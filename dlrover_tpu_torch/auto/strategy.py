"""Strategy model: a named list of optimizations with their configs.

Own copy of the JAX package's ``auto/strategy.py`` (after atorch's
strategy save and load, ``auto_accelerate(load_strategy=...,
save_strategy_to_file=...)``): JSON on disk, ``[(name, config), ...]`` in
memory. The file is the same in both packages, so a strategy saved by
either loads in the other.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

Strategy = List[Tuple[str, Dict[str, Any]]]


def normalize_strategy(strategy) -> Strategy:
    """Accept the ``["fsdp", ("amp", {...})]`` shorthand."""
    out: Strategy = []
    for item in strategy:
        if isinstance(item, str):
            out.append((item, {}))
        else:
            name, config = item
            out.append((name, dict(config or {})))
    return out


def save_strategy(strategy: Strategy, path: str) -> None:
    with open(path, "w") as f:
        json.dump([[name, config] for name, config in strategy], f,
                  indent=2)


def load_strategy(path: str) -> Strategy:
    with open(path) as f:
        raw = json.load(f)
    return [(name, dict(config)) for name, config in raw]
