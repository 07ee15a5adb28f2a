"""Watcher interface: platform events → neutral NodeEvents.

Own copy of the JAX package's ``master/watcher/base.py``, after
dlrover/python/master/watcher/base_watcher.py: the NodeEvent carried from
the platform event stream into the job manager.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Iterator, List

from dlrover_tpu_torch.common.node import Node


@dataclass
class NodeEvent:
    event_type: str   # NodeEventType
    node: Node


class NodeWatcher(abc.ABC):
    @abc.abstractmethod
    def watch(self) -> Iterator[NodeEvent]:
        """Blocking stream of node events."""

    @abc.abstractmethod
    def list(self) -> List[Node]:
        """Snapshot of current nodes (to reconcile missed events)."""

    def prime(self) -> None:  # pragma: no cover - default no-op
        """Open the event subscription before any nodes are launched so no
        creation event is missed (called ahead of the initial scale)."""

    def stop(self) -> None:  # pragma: no cover - default no-op
        pass
