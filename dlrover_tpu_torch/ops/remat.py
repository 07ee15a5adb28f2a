"""Named rematerialization policies, as activation checkpointing.

Counterpart of ``dlrover_tpu/ops/remat.py``, with its names:

- ``""``, ``"full"``, ``"nothing_saveable"``: keep only the block's
  inputs and recompute the whole block in the backward
  (``torch.utils.checkpoint``, non-reentrant);
- ``"dots"``, ``"dots_saveable"``: keep every matmul's output
  (selective checkpointing: a policy on the ``aten`` matmuls, the
  batched ones included) and recompute the rest;
- ``"dots_with_no_batch_dims"``: keep the outputs of the matmuls without
  batch dims (``mm``, ``addmm``: a ``(b, s, h) @ (h, o)`` projection is
  folded into one) and recompute the rest.

The port's CUDA kernels are launched through ``ctypes``, so no dispatch
policy sees them: like a Pallas call in JAX, which is no dot, they run
again in the recompute (their forward launches count twice, their
backward ones once).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten
_NO_BATCH_DOTS = frozenset({_aten.mm.default, _aten.addmm.default})
_DOTS = _NO_BATCH_DOTS | {_aten.bmm.default, _aten.baddbmm.default}

# policy name -> the matmuls whose outputs are kept (None: none)
POLICIES = {
    "": None,
    "full": None,
    "nothing_saveable": None,
    "dots": _DOTS,
    "dots_saveable": _DOTS,
    "dots_with_no_batch_dims": _NO_BATCH_DOTS,
}


def _keep(ops, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def resolve_remat_policy(name: str) -> Optional[Callable]:
    """Policy name → the ``context_fn`` of ``torch.utils.checkpoint``
    (None: recompute everything). Raises ``ValueError`` for an unknown
    name, as the JAX function does."""
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; "
                         f"choose from {sorted(POLICIES)}")
    ops = POLICIES[name]
    if ops is None:
        return None
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_keep, ops))


def remat_call(fn: Callable, policy: str, *args):
    """``fn(*args)`` with its activations rematerialized under
    ``policy``."""
    context_fn = resolve_remat_policy(policy)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, *args, use_reentrant=False, **kw)
