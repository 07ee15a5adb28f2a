"""bf16 parameters with f32 master copies, per leaf.

Counterpart of ``dlrover_tpu/optim/bf16.py``: the state holds the f32
master copy of the parameter and the inner transform's state (its keys
prefixed ``inner_``); the inner transform runs on the master in f32 and
the emitted update is the bf16 delta ``bf16(master') − param``, so the
visible parameter stays bf16 while the rounding error does not
accumulate in it.
"""

from __future__ import annotations

import torch

from dlrover_tpu_torch.optim.base import LeafState, LeafTransform

_INNER = "inner_"


def bf16_master(inner: LeafTransform) -> LeafTransform:
    def init(p: torch.Tensor) -> LeafState:
        master = p.to(torch.float32, copy=True)
        return {"master": master,
                **{_INNER + k: v for k, v in inner.init(master).items()}}

    def update(g: torch.Tensor, state: LeafState, p: torch.Tensor,
               lr: float):
        master = state["master"]
        inner_state = {k[len(_INNER):]: v for k, v in state.items()
                       if k.startswith(_INNER)}
        inner_update, inner_state = inner.update(g.float(), inner_state,
                                                 master, lr)
        new_master = master + inner_update
        return (new_master.to(p.dtype) - p,
                {"master": new_master,
                 **{_INNER + k: v for k, v in inner_state.items()}})

    return LeafTransform(init, update, inner.learning_rate)
