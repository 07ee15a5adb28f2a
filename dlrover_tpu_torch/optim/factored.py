"""Adafactor's factored second-moment scaling, per leaf.

Own copy of optax's ``scale_by_factored_rms`` semantics (the JAX
bench's lean optimizer, ``optax.chain(optax.scale_by_factored_rms(),
optax.scale(-lr))``): the decay schedule 1 − (t+1)^−0.8, a leaf whose
two largest dims are both at least ``min_dim_size_to_factor`` keeps a
row and a column mean of g² + eps over them (``v_row``, ``v_col``), any
other leaf the full second moment ``v``; the unused entries hold a
zero of shape (1,), as optax's state does, so a JAX state converts leaf
for leaf (``convert.py``).

A DTensor parameter (sharded over an expert, a tensor or a data axis)
keeps its statistics as DTensors laid out alike; a mean over a dim the
parameter is sharded on is made whole on every rank (``settled``), as
XLA reduces a sharded leaf: its shards' means summed over the axis by the
port's own collective (``parallel/collectives.py``, host staged for CUDA
tensors on gloo) and divided by the axis's size, the shards being equal.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from dlrover_tpu_torch.optim.base import LeafState, LeafTransform, count_like
from dlrover_tpu_torch.parallel.collectives import all_reduce_


def factored_dims(shape, min_dim_size_to_factor: int
                  ) -> Optional[Tuple[int, int]]:
    """(d1, d0): the second-largest and the largest dim, or None when the
    leaf is not factored (optax's ``_factored_dims``, its argsort too)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def settled(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial values (a reduction over a dim it is sharded
    on: a sum, or a mean of equal shards) made whole on every rank; any
    other tensor as it is."""
    if not (isinstance(t, DTensor)
            and any(p.is_partial() for p in t.placements)):
        return t
    local = t.to_local().clone()
    mesh = t.device_mesh
    for dim, p in enumerate(t.placements):
        if not p.is_partial():
            continue
        if p.reduce_op not in ("sum", "avg"):
            raise ValueError(f"cannot settle a {p.reduce_op} partial")
        all_reduce_([local], mesh.get_group(dim))
        if p.reduce_op == "avg":
            local /= mesh.size(dim)
    return DTensor.from_local(
        local, mesh, [Replicate() if p.is_partial() else p
                      for p in t.placements],
        run_check=False, shape=t.shape, stride=t.stride())


def _zeros_without(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Zeros of ``p``'s shape without ``dim``, laid out as ``p`` is."""
    if isinstance(p, DTensor):
        return settled(torch.zeros_like(p).mean(dim=dim))
    return torch.zeros(np.delete(p.shape, dim).tolist(), dtype=p.dtype,
                       device=p.device)


def factored_init(p: torch.Tensor, min_dim_size_to_factor: int
                  ) -> LeafState:
    """optax's ``scale_by_factored_rms`` state of one leaf: its step
    count and the unused entries as zeros of shape (1,)."""
    def unused():
        return torch.zeros((1,), dtype=p.dtype, device=p.device)

    dims = factored_dims(tuple(p.shape), min_dim_size_to_factor)
    state = {"count": count_like(p), "v_row": unused(), "v_col": unused(),
             "v": unused()}
    if dims is None:
        state["v"] = torch.zeros_like(p)
    else:
        d1, d0 = dims
        state["v_row"] = _zeros_without(p, d0)
        state["v_col"] = _zeros_without(p, d1)
    return state


def factored_scale(g: torch.Tensor, state: LeafState, p: torch.Tensor,
                   decay_rate: float, step_offset: int,
                   min_dim_size_to_factor: int, epsilon: float
                   ) -> Tuple[torch.Tensor, LeafState]:
    """optax's ``scale_by_factored_rms`` update of one leaf: (the scaled
    gradient, the new state)."""
    count = state["count"]
    t = (count - step_offset + 1).float()
    decay = 1.0 - t ** -decay_rate
    grad_sqr = g * g + epsilon
    new = dict(state, count=count + 1)
    dims = factored_dims(tuple(p.shape), min_dim_size_to_factor)
    if dims is not None:
        d1, d0 = dims
        v_row = (decay * state["v_row"] + (1.0 - decay)
                 * settled(grad_sqr.mean(dim=d0))).to(p.dtype)
        v_col = (decay * state["v_col"] + (1.0 - decay)
                 * settled(grad_sqr.mean(dim=d1))).to(p.dtype)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = settled(v_row.mean(dim=reduced_d1, keepdim=True))
        row_factor = (v_row / row_col_mean) ** -0.5
        col_factor = v_col ** -0.5
        u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
        new.update(v_row=v_row, v_col=v_col)
    else:
        v = (decay * state["v"] + (1.0 - decay) * grad_sqr).to(p.dtype)
        u = g * v ** -0.5
        new["v"] = v
    return u, new


def factored_rms(learning_rate: float, decay_rate: float = 0.8,
                 step_offset: int = 0, min_dim_size_to_factor: int = 128,
                 epsilon: float = 1e-30) -> LeafTransform:
    """``optax.chain(optax.scale_by_factored_rms(decay_rate=...,
    step_offset=..., min_dim_size_to_factor=..., epsilon=...),
    optax.scale(-learning_rate))``: factored, the power decay
    schedule."""

    def init(p: torch.Tensor) -> LeafState:
        return factored_init(p, min_dim_size_to_factor)

    def update(g: torch.Tensor, state: LeafState, p: torch.Tensor,
               lr: float):
        u, new = factored_scale(g, state, p, decay_rate, step_offset,
                                min_dim_size_to_factor, epsilon)
        return u * -lr, new

    return LeafTransform(init, update, learning_rate)
