"""Adafactor's factored second-moment scaling, per leaf.

Own copy of optax's ``scale_by_factored_rms`` semantics (the JAX
bench's lean optimizer, ``optax.chain(optax.scale_by_factored_rms(),
optax.scale(-lr))``): the decay schedule 1 − (t+1)^−0.8, a leaf whose
two largest dims are both at least ``min_dim_size_to_factor`` keeps a
row and a column mean of g² + eps over them (``v_row``, ``v_col``), any
other leaf the full second moment ``v``; the unused entries hold a
zero of shape (1,), as optax's state does, so a JAX state converts leaf
for leaf (``convert.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.optim.base import LeafState, LeafTransform, count_like


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


def factored_rms(learning_rate: float, decay_rate: float = 0.8,
                 step_offset: int = 0, min_dim_size_to_factor: int = 128,
                 epsilon: float = 1e-30) -> LeafTransform:
    """``optax.chain(optax.scale_by_factored_rms(decay_rate=...,
    step_offset=..., min_dim_size_to_factor=..., epsilon=...),
    optax.scale(-learning_rate))``: factored, the power decay
    schedule."""

    def init(p: torch.Tensor) -> LeafState:
        def zeros(shape):
            return torch.zeros(shape, dtype=p.dtype, device=p.device)

        dims = factored_dims(tuple(p.shape), min_dim_size_to_factor)
        state = {"count": count_like(p), "v_row": zeros((1,)),
                 "v_col": zeros((1,)), "v": zeros((1,))}
        if dims is None:
            state["v"] = zeros(p.shape)
        else:
            d1, d0 = dims
            state["v_row"] = zeros(np.delete(p.shape, d0).tolist())
            state["v_col"] = zeros(np.delete(p.shape, d1).tolist())
        return state

    def update(g: torch.Tensor, state: LeafState, p: torch.Tensor,
               lr: float):
        count = state["count"]
        t = (count - step_offset + 1).float()
        decay = 1.0 - t ** -decay_rate
        grad_sqr = g * g + epsilon
        new = dict(state, count=count + 1)
        dims = factored_dims(tuple(p.shape), min_dim_size_to_factor)
        if dims is not None:
            d1, d0 = dims
            v_row = (decay * state["v_row"]
                     + (1.0 - decay) * grad_sqr.mean(dim=d0)).to(p.dtype)
            v_col = (decay * state["v_col"]
                     + (1.0 - decay) * grad_sqr.mean(dim=d1)).to(p.dtype)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            new.update(v_row=v_row, v_col=v_col)
        else:
            v = (decay * state["v"] + (1.0 - decay) * grad_sqr).to(p.dtype)
            u = g * v ** -0.5
            new["v"] = v
        return u * -lr, new

    return LeafTransform(init, update, learning_rate)
