"""Row-sparse optimizers for embedding tables, per leaf.

Counterpart of ``dlrover_tpu/optim/sparse.py``: only the rows touched
in a step (a row with any nonzero gradient) get accumulator, moment and
parameter updates; an untouched row, its state included, stays the same
bits. As in the JAX package "sparse" means masking by row activity, not
sparse tensors. A 1-D leaf is one row.
"""

from __future__ import annotations

import torch

from dlrover_tpu_torch.optim.base import LeafState, LeafTransform, sqrt_rn


def _row_active(g: torch.Tensor) -> torch.Tensor:
    """(rows, 1, ...) bool mask of the rows with a nonzero gradient (a
    0-d mask for a 1-D leaf)."""
    if g.dim() < 2:
        return (g != 0).any()
    active = (g.reshape(g.shape[0], -1) != 0).any(dim=-1)
    return active.reshape((g.shape[0],) + (1,) * (g.dim() - 1))


def row_sparse_adagrad(learning_rate: float = 0.1,
                       initial_accumulator: float = 0.1,
                       eps: float = 1e-10) -> LeafTransform:
    def init(p: torch.Tensor) -> LeafState:
        return {"accumulator": torch.full_like(p, initial_accumulator)}

    def update(g, state, p, lr):
        active = _row_active(g)
        acc = torch.where(active, state["accumulator"] + g.square(),
                          state["accumulator"])
        step = torch.where(active, -lr * g / (sqrt_rn(acc) + eps),
                           torch.zeros_like(g))
        return step, {"accumulator": acc}

    return LeafTransform(init, update, learning_rate)


def row_sparse_adam(learning_rate: float = 1e-3, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8) -> LeafTransform:
    """Adam where the moments and the per-row bias-correction counts of
    untouched rows stay the same bits."""

    def init(p: torch.Tensor) -> LeafState:
        counts = ((p.shape[0],) + (1,) * (p.dim() - 1)
                  if p.dim() >= 2 else ())
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p),
                "counts": torch.zeros(counts, dtype=torch.int32,
                                      device=p.device)}

    def update(g, state, p, lr):
        active = _row_active(g)
        counts = torch.where(active, state["counts"] + 1, state["counts"])
        mu = torch.where(active, b1 * state["mu"] + (1 - b1) * g,
                         state["mu"])
        nu = torch.where(active, b2 * state["nu"] + (1 - b2) * g.square(),
                         state["nu"])
        t = counts.clamp_min(1).float()
        mu_hat = mu / (1 - b1 ** t)
        nu_hat = nu / (1 - b2 ** t)
        step = torch.where(active, -lr * mu_hat / (sqrt_rn(nu_hat) + eps),
                           torch.zeros_like(g))
        return step, {"mu": mu, "nu": nu, "counts": counts}

    return LeafTransform(init, update, learning_rate)


def row_sparse_sgd(learning_rate: float = 0.01,
                   momentum: float = 0.9) -> LeafTransform:
    """SGD with momentum where untouched rows' buffers stay the same
    bits."""

    def init(p: torch.Tensor) -> LeafState:
        return {"momentum": torch.zeros_like(p)}

    def update(g, state, p, lr):
        active = _row_active(g)
        buf = torch.where(active, momentum * state["momentum"] + g,
                          state["momentum"])
        step = torch.where(active, -lr * buf, torch.zeros_like(g))
        return step, {"momentum": buf}

    return LeafTransform(init, update, learning_rate)
