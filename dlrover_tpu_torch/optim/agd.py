"""AGD: auto-switchable optimizer with gradient-difference
preconditioning, per leaf.

Counterpart of ``dlrover_tpu/optim/agd.py`` (AGD, NeurIPS'23): the
diagonal preconditioner accumulates the squared stepwise difference of
the bias-corrected first moments instead of the squared gradient, and
``delta`` switches each coordinate between adaptive (divide by
sqrt(nu_hat)) and SGD-like (divide by delta) steps. The same arithmetic
and order as the optax chain ``agd(...)`` then ``scale_by_learning_rate``.
"""

from __future__ import annotations

import torch

from dlrover_tpu_torch.optim.base import (
    LeafState,
    LeafTransform,
    count_like,
    sqrt_rn,
)


def agd(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
        delta: float = 1e-5, eps: float = 1e-8,
        weight_decay: float = 0.0) -> LeafTransform:
    def init(p: torch.Tensor) -> LeafState:
        return {"count": count_like(p), "mu": torch.zeros_like(p),
                "nu": torch.zeros_like(p)}

    def update(g: torch.Tensor, state: LeafState, p: torch.Tensor,
               lr: float):
        count = state["count"] + 1
        step = 1 - b1     # optax.incremental_update(g, mu, 1 - b1)
        mu = step * g + (1.0 - step) * state["mu"]
        t = count.float()
        # the previous moment is zero at count 1: the difference is then
        # the gradient itself
        prev_bc = torch.where(count == 1, torch.ones_like(t),
                              1.0 - b1 ** (t - 1))
        cur_bc = 1.0 - b1 ** t
        diff = mu / cur_bc - state["mu"] / prev_bc
        nu = b2 * state["nu"] + (1 - b2) * diff.square()
        mu_hat = mu / (1 - b1 ** t).to(mu.dtype)
        nu_hat = nu / (1 - b2 ** t).to(nu.dtype)
        u = mu_hat / torch.maximum(sqrt_rn(nu_hat) + eps,
                                   torch.tensor(delta, dtype=nu.dtype,
                                                device=nu.device))
        if weight_decay:
            u = u + weight_decay * p
        return u * -lr, {"count": count, "mu": mu, "nu": nu}

    return LeafTransform(init, update, learning_rate)
