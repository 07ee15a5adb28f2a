"""Adafactor, per leaf: the port's own copy of ``optax.adafactor``.

optax chains, in this order: ``scale_by_factored_rms`` (``factored.py``),
``clip_by_block_rms(clipping_threshold)`` (each leaf's update divided by
max(1, rms(update) / threshold)), ``scale_by_learning_rate``,
``scale_by_param_block_rms`` (times max(rms(param), 1e-3), the parameter
before the update) and ``scale(-1)``, at optax's defaults (decay 0.8 from
step 0, eps 1e-30, the parameter scale on); its momentum and weight
decay (off by default) are not ported. The state is
``scale_by_factored_rms``'s alone (the other links keep none), so a JAX
state converts leaf for leaf (``convert.factored_state_from_jax``).
"""

from __future__ import annotations

from typing import Optional

import torch

from dlrover_tpu_torch.optim.base import LeafState, LeafTransform
from dlrover_tpu_torch.optim.factored import (
    factored_init,
    factored_scale,
    settled,
)

# optax's defaults: scale_by_factored_rms's decay and eps, and
# scale_by_param_block_rms's floor
DECAY_RATE, EPS, MIN_PARAM_SCALE = 0.8, 1e-30, 1e-3


def block_rms(t: torch.Tensor) -> torch.Tensor:
    """sqrt(mean(t²)) over the whole leaf (every shard of a DTensor)."""
    return settled((t * t).mean()).sqrt()


def adafactor(learning_rate: float, min_dim_size_to_factor: int = 128,
              clipping_threshold: Optional[float] = 1.0) -> LeafTransform:
    """``optax.adafactor(learning_rate, min_dim_size_to_factor,
    clipping_threshold=clipping_threshold)``."""

    def init(p: torch.Tensor) -> LeafState:
        return factored_init(p, min_dim_size_to_factor)

    def update(g: torch.Tensor, state: LeafState, p: torch.Tensor,
               lr: float):
        u, new = factored_scale(g, state, p, DECAY_RATE, 0,
                                min_dim_size_to_factor, EPS)
        if clipping_threshold is not None:
            u = u / torch.clamp(block_rms(u) / clipping_threshold, min=1.0)
        u = u * lr * torch.clamp(block_rms(p), min=MIN_PARAM_SCALE)
        return -u, new

    return LeafTransform(init, update, learning_rate)
