"""WSAM: weighted sharpness-aware minimization.

Counterpart of ``dlrover_tpu/optim/wsam.py`` (KDD'23): the gradient of
L(w) + γ/(1−γ)·[max_{‖ε‖≤ρ} L(w+ε) − L(w)],

    g_wsam = g + γ/(1−γ) · (g_adv − g),   g_adv = ∇L(w + ρ·g/‖g‖)

(γ = 0.5 is plain SAM). Where the JAX function takes a parameter tree,
this one takes the module: it perturbs the parameters in place for the
second gradient and then copies their saved values back, so they are
exactly as it found them; the copy holds the parameters once more
meanwhile. The result goes to any optimizer as the parameters'
``.grad``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn


def wsam_value_and_grad(
    loss_fn: Callable[..., torch.Tensor], rho: float = 0.05,
    gamma: float = 0.5,
) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Wrap ``loss_fn(model, *args, **kwargs) -> loss`` into
    ``value_and_grad(model, *args, **kwargs) -> (loss, {name: grad})``
    over the model's parameters that require a gradient."""
    if not 0.0 <= gamma < 1.0:
        raise ValueError(f"gamma must be in [0, 1), got {gamma}")
    sharpness_weight = gamma / (1.0 - gamma)

    def grads_of(model, params, *args, **kwargs):
        loss = loss_fn(model, *args, **kwargs)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a parameter the loss does not reach: zero, as jax.grad gives it
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    def value_and_grad(model: nn.Module, *args, **kwargs):
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        params = [p for _, p in named]
        loss, grads = grads_of(model, params, *args, **kwargs)
        grad_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        scale = rho / torch.clamp_min(grad_norm, 1e-12)
        saved = [p.detach().clone() for p in params]
        try:
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.add_(scale * g)
            _, adv_grads = grads_of(model, params, *args, **kwargs)
        finally:
            with torch.no_grad():
                for p, value in zip(params, saved):
                    p.copy_(value)
        return loss, {n: g + sharpness_weight * (ga - g)
                      for (n, _), g, ga in zip(named, grads, adv_grads)}

    return value_and_grad
