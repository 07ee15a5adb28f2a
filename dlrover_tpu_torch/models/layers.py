"""The layers the GPT and BERT families share, as flax builds them.

Counterparts of flax's ``nn.Dense`` with a bias, ``nn.LayerNorm`` and
``nn.gelu``, with flax's parameter names and numerics:

- ``Dense``: ``kernel`` ``(in, out)`` and ``bias``, both in
  ``cfg.param_dtype``, cast to ``cfg.dtype`` at the product; the bias is
  added in ``cfg.dtype`` after it, as flax promotes all three to
  ``dtype`` and adds the bias to the product's result. Over a tensor
  axis that shards the input dim (a row-parallel kernel) the product's
  pending sum is reduced before the bias, which is added once.
- ``LayerNorm``: ``scale`` and ``bias`` in f32 (flax's ``param_dtype``
  default, whatever the model's), the statistics and the normalisation
  in f32 and one cast to ``cfg.dtype`` at the end. flax's default eps is
  1e-6, not torch's 1e-5; the caller passes it. flax takes the variance
  as E[x²] − E[x]² (clipped at 0) where torch takes the mean square of
  the centred values: the same in exact arithmetic, f32 rounding apart.
- ``gelu``: the tanh approximation, flax's default (torch's is erf).

Parameters carry logical axes (``param_axes``) as the flax modules box
them; LayerNorm's carry none, so they are replicated on every mesh, as
flax leaves them unboxed. ``call_block`` runs a block under the
config's rematerialization policy. ``split_heads`` takes q, k and v
from a fused projection stored head-major (GPT's and BERT's ``qkv``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.ops.remat import remat_call, resolve_remat_policy
from dlrover_tpu_torch.parallel.tensor_parallel import reduce_partial


# the attentions every family takes (``dispatch_attention``)
ATTN_IMPLS = ("flash", "reference", "ring", "ulysses")


def check_options(cfg) -> None:
    """An attention, a remat policy or an embedding no family knows
    (``ValueError``)."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}: expected "
                         f"one of {ATTN_IMPLS}")
    if cfg.remat:
        # an unknown policy name raises ValueError here, at the build
        resolve_remat_policy(cfg.remat_policy)
    if cfg.embed_impl not in ("gather", "onehot"):
        raise ValueError(f"unknown embed_impl {cfg.embed_impl!r}")


def call_block(block: nn.Module, cfg, *args):
    """``block(*args)``, its activations rematerialized under
    ``cfg.remat_policy`` when ``cfg.remat`` (``ops/remat.py``), as the
    JAX families wrap each block in ``nn.remat``."""
    if cfg.remat:
        return remat_call(block, cfg.remat_policy, *args)
    return block(*args)


def normal_param(shape, std, cfg, device, generator) -> nn.Parameter:
    """A ``cfg.param_dtype`` parameter drawn from normal(0, std), as
    flax's ``normal`` initializer (the random streams differ)."""
    t = torch.empty(shape, dtype=cfg.param_dtype, device=device)
    return nn.Parameter(t.normal_(0.0, std, generator=generator))


class Dense(nn.Module):
    """Biased linear, ``(in, out)`` layout; ``axes`` are the kernel's
    logical axes, and the bias takes the output one."""

    def __init__(self, d_in, d_out, axes, cfg, device, generator):
        super().__init__()
        self.dtype = cfg.dtype
        self.param_axes = {"kernel": axes, "bias": (axes[-1],)}
        self.kernel = normal_param((d_in, d_out), 0.02, cfg, device,
                                   generator)
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=cfg.param_dtype,
                                             device=device))

    def forward(self, x):
        return (reduce_partial(torch.matmul(x, self.kernel.to(self.dtype)))
                + self.bias.to(self.dtype))


def split_heads(qkv: torch.Tensor, heads: int):
    """q, k and v, each (…, seq, heads, head_dim), from a fused
    projection's (…, seq, 3·heads·head_dim) output laid out head-major
    (each head's q, k and v columns side by side). A DTensor sharded over
    the last dim stays sharded over heads: no collective runs."""
    *lead, width = qkv.shape
    # (…, heads, 3·head_dim) cut along its last dim: the heads stay the
    # sharded dim forward and backward (the gradients are joined by a
    # concatenation along an unsharded dim)
    return qkv.unflatten(-1, (heads, width // heads)).split(
        width // (3 * heads), dim=-1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=eps, dtype=cfg.dtype)``."""

    def __init__(self, dim, eps, cfg, device):
        super().__init__()
        self.eps, self.dtype = eps, cfg.dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, x):
        y = F.layer_norm(x.float(), self.scale.shape, self.scale.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
