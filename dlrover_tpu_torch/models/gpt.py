"""GPT-2 style model (nanoGPT) as torch ``nn.Module``s.

Counterpart of ``dlrover_tpu/models/gpt.py``, with the same config,
presets, parameter names and numerics: pre-LN blocks with flax's
LayerNorm (eps 1e-6), a fused ``qkv`` projection, causal attention
through ``dispatch_attention`` (the port's flash kernels or the plain
path), a tanh-GELU MLP, learned positions, and a head tied to the token
table with f32 logits. The layers are ``models/layers.py``'s; dense
kernels keep the JAX ``(in, out)`` layout.

The fused ``qkv`` kernel and bias are stored head-major: column
``(h·3 + j)·head_dim + i`` is head ``h``'s element ``i`` of q, k or v
(``j`` = 0, 1, 2), where flax lays the 3·n columns out as ``[q | k |
v]``. The forward cuts ``(…, n_head, 3·head_dim)`` into its three
``head_dim`` slices (``layers.split_heads``). A contiguous
column shard over a tensor axis that divides ``n_head`` then holds whole
q, k and v heads, whatever the axis's size, so a checkpoint restores at
any tensor size. ``convert.py`` permutes the two leaves (and their
optimizer state) to and from flax's layout; every other parameter
converts unchanged.

Parameter names follow the flax tree: ``wte``, ``wpe``,
``block_{i}.{ln1,ln2}.{scale,bias}``,
``block_{i}.{qkv,attn_out,fc,proj}.{kernel,bias}`` and
``ln_f.{scale,bias}``. ``GPTConfig()`` is GPT-2 small (124,475,904
parameters).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    call_block,
    check_options,
    gelu,
    normal_param,
    split_heads,
)
from dlrover_tpu_torch.models.llama import dispatch_attention, embed_lookup
from dlrover_tpu_torch.parallel.mesh import sequence_offset
from dlrover_tpu_torch.parallel.tensor_parallel import column_parallel_input

# flax nn.LayerNorm's default epsilon, which every GPT norm keeps
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    block_size: int = 1024
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # "flash" | "reference" | "ring" | "ulysses"
    attn_impl: str = "flash"
    embed_impl: str = "gather"
    # rematerialize each block under remat_policy (ops/remat.py)
    remat: bool = False
    remat_policy: str = "nothing_saveable"

    @classmethod
    def nano(cls, **kw) -> "GPTConfig":
        kw.setdefault("vocab_size", 256)
        return cls(n_embd=128, n_layer=4, n_head=4, block_size=128, **kw)

    @classmethod
    def tiny(cls, **kw) -> "GPTConfig":
        kw.setdefault("vocab_size", 128)
        return cls(n_embd=64, n_layer=2, n_head=2, block_size=64, **kw)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        n = cfg.n_embd
        self.ln1 = LayerNorm(n, LN_EPS, cfg, device)
        self.qkv = Dense(n, 3 * n, ("embed", "heads"), cfg, device,
                         generator)
        self.attn_out = Dense(n, n, ("heads", "embed"), cfg, device,
                              generator)
        self.ln2 = LayerNorm(n, LN_EPS, cfg, device)
        self.fc = Dense(n, 4 * n, ("embed", "mlp"), cfg, device, generator)
        self.proj = Dense(4 * n, n, ("mlp", "embed"), cfg, device,
                          generator)

    def qkv_heads(self, x):
        """q, k and v, each (batch, seq, n_head, head_dim), from the
        head-major fused projection of ``ln1(x)``: under a tensor axis
        each is sharded over heads as the kernel's columns are, with no
        collective."""
        return split_heads(self.qkv(column_parallel_input(self.ln1(x))),
                           self.cfg.n_head)

    def forward(self, x):
        cfg = self.cfg
        batch, seq, _ = x.shape
        q, k, v = self.qkv_heads(x)
        attn = dispatch_attention(cfg.attn_impl, q, k, v, causal=True)
        x = x + self.attn_out(attn.reshape(batch, seq, cfg.n_embd))
        h = column_parallel_input(self.ln2(x))
        return x + self.proj(gelu(self.fc(h)))


class GPT(nn.Module):
    """``forward(tokens) -> logits`` (f32).

    Parameters are made on ``device`` (the current CUDA device when None;
    raises without a GPU unless ``device="cpu"``) from a
    ``torch.Generator`` seeded with ``seed``: normal(0.02) for the dense
    kernels and tables, zeros for the biases, ones and zeros for the
    norms, as the flax initializers (the random streams differ)."""

    def __init__(self, config: GPTConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        check_options(config)
        cfg = self.config = config
        self.param_axes = {"wte": ("vocab", "embed"), "wpe": (None, "embed")}
        generator = (None if device.type == "meta" else
                     torch.Generator(device=device).manual_seed(seed))
        self.wte = normal_param((cfg.vocab_size, cfg.n_embd), 0.02, cfg,
                                device, generator)
        self.wpe = normal_param((cfg.block_size, cfg.n_embd), 0.02, cfg,
                                device, generator)
        for layer in range(cfg.n_layer):
            self.add_module(f"block_{layer}", Block(cfg, device, generator))
        self.ln_f = LayerNorm(cfg.n_embd, LN_EPS, cfg, device)

    def kernel_libraries(self) -> Tuple[str, ...]:
        """The CUDA libraries (``ops/csrc/<name>.cu``) a training step of
        this configuration launches kernels from."""
        return ("flash_attention",) if self.config.attn_impl != "reference" \
            else ()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        seq = tokens.shape[-1]
        # on a sequence shard, the positions from its offset on
        start = sequence_offset(seq)
        x = (embed_lookup(self.wte, tokens, cfg)
             + self.wpe[start:start + seq].to(cfg.dtype))
        for layer in range(cfg.n_layer):
            x = call_block(getattr(self, f"block_{layer}"), cfg, x)
        x = column_parallel_input(self.ln_f(x))
        # weight-tied LM head (as nanoGPT)
        return torch.matmul(x, self.wte.to(cfg.dtype).t()).float()
