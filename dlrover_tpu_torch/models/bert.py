"""BERT-style bidirectional encoder (masked LM) as torch ``nn.Module``s.

Counterpart of ``dlrover_tpu/models/bert.py``, with the same config,
presets, parameter names and numerics: word, position and (when given)
token-type embeddings, an ``embed_norm``, post-LN encoder blocks (flax's
LayerNorm at ``layer_norm_eps``) with a fused ``qkv``, stored
head-major as GPT's is (``models/gpt.py``: each head's q, k and v
columns side by side, where flax lays out ``[q | k | v]``;
``convert.py`` permutes between the two), and non-causal attention
through ``dispatch_attention`` (the port's flash kernels with ``causal=False``,
or the plain path), a tanh-GELU MLP, and the MLM head: a dense
transform, GELU, ``mlm_norm`` and a decoder tied to the word table, with
f32 logits. Padding is the loss's business (``mlm_loss``'s weights); the
attention runs over the whole length.

Parameter names follow the flax tree: ``word_embed``, ``pos_embed``,
``type_embed``, ``embed_norm.{scale,bias}``,
``layer_{i}.{qkv,attn_out,fc,proj}.{kernel,bias}``,
``layer_{i}.{attn_norm,mlp_norm}.{scale,bias}``,
``mlm_transform.{kernel,bias}`` and ``mlm_norm.{scale,bias}``.
``BertConfig.base()`` is BERT-base (109,483,776 parameters).
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
from dlrover_tpu_torch.models.llama import (
    dispatch_attention,
    embed_lookup,
    token_nll,
)
from dlrover_tpu_torch.parallel.collectives import all_reduce_
from dlrover_tpu_torch.parallel.mesh import sequence_offset, sequence_parallel
from dlrover_tpu_torch.parallel.tensor_parallel import (
    column_parallel_input,
    gather_shards,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # "flash" | "reference" | "ring" | "ulysses", all with causal=False
    attn_impl: str = "flash"
    embed_impl: str = "gather"
    # rematerialize each block under remat_policy (ops/remat.py)
    remat: bool = False
    remat_policy: str = "nothing_saveable"

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        kw.setdefault("vocab_size", 128)
        kw.setdefault("max_seq_len", 64)
        return cls(hidden_size=64, num_layers=2, num_heads=2,
                   intermediate_size=128, **kw)

    def param_count(self) -> int:
        """The reference's formula: the dense kernels and the tables,
        without the biases and norms."""
        h, i = self.hidden_size, self.intermediate_size
        per_layer = 4 * h * h + 2 * h * i
        return (self.vocab_size * h + self.max_seq_len * h
                + self.type_vocab_size * h
                + self.num_layers * per_layer + h * h)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: BertConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        h, i, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.qkv = Dense(h, 3 * h, ("embed", "heads"), cfg, device,
                         generator)
        self.attn_out = Dense(h, h, ("heads", "embed"), cfg, device,
                              generator)
        self.attn_norm = LayerNorm(h, eps, cfg, device)
        self.fc = Dense(h, i, ("embed", "mlp"), cfg, device, generator)
        self.proj = Dense(i, h, ("mlp", "embed"), cfg, device, generator)
        self.mlp_norm = LayerNorm(h, eps, cfg, device)

    def qkv_heads(self, x):
        """q, k and v, each (batch, seq, num_heads, head_dim), from the
        head-major fused projection (see ``GPT``'s ``Block``)."""
        return split_heads(self.qkv(column_parallel_input(x)),
                           self.cfg.num_heads)

    def forward(self, x):
        cfg = self.cfg
        batch, seq, _ = x.shape
        q, k, v = self.qkv_heads(x)
        attn = dispatch_attention(cfg.attn_impl, q, k, v, causal=False)
        attn = self.attn_out(attn.reshape(batch, seq, cfg.hidden_size))
        # post-LN residuals (original BERT)
        x = self.attn_norm(x + attn)
        h = self.fc(column_parallel_input(x))
        return self.mlp_norm(x + self.proj(gelu(h)))


class Bert(nn.Module):
    """``forward(tokens, token_types=None) -> logits`` (batch, seq,
    vocab), f32; the decoder is tied to the word table.

    Built on ``device`` from ``seed`` as ``GPT`` is (the current CUDA
    device when None; raises without a GPU unless ``device="cpu"``)."""

    def __init__(self, config: BertConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        check_options(config)
        cfg = self.config = config
        h = cfg.hidden_size
        self.param_axes = {"word_embed": ("vocab", "embed"),
                           "pos_embed": (None, "embed"),
                           "type_embed": (None, "embed")}
        generator = (None if device.type == "meta" else
                     torch.Generator(device=device).manual_seed(seed))
        self.word_embed = normal_param((cfg.vocab_size, h), 0.02, cfg,
                                       device, generator)
        self.pos_embed = normal_param((cfg.max_seq_len, h), 0.02, cfg,
                                      device, generator)
        self.type_embed = normal_param((cfg.type_vocab_size, h), 0.02, cfg,
                                       device, generator)
        self.embed_norm = LayerNorm(h, cfg.layer_norm_eps, cfg, device)
        for layer in range(cfg.num_layers):
            self.add_module(f"layer_{layer}",
                            EncoderBlock(cfg, device, generator))
        # MLM head: BERT's cls/predictions/transform
        self.mlm_transform = Dense(h, h, ("embed", "mlp"), cfg, device,
                                   generator)
        self.mlm_norm = LayerNorm(h, cfg.layer_norm_eps, cfg, device)

    def kernel_libraries(self) -> Tuple[str, ...]:
        """The CUDA libraries (``ops/csrc/<name>.cu``) a training step of
        this configuration launches kernels from."""
        return ("flash_attention",) if self.config.attn_impl != "reference" \
            else ()

    def forward(self, tokens: torch.Tensor,
                token_types: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        cfg = self.config
        seq = tokens.shape[-1]
        # on a sequence shard, the positions from its offset on
        start = sequence_offset(seq)
        x = (embed_lookup(self.word_embed, tokens, cfg)
             + self.pos_embed[start:start + seq].to(cfg.dtype))
        if token_types is not None:
            x = x + self.type_embed.to(cfg.dtype)[token_types]
        x = self.embed_norm(x)
        for layer in range(cfg.num_layers):
            x = call_block(getattr(self, f"layer_{layer}"), cfg, x)
        # the transform's columns are sharded over a tensor axis: made
        # whole for the norm
        x = gather_shards(gelu(self.mlm_transform(column_parallel_input(x))))
        x = self.mlm_norm(x)
        return torch.matmul(column_parallel_input(x),
                            self.word_embed.to(cfg.dtype).t()).float()


def mlm_loss(logits: torch.Tensor, targets: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-LM cross entropy. ``weights`` marks the predicted
    positions (1 at [MASK]-ed tokens, 0 elsewhere and at padding); None
    scores every position (the dense-target form the loop's
    ``loss_fn(logits, targets)`` takes).

    On a sequence shard (the ambient mesh's ``sequence`` axis) the count
    of weighted positions is the whole rows' (shards hold different
    counts), scaled by the axis size: the trainer's mean over the axis is
    then Σ nll·w / Σ w over the whole rows, not a mean of shard means."""
    nll = token_nll(logits, targets)
    if weights is None:
        return nll.mean()
    weights = weights.to(nll.dtype)
    count = weights.sum()
    sp = sequence_parallel()
    if sp is None:
        return (nll * weights).sum() / count.clamp_min(1.0)
    group, _, size = sp
    count = count.detach().clone()
    all_reduce_([count], group)
    return (nll * weights).sum() / count.clamp_min(1.0) * size
