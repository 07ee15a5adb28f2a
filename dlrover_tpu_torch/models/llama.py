"""LLaMA-family model as torch ``nn.Module``s.

Counterpart of ``dlrover_tpu/models/llama.py``, with the same config,
presets, parameter names and numerics: f32 master parameters cast to
``cfg.dtype`` at each matmul, a ``cfg.dtype`` (bf16) residual stream,
f32 softmax statistics and f32 logits. Dense weights keep the JAX
``(in, out)`` layout, so ``y = x @ kernel`` and parameters convert
between the frameworks without a transpose (``dlrover_tpu_torch/
convert.py``). The large matmuls are plain ``torch.matmul``, as the
reference leaves them to XLA; attention goes through the port's flash
kernels (``attn_impl="flash"``), the plain path (``"reference"``) or
sequence parallelism over the trainer's mesh (``"ring"``,
``"ulysses"``: ``parallel/ring_attention.py``, on a sequence shard
whose positions start at its offset), and
each RMSNorm through the port's fused kernels (``norm_impl="fused"``) or
the plain norm (``"reference"``).

Parameter names follow the flax tree: ``embed``, ``layer_{i}.attn_norm
.weight``, ``layer_{i}.attn.{q,k,v,o}_proj.kernel``,
``layer_{i}.mlp.{gate,up,down}_proj.kernel``, ``layer_{i}.mlp_norm
.weight``, ``final_norm.weight`` and ``lm_head``. Each module's
``param_axes`` names its parameters' logical axes, the names the flax
model boxes them with (``parallel/sharding.py`` maps them onto a mesh);
since the layout is the same, a name labels the same tensor dim in both.
Built on the ``meta`` device, the model allocates nothing and runs no
initializer: the trainer's restore target.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.layers import (
    call_block,
    check_options,
    normal_param,
)
from dlrover_tpu_torch.ops.flash_attention import (
    flash_attention,
    reference_attention,
)
from dlrover_tpu_torch.ops.norms import fused_rms_norm, reference_rms_norm
from dlrover_tpu_torch.parallel.mesh import sequence_offset, sequence_parallel
from dlrover_tpu_torch.parallel.ring_attention import sequence_attention
from dlrover_tpu_torch.parallel.tensor_parallel import (
    column_parallel_input,
    embed_shards,
    logits_vocab_sharded,
    reduce_partial,
    vocab_parallel_nll,
    vocab_sharded,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16        # activation/compute dtype
    param_dtype: torch.dtype = torch.float32   # master parameter dtype
    # "flash" (the port's CUDA kernels) | "reference" (plain torch) |
    # "ring" | "ulysses" (sequence parallelism, parallel/ring_attention.py)
    attn_impl: str = "flash"
    # "gather" and "onehot" give the same values; the port gathers for
    # both ("onehot" is the reference's workaround for TPU SPMD).
    embed_impl: str = "onehot"
    norm_impl: str = "fused"         # "fused" | "reference"
    # rematerialize each block under remat_policy (ops/remat.py)
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    # ---- stock sizes -----------------------------------------------------
    @classmethod
    def llama_1b(cls, **kw) -> "LlamaConfig":
        return cls(hidden_size=2048, intermediate_size=5504, num_layers=22,
                   num_heads=16, num_kv_heads=16, **kw)

    @classmethod
    def llama_7b(cls, **kw) -> "LlamaConfig":
        return cls(hidden_size=4096, intermediate_size=11008,
                   num_layers=32, num_heads=32, num_kv_heads=32, **kw)

    @classmethod
    def llama_wide_1b(cls, **kw) -> "LlamaConfig":
        """Gemma-style wide-MLP variant (i/h = 4 instead of Llama's
        2.7)."""
        return cls(hidden_size=2048, intermediate_size=8192,
                   num_layers=20, num_heads=16, num_kv_heads=16, **kw)

    @classmethod
    def llama_410m(cls, **kw) -> "LlamaConfig":
        return cls(hidden_size=1024, intermediate_size=2816, num_layers=24,
                   num_heads=8, num_kv_heads=8, **kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq_len", 128)
        return cls(hidden_size=64, intermediate_size=128, num_layers=2,
                   num_heads=4, num_kv_heads=2, rms_norm_eps=1e-5, **kw)

    def flops_per_token(self) -> float:
        """Approximate training FLOPs/token (fwd+bwd ≈ 6·params)."""
        return 6.0 * self.param_count()

    def param_count(self) -> int:
        h, i, v, L = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_layers)
        kv = self.num_kv_heads * self.head_dim
        per_layer = (
            h * h + 2 * h * kv + h * h      # q, k, v, o projections
            + 3 * h * i                      # gate, up, down
            + 2 * h                          # 2 rmsnorm scales
        )
        emb = v * h * (1 if self.tie_embeddings else 2)
        return L * per_layer + emb + h


def _check_supported(cfg: LlamaConfig) -> None:
    """Options this slice does not port raise instead of doing something
    else."""
    check_options(cfg)
    if cfg.norm_impl not in ("fused", "reference"):
        raise ValueError(f"unknown norm_impl {cfg.norm_impl!r}")


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 cfg) -> torch.Tensor:
    """Token embedding lookup in ``cfg.dtype`` (``cfg`` needs only
    ``dtype``; GPT's and BERT's configs work too). ``"onehot"`` (a one-hot
    matmul in the reference) gives the same values as ``"gather"``, so
    both gather here; the f32 rows are gathered before the cast, which
    rounds each value exactly as casting the table first would. A table
    sharded over the vocabulary (tensor parallelism) is looked up
    locally, and each row summed in from the one rank that holds it,
    never by gathering the table (``parallel/tensor_parallel.py``)."""
    if vocab_sharded(embed):
        return embed_shards(embed, tokens).to(cfg.dtype)
    return F.embedding(tokens, embed).to(cfg.dtype)


def dispatch_attention(impl: str, q, k, v, causal: bool = True
                       ) -> torch.Tensor:
    """The model families' shared attention: ``(b, seq, heads, dim)`` in
    and out. ``impl``: ``"flash"`` (the port's kernels), ``"reference"``
    (plain torch), or ``"ring"``/``"ulysses"``: sequence parallelism over
    the ambient mesh's ``sequence`` axis (the trainer enters its mesh
    around each step), on this rank's shard of the sequence. At sequence
    1, or off-mesh, those two run the flash kernels (their plain version
    for CPU tensors), where the JAX package falls back to the plain
    attention."""
    if impl in ("ring", "ulysses"):
        sp = sequence_parallel()
        if sp is not None:
            return _sequence_parallel_attention(impl, sp[0], q, k, v,
                                                causal)
        impl = "flash"
    # (b, heads, seq, dim) layout for the kernels
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    attention = flash_attention if impl == "flash" else reference_attention
    return attention(q, k, v, causal).transpose(1, 2)


def _sequence_parallel_attention(impl: str, group, q, k, v,
                                 causal: bool) -> torch.Tensor:
    """Ring or Ulysses attention on this rank's sequence shard. Under
    tensor parallelism q, k and v are DTensors sharded over heads: the
    attention runs on their local heads (``local_map``), as the JAX
    package composes the ``tensor`` axis with the sequence one."""
    run = functools.partial(sequence_attention, impl, group=group,
                            causal=causal)
    if not any(isinstance(t, DTensor) for t in (q, k, v)):
        return run(q, k, v)
    placements = q.placements if isinstance(q, DTensor) else None
    for t in (q, k, v):
        if not isinstance(t, DTensor) or t.placements != placements:
            raise ValueError("sequence-parallel attention takes q, k and v "
                             "as DTensors of one placement")
    if not all(isinstance(p, Replicate)
               or (isinstance(p, Shard) and p.dim in (0, 2))
               for p in placements):
        raise ValueError(f"sequence-parallel attention shards over batch "
                         f"or heads only, got {placements}")
    return local_map(run, out_placements=list(placements),
                     in_placements=(list(placements),) * 3,
                     device_mesh=q.device_mesh)(q, k, v)


def token_positions(tokens: torch.Tensor) -> torch.Tensor:
    """Each token's position in its row: on a sequence shard (the
    ambient mesh's ``sequence`` axis) the shard's offset onward."""
    seq = tokens.shape[-1]
    start = sequence_offset(seq)
    return torch.arange(start, start + seq, device=tokens.device
                        ).expand(tokens.shape)


class Dense(nn.Module):
    """Kernel-only linear, ``(in, out)`` layout, cast to cfg.dtype;
    ``axes`` are the kernel's logical axes. Over a tensor axis that
    shards the input dim (a row-parallel kernel) the product's pending
    sum is reduced at the output (``reduce_partial``)."""

    def __init__(self, d_in, d_out, axes, cfg, device, generator):
        super().__init__()
        self.dtype = cfg.dtype
        self.param_axes = {"kernel": axes}
        self.kernel = normal_param((d_in, d_out), 0.02, cfg, device,
                                   generator)

    def forward(self, x):
        return reduce_partial(torch.matmul(x, self.kernel.to(self.dtype)))


class RMSNorm(nn.Module):
    param_axes = {"weight": ("norm",)}

    def __init__(self, dim, cfg, device):
        super().__init__()
        self.eps, self.dtype, self.impl = (cfg.rms_norm_eps, cfg.dtype,
                                           cfg.norm_impl)
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=cfg.param_dtype, device=device))

    def forward(self, x):
        norm = fused_rms_norm if self.impl == "fused" else reference_rms_norm
        return norm(x, self.weight.float(), self.eps).to(self.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding on (..., seq, num_heads, head_dim): split-half
    rotation in f32, returned in x.dtype."""
    head_dim = x.shape[-1]
    freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=x.device) / head_dim))
    angles = positions[..., :, None].float() * freq      # (b, s, d/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg, device, generator):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.hidden_size, cfg.head_dim
        self.q_proj = Dense(h, cfg.num_heads * d, ("embed", "heads"), cfg,
                            device, generator)
        self.k_proj = Dense(h, cfg.num_kv_heads * d, ("embed", "kv"), cfg,
                            device, generator)
        self.v_proj = Dense(h, cfg.num_kv_heads * d, ("embed", "kv"), cfg,
                            device, generator)
        self.o_proj = Dense(cfg.num_heads * d, h, ("heads", "embed"), cfg,
                            device, generator)

    def forward(self, x, positions):
        cfg = self.cfg
        batch, seq, _ = x.shape
        x = column_parallel_input(x)
        q = self.q_proj(x).view(batch, seq, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).view(batch, seq, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(x).view(batch, seq, cfg.num_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = dispatch_attention(cfg.attn_impl, q, k, v, causal=True)
        return self.o_proj(out.reshape(batch, seq, -1))


class MLP(nn.Module):
    def __init__(self, cfg, device, generator):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(h, i, ("embed", "mlp"), cfg, device,
                               generator)
        self.up_proj = Dense(h, i, ("embed", "mlp"), cfg, device, generator)
        self.down_proj = Dense(i, h, ("mlp", "embed"), cfg, device,
                               generator)

    def forward(self, x):
        x = column_parallel_input(x)
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg, device, generator):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg, device)
        self.attn = Attention(cfg, device, generator)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg, device)
        self.mlp = MLP(cfg, device, generator)

    def forward(self, x, positions):
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class Llama(nn.Module):
    """Decoder-only LM. ``forward(tokens) -> logits`` (f32).

    Parameters are made on ``device`` (the current CUDA device when None;
    raises without a GPU unless ``device="cpu"``) from a
    ``torch.Generator`` seeded with ``seed``: normal(0.02) for the dense
    kernels and tables, ones for the norm scales, as the flax
    initializers (the random streams differ from JAX's)."""

    def __init__(self, config: LlamaConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        _check_supported(config)
        cfg = self.config = config
        self.param_axes = {"embed": ("vocab", "embed")}
        if not cfg.tie_embeddings:
            self.param_axes["lm_head"] = ("embed", "vocab")
        generator = (None if device.type == "meta" else
                     torch.Generator(device=device).manual_seed(seed))
        self.embed = normal_param((cfg.vocab_size, cfg.hidden_size), 0.02,
                                  cfg, device, generator)
        for layer in range(cfg.num_layers):
            self.add_module(f"layer_{layer}",
                            DecoderBlock(cfg, device, generator))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = normal_param((cfg.hidden_size, cfg.vocab_size),
                                        0.02, cfg, device, generator)

    def kernel_libraries(self) -> Tuple[str, ...]:
        """The CUDA libraries (``ops/csrc/<name>.cu``) a training step of
        this configuration launches kernels from."""
        cfg = self.config
        return (("flash_attention",) if cfg.attn_impl != "reference"
                else ()) + (("norms",) if cfg.norm_impl == "fused" else ())

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = embed_lookup(self.embed, tokens, cfg)
        positions = token_positions(tokens)
        for layer in range(cfg.num_layers):
            x = call_block(getattr(self, f"layer_{layer}"), cfg, x,
                           positions)
        x = column_parallel_input(self.final_norm(x))
        head = (self.embed.t() if cfg.tie_embeddings else self.lm_head)
        logits = torch.matmul(x, head.to(cfg.dtype))
        return logits.float()


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each token's negative log-likelihood in f32, targets' shape; logits
    sharded over the vocabulary (a tensor axis's head) are reduced from
    their shards' statistics (``parallel/tensor_parallel.py``), never
    gathered."""
    if logits_vocab_sharded(logits):
        return vocab_parallel_nll(logits, targets)
    return F.cross_entropy(logits.float().flatten(0, -2),
                           targets.flatten().long(),
                           reduction="none").view(targets.shape)


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy; logits (b, s, v), targets (b, s)."""
    if logits_vocab_sharded(logits):
        return token_nll(logits, targets).mean()
    return F.cross_entropy(logits.float().flatten(0, -2),
                           targets.flatten().long())
