"""Mixtral-style MoE Llama: sparse expert MLPs in the Llama skeleton.

Counterpart of ``dlrover_tpu/models/llama_moe.py``: the port's Llama
attention and RMSNorm (so ``attn_impl="flash"`` and ``norm_impl="fused"``
reach the port's kernels) with each block's MLP replaced by the
expert-parallel ``MoELayer`` (``parallel/moe.py``). Parameter names
follow the flax tree: ``layer_{i}.attn_norm.weight``, ``layer_{i}.attn
.{q,k,v,o}_proj.kernel``, ``layer_{i}.moe_norm.weight``,
``layer_{i}.moe.router``, ``layer_{i}.moe.ExpertMLP_0.{wi,wo}``, with
``embed``, ``final_norm.weight`` and ``lm_head`` as in Llama.

Where the JAX model sows each layer's weighted router aux loss into the
``losses`` collection, the port's blocks return it beside their output
and the model sums it through the autograd graph: ``model(tokens,
with_losses=True)`` gives ``(logits, aux)``, the counterpart of
``model.apply(..., mutable=["losses"])`` and ``moe_aux_loss``. On a
sequence shard (``attn_impl="ring"`` or ``"ulysses"`` under the
trainer's mesh) each block gathers the whole rows before the router and
keeps its own shard of the expert output, so routing, capacity and the
aux loss are those of the whole rows, as in the JAX model. A block
rematerialized in the backward returns the same aux again, but only the
forward's value reaches the loss, so it is counted once.

Under a ``tensor`` axis the dense parts take the Llama's placement of the
sums (``parallel/tensor_parallel.py``): each attention and the head read
their replicated input through ``column_parallel_input``, the
row-parallel ``o_proj`` reduces its pending sum at its output, and a
vocabulary-sharded embedding and head go through ``embed_shards`` and
the loss's ``vocab_parallel_nll``; the expert layer sums its own
(``parallel/moe.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.layers import call_block, normal_param
from dlrover_tpu_torch.models.llama import (
    Attention,
    LlamaConfig,
    RMSNorm,
    _check_supported,
    cross_entropy_loss,
    embed_lookup,
    token_positions,
)
from dlrover_tpu_torch.parallel.mesh import sequence_parallel
from dlrover_tpu_torch.parallel.moe import MoEConfig, MoELayer, fold_seed
from dlrover_tpu_torch.parallel.ring_attention import gather_sequence
from dlrover_tpu_torch.parallel.tensor_parallel import column_parallel_input


@dataclasses.dataclass(frozen=True)
class LlamaMoEConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    jitter_noise: float = 0.0
    aux_loss_weight: float = 0.01

    def moe_config(self) -> MoEConfig:
        return MoEConfig(
            num_experts=self.num_experts,
            top_k=self.top_k,
            hidden_size=self.hidden_size,
            expert_intermediate=self.intermediate_size,
            capacity_factor=self.capacity_factor,
            jitter_noise=self.jitter_noise,
            aux_loss_weight=self.aux_loss_weight,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
        )

    @classmethod
    def mixtral_tiny(cls, **kw) -> "LlamaMoEConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq_len", 128)
        return cls(hidden_size=64, intermediate_size=128, num_layers=2,
                   num_heads=4, num_kv_heads=2, num_experts=4, top_k=2,
                   **kw)

    def param_count(self) -> int:
        dense = super().param_count()
        # each layer's single MLP becomes num_experts experts + a router
        per_layer_mlp = 3 * self.hidden_size * self.intermediate_size
        moe_mlp = (2 * self.hidden_size * self.intermediate_size
                   * self.num_experts
                   + self.hidden_size * self.num_experts)
        return dense + self.num_layers * (moe_mlp - per_layer_mlp)

    def active_param_count(self) -> int:
        """Params touched per token (the MoE efficiency headline)."""
        dense = super().param_count()
        per_layer_mlp = 3 * self.hidden_size * self.intermediate_size
        active_mlp = (2 * self.hidden_size * self.intermediate_size
                      * self.top_k
                      + self.hidden_size * self.num_experts)
        return dense + self.num_layers * (active_mlp - per_layer_mlp)


class MoEDecoderBlock(nn.Module):
    def __init__(self, cfg: LlamaMoEConfig, deterministic: bool, device,
                 generator):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg, device)
        self.attn = Attention(cfg, device, generator)
        self.moe_norm = RMSNorm(cfg.hidden_size, cfg, device)
        self.moe = MoELayer(cfg.moe_config(), deterministic, device,
                            generator)

    def forward(self, x, positions, gating_seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x + self.attn(self.attn_norm(x), positions)
        h = self.moe_norm(x)
        sp = sequence_parallel()
        if sp is None:
            out, aux = self.moe(h, gating_seed)
            return x + out, aux
        # a row routes as a whole (capacity and slot order run along it):
        # every member of the sequence axis routes the whole rows and keeps
        # its own shard of the output
        group, index, _ = sp
        local = h.shape[1]
        out, aux = self.moe(gather_sequence(h, group), gating_seed)
        return x + out[:, index * local:(index + 1) * local], aux


class LlamaMoE(nn.Module):
    """Decoder-only MoE LM (Mixtral shape). ``forward(tokens) -> logits``
    (f32); ``forward(tokens, with_losses=True) -> (logits, aux)``, the
    sum of the layers' weighted router aux losses. Construct with
    ``deterministic=False`` for training, so the train capacity factor
    and the router jitter apply; ``gating_seed`` (the trainer's, folded
    from its seed, the step and the micro-step) seeds the jitter, folded
    again with each layer's index.

    Parameters are made on ``device`` (the current CUDA device when None;
    raises without a GPU unless ``device="cpu"``) from a
    ``torch.Generator`` seeded with ``seed``: normal(0.02) for the
    attention kernels and tables, lecun_normal for the router and the
    experts, ones for the norm scales, as the flax initializers (the
    random streams differ from JAX's)."""

    # the trainer asks for the aux losses (trainer/train_step.py)
    sows_losses = True

    def __init__(self, config: LlamaMoEConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, deterministic: bool = True):
        super().__init__()
        device = resolve_device(device)
        _check_supported(config)
        cfg = self.config = config
        self.deterministic = deterministic
        self.param_axes = {"embed": ("vocab", "embed")}
        if not cfg.tie_embeddings:
            self.param_axes["lm_head"] = ("embed", "vocab")
        generator = (None if device.type == "meta" else
                     torch.Generator(device=device).manual_seed(seed))
        self.embed = normal_param((cfg.vocab_size, cfg.hidden_size), 0.02,
                                  cfg, device, generator)
        for layer in range(cfg.num_layers):
            self.add_module(f"layer_{layer}", MoEDecoderBlock(
                cfg, deterministic, device, generator))
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

    def forward(self, tokens: torch.Tensor, with_losses: bool = False,
                gating_seed: Optional[int] = None):
        cfg = self.config
        x = embed_lookup(self.embed, tokens, cfg)
        positions = token_positions(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in range(cfg.num_layers):
            seed = (None if gating_seed is None
                    else fold_seed(gating_seed, layer))
            x, layer_aux = call_block(getattr(self, f"layer_{layer}"), cfg,
                                      x, positions, seed)
            aux = aux + layer_aux
        x = column_parallel_input(self.final_norm(x))
        head = (self.embed.t() if cfg.tie_embeddings else self.lm_head)
        logits = torch.matmul(x, head.to(cfg.dtype)).float()
        return (logits, aux) if with_losses else logits


def moe_cross_entropy_loss(model: LlamaMoE, tokens: torch.Tensor,
                           targets: torch.Tensor) -> torch.Tensor:
    """Cross entropy + router aux losses in one scalar."""
    logits, aux = model(tokens, with_losses=True)
    return cross_entropy_loss(logits, targets) + aux
