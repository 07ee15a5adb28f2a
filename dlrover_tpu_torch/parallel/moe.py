"""Mixture-of-experts with expert parallelism.

Counterpart of ``dlrover_tpu/parallel/moe.py``, with its config, routing
and parameter names: capacity-based top-k routing builds a dispatch mask
(tokens → expert capacity slots) and combine weights, and the dispatch
and combine are the reference's two einsums. The router runs in f32 (its
parameter, the product and the softmax), whatever the activations' type.

Expert parallelism: the JAX package gives the expert leaves an
``expert`` logical axis and lets XLA place the collectives. Here the
trainer lays those leaves over the mesh's ``expert`` axis as DTensors
(``Shard(0)``: each rank holds E/ep experts), and the layer reads its
group from them. Every rank of an expert group holds the same tokens
(the batch is not sharded over ``expert``), routes them alike, and
dispatches to its own experts only; the experts' outputs are gathered
over the group, so the combine, and everything after it, is the same on
every rank. The input's gradient, which each rank has only through its
own experts' slots, is summed over the group; the gathered outputs'
gradient is the same on every rank, and each rank keeps its own experts'
part (:class:`_Gather`). The router (``("embed", "expert")``) is sharded
over its expert columns and gathered whole before routing.

Tensor parallelism: ``wi``'s ``mlp`` dim (its columns) and ``wo``'s
(its rows) map to the ``tensor`` axis, so each rank holds M/t columns of
every expert it holds (``Shard(2)`` and ``Shard(1)``; under expert ×
tensor both leaves lie on the 2-D ``(expert, tensor)`` sub-mesh). A
rank's ``wo`` product is then a pending sum over ``tensor``. It is
summed where XLA's SPMD partitioner sums it for the JAX layer (read from
the compiled step's HLO at tensor 2 on the CPU): at the experts' output,
(E/ep, G·C, H), before the gather over the expert group; and in the
backward the experts' input gradient, (E/ep, G·C, H), is summed over
``tensor`` before the dispatch's transpose, then over the expert group
at the layer's input. The input comes in replicated over ``tensor`` (the
residual stream, a DTensor the layer computes on as its local value), so
every tensor rank routes alike and none routes on a partial sum. Every
collective here is the port's own (``parallel/collectives.py``, host
staged for CUDA tensors on gloo), never DTensor's.

Router jitter (``jitter_noise > 0`` in training routing) draws from a
``torch.Generator`` seeded by the caller (the trainer folds its seed,
the step and the micro-step, and the model the layer index): the same
step gives the same noise across a restart and in a rematerialized
forward, but the bits are not threefry's (ROADMAP, "Differences kept on
purpose").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch.common.constants import MeshAxis
from dlrover_tpu_torch.models.layers import gelu
from dlrover_tpu_torch.parallel.collectives import all_gather
from dlrover_tpu_torch.parallel.tensor_parallel import (
    local_sum,
    local_sum_backward,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    hidden_size: int = 512
    expert_intermediate: int = 1024
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    jitter_noise: float = 0.0       # router input jitter (switch-style)
    aux_loss_weight: float = 0.01
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32


def _capacity(tokens_per_group: int, num_experts: int,
              capacity_factor: float, min_capacity: int) -> int:
    capacity = int(tokens_per_group * capacity_factor / num_experts)
    return max(capacity, min_capacity)


def top_k_gating(router_logits: torch.Tensor, top_k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-based top-k routing of ``router_logits`` (G, S, E).

    Returns (dispatch_mask (G, S, E, C) bool, combine_weights (G, S, E, C)
    f32, aux_loss). Each round takes every token's best remaining expert
    (ties to the lowest index) and queues it there in token order after
    the slots of earlier rounds; a token past its expert's capacity is
    dropped (an all-zero row; the residual path keeps it alive). The
    combine weights are renormalised over the slots each token got."""
    groups, seq, num_experts = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)

    # load-balancing aux loss (Switch eq. 4): E * Σ_e f_e · P_e
    top1 = probs.argmax(dim=-1)
    f = F.one_hot(top1, num_experts).float().mean(dim=1)      # (G, E)
    p = probs.mean(dim=1)                                     # (G, E)
    aux_loss = num_experts * (f * p).sum(dim=-1).mean()

    dispatch = torch.zeros((groups, seq, num_experts, capacity),
                           dtype=torch.bool, device=probs.device)
    combine = torch.zeros(dispatch.shape, dtype=torch.float32,
                          device=probs.device)
    remaining = probs
    # slots already used per expert, carried across the k rounds
    fill = torch.zeros((groups, num_experts), dtype=torch.int64,
                       device=probs.device)
    for _ in range(top_k):
        expert_idx = remaining.argmax(dim=-1)                 # (G, S)
        gate = remaining.gather(-1, expert_idx[..., None])[..., 0]
        onehot = F.one_hot(expert_idx, num_experts)           # (G, S, E)
        # position of each token in its expert's queue this round
        position = onehot.cumsum(dim=1) - 1 + fill[:, None, :]
        position = (position * onehot).sum(dim=-1)            # (G, S)
        within = position < capacity
        # one_hot of a position past the capacity is all zeros in JAX
        slot_onehot = (F.one_hot(position.clamp(max=capacity - 1),
                                 capacity).bool()
                       & within[..., None])                   # (G, S, C)
        this_dispatch = (onehot.bool()[..., None]
                         & slot_onehot[:, :, None, :])
        dispatch = dispatch | this_dispatch
        combine = combine + this_dispatch * gate[..., None, None]
        fill = fill + (onehot * within[..., None]).sum(dim=1)
        remaining = remaining * (1.0 - onehot.to(remaining.dtype))
    # renormalize combine weights over the selected experts
    denom = combine.sum(dim=(2, 3), keepdim=True)
    combine = combine / denom.clamp(min=1e-9)
    return dispatch, combine, aux_loss


def lecun_normal_param(shape, param_dtype, device, generator
                       ) -> nn.Parameter:
    """flax's ``lecun_normal``: a normal truncated at ±2 standard
    deviations, scaled to variance 1/fan_in, where fan_in is the
    second-to-last dim times every dim before it (flax's receptive
    field, so an (E, H, M) expert kernel's is E·H). The random streams
    differ from JAX's."""
    fan_in = 1
    for d in shape[:-1]:
        fan_in *= d
    # the standard deviation of a unit normal truncated at ±2
    std = (1.0 / fan_in) ** 0.5 / .87962566103423978
    t = torch.empty(shape, dtype=param_dtype, device=device)
    if t.is_meta:
        return nn.Parameter(t)
    return nn.Parameter(nn.init.trunc_normal_(
        t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator))


class _Gather(torch.autograd.Function):
    """Each member's ``local`` joined along ``dim`` in the group's rank
    order (the experts' outputs along the experts, the router's columns);
    the backward keeps this rank's part of the gradient, which every rank
    computes whole and alike."""

    @staticmethod
    def forward(ctx, local, group, dim):
        ctx.rank, ctx.size = dist.get_rank(group), dist.get_world_size(group)
        ctx.dim = dim
        return torch.cat(list(all_gather(local, group).unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.size, dim=ctx.dim)[ctx.rank].contiguous(), \
            None, None


def _local(param: torch.Tensor) -> torch.Tensor:
    return param.to_local() if isinstance(param, DTensor) else param


def _axis_group(param: torch.Tensor, axis: str, dim: int
                ) -> Tuple[int, Optional[object]]:
    """(this rank's index, the process group) of ``axis`` when the DTensor
    ``param`` is sharded over it on its tensor dim ``dim``; (0, None)
    when the mesh has no such axis. Any other placement there raises."""
    if not isinstance(param, DTensor):
        return 0, None
    mesh = param.device_mesh
    if axis not in (mesh.mesh_dim_names or ()):
        return 0, None
    index = mesh.mesh_dim_names.index(axis)
    placement = param.placements[index]
    if placement.is_replicate():
        return 0, None
    if not placement.is_shard(dim):
        raise ValueError(f"{tuple(param.shape)} is laid out {placement} "
                         f"over {axis}, not on its dim {dim}")
    return mesh.get_local_rank(index), mesh.get_group(index)


class ExpertMLP(nn.Module):
    """E parallel feed-forward experts (``wi``, gelu, ``wo``); the
    parameters carry the ``expert`` logical axis, so an expert mesh
    shards them, and the ``mlp`` one, so a tensor axis shards each
    expert's columns."""

    param_axes = {"wi": ("expert", "embed", "mlp"),
                  "wo": ("expert", "mlp", "embed")}

    def __init__(self, cfg: MoEConfig, device, generator):
        super().__init__()
        self.dtype = cfg.dtype
        e, h, m = cfg.num_experts, cfg.hidden_size, cfg.expert_intermediate
        self.wi = lecun_normal_param((e, h, m), cfg.param_dtype, device,
                                     generator)
        self.wo = lecun_normal_param((e, m, h), cfg.param_dtype, device,
                                     generator)

    def expert_group(self) -> Tuple[int, int, Optional[object]]:
        """(first, end) of the experts this rank holds and the expert
        group's process group (None when the experts are not sharded)."""
        index, group = _axis_group(self.wi, MeshAxis.EXPERT, 0)
        local = _local(self.wi).shape[0]
        return index * local, (index + 1) * local, group

    def tensor_group(self) -> Optional[object]:
        """The tensor axis's process group when each expert's columns are
        sharded over it, else None."""
        return _axis_group(self.wi, MeshAxis.TENSOR, 2)[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (E_local, C_total, H); under tensor each rank's M/t columns
        tensor = self.tensor_group()
        x = local_sum_backward(x.to(self.dtype), [tensor])
        h = torch.einsum("ech,ehm->ecm", x, _local(self.wi).to(self.dtype))
        h = gelu(h)
        out = torch.einsum("ecm,emh->ech", h, _local(self.wo).to(self.dtype))
        return local_sum(out, [tensor])


class MoELayer(nn.Module):
    """Drop-in MLP replacement: (..., S, H) → ((..., S, H), aux loss).
    Where the JAX layer sows its weighted aux loss, this one returns it
    (``aux_loss_weight`` applied), so that it rides the autograd graph
    (and a rematerialized block's outputs) to the loss exactly once.

    ``deterministic`` (a constructor argument, as in JAX, so that
    ``.eval()`` cannot change the routing) picks the eval capacity factor
    and turns the jitter off."""

    def __init__(self, cfg: MoEConfig, deterministic: bool = True,
                 device=None, generator=None):
        super().__init__()
        self.cfg, self.deterministic = cfg, deterministic
        self.param_axes = {"router": ("embed", "expert")}
        self.router = lecun_normal_param(
            (cfg.hidden_size, cfg.num_experts), torch.float32, device,
            generator)
        self.ExpertMLP_0 = ExpertMLP(cfg, device, generator)

    def forward(self, x: torch.Tensor, gating_seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        # a DTensor input (the residual stream under tensor parallelism)
        # is replicated: the layer computes on its local value
        like = x if isinstance(x, DTensor) else None
        if like is not None:
            if not all(p.is_replicate() for p in like.placements):
                raise ValueError(f"the MoE layer takes a replicated input, "
                                 f"got {like.placements}")
            x = like.to_local()
        orig_shape = x.shape
        hidden = orig_shape[-1]
        # flatten leading dims into routing groups
        x = x.reshape((-1,) + tuple(orig_shape[-2:]))     # (G, S, H)
        groups, seq, _ = x.shape
        router = _local(self.router)
        _, router_group = _axis_group(self.router, MeshAxis.EXPERT, 1)
        if router_group is not None:
            router = _Gather.apply(router, router_group, 1)
        with torch.autocast(x.device.type, enabled=False):
            router_in = x.float()
            if cfg.jitter_noise > 0 and not self.deterministic:
                router_in = router_in * jitter(
                    router_in, cfg.jitter_noise, gating_seed)
            logits = router_in @ router.float()             # (G, S, E)
            capacity = _capacity(seq, cfg.num_experts,
                                 cfg.capacity_factor if not self.deterministic
                                 else cfg.eval_capacity_factor,
                                 cfg.min_capacity)
            capacity = min(capacity, seq)
            dispatch, combine, aux_loss = top_k_gating(logits, cfg.top_k,
                                                       capacity)

        experts = self.ExpertMLP_0
        first, end, group = experts.expert_group()
        # the dispatch reaches this rank's experts only: its gradient is
        # summed over the expert group
        x_in = local_sum_backward(x, [group])
        # dispatch: (G,S,E,C) × (G,S,H) → (E, G*C, H), this rank's experts
        expert_in = torch.einsum("gsec,gsh->egch",
                                 dispatch[:, :, first:end].to(x.dtype), x_in)
        expert_out = experts(expert_in.reshape(end - first,
                                               groups * capacity, hidden))
        if group is not None:
            expert_out = _Gather.apply(expert_out, group, 0)
        expert_out = expert_out.reshape(cfg.num_experts, groups, capacity,
                                        hidden)
        out = torch.einsum("gsec,egch->gsh",
                           combine.to(expert_out.dtype), expert_out)
        out = out.reshape(orig_shape).to(x.dtype)
        if like is not None:
            out = DTensor.from_local(out, like.device_mesh, like.placements,
                                     run_check=False)
        return out, cfg.aux_loss_weight * aux_loss


def jitter(router_in: torch.Tensor, noise: float,
           seed: Optional[int]) -> torch.Tensor:
    """Uniform multiplicative noise in [1 − noise, 1 + noise) of
    ``router_in``'s shape, drawn from a generator seeded with ``seed``
    (0 when the caller gives none)."""
    g = torch.Generator(device=router_in.device).manual_seed(
        int(seed or 0))
    return torch.empty_like(router_in).uniform_(
        1.0 - noise, 1.0 + noise, generator=g)


def fold_seed(*parts: int) -> int:
    """One 63-bit seed from several integers (a seed, a step, a
    micro-step, a layer), the same on every process: the port's
    ``jax.random.fold_in``."""
    return int(np.random.SeedSequence([int(p) for p in parts])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))
