"""The tensor axis's collectives, where the models place them.

The JAX package shards the parameters by logical axes and lets XLA's
SPMD insert the reductions a sharded product needs. The port lays the
same parameters out as DTensors (``parallel/sharding.py``), and DTensor
propagates placements through the plain model code; the collectives a
tensor axis needs are made here, at the points where the SPMD partitioner
puts them, and the models call them:

- ``reduce_partial``: a row-parallel projection's output (kernel sharded
  over its input dim) is a pending sum; it is reduced at the output,
  before the bias and the residual add, so the residual stream stays
  replicated whatever the norm.
- ``column_parallel_input``: the replicated input of column-parallel
  projections (kernels sharded over their output dim). Identity forward;
  backward, the projections' input gradients, each a pending sum, are
  summed there and reduced once (Megatron's "f").
- ``gather_shards``: an activation sharded over its last dim made whole
  (BERT's MLM transform before its norm).
- ``embed_shards``: the lookup of a table sharded over the vocabulary:
  each rank looks up the rows it holds, and the sum over the axis makes
  the whole rows.
- ``vocab_parallel_nll``: each token's negative log-likelihood from
  logits sharded over the vocabulary, from the maxima, the sums of
  exponentials and the target logits of the shards (small per-token
  collectives), never the whole logits.
- ``local_sum`` and ``local_sum_backward``: a plain (local) tensor's sum
  over process groups in the forward, or its gradient's in the backward
  (the expert layer's: ``parallel/moe.py``).

Every one moves tensors through ``parallel/collectives.py``: under gloo a
CUDA tensor crosses through page-locked host memory there, over the
group's lanes, and its seconds are counted in ``staging_seconds``. They
take DTensors on the one-dimensional tensor mesh the trainer lays the
parameters out on; anything else passes through.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from dlrover_tpu_torch.parallel.collectives import all_gather, all_reduce_


def _summed_dims(t: DTensor) -> List[int]:
    """The mesh dims of ``t``'s pending sums (``Partial("sum")``, not a
    subclass with its own reduction)."""
    return [dim for dim, p in enumerate(t.placements)
            if type(p) is Partial and p.reduce_op == "sum"]


class _SumPartial(torch.autograd.Function):
    """A DTensor's plain pending sums reduced to ``Replicate``; the
    gradient of a replicated result passes back unchanged, as DTensor's
    own."""

    @staticmethod
    def forward(ctx, t):
        local = t.to_local().clone()
        mesh = t.device_mesh
        summed = _summed_dims(t)
        for dim in summed:
            all_reduce_([local], mesh.get_group(dim))
        placements = [Replicate() if dim in summed else p
                      for dim, p in enumerate(t.placements)]
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    @staticmethod
    def backward(ctx, grad):
        return grad


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums (``Partial``: the output of a product
    whose contracted dim is sharded, a row-parallel layer's) reduced to
    ``Replicate``; anything else passes through."""
    if not (isinstance(t, DTensor) and _summed_dims(t)):
        return t
    return _SumPartial.apply(t)


class _ColumnParallelInput(torch.autograd.Function):
    """Identity forward; the gradient's pending sum reduced backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduce_partial(grad)


def column_parallel_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the replicated input of column-parallel products: the
    same value, and in the backward the products' input gradients summed
    here and reduced once, as the JAX package's SPMD reduces them after
    the dots' backward. Every replicated activation then has a
    replicated gradient."""
    if not (isinstance(x, DTensor) and x.requires_grad):
        return x
    return _ColumnParallelInput.apply(x)


def _last_dim_shard(t: torch.Tensor) -> bool:
    """A DTensor on a 1-D mesh sharded over its last dim."""
    return (isinstance(t, DTensor) and t.device_mesh.ndim == 1
            and t.placements == (Shard(t.ndim - 1),))


class _GatherShards(torch.autograd.Function):
    """Shard(last) → Replicate through ``all_gather``; the gradient's own
    shard back (its pending sum reduced first)."""

    @staticmethod
    def forward(ctx, t):
        mesh = t.device_mesh
        group = mesh.get_group(0)
        ctx.mesh, ctx.rank = mesh, group.rank()
        local = t.to_local()
        ctx.width = local.shape[-1]
        parts = all_gather(local, group)
        whole = torch.cat(list(parts.unbind(0)), dim=-1)
        return DTensor.from_local(whole, mesh, [Replicate()],
                                  run_check=False)

    @staticmethod
    def backward(ctx, grad):
        grad = reduce_partial(grad).to_local()
        mine = grad[..., ctx.rank * ctx.width:(ctx.rank + 1) * ctx.width]
        return DTensor.from_local(mine.contiguous(), ctx.mesh,
                                  [Shard(grad.ndim - 1)], run_check=False)


def gather_shards(t: torch.Tensor) -> torch.Tensor:
    """An activation sharded over its last dim on a 1-D mesh (a
    column-parallel product's output) made replicated; anything else
    passes through."""
    return _GatherShards.apply(t) if _last_dim_shard(t) else t


def _vocab_start(t: DTensor) -> int:
    """The first vocabulary row (or column) of this rank's shard of
    ``t``'s sharded dim."""
    return t.device_mesh.get_group(0).rank() * t.to_local().shape[
        t.placements[0].dim]


def embed_shards(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)`` of a table sharded over its rows
    (the vocabulary) on a 1-D mesh, replicated: each rank's rows looked
    up, the others zero, and the sum over the axis. The gradient reaches
    each rank's own rows."""
    local = table.to_local()
    start = _vocab_start(table)
    inside = (tokens >= start) & (tokens < start + local.shape[0])
    rows = torch.nn.functional.embedding(
        (tokens - start).clamp(0, local.shape[0] - 1), local)
    rows = rows * inside.unsqueeze(-1).to(rows.dtype)
    return reduce_partial(DTensor.from_local(
        rows, table.device_mesh, [Partial()], run_check=False))


def vocab_sharded(table: torch.Tensor) -> bool:
    """A table sharded over its rows on a 1-D mesh (``embed_shards``)."""
    return (isinstance(table, DTensor) and table.device_mesh.ndim == 1
            and table.placements == (Shard(0),))


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[target] from this rank's vocabulary shard:
    the global maximum from the shards' maxima, the sum of exponentials
    and the target's logit summed over the axis. Backward: softmax minus
    the target's one-hot, on the shard, scaled by the gradient."""

    @staticmethod
    def forward(ctx, local, targets, start, group):
        width = local.shape[-1]
        top = all_gather(local.detach().amax(dim=-1), group).amax(dim=0)
        exp = torch.exp(local - top.unsqueeze(-1))
        total = exp.sum(dim=-1)
        inside = (targets >= start) & (targets < start + width)
        index = (targets - start).clamp(0, width - 1)
        picked = (local.gather(-1, index.unsqueeze(-1)).squeeze(-1)
                  * inside.to(local.dtype))
        all_reduce_([total, picked], group)
        ctx.save_for_backward(exp / total.unsqueeze(-1), index, inside)
        return torch.log(total) + top - picked

    @staticmethod
    def backward(ctx, grad):
        softmax, index, inside = ctx.saved_tensors
        out = softmax * grad.unsqueeze(-1)
        out.scatter_add_(-1, index.unsqueeze(-1),
                         -(grad * inside.to(grad.dtype)).unsqueeze(-1))
        return out, None, None, None


def vocab_parallel_nll(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Each token's negative log-likelihood, (…,) in f32, from logits
    (…, vocab) sharded over the vocabulary on a 1-D mesh (a vocab-
    sharded head's product); a plain tensor."""
    local = logits.to_local().float()
    group = logits.device_mesh.get_group(0)
    return _VocabParallelNLL.apply(local, targets.long(),
                                   _vocab_start(logits), group)


def logits_vocab_sharded(logits: torch.Tensor) -> bool:
    """Logits sharded over their last (vocabulary) dim on a 1-D mesh
    (``vocab_parallel_nll``)."""
    return _last_dim_shard(logits)


class _LocalSum(torch.autograd.Function):
    """A plain tensor summed over each group; the gradient of the sum
    passes back unchanged (every rank holds the same sum)."""

    @staticmethod
    def forward(ctx, t, groups):
        t = t.contiguous().clone()
        for group in groups:
            all_reduce_([t], group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _LocalSumBackward(torch.autograd.Function):
    """Identity forward; the gradient summed over each group."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        for group in ctx.groups:
            all_reduce_([grad], group)
        return grad, None


def local_sum(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """A plain tensor's pending sum (each rank's part of a product over a
    sharded contraction) summed over ``groups`` (None entries skipped)."""
    groups = tuple(g for g in groups if g is not None)
    return _LocalSum.apply(t, groups) if groups else t


def local_sum_backward(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``t`` as the input of products each rank computes only its part of:
    the same value, and in the backward its gradient summed over
    ``groups`` (None entries skipped)."""
    groups = tuple(g for g in groups if g is not None)
    return _LocalSumBackward.apply(t, groups) if groups else t
