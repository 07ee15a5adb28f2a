"""Sequence-parallel attention: the ring and Ulysses.

Counterpart of ``dlrover_tpu/parallel/ring_attention.py``. The JAX
package runs each path inside a ``shard_map`` over the ``sequence``
axis; here each rank calls it on its own shard, and the axis is a
process group (``Mesh.submesh([MeshAxis.SEQUENCE]).get_group()``). The
collectives are ``parallel/collectives.py``'s.

- **The einsum ring** (``block_impl="einsum"``): each rank keeps its Q
  shard while the K/V shards rotate around the ring, and the softmax is
  accumulated online (running max and sum), in f32. Autograd derives the
  backward, through ``_Shift``, whose backward is the reverse rotation.
  This is the plain version, and the path of CPU tensors.
- **Ring-flash** (``"flash"``): ``RingFlashFn`` runs the port's flash
  kernels on every visiting K/V block (the diagonal block causal, earlier
  blocks in full, later ones skipped when causal) and merges the
  normalized block outputs by their logsumexp in f32; its backward is a
  second ring in which each block's dK/dV accumulator (f32) travels with
  the block and is home after S rotations, with dQ and dK/dV from the
  kernels given the merged lse and one ``delta = rowsum(dO·O)``.
- **Ulysses**: an all-to-all from sequence to heads, attention over the
  whole sequence on this rank's heads (the flash kernels, or the einsum
  block), and the all-to-all back. Only K/V's own heads ride the
  all-to-all when the sequence size divides the kv heads; otherwise they
  are repeated to the query heads first, as in the JAX package.

``block_impl="auto"`` is the kernels for CUDA tensors and the einsum
path for CPU tensors; ``$DLROVER_TPU_SP_BLOCK_IMPL`` overrides
``"auto"``. Layout: ``(batch, seq, heads, head_dim)`` at the public
functions, with k/v carrying ``kv_heads ≤ heads`` (GQA).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.ops.flash_attention import (
    FlashAttentionFn,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
)
from dlrover_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_,
    all_to_all,
    shift,
)

_NEG_INF = -1e30

BLOCK_IMPLS = ("auto", "flash", "einsum")


def use_flash_blocks(block_impl: str, x: torch.Tensor) -> bool:
    """The per-rank attention ring and Ulysses share: ``"auto"`` (after
    ``$DLROVER_TPU_SP_BLOCK_IMPL``) is the kernels for a CUDA tensor and
    the einsum path for a CPU one; ``"flash"`` and ``"einsum"`` force
    one."""
    if block_impl == "auto":
        block_impl = os.environ.get("DLROVER_TPU_SP_BLOCK_IMPL", "auto")
    block_impl = block_impl.strip().lower()
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"unknown SP block impl {block_impl!r}: expected "
                         f"auto | flash | einsum")
    return block_impl == "flash" or (block_impl == "auto" and x.is_cuda)


def _scale(sm_scale: Optional[float], q: torch.Tensor) -> float:
    return sm_scale if sm_scale is not None else q.shape[-1] ** -0.5


# ===========================================================================
# The einsum ring (the plain version)
# ===========================================================================


def _block_attn(q32, k, v, scale: float, mask: Optional[torch.Tensor]):
    """One Q shard × K/V block: (unnormalized out (B, Lq, H, D) f32,
    block max (B, H, Lq), block sum (B, H, Lq)); k/v already repeated to
    q's heads; ``mask`` additive (Lq, Lk) or None."""
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k.float()) * scale
    if mask is not None:
        s = s + mask
    m = s.amax(dim=-1)
    # a fully masked row (none here, but the reference guards it)
    m_safe = torch.clamp_min(m, _NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m_safe, l


def _online_merge(o, m, l, o_new, m_new, l_new):
    """Merge a new block into the running (o, m, l)."""
    m_next = torch.maximum(m, m_new)
    alpha = torch.exp(m - m_next)
    beta = torch.exp(m_new - m_next)
    l_next = l * alpha + l_new * beta
    o_next = (o * alpha.transpose(1, 2)[..., None]
              + o_new * beta.transpose(1, 2)[..., None])
    return o_next, m_next, l_next


def _causal_mask(length: int, device) -> torch.Tensor:
    pos = torch.arange(length, device=device)
    return torch.where(pos[None, :] > pos[:, None], _NEG_INF,
                       0.0).float()


class _Shift(torch.autograd.Function):
    """K and V rotated one member forward around the group; the backward
    rotates their gradients one member back. One node for both keeps
    every rank's backward collectives in one order."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        return tuple(shift([k, v], group))

    @staticmethod
    def backward(ctx, dk, dv):
        dk, dv = shift([dk, dv], ctx.group, back=True)
        return dk, dv, None


def _ring_einsum(q, k, v, group, causal: bool, scale: float):
    size = dist.get_world_size(group)
    me = dist.get_rank(group)
    batch, l_local, heads, dim = q.shape
    groups = heads // k.shape[2]
    q32 = q.float()
    diag = _causal_mask(l_local, q.device)
    o = torch.zeros((batch, l_local, heads, dim), dtype=torch.float32,
                    device=q.device)
    m = torch.full((batch, heads, l_local), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((batch, heads, l_local), dtype=torch.float32,
                    device=q.device)
    kb, vb = k, v
    for i in range(size):
        kv_idx = (me - i) % size
        # three block kinds: the diagonal (causal mask), an earlier block
        # (no mask) and, when causal, a later one (weight exactly zero:
        # skipped)
        if not causal or kv_idx <= me:
            kr = kb.repeat_interleave(groups, dim=2) if groups > 1 else kb
            vr = vb.repeat_interleave(groups, dim=2) if groups > 1 else vb
            mask = diag if causal and kv_idx == me else None
            o, m, l = _online_merge(o, m, l,
                                    *_block_attn(q32, kr, vr, scale, mask))
        if i < size - 1:
            kb, vb = _Shift.apply(kb, vb, group)
    if causal and size > 1:
        # the last rotation's blocks are skipped on every rank but the
        # last; tied in at weight 0 (exact), every rank's graph holds
        # every rotation, so every rank runs the same reverse shifts
        o = o + 0.0 * (kb.float().sum() + vb.float().sum())
    out = o / torch.clamp_min(l.transpose(1, 2)[..., None], 1e-20)
    return out.to(q.dtype)


# ===========================================================================
# Ring-flash: the kernels on every block
# ===========================================================================


def _merge_normalized(o, lse, o_b, lse_b):
    """Merge (normalized out, lse) accumulators; a -inf lse is empty."""
    lse_n = torch.logaddexp(lse, lse_b)
    w_old = torch.where(torch.isfinite(lse), torch.exp(lse - lse_n), 0.0)
    w_new = torch.where(torch.isfinite(lse_b), torch.exp(lse_b - lse_n),
                        0.0)
    return o * w_old + o_b * w_new, lse_n


def _visible(kv_idx: int, me: int, causal: bool) -> Optional[bool]:
    """The causal flag a block runs the kernels with, or None for a
    block the causal ring skips (it lies after this rank's queries)."""
    if not causal:
        return False
    if kv_idx == me:
        return True
    return False if kv_idx < me else None


class RingFlashFn(torch.autograd.Function):
    """Ring attention with the flash kernels on every block, in the
    kernels' layout: q ``(b, h, l, d)``, k/v ``(b, h_kv, l, d)``, each
    rank's sequence shard. Saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        size = dist.get_world_size(group)
        me = dist.get_rank(group)
        b, h, l_local, _ = q.shape
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, l_local, 1), float("-inf"),
                         dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for i in range(size):
            flag = _visible((me - i) % size, me, causal)
            if flag is not None:
                o_b, lse_b = flash_fwd(q, kb, vb, flag, scale)
                o, lse = _merge_normalized(o, lse, o_b.float(), lse_b)
            if i < size - 1:
                kb, vb = shift([kb, vb], group)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        size = dist.get_world_size(group)
        me = dist.get_rank(group)
        g = g.contiguous()
        # rowsum(dO·O) of the merged output, once for the whole ring
        delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dvb = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for i in range(size):
            flag = _visible((me - i) % size, me, causal)
            if flag is not None:
                dq += flash_bwd_dq(q, kb, vb, g, lse, delta, flag,
                                   scale).float()
                dk_b, dv_b = flash_bwd_dkv(q, kb, vb, g, lse, delta, flag,
                                           scale)
                dkb += dk_b.float()
                dvb += dv_b.float()
            # the dK/dV accumulators travel with their block: after
            # ``size`` rotations both are back at the block's owner
            if i < size - 1:
                kb, vb = shift([kb, vb], group)
            dkb, dvb = shift([dkb, dvb], group)
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None,
                None, None)


# ===========================================================================
# Public API
# ===========================================================================


def ring_attention(q, k, v, group, causal: bool = True,
                   sm_scale: Optional[float] = None,
                   block_impl: str = "auto") -> torch.Tensor:
    """This rank's shard of ring attention: q ``(B, L_local, H, D)``,
    k/v ``(B, L_local, KV, D)`` with KV ≤ H (GQA), the shards laid over
    ``group`` in member order; returns q's shape. Only the K/V shards
    rotate (the kernels group the heads; the einsum path repeats them
    per block)."""
    scale = _scale(sm_scale, q)
    if not use_flash_blocks(block_impl, q):
        return _ring_einsum(q, k, v, group, causal, scale)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = RingFlashFn.apply(qt, kt, vt, group, causal, scale)
    return out.transpose(1, 2)


def _heads_split(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, L, H, D) → (size, B, L, H / size, D): head block j first."""
    b, l, h, d = x.shape
    return x.reshape(b, l, size, h // size, d).permute(2, 0, 1, 3, 4)


class _SeqToHeads(torch.autograd.Function):
    """(B, L_local, H, D) shards of a sequence → (B, L, H / S, D): all of
    it for this member's head block (``all_to_all(split_axis=2,
    concat_axis=1, tiled=True)``); the backward is the inverse. One node
    for q, k and v keeps every rank's backward collectives in one
    order."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(_seq_to_heads(x, group) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(_heads_to_seq(g.contiguous(), ctx.group)
                               for g in grads)


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.group), None


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    size = dist.get_world_size(group)
    got = all_to_all(_heads_split(x, size), group)   # (S, B, L, H/S, D)
    s, b, l, h, d = got.shape
    return got.permute(1, 0, 2, 3, 4).reshape(b, s * l, h, d)


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    size = dist.get_world_size(group)
    b, full, h, d = x.shape
    # sequence block j goes to member j
    blocks = x.reshape(b, size, full // size, h, d).permute(1, 0, 2, 3, 4)
    got = all_to_all(blocks, group)                  # (S, B, L, H/S, D)
    return got.permute(1, 2, 0, 3, 4).reshape(b, full // size, size * h, d)


def check_ulysses_heads(heads: int, size: int, tensor: int = 1) -> None:
    """The reference's divisibility rule: the query heads over the
    sequence axis (and the tensor axis beside it)."""
    if heads % (size * tensor):
        raise ValueError(
            f"{heads} heads not divisible by sequence axis {size}"
            + (f" × tensor axis {tensor}" if tensor > 1 else ""))


def ulysses_attention(q, k, v, group, causal: bool = True,
                      sm_scale: Optional[float] = None,
                      block_impl: str = "auto") -> torch.Tensor:
    """This rank's shard of Ulysses attention, shapes as
    ``ring_attention``: sequence → heads, attention over the whole
    sequence on H / S heads, heads → sequence."""
    size = dist.get_world_size(group)
    check_ulysses_heads(q.shape[2], size)
    scale = _scale(sm_scale, q)
    use_flash = use_flash_blocks(block_impl, q)
    if k.shape[2] % size:
        groups = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    q_full, k_full, v_full = _SeqToHeads.apply(group, q, k, v)
    if use_flash:
        # local q head j maps to local kv head j // rep inside the kernels,
        # the assignment of a repeat before the split
        out = FlashAttentionFn.apply(
            *(t.transpose(1, 2).contiguous()
              for t in (q_full, k_full, v_full)), causal, scale)
        return _HeadsToSeq.apply(out.transpose(1, 2), group)
    rep = q_full.shape[2] // k_full.shape[2]
    if rep > 1:
        k_full = k_full.repeat_interleave(rep, dim=2)
        v_full = v_full.repeat_interleave(rep, dim=2)
    mask = _causal_mask(q_full.shape[1], q.device) if causal else None
    o, _, l = _block_attn(q_full.float(), k_full, v_full, scale, mask)
    out = o / torch.clamp_min(l.transpose(1, 2)[..., None], 1e-20)
    return _HeadsToSeq.apply(out.to(q.dtype), group)


def sequence_attention(impl: str, q, k, v, group, causal: bool = True,
                       block_impl: str = "auto") -> torch.Tensor:
    """``"ring"`` or ``"ulysses"`` on this rank's shards."""
    fn = ulysses_attention if impl == "ulysses" else ring_attention
    return fn(q, k, v, group, causal=causal, block_impl=block_impl)


class _GatherSequence(torch.autograd.Function):
    """(B, L_local, ...) shards → the whole (B, S·L_local, ...) on every
    member; the backward sums the members' gradients of this member's
    block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = all_gather(x, group)                 # (S, B, L, ...)
        return parts.transpose(0, 1).flatten(1, 2)

    @staticmethod
    def backward(ctx, g):
        size = dist.get_world_size(ctx.group)
        me = dist.get_rank(ctx.group)
        g = g.contiguous().clone()
        all_reduce_([g], ctx.group)
        local = g.shape[1] // size
        return g[:, me * local:(me + 1) * local].contiguous(), None


def gather_sequence(x: torch.Tensor, group) -> torch.Tensor:
    """The whole rows of a sequence-sharded ``x`` (B, L_local, ...) on
    every member of ``group``, differentiably."""
    return _GatherSequence.apply(x.contiguous(), group)


def expected_launches(size: int, rank: int, causal: bool, impl: str
                      ) -> Tuple[int, int, int]:
    """(flash_fwd, flash_bwd_dq, flash_bwd_dkv) launches one forward and
    backward of ``impl`` makes on member ``rank`` of ``size``: the causal
    ring runs blocks 0..rank, the non-causal ring every block, Ulysses
    one of each."""
    if impl == "ulysses":
        return 1, 1, 1
    n = rank + 1 if causal else size
    return n, n, n
