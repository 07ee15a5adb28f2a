"""Flash attention: hand-written CUDA kernels for Hopper, their plain
PyTorch versions, and the autograd function that joins them.

Counterpart of ``dlrover_tpu/ops/flash_attention.py``. The three Pallas
kernels there (``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``)
are ``csrc/flash_attention.cu`` here; the source says what bounds each
one and how it is laid out. Layout at every public function is the JAX
one: q ``(b, h, s_q, d)``, k/v ``(b, h_kv, s_k, d)`` with ``h`` a
multiple of ``h_kv`` (GQA), lse and delta ``(b, h, s_q, 1)`` f32, the
lse in natural-log units. The causal mask is top-left (``q_idx >=
k_idx``), as in the reference.

A CUDA tensor goes to the kernel, or the wrapper raises (bf16 and
head_dim 64 or 128 only). A CPU tensor goes to the plain version, which
repeats the kernel's arithmetic and rounding points in f32; nothing else
falls back. ``launch_counts`` counts the kernel launches, one per
wrapper call that launched.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from dlrover_tpu_torch.ops import _build, _launch

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

HEAD_DIMS = (64, 128)

# Plain integers, one per kernel: +1 at each launch, nowhere else.
launch_counts: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _scale(sm_scale: Optional[float], q: torch.Tensor) -> float:
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


# ===========================================================================
# Plain versions (CPU path, and the kernels' yardstick on the card)
# ===========================================================================


def _repeat_kv(t: torch.Tensor, group: int) -> torch.Tensor:
    return t if group == 1 else t.repeat_interleave(group, dim=1)


def _scores_log2(q, k, scale: float, causal: bool) -> torch.Tensor:
    """f32 scores in the exp2 domain, masked top-left with NEG_INF."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    if causal:
        seq_q, seq_k = q.shape[2], k.shape[2]
        keep = torch.ones(seq_q, seq_k, dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) as ``_flash_fwd`` computes them: o in q.dtype, lse
    ``(b, h, s_q, 1)`` f32 in natural-log units; P rounded to v.dtype
    before P·V."""
    group = q.shape[1] // k.shape[1]
    k, v = _repeat_kv(k, group), _repeat_kv(v, group)
    s = _scores_log2(q, k, _scale(sm_scale, q), causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (acc / l_safe).to(q.dtype)
    lse = (m + torch.log2(l_safe)) * LN2
    return o, lse


def _probs_and_ds(q, k, v, do, lse, delta, scale: float, causal: bool):
    """Recomputed P = exp2(s - lse·log2e) and dS = P·(dO·Vᵀ − delta)·scale
    (f32), with k/v already repeated to q's heads."""
    s = _scores_log2(q, k, scale, causal)
    p = torch.exp2(s - lse.float() * LOG2E)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta.float()) * scale
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
    """dQ as ``_bwd_dq_kernel`` computes it: dS rounded to k.dtype before
    dS·K; dq in q.dtype."""
    group = q.shape[1] // k.shape[1]
    k, v = _repeat_kv(k, group), _repeat_kv(v, group)
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, _scale(sm_scale, q),
                          causal)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) as ``_bwd_dkv_kernel`` computes them per query head (P
    rounded to dO.dtype, dS to q.dtype), summed over each GQA group in
    f32 before the one cast to k.dtype/v.dtype — the kernel's order, which
    is more exact than the reference's cast before the group sum."""
    b, h_kv, s_k, d = k.shape
    group = q.shape[1] // h_kv
    kr, vr = _repeat_kv(k, group), _repeat_kv(v, group)
    p, ds = _probs_and_ds(q, kr, vr, do, lse, delta, _scale(sm_scale, q),
                          causal)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dk = dk.reshape(b, h_kv, group, s_k, d).sum(dim=2)
    dv = dv.reshape(b, h_kv, group, s_k, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


# ===========================================================================
# CUDA wrappers
# ===========================================================================

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "flash_fwd_bf16": [_PTR] * 5 + [_INT] * 6 + [ctypes.c_float, _INT, _PTR],
    "flash_bwd_dq_bf16": [_PTR] * 7 + [_INT] * 6
    + [ctypes.c_float, _INT, _PTR],
    "flash_bwd_dkv_bf16": [_PTR] * 8 + [_INT] * 6
    + [ctypes.c_float, _INT, _PTR],
}


def _library() -> ctypes.CDLL:
    return _build.bind("flash_attention", _SIGNATURES)


def _check_shapes(q, k, v, do=None, lse=None, delta=None) -> Tuple[int, ...]:
    """Validate the shapes every path takes; return (b, h, h_kv, s_q, s_k,
    d)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (batch, heads, seq, head_dim)")
    b, h, s_q, d = q.shape
    bk, h_kv, s_k, dk = k.shape
    if bk != b or dk != d or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    if h_kv == 0 or h % h_kv:
        raise ValueError(f"{h} query heads are not a multiple of {h_kv} "
                         f"kv heads")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and tuple(t.shape) != (b, h, s_q, 1):
            raise ValueError(f"{name} must have shape {(b, h, s_q, 1)}, "
                             f"got {tuple(t.shape)}")
    return b, h, h_kv, s_q, s_k, d


def _check_kernel_inputs(bf16s, f32s, dims) -> None:
    """What the CUDA kernels take beyond the shapes: bf16 operands, f32
    row statistics, head_dim 64 or 128, nothing empty, contiguous and
    16-byte aligned."""
    b, h, _, s_q, s_k, d = dims
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the CUDA kernels "
                         f"(supported: {HEAD_DIMS})")
    if min(b, h, s_q, s_k) == 0:
        raise ValueError("flash attention on an empty tensor")
    for want, tensors in ((torch.bfloat16, bf16s), (torch.float32, f32s)):
        for t in tensors:
            if t.dtype != want:
                raise TypeError(f"the CUDA kernels take {want} here, got "
                                f"{t.dtype}")
    for t in (*bf16s, *f32s):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the CUDA kernels take contiguous, 16-byte "
                             "aligned tensors")


def flash_fwd(q, k, v, causal: bool = True,
              sm_scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the forward kernel for CUDA tensors, the plain version
    for CPU tensors."""
    dims = _check_shapes(q, k, v)
    if _launch.device_kind("flash attention", q, k, v) == "cpu":
        return flash_fwd_plain(q, k, v, causal, sm_scale)
    _check_kernel_inputs((q, k, v), (), dims)
    b, h, h_kv, s_q, s_k, d = dims
    lib = _library()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_q, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = lib.flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, h_kv, s_q, s_k, d, _scale(sm_scale, q),
            int(causal), _launch.stream(q))
    _build.check(lib, code, "flash_fwd_bf16")
    launch_counts["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """dQ: the dQ kernel for CUDA tensors, the plain version for CPU."""
    dims = _check_shapes(q, k, v, do, lse, delta)
    if _launch.device_kind("flash attention", q, k, v, do, lse,
                           delta) == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
    _check_kernel_inputs((q, k, v, do), (lse, delta), dims)
    b, h, h_kv, s_q, s_k, d = dims
    lib = _library()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dq_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, h_kv,
            s_q, s_k, d, _scale(sm_scale, q), int(causal),
            _launch.stream(q))
    _build.check(lib, code, "flash_bwd_dq_bf16")
    launch_counts["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  sm_scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), summed over each GQA group: the dK/dV kernel for CUDA
    tensors, the plain version for CPU."""
    dims = _check_shapes(q, k, v, do, lse, delta)
    if _launch.device_kind("flash attention", q, k, v, do, lse,
                           delta) == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                   sm_scale)
    _check_kernel_inputs((q, k, v, do), (lse, delta), dims)
    b, h, h_kv, s_q, s_k, d = dims
    lib = _library()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dkv_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, h_kv, s_q, s_k, d, _scale(sm_scale, q), int(causal),
            _launch.stream(q))
    _build.check(lib, code, "flash_bwd_dkv_bf16")
    launch_counts["flash_bwd_dkv"] += 1
    return dk, dv


# ===========================================================================
# Public API
# ===========================================================================


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the dQ and dK/dV kernels as its backward.
    Saves (q, k, v, o, lse); delta = rowsum(dO·O) is computed in f32
    outside the kernels, as ``_flash_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: Optional[float]):
        o, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                               ctx.sm_scale)
        return dq, dk, dv, None, None


def _flash_local(q, k, v, causal: bool, sm_scale: Optional[float]):
    return FlashAttentionFn.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal, sm_scale)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over (b, h, s, d) tensors, differentiable
    through the kernels.

    DTensors (tensor parallelism shards heads) reach the kernels as their
    local shards through ``local_map``: q, k and v must share one
    placement, sharded over batch or heads only, so that each rank's
    query heads and the kv heads of their GQA groups are local; the
    output has that placement. Nothing is gathered."""
    if not any(isinstance(t, DTensor) for t in (q, k, v)):
        return _flash_local(q, k, v, causal, sm_scale)
    placements = q.placements if isinstance(q, DTensor) else None
    for t in (q, k, v):
        if not isinstance(t, DTensor) or t.placements != placements:
            raise ValueError("flash attention takes q, k and v as DTensors "
                             "of one placement")
    if not all(isinstance(p, Replicate)
               or (isinstance(p, Shard) and p.dim in (0, 1))
               for p in placements):
        raise ValueError(f"flash attention shards over batch or heads "
                         f"only, got {placements}")
    return local_map(
        functools.partial(_flash_local, causal=causal, sm_scale=sm_scale),
        out_placements=list(placements),
        in_placements=(list(placements),) * 3,
        device_mesh=q.device_mesh)(q, k, v)


def reference_attention(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention with the same semantics (f32 math, output in
    q.dtype): the ``attn_impl="reference"`` path and the test oracle."""
    scale = _scale(sm_scale, q)
    group = q.shape[1] // k.shape[1]
    k, v = _repeat_kv(k, group), _repeat_kv(v, group)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


# ===========================================================================
# How close a kernel must come to its plain version
# ===========================================================================

# Kernel and plain version round o, P and dS to bf16 from f32 sums taken
# in another order, so an element may sit a few bf16 ulps apart. Each
# element is allowed BF16_ATOL·rms(want) + BF16_RTOL·|want|, and the
# whole tensor BF16_REL_L2·||want||. The scale is the reference's RMS,
# never its largest element: in a causal run row 0 of o (= v[0]) and key
# 0 of dK/dV (summed over every query) are outliers several times the
# RMS, and a limit taken from them would pass an error of typical size.
# An element of dK/dV sums up to s_q rounded dS terms, so its error
# follows the size of its terms more than its own: a right kernel came
# to half of each allowance (H100, causal s_q 512 < s_k 1024, where the
# zero rows past s_q halve the RMS), and a fault of a typical size on a
# part of the tensor exceeds it tenfold or more.
BF16_RTOL = 2.0 ** -5
BF16_ATOL = 2.0 ** -4
BF16_REL_L2 = 2.0 ** -7


def bf16_error(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """``max_abs``; ``rel_l2`` = ||got − want|| / ||want||; ``worst`` =
    the largest ratio of an element's error to its allowance."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = want.square().mean().sqrt()
    allow = (BF16_ATOL * rms + BF16_RTOL * want.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    return {"max_abs": err.max().item(),
            "rel_l2": (err.norm() / want.norm().clamp_min(
                torch.finfo(torch.float32).tiny)).item(),
            "worst": (err / allow).max().item()}


def bf16_within_tolerance(error: Dict[str, float]) -> bool:
    return error["worst"] <= 1.0 and error["rel_l2"] <= BF16_REL_L2
