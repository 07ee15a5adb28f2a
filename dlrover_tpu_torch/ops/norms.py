"""RMSNorm: hand-written CUDA kernels for Hopper, their plain PyTorch
versions, the autograd function that joins them, and the plain norm.

Counterpart of ``dlrover_tpu/ops/norms.py``. Its two Pallas kernels
(``_rms_fwd_kernel``, ``_rms_bwd_kernel``) are ``csrc/norms.cu`` here;
the source says what bounds each one and how it is laid out. The kernel
functions take rows ``(rows, dim)``: x in bf16 or f32, w ``(dim,)`` f32,
rstd ``(rows, 1)`` f32 as the reference saves it. ``fused_rms_norm``
takes any leading shape.

A CUDA tensor goes to the kernel, or the wrapper raises. A CPU tensor
goes to the plain version, which repeats the kernel's arithmetic and
rounding points in f32; nothing else falls back. ``launch_counts``
counts the kernel launches, one per wrapper call that launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from dlrover_tpu_torch.ops import _build, _launch

# csrc/norms.cu: a thread owns 8 columns of a row in each of at most 4
# places of a 1024-thread block
MAX_DIM = 4 * 1024 * 8
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Plain integers, one per kernel: +1 at each launch, nowhere else.
launch_counts: Dict[str, int] = {"rms_fwd": 0, "rms_bwd": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ===========================================================================
# Plain versions (CPU path, and the kernels' yardstick on the card)
# ===========================================================================


def reference_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x²) + eps) * weight in f32, returned in x.dtype:
    the ``norm_impl="reference"`` path, differentiated by autograd."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or f64 if it is f64 (so that gradcheck can run)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rms_fwd_plain(x: torch.Tensor, w: torch.Tensor, eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, rstd) as ``_rms_fwd_kernel`` computes them: f32 math,
    ``(x·rstd)·w`` in that order, y rounded to x.dtype, rstd ``(rows, 1)``
    f32."""
    xf = _wide(x)
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rstd * _wide(w)).to(x.dtype), rstd


def rms_bwd_plain(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                  g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) as ``_rms_bwd_kernel`` and ``_rms_bwd_vjp`` compute them:
    dx = rstd·(g·w − x̂·mean(g·w·x̂)) rounded to x.dtype, dw = Σrows g·x̂
    in f32."""
    xhat = _wide(x) * rstd
    gf = _wide(g)
    wg = gf * _wide(w)
    mean = (wg * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (wg - xhat * mean)).to(x.dtype)
    return dx, (gf * xhat).sum(dim=0)


# ===========================================================================
# CUDA wrappers
# ===========================================================================

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "rms_bwd_grid": [_INT] * 3,
    "rms_fwd": [_PTR] * 4 + [_INT] * 2 + [ctypes.c_float, _INT, _PTR],
    "rms_bwd": [_PTR] * 7 + [_INT] * 4 + [_PTR],
}


def _library() -> ctypes.CDLL:
    return _build.bind("norms", _SIGNATURES)


def _check_rows(x: torch.Tensor, w: torch.Tensor, rstd=None, g=None) -> str:
    """Validate the shapes every path takes; return the common device's
    type ('cpu' or 'cuda')."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (rows, dim), got {tuple(x.shape)}")
    rows, dim = x.shape
    if tuple(w.shape) != (dim,):
        raise ValueError(f"w must have shape {(dim,)}, got {tuple(w.shape)}")
    if rstd is not None and tuple(rstd.shape) != (rows, 1):
        raise ValueError(f"rstd must have shape {(rows, 1)}, got "
                         f"{tuple(rstd.shape)}")
    if g is not None and g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)}")
    return _launch.device_kind(
        "RMSNorm", *(t for t in (x, w, rstd, g) if t is not None))


def _check_kernel_inputs(x: torch.Tensor, f32s, g=None) -> None:
    """What the CUDA kernels take beyond the shapes: x (and g, of x's
    type) in bf16 or f32, w and rstd in f32, 1 <= dim <= MAX_DIM, no empty
    rows, contiguous and 16-byte aligned."""
    rows, dim = x.shape
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the RMSNorm kernels take x in {KERNEL_DTYPES}, got "
                        f"{x.dtype}")
    if g is not None and g.dtype != x.dtype:
        raise TypeError(f"g must be {x.dtype} like x, got {g.dtype}")
    for t in f32s:
        if t.dtype != torch.float32:
            raise TypeError(f"the RMSNorm kernels take w and rstd in "
                            f"torch.float32, got {t.dtype}")
    if rows == 0 or not 1 <= dim <= MAX_DIM:
        raise ValueError(f"the RMSNorm kernels take 1 <= dim <= {MAX_DIM} "
                         f"and at least one row, got {tuple(x.shape)}")
    for t in (x, g, *f32s):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("the RMSNorm kernels take contiguous, 16-byte "
                             "aligned tensors")


def rms_fwd(x: torch.Tensor, w: torch.Tensor, eps: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, rstd) of rows x ``(rows, dim)``: the forward kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if _check_rows(x, w) == "cpu":
        return rms_fwd_plain(x, w, eps)
    _check_kernel_inputs(x, (w,))
    rows, dim = x.shape
    lib = _library()
    y = torch.empty_like(x)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.rms_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                           rstd.data_ptr(), rows, dim, eps,
                           int(x.dtype == torch.bfloat16), _launch.stream(x))
    _build.check(lib, code, "rms_fwd")
    launch_counts["rms_fwd"] += 1
    return y, rstd


def rms_bwd(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
            g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw): the backward kernel (and its sum of the per-block dw
    partials) for CUDA tensors, the plain version for CPU tensors."""
    if _check_rows(x, w, rstd, g) == "cpu":
        return rms_bwd_plain(x, w, rstd, g)
    _check_kernel_inputs(x, (w, rstd), g)
    rows, dim = x.shape
    lib = _library()
    is_bf16 = int(x.dtype == torch.bfloat16)
    dx = torch.empty_like(x)
    dw = torch.empty((dim,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        grid = lib.rms_bwd_grid(rows, dim, is_bf16)
        partials = torch.empty((grid, dim), dtype=torch.float32,
                               device=x.device)
        code = lib.rms_bwd(x.data_ptr(), w.data_ptr(), rstd.data_ptr(),
                           g.data_ptr(), dx.data_ptr(), partials.data_ptr(),
                           dw.data_ptr(), rows, dim, grid, is_bf16,
                           _launch.stream(x))
    _build.check(lib, code, "rms_bwd")
    launch_counts["rms_bwd"] += 1
    return dx, dw


# ===========================================================================
# Public API
# ===========================================================================


class FusedRMSNormFn(torch.autograd.Function):
    """RMSNorm over the last dim of rows ``(rows, dim)`` with the backward
    kernel as its backward. Saves (x, w, rstd), as ``_rms_fwd`` does."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        y, rstd = rms_fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, rstd = ctx.saved_tensors
        dx, dw = rms_bwd(x, w, rstd, g.contiguous())
        return dx, dw.to(w.dtype), None


def _rms_local(x: torch.Tensor, weight: torch.Tensor,
               eps: float) -> torch.Tensor:
    dim = x.shape[-1]
    y = FusedRMSNormFn.apply(x.reshape(-1, dim).contiguous(), weight.float(),
                             eps)
    return y.reshape(x.shape)


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, x * rsqrt(mean(x²) + eps) * weight, of
    any leading shape, differentiable through the kernels; y in x.dtype.
    The weight is taken in f32, as the reference's kernel does.

    DTensors (tensor parallelism keeps the weight replicated) reach the
    kernels as their local shards through ``local_map``: x may be
    sharded over any dim but the normalized one, and a pending sum (the
    residual stream after a row-parallel product) is reduced first, as
    a row-parallel layer's output always is; the weight must be
    replicated; y has x's placement, any pending sum reduced."""
    if not any(isinstance(t, DTensor) for t in (x, weight)):
        return _rms_local(x, weight, eps)
    if not isinstance(x, DTensor) or not isinstance(weight, DTensor):
        raise ValueError("fused_rms_norm takes x and the weight both as "
                         "DTensors or both as tensors")
    x_placements = [Replicate() if p.is_partial() else p
                    for p in x.placements]
    if not (all(isinstance(p, Replicate) for p in weight.placements)
            and all(isinstance(p, Replicate)
                    or (isinstance(p, Shard) and p.dim != x.ndim - 1)
                    for p in x_placements)):
        raise ValueError(f"fused_rms_norm takes a replicated weight and x "
                         f"unsharded over its last dim, got "
                         f"{x.placements} and {weight.placements}")
    return local_map(
        functools.partial(_rms_local, eps=eps), out_placements=x_placements,
        in_placements=(x_placements, list(weight.placements)),
        device_mesh=x.device_mesh, redistribute_inputs=True)(x, weight)


# ===========================================================================
# How close a kernel must come to its plain version in f32
# ===========================================================================

# rstd, dw, and y / dx of an f32 x: the kernel sums a row (or dw's
# column) in another order than the plain version and takes rsqrtf
# (within 2 ulps) for rsqrt, so an element may sit a few f32 ulps apart,
# and a sum of many terms of both signs a few ulps of its terms' size.
# Each element is allowed F32_REL of the reference's RMS plus of its own
# size: 1e-5 is about 80 ulps.
F32_REL = 1e-5


def f32_error(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """``max_abs``, and ``worst`` = the largest ratio of an element's
    error to its allowance F32_REL·(rms(want) + |want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = want.square().mean().sqrt()
    allow = (F32_REL * (rms + want.abs())).clamp_min(
        torch.finfo(torch.float32).tiny)
    return {"max_abs": err.max().item(), "worst": (err / allow).max().item()}
