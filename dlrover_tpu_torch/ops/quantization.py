"""Groupwise int8/int4 quantization: hand-written CUDA kernels for
Hopper, their plain PyTorch versions, int4 packing, the swizzled
(partner-major) layout and the quantized reduction.

Counterpart of ``dlrover_tpu/ops/quantization.py``, with the same
functions, signatures, shapes and dtypes. Its two Pallas kernels
(``_quantize_kernel``, ``_dequantize_kernel``) are
``csrc/quantization.cu`` here, working on groups ``(rows, group)``; the
source says what bounds them. Int4 packing, the swizzle permutation and
``quant_reduce``'s f32 sum stay plain PyTorch, as the reference computes
them outside its kernels.

A CUDA tensor goes to the kernel, or the wrapper raises (x in f32 or
bf16; output f32 or bf16). A CPU tensor goes to the plain version, which
does the kernel's arithmetic to the bit; nothing else falls back.
``launch_counts`` counts the kernel launches, one per wrapper call that
launched.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.ops import _build, _launch

KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# Plain integers, one per kernel: +1 at each launch, nowhere else.
launch_counts: Dict[str, int] = {"quantize": 0, "dequantize": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _qmax(bits: int) -> int:
    if bits == 8:
        return 127
    if bits == 4:
        return 7
    raise ValueError(f"bits must be 4 or 8, got {bits}")


def _rcp(qmax: int) -> float:
    """1/qmax rounded to f32 once. The reference's absmax / qmax divides
    by a constant, which XLA compiles to a product with this reciprocal;
    the kernel and the plain version do the same, and so match the
    reference to the bit."""
    return float(np.float32(1.0) / np.float32(qmax))


# ===========================================================================
# Plain versions (CPU path, and the kernels' yardstick on the card)
# ===========================================================================


def quantize_plain(x2: torch.Tensor, qmax: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 ``(rows, group)``, scales f32 ``(rows, 1)``) of groups
    ``(rows, group)`` as ``_quantize_kernel`` computes them: scale =
    absmax·(1/qmax), inverse 0 for an all-zero group, round half to even,
    clip to ±qmax."""
    x = x2.float()
    scale = x.abs().amax(dim=-1, keepdim=True) * _rcp(qmax)
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    q = torch.round(x * inv).clamp(-qmax, qmax)
    return q.to(torch.int8), scale


def dequantize_plain(q2: torch.Tensor, s2: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q·scale in f32, cast to ``dtype``, as ``_dequantize_kernel``."""
    return (q2.float() * s2).to(dtype)


# ===========================================================================
# CUDA wrappers
# ===========================================================================

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "quantize_rows": [_PTR] * 3 + [ctypes.c_longlong] + [_INT] * 3 + [_PTR],
    "dequantize_rows": [_PTR] * 3 + [ctypes.c_longlong, _INT, _INT, _PTR],
}


def _library() -> ctypes.CDLL:
    return _build.bind("quantization", _SIGNATURES)


def _check_contiguous(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the quantization kernels take contiguous "
                             "tensors")


def quantize_rows(x2: torch.Tensor, qmax: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, scales ``(rows, 1)``) of groups ``(rows, group)``: the quantize
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if x2.dim() != 2:
        raise ValueError(f"groups must be 2-D (rows, group), got "
                         f"{tuple(x2.shape)}")
    if _launch.device_kind("quantization", x2) == "cpu":
        return quantize_plain(x2, qmax)
    if x2.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the quantize kernel takes {KERNEL_DTYPES}, got "
                        f"{x2.dtype}")
    _check_contiguous(x2)
    rows, group = x2.shape
    q = torch.empty(x2.shape, dtype=torch.int8, device=x2.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    if rows * group == 0:
        return q, scales
    lib = _library()
    with torch.cuda.device(x2.device):
        code = lib.quantize_rows(x2.data_ptr(), q.data_ptr(),
                                 scales.data_ptr(), rows, group, qmax,
                                 int(x2.dtype == torch.bfloat16),
                                 _launch.stream(x2))
    _build.check(lib, code, "quantize_rows")
    launch_counts["quantize"] += 1
    return q, scales


def dequantize_rows(q2: torch.Tensor, s2: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q·scale of groups ``(rows, group)`` with scales ``(rows, 1)``: the
    dequantize kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q2.dim() != 2 or tuple(s2.shape) != (q2.shape[0], 1):
        raise ValueError(f"q must be (rows, group) and scales (rows, 1), "
                         f"got {tuple(q2.shape)} and {tuple(s2.shape)}")
    if _launch.device_kind("quantization", q2, s2) == "cpu":
        return dequantize_plain(q2, s2, dtype)
    if q2.dtype != torch.int8 or s2.dtype != torch.float32:
        raise TypeError(f"the dequantize kernel takes int8 q and f32 scales, "
                        f"got {q2.dtype} and {s2.dtype}")
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the dequantize kernel writes {KERNEL_DTYPES}, got "
                        f"{dtype}")
    _check_contiguous(q2, s2)
    rows, group = q2.shape
    out = torch.empty(q2.shape, dtype=dtype, device=q2.device)
    if rows * group == 0:
        return out
    lib = _library()
    with torch.cuda.device(q2.device):
        code = lib.dequantize_rows(q2.data_ptr(), s2.data_ptr(),
                                   out.data_ptr(), rows, group,
                                   int(dtype == torch.bfloat16),
                                   _launch.stream(q2))
    _build.check(lib, code, "dequantize_rows")
    launch_counts["dequantize"] += 1
    return out


# ===========================================================================
# Public API (the reference's)
# ===========================================================================


def quantize(x: torch.Tensor, bits: int = 8, group_size: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Groupwise symmetric quantization over the last dim.

    Returns (q, scales): q int8 — for bits=4, two nibbles packed per int8,
    so the last dim halves; scales f32 with shape x.shape[:-1] +
    (groups,)."""
    qmax = _qmax(bits)
    shape = tuple(x.shape)
    if shape[-1] % group_size:
        raise ValueError(f"last dim {shape[-1]} not divisible by group "
                         f"{group_size}")
    q, scales = quantize_rows(x.reshape(-1, group_size), qmax)
    scales = scales.reshape(shape[:-1] + (shape[-1] // group_size,))
    q = q.reshape(shape)
    if bits == 4:
        q = pack_int4(q)
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor, bits: int = 8,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`."""
    if bits == 4:
        q = unpack_int4(q)
    shape = tuple(q.shape)
    group_size = shape[-1] // scales.shape[-1]
    out = dequantize_rows(q.reshape(-1, group_size), scales.reshape(-1, 1),
                          dtype)
    return out.reshape(shape)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7] → packed nibbles, last dim halves."""
    lo = q[..., 0::2] & 0x0F
    hi = (q[..., 1::2] & 0x0F) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed nibbles → int8 values (sign-extended), last dim doubles."""
    lo = (packed & 0x0F).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = ((packed.to(torch.int32) >> 4) & 0x0F).to(torch.int8)
    hi = torch.where(hi > 7, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(packed.shape[:-1] + (packed.shape[-1] * 2,))


def swizzled_quantize(x: torch.Tensor, partners: int, bits: int = 8,
                      group_size: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize then re-layout partner-major for chunked collectives:
    element i of the flat x goes to partner i % partners, and q has shape
    (partners, chunk) with each partner's chunk contiguous."""
    flat = x.reshape(-1)
    if flat.shape[0] % (partners * group_size):
        raise ValueError("size not divisible by partners*group_size")
    chunk = flat.shape[0] // partners
    swizzled = flat.reshape(chunk, partners).t().contiguous()
    return quantize(swizzled, bits=bits, group_size=group_size)


def unswizzle_dequantize(q: torch.Tensor, scales: torch.Tensor, shape,
                         bits: int = 8,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    partners = q.shape[0]
    deq = dequantize(q, scales, bits=bits, dtype=dtype)
    return deq.reshape(partners, -1).t().reshape(shape)


def quant_reduce(qs: torch.Tensor, scales: torch.Tensor, bits: int = 8,
                 group_size: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce N quantized chunks to one re-quantized chunk: dequantize
    each (one launch over all N), add them in f32 in chunk order, and
    quantize the sum. qs: (N, ...) packed ints; scales: (N, ..., groups)."""
    deq = dequantize(qs, scales, bits=bits)
    total = deq[0]
    for chunk in deq[1:]:
        total = total + chunk
    return quantize(total, bits=bits, group_size=group_size)


# ===========================================================================
# Plain reference (test oracle)
# ===========================================================================


def reference_quantize(x: torch.Tensor, bits: int = 8, group_size: int = 128
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's plain quantize on whole tensors, with no kernel and
    no launch: the oracle the tests hold the kernel path against."""
    qmax = _qmax(bits)
    shape = tuple(x.shape)
    q, scale = quantize_plain(x.reshape(-1, group_size), qmax)
    q = q.reshape(shape)
    scales = scale.reshape(shape[:-1] + (shape[-1] // group_size,))
    if bits == 4:
        q = pack_int4(q)
    return q, scales
