"""Quantized gradient mean: int8/int4 codes on the wire.

Counterpart of ``dlrover_tpu/parallel/quant_collectives.py``, over a
process group where the reference runs inside a ``shard_map`` manual
over one mesh axis. The same groupwise-symmetric scheme and the same
arithmetic:

- ``gather`` mode: each member quantizes its gradient once, the codes and
  scales are all-gathered, and every member dequantizes the n versions
  and sums them in member order, then divides by n.
- ``scatter`` mode: each member quantizes its gradient in n chunks, chunk
  i goes to member i (all-to-all), which dequantizes the n versions of
  its chunk, sums them in member order, divides by n, quantizes that
  again and all-gathers the codes.

``auto`` is gather for n ≤ 4. ``bits=4`` packs two codes a byte on the
wire (``pack_int4``); ``bits=0``, a non-float leaf or one under
``MIN_QUANT_SIZE`` elements is the exact mean (sum over the group,
divided by n). The sums run locally in member order, as the reference's
``jnp.sum(axis=0)``, never as a ``dist.all_reduce`` (whose order is the
backend's).

CUDA tensors quantize and dequantize with the port's kernels
(``quantize_rows``/``dequantize_rows``, one launch each per call over
every member's rows); CPU tensors with their plain versions, the same
arithmetic to the bit.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.ops.quantization import (
    dequantize_rows,
    pack_int4,
    quantize_rows,
    unpack_int4,
)
from dlrover_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_,
    all_to_all,
)

DEFAULT_GROUP = 256
# below this many elements the quantization bookkeeping costs more than
# the wire saves: the exact mean
MIN_QUANT_SIZE = 2048

BITS = (8, 4, 0)


def _qmax(bits: int) -> int:
    return 127 if bits == 8 else 7


def _wire_encode(q: torch.Tensor, bits: int) -> torch.Tensor:
    return pack_int4(q) if bits == 4 else q


def _wire_decode(q: torch.Tensor, bits: int) -> torch.Tensor:
    return unpack_int4(q) if bits == 4 else q


def _sum_in_order(deq: torch.Tensor) -> torch.Tensor:
    """deq[0] + deq[1] + ... in member order."""
    total = deq[0]
    for part in deq[1:]:
        total = total + part
    return total


def _dequantize_all(q: torch.Tensor, s: torch.Tensor, bits: int
                    ) -> torch.Tensor:
    """(n, rows, group) codes on the wire and (n, rows, 1) scales → f32
    (n, rows, group), one dequantize over all n members' rows."""
    q = _wire_decode(q, bits)
    n, rows, group = q.shape
    return dequantize_rows(q.reshape(n * rows, group).contiguous(),
                           s.reshape(n * rows, 1).contiguous(),
                           torch.float32).view(n, rows, group)


def _exact_mean(g: torch.Tensor, group, n: int) -> torch.Tensor:
    """The exact mean over ``group`` (the reference's ``lax.pmean``:
    the sum, then a true division, so an integer leaf comes back
    float)."""
    total = g.clone(memory_format=torch.contiguous_format)
    all_reduce_([total], group)
    return total / n


def quantized_pmean_leaf(g: torch.Tensor, group, n: Optional[int] = None,
                         bits: int = 8, group_size: int = DEFAULT_GROUP,
                         mode: str = "auto") -> torch.Tensor:
    """Mean of one gradient leaf over ``group`` (n members) with quantized
    wire traffic; ``bits=0`` is the exact mean."""
    n = dist.get_world_size(group) if n is None else n
    if (bits == 0 or not torch.is_floating_point(g)
            or g.numel() < MIN_QUANT_SIZE):
        return _exact_mean(g, group, n)
    qmax = _qmax(bits)
    if mode == "auto":
        mode = "gather" if n <= 4 else "scatter"
    flat = g.reshape(-1).float()
    # pad so that the groups (and in scatter mode the n chunks) divide
    quantum = group_size * (n if mode == "scatter" else 1)
    pad = (-flat.numel()) % quantum
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    if mode == "gather":
        q, s = quantize_rows(flat.view(-1, group_size), qmax)
        qg = all_gather(_wire_encode(q, bits), group)
        sg = all_gather(s, group)
        out = _sum_in_order(_dequantize_all(qg, sg, bits)) / n
    elif mode == "scatter":
        # chunk i of my gradient goes to member i; I reduce my own index
        q, s = quantize_rows(flat.view(-1, group_size), qmax)
        rows = q.shape[0] // n
        qt = all_to_all(_wire_encode(q, bits).view(n, rows, -1), group)
        st = all_to_all(s.view(n, rows, 1), group)
        chunk = _sum_in_order(_dequantize_all(qt, st, bits)) / n
        # quantize the reduced chunk again for the gather leg
        q2, s2 = quantize_rows(chunk, qmax)
        qg = all_gather(_wire_encode(q2, bits), group)
        sg = all_gather(s2, group)
        out = _dequantize_all(qg, sg, bits)
    else:
        raise ValueError(f"unknown quantized reduce mode {mode!r}: expected "
                         f"auto | gather | scatter")
    out = out.reshape(-1)
    if pad:
        out = out[:g.numel()]
    return out.to(g.dtype).reshape(g.shape)


def quantized_pmean(tree: Any, group, n: Optional[int] = None,
                    bits: int = 8, group_size: int = DEFAULT_GROUP,
                    mode: str = "auto") -> Any:
    """The quantized mean of every leaf of a dict, list or tuple of
    tensors (a tensor is one leaf); ``bits=0`` is the exact mean of every
    leaf."""
    if bits not in BITS:
        raise ValueError(f"grad-reduce bits must be 8, 4 or 0, got {bits}")
    if isinstance(tree, dict):
        return {key: quantized_pmean(value, group, n, bits, group_size,
                                     mode) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantized_pmean(value, group, n, bits,
                                          group_size, mode)
                          for value in tree)
    return quantized_pmean_leaf(tree, group, n, bits, group_size, mode)
