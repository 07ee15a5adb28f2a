"""Quantized checkpoint codec: int8/int4 state dicts for flash checkpoints.

Counterpart of ``dlrover_tpu/checkpoint/quantized.py``, with the same
rule, layout and arithmetic, over a flat ``state_dict`` (name → tensor)
instead of a pytree:

- ``encode_tree(state)``: every *eligible* float leaf becomes
  ``{"__quant__", "q", "s"}``, int8 codes and f32 groupwise scales, by
  ``_mode``: "row" (the last dim divides by the group; layout kept),
  "flat" (flattened and zero-padded to the group) or "raw" (not worth
  it; the leaf rides along as it is). Codes and scales come from
  ``ops/quantization.py``'s ``quantize_rows``: the kernel for CUDA
  tensors, its plain version for CPU tensors, the arithmetic of JAX's
  ``_quantize_groups`` to the bit. A DTensor leaf quantizes its own
  shard when every shard boundary falls on a group boundary, and keeps
  its placements; otherwise it is gathered first (see ``_encode_leaf``).
- ``abstract_encoded(state)``: the load target matching the encoding of
  a state laid out as ``state``, in host memory: codes keep the leaf's
  placements on every dim but the (group-quantized) last one, scales
  take the codes' placements.
- ``decode_tree(encoded, state)``: ``dequantize_rows`` (kernel or plain
  version) on the device of each target leaf, cast to its dtype and laid
  out in its placements.

Eligibility is a pure function of a leaf's dtype and global shape, so
the save and restore sides always agree on the structure.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from dlrover_tpu_torch.ops.quantization import (
    dequantize_rows,
    pack_int4,
    quantize_rows,
    unpack_int4,
)
from dlrover_tpu_torch.parallel.sharding import (
    local_slice,
    sharded_from_host,
    to_local,
)

_TAG = "__quant__"
DEFAULT_GROUP = 128
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _qmax(bits: int) -> int:
    if bits not in (8, 4):
        raise ValueError(f"checkpoint quantization bits must be 8 or 4, "
                         f"got {bits}")
    return 127 if bits == 8 else 7


def _mode(leaf: torch.Tensor, group_size: int) -> str:
    """row: groupwise over the (divisible) last dim, layout preserved.
    flat: flatten + zero-pad to the group size (ragged or small last
    dims). raw: not worth compressing."""
    if not (leaf.dtype.is_floating_point and leaf.ndim >= 1):
        return "raw"
    if leaf.shape[-1] % group_size == 0 and leaf.shape[-1] > 0:
        return "row"
    if leaf.numel() >= group_size:
        return "flat"
    return "raw"


def _is_encoded(node: Any) -> bool:
    return isinstance(node, dict) and _TAG in node


def _contiguous_stride(shape: Sequence[int]) -> tuple:
    return torch.empty(shape, device="meta").stride()


def _shapes(shape: Sequence[int], bits: int, group_size: int, mode: str):
    """(codes' shape, scales' shape) of a leaf of global ``shape``."""
    pack = 2 if bits == 4 else 1
    if mode == "flat":
        size = math.prod(shape)
        padded = size + (-size) % group_size
        return (padded // pack,), (padded // group_size,)
    return (tuple(shape[:-1]) + (shape[-1] // pack,),
            tuple(shape[:-1]) + (shape[-1] // group_size,))


def _quantize_leaf(x: torch.Tensor, bits: int, group_size: int,
                   mode: str) -> dict:
    """JAX's ``_quantize_leaf`` on a plain tensor."""
    qmax = _qmax(bits)
    if mode == "flat":
        flat = x.reshape(-1).float()
        pad = (-flat.shape[0]) % group_size
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        x2 = flat.reshape(-1, group_size)
    else:
        x2 = x.reshape(-1, group_size)
        if x2.dtype not in _KERNEL_DTYPES:
            x2 = x2.float()
    q, scale = quantize_rows(x2.contiguous(), qmax)
    if mode == "flat":
        q, scales = q.reshape(-1), scale.reshape(-1)
    else:
        q = q.reshape(x.shape)
        scales = scale.reshape(tuple(x.shape[:-1])
                               + (x.shape[-1] // group_size,))
    if bits == 4:
        q = pack_int4(q)
    return {_TAG: torch.tensor(bits, dtype=torch.int32), "q": q,
            "s": scales}


def _groups_stay_local(leaf: DTensor, group_size: int) -> bool:
    """Every shard of the last dim starts and ends on a group boundary:
    at most one mesh dim shards it, in chunks of a multiple of the group
    (torch's chunking: ceil(n / k) a shard, the last one shorter)."""
    last = leaf.ndim - 1
    shards = [mesh_dim for mesh_dim, p in enumerate(leaf.placements)
              if isinstance(p, Shard) and p.dim == last]
    if not all(isinstance(p, (Shard, Replicate)) for p in leaf.placements):
        return False
    if not shards:
        return True
    if len(shards) > 1:
        return False
    chunk = -(-leaf.shape[-1] // leaf.device_mesh.size(shards[0]))
    return chunk % group_size == 0


def _encode_leaf(leaf: torch.Tensor, bits: int, group_size: int):
    mode = _mode(leaf, group_size)
    if mode == "raw":
        return leaf
    if not isinstance(leaf, DTensor):
        return _quantize_leaf(leaf, bits, group_size, mode)
    if mode == "row" and _groups_stay_local(leaf, group_size):
        node = _quantize_leaf(leaf.to_local(), bits, group_size, mode)
        for key, shape in zip(("q", "s"), _shapes(leaf.shape, bits,
                                                  group_size, mode)):
            node[key] = DTensor.from_local(
                node[key], leaf.device_mesh, leaf.placements,
                run_check=False, shape=shape,
                stride=_contiguous_stride(shape))
        return node
    # a shard boundary inside a group (or a flat leaf, whose groups run
    # across rows): each rank's groups would differ from the whole
    # leaf's, and the codes from JAX's. Gather this one leaf and encode
    # it whole; every rank holds the same codes, saved once.
    return _quantize_leaf(leaf.full_tensor(), bits, group_size, mode)


def encode_tree(state: Mapping[str, torch.Tensor], bits: int = 8,
                group_size: int = DEFAULT_GROUP) -> Dict[str, Any]:
    """Quantize eligible leaves where they lie (the kernels for leaves on
    the card), one leaf at a time."""
    _qmax(bits)
    return {name: _encode_leaf(leaf, bits, group_size)
            for name, leaf in state.items()}


def _host_like(shape, dtype, template: torch.Tensor, placements):
    """An empty host tensor of global ``shape``, as a DTensor in
    ``placements`` on the template's mesh when the template is one."""
    if not isinstance(template, DTensor):
        return torch.empty(shape, dtype=dtype)
    local = [s.stop - s.start for s in local_slice(
        shape, template.device_mesh, placements)]
    return DTensor.from_local(
        torch.empty(local, dtype=dtype), template.device_mesh, placements,
        run_check=False, shape=shape, stride=_contiguous_stride(shape))


def abstract_encoded(state: Mapping[str, torch.Tensor], bits: int = 8,
                     group_size: int = DEFAULT_GROUP) -> Dict[str, Any]:
    """The load target of ``encode_tree``'s output for a state laid out
    as ``state`` (its leaves' dtypes, shapes and placements; raw leaves
    are ``state``'s own tensors, loaded in place). Codes and scales are
    host buffers: a checkpoint read lands there and crosses to the card
    one leaf at a time in ``decode_tree``."""
    out: Dict[str, Any] = {}
    for name, leaf in state.items():
        mode = _mode(leaf, group_size)
        if mode == "raw":
            out[name] = leaf
            continue
        q_shape, s_shape = _shapes(leaf.shape, bits, group_size, mode)
        placements = None
        if isinstance(leaf, DTensor):
            last = leaf.ndim - 1
            placements = [Replicate() if mode == "flat" or (
                isinstance(p, Shard) and p.dim == last) else p
                for p in leaf.placements]
        out[name] = {
            _TAG: torch.tensor(bits, dtype=torch.int32),
            "q": _host_like(q_shape, torch.int8, leaf, placements),
            "s": _host_like(s_shape, torch.float32, leaf, placements),
        }
    return out


def decode_tree(encoded: Mapping[str, Any],
                state: Mapping[str, torch.Tensor], bits: int = 8,
                group_size: int = DEFAULT_GROUP) -> Dict[str, torch.Tensor]:
    """Dequantize back into ``state``'s dtypes, devices and placements:
    each leaf's codes cross to its device, are dequantized there and laid
    out as the target (a local slice, no communication)."""
    if set(encoded) != set(state):
        raise ValueError(
            f"encoded tree has {len(encoded)} leaves, target {len(state)} "
            f"— quantization eligibility drifted between save and restore")
    out: Dict[str, torch.Tensor] = {}
    for name, target in state.items():
        node = encoded[name]
        if not _is_encoded(node):
            out[name] = node
            continue
        mode = _mode(target, group_size)
        device = to_local(target).device
        q = to_local(node["q"]).to(device)
        s = to_local(node["s"]).to(device)
        if bits == 4:
            q = unpack_int4(q)
        dtype = target.dtype if target.dtype in _KERNEL_DTYPES else \
            torch.float32
        if mode == "flat":
            full = dequantize_rows(q.reshape(-1, group_size),
                                   s.reshape(-1, 1), dtype).reshape(-1)
            full = full[:target.numel()].to(target.dtype).reshape(
                target.shape)
            out[name] = sharded_from_host({name: full}, {name: target})[name]
            continue
        groups = s.shape[-1]
        value = dequantize_rows(q.reshape(-1, q.shape[-1] // groups),
                                s.reshape(-1, 1), dtype)
        value = value.to(target.dtype).reshape(q.shape)
        if isinstance(target, DTensor) and not isinstance(node["q"],
                                                          DTensor):
            # codes of a gathered leaf: the whole value on every rank
            value = sharded_from_host({name: value}, {name: target})[name]
        elif isinstance(target, DTensor):
            value = DTensor.from_local(
                value, target.device_mesh, node["q"].placements,
                run_check=False, shape=target.shape,
                stride=target.stride()).redistribute(
                    target.device_mesh, target.placements)
        out[name] = value
    return out


def encoded_nbytes(encoded: Mapping[str, Any]) -> int:
    """Payload bytes of an encoded (or plain) state: every tensor's
    global size."""
    total = 0
    for node in encoded.values():
        leaves = node.values() if isinstance(node, dict) else (node,)
        total += sum(t.numel() * t.element_size() for t in leaves
                     if torch.is_tensor(t))
    return total
