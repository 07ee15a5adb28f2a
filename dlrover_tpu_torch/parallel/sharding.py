"""Logical-axis → mesh-axis sharding rules.

Counterpart of ``dlrover_tpu/parallel/sharding.py``: model parameters
carry logical names (embed, heads, kv, mlp, vocab, norm; each module's
``param_axes``), and one table of rules decides which mesh axis each
name maps to. Changing the strategy is changing the table; the model
code never changes. Where the JAX package turns the table into a
``NamedSharding`` per leaf, the port turns it into the leaf's DTensor
placements, one per mesh dimension in the mesh's axis order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from dlrover_tpu_torch.common.constants import MeshAxis

# (logical axis, mesh axis or None). Megatron mapping: column-parallel
# weights shard their output dim ("heads"/"mlp"/"vocab" → tensor), row-
# parallel shard their input dim; FSDP shards the long "embed" dim.
DEFAULT_RULES: List[Tuple[str, Optional[Any]]] = [
    ("vocab", MeshAxis.TENSOR),
    ("heads", MeshAxis.TENSOR),
    ("kv", MeshAxis.TENSOR),
    ("mlp", MeshAxis.TENSOR),
    ("embed", MeshAxis.FSDP),
    ("expert", MeshAxis.EXPERT),
    ("norm", None),
    # activation layout: batch over the joint dp axes (the trainer's
    # shard_batch), seq and embed unsharded
    ("act_batch", (MeshAxis.DCN, MeshAxis.DATA, MeshAxis.FSDP)),
    ("act_seq", MeshAxis.SEQUENCE),
    ("act_embed", None),
]


def make_sharding_rules(
    fsdp: bool = True,
    tensor: bool = True,
    extra: Sequence[Tuple[str, Optional[str]]] = (),
) -> List[Tuple[str, Optional[Any]]]:
    rules = []
    for logical, axis in DEFAULT_RULES:
        if axis == MeshAxis.TENSOR and not tensor:
            axis = None
        if axis == MeshAxis.FSDP and not fsdp:
            axis = None
        rules.append((logical, axis))
    rules.extend(extra)
    return rules


def logical_axes(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """Parameter name → its logical axes, from each module's
    ``param_axes`` (``{"kernel": ("embed", "heads")}``)."""
    out: Dict[str, Tuple[str, ...]] = {}
    for prefix, module in model.named_modules():
        for name, axes in getattr(module, "param_axes", {}).items():
            out[f"{prefix}.{name}" if prefix else name] = tuple(axes)
    return out


def logical_to_placements(axes: Sequence[Optional[str]],
                          mesh_axes: Sequence[str],
                          rules: Sequence[Tuple[str, Any]]
                          ) -> List[Placement]:
    """One leaf's placements, assigned as flax's ``logical_to_mesh_axes``
    does: the rules in order, each taking the dim of its logical axis if
    that dim is still unassigned and none of its mesh axes is taken; an
    unmatched dim is replicated."""
    assigned: Dict[int, Tuple[str, ...]] = {}
    for name, target in rules:
        if name not in axes:
            continue
        dim = list(axes).index(name)
        targets = (() if target is None else
                   (target,) if isinstance(target, str) else tuple(target))
        taken = {a for t in assigned.values() for a in t}
        if dim not in assigned and not taken & set(targets):
            assigned[dim] = targets
    placements: List[Placement] = [Replicate()] * len(mesh_axes)
    for dim, targets in assigned.items():
        for axis in targets:
            placements[list(mesh_axes).index(axis)] = Shard(dim)
    return placements


def sanitize_shardings(shardings: Mapping[str, Sequence[Placement]],
                       shapes: Mapping[str, Sequence[int]]
                       ) -> Dict[str, List[Placement]]:
    """Replace placements that cannot apply to their leaf's rank (a rule
    carried onto a leaf of another rank, as a factored optimizer's
    statistics) with full replication."""
    out = {}
    for name, placements in shardings.items():
        ndim = len(shapes[name])
        if any(isinstance(p, Shard) and p.dim >= ndim for p in placements):
            placements = [Replicate()] * len(placements)
        out[name] = list(placements)
    return out


def mesh_placements(model: nn.Module, mesh,
                    rules: Optional[Sequence[Tuple[str, Any]]] = None
                    ) -> Dict[str, List[Placement]]:
    """Parameter name → its placements on ``mesh``'s dims (the port's
    ``mesh_shardings``); a parameter without logical axes is
    replicated."""
    rules = list(rules if rules is not None else DEFAULT_RULES)
    axes = logical_axes(model)
    params = dict(model.named_parameters())
    placements = {
        name: logical_to_placements(axes.get(name, ()), mesh.axis_names,
                                    rules)
        for name in params}
    return sanitize_shardings(
        placements, {name: p.shape for name, p in params.items()})


def to_local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or the tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def local_slice(global_shape, device_mesh, placements
                ) -> Tuple[slice, ...]:
    """This rank's slice of a tensor of ``global_shape`` laid out in
    ``placements`` on ``device_mesh``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        global_shape, device_mesh, placements)
    return tuple(slice(o, o + s) for o, s in zip(offset, shape))


def sharded_from_host(host_tree: Mapping[str, Any],
                      targets: Mapping[str, torch.Tensor],
                      in_place: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """Host buffers (numpy arrays or CPU tensors, full values) → tensors
    in the targets' devices, dtypes and placements. A DTensor target
    gets only this rank's shard copied to its device (no second full
    copy on the card, no communication: every rank holds the full host
    value). ``in_place``: each value is copied into its target's own
    storage (its local shard), straight from the host buffer and
    ``non_blocking`` (the caller keeps the buffers alive and synchronizes
    before reading), and the targets are returned: nothing is allocated
    on the card."""
    out = {}
    for name, host in host_tree.items():
        target = targets[name]
        full = torch.as_tensor(np.asarray(host) if not torch.is_tensor(host)
                               else host)
        if in_place:
            local = (full[local_slice(full.shape, target.device_mesh,
                                      target.placements)]
                     if isinstance(target, DTensor) else full)
            to_local(target).copy_(local, non_blocking=True)
            out[name] = target
            continue
        if isinstance(target, DTensor):
            local = full[local_slice(full.shape, target.device_mesh,
                                      target.placements)]
            local = local.to(target.to_local().device, target.dtype)
            out[name] = DTensor.from_local(
                local.contiguous(), target.device_mesh, target.placements,
                run_check=False, shape=target.shape, stride=target.stride())
        else:
            out[name] = full.to(target.device, target.dtype)
    return out


def reshard(tree: Mapping[str, torch.Tensor],
            placements: Mapping[str, Sequence[Placement]]
            ) -> Dict[str, torch.Tensor]:
    """Live DTensors → new placements on their meshes (the collective
    moves the shards); plain tensors pass through."""
    return {name: (t.redistribute(t.device_mesh, placements[name])
                   if isinstance(t, DTensor) else t)
            for name, t in tree.items()}
