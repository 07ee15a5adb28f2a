"""Named-axis mesh over the process group.

Counterpart of ``dlrover_tpu/parallel/mesh.py``. ``MeshSpec`` is the
same: one size per named axis, ``data`` inferred when 0, axes ordered
dcn, data, fsdp, pipe, expert, sequence, tensor (outermost first).
``create_mesh`` lays the world's ranks over those seven axes in
row-major order, the order the JAX package falls back to for CPU
devices, as a ``torch.distributed.device_mesh.DeviceMesh``. A single
process, every axis of size 1, needs no process group: its mesh holds no
``DeviceMesh`` and the trainer built on it is the single-device one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.constants import MeshAxis
from dlrover_tpu_torch.common.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes of each named parallel dim; 1 = unused. data is inferred when
    left at 0 (elastic: it absorbs whatever ranks remain). ``dcn`` is the
    outermost, cross-slice axis."""

    data: int = 0
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    expert: int = 1
    pipe: int = 1
    dcn: int = 1

    def with_total_devices(self, n_devices: int) -> "MeshSpec":
        fixed = (self.fsdp * self.tensor * self.sequence * self.expert
                 * self.pipe * self.dcn)
        if self.data:
            if self.data * fixed != n_devices:
                raise ValueError(
                    f"mesh spec {self} needs {self.data * fixed} devices, "
                    f"got {n_devices}"
                )
            return self
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed dims {fixed}"
            )
        return dataclasses.replace(self, data=n_devices // fixed)

    def axis_sizes(self) -> List[Tuple[str, int]]:
        return [
            (MeshAxis.DCN, self.dcn),
            (MeshAxis.DATA, self.data or 1),
            (MeshAxis.FSDP, self.fsdp),
            (MeshAxis.PIPE, self.pipe),
            (MeshAxis.EXPERT, self.expert),
            (MeshAxis.SEQUENCE, self.sequence),
            (MeshAxis.TENSOR, self.tensor),
        ]

    @property
    def total(self) -> int:
        return math.prod(size for _, size in self.axis_sizes())

    @classmethod
    def from_pairs(cls, pairs: Sequence[Tuple[str, int]]) -> "MeshSpec":
        """atorch-style [("data",2),("tensor",4)]."""
        sizes: Dict[str, int] = {}
        for name, size in pairs:
            if name not in MeshAxis.ALL:
                raise ValueError(f"unknown mesh axis {name!r}; "
                                 f"choose from {MeshAxis.ALL}")
            sizes[name] = sizes.get(name, 1) * size
        return cls(**sizes)


def rank_grid(spec: MeshSpec) -> torch.Tensor:
    """The ranks laid over the spec's axes in row-major order: the rank
    at coordinate (dcn, data, ..., tensor)."""
    return torch.arange(spec.total).reshape(
        [size for _, size in spec.axis_sizes()])


@dataclasses.dataclass
class Mesh:
    """A resolved ``MeshSpec`` on this process's device, with the
    ``DeviceMesh`` over the process group (None for a single process)."""

    spec: MeshSpec
    device: torch.device
    device_mesh: Optional[object] = None
    _flattened: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(self.spec.axis_sizes())

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.spec.axis_sizes())

    def coordinate(self) -> Dict[str, int]:
        """This rank's coordinate on each axis."""
        if self.device_mesh is None:
            return {name: 0 for name in self.axis_names}
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    def submesh(self, names: Sequence[str]):
        """The ``DeviceMesh`` of the named axes; several axes are flattened
        into one dimension, major axis first."""
        names = tuple(names)
        if len(names) == 1:
            return self.device_mesh[names[0]]
        if names not in self._flattened:
            self._flattened[names] = self.device_mesh[names]._flatten(
                "_".join(names))
        return self._flattened[names]


def create_mesh(spec: Optional[MeshSpec] = None,
                device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The mesh of ``spec`` over the process group's world (a single
    process when no group is initialized). Every axis always exists (size
    1 when unused), so placements never special-case a missing axis."""
    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    spec = (spec or MeshSpec()).with_total_devices(world)
    if world == 1:
        return Mesh(spec, device)
    from torch.distributed.device_mesh import DeviceMesh

    names = tuple(name for name, _ in spec.axis_sizes())
    return Mesh(spec, device,
                DeviceMesh(device.type, rank_grid(spec),
                           mesh_dim_names=names))


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes the batch dim is sharded over, jointly and outermost first:
    cross-slice replicas over dcn, then data and fsdp."""
    return (MeshAxis.DCN, MeshAxis.DATA, MeshAxis.FSDP)


def dp_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[axis] for axis in data_axes(mesh))


def dcn_size(mesh: Mesh) -> int:
    """Slices the mesh spans (1 = single slice)."""
    return mesh.shape[MeshAxis.DCN]


def dp_index(mesh: Mesh) -> int:
    """This rank's position on the joint data axes: the block of batch
    rows it holds."""
    coord = mesh.coordinate()
    index = 0
    for axis in data_axes(mesh):
        index = index * mesh.shape[axis] + coord[axis]
    return index
