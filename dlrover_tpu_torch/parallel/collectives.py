"""The collectives of sequence parallelism and the quantized reduce,
over a ``torch.distributed`` process group.

The JAX package's ``ppermute``, ``all_to_all``, ``all_gather`` and
``psum`` run inside ``shard_map`` over a mesh axis; here each is a call
over that axis's process group (``Mesh.submesh([axis]).get_group()``):

- ``shift``: every member sends its tensors to the next member of the
  group and receives the previous member's (the ring's rotation,
  ``ppermute`` with ``(j, j + 1)``);
- ``all_to_all``: ``x.shape[0]`` chunks, chunk ``j`` to member ``j``;
  the result's chunk ``i`` came from member ``i``;
- ``all_gather``: every member's tensor stacked in member order;
- ``all_reduce_``: the sum over the group, in place.

Under NCCL each moves device tensors directly. Under gloo a CUDA tensor
crosses through page-locked host memory: it is copied down, the
collective runs on the host copy, and the result is copied back up. That
is the one branch on the group's backend (``host_staged``), and its
seconds are counted in ``staging_seconds`` (the copies and the host
collective, which the card's stream waits for) so a caller can print
them. gloo runs one collective of a group at a time, so a host-staged
buffer is split over the group's lanes (``set_lanes``: more groups of
the same ranks, ``Mesh.lanes``) and its parts cross side by side. CPU
tensors run the collective as they are.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

# Seconds spent in host-staged collectives (copies down, the host
# collective, copies up), by collective; reset by the caller.
staging_seconds: Dict[str, float] = {"shift": 0.0, "all_to_all": 0.0,
                                     "all_gather": 0.0, "all_reduce": 0.0}

# elements of one host-staged all-reduce: a model's gradients cross in
# pieces of this size through one page-locked buffer, not all at once
STAGE_ELEMENTS = 1 << 26
# the lanes a staged group's buffers are split over (``Mesh.lanes``)
STAGE_LANES = 4

# a group's lanes: groups of its ranks, in its order (``set_lanes``)
_LANES: Dict[object, List[object]] = {}


def reset_staging_seconds() -> None:
    for name in staging_seconds:
        staging_seconds[name] = 0.0


def set_lanes(group, lanes: Sequence) -> None:
    """Host-staged collectives on ``group`` split their buffer over
    ``lanes`` (groups of the same ranks in the same order, every rank
    giving its own group's) and run the parts side by side."""
    _LANES[group] = list(lanes)


def host_staged(group, tensors: Sequence[torch.Tensor]) -> bool:
    """Whether ``tensors`` cross through host memory on ``group``: CUDA
    tensors on a gloo group."""
    return (any(t.is_cuda for t in tensors)
            and dist.get_backend(group) == dist.Backend.GLOO)


def _flat_host(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One host buffer (page-locked for CUDA tensors) holding ``tensors``
    (one dtype) end to end."""
    total = sum(t.numel() for t in tensors)
    host = torch.empty(total, dtype=tensors[0].dtype,
                       pin_memory=tensors[0].is_cuda)
    offset = 0
    for t in tensors:
        host[offset:offset + t.numel()].copy_(t.reshape(-1))
        offset += t.numel()
    return host


def _unflatten(host: torch.Tensor, like: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """``host``'s pieces back on ``like``'s device, in ``like``'s shapes."""
    out, offset = [], 0
    for t in like:
        out.append(host[offset:offset + t.numel()].view(t.shape).to(
            t.device))
        offset += t.numel()
    return out


def _over_lanes(group, run: Callable, columns: torch.Tensor
                ) -> torch.Tensor:
    """``run(part, lane)`` on ``columns`` (a host buffer ``(rows,
    width)``) split by columns over ``group``'s lanes, side by side; the
    results joined back by columns."""
    lanes = _LANES.get(group) or [group]
    parts = [p.contiguous() for p in columns.chunk(len(lanes), dim=1)]
    with ThreadPoolExecutor(len(parts)) as pool:
        out = list(pool.map(run, parts, lanes[:len(parts)]))
    return torch.cat(out, dim=1)


class _Staged:
    """Adds the seconds of a host-staged collective, the copies down and
    up included, to ``staging_seconds[what]``."""

    def __init__(self, what: str):
        self.what = what

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        staging_seconds[self.what] += time.perf_counter() - self.t0


def _neighbours(group) -> tuple:
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    return (dist.get_global_rank(group, (rank + 1) % size),
            dist.get_global_rank(group, (rank - 1) % size))


def _exchange(send: torch.Tensor, group, back: bool) -> torch.Tensor:
    """``send`` to the next member and the previous member's in return
    (``back``: to the previous, the next one's in return)."""
    nxt, prev = _neighbours(group)
    if back:
        nxt, prev = prev, nxt
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, nxt, group),
           dist.P2POp(dist.irecv, recv, prev, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def shift(tensors: Sequence[torch.Tensor], group, back: bool = False
          ) -> List[torch.Tensor]:
    """Each tensor sent to the next member of ``group``, the previous
    member's received in its place (one dtype for all of them); ``back``
    rotates the other way."""
    tensors = [t.contiguous() for t in tensors]
    if dist.get_world_size(group) == 1:
        return list(tensors)
    if host_staged(group, tensors):
        with _Staged("shift"):
            got = _over_lanes(
                group, lambda part, lane: _exchange(part, lane, back),
                _flat_host(tensors).view(1, -1))
            return _unflatten(got.view(-1), tensors)
    if len(tensors) == 1:
        return [_exchange(tensors[0], group, back)]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    recv = _exchange(flat, group, back)
    out, offset = [], 0
    for t in tensors:
        out.append(recv[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of shape ``(n, ...)`` with n the group's size: chunk ``j`` to
    member ``j``; the result's chunk ``i`` is member ``i``'s chunk for
    this member."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    if host_staged(group, [x]):
        def run(part, lane):
            out = torch.empty_like(part)
            dist.all_to_all_single(out, part, group=lane)
            return out

        with _Staged("all_to_all"):
            got = _over_lanes(group, run, _flat_host([x]).view(n, -1))
            return got.view(x.shape).to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every member's ``x`` stacked in member order: ``(n, *x.shape)``."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    if n == 1:
        return x.unsqueeze(0).clone()
    if host_staged(group, [x]):
        def run(part, lane):
            parts = [torch.empty_like(part) for _ in range(n)]
            dist.all_gather(parts, part, group=lane)
            return torch.cat(parts)

        with _Staged("all_gather"):
            got = _over_lanes(group, run, _flat_host([x]).view(1, -1))
            return got.view((n,) + tuple(x.shape)).to(x.device)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def all_reduce_(tensors: Sequence[torch.Tensor], group) -> None:
    """Each tensor (contiguous) replaced by its sum over ``group``, in
    place. Host staging packs the tensors of each dtype end to end and
    reduces them ``STAGE_ELEMENTS`` at a time through one host buffer,
    split over the group's lanes."""
    if dist.get_world_size(group) == 1 or not tensors:
        return
    if not host_staged(group, tensors):
        for t in tensors:
            dist.all_reduce(t, group=group)
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t.view(-1))
    with _Staged("all_reduce"):
        for flats in by_dtype.values():
            _reduce_staged(flats, group)


def _reduce_staged(flats: List[torch.Tensor], group) -> None:
    """The sums of ``flats`` (one dtype, flat) over ``group``, in place,
    through one host buffer of up to ``STAGE_ELEMENTS``."""
    def run(part, lane):
        dist.all_reduce(part, group=lane)
        return part

    host = torch.empty(min(STAGE_ELEMENTS, sum(f.numel() for f in flats)),
                       dtype=flats[0].dtype, pin_memory=flats[0].is_cuda)
    pieces, used = [], 0

    def reduce_pieces():
        got = _over_lanes(group, run, host[:used].view(1, -1)).view(-1)
        offset = 0
        for piece in pieces:
            piece.copy_(got[offset:offset + piece.numel()])
            offset += piece.numel()

    for flat in flats:
        start = 0
        while start < flat.numel():
            take = min(flat.numel() - start, host.numel() - used)
            piece = flat[start:start + take]
            host[used:used + take].copy_(piece)
            pieces.append(piece)
            used += take
            start += take
            if used == host.numel():
                reduce_pieces()
                pieces, used = [], 0
    if used:
        reduce_pieces()
