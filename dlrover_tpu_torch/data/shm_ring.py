"""Shared-memory ring: the Python surface over the native C++ ring.

Counterpart of ``dlrover_tpu/data/shm_ring.py`` (after atorch's
``ShmDataContext`` and ``CoworkerDataset``): CPU preprocessing processes
push pickled batches into per-worker rings and the training process pops
them without socket serialization. The ring is ``native/shm_ring.cpp``,
built by the port's loader (``native_build.py``); the JAX package's ring
is the same source, so a ring written by one package is read by the
other. A failed ``g++`` build raises ``NativeBuildError``: the ring
never drops silently to the Python one. ``_PyRing`` (over
``multiprocessing.shared_memory``, its own layout magic) is the plain
version, chosen only by ``_force_fallback=True``; each layout refuses a
ring made by the other.

This module imports neither torch nor numpy, so a producer process that
imports it starts in about a second.
"""

from __future__ import annotations

import ctypes
import pickle
import struct
import time
import uuid
from typing import Any, Iterator, List, Optional

from dlrover_tpu_torch.native_build import load_native


class RingClosed(Exception):
    pass


class RingTimeout(TimeoutError):
    pass


class ShmRing:
    """Single-producer single-consumer byte-record ring."""

    def __init__(self, name: Optional[str] = None,
                 capacity: int = 64 << 20, owner: bool = True,
                 _force_fallback: bool = False):
        self.name = name or f"/dlrover-tpu-{uuid.uuid4().hex[:12]}"
        if not self.name.startswith("/"):
            self.name = "/" + self.name
        self._owner = owner
        self._closed = False
        self._lib = None if _force_fallback else load_native()
        if self._lib is not None:
            self._handle = self._lib.shm_ring_open(
                self.name.encode(), capacity, 1 if owner else 0)
            if not self._handle:
                raise OSError(f"shm_ring_open failed for {self.name} (no "
                              f"such ring, or not the native layout)")
        else:
            self._fallback = _PyRing(self.name, capacity, owner)

    # -- byte records --------------------------------------------------
    def push_bytes(self, payload: bytes,
                   timeout_s: Optional[float] = 30.0) -> None:
        """Push one record. An empty record is refused (``ValueError``):
        the native ring reads a record length of 0 as "empty", so one
        would wedge its consumer (the JAX package's ring takes it)."""
        if not payload:
            raise ValueError("an empty record cannot be pushed")
        timeout_ms = -1 if timeout_s is None else int(timeout_s * 1000)
        if self._lib is None:
            self._fallback.push(payload, timeout_ms)
            return
        buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
        code = self._lib.shm_ring_push(self._handle, buf, len(payload),
                                       timeout_ms)
        if code == -1:
            raise RingTimeout("push timed out")
        if code == -2:
            raise RingClosed()
        if code == -3:
            raise ValueError("record larger than ring capacity")

    def pop_bytes(self, timeout_s: Optional[float] = 30.0) -> bytes:
        timeout_ms = -1 if timeout_s is None else int(timeout_s * 1000)
        if self._lib is None:
            return self._fallback.pop(timeout_ms)
        deadline = time.time() + (timeout_s or 0)
        while True:
            length = self._lib.shm_ring_next_len(self._handle)
            if length == -2:
                raise RingClosed()
            if length > 0:
                buf = (ctypes.c_uint8 * length)()
                got = self._lib.shm_ring_pop(self._handle, buf, length,
                                             timeout_ms)
                if got == -2:
                    raise RingClosed()
                if got == -1:
                    raise RingTimeout("pop timed out")
                if got < 0:
                    raise ValueError(
                        f"shm_ring_pop failed with code {got} "
                        "(concurrent consumers on one ring?)")
                return ctypes.string_at(buf, got)
            if timeout_s is not None and time.time() > deadline:
                raise RingTimeout("pop timed out")
            time.sleep(0.0005)

    # -- python objects ------------------------------------------------
    def push(self, obj: Any, timeout_s: Optional[float] = 30.0) -> None:
        self.push_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL),
                        timeout_s)

    def pop(self, timeout_s: Optional[float] = 30.0) -> Any:
        return pickle.loads(self.pop_bytes(timeout_s))

    def mark_closed(self) -> None:
        if self._lib is not None:
            self._lib.shm_ring_mark_closed(self._handle)
        else:
            self._fallback.mark_closed()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._lib is not None:
            self._lib.shm_ring_close(self._handle)
        else:
            self._fallback.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _PyRing:
    """The plain ring over ``multiprocessing.shared_memory``. Layout:
    magic u32 | pad u32 | head u64 | tail u64 | closed u64 | data. The
    magic tells this layout from the native one, which differs; attach
    refuses a mismatch instead of reading garbage offsets."""

    _HDR = 32
    _MAGIC = 0x50594c52          # "PYLR"
    _NATIVE_MAGIC = 0x444c5452   # the C++ ring's magic ("DLTR")

    def __init__(self, name: str, capacity: int, owner: bool):
        from multiprocessing import shared_memory

        self.capacity = capacity
        shm_name = name.strip("/")
        if owner:
            self._shm = shared_memory.SharedMemory(
                name=shm_name, create=True, size=self._HDR + capacity)
            self._shm.buf[:self._HDR] = b"\0" * self._HDR
            struct.pack_into("<I", self._shm.buf, 0, self._MAGIC)
        else:
            self._shm = shared_memory.SharedMemory(name=shm_name)
            (magic,) = struct.unpack_from("<I", self._shm.buf, 0)
            if magic != self._MAGIC:
                self._shm.close()
                what = ("the native C++ layout"
                        if magic == self._NATIVE_MAGIC
                        else f"an unknown layout (magic {magic:#x})")
                raise RuntimeError(
                    f"ring {name!r} was made by {what}; the Python ring "
                    f"cannot attach to it")
            self.capacity = self._shm.size - self._HDR
        self._owner = owner

    def _get(self, idx: int) -> int:
        # slots: 1=head, 2=tail, 3=closed (slot 0 is magic+pad)
        return struct.unpack_from("<Q", self._shm.buf, idx * 8)[0]

    def _set(self, idx: int, value: int) -> None:
        struct.pack_into("<Q", self._shm.buf, idx * 8, value)

    def push(self, payload: bytes, timeout_ms: int) -> None:
        need = len(payload) + 4
        deadline = time.time() + timeout_ms / 1000.0
        cap = self.capacity
        if need + 4 > cap:
            raise ValueError("record larger than ring capacity")
        while True:
            if self._get(3):
                raise RingClosed()
            head, tail = self._get(1), self._get(2)
            pos = head % cap
            to_end = cap - pos
            effective = need if to_end >= need else to_end + need
            if cap - (head - tail) >= effective:
                base = self._HDR
                if to_end < need:
                    if to_end >= 4:
                        struct.pack_into("<I", self._shm.buf, base + pos,
                                         0xFFFFFFFF)
                    head += to_end
                    pos = 0
                struct.pack_into("<I", self._shm.buf, base + pos,
                                 len(payload))
                self._shm.buf[base + pos + 4:base + pos + 4 + len(payload)] \
                    = payload
                self._set(1, head + need)
                return
            if timeout_ms >= 0 and time.time() > deadline:
                raise RingTimeout("push timed out")
            time.sleep(0.001)

    def pop(self, timeout_ms: int) -> bytes:
        deadline = time.time() + timeout_ms / 1000.0
        cap = self.capacity
        base = self._HDR
        while True:
            head, tail = self._get(1), self._get(2)
            if head == tail:
                if self._get(3):
                    raise RingClosed()
                if timeout_ms >= 0 and time.time() > deadline:
                    raise RingTimeout("pop timed out")
                time.sleep(0.001)
                continue
            pos = tail % cap
            to_end = cap - pos
            if to_end < 4:
                self._set(2, tail + to_end)
                continue
            (length,) = struct.unpack_from("<I", self._shm.buf, base + pos)
            if length == 0xFFFFFFFF:
                self._set(2, tail + to_end)
                continue
            payload = bytes(
                self._shm.buf[base + pos + 4:base + pos + 4 + length])
            self._set(2, tail + length + 4)
            return payload

    def mark_closed(self) -> None:
        self._set(3, 1)

    def close(self) -> None:
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


class ShmDataContext:
    """N coworker→trainer rings and their iterator (atorch's
    ``ShmDataContext``).

    Trainer side: ``context = ShmDataContext(num_rings, capacity)``; pass
    ``context.ring_names`` to the coworker processes and iterate
    ``context.batches()``. Coworker side: ``ShmDataContext.attach(names)``,
    ``push(batch, ring_idx)``, ``close_producers()`` when exhausted.
    """

    def __init__(self, num_rings: int = 1, capacity: int = 64 << 20,
                 owner: bool = True,
                 ring_names: Optional[List[str]] = None):
        if ring_names is not None:
            self.rings = [ShmRing(name, capacity, owner=False)
                          for name in ring_names]
        else:
            self.rings = [ShmRing(capacity=capacity, owner=owner)
                          for _ in range(num_rings)]
        self.ring_names = [ring.name for ring in self.rings]

    @classmethod
    def attach(cls, ring_names: List[str],
               capacity: int = 64 << 20) -> "ShmDataContext":
        return cls(ring_names=ring_names, capacity=capacity)

    def push(self, batch: Any, ring_idx: int = 0,
             timeout_s: Optional[float] = 30.0) -> None:
        self.rings[ring_idx].push(batch, timeout_s)

    def close_producers(self) -> None:
        for ring in self.rings:
            ring.mark_closed()

    def batches(self, timeout_s: Optional[float] = 60.0) -> Iterator[Any]:
        """Round-robin over the rings until all are closed and drained.
        Raises RingTimeout when no ring yields a batch for ``timeout_s``
        (a dead producer that never called close_producers)."""
        live = list(self.rings)
        last_progress = time.time()
        while live:
            progressed = False
            for ring in list(live):
                try:
                    yield ring.pop(timeout_s=0.05)
                    progressed = True
                except RingTimeout:
                    continue
                except RingClosed:
                    live.remove(ring)
            if progressed:
                last_progress = time.time()
            elif live:
                if (timeout_s is not None
                        and time.time() - last_progress > timeout_s):
                    raise RingTimeout(
                        f"no batch from {len(live)} live ring(s) in "
                        f"{timeout_s:.0f}s (producer dead?)")
                time.sleep(0.005)

    def close(self) -> None:
        for ring in self.rings:
            ring.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
