"""Peer-to-peer restore: a relaunched worker's state comes from the host
copies the survivors staged, not from the flash checkpoint on disk.

Own copy of the JAX package's ``checkpoint/peer_restore.py``, over torch
tensors and the port's state-dict names. The pieces, in data-flow order:

- :class:`PeerStateStore` (worker): at every checkpoint boundary the
  state the flash checkpoint just copied to host memory is mirrored leaf
  by leaf into a directory the agent owns (the same bytes the DCP save
  writes, so peer step N and checkpoint step N are one consistent cut).
  The manifest (step, per-shard dtype, shape and CRC, the data-position
  state) is written last and atomically, so a SIGKILL mid-stage leaves
  the previous step intact.
- :class:`PeerDonorServer` (agent): a small TCP protocol, JSON header
  lines then raw bytes, byte for byte the JAX package's, serving staged
  shards. It lives in the agent process, so it outlives the worker
  restarts a failure forces.
- The master's restore plan (``master/rendezvous.py``
  ``compute_restore_plan``) maps each staged shard to a surviving donor,
  stamped with the world epoch so a second failure mid-transfer
  invalidates the plan.
- :class:`PeerRestorer` (worker): plan → parallel shard fetch (a hit in
  this host's own cache never touches the network) → epoch re-check →
  tensors in the target's placements (``parallel/sharding.py``
  ``sharded_from_host``). Shards no survivor holds come from the flash
  checkpoint of the SAME step (``mixed``); anything less consistent
  falls back to the checkpoint wholesale, never to a silent zero-init.

Manifest dtypes are numpy's names (``"float32"``, ``"int32"``); numpy
has no bf16, and a bf16 leaf is written ``"bfloat16"``, the name the JAX
package's ml_dtypes arrays carry. Leaves are read, written and
CRC-checked in parallel (file I/O and ``zlib.crc32`` release the GIL),
in chunks, straight from and into the flash checkpoint's host buffers.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import socketserver
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.checkpoint.state_dict import (
    get_state_dict,
    set_optimizer_state_dict,
)
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.sharding import sharded_from_host, to_local

MANIFEST = "manifest.json"
# stage dirs retained beyond the current one: a donor restaging a newer
# step must not yank the files a plan computed moments ago points at
_RETAIN_STAGES = 2
_HEADER_LIMIT = 1 << 20
# leaves read and CRC-checked at once, and the bytes of one read call
# (a restore has the host to itself)
_IO_THREADS = 8
_CHUNK = 16 << 20
# the same for a stage's deferred write, which runs beside the training
# step's own thread: fewer threads, larger calls, fewer GIL handoffs
_WRITE_THREADS = 4
_WRITE_CHUNK = 64 << 20

# torch dtype ↔ the numpy dtype name in a manifest
_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's (numpy's) name of a torch dtype."""
    return _DTYPE_NAMES[dtype]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# shard keys + host copies
# ---------------------------------------------------------------------------


def _flatten(tree: Any, prefix: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(tree, torch.Tensor):
        out.append((prefix, tree))
    elif isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}.{key}" if prefix else str(key), out)


def shard_items(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """(key, tensor) pairs in a fixed order. ``tree`` is a TrainState
    (keys ``model.<fqn>`` and ``optim.state.<fqn>.<name>``, the flattened
    names DCP saves under), a nested mapping (keys joined with ``.``) or
    a list of pairs already keyed. The optimizer's hyperparameters
    (``param_groups``) are no tensors: a restore takes them from its
    target, built by the same optimizer factory."""
    if isinstance(tree, list):
        return list(tree)
    if hasattr(tree, "model") and hasattr(tree, "optimizer"):
        # the state dicts' tensors alias the state's own
        model_sd, optim_sd = get_state_dict(tree.model, tree.optimizer)
        tree = {"model": model_sd, "optim": optim_sd}
    out: List[Tuple[str, Any]] = []
    _flatten(tree, "", out)
    return out


def held_whole(leaf: torch.Tensor) -> bool:
    """Whether this process holds all of ``leaf``: a plain tensor, or a
    DTensor whose mesh is this process alone or that is replicated."""
    if not isinstance(leaf, DTensor):
        return True
    return (leaf.device_mesh.size() == 1
            or all(p.is_replicate() for p in leaf.placements))


def host_copy(leaf: torch.Tensor) -> Optional[torch.Tensor]:
    """The leaf as a host tensor (itself when it already lies in host
    memory), or None when this process does not hold all of it (sharded
    across processes: exactly the shards that die with a host and force
    the checkpoint fallback)."""
    if not held_whole(leaf):
        return None
    local = to_local(leaf).detach()
    return local if local.device.type == "cpu" else local.cpu()


def _byte_view(t: torch.Tensor):
    """A writable uint8 numpy view of a contiguous host tensor's bytes."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _atomic_write(path: str, payload: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_manifest(directory: str) -> Optional[Dict[str, Any]]:
    """The staged manifest, or None when absent or torn (a torn stage
    left the previous manifest in place: readers never see half a
    step)."""
    try:
        with open(os.path.join(directory, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(manifest, dict) or "shards" not in manifest:
        return None
    return manifest


def load_stage_manifest(directory: str, step: int
                        ) -> Optional[Dict[str, Any]]:
    """The manifest of one staged step: the current one when it
    matches, else the copy inside the retained stage dir (a donor
    restaging a newer step keeps serving the step an in-flight plan
    names)."""
    manifest = load_manifest(directory)
    if manifest is not None and int(manifest.get("step", -1)) == step:
        return manifest
    return load_manifest(os.path.join(directory, f"stage-{step}"))


def manifest_summary(directory: str) -> Tuple[int, List[str], int]:
    """(step, shard keys, total bytes) of the staged manifest; (-1, [],
    0) when nothing usable is staged."""
    manifest = load_manifest(directory)
    if manifest is None:
        return -1, [], 0
    shards = manifest.get("shards", {})
    total = sum(int(s.get("nbytes", 0)) for s in shards.values())
    return int(manifest.get("step", -1)), sorted(shards), total


def _shard_path(directory: str, manifest: Dict[str, Any],
                meta: Dict[str, Any]) -> str:
    return os.path.join(directory, manifest.get("dir", ""), meta["file"])


def read_local_shard(directory: str, manifest: Dict[str, Any],
                     key: str) -> Optional[bytearray]:
    """Read and CRC-verify one staged shard; None on any mismatch."""
    meta = manifest.get("shards", {}).get(key)
    if meta is None:
        return None
    data = bytearray(max(0, int(meta.get("nbytes", 0))))
    return (data if read_local_shard_into(directory, manifest, key, data)
            else None)


def _read_chunks(directory: str, manifest: Dict[str, Any], key: str,
                 nbytes: int, chunk_buffer: Callable[[int, int], Any]
                 ) -> bool:
    """Read one staged shard of ``nbytes`` in chunks, each into the
    writable buffer ``chunk_buffer(offset, length)`` returns, and check
    its size and the CRC of all its bytes; False on any mismatch (the
    bytes read are then not to be used)."""
    meta = manifest.get("shards", {}).get(key)
    if meta is None or int(meta.get("nbytes", -1)) != nbytes:
        return False
    crc = 0
    try:
        with open(_shard_path(directory, manifest, meta), "rb",
                  buffering=0) as f:
            for offset in range(0, nbytes, _CHUNK):
                part = chunk_buffer(offset, min(_CHUNK, nbytes - offset))
                if f.readinto(part) != len(part):
                    return False
                crc = zlib.crc32(part, crc)
            if f.read(1):
                return False
    except (OSError, KeyError):
        return False
    return (crc & 0xFFFFFFFF) == int(meta.get("crc32", -1))


def read_local_shard_into(directory: str, manifest: Dict[str, Any],
                          key: str, out) -> bool:
    """``read_local_shard`` into the writable buffer ``out`` (exactly the
    shard's size), in chunks, CRC-verified; False on any mismatch (the
    buffer's bytes are then not to be used)."""
    view = memoryview(out).cast("B")
    return _read_chunks(directory, manifest, key, len(view),
                        lambda offset, length: view[offset:offset + length])


class _TensorWriter:
    """One reading thread's path from a staged shard into a tensor's
    storage: chunks land in two bounce buffers (page-locked when the
    tensor is on the card) and are copied into the tensor's bytes
    ``non_blocking``, on the thread's own stream; a bounce buffer is
    reused only after its copy is done. A restore then needs no host
    copy of the whole state."""

    def __init__(self, pin: bool):
        self.bounce = [torch.empty(_CHUNK, dtype=torch.uint8,
                                   pin_memory=pin) for _ in range(2)]
        self.done = [None, None]
        self.slot = 0
        self.stream = None

    def _copy(self, target, chunk) -> None:
        if chunk is None:
            return
        slot, offset, length = chunk
        src = self.bounce[slot][:length]
        dst = target[offset:offset + length]
        if not dst.is_cuda:
            dst.copy_(src)
            return
        if self.stream is None:
            self.stream = torch.cuda.Stream(dst.device)
        with torch.cuda.stream(self.stream):
            dst.copy_(src, non_blocking=True)
            self.done[slot] = self.stream.record_event()

    def write(self, directory: str, manifest: Dict[str, Any], key: str,
              target: torch.Tensor) -> bool:
        """Read shard ``key`` into ``target`` (a contiguous uint8 view of
        a tensor's bytes); False on any mismatch (``target``'s bytes are
        then not to be used). The copies may still be in flight: the
        caller synchronizes the device before reading ``target``."""
        pending = None

        def chunk_buffer(offset: int, length: int):
            nonlocal pending
            self._copy(target, pending)      # the previous chunk, checked
            slot, self.slot = self.slot, self.slot ^ 1
            if self.done[slot] is not None:
                self.done[slot].synchronize()
            pending = (slot, offset, length)
            return memoryview(self.bounce[slot].numpy())[:length]

        ok = _read_chunks(directory, manifest, key, target.numel(),
                          chunk_buffer)
        if ok:
            self._copy(target, pending)
        return ok


def stream_local_shards(directory: str, step: int,
                        targets: Dict[str, torch.Tensor]) -> List[str]:
    """Read the staged shards of ``step`` in this host's cache straight
    into ``targets`` (key → a contiguous uint8 view of a tensor's bytes),
    in parallel, CRC-checked; returns the keys restored (the others are
    missing, their targets' bytes not to be used). Waits for the copies
    to land."""
    manifest = load_stage_manifest(directory, step)
    if manifest is None or not targets:
        return []
    local = threading.local()
    cards = {t.device for t in targets.values() if t.is_cuda}

    def _write(key: str) -> bool:
        if not hasattr(local, "writer"):
            local.writer = _TensorWriter(pin=bool(cards))
        return local.writer.write(directory, manifest, key, targets[key])

    keys = sorted(targets, key=lambda k: -targets[k].numel())
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        oks = list(pool.map(_write, keys))
    for device in cards:
        torch.cuda.synchronize(device)
    return [key for key, ok in zip(keys, oks) if ok]


# ---------------------------------------------------------------------------
# worker-side staging
# ---------------------------------------------------------------------------


class PeerStateStore:
    """Host mirror of the live state, staged at checkpoint boundaries so
    the bytes outlive the worker process. Single writer by contract (the
    step loop); readers (the donor server, a relaunched worker) only ever
    see a complete step through the atomic manifest."""

    def __init__(self, directory: str):
        self._dir = directory
        # the deferred stage write (joined before the next stage, on
        # flush, and by the flash checkpoint before it overwrites the
        # host buffers the write reads)
        self._writer: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    @classmethod
    def from_env(cls) -> Optional["PeerStateStore"]:
        directory = os.environ.get(NodeEnv.PEER_CACHE_DIR, "")
        if not directory or not Context.singleton().peer_restore_enabled:
            return None
        return cls(directory)

    @property
    def directory(self) -> str:
        return self._dir

    def stage(self, step: int, state: Any,
              data_state: Optional[Dict[str, Any]] = None,
              defer_write: bool = False) -> bool:
        """Mirror ``state`` (a TrainState, a mapping or keyed pairs; exact
        dtypes, the live-precision cut: with an exact checkpoint a peer
        restore is bitwise the checkpoint's restore of the same step, with
        a quantized one it is the higher-fidelity copy) into the cache.

        Leaves on the card are copied to host memory on the caller; host
        leaves (the flash checkpoint's buffers) are written as they are,
        so the caller must keep them unchanged until ``flush``. With
        ``defer_write`` the file writes and CRCs run on a background
        thread. Returns whether anything was staged (dispatched, when
        deferred); never raises into the step loop."""
        try:
            host_items: List[Tuple[str, torch.Tensor]] = []
            skipped: List[str] = []
            for key, leaf in shard_items(state):
                host = host_copy(leaf)
                if host is None:
                    # no whole copy of this shard here: it dies with the
                    # host, and the restore plan routes it to storage
                    skipped.append(key)
                    continue
                host_items.append((key, host.contiguous()))
            if not host_items:
                return False
            self.flush()   # serialize with a previous deferred write
            if not defer_write:
                return self._write_stage(step, host_items, skipped,
                                         dict(data_state or {}))
            self._writer = threading.Thread(
                target=self._write_stage,
                args=(step, host_items, skipped, dict(data_state or {})),
                daemon=True, name=f"peer-stage-{step}")
            self._writer.start()
            return True
        except Exception:  # noqa: BLE001 — staging is an optimization
            logger.warning("peer-state staging at step %d failed", step,
                           exc_info=True)
            return False

    def flush(self) -> None:
        """Join an in-flight deferred stage write."""
        writer = self._writer
        if writer is not None and writer.is_alive():
            writer.join()
        self._writer = None

    @staticmethod
    def _write_leaf(path: str, tensor: torch.Tensor) -> int:
        """Write one leaf's bytes in chunks; returns their CRC."""
        view = memoryview(_byte_view(tensor))
        crc = 0
        with open(path, "wb") as f:
            for offset in range(0, len(view), _WRITE_CHUNK):
                part = view[offset:offset + _WRITE_CHUNK]
                f.write(part)
                crc = zlib.crc32(part, crc)
        return crc & 0xFFFFFFFF

    def _write_stage(self, step: int, host_items, skipped,
                     data_state: Dict[str, Any]) -> bool:
        stage_name = f"stage-{step}"
        tmp = os.path.join(self._dir, f"{stage_name}.tmp")
        final = os.path.join(self._dir, stage_name)
        t0 = time.monotonic()
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            files = [f"leaf-{i}.bin" for i in range(len(host_items))]
            with ThreadPoolExecutor(_WRITE_THREADS) as pool:
                crcs = list(pool.map(
                    lambda i: self._write_leaf(os.path.join(tmp, files[i]),
                                               host_items[i][1]),
                    range(len(host_items))))
            shards: Dict[str, Dict[str, Any]] = {}
            for (key, tensor), fname, crc in zip(host_items, files, crcs):
                shards[key] = {
                    "file": fname,
                    "dtype": dtype_name(tensor.dtype),
                    "shape": list(tensor.shape),
                    "nbytes": tensor.numel() * tensor.element_size(),
                    "crc32": crc,
                }
            manifest = {
                "step": int(step),
                "dir": stage_name,
                "staged_at": time.time(),
                "data_state": data_state,
                "shards": shards,
                "skipped": skipped,
            }
            # the per-stage copy rides INSIDE the dir (atomic with the
            # rename): the donor keeps serving this step after a newer
            # stage overwrites the top-level manifest
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            _atomic_write(os.path.join(self._dir, MANIFEST),
                          json.dumps(manifest).encode())
            self._prune(keep=stage_name)
            logger.info("peer cache: step %d staged, %d shards, %.1f MiB "
                        "in %.3f s", step, len(shards),
                        sum(m["nbytes"] for m in shards.values())
                        / (1 << 20), time.monotonic() - t0)
            return True
        except Exception:  # noqa: BLE001 — staging is an optimization
            logger.warning("peer-state staging at step %d failed", step,
                           exc_info=True)
            shutil.rmtree(tmp, ignore_errors=True)
            return False

    def _prune(self, keep: str) -> None:
        """Drop old stage dirs beyond the retention window (the newest
        few stay so an in-flight transfer keyed on the previous step is
        not yanked mid-read)."""
        try:
            stages = sorted(
                (name for name in os.listdir(self._dir)
                 if name.startswith("stage-")
                 and not name.endswith(".tmp")),
                key=lambda n: int(n.split("-")[1])
                if n.split("-")[1].isdigit() else -1)
        except OSError:
            return
        for name in stages[:-_RETAIN_STAGES]:
            if name != keep:
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)


# ---------------------------------------------------------------------------
# donor-side server (runs in the agent: survives worker restarts)
# ---------------------------------------------------------------------------


class _DonorHandler(socketserver.StreamRequestHandler):
    timeout = 30.0

    def handle(self) -> None:  # one connection, many requests
        while True:
            try:
                line = self.rfile.readline(_HEADER_LIMIT)
            except OSError:
                return
            if not line.strip():
                return
            try:
                request = json.loads(line)
            except json.JSONDecodeError:
                self._reply({"ok": False, "error": "bad request"})
                return
            if not self._serve(request):
                return

    def _reply(self, header: Dict[str, Any],
               payload: bytes = b"") -> bool:
        try:
            self.wfile.write(json.dumps(header).encode() + b"\n")
            if payload:
                self.wfile.write(payload)
            self.wfile.flush()
            return True
        except OSError:
            return False

    def _serve(self, request: Dict[str, Any]) -> bool:
        cache_dir = self.server.cache_dir  # type: ignore[attr-defined]
        op = request.get("op", "")
        if op == "manifest":
            # step-addressed when given (a plan's step survives a donor
            # restaging a newer one), the current stage otherwise
            step = request.get("step")
            manifest = (load_stage_manifest(cache_dir, int(step))
                        if step is not None else load_manifest(cache_dir))
            payload = json.dumps(manifest or {}).encode()
            return self._reply({"ok": manifest is not None,
                                "nbytes": len(payload)}, payload)
        if op != "shard":
            return self._reply({"ok": False, "error": f"bad op {op!r}"})
        key = str(request.get("key", ""))
        step = int(request.get("step", -1))
        manifest = load_stage_manifest(cache_dir, step)
        if manifest is None:
            return self._reply({
                "ok": False, "error": f"step {step} not staged"})
        data = read_local_shard(cache_dir, manifest, key)
        if data is None:
            return self._reply({"ok": False,
                                "error": f"shard {key!r} unavailable"})
        meta = manifest["shards"][key]
        # byte-range serving (the stripe mode of compute_restore_plan):
        # the receiver reassembles ranges from several donors and checks
        # the FULL-shard CRC carried in every range header; the whole
        # shard was CRC-verified above, so a range of it is sound too
        offset = int(request.get("offset", 0) or 0)
        length = request.get("length")
        if offset or length is not None:
            end = (offset + int(length)) if length is not None \
                else len(data)
            if not (0 <= offset <= end <= len(data)):
                return self._reply({
                    "ok": False,
                    "error": f"bad range [{offset}, {end}) of "
                             f"{len(data)}"})
            data = data[offset:end]
        return self._reply({"ok": True, "nbytes": len(data),
                            "crc32": meta["crc32"],
                            "total_nbytes": meta["nbytes"],
                            "dtype": meta["dtype"],
                            "shape": meta["shape"]}, data)


class _DonorTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class PeerDonorServer:
    """Serves the local peer-state cache to relaunched ranks. Owned by
    the agent, so a worker restart never interrupts a donation."""

    def __init__(self, cache_dir: str, port: Optional[int] = None):
        self._cache_dir = cache_dir
        self._port = (port if port is not None
                      else Context.singleton().peer_donor_port)
        self._server: Optional[_DonorTCPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.addr = ""

    def start(self) -> str:
        from dlrover_tpu_torch.common.comm import local_ip

        server = _DonorTCPServer(("", self._port), _DonorHandler)
        server.cache_dir = self._cache_dir  # type: ignore[attr-defined]
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="peer-donor")
        self._thread.start()
        self.addr = f"{local_ip()}:{server.server_address[1]}"
        logger.info("peer donor serving %s at %s", self._cache_dir,
                    self.addr)
        return self.addr

    def stop(self) -> None:
        # idempotent under concurrent callers: swap the fields out first
        # so only one caller tears each down
        server, self._server = self._server, None
        thread, self._thread = self._thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# receiver-side fetch
# ---------------------------------------------------------------------------


class _DonorConnection:
    """One persistent connection to a donor; shard requests ride it one
    after another (the per-donor fetch thread is its only user)."""

    def __init__(self, addr: str, timeout_s: float):
        host, port = addr.rsplit(":", 1)
        self._timeout_s = timeout_s
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout_s)
        self._file = self._sock.makefile("rb")

    def request(self, payload: Dict[str, Any], deadline: float = 0.0
                ) -> Tuple[Dict[str, Any], Any]:
        """One request/response, the body in a new writable buffer.
        ``deadline`` (unix time) bounds the WHOLE body read: a trickling
        donor must not stretch the restore past its budget one receive
        window at a time."""
        self._sock.sendall(json.dumps(payload).encode() + b"\n")
        header = json.loads(self._file.readline(_HEADER_LIMIT))
        nbytes = int(header.get("nbytes", 0))
        if not header.get("ok") or not nbytes:
            return header, b""
        view = memoryview(bytearray(nbytes))
        read = 0
        while read < nbytes:
            if deadline:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise OSError(
                        f"peer transfer deadline exceeded mid-shard "
                        f"({read}/{nbytes} bytes)")
                self._sock.settimeout(min(self._timeout_s, remaining))
            got = self._file.readinto(view[read:read + (1 << 20)])
            if not got:
                raise OSError(f"short read ({read}/{nbytes})")
            read += got
        return header, view.obj

    def close(self) -> None:
        try:
            self._file.close()
            self._sock.close()
        except OSError:
            pass


def fetch_manifest(addr: str, timeout_s: float = 10.0,
                   step: Optional[int] = None
                   ) -> Optional[Dict[str, Any]]:
    """One donor's staged manifest (step + data-position state); with
    ``step``, the manifest of that retained stage."""
    request: Dict[str, Any] = {"op": "manifest"}
    if step is not None:
        request["step"] = int(step)
    try:
        conn = _DonorConnection(addr, timeout_s)
        try:
            header, payload = conn.request(request)
        finally:
            conn.close()
        if not header.get("ok"):
            return None
        return json.loads(bytes(payload))
    except (OSError, ValueError):
        return None


def _verify(data, header: Dict[str, Any], expected_nbytes: int) -> bool:
    return (len(data) == expected_nbytes
            and int(header.get("nbytes", -1)) == expected_nbytes
            and (zlib.crc32(data) & 0xFFFFFFFF)
            == int(header.get("crc32", -1)))


def _stripe_ranges(nbytes: int, parts: int) -> List[Tuple[int, int]]:
    """Split ``nbytes`` into ``parts`` contiguous (offset, length) ranges:
    the stripe mode's "who sends which slice of a shard". Deterministic,
    covers every byte once, drops empty tail ranges."""
    parts = max(1, min(parts, nbytes)) if nbytes > 0 else 1
    base, extra = divmod(nbytes, parts)
    ranges: List[Tuple[int, int]] = []
    offset = 0
    for i in range(parts):
        length = base + (1 if i < extra else 0)
        if length <= 0:
            continue
        ranges.append((offset, length))
        offset += length
    return ranges


def fetch_shards(
    plan: Dict[str, Any],
    wanted: Dict[str, int],
    local_cache_dir: str = "",
    deadline: float = 0.0,
) -> Tuple[Dict[str, bytearray], Dict[str, int], List[str]]:
    """Fetch the wanted shards' bytes per the plan.

    ``wanted``: key → expected byte count (from the restore target, the
    authority on dtype and shape). Hits in the local cache (a survivor
    restoring on its own host) never touch the network and are read and
    verified in parallel. Returns (key → bytes, a writable buffer owned by
    the caller; bytes per donor ("local" for cache hits); missing keys). A failed, timed-out or corrupt shard is simply missing: the
    caller chooses between the shard-wise storage read and a wholesale
    one.

    Striped entries (plan mode "stripe": ``{"ranks": [...], "addrs":
    [...]}``) split a shard's bytes into contiguous ranges fetched from
    several donors in parallel. The reassembled shard is checked against
    the FULL-shard CRC every range header carries; a failed range fails
    the whole key (missing, never wrong)."""
    step = int(plan.get("step", -1))
    entries = plan.get("entries", {})
    got: Dict[str, Any] = {}
    donor_bytes: Dict[str, int] = {}
    # addr -> [(key, offset, length or None = whole)]
    remote: Dict[str, List[Tuple[str, int, Optional[int]]]] = {}
    # striped reassembly state: key -> {offset: bytes}, key -> crc set
    striped_parts: Dict[str, Dict[int, bytes]] = {}
    striped_crcs: Dict[str, set] = {}
    striped_expected: Dict[str, int] = {}   # number of ranges issued
    missing: List[str] = []
    local_manifest = (load_stage_manifest(local_cache_dir, step)
                      if local_cache_dir else None)
    local_hits: Dict[str, Any] = {}
    if local_manifest is not None:
        shards = local_manifest.get("shards", {})
        hits = [key for key in wanted if key in shards
                and int(shards[key].get("nbytes", -1)) == wanted[key]]
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            for key, data in zip(hits, pool.map(
                    lambda key: read_local_shard(
                        local_cache_dir, local_manifest, key), hits)):
                if data is not None:
                    local_hits[key] = data
    for key, nbytes in wanted.items():
        entry = entries.get(key)
        if key in local_hits:
            got[key] = local_hits[key]
            donor_bytes["local"] = donor_bytes.get("local", 0) + nbytes
            continue
        if not entry:
            missing.append(key)
            continue
        addrs = entry.get("addrs") or []
        if len(addrs) > 1 and nbytes > 0:
            ranges = _stripe_ranges(nbytes, len(addrs))
            striped_expected[key] = len(ranges)
            striped_parts[key] = {}
            striped_crcs[key] = set()
            for addr, (offset, length) in zip(addrs, ranges):
                remote.setdefault(addr, []).append((key, offset,
                                                    length))
            continue
        addr = entry.get("addr") or (addrs[0] if addrs else "")
        if not addr:
            missing.append(key)
            continue
        remote.setdefault(addr, []).append((key, 0, None))

    # collected under `lock` by the per-donor threads
    lock = threading.Lock()
    failed_keys: set = set()

    def _fetch_from(addr: str) -> Tuple[Dict[str, Any], List[str]]:
        fetched: Dict[str, Any] = {}
        failed: List[str] = []
        work = remote[addr]
        conn = None
        done: List[Tuple] = []
        try:
            conn = _DonorConnection(addr, timeout_s=30.0)
            for item in work:
                key, offset, length = item
                if deadline and time.time() > deadline:
                    break
                request: Dict[str, Any] = {"op": "shard", "key": key,
                                           "step": step}
                if length is not None:
                    request["offset"] = offset
                    request["length"] = length
                try:
                    header, data = conn.request(request, deadline=deadline)
                except (OSError, ValueError):
                    # the connection died mid-stream: re-dial once for
                    # this donor's remaining keys (unless the budget
                    # itself is what ran out)
                    if deadline and time.time() > deadline:
                        raise
                    conn.close()
                    conn = _DonorConnection(addr, timeout_s=30.0)
                    header, data = conn.request(request, deadline=deadline)
                done.append(item)
                if length is None:
                    if header.get("ok") and _verify(data, header,
                                                    wanted[key]):
                        fetched[key] = data
                    else:
                        failed.append(key)
                    continue
                # a striped range: stash the part; the reassembly and the
                # full-shard CRC check run once every donor thread is done
                if header.get("ok") and len(data) == length:
                    with lock:
                        striped_parts[key][offset] = bytes(data)
                        striped_crcs[key].add(
                            int(header.get("crc32", -1)))
                else:
                    with lock:
                        failed_keys.add(key)
        except (OSError, ValueError) as e:
            logger.warning("peer fetch from %s failed: %s", addr, e)
        finally:
            if conn is not None:
                conn.close()
        # anything not completed on this donor: whole keys fail here,
        # striped keys through failed_keys
        for item in work:
            if item in done:
                continue
            key, offset, length = item
            if length is None:
                if key not in fetched and key not in failed:
                    failed.append(key)
            else:
                with lock:
                    failed_keys.add(key)
        return fetched, failed

    if remote:
        with ThreadPoolExecutor(
                max_workers=min(8, len(remote))) as pool:
            for addr, (fetched, failed) in zip(
                    remote, pool.map(_fetch_from, list(remote))):
                got.update(fetched)
                if fetched:
                    donor_bytes[addr] = sum(len(d)
                                            for d in fetched.values())
                missing.extend(failed)
    # striped reassembly: every range present, the donors' full-shard
    # CRCs agree, and the assembled bytes hash to that CRC; a failed or
    # disagreeing stripe makes the key MISSING, never wrong
    for key, parts in striped_parts.items():
        nbytes = wanted[key]
        crcs = striped_crcs.get(key) or set()
        if (key in failed_keys
                or len(parts) != striped_expected.get(key, -1)
                or len(crcs) != 1):
            missing.append(key)
            continue
        assembled = memoryview(bytearray(nbytes))
        for offset in sorted(parts):
            assembled[offset:offset + len(parts[offset])] = parts[offset]
        if (sum(len(p) for p in parts.values()) != nbytes
                or (zlib.crc32(assembled) & 0xFFFFFFFF)
                != next(iter(crcs))):
            missing.append(key)
            continue
        got[key] = assembled.obj
        for addr, work in remote.items():
            contributed = sum(length or 0 for k, off, length in work
                              if k == key and off in parts)
            if contributed:
                donor_bytes[addr] = (donor_bytes.get(addr, 0)
                                     + contributed)
    return got, donor_bytes, missing


# ---------------------------------------------------------------------------
# the worker-side restore orchestration
# ---------------------------------------------------------------------------


class PeerRestorer:
    """Plan → transfer → validate → assemble, with the shard-wise
    checkpoint fallback. One instance per ElasticTrainLoop."""

    def __init__(self, client=None, cache: Optional[PeerStateStore] = None,
                 plan_file: str = ""):
        self._client = client
        self._cache = cache
        self._plan_file = (plan_file
                           or os.environ.get(NodeEnv.RESTORE_PLAN_FILE,
                                             ""))
        # stripe mode: RPC plans list every same-step holder of a shard
        # and the receiver fetches its byte ranges from all of them (set
        # by a parallelism re-plan, not ported yet: ROADMAP Queue A 6.3)
        self.stripe = False

    @classmethod
    def from_env(cls, client=None) -> Optional["PeerRestorer"]:
        if not Context.singleton().peer_restore_enabled:
            return None
        cache = PeerStateStore.from_env()
        plan_file = os.environ.get(NodeEnv.RESTORE_PLAN_FILE, "")
        if client is None and cache is None and not plan_file:
            return None
        return cls(client=client, cache=cache, plan_file=plan_file)

    @property
    def cache(self) -> Optional[PeerStateStore]:
        return self._cache

    # -- plan acquisition ---------------------------------------------------
    def _fetch_plan(self) -> Optional[Dict[str, Any]]:
        """Freshest plan first: the master RPC (recomputed now), then the
        plan the agent's join result carried, then, standalone with no
        master, a local pseudo-plan over this host's cache."""
        if self._client is not None:
            try:
                plan = (self._client.get_restore_plan(stripe=True)
                        if self.stripe
                        else self._client.get_restore_plan())
                if plan:
                    return plan
            except Exception:  # noqa: BLE001 — degrade to the file plan
                logger.warning("restore-plan RPC failed; using the "
                               "join-result plan", exc_info=True)
        if self._plan_file:
            try:
                with open(self._plan_file) as f:
                    plan = json.load(f)
                if isinstance(plan, dict) and plan.get("entries"):
                    return plan
            except (OSError, json.JSONDecodeError):
                pass
        if self._cache is not None:
            step, keys, _ = manifest_summary(self._cache.directory)
            if step >= 0:
                # local only: epoch -1 disables the staleness check
                # (there is no master to have recomputed membership)
                return {"epoch": -1, "step": step,
                        "entries": {key: {"rank": -1, "addr": ""}
                                    for key in keys}}
        return None

    def _current_epoch(self) -> Optional[int]:
        if self._client is None:
            return None
        try:
            return self._client.get_restore_epoch()
        except Exception:  # noqa: BLE001 — treat as unverifiable
            return None

    # -- the restore --------------------------------------------------------
    def restore(self, target: Any, checkpointer=None,
                timings: Optional[Dict[str, float]] = None,
                _retry: bool = True
                ) -> Optional[Tuple[Any, Dict[str, Any], int, str]]:
        """Restore ``target`` (a TrainState laid out for this world, its
        tensors written in place) from surviving peers. Returns (state,
        data_state, step, source) with source ``"peer"`` or ``"mixed"``;
        None means the caller takes the full checkpoint path (no plan, no
        donors, a newer committed step, or a plan that stayed stale). A
        None after the transfer may leave the target's tensors partly
        written: the checkpoint read overwrites every one of them."""
        timings = timings if timings is not None else {}
        recorder = obs.get_flight_recorder()
        t0 = time.monotonic()
        plan = self._fetch_plan()
        timings["peer_plan_s"] = time.monotonic() - t0
        if not plan or not plan.get("entries"):
            return None
        step = int(plan.get("step", -1))
        if step < 0:
            return None
        latest = None
        if checkpointer is not None:
            try:
                latest = checkpointer.latest_step()
            except OSError:   # storage may be torn or gone
                latest = None
        if latest is not None and latest > step:
            # storage moved past the staged state (a commit landed after
            # the last stage): peers would rewind the job
            logger.warning(
                "peer restore: checkpoint step %d is newer than the staged "
                "step %d; taking the storage path", latest, step)
            recorder.record_event("peer_restore_skipped", step=step,
                                  orbax_step=latest, reason="stale-stage")
            return None
        model_sd, optim_sd = get_state_dict(target.model, target.optimizer)
        items = shard_items({"model": model_sd, "optim": optim_sd})
        by_key = dict(items)
        wanted = {key: leaf.numel() * leaf.element_size()
                  for key, leaf in items}
        deadline = time.time() + Context.singleton().peer_restore_timeout_s
        local_dir = self._cache.directory if self._cache else ""
        t0 = time.monotonic()
        with obs.span("restore_peer_transfer",
                      {"step": step,
                       "shards": len(wanted)}) as transfer_span:
            # this host's staged copy of a leaf held whole goes straight
            # into the target's storage (chunks through small bounce
            # buffers: no host copy of the state); the rest is fetched
            # into host buffers and assembled
            streamed = set(stream_local_shards(local_dir, step, {
                key: to_local(leaf).reshape(-1).view(torch.uint8)
                for key, leaf in items if held_whole(leaf) and leaf.numel()
                and to_local(leaf).is_contiguous()}) if local_dir else [])
            got, donor_bytes, _ = fetch_shards(
                plan, {k: n for k, n in wanted.items() if k not in streamed},
                local_cache_dir=local_dir, deadline=deadline)
            if streamed:
                donor_bytes["local"] = donor_bytes.get("local", 0) + sum(
                    wanted[key] for key in streamed)
            transfer_s = time.monotonic() - t0
            total_bytes = sum(len(memoryview(d).cast("B"))
                              for d in got.values()) + sum(
                wanted[key] for key in streamed)
            transfer_span.set_attr("bytes", total_bytes)
            transfer_span.set_attr("donors", len(donor_bytes))
            if transfer_s > 0:
                transfer_span.set_attr(
                    "bandwidth_mbps",
                    round(total_bytes / (1 << 20) / transfer_s, 2))
        timings["peer_transfer_s"] = transfer_s
        timings["peer_bytes"] = float(total_bytes)
        if transfer_s > 0 and total_bytes > 0:
            timings["peer_bandwidth_mbps"] = (
                total_bytes / (1 << 20) / transfer_s)
        missing = sorted(set(wanted) - set(got) - streamed)
        # the staleness guard: a second failure that changed membership
        # after the plan was computed invalidates it (a donor may be
        # dead, or serve a world this rank is no longer part of).
        # Checked AFTER the transfer, right before the commit.
        plan_epoch = int(plan.get("epoch", -1))
        if plan_epoch >= 0:
            current = self._current_epoch()
            if current is not None and current != plan_epoch:
                recorder.record_event(
                    "restore_plan_stale", plan_epoch=plan_epoch,
                    current_epoch=current, step=step)
                obs.get_registry().counter(
                    "dlrover_tpu_restore_plan_stale_total",
                    "Restore plans rejected by the world-epoch "
                    "staleness guard").inc()
                logger.warning(
                    "restore plan stale (epoch %d -> %d): %s", plan_epoch,
                    current, "recomputing" if _retry else "falling back "
                    "to the checkpoint")
                if _retry:
                    return self.restore(target, checkpointer, timings,
                                        _retry=False)
                return None
        data_state = self._data_state(plan, step, donor_bytes,
                                      checkpointer)
        if missing:
            return self._finish_mixed(
                target, model_sd, optim_sd, by_key, got, missing, step,
                data_state, checkpointer, donor_bytes, timings)
        self._assemble(target, model_sd, optim_sd, by_key, got, timings)
        target.step = step
        self._record(step, "peer", donor_bytes, missing=0,
                     total_bytes=total_bytes, transfer_s=transfer_s)
        return target, data_state, step, "peer"

    def _data_state(self, plan: Dict[str, Any], step: int,
                    donor_bytes: Dict[str, int], checkpointer
                    ) -> Dict[str, Any]:
        """The data-position state of the restored step (the sampler
        position and the master's shard checkpoint, the JSON the flash
        checkpoint's data item carries). The local manifest first, then
        a remote donor that served us, then the committed data item; an
        unrecoverable position is LOUD (flight event + warning): a
        silently reset sampler would replay seen data."""
        if self._cache is not None:
            manifest = load_stage_manifest(self._cache.directory, step)
            if manifest is not None:
                return dict(manifest.get("data_state", {}))
        for addr in donor_bytes:
            if addr == "local":
                continue
            manifest = fetch_manifest(addr, step=step)
            if manifest is not None and \
                    int(manifest.get("step", -1)) == step:
                return dict(manifest.get("data_state", {}))
        if checkpointer is not None:
            data = checkpointer.restore_data_state(step)
            if data is not None:
                return data
        obs.get_flight_recorder().record_event(
            "peer_restore_no_data_state", step=step)
        logger.warning(
            "peer restore: no data-position state recoverable for step "
            "%d (no donor manifest, step not in storage); the sampler "
            "position resets", step)
        return {}

    def _assemble(self, target, model_sd, optim_sd,
                  by_key: Dict[str, torch.Tensor], got: Dict[str, Any],
                  timings: Dict[str, float]) -> None:
        """Fetched bytes → the target's tensors, in their placements
        (``sharded_from_host``: a DTensor target gets its own shard).
        Each host leaf is a typed view of a buffer fetch_shards filled;
        it is copied into the target's own storage (the target never
        aliases a received buffer), so the card holds nothing beyond the
        state. The buffers stay referenced until the copies are done."""
        t0 = time.monotonic()
        hosts = {}
        for key, buf in got.items():
            leaf = by_key[key]
            hosts[key] = (torch.frombuffer(buf, dtype=leaf.dtype)
                          if leaf.numel()
                          else torch.empty(0, dtype=leaf.dtype)
                          ).reshape(leaf.shape)
        sharded_from_host(hosts, by_key, in_place=True)
        device = next(target.model.parameters()).device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        got.clear()
        set_optimizer_state_dict(target.model, target.optimizer, optim_sd)
        timings["peer_assemble_s"] = time.monotonic() - t0

    def _finish_mixed(self, target, model_sd, optim_sd, by_key, got,
                      missing, step, data_state, checkpointer,
                      donor_bytes, timings):
        """Shard-wise degradation: the shards no surviving replica holds
        come from the checkpoint at the SAME step (mixing steps would
        assemble a state that never existed). Loud by design: this is a
        failure domain doing damage, not business as usual."""
        recorder = obs.get_flight_recorder()
        if checkpointer is None or \
                step not in set(checkpointer.all_steps() or ()):
            recorder.record_event(
                "peer_restore_fallback", step=step, source="orbax",
                missing=len(missing), sample=missing[:5],
                reason="staged step not committed to storage")
            logger.error(
                "peer restore: %d shard(s) unavailable from any "
                "surviving peer and step %d is not in storage; falling "
                "back to the full checkpoint restore", len(missing), step)
            return None
        logger.error(
            "peer restore DEGRADED: no surviving replica for %d shard(s) "
            "(e.g. %s); reading them from checkpoint step %d",
            len(missing), ", ".join(missing[:3]), step)
        recorder.record_event(
            "peer_restore_fallback", step=step, source="mixed",
            missing=len(missing), sample=missing[:5],
            reason="no surviving replica; shard-wise checkpoint read")
        self._assemble(target, model_sd, optim_sd, by_key, got, timings)
        t0 = time.monotonic()
        with obs.span("restore_tensor_read",
                      {"step": step, "mixed": True}):
            _, storage_data, _ = checkpointer.restore_step(
                step, target, keys=missing)
        timings["dcp_read_s"] = time.monotonic() - t0
        if not data_state:
            data_state = storage_data
        self._record(step, "mixed", donor_bytes, missing=len(missing),
                     total_bytes=int(timings.get("peer_bytes", 0)),
                     transfer_s=timings.get("peer_transfer_s", 0.0))
        return target, data_state, step, "mixed"

    def _record(self, step: int, source: str,
                donor_bytes: Dict[str, int], missing: int,
                total_bytes: int, transfer_s: float) -> None:
        registry = obs.get_registry()
        registry.counter(
            "dlrover_tpu_restore_source_total",
            "Elastic restores by state source",
            labelnames=("source",)).labels(source=source).inc()
        registry.gauge(
            "dlrover_tpu_checkpoint_restore_bytes",
            "Bytes read by the last checkpoint restore",
            labelnames=("source",)).labels(source="peer").set(
            float(total_bytes))
        if transfer_s > 0 and total_bytes > 0:
            registry.gauge(
                "dlrover_tpu_checkpoint_restore_bandwidth_mbps",
                "Effective bandwidth of the last restore's "
                "tensor-transfer phase",
                labelnames=("source",)).labels(source="peer").set(
                round(total_bytes / (1 << 20) / transfer_s, 2))
        obs.get_flight_recorder().record_event(
            "peer_restore", step=step, source=source,
            bytes=total_bytes, missing=missing,
            donors={str(k): v for k, v in donor_bytes.items()})
        logger.info(
            "peer restore at step %d: source=%s %.1f MiB from %d "
            "donor(s) in %.2fs%s", step, source, total_bytes / (1 << 20),
            len(donor_bytes), transfer_s,
            f" ({missing} shard(s) via the checkpoint)" if missing else "")
