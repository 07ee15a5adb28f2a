"""Crash-consistent master state: a versioned, checksummed snapshot store.

Own copy of the JAX package's ``master/state_backend.py``. The job master
is the one process whose death would otherwise kill the job: the
rendezvous, the dataset tasks, the kv store, the goodput ledger and the
diagnosis reports live in its memory. This module gives it durable
control-plane state with what an atomic-rename filesystem offers:

- **Atomicity**: every snapshot is written to a temp file in the same
  directory and ``os.replace``d into place, so a crash mid-write leaves
  the previous snapshot intact, never a torn file.
- **Integrity**: the snapshot wrapper carries a SHA-256 over the
  canonical JSON of the state payload; ``load_latest`` verifies it and
  falls back to the next-older snapshot on a mismatch.
- **Bounded retention**: only the newest ``retain`` snapshots are kept.

The hot ``coord/`` kv keys do not trigger snapshots; their mutations
ride :class:`MutationLog`, replayed over the latest snapshot by a
restarted or promoted master.

Snapshot files (``master-state-<10-digit version>.json``) and the log
(``kv-mutlog.jsonl``) are byte-compatible with the JAX package's in both
directions: either package's master restores the other's lineage.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import re
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.log import default_logger as logger

_SNAPSHOT_RE = re.compile(r"^master-state-(\d{10})\.json$")
_FORMAT_VERSION = 1
MUTATION_LOG_NAME = "kv-mutlog.jsonl"


def _canonical(state: Dict[str, Any]) -> str:
    """Deterministic JSON for checksumming (and change detection)."""
    return json.dumps(state, sort_keys=True, separators=(",", ":"))


def _checksum(payload: str) -> str:
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


class SnapshotCorruptionError(RuntimeError):
    """A snapshot file failed its checksum / structure validation."""


class MutationLog:
    """Append-only log of the durable-worthy HOT mutations (the
    ``coord/`` barrier keys) between snapshots.

    Snapshots deliberately exclude the gradient-path keys from their
    TRIGGER set (a full export+fsync per training step would put storage
    in the step loop), so the barrier mutations land here instead: one
    JSON line per mutation, buffered writes, NO fsync. ``append`` is an
    in-memory ENQUEUE — a background drainer owns the disk, so the kv
    store's condition lock never waits on the (typically shared/NFS)
    state volume. The log is ROTATED (truncated) every time a snapshot
    is written, because the snapshot's state export includes the hot
    keys' values at that instant: replaying the (strictly newer) log
    over the latest snapshot is therefore always last-wins correct. A
    restarted master — or a promoted hot standby — replays it via
    ``KVStoreService.replay_mutations``.

    ``gate``: an optional callable the DRAINER consults before each
    write; truthy = this master has been fenced (a higher-generation
    master owns the lineage) and the entries are discarded instead of
    written. Checking on the drainer thread means fencing bites even
    when ONLY hot traffic is flowing (nothing else would run the
    fence check), and the check's own file read never runs under the
    kv lock.
    """

    def __init__(self, directory: str):
        self._path = os.path.join(directory, MUTATION_LOG_NAME)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # the open handle is OWNED by the drainer thread: every
        # write/flush happens outside the lock (kv mutations enqueue
        # under the kv condition, so a disk stall here would stall
        # them). rotate()/close() take the handle out under the lock
        # after quiescing the drainer and do their file work unlocked.
        self._file = None
        self._seq = 0
        self._queue: List[Tuple[int, str]] = []   # (seq, json line)
        self._in_flight = 0
        self._rotating = False
        # bumped at every rotation start: a drainer batch that raced a
        # rotation (quiesce timeout) detects the epoch change and
        # re-writes itself to the FRESH file instead of silently
        # landing on the replaced inode
        self._rotations = 0
        # the seq fence of the last rotation: entries below it are
        # covered by the snapshot that triggered the rotation and must
        # NOT be re-enqueued (a resurrected pre-snapshot value would
        # regress the key on last-wins replay); entries at/after it
        # are post-export and must SURVIVE the rotation
        self._rotate_cutoff = 0
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self.gate = None
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        with self._lock:
            return self._path

    def current_seq(self) -> int:
        """The next seq to be assigned — the caller samples it BEFORE a
        state export as the rotation fence: every mutation the export
        can contain was appended (same kv lock) with a smaller seq,
        and anything the export might miss gets a larger one."""
        with self._cond:
            return self._seq

    def append(self, key: str, value: bytes) -> None:
        """Enqueue the RESULTING value of a mutation (b"" = the key was
        deleted); the drainer writes it. Cheap by design: callers hold
        the kv store's condition lock. The payload encoding happens
        OUTSIDE this log's lock (only the seq stamp needs it) so a
        large value never extends the critical section."""
        encoded = base64.b64encode(value).decode("ascii")
        with self._cond:
            if self._stopped:
                return
            seq = self._seq
            self._seq += 1
            line = json.dumps({"seq": seq, "k": key, "v": encoded})
            self._queue.append((seq, line))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._drain, daemon=True,
                    name="kv-mutlog-writer")
                self._thread.start()
            self._cond.notify_all()

    def _drain(self) -> None:
        while True:
            with self._cond:
                while self._rotating or (
                        not self._queue and not self._stopped):
                    if self._stopped and not self._queue:
                        return
                    self._cond.wait()
                if self._stopped and not self._queue:
                    return
                batch = self._queue
                self._queue = []
                self._in_flight = len(batch)
                handle = self._file
                epoch = self._rotations
            gate = self.gate
            discarded = False
            try:
                if gate is not None and gate():
                    # fenced: a higher-generation master owns this
                    # lineage — drop instead of corrupting its log
                    discarded = True
                    continue
                # file work OUTSIDE the lock: the handle is drainer-
                # owned between rotations (rotate/close quiesce on
                # _in_flight before touching it), so an append caller
                # holding the kv condition never waits on the disk
                if handle is None:
                    handle = open(self._path, "a")
                    with self._cond:
                        if self._rotations == epoch and \
                                not self._rotating:
                            self._file = handle
                handle.write(
                    "\n".join(line for _, line in batch) + "\n")
                handle.flush()
            except (OSError, ValueError) as e:
                # ValueError: write on a handle rotate closed in the
                # quiesce-timeout corner (the epoch re-check below
                # re-writes the batch to the fresh file)
                logger.warning("mutation log append failed: %s", e)
            except Exception:  # noqa: BLE001 — a broken gate must not
                # kill the writer
                logger.exception("mutation log gate failed")
            finally:
                with self._cond:
                    if not discarded and epoch != self._rotations:
                        # a rotation raced this batch past its quiesce
                        # timeout: the bytes may sit on the replaced
                        # inode. Drop the (possibly stale) handle and
                        # re-enqueue ONLY the post-fence entries for
                        # the fresh file — pre-fence ones are covered
                        # by the snapshot that rotated, and re-writing
                        # them could resurrect a superseded value over
                        # the snapshot's newer one on replay.
                        if handle is not None:
                            try:
                                handle.close()
                            except OSError:
                                pass
                        if self._file is handle:
                            self._file = None
                        keep = [entry for entry in batch
                                if entry[0] >= self._rotate_cutoff]
                        self._queue = keep + self._queue
                    self._in_flight = 0
                    self._cond.notify_all()

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Block until everything appended so far is on disk (or was
        gate-discarded). Returns False on timeout."""
        import time as time_mod

        deadline = time_mod.time() + timeout_s
        with self._cond:
            while self._queue or self._in_flight:
                remaining = deadline - time_mod.time()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def rotate(self, up_to_seq: Optional[int] = None) -> None:
        """Drop entries the snapshot just made durable. ``up_to_seq``
        is the fence the caller sampled via :meth:`current_seq` BEFORE
        exporting state: entries below it are in (or older than) the
        snapshot and go; entries at/after it may have landed between
        the export and this call — they are in NEITHER the snapshot
        nor (after a naive truncate) the log, so they are preserved in
        the rewritten file and the queue. ``None`` = fence at the
        current seq (drop everything enqueued so far — the caller
        guarantees its snapshot covers the present instant).

        Quiesces the drainer (bounded), then does the file work off
        the lock — ``_rotating`` keeps the drainer from re-opening
        mid-swap."""
        import time as time_mod

        deadline = time_mod.time() + 2.0
        with self._cond:
            fence = self._seq if up_to_seq is None else up_to_seq
            self._queue = [entry for entry in self._queue
                           if entry[0] >= fence]
            while self._in_flight:
                remaining = deadline - time_mod.time()
                if remaining <= 0 or not self._cond.wait(remaining):
                    break     # proceed anyway; the write path survives
            self._rotating = True
            self._rotations += 1
            self._rotate_cutoff = fence
            handle, self._file = self._file, None
        try:
            if handle is not None:
                handle.close()
            # rewrite instead of truncate: drained entries at/after
            # the fence are post-export and must survive the rotation
            survivors = []
            try:
                with open(self._path) as f:
                    for raw in f:
                        raw = raw.strip()
                        if not raw:
                            continue
                        try:
                            if int(json.loads(raw)["seq"]) >= fence:
                                survivors.append(raw)
                        except (ValueError, KeyError, TypeError):
                            continue   # torn line: gone either way
            except OSError:
                pass
            tmp = f"{self._path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                if survivors:
                    f.write("\n".join(survivors) + "\n")
            os.replace(tmp, self._path)
        except OSError as e:
            logger.warning("mutation log rotate failed: %s", e)
        finally:
            with self._cond:
                self._rotating = False
                self._cond.notify_all()

    def close(self) -> None:
        self.flush(timeout_s=2.0)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=2.0)
        with self._cond:
            handle, self._file = self._file, None
        if handle is not None:
            try:
                handle.close()
            except OSError:
                pass

    @staticmethod
    def read(directory: str) -> List[Tuple[str, bytes]]:
        """(key, value) pairs in append order, SKIPPING malformed lines
        (a torn tail on crash, or a partial write the writer survived
        and appended past — truncating at the first bad line would
        silently drop every committed mutation after it; skipping is
        safe under the replay's last-wins semantics). Empty when no log
        exists."""
        path = os.path.join(directory, MUTATION_LOG_NAME)
        entries: List[Tuple[str, bytes]] = []
        skipped = 0
        try:
            with open(path) as f:
                lines: Iterable[str] = f.readlines()
        except OSError:
            return entries
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
                entries.append((str(record["k"]),
                                base64.b64decode(record["v"])))
            except (ValueError, KeyError):
                skipped += 1
        if skipped:
            logger.warning(
                "mutation log %s: %d malformed line(s) skipped "
                "(torn/partial writes)", path, skipped)
        return entries


class MasterStateBackend:
    """Versioned snapshot files under one directory.

    Concurrency: one writer (the master process — ``save*`` serializes on
    an internal lock); readers (``load_latest``) tolerate the writer
    replacing files underneath them because replacement is atomic.
    """

    def __init__(self, directory: str, retain: int = 5):
        if retain < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        self._dir = directory
        self._retain = retain
        self._lock = threading.Lock()
        # double-primary fencing: wired by the owner (JobMaster sets
        # _check_fenced; a standby pins it permanently closed).  gate()
        # returning True means "deposed": every save becomes a no-op so
        # a stale master cannot interleave snapshot versions with the
        # promoted one's writes over the shared lineage.
        self.gate: Optional[Callable[[], bool]] = None
        os.makedirs(directory, exist_ok=True)
        existing = self.versions()
        self._next_version = (existing[-1] + 1) if existing else 1
        self._last_checksum = ""

    @property
    def directory(self) -> str:
        return self._dir

    def _path(self, version: int) -> str:
        return os.path.join(self._dir, f"master-state-{version:010d}.json")

    def versions(self) -> List[int]:
        """Snapshot versions present on disk, oldest first."""
        found = []
        try:
            names = os.listdir(self._dir)
        except OSError:
            return []
        for name in names:
            match = _SNAPSHOT_RE.match(name)
            if match:
                found.append(int(match.group(1)))
        return sorted(found)

    # -- writing -----------------------------------------------------------
    def save(self, state: Dict[str, Any]) -> Optional[str]:
        """Write a new snapshot version atomically; returns its path
        (None when the fence gate reports this writer deposed)."""
        if self.gate is not None and self.gate():
            return None
        payload = _canonical(state)
        return self._write(state, payload)

    def save_if_changed(self, state: Dict[str, Any]) -> Optional[str]:
        """Write only when the state differs from the last written
        snapshot (the per-mutation hook: polls that mutate nothing must
        not churn versions). Returns the path, or None when skipped."""
        if self.gate is not None and self.gate():
            return None
        payload = _canonical(state)
        with self._lock:
            if self._last_checksum and \
                    _checksum(payload) == self._last_checksum:
                return None
        return self._write(state, payload)

    def _write(self, state: Dict[str, Any], payload: str) -> str:
        digest = _checksum(payload)
        with self._lock:
            version = self._next_version
            self._next_version += 1
            path = self._path(version)
            wrapper = {
                "format": _FORMAT_VERSION,
                "version": version,
                "checksum": digest,
                "state": state,
            }
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(wrapper, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._last_checksum = digest
            self._prune()
        obs.get_registry().counter(
            "dlrover_tpu_master_snapshots_total",
            "Control-plane state snapshots written").inc()
        return path

    def _prune(self) -> None:
        """Drop snapshots beyond the retention window (lock held)."""
        versions = self.versions()
        for version in versions[:-self._retain]:
            try:
                os.remove(self._path(version))
            except OSError:
                pass

    # -- reading -----------------------------------------------------------
    def load_version(self, version: int) -> Dict[str, Any]:
        """Load + verify one snapshot; raises SnapshotCorruptionError."""
        path = self._path(version)
        try:
            with open(path) as f:
                wrapper = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise SnapshotCorruptionError(
                f"snapshot {path} unreadable: {e}") from e
        state = wrapper.get("state")
        if not isinstance(state, dict):
            raise SnapshotCorruptionError(
                f"snapshot {path} has no state dict")
        if _checksum(_canonical(state)) != wrapper.get("checksum"):
            raise SnapshotCorruptionError(
                f"snapshot {path} failed its checksum")
        return state

    def load_latest(self) -> Optional[Tuple[Dict[str, Any], int]]:
        """Newest valid snapshot as (state, version), walking backwards
        past corrupt ones (each fallback is counted + logged loudly);
        None when no valid snapshot exists."""
        fallbacks = obs.get_registry().counter(
            "dlrover_tpu_master_snapshot_fallbacks_total",
            "Corrupt snapshots skipped during master recovery")
        for version in reversed(self.versions()):
            try:
                return self.load_version(version), version
            except SnapshotCorruptionError as e:
                logger.error(
                    "master state snapshot v%d is corrupt (%s); falling "
                    "back to the previous snapshot", version, e)
                fallbacks.inc()
        return None
