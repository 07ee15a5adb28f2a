"""In-master key/value store backing the process-group bootstrap.

Own copy of the JAX package's ``master/kv_store.py``: agents publish the
rank-0 rendezvous address, barrier counters and per-round process ranks
under round-scoped keys, so a re-formed world after an elastic resize
never collides with stale keys. ``wait`` blocks server-side on a
condition variable with a timeout (``KVWaitRequest`` over the wire), so a
client needs one RPC per ~20 s window instead of one per poll tick.

Hot keys (``dcn/``, ``coord/``) carry a generation in the key itself
(``coord/<rdzv>/<round>``), and the store garbage-collects superseded
generations on write, so a stale previous-episode value can neither be
adopted nor accumulate. ``coord/`` mutations append their resulting
value to the attached mutation log (``master/state_backend.py``) instead
of triggering a snapshot; ``dcn/`` payloads are per-step and never
logged. ``export_state``/``restore_state`` carry the store through a
snapshot (values base64), and ``replay_mutations`` applies the log over
it on a restarted or promoted master.
"""

from __future__ import annotations

import base64
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import HOT_KV_PREFIXES as HOT_PREFIXES
from dlrover_tpu_torch.common.constants import LOGGED_KV_PREFIXES

# Generation-namespaced key shapes → (group, generation). The GROUP is the
# key with its generation component removed; within one group only the
# newest ``keep_generations`` generations are retained.
#   dcn/g<E>/<rest>                 (cross-slice sync, E = world epoch)
#   coord/<rdzv>/slice<S>/<round>   (per-slice rendezvous barrier)
#   coord/<rdzv>/<round>[/<group>]  (sliceless / network-check barrier)
_GENERATION_PATTERNS = (
    re.compile(r"^(dcn/)g(\d+)(/.+)$"),
    re.compile(r"^(coord/[^/]+/slice[^/]+/)(\d+)((?:/.+)?)$"),
    re.compile(r"^(coord/[^/]+/)(\d+)((?:/.+)?)$"),
)


def split_generation(key: str) -> Optional[Tuple[str, int]]:
    """(group, generation) for a generation-namespaced key, else None.
    The group folds the non-generation segments back together so
    ``coord/t/3/grp0`` and ``coord/t/4/grp0`` share a group while
    ``coord/t/4/grp1`` does not."""
    for pattern in _GENERATION_PATTERNS:
        match = pattern.match(key)
        if match:
            return match.group(1) + match.group(3), int(match.group(2))
    return None


class KVStoreService:
    def __init__(self, keep_generations: int = 2):
        self._store: Dict[str, bytes] = {}
        self._cond = threading.Condition()
        # generation hygiene: group -> {generation -> [keys]} for the
        # namespaced hot keys; superseded generations are collected on
        # write, keeping the newest ``keep_generations`` (the current
        # episode plus one for in-flight readers of the one it replaced)
        self._keep_generations = max(1, keep_generations)
        self._generations: Dict[str, Dict[int, List[str]]] = {}
        self.collected_total = 0
        # hot-key durability: appended per mutation instead of
        # triggering a snapshot (state_backend.MutationLog; None = off)
        self._mutation_log = None

    # -- hot-key plumbing ------------------------------------------------
    @staticmethod
    def is_hot(key: str) -> bool:
        """Hot keys live on the gradient path: they never trigger a
        control-plane snapshot (the servicer checks this)."""
        return key.startswith(HOT_PREFIXES)

    def attach_mutation_log(self, log) -> None:
        """Durability sink for hot mutations (replayed over the last
        snapshot by a restarted or promoted master)."""
        with self._cond:
            self._mutation_log = log

    def _log_mutation_locked(self, key: str, value: bytes) -> None:
        """(lock held) Append the RESULTING value (not the op), so
        replay is idempotent last-wins even for ``add``. Only the
        durable-worthy hot prefixes (LOGGED_KV_PREFIXES) land in the
        log."""
        if (self._mutation_log is not None
                and key.startswith(LOGGED_KV_PREFIXES)):
            self._mutation_log.append(key, value)

    def _gc_superseded_locked(self, key: str) -> int:
        """(lock held) Register ``key``'s generation and drop every key
        of generations its group has superseded. Returns the collected
        count — the CALLER increments the registry counter OUTSIDE the
        lock (registry children take their own locks and must never
        nest under a state lock)."""
        split = split_generation(key)
        if split is None:
            return 0
        group, generation = split
        gens = self._generations.setdefault(group, {})
        gens.setdefault(generation, [])
        if key not in gens[generation]:
            gens[generation].append(key)
        newest = sorted(gens)
        stale = newest[:-self._keep_generations]
        collected = 0
        for gen in stale:
            for stale_key in gens.pop(gen):
                if self._store.pop(stale_key, None) is not None:
                    collected += 1
                    self._log_mutation_locked(stale_key, b"")
        if collected:
            self.collected_total += collected
        return collected

    @staticmethod
    def _count_collected(collected: int) -> None:
        if not collected:
            return
        from dlrover_tpu_torch import obs

        obs.get_registry().counter(
            "dlrover_tpu_kv_gc_keys_total",
            "Hot kv keys of superseded generations garbage-collected "
            "(episode hygiene: a stale previous-episode payload must "
            "never be re-adopted)").inc(collected)

    # -- the store -------------------------------------------------------
    def set(self, key: str, value: bytes) -> None:
        with self._cond:
            self._store[key] = value
            self._log_mutation_locked(key, value)
            collected = self._gc_superseded_locked(key)
            self._cond.notify_all()
        self._count_collected(collected)

    def get(self, key: str) -> bytes:
        # lock-free: one dict lookup (atomic under the GIL; writers
        # replace values wholesale and never mutate them in place)
        return self._store.get(key, b"")

    def add(self, key: str, amount: int) -> int:
        """Atomic integer add; missing key counts as 0."""
        with self._cond:
            current = int(self._store.get(key, b"0"))
            current += amount
            self._store[key] = str(current).encode()
            self._log_mutation_locked(key, self._store[key])
            collected = self._gc_superseded_locked(key)
            self._cond.notify_all()
        self._count_collected(collected)
        return current

    def wait(self, keys: List[str], timeout_s: float) -> bool:
        """Block until every key exists, or timeout. Returns success."""
        deadline = time.time() + timeout_s
        with self._cond:
            while True:
                if all(k in self._store for k in keys):
                    return True
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)

    def delete(self, key: str) -> None:
        with self._cond:
            if self._store.pop(key, None) is not None:
                self._log_mutation_locked(key, b"")

    def clear_prefix(self, prefix: str) -> int:
        """Drop all keys under a (round-scoped) prefix; returns count."""
        with self._cond:
            stale = [k for k in self._store if k.startswith(prefix)]
            for k in stale:
                del self._store[k]
                self._log_mutation_locked(k, b"")
            return len(stale)

    def num_keys(self) -> int:
        with self._cond:
            return len(self._store)

    # -- crash-consistent state (master/state_backend.py) ------------------
    def export_state(self) -> dict:
        """Values are bytes: base64 keeps the snapshot JSON-safe."""
        with self._cond:
            return {k: base64.b64encode(v).decode("ascii")
                    for k, v in self._store.items()}

    def restore_state(self, state: dict) -> None:
        with self._cond:
            self._store = {k: base64.b64decode(v)
                           for k, v in state.items()}
            # rebuild the generation index from the restored keys so
            # hygiene picks up where the dead master left off
            self._generations = {}
            for key in self._store:
                split = split_generation(key)
                if split is not None:
                    group, generation = split
                    self._generations.setdefault(
                        group, {}).setdefault(generation, []).append(key)
            # restored keys may satisfy a blocked wait
            self._cond.notify_all()

    def replay_mutations(self, entries) -> int:
        """Apply (key, value) pairs from a mutation log over the
        restored snapshot (value b"" = deletion). Last-wins, idempotent;
        returns the number applied."""
        applied = 0
        with self._cond:
            for key, value in entries:
                if value:
                    self._store[key] = value
                else:
                    self._store.pop(key, None)
                applied += 1
                split = split_generation(key)
                if split is not None and value:
                    group, generation = split
                    gens = self._generations.setdefault(group, {})
                    keys = gens.setdefault(generation, [])
                    if key not in keys:
                        keys.append(key)
            if applied:
                self._cond.notify_all()
        return applied
