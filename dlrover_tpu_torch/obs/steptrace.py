"""Per-step trace records and NTP-style clock alignment (worker side).

Own copy of the JAX package's ``obs/steptrace.py`` (stdlib only, held
equal to it by ``tests/test_torch_steptrace.py``). Each finished step
emits one compact record: phase offsets from the step's start
(data_wait, h2d, compute, checkpoint; slice mode's local_post,
cross_slice_wait and apply), stamped with the worker's
clock offset against the master (:class:`ClockSync`: offset = server_ts
- (t0 + t1) / 2, uncertainty = RTT / 2, aged by a drift allowance).
:class:`StepTraceRecorder` buffers records in a bounded drop-oldest ring
and ships them over ``TelemetryReport.steptrace_json``. The master joins
and solves them (``dlrover_tpu_torch.master.steptrace``); the record
format here is the wire contract between the two. Clocks are
injectable.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

STEPTRACE_VERSION = 1

# canonical phase order for rendering (a record may carry any subset);
# local_post / cross_slice_wait / apply are the SliceGradSync
# decomposition, the rest mirror obs.timeline.PHASES
TRACE_PHASES = (
    "data_wait", "h2d", "compute", "local_post", "cross_slice_wait",
    "apply", "host_sync", "checkpoint",
)


class ClockSync:
    """NTP-style offset estimator over the master RPC path.

    ``offset`` approximates ``master_wall - local_wall``: one probe wraps
    a single round trip — ``t0 = wall(); server_ts = probe_fn();
    t1 = wall()`` — and the midpoint estimate
    ``server_ts - (t0 + t1) / 2`` errs by at most half the RTT under
    arbitrarily asymmetric request/response latency, so ``(t1 - t0) / 2``
    is a sound uncertainty bound. `estimate()` returns the sample whose
    *aged* bound (raw bound + DRIFT_PPM allowance per second since the
    probe) is smallest, so the stamped uncertainty keeps bounding the
    true offset as local oscillator drift accumulates between refreshes.

    ``probe_fn`` returns the server's wall clock (seconds) or raises /
    returns <= 0 on failure; probes are droppable by contract — a failed
    probe only ages the previous estimate. Clocks are injectable for the
    skew/drift/asymmetric-latency property tests.
    """

    # generous oscillator drift allowance (typical quartz is < 50 ppm;
    # 200 keeps the bound sound on thermally stressed hosts)
    DRIFT_PPM = 200.0

    def __init__(self, probe_fn: Optional[Callable[[], float]] = None,
                 wall: Callable[[], float] = time.time,
                 mono: Callable[[], float] = time.monotonic,
                 window: int = 8):
        self._probe_fn = probe_fn
        self._wall = wall
        self._mono = mono
        self._lock = threading.Lock()
        # (offset_s, err_s, mono_at) — newest last, bounded
        self._samples: deque = deque(maxlen=max(1, window))
        self._probes = 0
        self._failures = 0
        self._last_probe_mono = float("-inf")

    def probe(self) -> bool:
        """One synchronous round trip; False on failure (estimate keeps
        the previous samples)."""
        fn = self._probe_fn
        if fn is None:
            return False
        t0 = self._wall()
        try:
            server_ts = float(fn())
        except Exception:  # noqa: BLE001 — telemetry must never raise
            with self._lock:
                self._failures += 1
            return False
        t1 = self._wall()
        with self._lock:
            self._last_probe_mono = self._mono()
            if server_ts <= 0.0 or t1 < t0:
                # server declined (no master-side support) or the local
                # wall clock stepped backwards mid-probe: unusable
                self._failures += 1
                return False
            self._samples.append((server_ts - 0.5 * (t0 + t1),
                                  0.5 * (t1 - t0), self._mono()))
            self._probes += 1
            return True

    def maybe_probe(self, interval_s: float) -> bool:
        """Rate-limited refresh for hot-loop call sites: probes only when
        ``interval_s`` has elapsed since the last attempt (success or
        not — a dead master must not turn every step into an RPC)."""
        with self._lock:
            due = self._mono() - self._last_probe_mono >= interval_s
        return self.probe() if due else False

    def estimate(self) -> Tuple[float, float]:
        """``(offset_s, err_s)``: the sample with the smallest aged
        uncertainty. ``err_s`` is -1.0 before any successful probe ("no
        data", the repo-wide sentinel) with offset 0.0 — records from an
        unaligned worker still compose within their own host."""
        with self._lock:
            now = self._mono()
            samples = list(self._samples)
        if not samples:
            return 0.0, -1.0
        aged = [(off, err + max(0.0, now - at) * self.DRIFT_PPM * 1e-6)
                for off, err, at in samples]
        return min(aged, key=lambda s: s[1])

    def stats(self) -> Dict[str, float]:
        offset, err = self.estimate()
        with self._lock:
            return {"probes": self._probes, "failures": self._failures,
                    "offset_s": offset, "err_s": err,
                    "samples": len(self._samples)}


class StepTraceRecorder:
    """Bounded drop-oldest buffer of per-step trace records.

    ``record()`` is on the hot path (one call per step): it builds one
    small dict and appends under a plain lock — no I/O, no RPC
    (acceptance: < 1 % of a 10 ms step, like StepTimeline). Shipping
    happens at report cadence via ``flush_to`` over the TelemetryReport
    channel and is droppable by contract.

    Record format (the wire contract with master/steptrace.py)::

        {"v": 1, "step": int, "gen": int, "slice": int, "rank": int,
         "t0": local wall-clock at step start,
         "off": clock offset estimate (master - local, s),
         "err": offset uncertainty bound (s, -1.0 = unaligned),
         "phases": [[name, start_offset_s, duration_s], ...],
         "peers": {slice_id: header_observed_offset_s, ...}}  # optional

    Phase offsets are relative to ``t0``; the master aligns records by
    ``t0 + off`` into one fleet timeline.
    """

    def __init__(self, capacity: int = 512, rank: int = -1,
                 slice_id: int = -1,
                 clock_sync: Optional[ClockSync] = None):
        self._lock = threading.Lock()
        self._capacity = max(1, capacity)
        self._records: List[Dict[str, Any]] = []
        self._dropped = 0
        self._rank = int(rank)
        self._slice_id = int(slice_id)
        self._clock_sync = clock_sync

    def set_identity(self, rank: Optional[int] = None,
                     slice_id: Optional[int] = None) -> None:
        """Rank/slice become known (or change) after a rendezvous."""
        with self._lock:
            if rank is not None:
                self._rank = int(rank)
            if slice_id is not None:
                self._slice_id = int(slice_id)

    def record(self, step: int, generation: int, t0: float,
               phases: Iterable[Tuple[str, float, float]],
               peers: Optional[Dict[int, float]] = None) -> None:
        """One finished step. ``t0`` is the local wall clock at step
        start; ``phases`` are ``(name, start_offset_s, duration_s)``
        relative to it; ``peers`` maps peer slice id to the offset at
        which its gradient header was observed."""
        if self._clock_sync is not None:
            off, err = self._clock_sync.estimate()
        else:
            off, err = 0.0, -1.0
        entry: Dict[str, Any] = {
            "v": STEPTRACE_VERSION,
            "step": int(step),
            "gen": int(generation),
            "slice": self._slice_id,
            "rank": self._rank,
            "t0": float(t0),
            "off": round(off, 6),
            "err": round(err, 6),
            "phases": [[str(n), round(float(s), 6), round(float(d), 6)]
                       for n, s, d in phases],
        }
        if peers:
            entry["peers"] = {str(k): round(float(v), 6)
                              for k, v in peers.items()}
        with self._lock:
            self._records.append(entry)
            overflow = len(self._records) - self._capacity
            if overflow > 0:
                del self._records[:overflow]
                self._dropped += overflow

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            batch, self._records = self._records, []
            return batch

    def flush_to(self, client) -> None:
        """Drain and ship via ``client.report_telemetry(steptrace=...)``.
        Telemetry is droppable by contract: every failure is swallowed
        (the batch is lost, the caller's step loop must never be)."""
        batch = self.drain()
        if not batch:
            return
        try:
            client.report_telemetry(steptrace=batch)
        except Exception:  # noqa: BLE001 — droppable by contract
            pass

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped


def phase_seconds(record: Dict[str, Any]) -> Dict[str, float]:
    """Total seconds per phase name in one record (a phase may appear in
    several segments). Malformed segments are skipped, not raised — the
    wire is telemetry."""
    totals: Dict[str, float] = {}
    for seg in record.get("phases") or []:
        try:
            name, _, dur = seg[0], float(seg[1]), float(seg[2])
        except (TypeError, ValueError, IndexError):
            continue
        totals[str(name)] = totals.get(str(name), 0.0) + max(0.0, dur)
    return totals
