"""Goodput ledger: classify the job's wall-clock, per rank and job-wide.

What share of the job's card-seconds trained the model, and where did
the rest go? The ledger is that accounting layer: every rank-second of
the job lands in exactly one bucket —

- ``productive``       — steps making forward progress (step reports,
                         net of their data-wait fraction),
- ``data_wait``        — step time starving on the input pipeline,
- ``compile``          — re-lower/re-jit after an elastic resize
                         (``recompile`` spans, phase=relower; the AOT
                         phase overlaps the restore read and is counted
                         under ``restore``),
- ``rendezvous``       — agents joining/re-forming a world
                         (``rendezvous``/``reconnect`` spans),
- ``restore``          — the ``restore_or_init`` path (checkpoint read +
                         device put + overlapped compile),
- ``checkpoint_stall`` — blocking commit waits and emergency saves
                         (``checkpoint_wait``/``emergency_checkpoint``;
                         the async interval save's dispatch rides inside
                         step time and is deliberately NOT re-counted),
- ``drain``            — preemption drains, notice → departure,
- ``hang``             — time a rank made no progress before a
                         hang-classified exit (estimated from its last
                         activity),
- ``idle``             — the residual nothing above accounts for
                         (derived at query time, never accrued).

Wall-clock is accounted in RANK-seconds: job-wide buckets are sums over
ranks, the denominator is the sum of per-rank lifetimes, and
``goodput_fraction = productive / elapsed``. Incarnations segment the
accounting at every world re-formation so a postmortem can say "the
drain at round 3 cost 41 s of badput" (``render_snapshot``).

Feeding (master side, wired by JobMaster/MasterServicer):

- ``observe_span`` from the telemetry ingest path (rank known from the
  TelemetryReport; span-id dedup absorbs standalone double delivery),
- ``observe_step_report`` from GlobalStepReport,
- ``mark_draining``/``complete_drain``/``observe_hang`` from the drain
  and failure handlers,
- ``observe_world`` from the comm-world path (opens incarnations).

Own copy of the JAX package's ``obs/goodput.py`` (stdlib-only, so the
port keeps its own); the clock is injectable so tests run on a fake
clock. The ``compile`` bucket reads the JAX package's ``recompile``
spans, which the port's worker does not emit (its kernels are built
once a process, inside the restore). Lock discipline: all shared
state under ``self._lock``; registry operations happen OUTSIDE the lock
(sinks must never run under it).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

PRODUCTIVE = "productive"
BADPUT_BUCKETS = ("data_wait", "compile", "rendezvous", "restore",
                  "checkpoint_stall", "drain", "hang", "idle")
BUCKETS = (PRODUCTIVE,) + BADPUT_BUCKETS

# span name → bucket. Nested/duplicate spans are deliberately absent:
# `rendezvous_join`/`rendezvous_round` live inside the agent's
# `rendezvous` trace, `checkpoint_restore` inside `restore_or_init`,
# `checkpoint_save` inside the reported step time, `master_restore` on
# the master while workers keep training.
_SPAN_BUCKETS = {
    "recompile": "compile",
    "rendezvous": "rendezvous",
    "reconnect": "rendezvous",
    "restore_or_init": "restore",
    "checkpoint_wait": "checkpoint_stall",
    "emergency_checkpoint": "checkpoint_stall",
    "drain": "drain",
}

_SEEN_SPAN_CAP = 4096      # span-id dedup ring
_WINDOW_CAP = 8192         # accrual records retained for windowed views
_INCARNATION_CAP = 64      # incarnation segments retained
_JOB_RANK = -1             # accruals not attributable to one rank


def classify_span(name: str, attrs: Optional[Dict[str, Any]] = None
                  ) -> str:
    """Bucket for a finished span, "" when the span is not ledger
    evidence (nested, master-side, or steady-state)."""
    bucket = _SPAN_BUCKETS.get(name, "")
    if bucket == "compile" and (attrs or {}).get("phase") == "aot":
        # the AOT compile overlaps the checkpoint read inside
        # restore_or_init (the loop pays max(read, compile)); counting
        # both would invent wall-clock
        return ""
    return bucket


class GoodputLedger:
    def __init__(self, registry=None,
                 now_fn: Callable[[], float] = time.time):
        from dlrover_tpu_torch.obs.metrics import get_registry

        self._now = now_fn
        self._lock = threading.Lock()
        # rank -> {bucket: seconds} cumulative (idle excluded: derived)
        self._buckets: Dict[int, Dict[str, float]] = {}
        # rank lifetime: first_seen/last_activity/gone timestamps
        self._first_seen: Dict[int, float] = {}
        # ephemeral: export is timestamp-free by design
        self._last_activity: Dict[int, float] = {}
        self._gone: Dict[int, float] = {}
        self._state: Dict[int, str] = {}            # current activity
        # rank -> (notice_ts, rank bucket-total at notice): drain
        # accrues the notice→departure RESIDUAL, so accruals landing
        # inside the interval (the emergency checkpoint span, final
        # steps) are not double-counted
        self._draining_since: Dict[int, Tuple[float, float]] = {}
        self._last_step: Dict[int, int] = {}
        self._last_report_ts: Dict[int, float] = {}
        # ephemeral: re-learned from the next step reports
        self._mfu: Dict[int, float] = {}
        # multi-slice hierarchical DP: rank → slice (rendezvous slice
        # registry), per-rank degraded-step tallies (steps taken with
        # the gradient mean renormalized while a peer slice was
        # absent), and the slice label each rank's state gauge was
        # published under (removal must match the labels it was set
        # with, even across a slice-map update)
        self._slice_map: Dict[int, int] = {}
        self._degraded_steps: Dict[int, int] = {}
        # ephemeral: gauge label memory; republished
        self._state_slice: Dict[int, str] = {}
        # ephemeral: span dedup; dead spans cannot recur
        self._seen_span_ids: deque = deque(maxlen=_SEEN_SPAN_CAP)
        # ephemeral: mirror of _seen_span_ids
        self._seen_set: set = set()
        # online parallelism re-plans: the replan_plan/replan_migrate/
        # replan_rebuild sub-phase spans (nested inside the restore/
        # compile evidence — recorded here for the per-resize summary,
        # NOT accrued again as wall-clock)
        # ephemeral: timestamped; excluded from export
        self._replans: deque = deque(maxlen=64)
        # (ts, rank, bucket, seconds) for windowed summaries
        # ephemeral: window samples; outage reads as idle
        self._window: deque = deque(maxlen=_WINDOW_CAP)
        self._job_start = self._now()
        self._incarnations: deque = deque(maxlen=_INCARNATION_CAP)
        self._round = -1
        self._pending_reason = "job_start"
        with self._lock:
            self._open_incarnation(self._round, 0, self._pending_reason,
                                   self._job_start)
        registry = registry or get_registry()
        self._seconds_total = registry.counter(
            "dlrover_tpu_goodput_seconds_total",
            "Cumulative job wall-clock (rank-seconds) attributed to "
            "each goodput/badput bucket (idle is derived, see "
            "dlrover_tpu_goodput_fraction)", labelnames=("bucket",))
        self._events_total = registry.counter(
            "dlrover_tpu_elasticity_events_total",
            "World re-formations by trigger", labelnames=("kind",))
        self._state_gauge = registry.gauge(
            "dlrover_tpu_worker_goodput_state",
            "1 for the rank's current activity state",
            labelnames=("node", "slice", "state"))
        registry.gauge(
            "dlrover_tpu_goodput_fraction",
            "Cumulative productive fraction of the job's rank-seconds",
        ).set_function(self.goodput_fraction)

    # -- internal accrual (compute under lock, meter outside) --------------
    def _accrue_locked(self, rank: int, bucket: str, seconds: float,
                       ts: float) -> float:
        """Returns the seconds actually accrued (callers meter outside
        the lock)."""
        if seconds <= 0.0 or bucket not in BUCKETS or bucket == "idle":
            return 0.0
        table = self._buckets.setdefault(rank, {})
        table[bucket] = table.get(bucket, 0.0) + seconds
        self._window.append((ts, rank, bucket, seconds))
        inc = self._incarnations[-1]
        key = PRODUCTIVE if bucket == PRODUCTIVE else "badput"
        inc[key] = inc.get(key, 0.0) + seconds
        if bucket != PRODUCTIVE:
            per = inc.setdefault("badput_buckets", {})
            per[bucket] = per.get(bucket, 0.0) + seconds
        return seconds

    def _touch_locked(self, rank: int, ts: float) -> None:
        if rank == _JOB_RANK:
            return
        self._first_seen.setdefault(rank, ts)
        if ts > self._last_activity.get(rank, 0.0):
            self._last_activity[rank] = ts
        self._gone.pop(rank, None)

    def _open_incarnation(self, round_: int, world: int, reason: str,
                          ts: float) -> None:
        """(lock held)"""
        self._incarnations.append({
            "round": round_, "world": world, "reason": reason,
            "started_ts": ts, PRODUCTIVE: 0.0, "badput": 0.0,
            "badput_buckets": {},
        })

    def _set_state(self, rank: int, state: str
                   ) -> Optional[Tuple[int, str, str]]:
        """Under lock; returns (rank, old, new) when it changed so the
        caller updates the gauge outside the lock."""
        old = self._state.get(rank, "")
        if old == state:
            return None
        self._state[rank] = state
        return rank, old, state

    def _publish_state(self, change: Optional[Tuple[int, str, str]]
                       ) -> None:
        if change is None:
            return
        rank, old, new = change
        with self._lock:
            old_slice = self._state_slice.get(rank)
            new_slice = str(self._slice_map.get(rank, -1))
            if new:
                self._state_slice[rank] = new_slice
            else:
                self._state_slice.pop(rank, None)
        if old and old_slice is not None:
            self._state_gauge.remove(node=str(rank), slice=old_slice,
                                     state=old)
        if new:
            self._state_gauge.labels(node=str(rank), slice=new_slice,
                                     state=new).set(1)

    # -- slice membership (multi-slice hierarchical DP) --------------------
    def set_slice_map(self, slice_map: Dict[int, int]) -> None:
        with self._lock:
            self._slice_map = dict(slice_map)

    def observe_degraded_steps(self, rank: int, count: int) -> None:
        """``count`` degraded steps reported by ``rank``'s slice: the
        gradient mean was renormalized over present slices while a peer
        slice was absent. Tallied per rank for the snapshot/tools view
        (the labeled counter series is the servicer's)."""
        if count <= 0:
            return
        with self._lock:
            self._degraded_steps[rank] = (
                self._degraded_steps.get(rank, 0) + int(count))

    # -- evidence feeds ----------------------------------------------------
    def observe_span(self, record: Dict[str, Any],
                     rank: int = _JOB_RANK) -> bool:
        """One finished span dict (``Span.to_dict`` shape). Returns
        whether it was newly accounted (span-id re-deliveries — local
        sink + telemetry relay in a standalone process — are dropped)."""
        if not isinstance(record, dict):
            return False
        name = str(record.get("name", ""))
        bucket = classify_span(name, record.get("attrs"))
        span_id = record.get("span_id")
        try:
            duration = float(record.get("duration_s", 0.0))
        except (TypeError, ValueError):
            return False
        ts = float(record.get("ts", 0.0) or 0.0) or self._now()
        with self._lock:
            if span_id:
                if span_id in self._seen_set:
                    return False
                if len(self._seen_span_ids) == self._seen_span_ids.maxlen:
                    self._seen_set.discard(self._seen_span_ids[0])
                self._seen_span_ids.append(span_id)
                self._seen_set.add(span_id)
            if name.startswith("replan_") and duration >= 0.0:
                # the re-plan sub-phase decomposition (plan → migrate →
                # rebuild): per-resize evidence for the snapshot/tools
                # view. These spans nest INSIDE the restore/compile
                # evidence — recording them here never re-accrues their
                # wall-clock.
                attrs = record.get("attrs") or {}
                self._replans.append({
                    "phase": name[len("replan_"):],
                    "rank": rank,
                    "seconds": round(duration, 3),
                    "ts": ts,
                    "generation": attrs.get("generation", 0),
                    "detail": {k: v for k, v in attrs.items()
                               if k in ("source", "bytes", "resharded",
                                        "applied", "mesh")},
                })
            if not bucket or duration <= 0.0:
                return False
            self._touch_locked(rank, ts + duration)
            accrued = self._accrue_locked(rank, bucket, duration,
                                          ts + duration)
        if accrued > 0.0:
            self._seconds_total.labels(bucket=bucket).inc(accrued)
        return True

    def observe_step_report(self, rank: int, step: int,
                            step_time_s: float = 0.0,
                            data_wait_fraction: float = -1.0,
                            mfu: float = -1.0,
                            ts: Optional[float] = None) -> None:
        """Productive/data-wait accrual from one GlobalStepReport: the
        delta of steps since the rank's last report, at its reported
        mean step time, split by its data-wait fraction. A report with
        no timing evidence (step_time_s == 0) accrues nothing — the
        un-attributed time lands in ``idle``, honestly."""
        now = ts if ts is not None else self._now()
        metered: List[Tuple[str, float]] = []
        with self._lock:
            self._touch_locked(rank, now)
            change = self._set_state(rank, "steady")
            last_step = self._last_step.get(rank)
            last_ts = self._last_report_ts.get(rank)
            self._last_step[rank] = int(step)
            self._last_report_ts[rank] = now
            if mfu >= 0.0:
                self._mfu[rank] = mfu
            delta = (int(step) - last_step) if last_step is not None \
                else 0
            # accrual needs BOTH a prior step and a prior timestamp:
            # after a master restore last_ts restarts empty, so the
            # first report only re-anchors the cadence — its delta
            # spans the outage and must not become productive time
            if delta > 0 and step_time_s > 0.0 and last_ts is not None \
                    and now > last_ts:
                # never attribute more than the wall since the
                # previous report
                stepped = min(step_time_s * delta, now - last_ts)
                wait = min(1.0, max(0.0, data_wait_fraction))
                metered.append((PRODUCTIVE, self._accrue_locked(
                    rank, PRODUCTIVE, stepped * (1.0 - wait), now)))
                metered.append(("data_wait", self._accrue_locked(
                    rank, "data_wait", stepped * wait, now)))
        self._publish_state(change)
        for bucket, accrued in metered:
            if accrued > 0.0:
                self._seconds_total.labels(bucket=bucket).inc(accrued)

    def _rank_total_locked(self, rank: int) -> float:
        """(lock held)"""
        return sum(self._buckets.get(rank, {}).values())

    def mark_draining(self, rank: int, deadline: float = 0.0) -> None:
        now = self._now()
        with self._lock:
            self._touch_locked(rank, now)
            self._draining_since.setdefault(
                rank, (now, self._rank_total_locked(rank)))
            change = self._set_state(rank, "draining")
            self._pending_reason = "drain"
        self._publish_state(change)

    def complete_drain(self, rank: int) -> None:
        """The rank departed after its notice: the notice → departure
        interval is drain badput — net of whatever the interval already
        attributed elsewhere (the emergency-checkpoint span, final
        steps), so the same rank-second is never booked twice — and the
        rank's lifetime ends now."""
        now = self._now()
        with self._lock:
            marked = self._draining_since.pop(rank, None)
            accrued = 0.0
            if marked is not None:
                since, baseline = marked
                attributed_inside = max(
                    0.0, self._rank_total_locked(rank) - baseline)
                accrued = self._accrue_locked(
                    rank, "drain",
                    max(0.0, (now - since) - attributed_inside), now)
            change = self._set_state(rank, "")
            self._gone[rank] = now
            self._pending_reason = "drain"
        self._publish_state(change)
        if accrued > 0.0:
            self._seconds_total.labels(bucket="drain").inc(accrued)

    def observe_hang(self, rank: int,
                     hang_bound_s: float = 0.0) -> None:
        """A hang-classified worker exit: the time since the rank's last
        observed activity (bounded by the watchdog window when known)
        was a hang, not idle."""
        now = self._now()
        with self._lock:
            last = self._last_activity.get(rank, now)
            hang_s = max(0.0, now - last)
            if hang_bound_s > 0.0:
                hang_s = min(hang_s, hang_bound_s)
            self._touch_locked(rank, now)
            accrued = self._accrue_locked(rank, "hang", hang_s, now)
            self._pending_reason = "hang_restart"
        if accrued > 0.0:
            self._seconds_total.labels(bucket="hang").inc(accrued)

    def note_elasticity_event(self, kind: str) -> None:
        """Name the trigger the NEXT world re-formation is attributed to
        (drain / worker_lost / hang_restart / autoscale / scale).

        ``replan`` is the MECHANISM every world change rides through,
        not a root cause: it only fills an empty slot, so an autoscale
        claim (or a drain notice) that triggered the re-plan keeps the
        attribution instead of being clobbered by its own side effect."""
        with self._lock:
            if kind == "replan" and self._pending_reason:
                return
            self._pending_reason = kind

    def observe_world(self, round_: int, world_size: int) -> None:
        """A cut world observed (comm-world path): a new round opens a
        new incarnation attributed to the pending trigger."""
        now = self._now()
        with self._lock:
            if round_ <= self._round:
                return
            first = self._round < 0 and len(self._incarnations) == 1 \
                and self._incarnations[-1]["round"] == -1
            self._round = round_
            reason = self._pending_reason or "scale"
            self._pending_reason = ""
            if first:
                # the job's first world is not an elasticity event:
                # adopt the bootstrap segment instead of closing it
                self._incarnations[-1]["round"] = round_
                self._incarnations[-1]["world"] = world_size
                return
            self._open_incarnation(round_, world_size, reason, now)
        self._events_total.labels(kind=reason).inc()
        try:
            from dlrover_tpu_torch.obs.flight_recorder import (
                get_flight_recorder,
            )

            get_flight_recorder().record_event(
                "elasticity_event", round=round_, world=world_size,
                reason=reason)
        except Exception:  # noqa: BLE001 — telemetry must never raise
            pass

    def evict(self, live) -> None:
        """Membership hook: ranks no longer alive stop accruing lifetime
        (their cumulative buckets persist — badput history outlives the
        rank)."""
        live_set = set(live)
        now = self._now()
        changes = []
        with self._lock:
            for rank in list(self._first_seen):
                if rank in live_set or rank in self._gone:
                    continue
                self._gone[rank] = now
                self._draining_since.pop(rank, None)
                changes.append(self._set_state(rank, ""))
        for change in changes:
            self._publish_state(change)

    # -- queries -----------------------------------------------------------
    def _rank_elapsed_locked(self, rank: int, now: float) -> float:
        end = self._gone.get(rank, now)
        return max(0.0, end - self._first_seen.get(rank, now))

    def goodput_fraction(self) -> float:
        with self._lock:
            now = self._now()
            elapsed = sum(self._rank_elapsed_locked(r, now)
                          for r in self._first_seen)
            productive = sum(t.get(PRODUCTIVE, 0.0)
                             for t in self._buckets.values())
        return productive / elapsed if elapsed > 0 else 0.0

    def snapshot(self, window_s: float = 0.0) -> Dict[str, Any]:
        """The full ledger as one JSON-safe dict: job-wide buckets
        (idle derived as the residual), per-rank rows, incarnation
        segments, and optionally a windowed summary."""
        with self._lock:
            now = self._now()
            per_rank: Dict[str, Any] = {}
            job: Dict[str, float] = {b: 0.0 for b in BUCKETS}
            total_elapsed = 0.0
            for rank in sorted(self._first_seen):
                elapsed = self._rank_elapsed_locked(rank, now)
                table = dict(self._buckets.get(rank, {}))
                known = sum(table.values())
                table["idle"] = max(0.0, elapsed - known)
                per_rank[str(rank)] = {
                    "elapsed_s": round(elapsed, 3),
                    "state": self._state.get(rank, ""),
                    "gone": rank in self._gone,
                    "mfu": round(self._mfu.get(rank, -1.0), 4),
                    "slice": self._slice_map.get(rank, -1),
                    "degraded_steps": self._degraded_steps.get(rank, 0),
                    "buckets": {b: round(s, 3)
                                for b, s in table.items() if s > 0.0},
                }
                total_elapsed += elapsed
                for bucket, seconds in table.items():
                    job[bucket] = job.get(bucket, 0.0) + seconds
            # accruals with no rank (job-scope spans) count job-wide
            for bucket, seconds in self._buckets.get(_JOB_RANK,
                                                     {}).items():
                job[bucket] = job.get(bucket, 0.0) + seconds
                total_elapsed += seconds
            incarnations = [dict(inc,
                                 badput_buckets=dict(
                                     inc.get("badput_buckets", {})))
                            for inc in self._incarnations]
            snap: Dict[str, Any] = {
                "version": 1,
                "job_start_ts": self._job_start,
                "now": now,
                "elapsed_rank_seconds": round(total_elapsed, 3),
                "buckets": {b: round(s, 3) for b, s in job.items()},
                "goodput_fraction": round(
                    job[PRODUCTIVE] / total_elapsed, 4)
                if total_elapsed > 0 else 0.0,
                "per_rank": per_rank,
                "incarnations": incarnations,
                "degraded_steps_total": sum(
                    self._degraded_steps.values()),
                "replans": self._replan_summary_locked(),
            }
        if window_s > 0.0:
            snap["window"] = self.window_summary(window_s)
        return snap

    def _replan_summary_locked(self) -> List[Dict[str, Any]]:
        """(lock held) One row per resize: the replan sub-phase spans
        grouped by (rank, plan generation) — the per-event "what did
        this re-plan cost vs a checkpoint round-trip" evidence
        (tools/goodput.py, tools/diagnose.py)."""
        grouped: Dict[Tuple[int, Any], Dict[str, Any]] = {}
        for record in self._replans:
            key = (record["rank"], record["generation"])
            row = grouped.setdefault(key, {
                "rank": record["rank"],
                "generation": record["generation"],
                "ts": record["ts"], "phases": {}, })
            phases = row["phases"]
            phases[record["phase"]] = round(
                phases.get(record["phase"], 0.0) + record["seconds"], 3)
            row["ts"] = max(row["ts"], record["ts"])
            for k, v in record["detail"].items():
                row.setdefault(k, v)
        return sorted(grouped.values(), key=lambda r: r["ts"])

    def window_summary(self, window_s: float) -> Dict[str, Any]:
        """Buckets accrued over the trailing window, with the window's
        elapsed rank-seconds as denominator and the dominant badput
        bucket named (the alert rule's evidence)."""
        with self._lock:
            now = self._now()
            start = now - window_s
            # a full accrual ring may no longer reach back the whole
            # window: shrink the effective window to what the ring
            # actually covers, or the evicted accruals would read as
            # idle and a busy large job would raise a FALSE goodput
            # alert (the denominator must match the accrual evidence)
            truncated = False
            if len(self._window) == self._window.maxlen:
                oldest_ts = self._window[0][0]
                if oldest_ts > start:
                    start = oldest_ts
                    truncated = True
            buckets: Dict[str, float] = {}
            for ts, _, bucket, seconds in self._window:
                if ts >= start:
                    # an accrual records the END of its interval: clip
                    # the part that happened before the window opened
                    # (a long restore ending just inside the window
                    # must not dominate it wholesale)
                    buckets[bucket] = buckets.get(bucket, 0.0) \
                        + min(seconds, ts - start)
            elapsed = 0.0
            for rank in self._first_seen:
                end = self._gone.get(rank, now)
                begin = max(self._first_seen[rank], start)
                elapsed += max(0.0, end - begin)
        known = sum(buckets.values())
        buckets["idle"] = max(0.0, elapsed - known)
        productive = buckets.get(PRODUCTIVE, 0.0)
        dominant = ""
        worst = 0.0
        for bucket, seconds in buckets.items():
            if bucket != PRODUCTIVE and seconds > worst:
                dominant, worst = bucket, seconds
        summary = {
            "window_s": window_s,
            "elapsed_rank_seconds": round(elapsed, 3),
            "buckets": {b: round(s, 3) for b, s in buckets.items()
                        if s > 0.0},
            "goodput_fraction": round(productive / elapsed, 4)
            if elapsed > 0 else -1.0,
            "dominant_badput": dominant,
            "dominant_badput_s": round(worst, 3),
        }
        if truncated:
            summary["effective_window_s"] = round(now - start, 3)
            summary["truncated"] = True
        return summary

    def record_flight_snapshot(self, reason: str = "") -> None:
        """Drop the current snapshot into the flight recorder so a
        postmortem dump carries the ledger (``tools/goodput.py
        --flight``)."""
        try:
            from dlrover_tpu_torch.obs.flight_recorder import (
                get_flight_recorder,
            )

            get_flight_recorder().record_event(
                "goodput", reason=reason, snapshot=self.snapshot())
        except Exception:  # noqa: BLE001 — telemetry must never raise
            pass

    # -- crash-consistent state (master/state_backend.py) ------------------
    def export_state(self) -> dict:
        # deliberately timestamp-free: the master's save_if_changed
        # dedups snapshots by content, so a steady-state export must be
        # byte-identical to the previous one
        with self._lock:
            return {
                "job_start_ts": self._job_start,
                "round": self._round,
                "buckets": {str(r): dict(t)
                            for r, t in self._buckets.items()},
                "first_seen": {str(r): t
                               for r, t in self._first_seen.items()},
                "gone": {str(r): t for r, t in self._gone.items()},
                "last_step": {str(r): s
                              for r, s in self._last_step.items()},
                "incarnations": [dict(inc, badput_buckets=dict(
                    inc.get("badput_buckets", {})))
                    for inc in self._incarnations],
                "slices": {str(r): s
                           for r, s in self._slice_map.items()},
                "degraded_steps": {
                    str(r): n
                    for r, n in self._degraded_steps.items()},
            }

    def restore_state(self, state: dict) -> None:
        """Rehydrate cumulative accounting after a master restart. The
        outage gap accrues as idle (elapsed keeps running from
        first_seen); report cadence restarts fresh so the first
        post-restart report never double-attributes the gap. The
        Prometheus counters deliberately do NOT replay the restored
        totals: they are process-lifetime series (a restart reset is
        standard counter semantics, and an in-process master restart
        shares the registry — replaying would double-count); the
        snapshot/RPC view carries the job-cumulative numbers."""
        with self._lock:
            self._job_start = float(state.get("job_start_ts",
                                              self._job_start))
            self._round = int(state.get("round", -1))
            self._buckets.clear()
            for rank, table in (state.get("buckets") or {}).items():
                if not isinstance(table, dict):
                    continue
                clean = {b: float(s) for b, s in table.items()
                         if b in BUCKETS and b != "idle"}
                self._buckets[int(rank)] = clean
            self._first_seen = {int(r): float(t) for r, t in
                                (state.get("first_seen") or {}).items()}
            self._gone = {int(r): float(t) for r, t in
                          (state.get("gone") or {}).items()}
            self._last_step = {int(r): int(s) for r, s in
                               (state.get("last_step") or {}).items()}
            self._slice_map = {int(r): int(s) for r, s in
                               (state.get("slices") or {}).items()}
            self._degraded_steps = {
                int(r): int(n) for r, n in
                (state.get("degraded_steps") or {}).items()}
            # report timestamps deliberately restart: the next report's
            # delta spans the outage and must clamp to zero wall
            self._last_report_ts.clear()
            self._draining_since.clear()
            self._state.clear()
            self._incarnations.clear()
            for inc in state.get("incarnations") or []:
                if isinstance(inc, dict):
                    self._incarnations.append(dict(inc))
            if not self._incarnations:
                self._open_incarnation(self._round, 0, "job_start",
                                       self._job_start)
            self._pending_reason = "master_failover"


# --------------------------------------------------------------------------
# rendering (tools/goodput.py, tools/diagnose.py, tools/obs_dump.py)
# --------------------------------------------------------------------------


def _fmt_buckets(buckets: Dict[str, float], elapsed: float) -> List[str]:
    lines = []
    for bucket in BUCKETS:
        seconds = buckets.get(bucket, 0.0)
        if seconds <= 0.0:
            continue
        pct = 100.0 * seconds / elapsed if elapsed > 0 else 0.0
        lines.append(f"  {bucket:<16} {seconds:>10.1f}s  {pct:5.1f}%")
    return lines


def render_snapshot(snap: Dict[str, Any]) -> str:
    """Human-readable ledger report from a `GoodputLedger.snapshot()`
    dict (live RPC or flight dump)."""
    elapsed = float(snap.get("elapsed_rank_seconds", 0.0))
    buckets = snap.get("buckets", {})
    lines = [
        "goodput ledger: {:.1f} rank-seconds accounted, goodput "
        "{:.1%}".format(elapsed,
                        float(snap.get("goodput_fraction", 0.0))),
    ]
    lines += _fmt_buckets(buckets, elapsed)
    window = snap.get("window")
    if window:
        lines.append(
            "window ({:.0f}s): goodput {:.1%}, dominant badput: "
            "{} ({:.1f}s)".format(
                float(window.get("window_s", 0.0)),
                max(0.0, float(window.get("goodput_fraction", 0.0))),
                window.get("dominant_badput") or "-",
                float(window.get("dominant_badput_s", 0.0))))
    per_rank = snap.get("per_rank", {})
    # per-slice rollup (multi-slice hierarchical DP): grouped by
    # failure domain, with the degraded-step tally front and center
    slice_rows: Dict[Any, List[Dict[str, Any]]] = {}
    for row in per_rank.values():
        sid = row.get("slice", -1)
        if sid is not None and int(sid) >= 0:
            slice_rows.setdefault(int(sid), []).append(row)
    degraded_total = int(snap.get("degraded_steps_total", 0) or 0)
    if slice_rows:
        lines.append("per slice:")
        for sid in sorted(slice_rows):
            rows = slice_rows[sid]
            elapsed_s = sum(float(r.get("elapsed_s", 0.0))
                            for r in rows)
            productive = sum(
                float(r.get("buckets", {}).get(PRODUCTIVE, 0.0))
                for r in rows)
            degraded = sum(int(r.get("degraded_steps", 0))
                           for r in rows)
            fraction = productive / elapsed_s if elapsed_s > 0 else 0.0
            gone = all(r.get("gone") for r in rows)
            lines.append(
                f"  slice {sid:>3}  {len(rows)} rank(s)  "
                f"{elapsed_s:8.1f}s elapsed  goodput {fraction:6.1%}  "
                f"degraded_steps={degraded}"
                + ("  [gone]" if gone else ""))
    elif degraded_total:
        lines.append(f"degraded steps (renormalized gradient mean): "
                     f"{degraded_total}")
    if per_rank:
        lines.append("per rank:")
        for rank in sorted(per_rank, key=lambda r: int(r)):
            row = per_rank[rank]
            row_buckets = row.get("buckets", {})
            row_elapsed = float(row.get("elapsed_s", 0.0))
            productive = float(row_buckets.get(PRODUCTIVE, 0.0))
            fraction = productive / row_elapsed if row_elapsed > 0 \
                else 0.0
            top = sorted(((b, s) for b, s in row_buckets.items()
                          if b != PRODUCTIVE),
                         key=lambda kv: -kv[1])[:3]
            detail = " ".join(f"{b}={s:.1f}s" for b, s in top)
            mfu = float(row.get("mfu", -1.0))
            mfu_txt = f" mfu={mfu:.3f}" if mfu >= 0.0 else ""
            state = row.get("state") or ("gone" if row.get("gone")
                                         else "-")
            lines.append(
                f"  rank {rank:>4}  {row_elapsed:8.1f}s elapsed  "
                f"goodput {fraction:6.1%}  [{state}]{mfu_txt}  "
                f"{detail}".rstrip())
    replans = snap.get("replans", [])
    if replans:
        # per-resize pricing: the plan → migrate → rebuild legs of each
        # online re-plan (vs the checkpoint round-trip it replaced)
        lines.append("re-plans (plan / migrate / rebuild), per resize:")
        for row in replans:
            phases = row.get("phases", {})
            legs = " ".join(
                f"{phase}={phases[phase]:.2f}s"
                for phase in ("plan", "migrate", "rebuild")
                if phase in phases)
            detail = []
            if row.get("source"):
                detail.append(f"source={row['source']}")
            if row.get("bytes"):
                detail.append(
                    f"{float(row['bytes']) / (1 << 20):.1f}MiB moved")
            if row.get("resharded"):
                detail.append("resharded")
            total = sum(phases.values())
            lines.append(
                "  rank {rank} gen {gen}: {total:.2f}s total  {legs}"
                "{detail}".format(
                    rank=row.get("rank", "?"),
                    gen=row.get("generation", "?"),
                    total=total, legs=legs,
                    detail=("  [" + " ".join(detail) + "]")
                    if detail else "").rstrip())
    incarnations = snap.get("incarnations", [])
    if incarnations:
        lines.append("time lost to elasticity events, per incarnation:")
        for index, inc in enumerate(incarnations):
            per = inc.get("badput_buckets", {})
            top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
            detail = " ".join(f"{b}={s:.1f}s" for b, s in top) or "-"
            lines.append(
                "  #{idx} round={round} world={world} "
                "trigger={reason}: badput {badput:.1f}s "
                "(productive {productive:.1f}s)  {detail}".format(
                    idx=index, round=inc.get("round", "?"),
                    world=inc.get("world", "?"),
                    reason=inc.get("reason", "?"),
                    badput=float(inc.get("badput", 0.0)),
                    productive=float(inc.get(PRODUCTIVE, 0.0)),
                    detail=detail).rstrip())
    return "\n".join(lines)


def snapshot_from_flight(payload: Dict[str, Any]
                         ) -> Optional[Dict[str, Any]]:
    """The newest `goodput` snapshot event of a flight dump, or a
    spans-only rebuild when the dump predates snapshot recording (the
    rebuild has no step reports, so productive time is absent and the
    residual reads as idle)."""
    newest = None
    for record in payload.get("events", []):
        if record.get("kind") == "event" and \
                record.get("name") == "goodput":
            snap = record.get("attrs", {}).get("snapshot")
            if isinstance(snap, dict):
                newest = snap
    if newest is not None:
        return newest
    # fallback: replay span records through a throwaway ledger
    spans = [r for r in payload.get("events", [])
             if r.get("kind") == "span"]
    if not spans:
        return None
    from dlrover_tpu_torch.obs.metrics import MetricsRegistry

    ledger = GoodputLedger(registry=MetricsRegistry())
    for record in spans:
        ledger.observe_span(record)
    snap = ledger.snapshot()
    snap["rebuilt_from_spans"] = True
    return snap
