"""DiagnosisManager: run the inference chain, keep the reports, dispatch
actions.

Own copy of the JAX package's ``master/diagnosis/manager.py`` (held
equal to it by ``tests/test_torch_diagnosis.py``), with an injectable
clock. On a fixed cadence (``Context.diagnosis_interval_s``) it
snapshots the SpeedMonitor's per-worker step reports, the latest
NodeResourceStats and step-report HBM watermarks, the goodput window
and the steptrace summary, runs the rule chain (``rules.py``), and for
every conclusion

- appends a :class:`DiagnosisReport` to a bounded ring
  (``export_state``/``restore_state`` carry the newest across a master
  restart: the master's snapshot holds them, and ``state_sink`` writes
  one after every round that concluded something),
- records a ``diagnosis`` flight event and bumps
  ``dlrover_tpu_diagnosis_reports_total{rule,severity}``,
- enqueues the report's actions on per-rank queues that agents drain
  through the polled ``DiagnosisActionRequest`` (kill-switch:
  ``Context.diagnosis_actions_enabled``; a per-rank cooldown, so a
  persistently slow rank is profiled once, not every interval).

The snapshot carries the planner calibration's current entry
(``parallel/calibration.py``), the ``PlanRegressionRule``'s evidence;
after each round the learned per-axis discounts go to ``discount_sink``
(wired by ``JobMaster`` to the servicer's ``push_axis_discounts``).
``request_checkpoint`` fans an urgent save-and-continue out to the
survivors of a drain, bypassing the cooldown; ``request_drain`` orders
save-and-exit actions: the same-slice peers of a rank with a preemption
notice (the slice departs as a unit) and the fleet controller's shed.

Threading: fed from servicer threads and read by scrapes while the
diagnose loop runs; every shared structure is guarded by ``self._lock``.
Rule evaluation is serialized under ``self._diag_lock``, which may take
``self._lock`` inside it, never the reverse.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.diagnosis.rules import (
    DiagnosisReport,
    DiagnosisSnapshot,
    Rule,
    default_rules,
    parse_action,
    straggler_scores,
)

_REPORT_RING = 256        # reports retained in memory
_PERSISTED_REPORTS = 64   # newest reports carried in state snapshots
_ACTION_QUEUE_CAP = 8     # per-rank pending actions (drop-oldest)
# resource stats older than this are not evidence (the node stopped
# reporting — its last sample describes a process that may be gone)
_STATS_FRESH_S = 120.0


class DiagnosisManager:
    def __init__(self, speed_monitor, rules: Optional[List[Rule]] = None,
                 goodput_ledger=None, plan_calibration=None,
                 steptrace=None,
                 clock: Callable[[], float] = time.time):
        self._speed_monitor = speed_monitor
        # the wall clock of every report, action and freshness check
        self._clock = clock
        self._rules = rules if rules is not None else default_rules()
        # optional goodput ledger (obs/goodput.py): its trailing-window
        # summary rides on every snapshot as the GoodputRule's evidence
        self._goodput_ledger = goodput_ledger
        # optional planner calibration (parallel/calibration.py): the
        # running plan's predicted-vs-measured entry is the
        # PlanRegressionRule's evidence
        self._plan_calibration = plan_calibration
        # optional steptrace assembler (master/steptrace.py): its
        # windowed critical-path summary is the CriticalPathRule's
        # evidence
        self._steptrace = steptrace
        self._lock = threading.Lock()
        self._diag_lock = threading.Lock()
        self._reports: deque = deque(maxlen=_REPORT_RING)
        self._node_stats: Dict[int, Dict[str, Any]] = {}
        self._pending: Dict[int, deque] = {}
        self._last_action_ts: Dict[int, float] = {}
        self._next_action_id = 1
        self._published_scores: set = set()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # crash-consistency hook (wired by JobMaster): called after a
        # round that appended reports
        self.state_sink: Optional[Callable[[], None]] = None
        # calibration feedback hook (JobMaster wires the servicer's
        # push_axis_discounts): the learned discounts are recomputed on
        # this loop's cadence, not per step report
        self.discount_sink: Optional[Callable[[Dict[str, float]],
                                              None]] = None
        registry = obs.get_registry()
        self._reports_total = registry.counter(
            "dlrover_tpu_diagnosis_reports_total",
            "Diagnosis reports emitted by the inference chain",
            labelnames=("rule", "severity"))
        self._actions_total = registry.counter(
            "dlrover_tpu_diagnosis_actions_total",
            "Diagnosis actions dispatched to agent queues",
            labelnames=("kind",))
        # per-worker gauges carry the rank's slice (multi-slice
        # hierarchical DP; "-1" on single-slice jobs) so dashboards can
        # group by failure domain and a departing SLICE evicts as a unit
        self._slice_map: Dict[int, int] = {}
        self._score_gauge = registry.gauge(
            "dlrover_tpu_worker_straggler_score",
            "Worker mean step time over the fleet median (1.0 = at the "
            "pack)", labelnames=("node", "slice"))
        self._wait_gauge = registry.gauge(
            "dlrover_tpu_worker_data_wait_fraction",
            "Windowed fraction of worker step time spent waiting on "
            "data", labelnames=("node", "slice"))
        self._mfu_gauge = registry.gauge(
            "dlrover_tpu_worker_mfu",
            "Windowed per-rank achieved model-FLOPs utilization (from "
            "step reports; absent without a FLOPs model)",
            labelnames=("node", "slice"))
        self._hbm_peak_gauge = registry.gauge(
            "dlrover_tpu_worker_hbm_peak_mb",
            "Per-rank device-truth HBM peak watermark over the last "
            "report window (in-step transient, obs/device.py; absent "
            "on backends with no memory stats)",
            labelnames=("node", "slice"))

    # -- slice membership (multi-slice hierarchical DP) --------------------
    def set_slice_map(self, slice_map: Dict[int, int]) -> None:
        """rank → slice from the rendezvous slice registry (servicer
        pushes on every slice-carrying join)."""
        with self._lock:
            self._slice_map = dict(slice_map)

    def _slice_label(self, rank: int) -> str:
        with self._lock:
            return str(self._slice_map.get(rank, -1))

    # -- evidence feeds (servicer threads) ---------------------------------
    def observe_resource_stats(self, stats: msg.NodeResourceStats) -> None:
        # keyed by RANK when the sender provides one: every other piece
        # of diagnosis evidence (step reports, action queues, eviction
        # sets) is rank-keyed, and node_id diverges from rank after a
        # relaunch — a node_id key here would dodge eviction and make
        # HBM reports name a different identity space than straggler
        # reports
        rank = stats.node_rank if stats.node_rank >= 0 else stats.node_id
        entry = {
            "ts": self._clock(),
            "cpu_percent": stats.cpu_percent,
            "memory_mb": stats.memory_mb,
            "chips": [{"index": c.index,
                       "duty_cycle_pct": c.duty_cycle_pct,
                       "hbm_used_mb": c.hbm_used_mb,
                       "hbm_total_mb": c.hbm_total_mb,
                       "hbm_peak_mb": getattr(c, "hbm_peak_mb", -1.0)}
                      for c in stats.chip_stats],
        }
        with self._lock:
            # a fresher step-report watermark must survive the slower
            # chip-stats relay overwriting the entry — but it carries
            # its OWN age: a wedged loop (no step reports) keeps the
            # chip relay alive, and its last watermark must expire
            # with the window it described, not ride the relay's ts
            previous = self._node_stats.get(rank)
            if previous and previous.get("hbm_peak_mb", -1.0) >= 0.0:
                peak_ts = float(previous.get("hbm_peak_ts", 0.0))
                if self._clock() - peak_ts <= _STATS_FRESH_S:
                    entry["hbm_peak_mb"] = previous["hbm_peak_mb"]
                    entry["hbm_peak_ts"] = peak_ts
            self._node_stats[rank] = entry

    def observe_step_watermark(self, rank: int, peak_mb: float) -> None:
        """Device-truth HBM peak watermark from a step report
        (GlobalStepReport.hbm_peak_bytes → servicer): report-interval
        cadence, the in-step transient — HbmPressureRule's preferred
        signal over the between-steps chip-stats sample."""
        if peak_mb < 0.0:
            return
        with self._lock:
            entry = self._node_stats.get(rank)
            if entry is None:
                entry = {"ts": self._clock(), "chips": []}
                self._node_stats[rank] = entry
            entry["hbm_peak_mb"] = float(peak_mb)
            entry["hbm_peak_ts"] = self._clock()
            entry["ts"] = self._clock()

    def observe_worker_exit(self, rank: int, exit_kind: str,
                            detail: str = "") -> None:
        """A worker departed: record HOW (the diagnosis layer must tell
        hang from crash from drain — they demand different operator
        responses and different relaunch arithmetic)."""
        from dlrover_tpu_torch.common.constants import NodeExitReason

        severity = {
            NodeExitReason.DRAINED: "info",
            NodeExitReason.SUCCEEDED: "info",
            NodeExitReason.HANG: "warning",
        }.get(exit_kind, "warning")
        report = DiagnosisReport(
            rule="worker_exit", severity=severity, worker_id=rank,
            summary=(f"worker {rank} exited: {exit_kind}"
                     + (f" ({detail})" if detail else "")),
            details={"exit_kind": exit_kind},
            ts=self._clock(),
        )
        with self._diag_lock:
            self._emit(report, Context.singleton())

    def observe_drain_notice(self, rank: int, deadline: float,
                             reason: str = "",
                             slice_id: int = -1) -> None:
        """A preemption notice arrived for ``rank``: record the planned
        departure so postmortems show the drain was ADVANCE-notified
        (and, in slice mode, which slice drains as a unit)."""
        scope = (f"slice {slice_id} drains as a unit"
                 if slice_id >= 0 else "")
        report = DiagnosisReport(
            rule="preemption", severity="info", worker_id=rank,
            summary=(f"worker {rank} draining: departs in "
                     f"{max(0.0, deadline - self._clock()):.0f}s"
                     + (f" ({reason})" if reason else "")
                     + (f" [{scope}]" if scope else "")),
            details={"deadline": deadline, "reason": reason,
                     "slice": slice_id},
            ts=self._clock(),
        )
        with self._diag_lock:
            self._emit(report, Context.singleton())

    def observe_autoscale(self, kind: str, reason: str,
                          evidence: Optional[Dict[str, Any]] = None,
                          severity: str = "info") -> None:
        """A fleet-controller decision (brain/fleet_controller.py): claim,
        shed, hold or rollback lands in the report history, so a
        postmortem reads why the fleet changed shape beside the evidence
        that drove it."""
        report = DiagnosisReport(
            rule="autoscale", severity=severity, worker_id=-1,
            summary=f"autoscale {kind}: {reason}",
            details=dict(evidence or {}, kind=kind),
            ts=self._clock(),
        )
        with self._diag_lock:
            self._emit(report, Context.singleton())

    def request_checkpoint(self, ranks, deadline: float,
                           reason: str = "") -> List[int]:
        """Urgent ``checkpoint`` fan-out (a peer is draining): enqueue a
        save-now action for every given rank, BYPASSING the per-rank
        cooldown — preemption does not wait for cooldowns. Returns the
        ranks actually queued. The ``diagnosis_actions_enabled``
        kill-switch still applies: diagnose-only means NO agent-side
        effects, urgent or not."""
        return self._request_urgent("checkpoint", ranks, deadline,
                                    reason)

    def request_drain(self, ranks, deadline: float,
                      reason: str = "") -> List[int]:
        """Slice-unit drain fan-out: save-and-EXIT actions for the
        same-slice peers of a rank that received a preemption notice
        (the whole slice departs together; its world dies with it
        either way), and the fleet controller's shed of its notice rank
        (which has no notice file). Same urgency contract as
        request_checkpoint."""
        return self._request_urgent("drain", ranks, deadline, reason)

    def _request_urgent(self, kind: str, ranks, deadline: float,
                        reason: str = "") -> List[int]:
        if not Context.singleton().diagnosis_actions_enabled:
            logger.warning(
                "diagnosis actions disabled: urgent %s fan-out "
                "for draining peer suppressed (ranks %s)", kind,
                list(ranks))
            return []
        queued: List[int] = []
        now = self._clock()
        with self._lock:
            for rank in ranks:
                queue = self._pending.get(rank)
                if queue is None:
                    queue = deque(maxlen=_ACTION_QUEUE_CAP)
                    self._pending[rank] = queue
                action_id = self._next_action_id
                self._next_action_id += 1
                queue.append({
                    "id": action_id,
                    "kind": kind,
                    "rank": rank,
                    "rule": "preemption",
                    "reason": reason,
                    "deadline": deadline,
                    "ts": now,
                })
                queued.append(rank)
        for rank in queued:
            self._actions_total.labels(kind=kind).inc()
            obs.get_flight_recorder().record_event(
                "diagnosis_action", kind=kind, rank=rank,
                rule="preemption")
        return queued

    def evict_workers(self, live) -> None:
        """Membership-change hook: a departed rank's queued actions and
        cached stats must not outlive it (an agent re-joining under the
        same rank would execute a dead world's restart)."""
        live_set = set(live)
        with self._lock:
            for table in (self._node_stats, self._pending,
                          self._last_action_ts):
                for rank in list(table):
                    if rank not in live_set:
                        table.pop(rank, None)

    # -- the chain ---------------------------------------------------------
    def snapshot(self) -> DiagnosisSnapshot:
        now = self._clock()
        with self._lock:
            stats = {rank: entry
                     for rank, entry in self._node_stats.items()
                     if now - entry["ts"] <= _STATS_FRESH_S}
        goodput = None
        if self._goodput_ledger is not None:
            try:
                goodput = self._goodput_ledger.window_summary(
                    Context.singleton().goodput_window_s)
            except Exception:  # noqa: BLE001 — evidence, not the chain
                logger.exception("goodput window summary failed")
        calibration = None
        if self._plan_calibration is not None:
            try:
                calibration = self._plan_calibration.current()
            except Exception:  # noqa: BLE001 — evidence, not the chain
                logger.exception("plan calibration read failed")
        steptrace = None
        if self._steptrace is not None:
            try:
                steptrace = self._steptrace.summary()
            except Exception:  # noqa: BLE001 — evidence, not the chain
                logger.exception("steptrace summary read failed")
        return DiagnosisSnapshot(
            ts=now,
            worker_speeds=self._speed_monitor.worker_speeds(),
            running_speed=self._speed_monitor.running_speed(),
            peak_speed=self._speed_monitor.peak_speed(),
            running_workers=self._speed_monitor.num_running_workers,
            node_stats=stats,
            running_mfu=self._speed_monitor.running_mfu(),
            peak_mfu=self._speed_monitor.peak_mfu(),
            goodput=goodput,
            plan_calibration=calibration,
            steptrace=steptrace,
        )

    def diagnose_once(self) -> List[DiagnosisReport]:
        """One evaluation of the whole chain; safe to call from tests or
        an operator path while the loop runs (serialized)."""
        ctx = Context.singleton()
        with self._diag_lock:
            snap = self.snapshot()
            self._publish_worker_gauges(snap, ctx)
            reports: List[DiagnosisReport] = []
            for rule in self._rules:
                try:
                    reports.extend(rule.evaluate(snap, ctx))
                except Exception:  # noqa: BLE001 — one rule, not the chain
                    logger.exception("diagnosis rule %s failed", rule.name)
            for report in reports:
                report.ts = report.ts or snap.ts
                self._emit(report, ctx)
        if reports and self.state_sink is not None:
            try:
                self.state_sink()
            except Exception:  # noqa: BLE001 — durability is best-effort
                logger.exception("diagnosis state snapshot failed")
        if self._plan_calibration is not None \
                and self.discount_sink is not None:
            try:
                self.discount_sink(
                    self._plan_calibration.axis_discounts())
            except Exception:  # noqa: BLE001 — advisory feedback
                logger.exception("axis discount push failed")
        return reports

    def _publish_worker_gauges(self, snap: DiagnosisSnapshot,
                               ctx: Context) -> None:
        scores = straggler_scores(snap.worker_speeds,
                                  ctx.diagnosis_min_worker_samples)
        # published keys are (node, slice) label pairs: whole-slice
        # eviction on slice departure falls out of the set difference —
        # every member's pair goes stale together
        published = set()

        def _key(rank: int):
            return str(rank), self._slice_label(rank)

        for rank, score in scores.items():
            node, slice_ = _key(rank)
            self._score_gauge.labels(node=node, slice=slice_).set(score)
            published.add((node, slice_))
        for rank, speed in snap.worker_speeds.items():
            node, slice_ = _key(rank)
            if speed.data_wait_fraction >= 0.0:
                self._wait_gauge.labels(node=node, slice=slice_).set(
                    speed.data_wait_fraction)
                published.add((node, slice_))
            if speed.mfu >= 0.0:
                self._mfu_gauge.labels(node=node, slice=slice_).set(
                    speed.mfu)
                published.add((node, slice_))
        for rank, stats in snap.node_stats.items():
            peak = float(stats.get("hbm_peak_mb", -1.0) or -1.0)
            if peak >= 0.0:
                node, slice_ = _key(rank)
                self._hbm_peak_gauge.labels(node=node,
                                            slice=slice_).set(peak)
                published.add((node, slice_))
        with self._lock:
            stale = self._published_scores - published
            self._published_scores = published
        for node, slice_ in stale:
            # dead ranks must not keep ranking in scrapes
            self._score_gauge.remove(node=node, slice=slice_)
            self._wait_gauge.remove(node=node, slice=slice_)
            self._mfu_gauge.remove(node=node, slice=slice_)
            self._hbm_peak_gauge.remove(node=node, slice=slice_)

    def _emit(self, report: DiagnosisReport, ctx: Context) -> None:
        record = report.to_dict()
        with self._lock:
            self._reports.append(record)
        self._reports_total.labels(rule=report.rule,
                                   severity=report.severity).inc()
        obs.get_flight_recorder().record_event(
            "diagnosis", rule=report.rule, severity=report.severity,
            worker=report.worker_id, summary=report.summary,
            actions=list(report.actions))
        logger.log(
            30 if report.severity != "info" else 20,
            "diagnosis [%s/%s]: %s", report.rule, report.severity,
            report.summary)
        if not ctx.diagnosis_actions_enabled:
            return
        for action in report.actions:
            self._enqueue_action(action, report, ctx)

    def _enqueue_action(self, action: str, report: DiagnosisReport,
                        ctx: Context) -> None:
        parsed = parse_action(action)
        kind, rank = parsed["kind"], parsed["rank"]
        if kind in ("observe", "alert") or rank < 0:
            # advisory kinds surface through the report itself; only
            # targeted kinds travel to an agent
            return
        now = self._clock()
        with self._lock:
            last = self._last_action_ts.get(rank, 0.0)
            if now - last < ctx.diagnosis_action_cooldown_s:
                return
            self._last_action_ts[rank] = now
            queue = self._pending.get(rank)
            if queue is None:
                queue = deque(maxlen=_ACTION_QUEUE_CAP)
                self._pending[rank] = queue
            action_id = self._next_action_id
            self._next_action_id += 1
            entry = {
                "id": action_id,
                "kind": kind,
                "rank": rank,
                "rule": report.rule,
                "reason": report.summary,
                "ts": now,
            }
            if kind == "profile":
                entry["num_steps"] = ctx.diagnosis_profile_steps
            queue.append(entry)
        self._actions_total.labels(kind=kind).inc()
        obs.get_flight_recorder().record_event(
            "diagnosis_action", kind=kind, rank=rank, id=entry["id"],
            rule=report.rule)

    # -- agent / tools endpoints (servicer threads) ------------------------
    def poll_actions(self, node_rank: int) -> List[Dict[str, Any]]:
        """Pop (single-delivery) every action queued for this rank."""
        with self._lock:
            queue = self._pending.get(node_rank)
            if not queue:
                return []
            actions = list(queue)
            queue.clear()
            return actions

    def reports(self, limit: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            records = list(self._reports)
        if limit > 0:
            records = records[-limit:]
        return records

    def pending_action_counts(self) -> Dict[int, int]:
        with self._lock:
            return {rank: len(queue)
                    for rank, queue in self._pending.items() if queue}

    # -- loop --------------------------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> None:
        interval = (interval_s if interval_s is not None
                    else Context.singleton().diagnosis_interval_s)

        def _loop():
            while not self._stopped.wait(interval):
                try:
                    self.diagnose_once()
                except Exception:  # noqa: BLE001 — loop must survive
                    logger.exception("diagnosis round failed")

        with self._lock:
            if self._thread is not None:
                return
            self._stopped.clear()
            thread = threading.Thread(target=_loop, daemon=True,
                                      name="diagnosis-manager")
            self._thread = thread
        thread.start()

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            self._thread = None

    # -- crash-consistent state (master/state_backend.py) ------------------
    def export_state(self) -> dict:
        with self._lock:
            return {
                "reports": list(self._reports)[-_PERSISTED_REPORTS:],
                "next_action_id": self._next_action_id,
            }

    def restore_state(self, state: dict) -> None:
        """Rehydrate report history + the action-id sequence. Pending
        action queues and rule hysteresis deliberately restart empty:
        they describe a world the restarted master has not re-observed
        yet (agents re-register; evidence re-accumulates in one
        window)."""
        reports = state.get("reports", [])
        with self._lock:
            self._reports.clear()
            for record in reports:
                if isinstance(record, dict):
                    self._reports.append(record)
            self._next_action_id = max(
                1, int(state.get("next_action_id", 1)))
            self._pending.clear()
            self._last_action_ts.clear()

    # -- wire helpers ------------------------------------------------------
    @staticmethod
    def actions_to_json(actions: List[Dict[str, Any]]) -> str:
        return json.dumps(actions) if actions else ""

    @staticmethod
    def reports_to_json(reports: List[Dict[str, Any]]) -> str:
        return json.dumps(reports) if reports else ""
