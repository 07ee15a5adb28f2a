"""Diagnosis rules: the inference chain over job telemetry.

Own copy of the JAX package's ``master/diagnosis/rules.py`` (held equal
to it by ``tests/test_torch_diagnosis.py``), after
dlrover/python/master/diagnosis: each rule is a small stateful object
evaluated over one :class:`DiagnosisSnapshot`; a conclusion is a
:class:`DiagnosisReport` carrying zero or more actions in the grammar
``observe | profile:{rank} | restart:{rank} | checkpoint:{rank} |
drain:{rank} | alert``.

Rule state (hysteresis counters) is mutated only inside ``evaluate``;
the :class:`~dlrover_tpu_torch.master.diagnosis.manager.DiagnosisManager`
serializes evaluations under its own lock. ``PlanRegressionRule`` reads
the planner's calibration, which the port's master does not have yet
(ROADMAP Queue A item 6.3): with no evidence it concludes nothing.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import DefaultValues
from dlrover_tpu_torch.master.speed_monitor import WorkerSpeed

# severity levels, mildest first
INFO = "info"
WARNING = "warning"
CRITICAL = "critical"

# action grammar kinds (docs/observability.md)
ACTION_OBSERVE = "observe"
ACTION_PROFILE = "profile"
ACTION_RESTART = "restart"
# urgent save-now-keep-running: fanned out to survivors when a peer
# announces a preemption drain (the agent writes the worker's drain
# request file with exit=False)
ACTION_CHECKPOINT = "checkpoint"
# save-and-EXIT: fanned out to the SAME-SLICE peers of a draining rank
# (the slice drains as a unit — its process group dies with the slice; the
# agent writes the drain request with exit=True and departs cleanly)
ACTION_DRAIN = "drain"
ACTION_ALERT = "alert"


@dataclasses.dataclass
class DiagnosisSnapshot:
    """One immutable view of the evidence a diagnosis round runs over."""

    ts: float
    worker_speeds: Dict[int, WorkerSpeed]
    running_speed: float = 0.0
    peak_speed: float = 0.0
    running_workers: int = 0
    # worker_id -> {"cpu_percent", "memory_mb", "ts", "chips": [{...}]}
    node_stats: Dict[int, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    # job MFU evidence (SpeedMonitor + ModelInfo FLOPs model); -1 =
    # no FLOPs model reported — rules fall back to raw steps/s
    running_mfu: float = -1.0
    peak_mfu: float = -1.0
    # trailing-window goodput evidence (GoodputLedger.window_summary):
    # {"goodput_fraction", "dominant_badput", "elapsed_rank_seconds",
    #  "window_s", "buckets"}; None = no ledger attached
    goodput: Optional[Dict[str, Any]] = None
    # the running plan's predicted-vs-measured entry
    # (parallel/calibration.py PlanCalibration.current()):
    # {"mesh", "predicted_step_s", "measured_step_s", "ratio",
    #  "samples", ...}; None = no calibration attached / no plan yet
    plan_calibration: Optional[Dict[str, Any]] = None
    # windowed critical-path attribution (master/steptrace.py
    # StepTraceAssembler.summary): {"steps", "by_rank": {rank_str:
    # {"gating_steps", "gating_s", "phases"}}, "dominant_gating_rank",
    # "dominant_gating_phase", "cross_slice_wait_fraction"}; None = no
    # assembler attached / nothing traced yet
    steptrace: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class DiagnosisReport:
    """One conclusion of the chain (persisted, metered, rendered)."""

    rule: str
    severity: str
    summary: str
    ts: float = 0.0
    worker_id: int = -1
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)
    actions: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "DiagnosisReport":
        return cls(
            rule=str(raw.get("rule", "")),
            severity=str(raw.get("severity", INFO)),
            summary=str(raw.get("summary", "")),
            ts=float(raw.get("ts", 0.0)),
            worker_id=int(raw.get("worker_id", -1)),
            details=dict(raw.get("details", {})),
            actions=list(raw.get("actions", [])),
        )


def straggler_scores(worker_speeds: Dict[int, WorkerSpeed],
                     min_samples: int = 1) -> Dict[int, float]:
    """score = worker mean step time / median of its PEERS (1.0 = at the
    pack; 2.0 = twice as slow). Leave-one-out deliberately: a median
    that includes the candidate dilutes the signal — in a 2-worker job
    the inclusive score is 2·t1/(t0+t1) < 2 however slow t1 gets, so a
    ratio threshold ≥ 2 could NEVER fire. Workers below ``min_samples``
    are excluded — and so is scoring entirely with < 2 eligible workers
    (a solo worker cannot straggle relative to itself)."""
    eligible = {w: s.mean_step_time_s for w, s in worker_speeds.items()
                if s.samples >= min_samples and s.mean_step_time_s > 0}
    if len(eligible) < 2:
        return {}
    scores = {}
    for worker_id, mean_step in eligible.items():
        peers = [t for w, t in eligible.items() if w != worker_id]
        peer_median = statistics.median(peers)
        if peer_median > 0:
            scores[worker_id] = mean_step / peer_median
    return scores


class Rule:
    name = "rule"

    def evaluate(self, snapshot: DiagnosisSnapshot,
                 ctx: Optional[Context] = None) -> List[DiagnosisReport]:
        raise NotImplementedError


class StragglerRule(Rule):
    """Step-time vs moving median with hysteresis: a rank must score over
    ``straggler_median_ratio`` for ``straggler_trigger_windows``
    consecutive evaluations to be flagged (one slow window — a GC pause,
    a checkpoint — is noise), and under it for
    ``straggler_clear_windows`` to clear. Flagging emits a
    ``profile:{rank}`` action so the evidence (an actual device trace)
    collects itself."""

    name = "straggler"

    def __init__(self):
        self._over: Dict[int, int] = {}     # consecutive over-threshold
        self._under: Dict[int, int] = {}    # consecutive clean (flagged)
        self._flagged: set = set()

    def evaluate(self, snapshot, ctx=None):
        ctx = ctx or Context.singleton()
        scores = straggler_scores(snapshot.worker_speeds,
                                  ctx.diagnosis_min_worker_samples)
        reports: List[DiagnosisReport] = []
        for worker_id, score in scores.items():
            if score > ctx.straggler_median_ratio:
                self._under.pop(worker_id, None)
                count = self._over.get(worker_id, 0) + 1
                self._over[worker_id] = count
                if (worker_id not in self._flagged
                        and count >= ctx.straggler_trigger_windows):
                    self._flagged.add(worker_id)
                    speed = snapshot.worker_speeds[worker_id]
                    reports.append(DiagnosisReport(
                        rule=self.name, severity=WARNING,
                        worker_id=worker_id,
                        summary=(
                            f"worker {worker_id} is a straggler: "
                            f"{speed.mean_step_time_s:.3f}s/step is "
                            f"{score:.2f}x the peer median"),
                        details={"score": round(score, 3),
                                 "mean_step_time_s": round(
                                     speed.mean_step_time_s, 4),
                                 "samples": speed.samples,
                                 "windows_over": count},
                        actions=[f"{ACTION_PROFILE}:{worker_id}",
                                 ACTION_ALERT],
                    ))
            else:
                self._over.pop(worker_id, None)
                if worker_id in self._flagged:
                    count = self._under.get(worker_id, 0) + 1
                    self._under[worker_id] = count
                    if count >= ctx.straggler_clear_windows:
                        self._flagged.discard(worker_id)
                        self._under.pop(worker_id, None)
                        reports.append(DiagnosisReport(
                            rule=self.name, severity=INFO,
                            worker_id=worker_id,
                            summary=(f"worker {worker_id} recovered to "
                                     f"{score:.2f}x the peer median"),
                            details={"score": round(score, 3)},
                            actions=[ACTION_OBSERVE],
                        ))
        # evidence for departed ranks must not linger (a re-joining rank
        # would inherit a half-accumulated hysteresis count)
        live = set(scores)
        for table in (self._over, self._under):
            for worker_id in list(table):
                if worker_id not in live:
                    table.pop(worker_id, None)
        self._flagged &= live | {r.worker_id for r in reports}
        return reports

    @property
    def flagged(self) -> set:
        return set(self._flagged)


class DataPipelineBoundRule(Rule):
    """Data-wait fraction attribution: a worker spending most of its step
    waiting on the input pipeline is starved, not slow — restarting or
    profiling the device would point at the wrong subsystem."""

    name = "data_pipeline_bound"

    def __init__(self):
        self._reported: set = set()

    def evaluate(self, snapshot, ctx=None):
        ctx = ctx or Context.singleton()
        reports: List[DiagnosisReport] = []
        bound = set()
        for worker_id, speed in snapshot.worker_speeds.items():
            if speed.samples < ctx.diagnosis_min_worker_samples:
                continue
            if speed.data_wait_fraction >= ctx.diagnosis_data_wait_fraction:
                bound.add(worker_id)
                if worker_id not in self._reported:
                    self._reported.add(worker_id)
                    reports.append(DiagnosisReport(
                        rule=self.name, severity=WARNING,
                        worker_id=worker_id,
                        summary=(
                            f"worker {worker_id} is data-pipeline bound: "
                            f"{speed.data_wait_fraction:.0%} of step time "
                            f"is data wait"),
                        details={"data_wait_fraction": round(
                            speed.data_wait_fraction, 3),
                            "mean_step_time_s": round(
                                speed.mean_step_time_s, 4)},
                        actions=[ACTION_ALERT],
                    ))
        self._reported &= bound   # re-report if it regresses again later
        return reports


class ThroughputCollapseRule(Rule):
    """Windowed MFU (preferred) or steps/s under
    ``diagnosis_collapse_ratio`` × the world's observed high-water mark.
    MFU is the better collapse signal once a FLOPs model is reported:
    it is what the fleet actually pays for, and a report phrased as
    "MFU 0.18 vs peak 0.63" is directly actionable where raw tokens/s
    needs the model size for context. The peak resets at membership
    change (SpeedMonitor.reset_running_speed), so a deliberate
    scale-down is a new baseline, not a collapse."""

    name = "throughput_collapse"

    def __init__(self):
        self._collapsed = False

    def evaluate(self, snapshot, ctx=None):
        ctx = ctx or Context.singleton()
        if snapshot.peak_mfu > 0.0 and snapshot.running_mfu >= 0.0:
            running, peak = snapshot.running_mfu, snapshot.peak_mfu
            evidence = (f"MFU {running:.3f} vs this world's peak "
                        f"{peak:.3f}")
            details = {"running_mfu": round(running, 4),
                       "peak_mfu": round(peak, 4), "signal": "mfu"}
        else:
            running, peak = snapshot.running_speed, snapshot.peak_speed
            evidence = (f"{running:.2f} vs {peak:.2f} steps/s")
            details = {"running_speed": round(running, 4),
                       "peak_speed": round(peak, 4),
                       "signal": "steps_per_second"}
        if peak <= 0.0 or running <= 0.0:
            return []
        ratio = running / peak
        if ratio < ctx.diagnosis_collapse_ratio:
            if self._collapsed:
                return []
            self._collapsed = True
            details["ratio"] = round(ratio, 3)
            return [DiagnosisReport(
                rule=self.name, severity=CRITICAL,
                summary=(f"throughput collapsed to {ratio:.0%} of this "
                         f"world's peak ({evidence})"),
                details=details,
                actions=[ACTION_ALERT],
            )]
        self._collapsed = False
        return []


class GoodputRule(Rule):
    """Trailing-window goodput under ``goodput_alert_threshold``: the
    job is spending its rank-seconds on something other than productive
    steps, and the report names the dominant badput bucket so the alert
    is actionable (restore-bound vs compile-bound vs data-wait demand
    different fixes). Disabled by default (threshold 0 — an acceptable
    floor is job-specific); the window must be at least
    ``goodput_min_coverage`` covered before judging, so a fresh world's
    first minutes are not evidence."""

    name = "goodput"

    def __init__(self):
        self._alerted = False

    def evaluate(self, snapshot, ctx=None):
        ctx = ctx or Context.singleton()
        threshold = ctx.goodput_alert_threshold
        evidence = snapshot.goodput
        if threshold <= 0.0 or not evidence:
            return []
        window_s = float(evidence.get("window_s", 0.0))
        elapsed = float(evidence.get("elapsed_rank_seconds", 0.0))
        workers = max(1, snapshot.running_workers)
        if window_s <= 0.0 or \
                elapsed < ctx.goodput_min_coverage * window_s * workers:
            return []
        fraction = float(evidence.get("goodput_fraction", -1.0))
        if fraction < 0.0:
            return []
        if fraction < threshold:
            if self._alerted:
                return []
            self._alerted = True
            dominant = evidence.get("dominant_badput") or "idle"
            dominant_s = float(evidence.get("dominant_badput_s", 0.0))
            return [DiagnosisReport(
                rule=self.name, severity=CRITICAL,
                summary=(
                    f"goodput {fraction:.0%} over the last "
                    f"{window_s:.0f}s is below the {threshold:.0%} "
                    f"floor; dominant badput: {dominant} "
                    f"({dominant_s:.0f}s)"),
                details={"goodput_fraction": round(fraction, 4),
                         "threshold": threshold,
                         "window_s": window_s,
                         "dominant_badput": dominant,
                         "dominant_badput_s": round(dominant_s, 1),
                         "buckets": dict(evidence.get("buckets", {}))},
                actions=[ACTION_ALERT],
            )]
        self._alerted = False
        return []


class HbmPressureRule(Rule):
    """Per-chip HBM over the pressure threshold: the next resize or
    batch bump will OOM — warn while there is still headroom to act.

    Judges the PEAK WATERMARK when the chip stats carry one
    (``hbm_peak_mb``, the allocator's in-step high-water mark from
    obs/device.py): the 15 s monitor tick samples ``bytes_in_use``
    BETWEEN steps — the trough — while the transient in-step peak is
    what actually OOMs. The per-rank step-report watermark
    (``hbm_peak_mb`` on the node entry) is folded in too; the trough
    remains the fallback for senders predating the field."""

    name = "hbm_pressure"

    def __init__(self):
        self._reported: set = set()

    def evaluate(self, snapshot, ctx=None):
        ctx = ctx or Context.singleton()
        reports: List[DiagnosisReport] = []
        pressured = set()
        for worker_id, stats in snapshot.node_stats.items():
            worst = 0.0
            signal = "bytes_in_use"
            max_total = 0.0
            for chip in stats.get("chips", ()):
                total = float(chip.get("hbm_total_mb", 0.0) or 0.0)
                if total <= 0:
                    continue
                max_total = max(max_total, total)
                peak = float(chip.get("hbm_peak_mb", -1.0) or -1.0)
                if peak >= 0.0:
                    used, chip_signal = peak, "peak_watermark"
                else:
                    used = float(chip.get("hbm_used_mb", 0.0))
                    chip_signal = "bytes_in_use"
                pct = 100.0 * used / total
                if pct > worst:
                    worst, signal = pct, chip_signal
            # the step report's device-truth window peak (report-interval
            # cadence — fresher than the chip-stats file relay)
            node_peak = float(stats.get("hbm_peak_mb", -1.0) or -1.0)
            if node_peak >= 0.0 and max_total > 0:
                pct = 100.0 * node_peak / max_total
                if pct > worst:
                    worst, signal = pct, "step_peak_watermark"
            if worst >= ctx.diagnosis_hbm_pressure_pct:
                pressured.add(worker_id)
                if worker_id not in self._reported:
                    self._reported.add(worker_id)
                    reports.append(DiagnosisReport(
                        rule=self.name, severity=WARNING,
                        worker_id=worker_id,
                        summary=(f"worker {worker_id} HBM pressure: "
                                 f"{worst:.1f}% of a chip's HBM "
                                 f"({signal})"),
                        details={"worst_chip_pct": round(worst, 2),
                                 "signal": signal},
                        actions=[ACTION_ALERT],
                    ))
        self._reported &= pressured
        return reports


class PlanRegressionRule(Rule):
    """Measured step time exceeds the planner's prediction for the
    RUNNING plan by ``PLAN_REGRESSION_RATIO`` — the plan the fleet is
    executing is slower than what it was chosen FOR, so the planner's
    ranking (and every future resize decision scored with the same
    prior) is suspect. Hysteresis like StragglerRule: the ratio must
    hold for ``PLAN_REGRESSION_WINDOWS`` consecutive diagnosis rounds
    (one slow window — a checkpoint, a GC pause — is noise), and fall
    under for ``PLAN_REGRESSION_CLEAR_WINDOWS`` to clear. A signature
    change (a new plan applied) resets the evidence: the new shape is
    judged on its own measurements. The calibration loop
    (parallel/calibration.py) feeds the per-axis discounts back into
    scoring either way; this rule is the ALERT that the loop had to
    correct by more than the configured ratio."""

    name = "plan_regression"

    def __init__(self):
        self._signature = ""
        self._over = 0
        self._under = 0
        self._alerted = False

    def evaluate(self, snapshot, ctx=None):
        entry = snapshot.plan_calibration
        if not entry:
            return []
        if entry.get("signature", "") != self._signature:
            self._signature = str(entry.get("signature", ""))
            self._over = self._under = 0
            self._alerted = False
        predicted = float(entry.get("predicted_step_s", 0.0))
        measured = float(entry.get("measured_step_s", 0.0))
        samples = int(entry.get("samples", 0))
        if predicted <= 0.0 or measured <= 0.0 \
                or samples < DefaultValues.CALIBRATION_MIN_SAMPLES:
            return []
        ratio = measured / predicted
        if ratio > DefaultValues.PLAN_REGRESSION_RATIO:
            self._under = 0
            self._over += 1
            if not self._alerted \
                    and self._over >= (
                        DefaultValues.PLAN_REGRESSION_WINDOWS):
                self._alerted = True
                mesh = entry.get("mesh", {})
                return [DiagnosisReport(
                    rule=self.name, severity=WARNING,
                    summary=(
                        f"plan regression: measured {measured:.3f}s/"
                        f"step is {ratio:.2f}x the planner's "
                        f"{predicted:.3f}s prediction for mesh "
                        f"{mesh} ({samples} windowed samples)"),
                    details={"ratio": round(ratio, 3),
                             "predicted_step_s": round(predicted, 6),
                             "measured_step_s": round(measured, 6),
                             "samples": samples,
                             "mesh": dict(mesh),
                             "windows_over": self._over},
                    actions=[ACTION_ALERT],
                )]
            return []
        self._over = 0
        if self._alerted:
            self._under += 1
            if self._under >= (
                    DefaultValues.PLAN_REGRESSION_CLEAR_WINDOWS):
                self._alerted = False
                self._under = 0
                return [DiagnosisReport(
                    rule=self.name, severity=INFO,
                    summary=(f"plan regression cleared: measured step "
                             f"time back to {ratio:.2f}x prediction"),
                    details={"ratio": round(ratio, 3)},
                    actions=[ACTION_OBSERVE],
                )]
        return []


class CriticalPathRule(Rule):
    """Steptrace critical-path attribution: a rank that GATES the fleet
    step — the one every other rank was waiting on — for at least
    ``critical_path_gating_fraction`` of the traced window is flagged by
    the *seconds it cost*, not by a mean ratio. This is sharper than
    :class:`StragglerRule`: a rank can have an unremarkable mean step
    time and still gate every step (it is last by a little, every
    time), and the evidence names the PHASE that gated (compute vs
    data_wait vs checkpoint), so the profile request already knows what
    it is looking for. Hysteresis mirrors StragglerRule
    (``straggler_trigger_windows`` to flag,
    ``straggler_clear_windows`` to clear); disabled when the fraction
    knob is <= 0 or the window has fewer than
    ``diagnosis_min_worker_samples`` traced steps."""

    name = "critical_path"

    def __init__(self):
        self._over: Dict[int, int] = {}     # consecutive over-threshold
        self._under: Dict[int, int] = {}    # consecutive clean (flagged)
        self._flagged: set = set()

    def evaluate(self, snapshot, ctx=None):
        ctx = ctx or Context.singleton()
        threshold = ctx.critical_path_gating_fraction
        evidence = snapshot.steptrace
        if threshold <= 0.0 or not evidence:
            return []
        steps = int(evidence.get("steps", 0))
        if steps < ctx.diagnosis_min_worker_samples:
            return []
        by_rank = evidence.get("by_rank", {}) or {}
        reports: List[DiagnosisReport] = []
        live = set()
        for rank_key, entry in by_rank.items():
            try:
                worker_id = int(rank_key)
            except (TypeError, ValueError):
                continue
            live.add(worker_id)
            gating_steps = int(entry.get("gating_steps", 0))
            gating_s = float(entry.get("gating_s", 0.0))
            fraction = gating_steps / steps
            phases = entry.get("phases", {}) or {}
            dominant_phase = max(
                sorted(phases), key=lambda p: phases[p],
                default="unknown")
            if fraction >= threshold:
                self._under.pop(worker_id, None)
                count = self._over.get(worker_id, 0) + 1
                self._over[worker_id] = count
                if (worker_id not in self._flagged
                        and count >= ctx.straggler_trigger_windows):
                    self._flagged.add(worker_id)
                    reports.append(DiagnosisReport(
                        rule=self.name, severity=WARNING,
                        worker_id=worker_id,
                        summary=(
                            f"rank {worker_id} gated {gating_steps}/"
                            f"{steps} traced steps "
                            f"({dominant_phase}, {gating_s:.2f}s "
                            f"gating)"),
                        details={
                            "gating_steps": gating_steps,
                            "traced_steps": steps,
                            "gating_fraction": round(fraction, 3),
                            "gating_s": round(gating_s, 4),
                            "gating_phase": dominant_phase,
                            "phases": {p: round(float(s), 4)
                                       for p, s in phases.items()},
                            "windows_over": count},
                        actions=[f"{ACTION_PROFILE}:{worker_id}",
                                 ACTION_ALERT],
                    ))
            else:
                self._over.pop(worker_id, None)
                if worker_id in self._flagged:
                    count = self._under.get(worker_id, 0) + 1
                    self._under[worker_id] = count
                    if count >= ctx.straggler_clear_windows:
                        self._flagged.discard(worker_id)
                        self._under.pop(worker_id, None)
                        reports.append(DiagnosisReport(
                            rule=self.name, severity=INFO,
                            worker_id=worker_id,
                            summary=(
                                f"rank {worker_id} off the critical "
                                f"path: gated {gating_steps}/{steps} "
                                f"traced steps"),
                            details={"gating_fraction": round(
                                fraction, 3)},
                            actions=[ACTION_OBSERVE],
                        ))
        # evidence for departed ranks must not linger (a re-joining rank
        # would inherit a half-accumulated hysteresis count)
        for table in (self._over, self._under):
            for worker_id in list(table):
                if worker_id not in live:
                    table.pop(worker_id, None)
        self._flagged &= live | {r.worker_id for r in reports}
        return reports

    @property
    def flagged(self) -> set:
        return set(self._flagged)


def default_rules() -> List[Rule]:
    """The chain, cheapest-evidence first."""
    return [StragglerRule(), CriticalPathRule(), DataPipelineBoundRule(),
            ThroughputCollapseRule(), HbmPressureRule(),
            PlanRegressionRule(), GoodputRule()]


def parse_action(action: str) -> Dict[str, Any]:
    """``kind[:rank]`` → {"kind", "rank"}; unknown kinds map to observe
    (an old agent must never crash on a newer master's grammar)."""
    kind, _, rank = action.partition(":")
    kind = kind.strip().lower()
    if kind not in (ACTION_OBSERVE, ACTION_PROFILE, ACTION_RESTART,
                    ACTION_CHECKPOINT, ACTION_DRAIN, ACTION_ALERT):
        kind = ACTION_OBSERVE
    try:
        target = int(rank) if rank else -1
    except ValueError:
        target = -1
    return {"kind": kind, "rank": target}
