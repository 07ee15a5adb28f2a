"""Planner prediction against measurement: the calibration loop.

Own copy of the JAX package's ``parallel/calibration.py`` (stdlib only;
``tests/test_torch_replan.py`` holds its exported state equal to the
reference's under one fake clock). The planner (``parallel/planner.py``)
stamps a ``predicted_step_s`` on every plan; :class:`PlanCalibration`
confronts it with measurement. Per applied shard-plan SIGNATURE (mesh,
device count and batch: the execution shape) it records the planner's
prediction and accumulates the steady-state step time and MFU of the
workers' step reports. From the table it derives learned per-axis
efficiency discounts that the rendezvous manager feeds back into
planner scoring (``set_axis_discounts``), and the current signature's
predicted-against-measured entry is the evidence of
:class:`~dlrover_tpu_torch.master.diagnosis.rules.PlanRegressionRule`.

Thread-safe (fed from servicer threads, read by the diagnosis loop and
RPCs), exported and restored through the master's state backend so that
calibration survives a master failover or a standby promotion.
"""

from __future__ import annotations

import json
import statistics
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

CALIBRATION_VERSION = 1

# samples retained per signature (each already a windowed worker mean)
SAMPLE_WINDOW = 64
# learned discounts are clamped: calibration refines the prior, it must
# never be able to zero an axis out (or inflate it) off noisy evidence
DISCOUNT_MIN = 0.25
DISCOUNT_MAX = 2.0
# axes a discount can be learned for (mesh dict keys, planner order)
AXES = ("dcn", "data", "fsdp", "tensor", "pipe")


def plan_signature(plan: Dict[str, Any]) -> str:
    """The execution shape as a stable string — the calibration key.
    Mesh + device count + effective batch: what the step time actually
    depends on (generation/epoch deliberately excluded: a re-stamp of
    the same shape continues the same measurement series)."""
    return json.dumps({
        "mesh": {k: int((plan.get("mesh") or {}).get(k, 1))
                 for k in AXES},
        "total_devices": int(plan.get("total_devices", 0) or 0),
        "global_batch": int(plan.get("global_batch", 0) or 0),
    }, sort_keys=True, separators=(",", ":"))


class PlanCalibration:
    def __init__(self, sample_window: int = SAMPLE_WINDOW,
                 min_samples: Optional[int] = None,
                 clock: Callable[[], float] = time.time):
        from dlrover_tpu_torch.common.config import Context

        self._window = max(2, int(sample_window))
        self._min_samples = (
            min_samples if min_samples is not None
            else Context.singleton().calibration_min_samples)
        self._clock = clock
        self._lock = threading.Lock()
        # signature -> {"mesh", "total_devices", "global_batch",
        #   "predicted_step_s", "predicted_efficiency", "generation",
        #   "first_ts", "samples": deque[(step_s, mfu)]}
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._current: Optional[str] = None
        # latest stamped generation -> signature (each generation
        # stamps exactly one plan): the attribution key for reports
        # that say which plan their sender actually ran
        self._by_generation: Dict[int, str] = {}

    @property
    def min_samples(self) -> int:
        return self._min_samples

    # -- feeds (servicer threads) ------------------------------------------
    def observe_plan(self, plan: Dict[str, Any]) -> None:
        """A plan was stamped (or re-stamped) by the master: remember
        its prediction under its signature and make it the CURRENT
        shape measurements attribute to. Infeasible plans are not
        calibration subjects — nothing runs them."""
        if not isinstance(plan, dict) or not plan.get("mesh") \
                or not plan.get("feasible", False):
            return
        signature = plan_signature(plan)
        predicted = float(plan.get("predicted_step_s", 0.0) or 0.0)
        # the stamped prediction already includes the learned discounts
        # (planner._efficiency): calibrating against it would measure
        # the correction against its own output — each push re-stamps
        # a compensated prediction, the ratio re-centers on 1.0, the
        # discount decays and oscillates. Divide the plan's stamped
        # discounts back out so the learned ratio stays anchored to
        # the RAW analytic prior (step time scales 1/efficiency, so
        # raw = discounted x the active axes' discount product).
        stamped = plan.get("axis_discounts") or {}
        if predicted > 0.0 and stamped:
            for axis in AXES:
                ways = int((plan.get("mesh") or {}).get(axis, 1) or 1)
                discount = float(stamped.get(axis, 0.0) or 0.0)
                if ways > 1 and discount > 0.0:
                    predicted *= discount
        with self._lock:
            entry = self._entries.get(signature)
            if entry is None:
                entry = {
                    "mesh": {k: int(plan["mesh"].get(k, 1))
                             for k in AXES},
                    "total_devices": int(
                        plan.get("total_devices", 0) or 0),
                    "global_batch": int(
                        plan.get("global_batch", 0) or 0),
                    "first_ts": self._clock(),
                    "samples": deque(maxlen=self._window),
                }
                self._entries[signature] = entry
            entry["predicted_step_s"] = predicted
            entry["predicted_efficiency"] = float(
                plan.get("predicted_efficiency", 0.0) or 0.0)
            entry["generation"] = int(plan.get("generation", 0) or 0)
            self._by_generation[entry["generation"]] = signature
            # bounded: a flapping fleet bumps generations forever, but
            # only recent ones can still have in-flight reports
            while len(self._by_generation) > 256:
                self._by_generation.pop(min(self._by_generation))
            self._current = signature

    def observe_step(self, step_time_s: float, mfu: float = -1.0,
                     plan_generation: int = -1) -> None:
        """One steady-state measurement (a worker's windowed mean step
        time, optionally its achieved MFU). A measurement must never
        land on a shape it did not run: when the report names the plan
        generation its sender applied (``plan_generation >= 0``) the
        sample lands on THAT stamped shape — so an old incarnation's
        straggling report during a resize cannot contaminate the new
        plan's entry — and a report from a fallback-mesh worker
        (``-2``) is dropped. ``-1`` (sender predates the field) keeps
        the current-signature attribution; no current plan → no
        attribution."""
        if step_time_s <= 0.0:
            return
        with self._lock:
            if plan_generation >= 0:
                signature = self._by_generation.get(plan_generation)
            elif plan_generation == -1:
                signature = self._current
            else:                      # explicit "not the stamped plan"
                signature = None
            entry = (self._entries.get(signature)
                     if signature else None)
            if entry is None:
                return
            entry["samples"].append((float(step_time_s), float(mfu)))

    # -- views -------------------------------------------------------------
    def _entry_view_locked(self, signature: str,
                           entry: Dict[str, Any]) -> Dict[str, Any]:
        samples = list(entry["samples"])
        times = [t for t, _ in samples]
        mfus = [m for _, m in samples if m >= 0.0]
        measured = sum(times) / len(times) if times else 0.0
        predicted = float(entry.get("predicted_step_s", 0.0))
        return {
            "signature": signature,
            "mesh": dict(entry["mesh"]),
            "total_devices": entry["total_devices"],
            "global_batch": entry["global_batch"],
            "generation": entry.get("generation", 0),
            "predicted_step_s": round(predicted, 9),
            "predicted_efficiency": round(
                float(entry.get("predicted_efficiency", 0.0)), 4),
            "measured_step_s": round(measured, 9),
            "measured_mfu": round(sum(mfus) / len(mfus), 4)
            if mfus else -1.0,
            "samples": len(samples),
            "ratio": round(measured / predicted, 4)
            if predicted > 0 and measured > 0 else 0.0,
            "current": signature == self._current,
        }

    def current(self) -> Optional[Dict[str, Any]]:
        """The running shape's predicted-vs-measured entry (the
        PlanRegressionRule's evidence); None before any plan."""
        with self._lock:
            if not self._current:
                return None
            entry = self._entries.get(self._current)
            if entry is None:
                return None
            return self._entry_view_locked(self._current, entry)

    def table(self) -> List[Dict[str, Any]]:
        """Every calibrated shape, stamped-first order (by first_ts)."""
        with self._lock:
            ordered = sorted(self._entries.items(),
                             key=lambda kv: kv[1].get("first_ts", 0.0))
            return [self._entry_view_locked(sig, entry)
                    for sig, entry in ordered]

    # -- the feedback loop -------------------------------------------------
    def axis_discounts(self,
                       min_samples: Optional[int] = None
                       ) -> Dict[str, float]:
        """Learned per-axis efficiency discounts for planner scoring.

        For each mesh axis: the median predicted/measured speed ratio
        of shapes USING the axis (size > 1), normalized by the median
        ratio of shapes NOT using it — so a global model bias (every
        shape 20 % slower than predicted) cancels instead of being
        blamed on whichever axis happens to be active. Clamped to
        [0.25, 2.0]; axes with no adequately-sampled evidence on both
        sides learn nothing (empty dict = prior stands)."""
        threshold = (min_samples if min_samples is not None
                     else self._min_samples)
        with self._lock:
            ratios = []        # (mesh, predicted/measured)
            for entry in self._entries.values():
                samples = [t for t, _ in entry["samples"]]
                predicted = float(entry.get("predicted_step_s", 0.0))
                if len(samples) < threshold or predicted <= 0.0:
                    continue
                measured = sum(samples) / len(samples)
                if measured <= 0.0:
                    continue
                ratios.append((entry["mesh"], predicted / measured))
        discounts: Dict[str, float] = {}
        for axis in AXES:
            with_axis = [r for mesh, r in ratios
                         if int(mesh.get(axis, 1)) > 1]
            without = [r for mesh, r in ratios
                       if int(mesh.get(axis, 1)) <= 1]
            if not with_axis or not without:
                continue
            baseline = statistics.median(without)
            if baseline <= 0.0:
                continue
            learned = statistics.median(with_axis) / baseline
            discounts[axis] = round(
                min(DISCOUNT_MAX, max(DISCOUNT_MIN, learned)), 4)
        return discounts

    # -- crash-consistent state (master/state_backend.py) ------------------
    def export_state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "version": CALIBRATION_VERSION,
                "current": self._current or "",
                "entries": {
                    sig: {
                        "mesh": dict(entry["mesh"]),
                        "total_devices": entry["total_devices"],
                        "global_batch": entry["global_batch"],
                        "generation": entry.get("generation", 0),
                        "first_ts": entry.get("first_ts", 0.0),
                        "predicted_step_s": entry.get(
                            "predicted_step_s", 0.0),
                        "predicted_efficiency": entry.get(
                            "predicted_efficiency", 0.0),
                        "samples": [[t, m] for t, m
                                    in entry["samples"]],
                    }
                    for sig, entry in self._entries.items()
                },
            }

    def restore_state(self, state: Dict[str, Any]) -> None:
        if not isinstance(state, dict):
            return
        with self._lock:
            self._entries.clear()
            self._by_generation.clear()
            for sig, raw in (state.get("entries") or {}).items():
                if not isinstance(raw, dict):
                    continue
                samples: deque = deque(maxlen=self._window)
                for pair in raw.get("samples", []):
                    if isinstance(pair, (list, tuple)) \
                            and len(pair) == 2:
                        samples.append((float(pair[0]),
                                        float(pair[1])))
                self._entries[str(sig)] = {
                    "mesh": {k: int((raw.get("mesh") or {}).get(k, 1))
                             for k in AXES},
                    "total_devices": int(
                        raw.get("total_devices", 0) or 0),
                    "global_batch": int(
                        raw.get("global_batch", 0) or 0),
                    "generation": int(raw.get("generation", 0) or 0),
                    "first_ts": float(raw.get("first_ts", 0.0) or 0.0),
                    "predicted_step_s": float(
                        raw.get("predicted_step_s", 0.0) or 0.0),
                    "predicted_efficiency": float(
                        raw.get("predicted_efficiency", 0.0) or 0.0),
                    "samples": samples,
                }
                self._by_generation[
                    self._entries[str(sig)]["generation"]] = str(sig)
            current = str(state.get("current", "") or "")
            self._current = current if current in self._entries else None
