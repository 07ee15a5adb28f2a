"""Per-step phase timeline: where did each training step's time go?

The step histogram says a step was slow; it cannot say *why*. The
timeline attributes every loop iteration to its phases — data-wait
(pulling the next batch from the host pipeline), h2d (host→device
transfer of the sharded batch), compute (train-step dispatch), plus the
occasional host_sync / checkpoint stalls — in a bounded ring. Its
windowed mean step time and data-wait fraction ride on the worker's
step reports to the master.

Recording is on the hot path: one ``record()`` per step must cost
microseconds, so a record is a dict append under a plain lock — no I/O,
no metrics.

Own copy of the JAX package's ``obs/timeline.py``; stdlib-only. Not
ported yet: ``export``/``load_timeline``, the JSON file the JAX agent
reads for its step-hang watchdog's forward-progress check (ROADMAP
Queue A item 6.5).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List

# canonical phase order (rendering + fraction math); "other" is the
# residual of total_s not covered by an explicit phase
PHASES = ("data_wait", "h2d", "compute", "host_sync", "checkpoint")


class StepTimeline:
    """Bounded ring of per-step phase attributions."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._steps: deque = deque(maxlen=capacity)

    def record(self, step: int, total_s: float,
               **phases: float) -> None:
        """One finished loop iteration. ``phases`` are seconds per phase
        (unknown phases are kept — the format is open); the residual
        lands under "other"."""
        known = sum(phases.values())
        entry = {"step": int(step), "total_s": float(total_s),
                 "phases": {k: float(v) for k, v in phases.items()}}
        residual = total_s - known
        if residual > 1e-9:
            entry["phases"]["other"] = residual
        with self._lock:
            self._steps.append(entry)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._steps)

    def window_stats(self, last_n: int = 0) -> Dict[str, float]:
        """Mean step time + per-phase fraction over the last ``last_n``
        records (0 = whole ring). ``data_wait_fraction`` is -1.0 when no
        samples exist — callers must not mistake "no data" for "0 %"."""
        with self._lock:
            steps = list(self._steps)
        if last_n > 0:
            steps = steps[-last_n:]
        if not steps:
            return {"samples": 0, "mean_step_s": 0.0,
                    "data_wait_fraction": -1.0}
        total = sum(e["total_s"] for e in steps)
        stats: Dict[str, float] = {
            "samples": len(steps),
            "mean_step_s": total / len(steps),
        }
        if total > 0:
            phase_totals: Dict[str, float] = {}
            for entry in steps:
                for name, value in entry["phases"].items():
                    phase_totals[name] = phase_totals.get(name, 0.0) + value
            for name, value in phase_totals.items():
                stats[f"{name}_fraction"] = value / total
        stats.setdefault("data_wait_fraction", -1.0 if total <= 0 else 0.0)
        return stats
