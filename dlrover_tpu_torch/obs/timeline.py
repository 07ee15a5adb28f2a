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
no metrics. The periodic ``export()`` (report-interval cadence) does
the JSON write, atomically: the agent reads the file (``load_timeline``)
for its relaunch governor's forward-progress check, and never sees a
torn one.

Own copy of the JAX package's ``obs/timeline.py``; stdlib-only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# canonical phase order (rendering + fraction math); "other" is the
# residual of total_s not covered by an explicit phase
PHASES = ("data_wait", "h2d", "compute", "host_sync", "checkpoint")

TIMELINE_VERSION = 1


class StepTimeline:
    """Bounded ring of per-step phase attributions."""

    def __init__(self, capacity: int = 256, role: str = "worker",
                 rank: int = -1):
        self._lock = threading.Lock()
        self._steps: deque = deque(maxlen=capacity)
        self._role = role
        self._rank = rank

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

    # -- export / parse ----------------------------------------------------
    def export(self, path: str, last_n: int = 0) -> bool:
        """Atomically write the ring as JSON (the agent's reader
        contract). ``last_n`` > 0 writes only the newest N records (the
        report-interval exports on the hot path serialize a tail); the
        end of a run writes the whole ring. Never raises: a full disk
        must not kill the step loop."""
        steps = self.snapshot()
        if last_n > 0:
            steps = steps[-last_n:]
        payload = {
            "version": TIMELINE_VERSION,
            "role": self._role,
            "rank": self._rank,
            "pid": os.getpid(),
            "exported_at": time.time(),
            "steps": steps,
        }
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
            return True
        except OSError:
            return False


def load_timeline(path: str) -> Optional[Dict[str, Any]]:
    """Parse an exported timeline file; None when missing or corrupt
    (readers poll while the worker is mid-flight: absence is normal)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None
    if not isinstance(payload, dict) or \
            not isinstance(payload.get("steps"), list):
        return None
    return payload
