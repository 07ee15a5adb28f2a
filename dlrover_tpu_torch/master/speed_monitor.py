"""Global-step speed monitoring and hang detection.

Own copy of the JAX package's ``master/speed_monitor.py``, after
dlrover/python/master/monitor/speed_monitor.py:43 —
collect (timestamp, global_step) samples, compute windowed throughput,
track per-worker step reports, and flag a hang when no step progress is made
for `hang_seconds`.

Publishes through the obs metrics registry (docs/observability.md):
``dlrover_tpu_training_global_step`` / ``_steps_per_second`` /
``_tokens_per_second`` collect-time gauges and the
``dlrover_tpu_train_step_time_seconds`` histogram observed per step
report. All shared step/worker state is written from servicer threads
and read from the master watch loop + metrics scrapes — every access
goes through ``self._lock``; registry observes happen OUTSIDE the lock
(sinks must never run under it).
"""

from __future__ import annotations

import dataclasses
import statistics
import threading
import time
from collections import deque
from typing import Deque, Dict, Iterable, Optional, Set, Tuple

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.obs import mfu as mfu_math


@dataclasses.dataclass
class WorkerSpeed:
    """Windowed per-worker speed evidence (the diagnosis engine's straggler
    input): means over the last `samples` step reports that carried
    timing (worker timelines, obs/timeline.py)."""

    worker_id: int
    samples: int = 0
    mean_step_time_s: float = 0.0
    data_wait_fraction: float = -1.0   # -1 = no timeline evidence
    last_report_ts: float = 0.0
    step: int = 0
    mfu: float = -1.0                  # -1 = no FLOPs model evidence


class SpeedMonitor:
    def __init__(self):
        self._lock = threading.Lock()
        ctx = Context.singleton()
        self._samples: Deque[Tuple[float, int]] = deque(
            maxlen=ctx.speed_sample_window
        )
        self._global_step = 0
        self._first_step_time: Optional[float] = None
        self._last_step_time: float = time.time()
        self._workers: Set[int] = set()
        self._worker_steps: Dict[int, int] = {}
        # worker_id -> deque[(step_time_s, data_wait_fraction, mfu, ts)]
        # from step reports that carried timing evidence
        self._worker_window = max(2, ctx.diagnosis_worker_window)
        self._worker_times: Dict[
            int, Deque[Tuple[float, float, float, float]]] = {}
        # worker_id -> deque[(latency_s, records, ts)] from completed
        # data-shard tasks (TaskManager.report_dataset_task): the only
        # per-rank speed evidence during data-only warmup, before any
        # step report carries timing — dispatch weighting must not fly
        # blind there.
        self._task_latency: Dict[int, Deque[Tuple[float, int, float]]] = {}
        # steps/s high-water mark over the job (throughput-collapse
        # baseline; survives window resets, cleared on restore)
        self._peak_speed = 0.0
        self._start_training_time: Optional[float] = None
        self._paused_time_s: float = 0.0
        self._tokens_per_step: int = 0
        self._seq_len: int = 0
        # model-FLOPs accounting (obs/mfu.py, fed by ModelInfo): the
        # job's MFU exposition is tokens/s × flops_per_token / peak.
        # The per-chip peak is kept separately so a parallelism re-plan
        # can re-anchor the aggregate to the NEW chip count instead of
        # reporting post-resize MFU against the old denominator.
        self._flops_per_token: float = 0.0
        self._peak_flops_total: float = 0.0
        self._peak_flops_per_chip: float = 0.0
        # set at membership change: the NEXT step-report delta spans the
        # failover gap (rendezvous + recompile + restore), not step time
        self._skip_next_step_time = False
        self._publish_metrics()

    def _publish_metrics(self) -> None:
        """Collect-time gauges: scrapes read live values through the
        monitor's own locked queries (the newest monitor instance in a
        process wins the registration — matching the newest master)."""
        registry = obs.get_registry()
        registry.gauge(
            "dlrover_tpu_training_global_step",
            "Latest global step reported by any worker",
        ).set_function(lambda: self.completed_global_step)
        registry.gauge(
            "dlrover_tpu_training_steps_per_second",
            "Windowed training throughput",
        ).set_function(self.running_speed)
        registry.gauge(
            "dlrover_tpu_training_tokens_per_second",
            "Windowed throughput x tokens per step (from ModelInfo)",
        ).set_function(self.tokens_per_second)
        registry.gauge(
            "dlrover_tpu_training_running_workers",
            "Workers currently joined on the master",
        ).set_function(lambda: self.num_running_workers)
        registry.gauge(
            "dlrover_tpu_training_mfu",
            "Job model-FLOPs utilization: tokens/s x FLOPs-per-token "
            "over the world's aggregate peak (-1 = no FLOPs model yet)",
        ).set_function(self.running_mfu)
        registry.gauge(
            "dlrover_tpu_training_model_flops_per_token",
            "Model FLOPs per trained token (ModelInfo; obs/mfu.py)",
        ).set_function(lambda: self._model_flops())
        self._step_time_hist = registry.histogram(
            "dlrover_tpu_train_step_time_seconds",
            "Wall-clock per training step, from step-report deltas",
        )

    # -- sample collection -------------------------------------------------
    def collect_global_step(self, step: int,
                            timestamp: Optional[float] = None) -> None:
        timestamp = timestamp or time.time()
        step_time: Optional[float] = None
        with self._lock:
            if step <= self._global_step:
                return
            if self._first_step_time is None:
                self._first_step_time = timestamp
            elif self._skip_next_step_time:
                # this delta spans the failover gap, not training
                self._skip_next_step_time = False
            elif timestamp > self._last_step_time:
                # mean per-step wall time since the previous report
                step_time = ((timestamp - self._last_step_time)
                             / (step - self._global_step))
            self._global_step = step
            self._last_step_time = timestamp
            self._samples.append((timestamp, step))
            speed = self._window_speed_locked()
            if speed > self._peak_speed:
                self._peak_speed = speed
        if step_time is not None:
            self._step_time_hist.observe(step_time)

    def collect_worker_step(self, worker_id: int, step: int,
                            step_time_s: float = 0.0,
                            data_wait_fraction: float = -1.0,
                            mfu: float = -1.0,
                            timestamp: Optional[float] = None) -> None:
        timestamp = timestamp or time.time()
        with self._lock:
            self._worker_steps[worker_id] = step
            if step_time_s > 0.0:
                window = self._worker_times.get(worker_id)
                if window is None:
                    window = deque(maxlen=self._worker_window)
                    self._worker_times[worker_id] = window
                window.append((step_time_s, data_wait_fraction, mfu,
                               timestamp))
        self.collect_global_step(step, timestamp)

    def collect_task_latency(self, worker_id: int, latency_s: float,
                             records: int,
                             timestamp: Optional[float] = None) -> None:
        """Per-rank data-shard completion latency, fed by
        TaskManager.report_dataset_task on every successful shard.
        Unlike step timing (gated on step_time_s > 0) this exists from
        the very first completed shard, so speed-weighted dispatch has
        evidence during the data-only warmup when no step report has
        carried timing yet."""
        if latency_s <= 0.0 or records <= 0:
            return
        timestamp = timestamp or time.time()
        with self._lock:
            window = self._task_latency.get(worker_id)
            if window is None:
                window = deque(maxlen=self._worker_window)
                self._task_latency[worker_id] = window
            window.append((latency_s, records, timestamp))

    def relative_speeds(self) -> Dict[int, float]:
        """Per-rank speed score: 1.0 = at the pack's pace, <1 slower,
        >1 faster. Ranks with step-timing evidence are scored against
        the fleet's median step time; ranks with ONLY task-latency
        evidence (data-only warmup) against the median records/s of
        that class. The two classes never share a denominator — a shard
        fetch and a training step are not the same kind of second."""
        with self._lock:
            step_mean: Dict[int, float] = {}
            for worker_id, window in self._worker_times.items():
                times = [t for t, _, _, _ in window]
                if times:
                    step_mean[worker_id] = sum(times) / len(times)
            task_rate: Dict[int, float] = {}
            for worker_id, window in self._task_latency.items():
                if worker_id in step_mean or not window:
                    continue
                lat = sum(entry[0] for entry in window)
                recs = sum(entry[1] for entry in window)
                if lat > 0.0 and recs > 0:
                    task_rate[worker_id] = recs / lat
        out: Dict[int, float] = {}
        if step_mean:
            med = statistics.median(step_mean.values())
            if med > 0.0:
                out.update({w: med / t for w, t in step_mean.items()
                            if t > 0.0})
        if task_rate:
            med = statistics.median(task_rate.values())
            if med > 0.0:
                out.update({w: r / med for w, r in task_rate.items()})
        return out

    def set_start_training(self) -> None:
        with self._lock:
            if self._start_training_time is None:
                self._start_training_time = time.time()

    def set_tokens_per_step(self, tokens: int, seq_len: int = 0) -> None:
        """From ModelInfo (batch_size × seq_len): scales steps/s into the
        tokens/s exposition series."""
        with self._lock:
            if tokens > 0:
                self._tokens_per_step = int(tokens)
            if seq_len > 0:
                self._seq_len = int(seq_len)

    @property
    def seq_len_hint(self) -> int:
        """Last reported sequence length (0 = never reported): lets a
        re-plan derive the new tokens-per-step from its planned batch
        before any worker of the new world has reported."""
        with self._lock:
            return self._seq_len

    def set_model_flops(self, flops_per_token: float,
                        peak_flops_total: float,
                        peak_flops_per_chip: float = 0.0) -> None:
        """From ModelInfo: the FLOPs model + aggregate peak that turn the
        tokens/s series into the MFU gauge."""
        with self._lock:
            if flops_per_token > 0.0:
                self._flops_per_token = float(flops_per_token)
            if peak_flops_total > 0.0:
                self._peak_flops_total = float(peak_flops_total)
            if peak_flops_per_chip > 0.0:
                self._peak_flops_per_chip = float(peak_flops_per_chip)

    def reanchor_plan(self, chips: int = 0,
                      tokens_per_step: int = 0) -> None:
        """A parallelism re-plan changed the world's execution shape:
        the aggregate peak re-anchors to the NEW chip count (from the
        stored per-chip peak) and tokens/s to the planned (possibly
        adjusted) batch, so post-resize MFU is never reported against
        the old world's denominators. Windowed samples and the peak
        speed reset as at any membership change: they describe the OLD
        shape's throughput."""
        with self._lock:
            if tokens_per_step > 0:
                self._tokens_per_step = int(tokens_per_step)
            if chips > 0 and self._peak_flops_per_chip > 0.0:
                self._peak_flops_total = (self._peak_flops_per_chip
                                          * chips)
            self._samples.clear()
            self._skip_next_step_time = True
            self._peak_speed = 0.0
            self._worker_times.clear()
            self._task_latency.clear()

    def _model_flops(self) -> float:
        with self._lock:
            return self._flops_per_token

    # -- queries -----------------------------------------------------------
    @property
    def completed_global_step(self) -> int:
        with self._lock:
            return self._global_step

    @property
    def num_running_workers(self) -> int:
        with self._lock:
            return len(self._workers)

    def running_speed(self) -> float:
        """Steps/second over the sample window."""
        with self._lock:
            return self._window_speed_locked()

    def _window_speed_locked(self) -> float:
        if len(self._samples) < 2:
            return 0.0
        (t0, s0), (t1, s1) = self._samples[0], self._samples[-1]
        if t1 <= t0:
            return 0.0
        return (s1 - s0) / (t1 - t0)

    def peak_speed(self) -> float:
        """Steps/s high-water mark of the CURRENT world (reset at
        membership change — a smaller world's sustainable speed is a new
        baseline, not a collapse)."""
        with self._lock:
            return self._peak_speed

    def running_mfu(self) -> float:
        """Job MFU from the windowed throughput; -1 with no FLOPs
        model (callers must not mistake "no evidence" for 0%)."""
        with self._lock:
            tokens = self._tokens_per_step
            fpt = self._flops_per_token
            peak = self._peak_flops_total
        return mfu_math.achieved_mfu(self.running_speed() * tokens,
                                     fpt, peak)

    def peak_mfu(self) -> float:
        """MFU at this world's steps/s high-water mark (the collapse
        rule's MFU baseline); -1 with no FLOPs model."""
        with self._lock:
            tokens = self._tokens_per_step
            fpt = self._flops_per_token
            peak = self._peak_flops_total
            peak_speed = self._peak_speed
        return mfu_math.achieved_mfu(peak_speed * tokens, fpt, peak)

    def worker_speeds(self) -> Dict[int, WorkerSpeed]:
        """Windowed per-worker means for the diagnosis engine (only
        workers whose reports carried timing evidence appear)."""
        with self._lock:
            out: Dict[int, WorkerSpeed] = {}
            for worker_id, window in self._worker_times.items():
                if not window:
                    continue
                times = [t for t, _, _, _ in window]
                waits = [w for _, w, _, _ in window if w >= 0.0]
                mfus = [m for _, _, m, _ in window if m >= 0.0]
                out[worker_id] = WorkerSpeed(
                    worker_id=worker_id,
                    samples=len(window),
                    mean_step_time_s=sum(times) / len(times),
                    data_wait_fraction=(sum(waits) / len(waits)
                                        if waits else -1.0),
                    last_report_ts=window[-1][3],
                    step=self._worker_steps.get(worker_id, 0),
                    mfu=(sum(mfus) / len(mfus) if mfus else -1.0),
                )
            return out

    def evict_departed(self, live: Iterable[int]) -> Set[int]:
        """Drop per-worker state for every worker NOT in ``live`` (the
        membership-change hook): straggler scoring and per-worker gauges
        must never rank dead ranks. Returns the evicted ids."""
        live_set = set(live)
        with self._lock:
            departed = ((set(self._worker_steps)
                         | set(self._worker_times)
                         | set(self._task_latency)
                         | self._workers) - live_set)
            for worker_id in departed:
                self._workers.discard(worker_id)
                self._worker_steps.pop(worker_id, None)
                self._worker_times.pop(worker_id, None)
                self._task_latency.pop(worker_id, None)
        return departed

    def tokens_per_second(self) -> float:
        with self._lock:
            tokens = self._tokens_per_step
        return self.running_speed() * tokens

    def all_worker_joined(self, expected: int) -> bool:
        with self._lock:
            return len(self._workers) >= expected

    def add_running_worker(self, worker_id: int) -> None:
        with self._lock:
            self._workers.add(worker_id)

    def remove_running_worker(self, worker_id: int) -> None:
        with self._lock:
            self._workers.discard(worker_id)
            self._worker_steps.pop(worker_id, None)
            self._worker_times.pop(worker_id, None)
            self._task_latency.pop(worker_id, None)

    def is_hanged(self, hang_seconds: Optional[float] = None) -> bool:
        """No step progress for hang_seconds while training had started."""
        hang_seconds = hang_seconds or Context.singleton().hang_seconds
        with self._lock:
            if self._first_step_time is None:
                return False
            return (time.time() - self._last_step_time) > hang_seconds

    def export_state(self) -> dict:
        with self._lock:
            return {"global_step": self._global_step,
                    "tokens_per_step": self._tokens_per_step,
                    "seq_len": self._seq_len,
                    "flops_per_token": self._flops_per_token,
                    "peak_flops_total": self._peak_flops_total,
                    "peak_flops_per_chip": self._peak_flops_per_chip}

    def restore_state(self, state: dict) -> None:
        """Rehydrate the step high-water mark so post-failover hang
        detection and the exposition don't restart from 0. Wall-clock
        fields restart fresh: the first step delta after a master
        restart spans the outage, not training."""
        with self._lock:
            self._global_step = int(state.get("global_step", 0))
            self._tokens_per_step = int(state.get("tokens_per_step", 0))
            self._seq_len = int(state.get("seq_len", 0))
            self._flops_per_token = float(
                state.get("flops_per_token", 0.0))
            self._peak_flops_total = float(
                state.get("peak_flops_total", 0.0))
            self._peak_flops_per_chip = float(
                state.get("peak_flops_per_chip", 0.0))
            self._last_step_time = time.time()
            self._samples.clear()
            self._skip_next_step_time = True
            self._peak_speed = 0.0
            self._worker_times.clear()
            self._task_latency.clear()

    def reset_running_speed(self) -> None:
        """Call at membership change: old samples reflect the old world,
        and the next step-report delta spans the failover gap — neither
        belongs in the steady-state series. The peak-speed baseline and
        per-worker timing windows reset too: they describe the OLD
        world's sustainable throughput."""
        with self._lock:
            self._samples.clear()
            self._skip_next_step_time = True
            self._peak_speed = 0.0
            self._worker_times.clear()
            self._task_latency.clear()
