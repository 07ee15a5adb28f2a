"""Job metric collector: gathers job/runtime/model stats and reports them.

Own copy of the JAX package's ``master/stats/job_collector.py``, after
JobMetricCollector (dlrover/python/master/stats/job_collector.py): job
meta at start, periodic runtime stats (node usage + global step), model
info once known, and the job-exit record, to the local reporter or the
brain. The port's runtime record also carries ``hbm_peak_mb``, the
largest allocator peak the step reports have shown (the card's
device-truth watermark), once one has come in.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.master.resource.stats_collector import (
    NodeSample,
    RuntimeStatsCollector,
)
from dlrover_tpu_torch.master.stats.reporter import StatsReporter


class JobMetricCollector:
    def __init__(
        self,
        job_name: str,
        reporter: StatsReporter,
        stats: Optional[RuntimeStatsCollector] = None,
        interval_s: float = 30.0,
    ):
        self._job_name = job_name
        self._reporter = reporter
        self.stats = stats or RuntimeStatsCollector()
        self._interval_s = interval_s
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._speed_monitor = None
        self._job_manager = None
        self._model_reported = False
        # rank → the newest step report's allocator peak (MiB)
        self._hbm_peaks: dict = {}
        self._hbm_lock = threading.Lock()

    def attach(self, speed_monitor=None, job_manager=None) -> None:
        # wired once during master construction, before start() spawns
        # the report loop: the loop thread only ever reads these
        self._speed_monitor = speed_monitor
        self._job_manager = job_manager

    # -- ingest (called from the servicer path) -------------------------
    def collect_node_stats(self, stats: msg.NodeResourceStats) -> None:
        hbm = 0.0
        # duty_cycle_pct = -1.0 means the sender could not derive one
        # (first export, no step context) — averaging the sentinel in
        # would hand the brain a fabricated "idle" reading
        known = [c.duty_cycle_pct for c in stats.chip_stats
                 if c.duty_cycle_pct >= 0.0]
        duty = sum(known) / len(known) if known else -1.0
        if stats.chip_stats:
            hbm = sum(c.hbm_used_mb for c in stats.chip_stats)
        self.stats.add_node_sample(
            stats.node_type or NodeType.WORKER, stats.node_id,
            NodeSample(
                timestamp=time.time(),
                cpu_percent=stats.cpu_percent,
                memory_mb=stats.memory_mb,
                chip_duty_cycle_pct=duty,
                hbm_used_mb=hbm,
            ),
        )

    def observe_hbm_peak(self, rank: int, peak_mb: float) -> None:
        """A step report's allocator peak for ``rank``."""
        with self._hbm_lock:
            self._hbm_peaks[rank] = float(peak_mb)

    def collect_model_info(self, info: msg.ModelInfo) -> None:
        if not self._model_reported:
            self._reporter.report("model", {
                "job": self._job_name,
                "param_count": info.param_count,
                "param_bytes": info.param_bytes,
                "flops_per_step": info.flops_per_step,
                "batch_size": info.batch_size,
                "seq_len": info.seq_len,
            })
            self._model_reported = True

    def report_job_meta(self, **meta) -> None:
        self._reporter.report("job_meta", {"job": self._job_name, **meta})

    def report_job_exit(self, stage: str, reason: str = "") -> None:
        self._reporter.report("job_exit", {
            "job": self._job_name, "stage": stage, "reason": reason,
        })

    # -- periodic runtime reporting -------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metric-collector")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        while not self._stopped.wait(self._interval_s):
            self.report_runtime()

    def report_runtime(self) -> None:
        """One runtime record now (the loop's, every ``interval_s``)."""
        self._reporter.report("runtime", self._runtime_payload())

    def _runtime_payload(self) -> dict:
        payload = {"job": self._job_name}
        if self._speed_monitor is not None:
            payload["global_step"] = (
                self._speed_monitor.completed_global_step)
            payload["steps_per_sec"] = self._speed_monitor.running_speed()
        if self._job_manager is not None:
            payload["running_workers"] = len(
                self._job_manager.get_running_workers())
        # Per-node aggregates so the brain's algorithms (hot-host, OOM
        # sizing) see the fields they key on.
        peak = self.stats.max_node_usage(NodeType.WORKER)
        if peak["memory_mb"]:
            payload["peak_memory_mb"] = peak["memory_mb"]
        with self._hbm_lock:
            hbm = max(self._hbm_peaks.values(), default=-1.0)
        if hbm >= 0.0:
            payload["hbm_peak_mb"] = hbm
        latest = [
            s for s in (
                self.stats.latest_node_sample(NodeType.WORKER, node_id)
                for node_id in self.stats.node_ids(NodeType.WORKER))
            if s is not None
        ]
        if latest:
            payload["cpu_percent"] = max(s.cpu_percent for s in latest)
            known = [s.chip_duty_cycle_pct for s in latest
                     if s.chip_duty_cycle_pct >= 0.0]
            if known:
                # omitted entirely when no node has derived one yet —
                # the brain's hot-host rule must read "unknown", not 0%
                payload["chip_duty_cycle_pct"] = sum(known) / len(known)
        return payload
