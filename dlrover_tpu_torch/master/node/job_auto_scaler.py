"""Periodic optimize → plan → scale loop.

Own copy of the JAX package's ``master/node/job_auto_scaler.py``, after
JobAutoScaler (dlrover/python/master/node/job_auto_scaler.py:73;
AllreduceTrainingAutoScaler :254): wakes every ``interval_s``, asks the
optimizer for a running-stage plan, converts it to a ScalePlan within
spec limits, and actuates through the job manager. OOM relaunch resizing
is handled inline by the job manager; this loop owns throughput-driven
worker-count changes and hot-host tuning, whose knobs it publishes
through ``paral_config_sink`` (the servicer's ``merge_paral_config``).
"""

from __future__ import annotations

import threading
from typing import Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import NodeGroupResource
from dlrover_tpu_torch.master.resource.optimizer import (
    OptimizeStage,
    ResourceLimits,
    ResourceOptimizer,
)
from dlrover_tpu_torch.master.scaler.base import ScalePlan


class JobAutoScaler:
    def __init__(
        self,
        job_manager,
        optimizer: ResourceOptimizer,
        speed_monitor=None,
        limits: Optional[ResourceLimits] = None,
        interval_s: float = 60.0,
    ):
        self._job_manager = job_manager
        self._optimizer = optimizer
        self._speed_monitor = speed_monitor
        self._limits = limits or ResourceLimits()
        self._interval_s = interval_s
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the tuned-knob compare-and-publish runs on the scaler thread
        # and from direct execute_job_optimization() callers
        self._tuned_lock = threading.Lock()
        self.paral_config_version = 0
        self.suggested_dataloader_workers = 0
        # callable(**fields) merging tuned knobs into the published config
        # (wired to MasterServicer.merge_paral_config)
        self.paral_config_sink = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="auto-scaler")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        while not self._stopped.wait(self._interval_s):
            try:
                self.execute_job_optimization()
            except Exception as e:  # noqa: BLE001 - loop must survive
                logger.error("auto-scale round failed: %s", e)

    # -- one optimization round ----------------------------------------
    def execute_job_optimization(self) -> Optional[ScalePlan]:
        """One optimize → plan → actuate round, timed as a
        `scale_decision` span (outcome attr: noop / tuned / scaled)."""
        with obs.span("scale_decision") as decision:
            plan = self._execute_job_optimization(decision)
        outcome = decision.attrs.get("outcome", "noop")
        obs.get_registry().counter(
            "dlrover_tpu_scale_decisions_total",
            "Auto-scaler optimization rounds by outcome",
            labelnames=("outcome",),
        ).labels(outcome=outcome).inc()
        return plan

    def _execute_job_optimization(self, decision) -> Optional[ScalePlan]:
        if self._speed_monitor is not None:
            self._optimizer.stats.add_speed_sample(
                len(self._job_manager.get_running_workers()),
                self._speed_monitor.running_speed(),
            )
        worker_args = self._job_manager.job_args.worker_args()
        if worker_args is None or not worker_args.auto_scale:
            return None
        current = worker_args.group_resource.count
        max_count = worker_args.max_count or self._limits.max_nodes or current
        plan = self._optimizer.generate_plan(
            OptimizeStage.RUNNING,
            {"worker_count": current, "max_worker_count": max_count},
        )
        plan.limit(self._limits)
        with self._tuned_lock:
            tuned = (plan.dataloader_workers
                     and plan.dataloader_workers
                     != self.suggested_dataloader_workers)
            if tuned:
                self.suggested_dataloader_workers = plan.dataloader_workers
                self.paral_config_version += 1
        if tuned:
            decision.set_attr("outcome", "tuned")
            if self.paral_config_sink is not None:
                self.paral_config_sink(
                    dataloader_workers=plan.dataloader_workers,
                    dataloader_batch_size=plan.dataloader_batch_size,
                )
        if plan.empty():
            return None
        scale_plan = ScalePlan()
        for node_type, group in plan.node_group_resources.items():
            if group.count <= 0 or group.count == current:
                continue
            resource = (group.node_resource
                        if group.node_resource.memory_mb
                        else worker_args.group_resource.node_resource)
            scale_plan.node_group_resources[node_type] = NodeGroupResource(
                count=group.count, node_resource=resource)
            if node_type == NodeType.WORKER:
                worker_args.group_resource.count = group.count
        if scale_plan.empty():
            return None
        counts = {t: g.count
                  for t, g in scale_plan.node_group_resources.items()}
        logger.info("auto-scale plan: %s", counts)
        decision.set_attr("outcome", "scaled")
        decision.set_attr("plan", counts)
        obs.get_flight_recorder().record_event("scale_plan", **counts)
        for node_type, group in scale_plan.node_group_resources.items():
            self._job_manager.scale_node_group(node_type, group.count,
                                               group.node_resource)
        return scale_plan
