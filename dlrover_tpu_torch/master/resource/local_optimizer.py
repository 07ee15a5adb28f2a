"""Single-job local resource optimizer.

Own copy of the JAX package's ``master/resource/local_optimizer.py``,
after PSLocalOptimizer (dlrover/python/master/resource/
local_optimizer.py:66) for allreduce jobs:
- JOB_CREATE: cold-start plan from job config (or defaults).
- NODE_INITIAL: right-size host cpu/mem from first observed usage.
- RUNNING: pick the worker count with the best marginal throughput
  (reference ``_generate_worker_resoruce`` :189 uses the speed ratio),
  and detect input-bound "hot hosts" (reference ``_optimize_hot_ps_cpu``
  :299): hosts whose CPU is saturated while the cards idle get more
  dataloader workers.
- OOM_RECOVERY: inherited 1.5× memory bump.
"""

from __future__ import annotations

from typing import Optional

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
from dlrover_tpu_torch.master.resource.optimizer import (
    OptimizeStage,
    ResourceOptimizer,
    ResourcePlan,
)
from dlrover_tpu_torch.master.resource.stats_collector import RuntimeStatsCollector

# Sizing margins (reference uses 1.2-1.5 factors for cpu/mem headroom).
_CPU_HEADROOM = 1.25
_MEM_HEADROOM = 1.4
# Hot-host (input-bound) thresholds — shared with the brain's
# optimize_job_hot_host so the two detectors cannot diverge.
HOT_HOST_CPU_PCT = 90.0
IDLE_CHIP_DUTY_PCT = 50.0


class LocalResourceOptimizer(ResourceOptimizer):
    def __init__(self, stats: Optional[RuntimeStatsCollector] = None,
                 scale_unit: int = 1):
        self.stats = stats or RuntimeStatsCollector()
        # worker-count deltas must respect slice granularity (hosts per
        # slice), the analog of the reference's node_unit rounding
        self._scale_unit = max(1, scale_unit)
        # counts whose marginal throughput gain failed the efficiency gate;
        # never explored again (prevents a grow/shrink oscillation)
        self._rejected_counts: set = set()

    def generate_plan(self, stage: str,
                      config: Optional[dict] = None) -> ResourcePlan:
        config = config or {}
        if stage == OptimizeStage.JOB_CREATE:
            return self._job_create_plan(config)
        if stage == OptimizeStage.NODE_INITIAL:
            return self._node_initial_plan(config)
        if stage == OptimizeStage.RUNNING:
            return self._running_plan(config)
        return ResourcePlan()

    # -- stages --------------------------------------------------------
    def _job_create_plan(self, config: dict) -> ResourcePlan:
        plan = ResourcePlan()
        count = int(config.get("worker_count", 0))
        if count:
            plan.node_group_resources[NodeType.WORKER] = NodeGroupResource(
                count=count,
                node_resource=NodeResource(
                    cpu=float(config.get("cpu", 8)),
                    memory_mb=float(config.get("memory_mb", 16384)),
                    chips=int(config.get("chips", 4)),
                    chip_type=config.get("chip_type", ""),
                ),
            )
        return plan

    def _node_initial_plan(self, config: dict) -> ResourcePlan:
        peak = self.stats.max_node_usage(NodeType.WORKER)
        plan = ResourcePlan()
        if peak["memory_mb"] <= 0:
            return plan
        current = config.get("current", NodeResource())
        group = NodeGroupResource(
            count=0,  # 0 = keep count; only resize the shape
            node_resource=NodeResource(
                cpu=max(current.cpu,
                        peak["cpu_percent"] / 100.0 * _CPU_HEADROOM
                        * max(current.cpu, 1)),
                memory_mb=peak["memory_mb"] * _MEM_HEADROOM,
                chips=current.chips,
                chip_type=current.chip_type,
            ),
        )
        plan.node_group_resources[NodeType.WORKER] = group
        return plan

    def _running_plan(self, config: dict) -> ResourcePlan:
        plan = ResourcePlan()
        speeds = self.stats.speed_by_worker_count()
        current_count = int(config.get("worker_count", 0))
        max_count = int(config.get("max_worker_count", current_count))
        if speeds and current_count:
            target = self._best_worker_count(speeds, current_count,
                                             max_count)
            if target != current_count:
                plan.node_group_resources[NodeType.WORKER] = (
                    NodeGroupResource(count=target))
        self._tune_hot_hosts(plan)
        return plan

    def _best_worker_count(self, speeds: dict, current: int,
                           max_count: int) -> int:
        """Grow while marginal scaling efficiency stays above 50%
        (reference: worker count from speed ratio,
        local_optimizer.py:189-243). Speed 0 (startup / compilation) is
        treated as "no data", never as a shrink signal — stall handling
        belongs to hang detection, not the auto-scaler."""
        base_speed = speeds.get(current, 0.0)
        if base_speed <= 0:
            return current
        smaller = current - self._scale_unit
        threshold = 1 + 0.5 * self._scale_unit / max(smaller, 1)
        if smaller in speeds and speeds[smaller] > 0:
            # we grew into `current` earlier; verify the growth paid off,
            # otherwise shrink back and blacklist this count
            if base_speed <= speeds[smaller] * threshold:
                self._rejected_counts.add(current)
                return smaller
        grown = current + self._scale_unit
        if grown > max_count or grown in self._rejected_counts:
            return current
        if grown in speeds and speeds[grown] > 0:
            gate = 1 + 0.5 * self._scale_unit / current
            if speeds[grown] > base_speed * gate:
                return grown
            self._rejected_counts.add(grown)
            return current
        # unobserved: one exploration step (a failed step is shrunk back
        # and blacklisted on the next round)
        return grown

    def _tune_hot_hosts(self, plan: ResourcePlan) -> None:
        """Input-bound host: CPU pegged while chips idle ⇒ raise dataloader
        parallelism (the analog of the hot-PS CPU fix)."""
        hot = 0
        for node_id in self.stats.node_ids(NodeType.WORKER):
            sample = self.stats.latest_node_sample(NodeType.WORKER, node_id)
            if (sample and sample.cpu_percent >= HOT_HOST_CPU_PCT
                    and 0 < sample.chip_duty_cycle_pct
                    < IDLE_CHIP_DUTY_PCT):
                hot += 1
        if hot:
            logger.info("detected %d input-bound (hot) hosts", hot)
            plan.dataloader_workers = 2  # signal: double dataloader workers
