"""Resource plan model + optimizer interface.

Own copy of the JAX package's ``master/resource/optimizer.py``, after
dlrover/python/master/resource/optimizer.py (ResourcePlan :48,
ResourceOptimizer :134): stage-based plans (job-create / node-initial /
running / OOM recovery) produced per job, consumed by the auto-scaler.
Node resources are host CPU and memory plus attached cards; "hot PS CPU"
maps to hot-host (input-bound) detection.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, Optional

from dlrover_tpu_torch.common.node import NodeGroupResource


class OptimizeStage:
    JOB_CREATE = "job-create"       # cold start: before any node runs
    NODE_INITIAL = "node-initial"   # first nodes running, little history
    RUNNING = "running"             # steady state
    OOM_RECOVERY = "oom-recovery"


@dataclass
class ResourceLimits:
    """Upper bounds from the job spec (CRD resourceLimits)."""

    max_nodes: int = 0
    max_cpu: float = 0.0
    max_memory_mb: float = 0.0
    max_chips: int = 0


@dataclass
class ResourcePlan:
    """Target group resources per node type + optional tuned runtime knobs."""

    node_group_resources: Dict[str, NodeGroupResource] = field(
        default_factory=dict)
    # Tuned worker-process knobs (forwarded as ParallelConfig).
    dataloader_batch_size: int = 0
    dataloader_workers: int = 0

    def empty(self) -> bool:
        return not self.node_group_resources

    def limit(self, limits: ResourceLimits) -> "ResourcePlan":
        for group in self.node_group_resources.values():
            if limits.max_cpu:
                group.node_resource.cpu = min(group.node_resource.cpu,
                                              limits.max_cpu)
            if limits.max_memory_mb:
                group.node_resource.memory_mb = min(
                    group.node_resource.memory_mb, limits.max_memory_mb)
            if limits.max_chips:
                group.node_resource.chips = min(group.node_resource.chips,
                                                limits.max_chips)
            if limits.max_nodes:
                group.count = min(group.count, limits.max_nodes)
        return self


class ResourceOptimizer(abc.ABC):
    """Produces plans from observed stats (reference: ResourceOptimizer
    base; implementations: PSLocalOptimizer, BrainOptimizer)."""

    @abc.abstractmethod
    def generate_plan(self, stage: str,
                      config: Optional[dict] = None) -> ResourcePlan:
        ...

    def generate_oom_recovery_plan(self, node_type: str,
                                   current_memory_mb: float) -> ResourcePlan:
        plan = ResourcePlan()
        group = NodeGroupResource()
        group.node_resource.memory_mb = current_memory_mb * 1.5
        plan.node_group_resources[node_type] = group
        return plan
