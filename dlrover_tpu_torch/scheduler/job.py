"""Job/Node argument model: the parsed form of an ElasticJob spec.

Own copy of the JAX package's ``scheduler/job.py``, after
dlrover/python/scheduler/job.py (JobArgs, NodeArgs) and the CRD shape in
dlrover/go/operator/api/v1alpha1/elasticjob_types.go:29-123
(distributionStrategy, optimizeMode, enableDynamicSharding,
replicaSpecs). A replica is a host with ``chips`` attached cards; the
``tpu_topology`` field keeps the JAX package's name so a spec parses the
same in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common.constants import (
    DistributionStrategy,
    NodeType,
    OptimizeMode,
    PlatformType,
)
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource


@dataclass
class NodeArgs:
    """Per-replica-type launch config (reference: scheduler/job.py NodeArgs)."""

    group_resource: NodeGroupResource = field(
        default_factory=NodeGroupResource)
    auto_scale: bool = True
    restart_count: int = 3
    critical: bool = False
    # Scale bounds for elastic types; 0 max ⇒ fixed at group count.
    min_count: int = 0
    max_count: int = 0


@dataclass
class JobArgs:
    """Everything the master needs to run one job on one platform."""

    platform: str = PlatformType.LOCAL
    namespace: str = "default"
    job_name: str = "job"
    node_args: Dict[str, NodeArgs] = field(default_factory=dict)
    distribution_strategy: str = DistributionStrategy.ALLREDUCE
    optimize_mode: str = OptimizeMode.SINGLE_JOB
    enable_dynamic_sharding: bool = True
    enable_elastic_scheduling: bool = True
    relaunch_always: bool = False      # relaunch even on app error
    remove_exited_node: bool = True
    cluster: str = ""
    user: str = ""
    job_uuid: str = ""
    # slice topology requested for worker hosts (the JAX package's field;
    # the local platform ignores it)
    tpu_topology: str = ""
    image: str = ""
    command: str = ""
    # Arbitrary platform passthrough (tolerations, node selectors, ...).
    extras: Dict[str, Any] = field(default_factory=dict)

    def worker_args(self) -> Optional[NodeArgs]:
        return self.node_args.get(NodeType.WORKER)

    @classmethod
    def from_spec(cls, spec: Dict[str, Any], job_name: str = "",
                  namespace: str = "default",
                  platform: str = PlatformType.LOCAL) -> "JobArgs":
        """Parse an ElasticJob-shaped dict (the CRD `spec` field; reference:
        K8sJobArgs.initilize, scheduler/kubernetes.py:360-441)."""
        args = cls(platform=platform, namespace=namespace,
                   job_name=job_name or spec.get("jobName", "job"))
        args.distribution_strategy = spec.get(
            "distributionStrategy", DistributionStrategy.ALLREDUCE)
        args.optimize_mode = spec.get("optimizeMode", OptimizeMode.SINGLE_JOB)
        args.enable_dynamic_sharding = spec.get("enableDynamicSharding", True)
        args.enable_elastic_scheduling = spec.get(
            "enableElasticScheduling", True)
        args.tpu_topology = spec.get("tpuTopology", "")
        args.image = spec.get("image", "")
        args.command = spec.get("command", "")
        for node_type, replica in spec.get("replicaSpecs", {}).items():
            if node_type not in (NodeType.WORKER, NodeType.PS,
                                 NodeType.CHIEF, NodeType.EVALUATOR):
                continue
            res = replica.get("resource", {})
            group = NodeGroupResource(
                count=int(replica.get("replicas", 0)),
                node_resource=NodeResource(
                    cpu=float(res.get("cpu", 0)),
                    memory_mb=float(res.get("memoryMb", 0)),
                    chips=int(res.get("chips", 0)),
                    chip_type=res.get("chipType", ""),
                    priority=res.get("priority", ""),
                ),
            )
            args.node_args[node_type] = NodeArgs(
                group_resource=group,
                auto_scale=bool(replica.get("autoScale", True)),
                restart_count=int(replica.get("restartCount", 3)),
                critical=bool(replica.get(
                    "critical", node_type == NodeType.PS)),
                min_count=int(replica.get("minReplicas", 0)),
                max_count=int(replica.get("maxReplicas", 0)),
            )
        return args
