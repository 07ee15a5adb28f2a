"""ElasticJob / ScalePlan custom-resource schemas.

Own copy of the JAX package's ``operator/crd.py``, after the operator API
types —
`dlrover/go/operator/api/v1alpha1/elasticjob_types.go:29-123` (ElasticJobSpec:
distributionStrategy, resourceLimits, optimizeMode, brainService,
enableElasticScheduling, enableDynamicSharding, replicaSpecs, suspend) and
`scaleplan_types.go:29-121` (ScaleSpec: replicaResourceSpecs, createPods,
removePods, migratePods, psHosts, manualScaling) — as plain dataclasses with
manifest (de)serialization. The YAML CRD definitions live in `manifests/`.

A replica's cards are the ``nvidia.com/gpu`` limit and their type the
``cloud.google.com/gke-accelerator`` node selector, where the JAX package
reads ``google.com/tpu`` and the GKE TPU labels; the TPU topology label
has no counterpart (ROADMAP, "Differences kept on purpose").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from dlrover_tpu_torch.common.node import NodeResource
from dlrover_tpu_torch.scheduler.kubernetes import (
    ACCELERATOR_LABEL,
    GPU_RESOURCE,
)

GROUP = "elastic.dlrover-tpu.org"
VERSION = "v1alpha1"
ELASTICJOB_PLURAL = "elasticjobs"
SCALEPLAN_PLURAL = "scaleplans"

_MEMORY_SUFFIXES = {
    "Ki": 1 / 1024, "Mi": 1, "Gi": 1024, "Ti": 1024 * 1024,
    "K": 1e3 / (1 << 20), "M": 1e6 / (1 << 20), "G": 1e9 / (1 << 20),
    "T": 1e12 / (1 << 20),
}


def parse_cpu(value: Any) -> float:
    """k8s cpu quantity → cores ('500m' → 0.5, '8' → 8.0)."""
    text = str(value or 0).strip()
    if not text:
        return 0.0
    if text.endswith("m"):
        return float(text[:-1]) / 1000.0
    return float(text)


def parse_memory_mb(value: Any) -> float:
    """k8s memory quantity → MiB ('32Gi' → 32768, '1G' → ~953.7,
    plain numbers are bytes)."""
    text = str(value or 0).strip()
    if not text:
        return 0.0
    for suffix, factor in sorted(_MEMORY_SUFFIXES.items(),
                                 key=lambda kv: -len(kv[0])):
        if text.endswith(suffix):
            return float(text[:-len(suffix)]) * factor
    return float(text) / (1 << 20)


@dataclasses.dataclass
class ReplicaSpec:
    """One node group (reference: ReplicaSpec in elasticjob_types.go —
    replicas + pod template + RestartCount/Priority extensions)."""

    replicas: int = 0
    min_replicas: int = 0
    max_replicas: int = 0
    restart_count: int = 3
    priority: str = ""
    image: str = ""
    command: str = ""
    resource: NodeResource = dataclasses.field(default_factory=NodeResource)

    @classmethod
    def from_manifest(cls, spec: Dict[str, Any]) -> "ReplicaSpec":
        template = spec.get("template", {})
        pod_spec = template.get("spec", {})
        containers = pod_spec.get("containers", [{}])
        main = containers[0] if containers else {}
        limits = (main.get("resources", {}) or {}).get("limits", {}) or {}
        command = main.get("command") or []
        if isinstance(command, list):
            command = " ".join(command[2:] if command[:2] ==
                               ["/bin/sh", "-c"] else command)
        selector = pod_spec.get("nodeSelector", {}) or {}
        return cls(
            replicas=int(spec.get("replicas", 0)),
            min_replicas=int(spec.get("minReplicas", 0)),
            max_replicas=int(spec.get("maxReplicas", 0)),
            restart_count=int(spec.get("restartCount", 3)),
            priority=spec.get("priority", ""),
            image=main.get("image", ""),
            command=command,
            resource=NodeResource(
                cpu=parse_cpu(limits.get("cpu", 0)),
                memory_mb=parse_memory_mb(limits.get("memory", 0)),
                chips=int(limits.get(GPU_RESOURCE, 0) or 0),
                chip_type=selector.get(ACCELERATOR_LABEL, ""),
            ),
        )

    def to_manifest(self) -> Dict[str, Any]:
        from dlrover_tpu_torch.scheduler.kubernetes import (
            accelerator_node_selector,
            resource_to_limits,
            shell_command,
        )

        limits = resource_to_limits(self.resource)
        selector = accelerator_node_selector(self.resource.chip_type)
        spec: Dict[str, Any] = {
            "replicas": self.replicas,
            "restartCount": self.restart_count,
            "template": {"spec": {
                "containers": [{
                    "name": "main",
                    "image": self.image,
                    "command": shell_command(self.command),
                    "resources": {"limits": limits},
                }],
                "nodeSelector": selector or None,
            }},
        }
        if self.min_replicas:
            spec["minReplicas"] = self.min_replicas
        if self.max_replicas:
            spec["maxReplicas"] = self.max_replicas
        if self.priority:
            spec["priority"] = self.priority
        container = spec["template"]["spec"]["containers"][0]
        spec["template"]["spec"]["containers"] = [
            {k: v for k, v in container.items() if v is not None}]
        spec["template"]["spec"] = {
            k: v for k, v in spec["template"]["spec"].items()
            if v is not None}
        return spec


@dataclasses.dataclass
class ElasticJobSpec:
    """Reference: ElasticJobSpec elasticjob_types.go:29-123."""

    distribution_strategy: str = "AllreduceStrategy"
    optimize_mode: str = "single-job"       # manual | single-job | cluster
    brain_service: str = ""
    enable_elastic_scheduling: bool = True
    enable_dynamic_sharding: bool = True
    suspend: bool = False
    resource_limits: Dict[str, str] = dataclasses.field(default_factory=dict)
    replica_specs: Dict[str, ReplicaSpec] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def from_manifest(cls, spec: Dict[str, Any]) -> "ElasticJobSpec":
        return cls(
            distribution_strategy=spec.get("distributionStrategy",
                                           "AllreduceStrategy"),
            optimize_mode=spec.get("optimizeMode", "single-job"),
            brain_service=spec.get("brainService", ""),
            enable_elastic_scheduling=bool(
                spec.get("enableElasticScheduling", True)),
            enable_dynamic_sharding=bool(
                spec.get("enableDynamicSharding", True)),
            suspend=bool(spec.get("suspend", False)),
            resource_limits=dict(spec.get("resourceLimits", {}) or {}),
            replica_specs={
                name: ReplicaSpec.from_manifest(rs)
                for name, rs in (spec.get("replicaSpecs", {}) or {}).items()
            },
        )

    def to_manifest(self) -> Dict[str, Any]:
        return {
            "distributionStrategy": self.distribution_strategy,
            "optimizeMode": self.optimize_mode,
            "brainService": self.brain_service,
            "enableElasticScheduling": self.enable_elastic_scheduling,
            "enableDynamicSharding": self.enable_dynamic_sharding,
            "suspend": self.suspend,
            "resourceLimits": self.resource_limits,
            "replicaSpecs": {name: rs.to_manifest()
                             for name, rs in self.replica_specs.items()},
        }


@dataclasses.dataclass
class ElasticJob:
    name: str
    namespace: str = "default"
    uid: str = ""
    spec: ElasticJobSpec = dataclasses.field(default_factory=ElasticJobSpec)
    phase: str = "Created"

    @classmethod
    def from_manifest(cls, obj: Dict[str, Any]) -> "ElasticJob":
        meta = obj.get("metadata", {})
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            uid=meta.get("uid", ""),
            spec=ElasticJobSpec.from_manifest(obj.get("spec", {})),
            phase=(obj.get("status", {}) or {}).get("phase", "Created"),
        )

    def to_manifest(self) -> Dict[str, Any]:
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": "ElasticJob",
            "metadata": {"name": self.name, "namespace": self.namespace,
                         **({"uid": self.uid} if self.uid else {})},
            "spec": self.spec.to_manifest(),
            "status": {"phase": self.phase},
        }

    def to_job_args(self):
        """Parsed CR → the master's JobArgs (reference:
        K8sJobArgs.initilize, scheduler/kubernetes.py:360-441 parses the
        CRD into NodeArgs). This is how the k8s-launched master learns
        the job's replica specs."""
        from dlrover_tpu_torch.common.constants import NodeType, PlatformType
        from dlrover_tpu_torch.common.node import NodeGroupResource
        from dlrover_tpu_torch.scheduler.job import JobArgs, NodeArgs

        args = JobArgs(platform=PlatformType.KUBERNETES,
                       namespace=self.namespace, job_name=self.name)
        args.distribution_strategy = self.spec.distribution_strategy
        args.optimize_mode = self.spec.optimize_mode
        args.enable_dynamic_sharding = self.spec.enable_dynamic_sharding
        args.enable_elastic_scheduling = (
            self.spec.enable_elastic_scheduling)
        for node_type, replica in self.spec.replica_specs.items():
            if node_type == "master":
                continue
            args.node_args[node_type] = NodeArgs(
                group_resource=NodeGroupResource(
                    count=replica.replicas,
                    node_resource=replica.resource,
                ),
                restart_count=replica.restart_count,
                critical=node_type == NodeType.PS,
                min_count=replica.min_replicas,
                max_count=replica.max_replicas,
            )
        worker = self.spec.replica_specs.get(NodeType.WORKER)
        if worker is not None:
            args.image = worker.image
            args.command = worker.command
        return args

    def owner_reference(self) -> Dict[str, Any]:
        """Pods owned by the job get garbage-collected with it
        (reference: master/master.go pod construction)."""
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": "ElasticJob",
            "name": self.name,
            "uid": self.uid,
            "controller": True,
            "blockOwnerDeletion": True,
        }


@dataclasses.dataclass
class ScaleSpec:
    """Reference: ScaleSpec scaleplan_types.go:29-121 (replica resource
    specs, explicit create/remove pod lists, migrate, psHosts, manual)."""

    owner_job: str = ""
    replica_resource_specs: Dict[str, int] = dataclasses.field(
        default_factory=dict)            # node type -> replicas
    create_pods: List[str] = dataclasses.field(default_factory=list)
    remove_pods: List[str] = dataclasses.field(default_factory=list)
    ps_hosts: List[str] = dataclasses.field(default_factory=list)
    manual_scaling: bool = True

    @classmethod
    def from_manifest(cls, spec: Dict[str, Any]) -> "ScaleSpec":
        replica_specs = {}
        for name, rs in (spec.get("replicaResourceSpecs", {}) or {}).items():
            if isinstance(rs, dict):
                if "replicas" not in rs:
                    continue    # resource-only entry: nothing to scale
                replica_specs[name] = int(rs["replicas"])
            else:
                replica_specs[name] = int(rs)
        return cls(
            owner_job=spec.get("ownerJob", ""),
            replica_resource_specs=replica_specs,
            create_pods=[p.get("name", "") if isinstance(p, dict) else p
                         for p in spec.get("createPods", []) or []],
            remove_pods=[p.get("name", "") if isinstance(p, dict) else p
                         for p in spec.get("removePods", []) or []],
            ps_hosts=list(spec.get("psHosts", []) or []),
            manual_scaling=bool(spec.get("manualScaling", True)),
        )


@dataclasses.dataclass
class ScalePlan:
    name: str
    namespace: str = "default"
    spec: ScaleSpec = dataclasses.field(default_factory=ScaleSpec)
    phase: str = "Pending"

    @classmethod
    def from_manifest(cls, obj: Dict[str, Any]) -> "ScalePlan":
        meta = obj.get("metadata", {})
        return cls(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            spec=ScaleSpec.from_manifest(obj.get("spec", {})),
            phase=(obj.get("status", {}) or {}).get("phase", "Pending"),
        )
