"""Brain client, and the brain-backed stats reporter and resource
optimizer.

Own copy of the JAX package's ``brain/client.py``, after BrainClient
(dlrover/python/brain/client.py:63) and the brain variant of
JobResourceOptimizer (master/resource/job.py): what the master uses when
``optimize_mode`` is ``cluster`` with a brain address.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import MasterStub, build_channel
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource
from dlrover_tpu_torch.master.resource.optimizer import (
    ResourceOptimizer,
    ResourcePlan,
)
from dlrover_tpu_torch.master.resource.stats_collector import RuntimeStatsCollector
from dlrover_tpu_torch.master.stats.reporter import StatsReporter


class BrainClient:
    # Finite deadline on every call: the brain is advisory, and a dead
    # brain must never hang the master (especially JobMaster.stop(), which
    # reports job-exit synchronously).
    def __init__(self, addr: str, timeout_s: float = 10.0):
        self._stub = MasterStub(build_channel(addr))
        self._timeout_s = timeout_s

    def persist_metrics(self, job_name: str, record_type: str,
                        payload: Dict[str, Any],
                        job_uuid: str = "") -> bool:
        response = msg.deserialize_message(self._stub.report(
            msg.serialize_message(msg.BrainMetricsReport(
                job_name=job_name, job_uuid=job_uuid,
                record_type=record_type,
                payload_json=json.dumps(payload),
            )), timeout=self._timeout_s))
        return bool(getattr(response, "success", False))

    def optimize(self, job_name: str, stage: str,
                 config: Optional[Dict] = None) -> Dict[str, Any]:
        response = msg.deserialize_message(self._stub.get(
            msg.serialize_message(msg.BrainOptimizeRequest(
                job_name=job_name, stage=stage,
                config_json=json.dumps(config or {}),
            )), timeout=self._timeout_s))
        if isinstance(response, msg.BrainResourcePlan) and response.found:
            # advisory resource plan, not a world-stamped execution
            # plan: the brain has no epoch/generation to validate, and
            # the auto-scaler re-checks cluster state before acting
            return json.loads(response.plan_json)
        return {}

    def get_job_metrics(self, job_name: str,
                        record_type: str = "") -> list:
        response = msg.deserialize_message(self._stub.get(
            msg.serialize_message(msg.BrainJobMetricsRequest(
                job_name=job_name, record_type=record_type,
            )), timeout=self._timeout_s))
        if isinstance(response, msg.BrainJobMetrics):
            return json.loads(response.records_json)
        return []


class BrainReporter(StatsReporter):
    """StatsReporter that persists into the brain service."""

    def __init__(self, addr: str, job_name: str, job_uuid: str = ""):
        self._client = BrainClient(addr)
        self._job_name = job_name
        self._job_uuid = job_uuid

    def report(self, record_type: str, payload: Dict[str, Any]) -> None:
        try:
            self._client.persist_metrics(self._job_name, record_type,
                                         payload, self._job_uuid)
        except Exception as e:  # noqa: BLE001 - reporting is best-effort
            logger.warning("brain report failed: %s", e)


def _plan_from_json(raw: Dict[str, Any]) -> ResourcePlan:
    plan = ResourcePlan()
    for node_type, fields in (raw.get("node_group_resources") or {}).items():
        plan.node_group_resources[node_type] = NodeGroupResource(
            count=int(fields.get("count", 0)),
            node_resource=NodeResource(
                cpu=float(fields.get("cpu", 0)),
                memory_mb=float(fields.get("memory_mb", 0)),
                chips=int(fields.get("chips", 0)),
                chip_type=fields.get("chip_type", ""),
            ),
        )
    plan.dataloader_workers = int(raw.get("dataloader_workers", 0))
    return plan


class BrainResourceOptimizer(ResourceOptimizer):
    """ResourceOptimizer backed by the brain service, falling back to the
    local optimizer when the brain has no answer (reference:
    JobResourceOptimizer's brain-with-local-fallback, master/resource/job.py)."""

    def __init__(self, addr: str, job_name: str,
                 stats: Optional[RuntimeStatsCollector] = None):
        from dlrover_tpu_torch.master.resource.local_optimizer import (
            LocalResourceOptimizer,
        )

        self._client = BrainClient(addr)
        self._job_name = job_name
        self._local = LocalResourceOptimizer(stats=stats)
        self.stats = self._local.stats

    def generate_plan(self, stage: str,
                      config: Optional[dict] = None) -> ResourcePlan:
        try:
            raw = self._client.optimize(self._job_name, stage, config)
        except Exception as e:  # noqa: BLE001 - brain outage ≠ job outage
            logger.warning("brain optimize failed: %s; using local", e)
            raw = {}
        if raw:
            return _plan_from_json(raw)
        return self._local.generate_plan(stage, config)
