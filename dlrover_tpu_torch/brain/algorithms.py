"""Brain optimizer algorithms.

Own copy of the JAX package's ``brain/algorithms.py``, after
dlrover/go/brain/pkg/optimizer/implementation/optalgorithm/: each
algorithm maps (stage, job config, stored records) to a resource plan.

- ``optimize_job_create_resource``: the cold-start worker shape, the
  median of recently completed jobs whose model is within 2x of this
  one's (optimize_job_ps_create_resource.go, over hosts with cards).
- ``optimize_job_oom_resource``: memory sized from the job's own peak
  (optimize_job_worker_create_oom_resource.go).
- ``optimize_job_hot_host``: hosts with pegged CPUs and idle cards ask
  for more dataloader workers (optimize_job_hot_ps_resource.go); its
  thresholds are the local optimizer's (``master/resource/
  local_optimizer.py``).
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.brain.datastore import MetricsStore

Plan = Dict[str, Any]


def optimize_job_create_resource(store: MetricsStore,
                                 job_name: str,
                                 config: Optional[Dict] = None) -> Plan:
    """Cold-start plan: median worker shape of recently-completed jobs
    whose model size is within 2× of this job's (if model info known)."""
    config = config or {}
    history = store.completed_jobs()
    if not history:
        return {}
    param_count = float(config.get("param_count", 0))
    counts: List[int] = []
    cpus: List[float] = []
    mems: List[float] = []
    chips: List[int] = []
    for name in history:
        model = store.query(job_name=name, record_type="model", limit=1)
        if param_count and model:
            other = float(model[0]["payload"].get("param_count", 0))
            if other and not (0.5 <= other / param_count <= 2.0):
                continue
        meta = store.query(job_name=name, record_type="job_meta", limit=1)
        if not meta:
            continue
        payload = meta[0]["payload"]
        if payload.get("worker_count"):
            counts.append(int(payload["worker_count"]))
        if payload.get("cpu"):
            cpus.append(float(payload["cpu"]))
        if payload.get("memory_mb"):
            mems.append(float(payload["memory_mb"]))
        if payload.get("chips"):
            chips.append(int(payload["chips"]))
    if not counts:
        return {}
    plan: Plan = {"node_group_resources": {"worker": {
        "count": int(statistics.median(counts)),
    }}}
    resource = plan["node_group_resources"]["worker"]
    if cpus:
        resource["cpu"] = statistics.median(cpus)
    if mems:
        resource["memory_mb"] = statistics.median(mems)
    if chips:
        resource["chips"] = int(statistics.median(chips))
    return plan


def optimize_job_oom_resource(store: MetricsStore, job_name: str,
                              config: Optional[Dict] = None) -> Plan:
    """OOM recovery: size memory to observed peak × 1.8 (at least 1.5× the
    current config)."""
    config = config or {}
    current = float(config.get("memory_mb", 0))
    peak = 0.0
    for record in store.query(job_name=job_name, record_type="runtime",
                              limit=200):
        peak = max(peak, float(record["payload"].get("peak_memory_mb", 0)))
    target = max(peak * 1.8, current * 1.5)
    if target <= 0:
        return {}
    return {"node_group_resources": {"worker": {
        "count": 0, "memory_mb": target,
    }}}


def optimize_job_hot_host(store: MetricsStore, job_name: str,
                          config: Optional[Dict] = None) -> Plan:
    """Hosts with pegged CPU and idle chips → more dataloader parallelism
    (and more host CPU if spec allows)."""
    from dlrover_tpu_torch.master.resource.local_optimizer import (
        HOT_HOST_CPU_PCT,
        IDLE_CHIP_DUTY_PCT,
    )

    hot = 0
    total = 0
    for record in store.query(job_name=job_name, record_type="runtime",
                              limit=50):
        payload = record["payload"]
        if "cpu_percent" not in payload:
            continue
        total += 1
        if (payload.get("cpu_percent", 0) >= HOT_HOST_CPU_PCT
                and payload.get("chip_duty_cycle_pct", 100)
                < IDLE_CHIP_DUTY_PCT):
            hot += 1
    if total and hot / total >= 0.3:
        return {"dataloader_workers": 2}
    return {}


ALGORITHMS = {
    "job-create": optimize_job_create_resource,
    "oom-recovery": optimize_job_oom_resource,
    "running": optimize_job_hot_host,
}


def run_algorithm(stage: str, store: MetricsStore, job_name: str,
                  config: Optional[Dict] = None) -> Plan:
    algo = ALGORITHMS.get(stage)
    if algo is None:
        return {}
    return algo(store, job_name, config)
