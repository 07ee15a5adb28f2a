"""Ray platform backend.

Own copy of the JAX package's ``scheduler/ray.py``, after
dlrover/python/scheduler/ray.py (RayClient :51, RayElasticJob :147,
RayJobArgs :171) and the ray client and worker
(dlrover/client/platform/ray/ray_job_submitter.py, trainer/worker/
tf_ray_worker.py). Nodes are Ray actors that run the port's elastic
agent; the master reaches them through the same watcher and scaler
interfaces as pods. Ray is an optional dependency: without it,
construction raises the JAX package's ``RuntimeError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.scheduler.job import JobArgs


def _require_ray():
    try:
        import ray  # noqa: F401

        return ray
    except ImportError as e:
        raise RuntimeError(
            "the ray platform needs the `ray` package (not shipped in "
            "this image); install it or use platform='local'/'k8s'"
        ) from e


class RayActorHandle:
    """One elastic-agent actor (reference: TFRayWorker as an actor)."""

    def __init__(self, actor: Any, node_type: str, node_id: int,
                 rank_index: int):
        self.actor = actor
        self.node_type = node_type
        self.node_id = node_id
        self.rank_index = rank_index
        self.name = f"{node_type}-{node_id}"


class RayClient:
    """Create/destroy agent actors (reference: RayClient,
    scheduler/ray.py:51)."""

    def __init__(self, job_name: str, address: str = "auto"):
        self._ray = _require_ray()
        if not self._ray.is_initialized():
            self._ray.init(address=address, ignore_reinit_error=True)
        self.job_name = job_name
        self._actors: Dict[str, RayActorHandle] = {}

    def create_agent_actor(self, node_type: str, node_id: int,
                           rank_index: int, master_addr: str,
                           entrypoint: List[str],
                           num_cpus: float = 1.0,
                           resources: Optional[dict] = None
                           ) -> RayActorHandle:
        ray = self._ray

        @ray.remote(num_cpus=num_cpus, resources=resources or {})
        class AgentActor:
            def run(self, master_addr, node_id, entrypoint):
                from dlrover_tpu_torch.agent.elastic_agent import (
                    ElasticAgent,
                    WorkerSpec,
                )
                from dlrover_tpu_torch.agent.master_client import MasterClient

                client = MasterClient(master_addr, node_id=node_id,
                                      node_type=node_type)
                agent = ElasticAgent(client,
                                     WorkerSpec(entrypoint=entrypoint))
                return agent.run()

        actor = AgentActor.remote()
        handle = RayActorHandle(actor, node_type, node_id, rank_index)
        handle.future = actor.run.remote(master_addr, node_id, entrypoint)
        self._actors[handle.name] = handle
        logger.info("created ray agent actor %s", handle.name)
        return handle

    def delete_actor(self, name: str) -> bool:
        handle = self._actors.pop(name, None)
        if handle is None:
            return False
        self._ray.kill(handle.actor)
        return True

    def list_actors(self) -> List[RayActorHandle]:
        return list(self._actors.values())

    def actor_status(self, name: str) -> str:
        handle = self._actors.get(name)
        if handle is None:
            return NodeStatus.DELETED
        ready, _ = self._ray.wait([handle.future], timeout=0)
        if not ready:
            return NodeStatus.RUNNING
        try:
            code = self._ray.get(ready[0])
            return (NodeStatus.SUCCEEDED if code == 0
                    else NodeStatus.FAILED)
        except Exception:  # noqa: BLE001 - actor died
            return NodeStatus.FAILED


class RayJobArgs(JobArgs):
    """JobArgs parsed for the ray platform (reference: RayJobArgs :171)."""

    @classmethod
    def from_spec(cls, spec, job_name: str = "", namespace: str = "default",
                  platform: str = "ray"):
        return super().from_spec(spec, job_name=job_name,
                                 namespace=namespace, platform=platform)
