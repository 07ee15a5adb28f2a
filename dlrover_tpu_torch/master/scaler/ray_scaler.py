"""Scaler actuating ScalePlans as Ray agent actors.

Own copy of the JAX package's ``master/scaler/ray_scaler.py``, after the
reference's ray path: RayClient/RayElasticJob
(dlrover/python/scheduler/ray.py:51,147) actuated from the master, with
TFRayWorker-style actors (trainer/worker/tf_ray_worker.py) playing the
node role. Each "node" is one ElasticAgent actor that joins the master
rendezvous exactly like a pod-hosted agent.
"""

from __future__ import annotations

import shlex
from typing import Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.scaler.base import ScalePlan, Scaler
from dlrover_tpu_torch.scheduler.ray import RayClient


class RayScaler(Scaler):
    def __init__(self, job_name: str, client: RayClient,
                 master_addr: str = "", command: str = ""):
        super().__init__(job_name)
        self._client = client
        self._master_addr = master_addr
        self._command = command

    def _entrypoint(self, node: Node):
        if not self._command:
            raise ValueError(
                "ray platform needs the job command (JobArgs.command) to "
                "build the agent entrypoint")
        return shlex.split(self._command)

    def _create(self, node: Node) -> None:
        self.register_existing(node.type, node.id + 1)
        self._client.create_agent_actor(
            node_type=node.type,
            node_id=node.id,
            rank_index=node.rank_index,
            master_addr=self._master_addr,
            entrypoint=self._entrypoint(node),
            num_cpus=node.config_resource.cpu or 1.0,
        )

    def scale(self, plan: ScalePlan) -> None:
        for node in plan.remove_nodes:
            logger.info("ray scaler: removing %s", node.name)
            self._client.delete_actor(node.name)
        group_total: Optional[int] = None
        for node_type, group in plan.node_group_resources.items():
            existing = [h for h in self._client.list_actors()
                        if h.node_type == node_type]
            group_total = group.count
            delta = group.count - len(existing)
            if delta > 0:
                ranks = self.fill_rank_holes(
                    (h.rank_index for h in existing), group.count, delta)
                for rank in ranks:
                    self._create(Node(
                        node_type, self.alloc_id(node_type),
                        rank_index=rank,
                        config_resource=group.node_resource))
            elif delta < 0:
                doomed = sorted(existing,
                                key=lambda h: -h.rank_index)[:(-delta)]
                for handle in doomed:
                    logger.info("ray scaler: scaling down %s", handle.name)
                    self._client.delete_actor(handle.name)
        for node in plan.launch_nodes:
            self._create(node)
