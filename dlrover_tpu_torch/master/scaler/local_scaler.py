"""Scaler against the in-memory LocalCluster.

Own copy of the JAX package's ``master/scaler/local_scaler.py``, the
local analog of PodScaler (master/scaler/pod_scaler.py:130): creates and
deletes PodRecords carrying the env contract the k8s path injects into
containers.
"""

from __future__ import annotations

from typing import Optional

from dlrover_tpu_torch.common.constants import NodeEnv, NodeStatus
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.scaler.base import ScalePlan, Scaler
from dlrover_tpu_torch.scheduler.local import LocalCluster, PodRecord


class LocalScaler(Scaler):
    def __init__(self, job_name: str, cluster: LocalCluster,
                 master_addr: str = ""):
        super().__init__(job_name)
        self._cluster = cluster
        self._master_addr = master_addr

    def _create(self, node: Node, node_num: int) -> None:
        self.register_existing(node.type, node.id + 1)
        pod = PodRecord(
            name=node.name,
            node_type=node.type,
            node_id=node.id,
            rank_index=node.rank_index,
            status=NodeStatus.PENDING,
            env={
                NodeEnv.MASTER_ADDR: self._master_addr,
                NodeEnv.NODE_ID: str(node.id),
                NodeEnv.NODE_RANK: str(node.rank_index),
                NodeEnv.NODE_NUM: str(node_num),
                NodeEnv.JOB_NAME: self.job_name,
            },
            resource=node.config_resource.to_dict(),
        )
        self._cluster.create_pod(pod)

    def scale(self, plan: ScalePlan) -> None:
        for node in plan.remove_nodes:
            logger.info("scaler: removing %s", node.name)
            self._cluster.delete_pod(node.name)
        group_total: Optional[int] = None
        for node_type, group in plan.node_group_resources.items():
            existing = [p for p in self._cluster.list_pods(node_type)
                        if p.status not in
                        (NodeStatus.FAILED, NodeStatus.DELETED,
                         NodeStatus.SUCCEEDED)]
            group_total = group.count
            delta = group.count - len(existing)
            if delta > 0:
                ranks = self.fill_rank_holes(
                    (p.rank_index for p in existing), group.count, delta)
                for rank in ranks:
                    node = Node(node_type, self.alloc_id(node_type),
                                rank_index=rank,
                                config_resource=group.node_resource)
                    self._create(node, group.count)
            elif delta < 0:
                # remove highest-rank pods first (keeps ranks contiguous)
                doomed = sorted(existing, key=lambda p: -p.rank_index)[:(-delta)]
                for pod in doomed:
                    logger.info("scaler: scaling down %s", pod.name)
                    self._cluster.delete_pod(pod.name)
        for node in plan.launch_nodes:
            self._create(node, group_total or (node.rank_index + 1))
