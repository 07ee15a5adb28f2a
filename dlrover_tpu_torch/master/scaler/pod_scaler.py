"""K8s pod scaler: ScalePlan → pod create/delete with retry queue.

Own copy of the JAX package's ``master/scaler/pod_scaler.py``, after
PodScaler (dlrover/python/master/scaler/
pod_scaler.py:130,325,352) — a background thread drains a creation queue so
transient API errors retry, pods carry the framework env contract, and
scale-down removes the highest ranks first.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.scaler.base import ScalePlan, Scaler
from dlrover_tpu_torch.scheduler.kubernetes import (
    K8sClient,
    build_pod_manifest,
    pod_to_fields,
)


class PodScaler(Scaler):
    def __init__(
        self,
        job_name: str,
        client: K8sClient,
        master_addr: str,
        image: str = "",
        command: str = "",
        owner_ref: Optional[Dict] = None,
        retry_interval_s: float = 3.0,
    ):
        super().__init__(job_name)
        self._client = client
        self._master_addr = master_addr
        self._image = image
        self._command = command
        self._owner_ref = owner_ref
        self._retry_interval_s = retry_interval_s
        self._create_queue: "queue.Queue[Node]" = queue.Queue()
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._node_num: Dict[str, int] = {}

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._periodic_create_pod, daemon=True,
            name="pod-creater")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _periodic_create_pod(self) -> None:
        """Drain the creation queue; failed creates are re-queued
        (reference: _periodic_create_pod, pod_scaler.py:325)."""
        while not self._stopped.is_set():
            try:
                node = self._create_queue.get(timeout=1.0)
            except queue.Empty:
                continue
            manifest = build_pod_manifest(
                job_name=self.job_name,
                node_type=node.type,
                node_id=node.id,
                rank_index=node.rank_index,
                image=self._image,
                command=self._command,
                master_addr=self._master_addr,
                node_num=self._node_num.get(node.type, node.rank_index + 1),
                resource=node.config_resource,
                owner_ref=self._owner_ref,
            )
            if not self._client.create_pod(manifest):
                logger.warning("pod create failed for %s; will retry",
                               node.name)
                time.sleep(self._retry_interval_s)
                self._create_queue.put(node)

    def scale(self, plan: ScalePlan) -> None:
        for node in plan.remove_nodes:
            self._client.delete_pod(node.name)
        for node_type, group in plan.node_group_resources.items():
            self._node_num[node_type] = group.count
            live = []
            for raw in self._client.list_pods(
                    f"dlrover-tpu/job={self.job_name},"
                    f"dlrover-tpu/type={node_type}"):
                fields = pod_to_fields(raw)
                if fields["status"] in (NodeStatus.PENDING,
                                        NodeStatus.RUNNING):
                    live.append(fields)
            delta = group.count - len(live)
            if delta > 0:
                ranks = self.fill_rank_holes(
                    (f["rank_index"] for f in live), group.count, delta)
                for rank in ranks:
                    node = Node(node_type, self.alloc_id(node_type),
                                rank_index=rank,
                                config_resource=group.node_resource)
                    self._create_queue.put(node)
            elif delta < 0:
                for fields in sorted(
                        live, key=lambda f: -f["rank_index"])[:(-delta)]:
                    self._client.delete_pod(fields["name"])
        for node in plan.launch_nodes:
            self.register_existing(node.type, node.id + 1)
            self._create_queue.put(node)
