"""Watcher over Ray agent actors.

Own copy of the JAX package's ``master/watcher/ray_watcher.py``, after
dlrover/python/master/watcher/ray_watcher.py: actor
liveness/exit mapped to the same NodeEvents the pod watcher emits, by
polling actor futures (Ray has no pod-style watch stream)."""

from __future__ import annotations

import time
from typing import Dict, Iterator, List

from dlrover_tpu_torch.common.constants import NodeStatus
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.watcher.base import NodeEvent, NodeWatcher
from dlrover_tpu_torch.scheduler.ray import RayClient


class RayNodeWatcher(NodeWatcher):
    def __init__(self, client: RayClient, job_name: str = "",
                 poll_interval_s: float = 1.0):
        self._client = client
        self._job_name = job_name
        self._interval_s = poll_interval_s
        self._stopped = False
        self._last: Dict[str, str] = {}

    def _nodes(self) -> List[Node]:
        nodes = []
        for handle in self._client.list_actors():
            status = self._client.actor_status(handle.name)
            node = Node(handle.node_type, handle.node_id,
                        rank_index=handle.rank_index, name=handle.name,
                        status=status)
            nodes.append(node)
        return nodes

    def watch(self) -> Iterator[NodeEvent]:
        while not self._stopped:
            seen = set()
            for node in self._nodes():
                seen.add(node.name)
                previous = self._last.get(node.name)
                if previous != node.status:
                    self._last[node.name] = node.status
                    kind = "ADDED" if previous is None else "MODIFIED"
                    yield NodeEvent(kind, node)
            for name in list(self._last):
                if name not in seen:
                    node_type, _, node_id = name.rpartition("-")
                    node = Node(node_type, int(node_id), name=name,
                                status=NodeStatus.DELETED)
                    del self._last[name]
                    yield NodeEvent("DELETED", node)
            time.sleep(self._interval_s)

    def list(self) -> List[Node]:
        return self._nodes()

    def stop(self) -> None:
        self._stopped = True
