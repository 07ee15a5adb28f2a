"""Watcher over the in-memory LocalCluster.

Own copy of the JAX package's ``master/watcher/local_watcher.py``, the
local analog of PodWatcher (dlrover/python/master/watcher/
k8s_watcher.py:130-193): subscribes to the cluster's event stream and
converts PodRecords to NodeEvents.
"""

from __future__ import annotations

import queue
from typing import Iterator, List, Optional

from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.watcher.base import NodeEvent, NodeWatcher
from dlrover_tpu_torch.scheduler.local import LocalCluster, PodRecord


def _pod_to_node(pod: PodRecord) -> Node:
    node = Node(pod.node_type, pod.node_id, rank_index=pod.rank_index,
                name=pod.name, status=pod.status)
    node.exit_reason = pod.exit_reason
    return node


class LocalNodeWatcher(NodeWatcher):
    def __init__(self, cluster: LocalCluster, job_name: str = ""):
        self._cluster = cluster
        self._job_name = job_name
        self._queue: Optional["queue.Queue"] = None
        self._stopped = False

    def prime(self) -> None:
        if self._queue is None:
            self._queue = self._cluster.subscribe()

    def watch(self) -> Iterator[NodeEvent]:
        self.prime()
        while not self._stopped:
            try:
                event = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            yield NodeEvent(event.event_type, _pod_to_node(event.pod))

    def list(self) -> List[Node]:
        return [_pod_to_node(p) for p in self._cluster.list_pods()]

    def stop(self) -> None:
        self._stopped = True
        if self._queue is not None:
            self._cluster.unsubscribe(self._queue)
