"""K8s pod watcher: watch stream → NodeEvents.

Own copy of the JAX package's ``master/watcher/k8s_watcher.py``, after
PodWatcher (dlrover/python/master/watcher/
k8s_watcher.py:130-193). Event parsing is delegated to the pure
`pod_to_fields` so it unit-tests without a cluster.
"""

from __future__ import annotations

from typing import Iterator, List

from dlrover_tpu_torch.common.constants import NodeEventType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.watcher.base import NodeEvent, NodeWatcher
from dlrover_tpu_torch.scheduler.kubernetes import K8sClient, pod_to_fields

_EVENT_TYPES = {
    "ADDED": NodeEventType.ADDED,
    "MODIFIED": NodeEventType.MODIFIED,
    "DELETED": NodeEventType.DELETED,
}


def _fields_to_node(fields: dict) -> Node:
    node = Node(fields["node_type"], fields["node_id"],
                rank_index=fields["rank_index"], name=fields["name"],
                status=fields["status"])
    node.exit_reason = fields["exit_reason"]
    node.host_addr = fields.get("pod_ip", "")
    return node


class K8sPodWatcher(NodeWatcher):
    def __init__(self, client: K8sClient, job_name: str):
        self._client = client
        self._selector = f"dlrover-tpu/job={job_name}"
        self._stopped = False

    def watch(self) -> Iterator[NodeEvent]:
        while not self._stopped:
            try:
                for raw in self._client.watch_pods(self._selector):
                    if self._stopped:
                        return
                    etype = _EVENT_TYPES.get(raw.get("type", ""))
                    if etype is None:
                        continue
                    fields = pod_to_fields(raw.get("object", {}))
                    if fields["node_id"] < 0:
                        continue
                    yield NodeEvent(etype, _fields_to_node(fields))
            except Exception as e:  # stream drop: relist + rewatch
                logger.warning("pod watch stream error: %s; rewatching", e)

    def list(self) -> List[Node]:
        nodes = []
        for raw in self._client.list_pods(self._selector):
            fields = pod_to_fields(raw)
            if fields["node_id"] >= 0:
                nodes.append(_fields_to_node(fields))
        return nodes

    def stop(self) -> None:
        self._stopped = True
