"""Node model and status state machine.

Own copy of the JAX package's ``common/node.py``, after
dlrover/python/common/node.py (Node/NodeResource/NodeGroupResource) and
dlrover/python/master/node/status_flow.py (NODE_STATE_FLOWS, relaunch
decisions). A node is a host with ``chips`` attached accelerator cards of
``chip_type``; the field names are the JAX package's, so the job
manager's exported state reads the same in both packages.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from dlrover_tpu_torch.common.constants import NodeExitReason, NodeStatus


@dataclass
class NodeResource:
    """Requested/used resources of one node (host)."""

    cpu: float = 0.0
    memory_mb: float = 0.0
    chips: int = 0               # accelerator cards attached to this host
    chip_type: str = ""          # e.g. "v5p", "v5e"
    priority: str = ""

    def to_dict(self):
        return {
            "cpu": self.cpu,
            "memory_mb": self.memory_mb,
            "chips": self.chips,
            "chip_type": self.chip_type,
            "priority": self.priority,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(**d) if d else cls()


@dataclass
class NodeGroupResource:
    """Resource config of a node group (count × per-node resource)."""

    count: int = 0
    node_resource: NodeResource = field(default_factory=NodeResource)

    def update(self, count: Optional[int] = None,
               cpu: Optional[float] = None,
               memory_mb: Optional[float] = None):
        if count is not None and count > 0:
            self.count = count
        if cpu is not None and cpu > 0:
            self.node_resource.cpu = cpu
        if memory_mb is not None and memory_mb > 0:
            self.node_resource.memory_mb = memory_mb


class Node:
    """One training node (host) as seen by the master."""

    def __init__(
        self,
        node_type: str,
        node_id: int,
        rank_index: Optional[int] = None,
        name: str = "",
        status: str = NodeStatus.INITIAL,
        config_resource: Optional[NodeResource] = None,
        critical: bool = False,
        max_relaunch_count: int = 3,
        relaunchable: bool = True,
    ):
        self.type = node_type
        self.id = node_id
        self.rank_index = rank_index if rank_index is not None else node_id
        self.name = name or f"{node_type}-{node_id}"
        self.status = status
        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.critical = critical
        self.relaunchable = relaunchable
        self.max_relaunch_count = max_relaunch_count
        self.relaunch_count = 0
        self.exit_reason = ""
        self.host_addr = ""
        self.host_port = 0
        self.create_time: Optional[float] = None
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.heartbeat_time: float = 0.0
        self.is_released = False
        self.paral_config = None
        self.start_hang_time: float = 0.0

    # -- status transitions ------------------------------------------------
    def update_status(self, status: str) -> None:
        self.status = status
        now = time.time()
        if status == NodeStatus.RUNNING and self.start_time is None:
            self.start_time = now
        if status in NodeStatus.terminal() and self.finish_time is None:
            self.finish_time = now

    def is_unrecoverable_failure(self) -> bool:
        if self.relaunch_count >= self.max_relaunch_count:
            return True
        if self.exit_reason == NodeExitReason.FATAL_ERROR:
            return True
        return False

    def is_alive(self) -> bool:
        return self.status in (NodeStatus.PENDING, NodeStatus.RUNNING,
                               NodeStatus.INITIAL)

    def get_relaunch_node(self, new_id: int) -> "Node":
        """Build the replacement node after this one fails (reference:
        dist_job_manager relaunch path)."""
        node = Node(
            self.type,
            new_id,
            rank_index=self.rank_index,
            status=NodeStatus.INITIAL,
            config_resource=self.config_resource,
            critical=self.critical,
            max_relaunch_count=self.max_relaunch_count,
        )
        node.relaunch_count = self.relaunch_count + 1
        return node

    # -- crash-consistent state (master/state_backend.py) ------------------
    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "id": self.id,
            "rank_index": self.rank_index,
            "name": self.name,
            "status": self.status,
            "config_resource": self.config_resource.to_dict(),
            "critical": self.critical,
            "relaunchable": self.relaunchable,
            "max_relaunch_count": self.max_relaunch_count,
            "relaunch_count": self.relaunch_count,
            "exit_reason": self.exit_reason,
            "host_addr": self.host_addr,
            "host_port": self.host_port,
            "create_time": self.create_time,
            "start_time": self.start_time,
            "finish_time": self.finish_time,
            "is_released": self.is_released,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        node = cls(
            d["type"],
            int(d["id"]),
            rank_index=int(d.get("rank_index", d["id"])),
            name=d.get("name", ""),
            status=d.get("status", NodeStatus.INITIAL),
            config_resource=NodeResource.from_dict(
                d.get("config_resource")),
            critical=bool(d.get("critical", False)),
            max_relaunch_count=int(d.get("max_relaunch_count", 3)),
            relaunchable=bool(d.get("relaunchable", True)),
        )
        node.relaunch_count = int(d.get("relaunch_count", 0))
        node.exit_reason = d.get("exit_reason", "")
        node.host_addr = d.get("host_addr", "")
        node.host_port = int(d.get("host_port", 0))
        node.create_time = d.get("create_time")
        node.start_time = d.get("start_time")
        node.finish_time = d.get("finish_time")
        node.is_released = bool(d.get("is_released", False))
        return node

    def __repr__(self):
        return (f"Node({self.type}-{self.id} rank={self.rank_index} "
                f"status={self.status})")


@dataclass
class NodeStateFlow:
    from_status: str
    to_status: str
    event_type: str
    should_relaunch: bool = False


# Allowed transitions (reference: status_flow.py NODE_STATE_FLOWS). "*" is a
# wildcard from-state; relaunch decisions additionally consult exit_reason in
# the node manager.
_ANY = "*"

NODE_STATE_FLOWS = [
    NodeStateFlow(NodeStatus.INITIAL, NodeStatus.PENDING, "added"),
    NodeStateFlow(NodeStatus.INITIAL, NodeStatus.RUNNING, "modified"),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.RUNNING, "modified"),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.SUCCEEDED, "modified"),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.FAILED, "modified",
                  should_relaunch=True),
    NodeStateFlow(NodeStatus.PENDING, NodeStatus.DELETED, "deleted",
                  should_relaunch=True),
    NodeStateFlow(NodeStatus.RUNNING, NodeStatus.SUCCEEDED, "modified"),
    NodeStateFlow(NodeStatus.RUNNING, NodeStatus.FAILED, "modified",
                  should_relaunch=True),
    NodeStateFlow(NodeStatus.RUNNING, NodeStatus.DELETED, "deleted",
                  should_relaunch=True),
    NodeStateFlow(NodeStatus.INITIAL, NodeStatus.DELETED, "deleted"),
    NodeStateFlow(_ANY, NodeStatus.BREAKDOWN, "modified",
                  should_relaunch=True),
    NodeStateFlow(NodeStatus.SUCCEEDED, NodeStatus.DELETED, "deleted"),
    NodeStateFlow(NodeStatus.FAILED, NodeStatus.DELETED, "deleted"),
]


def get_node_state_flow(from_status: str, event_type: str,
                        to_status: str) -> Optional[NodeStateFlow]:
    """Look up the allowed transition, or None if the event is stale/invalid."""
    if from_status == to_status:
        return None
    for flow in NODE_STATE_FLOWS:
        if (flow.from_status in (from_status, _ANY)
                and flow.to_status == to_status
                and flow.event_type == event_type):
            return flow
    # A deletion always applies regardless of recorded state.
    if event_type == "deleted" and to_status == NodeStatus.DELETED:
        relaunch = from_status not in NodeStatus.terminal()
        return NodeStateFlow(from_status, to_status, event_type, relaunch)
    return None
