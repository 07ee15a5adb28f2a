"""In-memory "cluster": the local platform backend.

Own copy of the JAX package's ``scheduler/local.py``, after the
reference tests' mocked k8sClient (dlrover/python/tests/test_utils.py:
238-253) as a platform of its own: pod records live in a dict, lifecycle
transitions are explicit method calls, and every change emits a watch
event. ``fail_pod`` is the fault-injection hook.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from dlrover_tpu_torch.common.constants import NodeEventType, NodeStatus


@dataclass
class PodRecord:
    """One simulated pod/host."""

    name: str
    node_type: str
    node_id: int
    rank_index: int
    status: str = NodeStatus.PENDING
    labels: Dict[str, str] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    resource: Dict[str, Any] = field(default_factory=dict)
    exit_reason: str = ""
    create_time: float = field(default_factory=time.time)


@dataclass
class WatchEvent:
    event_type: str       # NodeEventType
    pod: PodRecord


class LocalCluster:
    """Thread-safe fake cluster with a watch-event stream."""

    def __init__(self, auto_run: bool = True):
        # auto_run: created pods transition PENDING→RUNNING immediately,
        # like a healthy cluster with capacity.
        self._pods: Dict[str, PodRecord] = {}
        self._lock = threading.Lock()
        self._subscribers: List["queue.Queue[WatchEvent]"] = []
        self._auto_run = auto_run
        self._uid = itertools.count()

    # -- pod lifecycle -------------------------------------------------
    def create_pod(self, pod: PodRecord) -> PodRecord:
        with self._lock:
            self._pods[pod.name] = pod
        self._emit(NodeEventType.ADDED, pod)
        if self._auto_run:
            self.set_status(pod.name, NodeStatus.RUNNING)
        return pod

    def delete_pod(self, name: str) -> bool:
        with self._lock:
            pod = self._pods.pop(name, None)
        if pod is None:
            return False
        pod.status = NodeStatus.DELETED
        self._emit(NodeEventType.DELETED, pod)
        return True

    def set_status(self, name: str, status: str,
                   exit_reason: str = "") -> None:
        with self._lock:
            pod = self._pods.get(name)
            if pod is None:
                return
            pod.status = status
            if exit_reason:
                pod.exit_reason = exit_reason
        self._emit(NodeEventType.MODIFIED, pod)

    def fail_pod(self, name: str, exit_reason: str = "") -> None:
        """Chaos hook: make a pod fail (test/fault-injection entry)."""
        self.set_status(name, NodeStatus.FAILED, exit_reason)

    def list_pods(self, node_type: Optional[str] = None) -> List[PodRecord]:
        with self._lock:
            pods = list(self._pods.values())
        if node_type is not None:
            pods = [p for p in pods if p.node_type == node_type]
        return pods

    def get_pod(self, name: str) -> Optional[PodRecord]:
        with self._lock:
            return self._pods.get(name)

    # -- watch stream --------------------------------------------------
    def subscribe(self) -> "queue.Queue[WatchEvent]":
        q: "queue.Queue[WatchEvent]" = queue.Queue()
        with self._lock:
            self._subscribers.append(q)
        return q

    def unsubscribe(self, q: "queue.Queue[WatchEvent]") -> None:
        with self._lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    def _emit(self, event_type: str, pod: PodRecord) -> None:
        with self._lock:
            subscribers = list(self._subscribers)
        for q in subscribers:
            q.put(WatchEvent(event_type, pod))
