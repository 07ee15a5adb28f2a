"""Node-event callbacks: side effects of lifecycle transitions.

Own copy of the JAX package's ``master/node/event_callback.py``, after
dlrover/python/master/node/event_callback.py: TaskRescheduleCallback
(:105) requeues a dead worker's in-flight shards; the membership
callback (AllReduceNodeHandlingCallback, :212) keeps the rendezvous, the
speed monitor and the diagnosis engine in step with node lifecycle;
PsFailoverCallback (:127) bumps the global cluster version a failed
state holder leaves behind.
"""

from __future__ import annotations

from typing import Dict

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import Node


class NodeEventCallback:
    def on_node_started(self, node: Node) -> None:
        pass

    def on_node_succeeded(self, node: Node) -> None:
        pass

    def on_node_failed(self, node: Node) -> None:
        pass

    def on_node_deleted(self, node: Node) -> None:
        pass


class TaskRescheduleCallback(NodeEventCallback):
    """Requeue the doing-tasks of a dead worker so other workers pick them
    up (dynamic sharding fault tolerance)."""

    def __init__(self, task_manager):
        self._task_manager = task_manager

    def on_node_failed(self, node: Node) -> None:
        self._task_manager.recover_tasks(node.id)

    def on_node_deleted(self, node: Node) -> None:
        self._task_manager.recover_tasks(node.id)


class PsFailoverCallback(NodeEventCallback):
    """Bump the global cluster version when a state-holding node dies.

    After TFPSNodeHandlingCallback (reference
    master/node/event_callback.py:127) driving ElasticPsService
    (elastic_training/elastic_ps.py:18): the version bump tells every
    worker its view of the sharded state is stale. There are no PS
    processes: every worker holds embedding-table shards, so any
    state-holder death advances the version and the workers reconcile by
    restoring the table from the latest committed checkpoint
    (trainer/embedding.py EmbeddingFailoverClient)."""

    def __init__(self, elastic_ps_service, node_types=("worker", "ps")):
        self._service = elastic_ps_service
        self._node_types = set(node_types)

    def _bump(self, node: Node) -> None:
        if node.type in self._node_types:
            self._service.remove_node(node.type, node.id)
            version = self._service.inc_global_cluster_version()
            logger.info(
                "state holder %s died: global cluster version -> %d",
                node.name, version,
            )

    def on_node_failed(self, node: Node) -> None:
        self._bump(node)

    def on_node_deleted(self, node: Node) -> None:
        from dlrover_tpu_torch.common.constants import NodeStatus

        # Only an unexpected deletion of a live node is a state loss; a
        # SUCCEEDED pod's cleanup is routine, and a FAILED node already
        # bumped the version on the failure event (no double rollback).
        if node.status == NodeStatus.RUNNING:
            self._bump(node)
        elif node.type in self._node_types:
            self._service.remove_node(node.type, node.id)


class RendezvousMembershipCallback(NodeEventCallback):
    """Keep rendezvous managers' alive-node sets, the speed monitor and
    the diagnosis engine in sync with node lifecycle (the AllReduce
    path's membership bookkeeping)."""

    def __init__(self, rdzv_managers: Dict[str, object], speed_monitor,
                 diagnosis_manager=None):
        self._rdzv_managers = rdzv_managers
        self._speed_monitor = speed_monitor
        self._diagnosis_manager = diagnosis_manager

    def on_node_started(self, node: Node) -> None:
        for mgr in self._rdzv_managers.values():
            mgr.add_alive_node(node.rank_index)

    def _drop(self, node: Node, graceful: bool = False) -> None:
        for mgr in self._rdzv_managers.values():
            mgr.remove_alive_node(node.rank_index, graceful=graceful)
        from dlrover_tpu_torch.common.constants import RendezvousName

        training = self._rdzv_managers.get(RendezvousName.TRAINING)
        live = training.alive_nodes if training is not None else set()
        # evict BOTH keys a departed node may have reported under (rank
        # for modern senders, node_id for legacy ones) so straggler
        # scores never rank dead ranks — but node.id may COLLIDE with a
        # surviving worker's rank (ids grow past the rank range on
        # relaunch), and evicting a live rank's window resets its
        # straggler evidence until the next rendezvous
        self._speed_monitor.remove_running_worker(node.rank_index)
        if node.id != node.rank_index and node.id not in live:
            self._speed_monitor.remove_running_worker(node.id)
        self._speed_monitor.reset_running_speed()
        if self._diagnosis_manager is not None:
            self._diagnosis_manager.evict_workers(live)

    def on_node_succeeded(self, node: Node) -> None:
        # A clean exit must not invalidate the cut world — survivors are
        # finishing their own work and must not be forced to restart.
        self._drop(node, graceful=True)

    def on_node_failed(self, node: Node) -> None:
        logger.info("rendezvous membership: dropping failed %s", node.name)
        self._drop(node)

    def on_node_deleted(self, node: Node) -> None:
        self._drop(node)
