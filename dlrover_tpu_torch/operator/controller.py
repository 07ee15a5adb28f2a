"""Operator actuation shell: observe → native reconcile → act.

Own copy of the JAX package's ``operator/controller.py``, after
ElasticJobReconciler (elasticjob_controller.go:85) +
master.Manager (master/master.go:53-162: master pod/service construction,
DLROVER_MASTER_ADDR injection) + ScalePlanReconciler relay. Runs against
the in-memory LocalCluster (tests/standalone) or the k8s REST client.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.operator.native import (
    Action,
    ActionKind,
    JobObserved,
    JobPhase,
    PodPhase,
    reconcile,
)

_POD_STATUS_TO_PHASE = {
    NodeStatus.PENDING: PodPhase.PENDING,
    NodeStatus.RUNNING: PodPhase.RUNNING,
    NodeStatus.SUCCEEDED: PodPhase.SUCCEEDED,
    NodeStatus.FAILED: PodPhase.FAILED,
    NodeStatus.BREAKDOWN: PodPhase.FAILED,
}

PHASE_NAMES = {
    JobPhase.CREATED: "Created",
    JobPhase.PENDING: "Pending",
    JobPhase.RUNNING: "Running",
    JobPhase.SUCCEEDED: "Succeeded",
    JobPhase.FAILED: "Failed",
    JobPhase.SCALING: "Scaling",
}


class ElasticJobController:
    """One controller per job against the LocalCluster backend (the k8s
    shell wires the same reconcile core to K8sClient CRUD)."""

    def __init__(
        self,
        job_name: str,
        cluster,                       # LocalCluster
        master_factory=None,           # () -> started master; returns addr
        max_master_restarts: int = 3,
        interval_s: float = 1.0,
    ):
        self._job_name = job_name
        self._cluster = cluster
        self._master_factory = master_factory
        self._interval_s = interval_s
        self.phase = JobPhase.CREATED
        self.master_restarts = 0
        self.max_master_restarts = max_master_restarts
        self.master_addr = ""
        # node type -> requested count; a ScalePlan may scale several
        # node groups at once (scaleplan_types.go replicaResourceSpecs)
        self.pending_scale_plans: Dict[str, int] = {}
        self.suspended = False
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._master_handle = None
        # guards the reconcile state shared between the controller
        # thread and CR-entry callers (submit_scale_plan/observe/tests);
        # never held across a cluster call, master launch, or relay RPC
        self._lock = threading.Lock()

    # -- observation ---------------------------------------------------
    def observe(self) -> JobObserved:
        master_phase = PodPhase.ABSENT
        for pod in self._cluster.list_pods(NodeType.MASTER):
            master_phase = _POD_STATUS_TO_PHASE.get(pod.status,
                                                    PodPhase.ABSENT)
        workers = self._cluster.list_pods(NodeType.WORKER)
        with self._lock:
            job_phase = self.phase
            master_restarts = self.master_restarts
            suspended = self.suspended
            pending = bool(self.pending_scale_plans)
        return JobObserved(
            job_phase=job_phase,
            master_phase=master_phase,
            master_restarts=master_restarts,
            max_master_restarts=self.max_master_restarts,
            suspended=suspended,
            pending_scale_plan=pending,
            workers_total=len(workers),
            workers_running=sum(
                1 for p in workers if p.status == NodeStatus.RUNNING),
            workers_succeeded=sum(
                1 for p in workers if p.status == NodeStatus.SUCCEEDED),
            workers_failed_unrecoverable=sum(
                1 for p in workers if p.status == NodeStatus.FAILED),
        )

    # -- actuation -------------------------------------------------------
    def _act(self, action: Action) -> None:
        if action.kind == ActionKind.CREATE_MASTER:
            self._create_master()
        elif action.kind == ActionKind.RELAUNCH_MASTER:
            with self._lock:
                self.master_restarts = action.arg
            logger.warning("relaunching master (%d/%d)",
                           action.arg, self.max_master_restarts)
            for pod in self._cluster.list_pods(NodeType.MASTER):
                self._cluster.delete_pod(pod.name)
            self._create_master()
        elif action.kind == ActionKind.SET_PHASE:
            with self._lock:
                changed = self.phase != action.arg
                if changed:
                    self.phase = action.arg
            if changed:
                logger.info("job %s phase -> %s", self._job_name,
                            PHASE_NAMES[action.arg])
        elif action.kind == ActionKind.RELAY_SCALE_PLAN:
            self._relay_scale_plan()
        elif action.kind == ActionKind.FAIL_JOB:
            logger.error("job %s failed (reason code %d)", self._job_name,
                         action.arg)

    def _create_master(self) -> None:
        with self._lock:
            ordinal = self.master_restarts
        if hasattr(self._cluster, "create_master"):
            # k8s backend: master runs as a pod behind a stable service
            # (reference: master/master.go:53-162). The pod name carries
            # the restart ordinal: a relaunch must not collide with the
            # old pod's asynchronous (graceful) deletion.
            addr = self._cluster.create_master(ordinal=ordinal)
            with self._lock:
                self.master_addr = addr
            return
        from dlrover_tpu_torch.scheduler.local import PodRecord

        if self._master_factory is not None:
            # the factory launches a full master: keep the lock out of
            # that call and publish handle + addr once it returns
            handle, addr = self._master_factory()
            with self._lock:
                self._master_handle = handle
                self.master_addr = addr
        else:
            with self._lock:
                addr = self.master_addr
        self._cluster.create_pod(PodRecord(
            name=f"{self._job_name}-master-0",
            node_type=NodeType.MASTER,
            node_id=0,
            rank_index=0,
            env={"DLROVER_TPU_MASTER_ADDR": addr},
        ))

    def _relay_scale_plan(self) -> None:
        with self._lock:
            plans, self.pending_scale_plans = self.pending_scale_plans, {}
            addr = self.master_addr
        if not plans or not addr:
            return
        from dlrover_tpu_torch.agent.master_client import MasterClient

        try:
            client = MasterClient(addr, node_id=-1)
            try:
                for node_type, count in list(plans.items()):
                    client._report(msg.ScaleRequest(node_type=node_type,
                                                    count=count))
                    logger.info("relayed scale plan %s=%d to master",
                                node_type, count)
                    del plans[node_type]
            finally:
                client.close()
        except Exception as e:  # noqa: BLE001
            logger.warning("scale-plan relay failed: %s; requeued", e)
            # not-yet-sent entries go back; a newer request wins
            with self._lock:
                for node_type, count in plans.items():
                    self.pending_scale_plans.setdefault(node_type, count)

    def submit_scale_plan(self, node_type: str, count: int) -> None:
        """The ScalePlan-CR entry (reference: ScalePlanReconciler)."""
        with self._lock:
            self.pending_scale_plans[node_type] = count

    # -- loop ------------------------------------------------------------
    def reconcile_once(self) -> JobObserved:
        observed = self.observe()
        for action in reconcile(observed):
            self._act(action)
        return observed

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="elasticjob-controller")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        while not self._stopped.wait(self._interval_s):
            try:
                self.reconcile_once()
            except Exception as e:  # noqa: BLE001 - controller must survive
                logger.error("reconcile failed: %s", e)
