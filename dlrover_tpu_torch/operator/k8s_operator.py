"""Kubernetes operator: ElasticJob/ScalePlan watch → reconcile → pod CRUD.

Own copy of the JAX package's ``operator/k8s_operator.py``, after the Go
operator process —
`ElasticJobReconciler.Reconcile` (pkg/controllers/elasticjob_controller.go:85)
creating exactly one master pod + service per job
(pkg/controllers/master/master.go:53-162, DLROVER_MASTER_ADDR injection
:188), job phase sync from replica statuses, and the ScalePlanReconciler
relay of manual scale requests to the master. The decision core is the
shared native reconcile (native/reconciler.cpp via operator/native.py); this
module is the k8s shell: CR watch streams, pod CRUD through the
zero-dependency REST client, and CR status patches.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.operator.controller import ElasticJobController
from dlrover_tpu_torch.operator.crd import (
    ELASTICJOB_PLURAL,
    GROUP,
    SCALEPLAN_PLURAL,
    VERSION,
    ElasticJob,
    ScalePlan,
)
from dlrover_tpu_torch.scheduler.kubernetes import (
    K8sClient,
    build_pod_manifest,
    pod_to_fields,
)

MASTER_PORT = 50001


class _PodView:
    """The pod surface the controller's observe() needs."""

    def __init__(self, fields: Dict[str, Any]):
        self.name = fields["name"]
        self.node_type = fields["node_type"]
        self.status = fields["status"]
        self.terminating = fields.get("terminating", False)


class K8sJobCluster:
    """LocalCluster-compatible view of ONE job's pods over the k8s API.

    The controller observes through list_pods and acts through
    create_master/delete_pod; worker pods are created by the MASTER
    (pod scaler), exactly as in the reference — the operator only owns
    the master pod + service (master/master.go:69,145).
    """

    def __init__(self, job: ElasticJob, client: K8sClient):
        self.job = job
        self._client = client

    # -- controller observe surface ------------------------------------
    def list_pods(self, node_type: Optional[str] = None):
        selector = f"dlrover-tpu/job={self.job.name}"
        if node_type:
            selector += f",dlrover-tpu/type={node_type}"
        views = [_PodView(pod_to_fields(p))
                 for p in self._client.list_pods(selector)]
        # A pod under graceful deletion must read as gone, or the
        # reconciler re-fires RELAUNCH_MASTER every tick while the old
        # pod lingers Terminating and burns the restart budget.
        return [v for v in views if not v.terminating]

    def delete_pod(self, name: str) -> bool:
        return self._client.delete_pod(name)

    # -- controller act surface ----------------------------------------
    @property
    def master_addr(self) -> str:
        """The in-cluster service address injected as
        DLROVER_TPU_MASTER_ADDR (reference: master/master.go:188)."""
        return (f"{self.job.name}-dlrover-master."
                f"{self.job.namespace}:{MASTER_PORT}")

    def create_master(self, ordinal: int = 0) -> str:
        """Create the master pod + stable service; returns the address.
        `ordinal` is the restart count — each relaunch gets a fresh pod
        name so it cannot 409 against the old pod's graceful deletion."""
        spec = self.job.spec.replica_specs.get(
            "master", self.job.spec.replica_specs.get(NodeType.WORKER))
        image = spec.image if spec else ""
        manifest = build_pod_manifest(
            job_name=self.job.name,
            node_type=NodeType.MASTER,
            node_id=ordinal,
            rank_index=0,
            image=image,
            # The master reads its own ElasticJob CR to learn the replica
            # specs and runs the pod scaler/watcher (run_master_main's
            # k8s platform path) — the operator only conveys identity.
            command=(f"python -m dlrover_tpu_torch.master.job_master "
                     f"--port {MASTER_PORT} --platform k8s "
                     f"--job-name {self.job.name} "
                     f"--namespace {self.job.namespace}"),
            master_addr=self.master_addr,
            node_num=1,
            owner_ref=(self.job.owner_reference()
                       if self.job.uid else None),
        )
        self._client.create_pod(manifest)
        self._client.create_service({
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": f"{self.job.name}-dlrover-master",
                **({"ownerReferences": [self.job.owner_reference()]}
                   if self.job.uid else {}),
            },
            "spec": {
                "selector": {
                    "dlrover-tpu/job": self.job.name,
                    "dlrover-tpu/type": NodeType.MASTER,
                },
                "ports": [{"port": MASTER_PORT,
                           "targetPort": MASTER_PORT}],
            },
        })
        return self.master_addr


class K8sElasticJobOperator:
    """The operator main loop: one ElasticJobController per CR."""

    def __init__(self, namespace: str = "default",
                 client: Optional[K8sClient] = None,
                 reconcile_interval_s: float = 2.0):
        self._client = client or K8sClient(namespace)
        self._namespace = namespace
        self._interval_s = reconcile_interval_s
        self._controllers: Dict[str, ElasticJobController] = {}
        self._backends: Dict[str, K8sJobCluster] = {}
        self._patched_phase: Dict[str, str] = {}
        self._relayed_plans: set = set()
        # plans whose owner job was not tracked yet (the two watch
        # streams race); retried every reconcile tick
        self._orphan_plans: Dict[str, ScalePlan] = {}
        self._stopped = threading.Event()
        self._threads = []

    # -- CR plumbing ----------------------------------------------------
    def _cr_path(self, plural: str, name: str = "",
                 subresource: str = "") -> str:
        path = (f"/apis/{GROUP}/{VERSION}/namespaces/{self._namespace}"
                f"/{plural}")
        if name:
            path += f"/{name}"
        if subresource:
            path += f"/{subresource}"
        return path

    def _patch_status(self, plural: str, name: str,
                      status: Dict[str, Any]) -> None:
        try:
            self._client.api.request(
                "PATCH", self._cr_path(plural, name, "status"),
                {"status": status})
        except Exception as e:  # noqa: BLE001 — status sync is advisory
            logger.warning("status patch %s/%s failed: %s", plural, name, e)

    # -- job lifecycle ----------------------------------------------------
    def ensure_job(self, job: ElasticJob) -> ElasticJobController:
        controller = self._controllers.get(job.name)
        if controller is not None:
            self._backends[job.name].job = job
            controller.suspended = job.spec.suspend
            return controller
        backend = K8sJobCluster(job, self._client)
        controller = ElasticJobController(job.name, backend)
        controller.suspended = job.spec.suspend
        self._backends[job.name] = backend
        self._controllers[job.name] = controller
        logger.info("tracking ElasticJob %s", job.name)
        return controller

    def forget_job(self, name: str) -> None:
        controller = self._controllers.pop(name, None)
        self._backends.pop(name, None)
        self._patched_phase.pop(name, None)
        if controller is not None:
            controller.stop()
            logger.info("dropped ElasticJob %s", name)

    def handle_job_event(self, event: Dict[str, Any]) -> None:
        obj = event.get("object", {})
        job = ElasticJob.from_manifest(obj)
        if not job.name:
            return
        if event.get("type") == "DELETED":
            self.forget_job(job.name)
        else:                              # ADDED / MODIFIED
            self.ensure_job(job)

    def handle_scaleplan_event(self, event: Dict[str, Any]) -> None:
        """Relay a manual ScalePlan to the owner job's master
        (reference: ScalePlanReconciler + elasticjob_scaler.py).
        Idempotent: plans already phase=Relayed (our own status patch
        echoes back as MODIFIED, and watch reconnects replay existing
        plans) are skipped; plans whose owner isn't tracked yet are
        parked and retried — the two watch streams race."""
        plan = ScalePlan.from_manifest(event.get("object", {}))
        if not plan.name:
            return    # ERROR/Status watch events carry no object name
        if event.get("type") == "DELETED":
            self._orphan_plans.pop(plan.name, None)
            # a later re-created plan with the same name is a NEW request
            self._relayed_plans.discard(plan.name)
            return
        if plan.phase == "Relayed" or plan.name in self._relayed_plans:
            return
        self._relay_plan(plan)

    def _relay_plan(self, plan: ScalePlan) -> None:
        controller = self._controllers.get(plan.spec.owner_job)
        if controller is None:
            logger.warning("ScalePlan %s: owner job %r not tracked yet; "
                           "parked", plan.name, plan.spec.owner_job)
            self._orphan_plans[plan.name] = plan
            return
        self._orphan_plans.pop(plan.name, None)
        for node_type, count in plan.spec.replica_resource_specs.items():
            controller.submit_scale_plan(node_type, count)
        self._relayed_plans.add(plan.name)
        self._patch_status(SCALEPLAN_PLURAL, plan.name,
                           {"phase": "Relayed"})

    # -- reconcile --------------------------------------------------------
    def reconcile_all(self) -> None:
        from dlrover_tpu_torch.operator.controller import PHASE_NAMES

        for plan in list(self._orphan_plans.values()):
            self._relay_plan(plan)
        for name, controller in list(self._controllers.items()):
            try:
                controller.reconcile_once()
                phase = PHASE_NAMES[controller.phase]
                # status patch only on transition, not every tick
                if self._patched_phase.get(name) != phase:
                    self._patch_status(ELASTICJOB_PLURAL, name,
                                       {"phase": phase})
                    self._patched_phase[name] = phase
            except Exception as e:  # noqa: BLE001 — operator must survive
                logger.error("reconcile %s failed: %s", name, e)

    def list_existing_jobs(self) -> None:
        """Adopt CRs that existed before the operator started."""
        try:
            items = self._client.api.request(
                "GET", self._cr_path(ELASTICJOB_PLURAL)).get("items", [])
        except Exception as e:  # noqa: BLE001
            logger.warning("initial ElasticJob list failed: %s", e)
            return
        for obj in items:
            self.ensure_job(ElasticJob.from_manifest(obj))

    # -- loops ------------------------------------------------------------
    def _watch_loop(self, plural: str, handler) -> None:
        while not self._stopped.is_set():
            try:
                for event in self._client.api.stream(
                        self._cr_path(plural) + "?watch=true"):
                    handler(event)
                    if self._stopped.is_set():
                        break
            except Exception as e:  # noqa: BLE001 — reconnect on drop
                if not self._stopped.is_set():
                    logger.warning("%s watch dropped: %s; reconnecting",
                                   plural, e)
                    self._stopped.wait(1.0)

    def _reconcile_loop(self) -> None:
        while not self._stopped.wait(self._interval_s):
            self.reconcile_all()

    def start(self) -> None:
        self.list_existing_jobs()
        self._threads = [
            threading.Thread(
                target=self._watch_loop,
                args=(ELASTICJOB_PLURAL, self.handle_job_event),
                daemon=True, name="watch-elasticjobs"),
            threading.Thread(
                target=self._watch_loop,
                args=(SCALEPLAN_PLURAL, self.handle_scaleplan_event),
                daemon=True, name="watch-scaleplans"),
            threading.Thread(target=self._reconcile_loop, daemon=True,
                             name="operator-reconcile"),
        ]
        for thread in self._threads:
            thread.start()

    def stop(self) -> None:
        self._stopped.set()
        for controller in self._controllers.values():
            controller.stop()


def main(argv=None) -> int:
    """`python -m dlrover_tpu_torch.operator.k8s_operator` — the operator
    process entry (reference: the Go operator binary)."""
    import argparse
    import time

    parser = argparse.ArgumentParser("dlrover-tpu-operator")
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--interval", type=float, default=2.0)
    ns = parser.parse_args(argv)
    operator = K8sElasticJobOperator(ns.namespace,
                                     reconcile_interval_s=ns.interval)
    operator.start()
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        operator.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
