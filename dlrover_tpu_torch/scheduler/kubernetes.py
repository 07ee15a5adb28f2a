"""Kubernetes platform client: zero-dependency REST against the API server.

Own copy of the JAX package's ``scheduler/kubernetes.py``, after
dlrover/python/scheduler/kubernetes.py (k8sClient :85, K8sElasticJob
:327) without the ``kubernetes`` SDK: a thin HTTPS client over the
in-cluster service-account contract
(/var/run/secrets/kubernetes.io/serviceaccount) with create, delete,
list and watch on pods and services, and the pod-manifest builder. The
manifest and watch parsing are pure functions; network calls happen only
on a real cluster.

The accelerator in a manifest: a pod requests its cards as the
``nvidia.com/gpu`` device-plugin resource and their type as the
``cloud.google.com/gke-accelerator`` node selector. The JAX package
requests ``google.com/tpu`` with the GKE TPU accelerator and topology
labels and opens the TPU runtime's port; the topology and the port have
no counterpart here. That mapping is the only difference between the
two packages' manifests (ROADMAP, "Differences kept on purpose").
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, List, Optional

from dlrover_tpu_torch.common.constants import (
    NodeEnv,
    NodeExitReason,
    NodeStatus,
    WorkerExit,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import NodeResource

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
# the device-plugin resource a pod requests its cards as, and the node
# label that names their type
GPU_RESOURCE = "nvidia.com/gpu"
ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"

# k8s pod phase → framework node status (reference: the reference maps the
# same five phases in master/watcher/k8s_watcher.py).
POD_PHASE_TO_STATUS = {
    "Pending": NodeStatus.PENDING,
    "Running": NodeStatus.RUNNING,
    "Succeeded": NodeStatus.SUCCEEDED,
    "Failed": NodeStatus.FAILED,
    "Unknown": NodeStatus.UNKNOWN,
}


def in_cluster() -> bool:
    return os.path.exists(os.path.join(_SA_DIR, "token"))


class K8sApi:
    """Minimal typed REST surface; swap out in tests."""

    def __init__(self, host: Optional[str] = None,
                 token: Optional[str] = None,
                 ca_file: Optional[str] = None):
        self._host = host or "https://{}:{}".format(
            os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default"),
            os.environ.get("KUBERNETES_SERVICE_PORT", "443"),
        )
        if token is None and in_cluster():
            with open(os.path.join(_SA_DIR, "token")) as f:
                token = f.read().strip()
        self._token = token
        ca = ca_file or os.path.join(_SA_DIR, "ca.crt")
        self._ssl = ssl.create_default_context(
            cafile=ca if os.path.exists(ca) else None)
        if not os.path.exists(ca):
            self._ssl.check_hostname = False
            self._ssl.verify_mode = ssl.CERT_NONE

    def request(self, method: str, path: str,
                body: Optional[Dict[str, Any]] = None,
                timeout: float = 30.0) -> Dict[str, Any]:
        req = urllib.request.Request(
            self._host + path,
            data=json.dumps(body).encode() if body is not None else None,
            method=method,
        )
        req.add_header("Accept", "application/json")
        # k8s rejects PATCH with a plain JSON media type (415); it requires
        # one of the patch content types (we use merge-patch).
        if method == "PATCH":
            req.add_header("Content-Type", "application/merge-patch+json")
        else:
            req.add_header("Content-Type", "application/json")
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        with urllib.request.urlopen(req, timeout=timeout,
                                    context=self._ssl) as resp:
            return json.loads(resp.read() or b"{}")

    def stream(self, path: str, timeout: float = 3600.0
               ) -> Iterator[Dict[str, Any]]:
        """Line-delimited watch stream."""
        req = urllib.request.Request(self._host + path)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        with urllib.request.urlopen(req, timeout=timeout,
                                    context=self._ssl) as resp:
            for line in resp:
                line = line.strip()
                if line:
                    yield json.loads(line)


class K8sClient:
    """Pod/service CRUD in one namespace (reference: k8sClient,
    scheduler/kubernetes.py:85-326)."""

    def __init__(self, namespace: str = "default",
                 api: Optional[K8sApi] = None):
        self.namespace = namespace
        self.api = api or K8sApi()

    # -- pods ----------------------------------------------------------
    def create_pod(self, manifest: Dict[str, Any]) -> bool:
        try:
            self.api.request(
                "POST", f"/api/v1/namespaces/{self.namespace}/pods", manifest)
            return True
        except urllib.error.HTTPError as e:
            logger.error("create_pod failed: %s %s", e.code, e.reason)
            return False

    def delete_pod(self, name: str) -> bool:
        try:
            self.api.request(
                "DELETE", f"/api/v1/namespaces/{self.namespace}/pods/{name}")
            return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return True
            logger.error("delete_pod failed: %s %s", e.code, e.reason)
            return False

    def list_pods(self, label_selector: str = "") -> List[Dict[str, Any]]:
        path = f"/api/v1/namespaces/{self.namespace}/pods"
        if label_selector:
            path += f"?labelSelector={label_selector}"
        return self.api.request("GET", path).get("items", [])

    def watch_pods(self, label_selector: str = "",
                   resource_version: str = "") -> Iterator[Dict[str, Any]]:
        path = (f"/api/v1/namespaces/{self.namespace}/pods"
                f"?watch=true&labelSelector={label_selector}")
        if resource_version:
            path += f"&resourceVersion={resource_version}"
        return self.api.stream(path)

    def create_service(self, manifest: Dict[str, Any]) -> bool:
        try:
            self.api.request(
                "POST", f"/api/v1/namespaces/{self.namespace}/services",
                manifest)
            return True
        except urllib.error.HTTPError as e:
            logger.error("create_service failed: %s %s", e.code, e.reason)
            return False

    def patch_custom_resource(self, group: str, version: str, plural: str,
                              name: str, body: Dict[str, Any]) -> bool:
        """Patch a CR (scale-plan relay; reference: elasticjob_scaler.py)."""
        path = (f"/apis/{group}/{version}/namespaces/{self.namespace}"
                f"/{plural}/{name}")
        try:
            self.api.request("PATCH", path, body)
            return True
        except urllib.error.HTTPError as e:
            logger.error("patch CR failed: %s %s", e.code, e.reason)
            return False


# ---------------------------------------------------------------------------
# Pure manifest construction (unit-testable without a cluster).
# ---------------------------------------------------------------------------

def resource_to_limits(resource: NodeResource) -> Dict[str, str]:
    """NodeResource → k8s resource limits (single source of truth, shared
    with the CRD serialization in operator/crd.py)."""
    limits: Dict[str, str] = {}
    if resource.cpu:
        limits["cpu"] = str(resource.cpu)
    if resource.memory_mb:
        limits["memory"] = f"{int(resource.memory_mb)}Mi"
    if resource.chips:
        limits[GPU_RESOURCE] = str(resource.chips)
    return limits


def accelerator_node_selector(chip_type: str) -> Dict[str, str]:
    """The card type's placement label (single source of truth)."""
    return {ACCELERATOR_LABEL: chip_type} if chip_type else {}


def shell_command(command: str) -> Optional[List[str]]:
    return ["/bin/sh", "-c", command] if command else None


def build_pod_manifest(
    job_name: str,
    node_type: str,
    node_id: int,
    rank_index: int,
    image: str,
    command: str,
    master_addr: str,
    node_num: int,
    resource: Optional[NodeResource] = None,
    labels: Optional[Dict[str, str]] = None,
    owner_ref: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """A pod with the framework's env contract, its cards requested as
    ``nvidia.com/gpu`` and their type as the accelerator node selector
    (reference: _create_pod, master/scaler/pod_scaler.py:352)."""
    resource = resource or NodeResource()
    name = f"{job_name}-{node_type}-{node_id}"
    env = [
        {"name": NodeEnv.MASTER_ADDR, "value": master_addr},
        {"name": NodeEnv.NODE_ID, "value": str(node_id)},
        {"name": NodeEnv.NODE_TYPE, "value": node_type},
        {"name": NodeEnv.NODE_RANK, "value": str(rank_index)},
        {"name": NodeEnv.NODE_NUM, "value": str(node_num)},
        {"name": NodeEnv.JOB_NAME, "value": job_name},
    ]
    from dlrover_tpu_torch.common.config import Context

    watchdog_s = Context.singleton().hang_watchdog_s
    if watchdog_s > 0:
        # ship the watchdog knob into the pod: the worker enables the
        # watchdog, and pod_to_fields can classify a SIGABRT exit (134)
        # from the pod spec instead of guessing from master-side config
        env.append({"name": _HANG_WATCHDOG_ENV,
                    "value": str(watchdog_s)})
    limits = resource_to_limits(resource)
    node_selector = accelerator_node_selector(resource.chip_type)
    manifest: Dict[str, Any] = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": name,
            "labels": dict(labels or {}, **{
                "dlrover-tpu/job": job_name,
                "dlrover-tpu/type": node_type,
                "dlrover-tpu/rank": str(rank_index),
                "dlrover-tpu/node-id": str(node_id),
            }),
        },
        "spec": {
            "restartPolicy": "Never",
            "containers": [{
                "name": "main",
                "image": image,
                "command": shell_command(command),
                "env": env,
                "resources": {"limits": limits, "requests": dict(limits)},
            }],
            "nodeSelector": node_selector or None,
        },
    }
    if owner_ref:
        manifest["metadata"]["ownerReferences"] = [owner_ref]
    container = manifest["spec"]["containers"][0]
    manifest["spec"] = {k: v for k, v in manifest["spec"].items()
                        if v is not None}
    manifest["spec"]["containers"] = [
        {k: v for k, v in container.items() if v is not None}]
    return manifest


# the Context env-override name for hang_watchdog_s (common/config.py
# derives DLROVER_TPU_<FIELD_UPPER>): build_pod_manifest ships it into
# worker pods, pod_to_fields reads it back for exit classification
_HANG_WATCHDOG_ENV = "DLROVER_TPU_HANG_WATCHDOG_S"


def _pod_hang_enabled(pod: Dict[str, Any]) -> bool:
    """Whether THIS pod ran with the step-hang watchdog on — from the
    pod's own spec env when present (the worker knob is set per pod,
    not on the master), falling back to the master's Context."""
    for container in pod.get("spec", {}).get("containers", []):
        for entry in container.get("env", []) or []:
            if entry.get("name") == _HANG_WATCHDOG_ENV:
                try:
                    return float(entry.get("value", "0") or "0") > 0
                except ValueError:
                    return False
    from dlrover_tpu_torch.common.config import Context

    return Context.singleton().hang_watchdog_s > 0


def pod_to_fields(pod: Dict[str, Any]) -> Dict[str, Any]:
    """Parse a pod object into the watcher's neutral fields (reference:
    PodWatcher._convert_pod_event, master/watcher/k8s_watcher.py:130-193)."""
    meta = pod.get("metadata", {})
    labels = meta.get("labels", {})
    status = pod.get("status", {})
    exit_reason = ""
    for cs in status.get("containerStatuses", []):
        term = (cs.get("state", {}) or {}).get("terminated")
        if term:
            reason = term.get("reason", "")
            code = term.get("exitCode")
            # OOM only on the kernel OOM reason or exit 247; SIGKILL/SIGTERM
            # (137/143 — eviction, platform force-kill) are plain kills and
            # must not trigger the OOM memory bump on relaunch (reference:
            # master/watcher/k8s_watcher.py _get_pod_exit_reason). Drain /
            # hang / kill share WorkerExit.classify with the agent — one
            # exit-code vocabulary, so the diagnosis rules and the relaunch
            # budget see the same truth either way a pod dies.
            if code is not None:
                kind = WorkerExit.classify(
                    code, hang_enabled=_pod_hang_enabled(pod))
            else:
                kind = ""
            if reason == "OOMKilled" or code == 247:
                exit_reason = NodeExitReason.OOM
            elif kind in (NodeExitReason.DRAINED, NodeExitReason.HANG,
                          NodeExitReason.KILLED):
                exit_reason = kind
            elif reason == "Error":
                exit_reason = NodeExitReason.UNKNOWN_ERROR
    return {
        "name": meta.get("name", ""),
        "node_type": labels.get("dlrover-tpu/type", ""),
        "node_id": int(labels.get("dlrover-tpu/node-id", -1)),
        "rank_index": int(labels.get("dlrover-tpu/rank", -1)),
        "status": POD_PHASE_TO_STATUS.get(
            status.get("phase", ""), NodeStatus.UNKNOWN),
        "exit_reason": exit_reason,
        "host_ip": status.get("hostIP", ""),
        "pod_ip": status.get("podIP", ""),
        "terminating": bool(meta.get("deletionTimestamp")),
    }
