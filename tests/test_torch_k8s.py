"""The port's Kubernetes platform (dlrover_tpu_torch/operator/crd.py,
k8s_operator.py, scheduler/kubernetes.py, master/watcher/k8s_watcher.py,
master/scaler/pod_scaler.py) against the JAX package's, on the CPU,
through the in-process fake API server of tests/fake_k8s.py.

One mapping is applied to the JAX package's manifests before comparing:
the accelerator. The JAX package requests ``google.com/tpu``, names the
chip type under ``cloud.google.com/gke-tpu-accelerator``, pins the TPU
topology and opens the TPU runtime's port; the port requests
``nvidia.com/gpu`` and names the card type under
``cloud.google.com/gke-accelerator``, with no topology and no port.
Under it, the ElasticJob and ScalePlan CRDs (the test's sample and the
shipped samples in manifests/) parse and serialize equal and round-trip,
the CR's JobArgs are equal, pod manifests are equal, pod objects parse to
the same fields and nodes, and the operator runs a job's lifecycle on
the fake API server as the JAX operator does: the master pod and service
with the env contract, phase patches, a master relaunch, a ScalePlan
relayed once to a live master, and the master's ``--platform k8s`` path
creating the workers' pods with their cards as ``nvidia.com/gpu``.
"""

import copy
import dataclasses
import json
import time

import pytest

from dlrover_tpu.operator import crd as jcrd
from dlrover_tpu.scheduler import kubernetes as jk8s
from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.operator import crd as tcrd
from dlrover_tpu_torch.operator import k8s_operator as top
from dlrover_tpu_torch.scheduler import kubernetes as tk8s
from tests.fake_k8s import FakeK8s
from tests.test_k8s_operator import SAMPLE_JOB

TPU_LIMIT = "google.com/tpu"
TPU_TYPE = "cloud.google.com/gke-tpu-accelerator"
TPU_TOPOLOGY = "cloud.google.com/gke-tpu-topology"


def to_gpu(manifest):
    """A JAX manifest (CR, replica spec or pod) under the accelerator
    mapping: the TPU limit and request become ``nvidia.com/gpu``, the
    TPU type label the accelerator label; the topology label and the
    TPU runtime's port go."""
    out = copy.deepcopy(manifest)

    def walk(node):
        if isinstance(node, dict):
            for key in ("limits", "requests"):
                res = node.get(key)
                if isinstance(res, dict) and TPU_LIMIT in res:
                    res[tk8s.GPU_RESOURCE] = res.pop(TPU_LIMIT)
            selector = node.get("nodeSelector")
            if isinstance(selector, dict):
                if TPU_TYPE in selector:
                    selector[tk8s.ACCELERATOR_LABEL] = selector.pop(TPU_TYPE)
                selector.pop(TPU_TOPOLOGY, None)
                if not selector:
                    del node["nodeSelector"]
            if node.get("ports") == [{"containerPort": 8471}]:
                del node["ports"]
            for value in node.values():
                walk(value)
        elif isinstance(node, list):
            for value in node:
                walk(value)

    walk(out)
    return out


def _spec_dict(spec):
    """A parsed ElasticJobSpec as data, without the TPU topology (the
    JAX field the mapping drops)."""
    data = dataclasses.asdict(spec)
    for replica in data["replica_specs"].values():
        replica.pop("tpu_topology", None)
    return data


def _job_args_dict(args):
    data = json.loads(json.dumps(dataclasses.asdict(args), default=str))
    data.pop("tpu_topology", None)
    return data


def _samples():
    yaml = pytest.importorskip("yaml")
    jobs = [SAMPLE_JOB]
    with open("manifests/samples/elasticjob_llama.yaml") as f:
        jobs.append(yaml.safe_load(f))
    with open("manifests/samples/scaleplan_sample.yaml") as f:
        plan = yaml.safe_load(f)
    return jobs, plan


def test_crds_parse_serialize_and_round_trip_as_jax():
    jobs, plan = _samples()
    for manifest in jobs:
        want = jcrd.ElasticJob.from_manifest(manifest)
        got = tcrd.ElasticJob.from_manifest(to_gpu(manifest))
        assert (got.name, got.namespace, got.uid, got.phase) == (
            want.name, want.namespace, want.uid, want.phase)
        assert _spec_dict(got.spec) == _spec_dict(want.spec)
        assert got.to_manifest() == to_gpu(want.to_manifest())
        assert tcrd.ElasticJob.from_manifest(got.to_manifest()) == got
        assert _job_args_dict(got.to_job_args()) == \
            _job_args_dict(want.to_job_args())
        assert got.owner_reference() == want.owner_reference()
    worker = tcrd.ElasticJob.from_manifest(
        to_gpu(SAMPLE_JOB)).spec.replica_specs["worker"]
    assert (worker.resource.chips, worker.resource.chip_type) == (
        4, "tpu-v5p-slice")
    limits = worker.to_manifest()["template"]["spec"]["containers"][0][
        "resources"]["limits"]
    assert limits[tk8s.GPU_RESOURCE] == "4" and TPU_LIMIT not in limits
    assert dataclasses.asdict(tcrd.ScalePlan.from_manifest(plan)) == \
        dataclasses.asdict(jcrd.ScalePlan.from_manifest(plan))
    for value in ("500m", "8", "", "0.5"):
        assert tcrd.parse_cpu(value) == jcrd.parse_cpu(value)
    for value in ("32Gi", "512Mi", "1G", "1048576", "", "3Ti", "2K"):
        assert tcrd.parse_memory_mb(value) == jcrd.parse_memory_mb(value)


def _pod_kwargs(pkg):
    node = __import__(f"{pkg}.common.node", fromlist=["x"])
    return [
        dict(job_name="demo", node_type="worker", node_id=3, rank_index=1,
             image="img:1", command="python train.py", master_addr="m:1",
             node_num=4, resource=node.NodeResource(
                 cpu=8.0, memory_mb=32768.0, chips=8, chip_type="h100")),
        dict(job_name="demo", node_type="master", node_id=0, rank_index=0,
             image="", command="", master_addr="m:2", node_num=1,
             labels={"team": "a"}, owner_ref={"uid": "u-1"}),
        dict(job_name="j", node_type="worker", node_id=0, rank_index=0,
             image="i", command="run", master_addr="a:1", node_num=1,
             resource=node.NodeResource(cpu=1.0)),
    ]


@pytest.mark.parametrize("watchdog_s", [0.0, 30.0])
def test_pod_manifests_match_jax_under_the_mapping(watchdog_s):
    from dlrover_tpu.common.config import Context as JContext
    from dlrover_tpu_torch.common.config import Context

    for ctx in (JContext, Context):
        ctx.reset()
        ctx.singleton().update(hang_watchdog_s=watchdog_s)
    try:
        for jkw, tkw in zip(_pod_kwargs("dlrover_tpu"),
                            _pod_kwargs("dlrover_tpu_torch")):
            want = to_gpu(jk8s.build_pod_manifest(**jkw))
            got = tk8s.build_pod_manifest(**tkw)
            assert got == want
            for key in ("limits", "requests"):
                res = got["spec"]["containers"][0]["resources"][key]
                assert TPU_LIMIT not in res
    finally:
        JContext.reset()
        Context.reset()
    got = tk8s.build_pod_manifest(**_pod_kwargs("dlrover_tpu_torch")[0])
    assert got["spec"]["containers"][0]["resources"]["limits"][
        "nvidia.com/gpu"] == "8"
    assert got["spec"]["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "h100"}


def _pods():
    def pod(phase, state=None, labels=True, deleting=False, env=()):
        obj = {"metadata": {"name": "demo-worker-2"},
               "status": {"phase": phase, "hostIP": "10.0.0.1",
                          "podIP": "10.1.0.2"},
               "spec": {"containers": [{"env": list(env)}]}}
        if labels:
            obj["metadata"]["labels"] = {
                "dlrover-tpu/type": "worker", "dlrover-tpu/node-id": "2",
                "dlrover-tpu/rank": "1"}
        if deleting:
            obj["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
        if state is not None:
            obj["status"]["containerStatuses"] = [
                {"state": {"terminated": state}}]
        return obj

    hang = [{"name": "DLROVER_TPU_HANG_WATCHDOG_S", "value": "30"}]
    return [pod("Running"), pod("Pending", labels=False),
            pod("Unknown", deleting=True), pod("Bogus"),
            pod("Failed", {"reason": "OOMKilled", "exitCode": 137}),
            pod("Failed", {"reason": "Error", "exitCode": 247}),
            pod("Failed", {"reason": "Error", "exitCode": 137}),
            pod("Failed", {"reason": "Error", "exitCode": 76}),
            pod("Failed", {"reason": "Error", "exitCode": 134}, env=hang),
            pod("Failed", {"reason": "Error", "exitCode": 134}),
            pod("Failed", {"reason": "Error", "exitCode": 1}),
            pod("Succeeded", {"reason": "Completed", "exitCode": 0})]


def test_pod_objects_parse_as_jax():
    for pod in _pods():
        assert tk8s.pod_to_fields(pod) == jk8s.pod_to_fields(pod)


def _nodes(nodes):
    return sorted([n.type, n.id, n.rank_index, n.name, n.status,
                   n.exit_reason, n.host_addr] for n in nodes)


@pytest.fixture()
def fake_k8s():
    fake = FakeK8s()
    host = fake.start()
    yield fake, host
    fake.stop()


def test_pod_watcher_lists_and_scaler_creates_as_jax(fake_k8s):
    """The pod scaler's pods for a plan (under the mapping) and the
    watcher's nodes over them are the JAX pair's."""
    from dlrover_tpu.common import node as jnode
    from dlrover_tpu.master.scaler import base as jbase
    from dlrover_tpu.master.scaler import pod_scaler as jscaler
    from dlrover_tpu.master.watcher import k8s_watcher as jwatch
    from dlrover_tpu_torch.common import node as tnode
    from dlrover_tpu_torch.master.scaler import base as tbase
    from dlrover_tpu_torch.master.scaler import pod_scaler as tscaler
    from dlrover_tpu_torch.master.watcher import k8s_watcher as twatch

    fake, host = fake_k8s
    made = []
    for k8s, scaler_mod, watch_mod, base, node in (
            (jk8s, jscaler, jwatch, jbase, jnode),
            (tk8s, tscaler, twatch, tbase, tnode)):
        fake.pods.clear()
        client = k8s.K8sClient("default",
                               api=k8s.K8sApi(host=host, token="t"))
        scaler = scaler_mod.PodScaler("demo", client, "m:1", image="img",
                                      command="python train.py",
                                      retry_interval_s=0.05)
        scaler.start()
        try:
            scaler.scale(base.ScalePlan(node_group_resources={
                "worker": node.NodeGroupResource(
                    count=2, node_resource=node.NodeResource(
                        cpu=4.0, chips=8, chip_type="h100"))}))
            deadline = time.time() + 10
            while time.time() < deadline and len(fake.pods) < 2:
                time.sleep(0.02)
        finally:
            scaler.stop()
        fake.set_pod_phase("demo-worker-1", "Running")
        pods = {name: copy.deepcopy(pod) for name, pod in fake.pods.items()}
        nodes = _nodes(watch_mod.K8sPodWatcher(client, "demo").list())
        made.append((pods, nodes))
    (jpods, jnodes), (tpods, tnodes) = made
    assert tpods == {name: to_gpu(pod) for name, pod in jpods.items()}
    assert tnodes == jnodes and len(tnodes) == 2


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_operator_lifecycle_on_the_fake_api_server(fake_k8s):
    """The port's operator adopts an existing CR, creates its master pod
    and service with the env contract, patches the phases, relaunches a
    failed master under a new name, relays a ScalePlan once to a live
    master and drops a deleted job."""
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.scheduler.local import LocalCluster
    from tests.test_torch_job_manager import make_job_args

    fake, host = fake_k8s
    fake.elasticjobs["demo"] = to_gpu(SAMPLE_JOB)
    client = tk8s.K8sClient("default", api=tk8s.K8sApi(host=host,
                                                       token="t"))
    operator = top.K8sElasticJobOperator(client=client,
                                         reconcile_interval_s=0.05)
    operator.start()
    master = None
    try:
        assert _wait(lambda: "demo-master-0" in fake.pods)
        pod = fake.pods["demo-master-0"]
        container = pod["spec"]["containers"][0]
        env = {e["name"]: e["value"] for e in container["env"]}
        assert env["DLROVER_TPU_MASTER_ADDR"] == (
            f"demo-dlrover-master.default:{top.MASTER_PORT}")
        assert "dlrover_tpu_torch.master.job_master" in container[
            "command"][2]
        assert pod["metadata"]["ownerReferences"][0]["uid"] == "u-123"
        assert _wait(lambda: "demo-dlrover-master" in fake.services)
        fake.set_pod_phase("demo-master-0", "Running")
        assert _wait(lambda: any(
            p["body"].get("status", {}).get("phase") == "Running"
            and "elasticjobs/demo" in p["path"] for p in fake.patches))
        master = JobMaster(min_nodes=2, max_nodes=8,
                           job_args=make_job_args(2),
                           cluster=LocalCluster(), host="127.0.0.1")
        master.prepare()
        assert _wait(lambda: len(
            master.job_manager.get_running_workers()) == 2)
        operator._controllers["demo"].master_addr = master.addr
        assert _wait(lambda: fake.watcher_count("scaleplans") > 0)
        plan = {"metadata": {"name": "up"},
                "spec": {"ownerJob": "demo", "replicaResourceSpecs":
                         {NodeType.WORKER: {"replicas": 3}}}}
        fake.push_event("scaleplans", "ADDED", plan)
        assert _wait(lambda: len(
            master.job_manager.get_running_workers()) == 3)
        fake.push_event("scaleplans", "MODIFIED",
                        dict(plan, status={"phase": "Relayed"}))
        time.sleep(0.2)
        relayed = [p for p in fake.patches
                   if "scaleplans/up/status" in p["path"]]
        assert len(relayed) == 1
        fake.set_pod_phase("demo-master-0", "Failed")
        assert _wait(lambda: "demo-master-1" in fake.pods)
        assert operator._controllers["demo"].master_restarts == 1
        assert _wait(lambda: fake.watcher_count("elasticjobs") > 0)
        fake.push_event("elasticjobs", "DELETED", SAMPLE_JOB)
        assert _wait(lambda: "demo" not in operator._controllers)
    finally:
        operator.stop()
        if master is not None:
            master.stop(grace_s=0.1)


def test_k8s_master_reads_its_cr_and_creates_gpu_workers(fake_k8s,
                                                         monkeypatch):
    """``python -m dlrover_tpu_torch.master.job_master --platform k8s``:
    the master reads its ElasticJob CR and the pod scaler creates the
    four workers, each requesting its cards as ``nvidia.com/gpu``."""
    from dlrover_tpu_torch.master import job_master as jm

    fake, host = fake_k8s
    fake.elasticjobs["demo"] = to_gpu(SAMPLE_JOB)
    client = tk8s.K8sClient("default", api=tk8s.K8sApi(host=host,
                                                       token="t"))
    monkeypatch.setattr(tk8s, "K8sClient",
                        lambda namespace="default": client)
    started = {}
    prepare = jm.JobMaster.prepare

    def prepare_and_keep(self):
        prepare(self)
        started["master"] = self

    monkeypatch.setattr(jm.JobMaster, "prepare", prepare_and_keep)
    monkeypatch.setattr(jm.JobMaster, "run", lambda self, *a, **k: 0)
    assert jm.run_master_main(["--platform", "k8s", "--job-name", "demo",
                               "--namespace", "default"]) == 0
    master = started["master"]
    try:
        assert _wait(lambda: sum(1 for name in fake.pods
                                 if "worker" in name) == 4)
        container = fake.pods["demo-worker-0"]["spec"]["containers"][0]
        assert container["resources"]["limits"]["nvidia.com/gpu"] == "4"
        assert TPU_LIMIT not in container["resources"]["limits"]
        env = {e["name"]: e["value"] for e in container["env"]}
        assert env["DLROVER_TPU_MASTER_ADDR"] == master.addr
        assert master.rdzv_managers["elastic-training"]._params \
            .min_nodes == 2
    finally:
        master.stop(grace_s=0.1)


def test_suspended_job_creates_nothing(fake_k8s):
    fake, host = fake_k8s
    fake.elasticjobs["demo"] = to_gpu(dict(
        SAMPLE_JOB, spec=dict(SAMPLE_JOB["spec"], suspend=True)))
    client = tk8s.K8sClient("default", api=tk8s.K8sApi(host=host,
                                                       token="t"))
    operator = top.K8sElasticJobOperator(client=client,
                                         reconcile_interval_s=0.05)
    operator.start()
    try:
        assert _wait(lambda: "demo" in operator._controllers)
        time.sleep(0.3)
        assert "demo-master-0" not in fake.pods
    finally:
        operator.stop()
