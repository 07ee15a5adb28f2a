"""The port's job manager, scheduler, watcher, scaler and node-event
callbacks against the JAX package's (tests/test_job_manager.py's cases):
the same ``LocalCluster`` events and requests go to a JAX and a port job
manager under one fixed clock, and the two must agree on every node's
status, relaunch count, memory, exit reason and release, the job's stage
and exit reason, and ``export_state()`` as equal JSON. A JAX master's
snapshot restores into the port's job manager and back; the port's
master routes ``ScaleRequest``, heartbeats and failures to it."""

import dataclasses
import json
import time
import types

import pytest

from dlrover_tpu.common import constants as jconst
from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.common import node as jnode
from dlrover_tpu.master import job_master as jjm
from dlrover_tpu.master.node import event_callback as jcb
from dlrover_tpu.master.node import job_manager as jjob
from dlrover_tpu.master.speed_monitor import SpeedMonitor as JSpeedMonitor
from dlrover_tpu.scheduler import job as jsched
from dlrover_tpu.scheduler import local as jlocal
from dlrover_tpu_torch.common import constants as tconst
from dlrover_tpu_torch.common import messages as tmsg
from dlrover_tpu_torch.common import node as tnode
from dlrover_tpu_torch.master import job_master as tjm
from dlrover_tpu_torch.master.node import event_callback as tcb
from dlrover_tpu_torch.master.node import job_manager as tjob
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor as TSpeedMonitor
from dlrover_tpu_torch.scheduler import factory as tfactory
from dlrover_tpu_torch.scheduler import job as tsched
from dlrover_tpu_torch.scheduler import local as tlocal

JAX = types.SimpleNamespace(
    const=jconst, msg=jmsg, node=jnode, sched=jsched, local=jlocal,
    job=jjob, cb=jcb, SpeedMonitor=JSpeedMonitor, master=jjm)
PORT = types.SimpleNamespace(
    const=tconst, msg=tmsg, node=tnode, sched=tsched, local=tlocal,
    job=tjob, cb=tcb, SpeedMonitor=TSpeedMonitor, master=tjm)
CLOCK = 1.7e9


def make_job_args(workers=3, restart_count=2, pkg=PORT):
    args = pkg.sched.JobArgs(job_name="test-job")
    args.node_args[pkg.const.NodeType.WORKER] = pkg.sched.NodeArgs(
        group_resource=pkg.node.NodeGroupResource(
            count=workers,
            node_resource=pkg.node.NodeResource(
                cpu=4, memory_mb=8192, chips=4, chip_type="h100")),
        restart_count=restart_count,
    )
    return args


def wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def start_manager(pkg, workers=3, restart_count=2):
    cluster = pkg.local.LocalCluster()
    manager = pkg.job.create_job_manager(
        make_job_args(workers, restart_count, pkg),
        master_addr="127.0.0.1:0", speed_monitor=pkg.SpeedMonitor(),
        cluster=cluster)
    manager.start()
    assert wait_until(
        lambda: len(manager.get_running_workers()) == workers)
    return cluster, manager


@pytest.fixture
def fixed_clock(monkeypatch):
    """Node timestamps read time.time(): one constant for both packages,
    so their exported states compare as JSON."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)


# ---------------------------------------------------------------------------
# scenarios: the same events for either package, ending in a settled state
# ---------------------------------------------------------------------------


def _running(pkg, cluster):
    return [p for p in cluster.list_pods(pkg.const.NodeType.WORKER)
            if p.status == pkg.const.NodeStatus.RUNNING]


def _pod(pkg, cluster, rank):
    return [p for p in _running(pkg, cluster) if p.rank_index == rank][0]


def _relaunch(pkg):
    cluster, manager = start_manager(pkg, workers=2)
    victim = _pod(pkg, cluster, 0)
    cluster.fail_pod(victim.name, pkg.const.NodeExitReason.UNKNOWN_ERROR)
    assert wait_until(lambda: len(_running(pkg, cluster)) == 2
                      and len(manager.get_nodes()) == 3)
    return cluster, manager


def _oom(pkg):
    cluster, manager = start_manager(pkg, workers=1)
    cluster.fail_pod(_pod(pkg, cluster, 0).name,
                     pkg.const.NodeExitReason.OOM)
    assert wait_until(lambda: len(_running(pkg, cluster)) == 1
                      and len(manager.get_nodes()) == 2)
    return cluster, manager


def _drained(pkg):
    cluster, manager = start_manager(pkg, workers=2)
    cluster.fail_pod(_pod(pkg, cluster, 1).name,
                     pkg.const.NodeExitReason.DRAINED)
    assert wait_until(lambda: len(_running(pkg, cluster)) == 2
                      and len(manager.get_nodes()) == 3)
    return cluster, manager


def _fatal(pkg):
    cluster, manager = start_manager(pkg, workers=1, restart_count=3)
    cluster.fail_pod(_pod(pkg, cluster, 0).name,
                     pkg.const.NodeExitReason.FATAL_ERROR)
    assert wait_until(
        lambda: manager.job_stage() == pkg.const.JobStage.FAILED)
    return cluster, manager


def _budget(pkg):
    cluster, manager = start_manager(pkg, workers=1, restart_count=1)
    cluster.fail_pod(_pod(pkg, cluster, 0).name,
                     pkg.const.NodeExitReason.UNKNOWN_ERROR)
    assert wait_until(lambda: len(_running(pkg, cluster)) == 1
                      and len(manager.get_nodes()) == 2)
    cluster.fail_pod(_pod(pkg, cluster, 0).name,
                     pkg.const.NodeExitReason.UNKNOWN_ERROR)
    assert wait_until(
        lambda: manager.job_stage() == pkg.const.JobStage.FAILED)
    return cluster, manager


def _succeeded(pkg):
    cluster, manager = start_manager(pkg, workers=2)
    for pod in cluster.list_pods(pkg.const.NodeType.WORKER):
        cluster.set_status(pod.name, pkg.const.NodeStatus.SUCCEEDED)
    assert wait_until(
        lambda: manager.job_stage() == pkg.const.JobStage.SUCCEEDED)
    return cluster, manager


def _rank_holes(pkg):
    cluster, manager = start_manager(pkg, workers=3)
    cluster.fail_pod(_pod(pkg, cluster, 1).name,
                     pkg.const.NodeExitReason.UNKNOWN_ERROR)
    assert wait_until(lambda: len(manager.get_running_workers()) == 3
                      and len(manager.get_nodes()) == 4)
    manager.handle_scale_request(
        pkg.msg.ScaleRequest(node_type=pkg.const.NodeType.WORKER, count=5))
    assert wait_until(lambda: len(manager.get_running_workers()) == 5)
    assert sorted(p.rank_index for p in _running(pkg, cluster)) == [
        0, 1, 2, 3, 4]
    return cluster, manager


def _manual_scale(pkg):
    cluster, manager = start_manager(pkg, workers=2)
    manager.handle_scale_request(
        pkg.msg.ScaleRequest(node_type=pkg.const.NodeType.WORKER, count=4))
    assert wait_until(lambda: len(_running(pkg, cluster)) == 4
                      and len(manager.get_running_workers()) == 4)
    manager.handle_scale_request(
        pkg.msg.ScaleRequest(node_type=pkg.const.NodeType.WORKER, count=1))
    assert wait_until(
        lambda: len(manager.get_running_workers()) == 1
        and len(cluster.list_pods(pkg.const.NodeType.WORKER)) == 1)
    assert cluster.list_pods(pkg.const.NodeType.WORKER)[0].rank_index == 0
    return cluster, manager


def _failure_report(pkg):
    """An agent's NODE_ERROR report marks the host for replacement and
    raises the relaunch count to the agent's restarts."""
    cluster, manager = start_manager(pkg, workers=2)
    manager.handle_failure_report(pkg.msg.NodeFailureReport(
        node_id=1, restart_count=2,
        level=pkg.const.TrainingMsgLevel.NODE_ERROR))
    manager.collect_model_info(pkg.msg.ModelInfo(param_count=7,
                                                 batch_size=4))
    manager.update_node_resource_usage(pkg.msg.NodeResourceStats(
        node_id=0, node_type=pkg.const.NodeType.WORKER, cpu_percent=55.0,
        memory_mb=1234.0))
    return cluster, manager


SCENARIOS = {f.__name__[1:]: f for f in (
    _relaunch, _oom, _drained, _fatal, _budget, _succeeded, _rank_holes,
    _manual_scale, _failure_report)}


def _summary(manager):
    nodes = sorted(
        (n.type, n.id, n.rank_index, n.status, n.relaunch_count,
         n.config_resource.memory_mb, n.exit_reason, n.is_released,
         n.relaunchable, n.used_resource.cpu, n.used_resource.memory_mb)
        for n in manager.get_nodes())
    return {"nodes": nodes, "stage": manager.job_stage(),
            "exit_reason": manager.exit_reason(),
            "state": json.dumps(manager.export_state(), sort_keys=True)}


def _settled(pkg, cluster, manager):
    """Every event of the scenario processed: the manager's view of each
    node is its pod's status (DELETED once the pod is gone)."""
    pods = {p.name: p.status for p in cluster.list_pods()}
    return all(n.status == pods.get(n.name, pkg.const.NodeStatus.DELETED)
               for n in manager.get_nodes())


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_job_manager_matches_jax(scenario, fixed_clock):
    summaries = []
    for pkg in (JAX, PORT):
        cluster, manager = SCENARIOS[scenario](pkg)
        try:
            assert wait_until(lambda: _settled(pkg, cluster, manager))
            summaries.append(_summary(manager))
        finally:
            manager.stop()
    assert summaries[1] == summaries[0]


def test_scenarios_reach_their_ends(fixed_clock):
    """What each settled state holds (the parity test holds the port to
    the same)."""
    _, manager = _oom(PORT)
    manager.stop()
    replacement = [n for n in manager.get_nodes() if n.relaunch_count][0]
    assert replacement.config_resource.memory_mb == 8192 * 1.5
    _, manager = _drained(PORT)
    manager.stop()
    assert all(n.relaunch_count == 0 for n in manager.get_nodes())
    _, manager = _budget(PORT)
    manager.stop()
    assert manager.exit_reason() == "all workers failed unrecoverably"


# ---------------------------------------------------------------------------
# typed heartbeats
# ---------------------------------------------------------------------------


def _manager_with_chief(pkg):
    args = make_job_args(workers=1, pkg=pkg)
    args.node_args[pkg.const.NodeType.CHIEF] = pkg.sched.NodeArgs(
        group_resource=pkg.node.NodeGroupResource(
            count=1, node_resource=pkg.node.NodeResource(cpu=1)))
    manager = pkg.job.create_job_manager(
        args, master_addr="127.0.0.1:0", speed_monitor=pkg.SpeedMonitor(),
        cluster=pkg.local.LocalCluster())
    manager._init_nodes()
    return manager


@pytest.mark.parametrize("node_type", ["worker", "ps", ""])
def test_typed_heartbeats_match_jax(node_type, fixed_clock):
    """A worker beat refreshes only the worker with that id, a typed miss
    falls back to the untyped scan, an untyped beat refreshes every
    group, in both packages."""
    beats = []
    for pkg in (JAX, PORT):
        manager = _manager_with_chief(pkg)
        manager.collect_heartbeat(0, 123.0, node_type=node_type)
        beats.append(sorted((n.type, n.heartbeat_time)
                            for n in manager.get_nodes()))
    assert beats[1] == beats[0]
    if node_type == "worker":
        assert beats[1] == [("chief", 0.0), ("worker", 123.0)]


# ---------------------------------------------------------------------------
# the snapshot's job_manager key across the packages
# ---------------------------------------------------------------------------


def _master(pkg, cluster=None, workers=2, state=None, state_dir=""):
    kwargs = ({} if state is None else
              {"preloaded_state": (state, 3), "state_dir": state_dir})
    return pkg.master.JobMaster(
        min_nodes=workers, max_nodes=workers,
        job_args=make_job_args(workers, pkg=pkg),
        cluster=cluster if cluster is not None else pkg.local.LocalCluster(),
        host="127.0.0.1", **kwargs)


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_snapshot_job_manager_key_crosses_packages(writer, reader,
                                                   fixed_clock, tmp_path):
    """One package's master after a relaunch exports ``job_manager``; the
    other package's master restores it (before start) and exports the
    same JSON; restarted, both adopt the surviving pods alike."""
    cluster = writer.local.LocalCluster()
    master = _master(writer, cluster)
    master.prepare()
    try:
        assert wait_until(
            lambda: len(master.job_manager.get_running_workers()) == 2)
        cluster.fail_pod(_pod(writer, cluster, 0).name,
                         writer.const.NodeExitReason.UNKNOWN_ERROR)
        assert wait_until(
            lambda: len(master.job_manager.get_running_workers()) == 2
            and len(master.job_manager.get_nodes()) == 3)
        master.servicer.report(writer.msg.ModelInfo(param_count=9,
                                                    batch_size=2))
        snapshot = master._export_state()
    finally:
        master.stop()
    exported = json.dumps(snapshot["job_manager"], sort_keys=True)
    restored = _master(reader, state=json.loads(json.dumps(snapshot)),
                       state_dir=str(tmp_path / "state"))
    try:
        assert json.dumps(restored.job_manager.export_state(),
                          sort_keys=True) == exported
        assert json.dumps(restored._export_state()["job_manager"],
                          sort_keys=True) == exported
        assert restored.job_manager.get_nodes()[2].relaunch_count == 1
    finally:
        restored.stop()


def test_master_without_job_manager_ignores_the_key(tmp_path):
    """As the JAX master: no job manager, no ``job_manager`` key written,
    and a snapshot's key ignored."""
    state = {"generation": 1, "job_manager": {"stage": "running"}}
    master = tjm.JobMaster(port=0, host="127.0.0.1",
                           state_dir=str(tmp_path / "state"),
                           preloaded_state=(state, 2))
    try:
        assert master.job_manager is None and master.generation == 2
        assert "job_manager" not in master._export_state()
    finally:
        master.stop(grace_s=0.1)


# ---------------------------------------------------------------------------
# the master's wiring
# ---------------------------------------------------------------------------


def test_port_master_routes_to_its_job_manager():
    """ScaleRequest through the servicer (no longer refused), typed
    heartbeats and failure reports to the job manager, JobStatus from its
    stage, PsFailoverCallback's version bump on a failure, a shard of
    the dead worker requeued, and run() ending on success."""
    cluster = tlocal.LocalCluster()
    master = _master(PORT, cluster)
    master.prepare()
    try:
        manager = master.job_manager
        assert wait_until(lambda: len(manager.get_running_workers()) == 2)
        servicer = master.servicer
        answer = servicer.report(tmsg.ScaleRequest(node_type="worker",
                                                   count=3))
        assert answer.success
        assert wait_until(lambda: len(manager.get_running_workers()) == 3)
        servicer.report(tmsg.NodeHeartbeat(node_id=1, node_type="worker",
                                           timestamp=42.0))
        assert manager.get_nodes("worker")[1].heartbeat_time == 42.0
        assert servicer.get(tmsg.JobStatusRequest()).stage == "running"
        servicer.report(tmsg.DatasetShardParams(
            dataset_name="d", dataset_size=8, shard_size=2, num_epochs=1))
        task = servicer.get(tmsg.TaskRequest(worker_id=2, dataset_name="d"))
        assert task.task_id >= 0
        assert master.task_manager.get_dataset("d").counts()[1] == 1
        cluster.fail_pod("worker-2", tconst.NodeExitReason.UNKNOWN_ERROR)
        assert wait_until(lambda: master.elastic_ps_service
                          .get_cluster_version("global", "worker", 0) == 1)
        assert master.task_manager.get_dataset("d").counts() == (4, 0)
        thread = master.run_in_thread(poll_interval_s=0.05)
        assert wait_until(lambda: len(manager.get_running_workers()) == 3)
        for pod in cluster.list_pods("worker"):
            cluster.set_status(pod.name, tconst.NodeStatus.SUCCEEDED)
        thread.join(timeout=5)
        assert not thread.is_alive()
        assert manager.job_stage() == tconst.JobStage.SUCCEEDED
    finally:
        master.stop()


def test_scale_request_without_job_manager_is_refused_as_jax():
    answers = []
    for pkg in (JAX, PORT):
        master = pkg.master.JobMaster(port=0, host="127.0.0.1")
        try:
            answers.append(dataclasses.asdict(master.servicer.report(
                pkg.msg.ScaleRequest(node_type="worker", count=2))))
        finally:
            master.stop(grace_s=0.1)
    assert answers[1] == answers[0]
    assert answers[1]["success"] is False


def test_unported_platforms_are_refused():
    """Kubernetes and Ray are ported: a k8s job manager gets the pod
    scaler and watcher; Ray without its package, and a platform neither
    package knows, are refused as the JAX package refuses them."""
    from dlrover_tpu.master.node import job_manager as jjob
    from dlrover_tpu.scheduler import factory as jfactory
    from dlrover_tpu_torch.master.scaler.pod_scaler import PodScaler
    from dlrover_tpu_torch.master.watcher.k8s_watcher import K8sPodWatcher
    from dlrover_tpu_torch.scheduler.kubernetes import K8sClient

    args = make_job_args(1)
    args.platform = "k8s"
    manager = tjob.create_job_manager(args)
    assert isinstance(manager._scaler, PodScaler)
    assert isinstance(manager._watcher, K8sPodWatcher)
    assert isinstance(tfactory.new_platform_cluster("k8s"), K8sClient)
    args.platform = "ray"
    errors = []
    for create in (jjob.create_job_manager, tjob.create_job_manager):
        with pytest.raises(RuntimeError) as raised:
            create(args)
        errors.append(str(raised.value))
    assert errors[1] == errors[0]
    for platform in ("ray", "slurm"):
        for factory in (jfactory, tfactory):
            with pytest.raises(ValueError):
                factory.new_platform_cluster(platform)


def test_node_and_job_args_match_jax():
    """Node serialization, the state flows, and a parsed ElasticJob spec
    are the JAX package's."""
    spec = {"distributionStrategy": "ps", "optimizeMode": "manual",
            "replicaSpecs": {
                "worker": {"replicas": 3, "restartCount": 5,
                           "resource": {"cpu": 8, "memoryMb": 4096,
                                        "chips": 8}},
                "ps": {"replicas": 1}, "bogus": {"replicas": 9}}}
    want = dataclasses.asdict(jsched.JobArgs.from_spec(spec, "j"))
    assert dataclasses.asdict(tsched.JobArgs.from_spec(spec, "j")) == want
    node = jnode.Node("worker", 4, rank_index=1, max_relaunch_count=2)
    node.exit_reason, node.relaunch_count = "oom", 1
    as_dict = node.to_dict()
    assert tnode.Node.from_dict(as_dict).to_dict() == as_dict
    for a in (jconst.NodeStatus.INITIAL, jconst.NodeStatus.PENDING,
              jconst.NodeStatus.RUNNING, jconst.NodeStatus.FAILED,
              jconst.NodeStatus.SUCCEEDED, jconst.NodeStatus.DELETED):
        for b in (jconst.NodeStatus.PENDING, jconst.NodeStatus.RUNNING,
                  jconst.NodeStatus.FAILED, jconst.NodeStatus.DELETED,
                  jconst.NodeStatus.BREAKDOWN):
            for event in ("added", "modified", "deleted"):
                flows = [mod.get_node_state_flow(a, event, b)
                         for mod in (jnode, tnode)]
                assert [f and dataclasses.asdict(f) for f in flows][0] == \
                    [f and dataclasses.asdict(f) for f in flows][1]
    for cls in ("PlatformType", "DistributionStrategy", "OptimizeMode",
                "NodeEventType"):
        port = {k: v for k, v in vars(getattr(tconst, cls)).items()
                if k.isupper()}
        assert port == {k: getattr(getattr(jconst, cls), k) for k in port}
    assert tconst.DefaultValues.METRICS_PORT == \
        jconst.DefaultValues.METRICS_PORT
    assert tconst.DefaultValues.SECONDS_PER_SCALE_CHECK == \
        jconst.DefaultValues.SECONDS_PER_SCALE_CHECK


def test_membership_callback_drops_the_failed_rank():
    """RendezvousMembershipCallback and TaskRescheduleCallback over the
    port's rendezvous and a task manager, as the JAX case."""
    from dlrover_tpu_torch.master.rendezvous import (
        ElasticTrainingRendezvousManager,
        RendezvousParameters,
    )

    class FakeTaskManager:
        def __init__(self):
            self.recovered = []

        def recover_tasks(self, worker_id):
            self.recovered.append(worker_id)

    cluster = tlocal.LocalCluster()
    speed = TSpeedMonitor()
    rdzv = ElasticTrainingRendezvousManager(
        RendezvousParameters(min_nodes=1, max_nodes=4))
    task_manager = FakeTaskManager()
    manager = tjob.create_job_manager(make_job_args(2), speed_monitor=speed,
                                      cluster=cluster)
    manager.add_event_callback(tcb.TaskRescheduleCallback(task_manager))
    manager.add_event_callback(
        tcb.RendezvousMembershipCallback({"training": rdzv}, speed))
    manager.start()
    try:
        assert wait_until(lambda: len(manager.get_running_workers()) == 2)
        assert rdzv.alive_nodes == {0, 1}
        victim = cluster.list_pods("worker")[0]
        cluster.fail_pod(victim.name, tconst.NodeExitReason.UNKNOWN_ERROR)
        assert wait_until(lambda: victim.node_id in task_manager.recovered)
    finally:
        manager.stop()
