"""The port's Ray platform (dlrover_tpu_torch/scheduler/ray.py,
master/scaler/ray_scaler.py, master/watcher/ray_watcher.py) against the
JAX package's, on the CPU, with the fake ``ray`` module of
tests/test_ray_backend.py (no Ray is installed).

Without ``ray`` both clients raise the same ``RuntimeError``. With the
fake, one script of actor lifecycles, scale plans (up, down, a rank hole
refilled), watcher events and a job manager's initial plan runs through
both packages: every actor's creation arguments, resources and status
and every event are the same.
"""

import sys
import time
import types

import pytest

from dlrover_tpu.common.constants import NodeStatus, NodeType
from tests.test_ray_backend import _FAKE_STATE, _build_fake_ray


@pytest.fixture()
def fake_ray(monkeypatch):
    _FAKE_STATE["actors"] = []
    _FAKE_STATE["initialized"] = False
    ray = _build_fake_ray()
    monkeypatch.setitem(sys.modules, "ray", ray)
    return ray


def _pkg(name):
    import importlib

    mod = {k: importlib.import_module(f"{name}.{path}") for k, path in (
        ("ray", "scheduler.ray"), ("scaler", "master.scaler.ray_scaler"),
        ("base", "master.scaler.base"), ("watcher",
                                         "master.watcher.ray_watcher"),
        ("node", "common.node"), ("job", "scheduler.job"),
        ("jm", "master.node.job_manager"),
        ("speed", "master.speed_monitor"))}
    return types.SimpleNamespace(**mod)


JAX, PORT = _pkg("dlrover_tpu"), _pkg("dlrover_tpu_torch")


def test_missing_ray_is_refused_alike(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray", None)
    errors = []
    for pkg in (JAX, PORT):
        with pytest.raises(RuntimeError) as raised:
            pkg.ray.RayClient("demo")
        errors.append(str(raised.value))
    assert errors[1] == errors[0] and "ray" in errors[1]


def _group(pkg, count, cpu=2.0):
    return pkg.node.NodeGroupResource(
        count=count, node_resource=pkg.node.NodeResource(cpu=cpu))


def _actors(client):
    return sorted([h.name, h.node_type, h.node_id, h.rank_index,
                   h.actor.options, [list(a) for a, _ in h.actor.calls],
                   client.actor_status(h.name)]
                  for h in client.list_actors())


def _script(pkg, fake_ray):
    """The trace of one lifecycle through ``pkg``'s client, scaler and
    watcher."""
    _FAKE_STATE["actors"] = []
    _FAKE_STATE["initialized"] = False
    trace = []
    client = pkg.ray.RayClient("demo")
    handle = client.create_agent_actor(
        NodeType.WORKER, 0, 0, "1.2.3.4:50001", ["python", "train.py"],
        num_cpus=2.0)
    trace.append(["created", _actors(client)])
    for done, result in ((True, 0), (True, 1)):
        handle.actor.future.done, handle.actor.future.result = done, result
        trace.append(["status", client.actor_status(handle.name)])
    trace.append(["deleted", client.delete_actor(handle.name),
                  handle.actor.killed, client.actor_status(handle.name)])
    scaler = pkg.scaler.RayScaler("demo", client, master_addr="m:1",
                                  command="python train.py --steps 10")
    plan = pkg.base.ScalePlan
    scaler.scale(plan(node_group_resources={
        NodeType.WORKER: _group(pkg, 3)}))
    trace.append(["up", _actors(client)])
    victim = [h for h in client.list_actors() if h.rank_index == 1][0]
    client.delete_actor(victim.name)
    scaler.scale(plan(node_group_resources={
        NodeType.WORKER: _group(pkg, 3)}))
    trace.append(["hole refilled", _actors(client)])
    scaler.scale(plan(node_group_resources={
        NodeType.WORKER: _group(pkg, 2)}))
    trace.append(["down", _actors(client)])
    with pytest.raises(ValueError) as raised:
        pkg.scaler.RayScaler("demo", client, command="").scale(
            plan(node_group_resources={NodeType.WORKER: _group(pkg, 3)}))
    trace.append(["no command", str(raised.value)])
    watcher = pkg.watcher.RayNodeWatcher(client, poll_interval_s=0.0)
    events = watcher.watch()
    seen = [next(events) for _ in client.list_actors()]
    first = client.list_actors()[0]
    first.actor.future.done, first.actor.future.result = True, 1
    seen.append(next(events))
    client.delete_actor(first.name)
    seen.append(next(events))
    watcher.stop()
    trace.append(["events", [[e.event_type, e.node.name, e.node.type,
                              e.node.id, e.node.status] for e in seen]])
    trace.append(["list", sorted([n.name, n.status]
                                 for n in watcher.list())])
    return trace


def test_lifecycle_matches_jax(fake_ray):
    want = _script(JAX, fake_ray)
    got = _script(PORT, fake_ray)
    assert got == want
    trace = dict((entry[0], entry[1:]) for entry in got)
    assert [s for s in trace["status"]] == [NodeStatus.FAILED]
    assert [a[3] for a in trace["down"][0]] == [0, 1]
    assert [e[0] for e in trace["events"][0]][-2:] == ["MODIFIED",
                                                        "DELETED"]


def test_job_manager_creates_the_actors_as_jax(fake_ray):
    """``create_job_manager`` on the ray platform wires the actor scaler
    and watcher, and its initial plan creates the job's workers."""
    made = []
    for pkg in (JAX, PORT):
        _FAKE_STATE["actors"] = []
        args = pkg.job.JobArgs(platform="ray", job_name="demo",
                               command="python train.py")
        args.node_args[NodeType.WORKER] = pkg.job.NodeArgs(
            group_resource=_group(pkg, 2))
        client = pkg.ray.RayClient("demo")
        manager = pkg.jm.create_job_manager(
            args, master_addr="m:1", speed_monitor=pkg.speed.SpeedMonitor(),
            cluster=client)
        assert type(manager._scaler).__name__ == "RayScaler"
        manager.start()
        try:
            deadline = time.time() + 5
            while time.time() < deadline and len(
                    client.list_actors()) < 2:
                time.sleep(0.02)
            made.append(_actors(client))
        finally:
            manager.stop()
    assert made[1] == made[0] and len(made[1]) == 2
