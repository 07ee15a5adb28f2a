"""The port's ElasticJob reconciler (dlrover_tpu_torch/operator/native.py,
controller.py, built by dlrover_tpu_torch/native_build.py) against the
JAX package's, on the CPU.

The native table is built by the port's own loader from native/*.cpp
into build/native/ (never native/*.so). For every case of
tests/test_operator.py and a grid of observations around them, its
actions equal the JAX package's and the port's plain table. The
controller's lifecycle on a LocalCluster (master created, running,
succeeded; the relaunch budget; a scale plan relayed to a live master)
goes as the JAX controller's.
"""

import dataclasses
import itertools
import time
import types

import pytest

from dlrover_tpu.operator import controller as jcontroller
from dlrover_tpu.operator import native as jnative
from dlrover_tpu.scheduler import local as jlocal
from dlrover_tpu_torch import native_build
from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.operator import controller as tcontroller
from dlrover_tpu_torch.operator import native as tnative
from dlrover_tpu_torch.scheduler import local as tlocal
from tests.test_operator import CASES

JAX = types.SimpleNamespace(native=jnative, controller=jcontroller,
                            local=jlocal)
PORT = types.SimpleNamespace(native=tnative, controller=tcontroller,
                             local=tlocal)


def test_the_library_is_built_from_the_sources_into_build():
    path = native_build.so_path()
    before = tnative.native_calls
    tnative.reconcile(tnative.JobObserved())
    assert tnative.native_calls == before + 1
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    assert native_build.source_digest() in path.name
    lib = native_build.load_native()
    assert lib._name == str(path)
    assert lib.reconciler_abi_version() == \
        jnative.load_native().reconciler_abi_version()


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "native"
    bad.mkdir()
    for name in native_build.SOURCES:
        (bad / name).write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "NATIVE_DIR", bad)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native_build.NativeBuildError, match="g\\+\\+"):
        native_build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def _port_observed(jax_observed):
    return tnative.JobObserved(**dataclasses.asdict(jax_observed))


def _pairs(actions):
    return [(a.kind, a.arg) for a in actions]


@pytest.mark.parametrize("observed,expected", CASES)
def test_decision_table_matches_jax(observed, expected):
    port = _port_observed(observed)
    want = _pairs(jnative.reconcile(observed))
    assert _pairs(tnative.reconcile(port)) == want
    assert _pairs(tnative._native_reconcile(port)) == want
    assert _pairs(tnative._python_reconcile(port)) == want
    assert [kind for kind, _ in want] == expected


def _grid():
    """Every job phase × master phase × restart budget × suspension ×
    pending plan, and the worker roll-ups without a master."""
    for job, master, restarts, suspended, pending in itertools.product(
            range(6), range(5), (0, 2, 3), (False, True), (False, True)):
        yield dict(job_phase=job, master_phase=master,
                   master_restarts=restarts, max_master_restarts=3,
                   suspended=suspended, pending_scale_plan=pending)
    for total, succeeded, failed in ((2, 2, 0), (2, 0, 2), (3, 1, 1),
                                     (0, 0, 0)):
        yield dict(job_phase=2, master_phase=0, workers_total=total,
                   workers_running=total - succeeded - failed,
                   workers_succeeded=succeeded,
                   workers_failed_unrecoverable=failed)


def test_native_and_plain_tables_match_jax_over_a_grid():
    for fields in _grid():
        want = _pairs(jnative._python_reconcile(
            jnative.JobObserved(**fields)))
        port = tnative.JobObserved(**fields)
        assert _pairs(tnative._native_reconcile(port)) == want, fields
        assert _pairs(tnative._python_reconcile(port)) == want, fields


def _lifecycle(pkg):
    """Phases and master pods through a job's life, and a relaunch
    budget of one running out."""
    trace = []
    cluster = pkg.local.LocalCluster()
    controller = pkg.controller.ElasticJobController("j", cluster)
    for step in range(3):
        observed = controller.reconcile_once()
        masters = cluster.list_pods(NodeType.MASTER)
        trace.append([dataclasses.asdict(observed), controller.phase,
                      sorted((p.name, p.status) for p in masters)])
        if step == 1:
            cluster.set_status(masters[0].name, NodeStatus.SUCCEEDED)
    cluster = pkg.local.LocalCluster()
    controller = pkg.controller.ElasticJobController(
        "j", cluster, max_master_restarts=1)
    controller.reconcile_once()
    for _ in range(2):
        live = [p for p in cluster.list_pods(NodeType.MASTER)
                if p.status != NodeStatus.DELETED]
        cluster.fail_pod(live[0].name)
        controller.reconcile_once()
        trace.append([controller.master_restarts, controller.phase])
    controller.submit_scale_plan(NodeType.WORKER, 3)
    trace.append(["pending", dict(controller.pending_scale_plans)])
    return trace


def test_controller_lifecycle_matches_jax():
    want = _lifecycle(JAX)
    got = _lifecycle(PORT)
    assert got == want
    assert got[2][1] == tnative.JobPhase.SUCCEEDED
    assert got[4] == [1, tnative.JobPhase.FAILED]


def test_scale_plan_relayed_to_a_live_master():
    """A ScalePlan submitted to the controller reaches the port's
    job-managed master over gRPC and scales its workers 2 → 3."""
    from dlrover_tpu_torch.master.job_master import JobMaster
    from tests.test_torch_job_manager import make_job_args

    cluster = tlocal.LocalCluster()
    masters = []

    def master_factory():
        master = JobMaster(min_nodes=2, max_nodes=8,
                           job_args=make_job_args(2), cluster=cluster,
                           host="127.0.0.1")
        master.prepare()
        masters.append(master)
        return master, master.addr

    controller = tcontroller.ElasticJobController(
        "j", cluster, master_factory=master_factory)
    try:
        controller.reconcile_once()
        master = masters[0]
        assert controller.master_addr == master.addr

        def running(n):
            deadline = time.time() + 10
            while time.time() < deadline:
                if len(master.job_manager.get_running_workers()) == n:
                    return True
                time.sleep(0.02)
            return False

        assert running(2)
        controller.submit_scale_plan(NodeType.WORKER, 3)
        controller.reconcile_once()
        controller.reconcile_once()
        assert running(3)
        assert controller.pending_scale_plans == {}
    finally:
        for master in masters:
            master.stop(grace_s=0.1)
