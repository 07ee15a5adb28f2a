"""The port's brain (dlrover_tpu_torch/brain/: the sqlite store, the
optimizer algorithms, the service and its client, reporter and resource
optimizer) against the JAX package's, on the CPU.

The same records go into both packages' stores under one fixed clock:
every query, the completed-job list and the three algorithms' plans are
equal, and a database file written by either package reads the same in
the other. Both services answer the same request bytes with the same
reply bytes. Over gRPC, each package's client talks to the other's
service, the reporter persists and the optimizer's plans (the brain's,
else the local fallback) are the JAX optimizer's.
"""

import dataclasses
import json
import types

import pytest

from dlrover_tpu.brain import algorithms as jalg
from dlrover_tpu.brain import client as jclient
from dlrover_tpu.brain import datastore as jstore
from dlrover_tpu.brain import service as jservice
from dlrover_tpu.common import messages as J
from dlrover_tpu_torch.brain import algorithms as talg
from dlrover_tpu_torch.brain import client as tclient
from dlrover_tpu_torch.brain import datastore as tstore
from dlrover_tpu_torch.brain import service as tservice
from dlrover_tpu_torch.common import messages as T

JAX = types.SimpleNamespace(store=jstore, alg=jalg, service=jservice,
                            client=jclient, msg=J)
PORT = types.SimpleNamespace(store=tstore, alg=talg, service=tservice,
                             client=tclient, msg=T)


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    """Each store stamps ``created_at`` from a counting clock of its
    own, both starting at the same instant."""
    for module in (jstore, tstore):
        ticks = iter(range(10 ** 6))
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            time=lambda ticks=ticks: 1.7e9 + next(ticks)))


def _records():
    """(job, record type, payload): completed jobs of three model sizes
    for the cold-start plan, one job's runtime peaks for the OOM plan,
    and a hot host's runtime samples."""
    records = []
    for i, (params, workers, cpu, mem, chips) in enumerate([
            (1.0e9, 4, 16.0, 65536.0, 8), (1.2e9, 6, 32.0, 131072.0, 8),
            (0.9e9, 2, 8.0, 32768.0, 4), (9.0e9, 64, 96.0, 1e6, 8)]):
        job = f"done-{i}"
        records += [
            (job, "model", {"job": job, "param_count": params}),
            (job, "job_meta", {"job": job, "worker_count": workers,
                               "cpu": cpu, "memory_mb": mem,
                               "chips": chips}),
            (job, "job_exit", {"job": job, "stage": "succeeded"}),
        ]
    records.append(("failed-0", "job_exit",
                    {"job": "failed-0", "stage": "failed"}))
    for peak in (20000.0, 31000.0, 27000.0):
        records.append(("oom", "runtime", {"job": "oom",
                                           "peak_memory_mb": peak}))
    for cpu, duty in ((95.0, 20.0), (97.0, 10.0), (40.0, 90.0)):
        records.append(("hot", "runtime", {"job": "hot",
                                           "cpu_percent": cpu,
                                           "chip_duty_cycle_pct": duty}))
    return records


def _fill(pkg, path=":memory:"):
    store = pkg.store.MetricsStore(path)
    for job, kind, payload in _records():
        store.persist(job, kind, payload, job_uuid=f"uuid-{job}")
    return store


QUERIES = [dict(), dict(job_name="oom"), dict(record_type="job_exit"),
           dict(job_name="done-1", record_type="job_meta"),
           dict(job_name="hot", limit=2), dict(job_name="nobody")]
PLANS = [("job-create", "new", {"param_count": 1.0e9}),
         ("job-create", "new", {}),
         ("oom-recovery", "oom", {"memory_mb": 16384}),
         ("oom-recovery", "nobody", {}),
         ("running", "hot", {}), ("running", "oom", {}),
         ("unknown-stage", "oom", {})]


def _answers(store, pkg):
    return ([store.query(**q) for q in QUERIES],
            store.completed_jobs(), store.completed_jobs(limit=2),
            [pkg.alg.run_algorithm(stage, store, job, dict(config))
             for stage, job, config in PLANS])


def test_store_queries_and_plans_match_jax():
    want = _answers(_fill(JAX), JAX)
    got = _answers(_fill(PORT), PORT)
    assert got == want
    plans = got[3]
    assert plans[0]["node_group_resources"]["worker"]["count"] == 4
    assert plans[2]["node_group_resources"]["worker"]["memory_mb"] == \
        pytest.approx(31000.0 * 1.8)
    assert plans[4] == {"dataloader_workers": 2}
    assert plans[3] == plans[6] == {}


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_a_database_file_reads_the_same_in_either_package(
        tmp_path, writer, reader):
    path = str(tmp_path / "brain.sqlite")
    written = _answers(_fill(writer, path), writer)
    assert _answers(reader.store.MetricsStore(path), reader) == written


def _requests(m):
    return [
        ("report", m.BrainMetricsReport(
            job_name="oom", job_uuid="u", record_type="runtime",
            payload_json=json.dumps({"peak_memory_mb": 40000.0}))),
        ("report", m.BrainMetricsReport(job_name="x", record_type="r",
                                        payload_json="{not json")),
        ("report", m.GoodputRequest()),
        ("get", m.BrainOptimizeRequest(
            job_name="oom", stage="oom-recovery",
            config_json=json.dumps({"memory_mb": 1000}))),
        ("get", m.BrainOptimizeRequest(job_name="new", stage="job-create",
                                       config_json="")),
        ("get", m.BrainOptimizeRequest(job_name="x", stage="nope")),
        ("get", m.BrainJobMetricsRequest(job_name="oom",
                                         record_type="runtime")),
        ("get", m.BrainJobMetricsRequest()),
        ("get", m.JobStatusRequest()),
    ]


def _service_bytes(pkg):
    service = pkg.service.BrainService(store=_fill(pkg), port=0,
                                       host="127.0.0.1")
    try:
        out = []
        for kind, request in _requests(pkg.msg):
            send = (service._report_bytes if kind == "report"
                    else service._get_bytes)
            out.append(send(pkg.msg.serialize_message(request), None))
        return out
    finally:
        service.stop(0)


def test_service_replies_match_jax_byte_for_byte():
    want = _service_bytes(JAX)
    got = _service_bytes(PORT)
    assert got == want
    plan = T.deserialize_message(got[3])
    assert plan.found and json.loads(plan.plan_json)[
        "node_group_resources"]["worker"]["memory_mb"] == 40000.0 * 1.8
    assert T.deserialize_message(got[1]).reason == "bad payload"


def _plan_dict(plan):
    return json.loads(json.dumps(dataclasses.asdict(plan)))


@pytest.mark.parametrize("service_pkg,client_pkg",
                         [(PORT, PORT), (JAX, PORT), (PORT, JAX)])
def test_client_reporter_and_optimizer_over_the_wire(service_pkg,
                                                     client_pkg):
    """Each package's client against either service: persisted records
    read back, the reporter's records land, the optimizer's plan is the
    brain's where it has one and the local optimizer's where not, the
    same plans the JAX optimizer gets from the same service."""
    service = service_pkg.service.BrainService(
        store=_fill(service_pkg), port=0, host="127.0.0.1")
    service.start()
    addr = f"127.0.0.1:{service.port}"
    try:
        client = client_pkg.client.BrainClient(addr)
        assert client.persist_metrics("live", "model",
                                      {"param_count": 5})
        reporter = client_pkg.client.BrainReporter(addr, "live", "uuid-9")
        reporter.report("runtime", {"peak_memory_mb": 12000.0})
        records = client.get_job_metrics("live")
        assert [(r["record_type"], r["job_uuid"], r["payload"])
                for r in records] == [
            ("runtime", "uuid-9", {"peak_memory_mb": 12000.0}),
            ("model", "", {"param_count": 5})]
        assert client.optimize("live", "nope") == {}
        plans = []
        for pkg in (JAX, client_pkg):
            optimizer = pkg.client.BrainResourceOptimizer(addr, "live")
            plans.append([_plan_dict(optimizer.generate_plan(stage, cfg))
                          for stage, cfg in (
                              ("oom-recovery", {"memory_mb": 1000}),
                              ("job-create", {"param_count": 1.0e9}),
                              ("job-create", {"worker_count": 3}),
                              ("running", {}))])
        assert plans[1] == plans[0]
        oom, create, _, _ = plans[1]
        worker = oom["node_group_resources"]["worker"]
        assert worker["node_resource"]["memory_mb"] == pytest.approx(
            12000.0 * 1.8)
        assert create["node_group_resources"]["worker"]["count"] == 4
    finally:
        service.stop(0)


def test_a_dead_brain_falls_back_to_the_local_optimizer():
    """The brain is advisory: the reporter swallows a dead brain and the
    optimizer answers the local plan, as the JAX one does."""
    from dlrover_tpu.master.resource.local_optimizer import (
        LocalResourceOptimizer as JLocal,
    )

    reporter = tclient.BrainReporter("127.0.0.1:1", "j")
    reporter._client._timeout_s = 0.5
    reporter.report("runtime", {"x": 1})
    optimizer = tclient.BrainResourceOptimizer("127.0.0.1:1", "j")
    optimizer._client._timeout_s = 0.5
    config = {"worker_count": 3, "cpu": 4}
    assert _plan_dict(optimizer.generate_plan("job-create", config)) == \
        _plan_dict(JLocal().generate_plan("job-create", config))
