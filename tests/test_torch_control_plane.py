"""The port's control plane against the JAX package's.

- One scripted request sequence goes through the JAX ``MasterServicer``
  and the port's, each built by its ``JobMaster`` (the JAX one with the
  single-lock rendezvous, ``rdzv_sharded=False``), through
  ``get_bytes``/``report_bytes`` with no server, under one injected
  clock: the decoded responses are equal, and so are the two speed
  monitors' step, tokens/s and MFU.
- ``RelaunchGovernor``'s delays and quarantine decisions equal the JAX
  one's on the same fake clock.
- Over the real transport (gRPC on a free localhost port): the port's
  ``MasterClient`` against the port's master, against the JAX master,
  and the JAX client against the port's master, the observation calls
  (diagnosis, time series, step traces, clock probe) among them.
- The observation plane: the six requests the port once refused answer
  the JAX servicer's bytes over a diagnosis manager, a tsdb and a
  step-trace assembler on one fake clock, a drain notice at world 2
  fans a checkpoint out to the survivor, and a survivor's agent (the
  CLI on the CPU) turns that checkpoint into a save-and-continue.
"""

import dataclasses
import json
import time

import pytest

from dlrover_tpu.agent.elastic_agent import RelaunchGovernor as JGovernor
from dlrover_tpu.agent.master_client import MasterClient as JClient
from dlrover_tpu.common import messages as J
from dlrover_tpu.common.config import Context as JContext
from dlrover_tpu.master.job_master import JobMaster as JMaster
from dlrover_tpu_torch.agent.elastic_agent import RelaunchGovernor
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import messages as T
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.master.job_master import JobMaster

TRAIN = RendezvousName.TRAINING


@pytest.fixture
def contexts(monkeypatch, tmp_path):
    """Both packages' Context singletons, fresh, with the JAX master on
    its single-lock rendezvous and single-tier KV (what the port has)."""
    for key, value in {"DLROVER_TPU_RDZV_SHARDED": "0",
                       "DLROVER_TPU_COORD_PORT": "-1",
                       "DLROVER_TPU_DIAGNOSIS_ENABLED": "0",
                       "DLROVER_TPU_FLIGHT_DIR": str(tmp_path)}.items():
        monkeypatch.setenv(key, value)
    JContext.reset()
    Context.reset()
    yield JContext.singleton(), Context.singleton()
    JContext.reset()
    Context.reset()


# fields the JAX master fills from a subsystem the port leaves out (each
# asserted "" on the port's side below); none since the port's
# re-planner stamps the same parallelism plan on every join
UNPORTED_FIELDS = {}


class FakeClock:
    def __init__(self, start=1.7e9):
        self.now = start

    def __call__(self):
        return self.now


# (kind, message name, fields) in order; "tick" advances the clock,
# "speed" reads the speed monitor
SEQUENCE = [
    # the model first: both masters' re-planners stamp their plans on
    # every join from this profile
    ("report", "ModelInfo",
     dict(param_count=1_000_000, param_bytes=4_000_000,
          flops_per_step=6e6 * 4096, batch_size=8, seq_len=512,
          flops_per_token=6e6, peak_flops_per_chip=1e12, chips=2,
          flops_source="analytic", effective_global_batch=8)),
    ("report", "JoinRendezvousRequest",
     dict(node_id=0, node_rank=0, local_world_size=1, rdzv_name=TRAIN,
          node_ip="10.0.0.1")),
    ("get", "CommWorldRequest", dict(node_id=0, rdzv_name=TRAIN)),
    ("get", "WaitingNodeNumRequest", dict(node_id=0, rdzv_name=TRAIN)),
    ("report", "JoinRendezvousRequest",
     dict(node_id=1, node_rank=1, local_world_size=1, rdzv_name=TRAIN,
          node_ip="10.0.0.2")),
    ("get", "CommWorldRequest", dict(node_id=0, rdzv_name=TRAIN)),
    ("get", "CommWorldRequest", dict(node_id=1, rdzv_name=TRAIN)),
    ("get", "WaitingNodeNumRequest", dict(node_id=1, rdzv_name=TRAIN)),
    # the KV store
    ("report", "KeyValuePair", dict(key="coord/t/0", value=b"10.0.0.1:29")),
    ("get", "KVGetRequest", dict(key="coord/t/0")),
    ("get", "KVGetRequest", dict(key="absent")),
    ("report", "KVAddRequest", dict(key="counter", amount=3)),
    ("report", "KVAddRequest", dict(key="counter", amount=-1)),
    ("get", "KVWaitRequest", dict(keys=["coord/t/0", "counter"],
                                  timeout_s=5.0)),
    ("get", "KVWaitRequest", dict(keys=["never"], timeout_s=0.0)),
    # dynamic data sharding
    ("report", "DatasetShardParams",
     dict(dataset_name="ds", dataset_size=100, shard_size=16, num_epochs=2,
          shuffle=False, task_type="training", storage_type="table")),
    ("get", "TaskRequest", dict(dataset_name="ds", worker_id=0)),
    ("get", "TaskRequest", dict(dataset_name="ds", worker_id=1)),
    ("get", "TaskRequest", dict(dataset_name="ds", worker_id=1)),
    ("report", "TaskResult", dict(dataset_name="ds", task_id=0,
                                  worker_id=0, success=True)),
    ("get", "TaskCounts", dict(dataset_name="ds")),
    ("get", "ShardCheckpointRequest", dict(dataset_name="ds")),
    ("get", "DatasetEpochInfo", dict(dataset_name="ds")),
    # the steps
    ("tick", 1.0),
    ("report", "GlobalStepReport", dict(node_id=0, node_rank=0, step=1,
                                        step_time_s=0.5, mfu=0.2)),
    ("report", "GlobalStepReport", dict(node_id=1, node_rank=1, step=1,
                                        step_time_s=0.5, mfu=0.2)),
    ("tick", 0.5),
    ("report", "GlobalStepReport", dict(node_id=0, node_rank=0, step=2,
                                        step_time_s=0.5, mfu=0.2)),
    ("tick", 0.25),
    ("report", "GlobalStepReport", dict(node_id=1, node_rank=1, step=2,
                                        step_time_s=0.75, mfu=0.2)),
    ("tick", 1.5),
    ("report", "GlobalStepReport", dict(node_id=0, node_rank=0, step=5,
                                        step_time_s=0.5,
                                        data_wait_fraction=0.1, mfu=0.2)),
    ("speed",),
    # peer restore: both donors register step 3, rank 1 only part of it
    ("report", "PeerStoreReport",
     dict(node_id=0, node_rank=0, addr="10.0.0.1:7000", step=3,
          rdzv_name=TRAIN, keys=["model.w", "optim.state.w.exp_avg"],
          total_bytes=64)),
    ("report", "PeerStoreReport",
     dict(node_id=1, node_rank=1, addr="10.0.0.2:7000", step=3,
          rdzv_name=TRAIN, keys=["model.w"], total_bytes=32)),
    ("get", "RestorePlanRequest", dict(node_id=0, node_rank=0,
                                       rdzv_name=TRAIN)),
    ("get", "RestorePlanRequest", dict(node_id=1, node_rank=1,
                                       rdzv_name=TRAIN)),
    ("get", "RestorePlanRequest", dict(node_id=2, node_rank=2,
                                       rdzv_name=TRAIN, stripe=True)),
    ("get", "RestorePlanRequest", dict(node_id=1, node_rank=1,
                                       rdzv_name=TRAIN, epoch_only=True)),
    ("report", "NodeHeartbeat", dict(node_id=1, node_rank=1,
                                     node_type="worker")),
    # a failure gives the dead worker's tasks back
    ("report", "NodeFailureReport",
     dict(node_id=1, node_rank=1, error_data="worker exit code -9",
          level="process_error", restart_count=0, exit_kind="killed")),
    ("get", "TaskCounts", dict(dataset_name="ds")),
    ("get", "TaskRequest", dict(dataset_name="ds", worker_id=0)),
    ("get", "ShardCheckpointRequest", dict(dataset_name="ds")),
    # barriers and PS versions
    ("report", "SyncJoinRequest", dict(sync_name="s", node_id=0)),
    ("get", "SyncQueryRequest", dict(sync_name="s")),
    ("report", "SyncJoinRequest", dict(sync_name="s", node_id=1)),
    ("get", "SyncQueryRequest", dict(sync_name="s")),
    ("report", "SyncFinishRequest", dict(sync_name="s")),
    ("get", "SyncQueryRequest", dict(sync_name="s")),
    ("report", "ClusterVersionRequest",
     dict(task_type="worker", task_id=0, version_type="global",
          version=7)),
    ("get", "ClusterVersionRequest",
     dict(task_type="worker", task_id=0, version_type="global")),
    ("get", "ClusterVersionRequest",
     dict(task_type="worker", task_id=1, version_type="local")),
    ("report", "ParallelConfig", dict()),
    ("get", "ParallelConfigRequest", dict(node_id=0)),
    ("get", "JobStatusRequest", dict()),
    # a leave, a second round and its membership view
    ("report", "LeaveRendezvousRequest", dict(node_id=1, node_rank=1,
                                              rdzv_name=TRAIN)),
    ("report", "JoinRendezvousRequest",
     dict(node_id=2, node_rank=1, local_world_size=1, rdzv_name=TRAIN,
          node_ip="10.0.0.3")),
    ("get", "WaitingNodeNumRequest", dict(node_id=0, rdzv_name=TRAIN)),
    ("report", "JoinRendezvousRequest",
     dict(node_id=0, node_rank=0, local_world_size=1, rdzv_name=TRAIN,
          node_ip="10.0.0.1")),
    ("get", "CommWorldRequest", dict(node_id=1, rdzv_name=TRAIN)),
    # rank 1 withdraws its store (nothing staged); the epoch after the
    # membership changes
    ("report", "PeerStoreReport",
     dict(node_id=2, node_rank=1, addr="10.0.0.3:7000", step=-1,
          rdzv_name=TRAIN, keys=[])),
    ("get", "RestorePlanRequest", dict(node_id=2, node_rank=1,
                                       rdzv_name=TRAIN)),
    ("get", "RestorePlanRequest", dict(node_id=0, node_rank=0,
                                       rdzv_name=TRAIN, epoch_only=True)),
    # the re-formed world resumes from its checkpoint, below the step
    # mark: those reports are dropped until it passes the mark
    ("tick", 20.0),
    ("report", "GlobalStepReport", dict(node_id=0, node_rank=0, step=3,
                                        step_time_s=0.5, mfu=0.2)),
    ("tick", 0.5),
    ("report", "GlobalStepReport", dict(node_id=0, node_rank=0, step=5,
                                        step_time_s=0.5, mfu=0.2)),
    ("speed",),
    ("tick", 0.5),
    ("report", "GlobalStepReport", dict(node_id=0, node_rank=0, step=6,
                                        step_time_s=0.5, mfu=0.2)),
    ("tick", 0.25),
    ("report", "GlobalStepReport", dict(node_id=2, node_rank=1, step=7,
                                        step_time_s=0.25, mfu=0.2)),
    # garbage on the wire is an answer, not a crash
    ("raw", b"not a pickle"),
]


def _speed(monitor):
    return (monitor.completed_global_step, monitor.running_speed(),
            monitor.tokens_per_second(), monitor.running_mfu())


def _play(master, messages, clock):
    servicer = master.servicer
    answers, speeds = [], []
    for item in SEQUENCE:
        if item[0] == "tick":
            clock.now += item[1]
            continue
        if item[0] == "speed":
            speeds.append(_speed(master.speed_monitor))
            continue
        if item[0] == "raw":
            data = item[1]
            answers.append(("raw", messages.deserialize_message(
                servicer.get_bytes(data, None))))
            continue
        kind, name, fields = item
        payload = messages.serialize_message(
            getattr(messages, name)(**fields))
        send = servicer.get_bytes if kind == "get" else servicer.report_bytes
        answers.append((name, messages.deserialize_message(
            send(payload, None))))
    speeds.append(_speed(master.speed_monitor))
    return answers, speeds


def test_servicers_answer_a_scripted_sequence_alike(contexts, monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "time", clock)
    jax_master = JMaster(port=0, min_nodes=2, max_nodes=2,
                         host="127.0.0.1")
    port_master = JobMaster(port=0, min_nodes=2, max_nodes=2,
                            host="127.0.0.1")
    try:
        jax_answers, jax_speed = _play(jax_master, J, clock)
        clock.now = 1.7e9
        port_answers, port_speed = _play(port_master, T, clock)
    finally:
        jax_master.stop()
        port_master.stop()
    assert len(port_answers) == len(jax_answers)
    for (name, want), (_, got) in zip(jax_answers, port_answers):
        kind = type(want).__name__
        assert type(got).__name__ == kind, name
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        for field in UNPORTED_FIELDS.get(kind, ()):
            assert got.pop(field) == "" and want.pop(field)
        assert got == want, name
    # the script reached what it meant to: a world of two, tasks out and
    # requeued, a speed and an MFU
    worlds = [a for n, a in port_answers if n == "CommWorldRequest"]
    assert worlds[1].world == {0: 1, 1: 1}
    # the plans: rank 0 reads all it staged locally; rank 1 its own key,
    # the other from rank 0; the joins of the second round carry a plan
    plans = [a for n, a in port_answers if n == "RestorePlanRequest"]
    entries = [json.loads(p.plan_json)["entries"] if p.plan_json else {}
               for p in plans]
    assert {e["tier"] for e in entries[0].values()} == {"local"}
    assert entries[1]["model.w"]["tier"] == "local"
    assert entries[1]["optim.state.w.exp_avg"]["rank"] == 0
    assert entries[2]["model.w"]["addrs"] == ["10.0.0.1:7000",
                                              "10.0.0.2:7000"]
    assert plans[0].found and plans[3].plan_json == ""
    joins = [a for n, a in port_answers if n == "JoinRendezvousRequest"]
    assert joins[0].restore_plan_json == ""
    assert json.loads(joins[2].restore_plan_json)["step"] == 3
    assert port_speed == jax_speed
    step, _, tokens_per_s, running_mfu = port_speed[0]
    assert step == 5 and tokens_per_s > 0 and running_mfu > 0
    # after the second round: held at the mark, then past it
    assert [s[0] for s in port_speed[1:]] == [5, 7]
    assert port_speed[1][1] == port_speed[0][1]


def test_unported_requests_are_refused_by_name(contexts):
    """Every request the JAX master answers, the port's answers too: the
    autoscale status and, since slice mode (6.4) is ported, the slice
    status and a join carrying a slice id, as the JAX master answers
    them."""
    masters = [JMaster(port=0, host="127.0.0.1"),
               JobMaster(port=0, host="127.0.0.1")]
    try:
        answers = [m.servicer.get_bytes(mod.serialize_message(
            mod.AutoscaleStatusRequest()), None)
            for m, mod in zip(masters, (J, T))]
        assert answers[1] == answers[0]
        assert T.deserialize_message(answers[1]).status_json == ""
        statuses = []
        for m, mod in zip(masters, (J, T)):
            joined = mod.deserialize_message(m.servicer.report_bytes(
                mod.serialize_message(mod.JoinRendezvousRequest(
                    node_id=0, node_rank=0, local_world_size=1,
                    rdzv_name="elastic-training", slice_id=0)), None))
            assert isinstance(joined, mod.JoinRendezvousResult)
            statuses.append(json.loads(mod.deserialize_message(
                m.servicer.get_bytes(mod.serialize_message(
                    mod.SliceStatusRequest()), None)).status_json))
        assert statuses[1] == statuses[0]
        assert statuses[1]["slices"]["0"]["ranks"] == [0]
    finally:
        for m in masters:
            m.stop(grace_s=0.1)


def test_replanning_requests_are_answered_as_jax(contexts):
    """``ShardPlanRequest`` and ``PlanCalibrationRequest`` (once refused
    as not ported) are answered, byte for byte as the JAX master answers
    them, before any join and after a world of two with a model profile
    and step reports has formed."""
    answers = []
    for Master, m in ((JMaster, J), (JobMaster, T)):
        master = Master(port=0, min_nodes=2, max_nodes=2,
                        host="127.0.0.1")
        got = []

        def ask(request):
            got.append(master.servicer.get_bytes(
                m.serialize_message(request), None))

        try:
            ask(m.ShardPlanRequest(node_rank=0, rdzv_name=TRAIN))
            ask(m.PlanCalibrationRequest())
            master.servicer.report(m.ModelInfo(
                param_count=110_000, param_bytes=440_000,
                flops_per_token=6.6e5, peak_flops_per_chip=1e12,
                batch_size=8, seq_len=32, chips=1))
            for rank in (0, 1):
                master.servicer.report(m.JoinRendezvousRequest(
                    node_id=rank, node_rank=rank, local_world_size=1,
                    rdzv_name=TRAIN))
            master.servicer.get(m.CommWorldRequest(node_id=0,
                                                   rdzv_name=TRAIN))
            ask(m.ShardPlanRequest(node_rank=1, rdzv_name=TRAIN))
            plan = json.loads(m.deserialize_message(got[-1]).plan_json)
            for step in (1, 2, 3):
                master.servicer.report(m.GlobalStepReport(
                    node_id=0, node_rank=0, step=step, step_time_s=0.5,
                    mfu=0.3, plan_generation=plan["generation"]))
            ask(m.PlanCalibrationRequest())
        finally:
            master.stop()
        answers.append(got)
    jax, port = answers
    for want, got in zip(jax, port):
        want, got = J.deserialize_message(want), T.deserialize_message(got)
        assert type(got).__name__ == type(want).__name__
        want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        if "report_json" in got and got["report_json"]:
            # the table's first_ts is each master's own clock
            want, got = (json.loads(x["report_json"]) for x in (want, got))
            for row in want["table"] + got["table"]:
                assert row.pop("signature")
        assert got == want
    plan = json.loads(T.deserialize_message(port[2]).plan_json)
    assert plan["world_size"] == 2 and plan["feasible"]
    table = json.loads(T.deserialize_message(port[3]).report_json)["table"]
    # the first join stamped a world of one, the second a world of two;
    # the step reports name the second's generation
    assert [(row["total_devices"], row["samples"]) for row in table] == [
        (1, 0), (2, 3)]


def test_reconnect_request_is_answered(contexts):
    """A ``ReconnectRequest`` (an agent back from master-lost mode) puts
    its rank back in the alive set and answers ``world_intact`` for the
    round it reports, where it was once refused as not ported."""
    master = JobMaster(port=0, host="127.0.0.1")
    try:
        report = master.servicer.report
        report(T.JoinRendezvousRequest(node_id=0, node_rank=0,
                                       local_world_size=1,
                                       rdzv_name=TRAIN))
        master.servicer.get(T.CommWorldRequest(node_id=0,
                                               rdzv_name=TRAIN))
        answers = [report(T.ReconnectRequest(
            node_id=0, node_rank=0, rdzv_name=TRAIN, rdzv_round=rnd))
            for rnd in (0, 1, -1)]
        assert [type(a).__name__ for a in answers] == [
            "ReconnectResult"] * 3
        assert [a.world_intact for a in answers] == [True, False, False]
        assert {a.round for a in answers} == {0}
        assert {a.coord_addr for a in answers} == {""}
    finally:
        master.stop()


def _span(name, duration, span_id, ts, **attrs):
    return {"kind": "span", "name": name, "span_id": span_id,
            "duration_s": duration, "ts": ts, "attrs": attrs,
            "trace_id": "t", "parent_id": "", "status": "ok", "pid": 1}


def _telemetry(rank, *spans):
    return ("report", "TelemetryReport", dict(
        node_id=rank, node_rank=rank, node_type="worker",
        samples=[("counter", "dlrover_tpu_test_total", 2.0,
                  {"kind": "a"}),
                 ("gauge", "dlrover_tpu_test_gauge", 3.5, {})],
        spans_json=json.dumps(list(spans))))


T0 = 1.7e9
# the drain protocol, telemetry spans and the goodput ledger: a world of
# two, steps, a drain of rank 1 with its emergency checkpoint, a hang and
# a crash of rank 0, each answer and snapshot compared
DRAIN_SEQUENCE = [
    ("report", "JoinRendezvousRequest",
     dict(node_id=0, node_rank=0, local_world_size=1, rdzv_name=TRAIN)),
    ("report", "JoinRendezvousRequest",
     dict(node_id=1, node_rank=1, local_world_size=1, rdzv_name=TRAIN)),
    ("get", "CommWorldRequest", dict(node_id=0, rdzv_name=TRAIN)),
    ("get", "CommWorldRequest", dict(node_id=1, rdzv_name=TRAIN)),
    _telemetry(0, _span("rendezvous", 0.5, "r0", T0 - 1.0),
               _span("restore_or_init", 4.0, "s0", T0),
               _span("checkpoint_save", 0.3, "c0", T0 + 0.5)),
    _telemetry(1, _span("restore_or_init", 4.5, "s1", T0)),
    ("report", "GlobalStepReport", dict(node_id=0, node_rank=0, step=0,
                                        step_time_s=0.0)),
    ("report", "GlobalStepReport", dict(node_id=1, node_rank=1, step=0,
                                        step_time_s=0.0)),
    ("tick", 10.0),
    ("report", "GlobalStepReport", dict(node_id=0, node_rank=0, step=20,
                                        step_time_s=0.4,
                                        data_wait_fraction=0.1, mfu=0.3)),
    ("report", "GlobalStepReport", dict(node_id=1, node_rank=1, step=20,
                                        step_time_s=0.45, mfu=0.3)),
    ("get", "GoodputRequest", dict()),
    ("report", "DrainReport", dict(node_id=1, node_rank=1,
                                   deadline=T0 + 60.0, reason="spot",
                                   phase="notice")),
    ("get", "WaitingNodeNumRequest", dict(node_id=0, rdzv_name=TRAIN)),
    ("tick", 2.0),
    _telemetry(1, _span("emergency_checkpoint", 5.0, "e1", T0 + 12.0,
                        outcome="saved"),
               _span("emergency_checkpoint", 5.0, "e1", T0 + 12.0)),
    ("tick", 6.0),
    ("report", "DrainReport", dict(node_id=1, node_rank=1,
                                   deadline=T0 + 60.0, reason="spot",
                                   phase="complete")),
    ("get", "WaitingNodeNumRequest", dict(node_id=0, rdzv_name=TRAIN)),
    ("report", "JoinRendezvousRequest",
     dict(node_id=0, node_rank=0, local_world_size=1, rdzv_name=TRAIN)),
    ("get", "CommWorldRequest", dict(node_id=0, rdzv_name=TRAIN)),
    ("tick", 30.0),
    ("report", "NodeFailureReport",
     dict(node_id=0, node_rank=0, error_data="worker exit code -6",
          level="process_error", exit_kind="hang")),
    ("report", "JoinRendezvousRequest",
     dict(node_id=0, node_rank=0, local_world_size=1, rdzv_name=TRAIN)),
    ("get", "CommWorldRequest", dict(node_id=0, rdzv_name=TRAIN)),
    ("tick", 3.0),
    ("report", "NodeFailureReport",
     dict(node_id=0, node_rank=0, error_data="worker exit code -9",
          level="process_error", exit_kind="killed")),
    ("report", "DrainReport", dict(node_id=0, node_rank=0,
                                   deadline=T0 + 99.0, phase="notice")),
    ("get", "GoodputRequest", dict(window_s=30.0)),
    ("get", "GoodputRequest", dict()),
]


def _play_drain(servicer, messages, clock):
    answers = []
    for kind, name, *rest in DRAIN_SEQUENCE:
        if kind == "tick":
            clock.now += name
            continue
        fields = dict(rest[0])
        if name == "TelemetryReport":
            fields["samples"] = [messages.MetricSample(
                kind=k, name=n, value=v, labels=lab)
                for k, n, v, lab in fields["samples"]]
        payload = messages.serialize_message(
            getattr(messages, name)(**fields))
        send = servicer.get_bytes if kind == "get" else servicer.report_bytes
        answers.append((name, messages.deserialize_message(
            send(payload, None))))
        queue = getattr(servicer, "telemetry_queue", None)
        if queue is not None:
            queue.flush()
    return answers


def test_drain_telemetry_and_goodput_answers_match_jax(contexts,
                                                       monkeypatch):
    """DrainReport, TelemetryReport and GoodputRequest through the JAX
    servicer (no diagnosis manager, so no checkpoint fan-out: that is
    the observation test's) and the port's, each over a goodput ledger
    on one fake clock: equal answers, equal ledger snapshots, and the
    same rendezvous membership and draining set."""
    from dlrover_tpu.master import rendezvous as jrdzv
    from dlrover_tpu.master.servicer import MasterServicer as JServicer
    from dlrover_tpu.obs.goodput import GoodputLedger as JLedger
    from dlrover_tpu.obs.metrics import MetricsRegistry as JRegistry
    from dlrover_tpu_torch.master import rendezvous as trdzv
    from dlrover_tpu_torch.master.servicer import MasterServicer
    from dlrover_tpu_torch.obs.goodput import GoodputLedger
    from dlrover_tpu_torch.obs.metrics import MetricsRegistry

    jax_ctx, port_ctx = contexts
    for ctx in contexts:
        ctx.update(hang_watchdog_s=25.0)
    clock = FakeClock(T0)
    monkeypatch.setattr(time, "time", clock)
    runs = []
    for servicer_cls, ledger_cls, registry_cls, rdzv, messages in (
            (JServicer, JLedger, JRegistry, jrdzv, J),
            (MasterServicer, GoodputLedger, MetricsRegistry, trdzv, T)):
        clock.now = T0
        ledger = ledger_cls(registry=registry_cls(), now_fn=clock)
        params = rdzv.RendezvousParameters(1, 2, wait_new_node_s=3600.0)
        servicer = servicer_cls(goodput_ledger=ledger, rdzv_managers={
            TRAIN: rdzv.ElasticTrainingRendezvousManager(params),
            RendezvousName.NETWORK_CHECK:
                rdzv.NetworkCheckRendezvousManager(params)})
        try:
            answers = _play_drain(servicer, messages, clock)
        finally:
            queue = getattr(servicer, "telemetry_queue", None)
            if queue is not None:
                queue.stop()
        runs.append((answers, ledger, servicer))
    (jax_answers, jax_ledger, jax_srv), (answers, ledger, srv) = runs
    assert len(answers) == len(jax_answers)
    for (name, want), (_, got) in zip(jax_answers, answers):
        kind = type(want).__name__
        assert type(got).__name__ == kind, name
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        for field in UNPORTED_FIELDS.get(kind, ()):
            assert got.pop(field) == "" and want.pop(field)
        if name == "GoodputRequest":
            got = json.loads(got.pop("report_json"))
            want = json.loads(want.pop("report_json"))
        assert got == want, name
    assert ledger.snapshot() == jax_ledger.snapshot()
    snap = json.loads([a for n, a in answers
                       if n == "GoodputRequest"][-1].report_json)
    buckets = snap["buckets"]
    assert buckets["hang"] == pytest.approx(25.0)
    assert buckets["drain"] > 0 and buckets["checkpoint_stall"] == 5.0
    assert buckets["restore"] == 8.5 and buckets["productive"] > 0
    assert [i["reason"] for i in snap["incarnations"]] == [
        "job_start", "drain", "hang_restart"]
    drains = [a for n, a in answers if n == "DrainReport"]
    assert all(d.success and d.checkpoint_ranks == [] for d in drains)
    for mgr_name in (TRAIN, RendezvousName.NETWORK_CHECK):
        jm, tm = jax_srv.rdzv_managers[mgr_name], srv.rdzv_managers[mgr_name]
        assert tm.alive_nodes == jm.alive_nodes
        assert tm.draining == jm.draining
        # the JAX export's fields the port holds
        got, want = tm.export_state(), jm.export_state()
        assert got == {key: want[key] for key in got}
    assert srv.rdzv_managers[TRAIN].draining == {0: T0 + 99.0}
    # the port's master replayed the telemetry samples on its registry
    from dlrover_tpu_torch import obs

    text = obs.get_registry().render()
    assert 'dlrover_tpu_test_total{kind="a",node="0"}' in text


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(relaunch_backoff_base_s=0.5, relaunch_backoff_max_s=3.0,
         quarantine_failures=3, quarantine_window_s=10.0),
    dict(quarantine_failures=0),
])
def test_relaunch_governor_matches_jax(contexts, knobs):
    jax_ctx, port_ctx = contexts
    jax_ctx.update(**knobs)
    port_ctx.update(**knobs)
    clocks = FakeClock(0.0), FakeClock(0.0)
    governors = JGovernor(clock=clocks[0]), RelaunchGovernor(clock=clocks[1])
    # seconds between failures, none a hang-abort (the hang streak is
    # tests/test_torch_preemption.py's)
    gaps = [0, 2, 4, 7, 12, 1, 1, 3, 600, 0.5, 0.5, 9, 9, 9, 9]
    trace = ([], [])
    for gap in gaps:
        for gov, clock, out in zip(governors, clocks, trace):
            clock.now += gap
            out.append(gov.record_failure())
            out.append((gov.recent_failures, gov.quarantined))
    assert trace[1] == trace[0]
    # the script reaches quarantine unless it is switched off
    quarantined = [q for _, q in trace[1][1::2]]
    assert any(quarantined) == (port_ctx.quarantine_failures > 0)


def _client_round_trip(client, master, messages):
    """The worker's and agent's calls through ``client`` (whose package's
    ``messages`` module is given) against a live one-node ``master``
    (either package's)."""
    assert client.join_rendezvous(1) == 0
    rdzv_round, _, world = client.get_comm_world()
    assert (rdzv_round, world) == (0, {0: 1})
    assert client.num_nodes_waiting() == 0
    assert client.kv_set("coord/x/0", b"127.0.0.1:1")
    assert client.kv_wait("coord/x/0", timeout_s=5) == b"127.0.0.1:1"
    assert client.kv_add("n", 2) == 2 and client.kv_add("n", 3) == 5
    assert client.report_model_info(
        param_count=10, param_bytes=40, batch_size=4, seq_len=8,
        flops_per_token=60.0, peak_flops_per_chip=1e6, chips=1,
        effective_global_batch=4)
    for step in (1, 2, 3):
        assert client.report_global_step(step, step_time_s=0.1, mfu=0.1)
    assert client.report_heartbeat()
    assert client.report_failure("exit -9", level="process_error",
                                 exit_kind="killed")
    assert client.get_shard_checkpoint("") == ""
    assert client.report_node_address("127.0.0.1:7")
    assert client.kv_get("node-addr/0") == b"127.0.0.1:7"
    assert client.get_paral_config().dataloader_batch_size == 0
    # dynamic data sharding through the client's typed calls
    assert client.report_dataset_shard_params(messages.DatasetShardParams(
        dataset_name="ds", dataset_size=40, shard_size=10, num_epochs=1,
        storage_type="table"))
    first = client.get_task("ds")
    assert (first.shard.start, first.shard.end) == (0, 10)
    assert client.report_task_result("ds", first.task_id)
    assert client.get_task_counts("ds") == (3, 0)
    assert client.get_dataset_epoch("ds") == 1
    content = client.get_shard_checkpoint("ds")
    assert client.get_task("ds").shard.start == 10
    assert client.report_shard_checkpoint(content)
    assert client.get_task_counts("ds") == (3, 0)
    assert client.get_job_status().stage == "running"
    # peer restore: a store, its plan (plain and striped), the epoch and
    # the plan in the next join's result
    assert client.last_restore_plan_json == ""
    assert client.get_restore_plan() == {}
    assert client.report_peer_store("127.0.0.1:9", 4, ["model.w"],
                                    total_bytes=16)
    plan = client.get_restore_plan()
    assert plan["step"] == 4 and plan["epoch"] == client.get_restore_epoch()
    assert plan["entries"]["model.w"] == {"rank": 0, "addr": "127.0.0.1:9",
                                          "tier": "local"}
    assert client.get_restore_plan(stripe=True)["mode"] == "stripe"
    assert client.join_rendezvous(1) == 1
    assert json.loads(client.last_restore_plan_json)["entries"] == \
        plan["entries"]
    assert client.report_peer_store("127.0.0.1:9", -1, [])
    assert client.get_restore_plan() == {}
    assert client.leave_rendezvous()
    assert master.speed_monitor.completed_global_step == 3
    # telemetry, the goodput ledger and the drain protocol
    assert client.report_telemetry(spans=[{
        "kind": "span", "name": "restore_or_init", "span_id": "rt",
        "duration_s": 1.5, "ts": time.time() - 2.0, "attrs": {}}])
    assert client.report_telemetry() is True      # nothing to send
    deadline = time.time() + 60.0
    notice = client.report_drain(deadline, reason="r", phase="notice")
    assert notice.success and notice.checkpoint_ranks == []
    assert master.rdzv_managers[TRAIN].draining == {0: deadline}
    assert client.report_drain(deadline, phase="complete").success
    assert 0 not in master.rdzv_managers[TRAIN].alive_nodes
    snap = client.get_goodput(window_s=60.0)
    assert set(snap["buckets"]) >= {"productive", "restore", "drain"}
    assert snap["window"]["window_s"] == 60.0
    # the observation plane (no diagnosis manager: the fixture turns it
    # off): relayed card stats, the HBM watermark's series, a step trace,
    # a clock probe
    assert client.poll_diagnosis_actions() == []
    assert client.get_diagnosis_reports() == []
    assert client.report_resource_stats(messages.NodeResourceStats(
        node_id=0, node_rank=0, node_type="worker", cpu_percent=1.0,
        chip_stats=[messages.ChipStats(index=0, hbm_used_mb=10.0,
                                       hbm_total_mb=80.0)]))
    assert client.report_global_step(9, step_time_s=0.1,
                                     hbm_peak_bytes=float(3 << 20))
    series = client.query_timeseries(
        name="dlrover_tpu_worker_hbm_peak_mb")["series"]
    assert series[0]["labels"] == {"node": "0"}
    assert series[0]["points"][-1][1] == 3.0
    assert "dlrover_tpu_worker_step_time_seconds" in \
        client.query_timeseries()["names"]
    assert client.report_telemetry(steptrace=[{
        "v": 1, "step": 1, "gen": 0, "rank": 0, "t0": time.time(),
        "phases": [["compute", 0.0, 0.1]]}])
    queue = getattr(master.servicer, "telemetry_queue", None)
    if queue is not None:
        queue.flush()
    traces = client.query_steptrace(last_n=1)
    assert [g["gating_rank"] for g in traces["steps"]] == [0]
    assert abs(client.probe_clock() - time.time()) < 60.0


@pytest.mark.parametrize("pair", ["port-port", "port-jax", "jax-port"])
def test_clients_and_masters_talk_over_grpc(contexts, pair):
    client_kind, master_kind = pair.split("-")
    master = (JobMaster if master_kind == "port" else JMaster)(
        port=0, host="127.0.0.1")
    master.prepare()
    client = (MasterClient if client_kind == "port" else JClient)(
        master.addr, node_id=0, timeout_s=10.0)
    try:
        _client_round_trip(client, master, T if client_kind == "port" else J)
    finally:
        client.close()
        master.stop()


def test_constants_match_jax():
    """Every name of the port's copies of the JAX package's constant
    classes has the JAX value, and the exit-code classifier agrees."""
    from dlrover_tpu.common import constants as jc
    from dlrover_tpu_torch.common import constants as tc

    for cls in ("NodeType", "NodeStatus", "NodeExitReason", "WorkerExit",
                "JobStage", "RendezvousName", "NodeEnv",
                "TrainingMsgLevel", "TaskType", "DefaultValues",
                "MeshAxis"):
        port = {k: v for k, v in vars(getattr(tc, cls)).items()
                if k.isupper()}
        assert port, cls
        jax_cls = getattr(jc, cls)
        assert port == {k: getattr(jax_cls, k) for k in port}, cls
    assert tc.NodeStatus.terminal() == jc.NodeStatus.terminal()
    assert tc.HOT_KV_PREFIXES == jc.HOT_KV_PREFIXES
    for code in (0, 1, 76, -6, 134, -9, -15, 137, 143, 3, 255):
        for hang in (True, False):
            assert (tc.WorkerExit.classify(code, hang)
                    == jc.WorkerExit.classify(code, hang))
        assert (tc.WorkerExit.to_exit_status(code)
                == jc.WorkerExit.to_exit_status(code))


@pytest.mark.parametrize("spec", [
    "drop:0.3", "delay:0:0.5;error:0.2", "drop:0.2; error:0.1",
    "bogus:1", "drop:2", "delay:-1", "error"])
def test_net_chaos_matches_jax(spec):
    """``DLROVER_TPU_CHAOS_NET``: the same grammar and, from one seed,
    the same faults before each RPC as the JAX package's injector."""
    import grpc

    from dlrover_tpu.common import comm as jcomm
    from dlrover_tpu_torch.common import comm as tcomm

    try:
        want = dataclasses.asdict(jcomm.parse_net_chaos(spec))
    except ValueError:
        with pytest.raises(ValueError):
            tcomm.parse_net_chaos(spec)
        return
    assert dataclasses.asdict(tcomm.parse_net_chaos(spec)) == want
    runs = []
    for comm in (jcomm, tcomm):
        injector = comm.TransportFaultInjector(spec, seed=5)
        outcomes = []
        for _ in range(50):
            try:
                injector.before_rpc("get")
                outcomes.append("ok")
            except grpc.RpcError as e:
                outcomes.append(e.code().name)
        runs.append((outcomes, injector.injected))
    assert runs[1] == runs[0]
    assert set(runs[0][0]) != {"ok"}


def test_speed_after_a_relaunch_matches_jax(contexts, monkeypatch):
    """After a membership change the re-formed world resumes from its
    checkpoint, below the step high-water mark. Both monitors drop those
    reports: the speed holds no sample until the job passes the old mark,
    and then counts from there."""
    from dlrover_tpu.master.speed_monitor import SpeedMonitor as JMonitor
    from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor

    clock = FakeClock()
    monkeypatch.setattr(time, "time", clock)
    monitors = JMonitor(), SpeedMonitor()
    for monitor in monitors:
        monitor.set_tokens_per_step(1000)
    start = clock.now
    for step in range(1, 7):           # the first world reaches step 6
        clock.now = start + step
        for monitor in monitors:
            monitor.collect_worker_step(0, step)
    readings = [[m.tokens_per_second() for m in monitors]]
    for monitor in monitors:
        monitor.reset_running_speed()  # killed; resumes from step 3
    for step in range(4, 10):
        clock.now = start + 30 + 0.5 * step
        for monitor in monitors:
            monitor.collect_worker_step(0, step)
        readings.append([m.tokens_per_second() for m in monitors])
    assert all(port == jax for jax, port in readings)
    # 1000 tokens/s before; nothing until step 7 passes the mark (its
    # delta spans the gap and is skipped); then 2000 tokens/s
    assert [port for _, port in readings] == [1000.0, 0.0, 0.0, 0.0, 0.0,
                                              2000.0, 2000.0]
    assert [m.completed_global_step for m in monitors] == [9, 9]


def _steptrace_json(rank, steps, compute):
    return json.dumps([{"v": 1, "step": n, "gen": 0, "slice": -1,
                        "rank": rank, "t0": T0 + n, "off": 0.0,
                        "err": 0.001,
                        "phases": [["data_wait", 0.0, 0.001],
                                   ["compute", 0.001, compute]]}
                       for n in steps])


def _chip_stats(rank, used, peak):
    return ("report", "NodeResourceStats", dict(
        node_id=rank, node_rank=rank, node_type="worker", cpu_percent=3.0,
        memory_mb=1000.0, chip_stats=[dict(
            index=0, hbm_used_mb=used, hbm_total_mb=81079.0,
            hbm_peak_mb=peak, duty_cycle_pct=97.5)]))


# the observation plane: a world of two whose rank 1 is slow (it gates
# every traced step and straggles), step reports with device-truth HBM
# peaks, relayed card stats, step traces, diagnosis rounds, then the six
# requests, a hang exit and a drain notice whose checkpoint fan-out
# reaches the survivor
OBSERVE_SEQUENCE = [
    ("report", "JoinRendezvousRequest",
     dict(node_id=0, node_rank=0, local_world_size=1, rdzv_name=TRAIN)),
    ("report", "JoinRendezvousRequest",
     dict(node_id=1, node_rank=1, local_world_size=1, rdzv_name=TRAIN)),
    ("get", "CommWorldRequest", dict(node_id=0, rdzv_name=TRAIN)),
    ("get", "CommWorldRequest", dict(node_id=1, rdzv_name=TRAIN)),
    ("report", "ModelInfo",
     dict(param_count=1_000_000, param_bytes=4_000_000, batch_size=8,
          seq_len=512, flops_per_token=6e6, peak_flops_per_chip=1e12,
          chips=2, flops_source="analytic", effective_global_batch=8)),
] + [item for n in range(1, 7) for item in (
    ("tick", 1.0),
    ("report", "GlobalStepReport",
     dict(node_id=0, node_rank=0, step=n, step_time_s=0.4, mfu=0.3,
          hbm_peak_bytes=float((50_000 + n) << 20))),
    ("report", "GlobalStepReport",
     dict(node_id=1, node_rank=1, step=n, step_time_s=1.0, mfu=0.12,
          hbm_peak_bytes=float(51_000 << 20))),
)] + [
    ("report", "TelemetryReport",
     dict(node_id=0, node_rank=0, node_type="worker",
          steptrace_json=_steptrace_json(0, range(1, 7), 0.4))),
    ("report", "TelemetryReport",
     dict(node_id=1, node_rank=1, node_type="worker",
          steptrace_json=_steptrace_json(1, range(1, 7), 1.0))),
    _chip_stats(0, 19000.0, 52000.0),
    _chip_stats(1, 19500.0, -1.0),
    ("diagnose",), ("tick", 2.0), ("diagnose",), ("tick", 2.0),
    ("diagnose",),
    ("get", "DiagnosisReportRequest", dict()),
    ("get", "DiagnosisReportRequest", dict(limit=1)),
    ("get", "DiagnosisActionRequest", dict(node_id=0, node_rank=0)),
    ("get", "DiagnosisActionRequest", dict(node_id=1, node_rank=1)),
    ("get", "DiagnosisActionRequest", dict(node_id=1, node_rank=1)),
    ("get", "TimeSeriesQuery", dict()),
    ("get", "TimeSeriesQuery",
     dict(name="dlrover_tpu_worker_hbm_peak_mb")),
    ("get", "TimeSeriesQuery",
     dict(name="dlrover_tpu_worker_*", labels={"node": "1"},
          window_s=60.0)),
    ("get", "TimeSeriesQuery",
     dict(name="dlrover_tpu_steptrace_gating_rank", resolution_s=10.0)),
    ("get", "StepTraceRequest", dict()),
    ("get", "StepTraceRequest", dict(start_step=2, end_step=4)),
    ("get", "StepTraceRequest", dict(last_n=2)),
    ("get", "ClockProbe", dict(node_id=0)),
    ("tick", 1.0),
    ("report", "NodeFailureReport",
     dict(node_id=1, node_rank=1, error_data="worker exit code -6",
          level="process_error", exit_kind="hang")),
    ("report", "DrainReport", dict(node_id=1, node_rank=1,
                                   deadline=T0 + 90.0, reason="spot",
                                   phase="notice")),
    ("get", "DiagnosisActionRequest", dict(node_id=0, node_rank=0)),
    ("get", "DiagnosisReportRequest", dict()),
]


def _observation_servicer(packages, clock):
    """Both packages' servicers over the same components, each on the
    injected clock (the JAX diagnosis manager reads the patched
    ``time.time``; the port's is handed the clock)."""
    (servicer_cls, manager_cls, asm_cls, store_cls, ledger_cls,
     monitor_cls, registry_cls, rdzv, is_port) = packages
    store = store_cls(clock=clock)
    ledger = ledger_cls(registry=registry_cls(), now_fn=clock)
    monitor = monitor_cls()
    asm = asm_cls(tsdb=store, registry=registry_cls())
    manager = manager_cls(monitor, goodput_ledger=ledger, steptrace=asm,
                          **({"clock": clock} if is_port else {}))
    params = rdzv.RendezvousParameters(1, 2, wait_new_node_s=3600.0)
    return servicer_cls(
        speed_monitor=monitor, goodput_ledger=ledger,
        diagnosis_manager=manager, tsdb=store, steptrace=asm,
        rdzv_managers={
            TRAIN: rdzv.ElasticTrainingRendezvousManager(params),
            RendezvousName.NETWORK_CHECK:
                rdzv.NetworkCheckRendezvousManager(params)})


def test_observation_requests_answer_the_jax_bytes(contexts, monkeypatch):
    """The six requests the port's servicer used to refuse —
    DiagnosisActionRequest, DiagnosisReportRequest, TimeSeriesQuery,
    ClockProbe, StepTraceRequest and NodeResourceStats — through the JAX
    servicer and the port's, each with a diagnosis manager, a tsdb and a
    step-trace assembler on one fake clock: every answer's bytes are
    equal (ClockProbe's server time aside, wall-clock by design), and a
    drain notice at world 2 returns the survivor in
    ``checkpoint_ranks``."""
    from dlrover_tpu.master import rendezvous as jrdzv
    from dlrover_tpu.master.diagnosis.manager import DiagnosisManager as JDM
    from dlrover_tpu.master.servicer import MasterServicer as JServicer
    from dlrover_tpu.master.speed_monitor import SpeedMonitor as JMonitor
    from dlrover_tpu.master.steptrace import StepTraceAssembler as JAsm
    from dlrover_tpu.obs.goodput import GoodputLedger as JLedger
    from dlrover_tpu.obs.metrics import MetricsRegistry as JRegistry
    from dlrover_tpu.obs.tsdb import TimeSeriesStore as JStore
    from dlrover_tpu_torch.master import rendezvous as trdzv
    from dlrover_tpu_torch.master.diagnosis import DiagnosisManager
    from dlrover_tpu_torch.master.servicer import MasterServicer
    from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
    from dlrover_tpu_torch.master.steptrace import StepTraceAssembler
    from dlrover_tpu_torch.obs.goodput import GoodputLedger
    from dlrover_tpu_torch.obs.metrics import MetricsRegistry
    from dlrover_tpu_torch.obs.tsdb import TimeSeriesStore

    for ctx in contexts:
        ctx.update(diagnosis_action_cooldown_s=60.0)
    clock = FakeClock(T0)
    monkeypatch.setattr(time, "time", clock)
    runs = []
    for packages, messages in (
            ((JServicer, JDM, JAsm, JStore, JLedger, JMonitor, JRegistry,
              jrdzv, False), J),
            ((MasterServicer, DiagnosisManager, StepTraceAssembler,
              TimeSeriesStore, GoodputLedger, SpeedMonitor,
              MetricsRegistry, trdzv, True), T)):
        clock.now = T0
        servicer = _observation_servicer(packages, clock)
        answers = []
        try:
            for kind, *rest in OBSERVE_SEQUENCE:
                if kind == "tick":
                    clock.now += rest[0]
                    continue
                if kind == "diagnose":
                    servicer.diagnosis_manager.diagnose_once()
                    continue
                name, fields = rest
                fields = dict(fields)
                if name == "NodeResourceStats":
                    fields["chip_stats"] = [messages.ChipStats(**c)
                                            for c in fields["chip_stats"]]
                payload = messages.serialize_message(
                    getattr(messages, name)(**fields))
                send = (servicer.get_bytes if kind == "get"
                        else servicer.report_bytes)
                answer = send(payload, None)
                if name == "ClockProbe":
                    probe = messages.deserialize_message(answer)
                    assert probe.server_ts == clock.now
                    answer = b"ClockProbeResult"
                answers.append((name, answer))
                queue = getattr(servicer, "telemetry_queue", None)
                if queue is not None:
                    queue.flush()
        finally:
            queue = getattr(servicer, "telemetry_queue", None)
            if queue is not None:
                queue.stop()
        runs.append(answers)
    jax_answers, answers = runs
    assert [n for n, _ in answers] == [n for n, _ in jax_answers]
    for (name, want), (_, got) in zip(jax_answers, answers):
        if name == "JoinRendezvousRequest":
            # both re-planners' plans, byte for byte on the wire
            got = dataclasses.asdict(T.deserialize_message(got))
            want = dataclasses.asdict(J.deserialize_message(want))
        assert got == want, name
    decoded = [(n, T.deserialize_message(a)) for n, a in answers
               if n != "ClockProbe"]
    reports = json.loads(next(a for n, a in decoded
                              if n == "DiagnosisReportRequest").reports_json)
    assert {(r["rule"], r["worker_id"]) for r in reports} >= {
        ("critical_path", 1), ("straggler", 1)}
    polls = [json.loads(a.actions_json or "[]") for n, a in decoded
             if n == "DiagnosisActionRequest"]
    # one profile of rank 1 (the straggler's falls in the cooldown), the
    # survivor's urgent checkpoint after the drain notice
    assert [[x["kind"] for x in p] for p in polls] == [
        [], ["profile"], [], ["checkpoint"]]
    drain = next(a for n, a in decoded if n == "DrainReport")
    assert drain.success and drain.checkpoint_ranks == [0]
    traces = json.loads(next(a for n, a in decoded
                             if n == "StepTraceRequest").result_json)
    assert [g["gating_rank"] for g in traces["steps"]] == [1] * 6


def test_survivor_agent_saves_and_continues_on_checkpoint(tmp_path):
    """The port's master (in this process) fans an urgent ``checkpoint``
    out to rank 0, as it does to a drain's survivors; the rank's agent
    (the CLI, on the CPU) hands its worker a save-and-continue request,
    which saves at the next step boundary and trains on to the end."""
    import os
    import subprocess
    import sys

    from dlrover_tpu_torch.master.job_master import JobMaster

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log_file = tmp_path / "worker.log"
    master = JobMaster(host="127.0.0.1")
    master.prepare()
    try:
        env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
                   TMPDIR=str(tmp_path),
                   DLROVER_TPU_FLIGHT_DIR=str(tmp_path / "flight"),
                   DLROVER_TPU_CHAOS="slow:worker:0@1:0.2",
                   DLROVER_TPU_CHAOS_STATE=str(tmp_path / "chaos"))
        proc = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.run", "--master-addr",
             master.addr, "--monitor-interval", "0.2",
             os.path.join(repo, "dlrover_tpu_torch/examples/llama_train.py"),
             "--config", "tiny", "--device", "cpu", "--steps", "30",
             "--save-interval", "100", "--ckpt-dir", str(tmp_path / "c"),
             "--log-file", str(log_file)],
            cwd=repo, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        deadline = time.time() + 120
        while time.time() < deadline and "step 3 loss" not in (
                log_file.read_text() if log_file.exists() else ""):
            time.sleep(0.1)
        queued = master.diagnosis_manager.request_checkpoint(
            [0], time.time() + 60.0, reason="peer rank 1 draining")
        assert queued == [0]
        _, err = proc.communicate(timeout=180)
        assert proc.returncode == 0, err[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
        master.stop(grace_s=0.1)
    assert "urgent checkpoint requested of the worker" in err
    text = log_file.read_text()
    step = int(text.split("drain request at step ")[1].split()[0])
    assert 3 <= step < 30 and "exit=False" in text
    assert sorted(os.listdir(tmp_path / "c")) == [str(step)]
    assert "llama_train: done step=30" in text
