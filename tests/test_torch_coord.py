"""The port's coordination tier against the JAX package's.

``CoordServicer`` answers the kv RPCs on a port of its own; the
``MasterClient`` routes hot-prefix keys there and falls back to the main
tier through its breaker when the tier is down. ``TelemetryIngestQueue``
drops the oldest report past its bound and flushes to the same replay
order as the JAX queue.
"""

import json
import threading
import time

import pytest

from dlrover_tpu.common import messages as J
from dlrover_tpu.common.config import Context as JContext
from dlrover_tpu.master.coord_service import (
    CoordServicer as JCoordServicer,
    TelemetryIngestQueue as JQueue,
)
from dlrover_tpu.master.kv_store import KVStoreService as JKV
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import messages as T
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.master.coord_service import (
    CoordServicer,
    TelemetryIngestQueue,
)
from dlrover_tpu_torch.master.job_master import JobMaster
from dlrover_tpu_torch.master.kv_store import KVStoreService


@pytest.fixture
def fast_rpc(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path))
    Context.reset()
    JContext.reset()
    Context.singleton().update(rpc_timeout_s=1.0, rpc_retries=2,
                               rpc_backoff_s=0.02, rpc_backoff_max_s=0.05,
                               diagnosis_enabled=False)
    yield Context.singleton()
    Context.reset()
    JContext.reset()


def _answers(servicer, messages):
    out = []
    for kind, request in messages:
        send = servicer.get if kind == "get" else servicer.report
        answer = send(request)
        out.append((type(answer).__name__, dict(vars(answer))))
    return out


def _script(m):
    return [
        ("report", m.KeyValuePair(key="coord/t/0", value=b"a:1")),
        ("report", m.KeyValuePair(key="cold", value=b"c")),
        ("get", m.KVGetRequest(key="coord/t/0")),
        ("get", m.KVGetRequest(key="missing")),
        ("report", m.KVAddRequest(key="coord/t/0/n", amount=2)),
        ("report", m.KVAddRequest(key="coord/t/0/n", amount=5)),
        ("get", m.KVWaitRequest(keys=["coord/t/0"], timeout_s=0.1)),
        ("get", m.KVWaitRequest(keys=["never"], timeout_s=0.05)),
        ("get", m.TaskRequest(dataset_name="ds")),
        ("report", m.GlobalStepReport(step=3)),
    ]


def test_coord_servicer_answers_match_jax():
    """The same request sequence through both tiers: the same answers,
    a refusal for anything outside the coordination surface, and a
    snapshot only after a cold key."""
    sinks = [[], []]
    jax = JCoordServicer(JKV(), state_sink=lambda: sinks[0].append(1))
    port = CoordServicer(KVStoreService(),
                         state_sink=lambda: sinks[1].append(1))
    assert _answers(port, _script(T)) == _answers(jax, _script(J))
    assert sinks[0] == sinks[1] == [1]


def test_coord_servicer_refuses_slice_status_as_not_ported():
    """Slice mode (6.4) is ported: the tier answers ``SliceStatusRequest``
    from the slice registry with the job's step, as JAX's tier does, and
    with an empty status when it has no registry."""
    from dlrover_tpu.master.rendezvous import (
        ElasticTrainingRendezvousManager as JManager,
    )
    from dlrover_tpu.master.speed_monitor import SpeedMonitor as JSpeed
    from dlrover_tpu_torch.master.rendezvous import (
        ElasticTrainingRendezvousManager,
    )
    from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor

    answers = []
    for mod, kv, manager, speed, servicer in (
            (J, JKV, JManager, JSpeed, JCoordServicer),
            (T, KVStoreService, ElasticTrainingRendezvousManager,
             SpeedMonitor, CoordServicer)):
        mgr, monitor = manager(), speed()
        for rank, sid in ((0, 0), (1, 1)):
            mgr.join_rendezvous(rank, 1, slice_id=sid)
            mgr.get_comm_world(rank)
        monitor.collect_global_step(4)
        tier = servicer(kv(), rdzv_manager=mgr, speed_monitor=monitor)
        answers.append(json.loads(
            tier.get(mod.SliceStatusRequest()).status_json))
        assert servicer(kv()).get(
            mod.SliceStatusRequest()).status_json == ""
    assert answers[1] == answers[0]
    assert answers[1]["fleet_step"] == 4 and answers[1]["total"] == 2


def test_hot_keys_ride_the_coordination_tier(fast_rpc):
    """Join results carry the tier's address; hot keys go there, cold
    keys stay on the main tier; both tiers share one store."""
    master = JobMaster(port=0, host="127.0.0.1")
    master.prepare()
    client = MasterClient(master.addr, node_id=0)
    seen = {"coord": [], "main": []}
    coord_get = master.coord_servicer.get
    main_get = master.servicer.get
    master.coord_servicer.get = (
        lambda r: seen["coord"].append(type(r).__name__) or coord_get(r))
    master.servicer.get = (
        lambda r: seen["main"].append(type(r).__name__) or main_get(r))
    try:
        assert master.coord_addr
        client.join_rendezvous(local_world_size=1)
        assert client.coord_addr == master.coord_addr
        client.kv_set("coord/elastic-training/0", b"10.0.0.1:5")
        client.kv_set("cold", b"x")
        assert client.kv_get("coord/elastic-training/0") == b"10.0.0.1:5"
        assert client.kv_get("cold") == b"x"
        assert client.kv_wait("coord/elastic-training/0",
                              timeout_s=2.0) == b"10.0.0.1:5"
        assert client.kv_add("coord/elastic-training/0/n", 4) == 4
        assert seen["coord"].count("KVGetRequest") == 2
        assert seen["coord"].count("KVWaitRequest") == 1
        assert seen["main"].count("KVGetRequest") == 1
        assert "KVWaitRequest" not in seen["main"]
    finally:
        client.close()
        master.stop(grace_s=0.1)


def test_breaker_falls_back_to_the_main_tier(fast_rpc):
    """A dead coordination tier costs one failed call; for the next 5 s
    hot traffic goes straight to the main tier, which answers it."""
    master = JobMaster(port=0, host="127.0.0.1")
    master.prepare()
    client = MasterClient(master.addr, node_id=0,
                          coord_addr=master.coord_addr)
    try:
        client.kv_set("coord/elastic-training/0", b"v")
        master._coord_server.stop(0)
        started = time.monotonic()
        assert client.kv_get("coord/elastic-training/0") == b"v"
        assert client._coord_down_until > started
        deadline = client._coord_down_until
        assert client.kv_get("coord/elastic-training/0") == b"v"
        assert client._coord_down_until == deadline   # not re-dialed
        client.set_coord_addr("")
        assert client._coord_stub is None
    finally:
        client.close()
        master.stop(grace_s=0.1)


@pytest.mark.parametrize("maxlen,pushes", [(3, 7), (1, 4), (8, 5)])
def test_telemetry_queue_drops_oldest_like_jax(maxlen, pushes):
    """With the drainer held, the queue keeps the newest ``maxlen``
    reports and counts the rest dropped; on release both queues replay
    the same reports in the same order, and flush waits for them."""
    replays = []
    for cls in (JQueue, TelemetryIngestQueue):
        gate = threading.Event()
        seen = []

        def process(report, seen=seen, gate=gate):
            gate.wait(5.0)
            seen.append(report)

        queue = cls(process, maxlen=maxlen)
        queue.push("held")             # the drainer takes it and blocks
        deadline = time.time() + 2.0
        while queue._in_flight == 0 and time.time() < deadline:
            time.sleep(0.01)
        for i in range(pushes):
            queue.push(i)
        dropped = queue.dropped_total
        gate.set()
        assert queue.flush(timeout_s=5.0)
        queue.stop()
        replays.append((seen, dropped))
    assert replays[1] == replays[0]
    seen, dropped = replays[1]
    assert dropped == max(0, pushes - maxlen)
    assert seen == ["held"] + list(range(pushes))[-maxlen:]


def test_telemetry_queue_survives_a_failing_report():
    seen = []

    def process(report):
        if report == "bad":
            raise ValueError("boom")
        seen.append(report)

    queue = TelemetryIngestQueue(process, maxlen=4)
    for report in ("a", "bad", "b"):
        queue.push(report)
    assert queue.flush(timeout_s=5.0)
    queue.stop()
    assert seen == ["a", "b"]
