"""The port's master survives its own death, as the JAX master does.

- Either package's master restores the other's snapshot lineage, every
  ported component's export equal afterwards; the JAX snapshot's keys of
  unported parts are ignored.
- ``_handle_reconnect`` answers a request sequence (a fresh master, a
  restarted one, a moved round) as the JAX servicer does.
- The four cases of ``tests/test_master_failover.py`` on the port: state
  over a restart, a corrupt snapshot's fallback, agents riding out a
  restart with their workers, a worker crash during the outage.
- The hot standby (``tests/test_controlplane.py``'s promotion cases):
  warm state, promotion, fencing of a revived primary, an agent riding
  out the promotion; and a port standby promoting from a JAX primary.
- A worker loop on a moved master: both packages' loops keep dialing the
  dead address (neither re-resolves on its report's failure path) and
  the promoted master gets none of their step reports.

Agents here are one or two, with sub-second intervals and a 0.5 s RPC
deadline, so that each case stays a few seconds long.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from dlrover_tpu.agent.master_client import MasterClient as JClient
from dlrover_tpu.common import messages as J
from dlrover_tpu.common.config import Context as JContext
from dlrover_tpu.master.job_master import JobMaster as JMaster
from dlrover_tpu_torch import obs
from dlrover_tpu_torch.agent.elastic_agent import ElasticAgent, WorkerSpec
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import messages as T
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.master.job_master import JobMaster
from dlrover_tpu_torch.master.standby import StandbyMaster
from dlrover_tpu_torch.master.state_backend import (
    MasterStateBackend,
    MutationLog,
)

TRAIN = RendezvousName.TRAINING
SLEEPER = [sys.executable, "-c", "import time; time.sleep(120)"]
# the components both packages' snapshots hold
PORTED = ("rendezvous", "task_manager", "kv_store", "speed_monitor",
          "goodput", "diagnosis", "plan_calibration")
# the JAX snapshot's keys of parts these masters are built without (the
# fleet controller is off by default; no job manager without job_args)
UNPORTED = ("fleet_controller", "job_manager")


def _knobs(tmp_path, **extra):
    knobs = dict(rpc_timeout_s=0.5, rpc_retries=2, rpc_backoff_s=0.02,
                 rpc_backoff_max_s=0.05, master_reconnect_timeout_s=60.0,
                 master_state_dir=str(tmp_path / "state"),
                 master_bootstrap_file=str(tmp_path / "master.addr"),
                 standby_health_interval_s=0.25,
                 standby_promote_failures=2, diagnosis_enabled=True,
                 diagnosis_interval_s=3600.0,
                 tsdb_sample_interval_s=0.0)
    knobs.update(extra)
    return knobs


@pytest.fixture
def ctx(tmp_path, monkeypatch):
    """Both packages' Context singletons with every reconnect and retry
    knob shrunk, state and bootstrap under the test's directory."""
    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    JContext.reset()
    Context.reset()
    JContext.singleton().update(**_knobs(tmp_path))
    Context.singleton().update(**_knobs(tmp_path))
    yield Context.singleton()
    JContext.reset()
    Context.reset()


def _wait_for(predicate, timeout_s: float, what: str):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _shard_params(m, size=40):
    return m.DatasetShardParams(
        dataset_name="ds", dataset_size=size, shard_size=10,
        num_epochs=1, task_type="training", storage_type="table")


def _drive(master, m):
    """One job's control-plane history through a master's servicer (in
    process, no wire): a cut world of two, dataset tasks in every state,
    cold and hot keys, the model info and step reports, a crash, a hang
    and the spans of a telemetry report."""
    s = master.servicer
    for rank in (0, 1):
        s.report(m.JoinRendezvousRequest(node_id=rank, node_rank=rank,
                                         local_world_size=1,
                                         rdzv_name=TRAIN,
                                         node_ip=f"10.0.0.{rank + 1}"))
    s.get(m.CommWorldRequest(node_id=0, rdzv_name=TRAIN))
    s.report(_shard_params(m))
    first = s.get(m.TaskRequest(dataset_name="ds", worker_id=0))
    s.get(m.TaskRequest(dataset_name="ds", worker_id=1))
    s.report(m.TaskResult(dataset_name="ds", task_id=first.task_id,
                          worker_id=0, success=True))
    s.report(m.KeyValuePair(key="cold", value=b"\x00\x01cold"))
    s.report(m.KeyValuePair(key="coord/elastic-training/0",
                            value=b"10.0.0.1:29500"))
    s.report(m.ModelInfo(param_count=1000, param_bytes=4000,
                         flops_per_token=6000.0, peak_flops_per_chip=1e12,
                         batch_size=8, seq_len=32, chips=2))
    for step in (1, 2, 3):
        for rank in (0, 1):
            s.report(m.GlobalStepReport(node_id=rank, node_rank=rank,
                                        step=step, step_time_s=0.25,
                                        mfu=0.4))
    s.report(m.PeerStoreReport(node_id=0, node_rank=0, addr="10.0.0.1:7",
                               step=3, rdzv_name=TRAIN, keys=["a", "b"],
                               total_bytes=64))
    now = time.time()
    s.report(m.TelemetryReport(node_id=1, node_rank=1, spans_json=json.dumps(
        [{"kind": "span", "name": "restore_or_init", "span_id": "s1",
          "duration_s": 1.5, "ts": now - 2.0, "end_ts": now - 0.5,
          "attrs": {}, "trace_id": "t", "parent_id": "", "status": "ok",
          "pid": 1}])))
    s.telemetry_queue.flush(timeout_s=5.0)
    s.report(m.NodeFailureReport(node_id=1, node_rank=1, level="error",
                                 error_data="boom", exit_kind="crashed"))
    s.report(m.NodeFailureReport(node_id=0, node_rank=0, level="error",
                                 error_data="stuck", exit_kind="hang"))


def _port_keys(jax_part: dict, port_part: dict) -> dict:
    """The JAX component export cut to the fields the port's holds."""
    return {k: jax_part[k] for k in port_part if k in jax_part}


@pytest.mark.parametrize("writer", ["jax-flat", "jax-sharded", "port"])
def test_either_master_restores_the_others_snapshot(ctx, writer,
                                                    tmp_path):
    """A history driven through one package's master, snapshotted, and
    restored by the other package's master: generation + 1, every ported
    component's export equal to the snapshot's, and the JAX-only keys
    neither restored nor written."""
    for c in (ctx, JContext.singleton()):
        c.update(coord_port=-1)
    JContext.singleton().update(rdzv_sharded=writer == "jax-sharded")
    if writer == "port":
        master, m, Reader = JobMaster(port=0, min_nodes=2, max_nodes=2,
                                      host="127.0.0.1"), T, JMaster
        JContext.singleton().update(rdzv_sharded=False)
    else:
        master, m, Reader = JMaster(port=0, min_nodes=2, max_nodes=2,
                                    host="127.0.0.1"), J, JobMaster
    _drive(master, m)
    master.stop(grace_s=0.1)      # its forced snapshot holds the history
    backend = MasterStateBackend(str(tmp_path / "state"))
    state, version = backend.load_latest()
    assert state["generation"] == 1
    assert state["diagnosis"]["reports"], "no diagnosis report to carry"
    assert state["goodput"], "no goodput ledger to carry"
    reader = Reader(port=0, min_nodes=2, max_nodes=2, host="127.0.0.1")
    try:
        assert reader.generation == 2
        restored = reader._export_state()
        assert restored["generation"] == 2
        if writer == "port":
            assert set(UNPORTED) - set(state) == set(UNPORTED)
        else:
            assert "plan_calibration" in state
            assert not set(UNPORTED) & set(restored)
        for key in PORTED:
            if key == "rendezvous":
                continue
            want, got = state[key], restored[key]
            if writer != "port":
                want = _port_keys(want, got) if isinstance(got, dict) \
                    else want
            else:
                got = _port_keys(got, want) if isinstance(want, dict) \
                    else got
            assert got == want, key
        for name in (TRAIN, RendezvousName.NETWORK_CHECK):
            got = restored["rendezvous"][name]
            want = state["rendezvous"][name]
            if writer == "jax-sharded" and name == TRAIN:
                fleet = want["shards"]["-1"]
                assert got["round"] == fleet["round"] == 1
                assert got["latest_world"] == fleet["latest_world"] == {
                    "0": 1, "1": 1}
                assert got["alive"] == fleet["alive"]
                assert got["world_epoch"] == want["world_epoch"]
                assert got["peer_stores"] == want["peer_stores"]
                continue
            if writer == "port":
                got = _port_keys(got, want)
            else:
                want = _port_keys(want, got)
            assert got == want, name
        mgr = reader.rdzv_managers[TRAIN]
        assert mgr.latest_world == {0: 1, 1: 1}
        assert reader.kv_store.get("cold") == b"\x00\x01cold"
        assert reader.speed_monitor.completed_global_step == 3
    finally:
        reader.stop(grace_s=0.1)


def test_unported_snapshot_keys_are_ignored(ctx, tmp_path):
    """A JAX snapshot carrying the fleet controller and the job manager
    restores into the port's master, which neither applies nor
    re-exports them; its planner calibration, ported since, is restored
    and exported as it was loaded."""
    ctx.update(coord_port=-1)
    calibration = {"version": 1, "current": "", "entries": {}}
    state = {"generation": 4,
             "kv_store": {"k": "dg=="},
             "plan_calibration": calibration,
             "fleet_controller": {"decisions": [1, 2]},
             "job_manager": {"nodes": {"0": "running"}}}
    master = JobMaster(port=0, host="127.0.0.1",
                       preloaded_state=(state, 7))
    try:
        assert master.generation == 5
        assert master.kv_store.get("k") == b"v"
        exported = master._export_state()
        assert not set(UNPORTED) & set(exported)
        assert exported["plan_calibration"] == calibration
    finally:
        master.stop(grace_s=0.1)


# ---------------------------------------------------------------------------
# the reconnect handshake against the JAX servicer's
# ---------------------------------------------------------------------------


def _reconnect_script(master_cls, m, tmp_path, which):
    """Answers to the same ReconnectRequests from a fresh master, a
    restarted one over its state, and after the world moved a round."""
    state = str(tmp_path / which)
    answers = []

    def reconnect(master, rank, rnd, gen):
        answer = master.servicer.report(m.ReconnectRequest(
            node_id=rank, node_rank=rank, rdzv_name=TRAIN,
            rdzv_round=rnd, generation=gen))
        answers.append((type(answer).__name__, answer.generation,
                        answer.world_intact, answer.round,
                        answer.coord_addr))

    def join(master, rank):
        master.servicer.report(m.JoinRendezvousRequest(
            node_id=rank, node_rank=rank, local_world_size=1,
            rdzv_name=TRAIN))

    master = master_cls(port=0, min_nodes=2, max_nodes=2,
                        host="127.0.0.1", state_dir=state)
    join(master, 0)
    reconnect(master, 0, -1, 0)          # no world yet
    join(master, 1)
    master.servicer.get(m.CommWorldRequest(node_id=0, rdzv_name=TRAIN))
    reconnect(master, 0, 0, 1)           # fresh master, world intact
    reconnect(master, 1, 3, 1)           # a round this master never cut
    reconnect(master, 7, 0, 1)           # a rank outside the world
    master.stop(grace_s=0.1)
    master = master_cls(port=0, min_nodes=2, max_nodes=2,
                        host="127.0.0.1", state_dir=state)
    reconnect(master, 0, 0, 1)           # restarted: generation 2
    reconnect(master, 1, 0, 0)
    join(master, 0)                      # the world moves a round
    join(master, 1)
    master.servicer.get(m.CommWorldRequest(node_id=1, rdzv_name=TRAIN))
    reconnect(master, 0, 0, 2)           # stale round
    reconnect(master, 0, 1, 2)           # the new one
    alive = sorted(master.rdzv_managers[TRAIN].alive_nodes)
    master.stop(grace_s=0.1)
    return answers, alive


def test_reconnect_answers_match_jax(ctx, tmp_path):
    for c in (ctx, JContext.singleton()):
        c.update(coord_port=-1, master_bootstrap_file="")
    JContext.singleton().update(rdzv_sharded=False)
    jax = _reconnect_script(JMaster, J, tmp_path, "jax")
    port = _reconnect_script(JobMaster, T, tmp_path, "port")
    assert port == jax
    answers, alive = port
    assert [a[2] for a in answers] == [False, True, False, False, True,
                                       True, False, True]
    assert [a[1] for a in answers] == [1, 1, 1, 1, 2, 2, 2, 2]
    assert 7 in alive                     # re-entered the alive set


# ---------------------------------------------------------------------------
# tests/test_master_failover.py on the port
# ---------------------------------------------------------------------------


def test_control_plane_state_survives_restart(ctx, tmp_path):
    """Drive a master over the wire, stop it, restore a new one from the
    snapshot lineage: the round and world, task progress (in-flight
    tasks too), the kv store and the step mark survive, and the
    bootstrap file names the new master at generation 2."""
    master1 = JobMaster(port=0, min_nodes=2, max_nodes=2, host="127.0.0.1")
    master1.prepare()
    c0 = MasterClient(master1.addr, node_id=0)
    c1 = MasterClient(master1.addr, node_id=1)
    try:
        c0.join_rendezvous(local_world_size=4)
        c1.join_rendezvous(local_world_size=4)
        assert c0.get_comm_world()[2] == {0: 4, 1: 4}
        assert c0.master_generation == 1
        c0.report_dataset_shard_params(_shard_params(T))
        t0a = c0.get_task("ds")
        t0b = c0.get_task("ds")
        t1 = c1.get_task("ds")
        assert c0.report_task_result("ds", t0a.task_id, True)
        c0.kv_set("coordinator", b"10.0.0.1:8476")
        c0.report_global_step(7)
        c0.kv_set("after-step", b"1")   # step reports do not snapshot
    finally:
        c0.close()
        c1.close()
    master1.stop(grace_s=0.1)

    master2 = JobMaster(port=0, min_nodes=2, max_nodes=2, host="127.0.0.1")
    master2.prepare()
    c = MasterClient(master2.addr, node_id=2)
    try:
        assert master2.generation == 2
        mgr = master2.rdzv_managers[TRAIN]
        assert mgr.rdzv_round == 1 and mgr.latest_world == {0: 4, 1: 4}
        with open(tmp_path / "master.addr") as f:
            assert json.load(f) == {"addr": master2.addr,
                                    "coord_addr": master2.coord_addr,
                                    "generation": 2}
        assert master2.task_manager.counts("ds") == (1, 2)
        dispatched = {t0a.shard.start, t0b.shard.start, t1.shard.start}
        assert c.get_task("ds").shard.start not in dispatched
        assert c.get_task("ds").task_type == "wait"
        assert c.report_task_result("ds", t1.task_id, True)
        assert c.kv_get("coordinator") == b"10.0.0.1:8476"
        assert master2.speed_monitor.completed_global_step == 7
    finally:
        c.close()
        master2.stop(grace_s=0.1)


def test_corrupt_snapshot_falls_back_to_older(ctx, tmp_path):
    master1 = JobMaster(port=0, host="127.0.0.1")
    master1.prepare()
    c0 = MasterClient(master1.addr, node_id=0)
    try:
        c0.kv_set("survives", b"yes")          # snapshot vN
        c0.kv_set("lost-with-torn", b"gone")   # snapshot vN+1 (torn)
    finally:
        c0.close()
    master1.stop(grace_s=0.1)
    backend = master1._state_backend
    latest = backend.versions()[-1]
    with open(backend._path(latest), "w") as f:
        f.write('{"version": %d, "torn' % latest)
    master2 = JobMaster(port=0, host="127.0.0.1")
    try:
        assert master2.kv_store.get("survives") == b"yes"
        assert master2.kv_store.get("lost-with-torn") == b""
        assert master2.generation == 2
    finally:
        master2.stop(grace_s=0.1)


def _agents(master, ranks, **spec):
    agents = []
    for rank in ranks:
        client = MasterClient(master.addr, node_id=rank)
        agents.append(ElasticAgent(client, WorkerSpec(
            entrypoint=SLEEPER, devices_per_node=1,
            monitor_interval_s=0.1, rdzv_timeout_s=15.0,
            shutdown_grace_s=5.0, enable_monitors=False,
            master_lost_after_polls=2, **spec)))
    for agent in agents:
        threading.Thread(target=agent.run, daemon=True).start()
    _wait_for(lambda: all(a.last_round == 0 and a._proc is not None
                          for a in agents),
              15.0, "initial rendezvous and worker spawn")
    return agents


def _shutdown(agents):
    for agent in agents:
        agent.shutdown()
        agent._client.close()


def test_agents_reconnect_and_keep_workers(ctx, tmp_path):
    """Two agents with running workers; the master stops and a new one
    restores from the snapshot. The agents enter master-lost mode,
    re-resolve the address from the bootstrap file, re-register, find
    their world intact and keep their workers (same pids); the flight
    dump shows master_restore → reconnect → rendezvous(resync)."""
    master1 = JobMaster(port=0, min_nodes=2, max_nodes=2, host="127.0.0.1")
    master1.prepare()
    agents = _agents(master1, (0, 1), max_restarts=0)
    try:
        pids = [a._proc.pid for a in agents]
        world_before = dict(agents[0].last_world)
        assert world_before == {0: 1, 1: 1}
        master1.stop(grace_s=0.1)
        master2 = JobMaster(port=0, min_nodes=2, max_nodes=2,
                            host="127.0.0.1")
        master2.prepare()
        try:
            assert master2.generation == 2
            _wait_for(lambda: all(
                a._client.master_addr == master2.addr
                and a._client.master_generation == 2 for a in agents),
                30.0, "agents to reconnect to the restarted master")
            assert master2.rdzv_managers[TRAIN].latest_world == world_before
            assert master2.kv_store.get("coord/elastic-training/0") != b""
            time.sleep(0.3)
            assert [a._proc.pid for a in agents] == pids
            assert all(a._proc.poll() is None for a in agents)
            _assert_span_sequence()
        finally:
            master2.stop(grace_s=0.1)
    finally:
        _shutdown(agents)


def test_worker_crash_during_outage_reforms_world(ctx, tmp_path):
    """The worker dies while the master is down: its restart cannot
    rendezvous, so it falls into master-lost handling and, once the
    restarted master serves, re-joins; the world re-forms at round 1
    with a fresh worker."""
    master1 = JobMaster(port=0, host="127.0.0.1")
    master1.prepare()
    agents = _agents(master1, (0,), max_restarts=3)
    try:
        victim_pid = agents[0]._proc.pid
        master1.stop(grace_s=0.1)
        agents[0]._proc.kill()
        time.sleep(1.0)                   # the restart meets the outage
        master2 = JobMaster(port=0, host="127.0.0.1")
        master2.prepare()
        try:
            _wait_for(lambda: agents[0].last_round == 1
                      and agents[0]._proc is not None
                      and agents[0]._proc.poll() is None,
                      30.0, "the world to re-form at round 1")
            assert agents[0]._proc.pid != victim_pid
            assert master2.rdzv_managers[TRAIN].latest_world == {0: 1}
            names = [e.get("name") for e in
                     obs.get_flight_recorder().snapshot()]
            assert "master_lost" in names
        finally:
            master2.stop(grace_s=0.1)
    finally:
        _shutdown(agents)


def _assert_span_sequence():
    """master_restore → reconnect → rendezvous(resync), ordered by span
    end, all in one dump (master and agents share the recorder)."""
    path = obs.get_flight_recorder().dump(reason="failover-test")
    with open(path) as f:
        events = json.load(f)["events"]
    spans = [e for e in events
             if e.get("kind") == "span" and e.get("status") == "ok"]

    def end_of(name, **attrs):
        matches = [s for s in spans if s["name"] == name
                   and all(s.get("attrs", {}).get(k) == v
                           for k, v in attrs.items())]
        assert matches, f"no ok span {name!r} ({attrs}) in the dump"
        return max(s["end_ts"] for s in matches)

    assert (end_of("master_restore") <= end_of("reconnect")
            <= end_of("rendezvous", resync=True, world_intact=True))


# ---------------------------------------------------------------------------
# the hot standby
# ---------------------------------------------------------------------------


def test_promotion_preserves_state_and_fences_old_primary(ctx, tmp_path):
    primary = JobMaster(port=0, min_nodes=2, max_nodes=2, host="127.0.0.1")
    primary.prepare()
    c0 = MasterClient(primary.addr, node_id=0)
    c1 = MasterClient(primary.addr, node_id=1)
    standby = StandbyMaster(state_dir=str(tmp_path / "state"),
                            host="127.0.0.1", min_nodes=2, max_nodes=2)
    try:
        c0.join_rendezvous(local_world_size=4)
        c1.join_rendezvous(local_world_size=4)
        assert c0.get_comm_world()[2] == {0: 4, 1: 4}
        assert c0.coord_addr == primary.coord_addr != ""
        for i in range(3):
            c0.report_global_step(5 + i, step_time_s=0.05, mfu=0.4,
                                  hbm_peak_bytes=256.0 * (1 << 20))
        primary.tsdb_collector.sample_once()
        assert primary.tsdb_collector.flush()
        c0.kv_set("coordinator", b"10.0.0.1:1")      # cold
        # a hot coord/ key set after the last cold snapshot survives
        # through the mutation log's tail
        c0.kv_set("coord/elastic-training/0", b"hot-tail")
        assert primary._mutation_log.flush()
        standby.start()
        _wait_for(lambda: standby.warm_version > 0, 10.0, "standby warm")
        assert standby.consecutive_failures == 0
        primary._server.stop(0)                       # a kill, no stop()
        primary._coord_server.stop(0)
        _wait_for(lambda: standby.promoted_master is not None, 20.0,
                  "standby promotion")
        promoted = standby.promoted_master
        assert promoted.generation == 2
        assert MasterClient.resolve_master_addr() == promoted.addr
        c0.reconnect(MasterClient.resolve_master_addr())
        result = c0.reconnect_report(local_world_size=4, rdzv_round=0)
        assert result.world_intact and result.generation == 2
        assert c0.coord_addr == promoted.coord_addr != primary.coord_addr
        assert promoted.kv_store.get("coordinator") == b"10.0.0.1:1"
        assert promoted.kv_store.get(
            "coord/elastic-training/0") == b"hot-tail"
        history = promoted.tsdb.query(
            "dlrover_tpu_worker_hbm_peak_mb", labels={"node": "0"},
            resolution_s=10.0)
        assert history and history[0]["points"][-1][1] == 256.0
        with open(tmp_path / "master.addr") as f:
            assert json.load(f) == {"addr": promoted.addr,
                                    "coord_addr": promoted.coord_addr,
                                    "generation": 2}
        primary._publish_bootstrap_addr()             # a revived primary
        with open(tmp_path / "master.addr") as f:
            assert json.load(f)["addr"] == promoted.addr
        names = [e.get("name") for e in
                 obs.get_flight_recorder().snapshot()]
        assert "master_promoted" in names and "master_fenced" in names
    finally:
        c0.close()
        c1.close()
        standby.stop()
        primary.stop(grace_s=0.1)


def test_fenced_primary_stops_writing_the_shared_lineage(ctx, tmp_path):
    primary = JobMaster(port=0, host="127.0.0.1")
    primary.prepare()
    client = MasterClient(primary.addr, node_id=0)
    try:
        client.kv_set("pre-fence", b"1")
        boot = str(tmp_path / "master.addr")
        with open(boot + ".tmp", "w") as f:
            json.dump({"addr": "10.0.0.9:1", "coord_addr": "",
                       "generation": 99}, f)
        os.replace(boot + ".tmp", boot)
        primary._check_fenced(throttle_s=0.0)
        version = primary._state_backend.versions()[-1]
        client.kv_set("post-fence-cold", b"2")            # would snapshot
        client.kv_set("coord/elastic-training/9", b"hot")  # would log
        assert primary._state_backend.versions()[-1] == version
        primary._mutation_log.flush()
        log = MutationLog.read(str(tmp_path / "state"))
        assert all(k != "coord/elastic-training/9" for k, _ in log)
    finally:
        client.close()
        primary.stop(grace_s=0.1)


def test_agent_rides_out_promotion_without_worker_restart(ctx, tmp_path):
    """A killed primary, a standby that promotes, and an agent that keeps
    its worker (same pid): no re-join, no spawn after the kill, and the
    master_lost → master_promoted → master_reconnected(world_intact)
    sequence in the flight record."""
    primary = JobMaster(port=0, host="127.0.0.1")
    primary.prepare()
    standby = StandbyMaster(state_dir=str(tmp_path / "state"),
                            host="127.0.0.1")
    agents = _agents(primary, (0,), max_restarts=0)
    try:
        pid = agents[0]._proc.pid
        standby.start()
        _wait_for(lambda: standby.warm_version > 0, 10.0, "standby warm")
        kill_ts = time.time()
        primary._server.stop(0)
        primary._coord_server.stop(0)
        _wait_for(lambda: standby.promoted_master is not None, 20.0,
                  "promotion")
        promoted = standby.promoted_master
        _wait_for(lambda: agents[0]._client.master_addr == promoted.addr
                  and agents[0]._client.master_generation == 2,
                  30.0, "the agent to reconnect")
        time.sleep(0.3)
        assert agents[0]._proc.pid == pid and agents[0]._proc.poll() is None
        assert agents[0]._client.coord_addr == promoted.coord_addr
        by_name = {}
        events = obs.get_flight_recorder().snapshot()
        for event in events:
            if event.get("ts", 0.0) >= kill_ts:
                by_name.setdefault(event.get("name"), []).append(event)
        assert by_name.get("master_lost")
        assert len(by_name.get("master_promoted", [])) == 1
        reconnected = by_name.get("master_reconnected", [])
        assert reconnected and all(e["attrs"]["world_intact"]
                                   for e in reconnected)
        assert (by_name["master_promoted"][0]["ts"]
                <= max(e["ts"] for e in reconnected))
        assert "worker_spawn" not in by_name
        assert not [e for e in events if e.get("kind") == "span"
                    and e.get("name") == "rendezvous_join"
                    and e.get("ts", 0.0) >= kill_ts]
    finally:
        _shutdown(agents)
        standby.stop()
        primary.stop(grace_s=0.1)


def test_port_standby_promotes_from_a_jax_primary(ctx, tmp_path):
    """A JAX primary at its defaults (sharded rendezvous, coordination
    tier) with a port standby on its state dir and bootstrap file: the
    standby probes it over the shared wire, promotes when it dies, and a
    JAX client's reconnect finds its world intact at generation 2."""
    primary = JMaster(port=0, min_nodes=2, max_nodes=2, host="127.0.0.1")
    primary.prepare()
    c0 = JClient(primary.addr, node_id=0)
    c1 = JClient(primary.addr, node_id=1)
    standby = StandbyMaster(state_dir=str(tmp_path / "state"),
                            host="127.0.0.1", min_nodes=2, max_nodes=2)
    try:
        c0.join_rendezvous(local_world_size=1)
        c1.join_rendezvous(local_world_size=1)
        assert c0.get_comm_world()[2] == {0: 1, 1: 1}
        c0.kv_set("coordinator", b"10.0.0.1:1")
        c0.kv_set("coord/elastic-training/0", b"hot")
        assert primary._mutation_log.flush()
        standby.start()
        _wait_for(lambda: standby.warm_version > 0, 10.0, "standby warm")
        assert standby.consecutive_failures == 0
        primary._server.stop(0)
        primary._coord_server.stop(0)
        _wait_for(lambda: standby.promoted_master is not None, 20.0,
                  "promotion")
        promoted = standby.promoted_master
        assert promoted.generation == 2
        assert promoted.rdzv_managers[TRAIN].latest_world == {0: 1, 1: 1}
        assert promoted.kv_store.get("coord/elastic-training/0") == b"hot"
        addr = JClient.resolve_master_addr()
        assert addr == promoted.addr
        c0.reconnect(addr)
        result = c0.reconnect_report(local_world_size=1, rdzv_round=0)
        assert result.world_intact and result.generation == 2
        assert c0.kv_get("coordinator") == b"10.0.0.1:1"
    finally:
        c0.close()
        c1.close()
        standby.stop()
        primary.stop(grace_s=0.1)


def test_cli_standby_promotes_and_publishes(ctx, tmp_path):
    """``run_master_main`` runs the primary and, with ``--standby``, the
    standby, each from its flags alone: the standby tails the primary's
    lineage and takes the bootstrap file over at generation 2 when the
    primary stops answering."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo,
               DLROVER_TPU_STANDBY_HEALTH_INTERVAL_S="0.25",
               DLROVER_TPU_STANDBY_PROMOTE_FAILURES="2",
               DLROVER_TPU_DIAGNOSIS_ENABLED="0")
    flags = ["--state-dir", str(tmp_path / "cli-state"),
             "--bootstrap-file", str(tmp_path / "cli.addr")]
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.master.job_master"]
    primary = subprocess.Popen(cmd + flags, env=env, cwd=repo,
                               stdout=subprocess.PIPE, text=True)
    standby = None
    try:
        line = primary.stdout.readline()
        assert line.startswith("DLROVER_TPU_MASTER_ADDR="), line
        with open(tmp_path / "cli.addr") as f:
            boot = json.load(f)
        assert boot["generation"] == 1 and boot["coord_addr"]
        standby = subprocess.Popen(cmd + flags + ["--standby"], env=env,
                                   cwd=repo, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
        assert standby.stdout.readline().strip() == \
            "DLROVER_TPU_STANDBY=watching"
        time.sleep(0.5)
        primary.kill()
        primary.wait(10)

        def promoted():
            with open(tmp_path / "cli.addr") as f:
                return json.load(f)["generation"] == 2

        _wait_for(promoted, 20.0, "the standby's bootstrap publish")
        with open(tmp_path / "cli.addr") as f:
            boot2 = json.load(f)
        assert boot2["addr"] != boot["addr"]
        client = MasterClient(boot2["addr"], node_id=0)
        try:
            assert client.get_job_status().stage
        finally:
            client.close()
    finally:
        for proc in (primary, standby):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(10)


# ---------------------------------------------------------------------------
# a worker loop on a moved master
# ---------------------------------------------------------------------------


def _moving_batches(vocab, move, count=4):
    """Seeded batches; the master moves while the third step runs."""
    rng = np.random.default_rng(0)
    for i in range(count):
        if i == 2:
            move()
        tokens = rng.integers(0, vocab, (4, 16), dtype=np.int32)
        yield tokens, tokens


def _moved_master_run(which, tmp_path, cpu_devices):
    """A tiny loop of one package with a master client, 4 steps, a step
    report a step; before the third step the master moves (stopped, a
    new one restored on another port, the bootstrap file rewritten).
    Returns what the loop and the moved-to master saw."""
    state = str(tmp_path / f"{which}-state")
    for c in (Context.singleton(), JContext.singleton()):
        c.update(master_bootstrap_file=str(tmp_path / f"{which}.addr"))
    if which == "jax":
        import jax
        import optax

        from dlrover_tpu.models import llama as jllama
        from dlrover_tpu.parallel.mesh import MeshSpec as JMeshSpec
        from dlrover_tpu.trainer import elastic_loop as jloop

        master_cls, client_cls = JMaster, JClient
    else:
        import functools

        import torch

        from dlrover_tpu_torch.models.llama import (
            Llama,
            LlamaConfig,
            cross_entropy_loss,
        )
        from dlrover_tpu_torch.trainer.elastic_loop import (
            ElasticTrainLoop,
            TrainLoopConfig,
        )

        master_cls, client_cls = JobMaster, MasterClient
    first = master_cls(port=0, host="127.0.0.1", state_dir=state)
    first.prepare()
    client = client_cls(first.addr, node_id=0)
    moved = {}

    def move():
        first.stop(grace_s=0.1)
        second = master_cls(port=0, host="127.0.0.1", state_dir=state)
        second.prepare()
        moved["master"] = second
        moved["step_at_move"] = second.speed_monitor.completed_global_step

    try:
        if which == "jax":
            cfg = jllama.LlamaConfig.tiny(attn_impl="reference")
            loop = jloop.ElasticTrainLoop(
                jllama.Llama(cfg), optax.adamw(1e-3),
                jllama.cross_entropy_loss,
                jloop.TrainLoopConfig(
                    global_batch=4, seq_len=16, max_micro_per_replica=4,
                    max_steps=4, report_interval_steps=1,
                    mesh_spec=JMeshSpec()),
                devices=cpu_devices[:1], master_client=client)
            state0, _ = loop.restore_or_init(jax.random.PRNGKey(0))
        else:
            cfg = LlamaConfig.tiny(dtype=torch.float32)
            loop = ElasticTrainLoop(
                functools.partial(Llama, cfg),
                lambda p: torch.optim.AdamW(p, lr=1e-3),
                cross_entropy_loss,
                TrainLoopConfig(global_batch=4, seq_len=16,
                                max_micro_per_replica=4, max_steps=4,
                                report_interval_steps=1),
                master_client=client, device="cpu")
            state0, _ = loop.restore_or_init(0)
        _, metrics = loop.run(state0, _moving_batches(cfg.vocab_size, move),
                              start_step=0)
        loop.close()
        second = moved["master"]
        return {"steps": int(metrics["step"]),
                # the clock probe stays rate-limited (30 s): it is not
                # one of the calls a step on the dead address pays
                "clock_probe_failures": loop._clock_sync.stats()[
                    "failures"],
                "dials_old_address": client.master_addr == first.addr,
                "moved": second.addr != first.addr,
                "bootstrap_names_new": (client_cls.resolve_master_addr()
                                        == second.addr),
                "reports_reaching_new_master": (
                    second.speed_monitor.completed_global_step
                    - moved["step_at_move"]),
                "new_generation": second.generation}
    finally:
        client.close()
        if "master" in moved:
            moved["master"].stop(grace_s=0.1)
        first.stop(grace_s=0.1)


def test_loops_keep_dialing_a_moved_master_as_jax(ctx, tmp_path,
                                                  cpu_devices):
    """Neither package's loop re-resolves the master on its step
    report's failure path: after a move both keep dialing the dead
    address, finish every step, and the new master gets none of their
    step reports. Each step on the dead address pays the RPC deadline
    for its step report and its step-trace flush."""
    for c in (ctx, JContext.singleton()):
        c.update(coord_port=-1, rpc_timeout_s=0.2)
    JContext.singleton().update(rdzv_sharded=False)
    jax = _moved_master_run("jax", tmp_path, cpu_devices)
    port = _moved_master_run("torch", tmp_path, cpu_devices)
    assert port == jax
    assert port == {"steps": 4, "clock_probe_failures": 0,
                    "dials_old_address": True, "moved": True,
                    "bootstrap_names_new": True,
                    "reports_reaching_new_master": 0,
                    "new_generation": 2}
