"""The port's planned and silent failures against the JAX package's
(tests/test_preemption.py): the preemption notice sources, the
agent→worker drain-request channel and its acknowledgement, the step-hang
watchdog with an injected abort, ``RelaunchGovernor`` on one sequence of
hang and crash events, the exit classification, and the rendezvous's
drain cases, each run through both packages on the same inputs and
clock; then the agent's side (a clean-drain exit is no failure) and one
drain through the port's CLI."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from dlrover_tpu.agent import elastic_agent as jagent
from dlrover_tpu.agent import preemption as jpre
from dlrover_tpu.common import constants as jconst
from dlrover_tpu.common.config import Context as JContext
from dlrover_tpu.master import rendezvous as jrdzv
from dlrover_tpu.trainer import watchdog as jwatchdog
from dlrover_tpu_torch import obs
from dlrover_tpu_torch.agent import elastic_agent as tagent
from dlrover_tpu_torch.agent import preemption as tpre
from dlrover_tpu_torch.common import constants as tconst
from dlrover_tpu_torch.common.config import Context as TContext
from dlrover_tpu_torch.master import rendezvous as trdzv
from dlrover_tpu_torch.trainer import watchdog as twatchdog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "dlrover_tpu_torch", "examples",
                      "llama_train.py")
PACKAGES = [pytest.param((jpre, jconst, JContext), id="jax"),
            pytest.param((tpre, tconst, TContext), id="port")]


@pytest.fixture(autouse=True)
def _fresh_contexts():
    JContext.reset()
    TContext.reset()
    yield
    JContext.reset()
    TContext.reset()


def test_knobs_and_exit_vocabulary_match_jax():
    jctx, tctx = JContext.singleton(), TContext.singleton()
    for knob in ("hang_watchdog_s", "preempt_default_grace_s",
                 "preempt_notice_poll_s", "preempt_env_horizon_s"):
        assert getattr(tctx, knob) == getattr(jctx, knob), knob
    for name in ("TIMELINE_FILE", "DRAIN_REQUEST_FILE",
                 "PREEMPTION_NOTICE_FILE", "PREEMPTION_AT"):
        assert getattr(tconst.NodeEnv, name) == getattr(jconst.NodeEnv,
                                                        name)
    assert tconst.WorkerExit.DRAIN == jconst.WorkerExit.DRAIN == 76


@pytest.mark.parametrize("code", [0, 76, -6, 134, -9, -15, 137, 143, 1,
                                  3, 255])
@pytest.mark.parametrize("hang_enabled", [True, False])
def test_exit_classification_matches_jax(code, hang_enabled):
    want = jconst.WorkerExit.classify(code, hang_enabled=hang_enabled)
    assert tconst.WorkerExit.classify(code,
                                      hang_enabled=hang_enabled) == want
    assert (tconst.WorkerExit.to_exit_status(code)
            == jconst.WorkerExit.to_exit_status(code))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_notice_sources(pkg, tmp_path, monkeypatch):
    pre, const, ctx_cls = pkg
    path = str(tmp_path / "notice.json")
    src = pre.FileNoticeSource(path)
    assert src.poll() is None                       # no file yet
    with open(path, "w") as f:
        json.dump({"grace_s": 5.0, "reason": "spot reclaim"}, f)
    notice = src.poll()
    assert notice.source == "file" and notice.reason == "spot reclaim"
    assert 3.0 < notice.deadline - time.time() <= 5.5
    deadline = time.time() + 42.0
    with open(path, "w") as f:
        json.dump({"deadline": deadline}, f)
    assert pre.FileNoticeSource(path).poll().deadline == deadline
    # a notice whose window closed is a leftover, not a drain
    with open(path, "w") as f:
        json.dump({"deadline": time.time() - 1.0}, f)
    assert pre.FileNoticeSource(path).poll() is None
    env = pre.EnvNoticeSource()
    monkeypatch.delenv(const.NodeEnv.PREEMPTION_AT, raising=False)
    assert env.poll() is None
    monkeypatch.setenv(const.NodeEnv.PREEMPTION_AT, str(time.time() + 86400))
    assert env.poll() is None                       # beyond the horizon
    monkeypatch.setenv(const.NodeEnv.PREEMPTION_AT, str(time.time() + 5))
    assert env.poll().source == "env"
    ctx_cls.singleton().update(preempt_env_horizon_s=7200.0)
    monkeypatch.setenv(const.NodeEnv.PREEMPTION_AT, str(time.time() + 3600))
    assert env.poll().source == "env"
    with open(path, "w") as f:
        json.dump({"grace_s": 9.0}, f)
    seen = []
    watcher = pre.PreemptionWatcher(seen.append,
                                    sources=[pre.FileNoticeSource(path)],
                                    poll_s=0.01)
    assert watcher.poll_once() is not None
    assert watcher.poll_once() is None              # delivered once
    assert len(seen) == 1
    watcher.stop()


@pytest.mark.parametrize("writer", [jpre, tpre], ids=["jax", "port"])
@pytest.mark.parametrize("reader", [jpre, tpre], ids=["jax", "port"])
def test_drain_request_channel_and_ack(writer, reader, tmp_path):
    """Either package's agent writes a request either package's loop
    reads; a rewrite inside one mtime tick is still seen, and the ack of
    a save-and-continue request survives a respawn."""
    path = str(tmp_path / "drain.json")
    src = reader.DrainRequestSource(path)
    assert src.poll() is None
    writer.write_drain_request(path, 1, 123.0, reason="r", exit_worker=True)
    assert src.poll() == {"seq": 1, "deadline": 123.0, "reason": "r",
                          "exit": True}
    assert src.poll() is None
    st = os.stat(path)
    writer.write_drain_request(path, 2, 9.0, exit_worker=False)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
    request = src.poll()
    assert request["seq"] == 2 and not request["exit"]
    src.acknowledge(request["seq"])
    assert reader.DrainRequestSource(path).poll() is None
    assert jpre.DrainRequestSource(path).poll() is None


def test_sigterm_chains_flight_dump_and_drain_notice(tmp_path):
    recorder = obs.FlightRecorder(role="chaintest", dump_dir=str(tmp_path))
    source = tpre.SignalNoticeSource()
    # start the chain from the default disposition: a handler that an
    # earlier test in this process left behind must not join it
    saved = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    try:
        source.install()
        recorder.install_signal_handlers()
        os.kill(os.getpid(), signal.SIGTERM)
        notice = source.poll()
        assert notice is not None and notice.source == "sigterm"
        assert notice.grace_s > 0
        assert (tmp_path / f"flight-chaintest-{os.getpid()}.json").exists()
    finally:
        recorder.uninstall_signal_handlers()
        source.close()
        if saved is not None:
            signal.signal(signal.SIGTERM, saved)


def _watchdogs(clock, aborts, **kw):
    return [mod.StepHangWatchdog(
        10.0, poll_s=999.0, clock=clock,
        abort_fn=lambda mod=mod: aborts.append(mod.__name__), **kw)
        for mod in (jwatchdog, twatchdog)]


def test_watchdog_matches_jax_with_an_injected_abort():
    t = [0.0]
    aborts = []
    trace = []
    for wd in _watchdogs(lambda: t[0], aborts, warmup_s=30.0):
        t[0] = 0.0
        out = []
        # the first step inside its warmup, then 10 s a step
        for now, step in ((20.0, None), (29.0, 1), (38.0, None),
                          (38.5, 2), (48.0, None), (48.6, None),
                          (49.0, 3), (52.0, None)):
            t[0] = now
            if step is not None:
                wd.notify_step(step)
            out.append(wd.check_once())
        trace.append(out)
    assert trace[1] == trace[0] == [False, False, False, False, False,
                                    True, True, True]
    assert aborts == ["dlrover_tpu.trainer.watchdog",
                      "dlrover_tpu_torch.trainer.watchdog"]
    events = [e for e in obs.get_flight_recorder().snapshot()
              if e.get("name") == "step_hang"]
    assert events[-1]["attrs"]["step"] == 2
    assert events[-1]["attrs"]["stacks"]["MainThread"]
    for hang_s in (0.0, 5.0, 150.0, 400.0):
        assert (twatchdog.default_warmup_s(hang_s)
                == jwatchdog.default_warmup_s(hang_s))
    disabled = twatchdog.StepHangWatchdog(0.0)
    disabled.start()
    assert disabled._thread is None


def test_watchdog_rearms_after_stop():
    aborts = []
    wd = twatchdog.StepHangWatchdog(0.2, poll_s=0.02, warmup_s=0.3,
                                    abort_fn=lambda: aborts.append(1))
    wd.start()
    wd.notify_step(1)
    wd.stop()
    time.sleep(0.4)                      # stalled while disarmed: quiet
    assert aborts == []
    wd.start()
    deadline = time.time() + 5.0
    while not aborts and time.time() < deadline:
        time.sleep(0.05)
    assert aborts == [1]
    wd.stop()


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


# (gap s, event, lifetime s, made progress)
EVENTS = [
    (0, "hang", 20.0, False), (30, "hang", 25.0, False),
    (30, "crash", 40.0, True), (5, "hang", 10.0, False),
    (60, "hang", 9.0, False), (60, "hang", 8.0, False),
    (60, "hang", 8.0, False), (70, "hang", 700.0, False),
    (1, "crash", 2.0, False), (1, "crash", 2.0, False),
    (700, "hang", 3.0, False), (2, "crash", 1.0, False),
]


@pytest.mark.parametrize("knobs", [
    dict(hang_watchdog_s=10.0, quarantine_failures=3,
         quarantine_window_s=30.0),
    dict(hang_watchdog_s=0.0),
    dict(hang_watchdog_s=100.0, quarantine_failures=0),
])
def test_relaunch_governor_on_hangs_and_crashes_matches_jax(knobs):
    JContext.singleton().update(**knobs)
    TContext.singleton().update(**knobs)
    clocks = FakeClock(), FakeClock()
    governors = (jagent.RelaunchGovernor(clock=clocks[0]),
                 tagent.RelaunchGovernor(clock=clocks[1]))
    trace = ([], [])
    for gap, kind, lifetime, progress in EVENTS:
        for gov, clock, out in zip(governors, clocks, trace):
            clock.now += gap
            if kind == "hang":
                gov.record_hang(lifetime, made_progress=progress)
            out.append(gov.record_failure(lifetime, made_progress=progress))
            out.append((gov.recent_failures, gov.quarantined))
    assert trace[1] == trace[0]
    if knobs.get("quarantine_failures") == 3:
        # three early hangs in a row quarantine however slow they come
        assert any(q for _, q in trace[1][1::2])


def _cut(mgr, ranks):
    for rank in ranks:
        mgr.join_rendezvous(rank, 1)
    _, _, world = mgr.get_comm_world(ranks[0])
    assert sorted(world) == sorted(ranks)


@pytest.mark.parametrize("rdzv", [jrdzv, trdzv], ids=["jax", "port"])
def test_rendezvous_drain_cases(rdzv):
    """tests/test_preemption.py's drain cases, through either manager."""
    params = rdzv.RendezvousParameters
    mgr = rdzv.ElasticTrainingRendezvousManager(
        params(min_nodes=1, max_nodes=2, wait_new_node_s=3600.0))
    _cut(mgr, [0, 1])
    assert mgr.mark_draining(1, time.time() + 60.0) == {0: 1}
    assert 1 in mgr.draining
    assert mgr.num_nodes_waiting() == 0        # survivors train on
    assert mgr.complete_drain(1)
    assert mgr.alive_nodes == {0}
    assert mgr.num_nodes_waiting() >= 1
    mgr.join_rendezvous(0, 1)                  # re-forms at once
    assert mgr.get_comm_world(0)[2] == {0: 1}
    # a blown deadline is reaped with the liveness timeout off
    mgr = rdzv.ElasticTrainingRendezvousManager(params(1, 2, 3600.0))
    _cut(mgr, [0, 1])
    mgr.mark_draining(1, time.time() - 30.0)
    mgr.reap_dead_nodes(timeout_s=0.0)
    assert 1 not in mgr.alive_nodes and mgr.draining == {}
    # a re-join cancels the drain
    mgr = rdzv.ElasticTrainingRendezvousManager(params(1, 2))
    _cut(mgr, [0, 1])
    mgr.mark_draining(1, time.time() + 60.0)
    mgr.join_rendezvous(1, 1)
    assert mgr.draining == {}


def test_rendezvous_drain_answers_and_state_match_jax(monkeypatch):
    """One script through both managers on one clock: the same answers,
    the same draining set, donors without the draining rank, and each
    package's export restores into the other."""
    now = [1.7e9]
    monkeypatch.setattr(time, "time", lambda: now[0])
    managers = [m.ElasticTrainingRendezvousManager(
        m.RendezvousParameters(1, 3, wait_new_node_s=3600.0))
        for m in (jrdzv, trdzv)]
    answers = ([], [])
    for mgr, out in zip(managers, answers):
        _cut(mgr, [0, 1, 2])
        for rank in (0, 1, 2):
            mgr.register_peer_store(rank, f"h{rank}:7000", 3,
                                    ["model.w"], 8)
        out.append(mgr.mark_draining(2, now[0] + 60.0))
        out.append(mgr.compute_restore_plan(0))
        out.append(mgr.draining)
        out.append(mgr.num_nodes_waiting())
    exports = [mgr.export_state() for mgr in managers]
    assert answers[1] == answers[0]
    assert exports[1]["draining"] == exports[0]["draining"] == {
        "2": now[0] + 60.0}
    for key in exports[1]:
        assert exports[1][key] == exports[0][key], key
    for source in exports:
        for module in (jrdzv, trdzv):
            restored = module.ElasticTrainingRendezvousManager(
                module.RendezvousParameters(1, 3))
            restored.restore_state(source)
            assert restored.draining == {2: now[0] + 60.0}
            assert restored.alive_nodes == {0, 1, 2}
    now[0] += 70.0                              # the deadline blows
    for mgr in managers:
        mgr.reap_dead_nodes(timeout_s=0.0)
        assert mgr.alive_nodes == {0, 1} and mgr.draining == {}


def test_clean_drain_exit_is_not_a_failure(tmp_path, monkeypatch):
    """A worker leaving with the clean-drain code: the port's agent
    exits 0 without a failure report or a charge, and the master removes
    the rank."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.job_master import JobMaster

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    master = JobMaster(host="127.0.0.1")
    master.prepare()
    client = MasterClient(master.addr, node_id=0, node_rank=0)
    before = len([e for e in obs.get_flight_recorder().snapshot()
                  if e.get("name") == "worker_failed"])
    try:
        agent = tagent.ElasticAgent(client, tagent.WorkerSpec(
            entrypoint=[sys.executable, "-c", "raise SystemExit(76)"],
            monitor_interval_s=0.1, rdzv_timeout_s=30.0))
        assert agent.run() == 0
        assert agent._restart_count == 0
        events = obs.get_flight_recorder().snapshot()
        assert len([e for e in events
                    if e.get("name") == "worker_failed"]) == before
        drained = [e for e in events if e.get("name") == "worker_drained"]
        assert drained[-1]["attrs"]["exit_code"] == 76
        assert drained[-1]["attrs"]["clean"] is True
        assert 0 not in master.rdzv_managers["elastic-training"].alive_nodes
    finally:
        client.close()
        master.stop(grace_s=0.1)


def test_preemption_notice_drains_the_cli_worker(tmp_path):
    """The CLI on the CPU: a `preempt` fault at step 2 with a `slow` hold
    so the drain lands at that step's boundary (or a later one on a
    loaded host). The agent announces the drain, the worker saves the
    drained step under the deadline and exits 76, the agent concludes
    with the master and exits 0 uncharged; a second run resumes at the
    drained step and finishes."""
    log_file = tmp_path / "worker.log"

    def run(extra_env, steps):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   DLROVER_TPU_FLIGHT_DIR=str(tmp_path / "flight"),
                   **extra_env)
        return subprocess.run(
            [sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
             "--devices-per-node", "1", "--monitor-interval", "0.2",
             SCRIPT, "--config", "tiny", "--device", "cpu", "--steps",
             str(steps), "--save-interval", "5", "--ckpt-dir",
             str(tmp_path / "c"), "--log-file", str(log_file)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=240)

    first = run({"DLROVER_TPU_CHAOS": "preempt:worker:0@2:60;"
                                      "slow:worker:0@2:3",
                 "DLROVER_TPU_CHAOS_STATE": str(tmp_path / "chaos")}, 8)
    assert first.returncode == 0, first.stderr[-3000:]
    err = first.stderr
    assert "drain announced to the master" in err
    assert "node 0 drain COMPLETE (announced=True)" in err
    assert "drain complete (worker exit 76, drained)" in err
    assert "worker failed" not in err and "restarting" not in err
    text = log_file.read_text()
    step = int(text.split("drained at step ")[1].split()[0])
    assert 2 <= step < 5
    assert f"emergency checkpoint committed at step {step}" in text
    assert (f"drained at step {step} (checkpoint: saved); exiting 76"
            in text)
    assert sorted(os.listdir(tmp_path / "c")) == [str(step)]
    second = run({}, step + 2)
    assert second.returncode == 0, second.stderr[-3000:]
    text = log_file.read_text()
    assert f"llama_train: start_step={step} source=checkpoint" in text
    assert f"llama_train: done step={step + 2}" in text
