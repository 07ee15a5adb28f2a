"""The port's agent monitors and worker-side card telemetry against the
JAX package's (``agent/monitor.py``, ``obs/device.py``), and the port's
``torch.profiler`` session (``obs/profiler.py``) on the CPU.

- ``export_chip_stats`` and ``DeviceTelemetry``, driven by one fake
  allocator sequence (the JAX side through a fake ``jax.local_devices``,
  the port's through a fake sampler), write the same files and drain the
  same windowed peaks under one fake clock.
- ``ResourceMonitor`` relays the same card stats from the file;
  ``HangingDetector``, ``report_step`` and ``ParalConfigTuner`` agree.
- A ``ProfilerSession`` capture of a tiny model writes ``status: "ok"``
  and a Chrome trace, skips a rewritten request with a served id, and a
  respawned session does not replay it.
"""

import json
import os
import time

import jax
import pytest
import torch

from dlrover_tpu.agent import monitor as jmonitor
from dlrover_tpu.common import messages as J
from dlrover_tpu.obs import device as jdevice
from dlrover_tpu_torch import obs
from dlrover_tpu_torch.agent import monitor as tmonitor
from dlrover_tpu_torch.common import messages as T
from dlrover_tpu_torch.obs import device as tdevice
from dlrover_tpu_torch.obs import profiler as tprofiler

MB = 1 << 20
T0 = 1.7e9


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tiny models run on one thread, so parallel test workers do
    not oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# allocator readings after each step: (bytes_in_use, peak), limit 80 GB;
# rises, a flat stretch, noise under the 1 MiB threshold
READINGS = [(19e9, 49e9), (19e9, 49e9), (19.5e9, 49e9 + 512 * 1024),
            (20e9, 52e9), (20e9, 52e9), (18e9, 52e9),
            (18e9, 52e9), (18.2e9, 53e9), (18e9, 53e9)]
LIMIT = 85017493504.0


class _FakeDevice:
    def __init__(self, stats):
        self.id = 0
        self._stats = stats

    def memory_stats(self):
        return dict(self._stats)


def _jax_stats(in_use, peak):
    return {"bytes_in_use": in_use, "peak_bytes_in_use": peak,
            "bytes_limit": LIMIT}


def test_export_chip_stats_matches_jax(tmp_path, monkeypatch):
    clock = [T0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    files = {"jax": str(tmp_path / "jax.json"),
             "port": str(tmp_path / "port.json")}
    outputs = {"jax": [], "port": []}
    step = 0
    for in_use, peak in READINGS:
        step += 3
        clock[0] += 1.2
        monkeypatch.setattr(jax, "local_devices", lambda: [
            _FakeDevice(_jax_stats(in_use, peak))])
        jmonitor.export_chip_stats(files["jax"], step=step,
                                   step_time_s=0.36)
        tmonitor.export_chip_stats(
            files["port"], step=step, step_time_s=0.36,
            sampler=lambda: [{"id": 0, **_jax_stats(in_use, peak)}])
        for name, path in files.items():
            with open(path) as f:
                outputs[name].append(json.load(f))
    assert outputs["port"] == outputs["jax"]
    # the first export has no duty cycle; a peak rides only on a rise
    assert "duty_cycle_pct" not in outputs["port"][0][0]
    assert [("hbm_peak_mb" in o[0]) for o in outputs["port"]] == [
        True, False, False, True, False, False, False, True, False]
    # a process that never used a card exports no memory fields
    tmonitor.export_chip_stats(str(tmp_path / "cpu.json"),
                               sampler=lambda: [{"id": 0}])
    with open(tmp_path / "cpu.json") as f:
        assert json.load(f) == [{"index": 0}]


def test_device_telemetry_windows_like_jax():
    """The same readings through both trackers, drained every two
    steps: the same windowed peaks, rise steps and lifetime watermark."""
    def run(cls, shape):
        readings = iter(READINGS)
        current = {}

        def sampler():
            return [shape(*current["r"])] if current["r"] else None

        tracker = cls(sampler=sampler)
        out = []
        step = 0
        for reading in readings:
            step += 1
            current["r"] = reading
            tracker.on_step(step)
            if step % 2 == 0:
                out.append(tracker.drain())
        out.append((tracker.available, tracker.peak_mb()))
        return out

    jax_out = run(jdevice.DeviceTelemetry,
                  lambda u, p: {"index": 0.0, "bytes_in_use": u,
                                "peak_bytes_in_use": p,
                                "bytes_limit": LIMIT})
    port_out = run(tdevice.DeviceTelemetry,
                   lambda u, p: {"index": 0.0, "bytes_in_use": u,
                                 "peak_bytes_in_use": p,
                                 "bytes_limit": LIMIT})
    assert port_out == jax_out
    assert port_out[-1] == (True, 53e9 / MB)
    # the CPU: one probe, then a no-op; no device truth in the report
    cpu = tdevice.DeviceTelemetry(tdevice.allocator_sampler("cpu"))
    cpu.on_step(1)
    cpu.on_step(2)
    assert cpu.available is False
    assert cpu.drain()["hbm_peak_bytes"] == 0.0


class _Client:
    node_id = 3
    node_rank = 1

    def __init__(self):
        self.steps = []
        self.configs = []

    def report_global_step(self, step, **kwargs):
        self.steps.append((step, kwargs))
        return True

    def get_paral_config(self):
        return self.configs.pop(0)


def test_resource_monitor_relays_the_worker_file(tmp_path):
    path = str(tmp_path / "chips.json")
    tmonitor.export_chip_stats(
        path, sampler=lambda: [{"id": 0, **_jax_stats(19e9, 50e9)}])
    port = tmonitor.ResourceMonitor(_Client(), chip_stats_file=path,
                                    interval_s=60.0).sample()
    jax_stats = jmonitor.ResourceMonitor(_Client(), chip_stats_file=path,
                                         interval_s=60.0).sample()
    assert [T.serialize_message(c) for c in port.chip_stats] == [
        J.serialize_message(c) for c in jax_stats.chip_stats]
    assert port.chip_stats[0].hbm_total_mb == LIMIT / MB
    assert (port.node_id, port.node_rank) == (3, 1)
    # before the worker exports anything there are no card stats
    assert tmonitor.ResourceMonitor(
        _Client(), chip_stats_file=str(tmp_path / "absent"),
        interval_s=60.0).sample().chip_stats == []


def test_hang_detector_step_file_and_tuner_match_jax(tmp_path,
                                                      monkeypatch):
    clock = [T0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    metrics = {m: str(tmp_path / f"{m}.jsonl") for m in ("jax", "port")}
    detectors = {
        "jax": jmonitor.HangingDetector(metrics["jax"], on_hang=lambda: 0,
                                        hang_seconds=30.0, warmup_s=100.0),
        "port": tmonitor.HangingDetector(metrics["port"],
                                         on_hang=lambda: 0,
                                         hang_seconds=30.0, warmup_s=100.0,
                                         clock=lambda: clock[0])}
    trace = {"jax": [], "port": []}
    for advance, step in [(50, None), (60, None), (1, 1), (20, 2),
                          (31, None), (5, 3), (29, None), (2, None)]:
        clock[0] += advance
        if step is not None:
            jmonitor.report_step(step, metrics["jax"], step_time_s=0.4,
                                 data_wait_fraction=0.01)
            tmonitor.report_step(step, metrics["port"], step_time_s=0.4,
                                 data_wait_fraction=0.01)
        for name, detector in detectors.items():
            trace[name].append(detector.is_hanged())
        if advance == 31:
            for detector in detectors.values():
                detector.reset()
    assert trace["port"] == trace["jax"]
    assert trace["port"] == [False, True, False, False, True, False,
                             False, True]
    with open(metrics["port"]) as f, open(metrics["jax"]) as g:
        assert f.read() == g.read()

    # the tuner writes each new config version once
    outs = {}
    for name, module, messages in (("jax", jmonitor, J),
                                   ("port", tmonitor, T)):
        client = _Client()
        client.configs = [messages.ParallelConfig(version=1,
                                                  dataloader_batch_size=8),
                          messages.ParallelConfig(version=1),
                          messages.ParallelConfig(version=2,
                                                  learning_rate=1e-4)]
        path = str(tmp_path / f"{name}-paral.json")
        tuner = module.ParalConfigTuner(client, path, interval_s=60.0)
        polled = [tuner.poll_once() for _ in range(3)]
        with open(path) as f:
            outs[name] = (polled, json.load(f))
    assert outs["port"] == outs["jax"]


def _tiny_steps(model, opt, n):
    for _ in range(n):
        loss = model(torch.randn(4, 16)).square().mean()
        loss.backward()
        opt.step()
        opt.zero_grad()


def test_profiler_session_captures_on_the_cpu(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                                torch.nn.Linear(32, 4))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    request = str(tmp_path / "request.json")
    dump = str(tmp_path / "profiles")
    session = tprofiler.ProfilerSession(request_path=request)
    session.poll(0)                      # no request: nothing happens
    assert not session.active
    tprofiler.write_profile_request(request, 1, 2, dump)
    for step in range(1, 6):
        session.poll(step)
        _tiny_steps(model, opt, 1)
    assert not session.active
    done = tprofiler.read_profile_result(request)
    assert done["status"] == "ok" and done["id"] == 1
    assert (done["start_step"], done["num_steps"]) == (1, 2)
    trace = os.path.join(done["trace_dir"], tprofiler.TRACE_NAME)
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any("addmm" in str(n) for n in names)
    assert done["trace_bytes"] == os.path.getsize(trace)
    with open(os.path.join(done["trace_dir"], "manifest.json")) as f:
        assert json.load(f) == done
    # the agent rewrites the request with the same id: a replay, skipped
    tprofiler.write_profile_request(request, 1, 2, dump)
    session.poll(6)
    assert not session.active
    # a respawned worker seeds its watermark from the served manifest
    respawned = tprofiler.ProfilerSession(request_path=request)
    respawned.poll(0)
    assert not respawned.active
    # a new id is served, and stop() flushes it mid-capture
    tprofiler.write_profile_request(request, 2, 5, dump)
    respawned.poll(1)
    assert respawned.active
    _tiny_steps(model, opt, 1)
    respawned.stop()
    assert tprofiler.read_profile_result(request)["id"] == 2
    assert len(os.listdir(dump)) == 2


def test_profiler_static_window_and_unwritable_dir(tmp_path):
    static = tmp_path / "static"
    session = tprofiler.ProfilerSession(static_dir=str(static),
                                        static_start=1, static_num=1)
    for step in range(4):
        session.poll(step)
    (capture,) = os.listdir(static)
    with open(static / capture / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["status"] == "ok" and manifest["id"] == 0
    blocked = tmp_path / "file"
    blocked.write_text("x")
    capture = tprofiler.ProfilerCapture(str(blocked), 1)
    assert not capture.start()
    assert capture.stop()["status"].startswith("error: mkdir failed")


@pytest.mark.parametrize("kind", ["profile", "checkpoint", "drain",
                                  "restart", "alert", "observe"])
def test_agent_executes_each_action(tmp_path, monkeypatch, kind):
    """The agent's action executor writes the profile request or the
    drain request (save-and-continue for ``checkpoint``, save-and-exit
    for ``drain``), restarts uncharged, or logs."""
    from dlrover_tpu_torch.agent import elastic_agent as ea
    from dlrover_tpu_torch.agent.preemption import DrainRequestSource

    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    agent = ea.ElasticAgent(_Client(), ea.WorkerSpec(entrypoint=["true"]))
    restarts = []
    monkeypatch.setattr(agent, "_restart_worker",
                        lambda count_against_budget: restarts.append(
                            count_against_budget))
    agent._execute_diagnosis_action({"id": 4, "kind": kind, "rank": 1,
                                     "reason": "r", "num_steps": 3,
                                     "deadline": T0 + 99.0})
    request = tprofiler.read_profile_result(agent.profile_request_file)
    assert request is None
    if kind == "profile":
        with open(agent.profile_request_file) as f:
            assert json.load(f) == {"id": 1, "num_steps": 3,
                                    "dump_dir": agent.profile_dump_dir}
    elif kind in ("checkpoint", "drain"):
        monkeypatch.setenv("DLROVER_TPU_DRAIN_REQUEST",
                           agent.drain_request_file)
        drain = DrainRequestSource().poll()
        assert drain["exit"] is (kind == "drain")
        assert drain["deadline"] == T0 + 99.0
    else:
        assert not os.path.exists(agent.drain_request_file)
    assert restarts == ([False] if kind == "restart" else [])
    agent._remove_workdir()
    obs.remove_span_sink(agent._span_exporter)


def test_agent_keeps_the_newest_captures(tmp_path, monkeypatch):
    """Captures live apart from the agent's work dir: a new request
    removes all but the newest ``PROFILE_CAPTURES_KEPT`` - 1, and the
    directory outlives the agent only when it holds a capture."""
    from dlrover_tpu_torch.agent import elastic_agent as ea

    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    agents = [ea.ElasticAgent(_Client(), ea.WorkerSpec(entrypoint=["true"]))
              for _ in range(2)]
    agent, idle = agents
    dump = agent.profile_dump_dir
    assert os.path.dirname(dump) != agent._workdir
    for i in range(6):
        os.makedirs(os.path.join(dump, f"capture-{i}-0"))
        os.utime(os.path.join(dump, f"capture-{i}-0"), (T0 + i, T0 + i))
    agent._execute_diagnosis_action({"id": 1, "kind": "profile",
                                     "rank": 0, "num_steps": 2})
    kept = ea.PROFILE_CAPTURES_KEPT - 1
    assert sorted(os.listdir(dump)) == [f"capture-{i}-0"
                                        for i in range(6 - kept, 6)]
    for a in agents:
        a._remove_workdir()
        obs.remove_span_sink(a._span_exporter)
        assert not os.path.exists(a._workdir)
    assert os.path.isdir(dump)
    assert not os.path.exists(idle.profile_dump_dir)


class _LoopClient:
    """The MasterClient surface the loop calls, recording what it sent;
    the master's clock runs 5 s ahead of this host's."""

    def __init__(self):
        self.steps, self.traces, self.probes = [], [], 0

    def probe_clock(self):
        self.probes += 1
        return time.time() + 5.0

    def report_model_info(self, **kwargs):
        return True

    def report_global_step(self, step, **kwargs):
        self.steps.append((step, kwargs))
        return True

    def report_telemetry(self, samples=None, spans=None, steptrace=None):
        self.traces.extend(steptrace or ())
        return True

    def get_shard_checkpoint(self, name):
        return ""


class _SlowReportClient(_LoopClient):
    """A master whose step report takes ``REPORT_S`` to answer."""

    REPORT_S = 0.05

    def report_global_step(self, step, **kwargs):
        time.sleep(self.REPORT_S)
        return super().report_global_step(step, **kwargs)


def _run_tiny_loop(tmp_path, monkeypatch, client=None, **config):
    """A tiny Llama loop on the CPU reporting to ``client`` (a new
    ``_LoopClient`` by default): the client and the run's history."""
    import functools

    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        cross_entropy_loss,
    )
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )
    from dlrover_tpu_torch.trainer.sampler import (
        ElasticDistributedSampler,
    )
    from dlrover_tpu_torch.trainer.synthetic import (
        batches,
        synthetic_corpus,
    )

    monkeypatch.setenv(NodeEnv.CHIP_STATS_FILE, str(tmp_path / "chips"))
    monkeypatch.setenv(NodeEnv.NODE_RANK, "0")
    cfg = LlamaConfig.tiny(embed_impl="gather")
    client = client if client is not None else _LoopClient()
    loop = ElasticTrainLoop(
        functools.partial(Llama, cfg),
        lambda p: torch.optim.AdamW(p, lr=1e-3), cross_entropy_loss,
        TrainLoopConfig(global_batch=2, seq_len=16, max_steps=4,
                        report_interval_steps=1, **config),
        master_client=client, device="cpu")
    sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)
    state, _ = loop.restore_or_init(0, sampler)
    data = batches(synthetic_corpus(cfg.vocab_size), sampler, 2, 16)
    state, metrics = loop.run(state, data, sampler=sampler)
    loop.close()
    return client, metrics["history"]


def test_loop_reports_traces_and_profiles_a_static_window(tmp_path,
                                                          monkeypatch):
    """A tiny Llama loop on the CPU with a master client, a card-stats
    file and a static profiler window of step 2: a step report a step
    (no device truth off the card: ``hbm_peak_bytes`` 0), one trace
    record a step with the clock offset the probe measured, the phases
    from the batch's arrival, a capture of that one step, and a card
    stats file with no memory fields."""
    client, history = _run_tiny_loop(
        tmp_path, monkeypatch, profile_dir=str(tmp_path / "static"),
        profile_start_step=1, profile_num_steps=1)
    assert client.probes == 1
    assert [s for s, _ in client.steps] == [1, 2, 3, 4]
    assert all(kw["hbm_peak_bytes"] == 0.0 for _, kw in client.steps)
    assert [r["step"] for r in client.traces] == [1, 2, 3, 4]
    for rec, hist in zip(client.traces, history):
        assert rec["rank"] == 0 and 4.9 < rec["off"] < 5.1
        names = [p[0] for p in rec["phases"]]
        assert names == ["data_wait", "h2d", "compute", "host_sync"]
        after_batch = sum(p[2] for p in rec["phases"][1:])
        assert after_batch >= hist["step_time_s"]
    (capture,) = os.listdir(tmp_path / "static")
    with open(tmp_path / "static" / capture / "manifest.json") as f:
        manifest = json.load(f)
    assert (manifest["status"], manifest["start_step"]) == ("ok", 1)
    with open(tmp_path / "chips") as f:
        assert json.load(f) == []


def test_loop_traces_a_checkpointing_step_by_its_own_marks(tmp_path,
                                                           monkeypatch):
    """With a checkpointer the trace still starts its compute phase at
    the batch's arrival, and its ``checkpoint`` phase is the save's own
    time, after the compute and the boundary's host work."""
    client, history = _run_tiny_loop(
        tmp_path, monkeypatch, checkpoint_dir=str(tmp_path / "ckpt"),
        save_interval_steps=2)
    assert [r["step"] for r in client.traces] == [1, 2, 3, 4]
    for rec, hist in zip(client.traces, history):
        phases = {name: (start, dur) for name, start, dur in rec["phases"]}
        after_batch = phases["h2d"][1] + phases["compute"][1]
        assert after_batch >= hist["step_time_s"]
        start, dur = phases["checkpoint"]
        assert dur == pytest.approx(hist["checkpoint_s"], abs=1e-6)
        assert start == pytest.approx(sum(
            phases[n][1] for n in ("data_wait", "h2d", "compute",
                                   "host_sync")),
            abs=1e-5)
    assert [h["step"] for h in history if "checkpoint_wait_s" in h] == [2, 4]


def test_loop_traces_a_slow_step_report_as_host_sync(tmp_path, monkeypatch):
    """A step report that waits on a busy master is traced: the record's
    ``host_sync`` phase starts where the compute ends and lasts at least
    the report's wait, and no step's phases run past the next step's
    start."""
    client, _ = _run_tiny_loop(tmp_path, monkeypatch,
                               client=_SlowReportClient())
    assert [r["step"] for r in client.traces] == [1, 2, 3, 4]
    for rec, nxt in zip(client.traces, client.traces[1:] + [None]):
        names = [p[0] for p in rec["phases"]]
        assert names == ["data_wait", "h2d", "compute", "host_sync"]
        phases = {name: (start, dur) for name, start, dur in rec["phases"]}
        start, dur = phases["host_sync"]
        assert start == pytest.approx(sum(phases["compute"]), abs=1e-5)
        assert dur >= _SlowReportClient.REPORT_S
        if nxt is not None:
            assert nxt["t0"] - rec["t0"] >= start + dur - 1e-3
