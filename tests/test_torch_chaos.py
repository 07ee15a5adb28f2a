"""The port's chaos injection (``dlrover_tpu_torch/diagnostics/chaos.py``)
against the JAX package's: ``parse_chaos`` on a table of specs, the
worker injector's sleeps, one-shot markers (the same files, so either
package honours the other's) and preemption notices, the faults the port
refuses by ROADMAP item, and one chaos hang through the port's CLI: the
step-hang watchdog aborts the worker, the agent classifies the abort as
a hang, relaunches it without charging the restart budget, and the
relaunch (replaying the hang inside its first-step budget) finishes."""

import glob
import json
import os
import subprocess
import sys
import time

import pytest

from dlrover_tpu.diagnostics import chaos as jchaos
from dlrover_tpu_torch.diagnostics import chaos as tchaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "dlrover_tpu_torch", "examples",
                      "llama_train.py")

SPECS = [
    "kill:worker:0@5",
    "kill:worker:0@5;hang:worker:1@3:120;slow:ps:2@4:0.5",
    "preempt:worker:1@4:20;hang:worker:0@3",
    "preempt:worker:0@2",
    " hang:worker:0@2:1 ; hang:worker:0@2:1 ;",
    "kill:master:0@7",
    "kill:shard:1@5;hang:shard:1@5:3",
    "kill:slice:0@5;preempt:slice:1@4:20",
    "resize:-2@10;resize:+2@10;resize:slice:-1@10",
    "offer:slice:+1@10:300;offer:slice:2@3;revoke:slice:1@10:20",
    "revoke:slice:0@4",
    "",
]

BAD_SPECS = [
    "kill:worker@5", "explode:worker:0@5", "kill:worker:-1@5",
    "resize:0@4", "resize:pod:-1@4", "offer:worker:1@3",
    "offer:slice:0@3", "revoke:worker:1@4", "kill:worker:x@5",
    "hang:worker:0@2:abc",
]


def _fields(faults):
    return [vars(f) for f in faults]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_chaos_matches_jax(spec):
    assert _fields(tchaos.parse_chaos(spec)) == _fields(
        jchaos.parse_chaos(spec))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_fail_loudly_alike(spec):
    with pytest.raises(ValueError) as want:
        jchaos.parse_chaos(spec)
    with pytest.raises(ValueError) as got:
        tchaos.parse_chaos(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,item", [
    ("hang:shard:1@5:3", "12.2"),
    ("kill:slice:0@5", "6.4"),
    ("resize:slice:-1@4", "6.4"),
    ("preempt:slice:1@4:20", "6.4"),
    ("hang:slice:0@3:2", "6.4"),
    ("kill:master:0@7;kill:shard:0@5", "12.2"),
])
def test_unported_faults_parse_then_refuse_by_item(spec, item):
    """The ``shard`` role (12.2) is refused by its item; the ``slice``
    faults (6.4, slice mode, now ported) arm as the JAX injector arms
    them: on the addressed slice's workers."""
    assert tchaos.parse_chaos(spec)
    for role in ("worker", "master"):
        if item == "12.2":
            with pytest.raises(NotImplementedError,
                               match=item.replace(".", r"\.")):
                tchaos.ChaosInjector(role=role, rank=0, spec=spec)
            continue
        for slice_id in (-1, 0, 1):
            port = tchaos.ChaosInjector(role=role, rank=0, spec=spec,
                                        slice_id=slice_id)
            jax = jchaos.ChaosInjector(role=role, rank=0, spec=spec,
                                       slice_id=slice_id)
            assert _fields(port.faults) == _fields(jax.faults)


@pytest.mark.parametrize("spec", [
    "kill:master:0@7", "kill:worker:0@5;kill:master:0@7",
    "hang:master:0@3:2;slow:worker:1@2:0.5"])
def test_master_faults_arm_on_the_master_and_are_skipped_by_workers(spec):
    """A ``master`` fault arms on the master's injector only, and every
    worker injector skips it, as the JAX injectors do."""
    for role, rank in (("master", 0), ("worker", 0), ("worker", 1)):
        port = tchaos.ChaosInjector(role=role, rank=rank, spec=spec)
        jax = jchaos.ChaosInjector(role=role, rank=rank, spec=spec,
                                   slice_id=-1)
        assert _fields(port.faults) == _fields(jax.faults), (role, rank)
        assert all(f.role == role and f.rank == rank for f in port.faults)
    master = tchaos.ChaosInjector(role="master", rank=0, spec=spec)
    assert [f.role for f in master.faults] == ["master"]


def test_master_kill_fires_once_at_its_step(tmp_path, monkeypatch):
    """``kill:master:0@7`` SIGKILLs the master process at the first step
    report at or past 7, after claiming its one-shot marker, so a
    restarted master over the same state does not kill itself again."""
    monkeypatch.setenv(tchaos.CHAOS_STATE_ENV, str(tmp_path))
    kills = []
    monkeypatch.setattr(tchaos.os, "kill",
                        lambda pid, sig: kills.append((pid, sig)))
    inj = tchaos.ChaosInjector(role="master", rank=0,
                               spec="kill:master:0@7")
    for step in (5, 6, 8, 9):
        inj.maybe_inject(step)
    assert kills == [(tchaos.os.getpid(), tchaos.signal.SIGKILL)]
    again = tchaos.ChaosInjector(role="master", rank=0,
                                 spec="kill:master:0@7")
    again.maybe_inject(10)
    assert len(kills) == 1


def _injectors(monkeypatch, spec, rank=0):
    sleeps = []
    monkeypatch.setattr(jchaos.time, "sleep", sleeps.append)
    return (jchaos.ChaosInjector(role="worker", rank=rank, spec=spec,
                                 slice_id=-1),
            tchaos.ChaosInjector(role="worker", rank=rank, spec=spec),
            sleeps)


def test_injector_sleeps_match_jax(monkeypatch):
    spec = "hang:worker:0@2:5.0;slow:worker:0@3:0.5;hang:worker:1@2:9"
    trace = []
    for which in (0, 1):
        jinj, tinj, sleeps = _injectors(monkeypatch, spec)
        inj = (jinj, tinj)[which]
        assert [f.action for f in inj.faults] == ["hang", "slow"]
        for step in (1, 2, 2, 3, 4):
            inj.maybe_inject(step)
        trace.append(sleeps)
    assert trace[1] == trace[0] == [5.0, 0.5, 0.5]


def test_markers_are_shared_with_the_jax_injector(tmp_path, monkeypatch):
    """A one-shot fault fired by either package is consumed for the
    other (one marker file name), a hang's marker lands only after the
    sleep, and a claimed kill marker stops the kill."""
    monkeypatch.setenv(tchaos.CHAOS_STATE_ENV, str(tmp_path))
    spec = "hang:worker:0@1:0.01"

    def no_marker_yet(duration):
        assert not list(tmp_path.iterdir()), "marker before the sleep"

    monkeypatch.setattr(tchaos.time, "sleep", no_marker_yet)
    tinj = tchaos.ChaosInjector(role="worker", rank=0, spec=spec)
    tinj.maybe_inject(1)
    assert [p.name for p in tmp_path.iterdir()] == [
        "chaos_0_hang_worker_0_1"]
    jinj = jchaos.ChaosInjector(role="worker", rank=0, spec=spec,
                                slice_id=-1)
    assert all(f.fired for f in jinj.faults)
    (tmp_path / "chaos_0_kill_worker_0_1").write_text("other-pid")

    def boom(*args):
        raise AssertionError("kill fired despite a claimed marker")

    monkeypatch.setattr(tchaos.os, "kill", boom)
    kill = tchaos.ChaosInjector(role="worker", rank=0,
                                spec="kill:worker:0@1")
    assert kill.faults[0].fired
    kill.maybe_inject(1)


def test_preempt_writes_the_notice_once_as_jax(tmp_path, monkeypatch):
    payloads = []
    for module in (jchaos, tchaos):
        path = tmp_path / f"notice-{module.__name__}.json"
        monkeypatch.setenv("DLROVER_TPU_PREEMPTION_NOTICE", str(path))
        kw = {"slice_id": -1} if module is jchaos else {}
        inj = module.ChaosInjector(role="worker", rank=0,
                                   spec="preempt:worker:0@3:7", **kw)
        inj.maybe_inject(2)
        assert not path.exists()
        t0 = time.time()
        inj.maybe_inject(3)
        payload = json.loads(path.read_text())
        assert 0 < payload.pop("deadline") - t0 <= 7.5
        payloads.append(payload)
        path.unlink()
        inj.maybe_inject(4)
        assert not path.exists()
    assert payloads[1] == payloads[0] == {"grace_s": 7.0,
                                          "reason": "chaos preempt@3"}


def test_chaos_hang_aborted_by_the_watchdog_and_relaunched(tmp_path):
    """The CLI on the CPU: a hang at step 4 after the step-3 save, the
    watchdog at 3 s. The first incarnation's flight dump holds the main
    thread in the chaos sleep; the agent logs one hang abort and
    restarts without a charge; the relaunch resumes at 3 (from the peer
    stage), replays the hang within its first-step budget and finishes
    step 5; the agent exits 0."""
    log_file, flight = tmp_path / "worker.log", tmp_path / "flight"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               DLROVER_TPU_CHAOS="hang:worker:0@4:8",
               DLROVER_TPU_CHAOS_STATE=str(tmp_path / "chaos"),
               DLROVER_TPU_HANG_WATCHDOG_S="3",
               DLROVER_TPU_FLIGHT_DIR=str(flight))
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
         "--devices-per-node", "1", "--monitor-interval", "0.2", SCRIPT,
         "--config", "tiny", "--device", "cpu", "--steps", "5",
         "--save-interval", "3", "--ckpt-dir", str(tmp_path / "c"),
         "--log-file", str(log_file)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stderr.count("worker failed (exit -6, hang)") == 2
    assert "restarting (0/3)" in proc.stderr
    text = log_file.read_text()
    starts = [line.split("start_step=")[1].split()[0]
              for line in text.splitlines() if "start_step=" in line]
    assert starts == ["0", "3"]
    assert "source=peer" in text.split("start_step=3")[1].split("\n")[0]
    assert "llama_train: done step=5" in text
    hangs = []
    for path in glob.glob(str(flight / "flight-*.json")):
        with open(path) as f:
            hangs += [e["attrs"] for e in json.load(f)["events"]
                      if e.get("name") == "step_hang"]
    assert len(hangs) == 1 and hangs[0]["step"] == 3
    assert any("maybe_inject" in frame and "time.sleep" in frame
               for frame in hangs[0]["stacks"]["MainThread"])
