"""``python -m dlrover_tpu_torch.run --standalone`` on the CPU: the port's
master and agent around the worker script
``dlrover_tpu_torch/examples/llama_train.py`` at a tiny width (the JAX
package's kill demo, tests/test_examples.py, run by the port).

(a) 6 steps saving at 3 exit 0, and a second run resumes at step 6;
(b) the worker (the agent's child) is SIGKILLed once step 3 is committed
and a peer stage at least as new is complete (the gate chip_smoke.py
keeps on the card): the agent relaunches it, the new incarnation
restores from the host copy the first one staged in the agent's peer
cache (source ``peer``) at the newer of the committed and the staged
step, both read after the kill, and its steps are the same bits as an
uninterrupted in-process run;
(c) the failover drill of chip_smoke.py's ``failover`` phase at a tiny
width: a primary master process that SIGKILLs itself at step 4's report
(``kill:master:0@4``), a hot standby process that promotes, and an agent
that finds the master through the bootstrap file, reconnects with its
world intact and keeps the same worker, whose every step is the bits of
an uninterrupted run."""

import functools
import glob
import os
import signal
import subprocess
import sys
import time

import torch

from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
from dlrover_tpu_torch.trainer.elastic_loop import (
    ElasticTrainLoop,
    TrainLoopConfig,
)
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "dlrover_tpu_torch", "examples",
                      "llama_train.py")
sys.path.insert(0, os.path.dirname(SCRIPT))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
import llama_train  # noqa: E402


def _cli(extra, log_file, ckpt):
    return ([sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
             "--devices-per-node", "1", "--monitor-interval", "0.2",
             SCRIPT, "--config", "tiny", "--device", "cpu",
             "--save-interval", "3", "--ckpt-dir", ckpt,
             "--log-file", log_file] + extra)


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)


def _steps(log_file, sources=None):
    """{incarnation: {step: (loss, grad_norm)}} and the start steps, from
    the worker's log file (and each incarnation's restore source into
    ``sources``)."""
    runs, starts = [], []
    with open(log_file) as f:
        for line in f:
            words = line.split()
            if "llama_train: start_step=" in line:
                starts.append(int(line.split("start_step=")[1].split()[0]))
                if sources is not None:
                    sources.append(line.split("source=")[1].split()[0])
                runs.append({})
            elif len(words) > 6 and words[1] == "step" and words[3] == "loss":
                runs[-1][int(words[2])] = (float(words[4]), float(words[6]))
    return starts, runs


def test_standalone_trains_and_a_second_run_resumes(tmp_path):
    ckpt, log_file = str(tmp_path / "ckpt"), str(tmp_path / "run.log")
    for _ in range(2):
        proc = subprocess.run(_cli(["--steps", "6"], log_file, ckpt),
                              env=_env(), cwd=REPO, capture_output=True,
                              text=True, timeout=180)
        assert proc.returncode == 0, proc.stderr[-2000:]
    starts, runs = _steps(log_file)
    assert starts == [0, 6]
    assert sorted(runs[0]) == [1, 2, 3, 4, 5, 6] and runs[1] == {}
    assert sorted(os.listdir(ckpt)) == ["3", "6"]
    text = open(log_file).read()
    assert "done step=6" in text and "nothing to do" in text


def _uninterrupted(seq, global_batch, steps):
    """The worker script's run in this process, with no checkpoint."""
    cfg, seq = llama_train.build_config("tiny", seq)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loop = ElasticTrainLoop(
            functools.partial(Llama, cfg),
            lambda p: torch.optim.AdamW(p, lr=3e-4, betas=(0.9, 0.999),
                                        eps=1e-8, weight_decay=0.1),
            cross_entropy_loss,
            TrainLoopConfig(global_batch=global_batch, seq_len=seq,
                            max_micro_per_replica=global_batch,
                            max_steps=steps),
            device="cpu")
        sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)
        state, _ = loop.restore_or_init(0, sampler)
        state, metrics = loop.run(
            state, batches(synthetic_corpus(cfg.vocab_size), sampler,
                           global_batch, seq), sampler=sampler)
        loop.close()
    finally:
        torch.set_num_threads(threads)
    return {r["step"]: (r["loss"], r["grad_norm"])
            for r in metrics["history"]}


def _children(pid):
    out = subprocess.run(["pgrep", "-P", str(pid)], capture_output=True,
                         text=True)
    return [int(p) for p in out.stdout.split()]


def _wait_dead(pid, timeout_s=30.0):
    """Until ``pid`` has exited (gone, or a zombie its parent has not
    reaped yet)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return
        except OSError:
            return
        time.sleep(0.01)
    raise AssertionError(f"process {pid} still alive")


def test_killed_worker_is_relaunched_and_resumes_the_same_bits(tmp_path):
    ckpt, log_file = str(tmp_path / "ckpt"), str(tmp_path / "run.log")
    # the agent's work directory (peer cache, plan file) lands here
    agent_tmp = tmp_path / "agent"
    agent_tmp.mkdir()
    # steps of ≈0.2 s: step 6 commits long after the poll sees step 3
    size = ["--seq", "128", "--global-batch", "16"]
    proc = subprocess.Popen(
        _cli(["--steps", "7", "--report-interval", "1"] + size, log_file,
             ckpt), env=_env(TMPDIR=str(agent_tmp)), cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        victim = None
        while time.time() < deadline and proc.poll() is None:
            # step 3 committed and a stage at least as new complete, read
            # as the card's smoke reads them
            if chip_smoke._kill_ready(ckpt, str(agent_tmp), 3):
                kids = _children(proc.pid)
                if kids:
                    victim = kids[0]
                    break
            time.sleep(0.02)
        assert victim, "no committed and staged step 3, or no worker"
        os.kill(victim, signal.SIGKILL)
        _wait_dead(victim)
        # what the dead worker left: its committed steps and the step of
        # its last complete stage (the manifest is written last)
        committed, staged = chip_smoke._killed_state(ckpt, str(agent_tmp))
        _, err = proc.communicate(timeout=180)
        assert proc.returncode == 0, err[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "worker failed (exit -9, killed)" in err
    assert "spawning worker (round 1," in err
    sources = []
    starts, runs = _steps(log_file, sources)
    resumed = max(committed, staged)
    assert starts == [0, resumed] and resumed in (3, 6)
    assert sources == ["init", "peer"]
    want = _uninterrupted(128, 16, 7)
    assert {n: runs[0][n] for n in (1, 2, 3)} == {
        n: want[n] for n in (1, 2, 3)}
    assert runs[1] == {n: want[n] for n in range(resumed + 1, 8)}
    # the agent removed its work directory at exit
    assert not glob.glob(str(agent_tmp / "dlrover-tpu-agent-*"))


def test_worker_trains_through_a_killed_master(tmp_path):
    from dlrover_tpu_torch.common.config import Context

    knobs = {"rpc_backoff_s": 0.05, "standby_health_interval_s": 0.25,
             "standby_promote_failures": 2}
    Context.reset()
    Context.singleton().update(**knobs)
    try:
        budget = chip_smoke.failover_budget(0.2, 0.5, kill_at=4)
    finally:
        Context.reset()
    agent_tmp = tmp_path / "agent"
    agent_tmp.mkdir()
    env = {f"DLROVER_TPU_{k.upper()}": str(v) for k, v in knobs.items()}
    env.update(TMPDIR=str(agent_tmp), OMP_NUM_THREADS="1",
               DLROVER_TPU_RPC_TIMEOUT_S="0.5",
               DLROVER_TPU_MASTER_SNAPSHOT_RETAIN="1000",
               DLROVER_TPU_TSDB_SAMPLE_INTERVAL_S="0.2",
               DLROVER_TPU_TSDB_FLUSH_INTERVAL_S="0.5",
               DLROVER_TPU_FLIGHT_DIR=str(tmp_path / "flight"))
    out = chip_smoke.failover_drill(
        str(tmp_path), REPO,
        ["--config", "tiny", "--device", "cpu", "--save-interval", "3",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        budget["steps"], 4, 0.2, env, timeout_s=150,
        # steps of 0.2 s: the sidecar (flushed every 0.5 s) holds the
        # first step reports before the kill
        worker_chaos="slow:worker:0@1:0.2")
    want = _uninterrupted(16, 8, budget["steps"])
    got = {n: (r[1], r[2]) for n, r in out["run"]["steps"].items()}
    assert got == want
    assert out["snapshot"]["promoted_generation"] == 2
    # the worker dials the dead primary to the end, as the JAX loop does
    reports = out["step_reports"]
    assert reports["reached_promoted_master"] == 0, reports
    assert 0 < out["marks"]["kill_to_promoted_s"] < 15
