"""The port's ElasticTrainLoop with checkpoint-resume across a world
resize, against the JAX package's (tests/test_elastic_loop.py).

Train 3 steps at 4 ranks (data 2 × tensor 2), stop, resume at 2 ranks
(data 2) with the same global batch and data position for 2 more steps:
the port's gloo ranks start from the JAX loop's own init (carried
across) and see the JAX test's batches, and each phase's last loss must
be within 1e-4 of the JAX run's. A stop request forces a save, and a
worker process that receives SIGTERM saves the step it stopped on and a
second one resumes there. A drain request during step 3 drains both
packages' loops through an emergency checkpoint at step 3, and their
resumed losses agree within 1e-4.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dlrover_tpu.trainer import elastic_loop as jloop
from dlrover_tpu.trainer.sampler import ElasticDistributedSampler as JSampler
from dlrover_tpu_torch import convert
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.trainer.elastic_loop import ElasticTrainLoop, TrainLoopConfig
from test_torch_mesh import REPO, run_workers


def _batches(vocab, global_batch, seq, count, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        tokens = rng.integers(0, vocab, (global_batch, seq), dtype=np.int32)
        yield tokens, tokens  # autoregressive dummy, as the JAX test


def _jax_phases(cpu_devices, tmp_path):
    """The JAX test's two phases in f32: (init params, phase-1 last loss,
    phase-2 last loss, phase-2 start)."""
    cfg = jllama.LlamaConfig.tiny(attn_impl="reference", dtype=jnp.float32)

    def make(n, max_steps, **spec):
        return jloop.ElasticTrainLoop(
            jllama.Llama(cfg), optax.adamw(1e-3), jllama.cross_entropy_loss,
            jloop.TrainLoopConfig(
                global_batch=8, seq_len=16, max_micro_per_replica=4,
                max_steps=max_steps, checkpoint_dir=str(tmp_path / "jax"),
                save_interval_steps=1, mesh_spec=JMeshSpec(**spec)),
            devices=cpu_devices[:n])

    loop = make(4, 3, tensor=2)
    sampler = JSampler(1024, shuffle=False)
    state, _ = loop.restore_or_init(jax.random.PRNGKey(0), sampler)
    init = jax.tree.map(np.asarray, state.params)
    state, metrics = loop.run(state, _batches(cfg.vocab_size, 8, 16, 10),
                              start_step=0, sampler=sampler)
    loop.close()
    loop2 = make(2, 2)
    sampler2 = JSampler(1024, shuffle=False)
    state2, start2 = loop2.restore_or_init(jax.random.PRNGKey(1), sampler2)
    state2, metrics2 = loop2.run(state2, _batches(cfg.vocab_size, 8, 16, 10,
                                                  seed=1),
                                 start_step=start2, sampler=sampler2)
    loop2.close()
    return init, metrics["loss"], metrics2["loss"], start2


RESIZE_WORKER = """
import json, sys
import numpy as np
import torch
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.parallel.mesh import MeshSpec
from dlrover_tpu_torch.trainer.elastic_loop import ElasticTrainLoop, TrainLoopConfig
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

torch.set_num_threads(1)
init_distributed("cpu")
ckpt, init_path, tensor, steps, seed = (sys.argv[1], sys.argv[2],
                                        int(sys.argv[3]), int(sys.argv[4]),
                                        int(sys.argv[5]))
init = {k: torch.from_numpy(v) for k, v in np.load(init_path).items()}
cfg = LlamaConfig.tiny(attn_impl="flash", dtype=torch.float32)

def model(device, seed):
    m = Llama(cfg, device=device, seed=seed)
    if torch.device(device).type != "meta":
        m.load_state_dict(init)
    return m

loop = ElasticTrainLoop(
    model, lambda p: torch.optim.AdamW(p, lr=1e-3, weight_decay=1e-4),
    cross_entropy_loss,
    TrainLoopConfig(global_batch=8, seq_len=16, max_micro_per_replica=4,
                    max_steps=steps, checkpoint_dir=ckpt,
                    save_interval_steps=1,
                    mesh_spec=MeshSpec(tensor=tensor)), device="cpu")
sampler = ElasticDistributedSampler(1024, shuffle=False)
state, start = loop.restore_or_init(0, sampler)
position = sampler.completed_num
rng = np.random.default_rng(seed)

def batches():
    for _ in range(10):
        tokens = rng.integers(0, cfg.vocab_size, (8, 16), dtype=np.int32)
        yield tokens, tokens

state, metrics = loop.run(state, batches(), start_step=start,
                          sampler=sampler)
print(json.dumps({
    "start": start, "position": position, "dp": loop.dp,
    "source": loop.last_restore_source,
    "timings": sorted(loop.last_restore_timings),
    "losses": [r["loss"] for r in metrics["history"]],
    "step": metrics["step"], "completed": sampler.completed_num,
    "latest": loop.checkpointer.latest_step()}))
loop.close()
"""


def test_train_checkpoint_resume_resized_world(cpu_devices, tmp_path):
    init, loss1, loss2, jstart2 = _jax_phases(cpu_devices, tmp_path)
    np.savez(tmp_path / "init.npz", **{
        k: v.numpy() for k, v in convert.params_from_jax(init).items()})
    ckpt, init_path = tmp_path / "ckpt", tmp_path / "init.npz"
    # phase 1: 4 ranks (dp 2 × tensor 2), 3 steps
    phase1 = run_workers(tmp_path, RESIZE_WORKER, 4,
                         args=(ckpt, init_path, 2, 3, 0))
    for r in phase1:
        assert r["start"] == 0 and r["dp"] == 2 and r["source"] == "init"
        assert r["completed"] == 3 * 8 and r["latest"] == 3
        assert r["losses"] == phase1[0]["losses"]
        np.testing.assert_allclose(r["losses"][-1], loss1, rtol=1e-4)
    # phase 2: the world resized to 2 ranks; the same global batch
    phase2 = run_workers(tmp_path, RESIZE_WORKER, 2,
                         args=(ckpt, init_path, 1, 2, 1))
    for r in phase2:
        assert r["start"] == jstart2 == 3 and r["dp"] == 2
        assert r["source"] == "checkpoint" and r["position"] == 24
        assert r["step"] == r["latest"] == 5 and r["completed"] == 40
        np.testing.assert_allclose(r["losses"][-1], loss2, rtol=1e-4)
        assert {"abstract_state_s", "dcp_read_s", "restore_tensor_read_s",
                "restore_metadata_read_s", "device_ready_s", "post_sync_s",
                "compile_total_s", "build_s"} <= set(r["timings"])


def _adamw(params):
    return torch.optim.AdamW(params, lr=1e-3)


def test_stop_request_forces_save(tmp_path):
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    loop = ElasticTrainLoop(
        functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
        TrainLoopConfig(global_batch=8, seq_len=16, max_micro_per_replica=4,
                        max_steps=100, checkpoint_dir=str(tmp_path / "c"),
                        save_interval_steps=1000), device="cpu")
    state, _ = loop.restore_or_init(0)

    def gen():
        for i, batch in enumerate(_batches(cfg.vocab_size, 8, 16, 50)):
            if i == 2:
                loop._stop_requested.set()
            yield batch

    state, metrics = loop.run(state, gen())
    assert metrics["step"] == 3
    assert loop.checkpointer.latest_step() == 3  # forced save on stop
    loop.close()


def test_run_collects_garbage_at_step_boundaries_only():
    """While a run lasts the automatic collection is off; the loop
    collects the young generations after the first step, and the
    caller's setting comes back when the run returns."""
    import gc

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    loop = ElasticTrainLoop(
        functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
        TrainLoopConfig(global_batch=8, seq_len=16, max_micro_per_replica=4,
                        max_steps=3), device="cpu")
    state, _ = loop.restore_or_init(0)
    seen, young = [], []

    def on_gc(phase, info):
        if phase == "stop" and info["generation"] > 0:
            young.append((len(seen), info["generation"]))

    def gen():
        for batch in _batches(cfg.vocab_size, 8, 16, 3):
            seen.append(gc.isenabled())
            yield batch

    assert gc.isenabled()
    gc.callbacks.append(on_gc)
    try:
        state, metrics = loop.run(state, gen())
    finally:
        gc.callbacks.remove(on_gc)
    assert metrics["step"] == 3
    assert seen == [False] * 3 and young == [(1, 1)]
    assert gc.isenabled()
    gc.disable()
    try:
        loop.config.max_steps = 2
        loop.run(state, _batches(cfg.vocab_size, 8, 16, 2))
        assert not gc.isenabled()
    finally:
        gc.enable()
    loop.close()


def test_gc_probe_sees_only_the_loops_collection_during_a_run(tmp_path):
    """``examples/gc_probe.py`` logs the worker's collections beside its
    step lines: between the first and the last step there is exactly
    one, the loop's collection of the young generations before step
    2."""
    gc_log, log = tmp_path / "gc.log", tmp_path / "w.log"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "dlrover_tpu_torch", "examples",
                                      "gc_probe.py"), "--gc-log", str(gc_log),
         "--config", "tiny", "--device", "cpu", "--steps", "3",
         "--log-file", str(log)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                           OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    steps = {int(line.split()[2]): float(line.split()[0])
             for line in log.read_text().splitlines()
             if line.split()[1:2] == ["step"]}
    assert sorted(steps) == [1, 2, 3]
    during = [line.split()[1] for line in gc_log.read_text().splitlines()
              if steps[1] < float(line.split()[0]) < steps[3]]
    assert during == ["gen=1"]
    assert all(float(line.split()[0]) < steps[2]
               for line in gc_log.read_text().splitlines()
               if steps[1] < float(line.split()[0]) < steps[3])


SIGTERM_WORKER = """
import functools, json, sys, time
import numpy as np
import torch
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.trainer.elastic_loop import ElasticTrainLoop, TrainLoopConfig
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

ckpt, first = sys.argv[1], sys.argv[2] == "first"
cfg = LlamaConfig.tiny(dtype=torch.float32)
loop = ElasticTrainLoop(
    functools.partial(Llama, cfg), lambda p: torch.optim.AdamW(p, lr=1e-3),
    cross_entropy_loss,
    TrainLoopConfig(global_batch=4, seq_len=16, max_micro_per_replica=4,
                    max_steps=50 if first else 2, checkpoint_dir=ckpt,
                    save_interval_steps=1000), device="cpu")
loop.install_signal_handler()
sampler = ElasticDistributedSampler(1024, shuffle=False)
state, start = loop.restore_or_init(0, sampler)
position = sampler.completed_num

def batches():
    rng = np.random.default_rng(0)
    for i in range(60):
        if first and i == 2:
            print("ready", flush=True)   # two steps done
            for _ in range(100):         # the signal lands here
                if loop._stop_requested.is_set():
                    break
                time.sleep(0.1)
        tokens = rng.integers(0, 256, (4, 16))
        yield tokens, tokens

state, metrics = loop.run(state, batches(), start_step=start, sampler=sampler)
print(json.dumps({"start": start, "position": position,
                  "step": metrics["step"],
                  "latest": loop.checkpointer.latest_step()}))
loop.close()
"""


def test_sigterm_saves_the_step_and_a_new_worker_resumes(tmp_path):
    """SIGTERM (the agent's restart) after the second step: the worker
    finishes the step it is in, saves it and exits 0; a new worker
    process resumes at that step with the sampler there."""
    script = tmp_path / "sigterm_worker.py"
    script.write_text(textwrap.dedent(SIGTERM_WORKER))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    outs = []
    for mode in ("first", "second"):
        proc = subprocess.Popen(
            [sys.executable, str(script), str(tmp_path / "c"), mode],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env)
        try:
            lines = []
            for line in proc.stdout:
                lines.append(line)
                if line.strip() == "ready":
                    proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=120) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        outs.append(json.loads(lines[-1]))
    first, second = outs
    assert first["step"] == first["latest"] == 3
    assert second["start"] == 3 and second["position"] == 12
    assert second["step"] == 5


def test_loop_reports_model_info_and_steps_to_a_live_master(tmp_path):
    """With a ``MasterClient`` to the port's master (gRPC on localhost):
    ``ModelInfo`` once, a ``GlobalStepReport`` every
    ``report_interval_steps``, and the master's ``SpeedMonitor`` holds
    the loop's step and a tokens/s within 5% of the loop's own."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.job_master import JobMaster

    master = JobMaster(host="127.0.0.1")
    master.prepare()

    class CountingClient(MasterClient):
        calls = {"report_model_info": 0, "report_global_step": []}

        def report_model_info(self, **kw):
            self.calls["report_model_info"] += 1
            return super().report_model_info(**kw)

        def report_global_step(self, step, **kw):
            self.calls["report_global_step"].append(step)
            return super().report_global_step(step, **kw)

    client = CountingClient(master.addr, node_id=0, timeout_s=10.0)
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    seq, batch = 128, 16
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loop = ElasticTrainLoop(
            functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
            TrainLoopConfig(global_batch=batch, seq_len=seq,
                            max_micro_per_replica=batch, max_steps=7,
                            report_interval_steps=2),
            master_client=client, device="cpu")
        state, _ = loop.restore_or_init(0)
        state, metrics = loop.run(
            state, _batches(cfg.vocab_size, batch, seq, 7))
        loop.close()
        monitor = master.speed_monitor
        assert client.calls == {"report_model_info": 1,
                                "report_global_step": [2, 4, 6]}
        assert monitor.completed_global_step == 6 == metrics["step"] - 1
        # the master's clock spans reports 2 → 6, the loop's steps 3-6
        hist = {r["step"]: r for r in metrics["history"]}
        own = 4 * batch * seq / sum(hist[n]["step_time_s"]
                                    for n in (3, 4, 5, 6))
        assert abs(monitor.tokens_per_second() - own) / own < 0.05
        assert monitor.seq_len_hint == seq
    finally:
        torch.set_num_threads(threads)
        client.close()
        master.stop()


def test_loop_checkpoints_and_restores_the_masters_shard_position(
        tmp_path):
    """The loop saves the master's data-shard position (the dataset the
    job registered, under the default name "") with each checkpoint and
    gives it back to the master on restore, as the JAX loop does."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.messages import DatasetShardParams
    from dlrover_tpu_torch.master.job_master import JobMaster

    master = JobMaster(host="127.0.0.1")
    master.prepare()
    client = MasterClient(master.addr, node_id=0, timeout_s=10.0)
    cfg = LlamaConfig.tiny(dtype=torch.float32)

    def loop():
        return ElasticTrainLoop(
            functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
            TrainLoopConfig(global_batch=4, seq_len=16,
                            max_micro_per_replica=4, max_steps=2,
                            checkpoint_dir=str(tmp_path / "c"),
                            save_interval_steps=2, report_interval_steps=0),
            master_client=client, device="cpu")

    try:
        assert client.report_dataset_shard_params(DatasetShardParams(
            dataset_size=100, shard_size=10, storage_type="table"))
        taken = [client.get_task("").shard.start for _ in range(3)]
        client.report_task_result("", 0)
        saved = client.get_shard_checkpoint("")
        first = loop()
        state, _ = first.restore_or_init(0)
        first.run(state, _batches(cfg.vocab_size, 4, 16, 2))
        first.close()
        client.get_task("")
        assert client.get_shard_checkpoint("") != saved
        second = loop()
        _, start = second.restore_or_init(0)
        second.close()
        assert taken == [0, 10, 20] and start == 2
        assert client.get_shard_checkpoint("") == saved
    finally:
        client.close()
        master.stop()


def _drain_batches(vocab, drain_file, deadline, count=20, seed=0):
    """Seeded batches; the drain request lands while step 3 runs, so the
    boundary after step 3 consumes it."""
    from dlrover_tpu.agent.preemption import write_drain_request

    for i, batch in enumerate(_batches(vocab, 8, 16, count, seed)):
        if i == 2:
            write_drain_request(drain_file, 1, deadline,
                                reason="test preemption")
        yield batch


def test_drain_at_step_3_and_resume_match_jax(cpu_devices, tmp_path,
                                              monkeypatch):
    """The slice in small: a tiny Llama in both packages, from the JAX
    loop's init, gets a drain request during step 3. Each loop runs its
    emergency checkpoint at that boundary and leaves with DrainExit (code
    76); a new loop restores the drained step and trains 2 more. Both
    land on step 3, and the resumed losses agree within 1e-4."""
    from dlrover_tpu.trainer.elastic_loop import DrainExit as JDrainExit
    from dlrover_tpu_torch import obs
    from dlrover_tpu_torch.trainer.elastic_loop import DrainExit

    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    jcfg = jllama.LlamaConfig.tiny(attn_impl="reference", dtype=jnp.float32)
    deadline = time.time() + 120.0

    def jax_loop(max_steps):
        return jloop.ElasticTrainLoop(
            jllama.Llama(jcfg), optax.adamw(1e-3), jllama.cross_entropy_loss,
            jloop.TrainLoopConfig(
                global_batch=8, seq_len=16, max_micro_per_replica=4,
                max_steps=max_steps, checkpoint_dir=str(tmp_path / "jax"),
                save_interval_steps=1000, mesh_spec=JMeshSpec()),
            devices=cpu_devices[:1])

    monkeypatch.setenv("DLROVER_TPU_DRAIN_REQUEST", str(tmp_path / "jd"))
    loop = jax_loop(100)
    state, _ = loop.restore_or_init(jax.random.PRNGKey(0))
    init = convert.params_from_jax(jax.tree.map(np.asarray, state.params))
    with pytest.raises(JDrainExit) as jexit:
        loop.run(state, _drain_batches(jcfg.vocab_size,
                                       str(tmp_path / "jd"), deadline))
    loop.close()
    # the resumed worker runs under a new agent, with no request pending
    monkeypatch.delenv("DLROVER_TPU_DRAIN_REQUEST")
    loop = jax_loop(2)
    state, jstart = loop.restore_or_init(jax.random.PRNGKey(1))
    state, jmetrics = loop.run(state, _batches(jcfg.vocab_size, 8, 16, 5,
                                               seed=1), start_step=jstart)
    loop.close()

    cfg = LlamaConfig.tiny(attn_impl="flash", dtype=torch.float32)

    def model(device, seed):
        m = Llama(cfg, device=device, seed=seed)
        if torch.device(device).type != "meta":
            m.load_state_dict(init)
        return m

    def port_loop(max_steps):
        return ElasticTrainLoop(
            model, lambda p: torch.optim.AdamW(p, lr=1e-3,
                                               weight_decay=1e-4),
            cross_entropy_loss,
            TrainLoopConfig(global_batch=8, seq_len=16,
                            max_micro_per_replica=4, max_steps=max_steps,
                            checkpoint_dir=str(tmp_path / "port"),
                            save_interval_steps=1000), device="cpu")

    monkeypatch.setenv("DLROVER_TPU_DRAIN_REQUEST", str(tmp_path / "td"))
    loop = port_loop(100)
    state, _ = loop.restore_or_init(0)
    with pytest.raises(DrainExit) as texit:
        loop.run(state, _drain_batches(cfg.vocab_size, str(tmp_path / "td"),
                                       deadline))
    assert texit.value.code == jexit.value.code == 76
    assert texit.value.reason == "test preemption"
    events = [e.get("name") for e in obs.get_flight_recorder().snapshot()]
    assert {"train_drain", "emergency_checkpoint",
            "train_drained"} <= set(events)
    assert sorted(os.listdir(tmp_path / "port")) == ["3"]
    loop.close()
    monkeypatch.delenv("DLROVER_TPU_DRAIN_REQUEST")
    loop = port_loop(2)
    state, start = loop.restore_or_init(0)
    state, metrics = loop.run(state, _batches(cfg.vocab_size, 8, 16, 5,
                                              seed=1), start_step=start)
    loop.close()
    assert start == jstart == 3
    assert metrics["step"] == 5
    np.testing.assert_allclose(metrics["loss"], jmetrics["loss"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the GPT and BERT families through the loop
# ---------------------------------------------------------------------------


class _InfoClient:
    """The MasterClient surface both loops call at construction; keeps
    the ``ModelInfo`` they report."""

    def __init__(self):
        self.model_info = []

    def report_model_info(self, **kwargs):
        self.model_info.append(kwargs)
        return True

    def probe_clock(self):
        return time.time()

    def get_shard_plan(self):
        return None

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def _family(name):
    from dlrover_tpu.models import bert as jbert
    from dlrover_tpu.models import gpt as jgpt
    from dlrover_tpu_torch.models import bert as tbert
    from dlrover_tpu_torch.models import gpt as tgpt

    if name == "gpt":
        return (jgpt.GPT(jgpt.GPTConfig.tiny(dtype=jnp.float32)),
                functools.partial(tgpt.GPT,
                                  tgpt.GPTConfig.tiny(dtype=torch.float32)),
                jllama.cross_entropy_loss, cross_entropy_loss)
    return (jbert.Bert(jbert.BertConfig.tiny(dtype=jnp.float32)),
            functools.partial(tbert.Bert,
                              tbert.BertConfig.tiny(dtype=torch.float32)),
            jbert.mlm_loss, tbert.mlm_loss)


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_gpt_and_bert_report_the_jax_loops_model_info(cpu_devices, family):
    """Both loops, the same tiny config, one recording client each: the
    same parameter count (the sum over the parameters, biases and norms
    included), bytes, FLOPs/token (GPT's without an attention term, as
    its config has n_layer/n_embd; BERT's halved as if causal) and the
    planner's divisors."""
    jmodel, tmodel, jloss, tloss = _family(family)
    jclient, tclient = _InfoClient(), _InfoClient()
    cfg = dict(global_batch=8, seq_len=16, max_micro_per_replica=4)
    jl = jloop.ElasticTrainLoop(jmodel, optax.adamw(1e-3), jloss,
                                jloop.TrainLoopConfig(**cfg),
                                master_client=jclient,
                                devices=cpu_devices[:1])
    tl = ElasticTrainLoop(tmodel, _adamw, tloss, TrainLoopConfig(**cfg),
                          master_client=tclient, device="cpu")
    jl.close()
    tl.close()
    want, got = jclient.model_info[0], tclient.model_info[0]
    for key in ("param_count", "param_bytes", "flops_per_token",
                "flops_per_step", "tensor_divisor", "fsdp_divisor",
                "batch_size", "seq_len", "effective_global_batch"):
        assert got[key] == want[key], key
    probe = tmodel(device="meta")
    n = sum(p.numel() for p in probe.parameters())
    assert got["param_count"] == n
    if family == "gpt":
        assert got["flops_per_token"] == 6.0 * n
        assert got["fsdp_divisor"] == probe.config.n_embd
    else:
        c = probe.config
        assert got["flops_per_token"] == 6.0 * n + 6.0 * c.num_layers \
            * c.hidden_size * 16


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_gpt_and_bert_train_through_the_loop(family):
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
    from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

    _, tmodel, _, tloss = _family(family)
    vocab = tmodel(device="meta").config.vocab_size
    loop = ElasticTrainLoop(
        tmodel, _adamw, tloss,
        TrainLoopConfig(global_batch=8, seq_len=32, max_micro_per_replica=4,
                        max_steps=3), device="cpu")
    assert (loop.accum, loop.micro_global) == (2, 4)
    sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)
    state, start = loop.restore_or_init(0, sampler)
    data = batches(synthetic_corpus(vocab), sampler, 8, 32)
    state, metrics = loop.run(state, data, sampler=sampler)
    loop.close()
    hist = metrics["history"]
    assert metrics["step"] == state.step == len(hist) == 3
    for rec in hist:
        assert np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])
    assert abs(hist[0]["loss"] - np.log(vocab)) < 1.0


def test_gpt_resumes_with_the_uninterrupted_runs_bits(tmp_path):
    """GPT tiny saves at step 2 of 4; a fresh loop restores step 2 and
    trains steps 3-4 with the bits of the run that was never stopped."""
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
    from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

    _, tmodel, _, tloss = _family("gpt")

    def run(ckpt, steps):
        loop = ElasticTrainLoop(
            tmodel, _adamw, tloss,
            TrainLoopConfig(global_batch=4, seq_len=32,
                            max_micro_per_replica=4, max_steps=steps,
                            checkpoint_dir=ckpt, save_interval_steps=2),
            device="cpu")
        sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)
        state, start = loop.restore_or_init(0, sampler)
        loop.config.max_steps = steps - start
        data = batches(synthetic_corpus(128), sampler, 4, 32)
        state, metrics = loop.run(state, data, start_step=start,
                                  sampler=sampler)
        loop.close()
        return start, [(r["loss"], r["grad_norm"])
                       for r in metrics["history"]], state

    _, whole, whole_state = run("", 4)
    first_start, first, _ = run(str(tmp_path / "c"), 2)
    start, resumed, state = run(str(tmp_path / "c"), 4)
    assert (first_start, start) == (0, 2)
    assert first + resumed == whole
    for (name, a), b in zip(state.model.state_dict().items(),
                            whole_state.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_nanogpt_example_resumes_in_process(tmp_path):
    """The port's nanoGPT worker, called in this process on the CPU: 4
    steps saving at 2, then a second call resumes at 4 and finishes 6.
    Its corpus and batches are the JAX example's tokens."""
    import importlib.util

    from dlrover_tpu_torch.examples import nanogpt_train
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

    spec = importlib.util.spec_from_file_location(
        "jax_nanogpt_train", os.path.join(REPO, "examples", "nanogpt",
                                          "train.py"))
    jexample = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jexample)
    corpus = nanogpt_train.synthetic_corpus(256)
    np.testing.assert_array_equal(corpus, jexample.synthetic_corpus(256))
    got = nanogpt_train.batches(corpus, ElasticDistributedSampler(
        dataset_size=10 ** 6, seed=0), 8, 64)
    want = jexample.batches(corpus, JSampler(10 ** 6, seed=0), 8, 64)
    for _ in range(2):
        for a, b in zip(next(got), next(want)):
            np.testing.assert_array_equal(a, b)

    log = tmp_path / "log"
    args = ["--device", "cpu", "--save-interval", "2", "--ckpt-dir",
            str(tmp_path / "c"), "--log-file", str(log)]
    assert nanogpt_train.main(args + ["--steps", "4"]) == 0
    assert nanogpt_train.main(args + ["--steps", "6"]) == 0
    lines = log.read_text().splitlines()
    assert lines[0].startswith("nanogpt: start_step=0 ")
    assert lines[1].startswith("nanogpt: done step=4 ")
    assert lines[2].startswith("nanogpt: start_step=4 ")
    assert lines[3].startswith("nanogpt: done step=6 ")
