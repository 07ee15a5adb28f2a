"""The port's ElasticTrainLoop with checkpoint-resume across a world
resize, against the JAX package's (tests/test_elastic_loop.py).

Train 3 steps at 4 ranks (data 2 × tensor 2), stop, resume at 2 ranks
(data 2) with the same global batch and data position for 2 more steps:
the port's gloo ranks start from the JAX loop's own init (carried
across) and see the JAX test's batches, and each phase's last loss must
be within 1e-4 of the JAX run's. A stop request forces a save, and a
worker process that receives SIGTERM saves the step it stopped on and a
second one resumes there.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
