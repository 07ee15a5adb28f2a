"""The pipelined trainer over pipe × tensor and pipe × expert
(dlrover_tpu_torch/trainer/pipeline_trainer.py, parallel/pipeline.py)
against the JAX package's pipelined trainer on one device, on the CPU.

Each case starts from the JAX trainer's f32 init carried across
(``convert.pipeline_params_from_jax``) and trains three AdamW steps of 4
microbatches of 2 rows on one batch, on 4 gloo ranks: the tiny Llama,
GPT and BERT at pipe 2 × tensor 2 (each stage's blocks DTensors over its
tensor group, the shared embedding and head sharded over the vocabulary,
the ring carrying replicated activations) and the tiny Mixtral at pipe 2
× expert 2 (each stage's experts over its expert group). Each rank's
losses and grad norms must track the JAX oracle's at rtol/atol 1e-4. The
same launch checks the layouts (a stage holds only its own layers, a
tensor-sharded kernel half its columns, an expert kernel half its
experts) and the converters, which carry a stage's sharded leaves as
whole arrays. One gloo launch of 4 ranks runs every case while JAX computes
its oracles.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dlrover_tpu.parallel.mesh import create_mesh as jcreate_mesh
from dlrover_tpu.trainer import pipeline_trainer as jpt
from dlrover_tpu.trainer import train_step as jts
from dlrover_tpu_torch import convert
from test_torch_mesh import run_workers
from test_torch_pipeline import LR, M, MICRO, SEQ, WD, _batch, _configs

STEPS = 3
TOL = dict(rtol=1e-4, atol=1e-4)
# case id → (family, mesh spec)
CASES = {
    "llama-pipe2-tensor2": ("llama", {"pipe": 2, "tensor": 2}),
    "gpt-pipe2-tensor2": ("gpt", {"pipe": 2, "tensor": 2}),
    "bert-pipe2-tensor2": ("bert", {"pipe": 2, "tensor": 2}),
    "moe-pipe2-expert2": ("llama_moe", {"pipe": 2, "expert": 2}),
}


def _tiny(family):
    """(JAX config, JAX loss): the tiny presets, f32, reference attention
    (the Llama at its 2 layers and GPT's tiny, two heads, in place of the
    pipeline tests' 4-layer Llama and GPT nano)."""
    jcfg, _, jloss, _ = _configs(family)
    f32 = dict(attn_impl="reference", dtype=jnp.float32)
    if family == "llama":
        jcfg = jllama.LlamaConfig.tiny(**f32)
    if family == "gpt":
        jcfg = jgpt.GPTConfig.tiny(**f32)
    return jcfg, jloss


def _oracle(family, out_dir):
    """The JAX pipelined trainer on one device: its init and batches saved
    for the ranks in the port's names, and a function giving its (loss,
    grad_norm) a step."""
    jcfg, jloss = _tiny(family)
    mesh = jcreate_mesh(JMeshSpec(pipe=1), jax.devices("cpu")[:1])
    tx = optax.adamw(LR, weight_decay=WD)
    trainer = jpt.build_pipeline_trainer(jcfg, tx, mesh, M, MICRO, SEQ,
                                         jloss)
    state = trainer.init(jax.random.PRNGKey(0))
    # the head count a fused qkv is permuted by (GPT's, BERT's)
    heads = getattr(jcfg, "n_head", None) or getattr(jcfg, "num_heads")
    init = convert.pipeline_params_from_jax(
        jax.tree.map(np.asarray, state.params), family, heads=heads)
    tokens, targets = _batch(jcfg.vocab_size)
    np.savez(os.path.join(out_dir, f"{family}.npz"), tokens=tokens,
             targets=targets,
             **{"p/" + n: v.numpy() for n, v in init.items()})

    @jax.jit
    def step(state, tokens, targets):
        loss, grads = jax.value_and_grad(trainer._loss)(state.params,
                                                        tokens, targets)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return (jts.TrainState(step=state.step + 1,
                               params=optax.apply_updates(state.params,
                                                          updates),
                               opt_state=opt_state),
                loss, optax.global_norm(grads))

    def steps():
        """(loss, grad_norm) a step, and the trained parameters in the
        port's names."""
        nonlocal state
        history = []
        for _ in range(STEPS):
            state, loss, norm = step(state,
                                     *trainer.shard_batch(tokens, targets))
            history.append((float(loss), float(norm)))
        return history, convert.pipeline_params_from_jax(
            jax.tree.map(np.asarray, state.params), family, heads=heads)

    return steps


WORKER = r'''
import dataclasses, json, os, sys

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch import convert
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.models import bert, gpt, llama, llama_moe
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.trainer.pipeline_trainer import build_pipeline_trainer

torch.set_num_threads(1)
init_distributed("cpu")
data_dir, cases = sys.argv[1], json.loads(sys.argv[2])
rank = torch.distributed.get_rank()
F32 = dict(attn_impl="reference", dtype=torch.float32)
CONFIGS = {
    "llama": (llama.LlamaConfig.tiny(**F32), llama.cross_entropy_loss),
    "gpt": (gpt.GPTConfig.tiny(**F32), llama.cross_entropy_loss),
    "bert": (bert.BertConfig.tiny(**F32), bert.mlm_loss),
    "llama_moe": (llama_moe.LlamaMoEConfig.mixtral_tiny(**F32),
                  llama.cross_entropy_loss),
}


def adamw(params):
    # optax.adamw's
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.1)


def layout(model):
    """Each parameter's local shape and placements."""
    return {n: [list(p.to_local().shape), str(p.placements)]
            if isinstance(p, DTensor) else [list(p.shape), "plain"]
            for n, p in model.named_parameters()}


out = {}
for case, (family, spec) in cases.items():
    cfg, loss = CONFIGS[family]
    trainer = build_pipeline_trainer(
        cfg, adamw, create_mesh(MeshSpec(**spec), "cpu"), 4, 2, 16, loss,
        device="cpu")
    data = np.load(os.path.join(data_dir, family + ".npz"))
    build = trainer.build_stage

    def factory(device=None, seed=0):
        # the stage holding JAX's init, before it is laid out
        stage = build(device=device, seed=seed)
        if torch.device(device).type != "meta":
            stage.load_state_dict({n: torch.from_numpy(data["p/" + n])
                                   for n in stage.state_dict()})
        return stage

    trainer.model_factory = factory
    state = trainer.init(0)
    history = []
    tok, tgt = trainer.shard_batch(data["tokens"], data["targets"])
    for _ in range(3):
        state, m = trainer.step(state, tok, tgt)
        history.append([m["loss"].item(), m["grad_norm"].item()])
    # the stage through the converters: its sharded leaves as whole
    # arrays (every rank gathers alike), the same as the leaves gathered
    heads = getattr(cfg, "n_head", None) or cfg.num_heads
    whole = {n: t.numpy() for n, t in convert.params_from_jax(
        convert.params_to_jax(state.model.state_dict(), heads),
        heads).items()}
    gathered = {n: (p.full_tensor() if isinstance(p, DTensor) else p)
                .detach().numpy()
                for n, p in state.model.named_parameters()}
    np.savez(os.path.join(data_dir, f"{case}-{rank}.npz"), **whole)
    out[case] = {"history": history, "layout": layout(state.model),
                 "coordinate": trainer.mesh.coordinate(),
                 "converted_whole": set(whole) == set(gathered) and all(
                     np.array_equal(whole[n], gathered[n]) for n in whole)}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracles and the 4 ranks' results: the launch trains while
    JAX does."""
    data_dir = tmp_path_factory.mktemp("pipe_tp_data")
    families = sorted({family for family, _ in CASES.values()})
    oracles = {f: _oracle(f, str(data_dir)) for f in families}

    def launch():
        return run_workers(tmp_path_factory.mktemp("pipe_tp"), WORKER, 4,
                           args=(str(data_dir), json.dumps(CASES)),
                           timeout=240, name="pipe_tp")

    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch)
        trained = {f: steps() for f, steps in oracles.items()}
        results = future.result()
    histories = {f: history for f, (history, _) in trained.items()}
    params = {f: final for f, (_, final) in trained.items()}
    return histories, results, params, data_dir


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_training_tracks_the_jax_oracle(runs, case):
    """Each rank's three steps' losses and grad norms within 1e-4 of the
    JAX pipelined trainer's on one device, the same on every rank."""
    histories, results, _, _ = runs
    family, _ = CASES[case]
    want = np.asarray(histories[family])
    for rank in results:
        got = np.asarray(rank[case]["history"])
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(
            got, np.asarray(results[0][case]["history"]))
    assert want[-1, 0] < want[0, 0]


def test_pipe_tensor_stages_hold_their_layers_with_half_the_columns(runs):
    """At pipe 2 × tensor 2 a rank holds its stage's layer and the shared
    leaves, the column-parallel kernels and the vocabulary-sharded tables
    with half their columns or rows over the tensor axis, the norm
    scales replicated."""
    _, results, _, _ = runs
    for rank in results:
        coord = rank["llama-pipe2-tensor2"]["coordinate"]
        layout = rank["llama-pipe2-tensor2"]["layout"]
        stage = coord["pipe"]
        assert {n.split(".")[0] for n in layout if n.startswith("layer_")} \
            == {f"layer_{stage}"}
        q = layout[f"layer_{stage}.attn.q_proj.kernel"]
        o = layout[f"layer_{stage}.attn.o_proj.kernel"]
        assert q == [[64, 32], "(Shard(dim=1),)"]
        assert o == [[32, 64], "(Shard(dim=0),)"]
        assert layout["embed"] == [[128, 64], "(Shard(dim=0),)"]
        assert layout["lm_head"] == [[64, 128], "(Shard(dim=1),)"]
        assert layout["final_norm.weight"] == [[64], "(Replicate(),)"]
        gpt = rank["gpt-pipe2-tensor2"]["layout"]
        assert gpt[f"block_{stage}.qkv.kernel"] == [[64, 96],
                                                     "(Shard(dim=1),)"]


def test_pipe_expert_stages_hold_half_the_experts(runs):
    """At pipe 2 × expert 2 an MoE stage's expert kernels hold 2 of the 4
    experts (``Shard(0)`` over the stage's expert group), the router its
    expert columns, and the attention stays plain."""
    _, results, _, _ = runs
    for rank in results:
        stage = rank["moe-pipe2-expert2"]["coordinate"]["pipe"]
        layout = rank["moe-pipe2-expert2"]["layout"]
        prefix = f"layer_{stage}.moe."
        assert layout[prefix + "ExpertMLP_0.wi"] == [[2, 64, 128],
                                                     "(Shard(dim=0),)"]
        assert layout[prefix + "ExpertMLP_0.wo"] == [[2, 128, 64],
                                                     "(Shard(dim=0),)"]
        assert layout[prefix + "router"] == [[64, 2], "(Shard(dim=1),)"]
        assert layout[f"layer_{stage}.attn.q_proj.kernel"][1] == "plain"


@pytest.mark.parametrize("case", list(CASES))
def test_converters_carry_a_stage_s_sharded_leaves_whole(runs, case):
    """A stage's state dict through ``convert.params_to_jax`` and back:
    its tensor- and expert-sharded leaves come out as whole arrays, the
    same bits as the leaves gathered, and the Llama's and the MoE's
    trained leaves (no bias: Adam moves an f32-noise gradient by ±lr in
    either package) within 1e-4 of the JAX oracle's."""
    _, results, params, data_dir = runs
    family, _ = CASES[case]
    for rank, result in enumerate(results):
        assert result[case]["converted_whole"]
        got = dict(np.load(data_dir / f"{case}-{rank}.npz"))
        want = params[family]
        assert set(got) <= set(want)
        if family in ("llama", "llama_moe"):
            for name, value in got.items():
                np.testing.assert_allclose(value, want[name].numpy(),
                                           err_msg=name, **TOL)
