"""Tensor parallelism through the port's build_trainer
(dlrover_tpu_torch.trainer.train_step at a ``tensor`` axis) against the
JAX package's single-device oracle, as tests/test_models.py's
``test_sharded_training_on_mesh`` holds JAX's own fsdp × tensor runs.

The families a tensor axis was refused on, or trained only part of:
GPT and BERT, whose fused ``qkv`` projection the port stores head-major
(each rank's column shard is whole q, k and v heads; ``convert.py``
permutes it from flax's ``[q | k | v]``), and the Llama with the
reference norm (ROADMAP C17: the row-parallel products' pending sums are
reduced at each projection's output, ``parallel/sharding.py``). Each
starts from the JAX model's f32 init carried across and trains three
AdamW steps on one batch (8 rows of 16 tokens) on gloo CPU ranks, at
tensor 2 and at fsdp 2 × tensor 2; the losses and grad norms must track
the JAX trainer's on one device at rtol/atol 1e-4. GPT carries its tied
head (``wte``, sharded over the vocabulary, feeds the lookup and the
logits), BERT trains ``mlm_loss`` with weights (four predicted positions
a row, so that every data shard holds the same count). The same 2-rank
launch lowers auto_accelerate's ``tensor_parallel`` on GPT, checks that
a block's q, k and v come out of the fused projection as whole heads
sharded over the axis with no collective, forces the host-staged path
of the tensor axis's sums (the card's path over gloo), and restores a
GPT checkpoint saved by one process at tensor 2, and saves one that this
process restores at tensor 1: the same bits both ways. One gloo launch
of 2 ranks and one of 4 run every case while JAX computes its oracles.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from dlrover_tpu.models import bert as jbert
from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dlrover_tpu.parallel.mesh import create_mesh as jcreate_mesh
from dlrover_tpu.trainer import train_step as jts
from dlrover_tpu_torch import convert
from test_torch_mesh import run_workers

BATCH, SEQ, STEPS, LR, WD = 8, 16, 3, 1e-3, 0.1
TOL = dict(rtol=1e-4, atol=1e-4)
FAMILIES = ("gpt", "bert", "llama")
# BERT's predicted positions a row
MASKED = 4


def _jax_family(family):
    """(model, loss, head count) of a tiny f32 JAX model with the plain
    attention (the Llama's norm the reference one, as C17 needs)."""
    if family == "gpt":
        cfg = jgpt.GPTConfig.tiny(attn_impl="reference", dtype=jnp.float32)
        return jgpt.GPT(cfg), jllama.cross_entropy_loss, cfg.n_head
    if family == "bert":
        cfg = jbert.BertConfig.tiny(attn_impl="reference", dtype=jnp.float32)
        weights = jnp.asarray(_batch("bert")[2])
        return (jbert.Bert(cfg),
                lambda logits, tgt: jbert.mlm_loss(logits, tgt, weights),
                cfg.num_heads)
    cfg = jllama.LlamaConfig.tiny(attn_impl="reference",
                                  norm_impl="reference", dtype=jnp.float32)
    return jllama.Llama(cfg), jllama.cross_entropy_loss, cfg.num_heads


def _batch(family):
    """(tokens, targets, BERT's weights: MASKED ones a row)."""
    rng = np.random.default_rng(3)
    vocab = 128 if family in ("gpt", "bert") else 256
    tokens = rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32)
    targets = rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32)
    weights = np.zeros((BATCH, SEQ), np.float32)
    for row in weights:
        row[rng.choice(SEQ, MASKED, replace=False)] = 1.0
    return tokens, targets, weights


def _oracle(family, out_dir):
    """JAX's single-device trainer: its init saved for the port in the
    port's layout with the batch, and a function giving its (loss,
    grad_norm) a step."""
    model, loss_fn, heads = _jax_family(family)
    mesh = jcreate_mesh(JMeshSpec(), jax.devices("cpu")[:1])
    trainer = jts.build_trainer(
        model, optax.adamw(LR, weight_decay=WD), mesh,
        jnp.zeros((BATCH, SEQ), jnp.int32), loss_fn, accum_steps=1,
        micro_batch=BATCH)
    state = trainer.init(jax.random.PRNGKey(0))
    init = convert.params_from_jax(
        jax.tree.map(np.asarray, nn.unbox(state.params)), heads)
    torch.save(init, os.path.join(out_dir, f"{family}.pt"))
    tokens, targets, weights = _batch(family)
    np.savez(os.path.join(out_dir, f"{family}.npz"), tokens=tokens,
             targets=targets, weights=weights)

    def steps():
        nonlocal state
        history = []
        for _ in range(STEPS):
            state, m = trainer.step(state, *trainer.shard_batch(tokens,
                                                                targets))
            history.append((float(m["loss"]), float(m["grad_norm"])))
        return history

    return init, steps


WORKER = r'''
import json, os, sys

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication

from dlrover_tpu_torch import convert
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.checkpoint.flash_checkpoint import FlashCheckpointer
from dlrover_tpu_torch.models import bert, gpt, llama
from dlrover_tpu_torch.models.layers import split_heads
from dlrover_tpu_torch.parallel import collectives
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.trainer.train_step import build_trainer

torch.set_num_threads(1)
init_distributed("cpu")
data_dir, cases = sys.argv[1], json.loads(sys.argv[2])
LR, WD, STEPS = 1e-3, 0.1, 3
rank = torch.distributed.get_rank()
world = torch.distributed.get_world_size()


def adamw(params):
    # optax.adamw's
    return torch.optim.AdamW(params, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WD)


def config(name):
    if name == "gpt":
        return gpt.GPT, gpt.GPTConfig.tiny(attn_impl="flash",
                                           dtype=torch.float32)
    if name == "bert":
        return bert.Bert, bert.BertConfig.tiny(attn_impl="flash",
                                               dtype=torch.float32)
    return llama.Llama, llama.LlamaConfig.tiny(
        attn_impl="flash", norm_impl="reference", dtype=torch.float32)


def factory_of(name):
    """The family built holding JAX's init (not on the meta device)."""
    model_cls, cfg = config(name)
    init = torch.load(os.path.join(data_dir, name + ".pt"))

    def factory(device=None, seed=0):
        model = model_cls(cfg, device=device, seed=seed)
        if torch.device(device).type != "meta":
            model.load_state_dict(init)
        return model
    return factory


def trainer_of(case):
    name = case["family"]
    batch = np.load(os.path.join(data_dir, name + ".npz"))
    held = {}
    if name == "bert":
        def loss_fn(logits, targets):
            return bert.mlm_loss(logits, targets, held["weights"])
    else:
        loss_fn = llama.cross_entropy_loss
    sample = np.zeros(batch["tokens"].shape, np.int64)
    rows = batch["tokens"].shape[0]
    if case.get("auto"):
        from dlrover_tpu_torch.auto.accelerate import auto_accelerate

        result = auto_accelerate(
            factory_of(name), optim_factory=lambda: adamw, loss_fn=loss_fn,
            sample_batch=sample,
            strategy=[("tensor_parallel", {"size": world})],
            micro_batch=rows, devices=["cpu"] * world)
        trainer = result.trainer
    else:
        trainer = build_trainer(
            factory_of(name), adamw,
            create_mesh(MeshSpec(**case["spec"]), device="cpu"), sample,
            loss_fn, micro_batch=rows)
    # this rank's rows of the weights, as its batch
    held["weights"] = trainer.shard_batch(batch["weights"],
                                          batch["weights"])[1][0].float()
    return trainer, batch


def full(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy()


def full_state(state):
    """Every parameter and AdamW moment, whole."""
    out = {}
    for name, p in state.model.named_parameters():
        out[name] = full(p)
        for key, value in state.optimizer.state[p].items():
            if torch.is_tensor(value) and value.ndim:
                out[f"{name}/{key}"] = full(value)
    return out


def qkv_split(state, name):
    """A block's q, k and v of a replicated activation: the collectives
    counted, their placements, and each rank's heads against the same
    heads of flax's [q | k | v] split of the whole projection."""
    block = next(m for m in state.model.modules()
                 if hasattr(m, "qkv_heads"))
    kernel, bias = block.qkv.kernel, block.qkv.bias
    heads = config(name)[1].n_head if name == "gpt" else \
        config(name)[1].num_heads
    x = torch.randn(2, 16, kernel.shape[0],
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), implicit_replication():
        xd = DTensor.from_local(x, kernel.device_mesh, [Replicate()],
                                run_check=False)
        comm = CommDebugMode()
        with comm:
            qkv = block.qkv_heads(xd)
        local = [t.to_local() for t in split_heads(block.qkv(xd), heads)]
    width = kernel.shape[1] // 3
    y = x @ convert.qkv_to_jax(full(kernel), heads) + \
        convert.qkv_to_jax(full(bias), heads)
    mine = heads // world
    whole = all(
        np.array_equal(got.numpy(), y[..., j * width:(j + 1) * width]
                       .reshape(2, 16, heads, -1)
                       [:, :, rank * mine:(rank + 1) * mine])
        for j, got in enumerate(local))
    return {"collectives": comm.get_total_counts(),
            "placements": sorted({str(t.placements) for t in qkv}),
            "local_heads": sorted({t.to_local().shape[2] for t in qkv}),
            "whole_heads": bool(whole)}


direct = collectives.host_staged
out = {}
for case in cases:
    trainer, batch = trainer_of(case)
    if case.get("staged"):
        # the card's path over gloo: each sum through host memory
        collectives.host_staged = lambda group, tensors: True
    state = trainer.init(0)
    tok, tgt = trainer.shard_batch(batch["tokens"], batch["targets"])
    history, staging = [], 0.0
    for _ in range(STEPS):
        collectives.reset_staging_seconds()
        state, m = trainer.step(state, tok, tgt)
        history.append([m["loss"].item(), m["grad_norm"].item()])
        staging += collectives.staging_seconds["all_reduce"]
    collectives.host_staged = direct
    result = {"history": history, "staging_s": staging,
              "tensor": trainer.mesh.shape["tensor"]}
    if case.get("split"):
        result["split"] = qkv_split(state, case["family"])
    if case.get("ckpt"):
        # saved by one process at tensor 1: restored here, the same bits
        want = np.load(os.path.join(data_dir, "ckpt1.npz"))
        with FlashCheckpointer(os.path.join(data_dir, "ckpt1")) as ck:
            restored, _, step = ck.restore(trainer.abstract_state())
        got = full_state(restored)
        result["restored_step"] = step
        result["restored_same_bits"] = (
            set(got) == set(want.files)
            and all(np.array_equal(got[k], want[k]) for k in got))
        # one more step here, saved at tensor 2 for one process
        restored, _ = trainer.step(restored, tok, tgt)
        with FlashCheckpointer(os.path.join(data_dir, "ckpt2"),
                               save_interval_steps=1) as ck:
            ck.maybe_save(step + 1, restored, {}, force=True)
            ck.wait()
        # (every rank gathers: full_tensor is a collective)
        whole = full_state(restored)
        if rank == 0:
            np.savez(os.path.join(data_dir, "ckpt2.npz"), **whole)
    out[case["id"]] = result
print(json.dumps(out))
'''


def _case(family, spec, **kw):
    name = "".join(f"-{k}{v}" for k, v in spec.items())
    tags = "".join(f"-{k}" for k in sorted(kw))
    return dict(id=f"{family}{name}{tags}", family=family, spec=spec, **kw)


CASES = {
    2: [_case("gpt", {"tensor": 2}, split=True, ckpt=True),
        _case("bert", {"tensor": 2}, split=True),
        _case("llama", {"tensor": 2}),
        _case("gpt", {}, auto=True),
        _case("gpt", {"tensor": 2}, staged=True)],
    4: [_case(f, {"fsdp": 2, "tensor": 2}) for f in FAMILIES],
}
ORACLE_CASES = [(w, c) for w, cases in CASES.items() for c in cases]


def _ckpt_trainer(init):
    """GPT tiny at tensor 1 in this process, from the carried init."""
    from dlrover_tpu_torch.models import gpt as tgpt
    from dlrover_tpu_torch.models.llama import cross_entropy_loss
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    def factory(device=None, seed=0):
        model = tgpt.GPT(tgpt.GPTConfig.tiny(attn_impl="flash",
                                              dtype=torch.float32),
                         device=device, seed=seed)
        if torch.device(device).type != "meta":
            model.load_state_dict(init)
        return model

    return build_trainer(
        factory, lambda p: torch.optim.AdamW(
            p, lr=LR, betas=(0.9, 0.999), eps=1e-8, weight_decay=WD),
        None, np.zeros((BATCH, SEQ)), cross_entropy_loss,
        micro_batch=BATCH, device="cpu")


def _full_state(state):
    out = {}
    for name, p in state.model.named_parameters():
        out[name] = p.detach().numpy()
        for key, value in state.optimizer.state[p].items():
            if torch.is_tensor(value) and value.ndim:
                out[f"{name}/{key}"] = value.numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracles, each launch's per-rank results and this process's
    restore of the tensor-2 checkpoint: the launches train while JAX
    does."""
    from dlrover_tpu_torch.checkpoint.flash_checkpoint import (
        FlashCheckpointer,
    )

    data_dir = tmp_path_factory.mktemp("tp_data")
    oracles = {f: _oracle(f, str(data_dir)) for f in FAMILIES}
    # GPT saved by this process at tensor 1 after two steps
    trainer = _ckpt_trainer(oracles["gpt"][0])
    state = trainer.init(0)
    tokens, targets, _ = _batch("gpt")
    for _ in range(2):
        state, _ = trainer.step(state, *trainer.shard_batch(tokens,
                                                            targets))
    with FlashCheckpointer(str(data_dir / "ckpt1"),
                           save_interval_steps=1) as ck:
        ck.maybe_save(2, state, {}, force=True)
        ck.wait()
    np.savez(data_dir / "ckpt1.npz", **_full_state(state))

    def launch(world):
        return run_workers(tmp_path_factory.mktemp(f"tp{world}"), WORKER,
                           world, args=(str(data_dir),
                                        json.dumps(CASES[world])),
                           timeout=240, name=f"tp{world}")

    with ThreadPoolExecutor(1) as pool:
        launches = {world: pool.submit(launch, world) for world in CASES}
        histories = {f: steps() for f, (_, steps) in oracles.items()}
        results = {world: future.result()
                   for world, future in launches.items()}
    # the tensor-2 save, restored here at tensor 1
    with FlashCheckpointer(str(data_dir / "ckpt2")) as ck:
        restored, _, step = ck.restore(_ckpt_trainer(
            oracles["gpt"][0]).abstract_state())
    return histories, results, (step, _full_state(restored),
                                dict(np.load(data_dir / "ckpt2.npz")))


@pytest.mark.parametrize("world,case", ORACLE_CASES,
                         ids=[f"{w}-{c['id']}" for w, c in ORACLE_CASES])
def test_tensor_parallel_training_tracks_the_jax_oracle(runs, world, case):
    """Each rank's three steps' losses and grad norms within 1e-4 of the
    JAX trainer's on one device, the same on every rank, at the tensor
    axis asked for (auto_accelerate's tensor_parallel lowers to 2)."""
    histories, results, _ = runs
    want = np.asarray(histories[case["family"]])
    ranks = [r[case["id"]] for r in results[world]]
    for rank in ranks:
        assert rank["tensor"] == 2
        got = np.asarray(rank["history"])
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got, np.asarray(ranks[0]["history"]))
    assert want[-1, 0] < want[0, 0]


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_fused_qkv_splits_into_whole_heads_with_no_collective(runs,
                                                              family):
    """The head-major fused projection of a replicated activation gives
    each rank q, k and v sharded over heads (``Shard(2)``, one whole head
    of the tiny presets' two) with no collective counted, and each local
    head equals that head of flax's ``[q | k | v]`` split of the whole
    projection."""
    _, results, _ = runs
    for rank in results[2]:
        split = rank[f"{family}-tensor2-ckpt-split" if family == "gpt"
                     else f"{family}-tensor2-split"]["split"]
        assert split == {"collectives": 0,
                         "placements": ["(Shard(dim=2),)"],
                         "local_heads": [1], "whole_heads": True}


def test_staged_sums_cross_host_memory_with_the_same_bits(runs):
    """The tensor axis's sums forced through the host-staged all-reduce
    (gloo's path for a CUDA tensor on the card): the same losses and grad
    norms bit for bit as the direct collectives, and staging seconds
    counted."""
    _, results, _ = runs
    for rank in results[2]:
        staged = rank["gpt-tensor2-staged"]
        direct = rank["gpt-tensor2-ckpt-split"]
        assert staged["history"] == direct["history"]
        assert staged["staging_s"] > 0 and direct["staging_s"] == 0


def test_checkpoint_saved_at_tensor_1_restores_at_tensor_2(runs):
    """GPT saved by one process (tensor 1) after two steps: the two ranks
    restore it at tensor 2, every parameter and AdamW moment the same
    bits as saved."""
    _, results, _ = runs
    for rank in results[2]:
        case = rank["gpt-tensor2-ckpt-split"]
        assert case["restored_step"] == 2 and case["restored_same_bits"]


def test_checkpoint_saved_at_tensor_2_restores_at_tensor_1(runs):
    """GPT saved at tensor 2 one step later: this process restores it at
    tensor 1, every parameter and AdamW moment the same bits as the ranks
    held (no relayout: the head-major layout does not depend on the
    tensor size)."""
    _, _, (step, got, want) = runs
    assert step == 3
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
