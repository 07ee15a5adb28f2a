"""Sequence parallelism through the port's build_trainer
(dlrover_tpu_torch.trainer.train_step at a ``sequence`` axis) against
the JAX package's single-device oracle, as tests/test_sequence_parallel.py
holds JAX's own sequence-parallel runs.

Every family (Llama, GPT, BERT, the MoE Llama) starts from the JAX
model's f32 init, carried across, and trains two AdamW(1e-3) steps on one
batch (4 rows of 32 tokens) on gloo CPU ranks, with ``attn_impl="ring"``
or ``"ulysses"``; the losses and grad norms must track the JAX trainer's
on one device with plain attention at rtol 2e-3, the tolerance of the
JAX tests. The compositions: sequence 2 alone, data 2 × sequence 2, fsdp
2 × sequence 2, tensor 2 × sequence 2 (every family but the MoE's; GPT
and BERT, whose tiny presets hold 2 heads, with the ring only: Ulysses
needs the heads to divide over both axes; the Llama also with the
reference norm, the configuration ROADMAP C17 refused), and
auto_accelerate's sequence_parallel pass over data 2 (as JAX's
test_sp_through_auto_accelerate_matches_oracle). The same launches hold
``mlm_loss``'s weighted count over shards and the host-staged
collectives over ``Mesh.lanes`` (staging forced for CPU tensors). One
gloo launch of 2 ranks and one of 4 run every case; chip_smoke's sp
phase is rehearsed on two CPU ranks of its own.
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
from dlrover_tpu.models import llama_moe as jlm
from dlrover_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dlrover_tpu.parallel.mesh import create_mesh as jcreate_mesh
from dlrover_tpu.trainer import train_step as jts
from dlrover_tpu_torch import convert
from test_torch_mesh import run_workers

BATCH, SEQ, STEPS, LR = 4, 32, 2, 1e-3
RTOL = 2e-3
FAMILIES = ("llama", "gpt", "bert", "moe")


def _jax_family(family):
    """(model, loss) of a tiny f32 JAX model with plain attention."""
    if family == "llama":
        cfg = jllama.LlamaConfig.tiny(attn_impl="reference",
                                      norm_impl="reference",
                                      dtype=jnp.float32)
        return jllama.Llama(cfg), jllama.cross_entropy_loss
    if family == "moe":
        cfg = jlm.LlamaMoEConfig.mixtral_tiny(attn_impl="reference",
                                              dtype=jnp.float32)
        return (jlm.LlamaMoE(cfg, deterministic=False),
                jllama.cross_entropy_loss)
    if family == "gpt":
        cfg = jgpt.GPTConfig.tiny(attn_impl="reference", dtype=jnp.float32)
        return jgpt.GPT(cfg), jllama.cross_entropy_loss
    cfg = jbert.BertConfig.tiny(attn_impl="reference", dtype=jnp.float32)
    return jbert.Bert(cfg), jbert.mlm_loss


def _batch(family):
    rng = np.random.default_rng(7)
    vocab = 128 if family in ("bert", "gpt") else 250
    tokens = rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32)
    targets = (tokens if family == "bert" else
               rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32))
    return tokens, targets


def _oracle_init(family, out_dir):
    """JAX's single-device trainer and its init, saved for the port with
    the batch."""
    model, loss_fn = _jax_family(family)
    mesh = jcreate_mesh(JMeshSpec(), jax.devices("cpu")[:1])
    trainer = jts.build_trainer(
        model, optax.adamw(LR), mesh, jnp.zeros((BATCH, SEQ), jnp.int32),
        loss_fn, accum_steps=1, micro_batch=BATCH)
    state = trainer.init(jax.random.PRNGKey(0))
    # GPT's and BERT's fused qkv goes over in the port's head-major layout
    heads = (getattr(model.config, "n_head", None)
             or getattr(model.config, "num_heads", None))
    torch.save(convert.params_from_jax(
        jax.tree.map(np.asarray, nn.unbox(state.params)), heads),
        os.path.join(out_dir, f"{family}.pt"))
    tokens, targets = _batch(family)
    np.savez(os.path.join(out_dir, f"{family}.npz"), tokens=tokens,
             targets=targets)
    return trainer, state


def _oracle(family, trainer, state):
    """JAX's (loss, grad_norm) a step."""
    tokens, targets = _batch(family)
    history = []
    for _ in range(STEPS):
        state, m = trainer.step(state, *trainer.shard_batch(tokens,
                                                            targets))
        history.append((float(m["loss"]), float(m["grad_norm"])))
    return history


WORKER = r'''
import functools, json, os, sys

import numpy as np
import torch

from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.models import bert, gpt, llama, llama_moe
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.trainer.train_step import build_trainer

init_distributed("cpu")
data_dir, cases = sys.argv[1], json.loads(sys.argv[2])
LR, STEPS = 1e-3, 2


def family(name, impl, norm="fused"):
    if name == "llama":
        # the fused norm (its plain version on the CPU), or the reference
        # norm, which the JAX oracle runs
        cfg = llama.LlamaConfig.tiny(attn_impl=impl, norm_impl=norm,
                                     dtype=torch.float32)
        return functools.partial(llama.Llama, cfg), llama.cross_entropy_loss
    if name == "moe":
        cfg = llama_moe.LlamaMoEConfig.mixtral_tiny(attn_impl=impl,
                                                    dtype=torch.float32)
        return (functools.partial(llama_moe.LlamaMoE, cfg,
                                  deterministic=False),
                llama.cross_entropy_loss)
    if name == "gpt":
        cfg = gpt.GPTConfig.tiny(attn_impl=impl, dtype=torch.float32)
        return functools.partial(gpt.GPT, cfg), llama.cross_entropy_loss
    cfg = bert.BertConfig.tiny(attn_impl=impl, dtype=torch.float32)
    return functools.partial(bert.Bert, cfg), bert.mlm_loss


def adamw(params):
    # optax.adamw's defaults
    return torch.optim.AdamW(params, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def trainer_of(case):
    factory, loss_fn = family(case["family"], case["impl"],
                              case.get("norm", "fused"))
    batch = np.load(os.path.join(data_dir, case["family"] + ".npz"))
    init = torch.load(os.path.join(data_dir, case["family"] + ".pt"))
    model = factory(device="cpu")
    model.load_state_dict(init, strict=True)
    if case.get("auto"):
        from dlrover_tpu_torch.auto.accelerate import auto_accelerate

        result = auto_accelerate(
            model, optim_factory=lambda: adamw, loss_fn=loss_fn,
            sample_batch=np.zeros(batch["tokens"].shape, np.int64),
            strategy=[("sequence_parallel", {"size": 2,
                                             "impl": case["impl"]}),
                      ("parallel_mode", {"data": 2})],
            micro_batch=batch["tokens"].shape[0],
            devices=["cpu"] * torch.distributed.get_world_size())
        assert result.context.model_config().attn_impl == case["impl"]
        return result.trainer, batch
    mesh = create_mesh(MeshSpec(**case["spec"]), device="cpu")
    trainer = build_trainer(
        model, adamw, mesh, np.zeros(batch["tokens"].shape, np.int64),
        loss_fn, micro_batch=batch["tokens"].shape[0])
    return trainer, batch


out = []
for case in cases:
    trainer, batch = trainer_of(case)
    state = trainer.init(0)
    tok, tgt = trainer.shard_batch(batch["tokens"], batch["targets"])
    history = []
    for _ in range(STEPS):
        state, m = trainer.step(state, tok, tgt)
        history.append([m["loss"].item(), m["grad_norm"].item()])
    out.append({"shard": list(tok.shape), "history": history})
# the host-staged all-reduce spread over Mesh.lanes (staging forced for
# CPU tensors: on the card it is gloo's path for CUDA tensors)
from dlrover_tpu_torch.parallel import collectives
mesh = create_mesh(MeshSpec(sequence=2), device="cpu")
lanes = mesh.lanes(("sequence",), 3)
collectives.host_staged = lambda group, tensors: True
collectives.STAGE_ELEMENTS = 7
group = mesh.submesh(["sequence"]).get_group()
collectives.set_lanes(group, lanes)
rank = torch.distributed.get_rank()
x = torch.arange(10, dtype=torch.float32) * (rank + 1)
collectives.all_reduce_([x, x[:0] + 1], group)
y = torch.arange(7, dtype=torch.float32) + 100 * rank
shifted = collectives.shift([y, y[:3]], group)
back = collectives.shift(shifted, group, back=True)
z = torch.arange(10, dtype=torch.float32).view(2, 5) + 100 * rank
# mlm_loss with weights on sequence shards: the mean over the axis of the
# shards' losses is the whole rows' weighted mean
from dlrover_tpu_torch.parallel.mesh import use_mesh
gen = torch.Generator().manual_seed(5)
logits = torch.randn(2, 8, 16, generator=gen)
targets = torch.randint(0, 16, (2, 8), generator=gen)
weights = (torch.rand(2, 8, generator=gen) < 0.3).float()
weights[0, :4] = 1.0             # the shards hold different counts
width = 8 // 2
mine = slice(group.rank() * width, (group.rank() + 1) * width)
with use_mesh(mesh):
    shard = bert.mlm_loss(logits[:, mine], targets[:, mine],
                          weights[:, mine])
total = shard.detach().clone()
torch.distributed.all_reduce(total, group=group)
mlm = [total.item() / 2, bert.mlm_loss(logits, targets, weights).item()]
print(json.dumps({"cases": out, "mlm": mlm, "lanes": [
    len(lanes), x.tolist(), [t.tolist() for t in shifted],
    [t.tolist() for t in back],
    collectives.all_to_all(z, group).tolist(),
    collectives.all_gather(y, group).tolist()]}))
'''


def _cases(world):
    """The compositions a launch of ``world`` ranks trains."""
    if world == 2:
        return [dict(family=f, impl=impl, spec={"sequence": 2})
                for f in FAMILIES for impl in ("ring", "ulysses")]
    cases = []
    for spec in ({"data": 2, "sequence": 2}, {"fsdp": 2, "sequence": 2},
                 {"tensor": 2, "sequence": 2}):
        cases += [dict(family=f, impl=impl, spec=spec)
                  for f in ("llama", "gpt", "bert")
                  for impl in ("ring", "ulysses")
                  # 2 heads do not divide over sequence × tensor = 4
                  if not ("tensor" in spec and f != "llama"
                          and impl == "ulysses")]
    # ROADMAP C17: the reference norm under a tensor axis
    cases += [dict(family="llama", impl="ring", norm="reference",
                   spec={"tensor": 2, "sequence": 2})]
    cases += [dict(family="moe", impl="ring", spec={"data": 2,
                                                    "sequence": 2})]
    cases += [dict(family="llama", impl=impl, auto=True, spec={})
              for impl in ("ring", "ulysses")]
    return cases


def _case_id(case):
    spec = "x".join(f"{k}{v}" for k, v in case["spec"].items())
    norm = f"-{case['norm']}-norm" if "norm" in case else ""
    return (f"{case['family']}-{case['impl']}-"
            f"{'auto' if case.get('auto') else spec}{norm}")


# the C17 case is its own test's (below)
ALL_CASES = [(2, c) for c in _cases(2)] + [(4, c) for c in _cases(4)
                                           if "norm" not in c]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracles and each launch's per-rank results: the launches
    train while JAX does."""
    data_dir = tmp_path_factory.mktemp("sp_data")
    inits = {f: _oracle_init(f, str(data_dir)) for f in FAMILIES}

    def launch(world):
        return run_workers(tmp_path_factory.mktemp(f"sp{world}"), WORKER,
                           world, args=(str(data_dir),
                                        json.dumps(_cases(world))),
                           timeout=240, name=f"sp{world}")

    with ThreadPoolExecutor(1) as pool:
        launches = {world: pool.submit(launch, world) for world in (2, 4)}
        oracles = {f: _oracle(f, *inits[f]) for f in FAMILIES}
        results = {}
        for world, future in launches.items():
            ranks = future.result()
            for i, case in enumerate(_cases(world)):
                results[(world, _case_id(case))] = [
                    r["cases"][i] for r in ranks]
            results[(world, "lanes")] = [r["lanes"] for r in ranks]
            results[(world, "mlm")] = [r["mlm"] for r in ranks]
    return oracles, results


@pytest.mark.parametrize("world", [2, 4])
def test_weighted_mlm_loss_over_sequence_shards_is_the_whole_rows(runs,
                                                                  world):
    """``mlm_loss`` with weights on a sequence shard counts the whole
    rows' weighted positions (the shards hold different counts), so the
    mean of the shards' losses over the axis, the trainer's loss, is the
    whole rows' weighted mean, not a mean of shard means."""
    _, results = runs
    for over_shards, whole in results[(world, "mlm")]:
        np.testing.assert_allclose(over_shards, whole, rtol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_staged_all_reduce_over_lanes_sums_the_sequence_group(runs, world):
    """``Mesh.lanes`` gives each rank three more groups of its sequence
    group's ranks; the host-staged collectives (forced for CPU tensors)
    split over them: the all-reduce (in buffers of 7 elements) sums over
    that group alone, the shift brings the other member's tensors and
    shifting back restores one's own, the all-to-all and the all-gather
    deliver each member's parts in member order."""
    _, results = runs
    for rank, got in enumerate(results[(world, "lanes")]):
        count, summed, shifted, back, swapped, gathered = got
        group = [rank - rank % 2, rank - rank % 2 + 1]
        other = group[1 - rank % 2]
        assert count == 3
        assert summed == [float(i * sum(r + 1 for r in group))
                          for i in range(10)]
        mine = [float(i + 100 * rank) for i in range(7)]
        theirs = [float(i + 100 * other) for i in range(7)]
        assert shifted == [theirs, theirs[:3]]
        assert back == [mine, mine[:3]]
        me = rank % 2
        assert swapped == [[float(me * 5 + i + 100 * r) for i in range(5)]
                           for r in group]
        assert gathered == [[float(i + 100 * r) for i in range(7)]
                            for r in group]


def test_reference_norm_under_a_tensor_axis_is_refused_as_c17(runs):
    """ROADMAP Queue C17, repaired: the Llama with the reference norm
    (the JAX oracle's) at tensor 2 × sequence 2 with the ring trains and
    tracks the JAX oracle as every case does. It was refused while
    DTensor left the row-parallel products' pending sum in the residual
    stream, which the attention's ``local_map`` took from the norm; the
    sum is now reduced at each projection's output and the column-
    parallel inputs' gradients where they fan in
    (``parallel/sharding.py``), as JAX's SPMD places them."""
    oracles, results = runs
    case = next(c for c in _cases(4) if c.get("norm") == "reference")
    want = np.asarray(oracles["llama"])
    ranks = results[(4, _case_id(case))]
    for rank in ranks:
        got = np.asarray(rank["history"])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=RTOL)
        np.testing.assert_array_equal(got, np.asarray(ranks[0]["history"]))


def test_chip_smoke_sp_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's sp phase with the tiny Llama on two CPU ranks: (a) the
    ring and Ulysses over the flash path (the kernels' plain versions
    here) within the flash tolerance of one process's and of the plain
    ring's, (b) three steps of each at sequence 2 within the parity
    limits of one process's, (c) the quantized mean bit for bit with
    itself on CPU copies and within the bound, (d) the tiny GPT and BERT
    at tensor 2 (bf16, the head-major qkv: one whole head a rank), three
    steps each within (b)'s limits of one process's, their q, k and v
    sharded over heads with no collective, (e) the tiny Llama over a dcn
    axis of the two ranks, its mean over dcn quantized to int8, three
    steps within (b)'s limits of one process's exact run; the phase
    checks each (the launches and their shapes only on the card)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    spec = chip_smoke.sp_spec("cpu")
    # the ranks' torch threads, one each, as run_workers gives them
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    workers = chip_smoke._sp_workers(str(tmp_path), spec)
    out = chip_smoke.phase_sp("cpu rehearsal", workers, spec)
    assert set(out["launches"].values()) == {0}
    assert set(out["part_s"]) == {"a", "c", "wait", "b", "d", "e"}


@pytest.mark.parametrize("world,case", ALL_CASES,
                         ids=[f"{w}-{_case_id(c)}" for w, c in ALL_CASES])
def test_sequence_parallel_training_tracks_the_jax_oracle(runs, world,
                                                          case):
    oracles, results = runs
    ranks = results[(world, _case_id(case))]
    want = np.asarray(oracles[case["family"]])
    spec = case["spec"] or {"data": 2, "sequence": 2}
    rows = BATCH // (spec.get("data", 1) * spec.get("fsdp", 1))
    for rank in ranks:
        # each rank trained on its columns of its rows
        assert rank["shard"] == [1, rows, SEQ // spec["sequence"]]
        got = np.asarray(rank["history"])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=RTOL)
        # every rank reports the same (global) metrics
        np.testing.assert_array_equal(got, np.asarray(ranks[0]["history"]))
