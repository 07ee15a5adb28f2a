"""The port's build_trainer (dlrover_tpu_torch.trainer.train_step) against
the JAX package's on one CPU device: the same LlamaConfig.tiny in f32,
the same initial parameters (JAX's, carried across), the same numpy
batches, AdamW(lr, weight_decay=0.1) on both sides.

Tolerances. Loss and grad-norm: 1e-4 relative, f32 sums in another
order. Parameters: Adam's update is lr·m̂/(√v̂+eps), nearly lr·sign(g)
on the first steps, so an element whose gradient is within f32 noise of
zero can move by up to 2·lr the other way in one framework. The check
is therefore two-part: every element within 2·lr·steps (what a sign
flip each step could cost), and all but a few in 100,000 within 1e-6
(the f32 arithmetic itself; measured here: at most 2 of 106,816 elements
outside it, by at most 7e-6).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu.trainer import train_step as jts
from dlrover_tpu_torch import convert
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.trainer import train_step as tts

LR, WD, SEQ, MICRO = 1e-3, 0.1, 32, 2
CLOSE_ATOL = 1e-6
MAX_FAR_FRACTION = 5e-5


def _batch(accum, seed):
    rng = np.random.default_rng(seed)
    shape = (accum * MICRO, SEQ)
    return (rng.integers(0, 256, shape, dtype=np.int32),
            rng.integers(0, 256, shape, dtype=np.int32))


def _flat(params):
    return convert.params_from_jax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("accum", [1, 2])
def test_steps_match_jax(accum):
    jcfg = jllama.LlamaConfig.tiny(attn_impl="reference", dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(attn_impl="flash", dtype=torch.float32)
    mesh = create_mesh(MeshSpec(), jax.devices("cpu")[:1])
    jtrainer = jts.build_trainer(
        jllama.Llama(jcfg), optax.adamw(LR, weight_decay=WD), mesh,
        jnp.zeros((MICRO, SEQ), jnp.int32), jllama.cross_entropy_loss,
        accum_steps=accum, micro_batch=MICRO)
    jstate = jtrainer.init(jax.random.PRNGKey(0))

    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(_flat(jstate.params))
    ttrainer = tts.build_trainer(
        model,
        lambda p: torch.optim.AdamW(p, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=WD), None,
        np.zeros((MICRO, SEQ), np.int64), tllama.cross_entropy_loss,
        accum_steps=accum, micro_batch=MICRO, device="cpu")
    tstate = ttrainer.init(0)

    for step in (1, 2):
        tokens, targets = _batch(accum, seed=step)
        jstate, jm = jtrainer.step(jstate, *jtrainer.shard_batch(tokens,
                                                                 targets))
        tstate, tm = ttrainer.step(tstate, *ttrainer.shard_batch(tokens,
                                                                 targets))
        assert tstate.step == step == int(jstate.step)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        want = _flat(jstate.params)
        got = tstate.model.state_dict()
        far = total = 0
        for key, w in want.items():
            diff = (got[key] - w).abs()
            assert diff.max().item() <= 2 * LR * step + 1e-6, key
            far += int((diff > CLOSE_ATOL).sum())
            total += diff.numel()
        assert far <= MAX_FAR_FRACTION * total, (far, total)


def test_shard_batch_shape_and_device():
    model = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu")
    trainer = tts.build_trainer(
        model, functools.partial(torch.optim.AdamW, lr=LR), None,
        np.zeros((MICRO, SEQ)), tllama.cross_entropy_loss, accum_steps=3,
        micro_batch=MICRO, device="cpu")
    tok, tgt = trainer.shard_batch(*_batch(3, seed=0))
    assert tok.shape == tgt.shape == (3, MICRO, SEQ)
    assert tok.dtype == torch.int64 and tok.device.type == "cpu"


@pytest.mark.parametrize("global_batch,dp,max_micro", [
    (8, 1, 8), (8, 1, 3), (12, 2, 4), (16, 4, 1), (7, 1, 2)])
def test_choose_accumulation_matches_jax(global_batch, dp, max_micro):
    assert (tts.choose_accumulation(global_batch, dp, max_micro)
            == jts.choose_accumulation(global_batch, dp, max_micro))


# ---------------------------------------------------------------------------
# the sharded step, split_grad_apply and offload_opt_state
# ---------------------------------------------------------------------------

SHARDED_WORKER = """
import json, sys
import numpy as np
import torch
from torch.distributed.tensor import DTensor
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.trainer.train_step import build_trainer

torch.set_num_threads(1)
init_distributed("cpu")
spec, init_path, batch_path, accum = (json.loads(sys.argv[1]), sys.argv[2],
                                      sys.argv[3], int(sys.argv[4]))
init = {k: torch.from_numpy(v) for k, v in np.load(init_path).items()}
batches = np.load(batch_path)
cfg = LlamaConfig.tiny(attn_impl="flash", dtype=torch.float32)

def model(device, seed):
    m = Llama(cfg, device=device, seed=seed)
    if torch.device(device).type != "meta":
        m.load_state_dict(init)
    return m

mesh = create_mesh(MeshSpec(**spec), "cpu")

def run(**kw):
    trainer = build_trainer(
        model, lambda p: torch.optim.AdamW(p, lr=1e-3, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=0.1),
        mesh, np.zeros((batches.shape[1] // accum, batches.shape[2])),
        cross_entropy_loss, accum_steps=accum,
        micro_batch=batches.shape[1] // accum, **kw)
    state = trainer.init(0)
    losses, norms = [], []
    for tokens in batches:
        tok, tgt = trainer.shard_batch(tokens, tokens[:, ::-1])
        if kw.get("split_grad_apply"):
            grads, m = trainer.grad_step(state, tok, tgt)
            state, m2 = trainer.apply_grads(state, grads)
            m.update(m2)
        else:
            state, m = trainer.step(state, tok, tgt)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    params = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
              for n, p in state.model.named_parameters()}
    return losses, norms, params

losses, norms, params = run()
split = run(split_grad_apply=True)
offload = run(offload_opt_state=True)
same = lambda other: (other[0] == losses and other[1] == norms and all(
    torch.equal(params[n], other[2][n]) for n in params))
print(json.dumps({"losses": losses, "grad_norms": norms,
                  "split_same_bits": same(split),
                  "offload_same_bits": same(offload)}))
"""


@pytest.mark.parametrize("spec,world,accum", [
    (dict(data=2, tensor=2), 4, 1), (dict(fsdp=2), 2, 2),
    (dict(dcn=2, fsdp=2), 4, 1)])
def test_sharded_steps_match_jax(tmp_path, cpu_devices, spec, world, accum):
    """World 4 (data 2 × tensor 2: DTensor TP + HSDP), world 2 (FSDP2
    over fsdp 2, two micro-batches) and world 4 (dcn 2 × fsdp 2: HSDP
    with dcn as the replicate dim, where JAX reduces hierarchically) from
    JAX's init, against JAX's build_trainer on the same mesh shapes:
    losses and grad norms within 1e-4, the same on every rank. In the
    same workers, grad_step + apply_grads and the offloaded optimizer
    give the same bits as step."""
    from test_torch_mesh import run_workers

    micro = 4
    jcfg = jllama.LlamaConfig.tiny(attn_impl="reference", dtype=jnp.float32)
    mesh = create_mesh(MeshSpec(**spec), cpu_devices[:world])
    jtrainer = jts.build_trainer(
        jllama.Llama(jcfg), optax.adamw(LR, weight_decay=WD), mesh,
        jnp.zeros((micro, SEQ), jnp.int32), jllama.cross_entropy_loss,
        accum_steps=accum, micro_batch=micro)
    jstate = jtrainer.init(jax.random.PRNGKey(0))
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in
                                       _flat(jstate.params).items()})
    rng = np.random.default_rng(7)
    batches = rng.integers(0, 256, (2, accum * micro, SEQ), dtype=np.int32)
    np.save(tmp_path / "batches.npy", batches)
    want_loss, want_norm = [], []
    for tokens in batches:
        jstate, jm = jtrainer.step(jstate, *jtrainer.shard_batch(
            tokens, np.ascontiguousarray(tokens[:, ::-1])))
        want_loss.append(float(jm["loss"]))
        want_norm.append(float(jm["grad_norm"]))
    out = run_workers(tmp_path, SHARDED_WORKER, world, args=(
        json.dumps(spec), tmp_path / "init.npz", tmp_path / "batches.npy",
        accum))
    for r in out:
        assert r["losses"] == out[0]["losses"]
        assert r["grad_norms"] == out[0]["grad_norms"]
        np.testing.assert_allclose(r["losses"], want_loss, rtol=1e-4)
        np.testing.assert_allclose(r["grad_norms"], want_norm, rtol=1e-4)
        assert r["split_same_bits"] and r["offload_same_bits"]


def _tiny_trainer(**kw):
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    return tts.build_trainer(
        functools.partial(tllama.Llama, cfg),
        lambda p: torch.optim.AdamW(p, lr=LR, weight_decay=WD), None,
        np.zeros((MICRO, SEQ)), tllama.cross_entropy_loss, accum_steps=2,
        micro_batch=MICRO, device="cpu", **kw)


def _three_steps(trainer, split=False):
    state = trainer.init(0)
    out = []
    for step in range(3):
        tok, tgt = trainer.shard_batch(*_batch(2, seed=step))
        if split:
            grads, m = trainer.grad_step(state, tok, tgt)
            assert all(g.dtype == torch.float32 for g in grads.values())
            state, m2 = trainer.apply_grads(state, grads)
            m = {**m, **m2}
        else:
            state, m = trainer.step(state, tok, tgt)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out, state


def test_grad_step_and_apply_grads_give_the_bits_of_step():
    want, state = _three_steps(_tiny_trainer())
    got, split_state = _three_steps(_tiny_trainer(split_grad_apply=True),
                                    split=True)
    assert got == want
    for a, b in zip(state.model.parameters(), split_state.model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="split_grad_apply"):
        _tiny_trainer().grad_step(state, None, None)


def test_offloaded_moments_give_the_same_bits_and_live_on_the_host():
    want, state = _three_steps(_tiny_trainer())
    trainer = _tiny_trainer(offload_opt_state=True)
    got, off_state = _three_steps(trainer)
    assert got == want
    for a, b in zip(state.model.parameters(), off_state.model.parameters()):
        assert torch.equal(a, b)
    moments = [v for s in off_state.optimizer.state.values()
               for v in s.values() if v.ndim > 0]
    assert len(moments) == 2 * len(list(off_state.model.parameters()))
    # between steps each moment is its host buffer, not a device copy
    buffers = {t.data_ptr() for t in trainer._host.values()}
    assert all(v.data_ptr() in buffers for v in moments)


def test_abstract_state_and_precompile_on_cpu():
    trainer = _tiny_trainer()
    state = trainer.abstract_state()
    shapes = {n: p.shape for n, p in trainer.init(0).model.named_parameters()}
    assert {n: p.shape for n, p in state.model.named_parameters()} == shapes
    assert not any(p.is_meta for p in state.model.parameters())
    for p in state.model.parameters():
        assert set(state.optimizer.state[p]) == {"step", "exp_avg",
                                                 "exp_avg_sq"}
    trainer.precompile()
    assert trainer.precompile_timings["build_s"] >= 0
    assert trainer.libraries == ("flash_attention", "norms")
    tok, tgt = trainer.shard_batch(*_batch(2, seed=0))
    trainer.step(trainer.init(0), tok, tgt)
    assert trainer.last_step_dispatch_s > 0 and trainer.last_shard_batch_s > 0


@pytest.mark.parametrize("spec,kw,exc", [
    # a sequence axis needs the ring or Ulysses attention (the tiny Llama
    # runs flash)
    (dict(sequence=2), {}, ValueError),
    # 4 experts (the MoE tiny model) over 3 expert ranks
    (dict(expert=3), dict(moe=True), ValueError),
    (dict(pipe=2), {}, NotImplementedError),
    # the quantized reduce over a dcn axis (slice mode, 6.4) builds: its
    # mean is the explicit one (tests/test_torch_slice_domains.py)
    (dict(dcn=2), dict(grad_reduce_bits=8), None),
    (dict(), dict(grad_reduce_bits=3), ValueError),
    (dict(tensor=4), {}, ValueError),        # 2 kv heads over 4 ranks
    (dict(data=3), {}, ValueError),          # micro 2 over 3 ranks
])
def test_unported_axes_and_unsplittable_shapes_raise(spec, kw, exc):
    from dlrover_tpu_torch.models import llama_moe as tlm
    from dlrover_tpu_torch.parallel import mesh as tmesh

    resolved = tmesh.MeshSpec(**spec)
    resolved = resolved.with_total_devices(
        resolved.total if resolved.data else resolved.total)
    mesh = tmesh.Mesh(resolved, torch.device("cpu"))
    kw = dict(kw)
    model = (functools.partial(tlm.LlamaMoE,
                               tlm.LlamaMoEConfig.mixtral_tiny())
             if kw.pop("moe", False) else
             functools.partial(tllama.Llama, tllama.LlamaConfig.tiny()))
    build = functools.partial(
        tts.build_trainer, model, functools.partial(torch.optim.AdamW,
                                                    lr=LR), mesh,
        np.zeros((MICRO, SEQ)), tllama.cross_entropy_loss,
        micro_batch=MICRO, **kw)
    if exc is None:
        assert build()._explicit_axis == "dcn"
        return
    with pytest.raises(exc):
        build()
