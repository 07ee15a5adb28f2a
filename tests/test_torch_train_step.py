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
                                    weight_decay=WD),
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
        model, functools.partial(torch.optim.AdamW, lr=LR),
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
