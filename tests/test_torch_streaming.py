"""The port's streaming per-layer step (dlrover_tpu_torch/trainer/
streaming.py) against the JAX package's build_streaming_trainer, against
the port's own dense step, and under ElasticTrainLoop, on the CPU.

The JAX side starts from its dense trainer's init repacked as its test
does (tests/test_streaming.py), and the port from that state carried
across by ``convert.streaming_state_from_jax``; one step each on the
same seeded batch, held with the JAX test's own limits: the loss within
1e-5 relative, every parameter within 2e-4 relative and 2e-6 absolute.
The port's streaming step against its dense step (the same LeafOptimizer
update) is held to the same limits; a resume through the loop trains the
uninterrupted run's bits.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models.llama import Llama as JLlama
from dlrover_tpu.models.llama import cross_entropy_loss as j_xent
from dlrover_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dlrover_tpu.parallel.mesh import create_mesh as j_create_mesh
from dlrover_tpu.trainer.streaming import build_streaming_trainer as j_build
from dlrover_tpu.trainer.train_step import build_trainer as j_build_dense
from dlrover_tpu_torch import convert, optim
from dlrover_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    cross_entropy_loss,
)
from dlrover_tpu_torch.trainer.elastic_loop import (
    ElasticTrainLoop,
    TrainLoopConfig,
)
from dlrover_tpu_torch.trainer.streaming import (
    StreamingState,
    build_streaming_trainer,
)
from dlrover_tpu_torch.trainer.train_step import build_trainer
from test_streaming import _dense_to_streaming, _tiny_cfg

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-6)
MICRO, SEQ, LR = 2, 16, 1e-2


def _port_cfg(tied: bool) -> LlamaConfig:
    """``_tiny_cfg`` of tests/test_streaming.py, in the port."""
    return LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=3,
        num_heads=4, num_kv_heads=4, max_seq_len=16,
        attn_impl="reference", norm_impl="reference", embed_impl="gather",
        dtype=torch.float32, param_dtype=torch.float32,
        tie_embeddings=tied)


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (MICRO, SEQ), np.int32),
            rng.integers(0, vocab, (MICRO, SEQ), np.int32))


def _port_state(trainer, step, params, opt_state) -> StreamingState:
    """A port streaming state holding the carried parameters and each
    one's optimizer state."""
    state = trainer.init(0)
    state.model.load_state_dict(params, strict=True)
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = opt_state[name]
    state.step = step
    return state


# min_dim_size_to_factor 128 (the JAX test's optimizer) leaves every
# tiny leaf unfactored; 16 factors the 2-D ones (v_row and v_col)
@pytest.mark.parametrize("min_dim", [128, 16])
@pytest.mark.parametrize("tied", [False, True])
def test_streaming_step_matches_jax(tied, min_dim):
    jcfg = _tiny_cfg(tie_embeddings=tied)
    tx = optax.chain(
        optax.scale_by_factored_rms(min_dim_size_to_factor=min_dim),
        optax.scale(-LR))
    mesh = j_create_mesh(JMeshSpec(), jax.devices()[:1])
    dense = j_build_dense(JLlama(jcfg), tx, mesh,
                          jnp.zeros((MICRO, SEQ), jnp.int32), j_xent,
                          accum_steps=1, micro_batch=MICRO)
    jstate = _dense_to_streaming(dense.init(jax.random.PRNGKey(0)), jcfg,
                                 tx)
    carried = convert.streaming_state_from_jax(
        jax.tree.map(np.asarray, jstate))
    tokens, targets = _batch(jcfg.vocab_size)
    jnew, jmetrics = j_build(jcfg, tx, MICRO, SEQ).step(
        jstate, jnp.asarray(tokens), jnp.asarray(targets))

    trainer = build_streaming_trainer(
        _port_cfg(tied), optim.factored_rms(LR,
                                            min_dim_size_to_factor=min_dim),
        MICRO, device="cpu")
    state = _port_state(trainer, *carried)
    state, metrics = trainer.step(state, *trainer.shard_batch(tokens,
                                                               targets))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=LOSS_RTOL)
    assert state.step == 1 == int(jnew.step)
    _, want, want_opt = convert.streaming_state_from_jax(
        jax.tree.map(np.asarray, jnew))
    got = dict(state.model.named_parameters())
    assert got.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   value.numpy(), err_msg=name, **PARAM_TOL)
        leaf = state.optimizer.state[got[name]]
        assert int(leaf["count"]) == int(want_opt[name]["count"]) == 1
        for key in convert.FACTORED_KEYS:
            # second moments of the gradients: twice their relative
            # error, on a floor of 1e-4 of the leaf's largest
            want_v = want_opt[name][key].numpy()
            np.testing.assert_allclose(
                leaf[key].numpy(), want_v, rtol=2 * PARAM_TOL["rtol"],
                atol=1e-4 * np.abs(want_v).max(), err_msg=f"{name}.{key}")


def test_params_view_follows_jax():
    cfg = _port_cfg(tied=False)
    trainer = build_streaming_trainer(cfg, optim.factored_rms(LR), MICRO,
                                      device="cpu")
    view = trainer.init(0).params
    jview = j_build(_tiny_cfg(), optax.chain(
        optax.scale_by_factored_rms(), optax.scale(-LR)), MICRO, SEQ
    ).abstract_state(jax.random.PRNGKey(0)).params
    jview = nn.unbox(jview)
    assert view.keys() == jview.keys()
    assert len(view["blocks"]) == cfg.num_layers
    block_leaves = {path: leaf.shape[1:] for path, leaf in
                    convert._flat(jview["blocks"]).items()}
    assert {n: tuple(p.shape) for n, p in view["blocks"][0].items()} \
        == block_leaves
    assert tuple(view["embed"].shape) == jview["embed"].shape
    assert tuple(view["head"].shape) == jview["head"].shape
    assert view["norm"].keys() == jview["norm"].keys()
    tied = build_streaming_trainer(_port_cfg(tied=True),
                                   optim.factored_rms(LR), MICRO,
                                   device="cpu")
    assert tied.init(0).params["head"] is None


@pytest.mark.parametrize("tied", [False, True])
def test_streaming_step_matches_the_dense_step(tied):
    cfg = _port_cfg(tied)
    transform = optim.factored_rms(LR, min_dim_size_to_factor=16)
    streaming = build_streaming_trainer(cfg, transform, MICRO,
                                        device="cpu")
    dense = build_trainer(functools.partial(Llama, cfg),
                          functools.partial(optim.LeafOptimizer,
                                            transform=transform),
                          None, np.zeros((MICRO, SEQ)), cross_entropy_loss,
                          micro_batch=MICRO, device="cpu")
    s_state, d_state = streaming.init(0), dense.init(0)
    for seed in range(3):
        batch = _batch(cfg.vocab_size, seed)
        s_state, s_metrics = streaming.step(s_state,
                                            *streaming.shard_batch(*batch))
        d_state, d_metrics = dense.step(d_state, *dense.shard_batch(*batch))
        np.testing.assert_allclose(float(s_metrics["loss"]),
                                   float(d_metrics["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(s_metrics["grad_norm"]),
                                   float(d_metrics["grad_norm"]),
                                   rtol=LOSS_RTOL)
    for (name, p), q in zip(s_state.model.named_parameters(),
                            d_state.model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   err_msg=name, **PARAM_TOL)


def test_cross_leaf_optimizers_and_accumulation_are_refused():
    cfg = _port_cfg(tied=False)
    with pytest.raises(TypeError, match="per leaf"):
        build_streaming_trainer(
            cfg, lambda p: torch.optim.AdamW(p, lr=1e-3), MICRO,
            device="cpu")
    with pytest.raises(TypeError, match="per leaf"):
        build_streaming_trainer(
            cfg, optax.chain(optax.clip_by_global_norm(1.0),
                             optax.scale_by_factored_rms()),
            MICRO, device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        build_streaming_trainer(cfg, optim.factored_rms(LR), MICRO,
                                accum_steps=2, device="cpu")


def _loop(trainer, tmp_path, steps, save_interval=2):
    return ElasticTrainLoop(
        None, None, None,
        TrainLoopConfig(global_batch=MICRO, seq_len=SEQ,
                        max_micro_per_replica=MICRO, max_steps=steps,
                        checkpoint_dir=str(tmp_path),
                        save_interval_steps=save_interval,
                        report_interval_steps=0),
        trainer=trainer)


def _data(vocab, count, start=0):
    batches = [_batch(vocab, seed) for seed in range(start + count)]
    return iter(batches[start:])


def test_loop_saves_and_resumes_the_streaming_trainer(tmp_path):
    """The streaming trainer through ElasticTrainLoop(trainer=...): 4
    uninterrupted steps, against 2 steps with a save at 2, a rebuilt
    loop restoring it (the optimizer's int32 counts and f32 state
    included) and 2 more steps: the same losses and parameters, bit for
    bit."""
    cfg = _port_cfg(tied=True)

    def trainer():
        return build_streaming_trainer(
            cfg, optim.factored_rms(LR, min_dim_size_to_factor=16), MICRO,
            device="cpu")

    whole = _loop(trainer(), tmp_path / "whole", 4, save_interval=0)
    state, start = whole.restore_or_init(0)
    assert start == 0 and isinstance(state, StreamingState)
    state, ref = whole.run(state, _data(cfg.vocab_size, 4))
    whole.close()
    assert whole._param_count == cfg.param_count()

    first = _loop(trainer(), tmp_path / "ckpt", 2)
    s1, _ = first.restore_or_init(0)
    s1, m1 = first.run(s1, _data(cfg.vocab_size, 2))
    first.close()
    second = _loop(trainer(), tmp_path / "ckpt", 2)
    s2, start = second.restore_or_init(0)
    assert start == 2 and second.last_restore_source == "checkpoint"
    for p in s2.model.parameters():
        assert s2.optimizer.state[p]["count"].dtype == torch.int32
        assert int(s2.optimizer.state[p]["count"]) == 2
    s2, m2 = second.run(s2, _data(cfg.vocab_size, 2, start=2),
                        start_step=start)
    second.close()
    losses = [r["loss"] for r in m1["history"] + m2["history"]]
    assert losses == [r["loss"] for r in ref["history"]]
    for (name, p), q in zip(state.model.named_parameters(),
                            s2.model.parameters()):
        assert torch.equal(p, q), name


def test_loop_refuses_a_trainer_of_another_batch(tmp_path):
    trainer = build_streaming_trainer(_port_cfg(tied=False),
                                      optim.factored_rms(LR), MICRO,
                                      device="cpu")
    with pytest.raises(ValueError, match="global batch"):
        ElasticTrainLoop(None, None, None,
                         TrainLoopConfig(global_batch=2 * MICRO,
                                         seq_len=SEQ),
                         trainer=trainer)
