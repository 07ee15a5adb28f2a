"""The port's MoE family (dlrover_tpu_torch/parallel/moe.py,
models/llama_moe.py) against the JAX package's, on the CPU.

The same inputs, made from a numpy seed, go through the JAX function and
the port's, with the JAX parameters carried across by
dlrover_tpu_torch.convert. Routing is exact: dispatch masks equal, and
the combine weights and aux loss within 1e-6 (the same f32 softmax). f32
layers and models within 2e-5 (outputs and gradients of magnitude ~1:
the same products summed in another order); bf16 layers hold the
rounding points too, relative L2 within 2^-6 and every element within
2^-5 + 2^-5·|want| (the two frameworks round the bf16 expert products and
GELU from f32 sums taken in another order). bf16 is held at the layer,
where both get the same input: across a whole bf16 model the inputs of a
router differ by bf16 rounding, and a token whose top experts nearly tie
can take another one (3 of 32 tokens of the tiny model at seed 11, and
the tokens queued behind it move), which is routing, not error. Three
training steps under Adafactor with 2 micro-steps, and the expert axis
on gloo ranks (each rank holds E/2 experts), hold losses, grad norms and
parameters within 1e-4.
"""

import dataclasses
import functools
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import llama_moe as jlm
from dlrover_tpu.parallel import moe as jmoe
from dlrover_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dlrover_tpu.parallel.mesh import create_mesh as jcreate_mesh
from dlrover_tpu.trainer import elastic_loop as jloop
from dlrover_tpu.trainer import train_step as jts
from dlrover_tpu_torch import convert, optim
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import llama_moe as tlm
from dlrover_tpu_torch.parallel import moe as tmoe
from dlrover_tpu_torch.trainer import train_step as tts
from test_torch_mesh import run_workers

GATE_TOL = 1e-6
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_REL_L2 = 2.0 ** -6
BF16_ATOL = 2.0 ** -5
TRAIN_TOL = dict(atol=1e-4, rtol=1e-4)
LR, SEQ, MICRO, ACCUM = 1e-2, 16, 4, 2


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)


def _assert_bf16_close(got, want, what):
    got, want = _np(got), _np(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL_L2, f"{what}: relative L2 {rel}"
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_ATOL,
                               err_msg=what)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(16, 4, 1.25, 4), (2048, 8, 1.25, 4),
                                  (7, 8, 1.0, 4), (128, 8, 2.0, 4),
                                  (100, 3, 0.5, 1)])
def test_capacity_matches_jax(args):
    assert tmoe._capacity(*args) == jmoe._capacity(*args)


def _seeded_logits():
    return np.random.default_rng(0).standard_normal(
        (2, 16, 4)).astype(np.float32)


def _overflow_logits():
    logits = np.zeros((1, 8, 4), np.float32)
    logits[:, :, 0] = 10.0
    return logits


def _tie_logits():
    # every token ties between experts 1 and 2, and the rest tie at 0
    logits = np.zeros((2, 12, 4), np.float32)
    logits[:, :, 1:3] = 1.0
    logits[1, ::3] = 0.0
    return logits


@pytest.mark.parametrize("case", [
    ("seeded", _seeded_logits, 2, 3),
    ("seeded_top1", _seeded_logits, 1, 4),
    ("overflow", _overflow_logits, 1, 2),
    ("overflow_top2", _overflow_logits, 2, 2),
    ("uniform", lambda: np.zeros((1, 64, 8), np.float32), 1, 64),
    ("ties", _tie_logits, 2, 4),
], ids=lambda c: c[0])
def test_gating_matches_jax(case):
    """The JAX gating tests' cases (tests/test_moe.py) and ties: the same
    slots, and ties to the lowest expert index in both."""
    _, make, top_k, capacity = case
    logits = make()
    jd, jc, ja = jmoe.top_k_gating(jnp.asarray(logits), top_k, capacity)
    td, tc, ta = tmoe.top_k_gating(torch.from_numpy(logits), top_k,
                                   capacity)
    assert td.dtype == torch.bool and tc.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=GATE_TOL,
                               rtol=0)
    np.testing.assert_allclose(ta.item(), float(ja), atol=GATE_TOL, rtol=0)
    per_slot = td.numpy().sum(axis=1)
    assert per_slot.max() <= 1
    assert td.numpy().sum(axis=(2, 3)).max() <= top_k


def test_overflow_keeps_the_first_tokens_and_drops_the_rest():
    dispatch, combine, _ = tmoe.top_k_gating(
        torch.from_numpy(_overflow_logits()), 1, 2)
    routed = dispatch[0, :, 0].any(-1)
    assert routed.tolist() == [True, True] + [False] * 6
    assert combine[0, 2:].abs().sum() == 0


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

LAYER_CFG = dict(num_experts=4, top_k=2, hidden_size=16,
                 expert_intermediate=32)


def _layer_inputs(seed=2):
    return np.random.default_rng(seed).standard_normal(
        (2, 24, 16)).astype(np.float32)


def _layer_grads(layer, x, cotangent):
    """(output, aux, ∂/∂params by name, ∂/∂x) of the port's MoELayer for
    the loss sum(out · cotangent) + aux."""
    x = x.clone().requires_grad_()
    out, aux = layer(x)
    (out.float() * cotangent).sum().add(aux).backward()
    return (out.detach(), aux.detach(),
            {n: p.grad for n, p in layer.named_parameters()}, x.grad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("deterministic", [True, False])
def test_moe_layer_matches_jax(dtype, deterministic):
    """MoELayer forward and gradients (router, wi, wo and the input)
    under eval routing (capacity factor 2) and training routing (1.25,
    which drops tokens here); the ExpertMLP inside it, through the
    same parameters."""
    jcfg = jmoe.MoEConfig(**LAYER_CFG, dtype=getattr(jnp, dtype))
    tcfg = tmoe.MoEConfig(**LAYER_CFG, dtype=getattr(torch, dtype))
    x = _layer_inputs()
    cot = np.random.default_rng(3).standard_normal(x.shape).astype(
        np.float32)
    jlayer = jmoe.MoELayer(jcfg, deterministic=deterministic)
    params = nn.unbox(jlayer.init(jax.random.PRNGKey(0),
                                  jnp.asarray(x)))["params"]

    def jloss(p, xin):
        out, mut = jlayer.apply({"params": p}, xin.astype(jcfg.dtype),
                                mutable=["losses"])
        return (jnp.sum(out.astype(jnp.float32) * cot)
                + jmoe.moe_aux_loss(mut), (out, jmoe.moe_aux_loss(mut)))

    (_, (jout, jaux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    layer = tmoe.MoELayer(tcfg, deterministic, device="cpu")
    layer.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    tout, taux, tg, tgx = _layer_grads(
        layer, torch.from_numpy(x).to(tcfg.dtype), torch.from_numpy(cot))
    jgrads = convert.params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(jgrads) == set(tg) == {"router", "ExpertMLP_0.wi",
                                      "ExpertMLP_0.wo"}
    np.testing.assert_allclose(taux.item(), float(jaux), atol=GATE_TOL)
    pairs = [("out", tout, jout), ("dx", tgx, jgx)] + [
        (f"d{n}", tg[n], jgrads[n]) for n in sorted(tg)]
    for what, got, want in pairs:
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                                       **F32_TOL)
        else:
            _assert_bf16_close(got, want, what)


def test_expert_mlp_matches_jax():
    jcfg = jmoe.MoEConfig(**LAYER_CFG)
    x = np.random.default_rng(4).standard_normal((4, 10, 16)).astype(
        np.float32)
    jexp = jmoe.ExpertMLP(jcfg)
    params = nn.unbox(jexp.init(jax.random.PRNGKey(1), jnp.asarray(x)))[
        "params"]
    want = jexp.apply({"params": params}, jnp.asarray(x))
    texp = tmoe.ExpertMLP(tmoe.MoEConfig(**LAYER_CFG), "cpu", None)
    texp.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    np.testing.assert_allclose(texp(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), **F32_TOL)
    assert texp.expert_group() == (0, 4, None)


def test_init_scales_follow_flax_lecun_normal():
    """The router and experts draw lecun_normal (fan_in of an (E, H, M)
    kernel is E·H, flax's receptive field), within 2 of their std."""
    cfg = tmoe.MoEConfig(num_experts=8, hidden_size=256,
                         expert_intermediate=512)
    layer = tmoe.MoELayer(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    for p, fan_in in ((layer.router, 256), (layer.ExpertMLP_0.wi, 8 * 256),
                      (layer.ExpertMLP_0.wo, 8 * 512)):
        std = fan_in ** -0.5
        assert p.abs().max() <= 2 * std / .87962566 + 1e-6
        np.testing.assert_allclose(p.std().item(), std, rtol=0.05)


def test_jitter_range_and_replay():
    """Training routing with jitter: the noise lies in [1 − j, 1 + j),
    the same seed gives the same noise (a restart, a recompute), another
    seed other noise; deterministic routing ignores it."""
    x = torch.ones(2, 64, 16)
    noise = tmoe.jitter(x, 0.1, 7)
    assert noise.min() >= 0.9 and noise.max() < 1.1
    assert noise.std() > 0.03
    assert torch.equal(noise, tmoe.jitter(x, 0.1, 7))
    assert not torch.equal(noise, tmoe.jitter(x, 0.1, 8))
    cfg = tmoe.MoEConfig(**LAYER_CFG, jitter_noise=0.5)
    xs = torch.from_numpy(_layer_inputs())
    train = tmoe.MoELayer(cfg, deterministic=False, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(train(xs, 3)[0], train(xs, 3)[0])
    assert not torch.equal(train(xs, 3)[0], train(xs, 4)[0])
    evaluation = tmoe.MoELayer(cfg, deterministic=True, device="cpu")
    evaluation.load_state_dict(train.state_dict())
    assert torch.equal(evaluation(xs, 3)[0], evaluation(xs, 4)[0])
    seeds = {tmoe.fold_seed(0, step, micro) for step in range(4)
             for micro in range(3)}
    assert len(seeds) == 12 and tmoe.fold_seed(0, 1, 2) == \
        tmoe.fold_seed(0, 1, 2)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _jax_model(tokens, **kw):
    cfg = jlm.LlamaMoEConfig.mixtral_tiny(attn_impl="reference",
                                          dtype=jnp.float32, **kw)
    model = jlm.LlamaMoE(cfg)
    params = jax.tree.map(np.asarray, nn.unbox(model.init(
        jax.random.PRNGKey(0), jnp.asarray(tokens)))["params"])
    return model, params


def _port_model(params, deterministic=True, **kw):
    cfg = tlm.LlamaMoEConfig.mixtral_tiny(dtype=torch.float32, **kw)
    model = tlm.LlamaMoE(cfg, device="cpu", deterministic=deterministic)
    model.load_state_dict(convert.params_from_jax(params), strict=True)
    return model


def _tokens(seed=11, batch=2, seq=SEQ):
    return np.random.default_rng(seed).integers(0, 250, (batch, seq)
                                                ).astype(np.int32)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("norm_impl", ["fused", "reference"])
@pytest.mark.parametrize("attn_impl", ["flash", "reference"])
def test_llama_moe_loss_and_grads_match_jax(attn_impl, norm_impl, remat):
    """moe_cross_entropy_loss (cross entropy + the layers' aux losses) and
    every parameter's gradient against the JAX model's, f32."""
    tokens, targets = _tokens(), _tokens(seed=12)
    jmodel, params = _jax_model(tokens)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.moe_cross_entropy_loss(
            jmodel, p, jnp.asarray(tokens), jnp.asarray(targets)))(params)
    model = _port_model(params, attn_impl=attn_impl, norm_impl=norm_impl,
                        remat=remat)
    loss = tlm.moe_cross_entropy_loss(
        model, torch.from_numpy(tokens), torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **F32_TOL)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **F32_TOL)


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable",
                                    "dots_with_no_batch_dims"])
def test_aux_loss_counted_once_under_remat(policy):
    """A rematerialized block runs its MoE layer again in the backward;
    the aux sum reaches the loss once: the loss, the aux and every
    gradient equal remat=False's bit for bit."""
    tokens, targets = _tokens(), _tokens(seed=12)
    _, params = _jax_model(tokens)
    runs = {}
    for remat in (False, True):
        model = _port_model(params, remat=remat, remat_policy=policy,
                            deterministic=False)
        logits, aux = model(torch.from_numpy(tokens), with_losses=True)
        loss = tllama.cross_entropy_loss(logits,
                                         torch.from_numpy(targets)) + aux
        loss.backward()
        runs[remat] = (loss, aux, {n: p.grad for n, p in
                                   model.named_parameters()})
    (l0, a0, g0), (l1, a1, g1) = runs[False], runs[True]
    assert a0.item() > 0 and torch.equal(a0, a1) and torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_sizes_and_param_axes():
    cfg = tlm.LlamaMoEConfig.mixtral_tiny()
    jcfg = jlm.LlamaMoEConfig.mixtral_tiny()
    model = tlm.LlamaMoE(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    from dlrover_tpu_torch.parallel.sharding import logical_axes

    axes = logical_axes(model)
    assert axes["layer_1.moe.router"] == ("embed", "expert")
    assert axes["layer_1.moe.ExpertMLP_0.wi"] == ("expert", "embed", "mlp")
    assert axes["layer_1.moe.ExpertMLP_0.wo"] == ("expert", "mlp", "embed")
    assert model.kernel_libraries() == ("flash_attention", "norms")


def test_converter_round_trips_the_moe_tree():
    _, params = _jax_model(_tokens())
    flat = convert.params_from_jax(params)
    assert {"layer_0.moe.router", "layer_0.moe.ExpertMLP_0.wi",
            "layer_0.moe.ExpertMLP_0.wo", "layer_0.attn_norm.weight",
            "layer_0.moe_norm.weight"} <= set(flat)
    back = convert.params_to_jax(_port_model(params).state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert jax.tree.structure(back) == jax.tree.structure(params)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _batches(steps=3, vocab=256):
    out = []
    for step in range(1, steps + 1):
        rng = np.random.default_rng(step)
        out.append(tuple(rng.integers(0, vocab, (ACCUM * MICRO, SEQ),
                                      dtype=np.int32) for _ in range(2)))
    return out


def _jax_training(tx, steps=3):
    cfg = jlm.LlamaMoEConfig.mixtral_tiny(attn_impl="reference",
                                          dtype=jnp.float32)
    mesh = jcreate_mesh(JMeshSpec(), jax.devices("cpu")[:1])
    trainer = jts.build_trainer(
        jlm.LlamaMoE(cfg, deterministic=False), tx, mesh,
        jnp.zeros((MICRO, SEQ), jnp.int32), jllama.cross_entropy_loss,
        accum_steps=ACCUM, micro_batch=MICRO)
    state = trainer.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state.params)
    history = []
    for tokens, targets in _batches(steps):
        state, m = trainer.step(state, *trainer.shard_batch(tokens,
                                                            targets))
        history.append((float(m["loss"]), float(m["grad_norm"])))
    return init, history, state


def _adafactor(params):
    return optim.LeafOptimizer(params, optim.adafactor(LR))


def test_three_adafactor_steps_with_two_micro_steps_match_jax():
    """JAX's build_trainer over LlamaMoE(deterministic=False) with
    optax.adafactor, 2 micro-steps, against the port's from one init:
    losses (cross entropy + aux), grad norms and every parameter within
    1e-4 after each of 3 steps; Adafactor's state then converts leaf for
    leaf."""
    init, jhist, jstate = _jax_training(optax.adafactor(LR))
    model = tlm.LlamaMoE(tlm.LlamaMoEConfig.mixtral_tiny(
        attn_impl="flash", dtype=torch.float32), device="cpu",
        deterministic=False)
    model.load_state_dict(convert.params_from_jax(init), strict=True)
    trainer = tts.build_trainer(
        model, _adafactor, None, np.zeros((MICRO, SEQ)),
        tllama.cross_entropy_loss, accum_steps=ACCUM, micro_batch=MICRO,
        device="cpu")
    state = trainer.init(0)
    for (tokens, targets), (jl, jn) in zip(_batches(), jhist):
        state, m = trainer.step(state, *trainer.shard_batch(tokens,
                                                            targets))
        np.testing.assert_allclose(m["loss"].item(), jl, **TRAIN_TOL)
        np.testing.assert_allclose(m["grad_norm"].item(), jn, **TRAIN_TOL)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   err_msg=name, **TRAIN_TOL)
    jopt = convert.factored_state_from_jax(
        jax.tree.map(np.asarray, jstate.opt_state))
    for name, p in state.model.named_parameters():
        leaf = state.optimizer.state[p]
        assert int(leaf["count"]) == int(jopt[name]["count"]) == 3
        for key in ("v_row", "v_col", "v"):
            np.testing.assert_allclose(leaf[key].numpy(),
                                       jopt[name][key].numpy(), rtol=1e-3,
                                       atol=1e-9, err_msg=f"{name}.{key}")


def test_trainer_adds_the_aux_loss_and_seeds_the_jitter():
    """The reported loss is cross entropy + aux (the JAX trainer's
    ``losses`` collection); with jitter, the same (state, step) replays
    the same loss and a training run converges."""
    tokens = _tokens(batch=MICRO)
    cfg = tlm.LlamaMoEConfig.mixtral_tiny(attn_impl="reference",
                                          dtype=torch.float32,
                                          jitter_noise=0.1)

    def trainer():
        return tts.build_trainer(
            functools.partial(tlm.LlamaMoE, cfg, deterministic=False),
            lambda p: torch.optim.Adam(p, lr=1e-3), None,
            np.zeros((MICRO, SEQ)), tllama.cross_entropy_loss,
            micro_batch=MICRO, device="cpu")

    t = trainer()
    state = t.init(0)
    tok, tgt = t.shard_batch(tokens, tokens)
    with torch.no_grad():
        logits, aux = state.model(tok[0], with_losses=True,
                                  gating_seed=tmoe.fold_seed(0, 0, 0))
        expected = tllama.cross_entropy_loss(logits, tgt[0]) + aux
    losses = []
    for _ in range(5):
        state, m = t.step(state, tok, tgt)
        losses.append(m["loss"].item())
    assert losses[0] == expected.item() and aux.item() > 0
    assert losses[-1] < losses[0]
    again = trainer()
    _, m = again.step(again.init(0), tok, tgt)
    assert m["loss"].item() == losses[0]


def test_expert_axis_needs_a_divisor_and_no_tensor_axis():
    """An MoE model builds under a tensor axis, alone or with the expert
    axis (ROADMAP Queue A item 10c, done: its training on gloo ranks is
    tests/test_torch_moe_tensor_parallel.py); an expert count or an
    expert width that does not divide over its axis still raises."""
    from dlrover_tpu_torch.parallel import mesh as tmesh

    cfg = tlm.LlamaMoEConfig.mixtral_tiny()

    def build(**spec):
        mesh = tmesh.Mesh(tmesh.MeshSpec(**spec).with_total_devices(
            tmesh.MeshSpec(**spec).total), torch.device("cpu"))
        return tts.build_trainer(functools.partial(tlm.LlamaMoE, cfg),
                                 _adafactor, mesh, np.zeros((MICRO, SEQ)),
                                 tllama.cross_entropy_loss,
                                 micro_batch=MICRO)

    for spec in (dict(tensor=2), dict(expert=2, tensor=2)):
        assert build(**spec).mesh.shape["tensor"] == 2
    with pytest.raises(ValueError, match="expert=3"):
        build(expert=3)
    with pytest.raises(ValueError, match="tensor=3"):
        build(tensor=3)


class _InfoClient:
    """The MasterClient surface both loops call at construction."""

    def __init__(self):
        self.model_info = []

    def report_model_info(self, **kwargs):
        self.model_info.append(kwargs)
        return True

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def test_loop_reports_the_jax_loops_model_info(cpu_devices):
    """Both loops' ModelInfo for LlamaMoE: the parameter count over every
    expert and FLOPs/token 6·N plus the attention term (ROADMAP Queue
    C12: the loop's MFU counts every expert, not the top-k it runs)."""
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )

    jclient, tclient = _InfoClient(), _InfoClient()
    kw = dict(global_batch=8, seq_len=16, max_micro_per_replica=4)
    jl = jloop.ElasticTrainLoop(
        jlm.LlamaMoE(jlm.LlamaMoEConfig.mixtral_tiny(), deterministic=False),
        optax.adafactor(LR), jllama.cross_entropy_loss,
        jloop.TrainLoopConfig(**kw), master_client=jclient,
        devices=cpu_devices[:1])
    cfg = tlm.LlamaMoEConfig.mixtral_tiny()
    tl = ElasticTrainLoop(
        functools.partial(tlm.LlamaMoE, cfg, deterministic=False),
        _adafactor, tllama.cross_entropy_loss, TrainLoopConfig(**kw),
        master_client=tclient, device="cpu")
    jl.close()
    tl.close()
    want, got = jclient.model_info[0], tclient.model_info[0]
    for key in ("param_count", "param_bytes", "flops_per_token",
                "flops_per_step", "tensor_divisor", "fsdp_divisor",
                "batch_size", "seq_len", "effective_global_batch"):
        assert got[key] == want[key], key
    assert got["param_count"] == cfg.param_count() > cfg.active_param_count()
    assert got["flops_per_token"] == 6.0 * cfg.param_count() + 6.0 * \
        cfg.num_layers * cfg.hidden_size * 16


# ---------------------------------------------------------------------------
# the expert axis on gloo ranks
# ---------------------------------------------------------------------------

EP_WORKER = """
import json, sys
import numpy as np
import torch
from torch.distributed.tensor import DTensor
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.models.llama import cross_entropy_loss
from dlrover_tpu_torch.models.llama_moe import LlamaMoE, LlamaMoEConfig
from dlrover_tpu_torch.optim import LeafOptimizer, adafactor
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.trainer.train_step import build_trainer

torch.set_num_threads(1)
init_distributed("cpu")
batches = np.load(sys.argv[1])
spec = json.loads(sys.argv[2])
cfg = LlamaMoEConfig.mixtral_tiny(attn_impl="flash", dtype=torch.float32)
trainer = build_trainer(
    lambda device, seed: LlamaMoE(cfg, device=device, seed=seed,
                                  deterministic=False),
    lambda p: LeafOptimizer(p, adafactor(1e-2, min_dim_size_to_factor=32)),
    create_mesh(MeshSpec(**spec), "cpu"), np.zeros((4, batches.shape[-1])),
    cross_entropy_loss, accum_steps=2, micro_batch=4, device="cpu")
state = trainer.init(0)
losses, norms = [], []
for tokens, targets in batches:
    state, m = trainer.step(state, *trainer.shard_batch(tokens, targets))
    losses.append(m["loss"].item())
    norms.append(m["grad_norm"].item())
params = {n: (p.full_tensor() if isinstance(p, DTensor) else p)
          for n, p in state.model.named_parameters()}
if len(sys.argv) > 3:
    np.savez(sys.argv[3], **{n: p.detach().numpy()
                             for n, p in params.items()})
print(json.dumps({
    "losses": losses, "grad_norms": norms,
    "local_experts": {n: p.to_local().shape[0] for n, p in
                      state.model.named_parameters()
                      if n.endswith(("wi", "wo")) and isinstance(p, DTensor)},
    "sums": {n: float(p.detach().double().sum()) for n, p in params.items()}}))
"""


def test_expert_axis_on_gloo_ranks_matches_one_device(tmp_path):
    """3 Adafactor steps (factored 3-D expert leaves, 2 micro-steps) at
    expert=2 on 2 ranks, expert=2 × data=2 on 4 (HSDP's replicated data
    axis) and expert=2 × fsdp=2 on 4 (FSDP2 shards each expert leaf's
    embed dim) against one rank: every rank holds 2 of the 4 experts,
    and the losses, grad norms and final parameters agree within 1e-4,
    as tests/test_moe.py's expert mesh does in JAX."""
    batches = np.stack([np.stack(b) for b in _batches()])
    np.save(tmp_path / "batches.npy", batches)
    runs = {}
    cases = (("one", 1, {}), ("expert", 2, {"expert": 2}),
             ("expert_data", 4, {"expert": 2, "data": 2}),
             ("expert_fsdp", 4, {"expert": 2, "fsdp": 2}))
    for name, world, spec in cases:
        out = tmp_path / f"{name}.npz"
        runs[name] = run_workers(tmp_path, EP_WORKER, world,
                                 args=(tmp_path / "batches.npy",
                                       json.dumps(spec), out),
                                 name=f"ep_{name}")
        runs[name + "_params"] = dict(np.load(out))
    base = runs["one"][0]
    for name in ("expert", "expert_data", "expert_fsdp"):
        for r in runs[name]:
            assert set(r["local_experts"].values()) == {2}
            assert len(r["local_experts"]) == 4
            np.testing.assert_allclose(r["losses"], base["losses"],
                                       **TRAIN_TOL)
            np.testing.assert_allclose(r["grad_norms"], base["grad_norms"],
                                       **TRAIN_TOL)
            # the ranks of an expert group agree on every parameter
            assert r["sums"] == runs[name][0]["sums"]
        for key, want in runs["one_params"].items():
            np.testing.assert_allclose(runs[name + "_params"][key], want,
                                       err_msg=f"{name} {key}", **TRAIN_TOL)


CKPT_WORKER = """
import json, sys
import numpy as np
import torch
from torch.distributed.tensor import DTensor
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.models.llama import cross_entropy_loss
from dlrover_tpu_torch.models.llama_moe import LlamaMoE, LlamaMoEConfig
from dlrover_tpu_torch.optim import LeafOptimizer, adafactor
from dlrover_tpu_torch.parallel.mesh import MeshSpec
from dlrover_tpu_torch.trainer.elastic_loop import (ElasticTrainLoop,
                                                    TrainLoopConfig)

torch.set_num_threads(1)
init_distributed("cpu")
ckpt, expert, steps, out = (sys.argv[1], int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4])
cfg = LlamaMoEConfig.mixtral_tiny(attn_impl="flash", dtype=torch.float32)
loop = ElasticTrainLoop(
    lambda device, seed: LlamaMoE(cfg, device=device, seed=seed,
                                  deterministic=False),
    lambda p: LeafOptimizer(p, adafactor(1e-2, min_dim_size_to_factor=32)),
    cross_entropy_loss,
    TrainLoopConfig(global_batch=8, seq_len=16, max_micro_per_replica=4,
                    max_steps=steps, checkpoint_dir=ckpt,
                    save_interval_steps=2, mesh_spec=MeshSpec(expert=expert)),
    device="cpu")
state, start = loop.restore_or_init(0)
params = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
          for n, p in state.model.named_parameters()}
np.savez(out + f".restored{torch.distributed.get_rank() if torch.distributed.is_initialized() else 0}.npz",
         **{n: p.numpy() for n, p in params.items()})

def batches():
    rng = np.random.default_rng(start)
    for _ in range(steps):
        tokens = rng.integers(0, 256, (8, 16), dtype=np.int32)
        yield tokens, tokens

loop.config.max_steps = steps - start
state, metrics = loop.run(state, batches(), start_step=start)
params = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
          for n, p in state.model.named_parameters()}
np.savez(out + ".final.npz", **{n: p.numpy() for n, p in params.items()})
print(json.dumps({"start": start, "source": loop.last_restore_source,
                  "losses": [r["loss"] for r in metrics["history"]],
                  "latest": loop.checkpointer.latest_step()}))
loop.close()
"""


def test_checkpoint_saved_at_expert_2_restores_at_expert_1(tmp_path):
    """Two ranks at expert=2 train 2 steps and save (each holds half the
    experts and their Adafactor statistics); one process at expert=1
    restores the step: every parameter the same bits as the saved ones,
    and its third step within 1e-4 of a third step at expert=2 from the
    same checkpoint (the resharded optimizer state)."""
    ckpt = tmp_path / "ckpt"
    out = str(tmp_path / "run")
    saved = run_workers(tmp_path, CKPT_WORKER, 2,
                        args=(ckpt, 2, 2, out + "_save"), name="ckpt_save")
    assert [r["latest"] for r in saved] == [2, 2]
    ep2 = run_workers(tmp_path, CKPT_WORKER, 2,
                      args=(ckpt, 2, 3, out + "_ep2"), name="ckpt_ep2")
    ep1 = run_workers(tmp_path, CKPT_WORKER, 1,
                      args=(ckpt, 1, 3, out + "_ep1"), name="ckpt_ep1")
    want = dict(np.load(out + "_save.final.npz"))
    got = dict(np.load(out + "_ep1.restored0.npz"))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert ep1[0]["start"] == ep2[0]["start"] == 2
    assert ep1[0]["source"] == "checkpoint"
    np.testing.assert_allclose(ep1[0]["losses"], ep2[0]["losses"],
                               **TRAIN_TOL)
    final1 = dict(np.load(out + "_ep1.final.npz"))
    for name, value in dict(np.load(out + "_ep2.final.npz")).items():
        np.testing.assert_allclose(final1[name], value, err_msg=name,
                                   **TRAIN_TOL)


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------


def test_moe_example_resumes_in_process(tmp_path):
    """The port's MoE worker, called in this process on the CPU at a small
    width: 4 steps saving at 2, then a second call resumes at 4 and
    finishes 6; its synthetic documents are the JAX example's."""
    import importlib.util
    import os

    from dlrover_tpu_torch.examples import moe_train
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
    from test_torch_mesh import REPO

    spec = importlib.util.spec_from_file_location(
        "jax_moe_train", os.path.join(REPO, "examples", "moe", "train.py"))
    jexample = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jexample)
    from dlrover_tpu.trainer.sampler import ElasticDistributedSampler as JS

    got = moe_train.token_batches(1024, ElasticDistributedSampler(
        dataset_size=10 ** 6, seed=0), 4, 32)
    want = jexample.token_batches(1024, JS(10 ** 6, seed=0), 4, 32)
    for _ in range(2):
        for a, b in zip(next(got), next(want)):
            np.testing.assert_array_equal(a, b)
    defaults = vars(moe_train.parse_args([]))
    jdefaults = vars(jexample.parse_args([]))
    assert defaults.pop("device") == "cuda" and defaults == jdefaults

    log = tmp_path / "log"
    args = ["--device", "cpu", "--hidden", "64", "--seq", "32",
            "--global-batch", "4", "--save-interval", "2", "--ckpt-dir",
            str(tmp_path / "c"), "--log-file", str(log)]
    assert moe_train.main(args + ["--steps", "4"]) == 0
    assert moe_train.main(args + ["--steps", "6"]) == 0
    lines = log.read_text().splitlines()
    assert lines[0].startswith("moe: start_step=0 experts=4 "
                               "expert_shards=1 ")
    assert lines[1].startswith("moe: done step=4 ")
    assert lines[2].startswith("moe: start_step=4 ")
    assert lines[3].startswith("moe: done step=6 ")
    with pytest.raises(SystemExit):
        moe_train.main(args + ["--expert-shards", "3"])


def test_moe_entry_points_raise_without_gpu():
    """The model, the trainer over it and the worker script run on the
    card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-GPU refusal is moot")
    from dlrover_tpu_torch.examples import moe_train

    cfg = tlm.LlamaMoEConfig.mixtral_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.LlamaMoE(cfg)
    with pytest.raises(RuntimeError):
        tts.build_trainer(functools.partial(tlm.LlamaMoE, cfg), _adafactor,
                          None, np.zeros((MICRO, SEQ)),
                          tllama.cross_entropy_loss, micro_batch=MICRO)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        moe_train.main(["--steps", "1"])


def test_dataclass_fields_follow_jax():
    tfields = {f.name for f in dataclasses.fields(tlm.LlamaMoEConfig)}
    jfields = {f.name for f in dataclasses.fields(jlm.LlamaMoEConfig)}
    assert tfields == jfields
    assert ({f.name for f in dataclasses.fields(tmoe.MoEConfig)}
            == {f.name for f in dataclasses.fields(jmoe.MoEConfig)})
