"""The port's pipeline parallelism (dlrover_tpu_torch/parallel/pipeline.py,
trainer/pipeline_trainer.py) against the JAX package's, on the CPU.

The same inputs, made from a numpy seed, go through the JAX function and
the port's, the JAX parameters carried across by
``convert.pipeline_params_from_jax``. The JAX side runs in this process
on the virtual CPU devices of ``tests/conftest.py``; the port runs
in-process at ``pipe`` 1 and on gloo ranks (``run_workers``) at ``pipe``
2 and 4. f32, reference attention: losses and every gradient within
1e-4 (the train step's tolerance). The schedule's step count and each
step's (round, microbatch, valid) equal the JAX formula's.

Four gloo launches, each with a wall-clock limit (a deadlocked shift
fails, it does not hang): every model family at pipe 2; pipe 2 × data 2,
pipe 2 × fsdp 2 and the functions at pipe 4 on 4 ranks; the elastic loop
at pipe 2.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import bert as jbert
from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import llama_moe as jlm
from dlrover_tpu.parallel import pipeline as jpipe
from dlrover_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dlrover_tpu.parallel.mesh import create_mesh as jcreate_mesh
from dlrover_tpu.trainer import elastic_loop as jloop
from dlrover_tpu.trainer import pipeline_trainer as jpt
from dlrover_tpu_torch import convert
from dlrover_tpu_torch.models import bert as tbert
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import llama_moe as tlm
from dlrover_tpu_torch.parallel import mesh as tmesh
from dlrover_tpu_torch.parallel import pipeline as tpipe
from dlrover_tpu_torch.trainer import pipeline_trainer as tpt
from dlrover_tpu_torch.trainer import train_step as tts
from test_torch_mesh import run_workers

TOL = dict(atol=1e-4, rtol=1e-4)
LR, WD, SEQ, MICRO, M = 1e-3, 0.1, 16, 2, 4
# gloo launches: the tiny models take seconds; the limit catches a hang
LAUNCH_TIMEOUT_S = 240

# case → (family, num_rounds, remat, bound_activations)
CASES = {
    "llama": ("llama", 1, False, False),
    "llama_c2": ("llama", 2, False, False),
    "llama_remat": ("llama", 2, True, False),
    "llama_bound": ("llama", 1, False, True),
    "gpt": ("gpt", 1, False, False),
    "bert": ("bert", 1, False, False),
    "moe": ("llama_moe", 1, False, False),
}


def _configs(family):
    """(JAX config, port config, JAX loss, port loss): the tiny presets,
    f32, reference attention; the Llama one at 4 layers so that pipe 2
    holds two rounds."""
    if family == "llama":
        return (dataclasses.replace(jllama.LlamaConfig.tiny(
                    attn_impl="reference", dtype=jnp.float32), num_layers=4),
                dataclasses.replace(tllama.LlamaConfig.tiny(
                    attn_impl="reference", dtype=torch.float32),
                    num_layers=4),
                jllama.cross_entropy_loss, tllama.cross_entropy_loss)
    if family == "gpt":
        return (jgpt.GPTConfig.nano(attn_impl="reference", dtype=jnp.float32),
                tgpt.GPTConfig.nano(attn_impl="reference",
                                    dtype=torch.float32),
                jllama.cross_entropy_loss, tllama.cross_entropy_loss)
    if family == "bert":
        return (jbert.BertConfig.tiny(attn_impl="reference",
                                      dtype=jnp.float32),
                tbert.BertConfig.tiny(attn_impl="reference",
                                      dtype=torch.float32),
                jbert.mlm_loss, tbert.mlm_loss)
    return (jlm.LlamaMoEConfig.mixtral_tiny(attn_impl="reference",
                                            dtype=jnp.float32),
            tlm.LlamaMoEConfig.mixtral_tiny(attn_impl="reference",
                                            dtype=torch.float32),
            jllama.cross_entropy_loss, tllama.cross_entropy_loss)


def _heads(family):
    """The head count ``convert`` permutes a fused qkv by (GPT's, BERT's
    head-major layout); the other families hold none."""
    cfg = _configs(family)[1]
    return getattr(cfg, "n_head", None) or getattr(cfg, "num_heads", None)


def _batch(vocab, seed=0, rows=M * MICRO):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (rows, SEQ)).astype(np.int32),
            rng.integers(0, vocab, (rows, SEQ)).astype(np.int32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_grads(case, devices, seed=0):
    """The JAX trainer's (params, loss, grads) at pipe len(devices), as
    numpy trees."""
    family, rounds, remat, bound = CASES[case]
    jcfg, _, jloss, _ = _configs(family)
    mesh = jcreate_mesh(JMeshSpec(pipe=len(devices)), devices)
    trainer = jpt.build_pipeline_trainer(
        jcfg, optax.adamw(LR, weight_decay=WD), mesh, M, MICRO, SEQ, jloss,
        num_rounds=rounds, remat=remat, bound_activations=bound)
    state = trainer.init(jax.random.PRNGKey(seed))
    tok, tgt = trainer.shard_batch(*_batch(jcfg.vocab_size, seed))
    loss, grads = jax.jit(jax.value_and_grad(trainer._loss))(
        state.params, tok, tgt)
    return _np(state.params), float(loss), _np(grads)


def _port_trainer(case, mesh=None, **kw):
    family, rounds, remat, bound = CASES[case]
    _, tcfg, _, tloss = _configs(family)
    return tpt.build_pipeline_trainer(
        tcfg, _adamw, mesh, M, MICRO, SEQ, tloss, num_rounds=rounds,
        remat=remat, bound_activations=bound, device="cpu", **kw)


def _adamw(params):
    # optax.adamw(LR, weight_decay=WD)
    return torch.optim.AdamW(params, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WD)


def _assert_close(got, want, what):
    assert set(got) == set(want), what
    for name in want:
        value = got[name]
        if torch.is_tensor(value):
            value = value.detach().float().numpy()
        np.testing.assert_allclose(
            np.asarray(value, np.float32), np.asarray(want[name]),
            err_msg=f"{what}: {name}", **TOL)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def _jax_slots(steps, num_micro, num_stages, num_rounds):
    """pipeline_train's step expressions (dlrover_tpu/parallel/
    pipeline.py:311-316) evaluated by JAX over every (t, stage): {(t, s):
    (r, m, valid)}."""
    S, C = num_stages, num_rounds
    t, stage = jnp.meshgrid(jnp.arange(steps), jnp.arange(S), indexing="ij")
    ts = t - stage
    r = jnp.clip((ts // S) % C, 0, C - 1)
    m = (ts // (S * C)) * S + ts % S
    valid = jnp.logical_and(ts >= 0, m < num_micro)
    r, m, valid = (np.asarray(x) for x in (r, m, valid))
    return {(i, s): (int(r[i, s]), int(m[i, s]), bool(valid[i, s]))
            for i in range(steps) for s in range(S)}


@pytest.mark.parametrize("num_micro", range(1, 10))
@pytest.mark.parametrize("num_rounds", [1, 2])
@pytest.mark.parametrize("num_stages", [1, 2, 4])
def test_schedule_is_the_jax_formula(num_stages, num_rounds, num_micro):
    """Step count and (r, m, valid) map against the JAX expressions; every
    (chunk, microbatch) runs once, in chunk order, entering at stage 0
    round 0 and leaving at the last stage in the last round; every send
    meets a receive on the next stage one step later."""
    S, C, Mi = num_stages, num_rounds, num_micro
    steps = tpipe.schedule_steps(Mi, S, C)
    assert steps == -(-Mi // S) * S * C + S - 1
    want = _jax_slots(steps, Mi, S, C)
    seen = {}
    for t in range(steps):
        for s in range(S):
            got = tpipe.slot(t, s, Mi, S, C)
            assert got == want[(t, s)], (t, s)
            r, m, valid = got
            if valid:
                assert (r * S + s, m) not in seen
                seen[(r * S + s, m)] = t
            assert tpipe.sends(t, s, Mi, S, C) == tpipe.receives(
                t + 1, (s + 1) % S, Mi, S, C), (t, s)
            assert tpipe.enters(t, s, Mi, S, C) == (valid and s == 0
                                                     and r == 0)
            assert tpipe.exits(t, s, Mi, S, C) == (valid and s == S - 1
                                                    and r == C - 1)
    assert set(seen) == {(g, m) for g in range(S * C) for m in range(Mi)}
    for m in range(Mi):
        order = [seen[(g, m)] for g in range(S * C)]
        assert order == sorted(order) and order[-1] - order[0] == S * C - 1
    assert not any(tpipe.sends(steps - 1, s, Mi, S, C) for s in range(S))


# ---------------------------------------------------------------------------
# the functions at pipe 1
# ---------------------------------------------------------------------------


H, V, PER = 8, 12, 2


def _toy_jax(num_stages, num_rounds, seed=0):
    """A toy pipeline's parameters: chunk leaves (C, S, PER, ...) and an
    embedding/head pair, numpy."""
    rng = np.random.default_rng(seed)
    shape = (num_rounds, num_stages, PER)
    chunks = {"w": rng.standard_normal(shape + (H, H), np.float32) / 3,
              "b": rng.standard_normal(shape + (H,), np.float32) / 10}
    shared = {"embed": rng.standard_normal((V, H), np.float32),
              "head": rng.standard_normal((H, V), np.float32) / 3}
    return chunks, shared


def _toy_fns(xp):
    """(chunk_fn, chunk_fn with aux, enter_fn, exit_fn) in ``xp`` (jnp or
    torch): tanh layers, a table lookup, per-row cross entropy."""
    def chunk(params, x):
        for j in range(PER):
            x = xp.tanh(x @ params["w"][j] + params["b"][j])
        return x

    def chunk_aux(params, x):
        y = chunk(params, x)
        return y, (y ** 2).mean() * 0.1

    def enter(shared, tok):
        return shared["embed"][tok]

    def exit_(shared, y, tgt):
        logits = y @ shared["head"]
        if xp is jnp:
            logp = jax.nn.log_softmax(logits, -1)
            picked = jnp.take_along_axis(logp, tgt[..., None], -1)[..., 0]
        else:
            logp = torch.log_softmax(logits, -1)
            picked = logp.gather(-1, tgt[..., None].long())[..., 0]
        return -picked.mean(-1)

    return chunk, chunk_aux, enter, exit_


def _toy_tokens(num_micro=5, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (num_micro, 3, 4)).astype(np.int32),
            rng.integers(0, V, (num_micro, 3, 4)).astype(np.int32))


def _jax_toy_train(mesh, num_rounds, aux, remat, groups):
    chunks, shared = _toy_jax(mesh.shape["pipe"], num_rounds)
    tok, tgt = _toy_tokens()
    chunk, chunk_aux, enter, exit_ = _toy_fns(jnp)

    def loss(chunks, shared):
        return jpipe.pipeline_train(
            mesh, chunk_aux if aux else chunk, chunks, shared, enter, exit_,
            jnp.asarray(tok), jnp.asarray(tgt), num_rounds=num_rounds,
            remat=remat, chunk_has_aux=aux, activation_groups=groups)

    # (jit: a checkpointed window inside shard_map does not run eagerly)
    value, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, chunks), jax.tree.map(jnp.asarray, shared))
    return float(value), _np(grads)


@pytest.mark.parametrize("num_rounds,aux,remat,groups", [
    (1, False, False, 0), (2, False, False, 0), (2, True, False, 0),
    (1, False, True, 0), (2, True, False, 1), (2, False, True, 1)])
def test_pipeline_train_matches_jax_at_one_stage(cpu_devices, num_rounds,
                                                 aux, remat, groups):
    mesh = jcreate_mesh(JMeshSpec(pipe=1), cpu_devices[:1])
    want, (want_chunks, want_shared) = _jax_toy_train(mesh, num_rounds, aux,
                                                      remat, groups)
    chunks, shared = _toy_jax(1, num_rounds)
    chunks = {k: torch.tensor(v, requires_grad=True)
              for k, v in chunks.items()}
    shared = {k: torch.tensor(v, requires_grad=True)
              for k, v in shared.items()}
    tok, tgt = (torch.from_numpy(x) for x in _toy_tokens())
    chunk, chunk_aux, enter, exit_ = _toy_fns(torch)
    loss = tpipe.pipeline_train(
        tmesh.create_mesh(device="cpu"), chunk_aux if aux else chunk,
        tpipe.local_chunks(chunks, 0), shared, enter, exit_, tok, tgt,
        num_rounds=num_rounds, remat=remat, chunk_has_aux=aux,
        activation_groups=groups)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, **TOL)
    _assert_close({k: v.grad for k, v in chunks.items()}, want_chunks,
                  "chunks")
    _assert_close({k: v.grad for k, v in shared.items()}, want_shared,
                  "shared")


def _mlp_stage(xp):
    def stage(params, x):
        h = xp.tanh(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]
    return stage


def _stages(num_stages, seed=2):
    rng = np.random.default_rng(seed)
    return [{"w1": rng.standard_normal((H, H), np.float32) / 3,
             "b1": rng.standard_normal((H,), np.float32) / 10,
             "w2": rng.standard_normal((H, H), np.float32) / 3,
             "b2": np.zeros((H,), np.float32)} for _ in range(num_stages)]


def _jax_apply(mesh, num_micro=5, remat=False):
    """pipeline_apply's outputs and the gradient of sum(out²) by the
    stacked parameters, and the sequential oracle's outputs."""
    stages = [jax.tree.map(jnp.asarray, s)
              for s in _stages(mesh.shape["pipe"])]
    stacked = jpipe.stack_stage_params(stages)
    inputs = jnp.asarray(np.random.default_rng(3).standard_normal(
        (num_micro, 2, H), np.float32))
    def apply(p):
        return jpipe.pipeline_apply(mesh, _mlp_stage(jnp), p, inputs,
                                    remat=remat)

    out = jax.jit(apply)(stacked)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(apply(p) ** 2)))(stacked)
    oracle = jpipe.sequential_oracle(_mlp_stage(jnp), stages, inputs)
    return np.asarray(out), _np(grads), np.asarray(oracle)


@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_apply_matches_jax_at_one_stage(cpu_devices, remat):
    mesh = jcreate_mesh(JMeshSpec(pipe=1), cpu_devices[:1])
    want, want_grads, oracle = _jax_apply(mesh, remat=remat)
    stacked = {k: v.requires_grad_() for k, v in
               tpipe.stack_stage_params(
                   [{k: torch.from_numpy(v) for k, v in s.items()}
                    for s in _stages(1)]).items()}
    inputs = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 2, H), np.float32))
    out = tpipe.pipeline_apply(tmesh.create_mesh(device="cpu"),
                               _mlp_stage(torch), stacked, inputs,
                               remat=remat)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(out.detach().numpy(), oracle, **TOL)
    seq = tpipe.sequential_oracle(
        _mlp_stage(torch), [{k: v[0] for k, v in stacked.items()}], inputs)
    np.testing.assert_allclose(seq.detach().numpy(), oracle, **TOL)
    _assert_close({k: v.grad for k, v in stacked.items()}, want_grads,
                  "stacked")


# ---------------------------------------------------------------------------
# PipelinedTrainer at pipe 1 against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_reference():
    """Each case's JAX (params, loss, grads), computed once at pipe 2 (the
    same function as at pipe 1, JAX's schedule proof; the carried-state
    test below runs JAX at pipe 1): the reference of the port at pipe 1
    here and at pipe 2 on gloo ranks."""
    devices = jax.devices("cpu")[:2]
    return {case: _jax_grads(case, devices) for case in CASES}


def _load(trainer, params, family):
    """A pipe-1 trainer's state holding the JAX parameters (every
    layer, whatever the JAX pipe size)."""
    state = trainer.init(0)
    state.model.load_state_dict(
        convert.pipeline_params_from_jax(params, family,
                                         heads=_heads(family)))
    return state


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_loss_and_every_gradient_match_jax(jax_reference, case):
    """At pipe 1: the loss and every gradient, chunk and shared, on
    converted weights."""
    family = CASES[case][0]
    params, want_loss, want_grads = jax_reference[case]
    trainer = _port_trainer(case)
    state = _load(trainer, params, family)
    tok, tgt = trainer.shard_batch(*_batch(_configs(family)[1].vocab_size))
    loss = trainer._accumulate(state, tok, tgt)
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    _assert_close({n: p.grad for n, p in state.model.named_parameters()},
                  convert.pipeline_params_from_jax(want_grads, family,
                                                   heads=_heads(family)),
                  case)


def test_adamw_steps_from_a_carried_jax_state(cpu_devices):
    """One JAX AdamW step, the state (parameters and moments) carried to
    the port, then a second step in both: losses, grad norms and
    parameters within 1e-4 (the circular schedule, two rounds)."""
    family, rounds = "llama", 2
    jcfg, _, jloss, _ = _configs(family)
    mesh = jcreate_mesh(JMeshSpec(pipe=1), cpu_devices[:1])
    jtr = jpt.build_pipeline_trainer(jcfg, optax.adamw(LR, weight_decay=WD),
                                     mesh, M, MICRO, SEQ, jloss,
                                     num_rounds=rounds)
    jstate = jtr.init(jax.random.PRNGKey(1))
    jstate, _ = jtr.step(jstate, *jtr.shard_batch(*_batch(256, 0)))
    carried = jax.tree.map(np.asarray, (jstate.params, jstate.opt_state))
    jstate, jm = jtr.step(jstate, *jtr.shard_batch(*_batch(256, 1)))

    trainer = _port_trainer("llama_c2")
    state = _load(trainer, carried[0], family)
    moments = convert.pipeline_adamw_from_jax(carried[1], family)
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = moments[name]
    state, m = trainer.step(state, *trainer.shard_batch(*_batch(256, 1)))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), **TOL)
    _assert_close(dict(state.model.named_parameters()),
                  convert.pipeline_params_from_jax(_np(jstate.params),
                                                   family), "params")
    grads = jax.jit(jax.grad(jtr._loss))(
        jax.tree.map(jnp.asarray, carried[0]),
        *jtr.shard_batch(*_batch(256, 1)))
    want_norm = float(optax.global_norm(grads))
    np.testing.assert_allclose(m["grad_norm"].item(), want_norm, **TOL)


def test_three_adamw_steps_equal_the_dense_trainer():
    """The pipelined trainer at pipe 1 and the port's dense trainer from
    the same weights at accum M, micro 2: three AdamW steps' losses,
    grad norms and parameters (f32, 1e-4)."""
    trainer = _port_trainer("llama_c2")
    cfg = _configs("llama")[1]
    state = trainer.init(0)
    dense = tts.build_trainer(
        tllama.Llama(cfg, device="cpu"), _adamw, None,
        np.zeros((MICRO, SEQ)), tllama.cross_entropy_loss, accum_steps=M,
        micro_batch=MICRO, device="cpu")
    dstate = dense.init(0)
    dstate.model.load_state_dict(state.model.state_dict())
    for seed in range(3):
        batch = _batch(cfg.vocab_size, seed)
        state, m = trainer.step(state, *trainer.shard_batch(*batch))
        dstate, dm = dense.step(dstate, *dense.shard_batch(*batch))
        np.testing.assert_allclose(m["loss"].item(), dm["loss"].item(),
                                   **TOL)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   dm["grad_norm"].item(), **TOL)
    _assert_close(dict(state.model.named_parameters()),
                  {n: p.detach() for n, p in
                   dstate.model.named_parameters()}, "params")


def test_offload_opt_state_keeps_the_moments_on_the_host():
    """Three steps with the moments offloaded: the same bits as without,
    every moment on the host between steps."""
    runs = {}
    for offload in (False, True):
        trainer = _port_trainer("llama", offload_opt_state=offload)
        state = trainer.init(0)
        for seed in range(3):
            state, m = trainer.step(state, *trainer.shard_batch(
                *_batch(256, seed)))
        runs[offload] = state
        if offload:
            for p in state.model.parameters():
                st = state.optimizer.state[p]
                assert st["exp_avg"].device.type == "cpu"
                assert st["exp_avg_sq"].device.type == "cpu"
    for (name, p), q in zip(runs[False].model.named_parameters(),
                            runs[True].model.parameters()):
        assert torch.equal(p, q), name


# ---------------------------------------------------------------------------
# refusals and the layout
# ---------------------------------------------------------------------------


def _mesh(**spec):
    resolved = tmesh.MeshSpec(**spec)
    return tmesh.Mesh(resolved.with_total_devices(resolved.total),
                      torch.device("cpu"))


def test_layers_that_do_not_divide_raise():
    with pytest.raises(ValueError, match="not divisible"):
        _port_trainer("bert", mesh=_mesh(pipe=4))
    with pytest.raises(ValueError, match="not divisible"):
        tpt.build_pipeline_trainer(
            tllama.LlamaConfig.tiny(attn_impl="reference"), _adamw, None,
            M, MICRO, SEQ, tllama.cross_entropy_loss, num_rounds=3,
            device="cpu")


@pytest.mark.parametrize("spec", [dict(pipe=2, tensor=2),
                                  dict(pipe=2, expert=2)])
def test_pipe_with_tensor_or_expert_names_item_10(spec):
    """pipe × tensor and pipe × expert build (ROADMAP Queue A item 10d,
    done: their training on gloo ranks is
    tests/test_torch_pipeline_tensor_parallel.py), and a width the axis
    does not divide still raises."""
    case = "llama" if "tensor" in spec else "moe"
    trainer = _port_trainer(case, mesh=_mesh(**spec))
    assert trainer.num_stages == 2
    assert trainer.mesh.shape == dict(_mesh(**spec).shape)
    wide = {axis: 3 if axis != "pipe" else 2 for axis in spec}
    with pytest.raises(ValueError, match="does not divide"):
        _port_trainer(case, mesh=_mesh(**wide))


def test_pipe_with_a_sequence_axis_is_refused_as_jax_splits_no_sequence():
    """The JAX PipelinedTrainer shards its batch over the data axes alone
    (P(None, data axes)): the port refuses a sequence axis and says so."""
    with pytest.raises(NotImplementedError, match="does not split"):
        _port_trainer("llama", mesh=_mesh(pipe=2, sequence=2))


def test_build_trainer_with_a_pipe_axis_names_the_pipelined_trainer():
    with pytest.raises(NotImplementedError,
                       match="build_pipeline_trainer"):
        tts.build_trainer(
            functools.partial(tllama.Llama, tllama.LlamaConfig.tiny()),
            _adamw, _mesh(pipe=2), np.zeros((MICRO, SEQ)),
            tllama.cross_entropy_loss, micro_batch=MICRO)


@pytest.mark.parametrize("family", ["llama", "llama_moe", "gpt", "bert"])
def test_convert_round_trip_and_stage_names(cpu_devices, family):
    """JAX params → the port's names → JAX, at pipe 2 and two rounds:
    the same tree; a stage's slice is the names its PipelineStage
    holds."""
    jcfg, tcfg, jloss, tloss = _configs(family)
    if family != "llama":
        jcfg = dataclasses.replace(jcfg, **{
            "n_layer" if family == "gpt" else "num_layers": 4})
        tcfg = dataclasses.replace(tcfg, **{
            "n_layer" if family == "gpt" else "num_layers": 4})
    mesh = jcreate_mesh(JMeshSpec(pipe=2), cpu_devices[:2])
    jtr = jpt.build_pipeline_trainer(jcfg, optax.adamw(LR), mesh, M, MICRO,
                                     SEQ, jloss, num_rounds=2)
    params = _np(jtr.init(jax.random.PRNGKey(0)).params)
    flat = convert.pipeline_params_from_jax(params, family,
                                            heads=_heads(family))
    back = convert.pipeline_params_to_jax(flat, family, 2, 2,
                                          heads=_heads(family))
    jax.tree.map(np.testing.assert_array_equal, back, params)
    trainer = tpt.build_pipeline_trainer(
        tcfg, _adamw, _mesh(pipe=2), M, MICRO, SEQ, tloss, num_rounds=2,
        device="cpu")
    whole = tpt.PipelineStage(trainer.spec, range(4), device="meta")
    assert set(flat) == set(whole.state_dict())
    for stage in range(2):
        layers = trainer.stage_layers(stage)
        built = tpt.PipelineStage(trainer.spec, layers, device="meta")
        assert set(convert.pipeline_params_from_jax(params, family, stage,
                                                   _heads(family))
                   ) == set(built.state_dict())
        assert layers == [stage, 2 + stage]


# ---------------------------------------------------------------------------
# pipe 2 on gloo ranks: every family
# ---------------------------------------------------------------------------

PORT_CONFIGS = """
import dataclasses, functools, json, sys
import numpy as np
import torch
from dlrover_tpu_torch import convert
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.models import bert, gpt, llama, llama_moe
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.parallel.sharding import to_local
from dlrover_tpu_torch.trainer.pipeline_trainer import build_pipeline_trainer

torch.set_num_threads(1)
init_distributed("cpu")
F32 = dict(attn_impl="reference", dtype=torch.float32)
CONFIGS = {
    "llama": (dataclasses.replace(llama.LlamaConfig.tiny(**F32),
                                  num_layers=4), llama.cross_entropy_loss),
    "gpt": (gpt.GPTConfig.nano(**F32), llama.cross_entropy_loss),
    "bert": (bert.BertConfig.tiny(**F32), bert.mlm_loss),
    "llama_moe": (llama_moe.LlamaMoEConfig.mixtral_tiny(**F32),
                  llama.cross_entropy_loss),
}


def adamw(params):
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.1)


def trainer_of(family, spec, rounds=1, remat=False, bound=False):
    cfg, loss = CONFIGS[family]
    return build_pipeline_trainer(
        cfg, adamw, create_mesh(MeshSpec(**spec), "cpu"), 4, 2, 16, loss,
        num_rounds=rounds, remat=remat, bound_activations=bound,
        device="cpu")
"""

FAMILIES_WORKER = PORT_CONFIGS + """
rank = torch.distributed.get_rank()
cases = json.loads(sys.argv[1])
losses = {}
for case, (family, rounds, remat, bound) in cases.items():
    data = np.load(f"{case}.npz")
    trainer = trainer_of(family, {"pipe": 2}, rounds, remat, bound)
    state = trainer.init(0)
    own = state.model.state_dict()
    state.model.load_state_dict(
        {n: torch.from_numpy(data["p/" + n]) for n in own})
    loss = trainer._accumulate(state, *trainer.shard_batch(data["tokens"],
                                                           data["targets"]))
    losses[case] = loss.item()
    np.savez(f"{case}-grads-{rank}.npz", **{
        n: p.grad.numpy() for n, p in state.model.named_parameters()})
print(json.dumps({"losses": losses,
                  "stage": trainer.mesh.coordinate()["pipe"]}))
"""


@pytest.fixture(scope="module")
def pipe2_families(tmp_path_factory, jax_reference):
    """Every case at pipe 2 in one launch of 2 ranks, from the JAX pipe-2
    trainer's weights: (the JAX (params, loss, grads), the ranks' JSON,
    the directory of their gradients)."""
    tmp = tmp_path_factory.mktemp("pipe2")
    want = jax_reference
    for case, (family, *_rest) in CASES.items():
        params = want[case][0]
        vocab = _configs(family)[0].vocab_size
        tokens, targets = _batch(vocab)
        np.savez(tmp / f"{case}.npz", tokens=tokens, targets=targets, **{
            "p/" + n: v.numpy() for n, v in
            convert.pipeline_params_from_jax(
                params, family, heads=_heads(family)).items()})
    results = run_workers(tmp, FAMILIES_WORKER, 2,
                          args=[json.dumps(CASES)],
                          timeout=LAUNCH_TIMEOUT_S, name="families")
    return want, results, tmp


@pytest.mark.parametrize("case", list(CASES))
def test_pipe2_matches_jax_on_gloo_ranks(pipe2_families, case):
    """At pipe 2, each rank's loss and its stage's gradients (the shared
    ones summed over the pipe group) against JAX's pipe-2 trainer."""
    want, results, tmp = pipe2_families
    family = CASES[case][0]
    _, want_loss, want_grads = want[case]
    want_flat = convert.pipeline_params_from_jax(want_grads, family,
                                                 heads=_heads(family))
    for rank, result in enumerate(results):
        assert result["stage"] == rank
        np.testing.assert_allclose(result["losses"][case], want_loss, **TOL)
        got = dict(np.load(tmp / f"{case}-grads-{rank}.npz"))
        stage = convert.pipeline_params_from_jax(want_grads, family, rank,
                                                 _heads(family))
        _assert_close(got, {n: want_flat[n] for n in stage}, case)


# ---------------------------------------------------------------------------
# 4 ranks: pipe 2 × data 2, pipe 2 × fsdp 2, the functions at pipe 4
# ---------------------------------------------------------------------------

MESHES_WORKER = PORT_CONFIGS + """
from torch.distributed.tensor import DTensor
from dlrover_tpu_torch.parallel import pipeline

rank = torch.distributed.get_rank()
data = np.load("batches.npz")
out = {}
for name, spec in (("data", {"pipe": 2, "data": 2}),
                   ("fsdp", {"pipe": 2, "fsdp": 2})):
    trainer = trainer_of("llama", spec, rounds=2)
    state = trainer.init(0)
    local = {n: to_local(p).numel() for n, p in
             state.model.named_parameters()}
    full = {n: p.numel() for n, p in state.model.named_parameters()}
    history = []
    for tokens, targets in zip(data["tokens"], data["targets"]):
        state, m = trainer.step(state, *trainer.shard_batch(tokens, targets))
        history.append([m["loss"].item(), m["grad_norm"].item()])
    params = {n: (p.full_tensor() if isinstance(p, DTensor) else p)
              for n, p in state.model.named_parameters()}
    np.savez(f"{name}-{rank}.npz",
             **{n: p.detach().numpy() for n, p in params.items()})
    out[name] = {"history": history, "names": sorted(full),
                 "coord": trainer.mesh.coordinate(),
                 "sharded": sorted(n for n in full if local[n] < full[n]),
                 "local": local, "full": full}

# the functions at pipe 4: pipeline_apply's outputs and gradients, and a
# toy pipeline_train at two rounds with aux losses
mesh = create_mesh(MeshSpec(pipe=4), "cpu")
stage = mesh.coordinate()["pipe"]
toy = np.load("toy.npz")
stacked = {k: torch.tensor(toy["apply/" + k], requires_grad=True)
           for k in ("w1", "b1", "w2", "b2")}
inputs = torch.from_numpy(toy["inputs"])


def mlp(params, x):
    return torch.tanh(x @ params["w1"] + params["b1"]) @ params["w2"] \\
        + params["b2"]


res = pipeline.pipeline_apply(mesh, mlp, stacked, inputs)
(res ** 2).sum().backward()
np.savez(f"apply-{rank}.npz", out=res.detach().numpy(),
         **{k: v.grad[stage].numpy() for k, v in stacked.items()})
chunks = {k: torch.tensor(toy["chunks/" + k], requires_grad=True)
          for k in ("w", "b")}
shared = {k: torch.tensor(toy["shared/" + k], requires_grad=True)
          for k in ("embed", "head")}


def chunk_aux(params, x):
    for j in range(params["w"].shape[0]):
        x = torch.tanh(x @ params["w"][j] + params["b"][j])
    return x, (x ** 2).mean() * 0.1


def exit_(shared, y, tgt):
    logp = torch.log_softmax(y @ shared["head"], -1)
    return -logp.gather(-1, tgt[..., None].long())[..., 0].mean(-1)


loss = pipeline.pipeline_train(
    mesh, chunk_aux, pipeline.local_chunks(chunks, stage), shared,
    lambda s, tok: s["embed"][tok], exit_, torch.from_numpy(toy["tok"]),
    torch.from_numpy(toy["tgt"]), num_rounds=2, chunk_has_aux=True,
    activation_groups=4)
loss.backward()
group = mesh.submesh(["pipe"]).get_group()
for v in shared.values():
    # a stage that neither enters nor exits has no gradient of them
    if v.grad is None:
        v.grad = torch.zeros_like(v)
    torch.distributed.all_reduce(v.grad, group=group)
np.savez(f"train-{rank}.npz", loss=loss.item(),
         **{"chunks/" + k: v.grad[:, stage].numpy() for k, v in chunks.items()},
         **{"shared/" + k: v.grad.numpy() for k, v in shared.items()})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, cpu_devices):
    """One launch of 4 ranks: pipe 2 × data 2 and pipe 2 × fsdp 2 (three
    AdamW steps of the 4-layer Llama at two rounds), and pipeline_apply
    and pipeline_train at pipe 4; with the pipe-1 run and the JAX
    functions at pipe 4 to hold them against."""
    tmp = tmp_path_factory.mktemp("four")
    batches = [_batch(256, seed) for seed in range(3)]
    np.savez(tmp / "batches.npz", tokens=np.stack([b[0] for b in batches]),
             targets=np.stack([b[1] for b in batches]))
    trainer = _port_trainer("llama_c2")
    state = trainer.init(0)
    history = []
    for batch in batches:
        state, m = trainer.step(state, *trainer.shard_batch(*batch))
        history.append([m["loss"].item(), m["grad_norm"].item()])
    ref = {n: p.detach().numpy() for n, p in state.model.named_parameters()}

    mesh4 = jcreate_mesh(JMeshSpec(pipe=4), cpu_devices[:4])
    apply_out, apply_grads, _ = _jax_apply(mesh4)
    chunks, shared = _toy_jax(4, 2)
    tok, tgt = _toy_tokens()
    train_loss, (train_chunks, train_shared) = _jax_toy_train(
        mesh4, 2, True, False, 4)
    stacked = jpipe.stack_stage_params(_stages(4))
    np.savez(tmp / "toy.npz", inputs=np.random.default_rng(3)
             .standard_normal((5, 2, H), np.float32), tok=tok, tgt=tgt,
             **{"apply/" + k: np.asarray(v) for k, v in stacked.items()},
             **{"chunks/" + k: v for k, v in chunks.items()},
             **{"shared/" + k: v for k, v in shared.items()})
    results = run_workers(tmp, MESHES_WORKER, 4, timeout=LAUNCH_TIMEOUT_S,
                          name="meshes")
    want = dict(history=history, params=ref, apply_out=apply_out,
                apply_grads=apply_grads, train_loss=train_loss,
                train_chunks=train_chunks, train_shared=train_shared)
    return want, results, tmp


@pytest.mark.parametrize("axis", ["data", "fsdp"])
def test_pipe2_with_data_or_fsdp_equals_pipe1(four_ranks, axis):
    """Losses, grad norms and parameters after three steps equal the
    pipe-1 run; each rank holds only its stage's layers, and under fsdp
    half of each leaf with an embed dim."""
    want, results, tmp = four_ranks
    for rank, result in enumerate(results):
        got = result[axis]
        np.testing.assert_allclose(got["history"], want["history"], **TOL)
        stage = got["coord"]["pipe"]
        layers = {stage, 2 + stage}
        blocks = {n.split(".")[0] for n in got["names"]
                  if n.startswith("layer_")}
        assert blocks == {f"layer_{i}" for i in layers}, (rank, blocks)
        params = dict(np.load(tmp / f"{axis}-{rank}.npz"))
        _assert_close(params, {n: want["params"][n] for n in params}, axis)
        if axis == "fsdp":
            assert "embed" in got["sharded"] and \
                "layer_%d.attn.q_proj.kernel" % min(layers) in got["sharded"]
            for name in got["sharded"]:
                assert got["local"][name] * 2 == got["full"][name], name
        else:
            assert got["sharded"] == []


def test_pipeline_apply_at_four_stages_matches_jax(four_ranks):
    want, _, tmp = four_ranks
    for rank in range(4):
        got = dict(np.load(tmp / f"apply-{rank}.npz"))
        np.testing.assert_allclose(got.pop("out"), want["apply_out"], **TOL)
        _assert_close(got, {k: v[rank] for k, v in
                            want["apply_grads"].items()}, "apply")


def test_pipeline_train_at_four_stages_two_rounds_matches_jax(four_ranks):
    want, _, tmp = four_ranks
    for rank in range(4):
        got = dict(np.load(tmp / f"train-{rank}.npz"))
        np.testing.assert_allclose(got.pop("loss"), want["train_loss"],
                                   **TOL)
        _assert_close(
            got, {**{"chunks/" + k: v[:, rank]
                     for k, v in want["train_chunks"].items()},
                  **{"shared/" + k: v
                     for k, v in want["train_shared"].items()}}, "train")


# ---------------------------------------------------------------------------
# the elastic loop at pipe 2
# ---------------------------------------------------------------------------

LOOP_WORKER = PORT_CONFIGS + """
import tempfile
from dlrover_tpu_torch.trainer.elastic_loop import (ElasticTrainLoop,
                                                    TrainLoopConfig)


class InfoClient:
    def __init__(self):
        self.model_info = []

    def report_model_info(self, **kwargs):
        self.model_info.append(kwargs)
        return True

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


ckpt = sys.argv[1]
data = np.load("batches.npz")
batches = list(zip(data["tokens"], data["targets"]))
cfg = CONFIGS["llama"][0]


def loop(steps, directory, client=None):
    return ElasticTrainLoop(
        llama.Llama(cfg, device="meta"), None, None,
        TrainLoopConfig(global_batch=8, seq_len=16, max_micro_per_replica=2,
                        max_steps=steps, checkpoint_dir=directory,
                        save_interval_steps=2, report_interval_steps=0),
        master_client=client, trainer=trainer_of("llama", {"pipe": 2}, 2))


client = InfoClient()
whole = loop(4, "", client)
state, _ = whole.restore_or_init(0)
state, ref = whole.run(state, iter(batches))
whole.close()
first = loop(2, ckpt)
s1, _ = first.restore_or_init(0)
s1, m1 = first.run(s1, iter(batches[:2]))
first.close()
second = loop(2, ckpt)
s2, start = second.restore_or_init(0)
s2, m2 = second.run(s2, iter(batches[2:]), start_step=start)
second.close()
same = all(torch.equal(p, q) for p, q in zip(state.model.parameters(),
                                              s2.model.parameters()))
print(json.dumps({
    "info": {k: v for k, v in client.model_info[0].items()
             if isinstance(v, (int, float, str))},
    "start": start, "source": second.last_restore_source,
    "ref": [[r["loss"], r["grad_norm"]] for r in ref["history"]],
    "resumed": [[r["loss"], r["grad_norm"]]
                for r in m1["history"] + m2["history"]],
    "params_equal": same,
    "keys": sorted(n for n, _ in s2.model.named_parameters())}))
"""


@pytest.fixture(scope="module")
def loop_pipe2(tmp_path_factory, cpu_devices):
    tmp = tmp_path_factory.mktemp("loop")
    batches = [_batch(256, seed) for seed in range(4)]
    np.savez(tmp / "batches.npz", tokens=np.stack([b[0] for b in batches]),
             targets=np.stack([b[1] for b in batches]))
    results = run_workers(tmp, LOOP_WORKER, 2, args=[str(tmp / "ckpt")],
                          timeout=LAUNCH_TIMEOUT_S, name="loop")
    return results, tmp


class _InfoClient:
    """The MasterClient surface the JAX loop calls at construction."""

    def __init__(self):
        self.model_info = []

    def report_model_info(self, **kwargs):
        self.model_info.append(kwargs)
        return True

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def test_loop_reports_the_jax_loops_model_info(loop_pipe2, cpu_devices):
    """The pipelined trainer injected into both loops at pipe 2: the
    parameter count over every stage, the FLOPs model from the loop's
    model argument, the same on both ranks."""
    results, _ = loop_pipe2
    jcfg = _configs("llama")[0]
    mesh = jcreate_mesh(JMeshSpec(pipe=2), cpu_devices[:2])
    jtr = jpt.build_pipeline_trainer(jcfg, optax.adamw(LR, weight_decay=WD),
                                     mesh, M, MICRO, SEQ,
                                     jllama.cross_entropy_loss, num_rounds=2)
    client = _InfoClient()
    jl = jloop.ElasticTrainLoop(
        jllama.Llama(jcfg), None, jllama.cross_entropy_loss,
        jloop.TrainLoopConfig(global_batch=8, seq_len=SEQ,
                              max_micro_per_replica=MICRO),
        master_client=client, devices=cpu_devices[:2], trainer=jtr)
    jl.close()
    want = client.model_info[0]
    for result in results:
        got = result["info"]
        for key in ("param_count", "param_bytes", "flops_per_token",
                    "flops_per_step", "tensor_divisor", "fsdp_divisor",
                    "batch_size", "seq_len", "effective_global_batch"):
            assert got[key] == want[key], key
    assert results[0]["info"]["param_count"] == _configs("llama")[1] \
        .param_count()


def test_loop_resumes_the_pipelined_state_bit_for_bit(loop_pipe2):
    """2 steps saving at 2, a new loop from the checkpoint, 2 more: the
    uninterrupted run's losses, grad norms and parameters, bit for bit,
    each rank holding its own stage's keys."""
    results, _ = loop_pipe2
    for rank, result in enumerate(results):
        assert result["start"] == 2 and result["source"] == "checkpoint"
        assert result["resumed"] == result["ref"]
        assert result["params_equal"]
        blocks = {n.split(".")[0] for n in result["keys"]
                  if n.startswith("layer_")}
        assert blocks == {f"layer_{i}" for i in (rank, 2 + rank)}
