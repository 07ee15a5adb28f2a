"""The port's per-leaf optimizers (dlrover_tpu_torch.optim) against optax
and dlrover_tpu.optim on the CPU.

The same leaves and five gradients, made from a seed with numpy, go
through each JAX transformation and the port's LeafOptimizer. Both run
the same f32 arithmetic element by element; the reductions (the
factored row and column means, the global norm) sum in another order,
and a pow may differ by an ulp, so the parameters are held within 1e-5
relative and 1e-7 absolute (tens of f32 ulps after five updates of
size lr). What the optimizers promise exactly is held exactly: a
sparse optimizer's untouched rows, bf16_master's bf16 parameters (the
same bits as JAX's), WSAM's parameters after the call.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.distributed.checkpoint.state_dict import (
    get_state_dict,
    set_optimizer_state_dict,
)

from dlrover_tpu import optim as joptim
from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch import convert, optim
from dlrover_tpu_torch.models import llama as tllama

TOL = dict(rtol=1e-5, atol=1e-7)
STEPS = 5

# a factored 2-D leaf, a 2-D leaf under 128 wide (unfactored), a 3-D
# leaf (factored over its two largest dims) and a 1-D one
SHAPES = {"w": (256, 160), "narrow": (64, 100), "cube": (3, 130, 140),
          "bias": (200,)}


def _leaves(seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _grads(shapes=SHAPES, seed=1, zero_rows=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        step = {}
        for k, s in shapes.items():
            g = rng.standard_normal(s).astype(np.float32)
            if zero_rows and len(s) >= 2:
                g[rng.random(s[0]) < 0.5] = 0.0
            elif zero_rows and rng.random() < 0.5:
                g[:] = 0.0
            step[k] = g
        out.append(step)
    return out


def _run_jax(tx, params, grads):
    params = jax.tree.map(jnp.asarray, params)
    state = tx.init(params)
    history = []
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   params)
        params = optax.apply_updates(params, updates)
        history.append(jax.tree.map(np.asarray, params))
    return history, state


def _run_port(transform, params, grads, dtype=torch.float32):
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype))
               for k, v in params.items()}
    opt = optim.LeafOptimizer(list(tensors.values()), transform)
    history = []
    for g in grads:
        for k, p in tensors.items():
            p.grad = torch.from_numpy(np.asarray(g[k], np.float32)).to(dtype)
        opt.step()
        history.append({k: p.detach().clone() for k, p in tensors.items()})
    return history, opt, tensors


def _assert_close(port_hist, jax_hist, tol=TOL):
    for step, (got, want) in enumerate(zip(port_hist, jax_hist)):
        for k in want:
            np.testing.assert_allclose(
                got[k].float().numpy(), np.asarray(want[k], np.float32),
                err_msg=f"{k} after update {step + 1}", **tol)


@pytest.mark.parametrize("kw", [dict(), dict(min_dim_size_to_factor=64),
                                dict(decay_rate=0.5, epsilon=1e-20)])
def test_factored_rms_matches_optax(kw):
    params, grads = _leaves(), _grads()
    tx = optax.chain(optax.scale_by_factored_rms(**kw), optax.scale(-3e-2))
    want, jstate = _run_jax(tx, params, grads)
    got, opt, tensors = _run_port(optim.factored_rms(3e-2, **kw), params,
                                  grads)
    _assert_close(got, want)
    # the state, leaf by leaf, in optax's layout
    fstate = jstate[0]
    for k, p in tensors.items():
        state = opt.state[p]
        assert state["count"].dtype == torch.int32
        assert int(state["count"]) == int(fstate.count) == STEPS
        for name in ("v_row", "v_col", "v"):
            np.testing.assert_allclose(
                state[name].numpy(), np.asarray(getattr(fstate, name)[k]),
                rtol=1e-5, atol=0, err_msg=f"{k}.{name}")


@pytest.mark.parametrize("kw", [
    dict(), dict(min_dim_size_to_factor=64), dict(clipping_threshold=None),
    dict(clipping_threshold=0.5),
])
def test_adafactor_matches_optax(kw):
    """optax.adafactor's chain on a factored 2-D leaf, a 2-D leaf under
    min_dim_size_to_factor, a 3-D (expert-shaped) leaf factored over its
    two largest dims and a 1-D leaf; the state converts leaf for leaf."""
    params, grads = _leaves(), _grads()
    want, jstate = _run_jax(optax.adafactor(3e-2, **kw), params, grads)
    got, opt, tensors = _run_port(optim.adafactor(3e-2, **kw), params,
                                  grads)
    _assert_close(got, want)
    converted = convert.factored_state_from_jax(
        jax.tree.map(np.asarray, jstate))
    for k, p in tensors.items():
        for name in ("count", "v_row", "v_col", "v"):
            np.testing.assert_allclose(
                opt.state[p][name].numpy(), converted[k][name].numpy(),
                rtol=1e-5, atol=0, err_msg=f"{k}.{name}")


def test_adafactor_clip_bites_as_optax_does():
    """A second gradient 100 times the first: each leaf's update RMS
    passes 1 (the decayed statistics lag), so clip_by_block_rms(1.0)
    divides it, in both; without the clip the parameters move further."""
    params, grads = _leaves(), _grads()
    grads[1] = {k: 100.0 * g for k, g in grads[1].items()}
    want, _ = _run_jax(optax.adafactor(3e-2), params, grads)
    got, _, _ = _run_port(optim.adafactor(3e-2), params, grads)
    _assert_close(got, want)
    unclipped, _, _ = _run_port(optim.adafactor(3e-2,
                                                clipping_threshold=None),
                                params, grads)
    for k in params:
        moved = (got[1][k] - got[0][k]).abs().sum()
        moved_unclipped = (unclipped[1][k] - unclipped[0][k]).abs().sum()
        assert moved < moved_unclipped, k


def test_factored_dims_follow_optax():
    from optax._src.factorized import _factored_dims

    from dlrover_tpu_torch.optim.factored import factored_dims

    for shape in [(256, 160), (64, 100), (3, 130, 140), (200,), (128, 128),
                  (130, 4, 129), (4096, 11008), (32000, 4096)]:
        assert factored_dims(shape, 128) == _factored_dims(shape, True, 128)


def test_agd_matches_dlrover_tpu():
    params, grads = _leaves(), _grads()
    for wd in (0.0, 0.01):
        want, _ = _run_jax(joptim.agd(1e-2, weight_decay=wd), params, grads)
        got, _, _ = _run_port(optim.agd(1e-2, weight_decay=wd), params,
                              grads)
        _assert_close(got, want)


@pytest.mark.parametrize("name", ["adagrad", "adam", "sgd"])
def test_row_sparse_optimizers_match_and_keep_untouched_rows(name):
    params, grads = _leaves(), _grads(zero_rows=True)
    jtx = {"adagrad": joptim.row_sparse_adagrad(0.1),
           "adam": joptim.row_sparse_adam(1e-2),
           "sgd": joptim.row_sparse_sgd(0.05)}[name]
    ttx = {"adagrad": optim.row_sparse_adagrad(0.1),
           "adam": optim.row_sparse_adam(1e-2),
           "sgd": optim.row_sparse_sgd(0.05)}[name]
    want, _ = _run_jax(jtx, params, grads)
    got, opt, tensors = _run_port(ttx, params, grads)
    _assert_close(got, want)
    # an untouched row (a 1-D leaf: the whole leaf) keeps its bits, state
    # included, through one more update
    before = {k: (p.detach().clone(),
                  {n: v.clone() for n, v in opt.state[p].items()})
              for k, p in tensors.items()}
    last = _grads(seed=7, zero_rows=True)[0]
    for k, p in tensors.items():
        p.grad = torch.from_numpy(last[k])
    opt.step()
    untouched = 0
    for k, p in tensors.items():
        g = torch.from_numpy(last[k])
        rows = (g.reshape(g.shape[0], -1) == 0).all(-1) if g.dim() >= 2 \
            else (g == 0).all().reshape(1)
        old_p, old_state = before[k]
        flat = (lambda t: t.reshape(rows.shape[0], -1)) if g.dim() >= 2 \
            else (lambda t: t.reshape(1, -1))
        assert torch.equal(flat(p.detach())[rows], flat(old_p)[rows]), k
        for n, v in opt.state[p].items():
            if v.dim() >= 1 and v.shape[0] == rows.shape[0] or g.dim() < 2:
                assert torch.equal(flat(v)[rows], flat(old_state[n])[rows]), \
                    f"{k}.{n}"
        untouched += int(rows.sum())
    assert untouched > 0


def test_bf16_master_image_matches_jax_bit_for_bit():
    """The bf16 parameters after each update are JAX's bits: both apply
    the emitted delta bf16(master') − p in bf16, which rounds (so the
    image is not always bf16(master') in either package); the f32
    masters agree within TOL."""
    def to_bf16(tree):
        return {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16))
                for k, v in tree.items()}

    # bf16 parameters and gradients on both sides
    bf16, grads = to_bf16(_leaves()), [to_bf16(g) for g in _grads()]
    want, jstate = _run_jax(joptim.bf16_master(joptim.agd(1e-2)), bf16,
                            grads)
    got, opt, tensors = _run_port(
        optim.bf16_master(optim.agd(1e-2)),
        {k: np.asarray(v, np.float32) for k, v in bf16.items()}, grads,
        dtype=torch.bfloat16)
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert g[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                g[k].float().numpy(), np.asarray(w[k], np.float32),
                err_msg=f"{k} after update {step + 1}")
    for k, p in tensors.items():
        master = opt.state[p]["master"]
        assert master.dtype == torch.float32
        np.testing.assert_allclose(
            master.numpy(), np.asarray(jstate.master[k]), **TOL)


def test_sqrt_rn_is_xlas_correctly_rounded_root():
    """The bf16 image's old one-ulp misses came from torch's vectorised
    CPU sqrt, which is one f32 ulp off on about a sixth of its inputs;
    AGD's and the row-sparse optimizers' roots go through ``sqrt_rn``,
    which is JAX's (and numpy's) correctly rounded root bit for bit."""
    rng = np.random.default_rng(7)
    v = (np.abs(rng.standard_normal(40960)) *
         10.0 ** rng.integers(-12, 3, 40960)).astype(np.float32)
    got = optim.base.sqrt_rn(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(v))
    np.testing.assert_array_equal(got, np.asarray(jnp.sqrt(jnp.asarray(v))))


def test_leaf_optimizer_state_round_trips_with_its_dtypes():
    """A checkpoint's restore (DCP's set_optimizer_state_dict) keeps the
    int32 counts and the f32 master of a bf16 parameter, which torch's
    own load_state_dict would cast to the parameter's dtype."""
    model = torch.nn.Linear(8, 4).to(torch.bfloat16)
    make = functools.partial(optim.LeafOptimizer,
                             transform=optim.bf16_master(
                                 optim.factored_rms(1e-2)))
    opt = make(model.parameters())
    for _ in range(2):
        model(torch.ones(3, 8, dtype=torch.bfloat16)).sum().backward()
        opt.step()
    _, osd = get_state_dict(model, opt)
    fresh = torch.nn.Linear(8, 4).to(torch.bfloat16)
    fresh_opt = make(fresh.parameters())
    set_optimizer_state_dict(fresh, fresh_opt, osd)
    for p, q in zip(model.parameters(), fresh.parameters()):
        a, b = opt.state[p], fresh_opt.state[q]
        assert a.keys() == b.keys()
        for name in a:
            assert b[name].dtype == a[name].dtype, name
            assert torch.equal(a[name], b[name]), name
    assert fresh_opt.state[next(fresh.parameters())]["master"].dtype \
        == torch.float32
    assert fresh_opt.state[next(fresh.parameters())]["inner_count"].dtype \
        == torch.int32


def test_wsam_gradient_matches_jax_on_tiny_llama():
    jcfg = jllama.LlamaConfig.tiny(attn_impl="reference",
                                   norm_impl="reference",
                                   dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(attn_impl="reference",
                                   norm_impl="reference",
                                   dtype=torch.float32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    targets = rng.integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    jmodel = jllama.Llama(jcfg)
    params = jax.tree.map(np.asarray, nn.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]))

    def jloss(p, tok, tgt):
        return jllama.cross_entropy_loss(jmodel.apply({"params": p}, tok),
                                         tgt)

    jl, jg = jax.jit(joptim.wsam_value_and_grad(jloss, rho=0.05,
                                                gamma=0.7))(
        params, jnp.asarray(tokens), jnp.asarray(targets))

    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(params), strict=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    def tloss(m, tok, tgt):
        return tllama.cross_entropy_loss(m(tok), tgt)

    tl, tg = optim.wsam_value_and_grad(tloss, rho=0.05, gamma=0.7)(
        model, torch.from_numpy(tokens).long(),
        torch.from_numpy(targets).long())
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(tg) == set(want)
    for n, g in tg.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)
    with pytest.raises(ValueError):
        optim.wsam_value_and_grad(tloss, gamma=1.0)


def test_leaf_optimizer_trains_through_build_trainer():
    """factored_rms as build_trainer's optimizer: the dense step's
    parameters after three updates equal the same updates applied by
    hand."""
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    cfg = tllama.LlamaConfig.tiny(attn_impl="reference",
                                  norm_impl="reference",
                                  dtype=torch.float32)
    make = functools.partial(optim.LeafOptimizer,
                             transform=optim.factored_rms(1e-2))
    trainer = build_trainer(functools.partial(tllama.Llama, cfg), make,
                            None, np.zeros((2, 16)),
                            tllama.cross_entropy_loss, micro_batch=2,
                            device="cpu")
    state = trainer.init(0)
    model = tllama.Llama(cfg, device="cpu", seed=0)
    opt = make(model.parameters())
    rng = np.random.default_rng(3)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 16))
        tgt = rng.integers(0, cfg.vocab_size, (2, 16))
        state, metrics = trainer.step(state, *trainer.shard_batch(tok, tgt))
        model.zero_grad()
        tllama.cross_entropy_loss(model(torch.from_numpy(tok)),
                                  torch.from_numpy(tgt)).backward()
        opt.step()
    for (n, p), q in zip(state.model.named_parameters(),
                         model.parameters()):
        assert torch.equal(p.detach(), q.detach()), n
