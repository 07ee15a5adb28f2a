"""The port's RMSNorm (dlrover_tpu_torch.ops.norms) against the JAX
package's, on the CPU.

On the CPU the port's wrappers run their plain versions; the JAX side
runs its Pallas kernels (``_rms_fwd``, ``_rms_bwd_vjp``) in interpret
mode, as tests/test_ops.py does. The same numpy inputs go to both.

Tolerances. f32: the forward (y, rstd) within 1e-6 absolute and
relative, the backward (dx, dw) within 1e-5 — the same f32 arithmetic
with the row sums taken in another order, a few ulps (1e-7) each, and dw
a sum over up to 100 rows. bf16: y and dx within one bf16 ulp of the
reference's value — both round the same f32 value once, so they differ
only where the f32 values straddle a rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.ops import norms as jnorms
from dlrover_tpu_torch import convert
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.ops import norms as tnorms

EPS = 1e-5
FWD_TOL = dict(atol=1e-6, rtol=1e-6)
BWD_TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(6, 32), (3, 5, 64), (100, 2048)]
SHAPE_IDS = ["x".join(map(str, s)) for s in SHAPES]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, np.float32) * 2.0
    w = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    g = rng.standard_normal(shape, np.float32)
    return x, w, g


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _assert_within_bf16_ulp(got, want):
    """|got − want| <= one bf16 ulp of want (bf16 keeps 8 of f32's 24
    significand bits, so its ulp is 2^16 f32 ulps)."""
    got, want = _np(got), _np(want)
    ulp = np.maximum(np.abs(np.spacing(want)) * 2.0 ** 16,
                     np.finfo(np.float32).tiny)
    worst = (np.abs(got - want) / ulp).max()
    assert worst <= 1.0, f"{worst} bf16 ulps apart"


def _jax_fwd_bwd(x, w, g, jdtype):
    jx, jg = jnp.asarray(x, jdtype), jnp.asarray(g, jdtype)
    y, res = jnorms._rms_fwd(jx, jnp.asarray(w), EPS)
    dx, dw = jnorms._rms_bwd_vjp(EPS, res, jg)
    return y, res[2], dx, dw


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_kernels_match_pallas(shape, dtype):
    jdtype, tdtype = DTYPES[dtype]
    x, w, g = _inputs(shape)
    jy, jrstd, jdx, jdw = _jax_fwd_bwd(x, w, g, jdtype)
    dim = shape[-1]
    tx, tg = (_t(a, tdtype).reshape(-1, dim) for a in (x, g))
    y, rstd = tnorms.rms_fwd(tx, _t(w), EPS)
    assert y.dtype == tdtype and rstd.dtype == torch.float32
    assert tuple(rstd.shape) == (tx.shape[0], 1)
    np.testing.assert_allclose(_np(rstd), _np(jrstd), **FWD_TOL)
    # the backward takes the reference's own rstd, so it is held alone
    dx, dw = tnorms.rms_bwd(tx, _t(w), _t(_np(jrstd)), tg)
    assert dx.dtype == tdtype and dw.dtype == torch.float32
    np.testing.assert_allclose(_np(dw), _np(jdw), **BWD_TOL)
    jy, jdx = _np(jy).reshape(-1, dim), _np(jdx).reshape(-1, dim)
    if dtype == "f32":
        np.testing.assert_allclose(_np(y), jy, **FWD_TOL)
        np.testing.assert_allclose(_np(dx), jdx, **BWD_TOL)
    else:
        _assert_within_bf16_ulp(y, jy)
        _assert_within_bf16_ulp(dx, jdx)


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 48, 32)])
def test_autograd_matches_jax_grad(shape):
    x, w, g = _inputs(shape, seed=1)

    def jloss(a, b):
        return jnp.sum(jnorms.fused_rms_norm(a, b, EPS) * jnp.asarray(g))

    jy = jnorms.fused_rms_norm(jnp.asarray(x), jnp.asarray(w), EPS)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = tnorms.fused_rms_norm(tx, tw, EPS)
    (y * _t(g)).sum().backward()
    assert y.shape == shape
    np.testing.assert_allclose(_np(y), _np(jy), **FWD_TOL)
    np.testing.assert_allclose(_np(tx.grad), _np(jdx), **BWD_TOL)
    np.testing.assert_allclose(_np(tw.grad), _np(jdw), **BWD_TOL)


def test_gradcheck_float64():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 16))).requires_grad_()
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 16)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: tnorms.FusedRMSNormFn.apply(a, b, EPS), (x, w))


def test_default_eps_is_the_reference_default():
    x, w, _ = _inputs((6, 32), seed=3)
    want = jnorms.fused_rms_norm(jnp.asarray(x), jnp.asarray(w))
    got = tnorms.fused_rms_norm(_t(x), _t(w))
    np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL)


def test_cpu_tensors_launch_nothing():
    tnorms.reset_launch_counts()
    x, w, g = _inputs((2, 8, 32), seed=4)
    tx = _t(x).requires_grad_()
    (tnorms.fused_rms_norm(tx, _t(w)) * _t(g)).sum().backward()
    assert tx.grad is not None
    assert tnorms.launch_counts == {"rms_fwd": 0, "rms_bwd": 0}


@pytest.mark.parametrize("case", ["x_1d", "w_shape", "rstd_shape",
                                  "g_shape"])
def test_wrappers_reject_bad_shapes(case):
    x, w = torch.zeros(4, 8), torch.ones(8)
    rstd, g = torch.ones(4, 1), torch.zeros(4, 8)
    with pytest.raises(ValueError):
        if case == "x_1d":
            tnorms.rms_fwd(torch.zeros(8), w, EPS)
        elif case == "w_shape":
            tnorms.rms_fwd(x, torch.ones(4), EPS)
        elif case == "rstd_shape":
            tnorms.rms_bwd(x, w, torch.ones(4), g)
        else:
            tnorms.rms_bwd(x, w, rstd, torch.zeros(4, 4))


def test_f32_tolerance_passes_order_and_rejects_a_lost_block():
    """The card's f32 limit passes dw summed in another order (per-block
    partials of 64 rows, then the partials) and rejects a dw that lost one
    block's rows, the fault a wrong partial sum would make."""
    x, w, g = _inputs((2048, 256), seed=5)
    tx, tg = _t(x), _t(g)
    _, rstd = tnorms.rms_fwd_plain(tx, _t(w), EPS)
    _, dw = tnorms.rms_bwd_plain(tx, _t(w), rstd, tg)
    xhat = tx * rstd
    parts = (tg * xhat).reshape(32, 64, 256).sum(dim=1)
    blocked = torch.zeros(256)
    for p in parts:
        blocked = blocked + p
    assert tnorms.f32_error(blocked, dw)["worst"] <= 1.0
    assert tnorms.f32_error(blocked - parts[7], dw)["worst"] > 10.0


def _jax_params(jcfg, tokens):
    import flax.linen as nn

    variables = jllama.Llama(jcfg).init(jax.random.PRNGKey(0),
                                        jnp.asarray(tokens))
    return jax.tree.map(np.asarray, nn.unbox(variables["params"]))


def test_tiny_llama_fused_norm_matches_jax():
    """Logits and every parameter's gradient of one loss, the port's
    fused norm (FusedRMSNormFn, plain versions) against the JAX model in
    f32 (its norm is the plain one off the TPU; the hand-written backward
    is what differs)."""
    jcfg = jllama.LlamaConfig.tiny(norm_impl="fused", dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(norm_impl="fused", dtype=torch.float32)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 32), dtype=np.int32)
    targets = rng.integers(0, jcfg.vocab_size, (2, 32), dtype=np.int32)
    params = _jax_params(jcfg, tokens)

    def jloss(p):
        logits = jllama.Llama(jcfg).apply({"params": p}, jnp.asarray(tokens))
        return jllama.cross_entropy_loss(logits, jnp.asarray(targets)), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(params), strict=True)
    logits = model(torch.from_numpy(tokens).long())
    tllama.cross_entropy_loss(logits, torch.from_numpy(targets)).backward()
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), atol=1e-4,
                               rtol=1e-4)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads))
    names = dict(model.named_parameters())
    assert set(want) == set(names)
    assert "layer_1.mlp_norm.weight" in want and "final_norm.weight" in want
    for name, grad in want.items():
        np.testing.assert_allclose(_np(names[name].grad), grad.numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=name)
