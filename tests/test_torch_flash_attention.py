"""The port's flash attention (dlrover_tpu_torch.ops.flash_attention)
against the JAX package's, on the CPU.

On the CPU the port's wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode (as tests/test_ops.py does),
with 64-row blocks so the online softmax crosses several kv blocks. The
same numpy inputs go to both.

Tolerances: f32 at 2e-5 absolute and relative — the two sides do the
same f32 arithmetic in a different order (full rows here, 64-wide
blocks in the reference). bf16 at 2e-2 — both round P and dS to bf16,
but from differently ordered f32 sums, so a value may land one bf16 ulp
(2^-8 relative) apart.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops import flash_attention as tfa

# the package's __init__ re-exports the function under the module's name
jfa = importlib.import_module("dlrover_tpu.ops.flash_attention")

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
BLOCK = 64

# (causal, heads, kv_heads, seq_q, seq_k)
CASES = [
    (True, 2, 2, 128, 128),
    (False, 2, 2, 128, 128),
    (True, 4, 2, 128, 128),      # GQA 4/2
    (False, 4, 2, 192, 192),
    (True, 2, 2, 192, 192),
    (True, 2, 2, 64, 256),       # cross lengths, top-left causal
    (True, 2, 2, 256, 64),
    (False, 2, 2, 64, 256),
]
CASE_IDS = [f"{'causal' if c else 'full'}-h{h}kv{hk}-q{sq}k{sk}"
            for c, h, hk, sq, sk in CASES]


def _inputs(heads, kv_heads, seq_q, seq_k, dim=64, batch=1, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, heads, seq_q, dim), np.float32)
    k = rng.standard_normal((batch, kv_heads, seq_k, dim), np.float32)
    v = rng.standard_normal((batch, kv_heads, seq_k, dim), np.float32)
    do = rng.standard_normal((batch, heads, seq_q, dim), np.float32)
    return q, k, v, do


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_fwd_bwd(q, k, v, do, causal, dtype=jnp.float32):
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, lse = jfa._flash_fwd(jq, jk, jv, scale, causal, BLOCK, BLOCK)
    dq, dk, dv = jfa._flash_bwd((jq, jk, jv, o, lse), jdo, sm_scale=scale,
                                causal=causal, block_q=BLOCK, block_k=BLOCK)
    return o, lse, dq, dk, dv


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_kernels_match_pallas_f32(case):
    causal, heads, kv_heads, seq_q, seq_k = case
    q, k, v, do = _inputs(heads, kv_heads, seq_q, seq_k)
    jo, jlse, jdq, jdk, jdv = _jax_fwd_bwd(q, k, v, do, causal)

    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    o, lse = tfa.flash_fwd(tq, tk, tv, causal)
    np.testing.assert_allclose(_np(o), _np(jo), **F32_TOL)
    np.testing.assert_allclose(_np(lse), _np(jlse), **F32_TOL)
    assert lse.shape == (1, heads, seq_q, 1) and lse.dtype == torch.float32

    # the backward kernels take the reference's own lse and delta
    lse_ref = _t(_np(jlse))
    delta = (tdo * _t(_np(jo))).sum(-1, keepdim=True)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tdo, lse_ref, delta, causal)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tdo, lse_ref, delta, causal)
    np.testing.assert_allclose(_np(dq), _np(jdq), **F32_TOL)
    np.testing.assert_allclose(_np(dk), _np(jdk), **F32_TOL)
    np.testing.assert_allclose(_np(dv), _np(jdv), **F32_TOL)


def test_plain_kernels_match_pallas_bf16():
    q, k, v, do = _inputs(4, 2, 128, 128, seed=1)
    jo, jlse, jdq, jdk, jdv = _jax_fwd_bwd(q, k, v, do, True, jnp.bfloat16)
    tq, tk, tv, tdo = (_t(x, torch.bfloat16) for x in (q, k, v, do))
    o, lse = tfa.flash_fwd(tq, tk, tv, True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(o), _np(jo), **BF16_TOL)
    np.testing.assert_allclose(_np(lse), _np(jlse), **F32_TOL)
    lse_ref = _t(_np(jlse))
    delta = (tdo.float() * _t(_np(jo))).sum(-1, keepdim=True)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tdo, lse_ref, delta, True)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tdo, lse_ref, delta, True)
    # the reference rounds each query head's dK/dV to bf16 before the
    # GQA group sum, the port sums in f32 first: allow that extra ulp
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(_np(got), _np(want), atol=4e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("causal,heads,kv_heads,seq", [
    (True, 4, 2, 128), (False, 2, 2, 192), (True, 2, 2, 192)])
def test_autograd_matches_jax_grad(causal, heads, kv_heads, seq):
    q, k, v, do = _inputs(heads, kv_heads, seq, seq, seed=2)

    def jloss(a, b, c):
        o = jfa.flash_attention(a, b, c, causal, None, BLOCK, BLOCK)
        return jnp.sum(o * jnp.asarray(do))

    jo = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, None, BLOCK, BLOCK)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal)
    (o * _t(do)).sum().backward()
    np.testing.assert_allclose(_np(o), _np(jo), **F32_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    q, k, v, _ = _inputs(4, 2, 64, 128, seed=3)
    want = jfa.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal)
    got = tfa.reference_attention(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def _tiled_fwd(q, k, v, rescale=True, tile=64):
    """Causal online softmax over key tiles, P rounded to bf16 before P·V
    as the CUDA kernel does; ``rescale=False`` forgets to rescale the
    accumulator when the running max grows."""
    s = tfa._scores_log2(q, k, 1.0 / np.sqrt(q.shape[-1]), True)
    m = torch.full(s.shape[:-1] + (1,), tfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for j in range(0, k.shape[2], tile):
        m_new = torch.maximum(m, s[..., j:j + tile].amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s[..., j:j + tile] - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = (acc * alpha if rescale else acc) + torch.matmul(
            p.to(v.dtype).float(), v[..., j:j + tile, :].float())
        m = m_new
    return (acc / l).to(q.dtype)


def _bf16_case(seq=512):
    q, k, v, do = (_t(x, torch.bfloat16)
                   for x in _inputs(2, 2, seq, seq, seed=4))
    o, lse = tfa.flash_fwd_plain(q, k, v)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return q, k, v, do, o, lse, delta


def test_bf16_tolerance_passes_rounding_differences():
    """The card's limit passes what a right kernel differs by: the same
    attention rounded in another order."""
    q, k, v, _, o, _, _ = _bf16_case()
    for got in (_tiled_fwd(q, k, v), tfa.reference_attention(q, k, v)):
        err = tfa.bf16_error(got, o)
        assert tfa.bf16_within_tolerance(err), err


def test_bf16_tolerance_passes_128_row_tiles():
    """The wgmma forward's online softmax steps over 128-row kv tiles:
    that order of rounding passes too."""
    q, k, v, _, o, _, _ = _bf16_case()
    err = tfa.bf16_error(_tiled_fwd(q, k, v, tile=128), o)
    assert tfa.bf16_within_tolerance(err), err


def _tiled_dq(q, k, v, do, lse, delta, k_lag=0, tile=128):
    """dQ summed over kv tiles in order, in f32, dS rounded to bf16 and
    dQ cast once, as the wgmma dQ kernel does (128-row tiles); ``k_lag=1``
    takes dS·K with the previous tile's K."""
    _, ds = tfa._probs_and_ds(q, k, v, do, lse, delta,
                              1.0 / np.sqrt(q.shape[-1]), True)
    ds = ds.to(k.dtype).float()
    dq = torch.zeros(q.shape)
    for j in range(0, k.shape[2], tile):
        jk = max(j - k_lag * tile, 0)
        dq += torch.matmul(ds[..., j:j + tile], k[:, :, jk:jk + tile].float())
    return dq.to(q.dtype)


@pytest.mark.parametrize("tile", [64, 128])
def test_bf16_tolerance_passes_dq_over_kv_tiles(tile):
    """The wgmma dQ kernel sums dS·K over kv tiles in order, in f32:
    that order of summation passes at 64- and 128-row tiles."""
    q, k, v, do, _, lse, delta = _bf16_case()
    err = tfa.bf16_error(_tiled_dq(q, k, v, do, lse, delta, tile=tile),
                         tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta))
    assert tfa.bf16_within_tolerance(err), err


def _swizzle_misread(t):
    """``t`` as a kernel reads a 128B-swizzled tile without undoing the
    swizzle: in row r, 8-column chunk c of each 64-column half holds
    chunk c ^ (r % 8)."""
    s, d = t.shape[2], t.shape[3]
    rows = torch.arange(s).view(s, 1, 1)
    chunk = torch.arange(8).view(1, 1, 8) ^ (rows % 8)
    cols = (torch.arange(d // 64).view(1, -1, 1) * 64 + chunk * 8)
    cols = (cols.unsqueeze(-1) + torch.arange(8)).reshape(s, d)
    return torch.gather(t, 3, cols.expand(t.shape))


@pytest.mark.parametrize("fault", ["missed_rescale", "dkv_late_queries",
                                   "dq_last_kv_tile", "o_ragged_rows",
                                   "stale_ring_stage", "swizzle_chunks",
                                   "second_warpgroup_rows",
                                   "dkv_wrong_q_tile_stats",
                                   "dq_stale_ring_stage",
                                   "dq_row_stats_swapped",
                                   "dq_k_tile_repeated"])
def test_bf16_tolerance_rejects_kernel_faults(fault):
    """The limit scales with the reference's RMS, not with its causal
    outliers (row 0 of o, key 0 of dK/dV), so a fault of typical size
    on part of the tensor fails it."""
    q, k, v, do, o, lse, delta = _bf16_case()
    half, s = q.shape[2] // 2, q.shape[2]
    if fault == "stale_ring_stage":       # kv tile 2 read from tile 0's stage
        ks, vs = k.clone(), v.clone()
        ks[:, :, 256:384], vs[:, :, 256:384] = k[:, :, 0:128], v[:, :, 0:128]
        got, want = tfa.flash_fwd_plain(q, ks, vs)[0], o
    elif fault == "swizzle_chunks":       # K read without undoing the swizzle
        got, want = tfa.flash_fwd_plain(q, _swizzle_misread(k), v)[0], o
    elif fault == "second_warpgroup_rows":  # rows 64-127 of a tile = 0-63
        got, want = o.clone(), o
        for t0 in range(0, s, 128):
            got[:, :, t0 + 64:t0 + 128] = o[:, :, t0:t0 + 64]
    elif fault == "dkv_wrong_q_tile_stats":  # lse, delta of q tile i - 1
        lse_w, delta_w = lse.clone(), delta.clone()
        lse_w[:, :, 64:], delta_w[:, :, 64:] = lse[:, :, :-64], delta[:, :, :-64]
        got = tfa.flash_bwd_dkv_plain(q, k, v, do, lse_w, delta_w)[0]
        want = tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta)[0]
    elif fault == "dq_stale_ring_stage":  # kv tile 2 read from tile 0's stage
        ks, vs = k.clone(), v.clone()
        ks[:, :, 256:384], vs[:, :, 256:384] = k[:, :, 0:128], v[:, :, 0:128]
        got = tfa.flash_bwd_dq_plain(q, ks, vs, do, lse, delta)
        want = tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta)
    elif fault == "dq_row_stats_swapped":  # row r given row r ^ 8's stats
        rows = torch.arange(s) ^ 8
        got = tfa.flash_bwd_dq_plain(q, k, v, do, lse[:, :, rows],
                                     delta[:, :, rows])
        want = tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta)
    elif fault == "dq_k_tile_repeated":   # dS·K with the previous tile's K
        got = _tiled_dq(q, k, v, do, lse, delta, k_lag=1)
        want = tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta)
    elif fault == "missed_rescale":
        got, want = _tiled_fwd(q, k, v, rescale=False), o
    elif fault == "dkv_late_queries":     # q tiles past s/2 never visited
        got = tfa.flash_bwd_dkv_plain(q[:, :, :half], k, v, do[:, :, :half],
                                      lse[:, :, :half], delta[:, :, :half])[0]
        want = tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta)[0]
    elif fault == "dq_last_kv_tile":      # the diagonal's last tile skipped
        got = tfa.flash_bwd_dq_plain(q, k[:, :, :s - 64], v[:, :, :s - 64],
                                     do, lse, delta)
        want = tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta)
    else:                                 # the last 36 rows not stored
        got, want = o.clone(), o
        got[:, :, -36:] = 0
    assert not tfa.bf16_within_tolerance(tfa.bf16_error(got, want))


def test_cpu_tensors_launch_nothing():
    tfa.reset_launch_counts()
    q, k, v, do = _inputs(2, 2, 64, 64)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    (tfa.flash_attention(tq, tk, tv) * _t(do)).sum().backward()
    assert tq.grad is not None
    assert tfa.launch_counts == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                 "flash_bwd_dkv": 0}


@pytest.mark.parametrize("shapes", [
    ((1, 3, 64, 64), (1, 2, 64, 64)),     # heads not a multiple
    ((1, 2, 64, 64), (2, 2, 64, 64)),     # batch mismatch
    ((1, 2, 64, 64), (1, 2, 64, 32)),     # head_dim mismatch
    ((2, 64, 64), (2, 64, 64)),           # not 4-D
])
def test_wrapper_rejects_bad_shapes(shapes):
    q_shape, kv_shape = shapes
    q, k = torch.zeros(q_shape), torch.zeros(kv_shape)
    with pytest.raises(ValueError):
        tfa.flash_fwd(q, k, k.clone())


def test_backward_wrappers_reject_bad_row_shapes():
    q = torch.zeros(1, 2, 64, 64)
    lse = torch.zeros(1, 2, 64)           # missing the trailing 1
    with pytest.raises(ValueError):
        tfa.flash_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError):
        tfa.flash_bwd_dkv(q, q, q, q, lse, lse)

