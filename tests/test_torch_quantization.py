"""The port's quantization (dlrover_tpu_torch.ops.quantization) against the
JAX package's, on the CPU, bit for bit.

On the CPU the port's wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_quantization.py
does. The same numpy inputs go to both, and every code, scale and output
must be equal: both sides do the same IEEE f32 operations (the scale as
absmax times the f32 reciprocal of qmax, which is what XLA makes of the
reference's division by the constant qmax), so any difference is a fault.

Each input mixes groups of very different magnitudes with an all-zero
group (scale 0, inverse 0) and a tie group: absmax 127·2⁻³ (or 7·2⁻³)
makes the scale 2⁻³ and the inverse 8 exactly, and the values (k+½)/8
then land x·inv on k+½, where rounding half to even (jnp.round, rintf)
and half away from zero (roundf) differ.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops import quantization as tq

jq = importlib.import_module("dlrover_tpu.ops.quantization")

QMAX = {8: 127, 4: 7}
CASES = [(bits, group, dtype) for bits in (8, 4) for group in (128, 8)
         for dtype in ("f32", "bf16")]
CASE_IDS = [f"int{b}-g{g}-{d}" for b, g, d in CASES]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(bits, group, rows=8, cols=512, seed=0):
    """(rows, cols) f32 with one zero group and one tie group in row 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols)).astype(np.float32)
    x *= rng.uniform(1e-3, 1e2, (rows, 1)).astype(np.float32)
    x[0, :group] = 0.0
    tie = x[0, group:2 * group]
    qmax = QMAX[bits]
    half = (np.arange(group - 1) % qmax + 0.5) / 8.0
    tie[0] = qmax / 8.0
    tie[1:] = np.where(np.arange(group - 1) % 2, -half, half)
    return x


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or str(
        x.dtype) == "bfloat16" else x


def _equal(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_tie_group_lands_on_halves():
    """The tie group does what the module says: inverse exactly 8 and
    x·inv on k+½, so the rounding mode is tested."""
    for bits in (8, 4):
        x = _inputs(bits, 8)
        tie = x[0, 8:16]
        scale = np.float32(np.abs(tie).max()) * np.float32(
            np.float32(1) / np.float32(QMAX[bits]))
        assert scale == np.float32(0.125)
        prod = tie[1:] * np.float32(1) / scale
        assert np.all(np.abs(prod) % 1 == 0.5)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_quantize_and_dequantize_match_pallas_bitwise(case):
    bits, group, dtype = case
    jdtype, tdtype = DTYPES[dtype]
    x = _inputs(bits, group)
    jqv, js = jq.quantize(jnp.asarray(x, jdtype), bits=bits,
                          group_size=group)
    q, s = tq.quantize(_t(x, tdtype), bits=bits, group_size=group)
    _equal(q, jqv)
    _equal(s, js)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    # the all-zero group has scale 0 and codes 0
    assert s[0, 0] == 0 and not (tq.unpack_int4(q) if bits == 4
                                 else q)[0, :group].any()
    for out in DTYPES:
        jout, tout = DTYPES[out]
        want = jq.dequantize(jqv, js, bits=bits, dtype=jout)
        got = tq.dequantize(q, s, bits=bits, dtype=tout)
        assert got.dtype == tout
        _equal(got, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_reference_quantize_is_the_kernel_path(bits):
    x = _inputs(bits, 128, seed=1)
    q, s = tq.quantize(_t(x), bits=bits)
    rq, rs = tq.reference_quantize(_t(x), bits=bits)
    _equal(q, rq)
    _equal(s, rs)
    jqv, js = jq.quantize(jnp.asarray(x), bits=bits)
    _equal(rq, jqv)


def test_pack_unpack_int4_match_jax_bitwise():
    rng = np.random.default_rng(2)
    q = rng.integers(-7, 8, (3, 64), dtype=np.int8)
    packed = tq.pack_int4(torch.from_numpy(q))
    _equal(packed, jq.pack_int4(jnp.asarray(q)))
    every_byte = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    _equal(tq.unpack_int4(torch.from_numpy(every_byte)),
           jq.unpack_int4(jnp.asarray(every_byte)))
    _equal(tq.unpack_int4(packed), q)


@pytest.mark.parametrize("bits,partners,group", [(8, 4, 128), (4, 4, 128),
                                                 (8, 2, 8)])
def test_swizzled_quantize_matches_jax_bitwise(bits, partners, group):
    x = _inputs(bits, group, rows=4, cols=1024, seed=3)
    jqv, js = jq.swizzled_quantize(jnp.asarray(x), partners, bits=bits,
                                   group_size=group)
    q, s = tq.swizzled_quantize(_t(x), partners, bits=bits,
                                group_size=group)
    _equal(q, jqv)
    _equal(s, js)
    want = jq.unswizzle_dequantize(jqv, js, x.shape, bits=bits)
    got = tq.unswizzle_dequantize(q, s, x.shape, bits=bits)
    _equal(got, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_reduce_matches_jax_bitwise(bits):
    chunks = np.stack([_inputs(bits, 128, rows=4, cols=256, seed=10 + i)
                       for i in range(4)])
    jqs, jss = zip(*(jq.quantize(jnp.asarray(c), bits=bits)
                     for c in chunks))
    jqs, jss = jnp.stack(jqs), jnp.stack(jss)
    qs, ss = zip(*(tq.quantize(_t(c), bits=bits) for c in chunks))
    qs, ss = torch.stack(qs), torch.stack(ss)
    jqr, jsr = jq.quant_reduce(jqs, jss, bits=bits)
    qr, sr = tq.quant_reduce(qs, ss, bits=bits)
    _equal(qr, jqr)
    _equal(sr, jsr)


def test_cpu_tensors_launch_nothing():
    tq.reset_launch_counts()
    q, s = tq.quantize(_t(_inputs(8, 128)))
    tq.dequantize(q, s)
    assert tq.launch_counts == {"quantize": 0, "dequantize": 0}


@pytest.mark.parametrize("bad", ["bits", "group", "scales"])
def test_rejects_bad_arguments(bad):
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError):
        if bad == "bits":
            tq.quantize(x, bits=2)
        elif bad == "group":
            tq.quantize(x, group_size=96)
        else:
            tq.dequantize_rows(torch.zeros(4, 8, dtype=torch.int8),
                               torch.ones(4))
