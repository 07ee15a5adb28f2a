"""The port's host custom ops (dlrover_tpu_torch.ops.host_ops) against the
JAX package's (dlrover_tpu.ops.host_ops) and the plain versions, zlib and
numpy, on the same seeded inputs. Every comparison is exact: a CRC and a
histogram are integers."""

import sys
import subprocess
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import host_ops as jops
from dlrover_tpu_torch import native_build
from dlrover_tpu_torch.ops import host_ops as tops


def _arrays():
    rng = np.random.default_rng(0)
    return [
        b"",
        b"dlrover-tpu native extension point",
        rng.integers(0, 256, 1, dtype=np.uint8),
        rng.standard_normal(1000).astype(np.float32),
        rng.integers(-2 ** 31, 2 ** 31 - 1, (7, 33), dtype=np.int32),
        rng.integers(0, 32000, (8, 2048), dtype=np.int64),
        # a non-contiguous view: its bytes in C order
        rng.standard_normal((16, 16)).astype(np.float64)[:, ::3],
    ]


@pytest.mark.parametrize("index", range(7))
@pytest.mark.parametrize("seed", [0, 0xDEADBEEF])
def test_crc32_matches_jax_zlib_and_plain(index, seed):
    data = _arrays()[index]
    want = zlib.crc32(np.ascontiguousarray(data).tobytes()
                      if not isinstance(data, bytes) else data,
                      seed) & 0xFFFFFFFF
    assert tops.crc32(data, seed) == want
    assert tops.crc32_plain(data, seed) == want
    assert jops.crc32(data, seed) == want


def test_crc32_chains_through_seed():
    a, b = b"first half|", b"second half"
    assert tops.crc32(b, seed=tops.crc32(a)) == zlib.crc32(a + b)


@pytest.mark.parametrize("vocab,count_oov", [(50, True), (50, False),
                                             (3, True), (32000, True)])
def test_token_histogram_matches_jax_and_bincount(vocab, count_oov):
    rng = np.random.default_rng(vocab)
    toks = rng.integers(-5, vocab + 7, 10_000).astype(np.int32)
    hist, oov = tops.token_histogram(toks, vocab, count_oov)
    plain, plain_oov = tops.token_histogram_plain(toks, vocab, count_oov)
    jhist, joov = jops.token_histogram(toks, vocab, count_oov)
    np.testing.assert_array_equal(hist, plain)
    np.testing.assert_array_equal(hist, jhist)
    assert oov == plain_oov == joov
    in_vocab = toks[(toks >= 0) & (toks < vocab)]
    np.testing.assert_array_equal(hist[:vocab],
                                  np.bincount(in_vocab, minlength=vocab))
    assert hist.shape == (vocab + int(count_oov),) and hist.dtype == np.uint64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.uint8])
def test_checksum_op_matches_jax_checksum_in_jit(dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 37)).astype(np.float32)
                         * 100).to(dtype)
    got = tops.checksum(x)
    assert got.dtype == torch.int64 and got.shape == () \
        and got.device == x.device
    raw = x.contiguous().view(torch.uint8).numpy()
    assert int(got) == zlib.crc32(raw.tobytes())
    if dtype in (torch.float32, torch.uint8):
        # (JAX without x64 would hold an int64 array as int32)
        jx = jnp.asarray(x.numpy())
        assert int(got) == int(jax.jit(jops.checksum_in_jit)(jx))
    # one changed element changes the CRC
    y = x.clone()
    y.view(-1)[7] += 1
    assert int(tops.checksum(y)) != int(got)


def test_checksum_op_is_a_registered_custom_op_with_a_fake():
    x = torch.arange(64, dtype=torch.float32)
    tops.checksum(x)
    op = torch.ops.dlrover_tpu_torch.crc32
    assert int(op(x)) == tops.crc32(x.numpy())
    with torch._subclasses.fake_tensor.FakeTensorMode():
        fake = op(torch.empty(8, 8))
        assert fake.shape == () and fake.dtype == torch.int64


def test_native_library_binds_the_host_ops_and_a_failed_build_raises(
        tmp_path):
    lib = native_build.load_native()
    assert lib.dlrover_tpu_crc32.restype is not None
    assert lib.dlrover_tpu_token_histogram.argtypes[-1] is not None
    # no g++: the loader raises instead of handing back a fallback
    code = (
        "import os, sys\n"
        "from dlrover_tpu_torch import native_build as nb\n"
        f"nb.BUILD_DIR = __import__('pathlib').Path({str(tmp_path)!r})\n"
        "os.environ['CXX'] = '/nonexistent/g++'\n"
        "from dlrover_tpu_torch.ops import host_ops\n"
        "try:\n"
        "    host_ops.crc32(b'x')\n"
        "except nb.NativeBuildError as e:\n"
        "    print('raised', type(e).__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert "raised" in out.stdout, out.stderr[-2000:]
