"""Host-side native custom ops and the way a traced program calls one.

Counterpart of ``dlrover_tpu/ops/host_ops.py``. The ops are C-linkage
functions in ``native/custom_op.cpp``, built by the port's loader
(``native_build.py``) and called through ctypes:

- :func:`crc32`: the zlib-compatible CRC32 of an array's or a byte
  string's bytes, chained through ``seed``;
- :func:`token_histogram`: the count of each token id, with an
  out-of-vocabulary bucket (the data plane's input-skew diagnostic).

A failed ``g++`` build raises ``NativeBuildError``: there is no silent
fallback. :func:`crc32_plain` (zlib) and :func:`token_histogram_plain`
(numpy) are the plain versions the tests hold the native ops against.

:func:`checksum` is the counterpart of ``checksum_in_jit`` (a
``jax.pure_callback``): a ``torch.library.custom_op``
(``dlrover_tpu_torch::crc32``) with a declared 0-d ``int64`` result on
the input's device. It copies the tensor to the host and runs the native
CRC, so it is an explicit device→host sync: a check off the hot path,
never inside a step. torch is imported only when it is first called, so
a producer process that stamps CRCs with :func:`crc32` never loads it.
"""

import ctypes
import zlib
from typing import Tuple

import numpy as np

from dlrover_tpu_torch.native_build import load_native


def _as_bytes_view(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, np.uint8)
    return np.ascontiguousarray(data).view(np.uint8).reshape(-1)


def crc32(data, seed: int = 0) -> int:
    """zlib-compatible CRC32 of an array's (or bytes') bytes; chain via
    ``seed``."""
    view = _as_bytes_view(data)
    ptr = view.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return int(load_native().dlrover_tpu_crc32(ptr, view.size,
                                                seed & 0xFFFFFFFF))


def crc32_plain(data, seed: int = 0) -> int:
    """:func:`crc32` through zlib."""
    return zlib.crc32(_as_bytes_view(data).tobytes(), seed) & 0xFFFFFFFF


def _histogram_slots(tokens, vocab_size: int, count_oov: bool):
    toks = np.ascontiguousarray(tokens, dtype=np.int32).reshape(-1)
    hist = np.zeros(vocab_size + (1 if count_oov else 0), dtype=np.uint64)
    return toks, hist


def token_histogram(tokens, vocab_size: int,
                    count_oov: bool = True) -> Tuple[np.ndarray, int]:
    """Counts of each token id: (hist, n_out_of_vocab). ``hist`` has
    vocab_size + 1 slots when ``count_oov`` (the last one the
    out-of-vocabulary bucket), else vocab_size."""
    toks, hist = _histogram_slots(tokens, vocab_size, count_oov)
    oov = load_native().dlrover_tpu_token_histogram(
        toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), toks.size,
        hist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), vocab_size,
        1 if count_oov else 0)
    return hist, int(oov)


def token_histogram_plain(tokens, vocab_size: int,
                          count_oov: bool = True) -> Tuple[np.ndarray, int]:
    """:func:`token_histogram` through ``np.bincount``."""
    toks, hist = _histogram_slots(tokens, vocab_size, count_oov)
    in_vocab = toks[(toks >= 0) & (toks < vocab_size)]
    hist[:vocab_size] += np.bincount(
        in_vocab, minlength=vocab_size).astype(np.uint64)
    oov = toks.size - in_vocab.size
    if count_oov:
        hist[vocab_size] += np.uint64(oov)
    return hist, int(oov)


_checksum_op = None


def _register_checksum():
    # (no ``from __future__ import annotations`` in this module: the
    # custom op's schema is read from its annotations, which must be
    # types, not strings)
    import torch

    @torch.library.custom_op("dlrover_tpu_torch::crc32", mutates_args=())
    def checksum_op(x: torch.Tensor) -> torch.Tensor:
        host = x.detach().contiguous().cpu().reshape(-1)
        value = crc32(host.view(torch.uint8).numpy())
        return torch.tensor(value, dtype=torch.int64, device=x.device)

    @checksum_op.register_fake
    def _(x):
        return x.new_empty((), dtype=torch.int64)

    return checksum_op


def checksum(x):
    """CRC32 of a tensor's bytes as a 0-d int64 tensor on its device,
    through the ``dlrover_tpu_torch::crc32`` custom op (a device→host
    sync)."""
    global _checksum_op
    if _checksum_op is None:
        _checksum_op = _register_checksum()
    return _checksum_op(x)
