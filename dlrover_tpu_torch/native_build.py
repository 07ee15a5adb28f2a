"""Build and load the native host library (the reconciler core, the shm
ring and the host custom ops), with every entry point's argument and
result types bound.

The port's own loader of ``native/{shm_ring,reconciler,custom_op}.cpp``:
on first use ``g++`` compiles them with ``native/Makefile``'s flags into
``build/native/libdlrover_tpu_native-<hash>.so`` at the root of the
checkout (``build/`` is ignored by git), the hash being that of the
sources and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. It never loads or writes ``native/*.so``. A
failed build raises :class:`NativeBuildError` with the compiler's
output: there is no silent fallback (the pure-Python reconciler table in
``operator/native.py`` is the plain version the tests hold the native
one against, not a stand-in).

``python -m dlrover_tpu_torch.native_build`` builds it explicitly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
SOURCES = ("shm_ring.cpp", "reconciler.cpp", "custom_op.cpp")
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra"]
LD_FLAGS = ["-shared", "-lrt", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """g++ failed or is missing; the message carries its output."""


def source_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode() + b"\0" + (NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return h.hexdigest()[:16]


def so_path() -> Path:
    return BUILD_DIR / f"libdlrover_tpu_native-{source_digest()}.so"


def build() -> Path:
    """Compile the library unless one of the same :func:`source_digest`
    exists; return its path."""
    out = so_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError("g++ not found on PATH: the native host "
                               "library is built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, *(str(NATIVE_DIR / s) for s in SOURCES),
           "-o", str(tmp), *LD_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise NativeBuildError(f"cannot run {cxx}: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_native() -> ctypes.CDLL:
    """The native library, built on first use (raises
    :class:`NativeBuildError` when it cannot be built)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        _bind(lib)
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    """The argument and result types of every entry point a consumer
    calls: the reconciler's (``operator/native.py``), the shm ring's
    (``data/shm_ring.py``) and the host ops' (``ops/host_ops.py``), as
    the JAX package's loader sets them."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.reconciler_abi_version.restype = ctypes.c_int32
    lib.shm_ring_open.restype = ctypes.c_void_p
    lib.shm_ring_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                  ctypes.c_int]
    lib.shm_ring_capacity.restype = ctypes.c_uint32
    lib.shm_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.shm_ring_push.restype = ctypes.c_int
    lib.shm_ring_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32,
                                  ctypes.c_int64]
    lib.shm_ring_next_len.restype = ctypes.c_int64
    lib.shm_ring_next_len.argtypes = [ctypes.c_void_p]
    lib.shm_ring_pop.restype = ctypes.c_int64
    lib.shm_ring_pop.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint32,
                                 ctypes.c_int64]
    lib.shm_ring_mark_closed.restype = None
    lib.shm_ring_mark_closed.argtypes = [ctypes.c_void_p]
    lib.shm_ring_close.restype = None
    lib.shm_ring_close.argtypes = [ctypes.c_void_p]
    lib.dlrover_tpu_crc32.restype = ctypes.c_uint32
    lib.dlrover_tpu_crc32.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32]
    lib.dlrover_tpu_token_histogram.restype = ctypes.c_uint64
    lib.dlrover_tpu_token_histogram.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32, ctypes.c_int]


def main() -> int:
    t0 = time.monotonic()
    path = build()
    print(f"native build: ok ({path}, {time.monotonic() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
