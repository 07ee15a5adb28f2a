"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and is compiled
on first use into ``build/kernels/lib<name>-<hash>.so`` at the root of
the checkout, the hash being that of the source, so an edited source is
rebuilt and an unchanged one is loaded as it is. A plain C interface
keeps the build to seconds (no PyTorch headers). Pointers and streams
cross the boundary as ``c_void_p``; every entry point returns
``cudaGetLastError()`` and :func:`check` raises on a nonzero code.
:func:`bind` sets the entry points' argument types. Libraries of
different names may be loaded from several threads at once, each nvcc
running beside the others.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


class KernelBuildError(RuntimeError):
    """nvcc failed; the message carries its stderr."""


class KernelLaunchError(RuntimeError):
    """A kernel entry point returned a nonzero CUDA error code."""


@dataclasses.dataclass
class Library:
    """A loaded kernel library, with what its build reported."""

    handle: ctypes.CDLL
    build_seconds: float
    ptxas_log: str


_LIBS: Dict[str, Library] = {}
# one lock a library name, so that two names build at once and one name
# builds once
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "are built on a machine with the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists; return the library's path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) for {src}:\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> Library:
    """The library of ``csrc/<name>.cu``, built and loaded on first use."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name not in _LIBS:
            t0 = time.monotonic()
            path = build(name)
            handle = ctypes.CDLL(str(path))
            log = path.with_suffix(".ptxas.txt")
            _LIBS[name] = Library(handle, time.monotonic() - t0,
                                  log.read_text() if log.exists() else "")
        return _LIBS[name]


def bind(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with each named entry point's
    ``argtypes`` set and its result an int (the CUDA error code)."""
    lib = load(name).handle
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if an entry point of ``lib`` (which must export
    ``cuda_error_string``) returned a nonzero CUDA error code."""
    if code != 0:
        fn = lib.cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise KernelLaunchError(
            f"{what} failed with CUDA error {code}: {fn(code).decode()}")
