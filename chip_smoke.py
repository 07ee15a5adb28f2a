"""Drive dlrover_tpu_torch on one NVIDIA card and check what comes out.

    python3 chip_smoke.py                 # every phase (needs one card)
    python3 chip_smoke.py --phases kernels,parity

Phases (each one's failure ends the run with a nonzero exit):
  device   torch sees a card; print nvidia-smi's name and power limit
  build    build the three CUDA libraries of ops/csrc (flash attention,
           norms, quantization), one nvcc each, all started together;
           print each one's seconds and ptxas's register / spill report
  kernels  each flash-attention and RMSNorm kernel against its plain
           PyTorch version on the card at the Llama-1B slice shape and at
           edge shapes, with stated tolerances; time kernel, plain
           version and the library yardstick (SDPA, F.rms_norm)
  quant    the quantization API (quantize, dequantize, swizzled,
           quant_reduce) on a Llama-1B gate_proj gradient, int8 and int4,
           bf16 input, group 8, zero and tie groups: every output equals
           the plain versions' bit for bit; time both kernels, their
           plain versions and torch.mul (dequantize's one-call yardstick)
  parity   a small Llama trained 3 steps with attn_impl="flash" and
           "reference", and with norm_impl="fused" and "reference", from
           the same init: losses, grad norms and gradients agree
  llama1b  Llama-1B at full width (22 layers, hidden 2048, seq 2048) in
           the JAX headline configuration (flash attention, fused norm)
           trained through ElasticTrainLoop, 2 warm-up + 5 timed steps;
           each flash kernel launches 22 times per step, rms_fwd and
           rms_bwd 45 times

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import statistics
import subprocess
import sys
import time

import torch

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s
# ≈40 ms of device sleep at the H100's 1.98 GHz boost clock: longer than
# the host takes to queue the timed calls
SLEEP_CYCLES = 80_000_000
LIBRARIES = ["flash_attention", "norms", "quantization"]
CSRC = "dlrover_tpu_torch/ops/csrc/"
# each kernel's source in this repo and the Pallas kernel body it replaces
KERNELS = {
    "flash_fwd": ("flash_attention.cu",
                  "dlrover_tpu/ops/flash_attention.py:129"),
    "flash_bwd_dq": ("flash_attention.cu",
                     "dlrover_tpu/ops/flash_attention.py:249"),
    "flash_bwd_dkv": ("flash_attention.cu",
                      "dlrover_tpu/ops/flash_attention.py:293"),
    "rms_fwd": ("norms.cu", "dlrover_tpu/ops/norms.py:25"),
    "rms_bwd": ("norms.cu", "dlrover_tpu/ops/norms.py:34"),
    "quantize": ("quantization.cu", "dlrover_tpu/ops/quantization.py:48"),
    "dequantize": ("quantization.cu", "dlrover_tpu/ops/quantization.py:58"),
}
# o, dQ, dK and dV against their plain versions: each element within
# 2^-4·rms(want) + 2^-5·|want| and the tensor within 2^-7 relative L2
# (flash_attention.bf16_error says why). lse is f32 from the same max
# and a sum in another order: 1e-3 absolute.
LSE_TOL = 1e-3
SLICE = dict(b=4, h=16, h_kv=16, s_q=2048, s_k=2048, d=128, causal=True)
EDGE_SHAPES = [
    dict(b=2, h=16, h_kv=4, s_q=1024, s_k=1024, d=128, causal=True),
    dict(b=2, h=8, h_kv=8, s_q=1024, s_k=1024, d=128, causal=False),
    dict(b=2, h=8, h_kv=8, s_q=512, s_k=1024, d=128, causal=True),
    dict(b=2, h=8, h_kv=8, s_q=1024, s_k=512, d=128, causal=True),
    dict(b=2, h=4, h_kv=2, s_q=192, s_k=192, d=64, causal=True),
    dict(b=2, h=4, h_kv=4, s_q=100, s_k=100, d=64, causal=True),
    dict(b=1, h=4, h_kv=2, s_q=100, s_k=300, d=64, causal=False),
]
# A small bf16 Llama trained with attn_impl="flash" and "reference"
# from the same init. The loss barely moves in 3 steps, so the backward
# kernels are held by the gradients: the grad norm of every step, and
# each parameter's gradient of one step (relative L2), where the two
# attention paths differ only by bf16 rounding of o and of its gradient.
PARITY_LOSS_TOL = 2e-2
PARITY_GRAD_NORM_TOL = 1e-2
PARITY_GRAD_TOL = 2.0 ** -5
# RMSNorm at the Llama-1B slice shape (8 x 2048 rows of 2048), eps as the
# model passes it, and edge shapes (rows, dim, dtype): ragged rows, dim
# 64 and 4096, a dim that is not a multiple of 8, f32 x, and rows wide
# enough to need 2 and 4 chunks a thread. y and dx are held by
# flash_attention.bf16_error's rule (bf16) or norms.f32_error's (f32);
# rstd and dw by norms.f32_error's: within 1e-5 of the reference's RMS
# plus their own size. dw must be the same bits in two calls.
NORM_EPS = 1e-5
NORM_SLICE = (8 * 2048, 2048, torch.bfloat16)
NORM_EDGES = [
    (1000, 2048, torch.bfloat16), (4096, 64, torch.bfloat16),
    (512, 4096, torch.bfloat16), (300, 100, torch.bfloat16),
    (1000, 2048, torch.float32), (64, 12288, torch.bfloat16),
    (16, 30000, torch.float32),
]
# quantization: a Llama-1B gate_proj gradient, f32 (in, out), groups of
# 128 (43 a row); every code, scale and output equal to the plain
# versions' bit for bit.
QUANT_SHAPE = (2048, 5504)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# device / build
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from dlrover_tpu_torch.ops import _build

    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        libs = dict(zip(LIBRARIES, pool.map(_build.load, LIBRARIES)))
    log(f"build: {len(libs)} libraries in {time.monotonic() - t0:.1f} s")
    for name, info in libs.items():
        log(f"build: {name}.cu in {info.build_seconds:.1f} s")
        for line in info.ptxas_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")


def _counter_modules():
    from dlrover_tpu_torch.ops import flash_attention, norms, quantization

    return flash_attention, norms, quantization


def reset_counts() -> None:
    for module in _counter_modules():
        module.reset_launch_counts()


def read_counts() -> dict:
    counts = {}
    for module in _counter_modules():
        counts.update(module.launch_counts)
    return counts


def record(name: str, ms: float, plain_ms: float, bound_ms: float,
           bound_by: str, library_ms, max_abs_err: float, **extra) -> dict:
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces, "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, **extra}


def roofline(flops: float, peak_flops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the larger of operations over their peak and
    bytes over the HBM rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """The card's time for one call of ``fn``: ``reps`` calls between two
    CUDA events, queued behind a device sleep so that the wrappers' host
    time (checks, allocations, the launch) overlaps the card's work
    instead of adding to it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def causal_pairs(s_q: int, s_k: int, causal: bool) -> int:
    """(q, k) score pairs the function needs: top-left causal keeps
    k <= q."""
    if not causal:
        return s_q * s_k
    return sum(min(i + 1, s_k) for i in range(s_q))


def bound(name: str, b, h, h_kv, s_q, s_k, d, causal) -> tuple:
    """(bound_ms, bound_by): the larger of FLOPs over the bf16 peak and
    bytes (each input read once, each output written once) over HBM
    rate."""
    pairs = b * h * causal_pairs(s_q, s_k, causal)
    q_el, kv_el, rows = b * h * s_q * d, b * h_kv * s_k * d, b * h * s_q
    if name == "flash_fwd":      # S = QKᵀ, O = PV
        flops = 4 * d * pairs
        nbytes = 2 * (2 * q_el + 2 * kv_el) + 4 * rows
    elif name == "flash_bwd_dq":  # S, dP = dO Vᵀ, dQ = dS K
        flops = 6 * d * pairs
        nbytes = 2 * (3 * q_el + 2 * kv_el) + 8 * rows
    else:                         # S, dP, dV = Pᵀ dO, dK = dSᵀ Q
        flops = 8 * d * pairs
        nbytes = 2 * (2 * q_el + 4 * kv_el) + 8 * rows
    return roofline(flops, PEAK_BF16_FLOPS, nbytes)


def _inputs(shape, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, h, h_kv, s_q, s_k, d = (shape[x] for x in
                               ("b", "h", "h_kv", "s_q", "s_k", "d"))

    def rnd(*dims):
        return torch.randn(*dims, generator=g, device="cuda").bfloat16()

    return (rnd(b, h, s_q, d), rnd(b, h_kv, s_k, d), rnd(b, h_kv, s_k, d),
            rnd(b, h, s_q, d))


def check_shape(shape, seed: int) -> tuple:
    """Kernel vs plain version at one shape: (max abs error of each
    output, the outputs beyond tolerance)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    causal = shape["causal"]
    q, k, v, do = _inputs(shape, seed)
    o, lse = fa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    po, plse = fa.flash_fwd_plain(q, k, v, causal)
    # both backward versions get the same lse and delta
    delta = (do.float() * po.float()).sum(-1, keepdim=True)
    dq = fa.flash_bwd_dq(q, k, v, do, plse, delta, causal)
    torch.cuda.synchronize()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, plse, delta, causal)
    torch.cuda.synchronize()
    pdq = fa.flash_bwd_dq_plain(q, k, v, do, plse, delta, causal)
    pdk, pdv = fa.flash_bwd_dkv_plain(q, k, v, do, plse, delta, causal)
    errs, bad = {}, []
    for name, got, want in (("o", o, po), ("dq", dq, pdq), ("dk", dk, pdk),
                            ("dv", dv, pdv)):
        e = fa.bf16_error(got, want)
        errs[name] = e["max_abs"]
        if not fa.bf16_within_tolerance(e):
            bad.append(name)
        log(f"  {name} vs plain {shape}: max abs {e['max_abs']:.3g}, "
            f"rel L2 {e['rel_l2']:.3g} (limit {fa.BF16_REL_L2:.3g}), "
            f"worst element {e['worst']:.3g} of its allowance")
    errs["lse"] = (lse - plse).abs().max().item()
    if not errs["lse"] <= LSE_TOL:
        bad.append("lse")
    log(f"  lse vs plain {shape}: max abs {errs['lse']:.3g} (limit "
        f"{LSE_TOL})")
    return errs, [f"{name} at {shape}" for name in bad]


def phase_kernels() -> list:
    return flash_kernels() + norm_kernels()


def flash_kernels() -> list:
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import flash_attention as fa

    # every shape is checked and printed before a failure ends the phase
    bad = []
    for i, shape in enumerate(EDGE_SHAPES):
        bad += check_shape(shape, seed=100 + i)[1]
    slice_errs, slice_bad = check_shape(SLICE, seed=1)
    if bad + slice_bad:
        raise AssertionError(f"kernels beyond tolerance: {bad + slice_bad}")

    # times at the slice shape
    causal = SLICE["causal"]
    q, k, v, do = _inputs(SLICE, seed=2)
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    timings = {
        "flash_fwd": (
            lambda: fa.flash_fwd(q, k, v, causal),
            lambda: fa.flash_fwd_plain(q, k, v, causal)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                           causal)),
    }
    # yardsticks only, never called on the path: SDPA's forward, its
    # backward alone (dQ, dK and dV in one call, the graph kept), and both
    sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        og, (qg, kg, vg), do, retain_graph=True))

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(
            qg, kg, vg, is_causal=causal), (qg, kg, vg), do)

    sdpa_fwd_bwd_ms = time_ms(sdpa_fwd_bwd)
    dims = [SLICE[x] for x in ("b", "h", "h_kv", "s_q", "s_k", "d",
                               "causal")]
    err_of = {"flash_fwd": max(slice_errs["o"], slice_errs["lse"]),
              "flash_bwd_dq": slice_errs["dq"],
              "flash_bwd_dkv": max(slice_errs["dk"], slice_errs["dv"])}
    records = []
    for name, (kernel, plain) in timings.items():
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        bound_ms, bound_by = bound(name, *dims)
        library_ms = sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd_ms
        records.append(record(name, ms, plain_ms, bound_ms, bound_by,
                              library_ms, err_of[name],
                              library_fwd_bwd_ms=sdpa_fwd_bwd_ms))
        log(f"  {name}: {ms:.3f} ms (bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.1%} of it), plain {plain_ms:.3f}"
            f" ms, sdpa fwd {sdpa_fwd_ms:.3f} ms, sdpa bwd alone "
            f"{sdpa_bwd_ms:.3f} ms, sdpa fwd+bwd {sdpa_fwd_bwd_ms:.3f} ms")
    del q, k, v, do, o, lse, delta, qg, kg, vg, og
    torch.cuda.empty_cache()
    return records


def _norm_inputs(rows: int, dim: int, dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (2 * torch.randn(rows, dim, generator=g, device="cuda")).to(dtype)
    w = 0.5 + torch.rand(dim, generator=g, device="cuda")
    dy = torch.randn(rows, dim, generator=g, device="cuda").to(dtype)
    return x, w, dy


def _norm_error(got, want) -> tuple:
    """(max abs error, within tolerance) under the rule of got's type."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import norms

    if got.dtype == torch.bfloat16:
        e = fa.bf16_error(got, want)
        return e["max_abs"], fa.bf16_within_tolerance(e)
    e = norms.f32_error(got, want)
    return e["max_abs"], e["worst"] <= 1.0


def check_norm(rows: int, dim: int, dtype, seed: int) -> tuple:
    """Both norm kernels against their plain versions at one shape (the
    backward of both gets the plain rstd), and dw (and dx) the same bits
    in a second call: (max abs error of each output, what failed)."""
    from dlrover_tpu_torch.ops import norms

    x, w, dy = _norm_inputs(rows, dim, dtype, seed)
    y, rstd = norms.rms_fwd(x, w, NORM_EPS)
    torch.cuda.synchronize()
    py, prstd = norms.rms_fwd_plain(x, w, NORM_EPS)
    dx, dw = norms.rms_bwd(x, w, prstd, dy)
    dx2, dw2 = norms.rms_bwd(x, w, prstd, dy)
    torch.cuda.synchronize()
    pdx, pdw = norms.rms_bwd_plain(x, w, prstd, dy)
    errs, bad = {}, []
    for name, got, want in (("y", y, py), ("rstd", rstd, prstd),
                            ("dx", dx, pdx), ("dw", dw, pdw)):
        errs[name], ok = _norm_error(got, want)
        if not ok:
            bad.append(name)
    if not (torch.equal(dw, dw2) and torch.equal(dx, dx2)):
        bad.append("dw/dx differ between two calls")
    shape = (rows, dim, str(dtype).replace("torch.", ""))
    log(f"  norm {shape}: max abs y {errs['y']:.3g}, rstd "
        f"{errs['rstd']:.3g}, dx {errs['dx']:.3g}, dw {errs['dw']:.3g}; "
        f"dw bitwise equal in two calls: {torch.equal(dw, dw2)}")
    return errs, [f"{name} at {shape}" for name in bad]


def norm_bound(name: str, rows: int, dim: int, esize: int) -> tuple:
    """Forward: x read, y written (each esize bytes), w and rstd; about 4
    f32 operations an element. Backward: x and g read, dx written, w,
    rstd and dw; about 10 f32 operations an element."""
    n = rows * dim
    if name == "rms_fwd":
        return roofline(4 * n, PEAK_F32_FLOPS,
                        2 * n * esize + 4 * dim + 4 * rows)
    return roofline(10 * n, PEAK_F32_FLOPS, 3 * n * esize + 4 * rows
                    + 8 * dim)


def norm_kernels() -> list:
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import norms

    bad = []
    for i, shape in enumerate(NORM_EDGES):
        bad += check_norm(*shape, seed=200 + i)[1]
    slice_errs, slice_bad = check_norm(*NORM_SLICE, seed=4)
    if bad + slice_bad:
        raise AssertionError(f"norm kernels beyond tolerance: "
                             f"{bad + slice_bad}")

    rows, dim, dtype = NORM_SLICE
    x, w, dy = _norm_inputs(rows, dim, dtype, seed=5)
    _, rstd = norms.rms_fwd(x, w, NORM_EPS)
    # yardstick only, never called on the path: F.rms_norm with the weight
    # in x's type (its fused kernel takes one type), its backward alone
    # (dx and dw, the graph kept), and both
    xl = x.detach().clone().requires_grad_()
    wl = w.to(dtype).requires_grad_()
    lib_fwd_ms = time_ms(lambda: F.rms_norm(x, (dim,), wl, NORM_EPS))
    yl = F.rms_norm(xl, (dim,), wl, NORM_EPS)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        yl, (xl, wl), dy, retain_graph=True))
    lib_fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
        F.rms_norm(xl, (dim,), wl, NORM_EPS), (xl, wl), dy))
    timings = {
        "rms_fwd": (lambda: norms.rms_fwd(x, w, NORM_EPS),
                    lambda: norms.rms_fwd_plain(x, w, NORM_EPS), lib_fwd_ms,
                    max(slice_errs["y"], slice_errs["rstd"])),
        "rms_bwd": (lambda: norms.rms_bwd(x, w, rstd, dy),
                    lambda: norms.rms_bwd_plain(x, w, rstd, dy), lib_bwd_ms,
                    max(slice_errs["dx"], slice_errs["dw"])),
    }
    records = []
    for name, (kernel, plain, library_ms, err) in timings.items():
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        bound_ms, bound_by = norm_bound(name, rows, dim, x.element_size())
        records.append(record(name, ms, plain_ms, bound_ms, bound_by,
                              library_ms, err,
                              library_fwd_bwd_ms=lib_fwd_bwd_ms))
        log(f"  {name}: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.1%} of it), plain {plain_ms:.3f}"
            f" ms, F.rms_norm {library_ms:.4f} ms, F.rms_norm fwd+bwd "
            f"{lib_fwd_bwd_ms:.4f} ms")
    del x, w, dy, rstd, xl, wl, yl
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def _quant_input(rows: int, cols: int, group: int, seed: int):
    """f32 groups of very different sizes (10^-3 to 10^1 a row), with an
    all-zero group and two tie groups in row 0: absmax 127/8 (or 7/8)
    makes the scale 1/8 and the inverse 8 exactly, and values (k+½)/8
    then land x·inv on k+½, where rounding half to even and half away
    from zero differ."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, cols, generator=g, device="cuda")
    x *= 10.0 ** (4 * torch.rand(rows, 1, generator=g, device="cuda") - 3)
    x[0, :group] = 0
    for i, qmax in ((1, 127), (2, 7)):
        k = torch.arange(group - 1, device="cuda")
        half = (k % qmax + 0.5) / 8
        x[0, i * group] = qmax / 8
        x[0, i * group + 1:(i + 1) * group] = torch.where(k % 2 == 1, -half,
                                                          half)
    return x


def _quant_path(x, xb, x8, x6, chunks) -> dict:
    """The quantization API as a user calls it, on the gate_proj
    gradient (int8, int4, f32 and bf16 outputs), a bf16 input, groups of
    8 and of 6, the swizzled layout over 4 partners and a reduction of 4
    chunks; every output by name."""
    from dlrover_tpu_torch.ops import quantization as qz

    out = {}

    def both(name, pair):
        out[f"q_{name}"], out[f"s_{name}"] = pair
        return pair

    for bits in (8, 4):
        q, s = both(f"int{bits}", qz.quantize(x, bits))
        out[f"deq_int{bits}"] = qz.dequantize(q, s, bits)
        out[f"deq_int{bits}_bf16"] = qz.dequantize(q, s, bits,
                                                   torch.bfloat16)
    q, s = both("bf16_in", qz.quantize(xb))
    out["deq_bf16_in"] = qz.dequantize(q, s, dtype=torch.bfloat16)
    q, s = both("group8", qz.quantize(x8, 4, group_size=8))
    out["deq_group8"] = qz.dequantize(q, s, 4)
    # a group that is not a multiple of 4 takes the kernels' one-wide path
    q, s = both("group6", qz.quantize(x6, 8, group_size=6))
    out["deq_group6"] = qz.dequantize(q, s, dtype=torch.bfloat16)
    q, s = both("swizzled", qz.swizzled_quantize(x, 4))
    out["unswizzled"] = qz.unswizzle_dequantize(q, s, x.shape)
    pairs = [qz.quantize(c) for c in chunks]
    both("reduced", qz.quant_reduce(torch.stack([a for a, _ in pairs]),
                                    torch.stack([b for _, b in pairs])))
    return out


def phase_quant() -> list:
    """The quantization path on the card, its launches counted, then each
    output against the same API run on the CPU, where every kernel is its
    plain version (the packing, swizzle and sum code is shared)."""
    from dlrover_tpu_torch.ops import quantization as qz

    rows, cols = QUANT_SHAPE
    x = _quant_input(rows, cols, 128, seed=6)
    xb = _quant_input(rows, cols, 128, seed=7).bfloat16()
    x8 = _quant_input(256, 1024, 8, seed=8)
    x6 = _quant_input(256, 1032, 6, seed=9).bfloat16()
    chunks = [_quant_input(rows, cols, 128, seed=10 + i) for i in range(4)]
    reset_counts()
    got = _quant_path(x, xb, x8, x6, chunks)
    torch.cuda.synchronize()
    launches = read_counts()
    want = _quant_path(x.cpu(), xb.cpu(), x8.cpu(), x6.cpu(),
                       [c.cpu() for c in chunks])
    differ = [name for name in want
              if not torch.equal(got[name].cpu(), want[name])]
    log(f"quant: launches {launches}; {len(want)} outputs compared bit for "
        f"bit with the plain versions, differing: {differ or 'none'}")
    if differ:
        raise AssertionError(f"quantization outputs differ: {differ}")
    if not (launches["quantize"] and launches["dequantize"]):
        raise AssertionError(f"quant path launched {launches}")

    # kernel against plain version at the gate_proj shape, int8
    x2 = x.reshape(-1, 128)
    q2, s2 = qz.quantize_rows(x2, 127)
    pq, ps = qz.quantize_plain(x2, 127)
    deq = qz.dequantize_rows(pq, ps)
    torch.cuda.synchronize()
    pdeq = qz.dequantize_plain(pq, ps)
    errs = {"quantize": max((q2.int() - pq.int()).abs().max().item(),
                            (s2 - ps).abs().max().item()),
            "dequantize": (deq - pdeq).abs().max().item()}
    if max(errs.values()) != 0 or not (torch.equal(q2, pq)
                                       and torch.equal(deq, pdeq)):
        raise AssertionError(f"quantization kernels differ: {errs}")
    n = x2.numel()
    # yardstick only, never called on the path: torch.mul of int8 codes
    # and f32 scales promotes to f32 and is dequantize in one call. No
    # single PyTorch call computes groupwise absmax quantization.
    timings = {
        "quantize": (lambda: qz.quantize_rows(x2, 127),
                     lambda: qz.quantize_plain(x2, 127), None,
                     roofline(4 * n, PEAK_F32_FLOPS, 4 * n + n + 4 * len(x2))),
        "dequantize": (lambda: qz.dequantize_rows(pq, ps),
                       lambda: qz.dequantize_plain(pq, ps),
                       lambda: torch.mul(pq, ps),
                       roofline(n, PEAK_F32_FLOPS, n + 4 * len(x2) + 4 * n)),
    }
    records = []
    for name, (kernel, plain, library, bounds) in timings.items():
        bound_ms, bound_by = bounds
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        library_ms = time_ms(library) if library else None
        rec = record(name, ms, plain_ms, bound_ms, bound_by, library_ms,
                     errs[name])
        rec["launches"] = launches[name]
        records.append(rec)
        log(f"  {name}: {ms:.4f} ms (bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.1%} of it), plain {plain_ms:.3f}"
            f" ms, " + (f"torch.mul {library_ms:.4f} ms" if library
                        else "no single PyTorch call"))
    del x, xb, x8, x6, chunks, got, x2, q2, s2, pq, ps, deq
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _adamw(params):
    # optax.adamw(3e-4, weight_decay=0.1)
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.1)


def _train(cfg, global_batch: int, steps: int, max_micro: int,
           profile_out: str = ""):
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
    from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

    loop = ElasticTrainLoop(
        functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
        TrainLoopConfig(global_batch=global_batch, seq_len=cfg.max_seq_len,
                        max_micro_per_replica=max_micro, max_steps=steps,
                        report_interval_steps=0))
    sampler = ElasticDistributedSampler(dataset_size=10 ** 6, shuffle=True,
                                        seed=0)
    state, start = loop.restore_or_init(0, sampler)
    data = batches(synthetic_corpus(cfg.vocab_size), sampler, global_batch,
                   cfg.max_seq_len)
    state, metrics = loop.run(state, data, start_step=start,
                              sampler=sampler)
    # the main path's launches, read before any profiled step adds more
    launches = read_counts()
    if profile_out:
        loop.config.max_steps = 1
        profile_step(lambda: loop.run(state, data, sampler=sampler),
                     profile_out)
    loop.close()
    del state
    return metrics["history"], launches


def _category(name: str) -> str:
    lowered = name.lower()
    for key, cat in (("rms_fwd", "rms_fwd kernel"),
                     ("rms_bwd", "rms_bwd kernel"),
                     ("rms_dw_sum", "rms_bwd kernel"),
                     ("flash_fwd", "flash fwd kernel"),
                     ("flash_bwd_dq", "flash dQ kernel"),
                     ("flash_bwd_dkv", "flash dK/dV kernel"),
                     ("gemm", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
                     ("sm90", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"),
                     ("multi_tensor", "optimizer (foreach)"),
                     ("reduce", "reductions"), ("softmax", "softmax"),
                     ("elementwise", "elementwise"), ("catarray", "concat"),
                     ("index", "gather/scatter"), ("memcpy", "copies"),
                     ("memset", "copies")):
        if key in lowered:
            return cat
    return "other"


def profile_step(run_step, out_path: str) -> None:
    """One training step under torch.profiler: device time by kernel
    category, the device's busy share of the step's wall time, and the
    full table in ``out_path``."""
    import os

    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # kernel rows only: operator rows and annotated ranges (the
    # optimizer step) repeat their kernels' device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")
              and e.key != "Command Buffer Full"]
    by_cat: dict = {}
    for e in events:
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
    busy_ms = sum(by_cat.values())
    log(f"profile: step wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms"
        f" ({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"  profile: {cat:24s} {ms:9.2f} ms  {ms / busy_ms:6.1%}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))


def _one_step_grads(cfg, tokens, targets) -> dict:
    """Each parameter's f32 gradient of one loss, from the seed-0 init
    the training runs start from."""
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss

    model = Llama(cfg, seed=0)
    cross_entropy_loss(model(tokens), targets).backward()
    return {n: p.grad.float() for n, p in model.named_parameters()}


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm()).item()


def _expected_launches(cfg, micro_steps: int) -> dict:
    """Each kernel's launches over ``micro_steps`` forward+backward passes
    of ``cfg``: a flash kernel once a layer, an RMSNorm kernel at each of
    the 2·L+1 norms, nothing of the quantization pair."""
    flash = cfg.num_layers * micro_steps if cfg.attn_impl == "flash" else 0
    norm = ((2 * cfg.num_layers + 1) * micro_steps
            if cfg.norm_impl == "fused" else 0)
    return {"flash_fwd": flash, "flash_bwd_dq": flash, "flash_bwd_dkv": flash,
            "rms_fwd": norm, "rms_bwd": norm, "quantize": 0,
            "dequantize": 0}


def _compare_runs(what: str, a: str, b: str, losses, grad_norms, grads,
                  show) -> None:
    """Losses, per-step grad norms and one step's gradients of run a
    against run b, within the PARITY_* limits; ``show`` names gradients
    to print besides the four worst."""
    diffs = [abs(x - y) for x, y in zip(losses[a], losses[b])]
    norm_diffs = [abs(x - y) / y for x, y in zip(grad_norms[a],
                                                 grad_norms[b])]
    grad_errs = {n: _rel_l2(grads[a][n], grads[b][n]) for n in grads[b]}
    worst = sorted(grad_errs, key=grad_errs.get, reverse=True)
    log(f"parity ({what}): {a} {losses[a]} {b} {losses[b]} max |diff| "
        f"{max(diffs):.3g} (tolerance {PARITY_LOSS_TOL})")
    log(f"parity ({what}): grad norms {a} {grad_norms[a]} {b} "
        f"{grad_norms[b]} max relative diff {max(norm_diffs):.3g} "
        f"(tolerance {PARITY_GRAD_NORM_TOL})")
    log(f"parity ({what}): one step's gradients, relative L2 (tolerance "
        f"{PARITY_GRAD_TOL}): worst "
        + ", ".join(f"{n} {grad_errs[n]:.3g}" for n in worst[:4]) + "; "
        + ", ".join(f"{n} {grad_errs[n]:.3g}" for n in show))
    if len(diffs) != 3 or not max(diffs) <= PARITY_LOSS_TOL:
        raise AssertionError(f"{what}: training losses disagree")
    if not max(norm_diffs) <= PARITY_GRAD_NORM_TOL:
        raise AssertionError(f"{what}: grad norms disagree")
    if not grad_errs[worst[0]] <= PARITY_GRAD_TOL:
        raise AssertionError(f"{what}: gradients disagree: {worst[0]} "
                             f"{grad_errs[worst[0]]}")


def phase_parity() -> None:
    """A small Llama from one init through three paths: flash attention
    with the plain norm against plain attention (the flash kernels), and
    flash attention with the fused norm against the plain norm (the norm
    kernels; the *_norm.weight gradients are rms_bwd's dw)."""
    from dlrover_tpu_torch.models.llama import LlamaConfig

    g = torch.Generator(device="cuda").manual_seed(3)
    tokens, targets = (torch.randint(0, 1024, (4, 256), generator=g,
                                     device="cuda") for _ in range(2))
    losses, grad_norms, grads = {}, {}, {}
    for attn, norm in (("flash", "reference"), ("reference", "reference"),
                       ("flash", "fused")):
        run = f"{attn}/{norm}"
        cfg = LlamaConfig(vocab_size=1024, hidden_size=512,
                          intermediate_size=1408, num_layers=2, num_heads=4,
                          num_kv_heads=2, max_seq_len=256, attn_impl=attn,
                          norm_impl=norm, embed_impl="gather")
        grads[run] = _one_step_grads(cfg, tokens, targets)
        reset_counts()
        hist, launches = _train(cfg, global_batch=4, steps=3, max_micro=4)
        losses[run] = [r["loss"] for r in hist]
        grad_norms[run] = [r["grad_norm"] for r in hist]
        want = _expected_launches(cfg, len(hist))
        if launches != want:
            raise AssertionError(f"{run} parity run launches {launches}, "
                                 f"want {want}")
    _compare_runs("attention", "flash/reference", "reference/reference",
                  losses, grad_norms, grads,
                  [f"layer_0.attn.{p}_proj.kernel" for p in "qkv"])
    _compare_runs("norm", "flash/fused", "flash/reference", losses,
                  grad_norms, grads,
                  sorted(n for n in grads["flash/fused"] if "norm" in n))
    del grads
    torch.cuda.empty_cache()


def phase_llama1b(warmup: int = 2, timed: int = 5,
                  profile_out: str = "") -> dict:
    from dlrover_tpu_torch.models.llama import LlamaConfig

    # the JAX headline configuration (bench.py:400-412): Llama-1B, flash
    # attention, fused norm, sequences of 2048, micro batch 8, AdamW. f32
    # params, grads and both Adam moments take ≈20 GB of the card's 80
    micro = 8
    cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                               norm_impl="fused", embed_impl="gather")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist, launches = _train(cfg, global_batch=micro, steps=warmup + timed,
                            max_micro=micro, profile_out=profile_out)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in hist:
        log(f"  llama1b step {r['step']}: loss {r['loss']:.4f} grad_norm "
            f"{r['grad_norm']:.4f} {r['step_time_s'] * 1e3:.1f} ms")
    if len(hist) != warmup + timed:
        raise AssertionError(f"ran {len(hist)} steps")
    if not all(math.isfinite(r["loss"]) for r in hist):
        raise AssertionError("non-finite loss")
    if abs(hist[0]["loss"] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {hist[0]['loss']} is not near "
                             f"ln(vocab) = {math.log(cfg.vocab_size):.3f}")
    want = _expected_launches(cfg, len(hist))
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want} ({len(hist)}"
                             f" steps of one micro-batch)")
    timed_hist = hist[warmup:]
    step_s = sum(r["step_time_s"] for r in timed_hist) / timed
    tokens_per_s = micro * cfg.max_seq_len / step_s
    mfu = statistics.mean(r["mfu"] for r in timed_hist)
    result = {"params_b": cfg.param_count() / 1e9, "micro_batch": micro,
              "seq": cfg.max_seq_len, "step_ms": step_s * 1e3,
              "tokens_per_s": tokens_per_s, "mfu": mfu,
              "peak_mem_gb": peak_gb, "launches_per_step": {
                  n: c / len(hist) for n, c in launches.items()}}
    log(f"llama1b: {json.dumps(result)}")
    return launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", default="kernels,quant,parity,llama1b",
                        help="comma-separated subset of kernels, quant, "
                             "parity, llama1b (device and build always "
                             "run)")
    parser.add_argument("--profile", default="",
                        help="after the Llama-1B run, profile one more "
                             "step and write the kernel table here")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    t0 = time.monotonic()
    phase_device()
    phase_build()
    train_records = phase_kernels() if "kernels" in phases else []
    quant_records = phase_quant() if "quant" in phases else []
    if "parity" in phases:
        phase_parity()
    if "llama1b" in phases:
        # the training path's kernels take their launches from its run
        launches = phase_llama1b(profile_out=args.profile)
        for rec in train_records:
            rec["launches"] = launches[rec["name"]]
    records = train_records + quant_records
    log(f"elapsed {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
