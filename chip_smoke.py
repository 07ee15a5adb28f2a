"""Drive dlrover_tpu_torch on one NVIDIA card and check what comes out.

    python3 chip_smoke.py                 # every phase (needs one card)
    python3 chip_smoke.py --phases kernels,parity

Phases (each one's failure ends the run with a nonzero exit):
  device   torch sees a card; print nvidia-smi's name and power limit
  build    build the CUDA kernels from ops/csrc with nvcc; print seconds
           and ptxas's register / spill report
  kernels  each flash-attention kernel against its plain PyTorch version
           on the card at the Llama-1B slice shape and at the edge shapes
           (GQA, full, cross lengths, ragged), with stated bf16
           tolerances; time kernel, plain version and the SDPA yardstick
  parity   a small Llama trained 3 steps with attn_impl="flash" and
           "reference" from the same init: the losses agree
  llama1b  Llama-1B at full width (22 layers, hidden 2048, seq 2048)
           trained through ElasticTrainLoop, 2 warm-up + 5 timed steps;
           each flash kernel launches 22 times per step

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
PEAK_HBM_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s
SOURCE = "dlrover_tpu_torch/ops/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "dlrover_tpu/ops/flash_attention.py:129",
    "flash_bwd_dq": "dlrover_tpu/ops/flash_attention.py:249",
    "flash_bwd_dkv": "dlrover_tpu/ops/flash_attention.py:293",
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
    from dlrover_tpu_torch.ops import _build

    info = _build.load("flash_attention")
    log(f"build: flash_attention.cu in {info.build_seconds:.1f} s")
    for line in info.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn``."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


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
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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
    # yardstick only: one PyTorch call for the forward, and forward plus
    # backward; the port never calls it
    sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg,
                                       is_causal=causal).backward(do)

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
        rec = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": 0,
               "max_abs_err": err_of[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": sdpa_fwd_ms if name == "flash_fwd" else None,
               "library_fwd_bwd_ms": sdpa_fwd_bwd_ms}
        log(f"  {name}: {ms:.3f} ms (bound {bound_ms:.4f} ms by "
            f"{bound_by}, {bound_ms / ms:.1%} of it), plain {plain_ms:.3f}"
            f" ms, sdpa fwd {sdpa_fwd_ms:.3f} ms, sdpa fwd+bwd "
            f"{sdpa_fwd_bwd_ms:.3f} ms")
        records.append(rec)
    del q, k, v, do, o, lse, delta, qg, kg, vg
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
    from dlrover_tpu_torch.ops import flash_attention as fa
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
    launches = dict(fa.launch_counts)
    if profile_out:
        loop.config.max_steps = 1
        profile_step(lambda: loop.run(state, data, sampler=sampler),
                     profile_out)
    loop.close()
    del state
    return metrics["history"], launches


def _category(name: str) -> str:
    lowered = name.lower()
    for key, cat in (("flash_fwd", "flash fwd kernel"),
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


def phase_parity() -> None:
    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(3)
    tokens, targets = (torch.randint(0, 1024, (4, 256), generator=g,
                                     device="cuda") for _ in range(2))
    losses, norms, grads = {}, {}, {}
    for impl in ("flash", "reference"):
        cfg = LlamaConfig(vocab_size=1024, hidden_size=512,
                          intermediate_size=1408, num_layers=2, num_heads=4,
                          num_kv_heads=2, max_seq_len=256, attn_impl=impl,
                          norm_impl="reference", embed_impl="gather")
        grads[impl] = _one_step_grads(cfg, tokens, targets)
        fa.reset_launch_counts()
        hist, launches = _train(cfg, global_batch=4, steps=3, max_micro=4)
        losses[impl] = [r["loss"] for r in hist]
        norms[impl] = [r["grad_norm"] for r in hist]
        want = cfg.num_layers * len(hist) if impl == "flash" else 0
        if set(launches.values()) != {want}:
            raise AssertionError(
                f"{impl} parity run launches {launches}, want {want}")
    diffs = [abs(a - b) for a, b in zip(losses["flash"],
                                        losses["reference"])]
    norm_diffs = [abs(a - b) / b for a, b in zip(norms["flash"],
                                                 norms["reference"])]
    grad_errs = {n: _rel_l2(grads["flash"][n], grads["reference"][n])
                 for n in grads["reference"]}
    worst = sorted(grad_errs, key=grad_errs.get, reverse=True)
    log(f"parity: flash {losses['flash']} reference {losses['reference']} "
        f"max |diff| {max(diffs):.3g} (tolerance {PARITY_LOSS_TOL})")
    log(f"parity: grad norms flash {norms['flash']} reference "
        f"{norms['reference']} max relative diff {max(norm_diffs):.3g} "
        f"(tolerance {PARITY_GRAD_NORM_TOL})")
    log("parity: one step's gradients, relative L2 flash vs reference "
        f"(tolerance {PARITY_GRAD_TOL}): "
        + ", ".join(f"{n} {grad_errs[n]:.3g}" for n in worst[:4])
        + "; layer_0 q/k/v " + ", ".join(
            f"{grad_errs[f'layer_0.attn.{p}_proj.kernel']:.3g}"
            for p in "qkv"))
    if len(diffs) != 3 or not max(diffs) <= PARITY_LOSS_TOL:
        raise AssertionError("flash and reference training losses disagree")
    if not max(norm_diffs) <= PARITY_GRAD_NORM_TOL:
        raise AssertionError("flash and reference grad norms disagree")
    if not grad_errs[worst[0]] <= PARITY_GRAD_TOL:
        raise AssertionError(f"flash and reference gradients disagree: "
                             f"{worst[0]} {grad_errs[worst[0]]}")
    del grads
    torch.cuda.empty_cache()


def phase_llama1b(warmup: int = 2, timed: int = 5,
                  profile_out: str = "") -> dict:
    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.ops import flash_attention as fa

    # sequences of 2048 per step: f32 params, grads and both Adam moments
    # take ≈20 GB, and the step peaks at ≈58 GB of the card's 80
    micro = 8
    cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                               norm_impl="reference", embed_impl="gather")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
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
    want = cfg.num_layers * len(hist)
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launches {launches}, want {want} each "
                             f"({cfg.num_layers} per step)")
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
    parser.add_argument("--phases", default="kernels,parity,llama1b",
                        help="comma-separated subset of kernels, parity, "
                             "llama1b (device and build always run)")
    parser.add_argument("--profile", default="",
                        help="after the Llama-1B run, profile one more "
                             "step and write the kernel table here")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    t0 = time.monotonic()
    phase_device()
    phase_build()
    records = phase_kernels() if "kernels" in phases else []
    if "parity" in phases:
        phase_parity()
    if "llama1b" in phases:
        launches = phase_llama1b(profile_out=args.profile)
        for rec in records:
            rec["launches"] = launches[rec["name"]]
    log(f"elapsed {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
