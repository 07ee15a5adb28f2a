"""Drive dlrover_tpu_torch on one NVIDIA card and check what comes out.

    python3 chip_smoke.py                 # every phase (needs one card)
    python3 chip_smoke.py --phases kernels,parity

Phases (each one's failure ends the run with a nonzero exit):
  device   torch sees a card; print nvidia-smi's name and power limit
  build    build the three CUDA libraries of ops/csrc (flash attention,
           norms, quantization), one nvcc each, all started together;
           print each one's seconds and ptxas's register / spill report
           for every kernel; fail if a wgmma kernel (the flash forward,
           dQ or dK/dV) spills
  kernels  each flash-attention and RMSNorm kernel against its plain
           PyTorch version on the card at the Llama-1B slice shape and at
           edge shapes, with stated tolerances, and o, dQ, dK and dV the
           same bits in a second call; time kernel, plain version and the
           library yardstick (SDPA, F.rms_norm)
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
  resume   the same Llama-1B through ElasticTrainLoop with a flash
           checkpoint in a temporary directory (deleted at the end; the
           phase fails if the disk cannot hold one checkpoint, or the
           host's memory the pinned host copy plus one restore): A 7
           steps saving at 3, its host copy staged into a peer cache (on
           /dev/shm when that holds two stages), and a second, steady-state
           save after step 7 (dropped before B); the blocking part of both
           saves by piece (the first's page-locking timed apart); B a fresh loop restores 3 from disk and trains
           4-6, the same bits as A, the restore's peak device memory within
           the state plus its largest leaf; F a fresh loop with the peer
           cache and no master restores 3 through the local pseudo-plan:
           source "peer", the same bits as A, the same peak bound, its
           restore by part beside B's read; C the same as B with int8
           parameters, losses within 0.1% of A's, 201 quantize and 201
           dequantize launches, codes bit for bit with the plain versions;
           D a worker process at 2 layers gets SIGTERM after its second
           step, saves where it stops and a second one resumes there; E 3
           steps with AdamW's moments in pinned host memory, the same bits
           as A's first 3
  standalone
           the control plane: the port's JobMaster in this process, and
           `python -m dlrover_tpu_torch.run --master-addr ...` running
           the worker script dlrover_tpu_torch/examples/llama_train.py
           (Llama-1B, 7 steps saving at 3 and 6, a step report each step)
           under the port's agent, whose work directory (peer cache) is on
           /dev/shm when that holds two stages; once step 3 is committed
           and a peer stage at least as new is complete (the commit and
           the peer write run side by side; the kill waits for both)
           the worker is SIGKILLed and the agent relaunches it in the next
           rendezvous round. The relaunched worker restores with source
           "peer" through the master's plan at the newer of the committed
           step and the staged one (both read after the kill), and its
           steps, like the first incarnation's, are the same bits as
           resume's run A (or an uninterrupted in-process run when resume
           did not run); the agent exits 0, the master's SpeedMonitor
           holds step 7, its tokens/s read just after the kill (the first
           incarnation's step reports) is within 5% of the worker's own
           over the same steps, and the worker launched each flash kernel
           22 times and each RMSNorm kernel 45 times a resumed step. Prints
           host memory, the recovery time by part (the restore split into
           plan, transfer and assemble) up to the first resumed step and
           on to the second, the blocking saves by piece (each process's
           first save page-locks its host buffers, timed apart), and the
           step times beside the writers that ran under them
  faults   planned and silent failures under the port's JobMaster (in
           this process) and `python -m dlrover_tpu_torch.run`, the same
           Llama-1B worker (7 steps saving at 3 and 6, a step report
           each step). Launch 1: a chaos `preempt` notice at step 4 with
           a 90 s grace (and a `slow` hold of 3 s so the drain request
           lands at step 4's boundary): the agent exits 0, the worker
           76 classified drained, no charge, the emergency save
           `saved` and step 4 committed, notice to exit under the grace;
           prints notice → drain request → consumed step → exit, the
           emergency save's blocking part, commit and page-locking, and
           whether the 30 s default grace would have held. Launch 2,
           under DLROVER_TPU_HANG_WATCHDOG_S=12 with a chaos `hang` at
           step 7 (after the step-6 save): it resumes at the drained
           step, the watchdog aborts it once (its flight dump holds the
           main thread in the chaos sleep), the agent classifies the
           abort `hang` and relaunches it uncharged, the relaunch
           restores step 6 and finishes step 7 (replaying the hang
           within its first-step budget); every step is the same bits
           as resume's run A (or an in-process run); prints last step →
           abort → relaunch → first resumed step. Then the master's
           goodput ledger through `MasterClient.get_goodput`: its
           buckets cover the elapsed rank-seconds (within 5%), drain >
           0, 0 < hang ≤ the watchdog's 12 s. Each of the three worker
           processes launched every flash kernel 22 times and every
           RMSNorm kernel 45 times a step it finished

  observe  the master observes the card: the port's JobMaster in this
           process (diagnosis rounds and tsdb samples every 2 s, every
           other knob at its default) and `python -m dlrover_tpu_torch.run
           --monitor-interval 1` around the same Llama-1B worker (46
           steps, no checkpoint, a step report each step) under the
           agent with its monitors, and a chaos `slow` fault of 1.5 s a
           step from step 37 on. Gates: every step report's
           hbm_peak_bytes equals the worker's own allocator peak
           (`allocated_bytes.all.peak`) at that step; a relayed
           NodeResourceStats carries the card's use and total; the
           step-time, tokens/s, MFU and HBM-peak series hold a point per
           sample interval of training; StepTraceRequest answers one
           group a step, gated by rank 0, its phases (data wait
           included) within 5% of the period to the next step's start,
           the capture's two boundaries reported apart and the loop's
           young-generation collection at a boundary (logged by the
           worker) taken out of its period; the solo rank's
           CriticalPathRule issues profile:0, the agent requests it and
           the worker captures 5 steps with torch.profiler (manifest
           ok, the trace names the five training kernels; its size and
           export time printed); no hbm_pressure report; a critical
           throughput_collapse under the fault; the clean steps' median
           within 1% of the llama1b phase's and the first step after
           the capture inside their spread (the captured steps'
           slowdown printed); every loss and grad norm the bits of an
           uninterrupted in-process run
  failover the master survives its own death: a primary `python -m
           dlrover_tpu_torch.master.job_master --state-dir S
           --bootstrap-file B` with `kill:master:0@10`, a hot standby
           (the same with `--standby`, at its defaults: a probe every
           2 s, promotion after 3 failures) and `python -m
           dlrover_tpu_torch.run --monitor-interval 1` finding the
           master through B, around the same Llama-1B worker (a report
           a step, saves every 8; the steps derived from the code's
           detection, promotion and reconnect bounds so that 10 follow
           the reconnect, printed); every master RPC of the agent and
           the worker has a 0.5 s deadline, cut from 30 s (a call to a
           dead master waits out its whole deadline). Gates: the primary
           dies by SIGKILL at step 10's report; one promotion, at the
           loaded snapshot's generation + 1, named by B; the agent's
           master-lost mode, one reconnect with world_intact=True, no
           new round, one worker pid from start to exit, its steps in
           order, exit 0; every step the bits of an uninterrupted run;
           the promoted master's first snapshot equal to the loaded one
           component by component (rendezvous, task manager, kv store,
           speed monitor, goodput ledger, diagnosis), and its tsdb
           holding the sidecar's points from before the kill. Prints
           kill → promotion (and the promotion) → master-lost mode →
           reconnect, the step period before the kill, in the outage and
           after the reconnect, the step reports that reached the
           promoted master, its goodput buckets and the phase's time
  replan   re-planning on resize: the port's JobMaster in this process
           (min 1, max 2 nodes, diagnosis every 2 s, a speed window of 8
           samples) and two `python -m dlrover_tpu_torch.run
           --monitor-interval 0.5` agents, ranks 0 and 1, each around the
           Llama-1B worker as a `--solo-replica` (no process group, its
           own checkpoint directory) at batch 8 in micro batches of 2,
           both on the one card, 32 steps, a report a step, no interval
           save, `resize:-1@6`. Rank 1 leaves with the clean-drain exit at
           step 6, the master removes it, rank 0's agent stops its worker
           (the stop forces a save and a peer stage) and respawns it in
           one rendezvous round into world 1. Gates: the stamped plan goes
           from world 2 to world 1 at a higher epoch, feasible, the
           survivor applying "batch" (replica mode) then "mesh+batch";
           one round; the leaver drained; the restore from the
           survivor's own staged cut (source peer, no checkpoint read);
           replan_plan, replan_migrate (source peer) and replan_rebuild
           once each for the resize; the resumed steps bit for bit those
           of a solo world-1 worker in this process restored from the
           same staged cut (hard-linked aside); the master's speed
           re-anchored at the re-join (its window emptied, one card) and
           its tokens/s and MFU within 2% of the survivor's own over the
           same steps (its step lines' mean period); the calibration's world-1 entry with >= 3
           samples, predicted by the planner's formula on the ModelInfo
           (989e12); the ledger's replans row holding plan, migrate and
           rebuild; each worker's kernel launches exactly its steps'.
           Prints predicted against measured step time, whether
           PlanRegressionRule fired, the three legs' seconds, the leaver's
           drain to the first resumed step, both replicas' steps while
           they share the card and their allocator peaks

The line before the last is the kernels' JSON record (the quantization
pair's launches are the resume phase's checkpoint path; each kernel's
"standalone_launches" are those the worker under the agent printed for
its resumed incarnation, its "faults_launches" the sum over the faults
phase's three worker processes, its "observe_launches" the observe
phase worker's, its "failover_launches" the failover phase worker's and
its "replan_launches" the replan phase's three incarnations'); the last
line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import signal
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
    # the wgmma kernels' 128-row tiles: one row past a tile, GQA across
    # several tiles, ragged s_q < s_k and s_q > s_k, MQA in one tile; dQ
    # with s_q not a multiple of 64 and GQA over two kv tiles
    dict(b=1, h=4, h_kv=4, s_q=129, s_k=129, d=128, causal=True),
    dict(b=2, h=8, h_kv=2, s_q=320, s_k=320, d=128, causal=True),
    dict(b=1, h=4, h_kv=4, s_q=200, s_k=456, d=64, causal=True),
    dict(b=1, h=4, h_kv=4, s_q=456, s_k=200, d=128, causal=True),
    dict(b=1, h=4, h_kv=1, s_q=64, s_k=64, d=64, causal=False),
    dict(b=1, h=8, h_kv=2, s_q=200, s_k=200, d=128, causal=True),
]
# kernels that must not spill: the warp-specialised ones, whose consumer
# warpgroups run at 240 registers under setmaxnreg
NO_SPILL = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
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
    spills = []
    for name, info in libs.items():
        log(f"build: {name}.cu in {info.build_seconds:.1f} s")
        for kernel, regs, spill in ptxas_report(info.ptxas_log):
            log(f"  ptxas: {kernel}: {regs} registers, {spill} bytes spilled")
            if spill and kernel.startswith(NO_SPILL):
                spills.append(kernel)
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")


def ptxas_report(ptxas_log: str) -> list:
    """(kernel, registers, spill bytes stored + loaded) for each entry
    function of an ``nvcc -Xptxas=-v`` log, the kernel named by its
    template (``flash_fwd_kernel<128>``)."""
    import re

    rows, kernel, spill = [], None, 0
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", m.group(1))
            kernel = (f"{k.group(1)}<{k.group(2)}>" if k and k.group(2)
                      else k.group(1) if k else m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append((kernel, int(m.group(1)), spill))
            kernel, spill = None, 0
    return rows


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
    o2, _ = fa.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    po, plse = fa.flash_fwd_plain(q, k, v, causal)
    # both backward versions get the same lse and delta
    delta = (do.float() * po.float()).sum(-1, keepdim=True)
    dq = fa.flash_bwd_dq(q, k, v, do, plse, delta, causal)
    dq2 = fa.flash_bwd_dq(q, k, v, do, plse, delta, causal)
    torch.cuda.synchronize()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, plse, delta, causal)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, plse, delta, causal)
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
    same = {name: torch.equal(a, b) for name, a, b in (
        ("o", o, o2), ("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2))}
    bad += [f"{name} differs between two calls" for name, eq in same.items()
            if not eq]
    log(f"  o, dq, dk, dv bitwise equal in two calls: {same}")
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
    median_ms = statistics.median(r["step_time_s"] for r in timed_hist) * 1e3
    tokens_per_s = micro * cfg.max_seq_len / step_s
    mfu = statistics.mean(r["mfu"] for r in timed_hist)
    result = {"params_b": cfg.param_count() / 1e9, "micro_batch": micro,
              "seq": cfg.max_seq_len, "step_ms": step_s * 1e3,
              "step_median_ms": median_ms,
              "tokens_per_s": tokens_per_s, "mfu": mfu,
              "peak_mem_gb": peak_gb, "launches_per_step": {
                  n: c / len(hist) for n, c in launches.items()}}
    log(f"llama1b: {json.dumps(result)}")
    return launches, result


# ---------------------------------------------------------------------------
# resume: flash checkpoint and restore at Llama-1B
# ---------------------------------------------------------------------------

# the SIGTERM drill's worker: Llama-1B at 2 layers and full width, run
# through the port only, with the loop's SIGTERM handler installed. The
# first run prints "ready" after its second step and pauses there, so the
# signal lands before its third step; the second run resumes.
SIGTERM_WORKER = r'''
import dataclasses, functools, json, sys, time
import torch
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.trainer.elastic_loop import ElasticTrainLoop, TrainLoopConfig
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

ckpt, first = sys.argv[1], sys.argv[2] == "first"
cfg = dataclasses.replace(LlamaConfig.llama_1b(
    max_seq_len=2048, attn_impl="flash", norm_impl="fused",
    embed_impl="gather"), num_layers=2)
loop = ElasticTrainLoop(
    functools.partial(Llama, cfg),
    lambda p: torch.optim.AdamW(p, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.1),
    cross_entropy_loss,
    TrainLoopConfig(global_batch=8, seq_len=2048, max_micro_per_replica=8,
                    max_steps=8 if first else 2, checkpoint_dir=ckpt,
                    save_interval_steps=1000, report_interval_steps=0))
loop.install_signal_handler()
sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)
state, start = loop.restore_or_init(0, sampler)
position = sampler.completed_num

def data():
    for i, batch in enumerate(batches(synthetic_corpus(cfg.vocab_size),
                                      sampler, 8, 2048)):
        if first and i == 2:
            print("ready", flush=True)
            time.sleep(5)
        yield batch

state, metrics = loop.run(state, data(), start_step=start, sampler=sampler)
print(json.dumps({"start": start, "position": position,
                  "step": metrics["step"],
                  "latest": loop.checkpointer.latest_step(),
                  "losses": [r["loss"] for r in metrics["history"]]}))
loop.close()
'''


def _free_memory() -> None:
    """Collect, and hand the card's and the host's cached blocks back
    (pinned host blocks too: the next loop pins its buffers anew)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, files in os.walk(path) for name in files)


def host_memory() -> dict:
    """This host's MemTotal and MemAvailable and /dev/shm's free bytes."""
    import shutil

    info = {"shm_free": 0}
    with open("/proc/meminfo") as f:
        for line in f:
            name, value = line.split(":", 1)
            if name in ("MemTotal", "MemAvailable"):
                info[name] = int(value.split()[0]) * 1024
    try:
        info["shm_free"] = shutil.disk_usage("/dev/shm").free
    except OSError:
        pass
    return info


def peer_root(state_bytes: int, tmp: str, smi: str, what: str) -> str:
    """A new directory for a peer cache (or an agent's work directory):
    on /dev/shm when it and the host's memory hold two stages beside the
    pinned host copy and one restore, else under ``tmp`` on disk. Fails,
    with the numbers, when the host cannot hold the pinned copy plus one
    restore."""
    import tempfile

    mem = host_memory()
    copies = 2 * state_bytes          # the pinned host copy + one restore
    on_shm = min(mem["shm_free"],
                 mem["MemAvailable"] - copies) >= 2 * state_bytes
    where = "/dev/shm" if on_shm else f"{tmp} (disk)"
    log(f"{what}: host MemTotal {mem['MemTotal'] / 1e9:.2f} GB, "
        f"MemAvailable {mem['MemAvailable'] / 1e9:.2f} GB, /dev/shm free "
        f"{mem['shm_free'] / 1e9:.2f} GB; pinned copy + one restore "
        f"{copies / 1e9:.2f} GB, two staged steps "
        f"{2 * state_bytes / 1e9:.2f} GB; the peer cache goes to {where} "
        f"({smi})")
    if mem["MemAvailable"] < copies:
        raise AssertionError(
            f"{mem['MemAvailable'] / 1e9:.2f} GB of host memory available: "
            f"less than the pinned host copy plus one restore "
            f"({copies / 1e9:.2f} GB)")
    return tempfile.mkdtemp(prefix="chip_smoke_peer_",
                            dir="/dev/shm" if on_shm else tmp)


def _resume_loop(cfg, ckpt_dir: str, bits: int, save_interval: int):
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )

    return ElasticTrainLoop(
        functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
        TrainLoopConfig(global_batch=8, seq_len=cfg.max_seq_len,
                        max_micro_per_replica=8, max_steps=3,
                        checkpoint_dir=ckpt_dir,
                        save_interval_steps=save_interval,
                        checkpoint_quantize_bits=bits,
                        report_interval_steps=0))


def _sampler_and_data(cfg):
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
    from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

    sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)

    def data():
        # created at the first step, so a restored position counts
        yield from batches(synthetic_corpus(cfg.vocab_size), sampler, 8,
                           cfg.max_seq_len)

    return sampler, data()


def _saved_codes(ckpt_dir: str, step: int, state) -> dict:
    """The int8 codes and scales of a step on disk, read into host
    buffers laid out for ``state``'s parameters."""
    import os

    import torch.distributed.checkpoint as dcp

    from dlrover_tpu_torch.checkpoint import quantized as cq

    params = {n: p.detach() for n, p in state.model.named_parameters()}
    target = cq.abstract_encoded(params, 8)
    dcp.load({"model": target}, checkpoint_id=os.path.join(ckpt_dir,
                                                           str(step)))
    return target


def _check_saved_codes(ckpt_dir: str, step: int, state) -> None:
    """Before a restore: the codes on disk are the plain quantization of
    the parameters that were saved (``state`` at the saved step)."""
    from dlrover_tpu_torch.checkpoint import quantized as cq

    codes = _saved_codes(ckpt_dir, step, state)
    want = cq.encode_tree({n: p.detach().cpu() for n, p in
                           state.model.named_parameters()}, 8)
    bad = [name for name, node in codes.items() if cq._is_encoded(node)
           and not (torch.equal(node["q"], want[name]["q"])
                    and torch.equal(node["s"], want[name]["s"]))]
    if bad:
        raise AssertionError(f"saved codes differ from the plain "
                             f"quantization: {bad}")


def _check_restored_codes(ckpt_dir: str, step: int, state) -> int:
    """After a restore: the parameters (dequantized by the kernel) are
    the plain dequantization of the codes on disk, bit for bit; returns
    the leaves compared."""
    from dlrover_tpu_torch.checkpoint import quantized as cq
    from dlrover_tpu_torch.ops import quantization as qz

    codes = _saved_codes(ckpt_dir, step, state)
    params = dict(state.model.named_parameters())
    bad = []
    for name, node in codes.items():
        if not cq._is_encoded(node):
            continue
        got = params[name].detach().cpu()
        want = qz.dequantize_plain(node["q"].reshape(-1, 128),
                                   node["s"].reshape(-1, 1)
                                   ).reshape(got.shape)
        if not torch.equal(got, want):
            bad.append(name)
    if bad:
        raise AssertionError(f"restored parameters differ from the plain "
                             f"dequantization: {bad}")
    return len(codes)


def _quant_kernel_times() -> dict:
    """quantize_rows / dequantize_rows at the embed table's shape
    (32000×2048 f32, groups of 128), against their bounds."""
    from dlrover_tpu_torch.ops import quantization as qz

    g = torch.Generator(device="cuda").manual_seed(11)
    x2 = (0.02 * torch.randn(32000, 2048, generator=g, device="cuda")
          ).reshape(-1, 128)
    q2, s2 = qz.quantize_rows(x2, 127)
    n = x2.numel()
    out = {}
    for name, fn, bounds in (
            ("quantize", lambda: qz.quantize_rows(x2, 127),
             roofline(4 * n, PEAK_F32_FLOPS, 4 * n + n + 4 * len(x2))),
            ("dequantize", lambda: qz.dequantize_rows(q2, s2),
             roofline(n, PEAK_F32_FLOPS, n + 4 * len(x2) + 4 * n))):
        ms = time_ms(fn)
        out[name] = {"ms": ms, "bound_ms": bounds[0], "bound_by": bounds[1]}
    del x2, q2, s2
    return out


def _sigterm_drill(tmp: str) -> dict:
    """D: a worker process gets SIGTERM after its second step, saves the
    step it stops on and exits 0; a second worker resumes there."""
    import os

    script = os.path.join(tmp, "sigterm_worker.py")
    with open(script, "w") as f:
        f.write(SIGTERM_WORKER)
    ckpt = os.path.join(tmp, "sigterm")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    outs = []
    for mode in ("first", "second"):
        proc = subprocess.Popen([sys.executable, script, ckpt, mode],
                                stdout=subprocess.PIPE, text=True, env=env)
        try:
            lines = []
            for line in proc.stdout:
                lines.append(line)
                if line.strip() == "ready":
                    proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if code != 0:
            raise AssertionError(f"SIGTERM drill {mode} run exited {code}")
        outs.append(json.loads(lines[-1]))
    first, second = outs
    log(f"resume D (SIGTERM): first run stopped at step {first['step']} "
        f"(latest saved {first['latest']}), second started at "
        f"{second['start']} with the sampler at {second['position']}, "
        f"losses {first['losses']} then {second['losses']}")
    if not (first["step"] == first["latest"] == second["start"] == 3
            and second["position"] == 24):
        raise AssertionError(f"SIGTERM drill did not resume where it "
                             f"stopped: {first} {second}")
    return {"stopped_at": first["step"], "resumed_at": second["start"]}


def phase_resume(smi: str, llama1b: dict) -> dict:
    """Llama-1B at full width and depth through ElasticTrainLoop with a
    flash checkpoint: A 7 steps saving at 3 (staged into a peer cache) and
    once more after 7; B a fresh loop restores 3 from disk and trains 4-6,
    the same bits as A; F the same from the peer cache; C the same as B
    with int8 parameters (losses within 0.1%, 201 quantize and 201
    dequantize launches, codes bit for bit with the plain versions); D the
    SIGTERM drill; E 3 steps with the moments offloaded, the same bits as
    A's first 3."""
    import shutil
    import tempfile

    import os

    from dlrover_tpu_torch.checkpoint import quantized as cq
    from dlrover_tpu_torch.checkpoint.peer_restore import load_manifest
    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        cross_entropy_loss,
    )
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                               norm_impl="fused", embed_impl="gather")
    params = cfg.param_count()
    state_bytes = 3 * 4 * params
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    out = {"card": smi}
    peer_dir = ""
    try:
        free = shutil.disk_usage(tmp).free
        log(f"resume: checkpoints in {tmp}, {free / 1e9:.1f} GB free; one "
            f"exact checkpoint is {state_bytes / 1e9:.2f} GB ({smi})")
        if free < 1.1 * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free in {tmp}: less "
                                 f"than one checkpoint")
        dir_a = f"{tmp}/exact"
        peer_dir = peer_root(state_bytes, tmp, smi, "resume")
        cache = f"{peer_dir}/cache"

        # A: 7 steps, the save at step 3 staged into the peer cache, then a
        # steady-state save after step 7 (its buffers already pinned;
        # straight through the checkpointer, not staged, and dropped
        # before B reads the newest step)
        os.environ[NodeEnv.PEER_CACHE_DIR] = cache
        loop = _resume_loop(cfg, dir_a, 0, 3)
        sampler, data = _sampler_and_data(cfg)
        state, _ = loop.restore_or_init(0, sampler)
        state, m1 = loop.run(state, data, 0, sampler)
        first_save = dict(loop.checkpointer.last_save)
        loop.checkpointer.save_interval_steps = 0
        loop.config.max_steps = 4
        state, m2 = loop.run(state, data, 3, sampler)
        loop.checkpointer.maybe_save(7, state, force=True)
        loop.checkpointer.wait()
        steady_save = dict(loop.checkpointer.last_save)
        hist_a = m1["history"] + m2["history"]
        pinned_gb = loop.checkpointer.host.nbytes / 1e9
        pinning_s = first_save["host_alloc_s"]
        loop.close()
        del state, loop
        del os.environ[NodeEnv.PEER_CACHE_DIR]
        shutil.rmtree(f"{dir_a}/7")
        _free_memory()
        step_s = statistics.mean(r["step_time_s"] for r in hist_a)
        ckpt_bytes = _dir_bytes(f"{dir_a}/3")
        write_s = first_save["commit_s"] - first_save["blocking_s"]
        staged = load_manifest(cache)
        out["a"] = {"losses": [r["loss"] for r in hist_a],
                    "grad_norms": [r["grad_norm"] for r in hist_a],
                    "blocking_save_ms": first_save["blocking_s"] * 1e3,
                    "steady_blocking_save_ms":
                        steady_save["blocking_s"] * 1e3,
                    "blocking_share_of_step":
                        steady_save["blocking_s"] / step_s,
                    "first_save": first_save, "steady_save": steady_save,
                    "pinned_gb": pinned_gb, "pinning_s": pinning_s,
                    "commit_s": first_save["commit_s"], "bytes": ckpt_bytes,
                    "write_gb_s": ckpt_bytes / write_s / 1e9,
                    "staged_step": staged["step"],
                    "staged_bytes": sum(m["nbytes"] for m in
                                        staged["shards"].values()),
                    "steps_ms": [r["step_time_s"] * 1e3 for r in hist_a],
                    "note": "run() waits for the commit at its end, "
                            "so steps 4-7 ran under step 3's peer-cache "
                            "write only"}
        log(f"resume A: {json.dumps(out['a'])} ({smi})")
        log(f"resume A blocking save by piece, first and steady state, s: "
            f"{json.dumps(first_save)} | {json.dumps(steady_save)}; the "
            f"host buffers' page-locking (once, inside the first save): "
            f"{pinned_gb:.2f} GB in {pinning_s:.3f} s; the first save "
            f"without it {first_save['blocking_s'] - pinning_s:.3f} s "
            f"({smi})")
        if staged["step"] != 3:
            raise AssertionError(f"A staged step {staged['step']}, not 3")

        # B: a fresh loop restores step 3 from disk and trains 4-6
        loop = _resume_loop(cfg, dir_a, 0, 0)
        sampler, data = _sampler_and_data(cfg)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        state, start = loop.restore_or_init(0, sampler)
        restore_peak = torch.cuda.max_memory_allocated() - before
        largest = max(p.numel() * 4 for p in state.model.parameters())
        timings = dict(loop.last_restore_timings)
        source = loop.last_restore_source
        position = sampler.completed_num
        state, m = loop.run(state, data, start, sampler)
        loop.close()
        del state, loop
        _free_memory()
        hist_b = m["history"]
        pairs = [(a[k], b[k]) for a, b in zip(hist_a[3:], hist_b)
                 for k in ("loss", "grad_norm")]
        same_bits = all(a == b for a, b in pairs)
        rel = max(abs(a - b) / abs(a) for a, b in pairs)
        out["b"] = {"start": start, "source": source, "sampler": position,
                    "losses": [r["loss"] for r in hist_b],
                    "same_bits": same_bits, "max_rel_diff": rel,
                    "restore_peak_gb": restore_peak / 2 ** 30,
                    "limit_gb": (state_bytes + largest) / 2 ** 30,
                    "read_gb_s": timings.get("restore_restored_bytes", 0)
                    / max(timings.get("restore_tensor_read_s", 0), 1e-9)
                    / 1e9, "timings": timings}
        log(f"resume B: {json.dumps(out['b'])} ({smi})")
        if (start, source, position, len(hist_b)) != (3, "checkpoint", 24,
                                                      3):
            raise AssertionError(f"B resumed at step {start} from {source},"
                                 f" sampler {position}, ran {len(hist_b)} "
                                 f"steps")
        if not (same_bits or rel < 1e-6):
            raise AssertionError(f"B's steps 4-6 differ from A's by {rel}")
        if restore_peak > state_bytes + largest:
            raise AssertionError(f"restore peaked at {restore_peak} bytes, "
                                 f"over the state's {state_bytes} + "
                                 f"{largest}")

        # F: a fresh loop with A's peer cache and no master restores step 3
        # through the local pseudo-plan and trains 4-6
        os.environ[NodeEnv.PEER_CACHE_DIR] = cache
        loop = _resume_loop(cfg, dir_a, 0, 0)
        sampler, data = _sampler_and_data(cfg)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        state, start = loop.restore_or_init(0, sampler)
        peak_f = torch.cuda.max_memory_allocated() - before
        timings_f = dict(loop.last_restore_timings)
        source = loop.last_restore_source
        position = sampler.completed_num
        state, m = loop.run(state, data, start, sampler)
        loop.close()
        del state, loop
        del os.environ[NodeEnv.PEER_CACHE_DIR]
        _free_memory()
        hist_f = m["history"]
        same_f = [(a["loss"], a["grad_norm"]) == (f["loss"], f["grad_norm"])
                  for a, f in zip(hist_a[3:], hist_f)]
        out["f"] = {"start": start, "source": source, "sampler": position,
                    "losses": [r["loss"] for r in hist_f],
                    "same_bits": same_f, "restore_peak_gb": peak_f / 2 ** 30,
                    "limit_gb": (state_bytes + largest) / 2 ** 30,
                    "timings": timings_f}
        parts = {
            "peer": {k: timings_f.get(k) for k in (
                "peer_plan_s", "peer_transfer_s", "peer_assemble_s",
                "peer_restore_s", "peer_bytes", "peer_bandwidth_mbps")},
            "checkpoint (B)": {k: timings.get(k) for k in (
                "dcp_read_s", "restore_tensor_read_s",
                "restore_restored_bytes", "restore_read_bandwidth_mbps")}}
        out["f"]["parts_beside_b"] = parts
        log(f"resume F: {json.dumps(out['f'])} ({smi})")
        log(f"resume F restore by part beside B's read: {json.dumps(parts)} "
            f"({smi})")
        if (start, source, position, len(hist_f)) != (3, "peer", 24, 3):
            raise AssertionError(f"F resumed at step {start} from {source}, "
                                 f"sampler {position}, ran {len(hist_f)} "
                                 f"steps")
        if not all(same_f):
            raise AssertionError(f"F's steps 4-6 differ from A's: {same_f}")
        if peak_f > state_bytes + largest:
            raise AssertionError(f"peer restore peaked at {peak_f} bytes, "
                                 f"over the state's {state_bytes} + "
                                 f"{largest}")
        shutil.rmtree(peer_dir)
        shutil.rmtree(dir_a)

        # C: int8 parameters
        dir_c = f"{tmp}/int8"
        loop = _resume_loop(cfg, dir_c, 8, 3)
        sampler, data = _sampler_and_data(cfg)
        state, _ = loop.restore_or_init(0, sampler)
        reset_counts()
        state, _ = loop.run(state, data, 0, sampler)
        save_launches = read_counts()
        save_c = dict(loop.checkpointer.last_save)
        _check_saved_codes(dir_c, 3, state)
        params_sd = {n: p.detach() for n, p in state.model.named_parameters()}
        enc = cq.abstract_encoded(params_sd, 8)
        codes = sum(n["q"].numel() for n in enc.values() if cq._is_encoded(n))
        scales = sum(n["s"].numel() * 4 for n in enc.values()
                     if cq._is_encoded(n))
        loop.close()
        del state, loop, params_sd, enc
        _free_memory()
        loop = _resume_loop(cfg, dir_c, 8, 0)
        sampler, data = _sampler_and_data(cfg)
        reset_counts()
        state, start = loop.restore_or_init(0, sampler)
        restore_launches = read_counts()
        leaves = _check_restored_codes(dir_c, start, state)
        timings_c = dict(loop.last_restore_timings)
        state, m = loop.run(state, data, start, sampler)
        loop.close()
        del state, loop
        _free_memory()
        hist_c = m["history"]
        rel_c = max(abs(a["loss"] - c["loss"]) / a["loss"]
                    for a, c in zip(hist_a[3:], hist_c))
        out["c"] = {"start": start, "losses": [r["loss"] for r in hist_c],
                    "max_rel_loss_diff": rel_c,
                    "quantize_launches": save_launches["quantize"],
                    "dequantize_launches": restore_launches["dequantize"],
                    "leaves": leaves, "bytes": _dir_bytes(f"{dir_c}/3"),
                    "codes_bytes": codes, "scales_bytes": scales,
                    "timings": timings_c, "save": save_c,
                    "kernels_at_embed": _quant_kernel_times()}
        log(f"resume C: {json.dumps(out['c'])} ({smi})")
        if start != 3 or len(hist_c) != 3 or not rel_c < 1e-3:
            raise AssertionError(f"C: start {start}, losses off by {rel_c}")
        if (save_launches["quantize"], restore_launches["dequantize"]) != (
                201, 201):
            raise AssertionError(f"C launched {save_launches} saving and "
                                 f"{restore_launches} restoring")
        shutil.rmtree(dir_c)

        out["d"] = _sigterm_drill(tmp)

        # E: the first 3 steps again, moments in host memory between steps
        trainer = build_trainer(functools.partial(Llama, cfg), _adamw, None,
                                torch.zeros(8, cfg.max_seq_len),
                                cross_entropy_loss, micro_batch=8,
                                offload_opt_state=True)
        sampler, data = _sampler_and_data(cfg)
        torch.cuda.reset_peak_memory_stats()
        state = trainer.init(0)
        hist_e = []
        for _, (tokens, targets) in zip(range(3), data):
            t0 = time.monotonic()
            state, metrics = trainer.step(state, *trainer.shard_batch(
                tokens, targets))
            hist_e.append((float(metrics["loss"]), time.monotonic() - t0))
            sampler.record_batch(8)
        moments = [v for s in state.optimizer.state.values()
                   for v in s.values() if v.ndim > 0]
        pinned = all(v.device.type == "cpu" and v.is_pinned()
                     for v in moments)
        peak_e = torch.cuda.max_memory_allocated() / 2 ** 30
        del state, trainer, moments
        _free_memory()
        out["e"] = {"losses": [x for x, _ in hist_e],
                    "step_ms": [t * 1e3 for _, t in hist_e],
                    "peak_gb": peak_e, "pinned_between_steps": pinned,
                    "llama1b_step_ms": llama1b.get("step_ms", "not measured"),
                    "llama1b_peak_gb": llama1b.get("peak_mem_gb",
                                                   "not measured")}
        log(f"resume E (offload): {json.dumps(out['e'])} ({smi})")
        if out["e"]["losses"] != out["a"]["losses"][:3] or not pinned:
            raise AssertionError(f"offloaded steps {out['e']['losses']} "
                                 f"against {out['a']['losses'][:3]}, pinned "
                                 f"{pinned}")
    finally:
        # the peer cache may lie on /dev/shm, outside ``tmp``
        if peer_dir:
            shutil.rmtree(peer_dir, ignore_errors=True)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# standalone: the control plane (master, agent, worker) around Llama-1B
# ---------------------------------------------------------------------------

# the master's tokens/s against the worker's own over the same steps
SPEED_TOL = 0.05
# the worker under the agent: steps, saving every SAVE_EVERY (the kill
# comes once the first save is committed; a relaunch resumes at 3 or 6)
STANDALONE_STEPS = 7
SAVE_EVERY = 3


def _reference_run(cfg, steps: int = STANDALONE_STEPS) -> list:
    """Resume's run A without its checkpoint: ``steps`` uninterrupted
    steps from the same seed and data, [(loss, grad_norm)] a step."""
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )

    loop = ElasticTrainLoop(
        functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
        TrainLoopConfig(global_batch=8, seq_len=cfg.max_seq_len,
                        max_micro_per_replica=8, max_steps=steps,
                        report_interval_steps=0))
    sampler, data = _sampler_and_data(cfg)
    state, _ = loop.restore_or_init(0, sampler)
    state, metrics = loop.run(state, data, 0, sampler)
    loop.close()
    del state, loop
    _free_memory()
    return [(r["loss"], r["grad_norm"]) for r in metrics["history"]]


def _children(pid: int) -> list:
    """The processes whose parent is ``pid``, from /proc."""
    import os

    kids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the command may hold spaces: the fields after it start past ')'
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            kids.append(int(name))
    return kids


def _agent_times(path: str) -> dict:
    """Wall-clock marks of the agent's relaunch, and the rendezvous round
    of each spawn, from its log lines ("[2026-10-17 00:58:52,261]
    [WARNING] [...] message")."""
    import datetime
    import re

    marks = {"rounds": []}
    patterns = {"detected": r"worker failed \(exit -9, killed\); backing",
                "backed_off": r"worker failed \(exit -9, killed\); restart",
                "spawned": r"spawning worker \(round 1,"}
    with open(path) as f:
        for line in f:
            m = re.match(r"\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3})\]", line)
            if not m:
                continue
            ts = datetime.datetime.strptime(
                m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
            for key, pattern in patterns.items():
                if key not in marks and re.search(pattern, line):
                    marks[key] = ts
            spawn = re.search(r"spawning worker \(round (\d+),", line)
            if spawn:
                marks["rounds"].append(int(spawn.group(1)))
    return marks


# the worker's log lines that mark a fault's timeline: first line
# starting with each prefix → its name in a run's "marks"
_WORKER_MARKS = {
    "chaos: preemption notice": "notice",
    "drain request at step": "drain_request_consumed",
    "emergency checkpoint": "emergency",
    "drained at step": "drained",
    "chaos: hanging": "hang_start",
    "step-hang watchdog": "watchdog_fired",
    "llama_train: done": "done",
}


def _worker_log(path: str) -> list:
    """The worker's incarnations from its log file: for each, its start
    step, restore source and timings, steps {step: (time, loss,
    grad_norm, step_s)}, saves {step: (time, blocking pieces)}, commits
    and peer-cache writes {step: end time}, the boundary collections
    {step: seconds}, launch counts and wall-clock marks."""
    import re

    runs = []
    with open(path) as f:
        for line in f:
            ts, _, text = line.rstrip("\n").partition(" ")
            if text.startswith("llama_train: start_step="):
                start = int(re.search(r"start_step=(\d+)", text).group(1))
                source = re.search(r"source=(\S+)", text).group(1)
                restore = json.loads(text.split("restore=", 1)[1])
                pid = re.search(r" pid=(\d+)", text)
                runs.append({"start": start, "source": source,
                             "pid": int(pid.group(1)) if pid else None,
                             "restore": restore, "steps": {}, "saves": {},
                             "commits": {}, "peer_writes": {}, "marks": {},
                             "collections": {}, "started_at": float(ts)})
                continue
            if not runs:
                continue
            run = runs[-1]
            m = re.match(r"step (\d+) loss (\S+) grad_norm (\S+) step_s "
                         r"(\S+)", text)
            save = re.search(r"async save started at step (\d+), blocking "
                             r"\S+ s: (\{.*\})$", text)
            done = (re.search(r"flash checkpoint: step (\d+) committed", text)
                    or re.search(r"peer cache: step (\d+) staged", text))
            collected = re.match(r"collection after step (\d+): (\S+) s",
                                 text)
            if m:
                run["steps"][int(m.group(1))] = (
                    float(ts), float(m.group(2)), float(m.group(3)),
                    float(m.group(4)))
            elif save:
                run["saves"][int(save.group(1))] = (float(ts), json.loads(
                    save.group(2)))
            elif done:
                kind = "commits" if "committed" in text else "peer_writes"
                run[kind][int(done.group(1))] = float(ts)
            elif collected:
                run["collections"][int(collected.group(1))] = float(
                    collected.group(2))
            elif text.startswith("worker_launch_counts "):
                # the last line holds the launches so far (one a step)
                run["launches"] = json.loads(text.split(" ", 1)[1])
            elif any(text.startswith(mark) for mark in _WORKER_MARKS):
                mark = next(m for m in _WORKER_MARKS if text.startswith(m))
                run["marks"].setdefault(_WORKER_MARKS[mark],
                                        (float(ts), text))
            elif text.startswith("worker_times "):
                run["times"] = json.loads(text.split(" ", 1)[1])
    for run in runs:
        run["runs_under_writers"] = _under_writers(run)
    return runs


def _under_writers(run: dict) -> dict:
    """Each step that ended while a save's commit or peer-cache write
    (started at an earlier step) was still running: {step: (step_ms,
    "commit", "peer")} with the writers it overlapped."""
    out = {}
    for n, (t, *_, step_s) in sorted(run["steps"].items()):
        writers = []
        for saved, (t_save, _) in run["saves"].items():
            if saved >= n:
                continue
            for kind in ("commits", "peer_writes"):
                end = run[kind].get(saved, float("inf"))
                if t_save < t <= end:
                    writers.append(f"{kind[:-1]} of {saved}")
        if writers:
            out[n] = (step_s * 1e3, writers)
    return out


def _killed_state(ckpt: str, agent_tmp: str) -> tuple:
    """The newest committed step under ``ckpt`` and the step of the last
    complete peer stage in the agent's work directory under
    ``agent_tmp`` (its manifest is written last), -1 when none."""
    import glob
    import os

    from dlrover_tpu_torch.checkpoint.peer_restore import load_manifest

    names = os.listdir(ckpt) if os.path.isdir(ckpt) else []
    committed = max((int(n) for n in names if n.isdigit()), default=-1)
    caches = glob.glob(os.path.join(agent_tmp, "dlrover-tpu-agent-*",
                                    "peer_cache"))
    manifest = load_manifest(caches[0]) if len(caches) == 1 else None
    return committed, (manifest or {}).get("step", -1)


def _kill_ready(ckpt: str, agent_tmp: str, first_save: int) -> bool:
    """Whether the worker may be killed: a step at or past ``first_save``
    is committed and a complete peer stage at least as new is there.
    DCP's commit and the peer-cache write of one save run side by side,
    so waiting for both keeps the relaunch's source from hanging on
    which finished first."""
    committed, staged = _killed_state(ckpt, agent_tmp)
    return committed >= first_save and staged >= committed


def _wait_dead(pid: int, timeout_s: float = 60.0) -> None:
    """Until ``pid`` has exited (gone, or a zombie not reaped yet)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return
        except OSError:
            return
        time.sleep(0.01)
    raise AssertionError(f"process {pid} still alive {timeout_s} s after "
                         f"SIGKILL")


def phase_standalone(smi: str, llama1b: dict, resume: dict) -> dict:
    """Llama-1B under the port's master and agent, with a SIGKILL after
    the first committed checkpoint (see the module docstring)."""
    import os
    import shutil
    import tempfile

    from dlrover_tpu_torch.common.constants import RendezvousName
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                               norm_impl="fused", embed_impl="gather")
    ref, ref_from = _reference_steps(cfg, resume)
    state_bytes = 3 * 4 * cfg.param_count()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_standalone_")
    ckpt, worker_log = f"{tmp}/ckpt", f"{tmp}/worker.log"
    agent_out, agent_err = f"{tmp}/agent.out", f"{tmp}/agent.err"
    master = JobMaster(host="127.0.0.1")
    master.prepare()
    proc, agent_tmp = None, ""
    out = {"card": smi}
    _free_memory()
    log(f"standalone: this process holds "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB of the card")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"standalone: checkpoints in {tmp}, {free / 1e9:.1f} GB free; "
            f"the run keeps at most two of {state_bytes / 1e9:.2f} GB")
        if free < 2.1 * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free in {tmp}: less "
                                 f"than two checkpoints")
        # the agent's work directory (its peer cache) lands in TMPDIR
        agent_tmp = peer_root(state_bytes, tmp, smi, "standalone")
        out["host_memory"] = host_memory()
        out["agent_tmp"] = agent_tmp
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.run",
               "--master-addr", master.addr,
               "dlrover_tpu_torch/examples/llama_train.py",
               "--config", "llama_1b", "--steps", str(STANDALONE_STEPS),
               "--save-interval", str(SAVE_EVERY), "--report-interval", "1",
               "--ckpt-dir", ckpt, "--log-file", worker_log]
        env = dict(os.environ, PYTHONPATH=repo, TMPDIR=agent_tmp)
        with open(agent_out, "w") as fo, open(agent_err, "w") as fe:
            proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=fo,
                                    stderr=fe)
        # SIGKILL the worker (the agent's child) once step 3 is committed
        # and staged
        deadline = time.time() + 400
        victim = None
        while time.time() < deadline and proc.poll() is None:
            if _kill_ready(ckpt, agent_tmp, SAVE_EVERY):
                kids = _children(proc.pid)
                if kids:
                    victim = kids[0]
                    break
            time.sleep(0.05)
        if victim is None:
            raise AssertionError(f"no committed and staged step 3 or no "
                                 f"worker (agent exit {proc.poll()}, "
                                 f"{_killed_state(ckpt, agent_tmp)})")
        os.kill(victim, signal.SIGKILL)
        t_kill = time.time()
        _wait_dead(victim)
        # what the dead worker left, read now that nothing can change it:
        # the relaunch must resume at the newer of the two
        committed, staged = _killed_state(ckpt, agent_tmp)
        resume_at = max(committed, staged)
        out["at_kill"] = {"committed": committed, "staged": staged,
                          "resume_at": resume_at}
        # the master's speed over the first incarnation's step reports: a
        # report already on the wire lands within the second, the new
        # incarnation's first one tens of seconds later. (Its resumed
        # reports at or below this mark are dropped, as in the JAX
        # master.)
        time.sleep(max(0.0, t_kill + 1.0 - time.time()))
        killed_at = (master.speed_monitor.completed_global_step,
                     master.speed_monitor.tokens_per_second(),
                     master.speed_monitor.running_mfu())
        code = proc.wait(timeout=600)
        with open(agent_err) as f:
            agent_tail = f.read()[-3000:]
        if code != 0:
            raise AssertionError(f"agent exited {code}: {agent_tail}")
        runs = _worker_log(worker_log)
        marks = _agent_times(agent_err)
        out["worker_pid_killed"] = victim
        if len(runs) != 2:
            raise AssertionError(f"{len(runs)} worker incarnations logged")
        first, second = runs
        got = {n: (r[1], r[2]) for run in runs
               for n, r in run["steps"].items()
               if run is second or n <= resume_at}
        same = {n: got.get(n) == ref[n - 1]
                for n in range(1, STANDALONE_STEPS + 1)}
        out.update({
            "reference": ref_from,
            "first_start": first["start"], "second_start": second["start"],
            "second_source": second["source"],
            "first_steps": sorted(first["steps"]),
            "losses": [got.get(n, (None,))[0]
                       for n in range(1, STANDALONE_STEPS + 1)],
            "same_bits": same, "spawn_rounds": marks["rounds"],
            "master_rounds_cut": master.rdzv_managers[
                RendezvousName.TRAINING].rdzv_round})
        log(f"standalone: {json.dumps(out)} ({smi})")
        if first["start"] != 0 or second["start"] != resume_at:
            raise AssertionError(f"incarnations started at {first['start']}"
                                 f" and {second['start']}, the kill left "
                                 f"{out['at_kill']}")
        if second["source"] != "peer":
            raise AssertionError(f"the relaunched worker restored from "
                                 f"{second['source']}, not the peer cache")
        resumed = list(range(resume_at + 1, STANDALONE_STEPS + 1))
        if sorted(second["steps"]) != resumed or not all(same.values()):
            raise AssertionError(f"steps against {ref_from}: {same}")
        if marks["rounds"] != [0, 1] or out["master_rounds_cut"] != 2:
            raise AssertionError(f"spawned in rounds {marks['rounds']}, "
                                 f"{out['master_rounds_cut']} rounds cut: "
                                 f"{agent_tail}")

        # the master's view: the last step at the end; at the kill, the
        # tokens/s of the first incarnation's reports (steps 1 to the
        # mark, on the master's clock) against the worker's own log over
        # the same steps (the step lines, logged just before each report)
        tokens = 8 * cfg.max_seq_len
        steps = second["steps"]
        mark, master_tps, master_mfu = killed_at
        logged = first["steps"]
        if mark < 2 or mark not in logged or 1 not in logged:
            raise AssertionError(f"master mark {mark} at the kill, first "
                                 f"incarnation logged {sorted(logged)}")
        worker_tps = ((mark - 1) * tokens
                      / (logged[mark][0] - logged[1][0]))
        master_step = master.speed_monitor.completed_global_step
        out["master"] = {"global_step": master_step,
                         "mark_at_kill": mark,
                         "tokens_per_s_at_kill": master_tps,
                         "worker_tokens_per_s": worker_tps,
                         "rel_diff": abs(master_tps - worker_tps)
                         / worker_tps, "mfu_at_kill": master_mfu,
                         "tokens_per_s_at_end": master.speed_monitor
                         .tokens_per_second()}
        log(f"standalone master: {json.dumps(out['master'])} ({smi})")
        if (master_step != STANDALONE_STEPS
                or not out["master"]["rel_diff"] < SPEED_TOL):
            raise AssertionError(f"master holds {out['master']}")

        want = _expected_launches(cfg, len(resumed))
        launches = second.get("launches")
        out["launches"] = launches
        if launches != want:
            raise AssertionError(f"worker launches {launches}, want {want}")

        # recovery: SIGKILL → the new incarnation's first finished step,
        # and on to its second (back at the step's speed)
        times, restore = second["times"], second["restore"]
        t_first = steps[resumed[0]][0]
        if len(resumed) < 2:
            raise AssertionError(f"resumed steps {resumed}: no second step")
        parts = {
            "detection_s": marks["detected"] - t_kill,
            "backoff_s": marks["backed_off"] - marks["detected"],
            "rendezvous_s": marks["spawned"] - marks["backed_off"],
            "process_start_and_import_s": times["imported"]
            - marks["spawned"],
            "loop_build_s": times["loop_built"] - times["imported"],
            "restore_s": times["restored"] - times["loop_built"],
            "of_which_abstract_state_s": restore.get("abstract_state_s"),
            "of_which_peer_plan_s": restore.get("peer_plan_s"),
            "of_which_transfer_s": restore.get("peer_transfer_s"),
            "of_which_assemble_s": restore.get("peer_assemble_s"),
            "of_which_kernel_libraries_load_s": restore.get("build_s"),
            "peer_bytes": restore.get("peer_bytes"),
            "peer_bandwidth_mbps": restore.get("peer_bandwidth_mbps"),
            "first_step_s": steps[resumed[0]][3],
            "other_s": t_first - times["restored"] - steps[resumed[0]][3],
            "total_s": t_first - t_kill,
            "second_step_s": steps[resumed[1]][3],
            "total_to_second_step_s": steps[resumed[1]][0] - t_kill}
        out["recovery"] = parts
        log(f"standalone recovery (SIGKILL to step {resumed[0]} done): "
            f"{json.dumps(parts)} ({smi})")
        out["saves"] = {f"incarnation {i} step {n}": pieces
                        for i, run in enumerate(runs)
                        for n, (_, pieces) in run["saves"].items()}
        # each incarnation's first save page-locks its host buffers
        out["pinning_s"] = {
            f"incarnation {i} step {min(run['saves'])}":
                run["saves"][min(run["saves"])][1].get("host_alloc_s")
            for i, run in enumerate(runs) if run["saves"]}
        log(f"standalone blocking saves by piece, s: "
            f"{json.dumps(out['saves'])}; of which the host buffers' "
            f"page-locking, once a process inside its first save, s: "
            f"{json.dumps(out['pinning_s'])} ({smi})")
        out["under_writers"] = {f"incarnation {i}": run["runs_under_writers"]
                                for i, run in enumerate(runs)}
        log(f"standalone steps that ran under a commit or a peer-cache "
            f"write (ms, writers): {json.dumps(out['under_writers'])} "
            f"({smi})")
        under_agent = [r[3] for run in runs for n, r in run["steps"].items()
                       if n != run["start"] + 1]
        out["step_under_agent"] = {
            "median_ms": statistics.median(under_agent) * 1e3,
            "steps_ms": [t * 1e3 for t in under_agent],
            "llama1b_median_ms": llama1b.get("step_median_ms",
                                             "not measured")}
        log(f"standalone step under the agent: "
            f"{json.dumps(out['step_under_agent'])} ({smi})")
        log(f"standalone host memory after the run: "
            f"{json.dumps(host_memory())} ({smi})")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        master.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        if agent_tmp:
            shutil.rmtree(agent_tmp, ignore_errors=True)
    return out


# the faults phase: launch 1 drains at step DRAIN_AT under a stated grace
# (the emergency save waits for the step-3 commit and then commits its
# own: two commits of 16.5-26.1 s, chip runs of the resume phase), with
# a `slow` fault holding step DRAIN_AT for DRAIN_HOLD_S so the agent's
# drain request (notice poll 1 s, its loop 0.2 s) lands before the next
# step boundary; launch 2 hangs at step HANG_AT, after the step-6 save,
# for HANG_SLEEP_S under a watchdog of HANG_WATCHDOG_S (it fires 12-15 s
# after step 6: past the peer stage of 6, 4-7.5 s; the sleep outlasts
# that with 5 s to spare), and its relaunch replays the hang inside the
# watchdog's first-step budget of 300 s
FAULT_GRACE_S = 90.0
DRAIN_AT = 4
DRAIN_HOLD_S = 3.0
HANG_AT = 7
HANG_WATCHDOG_S = 12.0
HANG_SLEEP_S = 20.0
DEFAULT_GRACE_S = 30.0     # Context.preempt_default_grace_s


def _reference_steps(cfg, resume: dict) -> tuple:
    """[(loss, grad_norm)] of 7 uninterrupted steps and where they came
    from: resume's run A when it ran, else an in-process run (kept for a
    later phase)."""
    if resume.get("a"):
        return (list(zip(resume["a"]["losses"], resume["a"]["grad_norms"])),
                "resume A")
    if "run" not in _REFERENCE:
        _REFERENCE["run"] = _reference_run(cfg)
    return _REFERENCE["run"], "an uninterrupted in-process run"


_REFERENCE: dict = {}


def _reference_prefix(cfg, steps: int) -> list:
    """The first ``steps`` of the longest uninterrupted in-process run so
    far (its steps do not depend on the run's length), running a longer
    one when none reaches ``steps``."""
    if len(_REFERENCE.get("long", ())) < steps:
        _REFERENCE["long"] = _reference_run(cfg, steps)
    return _REFERENCE["long"][:steps]


def _agent_lines(path: str) -> list:
    """(unix time, message) of each of the agent's log lines
    ("[2026-10-17 00:58:52,261] [WARNING] [...] message")."""
    import datetime
    import re

    lines = []
    with open(path) as f:
        for line in f:
            m = re.match(r"\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3})\] "
                         r"\[\w+\] \[[^\]]*\] (.*)$", line.rstrip("\n"))
            if m:
                lines.append((datetime.datetime.strptime(
                    m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp(),
                    m.group(2)))
    return lines


def _first(lines: list, pattern: str) -> float:
    import re

    for ts, text in lines:
        if re.search(pattern, text):
            return ts
    raise AssertionError(f"no agent line matches {pattern!r}")


def _spawn_agent(master, cmd_args: list, env_extra: dict, out: str,
                 err: str, agent_tmp: str, repo: str,
                 run_args: tuple = ()):
    """Start ``python -m dlrover_tpu_torch.run`` (with ``run_args``)
    against ``master`` with core dumps off (a SIGABRTed worker holding
    15 GB of page-locked memory must not write one); returns the Popen
    and its two open log files."""
    import os
    import resource

    cmd = ([sys.executable, "-m", "dlrover_tpu_torch.run",
            "--master-addr", master.addr] + list(run_args)
           + ["dlrover_tpu_torch/examples/llama_train.py"] + cmd_args)
    env = dict(os.environ, PYTHONPATH=repo, TMPDIR=agent_tmp, **env_extra)
    # the agent inherits this process's soft core limit (set here, not
    # in a preexec_fn: the master's gRPC threads make that unsafe)
    soft, hard = resource.getrlimit(resource.RLIMIT_CORE)
    fo, fe = open(out, "w"), open(err, "w")
    resource.setrlimit(resource.RLIMIT_CORE, (0, hard))
    try:
        proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=fo,
                                stderr=fe)
    finally:
        resource.setrlimit(resource.RLIMIT_CORE, (soft, hard))
    return proc, (fo, fe)


def _launch_agent(master, cmd_args: list, env_extra: dict, out: str,
                  err: str, agent_tmp: str, repo: str,
                  run_args: tuple = ()) -> int:
    """Run ``python -m dlrover_tpu_torch.run`` (with ``run_args``) against
    ``master`` to its end (``_spawn_agent``); returns its exit code."""
    proc, files = _spawn_agent(master, cmd_args, env_extra, out, err,
                               agent_tmp, repo, run_args)
    try:
        return proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for f in files:
            f.close()


def phase_faults(smi: str, llama1b: dict, resume: dict) -> dict:
    """Planned and silent failures under the port's master and agent:
    a preemption notice drained through an emergency checkpoint, then a
    hang the watchdog aborts and the agent relaunches uncharged; the
    master's goodput ledger accounts both (see the module docstring)."""
    import glob
    import os
    import shutil
    import tempfile

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.config import Context
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.obs import render_snapshot

    cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                               norm_impl="fused", embed_impl="gather")
    ref, ref_from = _reference_steps(cfg, resume)
    state_bytes = 3 * 4 * cfg.param_count()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    ckpt = f"{tmp}/ckpt"
    ctx = Context.singleton()
    # the master's ledger bounds a hang by the watchdog's window
    saved_hang_s = ctx.hang_watchdog_s
    ctx.update(hang_watchdog_s=HANG_WATCHDOG_S)
    master = JobMaster(host="127.0.0.1")
    master.prepare()
    client = None
    agent_tmp = ""
    out = {"card": smi}
    _free_memory()
    try:
        free = shutil.disk_usage(tmp).free
        log(f"faults: checkpoints in {tmp}, {free / 1e9:.1f} GB free; the "
            f"run keeps at most three of {state_bytes / 1e9:.2f} GB")
        if free < 3.1 * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free in {tmp}: less "
                                 f"than three checkpoints")
        agent_tmp = peer_root(state_bytes, tmp, smi, "faults")
        common = ["--config", "llama_1b", "--steps", str(STANDALONE_STEPS),
                  "--save-interval", str(SAVE_EVERY), "--report-interval",
                  "1", "--ckpt-dir", ckpt]

        # -- launch 1: a preemption notice at DRAIN_AT -------------------
        log1, err1 = f"{tmp}/worker1.log", f"{tmp}/agent1.err"
        code = _launch_agent(master, common + ["--log-file", log1], {
            "DLROVER_TPU_CHAOS": f"preempt:worker:0@{DRAIN_AT}:"
                                 f"{FAULT_GRACE_S};slow:worker:0@{DRAIN_AT}:"
                                 f"{DRAIN_HOLD_S}",
            "DLROVER_TPU_CHAOS_STATE": f"{tmp}/chaos1",
            "DLROVER_TPU_FLIGHT_DIR": f"{tmp}/flight1"},
            f"{tmp}/agent1.out", err1, agent_tmp, repo)
        lines1 = _agent_lines(err1)
        tail1 = "\n".join(t for _, t in lines1[-15:])
        if code != 0:
            raise AssertionError(f"launch 1: agent exited {code}: {tail1}")
        runs1 = _worker_log(log1)
        if len(runs1) != 1:
            raise AssertionError(f"launch 1: {len(runs1)} incarnations")
        a = runs1[0]
        marks = a["marks"]
        drained = [t for _, t in lines1 if t.startswith("drain complete")]
        charged = [t for _, t in lines1 if "worker failed" in t
                   or "restarting (" in t]
        if (not drained or "worker exit 76, drained" not in drained[0]
                or charged):
            raise AssertionError(f"launch 1: the worker did not leave "
                                 f"with 76 (drained) uncharged: {tail1}")
        drain_step = int(marks["drained"][1].split()[3])
        emergency = marks.get("emergency", (0, ""))[1]
        committed = sorted(int(n) for n in os.listdir(ckpt) if n.isdigit())
        if (drain_step != DRAIN_AT
                or "(checkpoint: saved)" not in marks["drained"][1]
                or not emergency.startswith(
                    f"emergency checkpoint committed at step {drain_step}")
                or drain_step not in committed):
            raise AssertionError(f"launch 1: drained at {drain_step}, "
                                 f"{emergency!r}, committed {committed}")
        t_notice = marks["notice"][0]
        t_request = _first(lines1, r"^drain request \d+ written")
        t_consumed = marks["drain_request_consumed"][0]
        t_drained = marks["drained"][0]
        t_exit = _first(lines1, r"^drain complete")
        save = a["saves"][drain_step][1]
        drain = {
            "drained_step": drain_step, "committed": committed,
            "notice_to_request_s": t_request - t_notice,
            "request_to_consumed_s": t_consumed - t_request,
            "consumed_to_drained_s": t_drained - t_consumed,
            "drained_to_exit_seen_s": t_exit - t_drained,
            "notice_to_exit_s": t_exit - t_notice,
            "of_which_hold_s": DRAIN_HOLD_S,
            "emergency_blocking_s": save.get("blocking_s"),
            "emergency_wait_for_previous_commit_s": save.get("wait_s"),
            "emergency_page_locking_s": save.get("host_alloc_s"),
            "emergency_commit_s": a["commits"].get(drain_step, 0.0)
            - a["saves"][drain_step][0],
            "grace_s": FAULT_GRACE_S,
            "default_grace_would_hold": t_exit - t_notice < DEFAULT_GRACE_S,
            "pinning_first_save_s": a["saves"][min(a["saves"])][1].get(
                "host_alloc_s")}
        out["drain"] = drain
        log(f"faults drain (notice at step {DRAIN_AT}, grace "
            f"{FAULT_GRACE_S:.0f} s): {json.dumps(drain)} ({smi})")
        if not drain["notice_to_exit_s"] < FAULT_GRACE_S:
            raise AssertionError(f"notice to exit "
                                 f"{drain['notice_to_exit_s']:.1f} s, over "
                                 f"the grace")

        # -- launch 2: a hang at HANG_AT, after the step-6 save ----------
        log2, err2 = f"{tmp}/worker2.log", f"{tmp}/agent2.err"
        flight2 = f"{tmp}/flight2"
        code = _launch_agent(master, common + ["--log-file", log2], {
            "DLROVER_TPU_CHAOS": f"hang:worker:0@{HANG_AT}:{HANG_SLEEP_S}",
            "DLROVER_TPU_CHAOS_STATE": f"{tmp}/chaos2",
            "DLROVER_TPU_HANG_WATCHDOG_S": str(HANG_WATCHDOG_S),
            "DLROVER_TPU_FLIGHT_DIR": flight2},
            f"{tmp}/agent2.out", err2, agent_tmp, repo)
        lines2 = _agent_lines(err2)
        tail2 = "\n".join(t for _, t in lines2[-15:])
        if code != 0:
            raise AssertionError(f"launch 2: agent exited {code}: {tail2}")
        runs2 = _worker_log(log2)
        failed = [t for _, t in lines2 if "worker failed" in t]
        restarts = [t for _, t in lines2 if "restarting (" in t]
        if (len(runs2) != 2 or len(failed) != 2
                or not all("(exit -6, hang)" in t for t in failed)
                or restarts != [restarts[0]]
                or "restarting (0/" not in restarts[0]):
            raise AssertionError(f"launch 2: {len(runs2)} incarnations, "
                                 f"want one uncharged hang abort: {tail2}")
        b, c = runs2
        # the watchdog's flight dump of the aborted worker: the main
        # thread's stack in the chaos sleep
        stacks = []
        for path in glob.glob(f"{flight2}/flight-*.json"):
            with open(path) as f:
                payload = json.load(f)
            stacks += [e["attrs"]["stacks"] for e in payload["events"]
                       if e.get("name") == "step_hang"]
        in_sleep = [st for st in stacks if any(
            "maybe_inject" in frame and "time.sleep" in frame
            for frame in st.get("MainThread", ()))]
        if len(stacks) != 1 or not in_sleep:
            raise AssertionError(f"{len(stacks)} step_hang dumps, the main "
                                 f"thread in the chaos sleep in "
                                 f"{len(in_sleep)}")
        if b["start"] != drain_step or c["start"] < SAVE_EVERY * 2:
            raise AssertionError(f"launch 2 started at {b['start']} (the "
                                 f"drain left {drain_step}), its relaunch "
                                 f"at {c['start']}")
        if (sorted(c["steps"]) != list(range(c["start"] + 1,
                                             STANDALONE_STEPS + 1))
                or sorted(b["steps"]) != list(range(drain_step + 1,
                                                    HANG_AT + 1))):
            raise AssertionError(f"steps: launch 2 {sorted(b['steps'])}, "
                                 f"relaunch {sorted(c['steps'])}")
        got = [(n, r) for run in (a, b, c) for n, r in run["steps"].items()]
        same = {f"{name} {n}": (r[1], r[2]) == ref[n - 1]
                for name, run in (("drained", a), ("hung", b),
                                  ("relaunched", c))
                for n, r in run["steps"].items()}
        out["same_bits"] = same
        out["reference"] = ref_from
        out["starts"] = [a["start"], b["start"], c["start"]]
        out["sources"] = [a["source"], b["source"], c["source"]]
        log(f"faults runs: starts {out['starts']}, sources "
            f"{out['sources']}, steps against {ref_from}: {json.dumps(same)}")
        if not all(same.values()) or len(got) != len(same):
            raise AssertionError(f"steps against {ref_from}: {same}")
        t_last = b["steps"][HANG_AT][0]
        t_fired = b["marks"]["watchdog_fired"][0]
        t_failed = _first(lines2, r"worker failed \(exit -6, hang\); "
                                  r"backing")
        spawn_ts = [ts for ts, t in lines2 if t.startswith("spawning")]
        t_relaunched = spawn_ts[-1]
        first = min(c["steps"])
        hang = {
            "watchdog_s": HANG_WATCHDOG_S, "hang_sleep_s": HANG_SLEEP_S,
            "last_step_to_abort_s": t_fired - t_last,
            "since_step_6_to_abort_s": t_fired - b["steps"][HANG_AT - 1][0],
            "abort_to_agent_s": t_failed - t_fired,
            "agent_to_relaunch_s": t_relaunched - t_failed,
            "relaunch_to_restored_s": c["times"]["restored"]
            - t_relaunched,
            "of_which_start_and_import_s": c["times"]["imported"]
            - t_relaunched,
            "restore_source": c["source"],
            # the relaunch replays the hang after its first step's line,
            # inside the watchdog's first-step budget
            "replayed_hang_to_done_s": c["marks"]["done"][0]
            - c["marks"]["hang_start"][0],
            "last_step_to_first_resumed_step_s": c["steps"][first][0]
            - t_last}
        out["hang"] = hang
        log(f"faults hang (watchdog {HANG_WATCHDOG_S:.0f} s): "
            f"{json.dumps(hang)} ({smi})")

        # launches: each process's own, the steps it finished
        out["launches"] = {}
        for name, run, steps in (("drained", a, len(a["steps"])),
                                 ("hung", b, HANG_AT - 1 - b["start"]),
                                 ("relaunched", c, len(c["steps"]))):
            want = _expected_launches(cfg, steps)
            if run.get("launches") != want:
                raise AssertionError(f"{name} worker launches "
                                     f"{run.get('launches')}, want {want}")
            out["launches"][name] = run["launches"]
        under_agent = [r[3] for run in (a, b, c)
                       for n, r in run["steps"].items()
                       if n != run["start"] + 1 and n != HANG_AT]
        out["step_under_agent"] = {
            "median_ms": statistics.median(under_agent) * 1e3,
            "steps_ms": [t * 1e3 for t in under_agent],
            "llama1b_median_ms": llama1b.get("step_median_ms",
                                             "not measured")}
        log(f"faults step under the agent: "
            f"{json.dumps(out['step_under_agent'])} ({smi})")

        # -- the master's goodput ledger ---------------------------------
        client = MasterClient(master.addr, node_id=99, node_rank=-1)
        snap = client.get_goodput()
        buckets = snap.get("buckets", {})
        elapsed = snap.get("elapsed_rank_seconds", 0.0)
        covered = sum(buckets.values())
        out["goodput"] = {"buckets": buckets, "elapsed_rank_seconds":
                          elapsed, "goodput_fraction":
                          snap.get("goodput_fraction"),
                          "incarnations": snap.get("incarnations")}
        log(f"faults goodput: {json.dumps(out['goodput'])} ({smi})")
        log(render_snapshot(snap))
        # the ledger books the drain twice (ROADMAP Queue C, both
        # packages): drain + checkpoint_stall against the window they
        # share, ready for the fix's check
        out["drain_accounting"] = {
            "drain_plus_checkpoint_stall_s": buckets.get("drain", 0.0)
            + buckets.get("checkpoint_stall", 0.0),
            "notice_to_exit_s": drain["notice_to_exit_s"]}
        log(f"faults drain accounting (the ledger's drain + "
            f"checkpoint_stall against the measured window): "
            f"{json.dumps(out['drain_accounting'])} ({smi})")
        if not (elapsed > 0 and abs(covered - elapsed) <= 0.05 * elapsed):
            raise AssertionError(f"goodput buckets cover {covered:.3f} of "
                                 f"{elapsed:.3f} rank-seconds")
        if not (buckets.get("drain", 0) > 0
                and 0 < buckets.get("hang", 0) <= HANG_WATCHDOG_S + 1e-3):
            raise AssertionError(f"goodput drain {buckets.get('drain')}, "
                                 f"hang {buckets.get('hang')} (watchdog "
                                 f"{HANG_WATCHDOG_S})")
        log(f"faults host memory after the run: "
            f"{json.dumps(host_memory())} ({smi})")
    finally:
        if client is not None:
            client.close()
        master.stop()
        ctx.update(hang_watchdog_s=saved_hang_s)
        shutil.rmtree(tmp, ignore_errors=True)
        if agent_tmp:
            shutil.rmtree(agent_tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# observe: what the master sees of the card
# ---------------------------------------------------------------------------

# the master's diagnosis rounds and tsdb samples, seconds (the JAX
# defaults are 30 and 5); every other knob keeps its default
OBSERVE_INTERVAL_S = 2.0
# steps of the worker, and the chaos `slow` fault: from step
# OBSERVE_SLOW_AT on, each step sleeps OBSERVE_SLOW_S after its loss
OBSERVE_STEPS = 46
OBSERVE_SLOW_AT = 37
OBSERVE_SLOW_S = 1.5
# the clean steps' median against the llama1b phase's, and a trace
# group's phases against the period to the next step's start
OBSERVE_STEP_TOL = 0.01
OBSERVE_PHASE_TOL = 0.05
# the kernels the Llama-1B step launches, by their CUDA names
TRAINING_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                    "flash_bwd_dkv_kernel", "rms_fwd_kernel",
                    "rms_bwd_kernel")


def _trace_kernels(path: str) -> dict:
    """{name: count} of the kernel events in a torch.profiler Chrome
    trace."""
    with open(path) as f:
        trace = json.load(f)
    counts: dict = {}
    for event in trace.get("traceEvents", []):
        if event.get("cat") == "kernel":
            name = event.get("name", "")
            counts[name] = counts.get(name, 0) + 1
    return counts


def _series_coverage(client, name: str, t0: float, t1: float,
                     pause: tuple) -> dict:
    """A series' raw points (every label set) over training [t0, t1]:
    their count, and the largest gap between neighbours (the ends of the
    span included) outside ``pause``, the capture's stop and export,
    when the worker trains and reports nothing."""
    payload = client.query_timeseries(name=name)
    stamps = sorted(p[0] for series in payload.get("series", ())
                    for p in series["points"] if t0 <= p[0] <= t1)
    edges = [t0] + stamps + [t1]
    gaps = [b - a for a, b in zip(edges, edges[1:])
            if not (a < pause[1] and b > pause[0])]
    return {"points": len(stamps), "max_gap_s": max(gaps, default=0.0)}


def phase_observe(smi: str, llama1b: dict) -> dict:
    """The master observes the card: Llama-1B under the port's master and
    agent with its monitors; the step reports' HBM watermark, the
    relayed card stats, the time series, the step traces, the diagnosis
    engine's profile:0 capture and its throughput_collapse under a slow
    fault (see the module docstring)."""
    import glob
    import os
    import shutil
    import tempfile

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common import messages as msg
    from dlrover_tpu_torch.common.config import Context
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                               norm_impl="fused", embed_impl="gather")
    t_phase = t_ref = time.monotonic()
    ref = _reference_prefix(cfg, OBSERVE_STEPS)
    log(f"observe: the reference run of {OBSERVE_STEPS} steps took "
        f"{time.monotonic() - t_ref:.1f} s")
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_observe_")
    ctx = Context.singleton()
    saved = {k: getattr(ctx, k) for k in ("diagnosis_interval_s",
                                          "tsdb_sample_interval_s")}
    ctx.update(diagnosis_interval_s=OBSERVE_INTERVAL_S,
               tsdb_sample_interval_s=OBSERVE_INTERVAL_S)
    master = JobMaster(host="127.0.0.1")
    # what reaches the master: every step report and resource report,
    # with the master's receive time
    seen = {"steps": [], "resources": []}
    report = master.servicer.report

    def recording_report(request):
        if isinstance(request, msg.GlobalStepReport):
            seen["steps"].append((time.time(), request))
        elif isinstance(request, msg.NodeResourceStats):
            seen["resources"].append((time.time(), request))
        return report(request)

    master.servicer.report = recording_report
    master.prepare()
    client = None
    out = {"card": smi}
    _free_memory()
    try:
        log_path, err = f"{tmp}/worker.log", f"{tmp}/agent.err"
        t_launch = time.time()
        code = _launch_agent(
            master, ["--config", "llama_1b", "--steps", str(OBSERVE_STEPS),
                     "--report-interval", "1", "--log-file", log_path],
            {"DLROVER_TPU_CHAOS": f"slow:worker:0@{OBSERVE_SLOW_AT}:"
                                  f"{OBSERVE_SLOW_S}",
             "DLROVER_TPU_CHAOS_STATE": f"{tmp}/chaos",
             "DLROVER_TPU_FLIGHT_DIR": f"{tmp}/flight"},
            f"{tmp}/agent.out", err, tmp, repo,
            run_args=("--monitor-interval", "1"))
        lines = _agent_lines(err)
        tail = "\n".join(t for _, t in lines[-15:])
        out["agent_run_s"] = time.time() - t_launch
        if code != 0:
            raise AssertionError(f"observe: agent exited {code}: {tail}")
        runs = _worker_log(log_path)
        if len(runs) != 1 or sorted(runs[0]["steps"]) != list(
                range(1, OBSERVE_STEPS + 1)):
            raise AssertionError(f"observe: {len(runs)} incarnations, "
                                 f"steps {[sorted(r['steps']) for r in runs]}")
        run = runs[0]
        steps = run["steps"]
        same = {n: (r[1], r[2]) == ref[n - 1] for n, r in steps.items()}
        out["same_bits"] = all(same.values())
        log(f"observe losses against an uninterrupted in-process run: "
            f"{json.dumps(same)}")
        if not all(same.values()):
            raise AssertionError(f"observe: steps against the reference "
                                 f"run: {same}")
        want = _expected_launches(cfg, OBSERVE_STEPS)
        if run.get("launches") != want:
            raise AssertionError(f"observe: launches {run.get('launches')},"
                                 f" want {want}")
        out["launches"] = run["launches"]
        client = MasterClient(master.addr, node_id=99, node_rank=-1)

        # -- the HBM watermark: the master's step reports against the
        #    worker's own allocator peak at the same step ------------------
        peaks, reserved = {}, {}
        with open(log_path) as f:
            for line in f:
                _, _, text = line.rstrip("\n").partition(" ")
                if text.startswith("worker_allocator_peak "):
                    rec = json.loads(text.split(" ", 1)[1])
                    peaks[rec["steps"]] = rec["bytes"]
                    reserved[rec["steps"]] = rec["reserved_bytes"]
        reported = {r.step: r.hbm_peak_bytes for _, r in seen["steps"]}
        pairs = {n: (reported[n], peaks[n]) for n in peaks if n in reported}
        hbm = {"steps_compared": len(pairs),
               "equal": all(a == b for a, b in pairs.values()),
               "allocated_peak_bytes": max(peaks.values(), default=0),
               "reserved_peak_bytes": max(reserved.values(), default=0),
               "card_total_bytes": torch.cuda.mem_get_info()[1]}
        out["hbm"] = hbm
        log(f"observe hbm: {json.dumps(hbm)} ({smi})")
        if len(pairs) < OBSERVE_STEPS - 1 or not hbm["equal"]:
            raise AssertionError(f"observe: the step reports' hbm_peak_bytes"
                                 f" against the worker's allocator peak: "
                                 f"{pairs}")
        total_mb = hbm["card_total_bytes"] / 2 ** 20
        relayed = [c for _, r in seen["resources"] for c in r.chip_stats]
        with_card = [c for c in relayed if c.hbm_used_mb > 0
                     and abs(c.hbm_total_mb - total_mb) < 1.0]
        out["resource_reports"] = {
            "reports": len(seen["resources"]),
            "with_card_stats": len(with_card),
            "hbm_used_mb": [c.hbm_used_mb for c in with_card],
            "hbm_total_mb": total_mb,
            "duty_cycle_pct": [c.duty_cycle_pct for c in with_card]}
        log(f"observe relayed card stats: "
            f"{json.dumps(out['resource_reports'])} ({smi})")
        if not with_card:
            raise AssertionError(f"observe: no NodeResourceStats carried the"
                                 f" card's use and total: {relayed}")

        # -- diagnosis: the profile:0 capture and the collapse ------------
        reports = client.get_diagnosis_reports()
        out["diagnosis"] = [{k: r[k] for k in ("rule", "severity", "ts",
                                               "summary", "actions")}
                            for r in reports]
        log(f"observe diagnosis reports: {json.dumps(out['diagnosis'])}")
        profile = [r for r in reports if r["rule"] == "critical_path"
                   and "profile:0" in r["actions"]]
        pressure = [r for r in reports if r["rule"] == "hbm_pressure"]
        t_slow = steps[OBSERVE_SLOW_AT - 1][0]
        collapse = [r for r in reports if r["rule"] == "throughput_collapse"
                    and r["severity"] == "critical" and r["ts"] >= t_slow]
        if not profile or pressure or not collapse:
            raise AssertionError(f"observe: critical_path profile:0 "
                                 f"{len(profile)}, hbm_pressure "
                                 f"{len(pressure)}, throughput_collapse "
                                 f"under the slow fault {len(collapse)}")
        captures = glob.glob(f"{tmp}/dlrover-tpu-profiles-*/"
                             f"capture-*/manifest.json")
        if len(captures) != 1:
            raise AssertionError(f"observe: {len(captures)} captures")
        with open(captures[0]) as f:
            manifest = json.load(f)
        trace_path = os.path.join(os.path.dirname(captures[0]),
                                  "trace.json")
        kernels = (_trace_kernels(trace_path)
                   if os.path.exists(trace_path) else {})
        named = {k: sum(c for n, c in kernels.items() if k in n)
                 for k in TRAINING_KERNELS}
        first = manifest["start_step"] + 1
        captured = list(range(first, first + manifest["num_steps"]))
        # evidence to action: the start of the fault's first step to the
        # collapse report, and the profile:0 report to the written trace
        out["collapse_after_fault_s"] = collapse[0]["ts"] - t_slow
        out["profile"] = {
            "status": manifest["status"], "steps": captured,
            "num_steps": manifest["num_steps"],
            "trace_bytes": manifest.get("trace_bytes"),
            "start_s": manifest.get("start_s"),
            "stop_and_export_s": manifest.get("stop_s"),
            "kernel_events": named,
            "reported_after_launch_s": profile[0]["ts"] - t_launch,
            "report_to_written_trace_s": manifest["finished_at"]
            - profile[0]["ts"],
            "collapse_after_fault_s": out["collapse_after_fault_s"]}
        log(f"observe profile capture: {json.dumps(out['profile'])} "
            f"({smi})")
        if (manifest["status"] != "ok"
                or manifest["num_steps"] != ctx.diagnosis_profile_steps
                or not all(named.values())):
            raise AssertionError(f"observe: capture {manifest}, kernels "
                                 f"{named}")
        if captured[-1] >= OBSERVE_SLOW_AT - 1:
            raise AssertionError(f"observe: the capture ({captured}) ran "
                                 f"into the slow fault at "
                                 f"{OBSERVE_SLOW_AT}")

        # -- step traces --------------------------------------------------
        traces = client.query_steptrace()
        groups = {g["step"]: g for g in traces.get("steps", ())}
        counted = [g["step"] for g in traces.get("steps", ())]
        # a step's wall time is the period from its start to the next
        # step's start on the trace's own clock, and all its phases,
        # data_wait included, must account for it. The capture's start
        # and its trace's export run at two step boundaries outside any
        # phase: those two periods are reported apart. The loop's
        # young-generation collection (after the first step and every
        # GC_EVERY_STEPS) is another such piece of a boundary: the time
        # the worker logs for it leaves the period. The last step has no
        # next start.
        boundaries = {"capture_start": captured[0] - 1,
                      "capture_stop": captured[-1]}
        collections = run["collections"]
        misses, waits, gaps = {}, {}, {}
        for n in steps:
            group = groups.get(n)
            if group is None:
                misses[n] = "missing"
                continue
            phases = [seg for lane in group["lanes"]
                      for seg in lane["phases"]]
            waits[n] = sum(d for name, _, d in phases
                           if name == "data_wait")
            if group["gating_rank"] != 0:
                misses[n] = ("gating rank", group["gating_rank"])
            if n + 1 not in groups:
                continue
            total = sum(d for _, _, d in phases)
            wall = (groups[n + 1]["t0"] - group["t0"]
                    - collections.get(n, 0.0))
            gaps[n] = wall - total
            if (n not in boundaries.values()
                    and abs(total - wall) > OBSERVE_PHASE_TOL * wall):
                misses[n] = (total, wall)
        outside = [g for n, g in gaps.items()
                   if n not in boundaries.values()]
        out["steptrace"] = {
            "groups": len(counted),
            "summary": traces.get("summary"),
            "data_wait_s": {"first": waits.get(1),
                            "max_after_first": max(
                                (w for n, w in waits.items() if n > 1),
                                default=0.0)},
            "collections_ms": {n: c * 1e3 for n, c in collections.items()},
            "untraced_between_steps_ms": {
                "median": statistics.median(outside) * 1e3,
                "max": max(outside) * 1e3,
                **{k: gaps[n] * 1e3 for k, n in boundaries.items()
                   if n in gaps}},
            "mismatches": misses}
        log(f"observe step traces: {json.dumps(out['steptrace'])}")
        if misses or sorted(counted) != sorted(steps):
            raise AssertionError(f"observe: step traces {sorted(counted)}: "
                                 f"{misses}")

        # -- time series: a point per sample interval while training ------
        t_first = min(t for t, _ in seen["steps"])
        t_last = max(t for t, _ in seen["steps"])
        pause = (steps[captured[-1]][0], steps[captured[-1] + 1][0])
        series = {name: _series_coverage(client, name, t_first, t_last,
                                         pause)
                  for name in ("dlrover_tpu_worker_step_time_seconds",
                               "dlrover_tpu_training_tokens_per_second",
                               "dlrover_tpu_training_mfu",
                               "dlrover_tpu_worker_mfu",
                               "dlrover_tpu_worker_hbm_peak_mb")}
        out["timeseries"] = {"training_span_s": t_last - t_first,
                             "export_pause_s": pause[1] - pause[0],
                             "series": series}
        log(f"observe time series: {json.dumps(out['timeseries'])}")
        sparse = {n: c for n, c in series.items()
                  if c["max_gap_s"] > 1.5 * OBSERVE_INTERVAL_S}
        if sparse:
            raise AssertionError(f"observe: series without a point every "
                                 f"{OBSERVE_INTERVAL_S} s of training: "
                                 f"{sparse}")

        # -- step time outside the capture and the fault -----------------
        after = captured[-1] + 1
        clean = {n: r[3] * 1e3 for n, r in steps.items()
                 if 2 < n < OBSERVE_SLOW_AT and n not in captured
                 and n != after}
        median = statistics.median(clean.values())
        base = llama1b.get("step_median_ms")
        times = {
            "clean_median_ms": median, "clean_steps_ms": clean,
            "captured_steps_ms": [steps[n][3] * 1e3 for n in captured],
            "captured_over_clean": statistics.median(
                steps[n][3] for n in captured) * 1e3 / median,
            "first_after_capture_ms": steps[after][3] * 1e3,
            "slow_steps_ms": [steps[n][3] * 1e3
                              for n in range(OBSERVE_SLOW_AT,
                                             OBSERVE_STEPS + 1)],
            "llama1b_median_ms": base if base else "not measured"}
        out["step_time"] = times
        log(f"observe step time: {json.dumps(times)} ({smi})")
        if base:
            band = (base * (1 - OBSERVE_STEP_TOL),
                    base * (1 + OBSERVE_STEP_TOL))
            spread = max(band[1], max(clean.values()))
            # the first step after the capture must not be slower than
            # the clean steps and the band (CUPTI released); faster is
            # no fault
            if not (band[0] <= median <= band[1]
                    and times["first_after_capture_ms"] <= spread):
                raise AssertionError(
                    f"observe: clean median {median:.2f} ms against the "
                    f"llama1b median {base:.2f} ms, the first step after "
                    f"the capture {times['first_after_capture_ms']:.2f} ms "
                    f"(the clean steps' and the band's top {spread:.2f})")
        log(f"observe: the phase took {time.monotonic() - t_phase:.1f} s "
            f"(the reference run, the worker under the agent "
            f"{out['agent_run_s']:.1f} s, the checks)")
    finally:
        if client is not None:
            client.close()
        master.stop()
        ctx.update(**saved)
        shutil.rmtree(tmp, ignore_errors=True)
    return out

# -- failover: the master survives its own death ----------------------------
FAILOVER_KILL_AT = 10
FAILOVER_SAVE_EVERY = 8
# steps that must follow the agent's reconnect
FAILOVER_AFTER_RECONNECT = 10
# the agent's poll cadence, cut from its 5 s default, and the deadline of
# every master RPC of the agent and the worker, cut from 30 s: an RPC to
# a dead master waits out its whole deadline (the channel waits for a
# connection), so at the defaults the agent needs 2 polls x 3 attempts x
# 30 s to declare the master lost, and every step report of the worker
# blocks 30 s
FAILOVER_MONITOR_S = 1.0
FAILOVER_RPC_TIMEOUT_S = 0.5
# the components a snapshot holds that the promoted master must restore
# exactly
FAILOVER_COMPONENTS = ("rendezvous", "task_manager", "kv_store",
                       "speed_monitor", "goodput", "diagnosis")


def failover_budget(monitor_s: float, rpc_timeout_s: float,
                    kill_at: int = FAILOVER_KILL_AT,
                    checkpoint: bool = True) -> dict:
    """Upper bounds, from the code, on the seconds from the primary's
    death to the agent's master-lost mode (``detect_s``: two failed
    ``num_nodes_waiting`` polls, each 3 attempts of a whole RPC deadline
    and the retry backoff, after a monitor wait), to the standby's
    promotion (``promote_s``: ``standby_promote_failures`` probes of
    ``max(1, interval)`` s, an interval apart) and to the reconnect
    (``reconnect_s``: the later of the two, one failed dial of the old
    address and its backoff, one good dial); the least period of a
    worker step while its master is dead (``degraded_step_s``: its step
    report, its step-trace flush and, with a ``checkpoint``, its query of
    the master's data-shard position each wait out the deadline), and
    the worker's steps: the kill's step, the outage's steps at that
    period, and FAILOVER_AFTER_RECONNECT more."""
    from dlrover_tpu_torch.common.config import Context

    ctx = Context.singleton()
    backoff = ctx.rpc_backoff_s
    poll = 3 * rpc_timeout_s + backoff * (1 + 2)
    detect = 2 * (monitor_s + poll)
    probe = max(1.0, ctx.standby_health_interval_s)
    promote = ctx.standby_promote_failures * (
        probe + ctx.standby_health_interval_s)
    reconnect = max(detect, promote) + 2 * rpc_timeout_s + 2 * backoff
    degraded = (3 if checkpoint else 2) * rpc_timeout_s
    outage_steps = math.ceil(reconnect / degraded)
    return {"detect_s": detect, "promote_s": promote,
            "reconnect_s": reconnect, "degraded_step_s": degraded,
            "outage_steps": outage_steps,
            "steps": kill_at + outage_steps + FAILOVER_AFTER_RECONNECT}


def _matches(lines: list, pattern: str) -> list:
    import re

    return [(ts, m) for ts, text in lines
            for m in [re.search(pattern, text)] if m]


def _worker_children(pid: int) -> set:
    """The worker processes (llama_train.py) among ``pid``'s children."""
    found = set()
    for kid in _children(pid):
        try:
            with open(f"/proc/{kid}/cmdline", "rb") as f:
                if b"llama_train.py" in f.read():
                    found.add(kid)
        except OSError:
            continue
    return found


def _wait_for_file(path: str, proc, timeout_s: float, what: str) -> None:
    import os

    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if os.path.exists(path):
            return
        if proc.poll() is not None:
            raise AssertionError(f"{what} exited {proc.returncode}")
        time.sleep(0.05)
    raise AssertionError(f"{what}: no {path} after {timeout_s} s")


def failover_drill(tmp: str, repo: str, worker_args: list, steps: int,
                   kill_at: int, monitor_s: float, env_extra: dict,
                   timeout_s: float = 600.0, worker_chaos: str = "") -> dict:
    """A primary master (``python -m dlrover_tpu_torch.master.job_master
    --state-dir S --bootstrap-file B`` with ``kill:master:0@kill_at``),
    a hot standby (the same with ``--standby``) and ``python -m
    dlrover_tpu_torch.run`` finding the master through B, around
    ``llama_train.py`` with ``worker_args``: the primary SIGKILLs itself
    at the worker's step-``kill_at`` report, the standby promotes, the
    agent reconnects and the worker trains on (``worker_chaos``, a chaos
    spec for the worker alone). Gates 1-3 and 5 of the
    failover phase (see the module docstring) raise here; returns the
    worker's run, the marks and the promoted master's answers."""
    import os

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.state_backend import MasterStateBackend

    state, boot = f"{tmp}/state", f"{tmp}/master.addr"
    paths = {n: f"{tmp}/{n}" for n in (
        "primary.out", "primary.err", "standby.out", "standby.err",
        "agent.out", "agent.err", "worker.log")}
    base = dict(os.environ, PYTHONPATH=repo, **env_extra)
    base.pop("DLROVER_TPU_CHAOS", None)
    master_cmd = [sys.executable, "-m", "dlrover_tpu_torch.master.job_master",
                  "--state-dir", state, "--bootstrap-file", boot]
    procs = {}

    def start(name, cmd, env):
        with open(paths[f"{name}.out"], "w") as fo, \
                open(paths[f"{name}.err"], "w") as fe:
            procs[name] = subprocess.Popen(cmd, cwd=repo, env=env,
                                           stdout=fo, stderr=fe)

    out = {"steps": steps, "kill_at": kill_at}
    try:
        start("primary", master_cmd,
              dict(base, DLROVER_TPU_CHAOS=f"kill:master:0@{kill_at}",
                   DLROVER_TPU_CHAOS_STATE=f"{tmp}/chaos"))
        _wait_for_file(boot, procs["primary"], 60, "the primary")
        start("standby", master_cmd + ["--standby"], base)
        deadline = time.time() + 60
        while not _matches(_agent_lines(paths["standby.err"]),
                           r"hot standby watching"):
            if time.time() > deadline or procs["standby"].poll() is not None:
                raise AssertionError("the standby did not start watching")
            time.sleep(0.05)
        t_launch = time.time()
        start("agent", [sys.executable, "-m", "dlrover_tpu_torch.run",
                        "--devices-per-node", "1",
                        "--monitor-interval", str(monitor_s),
                        "dlrover_tpu_torch/examples/llama_train.py"]
              + list(worker_args)
              + ["--steps", str(steps), "--report-interval", "1",
                 "--log-file", paths["worker.log"]],
              dict(base, DLROVER_TPU_MASTER_BOOTSTRAP_FILE=boot,
                   **({"DLROVER_TPU_CHAOS": worker_chaos,
                       "DLROVER_TPU_CHAOS_STATE": f"{tmp}/chaos"}
                      if worker_chaos else {})))
        workers = set()
        deadline = time.time() + timeout_s
        while procs["agent"].poll() is None and time.time() < deadline:
            workers |= _worker_children(procs["agent"].pid)
            time.sleep(0.05)
        if procs["agent"].poll() is None:
            raise AssertionError(f"failover: the agent ran past "
                                 f"{timeout_s} s")
        out["agent_run_s"] = time.time() - t_launch
        out["agent_exit"] = procs["agent"].returncode
        out["primary_exit"] = procs["primary"].poll()
        out["worker_pids_seen"] = sorted(workers)
        with open(boot) as f:
            out["bootstrap"] = json.load(f)
        # the promoted master, asked before it is stopped
        client = MasterClient(out["bootstrap"]["addr"], node_id=99,
                              node_rank=-1)
        try:
            out["goodput"] = client.get_goodput()
            out["history"] = client.query_timeseries(
                name="dlrover_tpu_worker_step_time_seconds",
                labels={"node": "0"}, resolution_s=10.0)
        finally:
            client.close()
    finally:
        for name in ("agent", "standby", "primary"):
            proc = procs.get(name)
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    lines = {n: _agent_lines(paths[f"{n}.err"])
             for n in ("primary", "standby", "agent")}
    tail = {n: "\n".join(t for _, t in lines[n][-12:]) for n in lines}

    # gate 1: the primary died by its own SIGKILL at the kill step's
    # report
    fired = _matches(lines["primary"],
                     r"chaos: SIGKILL self \(master-0\) at step (\d+)")
    if (out["primary_exit"] != -signal.SIGKILL or len(fired) != 1
            or int(fired[0][1].group(1)) != kill_at):
        raise AssertionError(f"failover: primary exit {out['primary_exit']}"
                             f", chaos {[m.group(0) for _, m in fired]}: "
                             f"{tail['primary']}")
    t_kill = fired[0][0]
    out["kill_ts"] = t_kill

    # gate 2: one promotion, at the loaded snapshot's generation + 1,
    # and the bootstrap file names it
    restored = _matches(lines["standby"],
                        r"restored from snapshot v(\d+) \(generation (\d+),"
                        r" (\d+) hot mutations replayed\)")
    promoted = _matches(lines["standby"],
                        r"PROMOTED in ([\d.]+)s: serving at (\S+) \(coord "
                        r"(\S+)\) as generation (\d+)")
    failed_probes = _matches(lines["standby"],
                             r"primary health probe failed \((\d+)/(\d+)")
    if len(promoted) != 1 or len(restored) != 1:
        raise AssertionError(f"failover: {len(promoted)} promotions, "
                             f"{len(restored)} restores: {tail['standby']}")
    version = int(restored[0][1].group(1))
    replayed = int(restored[0][1].group(3))
    generation = int(promoted[0][1].group(4))
    backend = MasterStateBackend(state)
    loaded = backend.load_version(version)
    written = backend.load_version(version + 1)
    boot_want = {"addr": promoted[0][1].group(2),
                 "coord_addr": promoted[0][1].group(3),
                 "generation": generation}
    if (generation != loaded["generation"] + 1
            or written["generation"] != generation
            or out["bootstrap"] != boot_want):
        raise AssertionError(f"failover: promoted generation {generation} "
                             f"from snapshot v{version} at generation "
                             f"{loaded['generation']}, its first snapshot "
                             f"{written['generation']}, bootstrap "
                             f"{out['bootstrap']} against {boot_want}")
    out["snapshot"] = {"loaded_version": version,
                       "loaded_generation": loaded["generation"],
                       "promoted_generation": generation,
                       "hot_mutations_replayed": replayed,
                       "versions_on_disk": len(backend.versions())}

    # gate 3: master-lost mode, one reconnect with the world intact, no
    # new round, no restart
    lost = _matches(lines["agent"], r"entering master-lost mode")
    reconnected = _matches(lines["agent"],
                           r"reconnected to master (\S+) \(generation "
                           r"(\d+), world intact=(\w+)\)")
    spawns = _matches(lines["agent"], r"spawning worker \(round (\d+),")
    if (len(lost) != 1 or len(reconnected) != 1
            or reconnected[0][1].group(3) != "True"
            or reconnected[0][1].group(1) != boot_want["addr"]
            or int(reconnected[0][1].group(2)) != generation
            or [m.group(1) for _, m in spawns] != ["0"]
            or out["agent_exit"] != 0):
        raise AssertionError(
            f"failover: agent exit {out['agent_exit']}, master-lost "
            f"{len(lost)}, reconnects "
            f"{[m.group(0) for _, m in reconnected]}, spawns "
            f"{[m.group(0) for _, m in spawns]}: {tail['agent']}")
    runs = _worker_log(paths["worker.log"])
    run = runs[0] if len(runs) == 1 else {}
    order = list(run.get("steps", {}))
    pid_at_exit = run.get("times", {}).get("pid")
    if (len(runs) != 1 or run["start"] != 0
            or order != list(range(1, steps + 1))
            or run["pid"] is None or pid_at_exit != run["pid"]
            or out["worker_pids_seen"] != [run["pid"]]):
        raise AssertionError(
            f"failover: {len(runs)} incarnations, starts "
            f"{[r['start'] for r in runs]}, steps {order}, pids "
            f"{run.get('pid')} / {pid_at_exit} / {out['worker_pids_seen']}")
    t_lost, t_reconnect = lost[0][0], reconnected[0][0]
    after = [n for n in order if run["steps"][n][0] > t_reconnect]
    out["run"] = run
    out["steps_after_reconnect"] = len(after)
    if len(after) < FAILOVER_AFTER_RECONNECT:
        raise AssertionError(f"failover: {len(after)} steps after the "
                             f"reconnect, want {FAILOVER_AFTER_RECONNECT}")

    # gate 5: the promoted master's state is the snapshot it loaded,
    # component by component (a hot key the mutation log replayed over
    # the snapshot aside), and its tsdb holds the sidecar's points from
    # before the kill
    differ = [k for k in FAILOVER_COMPONENTS
              if k != "kv_store" and loaded.get(k) != written.get(k)]
    kv_loaded, kv_written = loaded["kv_store"], written["kv_store"]
    if replayed == 0:
        kv_same = kv_loaded == kv_written
    else:
        cold = [k for k in set(kv_loaded) | set(kv_written)
                if not k.startswith("coord/")]
        kv_same = all(kv_loaded.get(k) == kv_written.get(k) for k in cold)
    if differ or not kv_same:
        raise AssertionError(f"failover: the promoted master's first "
                             f"snapshot v{version + 1} differs from the "
                             f"loaded v{version} in {differ} (kv store "
                             f"same: {kv_same})")
    before = [p for series in out["history"].get("series", ())
              for p in series["points"] if p[0] < t_kill and p[4] > 0]
    out["tsdb_points_before_kill"] = len(before)
    if not before:
        raise AssertionError(f"failover: the promoted master's tsdb holds "
                             f"no step-time point from before the kill: "
                             f"{out['history']}")

    # marks, measured and printed, not gated
    t_promoted = promoted[0][0]
    # the kill step's report is the one the primary died serving
    reports_after_kill = [n for n in order if n >= kill_at]
    with open(paths["worker.log"]) as f:
        failed_reports = sum(1 for line in f
                             if line.split(" ", 1)[-1].startswith(
                                 "step report failed"))
    out["marks"] = {
        "kill_to_first_failed_probe_s": (failed_probes[0][0] - t_kill
                                         if failed_probes else None),
        "kill_to_promoted_s": t_promoted - t_kill,
        "promotion_s": float(promoted[0][1].group(1)),
        "kill_to_master_lost_s": t_lost - t_kill,
        "kill_to_reconnect_s": t_reconnect - t_kill,
        "master_lost_to_reconnect_s": t_reconnect - t_lost}
    periods = {n: run["steps"][n][0] - run["steps"][n - 1][0]
               for n in order[1:]}

    def median_ms(ns):
        vals = [periods[n] for n in ns if n in periods]
        return statistics.median(vals) * 1e3 if vals else None

    out["step_period_ms"] = {
        "before_kill": median_ms([n for n in order
                                  if run["steps"][n][0] <= t_kill]),
        "outage": median_ms([n for n in order
                             if t_kill < run["steps"][n][0]
                             <= t_reconnect]),
        "after_reconnect": median_ms(after),
        "after_reconnect_max": max((periods[n] for n in after), default=0)
        * 1e3}
    out["step_reports"] = {
        "sent_from_the_kill_step": len(reports_after_kill),
        "failed": failed_reports,
        "reached_promoted_master": len(reports_after_kill)
        - failed_reports}
    out["goodput_buckets"] = out["goodput"].get("buckets")
    return out


def phase_failover(smi: str) -> dict:
    """Llama-1B trains through a SIGKILLed master (see the module
    docstring)."""
    import os
    import shutil
    import tempfile

    from dlrover_tpu_torch.models.llama import LlamaConfig

    t_phase = time.monotonic()
    cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                               norm_impl="fused", embed_impl="gather")
    budget = failover_budget(FAILOVER_MONITOR_S, FAILOVER_RPC_TIMEOUT_S)
    steps = budget["steps"]
    log(f"failover: the agent polls every {FAILOVER_MONITOR_S} s (cut from "
        f"5 s) and every master RPC of the agent and the worker has a "
        f"{FAILOVER_RPC_TIMEOUT_S} s deadline (cut from 30 s); the standby "
        f"runs at its defaults; bounds from the code: "
        f"{json.dumps(budget)}: {steps} steps, the kill at step "
        f"{FAILOVER_KILL_AT}, saves every {FAILOVER_SAVE_EVERY}")
    t_ref = time.monotonic()
    ref = _reference_prefix(cfg, steps)
    log(f"failover: the reference run took {time.monotonic() - t_ref:.1f} "
        f"s (0 when an earlier phase ran it)")
    state_bytes = 3 * 4 * cfg.param_count()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_failover_")
    agent_tmp = ""
    _free_memory()
    try:
        saves = steps // FAILOVER_SAVE_EVERY
        free = shutil.disk_usage(tmp).free
        log(f"failover: checkpoints in {tmp}, {free / 1e9:.1f} GB free; "
            f"the run keeps its {saves} saves of {state_bytes / 1e9:.2f} "
            f"GB")
        if free < (saves + 0.1) * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free in {tmp}: less "
                                 f"than {saves} checkpoints")
        agent_tmp = peer_root(state_bytes, tmp, smi, "failover")
        out = failover_drill(
            tmp, repo,
            ["--config", "llama_1b", "--save-interval",
             str(FAILOVER_SAVE_EVERY), "--ckpt-dir", f"{tmp}/ckpt"],
            steps, FAILOVER_KILL_AT, FAILOVER_MONITOR_S,
            {"TMPDIR": agent_tmp,
             "DLROVER_TPU_RPC_TIMEOUT_S": str(FAILOVER_RPC_TIMEOUT_S),
             # every snapshot stays, so the loaded one can be read back
             "DLROVER_TPU_MASTER_SNAPSHOT_RETAIN": "1000",
             # the sidecar holds the history before the kill
             "DLROVER_TPU_TSDB_SAMPLE_INTERVAL_S": "1",
             "DLROVER_TPU_TSDB_FLUSH_INTERVAL_S": "2",
             "DLROVER_TPU_FLIGHT_DIR": f"{tmp}/flight"})
        run = out.pop("run")
        # gate 4: every step the bits of an uninterrupted run
        same = {n: (r[1], r[2]) == ref[n - 1]
                for n, r in run["steps"].items()}
        log(f"failover losses against an uninterrupted in-process run: "
            f"{json.dumps(same)}")
        if not all(same.values()):
            raise AssertionError(f"failover: steps against the reference "
                                 f"run: {same}")
        want = _expected_launches(cfg, steps)
        if run.get("launches") != want:
            raise AssertionError(f"failover: launches {run.get('launches')},"
                                 f" want {want}")
        out["launches"] = run["launches"]
        out["budget"] = budget
        out.pop("history")
        out.pop("goodput")
        for key in ("marks", "step_period_ms", "step_reports",
                    "goodput_buckets", "snapshot"):
            log(f"failover {key}: {json.dumps(out[key])} ({smi})")
        out["phase_s"] = time.monotonic() - t_phase
        log(f"failover: {out['steps_after_reconnect']} steps after the "
            f"reconnect, {out['tsdb_points_before_kill']} tsdb buckets "
            f"from before the kill; the phase took {out['phase_s']:.1f} s "
            f"(the worker under the agent {out['agent_run_s']:.1f} s) "
            f"({smi})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if agent_tmp:
            shutil.rmtree(agent_tmp, ignore_errors=True)
    return out


# the replan phase: two solo replicas of Llama-1B on the one card under
# the port's master (min 1, max 2 nodes), each a micro batch of 2; the
# top rank leaves at step 6 and the survivor re-plans to world 1. No
# interval save: the survivor's only checkpoint is the one its stop
# forces (a commit in flight would hold the leaver's exit for its whole
# 16-26 s, and the survivor trains on meanwhile). 32 steps leave room
# for the survivor's stop, which lands some steps after 6, and for three
# diagnosis rounds after the re-plan.
REPLAN_STEPS = 32
REPLAN_LEAVE_AT = 6
REPLAN_MICRO = 2
REPLAN_MONITOR_S = 0.5
REPLAN_INTERVAL_S = 2.0
# the master's speed window (samples): the last seven step periods, clear
# of the resumed incarnation's first-step collection
REPLAN_SPEED_WINDOW = 8
REPLAN_SPEED_TOL = 0.02


def _link_stage(cache: str, step: int, dest: str) -> str:
    """Hard-link a peer cache's stage of ``step`` into a new cache
    directory ``dest`` (the same bytes, no copy), with that stage's
    manifest as the top-level one; returns ``dest``."""
    import os
    import shutil

    from dlrover_tpu_torch.checkpoint.peer_restore import MANIFEST

    stage = os.path.join(cache, f"stage-{step}")
    target = os.path.join(dest, f"stage-{step}")
    os.makedirs(target)
    for name in os.listdir(stage):
        os.link(os.path.join(stage, name), os.path.join(target, name))
    shutil.copyfile(os.path.join(stage, MANIFEST),
                    os.path.join(dest, MANIFEST))
    return dest


def _replan_reference(cfg, cache: str, ckpt_dir: str, steps: int) -> dict:
    """A solo world-1 worker in this process restored from the staged cut
    in ``cache`` (no master: the local pseudo-plan) at the survivor's
    shape (batch 8, micro 2), trained to ``steps``: its source, start
    and {step: (loss, grad_norm)}."""
    import os

    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )

    os.environ[NodeEnv.PEER_CACHE_DIR] = cache
    try:
        loop = ElasticTrainLoop(
            functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
            TrainLoopConfig(global_batch=8, seq_len=cfg.max_seq_len,
                            max_micro_per_replica=REPLAN_MICRO,
                            checkpoint_dir=ckpt_dir,
                            save_interval_steps=10 ** 6,
                            report_interval_steps=0))
    finally:
        del os.environ[NodeEnv.PEER_CACHE_DIR]
    sampler, data = _sampler_and_data(cfg)
    state, start = loop.restore_or_init(0, sampler)
    out = {"source": loop.last_restore_source, "start": start}
    loop.config.max_steps = steps - start
    state, metrics = loop.run(state, data, start, sampler)
    loop.close()
    out["steps"] = {r["step"]: (r["loss"], r["grad_norm"])
                    for r in metrics["history"]}
    del state, loop
    _free_memory()
    return out


def phase_replan(smi: str) -> dict:
    """Re-planning on resize: two solo replicas of Llama-1B on the card
    under the port's master, the top rank leaving at step 6, the
    survivor re-planned to world 1 in one round (see the module
    docstring)."""
    import glob
    import os
    import re
    import shutil
    import statistics as stats
    import tempfile

    from dlrover_tpu_torch import obs
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common import messages as msg
    from dlrover_tpu_torch.common.config import Context
    from dlrover_tpu_torch.common.constants import RendezvousName
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.parallel import planner

    t_phase = time.monotonic()
    cfg = LlamaConfig.llama_1b(max_seq_len=2048, attn_impl="flash",
                               norm_impl="fused", embed_impl="gather")
    state_bytes = 3 * 4 * cfg.param_count()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_replan_")
    agent_tmp = ""
    ctx = Context.singleton()
    saved = {k: getattr(ctx, k) for k in ("diagnosis_interval_s",
                                          "speed_sample_window")}
    ctx.update(diagnosis_interval_s=REPLAN_INTERVAL_S,
               speed_sample_window=REPLAN_SPEED_WINDOW)
    master = JobMaster(min_nodes=1, max_nodes=2, host="127.0.0.1")
    mgr = master.servicer.rdzv_managers[RendezvousName.TRAINING]
    # both ranks alive up front: the first round cuts once, when the
    # second joins
    for rank in (0, 1):
        mgr.add_alive_node(rank)
    seen = {"model_info": [], "spans": []}
    report = master.servicer.report

    def recording_report(request):
        if isinstance(request, msg.ModelInfo):
            seen["model_info"].append(request)
        elif isinstance(request, msg.TelemetryReport) and request.spans_json:
            seen["spans"] += [(request.node_rank, s) for s in
                              json.loads(request.spans_json)]
        return report(request)

    master.servicer.report = recording_report
    note_replan = master.servicer._note_replan

    def recording_note_replan(plan):
        # the speed monitor's window right after the re-anchor
        note_replan(plan)
        seen.setdefault("replans", []).append(
            (plan, len(master.speed_monitor._samples)))

    master.servicer._note_replan = recording_note_replan
    master.prepare()
    procs, files = [], []
    out = {"card": smi}
    _free_memory()
    try:
        free = shutil.disk_usage(tmp).free
        log(f"replan: checkpoints in {tmp}, {free / 1e9:.1f} GB free; the "
            f"run needs room for two of {state_bytes / 1e9:.2f} GB")
        if free < 2 * state_bytes:
            raise AssertionError(f"{free / 1e9:.1f} GB free in {tmp}: less "
                                 f"than two checkpoints")
        agent_tmp = peer_root(state_bytes, tmp, smi, "replan")
        logs = [f"{tmp}/rank{rank}.log" for rank in (0, 1)]
        errs = [f"{tmp}/agent{rank}.err" for rank in (0, 1)]
        env = {"DLROVER_TPU_CHAOS": f"resize:-1@{REPLAN_LEAVE_AT}",
               "DLROVER_TPU_CHAOS_STATE": f"{tmp}/chaos",
               "DLROVER_TPU_FLIGHT_DIR": f"{tmp}/flight"}
        t_launch = time.time()
        for rank in (0, 1):
            proc, pair = _spawn_agent(
                master, ["--config", "llama_1b", "--steps",
                         str(REPLAN_STEPS), "--save-interval",
                         str(10 ** 6), "--report-interval", "1",
                         "--max-micro", str(REPLAN_MICRO), "--solo-replica",
                         "--ckpt-dir", f"{tmp}/ckpt", "--log-file",
                         logs[rank]],
                env, f"{tmp}/agent{rank}.out", errs[rank], agent_tmp, repo,
                run_args=("--node-rank", str(rank), "--devices-per-node",
                          "1", "--monitor-interval", str(REPLAN_MONITOR_S)))
            procs.append(proc)
            files += pair
        # watch the run: the plans the master stamps, and the survivor's
        # staged cut, linked aside as soon as its second incarnation
        # starts (the agent removes its cache when it exits)
        plans, ref_cache, rounds_at_resize = [], "", None
        deadline = time.monotonic() + 900
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise AssertionError("replan: the agents outlived 900 s")
            plan = mgr.last_shard_plan
            if plan and (not plans or plan != plans[-1]):
                plans.append(plan)
            if rounds_at_resize is None and 1 not in mgr.alive_nodes:
                rounds_at_resize = mgr.rdzv_round
            runs = _worker_log(logs[0]) if os.path.exists(logs[0]) else []
            if not ref_cache and len(runs) > 1:
                step = runs[1]["start"]
                caches = [c for c in glob.glob(
                    f"{agent_tmp}/dlrover-tpu-agent-*/peer_cache")
                    if os.path.isdir(f"{c}/stage-{step}")]
                if len(caches) != 1:
                    raise AssertionError(f"replan: stage {step} in "
                                         f"{caches}")
                ref_cache = _link_stage(caches[0], step,
                                        f"{agent_tmp}/reference_cache")
            time.sleep(0.2)
        out["agents_s"] = time.time() - t_launch
        codes = [p.returncode for p in procs]
        for f in files:
            f.close()
        tails = {rank: "\n".join(t for _, t in _agent_lines(errs[rank])[-10:])
                 for rank in (0, 1)}
        if codes != [0, 0]:
            raise AssertionError(f"replan: agents exited {codes}: {tails}")
        survivor, leaver = _worker_log(logs[0]), _worker_log(logs[1])
        if len(survivor) != 2 or len(leaver) != 1:
            raise AssertionError(f"replan: {len(survivor)} survivor and "
                                 f"{len(leaver)} leaver incarnations")
        first, resumed = survivor
        stop = resumed["start"]
        out["stop_step"] = stop
        log(f"replan: the leaver stopped after step "
            f"{max(leaver[0]['steps'])}, the survivor's stop forced its "
            f"save at step {stop}; its resumed incarnation trained "
            f"{sorted(resumed['steps'])}")
        if (sorted(leaver[0]["steps"]) != list(range(1, REPLAN_LEAVE_AT + 1))
                or stop < REPLAN_LEAVE_AT or stop > REPLAN_STEPS - 4
                or sorted(resumed["steps"]) != list(
                    range(stop + 1, REPLAN_STEPS + 1))):
            raise AssertionError(
                f"replan: leaver steps {sorted(leaver[0]['steps'])}, "
                f"survivor {sorted(first['steps'])} then "
                f"{sorted(resumed['steps'])}")

        # gate 1: the plans, world 2 → 1, a new epoch, feasible; the
        # survivor's incarnations applied the two (the second's plan, an
        # RPC after the cut, carries the round of the cut as generation)
        applied = []
        with open(logs[0]) as f:
            for line in f:
                m = re.search(r"shard plan applied \((\S+)\): .* "
                              r"generation=(\d+) epoch=(\d+)", line)
                if m:
                    applied.append((m.group(1), int(m.group(2)),
                                    int(m.group(3))))
        out["applied"] = applied
        two = [p for p in plans if p["world_size"] == 2]
        one = [p for p in plans if p["world_size"] == 1]
        out["plans"] = [{k: p[k] for k in ("world_size", "epoch",
                                           "generation", "mesh",
                                           "global_batch", "feasible",
                                           "predicted_step_s")}
                        for p in plans]
        log(f"replan plans stamped: {json.dumps(out['plans'])}")
        if (not two or not one or plans[-1] != one[-1]
                or not one[-1]["feasible"]
                or one[-1]["epoch"] <= two[-1]["epoch"]
                or [a[0] for a in applied] != ["batch", "mesh+batch"]
                or applied[1][2] != one[-1]["epoch"]):
            raise AssertionError(f"replan: plans {out['plans']}, applied "
                                 f"{applied}")
        post = dict(one[-1], generation=applied[1][1])

        # gate 2: one rendezvous round, the restore from the survivor's
        # own staged cut (no checkpoint read), the leaver's clean drain
        drained = [e for e in obs.get_flight_recorder().snapshot()
                   if e.get("name") == "node_drained"
                   and e["attrs"].get("rank") == 1]
        out["rounds"] = {"at_resize": rounds_at_resize,
                         "final": mgr.rdzv_round}
        out["restore"] = {"source": resumed["source"],
                          "timings": resumed["restore"]}
        log(f"replan restore: {json.dumps(out['restore'])}; rounds "
            f"{json.dumps(out['rounds'])}")
        if (rounds_at_resize is None or mgr.rdzv_round != rounds_at_resize + 1
                or resumed["source"] != "peer"
                or "dcp_read_s" in resumed["restore"] or not drained):
            raise AssertionError(
                f"replan: rounds {out['rounds']}, restore {out['restore']},"
                f" drained {drained}")

        # gate 3: the spans of the resize, each once, from the survivor
        priced = [s for rank, s in seen["spans"] if rank == 0
                  and s.get("name", "").startswith("replan_")
                  and (s.get("attrs") or {}).get("generation")
                  == post["generation"]]
        names = sorted(s["name"] for s in priced)
        out["spans"] = {s["name"][len("replan_"):]: s["duration_s"]
                        for s in priced}
        migrate = [s for s in priced if s["name"] == "replan_migrate"]
        log(f"replan spans of generation {post['generation']}: "
            f"{json.dumps(out['spans'])} s ({smi})")
        if (names != ["replan_migrate", "replan_plan", "replan_rebuild"]
                or migrate[0]["attrs"].get("source") != "peer"):
            raise AssertionError(f"replan: spans {priced}")

        # gate 4: the survivor's resumed steps, bit for bit a solo
        # world-1 worker restored from the same staged cut
        ckpt_ref = f"{tmp}/reference_ckpt"
        ref = _replan_reference(cfg, ref_cache, ckpt_ref, REPLAN_STEPS)
        same = {n: (r[1], r[2]) == ref["steps"].get(n)
                for n, r in resumed["steps"].items()}
        log(f"replan: the reference restored {ref['start']} from "
            f"{ref['source']}; the survivor's resumed steps against it: "
            f"{json.dumps(same)}")
        if (ref["source"] != "peer" or ref["start"] != stop
                or not all(same.values())):
            raise AssertionError(f"replan: reference {ref['source']} at "
                                 f"{ref['start']}, steps {same}")
        shared = {rank: [r["steps"][n][3] for n in range(2,
                                                          REPLAN_LEAVE_AT + 1)]
                  for rank, r in ((0, first), (1, leaver[0]))}
        out["same_bits_both_replicas"] = all(
            first["steps"][n][1:3] == leaver[0]["steps"][n][1:3]
            for n in range(1, REPLAN_LEAVE_AT + 1))

        # gate 5: the master's speed from post-resize samples only: the
        # re-plan re-anchored it (its window emptied, one card) at the
        # survivor's re-join. (A replica whose plan request follows the
        # other's first ModelInfo sees the world-2 plan re-stamped with
        # the real batch, which both packages' masters count as a
        # re-plan too: at most one such re-anchor at two cards before.)
        replans = [(p["total_devices"], n) for p, n in seen.get("replans",
                                                               [])]
        out["reanchor"] = replans
        if replans[-1:] != [(1, 0)] or replans[:-1] not in ([], [(2, 0)]):
            raise AssertionError(f"replan: re-anchors {replans}")
        monitor = master.speed_monitor
        samples = list(monitor._samples)
        speed = monitor.export_state()
        info = seen["model_info"][-1]
        tokens = 8 * cfg.max_seq_len
        window = [s for _, s in samples]
        # the survivor's own rate over the master's window, from its step
        # lines' clock: the mean period, as the master's window is a
        # mean (the median printed beside it: steps at micro 2 have
        # outliers of 10%, which part a mean from a median)
        times = {n: r[0] for n, r in resumed["steps"].items()}
        periods = [times[n] - times[n - 1] for n in window[1:]
                   if n - 1 in times]
        own_tps = tokens / stats.mean(periods)
        own_mfu = own_tps * info.flops_per_token / info.peak_flops_per_chip
        out["speed"] = {
            "window_steps": window,
            "master_tokens_per_s": monitor.tokens_per_second(),
            "master_mfu": monitor.running_mfu(),
            "survivor_tokens_per_s": own_tps, "survivor_mfu": own_mfu,
            "survivor_median_tokens_per_s": tokens / stats.median(periods),
            "master_periods_s": [b[0] - a[0] for a, b in
                                 zip(samples, samples[1:])],
            "survivor_periods_s": periods,
            "survivor_step_s": [resumed["steps"][n][3] for n in window],
            "tokens_per_step": speed["tokens_per_step"],
            "peak_flops_total": speed["peak_flops_total"]}
        log(f"replan speed: {json.dumps(out['speed'])} ({smi})")
        if (speed["tokens_per_step"] != tokens
                or speed["peak_flops_total"] != info.peak_flops_per_chip
                or not window or min(window) <= stop
                or abs(out["speed"]["master_tokens_per_s"] / own_tps - 1)
                > REPLAN_SPEED_TOL
                or abs(out["speed"]["master_mfu"] / own_mfu - 1)
                > REPLAN_SPEED_TOL):
            raise AssertionError(f"replan: speed {out['speed']}")

        # gate 6: the calibration holds the world-1 signature with its
        # samples, predicted by the planner's formula on the ModelInfo
        client = MasterClient(master.addr, node_id=99, node_rank=-1)
        try:
            calibration = client.get_plan_calibration()
            goodput = client.get_goodput()
            reports = client.get_diagnosis_reports()
        finally:
            client.close()
        entry = [e for e in calibration["table"]
                 if e["total_devices"] == 1][-1:]
        profile = planner.ModelProfile(
            param_count=info.param_count, param_bytes=info.param_bytes,
            flops_per_token=info.flops_per_token,
            peak_flops_per_chip=info.peak_flops_per_chip,
            seq_len=info.seq_len, global_batch=info.batch_size)
        formula = planner.plan_parallelism({0: 1}, profile)
        by_hand = (info.batch_size * info.seq_len * info.flops_per_token
                   / (info.peak_flops_per_chip * 0.6))
        out["calibration"] = entry[0] if entry else {}
        log(f"replan calibration: {json.dumps(out['calibration'])}; the "
            f"planner's formula {formula['predicted_step_s']!r} s, by hand "
            f"{by_hand!r} s ({smi})")
        if (not entry or entry[0]["samples"] < 3
                or info.peak_flops_per_chip != PEAK_BF16_FLOPS
                or entry[0]["predicted_step_s"]
                != round(formula["predicted_step_s"], 9)
                or abs(formula["predicted_step_s"] / by_hand - 1) > 1e-12):
            raise AssertionError(f"replan: calibration {calibration}, "
                                 f"formula {formula}")

        # gate 7: the ledger's replans row holds plan, migrate, rebuild
        row = [r for r in goodput.get("replans", [])
               if r["rank"] == 0 and r["generation"] == post["generation"]]
        out["ledger_row"] = row[0] if row else {}
        if not row or sorted(row[0]["phases"]) != ["migrate", "plan",
                                                   "rebuild"]:
            raise AssertionError(f"replan: ledger replans "
                                 f"{goodput.get('replans')}")

        # gate 8: both workers launched every training kernel, exactly
        # as their steps and micro batches imply
        accum = 8 // REPLAN_MICRO
        launches = {"leaver": leaver[0].get("launches"),
                    "survivor": resumed.get("launches")}
        want = {"leaver": _expected_launches(cfg, REPLAN_LEAVE_AT * accum),
                "survivor": _expected_launches(
                    cfg, (REPLAN_STEPS - stop) * accum)}
        if launches != want:
            raise AssertionError(f"replan: launches {launches}, want {want}")
        out["launches"] = {name: launches["survivor"][name]
                           + launches["leaver"][name]
                           + first.get("launches", {}).get(name, 0)
                           for name in want["survivor"]}

        # printed, not gated
        regression = [r for r in reports if r["rule"] == "plan_regression"]
        leave_line = [t for t, text in _agent_lines(errs[1])
                      if "drain complete" in text]
        t_first = min(r[0] for r in resumed["steps"].values())
        # the drain to the first resumed step by part, on the wall clock
        spawn = [t for t, text in _agent_lines(errs[0])
                 if "spawning worker (round 1," in text]
        times = resumed.get("times", {})
        marks = [("drained", leave_line[0] if leave_line else None),
                 ("stop_save_committed", first["commits"].get(stop)),
                 ("respawned", spawn[0] if spawn else None),
                 ("imported", times.get("imported")),
                 ("loop_built", times.get("loop_built")),
                 ("restored", times.get("restored")),
                 ("first_resumed_step", t_first)]
        resize_parts = {f"{a}->{b}": tb - ta for (a, ta), (b, tb)
                        in zip(marks, marks[1:])
                        if ta is not None and tb is not None}
        peaks = {}
        for rank in (0, 1):
            with open(logs[rank]) as f:
                peaks[rank] = max(
                    (json.loads(line.split("worker_allocator_peak ", 1)[1])
                     ["bytes"] for line in f
                     if "worker_allocator_peak " in line), default=0)
        out["printed"] = {
            "predicted_step_s": entry[0]["predicted_step_s"],
            "measured_step_s": entry[0]["measured_step_s"],
            "ratio": entry[0]["ratio"],
            "plan_regression": [{k: r[k] for k in ("severity", "summary")}
                                | {"windows_over": r.get("details", {})
                                   .get("windows_over")}
                                for r in regression],
            "plan_migrate_rebuild_s": out["spans"],
            "migrate_bytes": migrate[0]["attrs"].get("bytes"),
            "leaver_drained_to_first_resumed_step_s": (
                t_first - leave_line[0] if leave_line else None),
            "resize_parts_s": resize_parts,
            "shared_step_ms_median": {
                rank: stats.median(v) * 1e3 for rank, v in shared.items()},
            "resumed_step_ms_median": stats.median(
                r[3] for r in resumed["steps"].values()) * 1e3,
            "allocator_peak_bytes": peaks,
            "same_bits_both_replicas": out["same_bits_both_replicas"]}
        log(f"replan printed: {json.dumps(out['printed'])} ({smi})")
        out["phase_s"] = time.monotonic() - t_phase
        log(f"replan: the phase took {out['phase_s']:.1f} s (the agents "
            f"{out['agents_s']:.1f} s) ({smi})")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in files:
            f.close()
        master.stop(grace_s=0.5)
        ctx.update(**saved)
        shutil.rmtree(tmp, ignore_errors=True)
        if agent_tmp:
            shutil.rmtree(agent_tmp, ignore_errors=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--phases",
                        default="kernels,quant,parity,llama1b,resume,"
                                "standalone,faults,observe,failover,replan",
                        help="comma-separated subset of kernels, quant, "
                             "parity, llama1b, resume, standalone, faults, "
                             "observe, failover, replan (device and build "
                             "always run)")
    parser.add_argument("--profile", default="",
                        help="after the Llama-1B run, profile one more "
                             "step and write the kernel table here")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    # a SIGTERM (a time limit) unwinds through the phases' ``finally``
    # blocks, which remove their directories (a peer cache on /dev/shm
    # among them)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    t0 = time.monotonic()
    smi = phase_device()
    phase_build()
    train_records = phase_kernels() if "kernels" in phases else []
    quant_records = phase_quant() if "quant" in phases else []
    if "parity" in phases:
        phase_parity()
    llama1b = {}
    if "llama1b" in phases:
        # the training path's kernels take their launches from its run
        launches, llama1b = phase_llama1b(profile_out=args.profile)
        for rec in train_records:
            rec["launches"] = launches[rec["name"]]
    resume = {}
    if "resume" in phases:
        # the quantization pair's path: the int8 checkpoint's save and
        # restore
        resume = phase_resume(smi, llama1b)
        for rec in quant_records:
            rec["launches"] = resume["c"][f"{rec['name']}_launches"]
    if "standalone" in phases:
        # the worker under the agent counts its own launches, printed at
        # its exit: the resumed incarnation's steps
        standalone = phase_standalone(smi, llama1b, resume)
        for rec in train_records + quant_records:
            rec["standalone_launches"] = standalone["launches"][rec["name"]]
    if "faults" in phases:
        # the drained worker's, the hung one's up to its last finished
        # step, and its relaunch's, summed
        faults = phase_faults(smi, llama1b, resume)
        for rec in train_records + quant_records:
            rec["faults_launches"] = sum(
                counts[rec["name"]]
                for counts in faults["launches"].values())
    if "observe" in phases:
        # the worker under the master that diagnoses it: its launches
        # over every step, the profiled ones among them
        observe = phase_observe(smi, llama1b)
        for rec in train_records + quant_records:
            rec["observe_launches"] = observe["launches"][rec["name"]]
    if "failover" in phases:
        # the worker that trained through its master's death
        failover = phase_failover(smi)
        for rec in train_records + quant_records:
            rec["failover_launches"] = failover["launches"][rec["name"]]
    if "replan" in phases:
        # the two replicas' incarnations, the leaver's and the
        # survivor's two, summed
        replan = phase_replan(smi)
        for rec in train_records + quant_records:
            rec["replan_launches"] = replan["launches"][rec["name"]]
    records = train_records + quant_records
    log(f"elapsed {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
