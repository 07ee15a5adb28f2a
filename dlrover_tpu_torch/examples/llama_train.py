"""Llama elastic training worker: the script the agent spawns.

The port's counterpart of the JAX package's ``examples/nanogpt/train.py``.
``python -m dlrover_tpu_torch.run --standalone`` starts a local master
and agent; the agent spawns this worker, which joins the round's process
group, builds a Llama through ``ElasticTrainLoop`` with a flash
checkpoint, reports to the master when ``DLROVER_TPU_MASTER_ADDR`` is
set, and trains on the synthetic random-walk corpus from random weights
(seed ``--seed``).

Run single-host, on the card:
    python -m dlrover_tpu_torch.run --standalone \\
        dlrover_tpu_torch/examples/llama_train.py --config llama_1b \\
        --steps 100 --ckpt-dir /tmp/llama-ckpt
and on the CPU at a tiny width:
    python -m dlrover_tpu_torch.run --standalone \\
        dlrover_tpu_torch/examples/llama_train.py --config tiny --device cpu

With ``--solo-replica`` each worker is an independent full replica: it
joins no process group and keeps its checkpoints in its own directory,
``<ckpt-dir>/rank<N>``. Under a master that plans a larger world, the
loop then applies only the plan's batch (the replica mode of
``trainer/elastic_loop.py``), so several agents on one host, even on
one card, exercise the control plane of a multi-host job: re-planning
on a resize, the donors, the restore plans.

A SIGKILL mid-run restarts the worker through the agent; the new
incarnation resumes from the latest committed checkpoint with the data
position intact. SIGTERM finishes the step, saves it and exits 0. A
drain request from the agent (a preemption notice) saves the step under
its deadline and exits 76; with ``DLROVER_TPU_HANG_WATCHDOG_S`` set, a
worker whose steps stop dumps its stacks and aborts itself (SIGABRT).
Faults are scripted through ``DLROVER_TPU_CHAOS`` (``diagnostics/
chaos.py``); every knob rides the environment, as in the JAX package.

Besides its step lines (the loop's, each with the loss as its ``repr``)
the worker prints ``start_step=`` (with the restore's source, ``peer``
from the agent's staged copy, ``checkpoint`` from disk, its pid and its
restore's timings by part), ``done step=`` (or ``drained``), a
``worker_launch_counts`` JSON line with its kernel launches so far at
the start of every step after the first and at exit (an aborted worker's
last line holds its launches up to its last finished step), on the card
a ``worker_allocator_peak`` JSON line beside it (the caching allocator's
``allocated_bytes.all.peak`` after that many steps of this run, what the
step reports carry to the master as ``hbm_peak_bytes``, and
``reserved_bytes.all.peak``), and at exit one
``worker_times`` line with its wall-clock marks and its pid.

The agent hands the worker the files of its monitors and diagnosis
actions through the environment (``DLROVER_TPU_CHIP_STATS``, the card
stats it relays; ``DLROVER_TPU_PROFILE_REQUEST``, the on-demand
profiler captures); every telemetry knob is a ``DLROVER_TPU_<NAME>``
variable read by ``Context`` (``DLROVER_TPU_STEPTRACE_ENABLED``,
``DLROVER_TPU_PROFILE_DIR`` for a static capture window, ...).
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if not __package__:
    # run as a script from a checkout: the package is two levels up
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser("llama-train")
    parser.add_argument("--config", choices=("llama_1b", "tiny"),
                        default="llama_1b")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--global-batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=0,
                        help="sequence length (0 = 2048 for llama_1b, 16 "
                             "for tiny)")
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt-dir", default="")
    parser.add_argument("--save-interval", type=int, default=20)
    parser.add_argument("--max-micro", type=int, default=0,
                        help="largest micro batch a replica runs at once "
                             "(0 = the global batch, no accumulation)")
    parser.add_argument("--solo-replica", action="store_true",
                        help="an independent full replica: no process "
                             "group, checkpoints in <ckpt-dir>/rank<N>")
    parser.add_argument("--report-interval", type=int, default=10)
    parser.add_argument("--log-file", default="",
                        help="append the worker's lines here (tests parse "
                             "it), each prefixed with its Unix time")
    return parser.parse_args(argv)


def build_config(name: str, seq: int):
    """(LlamaConfig, sequence length) of a named configuration: Llama-1B
    in the JAX headline configuration (flash attention, fused norm,
    gather embedding), or a tiny f32 one for CPU runs."""
    import torch

    from dlrover_tpu_torch.models.llama import LlamaConfig

    if name == "llama_1b":
        seq = seq or 2048
        return LlamaConfig.llama_1b(max_seq_len=seq, attn_impl="flash",
                                    norm_impl="fused",
                                    embed_impl="gather"), seq
    seq = seq or 16
    return LlamaConfig.tiny(dtype=torch.float32), seq


def main(argv=None) -> int:
    args = parse_args(argv)
    device = "cpu" if args.device == "cpu" else None

    from dlrover_tpu_torch.common.log import default_logger as logger

    handler = None
    if args.log_file:
        handler = logging.FileHandler(args.log_file)
        handler.setFormatter(logging.Formatter("%(created).6f %(message)s"))
        logger.addHandler(handler)

    def log(message: str) -> None:
        print(message, flush=True)
        if handler is not None:
            handler.stream.write(f"{time.time():.6f} {message}\n")
            handler.flush()

    import torch

    from dlrover_tpu_torch.agent.elastic_agent import init_distributed
    from dlrover_tpu_torch.common.constants import WorkerExit
    from dlrover_tpu_torch.models.llama import Llama, cross_entropy_loss
    from dlrover_tpu_torch.ops import flash_attention, norms, quantization
    from dlrover_tpu_torch.trainer.elastic_loop import (
        DrainExit,
        ElasticTrainLoop,
        TrainLoopConfig,
    )
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
    from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

    times = {"start": T_START, "imported": time.time(), "pid": os.getpid()}
    ckpt_dir = args.ckpt_dir
    if args.solo_replica:
        rank = int(os.environ.get("DLROVER_TPU_NODE_RANK", "0"))
        if ckpt_dir:
            ckpt_dir = os.path.join(ckpt_dir, f"rank{rank}")
    else:
        init_distributed(device)   # joins the round's process group
    cfg, seq = build_config(args.config, args.seq)

    client = None
    if os.environ.get("DLROVER_TPU_MASTER_ADDR"):
        from dlrover_tpu_torch.agent.master_client import MasterClient

        client = MasterClient.singleton()

    loop = ElasticTrainLoop(
        functools.partial(Llama, cfg),
        lambda p: torch.optim.AdamW(p, lr=args.lr, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=0.1),
        cross_entropy_loss,
        TrainLoopConfig(
            global_batch=args.global_batch,
            seq_len=seq,
            max_micro_per_replica=args.max_micro or args.global_batch,
            max_steps=args.steps,
            checkpoint_dir=ckpt_dir,
            save_interval_steps=args.save_interval,
            report_interval_steps=args.report_interval,
        ),
        master_client=client,
        device=device,
    )
    loop.install_signal_handler()
    times["loop_built"] = time.time()

    def log_launches() -> None:
        counts = {}
        for module in (flash_attention, norms, quantization):
            counts.update(module.launch_counts)
        log(f"worker_launch_counts {json.dumps(counts)}")

    def log_allocator_peak(steps: int) -> None:
        stats = torch.cuda.memory_stats()
        log("worker_allocator_peak " + json.dumps({
            "steps": steps, "bytes": stats["allocated_bytes.all.peak"],
            "reserved_bytes": stats["reserved_bytes.all.peak"]}))

    def counted(data):
        """The batches, logging the launches so far (and on the card the
        allocator's peak) before every batch after the first: the
        previous step is done by then."""
        for n, batch in enumerate(data):
            if n:
                log_launches()
                if loop.device.type == "cuda":
                    log_allocator_peak(n)
            yield batch

    sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)
    state, start_step = loop.restore_or_init(args.seed, sampler)
    times["restored"] = time.time()
    log(f"llama_train: start_step={start_step} "
        f"source={loop.last_restore_source} pid={os.getpid()} dp={loop.dp} "
        f"accum={loop.accum} device={loop.device} "
        f"restore={json.dumps(loop.last_restore_timings)}")
    try:
        if args.steps > start_step:
            # created at the first step, so a restored position counts
            data = batches(synthetic_corpus(cfg.vocab_size), sampler,
                           args.global_batch, seq)
            loop.config.max_steps = args.steps - start_step
            state, metrics = loop.run(state, counted(data),
                                      start_step=start_step,
                                      sampler=sampler)
            log(f"llama_train: done step={metrics['step']} "
                f"loss={metrics['loss']!r}")
        else:
            log("llama_train: nothing to do")
        loop.close()
    except DrainExit:
        # the emergency checkpoint is committed (or its outcome logged):
        # leave with the clean-drain code, the step's count and times
        # first
        log(f"llama_train: drained (exit {WorkerExit.DRAIN})")
        raise
    finally:
        log_launches()
        log(f"worker_times {json.dumps(times)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
