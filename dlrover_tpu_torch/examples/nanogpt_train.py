"""nanoGPT elastic training worker: the script the agent spawns.

The port's counterpart of the JAX package's ``examples/nanogpt/train.py``,
with the same command line, corpus and batches (the same tokens for the
same sampler seed): ``python -m dlrover_tpu_torch.run --standalone``
starts a local master and agent; the agent spawns this worker, which
joins the round's process group, builds a GPT through ``auto_accelerate``
(``["amp", "module_replace"]``: bf16 compute over f32 weights, the flash
kernels on the card and the plain attention on the CPU, over a
data-parallel mesh of the world, each micro batch at most 8 rows a
rank, as the loop's own build), trains it through ``ElasticTrainLoop``
with a flash checkpoint (sampler position included), and reports to the
master when ``DLROVER_TPU_MASTER_ADDR`` is set. ``--config nano`` (the default, as in the JAX example) is the
4-layer, 128-wide GPT; ``--config gpt2`` is GPT-2 small (12 × 768,
vocabulary 50304). Attention runs through the flash kernels on the card
and the plain path on the CPU.

Run single-host, on the card:
    python -m dlrover_tpu_torch.run --standalone \\
        dlrover_tpu_torch/examples/nanogpt_train.py --config gpt2 \\
        --seq 1024 --global-batch 48 --steps 200 --ckpt-dir /tmp/gpt2-ckpt
and on the CPU:
    python -m dlrover_tpu_torch.run --standalone \\
        dlrover_tpu_torch/examples/nanogpt_train.py --device cpu

A SIGKILL mid-run restarts the worker through the agent; the new
incarnation resumes from the latest committed checkpoint with the data
position intact, and logs ``nanogpt: start_step=N`` with its process
id, its restore source and the steps a slice-mode catch-up skipped. The
last line, ``nanogpt: done step=N loss=L digest=D``, carries a SHA-256
of the parameters' bytes, so replicas compare bit for bit.

In slice mode (``run --slice-id S``, ``DLROVER_TPU_SLICE_ID``) the
trainer steps in two halves around the cross-slice gradient sync
(``parallel/dcn_sync.py``).
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import os
import sys

if not __package__:
    # run as a script from a checkout: the package is two levels up
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from dlrover_tpu_torch.trainer.synthetic import (  # noqa: E402
    batches,
    synthetic_corpus,
)

__all__ = ["batches", "main", "parse_args", "synthetic_corpus"]

# rows a micro batch holds on each rank at most (TrainLoopConfig's default)
MAX_MICRO = 8


def parse_args(argv=None):
    parser = argparse.ArgumentParser("nanogpt-train")
    parser.add_argument("--config", choices=("nano", "gpt2"),
                        default="nano")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--global-batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--ckpt-dir", default="")
    parser.add_argument("--save-interval", type=int, default=20)
    parser.add_argument("--report-interval", type=int, default=10,
                        help="steps between step reports to the master")
    parser.add_argument("--log-file", default="",
                        help="append step logs here (tests parse it)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = "cpu" if args.device == "cpu" else None

    import numpy as np
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.agent.elastic_agent import init_distributed
    from dlrover_tpu_torch.auto import auto_accelerate
    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.models.llama import cross_entropy_loss
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

    init_distributed(device)   # joins the round's process group
    cfg = GPTConfig() if args.config == "gpt2" else GPTConfig.nano()
    world = dist.get_world_size() if dist.is_initialized() else 1
    result = auto_accelerate(
        functools.partial(GPT, cfg),
        optim_factory=lambda: lambda p: torch.optim.AdamW(
            p, lr=args.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1),
        loss_fn=cross_entropy_loss,
        sample_batch=np.zeros((1, args.seq), np.int64),
        strategy=["amp", "module_replace"],
        global_batch=args.global_batch, micro_batch=MAX_MICRO,
        devices=None if device is None else [device] * world)

    if int(os.environ.get("DLROVER_TPU_SLICE_ID", "-1")) >= 0:
        # slice mode: grad_step, the cross-slice mean, apply_grads
        result.trainer.split_grad_apply = True
    client = None
    if os.environ.get("DLROVER_TPU_MASTER_ADDR"):
        from dlrover_tpu_torch.agent.master_client import MasterClient

        client = MasterClient.singleton()

    loop = ElasticTrainLoop(
        result.model,
        None,                   # the optimizer lives in the trainer
        cross_entropy_loss,
        TrainLoopConfig(
            global_batch=args.global_batch,
            seq_len=args.seq,
            max_steps=args.steps,
            max_micro_per_replica=MAX_MICRO,
            checkpoint_dir=args.ckpt_dir,
            save_interval_steps=args.save_interval,
            report_interval_steps=args.report_interval,
        ),
        master_client=client,
        device=device,
        trainer=result.trainer,
    )
    loop.install_signal_handler()

    corpus = synthetic_corpus(cfg.vocab_size)
    sampler = ElasticDistributedSampler(
        dataset_size=10 ** 6, shuffle=True, seed=0)
    state, start_step = loop.restore_or_init(0, sampler)

    def log(message: str) -> None:
        print(message, flush=True)
        if args.log_file:
            with open(args.log_file, "a") as f:
                f.write(message + "\n")

    log(f"nanogpt: start_step={start_step} "
        f"dp={loop.dp} accum={loop.accum} device={loop.device} "
        f"pid={os.getpid()} source={loop.last_restore_source} "
        f"catch_up={int(loop.last_restore_timings.get('catch_up_steps', 0))}")
    if args.steps <= start_step:
        log("nanogpt: nothing to do")
        loop.close()
        return 0

    data = batches(corpus, sampler, args.global_batch, args.seq)
    loop.config.max_steps = args.steps - start_step
    state, metrics = loop.run(state, data, start_step=start_step,
                              sampler=sampler)
    final_step = int(metrics.get("step", start_step))
    digest = hashlib.sha256()
    for _, p in state.model.named_parameters():
        digest.update(p.detach().float().cpu().numpy().tobytes())
    log(f"nanogpt: done step={final_step} "
        f"loss={metrics.get('loss', -1):.4f} digest={digest.hexdigest()}")
    loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
