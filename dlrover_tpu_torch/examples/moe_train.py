"""Mixture-of-experts elastic training worker: expert parallelism over the
``expert`` mesh axis.

The port's counterpart of the JAX package's ``examples/moe/train.py``,
with the same command line and defaults (and ``--device``, as the port's
other workers), the same synthetic documents, ``LlamaMoE(cfg,
deterministic=False)`` (training routing: the train capacity factor and
router jitter when configured) under Adafactor (the port's copy of
``optax.adafactor``), and the same log lines. The router aux losses ride
the trainer's generic micro-step, with no bespoke loop. Attention runs
through the flash kernels on the card and the plain path on the CPU.

Run single-host, on the card:
    python -m dlrover_tpu_torch.run --standalone \\
        dlrover_tpu_torch/examples/moe_train.py --steps 50 \\
        --ckpt-dir /tmp/moe-ckpt
and on the CPU with ``--device cpu``. The expert axis is the world's
rank count, capped so that it divides --experts, unless
--expert-shards names it; multi-node as the nanoGPT worker, one agent a
host.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

if not __package__:
    # run as a script from a checkout: the package is two levels up
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser("moe-train")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--global-batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=256)
    parser.add_argument("--experts", type=int, default=4)
    parser.add_argument("--top-k", type=int, default=2)
    parser.add_argument("--expert-shards", type=int, default=0,
                        help="expert-axis size (0 = all ranks, capped at "
                             "--experts)")
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--ckpt-dir", default="")
    parser.add_argument("--save-interval", type=int, default=20)
    parser.add_argument("--log-file", default="",
                        help="append step logs here (tests parse it)")
    return parser.parse_args(argv)


def token_batches(vocab_size, sampler, global_batch, seq):
    """Synthetic documents: per-index seeded, so a resumed sampler
    regenerates identical data."""
    batch = []
    for idx in sampler:
        rng = np.random.default_rng(idx)
        batch.append(
            rng.integers(0, vocab_size, seq + 1).astype(np.int32))
        if len(batch) == global_batch:
            chunk = np.stack(batch)
            batch = []
            yield chunk[:, :-1], chunk[:, 1:]


def main(argv=None) -> int:
    args = parse_args(argv)
    device = "cpu" if args.device == "cpu" else None

    import torch.distributed as dist

    from dlrover_tpu_torch.agent.elastic_agent import init_distributed
    from dlrover_tpu_torch.models.llama import cross_entropy_loss
    from dlrover_tpu_torch.models.llama_moe import LlamaMoE, LlamaMoEConfig
    from dlrover_tpu_torch.optim import LeafOptimizer, adafactor
    from dlrover_tpu_torch.parallel.mesh import MeshSpec
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

    init_distributed(device)   # joins the round's process group

    if args.hidden < 64 or args.hidden % 64:
        raise SystemExit(
            f"--hidden {args.hidden} must be a multiple of 64 "
            f"(64-dim attention heads)")
    if args.expert_shards:
        expert_shards = args.expert_shards
        if args.experts % expert_shards:
            raise SystemExit(
                f"--experts {args.experts} must divide by expert "
                f"shards {expert_shards}")
    else:
        # auto: the largest rank count that divides the expert count
        # (the analyser's own sizing policy, auto/engine/analyser.py)
        n_dev = dist.get_world_size() if dist.is_initialized() else 1
        expert_shards = max(
            d for d in range(1, n_dev + 1) if args.experts % d == 0)
    cfg = LlamaMoEConfig(
        vocab_size=1024, hidden_size=args.hidden,
        num_layers=args.layers, num_heads=args.hidden // 64,
        num_kv_heads=args.hidden // 64,
        intermediate_size=args.hidden * 2,
        max_seq_len=args.seq,
        num_experts=args.experts, top_k=args.top_k,
        attn_impl="reference" if device == "cpu" else "flash",
    )

    client = None
    if os.environ.get("DLROVER_TPU_MASTER_ADDR"):
        from dlrover_tpu_torch.agent.master_client import MasterClient

        client = MasterClient.singleton()

    loop = ElasticTrainLoop(
        # deterministic=False = TRAINING routing semantics (train
        # capacity factor + router jitter when configured); the trainer
        # supplies the per-step gating seed
        functools.partial(LlamaMoE, cfg, deterministic=False),
        functools.partial(LeafOptimizer, transform=adafactor(args.lr)),
        cross_entropy_loss,
        TrainLoopConfig(
            global_batch=args.global_batch,
            seq_len=args.seq,
            max_steps=args.steps,
            checkpoint_dir=args.ckpt_dir,
            save_interval_steps=args.save_interval,
            report_interval_steps=10,
            mesh_spec=MeshSpec(expert=expert_shards),
        ),
        master_client=client,
        device=device,
    )
    loop.install_signal_handler()

    sampler = ElasticDistributedSampler(
        dataset_size=10 ** 6, shuffle=True, seed=0)
    state, start_step = loop.restore_or_init(0, sampler)

    def log(message: str) -> None:
        print(message, flush=True)
        if args.log_file:
            with open(args.log_file, "a") as f:
                f.write(message + "\n")

    active = cfg.active_param_count() / 1e6
    total = cfg.param_count() / 1e6
    log(f"moe: start_step={start_step} experts={args.experts} "
        f"expert_shards={expert_shards} params={total:.1f}M "
        f"active={active:.1f}M backend={loop.device.type}")
    if args.steps <= start_step:
        log("moe: nothing to do")
        loop.close()
        return 0

    data = token_batches(cfg.vocab_size, sampler, args.global_batch,
                         args.seq)
    loop.config.max_steps = args.steps - start_step
    state, metrics = loop.run(state, data, start_step=start_step,
                              sampler=sampler)
    final_step = int(metrics.get("step", start_step))
    log(f"moe: done step={final_step} "
        f"loss={metrics.get('loss', -1):.4f}")
    loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
