"""Streaming per-layer training example: a model whose gradients do not
fit one card beside its weights, through the elastic CLI.

The port's counterpart of the JAX package's
``examples/streaming/train.py``, with the same command line and batches:
``auto_accelerate`` lowers ``["half", ("streaming", {})]`` to the
per-layer streaming trainer (``trainer/streaming.py``), whose backward
runs as a reverse per-layer loop applying a per-leaf optimizer
(factored RMS here, ``optim.factored_rms``) in place, so the peak is the
weights plus one layer's gradients. Attention runs through the flash
kernels on the card and the plain path on the CPU.

Run on one host (the streaming trainer is one device's by design):
    python -m dlrover_tpu_torch.run --standalone \\
        dlrover_tpu_torch/examples/streaming_train.py --steps 50 \\
        --ckpt-dir /tmp/streaming-ckpt
and on the CPU, with ``--device cpu`` after the script.

Elastic restart, checkpoint and sampler resume and the step reports
apply unchanged: the streaming trainer has the dense trainer's surface,
so ``ElasticTrainLoop`` drives it as an injected trainer.
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
    parser = argparse.ArgumentParser("streaming-train")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch", type=int, default=2,
                        help="micro batch == global batch (streaming "
                             "does not gradient-accumulate)")
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--hidden", type=int, default=128)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--ckpt-dir", default="")
    parser.add_argument("--save-interval", type=int, default=20)
    parser.add_argument("--log-file", default="",
                        help="append step logs here (tests parse it)")
    return parser.parse_args(argv)


def token_batches(vocab_size, sampler, batch_size, seq):
    """Synthetic documents, seeded by their index, so a resumed sampler
    makes the same data (the JAX example's)."""
    batch = []
    for idx in sampler:
        rng = np.random.default_rng(idx)
        batch.append(rng.integers(0, vocab_size, seq + 1).astype(np.int32))
        if len(batch) == batch_size:
            chunk = np.stack(batch)
            batch = []
            yield chunk[:, :-1], chunk[:, 1:]


def main(argv=None) -> int:
    args = parse_args(argv)
    device = "cpu" if args.device == "cpu" else None

    from dlrover_tpu_torch.agent.elastic_agent import init_distributed
    from dlrover_tpu_torch.auto import auto_accelerate
    from dlrover_tpu_torch.models.llama import (
        Llama,
        LlamaConfig,
        cross_entropy_loss,
    )
    from dlrover_tpu_torch.optim import factored_rms
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

    init_distributed(device)
    if args.hidden < 64 or args.hidden % 64:
        raise SystemExit(f"--hidden {args.hidden} must be a multiple of 64 "
                         f"(64-dim attention heads)")
    cfg = LlamaConfig(
        vocab_size=1024, hidden_size=args.hidden,
        num_layers=args.layers, num_heads=args.hidden // 64,
        num_kv_heads=args.hidden // 64,
        intermediate_size=args.hidden * 2,
        max_seq_len=args.seq,
        tie_embeddings=False,
        attn_impl="reference" if device == "cpu" else "flash",
    )

    result = auto_accelerate(
        functools.partial(Llama, cfg),
        optim_factory=lambda: factored_rms(args.lr),
        loss_fn=cross_entropy_loss,
        sample_batch=np.zeros((args.batch, args.seq), np.int64),
        strategy=["half", ("streaming", {})],
        micro_batch=args.batch,
        devices=None if device is None else [device],
    )

    client = None
    if os.environ.get("DLROVER_TPU_MASTER_ADDR"):
        from dlrover_tpu_torch.agent.master_client import MasterClient

        client = MasterClient.singleton()

    loop = ElasticTrainLoop(
        result.model,
        None,                  # the optimizer lives in the trainer
        cross_entropy_loss,
        TrainLoopConfig(
            global_batch=args.batch,
            seq_len=args.seq,
            max_steps=args.steps,
            checkpoint_dir=args.ckpt_dir,
            save_interval_steps=args.save_interval,
            report_interval_steps=10,
        ),
        master_client=client,
        device=device,
        trainer=result.trainer,
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

    log(f"streaming: start_step={start_step} "
        f"params={cfg.param_count() / 1e6:.1f}M device={loop.device}")
    if args.steps <= start_step:
        log("streaming: nothing to do")
        loop.close()
        return 0

    data = token_batches(cfg.vocab_size, sampler, args.batch, args.seq)
    loop.config.max_steps = args.steps - start_step
    state, metrics = loop.run(state, data, start_step=start_step,
                              sampler=sampler)
    final_step = int(metrics.get("step", start_step))
    log(f"streaming: done step={final_step} "
        f"loss={metrics.get('loss', -1):.4f}")
    loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
