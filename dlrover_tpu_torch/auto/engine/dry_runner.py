"""Dry-run profiler: score a candidate strategy by actually training.

Counterpart of ``dlrover_tpu/auto/engine/dry_runner.py`` (after atorch's
dry runner, auto/dry_runner/dry_runner.py): lower the strategy, run
warm-up and timed steps on a synthetic batch, return steps/s, timed
between two ``torch.cuda.synchronize`` on the card. A candidate that
fails to lower or runs out of memory scores -inf instead of raising (the
search must survive bad candidates), and every candidate gives its
memory back before the next one starts: its trainer and state are
dropped, ``gc.collect()`` runs and the allocator's cache is emptied.

A kernel's build or launch error is not a bad candidate: it is raised
(``KernelBuildError``, ``KernelLaunchError``, a CUDA error other than
running out of memory), so that no search hides a broken kernel behind
the plain path.
"""

from __future__ import annotations

import copy
import gc
import os
import time
from typing import Tuple

import numpy as np
import torch

from dlrover_tpu_torch.auto.model_context import ModelContext
from dlrover_tpu_torch.auto.strategy import Strategy
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.ops._build import KernelBuildError, KernelLaunchError


def _fresh_context(context: ModelContext) -> ModelContext:
    clone = ModelContext(
        context.model,
        optim_factory=context.optim_factory,
        dataset=context.dataset,
        loss_fn=context.loss_fn,
        sample_batch=context.sample_batch,
        optim_args=context.optim_args,
        devices=context.devices,
    )
    clone.plan = copy.deepcopy(context.plan)
    return clone


def is_kernel_error(e: BaseException) -> bool:
    """A port kernel failed to build or launch, or the card reported a
    CUDA error that is not an out-of-memory."""
    if isinstance(e, (KernelBuildError, KernelLaunchError)):
        return True
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    return "CUDA error" in str(e)


def _sync(device: torch.device, metrics: dict) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    float(metrics["loss"])


def dry_run(context: ModelContext, strategy: Strategy,
            warmup: int = 0, steps: int = 0) -> Tuple[float, str]:
    """Returns (steps_per_sec, error). error == "" on success."""
    from dlrover_tpu_torch.auto.accelerate import apply_strategy, lower

    warmup = warmup or int(os.environ.get("DLROVER_TPU_DRYRUN_WARMUP", 1))
    steps = steps or int(os.environ.get("DLROVER_TPU_DRYRUN_STEPS", 3))
    trainer = state = tok = tgt = metrics = None
    try:
        clone = apply_strategy(_fresh_context(context), strategy)
        trainer = lower(clone).trainer
        state = trainer.init(0)
        sample = np.asarray(clone.infer_sample_batch(trainer.micro_batch))
        rng = np.random.default_rng(0)
        vocab_guess = int(sample.max()) + 2
        tokens = rng.integers(0, vocab_guess,
                              (trainer.accum_steps * trainer.micro_batch,)
                              + sample.shape[1:]).astype(sample.dtype)
        tok, tgt = trainer.shard_batch(tokens, tokens)
        for _ in range(max(warmup, 1)):  # ≥1: the timed steps build nothing
            state, metrics = trainer.step(state, tok, tgt)
        _sync(trainer.device, metrics)
        start = time.perf_counter()
        for _ in range(steps):
            state, metrics = trainer.step(state, tok, tgt)
        _sync(trainer.device, metrics)
        elapsed = time.perf_counter() - start
        return steps / max(elapsed, 1e-9), ""
    except Exception as e:  # noqa: BLE001 - bad candidates must not kill search
        if is_kernel_error(e):
            raise
        logger.info("dry run failed for %s: %s", [n for n, _ in strategy], e)
        return float("-inf"), str(e)
    finally:
        # the candidate's model, moments and batch go before the next one
        del trainer, state, tok, tgt, metrics
        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()
