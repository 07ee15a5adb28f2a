"""ElasticTrainLoop on one device: the standalone subset.

Counterpart of ``dlrover_tpu/trainer/elastic_loop.py``: the loop picks
(accum, micro) to hold the global batch fixed (``choose_accumulation``),
builds the trainer, inits the state and runs steps, recording each
step's loss, wall time, tokens/s and MFU against the card's peak
(``obs/mfu.py``).

Not ported yet, and raising when configured: master reporting
(``master_client``), checkpoint and restore (``checkpoint_dir``), a mesh
(``mesh_spec``) — ROADMAP Queue A items 5 and 6. Re-planning, drain,
chaos and steptrace come with them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.obs import mfu
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
from dlrover_tpu_torch.trainer.train_step import (
    TrainState,
    build_trainer,
    choose_accumulation,
)


@dataclasses.dataclass
class TrainLoopConfig:
    global_batch: int
    seq_len: int
    max_micro_per_replica: int = 8
    max_steps: int = 0                    # 0 = until data exhausted
    report_interval_steps: int = 10
    # not ported yet: a non-empty value raises
    checkpoint_dir: str = ""
    mesh_spec: Optional[Any] = None


def model_flops_per_token(cfg, seq_len: int) -> float:
    """obs/mfu.py's accounting for a LlamaConfig: 6·params, less a gather
    embedding table with untied head (it does no matmul), plus the causal
    attention term."""
    uncounted = 0.0
    if cfg.embed_impl == "gather" and not cfg.tie_embeddings:
        uncounted = cfg.vocab_size * cfg.hidden_size
    return mfu.flops_per_token(
        cfg.param_count(), num_layers=cfg.num_layers,
        hidden_size=cfg.hidden_size, seq_len=seq_len,
        uncounted_embed_params=uncounted)


class ElasticTrainLoop:
    def __init__(
        self,
        model,
        optimizer_factory: Callable[..., torch.optim.Optimizer],
        loss_fn: Callable,
        config: TrainLoopConfig,
        master_client=None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """``model``: a built module or a ``(device=, seed=) -> module``
        factory (see ``build_trainer``). ``device`` defaults to the
        current CUDA device and raises without a GPU unless ``"cpu"``."""
        if master_client is not None:
            raise NotImplementedError(
                "master reporting is not ported yet (ROADMAP Queue A item "
                "6.1)")
        if config.checkpoint_dir:
            raise NotImplementedError(
                "checkpoint and restore are not ported yet (ROADMAP Queue "
                "A item 6.2)")
        if config.mesh_spec is not None:
            raise NotImplementedError(
                "meshes are not ported yet (ROADMAP Queue A item 5)")
        self.config = config
        self.device = resolve_device(device)
        self.dp = 1
        self.global_batch = config.global_batch
        self.accum, self.micro_global = choose_accumulation(
            config.global_batch, self.dp, config.max_micro_per_replica)
        sample = np.zeros((self.micro_global, config.seq_len), np.int64)
        self.trainer = build_trainer(
            model, optimizer_factory, sample, loss_fn,
            accum_steps=self.accum, micro_batch=self.micro_global,
            device=self.device)
        self.peak_flops = (
            mfu.peak_flops_for(torch.cuda.get_device_name(self.device))
            if self.device.type == "cuda" else 0.0)
        logger.info("elastic loop: device=%s accum=%d micro(global)=%d",
                    self.device, self.accum, self.micro_global)

    def restore_or_init(self, seed: int = 0,
                        sampler: Optional[ElasticDistributedSampler] = None
                        ) -> Tuple[TrainState, int]:
        """(state, start_step). Restoring is not ported yet: this inits
        from ``seed`` and starts at step 0; ``sampler`` keeps its
        position."""
        return self.trainer.init(seed), 0

    def run(self, state: TrainState,
            batches: Iterable[Tuple[np.ndarray, np.ndarray]],
            start_step: int = 0,
            sampler: Optional[ElasticDistributedSampler] = None
            ) -> Tuple[TrainState, Dict[str, Any]]:
        """Train on host (tokens, targets) global batches until
        ``max_steps`` or the data runs out. Each step waits for its loss,
        so its wall time is the device's. Returns the state and
        ``{"step", "loss", "history"}``, the history holding per step
        ``step, loss, grad_norm, step_time_s, tokens_per_s, mfu`` (mfu -1
        where the card's peak is unknown)."""
        cfg = state.model.config
        flops = model_flops_per_token(cfg, self.config.seq_len)
        tokens_per_step = self.global_batch * self.config.seq_len
        history = []
        step = start_step
        for tokens, targets in batches:
            if self.config.max_steps and len(history) >= self.config.max_steps:
                break
            t0 = time.monotonic()
            tok, tgt = self.trainer.shard_batch(tokens, targets)
            state, metrics = self.trainer.step(state, tok, tgt)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            step += 1
            tps = tokens_per_step / dt
            record = {"step": step, "loss": loss,
                      "grad_norm": float(metrics["grad_norm"]),
                      "step_time_s": dt, "tokens_per_s": tps,
                      "mfu": mfu.achieved_mfu(tps, flops, self.peak_flops)}
            history.append(record)
            if sampler is not None:
                sampler.record_batch(self.global_batch)
            interval = self.config.report_interval_steps
            if interval and step % interval == 0:
                logger.info("step %d loss %.4f %.1f tokens/s mfu %.4f",
                            step, loss, tps, record["mfu"])
        last = history[-1] if history else {}
        return state, {"step": step, "loss": last.get("loss", float("nan")),
                       "history": history}

    def close(self) -> None:
        """Drop the trainer (and with it the device memory it holds)."""
        self.trainer = None
