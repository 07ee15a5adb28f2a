"""ElasticTrainLoop: the worker's training loop.

Counterpart of ``dlrover_tpu/trainer/elastic_loop.py``: the loop builds
the mesh over the live world (``parallel/mesh.py``), picks (accum,
micro) to hold the global batch fixed as the world resizes
(``choose_accumulation``), builds the sharded trainer, restores the
newest checkpoint onto THIS mesh (resharding as needed) or inits, and
runs steps, recording each step's loss, wall time, tokens/s and MFU
against the cards' peak (``obs/mfu.py``). It saves a flash checkpoint
at interval boundaries and, on a stop request (SIGTERM from the agent
before a membership change), finishes the step, force-saves and stops,
so a resized world resumes from the last committed step with its data
position.

Not ported yet: master reporting (``master_client`` raises; ROADMAP
Queue A item 6.1), peer restore (6.2), the shard plan and re-planning
(6.3), slice mode (6.4), drain requests, chaos and steptrace (6.5).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint.flash_checkpoint import FlashCheckpointer
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.obs import mfu
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh, dp_size
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
    checkpoint_dir: str = ""
    save_interval_steps: int = 100
    # 8/4 = groupwise int-quantized parameters (~4x fewer parameter
    # bytes; see checkpoint/quantized.py); 0 = exact dtypes
    checkpoint_quantize_bits: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "DLROVER_TPU_CKPT_QUANT_BITS", "0")))
    report_interval_steps: int = 10
    mesh_spec: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    rules: Optional[Any] = None
    # build the step's CUDA kernels concurrently with the checkpoint read
    # (restore pays max(read, build) instead of their sum)
    overlap_restore_compile: bool = True


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
        current CUDA device and raises without a GPU unless ``"cpu"``.
        The world is the initialized process group's (``agent/
        elastic_agent.py::init_distributed``), or this process alone."""
        if master_client is not None:
            raise NotImplementedError(
                "master reporting is not ported yet (ROADMAP Queue A item "
                "6.1)")
        self.config = config
        self.mesh = create_mesh(config.mesh_spec, device)
        self.device = self.mesh.device
        self.dp = dp_size(self.mesh)
        self.global_batch = config.global_batch
        self.accum, self.micro_global = choose_accumulation(
            config.global_batch, self.dp, config.max_micro_per_replica)
        sample = np.zeros((self.micro_global, config.seq_len), np.int64)
        self.trainer = build_trainer(
            model, optimizer_factory, self.mesh, sample, loss_fn,
            accum_steps=self.accum, micro_batch=self.micro_global,
            rules=config.rules)
        self.checkpointer = (
            FlashCheckpointer(config.checkpoint_dir,
                              config.save_interval_steps,
                              quantize_bits=config.checkpoint_quantize_bits)
            if config.checkpoint_dir else None)
        self._stop_requested = threading.Event()
        self._prev_sigterm = None
        self.last_restore_timings: Dict[str, float] = {}
        # where the last restore's state came from: "checkpoint" or "init"
        self.last_restore_source = ""
        cards = self.mesh.spec.total
        self.peak_flops = (
            mfu.peak_flops_for(torch.cuda.get_device_name(self.device))
            * cards if self.device.type == "cuda" else 0.0)
        logger.info("elastic loop: device=%s dp=%d accum=%d "
                    "micro(global)=%d mesh=%s", self.device, self.dp,
                    self.accum, self.micro_global, self.mesh.shape)

    # -- signals -----------------------------------------------------------
    def install_signal_handler(self) -> None:
        """SIGTERM (the agent's restart) → finish the step, force-save,
        stop."""

        def _handler(signum, frame):
            logger.info("SIGTERM: will checkpoint and stop after this step")
            self._stop_requested.set()

        self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)

    # -- restore -----------------------------------------------------------
    def restore_or_init(self, seed: int = 0,
                        sampler: Optional[ElasticDistributedSampler] = None
                        ) -> Tuple[TrainState, int]:
        """Restore the latest checkpoint onto THIS mesh (resharding as
        needed) or initialize from ``seed``. Returns (state, start_step).

        The restore target is the trainer's abstract state (storage
        without initialization), so a resume never holds two copies of
        the parameters and moments. While the checkpoint is read, the
        step's kernels are built in a background thread. Per-phase wall
        times land in ``last_restore_timings``."""
        timings: Dict[str, float] = {}
        self.last_restore_timings = timings
        build_thread = None
        if self.config.overlap_restore_compile:
            build_thread = threading.Thread(target=self._precompile_quietly,
                                            daemon=True)
            t_build = time.monotonic()
            build_thread.start()
        state, step = None, 0
        # no committed step: init at once, without a restore target
        if self.checkpointer is not None and self.checkpointer.all_steps():
            t0 = time.monotonic()
            abstract = self.trainer.abstract_state()
            timings["abstract_state_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            restored = self.checkpointer.restore(abstract)
            timings["dcp_read_s"] = time.monotonic() - t0
            for key, value in self.checkpointer.last_restore_phases.items():
                timings[f"restore_{key}"] = value
            if restored is not None:
                state, data_state, step = restored
                t0 = time.monotonic()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                timings["device_ready_s"] = time.monotonic() - t0
                t0 = time.monotonic()
                if sampler is not None and "sampler" in data_state:
                    sampler.load_state_dict(data_state["sampler"])
                timings["post_sync_s"] = time.monotonic() - t0
            del abstract
        self.last_restore_source = "init" if state is None else "checkpoint"
        if state is None:
            state = self.trainer.init(seed)
        if build_thread is not None:
            t0 = time.monotonic()
            build_thread.join()
            timings["compile_wait_after_read_s"] = time.monotonic() - t0
            timings["compile_total_s"] = time.monotonic() - t_build
            timings.update(self.trainer.precompile_timings)
        if timings:
            logger.info("restore timings: %s", timings)
        return state, step

    def _precompile_quietly(self) -> None:
        try:
            self.trainer.precompile()
        except Exception:  # noqa: BLE001 — the first step builds anyway
            logger.warning("kernel precompile failed; the first step will "
                           "build inline", exc_info=True)

    # -- main loop ---------------------------------------------------------
    def run(self, state: TrainState,
            batches: Iterable[Tuple[np.ndarray, np.ndarray]],
            start_step: int = 0,
            sampler: Optional[ElasticDistributedSampler] = None
            ) -> Tuple[TrainState, Dict[str, Any]]:
        """Train on host (tokens, targets) global batches until
        ``max_steps`` steps have run, a stop is requested or the data runs
        out. Each step waits for its loss, so its wall time is the
        device's. Saves at interval boundaries, force-saves on a stop
        request, and waits for the last save's commit before returning.
        Returns the state and ``{"step", "loss", "history"}``: the step
        reached, and per step ``step, loss, grad_norm, step_time_s,
        tokens_per_s, mfu`` (mfu -1 where the card's peak is unknown) and
        ``checkpoint_s`` (the save's blocking part, 0 without one)."""
        cfg = state.model.config
        flops = model_flops_per_token(cfg, self.config.seq_len)
        tokens_per_step = self.global_batch * self.config.seq_len
        history = []
        step = start_step
        for tokens, targets in batches:
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
                      "mfu": mfu.achieved_mfu(tps, flops, self.peak_flops),
                      "checkpoint_s": 0.0}
            history.append(record)
            if sampler is not None:
                sampler.record_batch(self.global_batch)
            if self.checkpointer is not None:
                t0 = time.monotonic()
                self.checkpointer.maybe_save(
                    step, state, self._data_state(sampler),
                    force=self._stop_requested.is_set())
                record["checkpoint_s"] = time.monotonic() - t0
            interval = self.config.report_interval_steps
            if interval and step % interval == 0:
                logger.info("step %d loss %.4f %.1f tokens/s mfu %.4f",
                            step, loss, tps, record["mfu"])
            if self._stop_requested.is_set():
                logger.info("stopping at step %d on request", step)
                break
            if self.config.max_steps and len(history) >= self.config.max_steps:
                break
        if self.checkpointer is not None:
            self.checkpointer.wait()
        last = history[-1] if history else {}
        return state, {"step": step, "loss": last.get("loss", float("nan")),
                       "history": history}

    def _data_state(self, sampler) -> Dict[str, Any]:
        return {"sampler": sampler.state_dict()} if sampler is not None \
            else {}

    def close(self) -> None:
        """Wait for the last save, restore the SIGTERM handler and drop
        the trainer (and with it the device memory it holds)."""
        if self.checkpointer is not None:
            self.checkpointer.close()
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None
        self.trainer = None
