"""Flash checkpoint: async sharded save/restore + data position.

Counterpart of ``dlrover_tpu/checkpoint/flash_checkpoint.py`` over
``torch.distributed.checkpoint`` (DCP) instead of Orbax:

- **Async save**: ``dcp.async_save`` stages the state to host memory
  (the only part the training loop waits for) and writes it from a
  background thread; each rank writes its own shards.
- **Commit marker**: a step is written under ``<step>.tmp`` and renamed
  to ``<step>`` only once every rank's shards, DCP's metadata and the
  data item are on disk, so a directory named by a step number is a
  committed one, and a torn save is never mistaken for one.
- **Reshard-on-restore**: the restore target is the NEW world's state
  (``Trainer.abstract_state``), and DCP reads each saved shard into the
  target's placements, whatever world size wrote it.
- **Data position**: a JSON item (``data.json``: the sampler's
  ``state_dict``, the quantization marker and layout) committed with the
  step, so a restored job resumes mid-epoch.
- **Quantized payloads** (``quantize_bits`` 8 or 4): the parameters, and
  only they, are stored through ``checkpoint/quantized.py``; the
  optimizer's moments stay exact (int8 second moments wreck the resumed
  update: sqrt(nu) denominators amplify the groupwise error).

Obs counters and spans (the JAX package's ``obs`` registry) wait for the
port of ``obs/``; the restore's phases land in ``last_restore_phases``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.state_dict import (
    get_state_dict,
    set_optimizer_state_dict,
)
from dlrover_tpu_torch.checkpoint.quantized import (
    abstract_encoded,
    decode_tree,
    encode_tree,
)
from dlrover_tpu_torch.common.constants import EMERGENCY_CKPT_MIN_WINDOW_S
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.sharding import to_local

_DATA_FILE = "data.json"
_TMP_SUFFIX = ".tmp"
# data-item key marking a quantized state payload (and its bit width)
_QUANT_KEY = "_ckpt_quantized_bits"
# which subtree was encoded: always "params" here (the model's state)
_QUANT_LAYOUT_KEY = "_ckpt_quantized_layout"


def _sync(tensor_device: torch.device) -> None:
    if tensor_device.type == "cuda":
        torch.cuda.synchronize(tensor_device)


class FlashCheckpointer:
    """Interval + on-demand async checkpointing of (TrainState, data
    state). One instance per training process, created at the same
    point on every rank; all ranks take part in each save and restore
    (each writes and reads its own shards), rank 0 commits."""

    def __init__(
        self,
        directory: str,
        save_interval_steps: int = 100,
        max_to_keep: int = 3,
        quantize_bits: int = 0,
    ):
        """quantize_bits: 8 or 4 stores the parameters groupwise
        int-quantized (``checkpoint/quantized.py``); 0 stores exact
        dtypes. Restores detect how a step was written."""
        if quantize_bits not in (0, 4, 8):
            raise ValueError(f"checkpoint quantization bits must be 0, 4 "
                             f"or 8, got {quantize_bits}")
        self.directory = str(directory)
        # 0 = interval saves off (forced saves still run)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        self.quantize_bits = quantize_bits
        os.makedirs(self.directory, exist_ok=True)
        world = dist.get_world_size() if dist.is_initialized() else 1
        self._rank = dist.get_rank() if world > 1 else 0
        # the background writer runs DCP's collectives while the training
        # loop runs its own: they must not share a group
        self._pg = dist.new_group(backend="gloo") if world > 1 else None
        self._lock = threading.Lock()
        self._committer = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="ckpt-commit")
        self._pending: Optional[concurrent.futures.Future] = None
        self._pending_step: Optional[int] = None
        # wall time of the last full (staging + commit) save, the
        # emergency path's estimate of whether a deadline is winnable;
        # 0 = no evidence yet (guarded by _lock)
        self._last_full_save_s = 0.0
        # the last save's blocking (staging) and commit seconds and bytes
        self.last_save: Dict[str, float] = {}
        # per-phase breakdown of the last successful restore; written
        # only by the restoring thread, read after restore() returns
        self.last_restore_phases: Dict[str, float] = {}

    # -- steps on disk -----------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """Committed steps, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isdir(os.path.join(self.directory, name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _barrier(self) -> None:
        if self._pg is not None:
            dist.barrier(group=self._pg)

    # -- save --------------------------------------------------------------
    def maybe_save(self, step: int, state, data_state: Optional[
            Dict[str, Any]] = None, force: bool = False) -> bool:
        """Save if at an interval boundary (or ``force``: a stop request,
        a preemption notice). Returns whether a save started; a step
        already committed is not written again."""
        if not force and (self.save_interval_steps <= 0
                          or step % self.save_interval_steps != 0
                          or step == 0):
            return False
        # one background save at a time: a second async_save while one
        # is in flight would interleave their collectives and files
        self._wait_pending()
        if step in self.all_steps():
            return False
        data_state = dict(data_state or {})
        t0 = time.monotonic()
        model_sd, optim_sd = get_state_dict(state.model, state.optimizer)
        if self.quantize_bits:
            model_sd = encode_tree(model_sd, self.quantize_bits)
            data_state[_QUANT_KEY] = self.quantize_bits
            data_state[_QUANT_LAYOUT_KEY] = "params"
        tmp = self._step_dir(step) + _TMP_SUFFIX
        if self._rank == 0 and os.path.exists(tmp):
            shutil.rmtree(tmp)             # a torn save of an earlier run
        self._barrier()
        future = dcp.async_save({"model": model_sd, "optim": optim_sd},
                                checkpoint_id=tmp, process_group=self._pg)
        blocking_s = time.monotonic() - t0
        self.last_save = {"step": step, "blocking_s": blocking_s}
        self._pending_step = step
        self._pending = self._committer.submit(
            self._commit, future, step, tmp, data_state, t0)
        logger.info("flash checkpoint: async save started at step %d "
                    "(%.3f s staging)", step, blocking_s)
        return True

    def _commit(self, future, step: int, tmp: str,
                data_state: Dict[str, Any], t0: float) -> None:
        """The background half of a save: wait for DCP's write, then (on
        rank 0) write the data item, rename the step into place and drop
        the steps past ``max_to_keep``."""
        future.result()
        if self._rank == 0:
            path = os.path.join(tmp, _DATA_FILE)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(data_state, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._step_dir(step))
            if self.max_to_keep > 0:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
        elapsed = time.monotonic() - t0
        with self._lock:
            self._last_full_save_s = elapsed
        self.last_save["commit_s"] = elapsed
        logger.info("flash checkpoint: step %d committed in %.1f s", step,
                    elapsed)

    def _wait_pending(self, timeout: Optional[float] = None) -> None:
        if self._pending is not None:
            self._pending.result(timeout)
            self._pending = self._pending_step = None

    def wait(self) -> None:
        """Block until the in-flight save is committed on every rank."""
        self._wait_pending()
        self._barrier()

    def save_emergency(self, step: int, state,
                       data_state: Optional[Dict[str, Any]] = None,
                       deadline: float = 0.0,
                       min_window_s: Optional[float] = None) -> str:
        """Deadline-bounded save on the way out (preemption drain): the
        machine disappears at ``deadline`` (unix time; 0 = none), so the
        save must commit before then or not start at all. Returns:

        - ``"saved"``: dispatched and committed inside the window;
        - ``"skipped"``: the window is below ``min_window_s`` or the last
          full save's wall time; a save that cannot commit would only
          leave a torn step to walk past;
        - ``"timeout"``: dispatched, but the commit did not finish in
          time; the step is left uncommitted (``<step>.tmp``);
        - ``"noop"``: nothing dispatched.
        """
        if min_window_s is None:
            min_window_s = EMERGENCY_CKPT_MIN_WINDOW_S
        remaining = deadline - time.time() if deadline > 0 else float("inf")
        with self._lock:
            estimate = self._last_full_save_s
        if remaining < max(min_window_s, estimate):
            logger.error(
                "emergency checkpoint at step %d SKIPPED: %.1fs left before "
                "the deadline (< floor %.1fs / last full save %.1fs); resume "
                "will fall back to the last committed step", step,
                remaining, min_window_s, estimate)
            return "skipped"
        t0 = time.monotonic()
        # an interval save of this very step may be in flight or done (a
        # drain landing on a boundary): await it instead of saving twice
        in_flight = step in (self._pending_step, self.latest_step())
        dispatched = False if in_flight else self.maybe_save(
            step, state, data_state, force=True)
        if not (in_flight or dispatched):
            return "noop"
        budget = (max(0.5, deadline - time.time() - 0.5)
                  if deadline > 0 else None)
        try:
            self._wait_pending(budget)
        except concurrent.futures.TimeoutError:
            logger.error("emergency checkpoint at step %d: commit still "
                         "running at the deadline; the step may be torn "
                         "(restore falls back past it)", step)
            return "timeout"
        if dispatched:
            with self._lock:
                self._last_full_save_s = time.monotonic() - t0
        logger.info("emergency checkpoint committed at step %d (%.1fs "
                    "window)", step, remaining)
        return "saved"

    # -- restore -----------------------------------------------------------
    def restore(self, target) -> Optional[Tuple[Any, Dict[str, Any], int]]:
        """Restore the newest restorable step INTO ``target`` (a
        TrainState laid out for the current world: reshard-on-restore).
        Returns (state, data_state, step), or None when no step exists.

        A corrupt or partial newest step is logged loudly and the next
        older one is tried; the steps it skipped are removed (the resumed
        run reaches those numbers again and must be able to save them).
        Only when every step fails does the newest step's error
        propagate: silently starting over would throw away the job's
        progress."""
        self.last_restore_phases = {}
        t0 = time.monotonic()
        self._remove_torn_saves()
        steps = sorted(self.all_steps(), reverse=True)
        discovery_s = time.monotonic() - t0
        if not steps:
            return None
        first_exc: Optional[BaseException] = None
        failed = []
        for step in steps:
            try:
                result = self._restore_at(step, target)
            # DCP's raise varies, and its CheckpointException (a failed
            # read on any rank) derives from BaseException
            except (Exception, dcp.CheckpointException) as e:  # noqa: BLE001
                first_exc = first_exc if first_exc is not None else e
                failed.append(step)
                logger.error("checkpoint restore at step %d FAILED (%s: %s);"
                             " falling back to the next-older step", step,
                             type(e).__name__, e)
                continue
            if failed:
                self._remove_failed_steps(failed)
            self.last_restore_phases["step_discovery_s"] = discovery_s
            self._restore_stats(step)
            return result
        raise first_exc

    def restore_step(self, step: int, target
                     ) -> Tuple[Any, Dict[str, Any], int]:
        """Restore one committed step, with no fallback."""
        self.last_restore_phases = {}
        return self._restore_at(step, target)

    def restore_data_state(self, step: int) -> Optional[Dict[str, Any]]:
        """The JSON data item of one committed step, markers stripped;
        None when it is unreadable."""
        try:
            data = self._read_data(step)
        except (OSError, ValueError):
            return None
        data.pop(_QUANT_KEY, None)
        data.pop(_QUANT_LAYOUT_KEY, None)
        return data

    def _read_data(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._step_dir(step), _DATA_FILE),
                  encoding="utf-8") as f:
            return dict(json.load(f))

    def _restore_at(self, step: int, target
                    ) -> Tuple[Any, Dict[str, Any], int]:
        phases = self.last_restore_phases
        device = next(target.model.parameters()).device
        # the small data item first: it says how the state was encoded
        t0 = time.monotonic()
        data = self._read_data(step)
        phases["metadata_read_s"] = time.monotonic() - t0
        bits = int(data.pop(_QUANT_KEY, 0))
        layout = data.pop(_QUANT_LAYOUT_KEY, "params" if bits else "")
        if bits and layout != "params":
            raise ValueError(f"checkpoint step {step}: quantized layout "
                             f"{layout!r} is not the port's ('params')")
        # the target's own tensors: DCP reads into them in place (the
        # optimizer's state must exist, see Trainer.abstract_state)
        model_sd, optim_sd = get_state_dict(target.model, target.optimizer)
        load_model = (abstract_encoded(model_sd, bits) if bits
                      else model_sd)
        t_read = time.monotonic()
        dcp.load({"model": load_model, "optim": optim_sd},
                 checkpoint_id=self._step_dir(step), process_group=self._pg)
        _sync(device)
        phases["tensor_read_s"] = time.monotonic() - t_read
        if bits:
            t_decode = time.monotonic()
            for name, value in decode_tree(load_model, model_sd,
                                           bits).items():
                if value is not model_sd[name]:
                    to_local(model_sd[name]).copy_(to_local(value))
            _sync(device)
            phases["decode_s"] = time.monotonic() - t_decode
        set_optimizer_state_dict(target.model, target.optimizer, optim_sd)
        target.step = step
        logger.info("flash checkpoint: restored step %d%s", step,
                    f" (int{bits} quantized)" if bits else "")
        return target, data, step

    def _restore_stats(self, step: int) -> None:
        """Bytes of the restored step and the tensor read's rate."""
        phases = self.last_restore_phases
        total = 0
        for root, _, files in os.walk(self._step_dir(step)):
            total += sum(os.path.getsize(os.path.join(root, name))
                         for name in files)
        phases["restored_bytes"] = float(total)
        read_s = phases.get("tensor_read_s", 0.0)
        if read_s > 0 and total:
            phases["read_bandwidth_mbps"] = total / (1 << 20) / read_s

    def _remove_torn_saves(self) -> None:
        """Drop ``<step>.tmp`` directories: saves a killed process never
        committed. A restore never reads them; removing them frees their
        bytes before the resumed run writes those steps again."""
        torn = [name for name in os.listdir(self.directory)
                if name.endswith(_TMP_SUFFIX)]
        if self._rank == 0:
            for name in torn:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
                logger.warning("checkpoint: removed uncommitted save %s",
                               name)
        self._barrier()

    def _remove_failed_steps(self, steps) -> None:
        """Drop the corrupt newer steps a fallback skipped: the resumed
        trainer reaches those step numbers again and would find them
        taken."""
        if self._rank == 0:
            for step in steps:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)
                logger.warning("checkpoint: removed unrestorable step %d "
                               "(resumed training will rewrite it)", step)
        self._barrier()

    # -- lifetime ----------------------------------------------------------
    def close(self) -> None:
        self.wait()
        self._committer.shutdown(wait=True)

    def __enter__(self) -> "FlashCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
