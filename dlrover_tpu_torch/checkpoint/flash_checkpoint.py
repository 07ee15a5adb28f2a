"""Flash checkpoint: async sharded save/restore + data position.

Counterpart of ``dlrover_tpu/checkpoint/flash_checkpoint.py`` over
``torch.distributed.checkpoint`` (DCP) instead of Orbax:

- **Async save**: the state is copied into host buffers allocated by
  the first save and kept across saves (page-locked on the card's host,
  in 1 GiB arenas; the allocation is timed apart), by ``non_blocking``
  copies on a side stream and one event; that copy (and the first
  save's allocation) is the only part the training loop waits for. DCP
  writes
  those buffers from a background thread (its stager hands them on
  untouched); each rank writes its own shards, four files at once. The peer cache
  (``checkpoint/peer_restore.py``) stages the same buffers, so the next
  save waits for both readers before it overwrites them.
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

The blocking part of the last save, by piece, lands in ``last_save``;
the restore's phases in ``last_restore_phases``. The spans and counters
are the JAX checkpointer's, under its names: ``checkpoint_save`` (the
blocking part), ``emergency_checkpoint`` (a drain's save and its commit
wait), ``checkpoint_restore`` (one step's read); saves, emergency saves
by outcome, restores and fallbacks counted, and the restored bytes and
read rate as gauges.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import FileSystemWriter
from torch.distributed.checkpoint.staging import AsyncStager
from torch.distributed.checkpoint.state_dict import (
    get_state_dict,
    set_optimizer_state_dict,
)
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch.checkpoint.peer_restore import shard_items
from dlrover_tpu_torch.checkpoint.quantized import (
    abstract_encoded,
    decode_tree,
    encode_tree,
)
from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.constants import EMERGENCY_CKPT_MIN_WINDOW_S
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel.sharding import to_local

_DATA_FILE = "data.json"
# files each rank's commit writes at once (DCP splits the items among
# them by size): one writer moves well under a core's memory rate, and
# the trainer keeps the other cores
_WRITER_THREADS = 4
_TMP_SUFFIX = ".tmp"
# data-item key marking a quantized state payload (and its bit width)
_QUANT_KEY = "_ckpt_quantized_bits"
# which subtree was encoded: always "params" here (the model's state)
_QUANT_LAYOUT_KEY = "_ckpt_quantized_layout"


def _sync(tensor_device: torch.device) -> None:
    if tensor_device.type == "cuda":
        torch.cuda.synchronize(tensor_device)


def _join(prefix: str, key) -> str:
    return f"{prefix}.{key}" if prefix else str(key)


def _select(tree: Any, keys, prefix: str = "") -> Any:
    """The part of a nested state dict under the flat ``keys`` (a key
    naming a subtree keeps all of it); None when nothing is kept."""
    if prefix in keys:
        return tree
    if not isinstance(tree, dict):
        return None
    out = {}
    for key, value in tree.items():
        kept = _select(value, keys, _join(prefix, key))
        if kept is not None:
            out[key] = kept
    return out or None


class _PreStaged(AsyncStager):
    """DCP's stager for a state dict already in host buffers: handed on
    as it is (DCP's default stager would copy it again)."""

    _synchronize_after_execute = False

    def stage(self, state_dict):
        return state_dict


class HostStage:
    """Host buffers for a state dict's tensors, one per flat key, each
    the shape and dtype of its tensor's local shard. They are allocated
    once (when a key is new or its shape changed) and reused by every
    later save: page-locked memory in arenas of 1 GiB (the last one the
    power of two that holds the rest) when the state is on the card (the
    host allocator rounds a request up to a power of two, so each arena
    is exactly one), plain memory for a CPU state. Each
    buffer owns its storage (a DCP writer copies a tensor that shares a
    larger one)."""

    ARENA = 1 << 30
    _ALIGN = 512

    def __init__(self, pin: bool):
        self.pin = pin
        self._buffers: Dict[str, torch.Tensor] = {}
        self._arenas: List[Any] = []
        # the arena leaves are packed into, its size and its bytes used
        self._open, self._cap, self._used = -1, 0, 0
        self._stream = None
        self.nbytes = 0                  # bytes held by the arenas

    def _arena(self, nbytes: int):
        return torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=self.pin).numpy()

    def buffers(self, items: List[Tuple[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
        """The host buffer of each (key, tensor), allocated if missing
        (the new leaves packed into new arenas)."""
        missing = []
        for key, leaf in items:
            local = to_local(leaf)
            buf = self._buffers.get(key)
            if (buf is None or buf.shape != local.shape
                    or buf.dtype != local.dtype):
                missing.append((key, local))
        if missing:
            self._place(missing)
        return {key: self._buffers[key] for key, _ in items}

    def _place(self, missing) -> None:
        """Buffers for (key, local tensor) pairs."""
        def aligned(local) -> int:
            nbytes = local.numel() * local.element_size()
            return -(-nbytes // self._ALIGN) * self._ALIGN

        # the bytes still to pack: an arena opened for the last of them
        # is the power of two that holds them, not a whole ARENA
        remaining = sum(aligned(local) for _, local in missing
                        if aligned(local) <= self.ARENA)
        sizes, spots = [], []   # new arenas' sizes; (arena, offset) a leaf
        for _, local in missing:
            nbytes, need = local.numel() * local.element_size(), aligned(local)
            if nbytes == 0:
                spots.append(None)
            elif need > self.ARENA:
                sizes.append(nbytes)
                spots.append((len(self._arenas) + len(sizes) - 1, 0))
            else:
                if self._used + need > self._cap:
                    self._cap = min(self.ARENA,
                                    1 << (remaining - 1).bit_length())
                    sizes.append(self._cap)
                    self._used = 0
                    self._open = len(self._arenas) + len(sizes) - 1
                spots.append((self._open, self._used))
                self._used += need
                remaining -= need
        self._arenas.extend(self._arena(size) for size in sizes)
        self.nbytes += sum(sizes)
        for (key, local), spot in zip(missing, spots):
            if spot is None:
                buf = torch.empty(local.shape, dtype=local.dtype)
            else:
                arena, offset = spot
                nbytes = local.numel() * local.element_size()
                buf = torch.frombuffer(
                    self._arenas[arena][offset:offset + nbytes],
                    dtype=local.dtype).reshape(local.shape)
            self._buffers[key] = buf

    def copy(self, pairs: List[Tuple[torch.Tensor, torch.Tensor]],
             device: torch.device) -> None:
        """(source, host buffer) pairs: copies issued ``non_blocking`` on
        a side stream after the work queued so far, then one event
        waited on."""
        if device.type != "cuda":
            for src, dst in pairs:
                dst.copy_(src)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            for src, dst in pairs:
                dst.copy_(src, non_blocking=True)
            done = self._stream.record_event()
        done.synchronize()


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
        peer_store=None,
    ):
        """quantize_bits: 8 or 4 stores the parameters groupwise
        int-quantized (``checkpoint/quantized.py``); 0 stores exact
        dtypes. Restores detect how a step was written.

        ``peer_store``: the ``PeerStateStore`` that stages this
        checkpointer's host buffers after each save (the loop's
        ``_stage_peer``). A save waits for its deferred write before it
        overwrites them, and with ``quantize_bits`` also copies the exact
        parameters for it (the peer cache holds the live precision)."""
        if quantize_bits not in (0, 4, 8):
            raise ValueError(f"checkpoint quantization bits must be 0, 4 "
                             f"or 8, got {quantize_bits}")
        self.directory = str(directory)
        # 0 = interval saves off (forced saves still run)
        self.save_interval_steps = save_interval_steps
        self.max_to_keep = max_to_keep
        self.quantize_bits = quantize_bits
        self.peer_store = peer_store
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
        # the last save's blocking part by piece and its commit seconds
        self.last_save: Dict[str, float] = {}
        # the saves' host buffers (built by the first save, when the
        # state's device is known) and the exact state's
        # host leaves of the last save, (key, leaf) with DTensors kept
        self.host: Optional[HostStage] = None
        self._exact_host: List[Tuple[str, torch.Tensor]] = []
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
        # the span covers the blocking part only; the commit is awaited
        # in ``wait``
        with obs.span("checkpoint_save",
                      {"step": step, "forced": force}) as save_span:
            saved = self._save(step, state, data_state)
            save_span.set_attr("saved", saved)
        if saved:
            obs.get_registry().counter(
                "dlrover_tpu_checkpoint_saves_total",
                "Checkpoint saves dispatched").inc()
        return saved

    def _save(self, step: int, state,
              data_state: Optional[Dict[str, Any]]) -> bool:
        # one background save at a time, and the host buffers are not
        # overwritten while either reader (DCP's write, the peer cache's
        # deferred write) still uses them
        t0 = time.monotonic()
        self._wait_pending()
        if self.peer_store is not None:
            self.peer_store.flush()
        wait_s = time.monotonic() - t0
        if step in self.all_steps():
            return False
        data_state = dict(data_state or {})
        times: Dict[str, float] = {"step": step, "wait_s": wait_s}
        t0 = time.monotonic()
        model_sd, optim_sd = get_state_dict(state.model, state.optimizer)
        times["get_state_dict_s"] = time.monotonic() - t0
        exact = {"model": model_sd, "optim": optim_sd}
        dcp_tree = exact
        if self.quantize_bits:
            t1 = time.monotonic()
            dcp_tree = {"model": encode_tree(model_sd, self.quantize_bits),
                        "optim": optim_sd}
            data_state[_QUANT_KEY] = self.quantize_bits
            data_state[_QUANT_LAYOUT_KEY] = "params"
            times["encode_s"] = time.monotonic() - t1
        tmp = self._step_dir(step) + _TMP_SUFFIX
        if self._rank == 0 and os.path.exists(tmp):
            shutil.rmtree(tmp)             # a torn save of an earlier run
        t1 = time.monotonic()
        self._barrier()
        times["barrier_s"] = time.monotonic() - t1
        # the host copy: the tree DCP writes, and with codes in it the
        # exact parameters too when the peer cache stages them
        trees = [dcp_tree]
        if self.quantize_bits and self.peer_store is not None:
            trees.append({"model": model_sd})
        host_trees, alloc_s, copy_s = self._copy_to_host(trees)
        times["host_alloc_s"] = alloc_s
        times["host_copy_s"] = copy_s
        host_exact = (host_trees[0] if not self.quantize_bits else
                      {"model": host_trees[1]["model"],
                       "optim": host_trees[0]["optim"]}
                      if self.peer_store is not None else {})
        self._exact_host = shard_items(host_exact)
        t1 = time.monotonic()
        future = dcp.async_save(
            host_trees[0],
            storage_writer=FileSystemWriter(tmp,
                                            thread_count=_WRITER_THREADS),
            process_group=self._pg, async_stager=_PreStaged())
        times["dispatch_s"] = time.monotonic() - t1
        blocking_s = time.monotonic() - t0
        times["blocking_s"] = blocking_s
        self.last_save = times
        self._pending_step = step
        self._pending = self._committer.submit(
            self._commit, future, step, tmp, data_state, t0)
        logger.info("flash checkpoint: async save started at step %d, "
                    "blocking %.3f s: %s", step, blocking_s,
                    json.dumps({k: v for k, v in times.items()
                                if k.endswith("_s")}))
        return True

    def exact_host_items(self) -> List[Tuple[str, torch.Tensor]]:
        """(flat key, host leaf) of the exact state the last save copied
        (DTensor leaves keep their placements), for the peer cache; valid
        until the next save starts."""
        return list(self._exact_host)

    def _copy_to_host(self, trees: List[Dict[str, Any]]):
        """Each tree with its tensors replaced by their host buffers
        (DTensors rewrapped around them, other values copied), and the
        seconds spent allocating and copying."""
        items = [item for tree in trees for item in shard_items(tree)]
        device = next((to_local(t).device for _, t in items
                       if to_local(t).device.type == "cuda"),
                      torch.device("cpu"))
        if self.host is None:
            self.host = HostStage(pin=device.type == "cuda")
        stage = self.host
        t0 = time.monotonic()
        buffers = stage.buffers(items)
        alloc_s = time.monotonic() - t0
        pairs = []

        def rebuild(tree, prefix=""):
            if isinstance(tree, torch.Tensor):
                host = buffers[prefix]
                pairs.append((to_local(tree).detach(), host))
                return (DTensor(host, tree._spec, requires_grad=False)
                        if isinstance(tree, DTensor) else host)
            if isinstance(tree, dict):
                return {key: rebuild(value, _join(prefix, key))
                        for key, value in tree.items()}
            return copy.deepcopy(tree)

        host_trees = [rebuild(tree) for tree in trees]
        t0 = time.monotonic()
        stage.copy(pairs, device)
        return host_trees, alloc_s, time.monotonic() - t0

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
            outcome = "skipped"
        else:
            with obs.span("emergency_checkpoint",
                          {"step": step,
                           "window_s": round(min(remaining, 1e9), 1)}
                          ) as em_span:
                outcome = self._emergency(step, state, data_state,
                                          deadline)
                em_span.set_attr("outcome", outcome)
        obs.get_registry().counter(
            "dlrover_tpu_checkpoint_emergency_total",
            "Deadline-bounded emergency saves by outcome",
            labelnames=("outcome",)).labels(outcome=outcome).inc()
        obs.get_flight_recorder().record_event(
            "emergency_checkpoint", step=step, outcome=outcome,
            window_s=round(min(remaining, 1e9), 1))
        if outcome == "saved":
            logger.info("emergency checkpoint committed at step %d (%.1fs "
                        "window)", step, remaining)
        return outcome

    def _emergency(self, step: int, state,
                   data_state: Optional[Dict[str, Any]],
                   deadline: float) -> str:
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
        # only a save THIS call dispatched measures a full save: awaiting
        # one in flight would record only its tail
        if dispatched:
            with self._lock:
                self._last_full_save_s = time.monotonic() - t0
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
        progress.

        A save of this checkpointer still in flight (a reconcile between
        steps: ``ElasticEmbeddingTrainer.maybe_reconcile``) is committed
        first: its ``<step>.tmp`` is not a torn save, and its step is the
        newest state to restore. A commit that fails is logged and dropped:
        its ``<step>.tmp`` goes with the torn saves, and the restore falls
        back to the newest committed step."""
        self.last_restore_phases = {}
        t0 = time.monotonic()
        if self._pending is not None:
            pending_step = self._pending_step
            try:
                self._wait_pending()
            # DCP's CheckpointException derives from BaseException
            except (Exception, dcp.CheckpointException) as e:  # noqa: BLE001
                self._pending = self._pending_step = None
                logger.error("flash checkpoint: the in-flight save of step "
                             "%s FAILED (%s: %s); restoring the newest "
                             "committed step", pending_step,
                             type(e).__name__, e)
            self.last_restore_phases["pending_commit_s"] = (
                time.monotonic() - t0)
            t0 = time.monotonic()
        self._remove_torn_saves()
        steps = sorted(self.all_steps(), reverse=True)
        discovery_s = time.monotonic() - t0
        if not steps:
            return None
        first_exc: Optional[BaseException] = None
        failed = []
        for nth, step in enumerate(steps):
            try:
                with obs.span("checkpoint_restore",
                              {"step": step, "fallback": nth > 0}):
                    result = self._restore_at(step, target)
            # DCP's raise varies, and its CheckpointException (a failed
            # read on any rank) derives from BaseException
            except (Exception, dcp.CheckpointException) as e:  # noqa: BLE001
                first_exc = first_exc if first_exc is not None else e
                failed.append(step)
                logger.error("checkpoint restore at step %d FAILED (%s: %s);"
                             " falling back to the next-older step", step,
                             type(e).__name__, e)
                obs.get_registry().counter(
                    "dlrover_tpu_checkpoint_restore_fallbacks_total",
                    "Corrupt/partial checkpoints skipped during "
                    "restore").inc()
                continue
            if failed:
                self._remove_failed_steps(failed)
            obs.get_registry().counter(
                "dlrover_tpu_checkpoint_restores_total",
                "Checkpoint restores completed").inc()
            self.last_restore_phases["step_discovery_s"] = discovery_s
            self._restore_stats(step)
            return result
        raise first_exc

    def restore_step(self, step: int, target, keys=None
                     ) -> Tuple[Any, Dict[str, Any], int]:
        """Restore one committed step, with no fallback. ``keys``: only
        these flat state keys (``model.<fqn>``, ``optim.state.<fqn>.<name>``;
        the peer restore's mixed path), the rest of ``target`` left as it
        is."""
        self.last_restore_phases = {}
        return self._restore_at(step, target, keys)

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

    def _restore_at(self, step: int, target, keys=None
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
        load = {"model": load_model, "optim": optim_sd}
        if keys is not None:
            load = _select(load, set(keys)) or {}
            load_model = load.get("model", {})
        t_read = time.monotonic()
        dcp.load(load, checkpoint_id=self._step_dir(step),
                 process_group=self._pg)
        _sync(device)
        phases["tensor_read_s"] = time.monotonic() - t_read
        if bits:
            t_decode = time.monotonic()
            for name, value in decode_tree(
                    load_model, {n: model_sd[n] for n in load_model},
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
        # labelled by source: the peer restore publishes the same gauges
        # as source="peer" ("orbax" is the JAX package's label of the
        # checkpoint on disk, kept so the series are one)
        registry = obs.get_registry()
        registry.gauge(
            "dlrover_tpu_checkpoint_restore_bytes",
            "Bytes read by the last checkpoint restore",
            labelnames=("source",),
        ).labels(source="orbax").set(float(total))
        if phases.get("read_bandwidth_mbps"):
            registry.gauge(
                "dlrover_tpu_checkpoint_restore_bandwidth_mbps",
                "Effective bandwidth of the last restore's "
                "tensor-read phase",
                labelnames=("source",),
            ).labels(source="orbax").set(phases["read_bandwidth_mbps"])

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
