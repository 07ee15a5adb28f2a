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

With a ``master_client`` (``agent/master_client.py``) the loop reports
the model's size and FLOPs model once (``ModelInfo``), a step report
every ``report_interval_steps`` (``GlobalStepReport``, with the window's
mean step time and MFU from the per-step timeline, ``obs/timeline.py``),
and checkpoints the master's data-shard position with its own.

With ``DLROVER_TPU_PEER_CACHE_DIR`` set (the agent sets it), every
save's host copy is also staged into the peer cache
(``checkpoint/peer_restore.py``), and a restore first asks for a peer
plan (the master's, the agent's plan file, or the local cache's) and
reads the staged state from memory: ``last_restore_source`` is then
``"peer"`` or ``"mixed"``, else ``"checkpoint"`` or ``"init"``.

Planned and silent failures (the JAX loop's, under the agent's env
contract):

- a drain request from the agent (``agent/preemption.py``, the file
  ``DLROVER_TPU_DRAIN_REQUEST``) is consumed at the next step boundary:
  ``exit=True`` (a preemption notice) runs the deadline-bounded
  emergency checkpoint, exports the timeline, flushes telemetry, dumps
  the flight record and leaves with the clean-drain exit code 76
  (:class:`DrainExit`); ``exit=False`` saves and keeps training;
- the step-hang watchdog (``trainer/watchdog.py``, armed when
  ``hang_watchdog_s`` > 0) dumps every thread's stack and self-aborts a
  worker whose steps stopped; it is disarmed around the drain's save
  and the final commit wait;
- the per-step timeline is exported to ``DLROVER_TPU_TIMELINE_FILE`` at
  the report cadence and at the end of a run (the agent's
  forward-progress evidence);
- finished spans (``restore_or_init``, the checkpointer's) are batched
  to the master at the report cadence (``obs.SpanExporter``);
- ``DLROVER_TPU_CHAOS`` scripts a fault at a step
  (``diagnostics/chaos.py``).

What the master observes of the card (the JAX loop's telemetry):

- the allocator's peak after every step (``obs/device.py``, a host-side
  read), drained into each step report's ``hbm_peak_bytes``; the card
  stats file the agent relays (``agent/monitor.py::export_chip_stats``,
  ``DLROVER_TPU_CHIP_STATS``) at the report cadence;
- one step-trace record a step (``obs/steptrace.py``: data_wait, h2d,
  compute, host_sync, checkpoint), stamped with the clock offset against
  the master (probed once at construction, refreshed at the report
  cadence) and flushed with the spans; the compute phase runs to the end
  of the step's host work (the chaos hook included), host_sync is the
  boundary's work before the save (the telemetry and timeline records
  and, when due, the step report's RPCs, which wait on the master), and
  the checkpoint phase is the save's own blocking time. The record is
  made after both, so it ships with the next step's flush (the JAX loop
  records before its report and leaves that time untraced). The port
  records its timeline before the save;
- ``torch.profiler`` captures (``obs/profiler.py``): the static window of
  ``profile_dir`` and the agent's on-demand requests
  (``DLROVER_TPU_PROFILE_REQUEST``), polled at the step boundary before
  the next step's clock starts (the JAX loop polls inside its step), so
  neither the profiler's start nor the trace's write lands in a timed
  step or trips the watchdog.

While a run lasts, CPython's automatic garbage collection is off and
the loop collects the young generations at step boundaries instead:
after the run's first step (its lazy imports and first allocations)
and every ``GC_EVERY_STEPS`` steps. An automatic collection can land
inside a step's kernel launches and hold the card idle for its
50-100 ms (Llama-1B on an H100). The oldest generation waits for the
run's end.

Re-planning on resize (the JAX loop's, ``parallel/planner.py``): before
the trainer is built, the loop fetches the master's shard plan for its
world (``ShardPlanRequest``, else the agent's ``DLROVER_TPU_SHARD_PLAN``
file) and applies it: the planned mesh and the planned (possibly
deliberately trimmed) global batch, or only the batch when each process
runs an independent full replica of a larger planned world (replica
mode: no process group, ``examples/llama_train.py --solo-replica``). A
plan that cannot be applied, or a planned mesh the model rejects, falls
back loudly (``replan_fallback``) to the configured shape. A world whose
dp does not divide the batch trims it to the nearest multiple
(``replan_batch_adjusted``) and the sampler advances by the trimmed
size. When the applied shape differs from the previous incarnation's
(remembered in ``<plan file>.applied``, written once the restore
landed), the resize is priced by the ``replan_plan``, ``replan_rebuild``
and ``replan_migrate`` spans, and the peer restore asks for striped
plans. Step reports carry the applied plan's generation (``-2`` when
none or in replica mode), and step traces group under the plan's epoch.

An injected ``trainer`` (the streaming step of ``trainer/streaming.py``,
the pipelined one of ``trainer/pipeline_trainer.py``) takes the place of
the dense one, as in the JAX loop: it is saved, restored and reported as
the dense one is, and no shard plan applies to it. A pipelined trainer's
ranks each save their stage's keys and the replicated shared ones, and
restore at the same pipe size. With ``prefetch_autotune``
the loop keeps a ``PrefetchAutoTuner`` (``data/prefetch.py``), feeds it
the window's data-wait share at each progress report and exports its
depth as the ``dlrover_tpu_prefetch_depth`` gauge; the input pipeline
reads ``loop.prefetch_tuner.depth_fn``.

Slice mode (the JAX loop's, ``parallel/dcn_sync.py``): a worker with a
slice id (``DLROVER_TPU_SLICE_ID``) and a master runs the split step:
``grad_step`` gives the in-slice mean, its gradients cross to host numpy
for the cross-slice mean through the master's KV store (renormalized over
the present slices while one is absent: a degraded step, counted on the
step report), and ``apply_grads`` applies the fleet mean. A re-formed
slice restored behind the fleet adopts the state a surviving slice's
leader publishes (``catch_up``) and advances its sampler. The host-level
sync needs a single-process slice world of a slice the master's registry
knows: a larger one, or a slice id whose agent joined sliceless (the id
then only arms the chaos slice faults), warns and trains without it.
The step trace splits such a step into compute, ``local_post``,
``cross_slice_wait`` and ``apply``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.agent.preemption import DrainRequestSource
from dlrover_tpu_torch.checkpoint.flash_checkpoint import FlashCheckpointer
from dlrover_tpu_torch.checkpoint.peer_restore import (
    PeerRestorer,
    PeerStateStore,
)
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import NodeEnv, WorkerExit
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.data.prefetch import PrefetchAutoTuner
from dlrover_tpu_torch.obs import mfu
from dlrover_tpu_torch.parallel import planner
from dlrover_tpu_torch.parallel.dcn_sync import SliceGradSync
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh, dp_size
from dlrover_tpu_torch.parallel.sharding import to_local
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
from dlrover_tpu_torch.trainer.train_step import (
    Trainer,
    TrainState,
    _init_optimizer_state,
    build_trainer,
    choose_accumulation,
)
from dlrover_tpu_torch.trainer.watchdog import StepHangWatchdog


# the young generations' collection cadence while a run lasts (see the
# module docstring)
GC_EVERY_STEPS = 50


class DrainExit(SystemExit):
    """Clean graceful drain: the loop consumed a preemption drain
    request, ran the emergency checkpoint, and the process must exit
    with the clean-drain code the agent classifies as NON-failure."""

    def __init__(self, reason: str = ""):
        super().__init__(WorkerExit.DRAIN)
        self.reason = reason


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
    # torch.profiler window: a trace of steps [start, start+num) of every
    # (re)spawn is written under profile_dir (default
    # $DLROVER_TPU_PROFILE_DIR; "" = off)
    profile_dir: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "DLROVER_TPU_PROFILE_DIR", ""))
    profile_start_step: int = 3           # skip the first-build steps
    profile_num_steps: int = 3


def model_flops_per_token(cfg, param_count: int, seq_len: int) -> float:
    """obs/mfu.py's accounting for any model config, read as the JAX
    loop reads it (``getattr`` with its fallbacks): 6·params, less a
    gather embedding table with an untied head (it does no matmul), plus
    the causal attention term from ``num_layers`` and ``hidden_size``.
    A config without those names (GPT's ``n_layer``/``n_embd``) gets no
    attention term, and BERT's is halved as if it were causal: the
    reference's accounting, kept so both masters see one ``ModelInfo``
    (ROADMAP Queue C11)."""
    uncounted = 0.0
    if (getattr(cfg, "embed_impl", "") == "gather"
            and not getattr(cfg, "tie_embeddings", True)):
        uncounted = (getattr(cfg, "vocab_size", 0)
                     * getattr(cfg, "hidden_size", 0))
    return mfu.flops_per_token(
        param_count, num_layers=getattr(cfg, "num_layers", 0),
        hidden_size=getattr(cfg, "hidden_size", 0), seq_len=seq_len,
        uncounted_embed_params=uncounted)


def model_divisors(cfg) -> Tuple[int, int]:
    """(tensor_divisor, fsdp_divisor), the planner's dim-divisibility
    granules, read as the JAX loop reads them: a tensor way must divide
    every tensor-sharded dim (heads, kv heads, MLP, vocabulary; their
    gcd, 0 when the config names none), an fsdp way the embed dim."""
    tensor_dims = [int(getattr(cfg, k, 0) or 0)
                   for k in ("num_heads", "n_head", "num_kv_heads",
                             "intermediate_size", "vocab_size")]
    tensor_dims = [d for d in tensor_dims if d > 0]
    tensor_divisor = math.gcd(*tensor_dims) if tensor_dims else 0
    fsdp_divisor = int(getattr(cfg, "hidden_size", 0)
                       or getattr(cfg, "n_embd", 0) or 0)
    return tensor_divisor, fsdp_divisor


class ElasticTrainLoop:
    def __init__(
        self,
        model,
        optimizer_factory: Callable[..., torch.optim.Optimizer],
        loss_fn: Callable,
        config: TrainLoopConfig,
        master_client=None,
        device: Optional[Union[str, torch.device]] = None,
        trainer: Optional[Trainer] = None,
    ):
        """``model``: a built module or a ``(device=, seed=) -> module``
        factory (see ``build_trainer``). ``device`` defaults to the
        current CUDA device and raises without a GPU unless ``"cpu"``.
        The world is the initialized process group's (``agent/
        elastic_agent.py::init_distributed``), or this process alone.
        ``master_client``: a ``MasterClient`` to report to (None: no
        master). ``trainer``: a built trainer with the dense
        ``Trainer``'s surface (the streaming one of
        ``trainer/streaming.py``, the pipelined one of
        ``trainer/pipeline_trainer.py``, whose ``model`` argument only
        gives the reported config) in place of the dense one; it brings
        its own model, optimizer, mesh and batch shape (``model``,
        ``optimizer_factory`` and ``loss_fn`` may be None), no shard plan
        applies, and the configured global batch must be its
        accum × micro."""
        # finished spans batched for the master (flushed at report
        # intervals); registered before any span below. A failed
        # construction deregisters it (the sink list outlives this
        # instance).
        self._span_exporter = obs.SpanExporter()
        obs.add_span_sink(self._span_exporter)
        try:
            self._init_inner(model, optimizer_factory, loss_fn, config,
                             master_client, device, trainer)
        except BaseException:
            obs.remove_span_sink(self._span_exporter)
            raise

    def _init_inner(self, model, optimizer_factory, loss_fn, config,
                    master_client, device, trainer) -> None:
        self.client = master_client
        self.config = config
        # the master's parallelism plan for this world, applied before
        # the trainer is built; a failure falls back loudly to the
        # configured shape
        self._shard_plan: Optional[Dict[str, Any]] = None
        self._plan_mesh_spec: Optional[MeshSpec] = None
        self._replan_applied = ""       # "" | "batch" | "mesh+batch"
        # whether the applied shape differs from the previous
        # incarnation's: only then is this (re)build a resize to price
        self._replan_changed = False
        self._pending_plan_signature = ""
        self.global_batch = config.global_batch
        self._trim_batch = 0
        # slice mode: with a slice id and a master the gradient mean is
        # two-level, the in-slice mean the step's and the cross-slice one
        # host-level (parallel/dcn_sync.py), tolerating an absent slice.
        # The host-level sync moves whole values through host memory, so
        # it needs a single-process slice world
        self._slice_id = int(os.environ.get(NodeEnv.SLICE_ID, "-1"))
        slice_mode = self._slice_id >= 0 and master_client is not None
        if slice_mode and str(self._slice_id) not in (
                master_client.get_slice_status().get("slices") or {}):
            # the agent joined sliceless (the id only arms the chaos
            # slice faults): no slice to sync with
            logger.warning(
                "the master's slice registry has no slice %d: training "
                "without the cross-slice sync", self._slice_id)
            slice_mode = False
        slice_world = int(os.environ.get(NodeEnv.WORLD_SIZE, "1"))
        if slice_mode and slice_world > 1:
            logger.warning(
                "slice %d spans %d processes: the host-level cross-slice "
                "gradient sync needs a single-process slice world; "
                "training without it (a mesh with a dcn axis reduces "
                "across slices inside the step)", self._slice_id,
                slice_world)
            slice_mode = False
        if trainer is not None:
            self._take_trainer(trainer, config, device)
            if not hasattr(trainer, "param_stats"):
                model = trainer.model_factory
            # an injected trainer without the split step runs its own
            slice_mode = slice_mode and getattr(trainer, "split_grad_apply",
                                                False)
        else:
            self._resolve_shard_plan(config)
            try:
                self._build_trainer(model, optimizer_factory, loss_fn,
                                    config, device, slice_mode)
            except Exception as e:  # noqa: BLE001 — a planned mesh the
                # model cannot shard over falls back to the configured
                # shape
                if self._plan_mesh_spec is None:
                    raise
                self._replan_fallback(
                    self._shard_plan,
                    f"planned mesh rejected by the model/trainer: {e}")
                self._build_trainer(model, optimizer_factory, loss_fn,
                                    config, device, slice_mode)
        self._slice_sync: Optional[SliceGradSync] = None
        if slice_mode:
            # the slice's process 0 posts; every rank collects
            is_leader = int(os.environ.get(NodeEnv.PROCESS_ID, "0")) == 0
            self._slice_sync = SliceGradSync(
                master_client, self._slice_id, is_leader=is_leader,
                abort_fn=lambda: self._stop_requested.is_set())
            logger.info("slice mode armed: slice=%d leader=%s",
                        self._slice_id, is_leader)
        # the sync's marks of the last slice step, for its trace record
        self._last_sync_trace: Optional[Dict[str, Any]] = None
        # peer-to-peer restore (checkpoint/peer_restore.py): the store
        # stages every save's host copy for the agent's donor; the
        # restorer turns a restore plan into a shard transfer
        self._peer_store = (PeerStateStore.from_env()
                            if config.checkpoint_dir else None)
        self._peer_restorer = (PeerRestorer.from_env(client=master_client)
                               if config.checkpoint_dir else None)
        if self._peer_restorer is not None and self._replan_changed:
            # a re-plan migration: restore plans stripe each shard's byte
            # ranges across every same-step holder
            self._peer_restorer.stripe = True
        self.checkpointer = (
            FlashCheckpointer(config.checkpoint_dir,
                              config.save_interval_steps,
                              quantize_bits=config.checkpoint_quantize_bits,
                              peer_store=self._peer_store)
            if config.checkpoint_dir else None)
        self._stop_requested = threading.Event()
        self._prev_sigterm = None
        self.last_restore_timings: Dict[str, float] = {}
        # where the last restore's state came from: "peer" (staged host
        # copies), "mixed" (peer + shard-wise checkpoint read),
        # "checkpoint" (the flash checkpoint on disk), "init" (fresh)
        self.last_restore_source = ""
        cards = self.mesh.spec.total
        self.peak_flops = (
            mfu.peak_flops_for(torch.cuda.get_device_name(self.device))
            * cards if self.device.type == "cuda" else 0.0)
        logger.info("elastic loop: device=%s dp=%d accum=%d "
                    "micro(global)=%d mesh=%s", self.device, self.dp,
                    self.accum, self.micro_global, self.mesh.shape)
        # per-step phase attribution: its windowed means ride on the
        # step reports, and its export is the agent's forward-progress
        # evidence
        self.timeline = obs.StepTimeline(
            role="worker",
            rank=int(os.environ.get(NodeEnv.NODE_RANK, "-1")))
        self._timeline_path = os.environ.get(NodeEnv.TIMELINE_FILE, "")
        self._timeline_exported_at = 0.0
        # the input pipeline's auto-tune (data/prefetch.py): fed the
        # timeline's windowed data-wait share at each progress report;
        # the pipeline reads ``prefetch_tuner.depth_fn`` batch by batch
        self.prefetch_tuner: Optional[PrefetchAutoTuner] = None
        if Context.singleton().prefetch_autotune:
            self.prefetch_tuner = PrefetchAutoTuner()
            obs.get_registry().gauge(
                "dlrover_tpu_prefetch_depth",
                "Auto-tuned device-prefetch depth (data/prefetch.py; "
                "grows while the timeline's data_wait fraction exceeds "
                "the tune threshold, decays when the pipeline is calm)",
            ).set_function(self.prefetch_tuner.depth_fn)
        # drain and urgent-checkpoint requests from the agent, consumed
        # at step boundaries (one os.stat a step when armed)
        self._drain_source = DrainRequestSource()
        # the step-hang backstop: no progress past hang_watchdog_s →
        # stack dump + self-abort so the agent restarts this worker
        # (0 = off)
        watchdog_s = Context.singleton().hang_watchdog_s
        self._watchdog = (StepHangWatchdog(watchdog_s)
                          if watchdog_s > 0 else None)
        self._chaos = None   # built at the first run: env may change
        # the allocator's peak after every step, drained into the step
        # reports (a no-op off the card)
        self.device_telemetry = obs.DeviceTelemetry(
            obs.device.allocator_sampler(self.device))
        # one trace record a step, clock-aligned against the master and
        # batched over the telemetry channel; the construction-time probe
        # anchors the offset before the first step
        ctx = Context.singleton()
        self._clock_sync = obs.ClockSync(
            probe_fn=(master_client.probe_clock
                      if master_client is not None else None))
        self._steptrace = (
            obs.StepTraceRecorder(
                capacity=ctx.steptrace_ring,
                rank=int(os.environ.get(NodeEnv.NODE_RANK, "-1")),
                slice_id=self._slice_id, clock_sync=self._clock_sync)
            if ctx.steptrace_enabled else None)
        if self._steptrace is not None and master_client is not None:
            self._clock_sync.probe()
        # the static window and the agent's on-demand captures
        self.profiler = obs.ProfilerSession(
            request_path=os.environ.get(NodeEnv.PROFILE_REQUEST_FILE, ""),
            static_dir=config.profile_dir,
            static_start=config.profile_start_step,
            static_num=config.profile_num_steps)
        # the model's sizes and FLOPs/token (obs/mfu.py): from the model
        # built on ``meta`` when a master wants them now, else from the
        # trained model at the first run
        self._flops_per_token = 0.0
        self._model_arg = model
        if self.client is not None:
            self._model_stats(model)
            self._report_model_info()

    def _take_trainer(self, trainer: Trainer, config,
                      device) -> None:
        """An injected trainer: its mesh and batch shape are the loop's,
        and the configured batch must be what its step takes."""
        self.trainer = trainer
        self.mesh = trainer.mesh
        self.device = self.mesh.device
        if device is not None and torch.device(device) != self.device:
            raise ValueError(f"device {device} is not the trainer's "
                             f"{self.device}")
        self.dp = dp_size(self.mesh)
        self.accum = trainer.accum_steps
        self.micro_global = trainer.micro_batch
        if self.accum * self.micro_global != config.global_batch:
            raise ValueError(
                f"the trainer steps {self.accum} x {self.micro_global} "
                f"rows, the loop's global batch is {config.global_batch}")

    # -- online parallelism re-planning (parallel/planner.py) --------------
    def _build_trainer(self, model, optimizer_factory, loss_fn, config,
                       device, split_grad_apply: bool = False) -> None:
        """The mesh, accumulation and trainer of the current shape (the
        planned mesh when a plan applied, else the configured one). A
        world whose dp does not divide the batch trims it to the nearest
        dp multiple, loudly. Under a re-plan the build is the
        ``replan_rebuild`` span. ``build_trainer`` itself rejects a
        tensor axis the model's dims do not divide, inside the caller's
        fallback."""
        self.mesh = create_mesh(self._plan_mesh_spec or config.mesh_spec,
                                device)
        self.device = self.mesh.device
        self.dp = dp_size(self.mesh)
        if self.global_batch % self.dp:
            # the planner's round-down-to-dp rule, applied locally: even
            # the configured mesh must not crash-loop on such a world
            adjusted = (self.global_batch // self.dp) * self.dp
            if adjusted <= 0:
                raise ValueError(
                    f"dp size {self.dp} exceeds the global batch "
                    f"{self.global_batch}: no mesh over this world holds "
                    f"one sample a replica")
            logger.error(
                "world dp %d does not divide the global batch %d: "
                "DELIBERATELY adjusting it to %d (input batches are "
                "trimmed; the sampler advances by the adjusted size)",
                self.dp, self.global_batch, adjusted)
            obs.get_flight_recorder().record_event(
                "replan_batch_adjusted", dp=self.dp,
                requested=self.global_batch, adjusted=adjusted,
                planned=self._plan_mesh_spec is not None)
            self.global_batch = adjusted
            self._trim_batch = adjusted
        self.accum, self.micro_global = choose_accumulation(
            self.global_batch, self.dp, config.max_micro_per_replica)
        sample = np.zeros((self.micro_global, config.seq_len), np.int64)
        rebuild = (
            obs.span("replan_rebuild",
                     {"generation": self._shard_plan.get("generation", 0),
                      "mesh": self.mesh.shape})
            if self._replan_applied and self._replan_changed
            else contextlib.nullcontext())
        with rebuild:
            self.trainer = build_trainer(
                model, optimizer_factory, self.mesh, sample, loss_fn,
                accum_steps=self.accum, micro_batch=self.micro_global,
                rules=config.rules, split_grad_apply=split_grad_apply)

    def _resolve_shard_plan(self, config) -> None:
        """Fetch and apply the master's parallelism plan for this world
        (the RPC, else the agent's plan file). No plan at all is silent
        (standalone runs); a plan that cannot be applied is a loud
        ``replan_fallback``."""
        if not Context.singleton().replan_enabled:
            return
        t0 = time.monotonic()
        plan = None
        if self.client is not None:
            try:
                plan = self.client.get_shard_plan() or None
            except Exception:  # noqa: BLE001 — degrade to the file
                logger.warning("shard-plan RPC failed; trying the "
                               "join-result plan file", exc_info=True)
        if plan is None:
            path = os.environ.get(NodeEnv.SHARD_PLAN_FILE, "")
            if path:
                try:
                    with open(path) as f:
                        loaded = json.load(f)
                    if isinstance(loaded, dict) and loaded.get("mesh"):
                        plan = loaded
                except (OSError, json.JSONDecodeError):
                    pass
        if plan is None:
            return
        try:
            self._apply_shard_plan(plan, config)
        except Exception as e:  # noqa: BLE001 — the fallback is always
            # reachable: a broken plan never wedges the worker
            self._replan_fallback(plan, f"plan application failed: {e}")
        if self._replan_changed:
            # the "plan" leg of the resize's pricing
            obs.record_span(
                "replan_plan", time.monotonic() - t0,
                attrs={"applied": self._replan_applied,
                       "generation": plan.get("generation", 0),
                       "epoch": plan.get("epoch", 0)})

    def _applied_plan_signature(self, plan: Dict[str, Any],
                                batch: int) -> str:
        """The execution shape this incarnation runs, as a stable
        string."""
        return json.dumps({"mesh": plan.get("mesh"),
                           "global_batch": batch,
                           "total_devices": plan.get("total_devices"),
                           "applied": self._replan_applied},
                          sort_keys=True)

    def _note_replan_changed(self, plan: Dict[str, Any],
                             batch: int) -> None:
        """A RESIZE (the shape differs from the previous incarnation's,
        read from the sidecar beside the agent's plan file) or a plain
        relaunch of the same plan? No plan file: no memory, so changed.
        The sidecar is written only once the restore landed
        (``_commit_applied_plan``): a worker that dies mid-resize re-runs
        and re-prices it."""
        self._pending_plan_signature = self._applied_plan_signature(
            plan, batch)
        path = os.environ.get(NodeEnv.SHARD_PLAN_FILE, "")
        if not path:
            self._replan_changed = True
            return
        previous = None
        try:
            with open(f"{path}.applied") as f:
                previous = f.read()
        except OSError:
            pass
        self._replan_changed = previous != self._pending_plan_signature

    def _commit_applied_plan(self) -> None:
        """The resize completed: remember the applied signature, so the
        next incarnation tells a plain relaunch from a resize."""
        path = os.environ.get(NodeEnv.SHARD_PLAN_FILE, "")
        if not self._pending_plan_signature or not path:
            return
        try:
            tmp = f"{path}.applied.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                f.write(self._pending_plan_signature)
            os.replace(tmp, f"{path}.applied")
        except OSError:
            pass

    def _apply_shard_plan(self, plan: Dict[str, Any], config) -> None:
        """The planned mesh and batch, or only the batch in replica mode
        (each process an independent full replica of a larger planned
        world: no process group, one card)."""
        error = planner.validate_plan(plan, n_devices=0)
        if error is not None:
            self._replan_fallback(plan, error)
            return
        # slice mode builds the slice's portion (dcn 1): each slice is its
        # own process group, and the dcn axis is the host-level sync
        mesh_dict = (planner.slice_mesh(plan) if self._slice_id >= 0
                     else dict(plan.get("mesh", {})))
        mesh_total = math.prod(int(mesh_dict.get(k, 1)) for k in
                               ("dcn", "data", "fsdp", "tensor", "pipe"))
        grouped = (torch.distributed.is_available()
                   and torch.distributed.is_initialized())
        n_devices = torch.distributed.get_world_size() if grouped else 1
        world_size = max(1, int(plan.get("world_size", 1) or 1))
        apply_mesh = mesh_total == n_devices
        if not apply_mesh:
            replica_mode = (not grouped and world_size > 1
                            and mesh_total == n_devices * world_size)
            if not replica_mode:
                self._replan_fallback(
                    plan, f"plan mesh covers {mesh_total} device(s); "
                          f"this process sees {n_devices}")
                return
        # the batch contract: the planned batch when the plan was made
        # for this loop's configured batch; a plan from a stale profile
        # adjusts locally by the same round-down-to-dp rule
        planned_batch = int(plan.get("global_batch", 0) or 0)
        requested = int(plan.get("requested_global_batch", 0) or 0)
        if requested != config.global_batch \
                or planned_batch > config.global_batch:
            dp = int(plan.get("dp", 0) or 0) or 1
            planned_batch, _ = planner.adjust_global_batch(
                config.global_batch, dp)
            if planned_batch <= 0:
                self._replan_fallback(
                    plan, f"planned dp {dp} exceeds the configured "
                          f"global batch {config.global_batch}")
                return
        if apply_mesh:
            self._plan_mesh_spec = MeshSpec(
                data=int(mesh_dict.get("data", 1)),
                fsdp=int(mesh_dict.get("fsdp", 1)),
                tensor=int(mesh_dict.get("tensor", 1)),
                pipe=int(mesh_dict.get("pipe", 1)),
                dcn=int(mesh_dict.get("dcn", 1)))
        self.global_batch = planned_batch
        self._trim_batch = (planned_batch
                            if planned_batch < config.global_batch else 0)
        self._shard_plan = plan
        self._replan_applied = "mesh+batch" if apply_mesh else "batch"
        self._note_replan_changed(plan, planned_batch)
        obs.get_flight_recorder().record_event(
            "replan_applied",
            applied=self._replan_applied,
            changed=self._replan_changed,
            mesh=mesh_dict,
            global_batch=planned_batch,
            requested_global_batch=config.global_batch,
            batch_adjusted=planned_batch != config.global_batch,
            resharded=bool(plan.get("resharded")),
            generation=plan.get("generation", 0),
            epoch=plan.get("epoch", 0),
            world_size=world_size)
        obs.get_registry().counter(
            "dlrover_tpu_replan_applied_total",
            "Parallelism plans applied at worker (re)build",
            labelnames=("applied",),
        ).labels(applied=self._replan_applied).inc()
        if planned_batch != config.global_batch:
            logger.warning(
                "re-plan DELIBERATELY adjusted the global batch %d -> %d "
                "(dp %s does not divide it); input batches are trimmed, "
                "the sampler advances by the adjusted size",
                config.global_batch, planned_batch, plan.get("dp"))
        logger.info(
            "shard plan applied (%s): mesh=%s batch=%d generation=%s "
            "epoch=%s", self._replan_applied, mesh_dict, planned_batch,
            plan.get("generation"), plan.get("epoch"))

    def _replan_fallback(self, plan: Optional[Dict[str, Any]],
                         reason: str) -> None:
        """The hard fallback to the configured shape (the checkpoint
        path of a plain restart), loud by contract: the flight record
        and a counter show it."""
        self._shard_plan = None
        self._plan_mesh_spec = None
        self._replan_applied = ""
        self._replan_changed = False
        self.global_batch = self.config.global_batch
        self._trim_batch = 0
        obs.get_flight_recorder().record_event(
            "replan_fallback", reason=reason[:256],
            generation=(plan or {}).get("generation", 0),
            epoch=(plan or {}).get("epoch", 0),
            mesh=(plan or {}).get("mesh"))
        obs.get_registry().counter(
            "dlrover_tpu_replan_fallbacks_total",
            "Re-plans abandoned for the configured-shape "
            "checkpoint-restart path").inc()
        logger.error(
            "parallelism re-plan falling back to the configured shape: "
            "%s (the checkpoint-restart path still applies)", reason)

    # -- master reporting --------------------------------------------------
    def _model_stats(self, model) -> None:
        """The model's sizes and the FLOPs model behind every MFU number
        (obs/mfu.py): the parameter count and bytes summed over the
        parameters of ``model`` (a module, or a factory built on
        ``meta``; a DTensor counts whole), as the JAX loop sums its
        leaves. A trainer with ``param_stats`` (the pipelined one, whose
        rank holds one stage) counts every stage itself, and the config
        is the loop's ``model`` argument's (None when there is none), as
        the JAX loop reads both."""
        stats = getattr(self.trainer, "param_stats", None)
        if stats is not None:
            self._param_count, self._param_bytes = stats()
            model = self._model_arg
        if model is not None and not isinstance(model, torch.nn.Module):
            model = model(device="meta", seed=0)
        if stats is None:
            params = list(model.parameters())
            self._param_count = sum(p.numel() for p in params)
            self._param_bytes = sum(p.numel() * p.element_size()
                                    for p in params)
        self._model_config = getattr(model, "config", None)
        self._flops_per_token = model_flops_per_token(
            self._model_config, self._param_count, self.config.seq_len)

    def _report_model_info(self) -> None:
        """One-shot static stats to the master: the sizes, the FLOPs
        model and the planner's divisibility granules."""
        try:
            tokens_per_step = self.global_batch * self.config.seq_len
            tensor_divisor, fsdp_divisor = model_divisors(
                self._model_config)
            cards = self.mesh.spec.total
            self.client.report_model_info(
                param_count=self._param_count,
                param_bytes=self._param_bytes,
                flops_per_step=self._flops_per_token * tokens_per_step,
                batch_size=self.config.global_batch,
                seq_len=self.config.seq_len,
                flops_per_token=self._flops_per_token,
                peak_flops_per_chip=self.peak_flops / cards,
                chips=cards,
                flops_source="analytic",
                tensor_divisor=tensor_divisor,
                fsdp_divisor=fsdp_divisor,
                effective_global_batch=self.global_batch,
            )
        except Exception:   # noqa: BLE001 — stats are advisory
            logger.warning("model-info report failed", exc_info=True)

    def _report_progress(self, step: int) -> None:
        """Ship the step report with the timeline's windowed speed
        evidence and the window's memory peak; refresh the clock offset
        and the card stats file. Best-effort: the step loop survives a
        dead master and a full disk."""
        stats = self.timeline.window_stats(
            self.config.report_interval_steps)
        mean_step = stats.get("mean_step_s", 0.0)
        tokens_per_step = self.global_batch * self.config.seq_len
        step_mfu = mfu.achieved_mfu(
            tokens_per_step / mean_step if mean_step > 0 else -1.0,
            self._flops_per_token, self.peak_flops)
        if self.prefetch_tuner is not None:
            self.prefetch_tuner.observe(
                stats.get("data_wait_fraction", -1.0))
        # the window's device-truth peak (0 off the card)
        hbm = self.device_telemetry.drain()
        # the calibration attributes this window to the plan the loop
        # applied; -2 (no plan, a fallback, or replica mode, which runs
        # a full local replica rather than the stamped mesh) is dropped
        plan_gen = (int(self._shard_plan.get("generation", 0) or 0)
                    if self._shard_plan is not None
                    and self._replan_applied == "mesh+batch" else -2)
        degraded = (self._slice_sync.drain_unreported()
                     if self._slice_sync is not None else 0)
        try:
            self.client.report_global_step(
                step, step_time_s=mean_step,
                data_wait_fraction=stats.get("data_wait_fraction", -1.0),
                mfu=step_mfu, degraded_steps=degraded,
                hbm_peak_bytes=hbm["hbm_peak_bytes"],
                plan_generation=plan_gen)
        except Exception:  # noqa: BLE001 — droppable by contract
            logger.warning("step report failed", exc_info=True)
            # the degraded tally must not vanish with a dropped report
            if degraded:
                self._slice_sync.degraded_unreported += degraded
        if self._steptrace is not None:
            # one RPC, rate-limited by the probe interval
            self._clock_sync.maybe_probe(
                Context.singleton().steptrace_probe_interval_s)
        try:
            from dlrover_tpu_torch.agent.monitor import export_chip_stats

            # the duty-cycle proxy wants the seconds the card is busy a
            # step: the step less its input wait
            busy = max(0.0, 1.0 - max(
                0.0, stats.get("data_wait_fraction", 0.0)))
            export_chip_stats(step=step, step_time_s=mean_step * busy)
        except Exception:  # noqa: BLE001 — stats are advisory
            pass
        # the timeline's tail, at most once a second (the write and
        # rename cost a millisecond on a slow disk); the end of a run
        # writes the whole ring
        now = time.monotonic()
        if self._timeline_path and now - self._timeline_exported_at >= 1.0:
            self._timeline_exported_at = now
            self.timeline.export(
                self._timeline_path,
                last_n=2 * self.config.report_interval_steps)

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
        the parameters and moments. With a peer restorer the staged host
        copies come first (peer, then mixed), then the checkpoint on
        disk, then init. While the state is read, the step's kernels are
        built in a background thread. Per-phase wall times land in
        ``last_restore_timings`` (the peer path's as ``peer_plan_s``,
        ``peer_transfer_s``, ``peer_assemble_s``, ``peer_bytes`` and
        ``peer_bandwidth_mbps``). The whole of it is the
        ``restore_or_init`` span, the goodput ledger's restore bucket."""
        timings: Dict[str, float] = {}
        self.last_restore_timings = timings
        with obs.span("restore_or_init") as restore_span:
            t_migrate = time.monotonic()
            state, step = self._restore_or_init(seed, sampler, timings)
            if self._shard_plan is not None and self._replan_changed:
                # the "migrate" leg of plan → migrate → rebuild: the
                # live state landed under the new shape, from peers when
                # any survive (nested evidence; restore_or_init stays
                # the ledger's restore bucket)
                migrate_s = time.monotonic() - t_migrate
                timings["replan_migrate_s"] = migrate_s
                obs.record_span(
                    "replan_migrate", migrate_s,
                    attrs={"step": step,
                           "source": self.last_restore_source,
                           "bytes": timings.get("peer_bytes", 0.0),
                           "generation": self._shard_plan.get(
                               "generation", 0),
                           "resharded": bool(self._shard_plan.get(
                               "resharded"))})
            restore_span.set_attr("start_step", step)
            restore_span.set_attr("source", self.last_restore_source)
            for key, value in timings.items():
                restore_span.set_attr(key, value)
        if timings:
            logger.info("restore timings: %s", timings)
        if self._slice_sync is not None:
            # a re-formed slice behind the fleet adopts the current state
            # (the restore's source and step above stay what the restore
            # produced; the catch-up is on top)
            state, step = self._maybe_slice_catch_up(state, step, sampler)
        # the migration landed: a later plain relaunch of this shape is
        # not re-priced as a resize
        self._commit_applied_plan()
        self._flush_telemetry()
        return state, step

    def _restore_or_init(self, seed, sampler, timings: Dict[str, float]
                         ) -> Tuple[TrainState, int]:
        build_thread = None
        if self.config.overlap_restore_compile:
            build_thread = threading.Thread(target=self._precompile_quietly,
                                            daemon=True)
            t_build = time.monotonic()
            build_thread.start()
        state, step = None, 0
        source = "init"
        # no committed step and no peer restorer: init at once, without
        # a restore target
        if self.checkpointer is not None and (
                self._peer_restorer is not None
                or self.checkpointer.all_steps()):
            t0 = time.monotonic()
            abstract = self.trainer.abstract_state()
            timings["abstract_state_s"] = time.monotonic() - t0
            restored = None
            if self._peer_restorer is not None:
                # the peer branch: the staged host copies instead of the
                # disk, overlapped with the same kernel build
                t0 = time.monotonic()
                try:
                    peer = self._peer_restorer.restore(
                        abstract, self.checkpointer, timings)
                except Exception:  # noqa: BLE001 — peers are an
                    # optimization; storage is the ground truth
                    logger.warning("peer restore failed; falling back to "
                                   "the checkpoint", exc_info=True)
                    peer = None
                timings["peer_restore_s"] = time.monotonic() - t0
                if peer is not None:
                    state, data_state, step, source = peer
                    restored = (state, data_state, step)
            if restored is None and self.checkpointer.all_steps():
                source = "checkpoint"
                t0 = time.monotonic()
                restored = self.checkpointer.restore(abstract)
                timings["dcp_read_s"] = time.monotonic() - t0
                for key, value in (self.checkpointer.last_restore_phases
                                   .items()):
                    timings[f"restore_{key}"] = value
            if restored is not None:
                if source == "checkpoint":
                    # "checkpoint" is the JAX package's "orbax" label of
                    # this counter (the only place the two names meet);
                    # peer and mixed count themselves in the restorer
                    obs.get_registry().counter(
                        "dlrover_tpu_restore_source_total",
                        "Elastic restores by state source",
                        labelnames=("source",),
                    ).labels(source="orbax").inc()
                state, data_state, step = restored
                t0 = time.monotonic()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                timings["device_ready_s"] = time.monotonic() - t0
                t0 = time.monotonic()
                if sampler is not None and "sampler" in data_state:
                    sampler.load_state_dict(data_state["sampler"])
                if self.client is not None and data_state.get("shards"):
                    # the master's data-shard position of that step
                    try:
                        self.client.report_shard_checkpoint(
                            data_state["shards"])
                    except Exception:  # noqa: BLE001 — advisory
                        logger.warning("could not restore the master's "
                                       "shard checkpoint", exc_info=True)
                timings["post_sync_s"] = time.monotonic() - t0
            else:
                source = "init"
            del abstract
        self.last_restore_source = source
        if state is None:
            state = self.trainer.init(seed)
        if build_thread is not None:
            t0 = time.monotonic()
            build_thread.join()
            timings["compile_wait_after_read_s"] = time.monotonic() - t0
            timings["compile_total_s"] = time.monotonic() - t_build
            timings.update(self.trainer.precompile_timings)
        return state, step

    def _precompile_quietly(self) -> None:
        try:
            self.trainer.precompile()
        except Exception:  # noqa: BLE001 — the first step builds anyway
            logger.warning("kernel precompile failed; the first step will "
                           "build inline", exc_info=True)
            return
        # the build's wall time into the flight record and its gauge
        obs.device.record_compile_event(
            self.trainer.precompile_timings.get("build_s", 0.0),
            mesh=self.mesh.shape)

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
        ``checkpoint_s`` (the save's blocking part, 0 without one).

        Each step is logged (loss as its ``repr``, the exact float). With
        a master client, the step report goes out before the step's save,
        so the master's clock sees the step end, not the save's staging
        (the save is ``checkpoint_s``; a step that saved also has
        ``checkpoint_wait_s``, the part of it spent waiting for the
        previous save's commit and peer-cache write).

        A drain request with ``exit`` consumed at a step boundary ends
        the run with :class:`DrainExit` after its emergency checkpoint;
        the step-hang watchdog watches the steps while the run lasts."""
        if self._chaos is None:
            from dlrover_tpu_torch.diagnostics.chaos import ChaosInjector

            self._chaos = ChaosInjector()
        if self._watchdog is not None:
            self._watchdog.start()
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            return self._run(state, batches, start_step, sampler)
        finally:
            if self._watchdog is not None:
                self._watchdog.stop()
            # an active capture is written out, whatever ended the run
            self.profiler.stop()
            if gc_was_enabled:
                gc.enable()

    def _run(self, state, batches, start_step, sampler):
        if not self._flops_per_token:
            self._model_stats(state.model)
        flops = self._flops_per_token
        tokens_per_step = self.global_batch * self.config.seq_len
        history = []
        step = start_step
        batch_iter = iter(batches)
        while True:
            # the step BOUNDARY is where a drain request is consumed: the
            # state is a whole post-step state here. The save may block
            # for a commit's tens of seconds, which is not a stall: the
            # watchdog is disarmed around it (re-armed, with its
            # first-step budget, for a save-and-continue)
            drain = self._drain_source.poll()
            if drain is not None:
                if self._watchdog is not None:
                    self._watchdog.stop()
                self._consume_drain(drain, step, state, sampler)
                if self._watchdog is not None:
                    self._watchdog.start()
            # a capture starts or ends here, outside the step's clock;
            # the trace's write counts as progress to the watchdog
            capturing = self.profiler.active
            self.profiler.poll(step - start_step)
            if (self._watchdog is not None and step > start_step
                    and capturing != self.profiler.active):
                self._watchdog.notify_step(step)
            t_wait = time.monotonic()
            try:
                tokens, targets = next(batch_iter)
            except StopIteration:
                break
            if self._trim_batch and len(tokens) > self._trim_batch:
                # the plan's deliberate batch adjustment (recorded in
                # replan_applied): the pipeline yields the configured
                # batch; train on the planned dp-divisible prefix
                tokens = tokens[:self._trim_batch]
                targets = targets[:self._trim_batch]
            t0 = time.monotonic()
            tok, tgt = self.trainer.shard_batch(tokens, targets)
            if self._slice_sync is not None:
                state, metrics = self._slice_step(state, tok, tgt,
                                                  step + 1)
            else:
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
            logger.info("step %d loss %r grad_norm %r step_s %.6f "
                        "tokens/s %.1f mfu %.4f", step, loss,
                        record["grad_norm"], dt, tps, record["mfu"])
            # scripted fault injection (a no-op unless DLROVER_TPU_CHAOS)
            self._chaos.maybe_inject(step)
            if sampler is not None:
                # the EFFECTIVE batch: the position advances by what
                # the step consumed
                sampler.record_batch(self.global_batch)
            t_compute_end = time.monotonic()
            self.device_telemetry.on_step(step)
            self.timeline.record(step, time.monotonic() - t_wait,
                                 data_wait=t0 - t_wait, compute=dt)
            if self.client is not None:
                interval = self.config.report_interval_steps
                if interval and step % interval == 0:
                    self._report_progress(step)
                    self._flush_telemetry()
            t_host_end = time.monotonic()
            if self.checkpointer is not None:
                t_save = time.monotonic()
                data_state = self._data_state(sampler)
                saved = self.checkpointer.maybe_save(
                    step, state, data_state,
                    force=self._stop_requested.is_set())
                if saved:
                    # the wait for the previous save's readers, part of
                    # checkpoint_s
                    record["checkpoint_wait_s"] = (
                        self.checkpointer.last_save["wait_s"])
                    # peer step N and checkpoint step N are one cut, so
                    # a shard-wise restore across both stays consistent
                    self._stage_peer(step, data_state)
                record["checkpoint_s"] = time.monotonic() - t_save
            if self._steptrace is not None:
                self._record_steptrace(step, t_wait, t0, t_compute_end,
                                       t_host_end, record["checkpoint_s"])
            # the collections, at the boundary, outside the timed step
            if len(history) == 1 or step % GC_EVERY_STEPS == 0:
                t_gc = time.monotonic()
                gc.collect(1)
                logger.info("collection after step %d: %.6f s", step,
                            time.monotonic() - t_gc)
            if self._watchdog is not None:
                self._watchdog.notify_step(step)
            if self._stop_requested.is_set():
                logger.info("stopping at step %d on request", step)
                obs.get_flight_recorder().record_event(
                    "train_stop_requested", step=step)
                break
            if self.config.max_steps and len(history) >= self.config.max_steps:
                break
        # out of the step loop: a long but legitimate final commit is not
        # a step hang
        if self._watchdog is not None:
            self._watchdog.stop()
        if self.checkpointer is not None:
            with obs.span("checkpoint_wait"):
                self.checkpointer.wait()
        if self._timeline_path:
            # runs shorter than a report interval still leave a timeline
            self.timeline.export(self._timeline_path)
        self._flush_telemetry()
        last = history[-1] if history else {}
        return state, {"step": step, "loss": last.get("loss", float("nan")),
                       "history": history}

    def _record_steptrace(self, step: int, t_step: float, t_data: float,
                          t_compute_end: float, t_host_end: float,
                          ckpt_s: float) -> None:
        """One step's trace record from the loop's monotonic marks: a
        handful of float ops and one bounded-ring append."""
        now_mono = time.monotonic()
        # the step start on the local wall clock, derived from the same
        # monotonic domain as every mark
        t0_wall = time.time() - (now_mono - t_step)
        data_d = max(0.0, t_data - t_step)
        h2d_d = max(0.0, float(self.trainer.last_shard_batch_s))
        cursor = data_d + h2d_d
        phases = [("data_wait", 0.0, data_d), ("h2d", data_d, h2d_d)]
        peers = None
        stashed, self._last_sync_trace = self._last_sync_trace, None
        if stashed is not None:
            # a slice step: compute to the gradients in hand, the local
            # post, the wait for the peer slices, the update
            ready = max(cursor, stashed["grads_ready"] - t_step)
            post = max(ready, stashed["local_post"] - t_step)
            coll = max(post, stashed["collect_done"] - t_step)
            apply_end = max(coll, stashed["apply_done"] - t_step)
            phases += [("compute", cursor, ready - cursor),
                       ("local_post", ready, post - ready),
                       ("cross_slice_wait", post, coll - post),
                       ("apply", coll, apply_end - coll)]
            compute_end = max(apply_end, t_compute_end - t_step)
            if stashed.get("peers"):
                peers = {sid: max(0.0, t - t_step)
                         for sid, t in stashed["peers"].items()}
        else:
            compute_end = max(cursor, t_compute_end - t_step)
            phases.append(("compute", cursor, compute_end - cursor))
        host_end = max(compute_end, t_host_end - t_step)
        phases.append(("host_sync", compute_end, host_end - compute_end))
        if ckpt_s > 0:
            phases.append(("checkpoint", host_end, ckpt_s))
        # the membership episode: the slice sync's world epoch, else the
        # applied plan's (0 without)
        self._steptrace.record(step, self._trace_generation(), t0_wall,
                               phases, peers=peers)

    def _trace_generation(self) -> int:
        """The episode step-trace records group under: the world epoch
        the slice sync saw last, else the applied plan's epoch, else 0 (a
        static world)."""
        if self._slice_sync is not None and self._slice_sync.world_epoch >= 0:
            return self._slice_sync.world_epoch
        if self._shard_plan is not None:
            try:
                return int(self._shard_plan.get("epoch", 0) or 0)
            except (TypeError, ValueError):
                pass
        return 0

    # -- slice mode ----------------------------------------------------------
    def _slice_step(self, state: TrainState, tok, tgt, step: int):
        """One slice-mode step: the in-slice mean gradients from
        ``grad_step``, their cross-slice mean through the host
        (tolerating an absent slice: a degraded step), and the update
        from the fleet mean. The pre-update state is the rejoin handoff
        the fleet's leader may publish for a re-formed slice."""
        grads, metrics = self.trainer.grad_step(state, tok, tgt)
        names = list(grads)
        reduced, info = self._slice_sync.reduce(
            [_grad_to_host(grads[name]) for name in names], step,
            state_leaves_fn=lambda: [_exact_to_host(t)
                                     for t in _state_tensors(state)])
        if info.get("degraded") or info.get("stalled_s"):
            obs.get_flight_recorder().record_event(
                "train_degraded_step", step=step,
                present=info.get("present"), absent=info.get("absent"),
                stalled_s=round(float(info.get("stalled_s", 0.0)), 1))
        with torch.no_grad():
            for name, leaf in zip(names, reduced):
                grads[name].copy_(torch.from_numpy(np.asarray(leaf)))
        state, apply_metrics = self.trainer.apply_grads(state, grads)
        if self._steptrace is not None and info.get("trace"):
            # the sync's marks share the loop's monotonic clock; the
            # update's dispatch end completes the decomposition
            self._last_sync_trace = dict(info["trace"],
                                         apply_done=time.monotonic())
        return state, dict(metrics, **apply_metrics)

    def _maybe_slice_catch_up(self, state: TrainState, start_step: int,
                              sampler) -> Tuple[TrainState, int]:
        """A re-formed slice restored at the checkpointed step while the
        fleet kept stepping degraded: adopt the fleet-current state a
        surviving slice's leader publishes, so this slice resumes in
        lockstep, and advance the sampler by the steps it skips."""
        result = self._slice_sync.catch_up(start_step)
        if result is None:
            return state, start_step
        leaves, fleet_step = result
        _init_optimizer_state(state.optimizer)
        tensors = _state_tensors(state)
        if len(leaves) != len(tensors):
            logger.error(
                "fleet state handoff has %d leaves, the local state %d: "
                "model mismatch; ignoring the handoff", len(leaves),
                len(tensors))
            return state, start_step
        with torch.no_grad():
            for tensor, leaf in zip(tensors, leaves):
                _exact_from_host(tensor, np.asarray(leaf))
        state.step = fleet_step
        if sampler is not None:
            for _ in range(max(0, fleet_step - start_step)):
                sampler.record_batch(self.global_batch)
        self.last_restore_timings["catch_up_steps"] = float(
            fleet_step - start_step)
        return state, fleet_step

    # -- preemption drain --------------------------------------------------
    def _consume_drain(self, drain: Dict[str, Any], step: int, state,
                       sampler) -> None:
        """Act on a drain or checkpoint request from the agent at a step
        boundary. ``exit=True`` (preemption): deadline-bounded emergency
        save, the timeline, telemetry and the flight record flushed, then
        the clean-drain exit (raises :class:`DrainExit`). ``exit=False``
        (the master's urgent checkpoint fan-out to survivors): save now,
        stage the cut into the peer cache, keep training."""
        deadline = float(drain.get("deadline", 0.0) or 0.0)
        reason = str(drain.get("reason", ""))
        exit_worker = bool(drain.get("exit", True))
        recorder = obs.get_flight_recorder()
        recorder.record_event(
            "train_drain", step=step, deadline=deadline,
            exit=exit_worker, reason=reason[:256])
        logger.warning(
            "drain request at step %d (deadline in %.0fs, exit=%s): %s",
            step, max(0.0, deadline - time.time()) if deadline else -1.0,
            exit_worker, reason or "-")
        outcome = "no-checkpointer"
        data_state = self._data_state(sampler)
        if self.checkpointer is not None:
            # the deadline bounds the save only on the way OUT (this
            # machine goes away then); a survivor's save-and-continue
            # inherits the draining peer's deadline, which is advisory
            outcome = self.checkpointer.save_emergency(
                step, state, data_state,
                deadline=deadline if exit_worker else 0.0)
            if outcome == "saved" and not exit_worker:
                # a survivor's cut is what the departing rank's
                # replacement restores from; the exiting path skips it:
                # this host's memory goes with it
                self._stage_peer(step, data_state)
        elif exit_worker:
            logger.error("drain with no checkpointer configured: exiting "
                         "WITHOUT saving (progress since the last external "
                         "save is lost)")
        if not exit_worker:
            self._drain_source.acknowledge(int(drain.get("seq", 0) or 0))
            return
        # the way out: postmortem and telemetry first, then the distinct
        # clean-drain exit the agent classifies as non-failure
        if self._timeline_path:
            self.timeline.export(self._timeline_path)
        recorder.record_event("train_drained", step=step,
                              checkpoint=outcome)
        self._flush_telemetry()
        recorder.dump(reason="drain")
        logger.info("drained at step %d (checkpoint: %s); exiting %d",
                    step, outcome, WorkerExit.DRAIN)
        raise DrainExit(reason)

    def _stage_peer(self, step: int, data_state) -> None:
        """Mirror the save's host copy into the peer cache. The loop has
        paid only the device→host copy (inside the save); the file writes
        and CRCs run on the store's writer thread. Best-effort: the loop
        survives a full cache disk."""
        if self._peer_store is None:
            return
        t0 = time.monotonic()
        with obs.span("peer_stage", {"step": step}) as stage_span:
            staged = self._peer_store.stage(
                step, self.checkpointer.exact_host_items(), data_state,
                defer_write=True)
            stage_span.set_attr("staged", staged)
        obs.get_registry().gauge(
            "dlrover_tpu_peer_stage_seconds",
            "Step-loop wall-clock of the last peer-state staging "
            "(host copy only; the write is deferred)").set(
            time.monotonic() - t0)

    def _data_state(self, sampler) -> Dict[str, Any]:
        data_state: Dict[str, Any] = {}
        if sampler is not None:
            data_state["sampler"] = sampler.state_dict()
        if self.client is not None:
            try:
                shards = self.client.get_shard_checkpoint("")
                # "" when no dataset is registered (purely local data)
                if shards:
                    data_state["shards"] = shards
            except Exception:  # noqa: BLE001 — the save must not fail
                pass
        return data_state

    def _flush_telemetry(self) -> None:
        if self.client is not None:
            self._span_exporter.flush_to(self.client)
            if self._steptrace is not None:
                self._steptrace.flush_to(self.client)

    def close(self) -> None:
        """Flush the last spans, wait for the last save, restore the
        SIGTERM handler and drop the trainer (and with it the device
        memory it holds). A deferred peer-cache write still in flight
        lands first: it is the point of the mirror."""
        self._flush_telemetry()
        obs.remove_span_sink(self._span_exporter)
        if self._peer_store is not None:
            self._peer_store.flush()
        if self.checkpointer is not None:
            self.checkpointer.close()
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None
        self.trainer = None


# -- slice mode's host leaves ------------------------------------------------


def _state_tensors(state: TrainState) -> list:
    """The state's tensors in a fixed order, the same on every slice:
    each parameter by name, then each parameter's optimizer state by
    key."""
    params = [p for _, p in state.model.named_parameters()]
    tensors = list(params)
    for p in params:
        moments = state.optimizer.state.get(p, {})
        tensors += [moments[k] for k in sorted(moments)
                    if torch.is_tensor(moments[k])]
    return tensors


def _grad_to_host(grad: torch.Tensor) -> np.ndarray:
    """A gradient as host numpy for the cross-slice mean: f32 for a bf16
    one (numpy has no bf16; the mean casts back to the gradient's dtype
    when it is copied in)."""
    local = to_local(grad).detach()
    if local.dtype == torch.bfloat16:
        local = local.float()
    return local.cpu().numpy()


def _exact_to_host(tensor: torch.Tensor) -> np.ndarray:
    """A state tensor's bits as host numpy (a bf16 one as int16)."""
    local = to_local(tensor).detach()
    if local.dtype == torch.bfloat16:
        local = local.view(torch.int16)
    return local.cpu().numpy()


def _exact_from_host(tensor: torch.Tensor, leaf: np.ndarray) -> None:
    """Copy the bits ``_exact_to_host`` gave back into ``tensor``."""
    local = to_local(tensor)
    value = torch.from_numpy(np.ascontiguousarray(leaf))
    if local.dtype == torch.bfloat16:
        value = value.view(torch.bfloat16)
    local.copy_(value.reshape(local.shape))
