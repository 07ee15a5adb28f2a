"""Control-plane message payloads.

Own copy of the JAX package's ``common/messages.py``: every master↔agent
interaction is a typed dataclass carried over the two-method service of
``common/comm.py`` (``get``, ``report``). The classes, their fields,
defaults and field order are the JAX package's (a test holds each equal).
Deserialization goes through a restricted unpickler that admits only the
classes defined in this module plus plain builtins, so a compromised
peer cannot instantiate arbitrary objects.

The wire is the JAX package's, byte for byte: a message is pickled under
the JAX module's name (``dlrover_tpu.common.messages.<Name>``, without
importing that module), and the unpickler maps those names onto this
module's classes. A torch worker can therefore talk to a JAX master and
a JAX worker to the port's master.
"""

from __future__ import annotations

import io
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class Message:
    """Base class for all control-plane payloads."""


# --------------------------------------------------------------------------
# Serialization with a class allowlist.
# --------------------------------------------------------------------------

_SAFE_BUILTINS = {
    "dict", "list", "tuple", "set", "frozenset", "bytes", "bytearray",
    "str", "int", "float", "bool", "complex", "NoneType",
}


# the module name the messages travel under: the JAX package's, so that
# either side's unpickler admits the other's payloads
WIRE_MODULE = "dlrover_tpu.common.messages"


class _WirePickler(pickle._Pickler):
    """The standard pickler (protocol 5, same opcodes as the C one) that
    names this module's message classes by their wire module. The C
    pickler cannot: it imports a class's module to check the reference."""

    def save_global(self, obj, name=None):
        if (isinstance(obj, type) and issubclass(obj, Message)
                and obj.__module__ == __name__):
            self.save(WIRE_MODULE)
            self.save(obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        # dotted names resolve attribute chains (e.g. "pickle.loads" via
        # any allowed module): never allow them
        if "." in name:
            raise pickle.UnpicklingError(
                f"forbidden dotted name in control-plane message: "
                f"{module}.{name}"
            )
        if module == WIRE_MODULE:
            candidate = globals().get(name)
            if isinstance(candidate, type) and issubclass(candidate, Message):
                return candidate
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"forbidden class in control-plane message: {module}.{name}"
        )


def serialize_message(message: Message) -> bytes:
    buffer = io.BytesIO()
    _WirePickler(buffer, protocol=pickle.HIGHEST_PROTOCOL).dump(message)
    return buffer.getvalue()


def deserialize_message(data: bytes) -> Optional[Message]:
    if not data:
        return None
    return _RestrictedUnpickler(io.BytesIO(data)).load()


# --------------------------------------------------------------------------
# Generic / bookkeeping
# --------------------------------------------------------------------------


@dataclass
class BaseRequest(Message):
    node_id: int = -1
    node_type: str = ""


@dataclass
class Response(Message):
    success: bool = True
    reason: str = ""


# --------------------------------------------------------------------------
# Dynamic data sharding (reference: TaskRequest/Task/ShardConfig …)
# --------------------------------------------------------------------------


@dataclass
class Shard(Message):
    start: int = 0
    end: int = 0
    indices: Optional[List[int]] = None  # for shuffled text datasets
    record_offsets: Optional[List[int]] = None


@dataclass
class Task(Message):
    task_id: int = -1
    task_type: str = ""          # TaskType.*
    dataset_name: str = ""
    shard: Shard = field(default_factory=Shard)
    epoch: int = 0

    @property
    def is_empty(self) -> bool:
        return self.task_id < 0


@dataclass
class TaskRequest(Message):
    dataset_name: str = ""
    worker_id: int = -1


@dataclass
class TaskResult(Message):
    dataset_name: str = ""
    task_id: int = -1
    worker_id: int = -1
    success: bool = True
    err_message: str = ""


@dataclass
class DatasetShardParams(Message):
    """Register a dataset for dynamic sharding."""

    dataset_name: str = ""
    dataset_size: int = 0
    shard_size: int = 0          # records per shard (batch_size × steps)
    num_epochs: int = 1
    shuffle: bool = False
    task_type: str = ""
    storage_type: str = "text"   # "table" (range-only) | "text" (indices)
    num_minibatches_per_shard: int = 0


@dataclass
class ShardCheckpointRequest(Message):
    dataset_name: str = ""


@dataclass
class ShardCheckpoint(Message):
    dataset_name: str = ""
    content: str = ""            # JSON-encoded DatasetShardCheckpoint


@dataclass
class DatasetMeta(Message):
    dataset_name: str = ""


@dataclass
class DatasetEpochInfo(Message):
    dataset_name: str = ""
    epoch: int = 0


@dataclass
class TaskCounts(Message):
    dataset_name: str = ""
    todo: int = 0
    doing: int = 0
    done: int = 0


# --------------------------------------------------------------------------
# Rendezvous (reference: JoinRendezvousRequest / CommWorldRequest …)
# --------------------------------------------------------------------------


@dataclass
class JoinRendezvousRequest(Message):
    node_id: int = -1
    node_rank: int = -1
    local_world_size: int = 1    # devices (chips) on this host
    rdzv_name: str = ""
    node_ip: str = ""
    # span parent context (obs.current_context()) so the master-side join
    # span shares the agent's trace; {} = sender predates the field
    trace: Dict[str, str] = field(default_factory=dict)
    # ICI slice this host belongs to (multi-slice hierarchical DP):
    # activates slice-scoped rendezvous — per-slice worlds and
    # generation tokens, a slice-local failure re-forms only that
    # slice. -1 = single-slice job / sender predates the field.
    slice_id: int = -1


@dataclass
class JoinRendezvousResult(Message):
    # The round this joiner will be placed in; the agent re-joins if it sees
    # get_comm_world advance past this round without including it (world
    # invalidated by a member death, or dropped by node_unit rounding).
    round: int = 0
    # Master generation token (bumped each master (re)start over one state
    # lineage): agents remember it and present it on reconnect so a
    # restarted master can tell re-registration from a new joiner.
    generation: int = 0
    # Peer-to-peer restore plan for this rank (checkpoint/peer_restore.py):
    # JSON {"epoch", "step", "entries": {shard_key: {"rank", "addr"}}}
    # mapping each staged shard to a surviving donor. "" = no donors (or
    # sender predates the field); the worker re-fetches via
    # RestorePlanRequest anyway — this copy serves workers with no master
    # client and records the plan at the re-rendezvous cut.
    restore_plan_json: str = ""
    # Online parallelism re-plan for the joining world
    # (parallel/planner.py): the deterministic DP×TP×PP(×DCN) mesh +
    # batch/accumulation shape chosen for the NEW world size, stamped
    # with the rendezvous generation token and world epoch. "" = no
    # planner input yet / sender predates the field; workers re-fetch
    # fresh via ShardPlanRequest at loop build.
    shard_plan_json: str = ""
    # Coordination-tier address (master/coord_service.py): hot KV
    # traffic (dcn/ gradient exchange, coord/ barriers) dials this
    # instead of the control tier. "" = tier not split out.
    coord_addr: str = ""


@dataclass
class ReconnectRequest(Message):
    """An agent in master-lost mode re-registering with a (possibly
    restarted) master. Carries everything the master needs to decide
    whether the agent's cached world is still valid."""

    node_id: int = -1
    node_rank: int = -1
    node_type: str = ""
    local_world_size: int = 1
    rdzv_name: str = ""
    # the generation the agent last saw (0 = it never learned one)
    generation: int = 0
    # the last completed round the agent was placed in (-1 = none)
    rdzv_round: int = -1
    # see JoinRendezvousRequest.slice_id
    slice_id: int = -1


@dataclass
class ReconnectResult(Message):
    generation: int = 0
    # True: the agent's rank is in the master's latest world for the
    # round the agent reported — keep the worker running. False: the
    # world moved on (or was never restored); re-join rendezvous.
    world_intact: bool = False
    round: int = -1
    # the (possibly promoted) master's coordination-tier address; a
    # standby's tier binds a fresh port, so reconnecting clients must
    # re-learn it ("" = tier not split out)
    coord_addr: str = ""


@dataclass
class LeaveRendezvousRequest(Message):
    """A joiner abandoning an uncompleted round (poll deadline). Without
    this, its stale entry lets a late partner complete a round with a
    peer that already gave up."""

    node_id: int = -1
    node_rank: int = -1
    rdzv_name: str = ""


@dataclass
class WaitingNodeNumRequest(Message):
    node_id: int = -1
    rdzv_name: str = ""


@dataclass
class WaitingNodeNum(Message):
    waiting_num: int = 0


@dataclass
class CommWorldRequest(Message):
    node_id: int = -1
    rdzv_name: str = ""


@dataclass
class CommWorld(Message):
    rdzv_name: str = ""
    round: int = 0
    group: int = 0
    # node_rank → local_world_size
    world: Dict[int, int] = field(default_factory=dict)


@dataclass
class PeerStoreReport(Message):
    """An agent advertising its host's staged peer-state cache
    (checkpoint/peer_restore.py): which shards of which step its donor
    server can serve to a replacement rank. step < 0 (or no keys) =
    nothing staged — the master drops the registration."""

    node_id: int = -1
    node_rank: int = -1
    addr: str = ""               # donor server "ip:port"
    step: int = -1
    rdzv_name: str = ""
    keys: List[str] = field(default_factory=list)
    total_bytes: int = 0
    # donor's ICI slice: restore plans prefer same-slice donors (ICI
    # bandwidth) before cross-slice (DCN) ones. -1 = no slice.
    slice_id: int = -1


@dataclass
class RestorePlanRequest(Message):
    """A restoring worker asking for a (fresh) peer-restore plan —
    or, with epoch_only, just the current world epoch: the staleness
    guard re-checks it immediately before committing a transfer."""

    node_id: int = -1
    node_rank: int = -1
    rdzv_name: str = ""
    epoch_only: bool = False
    # resharding mode (online re-plan migration): entries list EVERY
    # same-step holder of each shard so the receiver stripes byte
    # ranges across donors in parallel — who sends which shard SLICE to
    # whom when the target sharding differs from the source
    stripe: bool = False


@dataclass
class RestorePlan(Message):
    plan_json: str = ""          # JSON plan dict ("" with epoch_only)
    # world epoch the plan was computed at (bumped on every membership
    # loss): a plan whose epoch no longer matches must not commit
    epoch: int = 0
    step: int = -1
    found: bool = False


@dataclass
class ShardPlanRequest(Message):
    """A worker (or tool) asking for the current parallelism plan for
    its world (parallel/planner.py via the rendezvous manager): the
    deterministic mesh + batch shape every rank of the new world must
    agree on. The plan is recomputed from live membership, so a worker
    spawned after the cut sees the cut world's plan."""

    node_id: int = -1
    node_rank: int = -1
    rdzv_name: str = ""


@dataclass
class ShardPlanResult(Message):
    plan_json: str = ""          # JSON plan dict ("" = no plan)
    # world epoch the plan was computed at (same staleness discipline
    # as RestorePlan: a membership loss after computation bumps it)
    epoch: int = 0
    generation: int = 0
    found: bool = False


@dataclass
class SliceStatusRequest(Message):
    """A worker's cross-slice gradient sync asking which slices are
    currently formed (parallel/dcn_sync.py): the PRESENT set the
    degraded-mode renormalization divides by."""

    node_id: int = -1
    node_rank: int = -1
    rdzv_name: str = ""


@dataclass
class SliceStatus(Message):
    """JSON {"total": n, "fleet_step": s, "slices": {sid: {"formed":
    bool, "ranks": [...], "generation": g, "draining": bool}}} — the
    master's slice registry view plus the job step high-water mark
    (the re-formed slice's catch-up target)."""

    status_json: str = ""


@dataclass
class NetworkStatusReport(Message):
    node_id: int = -1
    normal: bool = True
    elapsed_time: float = 0.0


@dataclass
class NetworkCheckResultRequest(Message):
    node_id: int = -1


@dataclass
class NetworkCheckVerdict(Message):
    normal: bool = True
    is_straggler: bool = False
    reason: str = ""


# --------------------------------------------------------------------------
# KV store (reference: KeyValuePair)
# --------------------------------------------------------------------------


@dataclass
class KeyValuePair(Message):
    key: str = ""
    value: bytes = b""


@dataclass
class KVGetRequest(Message):
    key: str = ""


@dataclass
class KVAddRequest(Message):
    key: str = ""
    amount: int = 0


@dataclass
class KVWaitRequest(Message):
    """Server-side blocking wait on keys (bounded by the RPC deadline)."""

    keys: List[str] = field(default_factory=list)
    timeout_s: float = 10.0


@dataclass
class KVIntResult(Message):
    value: int = 0


# --------------------------------------------------------------------------
# Node health / lifecycle (reference: NodeFailure, GPUStats …)
# --------------------------------------------------------------------------


@dataclass
class NodeFailureReport(Message):
    node_id: int = -1
    node_rank: int = -1
    error_data: str = ""
    level: str = ""              # TrainingMsgLevel.*
    restart_count: int = 0
    # NodeExitReason.* classification of the worker exit (WorkerExit.
    # classify): the diagnosis layer must tell hang from crash from
    # drain. "" = sender predates the field.
    exit_kind: str = ""


@dataclass
class DrainReport(Message):
    """The advance-notice drain protocol (agent → master).

    phase="notice": this node received a preemption notice and is
    draining — it will emergency-checkpoint and depart by ``deadline``
    (unix ts). The master marks the rank DRAINING, fans out urgent
    ``checkpoint`` actions and pre-plans the post-departure world.

    phase="complete": the worker exited with the clean-drain code; the
    master removes the rank NOW (planned departure) so survivors re-form
    in one round instead of waiting out the liveness timeout."""

    node_id: int = -1
    node_rank: int = -1
    deadline: float = 0.0        # unix ts the VM disappears at
    reason: str = ""             # notice source / chaos tag
    phase: str = "notice"        # "notice" | "complete"


@dataclass
class DrainResult(Message):
    success: bool = True
    # ranks the master queued urgent checkpoint actions for (phase=
    # notice): lets the draining agent log the blast radius
    checkpoint_ranks: List[int] = field(default_factory=list)


@dataclass
class ChipStats(Message):
    index: int = 0
    # < 0 = unknown (the exporter derives a duty-cycle proxy only when
    # it has consecutive samples to derive it FROM; 0.0 would be a lie)
    duty_cycle_pct: float = -1.0
    hbm_used_mb: float = 0.0
    hbm_total_mb: float = 0.0
    # allocator peak high-water mark (memory_stats peak_bytes_in_use,
    # obs/device.py): the IN-step transient the between-steps
    # bytes_in_use sample misses — what HbmPressureRule judges. < 0 =
    # unknown / sender predates the field.
    hbm_peak_mb: float = -1.0


@dataclass
class NodeResourceStats(Message):
    node_id: int = -1
    node_type: str = ""
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    # rendezvous rank (see NodeHeartbeat.node_rank): the diagnosis
    # engine keys all per-worker evidence by rank — node_id diverges
    # from rank after a relaunch. -1 = sender predates the field.
    node_rank: int = -1
    chip_stats: List[ChipStats] = field(default_factory=list)


@dataclass
class NodeHeartbeat(Message):
    node_id: int = -1
    node_type: str = ""
    timestamp: float = 0.0
    # rendezvous liveness is keyed by RANK (node_id diverges from rank
    # after a relaunch, run.py); -1 = sender predates the field
    node_rank: int = -1


@dataclass
class NodeAddressReport(Message):
    node_id: int = -1
    node_rank: int = -1
    addr: str = ""


@dataclass
class GlobalStepReport(Message):
    node_id: int = -1
    step: int = 0
    timestamp: float = 0.0
    node_rank: int = -1        # see NodeHeartbeat.node_rank
    # per-worker speed evidence for the diagnosis engine: mean wall time
    # per step and mean data-wait fraction over the sender's report
    # window (from the worker's phase timeline, obs/timeline.py).
    # 0.0 / -1.0 = sender predates the fields or has no timeline.
    step_time_s: float = 0.0
    data_wait_fraction: float = -1.0
    # achieved-vs-peak model-FLOPs utilization over the sender's report
    # window (obs/mfu.py; needs the worker's FLOPs model + peak). -1.0 =
    # sender predates the field or has no FLOPs model — the collapse
    # rule then falls back to raw steps/s.
    mfu: float = -1.0
    # steps in this report window the sender's slice took in DEGRADED
    # mode (gradient mean renormalized over present slices while a peer
    # slice was absent, parallel/dcn_sync.py). 0 = none / predates.
    degraded_steps: int = 0
    # device-truth HBM peak watermark over the report window
    # (obs/device.py: jax memory_stats peak-bytes — the transient
    # IN-step peak, not the between-steps trough). 0 = backend has no
    # memory stats (CPU) / sender predates the field.
    hbm_peak_bytes: float = 0.0
    # the generation of the shard plan the sender's loop ACTUALLY
    # applied (parallel/calibration.py attributes the timing evidence
    # by this, so an old incarnation's straggling report can never
    # land on a shape it did not run). >= 0 = a stamped plan's
    # generation; -1 = sender predates the field (the master falls
    # back to current-signature attribution); -2 = sender is running
    # the replan FALLBACK mesh (not the stamped plan — dropped).
    plan_generation: int = -1


@dataclass
class ModelInfo(Message):
    """Static model stats fed to the resource optimizer (reference:
    common/grpc.py ModelInfo; profile_extractor)."""

    param_count: int = 0
    param_bytes: int = 0
    flops_per_step: float = 0.0
    # the CONFIGURED global batch (the planner's requested baseline: a
    # re-plan that shrank the batch must not ratchet the profile down
    # — a later grow should restore the full batch)
    batch_size: int = 0
    seq_len: int = 0
    # the batch actually trained per step right now (re-plan adjusted;
    # 0 = same as batch_size) — what tokens/s gauges scale by
    effective_global_batch: int = 0
    # model-FLOPs accounting (obs/mfu.py): FLOPs per trained token
    # (fwd+bwd, causal-discounted attention term), the sender's per-chip
    # bf16 peak, and the global chip count its mesh spans — the master's
    # MFU gauges are tokens/s × flops_per_token / (peak × chips).
    # 0 = sender predates the fields.
    flops_per_token: float = 0.0
    peak_flops_per_chip: float = 0.0
    chips: int = 0
    # "analytic" (6·params formula) or "cost_analysis" (cross-checked
    # against the compiled step's XLA cost analysis)
    flops_source: str = ""
    # model-dim divisibility granules for the parallelism planner
    # (parallel/planner.py): a tensor axis is only feasible when it
    # divides tensor_divisor (gcd of heads/kv-heads/mlp/vocab dims),
    # an fsdp axis when it divides fsdp_divisor (the embed dim). 0 =
    # unknown — the planner then relies on the worker-side trace probe
    # + loud fallback.
    tensor_divisor: int = 0
    fsdp_divisor: int = 0


# --------------------------------------------------------------------------
# Elastic / scaling control (reference: ParallelConfig, ScalePlan relay)
# --------------------------------------------------------------------------


@dataclass
class ParallelConfig(Message):
    """Master-tuned runtime knobs the worker hot-reloads (reference:
    paral_config_tuner.py + ElasticDataLoader hot-reload)."""

    dataloader_batch_size: int = 0
    dataloader_workers: int = 0
    learning_rate: float = 0.0
    grad_accum_steps: int = 0
    version: int = 0


@dataclass
class ParallelConfigRequest(Message):
    node_id: int = -1


@dataclass
class ScaleRequest(Message):
    """Manual/auto scale plan relayed to the master (reference: ScalePlan CRD)."""

    node_type: str = ""
    count: int = 0
    cpu: float = 0.0
    memory_mb: float = 0.0


@dataclass
class JobStatusRequest(Message):
    pass


@dataclass
class JobStatus(Message):
    stage: str = ""
    exit_reason: str = ""


@dataclass
class SyncJoinRequest(Message):
    """Named barrier join (reference: sync_service.py)."""

    sync_name: str = ""
    node_id: int = -1


@dataclass
class SyncFinishRequest(Message):
    sync_name: str = ""


@dataclass
class SyncQueryRequest(Message):
    sync_name: str = ""


@dataclass
class ClusterVersionRequest(Message):
    """PS-style cluster version arbitration (reference: elastic_ps.py)."""

    task_type: str = ""
    task_id: int = 0
    version_type: str = ""       # "local" | "global" | "restored"
    version: int = 0


@dataclass
class ClusterVersion(Message):
    version: int = 0


# --------------------------------------------------------------------------
# Telemetry (obs/): agent/worker → master metrics + spans
# --------------------------------------------------------------------------


@dataclass
class MetricSample(Message):
    """One registry operation to replay on the master's registry."""

    kind: str = "gauge"          # "counter" (inc) | "gauge" (set) |
    #                              "histogram" (observe)
    name: str = ""
    value: float = 0.0
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class TelemetryReport(Message):
    """Batched metric samples + finished spans from a node (obs/).

    Spans ride as JSON (list of span dicts, `Span.to_dict`) so the
    payload stays allowlist-friendly and schema-stable across versions.
    """

    node_id: int = -1
    node_rank: int = -1
    node_type: str = ""
    samples: List[MetricSample] = field(default_factory=list)
    spans_json: str = ""
    # batched per-step trace records (obs/steptrace.py record dicts),
    # same JSON-in-string convention as spans_json; "" = none
    steptrace_json: str = ""


# --------------------------------------------------------------------------
# Training diagnosis (master/diagnosis/): reports + the action grammar
# --------------------------------------------------------------------------


@dataclass
class DiagnosisActionRequest(Message):
    """An agent polling for actions the diagnosis engine addressed to its
    rank (observe / profile:{rank} / restart:{rank} / alert)."""

    node_id: int = -1
    node_rank: int = -1


@dataclass
class DiagnosisActions(Message):
    """Actions popped for the polling rank. JSON list of action dicts
    ({"id", "kind", "rank", "reason", ...}) — allowlist-friendly and
    schema-stable across versions, like TelemetryReport.spans_json."""

    actions_json: str = ""


@dataclass
class DiagnosisReportRequest(Message):
    """tools/diagnose.py asking a live master for recent reports
    (limit = 0 → everything retained)."""

    limit: int = 0


@dataclass
class DiagnosisReports(Message):
    reports_json: str = ""       # JSON list of DiagnosisReport dicts


@dataclass
class TimeSeriesQuery(Message):
    """tools/top.py (or any scraper) asking the master's time-series
    store (obs/tsdb.py) for windowed, aligned history. ``name`` may end
    with ``*`` for a prefix match; "" lists available series names.
    ``labels`` is a subset filter; ``resolution_s`` 0 = auto (raw when
    it covers the window, else the finest covering tier)."""

    name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    window_s: float = 0.0
    resolution_s: float = 0.0


@dataclass
class TimeSeriesResult(Message):
    """JSON TimeSeriesStore.query_payload dict: {"series": [...],
    "tiers": [...], "stats": {...}} (or {"names": [...]} for a listing).
    "" = master has no time-series store."""

    result_json: str = ""


@dataclass
class PlanCalibrationRequest(Message):
    """The planner calibration table (parallel/calibration.py):
    predicted vs measured step time / MFU per applied shard-plan
    signature, plus the learned per-axis discounts."""

    pass


@dataclass
class PlanCalibrationReport(Message):
    report_json: str = ""        # JSON {"table": [...], "discounts": {}}


@dataclass
class GoodputRequest(Message):
    """tools/goodput.py asking a live master for the goodput ledger
    (window_s > 0 additionally returns a trailing-window summary)."""

    window_s: float = 0.0


@dataclass
class GoodputReport(Message):
    report_json: str = ""        # JSON GoodputLedger.snapshot() dict


@dataclass
class ClockProbe(Message):
    """One NTP-style clock probe (obs/steptrace.py ClockSync): the
    worker wraps this round trip in local wall-clock reads and estimates
    its offset against the master from the midpoint. The servicer
    answers immediately with its wall clock — no locks, no state — so
    the RTT (the uncertainty bound) stays honest."""

    node_id: int = -1


@dataclass
class ClockProbeResult(Message):
    server_ts: float = 0.0       # master wall clock; <= 0 = unsupported


@dataclass
class StepTraceRequest(Message):
    """tools/steptrace.py (or top.py) asking the master's
    StepTraceAssembler for assembled per-step critical paths.
    ``start_step``/``end_step`` bound the range inclusively (-1 = open);
    ``last_n`` > 0 instead returns the newest N solved steps."""

    start_step: int = -1
    end_step: int = -1
    last_n: int = 0


@dataclass
class StepTraceResult(Message):
    """JSON StepTraceAssembler.query_payload dict ({"version", "steps",
    "summary"}). "" = master has no assembler (predates steptrace)."""

    result_json: str = ""


@dataclass
class AutoscaleStatusRequest(Message):
    """tools/diagnose.py (or top.py) asking a live master for the fleet
    controller's decision history + guardrail state
    (brain/fleet_controller.py FleetController.status())."""

    pass


@dataclass
class AutoscaleStatus(Message):
    """JSON FleetController.status() dict ({"decisions", "watch",
    "quarantine", "offers", ...}). "" = controller disabled
    (fleet_controller_enabled off) or master predates it."""

    status_json: str = ""


# --------------------------------------------------------------------------
# Brain service (reference: dlrover/proto/brain.proto persist_metrics /
# optimize / get_job_metrics; dlrover/python/brain/client.py)
# --------------------------------------------------------------------------


@dataclass
class BrainMetricsReport(Message):
    """persist_metrics: one record of job runtime/meta/model metrics."""

    job_name: str = ""
    job_uuid: str = ""
    record_type: str = ""        # "job_meta" | "runtime" | "model" | "job_exit"
    payload_json: str = ""


@dataclass
class BrainOptimizeRequest(Message):
    """optimize: ask for a resource plan at a given stage."""

    job_name: str = ""
    stage: str = ""              # OptimizeStage.*
    config_json: str = ""


@dataclass
class BrainResourcePlan(Message):
    plan_json: str = ""          # {"node_group_resources": {type: {...}}}
    found: bool = False


@dataclass
class BrainJobMetricsRequest(Message):
    """get_job_metrics: fetch persisted records of a job."""

    job_name: str = ""
    record_type: str = ""


@dataclass
class BrainJobMetrics(Message):
    records_json: str = ""       # JSON list


# --------------------------------------------------------------------------
# Coworker data plane (reference: atorch/service/coworker_data_service.py,
# data_info_service.py, protos/coworker.proto)
# --------------------------------------------------------------------------


@dataclass
class CoworkerBatch(Message):
    """One preprocessed batch pushed from a CPU coworker pod."""

    dataset_name: str = ""
    payload: bytes = b""         # pickled batch (numpy trees)
    producer_id: int = -1
    seq: int = -1


@dataclass
class CoworkerBatchRequest(Message):
    dataset_name: str = ""


@dataclass
class CoworkerInfo(Message):
    """Queue depth/capacity so producers can back off (data_info_service)."""

    dataset_name: str = ""
    queued: int = 0
    capacity: int = 0
    finished: bool = False
