"""Constants of the port: the mesh's axis names, the agent's environment
contract, node and job vocabularies, and the control plane's defaults.

Own copy of the parts of the JAX package's ``common/constants.py`` that
the port uses; a test holds each equal to the original.
"""


class PlatformType:
    LOCAL = "local"          # single-machine dev: master + agents as processes
    KUBERNETES = "k8s"       # pods per host
    RAY = "ray"


class DistributionStrategy:
    ALLREDUCE = "allreduce"   # SPMD data/model parallel over a mesh
    PS = "ps"                 # parameter-server-style (elastic embeddings)
    LOCAL = "local"


class OptimizeMode:
    MANUAL = "manual"
    SINGLE_JOB = "single-job"
    CLUSTER = "cluster"       # ask the brain service for resource plans


class NodeType:
    MASTER = "master"
    WORKER = "worker"        # a host running one training process
    CHIEF = "chief"          # worker rank 0 (checkpoint writes, logging)
    EVALUATOR = "evaluator"
    PS = "ps"                # parameter-server-style state holder


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    UNKNOWN = "unknown"
    BREAKDOWN = "breakdown"  # machine-level fault (host unreachable)

    @classmethod
    def terminal(cls):
        return {cls.SUCCEEDED, cls.FAILED, cls.DELETED}


class NodeEventType:
    ADDED = "added"
    MODIFIED = "modified"
    DELETED = "deleted"


class NodeExitReason:
    SUCCEEDED = "succeeded"
    KILLED = "killed"            # deleted/force-killed by the platform
    # clean graceful drain (emergency checkpoint completed, worker exited
    # WorkerExit.DRAIN): a planned departure, not a failure
    DRAINED = "drained"
    # self-aborted by the step-hang watchdog
    HANG = "hang"
    OOM = "oom"
    FATAL_ERROR = "fatal_error"
    HARDWARE_ERROR = "hardware_error"
    UNKNOWN_ERROR = "unknown_error"
    RELAUNCHED = "relaunched"


class WorkerExit:
    """Worker exit-code vocabulary shared by the trainer (producer) and
    the agent (classifier)."""

    SUCCESS = 0
    # graceful drain after a preemption notice; outside the shell
    # (126/127) and signal (128+n) ranges
    DRAIN = 76
    # SIGABRT: the step-hang watchdog self-aborts; Popen reports -6,
    # a shell 128+6
    _SIGABRT_POPEN = -6
    _SIGABRT_SHELL = 134
    # platform SIGKILL/SIGTERM
    _KILL_CODES = (-9, -15, 137, 143)

    @classmethod
    def classify(cls, code: int, hang_enabled: bool = True) -> str:
        """Exit code → NodeExitReason.*. With the hang watchdog off a
        SIGABRT is an ordinary crash and charges the relaunch budget."""
        if code == cls.SUCCESS:
            return NodeExitReason.SUCCEEDED
        if code == cls.DRAIN:
            return NodeExitReason.DRAINED
        if code in (cls._SIGABRT_POPEN, cls._SIGABRT_SHELL):
            return (NodeExitReason.HANG if hang_enabled
                    else NodeExitReason.UNKNOWN_ERROR)
        if code in cls._KILL_CODES:
            return NodeExitReason.KILLED
        return NodeExitReason.UNKNOWN_ERROR

    @classmethod
    def to_exit_status(cls, code: int) -> int:
        """Popen's negative signal codes → the POSIX 128+N exit status."""
        return 128 - code if code < 0 else code


class JobStage:
    CREATED = "created"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    STOPPING = "stopping"


class RendezvousName:
    TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"


class NodeEnv:
    """The environment contract between master, agent and worker."""

    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    # file a (re)started master writes its address into
    MASTER_BOOTSTRAP = "DLROVER_TPU_MASTER_BOOTSTRAP_FILE"
    # coordination-tier address ("" = single-tier master)
    COORD_ADDR = "DLROVER_TPU_COORD_ADDR"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_TYPE = "DLROVER_TPU_NODE_TYPE"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    # per worker (set by the agent for the process it spawns)
    WORLD_SIZE = "DLROVER_TPU_WORLD_SIZE"          # number of processes
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"          # this process's rank
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR"   # host:port of rank 0
    RDZV_ROUND = "DLROVER_TPU_RDZV_ROUND"
    PARAL_CONFIG_PATH = "DLROVER_TPU_PARAL_CONFIG"
    DEVICES_PER_NODE = "DLROVER_TPU_DEVICES_PER_NODE"
    # worker → agent handoff files
    METRICS_FILE = "DLROVER_TPU_METRICS_FILE"
    CHIP_STATS_FILE = "DLROVER_TPU_CHIP_STATS"
    # per-step phase timeline the worker exports (obs/timeline.py)
    TIMELINE_FILE = "DLROVER_TPU_TIMELINE_FILE"
    PROFILE_REQUEST_FILE = "DLROVER_TPU_PROFILE_REQUEST"
    DRAIN_REQUEST_FILE = "DLROVER_TPU_DRAIN_REQUEST"
    PEER_CACHE_DIR = "DLROVER_TPU_PEER_CACHE_DIR"
    RESTORE_PLAN_FILE = "DLROVER_TPU_RESTORE_PLAN"
    SHARD_PLAN_FILE = "DLROVER_TPU_SHARD_PLAN"
    RESIZE_REQUEST_FILE = "DLROVER_TPU_RESIZE_REQUEST"
    NUM_SLICES = "DLROVER_TPU_NUM_SLICES"
    PREEMPTION_NOTICE_FILE = "DLROVER_TPU_PREEMPTION_NOTICE"
    PREEMPTION_AT = "DLROVER_TPU_PREEMPTION_AT"
    SLICE_ID = "DLROVER_TPU_SLICE_ID"


class TrainingMsgLevel:
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    RDZV_ERROR = "rdzv_error"
    WARNING = "warning"
    INFO = "info"


class TaskType:
    """Dynamic-sharding task types."""

    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"
    WAIT = "wait"
    NONE = "none"


class MeshAxis:
    """Canonical named mesh axes."""

    # cross-slice data parallelism over the slow fabric: the OUTERMOST
    # axis
    DCN = "dcn"
    DATA = "data"
    FSDP = "fsdp"
    TENSOR = "tensor"
    SEQUENCE = "sequence"
    EXPERT = "expert"
    PIPE = "pipe"

    ALL = ("dcn", "data", "fsdp", "tensor", "sequence", "expert", "pipe")


class DefaultValues:
    """The defaults of the knobs the ported modules read (``Context``)."""

    METRICS_PORT = 0                # /metrics exposition; 0 → free port,
    #                                 -1 → disabled
    RDZV_TIMEOUT_S = 600.0
    RDZV_WAIT_NEW_NODE_S = 30.0     # grace window for extra nodes past min
    TASK_TIMEOUT_S = 1800.0
    HANG_SECONDS = 1800.0
    SECONDS_PER_SCALE_CHECK = 60.0
    # an agent silent this long is declared dead and its world
    # invalidated
    DEAD_NODE_TIMEOUT_S = 90.0
    MAX_RELAUNCH = 3
    GRPC_MAX_MESSAGE_MB = 64
    # client-side RPC budget (agent/master_client.py retry_rpc)
    RPC_TIMEOUT_S = 30.0
    RPC_RETRIES = 10
    RPC_BACKOFF_S = 0.5
    RPC_BACKOFF_MAX_S = 15.0
    # master-loss handling (agent/elastic_agent.py): how long an agent
    # keeps its worker alive while reconnecting to a restarted master
    MASTER_RECONNECT_TIMEOUT_S = 1800.0
    # crash-consistent master state (master/state_backend.py)
    MASTER_SNAPSHOT_RETAIN = 5
    # 0 = write-through (a snapshot per control-plane mutation); > 0
    # coalesces snapshots to at most one per interval, at the cost of up
    # to that much durability lag on a crash
    MASTER_SNAPSHOT_MIN_INTERVAL_S = 0.0
    # the KV/coordination tier's own port (master/coord_service.py):
    # 0 = any free port, -1 = serve coordination on the main port only
    COORD_PORT = 0
    # bounded telemetry ingest: reports queued past this are dropped
    # oldest-first (dlrover_tpu_telemetry_dropped_total)
    TELEMETRY_QUEUE_SIZE = 256
    KV_GC_KEEP_GENERATIONS = 2
    # the hot-standby master (master/standby.py): cadence of its primary
    # health probe, and how many consecutive failed probes promote it
    STANDBY_HEALTH_INTERVAL_S = 2.0
    STANDBY_PROMOTE_FAILURES = 3
    MONITOR_INTERVAL_S = 5.0
    # the agent's ResourceMonitor cadence (agent/monitor.py)
    REPORT_RESOURCE_INTERVAL_S = 15.0
    SPEED_SAMPLE_WINDOW = 20
    STRAGGLER_MEDIAN_RATIO = 2.0    # t > ratio × median ⇒ straggler
    # the diagnosis engine (master/diagnosis/): the rule chain over the
    # step reports, resource stats and step traces, run every interval
    DIAGNOSIS_ENABLED = True
    DIAGNOSIS_INTERVAL_S = 30.0
    # per-worker step-time window (samples) of the speed monitor
    DIAGNOSIS_WORKER_WINDOW = 20
    # samples a worker needs before a rule judges it
    DIAGNOSIS_MIN_WORKER_SAMPLES = 3
    # hysteresis: consecutive rounds over the threshold to flag, under it
    # to clear
    STRAGGLER_TRIGGER_WINDOWS = 2
    STRAGGLER_CLEAR_WINDOWS = 2
    # data-wait fraction above which a worker is input-bound
    DIAGNOSIS_DATA_WAIT_FRACTION = 0.5
    # the data-wait-driven device-prefetch depth (data/prefetch.py)
    PREFETCH_AUTOTUNE = True
    PREFETCH_DEPTH_MIN = 1
    PREFETCH_DEPTH_MAX = 8
    DATA_WAIT_TUNE_FRACTION = 0.2
    # per-card HBM used/total % that raises an hbm_pressure report
    DIAGNOSIS_HBM_PRESSURE_PCT = 92.0
    # throughput collapse: windowed MFU (or steps/s) under ratio × the
    # world's high-water mark
    DIAGNOSIS_COLLAPSE_RATIO = 0.5
    # False = diagnose only (reports and metrics, no actions dispatched)
    DIAGNOSIS_ACTIONS_ENABLED = True
    # steps an on-demand profiler capture traces
    DIAGNOSIS_PROFILE_STEPS = 5
    # per-rank cooldown between dispatched actions
    DIAGNOSIS_ACTION_COOLDOWN_S = 300.0
    # GoodputRule: alert below this trailing-window goodput (0 = off),
    # over this window, once it is this covered
    GOODPUT_ALERT_THRESHOLD = 0.0
    GOODPUT_WINDOW_S = 600.0
    GOODPUT_MIN_COVERAGE = 0.5
    # the time-series store (obs/tsdb.py): the collector's sampling and
    # sidecar-flush cadences (0 = no sampler thread; flush only at stop)
    TSDB_SAMPLE_INTERVAL_S = 5.0
    TSDB_FLUSH_INTERVAL_S = 30.0
    # planner calibration (parallel/calibration.py): the samples a plan
    # signature needs before it is evidence (each a windowed worker
    # mean); PlanRegressionRule (master/diagnosis/rules.py) alerts when
    # the measured step time exceeds the plan's prediction by the ratio
    # for PLAN_REGRESSION_WINDOWS rounds and clears after
    # PLAN_REGRESSION_CLEAR_WINDOWS under it (ratio 0 = rule off)
    CALIBRATION_MIN_SAMPLES = 3
    PLAN_REGRESSION_RATIO = 1.5
    PLAN_REGRESSION_WINDOWS = 3
    PLAN_REGRESSION_CLEAR_WINDOWS = 2
    # per-step critical-path tracing (obs/steptrace.py,
    # master/steptrace.py): the worker's record ring and clock-probe
    # refresh cadence, the master's assembled-step ring, and the
    # CriticalPathRule's gating fraction (0 = rule off)
    STEPTRACE_ENABLED = True
    STEPTRACE_RING = 512
    STEPTRACE_PROBE_INTERVAL_S = 30.0
    STEPTRACE_RING_STEPS = 512
    CRITICAL_PATH_GATING_FRACTION = 0.5
    # the least time before a deadline for which an emergency save
    # starts at all
    EMERGENCY_CKPT_MIN_WINDOW_S = 2.0
    # peer-to-peer restore (checkpoint/peer_restore.py): serve a
    # relaunched rank's state from the staged host copies of the
    # survivors (False: every restore reads the flash checkpoint), the
    # budget of the shard transfer, and the donor server's port (0 =
    # ephemeral; the address rides the PeerStoreReport)
    PEER_RESTORE_ENABLED = True
    PEER_RESTORE_TIMEOUT_S = 120.0
    PEER_DONOR_PORT = 0
    # online parallelism re-planning (parallel/planner.py): apply the
    # master's shard plan when building the worker (mesh + batch and
    # accumulation); False pins the configured shape
    REPLAN_ENABLED = True
    # -- slice mode (parallel/dcn_sync.py) ------------------------------
    # degraded-mode budget: surviving slices keep stepping with the
    # gradient mean renormalized over the PRESENT slices for this many
    # consecutive steps while a slice is absent; past it they hard-stall
    # with a CRITICAL alert instead of training on a shrunken mean
    SLICE_ABSENT_MAX_STEPS = 100
    # per-step deadline for a formed peer slice's gradient contribution;
    # a formed slice silent past it is absent for THIS step
    DCN_SYNC_TIMEOUT_S = 60.0
    # cadence of the collector's poll against the master KV store
    DCN_SYNC_POLL_S = 0.05
    # int8 groupwise quantization of the host-level cross-slice payloads;
    # 0 = exact float32 bytes
    DCN_SYNC_QUANT_BITS = 0
    # flight recorder rings (obs/flight_recorder.py)
    FLIGHT_RING_EVENTS = 4096
    FLIGHT_RING_SPANS = 4096
    # the fleet controller (brain/fleet_controller.py): claims offered
    # capacity, sheds a gating slice, or holds. Off by default: it
    # changes fleet membership on its own authority; jobs opt in
    FLEET_CONTROLLER_ENABLED = False
    AUTOSCALE_INTERVAL_S = 30.0          # evaluation cadence
    # no new actuation this long after one (the rollback watch concludes)
    AUTOSCALE_COOLDOWN_S = 120.0
    # consecutive evaluations agreeing before a decision actuates
    AUTOSCALE_HYSTERESIS_WINDOWS = 2
    # actuations an hour, claims and sheds together (rollbacks exempt)
    AUTOSCALE_MAX_DECISIONS_PER_HOUR = 6
    # a windowed goodput drop beyond this reverts the decision and
    # quarantines its class
    AUTOSCALE_ROLLBACK_DROP_FRACTION = 0.2
    AUTOSCALE_ROLLBACK_WINDOW_S = 120.0  # actuation → the watch's read
    # quarantine base of a rolled-back class; doubles a consecutive
    # rollback, capped at 8x
    AUTOSCALE_QUARANTINE_BACKOFF_S = 600.0
    # a claim's predicted gain must beat its join+re-plan cost by this
    AUTOSCALE_CLAIM_MARGIN = 1.2
    # a shed needs the trace's gating slice AND this cross-slice wait
    AUTOSCALE_SHED_WAIT_FRACTION = 0.3
    # speed-aware dynamic sharding (master/shard/)
    DISPATCH_SPEED_WEIGHTED = False
    DISPATCH_WEIGHT_FLOOR = 0.25
    # per-rank relaunch backoff + quarantine (agent)
    RELAUNCH_BACKOFF_BASE_S = 1.0
    RELAUNCH_BACKOFF_MAX_S = 60.0
    QUARANTINE_FAILURES = 5
    QUARANTINE_WINDOW_S = 600.0
    # preemption-aware graceful drain (agent/preemption.py): the grace
    # window of a notice with no deadline (a bare SIGTERM; k8s's default
    # terminationGracePeriodSeconds), the agent's notice-source poll, and
    # how far ahead of a static env deadline ($DLROVER_TPU_PREEMPTION_AT)
    # the drain fires (0 = the default grace)
    PREEMPT_DEFAULT_GRACE_S = 30.0
    PREEMPT_NOTICE_POLL_S = 1.0
    PREEMPT_ENV_HORIZON_S = 0.0
    # step-hang watchdog (trainer/watchdog.py): no step progress for this
    # long → stack dump + self-abort; 0 = disabled (jobs opt in through
    # DLROVER_TPU_HANG_WATCHDOG_S)
    HANG_WATCHDOG_S = 0.0


# keys under these prefixes are on the gradient path (kv store hygiene,
# the snapshot exemption, coordination-tier routing)
HOT_KV_PREFIXES = ("dcn/", "coord/")

# the durable subset of the hot prefixes: coord/ barrier mutations ride
# the mutation log (a promoted master must answer the rendezvous
# addresses agents kv_wait on); dcn/ payloads are per-step ephemeral and
# never logged
LOGGED_KV_PREFIXES = ("coord/",)

# the least time before a deadline for which an emergency save starts at
# all (seconds)
EMERGENCY_CKPT_MIN_WINDOW_S = DefaultValues.EMERGENCY_CKPT_MIN_WINDOW_S
