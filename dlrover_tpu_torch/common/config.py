"""Global context singleton of runtime tunables.

Own copy of the JAX package's ``common/config.py``, holding the knobs the
ported control plane reads. Each is overridable from the environment as
``DLROVER_TPU_<NAME_UPPER>`` or programmatically (tests).
"""

from __future__ import annotations

import os
import threading

from dlrover_tpu_torch.common.constants import DefaultValues


class Context:
    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self.rdzv_timeout_s: float = DefaultValues.RDZV_TIMEOUT_S
        self.rdzv_wait_new_node_s: float = DefaultValues.RDZV_WAIT_NEW_NODE_S
        self.task_timeout_s: float = DefaultValues.TASK_TIMEOUT_S
        self.hang_seconds: float = DefaultValues.HANG_SECONDS
        self.dead_node_timeout_s: float = DefaultValues.DEAD_NODE_TIMEOUT_S
        # client RPC budget (agent/master_client.py): per-call deadline,
        # attempt count and the jittered-exponential-backoff envelope
        self.rpc_timeout_s: float = DefaultValues.RPC_TIMEOUT_S
        self.rpc_retries: int = DefaultValues.RPC_RETRIES
        self.rpc_backoff_s: float = DefaultValues.RPC_BACKOFF_S
        self.rpc_backoff_max_s: float = DefaultValues.RPC_BACKOFF_MAX_S
        self.master_reconnect_timeout_s: float = (
            DefaultValues.MASTER_RECONNECT_TIMEOUT_S
        )
        # crash-consistent master state: snapshots land here ("" = state
        # persistence disabled); the bootstrap file carries the master's
        # advertised address across restarts ("" = env-only resolution)
        self.master_state_dir: str = ""
        self.master_bootstrap_file: str = ""
        self.master_snapshot_retain: int = (
            DefaultValues.MASTER_SNAPSHOT_RETAIN
        )
        self.master_snapshot_min_interval_s: float = (
            DefaultValues.MASTER_SNAPSHOT_MIN_INTERVAL_S
        )
        # the coordination tier's own port, the bounded telemetry ingest
        # and the hot-standby promoter (master/coord_service.py,
        # master/standby.py)
        self.coord_port: int = DefaultValues.COORD_PORT
        self.telemetry_queue_size: int = (
            DefaultValues.TELEMETRY_QUEUE_SIZE
        )
        self.kv_gc_keep_generations: int = (
            DefaultValues.KV_GC_KEEP_GENERATIONS
        )
        self.standby_health_interval_s: float = (
            DefaultValues.STANDBY_HEALTH_INTERVAL_S
        )
        self.standby_promote_failures: int = (
            DefaultValues.STANDBY_PROMOTE_FAILURES
        )
        self.report_resource_interval_s: float = (
            DefaultValues.REPORT_RESOURCE_INTERVAL_S
        )
        self.speed_sample_window: int = DefaultValues.SPEED_SAMPLE_WINDOW
        self.straggler_median_ratio: float = (
            DefaultValues.STRAGGLER_MEDIAN_RATIO
        )
        # the diagnosis engine (master/diagnosis/): rule thresholds,
        # cadence and the action kill-switch
        self.diagnosis_enabled: bool = DefaultValues.DIAGNOSIS_ENABLED
        self.diagnosis_interval_s: float = (
            DefaultValues.DIAGNOSIS_INTERVAL_S
        )
        self.diagnosis_worker_window: int = (
            DefaultValues.DIAGNOSIS_WORKER_WINDOW
        )
        self.diagnosis_min_worker_samples: int = (
            DefaultValues.DIAGNOSIS_MIN_WORKER_SAMPLES
        )
        self.straggler_trigger_windows: int = (
            DefaultValues.STRAGGLER_TRIGGER_WINDOWS
        )
        self.straggler_clear_windows: int = (
            DefaultValues.STRAGGLER_CLEAR_WINDOWS
        )
        self.diagnosis_data_wait_fraction: float = (
            DefaultValues.DIAGNOSIS_DATA_WAIT_FRACTION
        )
        self.diagnosis_hbm_pressure_pct: float = (
            DefaultValues.DIAGNOSIS_HBM_PRESSURE_PCT
        )
        self.diagnosis_collapse_ratio: float = (
            DefaultValues.DIAGNOSIS_COLLAPSE_RATIO
        )
        self.diagnosis_actions_enabled: bool = (
            DefaultValues.DIAGNOSIS_ACTIONS_ENABLED
        )
        self.diagnosis_profile_steps: int = (
            DefaultValues.DIAGNOSIS_PROFILE_STEPS
        )
        self.diagnosis_action_cooldown_s: float = (
            DefaultValues.DIAGNOSIS_ACTION_COOLDOWN_S
        )
        # GoodputRule (threshold 0 = off)
        self.goodput_alert_threshold: float = (
            DefaultValues.GOODPUT_ALERT_THRESHOLD
        )
        self.goodput_window_s: float = DefaultValues.GOODPUT_WINDOW_S
        self.goodput_min_coverage: float = (
            DefaultValues.GOODPUT_MIN_COVERAGE
        )
        # the time-series store (obs/tsdb.py): sampling and sidecar
        # flush cadences of the master's collector
        self.tsdb_sample_interval_s: float = (
            DefaultValues.TSDB_SAMPLE_INTERVAL_S
        )
        self.tsdb_flush_interval_s: float = (
            DefaultValues.TSDB_FLUSH_INTERVAL_S
        )
        # planner calibration (parallel/calibration.py) and the
        # PlanRegressionRule thresholds (master/diagnosis/rules.py)
        self.calibration_min_samples: int = (
            DefaultValues.CALIBRATION_MIN_SAMPLES
        )
        self.plan_regression_ratio: float = (
            DefaultValues.PLAN_REGRESSION_RATIO
        )
        self.plan_regression_windows: int = (
            DefaultValues.PLAN_REGRESSION_WINDOWS
        )
        self.plan_regression_clear_windows: int = (
            DefaultValues.PLAN_REGRESSION_CLEAR_WINDOWS
        )
        # per-step critical-path tracing (obs/steptrace.py,
        # master/steptrace.py) and the CriticalPathRule's threshold
        self.steptrace_enabled: bool = DefaultValues.STEPTRACE_ENABLED
        self.steptrace_ring: int = DefaultValues.STEPTRACE_RING
        self.steptrace_probe_interval_s: float = (
            DefaultValues.STEPTRACE_PROBE_INTERVAL_S
        )
        self.steptrace_ring_steps: int = (
            DefaultValues.STEPTRACE_RING_STEPS
        )
        self.critical_path_gating_fraction: float = (
            DefaultValues.CRITICAL_PATH_GATING_FRACTION
        )
        # flight-recorder rings (obs/flight_recorder.py)
        self.flight_ring_events: int = DefaultValues.FLIGHT_RING_EVENTS
        self.flight_ring_spans: int = DefaultValues.FLIGHT_RING_SPANS
        # per-rank relaunch backoff + quarantine (agent/elastic_agent.py)
        self.relaunch_backoff_base_s: float = (
            DefaultValues.RELAUNCH_BACKOFF_BASE_S
        )
        self.relaunch_backoff_max_s: float = (
            DefaultValues.RELAUNCH_BACKOFF_MAX_S
        )
        self.quarantine_failures: int = DefaultValues.QUARANTINE_FAILURES
        self.quarantine_window_s: float = DefaultValues.QUARANTINE_WINDOW_S
        # speed-aware dynamic sharding (master/shard/task_manager.py)
        self.dispatch_speed_weighted: bool = (
            DefaultValues.DISPATCH_SPEED_WEIGHTED
        )
        self.dispatch_weight_floor: float = (
            DefaultValues.DISPATCH_WEIGHT_FLOOR
        )
        # peer-to-peer restore (checkpoint/peer_restore.py)
        self.peer_restore_enabled: bool = (
            DefaultValues.PEER_RESTORE_ENABLED
        )
        self.peer_restore_timeout_s: float = (
            DefaultValues.PEER_RESTORE_TIMEOUT_S
        )
        self.peer_donor_port: int = DefaultValues.PEER_DONOR_PORT
        # online parallelism re-planning (parallel/planner.py): the
        # worker builds its mesh and batch shape from the master's shard
        # plan; False pins the configured shape
        self.replan_enabled: bool = DefaultValues.REPLAN_ENABLED
        # preemption-aware graceful drain (agent/preemption.py) and the
        # deadline-bounded emergency checkpoint (checkpoint/, trainer/)
        self.preempt_default_grace_s: float = (
            DefaultValues.PREEMPT_DEFAULT_GRACE_S
        )
        self.preempt_notice_poll_s: float = (
            DefaultValues.PREEMPT_NOTICE_POLL_S
        )
        self.preempt_env_horizon_s: float = (
            DefaultValues.PREEMPT_ENV_HORIZON_S
        )
        # step-hang watchdog (trainer/watchdog.py); 0 = disabled
        self.hang_watchdog_s: float = DefaultValues.HANG_WATCHDOG_S
        self._load_env_overrides()

    def _load_env_overrides(self) -> None:
        for name, value in vars(self).items():
            if name.startswith("_"):
                continue
            env_key = f"DLROVER_TPU_{name.upper()}"
            raw = os.getenv(env_key)
            if raw is None:
                continue
            kind = type(value)
            if kind is bool:
                setattr(self, name, raw.lower() in ("1", "true", "yes"))
            else:
                setattr(self, name, kind(raw))

    def update(self, **kwargs) -> None:
        """Runtime override."""
        for key, value in kwargs.items():
            if hasattr(self, key) and not key.startswith("_"):
                setattr(self, key, value)

    @classmethod
    def singleton(cls) -> "Context":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        """For tests: drop the singleton so env overrides re-apply."""
        with cls._lock:
            cls._instance = None
