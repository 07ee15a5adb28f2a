"""Job master: composition root + serving loop.

Own copy of the JAX package's ``master/job_master.py``, after
dlrover/python/master/local_master.py:38: the master owns every
control-plane component and serves the two-method gRPC service;
``prepare()`` starts serving, ``run()`` polls for job completion or a
hang. This is the standalone master (``run.py --standalone``), with the
single-lock rendezvous manager (the JAX package's ``rdzv_sharded=False``
path).

The master keeps the job's goodput ledger (``obs/goodput.py``), the
time-series store (``obs/tsdb.py``) with its collector sampling the
fleet gauges and the ledger every ``tsdb_sample_interval_s``, the
step-trace assembler (``master/steptrace.py``) and, unless
``diagnosis_enabled`` is off, the diagnosis engine
(``master/diagnosis/``), run every ``diagnosis_interval_s``. The
servicer feeds and serves them; a graceful ``stop()`` dumps the flight
record with the ledger, a tsdb snapshot and the assembled steps in it.

The master survives its own death, as the JAX master does:

- with a state directory (``--state-dir``, ``Context.master_state_dir``)
  every control-plane mutation lands in a crash-consistent snapshot
  (``master/state_backend.py``): the rendezvous, the task manager, the
  kv store, the speed monitor, the goodput ledger and the diagnosis
  reports; the hot ``coord/`` keys ride the mutation log, and the
  tsdb's downsampled tiers its sidecar file. A master started over the
  directory restores from the newest valid snapshot with generation =
  the snapshot's + 1;
- the coordination tier (``master/coord_service.py``) serves the kv
  RPCs on its own port (``coord_port``; -1 = the main port only);
- with a bootstrap file (``--bootstrap-file``) the master publishes
  ``{"addr", "coord_addr", "generation"}`` atomically, and never over a
  higher generation: a revived old primary is fenced, and stops writing
  the shared lineage;
- ``--standby`` runs a hot standby (``master/standby.py``) that tails
  the snapshot stream and promotes when the primary stops answering;
- a ``master``-role chaos fault (``kill:master:0@N``) is armed on the
  master and fed from the worker's step reports.

The planner's calibration (``parallel/calibration.py``) is built here
and handed to the servicer (stamped plans' predictions, step reports'
measurements) and the diagnosis engine (``PlanRegressionRule``'s
evidence; each round pushes the learned discounts back into the
planner). It is snapshotted as ``plan_calibration``, byte-compatible
with the JAX master's; a restore re-pushes its discounts at once.

The JAX master's snapshot also holds ``fleet_controller`` (the brain,
ROADMAP Queue A item 12.10) and ``job_manager`` (12.7); the port neither
writes nor restores them, and ignores them in a JAX snapshot.

Not ported yet (ROADMAP Queue A item 12): the sharded rendezvous
router (12.2), the fleet controller, the job manager with its scalers
and watchers, the brain and the metrics HTTP exporter.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.comm import build_server, local_ip
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import NodeType, RendezvousName
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.coord_service import CoordServicer
from dlrover_tpu_torch.master.diagnosis import DiagnosisManager
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.rendezvous import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
    RendezvousParameters,
)
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.state_backend import (
    MasterStateBackend,
    MutationLog,
)
from dlrover_tpu_torch.master.steptrace import StepTraceAssembler
from dlrover_tpu_torch.master.sync_service import ElasticPsService, SyncService
from dlrover_tpu_torch.parallel.calibration import PlanCalibration


class JobMaster:
    """One instance per job: the standalone/local master."""

    def __init__(
        self,
        port: int = 0,
        min_nodes: int = 1,
        max_nodes: int = 1,
        node_unit: int = 1,
        host: str = "0.0.0.0",
        state_dir: Optional[str] = None,
        preloaded_state: Optional[tuple] = None,
    ):
        ctx = Context.singleton()
        params = RendezvousParameters(
            min_nodes=min_nodes,
            max_nodes=max_nodes,
            wait_new_node_s=ctx.rdzv_wait_new_node_s,
            node_unit=node_unit,
        )
        self.task_manager = TaskManager()
        self.speed_monitor = SpeedMonitor()
        self.task_manager.speed_monitor = self.speed_monitor
        self.rdzv_managers = {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(params),
            RendezvousName.NETWORK_CHECK:
                NetworkCheckRendezvousManager(
                    RendezvousParameters(min_nodes, max_nodes,
                                         ctx.rdzv_wait_new_node_s)
                ),
        }
        self.kv_store = KVStoreService(
            keep_generations=ctx.kv_gc_keep_generations)
        self.sync_service = SyncService(expected_workers=min_nodes)
        self.elastic_ps_service = ElasticPsService()
        # the goodput ledger classifies every rank-second of the job
        # (obs/goodput.py); fed by the servicer, queried over RPC
        self.goodput_ledger = obs.GoodputLedger()
        # the fleet's bounded history, sampled by the collector (built
        # with the state backend below: its sidecar lives in the state
        # dir) and fed per rank by the servicer
        self.tsdb = obs.TimeSeriesStore()
        self.tsdb_collector = None
        # the planner's prediction against measurement: stamped plans
        # register their predicted step time, step reports the measured
        # one, and the learned per-axis discounts feed back into scoring
        self.plan_calibration = PlanCalibration()
        # per-step critical paths: feeds the tsdb gating series and the
        # CriticalPathRule
        self.steptrace = StepTraceAssembler(tsdb=self.tsdb)
        self.diagnosis_manager = None
        if ctx.diagnosis_enabled:
            self.diagnosis_manager = DiagnosisManager(
                self.speed_monitor, goodput_ledger=self.goodput_ledger,
                plan_calibration=self.plan_calibration,
                steptrace=self.steptrace)
        self.servicer = MasterServicer(
            task_manager=self.task_manager,
            rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store,
            speed_monitor=self.speed_monitor,
            sync_service=self.sync_service,
            elastic_ps_service=self.elastic_ps_service,
            goodput_ledger=self.goodput_ledger,
            diagnosis_manager=self.diagnosis_manager,
            tsdb=self.tsdb,
            steptrace=self.steptrace,
            plan_calibration=self.plan_calibration,
        )
        if self.diagnosis_manager is not None:
            # the learned discounts ride the diagnosis cadence, not the
            # per-report path
            self.diagnosis_manager.discount_sink = \
                self.servicer.push_axis_discounts
        self._host = host
        self._server, self.port = build_server(
            self.servicer.get_bytes, self.servicer.report_bytes,
            port=port, host=host,
        )
        self._init_coord_tier(host)
        self._stopped = threading.Event()
        self._exit_reason = ""
        self._init_state_backend(
            state_dir if state_dir is not None else ctx.master_state_dir,
            ctx.master_snapshot_retain,
            preloaded_state=preloaded_state,
        )
        self._arm_master_chaos()

    # -- the coordination tier (master/coord_service.py) ----------------
    def _init_coord_tier(self, host: str) -> None:
        """Bind the kv/coordination tier on its own port and thread pool
        so a join or telemetry storm on the control tier can never stall
        it (coord_port -1 = single-tier: the main servicer answers
        everything)."""
        self._coord_server = None
        self.coord_port = 0
        port = Context.singleton().coord_port
        if port < 0:
            return
        self.coord_servicer = CoordServicer(self.kv_store)
        try:
            # a full-width pool: blocked KVWaits hold threads
            self._coord_server, self.coord_port = build_server(
                self.coord_servicer.get_bytes,
                self.coord_servicer.report_bytes,
                port=port, host=host, max_workers=64)
        except RuntimeError as e:
            logger.warning("coordination tier failed to bind: %s "
                           "(serving coordination on the main port)", e)
            self._coord_server = None
            return
        self.servicer.coord_addr = self.coord_addr

    # -- crash-consistent control-plane state --------------------------
    def _init_state_backend(self, state_dir: str, retain: int,
                            preloaded_state: Optional[tuple] = None
                            ) -> None:
        """Attach the snapshot store and, when a prior master left valid
        state behind, rebuild every component from it BEFORE serving.
        The generation token bumps once per (re)start over one state
        lineage, so a reconnecting agent can tell a restarted master
        from a transient outage. ``preloaded_state`` is the hot
        standby's warm copy: promotion skips the disk read it already
        did. The hot-key mutation log is replayed OVER the snapshot."""
        self._snapshot_lock = threading.Lock()
        self._state_backend = None
        self._mutation_log = None
        self._last_snapshot_ts = 0.0
        # double-primary fencing covers the state dir: once a
        # higher-generation master owns the bootstrap file, this one
        # stops writing snapshots and mutation-log entries
        with self._snapshot_lock:
            self._fenced = False
            self._last_fence_check = 0.0
            self._snapshot_timer: Optional[threading.Timer] = None
        self.generation = 0
        if state_dir:
            self._state_backend = MasterStateBackend(state_dir,
                                                     retain=retain)
            # the gate reads the latched flag, not _check_fenced: saves
            # run under _snapshot_lock, which _check_fenced takes
            self._state_backend.gate = lambda: self._fenced
            self.generation = 1
            loaded = (preloaded_state if preloaded_state is not None
                      else self._state_backend.load_latest())
            if loaded is not None:
                state, version = loaded
                with obs.span("master_restore",
                              {"snapshot_version": version,
                               "preloaded": preloaded_state
                               is not None}):
                    self._restore_state(state)
                    replayed = self.kv_store.replay_mutations(
                        MutationLog.read(state_dir))
                logger.info(
                    "master state restored from snapshot v%d "
                    "(generation %d, %d hot mutations replayed)",
                    version, self.generation, replayed)
                obs.get_flight_recorder().record_event(
                    "master_restore", snapshot_version=version,
                    generation=self.generation,
                    hot_mutations_replayed=replayed)
                obs.get_registry().counter(
                    "dlrover_tpu_master_restores_total",
                    "Masters rebuilt from a state snapshot").inc()
            self._mutation_log = MutationLog(state_dir)
            # the drainer consults the fence before every write: hot-only
            # traffic must stop the moment a higher generation owns the
            # lineage
            self._mutation_log.gate = self._check_fenced
            self.kv_store.attach_mutation_log(self._mutation_log)
            self.servicer.state_sink = self._maybe_snapshot
            if self._coord_server is not None:
                self.coord_servicer.state_sink = self._maybe_snapshot
            if self.diagnosis_manager is not None:
                self.diagnosis_manager.state_sink = self._maybe_snapshot
            # the generation bump itself must be durable before the
            # first RPC is served
            self._maybe_snapshot()
        self.servicer.generation = self.generation
        # the time-series collector persists the downsampled tiers to a
        # checksummed sidecar in the state dir (not the snapshot:
        # background samples must not churn snapshot versions); a
        # restarted master or a promoted standby reloads them here
        self.tsdb_collector = obs.TsdbCollector(
            self.tsdb, goodput_ledger=self.goodput_ledger,
            state_dir=state_dir or "")
        if state_dir:
            # a superseded primary's flush must not clobber the promoted
            # lineage's history
            self.tsdb_collector.gate = self._check_fenced
        restored_series = self.tsdb_collector.restore()
        if restored_series:
            logger.info("fleet time-series history restored: %d "
                        "series", restored_series)
            obs.get_flight_recorder().record_event(
                "tsdb_restored", series=restored_series,
                generation=self.generation)

    def _export_state(self) -> dict:
        """The snapshot, in the JAX master's format for the components
        the port holds."""
        state = {
            "generation": self.generation,
            "rendezvous": {name: mgr.export_state()
                           for name, mgr in self.rdzv_managers.items()},
            "task_manager": self.task_manager.export_state(),
            "kv_store": self.kv_store.export_state(),
            "speed_monitor": self.speed_monitor.export_state(),
            "goodput": self.goodput_ledger.export_state(),
            "plan_calibration": self.plan_calibration.export_state(),
        }
        if self.diagnosis_manager is not None:
            state["diagnosis"] = self.diagnosis_manager.export_state()
        return state

    def _restore_state(self, state: dict) -> None:
        """Rebuild every ported component from a snapshot of either
        package. A JAX snapshot's ``fleet_controller`` (ROADMAP Queue A
        item 12.10) and ``job_manager`` (12.7) keys name parts the port
        lacks and are ignored."""
        self.generation = int(state.get("generation", 0)) + 1
        for name, rdzv_state in state.get("rendezvous", {}).items():
            mgr = self.rdzv_managers.get(name)
            if mgr is not None:
                mgr.restore_state(rdzv_state)
        self.task_manager.restore_state(state.get("task_manager", {}))
        self.kv_store.restore_state(state.get("kv_store", {}))
        self.speed_monitor.restore_state(state.get("speed_monitor", {}))
        if "goodput" in state:
            self.goodput_ledger.restore_state(state["goodput"])
        if "plan_calibration" in state:
            self.plan_calibration.restore_state(
                state["plan_calibration"])
            # re-arm the planner with the restored discounts now, not at
            # the first diagnosis round: the re-formation plan is scored
            # with them
            discounts = self.plan_calibration.axis_discounts()
            if discounts:
                self.servicer.push_axis_discounts(discounts)
        if self.diagnosis_manager is not None and "diagnosis" in state:
            self.diagnosis_manager.restore_state(state["diagnosis"])

    def _maybe_snapshot(self, force: bool = False) -> None:
        """Persist the control-plane state if it changed (the
        servicer's post-mutation hook). Serialized: concurrent RPC
        handlers must not interleave exports with version assignment.
        ``master_snapshot_min_interval_s`` > 0 coalesces bursts to one
        snapshot per interval, and a skipped mutation arms a trailing
        timer so the lag stays bounded; the default (0) is strict
        write-through."""
        if self._state_backend is None:
            return
        if self._check_fenced():
            return
        interval = Context.singleton().master_snapshot_min_interval_s
        with self._snapshot_lock:
            remaining = self._last_snapshot_ts + interval - time.time()
            if not force and interval > 0 and remaining > 0:
                if self._snapshot_timer is None:
                    timer = threading.Timer(remaining,
                                            self._trailing_snapshot)
                    timer.daemon = True
                    self._snapshot_timer = timer
                    timer.start()
                return
            # sample the mutation-log fence BEFORE exporting: every
            # mutation the export can contain holds a smaller seq, so
            # rotation keeps anything newer
            fence = (self._mutation_log.current_seq()
                     if self._mutation_log is not None else 0)
            try:
                written = self._state_backend.save_if_changed(
                    self._export_state())
            except Exception:  # noqa: BLE001 — durability is best-effort
                logger.exception("master state snapshot failed")
                return
            if written is not None:
                self._last_snapshot_ts = time.time()
                if self._mutation_log is not None:
                    self._mutation_log.rotate(up_to_seq=fence)

    def _trailing_snapshot(self) -> None:
        """Timer body: flush the mutation that fell inside the
        coalescing window."""
        with self._snapshot_lock:
            self._snapshot_timer = None
        self._maybe_snapshot(force=True)

    @staticmethod
    def _bootstrap_file_generation() -> int:
        """The generation the bootstrap file carries (-1 = no file or
        unreadable), parsed as agents parse it."""
        from dlrover_tpu_torch.agent.master_client import MasterClient

        try:
            return int(MasterClient.resolve_bootstrap().get(
                "generation", -1))
        except (TypeError, ValueError):
            return -1

    def _check_fenced(self, throttle_s: float = 2.0) -> bool:
        """Has a higher-generation master taken over the lineage? Read
        the bootstrap file at most once per ``throttle_s``; on the first
        detection, stop this master's state writes for good."""
        with self._snapshot_lock:
            if self._fenced:
                return True
            now = time.time()
            if now - self._last_fence_check < throttle_s:
                return False
            self._last_fence_check = now
        file_gen = self._bootstrap_file_generation()
        if not self.generation or file_gen <= self.generation:
            return False
        self._mark_fenced(file_gen)
        return True

    def _mark_fenced(self, file_generation: int) -> None:
        with self._snapshot_lock:
            if self._fenced:
                return
            self._fenced = True
        # stop NEW appends; queued entries are discarded by the
        # drainer's gate (this may run ON the drainer thread, so closing
        # the log here would join itself)
        self.kv_store.attach_mutation_log(None)
        logger.critical(
            "FENCED: generation %d owns the bootstrap file (ours is "
            "%d): another master promoted past us; stopping every "
            "state write into the shared lineage", file_generation,
            self.generation)
        obs.get_flight_recorder().record_event(
            "master_fenced", file_generation=file_generation,
            our_generation=self.generation)
        obs.get_registry().counter(
            "dlrover_tpu_master_fenced_total",
            "Bootstrap publishes refused because a higher-generation "
            "master already owns the file").inc()

    def _arm_master_chaos(self) -> None:
        """``kill:master:0@step``, fed from the workers' step reports so
        a chaos run can kill the control plane at a chosen step."""
        from dlrover_tpu_torch.diagnostics.chaos import ChaosInjector

        chaos = ChaosInjector(role=NodeType.MASTER, rank=0)
        if chaos.faults:
            self.servicer.master_chaos = chaos

    def _publish_bootstrap_addr(self) -> None:
        """Atomically write the advertised addresses and the generation
        to the bootstrap file, so agents in master-lost mode can
        re-resolve a restarted or promoted master. A file that already
        carries a HIGHER generation is never overwritten: the revived
        old primary is fenced instead (no double primary)."""
        path = Context.singleton().master_bootstrap_file
        if not path:
            return
        try:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            # read-check-replace is one critical section across masters
            with _bootstrap_publish_lock(path):
                current_gen = self._bootstrap_file_generation()
                if self.generation and current_gen > self.generation:
                    self._mark_fenced(current_gen)
                    return
                tmp = f"{path}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump({"addr": self.addr,
                               "coord_addr": self.coord_addr,
                               "generation": self.generation}, f)
                os.replace(tmp, path)
        except OSError as e:
            logger.warning("cannot publish master address to %s: %s",
                           path, e)
            return
        logger.info("master address %s (coord %s, generation %d) "
                    "published to %s", self.addr,
                    self.coord_addr or "-", self.generation, path)

    # ------------------------------------------------------------------
    def prepare(self) -> None:
        self._server.start()
        if self._coord_server is not None:
            self._coord_server.start()
            logger.info("coordination tier serving on port %d",
                        self.coord_port)
        self.task_manager.start_timeout_recovery()
        if self.diagnosis_manager is not None:
            self.diagnosis_manager.start()
        self.tsdb_collector.start()
        self._publish_bootstrap_addr()
        logger.info("job master serving on port %d", self.port)

    def run(self, poll_interval_s: float = 30.0) -> int:
        """Block until the job finishes; returns an exit code."""
        ctx = Context.singleton()
        exit_code = 0
        while not self._stopped.is_set():
            if self.task_manager.finished():
                logger.info("all datasets exhausted: job succeeded")
                break
            if self.speed_monitor.is_hanged(ctx.hang_seconds):
                logger.error("job hanged > %.0fs without step progress",
                             ctx.hang_seconds)
                exit_code = 1
                self._exit_reason = "hang"
                break
            self._stopped.wait(poll_interval_s)
        self.stop()
        return exit_code

    def run_in_thread(self, poll_interval_s: float = 1.0) -> threading.Thread:
        thread = threading.Thread(
            target=self.run, args=(poll_interval_s,), daemon=True,
            name="job-master",
        )
        thread.start()
        return thread

    def stop(self, grace_s: float = 1.0) -> None:
        if not self._stopped.is_set():
            self._stopped.set()
            if self.diagnosis_manager is not None:
                self.diagnosis_manager.stop()
            with self._snapshot_lock:
                if self._snapshot_timer is not None:
                    self._snapshot_timer.cancel()
                    self._snapshot_timer = None
            # queued telemetry is replayed before the final flight dump,
            # then the drainer stops
            self.servicer.telemetry_queue.flush(timeout_s=2.0)
            self.servicer.telemetry_queue.stop()
            # a coalesced mutation must not die with a graceful stop
            self._maybe_snapshot(force=True)
            if self._mutation_log is not None:
                self._mutation_log.close()
            self.tsdb_collector.stop()
            # the master's half of the postmortem: the goodput ledger, a
            # compact tsdb snapshot and the assembled step traces ride in
            # the dump, the same payloads the live RPCs serve
            recorder = obs.get_flight_recorder()
            self.goodput_ledger.record_flight_snapshot(
                reason="master-stop")
            try:
                recorder.record_event(
                    "tsdb", snapshot=self.tsdb_collector.flight_snapshot(),
                    calibration=self.plan_calibration.table(),
                    axis_discounts=self.plan_calibration.axis_discounts())
                recorder.record_event(
                    "steptrace", snapshot=self.steptrace.flight_snapshot())
            except Exception:  # noqa: BLE001 — the dump must land
                logger.exception("flight snapshot of the tsdb or "
                                 "steptrace failed")
            recorder.record_event("master_stop",
                                  exit_reason=self._exit_reason)
            recorder.dump(reason="master-stop")
            if self._coord_server is not None:
                self._coord_server.stop(grace_s)
            self._server.stop(grace_s)

    @property
    def addr(self) -> str:
        """Address agents should dial. A 0.0.0.0 bind is advertised as the
        host's own address so agents on other hosts don't dial their own
        loopback."""
        return f"{self._advertised_host()}:{self.port}"

    @property
    def coord_addr(self) -> str:
        """The coordination tier's advertised address ("" = single-tier:
        coordination served on the main port)."""
        if self._coord_server is None:
            return ""
        return f"{self._advertised_host()}:{self.coord_port}"

    def _advertised_host(self) -> str:
        host = self._host
        if host in ("0.0.0.0", "::", ""):
            host = local_ip()
        return host


@contextlib.contextmanager
def _bootstrap_publish_lock(path: str):
    """Advisory exclusive lock over the bootstrap publish critical
    section (best-effort: a filesystem without flock degrades to the
    bare race, still bounded by the fence check)."""
    lock_file = None
    try:
        import fcntl

        lock_file = open(f"{path}.lock", "w")
        fcntl.flock(lock_file, fcntl.LOCK_EX)
    except (ImportError, OSError):
        if lock_file is not None:
            lock_file.close()
        lock_file = None
    try:
        yield
    finally:
        if lock_file is not None:
            try:
                fcntl.flock(lock_file, fcntl.LOCK_UN)
                lock_file.close()
            except OSError:
                pass


def run_master_main(args=None) -> int:
    """CLI entry: ``python -m dlrover_tpu_torch.master.job_master``."""
    import argparse

    parser = argparse.ArgumentParser("dlrover-tpu-torch master")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--min-nodes", type=int, default=1)
    parser.add_argument("--max-nodes", type=int, default=1)
    parser.add_argument("--node-unit", type=int, default=1)
    parser.add_argument("--state-dir",
                        default=Context.singleton().master_state_dir,
                        help="directory for crash-consistent control-"
                             "plane snapshots; a restarted master "
                             "recovers from the latest valid one "
                             "('' = disabled)")
    parser.add_argument("--bootstrap-file",
                        default=Context.singleton().master_bootstrap_file,
                        help="file the master atomically writes its "
                             "advertised address into; agents re-resolve "
                             "from it after a master restart")
    parser.add_argument("--standby", action="store_true",
                        help="run as a hot standby: tail the primary's "
                             "snapshot stream under --state-dir, probe "
                             "the address it publishes in "
                             "--bootstrap-file, and promote when it "
                             "stops answering")
    ns = parser.parse_args(args)
    Context.singleton().update(master_state_dir=ns.state_dir,
                               master_bootstrap_file=ns.bootstrap_file)
    if ns.standby:
        from dlrover_tpu_torch.master.standby import StandbyMaster

        standby = StandbyMaster(
            state_dir=ns.state_dir, bootstrap_file=ns.bootstrap_file,
            port=ns.port, min_nodes=ns.min_nodes,
            max_nodes=ns.max_nodes, node_unit=ns.node_unit)
        print("DLROVER_TPU_STANDBY=watching", flush=True)
        return standby.run()
    master = JobMaster(port=ns.port, min_nodes=ns.min_nodes,
                       max_nodes=ns.max_nodes, node_unit=ns.node_unit)
    master.prepare()
    print(f"DLROVER_TPU_MASTER_ADDR={master.addr}", flush=True)
    return master.run()


if __name__ == "__main__":
    raise SystemExit(run_master_main())
