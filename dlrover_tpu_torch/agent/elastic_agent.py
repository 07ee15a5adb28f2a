"""Node-side elastic agent: rendezvous, spawn, monitor, restart; and the
training process's side of the agent's contract.

Own copy of the JAX package's ``agent/elastic_agent.py``, after
dlrover/python/elastic_agent/torch/training.py (rendezvous :315,
monitor/restart loop :429-521, failure reporting :490):

- One agent per host. The worker it spawns is ONE training process that
  owns the host's cards (``devices_per_node``).
- Rendezvous yields {node_rank → local card count}; the agent derives the
  process group's world size and this process's rank, and the lowest
  rank publishes the group's rendezvous address through the master KV
  store.
- On worker failure: report to the master, back off, re-rendezvous,
  respawn (restart budget, quarantine). On a membership change
  (``num_nodes_waiting > 0``): graceful restart so the world re-forms.
- Planned and silent failures: a preemption notice (``agent/
  preemption.py``: a notice file, a static env deadline, SIGTERM)
  drains the worker through a deadline-bounded emergency checkpoint and
  the clean-drain exit 76, announced to and concluded with the master,
  never charged; a worker the step-hang watchdog aborted (SIGABRT with
  ``hang_watchdog_s`` on) is classified ``hang`` and relaunched without
  charging the restart budget, its no-progress streak counted by the
  governor (forward progress read from the worker's timeline export).
- Peer restore (``checkpoint/peer_restore.py``): the agent's work
  directory holds the peer cache the worker stages into and the restore
  plan file; the agent's donor server serves the cache (it outlives the
  worker), and the agent advertises the staged step to the master before
  every join and on every monitor tick.
- Monitors (``agent/monitor.py``, ``WorkerSpec.enable_monitors``): the
  ``ResourceMonitor`` relays the host's CPU and memory and the card stats
  the worker exports (the agent never touches the card). The JAX agent's
  ``TrainingMonitor`` and ``ParalConfigTuner`` threads are not started:
  no worker of either package writes the step-progress file or reads the
  tuned config. Nor is its ``relaunch_on_hanging`` restart by
  ``HangingDetector``: the step-hang watchdog covers a stalled worker.
- Diagnosis actions: after each successful liveness poll the agent
  drains the master's actions for its rank and executes them:
  ``profile`` writes the request the worker's profiler polls (captures
  land in ``$TMPDIR/dlrover-tpu-profiles-*/capture-<id>-<ts>/``, which
  outlives the agent and keeps the newest ``PROFILE_CAPTURES_KEPT``),
  ``checkpoint`` a save-and-continue drain request, ``drain`` a
  save-and-exit one, ``restart`` restarts the worker uncharged, and
  ``alert`` and ``observe`` are logged.
- Master loss: ``master_lost_after_polls`` consecutive failed liveness
  polls (each a full retry budget) put the agent in master-lost mode.
  The worker keeps training while the agent re-resolves the master (the
  bootstrap file a restarted or promoted master rewrites, then the env),
  reconnects with jittered backoff, re-registers through the generation
  handshake and restarts the worker only when the world moved on. A
  worker restart that cannot reach the master falls into the same mode
  (the full ``master_reconnect_timeout_s``), and a preemption notice
  abandons the reconnect to drain locally.
"""

from __future__ import annotations

import dataclasses
import datetime
import glob
import os
import shutil
import signal
import subprocess
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import grpc

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.agent.master_client import MasterClient, backoff_delay_s
from dlrover_tpu_torch.agent.preemption import (
    PreemptionNotice,
    PreemptionWatcher,
    default_sources,
    write_drain_request,
)
from dlrover_tpu_torch.common.bootstrap import publish_or_wait_coordinator
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import (
    DefaultValues,
    NodeEnv,
    NodeExitReason,
    RendezvousName,
    TrainingMsgLevel,
    WorkerExit,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.obs.profiler import write_profile_request
from dlrover_tpu_torch.obs.timeline import load_timeline
from dlrover_tpu_torch.trainer.watchdog import default_warmup_s

# profiler captures (~45 MB each for Llama-1B) an agent keeps on disk: a
# new request removes the oldest beyond this
PROFILE_CAPTURES_KEPT = 4


class RelaunchGovernor:
    """Per-rank relaunch pacing: exponential delay between worker
    relaunches (base·2^(k−1) for the k-th recent failure, capped; no
    jitter: one agent, one worker) and quarantine once
    ``quarantine_failures`` land inside ``quarantine_window_s``. A
    flapping worker must not hot-loop respawns. Driven only from the
    agent's main run loop, so no lock.

    Hang-aborts do not charge ``max_restarts``, so they need their own
    loop-breaker the time window cannot provide (a watchdog cycle of a
    few minutes never fits ``quarantine_failures`` aborts inside the
    window): ``record_hang`` counts CONSECUTIVE hangs from incarnations
    that made no forward progress. Progress is judged two ways: the
    incarnation pushed the job's step high-water mark (the timeline
    export the agent reads; re-treading checkpointed steps is NOT
    forward progress), or it outlived the watchdog's warmup-plus-slack
    horizon. Either one, on ANY death, resets the streak.
    ``quarantine_failures`` no-progress hangs in a row quarantine the
    rank however slowly they arrive."""

    def __init__(self, clock=time.monotonic):
        ctx = Context.singleton()
        self._base_s = ctx.relaunch_backoff_base_s
        self._max_s = ctx.relaunch_backoff_max_s
        self._quarantine_failures = ctx.quarantine_failures
        self._window_s = ctx.quarantine_window_s
        # the watchdog's own first-step budget plus 2·hang of slack: an
        # incarnation alive past this has stepped even if the timeline
        # export never landed
        hang_s = ctx.hang_watchdog_s
        self._hang_progress_horizon_s = (default_warmup_s(hang_s)
                                         + 2.0 * hang_s)
        self._consecutive_early_hangs = 0
        self._clock = clock
        self._failures = deque()

    def _trim(self, now: float) -> None:
        while self._failures and now - self._failures[0] > self._window_s:
            self._failures.popleft()

    def _note_progress(self, lifetime_s: float,
                       made_progress: bool) -> None:
        if (made_progress
                or lifetime_s >= self._hang_progress_horizon_s):
            self._consecutive_early_hangs = 0

    def record_failure(self, lifetime_s: float = 0.0,
                       made_progress: bool = False) -> float:
        """Register one worker failure (any kind); returns the backoff
        delay to apply before the relaunch. A productive incarnation
        breaks the no-progress hang streak even when it ends in a
        crash."""
        self._note_progress(lifetime_s, made_progress)
        now = self._clock()
        self._trim(now)
        self._failures.append(now)
        exponent = min(len(self._failures) - 1, 62)
        return min(self._max_s, self._base_s * (2.0 ** exponent))

    def record_hang(self, lifetime_s: float,
                    made_progress: bool = False) -> None:
        """Register a watchdog hang-abort. Counts toward the streak only
        when the incarnation made NO forward progress."""
        if (made_progress
                or lifetime_s >= self._hang_progress_horizon_s):
            self._consecutive_early_hangs = 0
        else:
            self._consecutive_early_hangs += 1

    @property
    def recent_failures(self) -> int:
        self._trim(self._clock())
        return len(self._failures)

    @property
    def quarantined(self) -> bool:
        if self._quarantine_failures <= 0:
            return False
        return (self.recent_failures >= self._quarantine_failures
                or (self._consecutive_early_hangs
                    >= self._quarantine_failures))


@dataclasses.dataclass
class WorkerSpec:
    """What to run on this node."""

    entrypoint: List[str]                    # argv of the training process
    devices_per_node: int = 1                # local card count
    max_restarts: int = DefaultValues.MAX_RELAUNCH
    monitor_interval_s: float = DefaultValues.MONITOR_INTERVAL_S
    rdzv_timeout_s: float = DefaultValues.RDZV_TIMEOUT_S
    # SIGTERM → SIGKILL grace: must cover one train step + a forced
    # checkpoint commit (the worker saves on SIGTERM)
    shutdown_grace_s: float = 120.0
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    # side monitors (resource and step reporting, tuned-config polling)
    enable_monitors: bool = True
    # consecutive failed num_nodes_waiting polls (each already a full
    # retry_rpc budget) before the master is declared lost and the
    # agent enters the reconnect loop
    master_lost_after_polls: int = 2

    def __post_init__(self) -> None:
        # THIS interval paces the agent's num_nodes_waiting poll, the
        # master's main liveness signal
        timeout = Context.singleton().dead_node_timeout_s
        if 0 < timeout < 3 * self.monitor_interval_s:
            logger.warning(
                "dead_node_timeout_s (%.0fs) < 3x the agent poll "
                "interval (--monitor-interval %.0fs): healthy agents "
                "may be declared dead between polls; raise the timeout "
                "or lower the poll interval",
                timeout, self.monitor_interval_s)


class RendezvousTimeoutError(TimeoutError):
    pass


class MasterLostError(RuntimeError):
    """The master stayed unreachable past the reconnect budget."""


class PreemptedDuringOutage(Exception):
    """A preemption notice arrived while the agent was in master-lost
    reconnect: the reconnect is abandoned so the grace window goes to
    the local emergency checkpoint, not to dialing a dead master."""


class ElasticAgent:
    """Joins the master rendezvous and keeps one training process alive."""

    def __init__(self, client: MasterClient, spec: WorkerSpec,
                 rdzv_name: str = RendezvousName.TRAINING):
        self._client = client
        self._spec = spec
        self._rdzv_name = rdzv_name
        self._restart_count = 0
        # set by shutdown(): the run loop must not resurrect the worker
        # it just killed
        self._shutdown = threading.Event()
        self._proc: Optional[subprocess.Popen] = None
        self.last_world: Dict[int, int] = {}
        self.last_round = -1
        # consecutive failed liveness polls (master-lost detection)
        self._master_fail_streak = 0
        # relaunch pacing: backoff between respawns, quarantine on flap
        self._governor = RelaunchGovernor()
        self._monitors: List = []
        # peer-to-peer restore: the worker stages its state into the
        # cache; the donor server (started in run(), owned by THIS
        # process so it outlives worker restarts) serves it, and the
        # join result's restore plan lands in the plan file
        self._workdir = tempfile.mkdtemp(prefix="dlrover-tpu-agent-")
        # the card stats the worker exports for the ResourceMonitor
        self.chip_stats_file = os.path.join(self._workdir, "chips.json")
        # on-demand profiler captures the agent requests for a master
        # `profile:{rank}` action; the worker's ProfilerSession polls the
        # request file and writes its captures under the dump dir, which
        # outlives the work dir (removed at exit when it holds none)
        self.profile_request_file = os.path.join(
            self._workdir, "profile_request.json")
        self.profile_dump_dir = tempfile.mkdtemp(
            prefix="dlrover-tpu-profiles-")
        self._profile_request_seq = 0
        self.peer_cache_dir = os.path.join(self._workdir, "peer_cache")
        self.restore_plan_file = os.path.join(self._workdir,
                                              "restore_plan.json")
        # the parallelism plan of the join result (parallel/planner.py):
        # the spawned worker builds its shape from this file, or
        # re-fetches a fresh plan by RPC
        self.shard_plan_file = os.path.join(self._workdir,
                                            "shard_plan.json")
        self._peer_donor = None
        # (ino, mtime_ns, size) of the manifest at the last report: the
        # monitor tick re-parses and re-reports only a changed manifest
        self._peer_reported_statkey: Optional[Tuple] = None
        # the worker exports its per-step timeline here: the governor's
        # forward-progress evidence
        self.timeline_file = os.path.join(self._workdir, "timeline.json")
        # preemption drain plumbing: the notice file chaos and platform
        # hooks write (PreemptionWatcher polls it; honoured from the env
        # so a hook outside this agent can name the path), and the drain
        # request the worker's step loop consumes
        self.preempt_notice_file = os.environ.get(
            NodeEnv.PREEMPTION_NOTICE_FILE,
            os.path.join(self._workdir, "preempt_notice.json"))
        self.drain_request_file = os.path.join(
            self._workdir, "drain_request.json")
        self._drain_seq = 0
        # set by the PreemptionWatcher thread; consumed only by the main
        # run loop, which alone touches the worker process
        self._preempt_notice: Optional[PreemptionNotice] = None
        self._preempt_event = threading.Event()
        self._preempt_watcher: Optional[PreemptionWatcher] = None
        self._spawn_ts = time.monotonic()
        # the job's step high-water mark at spawn (from the timeline
        # export): an incarnation that pushes past it made FORWARD
        # progress; re-treading checkpointed steps does not count
        self._spawn_step = -1
        # batches the agent's finished spans (rendezvous, drain) for the
        # master's goodput ledger; flushed from the monitor loop
        self._span_exporter = obs.SpanExporter()
        obs.add_span_sink(self._span_exporter)

    @property
    def worker_pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    # -- rendezvous --------------------------------------------------------
    def rendezvous(self) -> Tuple[int, Dict[int, int]]:
        """Join and poll until this node is in a completed world."""
        spec = self._spec
        # the agent-side span is the trace root: the join RPC carries its
        # context, so the master's rendezvous_join span shares the trace
        with obs.span("rendezvous",
                      {"rdzv": self._rdzv_name,
                       "rank": self._client.node_rank}) as rdzv_span:
            # advertise this host's staged state BEFORE joining: a
            # relaunched rank's plan (computed at its own join) must be
            # able to name this host's donor
            self._report_peer_store(force=True)
            joined_round = self._client.join_rendezvous(
                spec.devices_per_node, self._rdzv_name)
            self._publish_restore_plan()
            deadline = time.time() + spec.rdzv_timeout_s
            while time.time() < deadline:
                rdzv_round, _, world = self._client.get_comm_world(
                    self._rdzv_name
                )
                if world and self._client.node_rank in world:
                    self.last_world, self.last_round = world, rdzv_round
                    rdzv_span.set_attr("round", rdzv_round)
                    rdzv_span.set_attr("world_size", len(world))
                    return rdzv_round, world
                if rdzv_round > joined_round:
                    # our round was cut without us (world invalidated by
                    # a member death, or node_unit rounding): re-join
                    logger.info(
                        "rendezvous round %d passed without this node; "
                        "re-joining", joined_round,
                    )
                    joined_round = self._client.join_rendezvous(
                        spec.devices_per_node, self._rdzv_name)
                time.sleep(0.5)
            raise RendezvousTimeoutError(
                f"rendezvous {self._rdzv_name!r} did not complete within "
                f"{spec.rdzv_timeout_s:.0f}s"
            )

    def _bootstrap_env(self, rdzv_round: int,
                       world: Dict[int, int]) -> Dict[str, str]:
        """Derive this round's process set; the lowest rank publishes the
        process group's rendezvous address via the master KV store."""
        ranks = sorted(world)
        process_id = ranks.index(self._client.node_rank)
        slice_id = self._client.slice_id
        # in slice mode each slice is its own process group with its own
        # round counter: the coordinator key is scoped by slice, or two
        # slices cutting round N would collide
        coord_key = (f"coord/{self._rdzv_name}/slice{slice_id}/"
                     f"{rdzv_round}" if slice_id >= 0
                     else f"coord/{self._rdzv_name}/{rdzv_round}")
        coord = publish_or_wait_coordinator(
            self._client, coord_key, process_id, self._spec.rdzv_timeout_s,
        )
        env = dict(os.environ)
        env.update(self._spec.env)
        env.update({
            NodeEnv.MASTER_ADDR: self._client.master_addr,
            # the coordination tier the join result advertised ("" =
            # single-tier): the worker's hot kv traffic dials it
            NodeEnv.COORD_ADDR: self._client.coord_addr,
            NodeEnv.NODE_ID: str(self._client.node_id),
            NodeEnv.NODE_RANK: str(self._client.node_rank),
            NodeEnv.WORLD_SIZE: str(len(ranks)),
            NodeEnv.PROCESS_ID: str(process_id),
            NodeEnv.COORDINATOR_ADDR: coord,
            NodeEnv.RDZV_ROUND: str(rdzv_round),
            NodeEnv.DEVICES_PER_NODE: str(self._spec.devices_per_node),
            NodeEnv.CHIP_STATS_FILE: self.chip_stats_file,
            NodeEnv.PROFILE_REQUEST_FILE: self.profile_request_file,
            NodeEnv.PEER_CACHE_DIR: self.peer_cache_dir,
            NodeEnv.RESTORE_PLAN_FILE: self.restore_plan_file,
            NodeEnv.SHARD_PLAN_FILE: self.shard_plan_file,
            NodeEnv.TIMELINE_FILE: self.timeline_file,
            NodeEnv.DRAIN_REQUEST_FILE: self.drain_request_file,
            # the worker sees the notice path the agent polls, so the
            # chaos `preempt` fault (run in the worker's step loop)
            # delivers a notice to THIS agent
            NodeEnv.PREEMPTION_NOTICE_FILE: self.preempt_notice_file,
        })
        if slice_id >= 0:
            # the worker's slice: it arms the cross-slice gradient sync
            # and the slice-targeted chaos faults. A sliceless agent
            # leaves the worker's environment as it is
            env[NodeEnv.SLICE_ID] = str(slice_id)
        return env

    # -- worker lifecycle --------------------------------------------------
    def _spawn(self) -> None:
        rdzv_round, world = self.rendezvous()
        env = self._bootstrap_env(rdzv_round, world)
        logger.info(
            "spawning worker (round %d, world %s, restart %d): %s",
            rdzv_round, sorted(world), self._restart_count,
            self._spec.entrypoint,
        )
        self._proc = subprocess.Popen(self._spec.entrypoint, env=env)
        self._spawn_ts = time.monotonic()
        self._spawn_step = self._timeline_step()
        obs.get_flight_recorder().record_event(
            "worker_spawn", round=rdzv_round, world=sorted(world),
            restart=self._restart_count, pid=self._proc.pid)

    def _stop_worker(self) -> None:
        if self._proc is None or self._proc.poll() is not None:
            return
        self._proc.send_signal(signal.SIGTERM)
        try:
            self._proc.wait(self._spec.shutdown_grace_s)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()

    def _restart_worker_resilient(self, count_against_budget: bool
                                  ) -> None:
        """_restart_worker, but a restart whose own rendezvous cannot
        reach the master falls into master-lost handling: a worker crash
        DURING a master outage gets the full reconnect budget, not one
        RPC retry budget. After reconnection the resync sees the dead
        worker and respawns it. Only transport errors divert: a
        RendezvousTimeoutError (the master answered, the world never
        formed) or a spawn failure propagates."""
        try:
            self._restart_worker(count_against_budget)
        except grpc.RpcError as exc:
            logger.warning(
                "worker restart could not reach the master (%s); "
                "entering master-lost mode", exc)
            self._handle_master_loss()

    def _restart_worker(self, count_against_budget: bool) -> None:
        """Membership-change restarts are normal elasticity and do NOT
        consume the failure budget."""
        self._stop_worker()
        if count_against_budget:
            self._restart_count += 1
        self._spawn()

    def _start_monitors(self) -> None:
        if not self._spec.enable_monitors:
            return
        from dlrover_tpu_torch.agent.monitor import ResourceMonitor

        self._monitors = [
            ResourceMonitor(self._client,
                            chip_stats_file=self.chip_stats_file),
        ]
        for monitor in self._monitors:
            monitor.start()

    def _stop_monitors(self) -> None:
        for monitor in self._monitors:
            monitor.stop()
        self._monitors = []

    # -- main loop ---------------------------------------------------------
    def run(self) -> int:
        """Monitor loop. Returns the worker's final exit code, POSIX-shaped
        (134, not -6)."""
        recorder = obs.get_flight_recorder()
        # ORDER MATTERS: the drain SIGTERM source installs first, the
        # recorder's dump handler second; the recorder chains to its
        # predecessor, so one SIGTERM yields both the flight dump and the
        # drain notice
        self._start_preemption_watcher()
        if threading.current_thread() is threading.main_thread():
            # postmortem timeline even when the agent itself is SIGTERMed
            recorder.install_signal_handlers()
        recorder.install_excepthook()
        try:
            self._spawn()
            # after the spawn: the donor's module imports torch (seconds),
            # which now overlaps the worker's own start; nothing is staged
            # to donate before the worker's first save
            self._start_peer_donor()
            self._start_monitors()
            return WorkerExit.to_exit_status(self._run_loop())
        except BaseException:
            # never orphan the trainer on the way out
            self._stop_worker()
            raise
        finally:
            self._stop_monitors()
            if self._preempt_watcher is not None:
                self._preempt_watcher.stop()
            self._stop_peer_donor()
            self._remove_workdir()
            self._flush_telemetry()
            obs.remove_span_sink(self._span_exporter)
            recorder.dump(reason="agent-exit")

    def _remove_workdir(self) -> None:
        """The staged copies and handoff files die with the agent that
        served them; profiler captures outlive it."""
        shutil.rmtree(self._workdir, ignore_errors=True)
        try:
            os.rmdir(self.profile_dump_dir)
        except OSError:
            logger.info("profiler captures kept in %s",
                        self.profile_dump_dir)

    def _flush_telemetry(self) -> None:
        self._span_exporter.flush_to(self._client)

    def _interruptible_wait(self, delay_s: float) -> None:
        """Sleep up to ``delay_s``, returning early on shutdown or a
        preemption notice: every sleep of the main loop sits inside the
        grace window, and the window is short."""
        end = time.monotonic() + delay_s
        while (time.monotonic() < end
               and not self._shutdown.is_set()
               and not self._preempt_event.is_set()):
            time.sleep(min(0.2, max(0.0, end - time.monotonic())))

    def _run_loop(self) -> int:
        spec = self._spec
        while True:
            self._interruptible_wait(spec.monitor_interval_s)
            if self._shutdown.is_set():
                return 0
            # a preemption notice outranks everything: this host is going
            # away, so drain instead of monitoring
            if self._preempt_event.is_set():
                return self._drain(self._preempt_notice)
            self._flush_telemetry()
            code = self._proc.poll()
            if code is not None:
                if self._shutdown.is_set():
                    return 0
                if code == 0:
                    logger.info("worker finished successfully")
                    return 0
                kind = WorkerExit.classify(
                    code, hang_enabled=self._hang_watchdog_enabled())
                if kind == NodeExitReason.DRAINED:
                    # the worker drained itself (a notice the agent never
                    # saw): a clean departure, no failure report, no
                    # relaunch charge
                    return self._conclude_drain(code, deadline=0.0,
                                                reason="worker-initiated")
                outcome = self._handle_worker_failure(code, kind)
                if outcome is not None:
                    return outcome
                continue
            # healthy: a membership change re-forms the world. Diagnosis
            # actions are polled only after a SUCCESSFUL liveness probe:
            # during a master outage an extra RPC here would block a full
            # timeout per tick before the probe that advances the
            # master-lost streak
            try:
                waiting = self._client.num_nodes_waiting(self._rdzv_name)
                self._master_fail_streak = 0
            except Exception:  # retry budget exhausted this poll
                self._master_fail_streak += 1
                if (self._master_fail_streak
                        >= spec.master_lost_after_polls):
                    self._master_fail_streak = 0
                    self._handle_master_loss()
                continue
            self._poll_diagnosis_actions()
            # keep the master's donor registry fresh: the worker staged
            # a newer step since the last report (one os.stat)
            self._report_peer_store()
            if waiting > 0:
                logger.info(
                    "%d node(s) waiting: restarting worker to re-form the "
                    "world", waiting,
                )
                obs.get_flight_recorder().record_event(
                    "membership_restart", waiting=waiting)
                self._restart_worker_resilient(count_against_budget=False)

    # -- failure classification / relaunch pacing --------------------------
    def _timeline_step(self) -> int:
        """The job's step high-water mark from the worker's timeline
        export (-1 when absent or corrupt: readers poll mid-flight)."""
        payload = load_timeline(self.timeline_file)
        if payload is None:
            return -1
        steps = (int(s.get("step", -1)) for s in payload["steps"]
                 if isinstance(s, dict))
        return max(steps, default=-1)

    @staticmethod
    def _hang_watchdog_enabled() -> bool:
        return Context.singleton().hang_watchdog_s > 0

    def _handle_worker_failure(self, code: int, kind: str
                               ) -> Optional[int]:
        """One classified worker failure: report it, pace the relaunch
        (backoff + quarantine), restart. Returns a terminal exit code, or
        None when the worker was restarted and the loop continues."""
        spec = self._spec
        recorder = obs.get_flight_recorder()
        lifetime_s = time.monotonic() - self._spawn_ts
        # forward progress = the incarnation pushed the job's step
        # high-water mark; a respawn hanging before it re-reaches the
        # previous mark is the no-progress loop quarantine is for
        made_progress = self._timeline_step() > self._spawn_step
        recorder.record_event("worker_failed", exit_code=code, kind=kind,
                              restart=self._restart_count)
        if kind == NodeExitReason.HANG:
            recorder.record_event("worker_hang_abort", exit_code=code)
        try:
            self._client.report_failure(
                f"worker exit code {code}",
                level=TrainingMsgLevel.PROCESS_ERROR,
                restart_count=self._restart_count,
                exit_kind=kind,
            )
        except Exception:  # master down: the restart's own rendezvous
            # surfaces a persistent outage
            logger.warning("could not report worker failure "
                           "(master unreachable)")
        # a watchdog hang-abort is the backstop doing its job, not a
        # worker defect: restart without charging max_restarts; the
        # governor's no-progress hang streak quarantines a deterministic
        # hang loop the time window alone could never catch
        counts = kind != NodeExitReason.HANG
        if not counts:
            self._governor.record_hang(lifetime_s,
                                       made_progress=made_progress)
        if counts and self._restart_count >= spec.max_restarts:
            logger.error(
                "worker failed (exit %d, %s) with restart budget "
                "exhausted (%d)", code, kind, spec.max_restarts,
            )
            return code
        delay = self._governor.record_failure(
            lifetime_s, made_progress=made_progress)
        registry = obs.get_registry()
        registry.gauge(
            "dlrover_tpu_agent_relaunch_backoff_seconds",
            "Backoff applied before the most recent worker relaunch",
        ).set(delay)
        if self._governor.quarantined:
            registry.gauge(
                "dlrover_tpu_agent_quarantined",
                "1 while this agent's rank is quarantined "
                "(relaunches stopped after repeated failures)").set(1)
            recorder.record_event(
                "worker_quarantined", exit_code=code, kind=kind,
                recent_failures=self._governor.recent_failures)
            logger.error(
                "worker QUARANTINED: %d failures inside the window; "
                "refusing to relaunch (exit %d)",
                self._governor.recent_failures, code)
            try:
                self._client.report_failure(
                    f"rank quarantined after "
                    f"{self._governor.recent_failures} failures",
                    level=TrainingMsgLevel.NODE_ERROR,
                    restart_count=self._restart_count,
                    exit_kind=kind,
                )
            except Exception:  # noqa: BLE001
                pass
            return code
        if delay > 0:
            recorder.record_event("relaunch_backoff", delay_s=delay,
                                  recent_failures=(
                                      self._governor.recent_failures))
            logger.warning(
                "worker failed (exit %d, %s); backing off %.1fs before "
                "relaunch (%d recent failures)", code, kind, delay,
                self._governor.recent_failures)
            self._interruptible_wait(delay)
            if self._shutdown.is_set():
                return 0
            # a preemption notice mid-backoff outranks the relaunch: the
            # respawn would die with the machine anyway, so drain
            if self._preempt_event.is_set():
                logger.warning(
                    "preemption notice during relaunch backoff; "
                    "draining instead of respawning")
                return self._drain(self._preempt_notice)
        logger.warning(
            "worker failed (exit %d, %s); restarting (%d/%d)",
            code, kind, self._restart_count + (1 if counts else 0),
            spec.max_restarts,
        )
        self._restart_worker_resilient(count_against_budget=counts)
        return None

    # -- preemption drain --------------------------------------------------
    def _start_preemption_watcher(self) -> None:
        def _on_notice(notice: PreemptionNotice) -> None:
            # watcher thread: only flip the event; the main run loop
            # owns the worker process and every RPC
            self._preempt_notice = notice
            self._preempt_event.set()

        self._preempt_watcher = PreemptionWatcher(
            _on_notice,
            sources=default_sources(notice_file=self.preempt_notice_file))
        self._preempt_watcher.start()

    def _drain(self, notice: PreemptionNotice) -> int:
        """The graceful exit: hand the worker a deadline-bounded
        save-and-exit request, announce the drain, await the clean-drain
        exit (force-stopping at the deadline: the machine goes away then
        anyway), conclude with the master. Never a failure: no relaunch
        charge, no failure report."""
        recorder = obs.get_flight_recorder()
        deadline = notice.deadline
        recorder.record_event(
            "preempt_notice", rank=self._client.node_rank,
            deadline=deadline, grace_s=round(notice.grace_s, 1),
            source=notice.source, reason=notice.reason[:256])
        obs.get_registry().counter(
            "dlrover_tpu_agent_preempt_notices_total",
            "Preemption notices this agent acted on",
            labelnames=("source",)).labels(source=notice.source).inc()
        with obs.span("drain", {"rank": self._client.node_rank,
                                "source": notice.source}) as drain_span:
            # the worker's drain request goes out FIRST: against an
            # unreachable master the announce below burns its whole retry
            # budget, and the emergency checkpoint must be running by then
            self._drain_seq += 1
            write_drain_request(self.drain_request_file, self._drain_seq,
                                deadline, reason=notice.reason,
                                exit_worker=True)
            logger.info("drain request %d written (deadline in %.1fs)",
                        self._drain_seq, deadline - time.time())
            try:
                result = self._client.report_drain(
                    deadline, reason=notice.reason, phase="notice")
                logger.info(
                    "drain announced to the master (urgent checkpoint "
                    "fanned out to ranks %s)", result.checkpoint_ranks)
            except Exception:  # noqa: BLE001 — master down: the local
                # emergency checkpoint matters more than the announce
                logger.warning("could not announce drain to the master; "
                               "draining locally anyway")
            code = self._await_worker_departure(deadline)
            drain_span.set_attr("exit_code", code)
        return self._conclude_drain(code, deadline, notice.reason)

    def _await_worker_departure(self, deadline: float) -> int:
        """Poll the worker until it exits or the deadline lands; a worker
        that ignored the request (not running the elastic loop, or
        wedged) is force-stopped: a SIGTERM save beats the platform's
        SIGKILL a moment later."""
        while time.time() < deadline:
            if self._shutdown.is_set():
                break
            code = self._proc.poll() if self._proc is not None else 0
            if code is not None:
                return code
            time.sleep(0.2)
        logger.warning("worker still running at the drain deadline; "
                       "force-stopping")
        self._stop_worker()
        return self._proc.returncode if self._proc is not None else 0

    def _conclude_drain(self, code: int, deadline: float,
                        reason: str) -> int:
        kind = WorkerExit.classify(
            code, hang_enabled=self._hang_watchdog_enabled())
        clean = kind in (NodeExitReason.DRAINED, NodeExitReason.SUCCEEDED)
        obs.get_flight_recorder().record_event(
            "worker_drained", exit_code=code, kind=kind, clean=clean,
            reason=reason[:256])
        try:
            self._client.report_drain(deadline, reason=reason,
                                      phase="complete")
        except Exception:  # noqa: BLE001 — the master's blown-deadline
            # reap is the fallback when this RPC is lost
            logger.warning("could not report drain completion")
        logger.info("drain complete (worker exit %d, %s): agent "
                    "departing", code, kind)
        return 0 if clean else code

    def shutdown(self) -> None:
        self._shutdown.set()
        self._stop_worker()

    # -- master failover ---------------------------------------------------
    def _handle_master_loss(self) -> None:
        """Degraded "master lost" mode. The worker keeps training (it
        needs the master only for shards and elasticity) while this loop
        (1) re-resolves the master address (bootstrap file, env), (2)
        reconnects with jittered exponential backoff, (3) re-registers
        through the generation handshake, and (4) re-syncs the
        rendezvous, restarting the worker only when the world moved on.
        Raises MasterLostError once master_reconnect_timeout_s is
        exhausted."""
        ctx = Context.singleton()
        recorder = obs.get_flight_recorder()
        logger.error(
            "master at %s unreachable: entering master-lost mode "
            "(worker keeps running; reconnect budget %.0fs)",
            self._client.master_addr, ctx.master_reconnect_timeout_s)
        recorder.record_event("master_lost",
                              addr=self._client.master_addr,
                              rank=self._client.node_rank)
        obs.get_registry().counter(
            "dlrover_tpu_master_lost_total",
            "Master-lost episodes entered by this agent").inc()
        while True:
            try:
                result = self._reconnect_master(ctx, recorder)
            except PreemptedDuringOutage:
                # this host is going away: the run loop's next tick
                # consumes the preempt event and drains locally
                logger.warning(
                    "preemption notice during master-lost reconnect; "
                    "abandoning the reconnect to drain locally")
                return
            try:
                self._resync_rendezvous(result)
                return
            except grpc.RpcError as exc:
                # the master flapped again mid-resync: back to the
                # reconnect loop; anything non-transport propagates
                logger.warning(
                    "master flapped during rendezvous re-sync (%s); "
                    "re-entering the reconnect loop", exc)

    def _reconnect_master(self, ctx, recorder):
        """Dial until one reconnect_report round-trips (or the budget
        runs out); returns the master's ReconnectResult."""
        deadline = time.time() + ctx.master_reconnect_timeout_s
        attempt = 0
        while True:
            if self._shutdown.is_set():
                raise MasterLostError("agent shut down mid-reconnect")
            if self._preempt_event.is_set():
                raise PreemptedDuringOutage()
            addr = self._client.resolve_master_addr(
                self._client.master_addr)
            try:
                with obs.span("reconnect",
                              {"addr": addr,
                               "rank": self._client.node_rank,
                               "attempt": attempt}) as reconnect_span:
                    self._client.reconnect(addr)
                    result = self._client.reconnect_report(
                        local_world_size=self._spec.devices_per_node,
                        rdzv_name=self._rdzv_name,
                        rdzv_round=self.last_round,
                    )
                    reconnect_span.set_attr("generation",
                                            result.generation)
                    reconnect_span.set_attr("world_intact",
                                            result.world_intact)
            except Exception as exc:  # noqa: BLE001 — grpc errors vary
                attempt += 1
                if time.time() >= deadline:
                    raise MasterLostError(
                        f"master unreachable for "
                        f"{ctx.master_reconnect_timeout_s:.0f}s "
                        f"(last tried {addr})") from exc
                delay = backoff_delay_s(attempt, ctx.rpc_backoff_s,
                                        ctx.rpc_backoff_max_s)
                logger.warning(
                    "master still unreachable at %s (attempt %d): %s; "
                    "next dial in %.1fs", addr, attempt, exc, delay)
                # a preemption notice or a shutdown mid-sleep must not
                # wait out the full delay
                self._interruptible_wait(delay)
                continue
            logger.info(
                "reconnected to master %s (generation %d, world "
                "intact=%s)", addr, result.generation,
                result.world_intact)
            recorder.record_event(
                "master_reconnected", addr=addr,
                generation=result.generation,
                world_intact=result.world_intact)
            return result

    def _resync_rendezvous(self, result) -> None:
        """After re-registration: keep the running worker only when the
        restored master still holds OUR world as its latest; otherwise
        restart so the world re-forms through a fresh rendezvous."""
        with obs.span("rendezvous",
                      {"rdzv": self._rdzv_name,
                       "rank": self._client.node_rank,
                       "resync": True}) as resync_span:
            worker_alive = (self._proc is not None
                            and self._proc.poll() is None)
            intact = result.world_intact and worker_alive
            if intact:
                try:
                    _, _, world = self._client.get_comm_world(
                        self._rdzv_name)
                    intact = bool(world) and world == self.last_world
                except Exception:  # noqa: BLE001 — master flapped again
                    intact = False
            resync_span.set_attr("world_intact", intact)
            if intact:
                logger.info("world %s survived the master outage; "
                            "worker keeps running", sorted(self.last_world))
                return
            logger.info("world changed across the master outage; "
                        "restarting worker to re-form")
            self._restart_worker(count_against_budget=False)

    # -- diagnosis actions -------------------------------------------------
    def _poll_diagnosis_actions(self) -> None:
        """Drain and execute the master's diagnosis actions for this
        rank. Best-effort: a failed poll is skipped (the next tick
        retries), and an action that cannot execute does not kill the
        agent."""
        try:
            actions = self._client.poll_diagnosis_actions()
        except Exception:  # noqa: BLE001 — droppable, next tick retries
            return
        for action in actions:
            try:
                self._execute_diagnosis_action(action)
            except Exception:  # noqa: BLE001
                logger.exception("diagnosis action failed: %s", action)

    def _execute_diagnosis_action(self, action: dict) -> None:
        kind = str(action.get("kind", "observe"))
        reason = str(action.get("reason", ""))
        obs.get_flight_recorder().record_event(
            "diagnosis_action_executed", kind=kind,
            id=action.get("id", 0), reason=reason[:256])
        obs.get_registry().counter(
            "dlrover_tpu_agent_diagnosis_actions_total",
            "Diagnosis actions this agent executed",
            labelnames=("kind",)).labels(kind=kind).inc()
        if kind == "profile":
            self._request_profile(action)
        elif kind in ("checkpoint", "drain"):
            self._request_save(action, exit_worker=kind == "drain")
        elif kind == "restart":
            logger.warning("diagnosis: restarting worker (%s)", reason)
            self._restart_worker_resilient(count_against_budget=False)
        elif kind == "alert":
            logger.warning("diagnosis alert: %s", reason)
        else:
            logger.info("diagnosis observe: %s", reason)

    def _request_profile(self, action: dict) -> None:
        """A master ``profile:{rank}`` action becomes a capture request
        the worker's ProfilerSession polls each step
        (``obs/profiler.py``); the capture lands under the dump dir,
        which keeps the newest ``PROFILE_CAPTURES_KEPT`` captures."""
        captures = sorted(
            glob.glob(os.path.join(self.profile_dump_dir, "capture-*")),
            key=os.path.getmtime)
        for old in captures[:max(0, len(captures)
                                 - PROFILE_CAPTURES_KEPT + 1)]:
            shutil.rmtree(old, ignore_errors=True)
        self._profile_request_seq += 1
        num_steps = int(action.get("num_steps", 5) or 5)
        write_profile_request(
            self.profile_request_file, self._profile_request_seq,
            num_steps, self.profile_dump_dir)
        logger.info(
            "diagnosis: requested a %d-step profiler capture (#%d) -> %s",
            num_steps, self._profile_request_seq, self.profile_dump_dir)

    def _request_save(self, action: dict, exit_worker: bool) -> None:
        """A master ``checkpoint:{rank}`` action (a peer is draining)
        hands the worker a save-now-KEEP-RUNNING request through the
        drain file, consumed at its next step boundary; a
        ``drain:{rank}`` one (this rank's slice is draining) a
        save-and-EXIT request, after which the run loop sees the clean
        drain exit and concludes the drain with the master."""
        self._drain_seq += 1
        deadline = float(action.get("deadline", 0.0) or 0.0)
        if deadline <= 0.0:
            deadline = (time.time()
                        + Context.singleton().preempt_default_grace_s)
        write_drain_request(
            self.drain_request_file, self._drain_seq, deadline,
            reason=str(action.get("reason", "")), exit_worker=exit_worker)
        logger.info(
            "diagnosis: %s requested of the worker (#%d, deadline in "
            "%.0fs)", "save-and-exit drain" if exit_worker
            else "urgent checkpoint", self._drain_seq,
            max(0.0, deadline - time.time()))

    # -- peer-to-peer restore ----------------------------------------------
    def _start_peer_donor(self) -> None:
        """Serve this host's staged state to relaunched ranks. Owned by
        the agent: it must outlive worker restarts. Best-effort: with no
        donor, restores read the checkpoint, and the agent runs on."""
        if not Context.singleton().peer_restore_enabled:
            return
        from dlrover_tpu_torch.checkpoint.peer_restore import (
            PeerDonorServer,
        )

        try:
            self._peer_donor = PeerDonorServer(self.peer_cache_dir)
            self._peer_donor.start()
        except OSError:   # bind failures
            logger.warning("peer donor server failed to start; this host "
                           "will not donate state", exc_info=True)
            self._peer_donor = None

    def _stop_peer_donor(self) -> None:
        if self._peer_donor is not None:
            self._peer_donor.stop()
            self._peer_donor = None

    def _report_peer_store(self, force: bool = False) -> None:
        """Advertise the staged manifest (step and shard keys) to the
        master's donor registry; withdrawn when nothing is staged. Only
        a CHANGED manifest pays for the parse and the RPC unless forced
        (the monitor tick's check is one os.stat)."""
        if self._peer_donor is None:
            return
        from dlrover_tpu_torch.checkpoint.peer_restore import (
            MANIFEST,
            manifest_summary,
        )

        try:
            st = os.stat(os.path.join(self.peer_cache_dir, MANIFEST))
            statkey: Optional[Tuple] = (st.st_ino, st.st_mtime_ns,
                                        st.st_size)
        except OSError:
            statkey = None
        if not force and statkey == self._peer_reported_statkey:
            return
        step, keys, total_bytes = manifest_summary(self.peer_cache_dir)
        try:
            self._client.report_peer_store(
                self._peer_donor.addr, step, keys,
                total_bytes=total_bytes, rdzv_name=self._rdzv_name)
            self._peer_reported_statkey = statkey
        except Exception:  # noqa: BLE001 — best-effort; the next tick
            # (or the pre-join force) retries
            logger.warning("could not report the peer store to the master")

    def _publish_restore_plan(self) -> None:
        """The restore and parallelism plans the join result carried →
        the plan files the spawned worker reads (a worker with a master
        client re-fetches fresh plans by RPC; these copies serve the
        rest)."""
        for payload, path, what in (
                (self._client.last_restore_plan_json,
                 self.restore_plan_file, "restore"),
                (self._client.last_shard_plan_json,
                 self.shard_plan_file, "shard")):
            tmp = f"{path}.tmp"
            try:
                with open(tmp, "w") as f:
                    f.write(payload or "{}")
                os.replace(tmp, path)
            except OSError:
                logger.warning("could not publish the %s plan file", what)


def init_distributed(device=None) -> None:
    """Training-process entry: join the process group from the agent's
    env contract (``DLROVER_TPU_WORLD_SIZE``, ``DLROVER_TPU_PROCESS_ID``,
    ``DLROVER_TPU_COORDINATOR``, the ``host:port`` of rank 0); a no-op
    for a single process (standalone runs).

    On the card (``device`` None or CUDA) each process first pins its
    card, ``rank % device_count`` unless ``device`` names one, and the
    group runs NCCL for CUDA tensors and gloo for CPU tensors: the
    checkpointer's background saves stage to host memory and need the CPU
    backend. ``device="cpu"`` runs gloo alone. (torch is imported here:
    the agent itself never needs it.)
    """
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.common.device import resolve_device

    world_size = int(os.getenv(NodeEnv.WORLD_SIZE, "1"))
    if world_size <= 1:
        return
    rank = int(os.environ[NodeEnv.PROCESS_ID])
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            resolve_device(device)          # raises, naming device="cpu"
        index = (torch.device(device).index if device is not None
                 else None)
        torch.cuda.set_device(rank % torch.cuda.device_count()
                              if index is None else index)
        backend = "cpu:gloo,cuda:nccl"
    else:
        backend = "gloo"
    # the same generous registration budget as the JAX package: several
    # workers building kernels on one host register late
    timeout = int(os.getenv("DLROVER_TPU_DIST_INIT_TIMEOUT", "600"))
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ[NodeEnv.COORDINATOR_ADDR]}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
