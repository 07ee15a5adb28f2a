"""Hot-standby master: tail the snapshot stream, health-check the
primary, promote without a reconnect storm.

Own copy of the JAX package's ``master/standby.py``:

- **Warm state**: the standby tails the primary's snapshot stream (the
  shared ``--state-dir``) and keeps the newest valid snapshot parsed in
  memory; the hot ``coord/`` keys ride the mutation log, which promotion
  replays on top.
- **Health checks**: the primary's advertised address is read from the
  bootstrap file it publishes; a ``JobStatusRequest`` probes it every
  ``Context.standby_health_interval_s``. ``standby_promote_failures``
  CONSECUTIVE failed probes trigger promotion.
- **Promotion without a storm**: the standby builds a full
  ``JobMaster`` from its warm state (generation = the snapshot's + 1)
  on a fresh port, and atomically rewrites the bootstrap file. Agents in
  master-lost mode re-resolve from that file and re-register through the
  reconnect handshake; the restored rendezvous answers
  ``world_intact=True``, so workers never stop and nobody re-joins.
- **Fencing**: the bootstrap file carries the generation, and
  ``JobMaster._publish_bootstrap_addr`` never overwrites a higher one:
  a revived old primary cannot steal the fleet back.

CLI: ``python -m dlrover_tpu_torch.master.job_master --standby
--state-dir ... --bootstrap-file ...``, or embed with
``StandbyMaster(...).start()``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Tuple

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.state_backend import MasterStateBackend


class StandbyMaster:
    """One hot standby for one job's master. Watches, warms, promotes."""

    def __init__(self, state_dir: str,
                 bootstrap_file: Optional[str] = None,
                 port: int = 0, host: str = "0.0.0.0",
                 min_nodes: int = 1, max_nodes: int = 1,
                 node_unit: int = 1,
                 health_interval_s: Optional[float] = None,
                 promote_failures: Optional[int] = None):
        if not state_dir:
            raise ValueError("a standby needs the primary's --state-dir "
                             "(the snapshot stream it tails)")
        ctx = Context.singleton()
        if bootstrap_file:
            ctx.update(master_bootstrap_file=bootstrap_file)
        if not ctx.master_bootstrap_file:
            raise ValueError(
                "a standby needs the bootstrap file the primary "
                "publishes (--bootstrap-file): it is both the health-"
                "check target and the promotion handoff")
        self._state_dir = state_dir
        self._port = port
        self._host = host
        self._min_nodes = min_nodes
        self._max_nodes = max_nodes
        self._node_unit = node_unit
        self._health_interval_s = (
            health_interval_s if health_interval_s is not None
            else ctx.standby_health_interval_s)
        self._promote_failures = max(1, (
            promote_failures if promote_failures is not None
            else ctx.standby_promote_failures))
        self._backend = MasterStateBackend(state_dir)
        # a standby must never write the snapshot lineage it tails —
        # the backend stays permanently fenced (promotion hands the
        # state dir to a fresh JobMaster with its own gated backend)
        self._backend.gate = lambda: True
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # guards the watch-state shared between the standby thread
        # (run/refresh/probe) and the caller thread (start/stop/tests);
        # never held across a probe RPC or a snapshot disk read
        self._lock = threading.Lock()
        # warm state: (state dict, snapshot version) — what promotion
        # hands to JobMaster so it skips the cold disk read
        self.warm_state: Optional[Tuple[dict, int]] = None
        self.warm_version = -1
        self.consecutive_failures = 0
        self.promoted_master = None
        self._probe_client = None
        self._probe_addr = ""

    # -- snapshot tailing -------------------------------------------------
    def refresh_warm_state(self) -> bool:
        """Load the newest snapshot if the stream advanced past what we
        hold; returns whether anything new was adopted."""
        with self._lock:
            held_version = self.warm_version
        versions = self._backend.versions()
        if not versions or versions[-1] <= held_version:
            return False
        loaded = self._backend.load_latest()
        if loaded is None:
            return False
        state, version = loaded
        with self._lock:
            if version <= self.warm_version:
                return False
            self.warm_state = (state, version)
            self.warm_version = version
        obs.get_registry().gauge(
            "dlrover_tpu_standby_warm_snapshot_version",
            "Newest snapshot version the hot standby holds parsed in "
            "memory").set(version)
        return True

    # -- health checking --------------------------------------------------
    def _primary_addr(self) -> str:
        from dlrover_tpu_torch.agent.master_client import MasterClient

        return MasterClient.resolve_bootstrap().get("addr", "")

    def check_primary(self) -> bool:
        """One probe: resolve the primary from the bootstrap file and
        round-trip a JobStatusRequest with a short deadline. No
        published primary yet = healthy (nothing to take over)."""
        from dlrover_tpu_torch.agent.master_client import MasterClient

        addr = self._primary_addr()
        if not addr:
            return True
        with self._lock:
            probe = self._probe_client
            stale = None
            if addr != self._probe_addr or probe is None:
                # channel construction is lazy (no connect): safe to
                # swap under the lock; the dead channel closes outside
                stale, probe = probe, MasterClient(
                    addr, node_id=-1, node_type="standby",
                    timeout_s=max(1.0, self._health_interval_s))
                self._probe_client = probe
                self._probe_addr = addr
        if stale is not None:
            try:
                stale.close()
            except Exception:  # noqa: BLE001 — dead channel
                pass
        try:
            probe.get_job_status()
            return True
        except Exception:  # noqa: BLE001 — any failure is a failed probe
            return False

    # -- the watch loop ---------------------------------------------------
    def run(self) -> int:
        """Watch until promotion (then serve as the master: returns its
        exit code) or stop() (returns 0)."""
        logger.info(
            "hot standby watching %s (probe every %.1fs, promote after "
            "%d consecutive failures)", self._state_dir,
            self._health_interval_s, self._promote_failures)
        obs.get_flight_recorder().record_event(
            "standby_started", state_dir=self._state_dir,
            health_interval_s=self._health_interval_s,
            promote_failures=self._promote_failures)
        while not self._stopped.is_set():
            self.refresh_warm_state()
            if self.check_primary():
                with self._lock:
                    self.consecutive_failures = 0
            else:
                with self._lock:
                    self.consecutive_failures += 1
                    failures = self.consecutive_failures
                logger.warning(
                    "primary health probe failed (%d/%d consecutive)",
                    failures, self._promote_failures)
                if failures >= self._promote_failures:
                    master = self.promote()
                    if master is not None:
                        return master.run()
            self._stopped.wait(self._health_interval_s)
        return 0

    def start(self) -> threading.Thread:
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="standby-master")
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            promoted = self.promoted_master
            probe = self._probe_client
        if promoted is not None:
            promoted.stop(grace_s=0.1)
        if probe is not None:
            try:
                probe.close()
            except Exception:  # noqa: BLE001
                pass

    # -- promotion --------------------------------------------------------
    def promote(self):
        """Become the primary: a full JobMaster from the warm state
        (generation = snapshot's + 1, mutation log replayed), serving
        immediately, bootstrap file atomically rewritten. Agents'
        reconnect handshakes find their worlds intact in the restored
        rendezvous state — zero worker restarts, zero re-register
        storm."""
        from dlrover_tpu_torch.master.job_master import JobMaster

        started = time.monotonic()
        # one last look at the stream: the primary may have snapshotted
        # between our last tail and its death
        self.refresh_warm_state()
        with self._lock:
            warm_state = self.warm_state
            warm_version = self.warm_version
            failures = self.consecutive_failures
        logger.critical(
            "PROMOTING: primary failed %d consecutive health probes; "
            "standby takes over from snapshot v%d",
            failures, warm_version)
        master = JobMaster(
            port=self._port, min_nodes=self._min_nodes,
            max_nodes=self._max_nodes, node_unit=self._node_unit,
            host=self._host, state_dir=self._state_dir,
            preloaded_state=warm_state)
        master.prepare()   # serves + publishes the bootstrap handoff
        took_s = time.monotonic() - started
        with self._lock:
            self.promoted_master = master
        obs.get_flight_recorder().record_event(
            "master_promoted", addr=master.addr,
            coord_addr=master.coord_addr,
            generation=master.generation,
            snapshot_version=warm_version,
            failed_probes=failures,
            promotion_s=round(took_s, 4))
        obs.get_registry().counter(
            "dlrover_tpu_master_promotions_total",
            "Hot-standby masters promoted to primary").inc()
        obs.record_span("master_promotion", took_s,
                        attrs={"generation": master.generation,
                               "snapshot_version": warm_version})
        logger.critical(
            "PROMOTED in %.3fs: serving at %s (coord %s) as generation "
            "%d", took_s, master.addr, master.coord_addr or "-",
            master.generation)
        return master
