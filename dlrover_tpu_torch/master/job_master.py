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

Not ported yet (ROADMAP Queue A item 12): the state backend and hot
standby (with them the tsdb's sidecar file), the sharded rendezvous
router and the coordination tier, the fleet controller, the planner's
calibration, the master-side chaos injector, the job manager with its
scalers and watchers, the brain and the metrics HTTP exporter.
"""

from __future__ import annotations

import threading

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.comm import build_server, local_ip
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import default_logger as logger
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
from dlrover_tpu_torch.master.steptrace import StepTraceAssembler
from dlrover_tpu_torch.master.sync_service import ElasticPsService, SyncService


class JobMaster:
    """One instance per job: the standalone/local master."""

    def __init__(
        self,
        port: int = 0,
        min_nodes: int = 1,
        max_nodes: int = 1,
        node_unit: int = 1,
        host: str = "0.0.0.0",
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
        # the fleet's bounded history, sampled by the collector and fed
        # per rank by the servicer; no state dir, so no sidecar file
        self.tsdb = obs.TimeSeriesStore()
        self.tsdb_collector = obs.TsdbCollector(
            self.tsdb, goodput_ledger=self.goodput_ledger)
        # per-step critical paths: feeds the tsdb gating series and the
        # CriticalPathRule
        self.steptrace = StepTraceAssembler(tsdb=self.tsdb)
        self.diagnosis_manager = None
        if ctx.diagnosis_enabled:
            self.diagnosis_manager = DiagnosisManager(
                self.speed_monitor, goodput_ledger=self.goodput_ledger,
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
        )
        self._host = host
        self._server, self.port = build_server(
            self.servicer.get_bytes, self.servicer.report_bytes,
            port=port, host=host,
        )
        self._stopped = threading.Event()
        self._exit_reason = ""

    # ------------------------------------------------------------------
    def prepare(self) -> None:
        self._server.start()
        self.task_manager.start_timeout_recovery()
        if self.diagnosis_manager is not None:
            self.diagnosis_manager.start()
        self.tsdb_collector.start()
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
            self.tsdb_collector.stop()
            # the master's half of the postmortem: the goodput ledger, a
            # compact tsdb snapshot and the assembled step traces ride in
            # the dump, the same payloads the live RPCs serve
            recorder = obs.get_flight_recorder()
            self.goodput_ledger.record_flight_snapshot(
                reason="master-stop")
            try:
                recorder.record_event(
                    "tsdb", snapshot=self.tsdb_collector.flight_snapshot())
                recorder.record_event(
                    "steptrace", snapshot=self.steptrace.flight_snapshot())
            except Exception:  # noqa: BLE001 — the dump must land
                logger.exception("flight snapshot of the tsdb or "
                                 "steptrace failed")
            recorder.record_event("master_stop",
                                  exit_reason=self._exit_reason)
            recorder.dump(reason="master-stop")
            self._server.stop(grace_s)

    @property
    def addr(self) -> str:
        """Address agents should dial. A 0.0.0.0 bind is advertised as the
        host's own address so agents on other hosts don't dial their own
        loopback."""
        host = self._host
        if host in ("0.0.0.0", "::", ""):
            host = local_ip()
        return f"{host}:{self.port}"


def run_master_main(args=None) -> int:
    """CLI entry: ``python -m dlrover_tpu_torch.master.job_master``."""
    import argparse

    parser = argparse.ArgumentParser("dlrover-tpu-torch master")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--min-nodes", type=int, default=1)
    parser.add_argument("--max-nodes", type=int, default=1)
    parser.add_argument("--node-unit", type=int, default=1)
    ns = parser.parse_args(args)
    master = JobMaster(port=ns.port, min_nodes=ns.min_nodes,
                       max_nodes=ns.max_nodes, node_unit=ns.node_unit)
    master.prepare()
    print(f"DLROVER_TPU_MASTER_ADDR={master.addr}", flush=True)
    return master.run()


if __name__ == "__main__":
    raise SystemExit(run_master_main())
