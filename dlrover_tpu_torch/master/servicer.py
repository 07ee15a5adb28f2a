"""MasterServicer: dispatch the two-RPC protocol onto master components.

Own copy of the JAX package's ``master/servicer.py``, after
dlrover/python/master/servicer.py:62-581: one service with
``get(Message)`` and ``report(Message)``, dispatched on the payload's
dataclass type. Every decision lives in a component (rendezvous manager,
task manager, KV store, speed monitor, sync services); the servicer only
routes.

The optional components are fed as the JAX master feeds them:

- the goodput ledger (``obs/goodput.py``): step reports, the spans of
  telemetry reports, the drain protocol, hang and crash failure reports,
  and each newly cut training world;
- the diagnosis engine (``master/diagnosis/``): step-report HBM
  watermarks, ``NodeResourceStats``, worker exits and drain notices; its
  reports and per-rank actions are served over
  ``DiagnosisReportRequest`` and ``DiagnosisActionRequest``, and a drain
  notice fans an urgent ``checkpoint`` out to the survivors;
- the time-series store (``obs/tsdb.py``, built here when none is
  given): each step report's step time, MFU and HBM watermark per rank,
  served over ``TimeSeriesQuery``;
- the step-trace assembler (``master/steptrace.py``): the records of
  telemetry reports, served over ``StepTraceRequest``; ``ClockProbe``
  answers the master's wall clock for the workers' clock alignment;
- the re-planner (``master/rendezvous.py::compute_shard_plan``): fed the
  model profile from ``ModelInfo`` and the cards' memory total from
  ``NodeResourceStats``; every training join and ``ShardPlanRequest``
  stamps the plan of the forming world (the join result carries it as
  ``shard_plan_json``), and a real re-plan re-anchors the speed monitor
  and attributes the next re-formation to ``replan`` in the ledger
  (``_note_replan``);
- the job manager (``master/node/job_manager.py``, optional: a master
  built with ``job_args``): ``NodeResourceStats``, typed heartbeats,
  ``NodeFailureReport``, ``ScaleRequest`` and ``ModelInfo``; it answers
  ``JobStatusRequest`` with the job's stage. The metric collector
  (``master/stats/job_collector.py``) takes the resource stats and the
  model profile; the auto-scaler's tuned knobs reach the served
  ``ParallelConfig`` through ``merge_paral_config``;
- the planner's calibration (``parallel/calibration.py``, optional):
  each stamped plan's prediction and each step report's measurement,
  tagged with the plan generation the sender applied; served over
  ``PlanCalibrationRequest``, its learned discounts pushed back into
  the planner through ``push_axis_discounts``;
- the fleet controller (``brain/fleet_controller.py``, optional: a
  master with ``fleet_controller_enabled``): its status is served over
  ``AutoscaleStatusRequest`` ("" without one, as the JAX servicer
  answers); the step reports' allocator peaks reach the metric
  collector's runtime records (``observe_hbm_peak``).

Crash consistency, as in the JAX servicer: after any request that may
have mutated control-plane state the servicer calls ``state_sink``
(wired by ``JobMaster`` to its snapshot writer). Step reports,
heartbeats, telemetry and hot (``coord/``, ``dcn/``) kv keys do not
snapshot: they are the per-step paths. A ``ReconnectRequest`` from an
agent in master-lost mode puts its rank back in the alive set and
answers ``world_intact``; join and reconnect results carry the
coordination tier's address. A ``TelemetryReport`` is queued on the
bounded drop-oldest :class:`TelemetryIngestQueue` and replayed by one
drainer thread; ``master_chaos`` (a master-role ``ChaosInjector``) is
fed the step of every ``GlobalStepReport``.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, Dict, Optional

import grpc

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import (
    JobStage,
    NodeExitReason,
    RendezvousName,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch import obs
from dlrover_tpu_torch.master.coord_service import TelemetryIngestQueue
from dlrover_tpu_torch.master.diagnosis.manager import DiagnosisManager
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.rendezvous import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
    RendezvousManager,
)
from dlrover_tpu_torch.master.shard.task_manager import TaskManager
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.steptrace import StepTraceAssembler
from dlrover_tpu_torch.master.sync_service import ElasticPsService, SyncService
from dlrover_tpu_torch.parallel.calibration import PlanCalibration

# report() payloads that mutate snapshotted control-plane state (the
# early-return branches, join, reconnect, drain and kv add, sink inline).
# Step reports, heartbeats and telemetry are deliberately absent, and a
# KeyValuePair sinks inline only for a cold key.
_MUTATING_REPORTS = (
    msg.DatasetShardParams,
    msg.TaskResult,
    msg.LeaveRendezvousRequest,
    msg.NetworkStatusReport,
    msg.NodeFailureReport,
    msg.NodeAddressReport,   # writes node-addr/<rank> into the kv store
    msg.ShardCheckpoint,
    msg.ScaleRequest,
    msg.ModelInfo,
    msg.PeerStoreReport,     # the donor registry feeds restore plans
)


class MasterServicer:
    def __init__(
        self,
        task_manager: Optional[TaskManager] = None,
        rdzv_managers: Optional[Dict[str, RendezvousManager]] = None,
        kv_store: Optional[KVStoreService] = None,
        speed_monitor: Optional[SpeedMonitor] = None,
        sync_service: Optional[SyncService] = None,
        elastic_ps_service: Optional[ElasticPsService] = None,
        goodput_ledger: Optional[obs.GoodputLedger] = None,
        diagnosis_manager: Optional[DiagnosisManager] = None,
        tsdb: Optional[obs.TimeSeriesStore] = None,
        steptrace: Optional[StepTraceAssembler] = None,
        plan_calibration: Optional[PlanCalibration] = None,
        fleet_controller=None,
    ):
        self.task_manager = task_manager or TaskManager()
        self.rdzv_managers: Dict[str, RendezvousManager] = rdzv_managers or {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        self.kv_store = kv_store or KVStoreService()
        self.speed_monitor = speed_monitor or SpeedMonitor()
        self.sync_service = sync_service or SyncService()
        self.elastic_ps_service = elastic_ps_service or ElasticPsService()
        # the goodput ledger (obs/goodput.py), fed from step reports,
        # telemetry spans, and the drain and failure handlers
        self.goodput_ledger = goodput_ledger or obs.GoodputLedger()
        # the time-series store and the step-trace assembler, fed from
        # step and telemetry reports; the diagnosis engine is optional
        # (Context.diagnosis_enabled)
        self.tsdb = tsdb or obs.TimeSeriesStore()
        self.steptrace = steptrace or StepTraceAssembler(tsdb=self.tsdb)
        self.diagnosis_manager = diagnosis_manager
        # the node lifecycle owner and the stats sink: set by a JobMaster
        # built with job_args, else None
        self.job_manager = None
        self.metric_collector = None
        # the planner's calibration (parallel/calibration.py): stamped
        # plans register predictions, step reports measurements, and the
        # learned discounts push back into the planner
        self.plan_calibration = plan_calibration
        # the fleet controller (brain/fleet_controller.py), served over
        # AutoscaleStatusRequest; its loop runs on its own thread
        self.fleet_controller = fleet_controller
        self._pushed_discounts: Dict[str, float] = {}
        # the tuned config is read on RPC threads and replaced by reports
        self._paral_lock = threading.Lock()
        self._paral_config = msg.ParallelConfig()
        # crash-consistency hook (wired by JobMaster): called after any
        # request that may have mutated control-plane state
        self.state_sink: Optional[Callable[[], None]] = None
        # master generation token (bumped per restart over one state
        # lineage); 0 = no state backend, tokens disabled
        self.generation = 0
        # step-driven chaos for the master itself (kill:master:0@step),
        # wired by JobMaster and fed from GlobalStepReports
        self.master_chaos = None
        # the coordination tier's address ("" = not split out), carried
        # by join and reconnect results
        self.coord_addr = ""
        # telemetry rides a bounded drop-oldest queue: a span storm
        # degrades observability, never liveness
        self.telemetry_queue = TelemetryIngestQueue(
            self._process_telemetry,
            maxlen=Context.singleton().telemetry_queue_size)

    # ------------------------------------------------------------------
    # raw byte endpoints (wired into comm.build_server)
    # ------------------------------------------------------------------
    def get_bytes(self, payload: bytes,
                  context: Optional[grpc.ServicerContext] = None) -> bytes:
        try:
            request = msg.deserialize_message(payload)
            response = self.get(request)
        except Exception:
            logger.exception("get failed (payload %d bytes)", len(payload))
            response = msg.Response(success=False, reason="internal error")
        return msg.serialize_message(response)

    def report_bytes(self, payload: bytes,
                     context: Optional[grpc.ServicerContext] = None) -> bytes:
        try:
            request = msg.deserialize_message(payload)
            response = self.report(request)
        except Exception:
            logger.exception("report failed (payload %d bytes)", len(payload))
            response = msg.Response(success=False, reason="internal error")
        return msg.serialize_message(response)

    # ------------------------------------------------------------------
    # typed dispatch
    # ------------------------------------------------------------------
    def get(self, request: msg.Message) -> msg.Message:
        if isinstance(request, msg.TaskRequest):
            # the counter, not the task, gates the snapshot: a final-epoch
            # splitter flip mutates state yet answers WAIT/NONE
            before = self.task_manager.mutation_count
            task = self.task_manager.get_dataset_task(
                request.worker_id, request.dataset_name)
            if self.task_manager.mutation_count != before:
                self._sink_state()
            return task
        if isinstance(request, msg.CommWorldRequest):
            mgr = self.rdzv_managers[request.rdzv_name]
            # only a poll that cut a round pays for a snapshot
            before = mgr.mutation_count
            rdzv_round, group, world = mgr.get_comm_world(request.node_id)
            if mgr.mutation_count != before:
                self._sink_state()
            if world and request.rdzv_name == RendezvousName.TRAINING:
                # a cut training world: the ledger opens an incarnation
                # per new round (idempotent for repeat polls)
                self.goodput_ledger.observe_world(rdzv_round, len(world))
            return msg.CommWorld(rdzv_name=request.rdzv_name,
                                 round=rdzv_round, group=group, world=world)
        if isinstance(request, msg.WaitingNodeNumRequest):
            mgr = self.rdzv_managers[request.rdzv_name]
            # the steady-state poll every live agent makes: liveness
            # touch + dead-member reaping ride on it
            mgr.touch(request.node_id)
            before = mgr.mutation_count
            mgr.reap_dead_nodes(Context.singleton().dead_node_timeout_s)
            if mgr.mutation_count != before:
                self._sink_state()   # a dead member was reaped
                self._evict_departed(mgr)
            return msg.WaitingNodeNum(
                waiting_num=mgr.num_nodes_waiting(request.node_id))
        if isinstance(request, msg.DiagnosisActionRequest):
            actions = []
            if self.diagnosis_manager is not None:
                actions = self.diagnosis_manager.poll_actions(
                    request.node_rank if request.node_rank >= 0
                    else request.node_id)
            return msg.DiagnosisActions(
                actions_json=DiagnosisManager.actions_to_json(actions))
        if isinstance(request, msg.DiagnosisReportRequest):
            reports = []
            if self.diagnosis_manager is not None:
                reports = self.diagnosis_manager.reports(request.limit)
            return msg.DiagnosisReports(
                reports_json=DiagnosisManager.reports_to_json(reports))
        if isinstance(request, msg.GoodputRequest):
            return msg.GoodputReport(report_json=json.dumps(
                self.goodput_ledger.snapshot(window_s=request.window_s)))
        if isinstance(request, msg.AutoscaleStatusRequest):
            if self.fleet_controller is None:
                return msg.AutoscaleStatus(status_json="")
            return msg.AutoscaleStatus(status_json=json.dumps(
                self.fleet_controller.status()))
        if isinstance(request, msg.TimeSeriesQuery):
            return msg.TimeSeriesResult(result_json=json.dumps(
                self.tsdb.query_payload(
                    name=request.name,
                    labels=dict(request.labels) or None,
                    window_s=request.window_s,
                    resolution_s=request.resolution_s)))
        if isinstance(request, msg.ClockProbe):
            # answered inline, no locks, no state: the round trip the
            # client measures around this is its uncertainty bound
            return msg.ClockProbeResult(server_ts=time.time())
        if isinstance(request, msg.StepTraceRequest):
            return msg.StepTraceResult(result_json=json.dumps(
                self.steptrace.query_payload(
                    start_step=request.start_step,
                    end_step=request.end_step,
                    last_n=request.last_n)))
        if isinstance(request, msg.KVGetRequest):
            return msg.KeyValuePair(key=request.key,
                                    value=self.kv_store.get(request.key))
        if isinstance(request, msg.KVWaitRequest):
            # cap the blocking window well below typical RPC deadlines so
            # the client always receives a response
            ok = self.kv_store.wait(request.keys,
                                    min(request.timeout_s, 20.0))
            return msg.Response(success=ok)
        if isinstance(request, msg.NetworkCheckResultRequest):
            mgr = self.rdzv_managers[RendezvousName.NETWORK_CHECK]
            fault, _ = mgr.check_fault_node()
            stragglers = mgr.detect_stragglers()
            is_fault = request.node_id in fault
            is_straggler = request.node_id in stragglers
            return msg.NetworkCheckVerdict(
                normal=not is_fault,
                is_straggler=is_straggler,
                reason="fault" if is_fault else
                       ("straggler" if is_straggler else ""),
            )
        if isinstance(request, msg.ShardCheckpointRequest):
            ckpt = self.task_manager.checkpoint_dataset(request.dataset_name)
            return msg.ShardCheckpoint(
                dataset_name=request.dataset_name,
                content=ckpt.to_json() if ckpt else "",
            )
        if isinstance(request, msg.DatasetEpochInfo):
            return msg.DatasetEpochInfo(
                dataset_name=request.dataset_name,
                epoch=self.task_manager.get_epoch(request.dataset_name),
            )
        if isinstance(request, msg.TaskCounts):
            todo, doing = self.task_manager.counts(request.dataset_name)
            return msg.TaskCounts(dataset_name=request.dataset_name,
                                  todo=todo, doing=doing)
        if isinstance(request, msg.ParallelConfigRequest):
            with self._paral_lock:
                return self._paral_config
        if isinstance(request, msg.SyncQueryRequest):
            finished = self.sync_service.sync_finished(request.sync_name)
            return msg.Response(success=finished)
        if isinstance(request, msg.ClusterVersionRequest):
            version = self.elastic_ps_service.get_cluster_version(
                request.version_type, request.task_type, request.task_id
            )
            return msg.ClusterVersion(version=version)
        if isinstance(request, msg.RestorePlanRequest):
            mgr = self.rdzv_managers.get(
                request.rdzv_name or RendezvousName.TRAINING)
            if mgr is None:
                return msg.RestorePlan()
            if request.epoch_only:
                # the staleness guard's commit-time check: the current
                # world epoch alone, no plan computed
                return msg.RestorePlan(epoch=mgr.world_epoch)
            plan = mgr.compute_restore_plan(request.node_rank,
                                            stripe=bool(request.stripe))
            return msg.RestorePlan(
                plan_json=json.dumps(plan),
                epoch=int(plan.get("epoch", 0)),
                step=int(plan.get("step", -1)),
                found=bool(plan.get("entries")))
        if isinstance(request, msg.ShardPlanRequest):
            mgr = self.rdzv_managers.get(
                request.rdzv_name or RendezvousName.TRAINING)
            if mgr is None:
                return msg.ShardPlanResult()
            before = mgr.mutation_count
            plan, changed = mgr.compute_shard_plan(request.node_rank)
            if changed:
                self._note_replan(plan)
            self._observe_plan(plan)
            if mgr.mutation_count != before:
                self._sink_state()   # a new plan was stamped
            return msg.ShardPlanResult(
                plan_json=json.dumps(plan),
                epoch=int(plan.get("epoch", 0)),
                generation=int(plan.get("generation", 0)),
                found=bool(plan.get("mesh")))
        if isinstance(request, msg.SliceStatusRequest):
            mgr = self.rdzv_managers.get(
                request.rdzv_name or RendezvousName.TRAINING)
            if mgr is None:
                return msg.SliceStatus(status_json="")
            status = mgr.slice_status()
            # the re-formed slice's catch-up target (dcn_sync.catch_up)
            status["fleet_step"] = (
                self.speed_monitor.completed_global_step)
            return msg.SliceStatus(status_json=json.dumps(status))
        if isinstance(request, msg.PlanCalibrationRequest):
            if self.plan_calibration is None:
                return msg.PlanCalibrationReport(report_json="")
            return msg.PlanCalibrationReport(report_json=json.dumps({
                "table": self.plan_calibration.table(),
                "discounts": self.plan_calibration.axis_discounts(),
                "min_samples": self.plan_calibration.min_samples,
            }))
        if isinstance(request, msg.JobStatusRequest):
            return self._get_job_status()
        logger.warning("get: unknown request %s", type(request).__name__)
        return msg.Response(success=False, reason="unknown request")

    def report(self, request: msg.Message) -> msg.Message:
        ok = True
        reason = ""
        if isinstance(request, msg.DatasetShardParams):
            self.task_manager.new_dataset(request)
        elif isinstance(request, msg.TaskResult):
            if not request.success and request.err_message:
                logger.warning("task %d of %s failed on worker %d: %s",
                               request.task_id, request.dataset_name,
                               request.worker_id,
                               request.err_message[:256])
            ok = self.task_manager.report_dataset_task(
                request.dataset_name, request.task_id, request.success
            )
        elif isinstance(request, msg.JoinRendezvousRequest):
            mgr = self.rdzv_managers[request.rdzv_name]
            # parent under the agent's span so agent rendezvous → master
            # join share a trace
            with obs.span("rendezvous_join",
                          {"rank": request.node_rank,
                           "rdzv": request.rdzv_name,
                           "slice": request.slice_id},
                          parent=request.trace or None):
                rdzv_round = mgr.join_rendezvous(
                    request.node_rank, request.local_world_size,
                    request.node_ip, request.slice_id)
            if (request.slice_id >= 0
                    and request.rdzv_name == RendezvousName.TRAINING):
                # keep every slice-labeled consumer's rank → slice view
                # current (per-worker gauges, goodput states, per-slice
                # speed)
                self._push_slice_map(mgr)
            self._sink_state()
            plan_json = ""
            shard_plan_json = ""
            if request.rdzv_name == RendezvousName.TRAINING:
                # the restore plan rides the join result: which donor
                # serves each staged shard this rank may need. A donor
                # registering later is picked up by the worker's own
                # RestorePlanRequest.
                plan = mgr.compute_restore_plan(request.node_rank)
                if plan.get("entries"):
                    plan_json = json.dumps(plan)
                # the parallelism plan of the world this join forms: the
                # same deterministic shape for every rank of it, so a
                # resize resolves in one rendezvous round
                try:
                    before = mgr.mutation_count
                    shard_plan, changed = mgr.compute_shard_plan(
                        request.node_rank)
                    shard_plan_json = json.dumps(shard_plan)
                    if changed:
                        self._note_replan(shard_plan)
                    self._observe_plan(shard_plan)
                    if mgr.mutation_count != before:
                        self._sink_state()   # the stamped plan is state
                except Exception:  # noqa: BLE001 — the planner never
                    # fails a join; workers fall back to their configured
                    # shape (a loud replan_fallback on their side)
                    logger.exception("shard-plan computation failed "
                                     "for rank %d", request.node_rank)
            return msg.JoinRendezvousResult(
                round=rdzv_round, generation=self.generation,
                restore_plan_json=plan_json,
                shard_plan_json=shard_plan_json,
                coord_addr=self.coord_addr)
        elif isinstance(request, msg.ReconnectRequest):
            return self._handle_reconnect(request)
        elif isinstance(request, msg.LeaveRendezvousRequest):
            mgr = self.rdzv_managers[request.rdzv_name]
            mgr.leave_waiting(request.node_rank)
        elif isinstance(request, msg.NetworkStatusReport):
            mgr = self.rdzv_managers[RendezvousName.NETWORK_CHECK]
            mgr.report_network_status(request.node_id, request.normal,
                                      request.elapsed_time)
        elif isinstance(request, msg.KeyValuePair):
            self.kv_store.set(request.key, request.value)
            if not self.kv_store.is_hot(request.key):
                # cold keys keep write-through durability; hot ones
                # ride the mutation log instead
                self._sink_state()
        elif isinstance(request, msg.KVAddRequest):
            value = self.kv_store.add(request.key, request.amount)
            if not self.kv_store.is_hot(request.key):
                self._sink_state()
            return msg.KVIntResult(value=value)
        elif isinstance(request, msg.GlobalStepReport):
            # keyed by RANK when the sender provides one (node_id
            # diverges from rank after a relaunch)
            rank = (request.node_rank if request.node_rank >= 0
                    else request.node_id)
            self.speed_monitor.collect_worker_step(
                rank,
                request.step,
                step_time_s=request.step_time_s,
                data_wait_fraction=request.data_wait_fraction,
                mfu=request.mfu)
            self.goodput_ledger.observe_step_report(
                rank, request.step,
                step_time_s=request.step_time_s,
                data_wait_fraction=request.data_wait_fraction,
                mfu=request.mfu)
            if request.degraded_steps > 0:
                self._observe_degraded_steps(rank, request.degraded_steps)
            self._observe_step_evidence(rank, request)
            self._touch_rendezvous(request.node_rank)
            # deliberately NOT a snapshot trigger (the per-step path);
            # the step high-water mark rides on the next mutation's
            # snapshot
            if self.master_chaos is not None:
                self.master_chaos.maybe_inject(request.step)
        elif isinstance(request, msg.NodeResourceStats):
            if self.job_manager is not None:
                self.job_manager.update_node_resource_usage(request)
            if self.metric_collector is not None:
                self.metric_collector.collect_node_stats(request)
            if self.diagnosis_manager is not None:
                self.diagnosis_manager.observe_resource_stats(request)
            # the cards' memory total bounds the planner's memory fit
            hbm_mb = max((c.hbm_total_mb for c in request.chip_stats),
                         default=0.0)
            if hbm_mb > 0:
                training = self.rdzv_managers.get(
                    RendezvousName.TRAINING)
                if training is not None:
                    training.set_chip_hbm(int(hbm_mb * (1 << 20)))
            # the agent's payload made scrapeable on the master
            obs.publish_node_stats(request)
        elif isinstance(request, msg.NodeHeartbeat):
            if self.job_manager is not None:
                self.job_manager.collect_heartbeat(
                    request.node_id, request.timestamp,
                    node_type=request.node_type)
            self._touch_rendezvous(request.node_rank)
        elif isinstance(request, msg.NodeFailureReport):
            logger.warning("node %d failure (level=%s, kind=%s): %s",
                           request.node_id, request.level,
                           request.exit_kind or "-",
                           request.error_data[:512])
            if self.job_manager is not None:
                self.job_manager.handle_failure_report(request)
            self.task_manager.recover_tasks(request.node_id)
            failed_rank = (request.node_rank if request.node_rank >= 0
                           else request.node_id)
            if self.diagnosis_manager is not None and request.exit_kind:
                # hang vs crash vs drain lands in the report history
                self.diagnosis_manager.observe_worker_exit(
                    failed_rank, request.exit_kind,
                    detail=request.error_data[:128])
            if request.exit_kind == NodeExitReason.HANG:
                self.goodput_ledger.observe_hang(
                    failed_rank, Context.singleton().hang_watchdog_s)
            elif request.exit_kind != NodeExitReason.DRAINED:
                self.goodput_ledger.note_elasticity_event("worker_lost")
        elif isinstance(request, msg.DrainReport):
            return self._handle_drain(request)
        elif isinstance(request, msg.TelemetryReport):
            # the RPC returns after one append, however large the span
            # replay backlog is
            self.telemetry_queue.push(request)
        elif isinstance(request, msg.PeerStoreReport):
            mgr = self.rdzv_managers.get(
                request.rdzv_name or RendezvousName.TRAINING)
            if mgr is not None:
                mgr.register_peer_store(
                    request.node_rank, request.addr, request.step,
                    request.keys, request.total_bytes,
                    slice_id=request.slice_id)
        elif isinstance(request, msg.NodeAddressReport):
            self.kv_store.set(f"node-addr/{request.node_rank}",
                              request.addr.encode())
        elif isinstance(request, msg.ShardCheckpoint):
            ok = self.task_manager.restore_dataset_checkpoint(request.content)
        elif isinstance(request, msg.SyncJoinRequest):
            ok = self.sync_service.join_sync(request.sync_name,
                                             request.node_id)
        elif isinstance(request, msg.SyncFinishRequest):
            ok = self.sync_service.finish_sync(request.sync_name)
        elif isinstance(request, msg.ClusterVersionRequest):
            self.elastic_ps_service.update_cluster_version(
                request.version_type, request.version,
                request.task_type, request.task_id,
            )
        elif isinstance(request, msg.ParallelConfig):
            with self._paral_lock:
                self._paral_config = request
        elif isinstance(request, msg.ScaleRequest):
            if self.job_manager is not None:
                self.job_manager.handle_scale_request(request)
            else:
                ok, reason = False, "no job manager"
        elif isinstance(request, msg.ModelInfo):
            logger.info(
                "model info: %.3gB params, flops/token=%.3g (%s), "
                "batch=%d seq=%d chips=%d",
                request.param_count / 1e9, request.flops_per_token,
                request.flops_source or "analytic",
                request.batch_size, request.seq_len, request.chips)
            if self.job_manager is not None:
                self.job_manager.collect_model_info(request)
            if self.metric_collector is not None:
                self.metric_collector.collect_model_info(request)
            # tokens/s = steps/s × tokens per step (the EFFECTIVE batch)
            effective = (request.effective_global_batch
                         or request.batch_size)
            self.speed_monitor.set_tokens_per_step(
                effective * request.seq_len,
                seq_len=request.seq_len)
            # MFU = tokens/s × FLOPs/token / aggregate peak; the per-card
            # peak is kept so a re-plan can re-anchor the denominator
            self.speed_monitor.set_model_flops(
                request.flops_per_token,
                request.peak_flops_per_chip * max(1, request.chips),
                peak_flops_per_chip=request.peak_flops_per_chip)
            # the planner's model profile (parallel/planner.py)
            training = self.rdzv_managers.get(RendezvousName.TRAINING)
            if training is not None:
                training.set_model_profile(
                    param_count=request.param_count,
                    param_bytes=request.param_bytes,
                    flops_per_token=request.flops_per_token,
                    peak_flops_per_chip=request.peak_flops_per_chip,
                    seq_len=request.seq_len,
                    global_batch=request.batch_size,
                    tensor_divisor=request.tensor_divisor,
                    fsdp_divisor=request.fsdp_divisor)
        else:
            logger.warning("report: unknown request %s",
                           type(request).__name__)
            ok, reason = False, "unknown request"
        if isinstance(request, _MUTATING_REPORTS):
            self._sink_state()
        return msg.Response(success=ok, reason=reason)

    # ------------------------------------------------------------------
    def _handle_reconnect(self, request: msg.ReconnectRequest
                          ) -> msg.ReconnectResult:
        """An agent lost us (or our predecessor) and is re-registering.
        Its rank re-enters the alive set either way; ``world_intact``
        tells it whether the worker it kept running still forms the
        master's latest world at the round it reported, or whether it
        must re-join rendezvous."""
        name = request.rdzv_name or RendezvousName.TRAINING
        mgr = self.rdzv_managers.get(name)
        if mgr is None:
            return msg.ReconnectResult(generation=self.generation)
        if request.slice_id >= 0:
            mgr.record_slice(request.node_rank, request.slice_id)
        mgr.add_alive_node(request.node_rank)
        # in slice mode, intact means the rank's slice world still holds
        # it at the round it reported; a peer slice having moved on does
        # not matter to this agent
        world = mgr.world_for(request.node_rank)
        latest_round = mgr.round_for(request.node_rank)
        intact = (bool(world) and request.node_rank in world
                  and request.rdzv_round == latest_round)
        restarted = (self.generation != 0
                     and request.generation != self.generation)
        logger.info(
            "agent %d reconnected (rank %d, saw generation %d, ours %d, "
            "round %d): %s", request.node_id, request.node_rank,
            request.generation, self.generation, request.rdzv_round,
            "world intact" if intact else "must re-join rendezvous")
        obs.get_flight_recorder().record_event(
            "agent_reconnect", node=request.node_id,
            rank=request.node_rank, world_intact=intact,
            master_restarted=restarted)
        obs.get_registry().counter(
            "dlrover_tpu_agent_reconnects_total",
            "Agents that re-registered after a master-lost episode",
            labelnames=("world_intact",),
        ).labels(world_intact=str(intact).lower()).inc()
        self._sink_state()
        return msg.ReconnectResult(generation=self.generation,
                                   world_intact=intact,
                                   round=latest_round,
                                   coord_addr=self.coord_addr)

    # ------------------------------------------------------------------
    def _handle_drain(self, request: msg.DrainReport) -> msg.DrainResult:
        """The advance-notice drain protocol. phase="notice": mark the
        rank DRAINING in every rendezvous and plan the post-departure
        world. phase="complete": remove the rank now, so survivors
        re-form in one round instead of waiting out the liveness
        timeout. With a diagnosis manager, the notice fans an urgent
        ``checkpoint`` action out to the SURVIVORS (the draining agent
        checkpoints its own worker locally), returned as
        ``checkpoint_ranks``. In slice mode a notice for any rank of a
        slice drains the slice as a unit: its peers get save-and-exit
        ``drain`` actions, the ranks outside it the checkpoint."""
        rank = (request.node_rank if request.node_rank >= 0
                else request.node_id)
        checkpoint_ranks = []
        if request.phase == "complete":
            announced = False
            # notice → departure is drain badput; the rank's lifetime
            # in the ledger ends here
            self.goodput_ledger.complete_drain(rank)
            for mgr in self.rdzv_managers.values():
                announced = mgr.complete_drain(rank) or announced
                self._evict_departed(mgr)
            logger.info("node %d drain COMPLETE (announced=%s): "
                        "survivors re-form now", rank, announced)
        else:
            training = self.rdzv_managers.get(RendezvousName.TRAINING)
            sid = training.slice_of(rank) if training is not None else -1
            slice_peers = []
            if sid >= 0:
                slice_peers = [r for r in training.slice_members(sid)
                               if r != rank]
            draining_unit = [rank] + slice_peers
            for member in draining_unit:
                self.goodput_ledger.mark_draining(member, request.deadline)
            planned = {}
            for name, mgr in self.rdzv_managers.items():
                unit = (draining_unit
                        if name == RendezvousName.TRAINING else [rank])
                for member in unit:
                    world = mgr.mark_draining(member, request.deadline)
                if name == RendezvousName.TRAINING:
                    planned = world
            # the checkpoint goes to the fleet's survivors: in slice mode
            # the planned world above is the victim slice's (now empty),
            # so the survivors are every alive rank outside the unit
            if sid >= 0:
                survivors = sorted(training.alive_nodes
                                   - set(draining_unit))
            else:
                survivors = sorted(r for r in planned
                                   if r not in draining_unit)
            drain_ranks: list = []
            if self.diagnosis_manager is not None:
                self.diagnosis_manager.observe_drain_notice(
                    rank, request.deadline, request.reason, slice_id=sid)
                if slice_peers:
                    drain_ranks = self.diagnosis_manager.request_drain(
                        slice_peers, request.deadline,
                        reason=f"slice {sid} draining (notice on rank "
                               f"{rank}): {request.reason}")
                checkpoint_ranks = (
                    self.diagnosis_manager.request_checkpoint(
                        survivors, request.deadline,
                        reason=f"peer rank {rank} draining: "
                               f"{request.reason}"))
            obs.get_flight_recorder().record_event(
                "node_draining", rank=rank, deadline=request.deadline,
                reason=request.reason[:256], slice=sid,
                planned_world=sorted(planned), drain_ranks=drain_ranks,
                checkpoint_ranks=checkpoint_ranks)
        obs.get_registry().counter(
            "dlrover_tpu_drains_total",
            "Drain protocol messages by phase",
            labelnames=("phase",)).labels(phase=request.phase).inc()
        self._sink_state()
        return msg.DrainResult(success=True,
                               checkpoint_ranks=checkpoint_ranks)

    def _observe_step_evidence(self, rank: int,
                               request: msg.GlobalStepReport) -> None:
        """The per-rank evidence of one step report (the hot path:
        appends only). The device-truth HBM watermark lands in the
        diagnosis node stats (HbmPressureRule's preferred signal) and
        the time-series store, beside the step time and MFU. The fleet
        step is not ingested per rank: the collector samples the
        SpeedMonitor's gauge into that series."""
        hbm_peak = float(request.hbm_peak_bytes or 0.0)
        peak_mb = hbm_peak / (1 << 20) if hbm_peak > 0 else -1.0
        if peak_mb >= 0.0 and self.diagnosis_manager is not None:
            self.diagnosis_manager.observe_step_watermark(rank, peak_mb)
        if peak_mb >= 0.0 and self.metric_collector is not None:
            self.metric_collector.observe_hbm_peak(rank, peak_mb)
        node = {"node": str(rank)}
        if request.step_time_s > 0:
            self.tsdb.ingest("dlrover_tpu_worker_step_time_seconds",
                             request.step_time_s, node)
        if request.mfu >= 0:
            self.tsdb.ingest("dlrover_tpu_worker_mfu", request.mfu, node)
        if peak_mb >= 0.0:
            self.tsdb.ingest("dlrover_tpu_worker_hbm_peak_mb", peak_mb,
                             node)
        if self.plan_calibration is not None \
                and request.step_time_s > 0:
            # appends only: the learned discounts are recomputed on the
            # diagnosis loop's cadence (DiagnosisManager.discount_sink)
            self.plan_calibration.observe_step(
                request.step_time_s, mfu=request.mfu,
                plan_generation=int(request.plan_generation))

    def push_axis_discounts(self, discounts: Dict[str, float]) -> None:
        """Feed learned calibration discounts into planner scoring,
        deduplicated on change (also the restore path's push)."""
        if discounts == self._pushed_discounts:
            return
        self._pushed_discounts = discounts
        training = self.rdzv_managers.get(RendezvousName.TRAINING)
        if training is not None:
            training.set_axis_discounts(discounts)

    def _note_replan(self, plan: Dict) -> None:
        """A REAL re-plan was stamped (the execution shape changed):
        the goodput ledger attributes the next world re-formation to
        it, and the speed monitor re-anchors its denominators to the
        new card count and the planned batch."""
        self.goodput_ledger.note_elasticity_event("replan")
        tokens_per_step = (int(plan.get("global_batch", 0) or 0)
                           * int(self.speed_monitor.seq_len_hint or 0))
        self.speed_monitor.reanchor_plan(
            chips=int(plan.get("total_devices", 0) or 0),
            tokens_per_step=tokens_per_step)
        obs.get_registry().counter(
            "dlrover_tpu_replans_total",
            "Parallelism re-plans stamped (the execution shape "
            "changed at a resize)").inc()

    def _observe_plan(self, plan: Dict) -> None:
        """Register a stamped plan's prediction with the calibration
        table (idempotent per signature)."""
        if self.plan_calibration is None:
            return
        try:
            self.plan_calibration.observe_plan(plan)
        except Exception:  # noqa: BLE001 — calibration is advisory
            logger.exception("plan calibration observe failed")

    def _sink_state(self) -> None:
        """Post-mutation crash-consistency hook; a snapshot failure
        never fails the RPC that triggered it."""
        sink = self.state_sink
        if sink is None:
            return
        try:
            sink()
        except Exception:  # noqa: BLE001 — durability is best-effort
            logger.exception("control-plane state snapshot failed")

    def _process_telemetry(self, report: msg.TelemetryReport) -> None:
        """Replay a node's metric samples on the master's registry, feed
        its spans into the master's flight recorder, the span histogram
        and the goodput ledger, and its step-trace records into the
        assembler (on the ingest queue's drainer thread)."""
        registry = obs.get_registry()
        for sample in report.samples:
            if not sample.name:
                continue
            labels = dict(sample.labels)
            labels.setdefault("node", str(report.node_id))
            try:
                names = tuple(sorted(labels))
                if sample.kind == "counter":
                    registry.counter(sample.name, labelnames=names).labels(
                        **labels).inc(sample.value)
                elif sample.kind == "histogram":
                    registry.histogram(sample.name,
                                       labelnames=names).labels(
                        **labels).observe(sample.value)
                else:
                    registry.gauge(sample.name, labelnames=names).labels(
                        **labels).set(sample.value)
            except (TypeError, ValueError) as e:
                logger.warning("telemetry sample %s dropped: %s",
                               sample.name, e)
        if report.spans_json:
            try:
                spans = json.loads(report.spans_json)
            except json.JSONDecodeError:
                logger.warning("telemetry spans from node %d undecodable",
                               report.node_id)
                spans = None
            if isinstance(spans, list):
                obs.record_remote_spans(spans, registry)
                for record in spans:
                    if isinstance(record, dict):
                        self.goodput_ledger.observe_span(
                            record, rank=report.node_rank)
        if report.steptrace_json:
            try:
                records = json.loads(report.steptrace_json)
            except json.JSONDecodeError:
                logger.warning("steptrace batch from node %d undecodable",
                               report.node_id)
                return
            if isinstance(records, list):
                self.steptrace.ingest(records, node_rank=report.node_rank)

    def _push_slice_map(self, mgr) -> None:
        """Fan the rank → slice view out to every slice-labeled consumer."""
        slice_map = mgr.slice_map
        if not slice_map:
            return
        self.speed_monitor.set_slice_map(slice_map)
        if self.diagnosis_manager is not None:
            self.diagnosis_manager.set_slice_map(slice_map)
        self.goodput_ledger.set_slice_map(slice_map)

    def _observe_degraded_steps(self, rank: int, count: int) -> None:
        """A slice's degraded steps (its gradient mean renormalized while
        a peer slice was absent): the master's counter, labeled by the
        reporting slice, and the goodput ledger's tally a rank."""
        mgr = self.rdzv_managers.get(RendezvousName.TRAINING)
        sid = mgr.slice_of(rank) if mgr is not None else -1
        obs.get_registry().counter(
            "dlrover_tpu_slice_degraded_steps_total",
            "Steps a slice took with the gradient mean renormalized "
            "over present slices (a peer slice was absent)",
            labelnames=("slice",)).labels(slice=str(sid)).inc(count)
        self.goodput_ledger.observe_degraded_steps(rank, count)

    def _evict_departed(self, mgr) -> None:
        """After a membership mutation: the departed ranks' speed
        evidence, queued actions, goodput lifetimes and step traces go
        with them."""
        live = mgr.alive_nodes
        self.speed_monitor.evict_departed(live)
        if self.diagnosis_manager is not None:
            self.diagnosis_manager.evict_workers(live)
        self.goodput_ledger.evict(live)
        self.steptrace.evict_departed(live)

    def _touch_rendezvous(self, node_rank: int) -> None:
        """Heartbeats and step reports carry the sender's RANK, so they
        count as liveness too. touch() ignores rank < 0."""
        for mgr in self.rdzv_managers.values():
            mgr.touch(node_rank)

    def _get_job_status(self) -> msg.JobStatus:
        if self.job_manager is not None:
            return msg.JobStatus(stage=self.job_manager.job_stage())
        stage = (JobStage.SUCCEEDED if self.task_manager.finished()
                 else JobStage.RUNNING)
        return msg.JobStatus(stage=stage)

    def update_paral_config(self, config: msg.ParallelConfig) -> None:
        with self._paral_lock:
            self._paral_config = config

    def merge_paral_config(self, **fields) -> msg.ParallelConfig:
        """Merge tuned knobs into the current config and bump its version
        (a partial update must not clobber other tuned fields or publish
        a stale version). The auto-scaler merges on its own thread while
        RPC threads replace the config, so the read-modify-write holds
        ``_paral_lock``. Falsy fields are left as they were."""
        with self._paral_lock:
            current = self._paral_config
            merged = dataclasses.replace(
                current, version=current.version + 1,
                **{k: v for k, v in fields.items() if v})
            self._paral_config = merged
        return merged
