"""Job manager: node lifecycle, relaunch decisions, job stage.

Own copy of the JAX package's ``master/node/job_manager.py``, after
DistributedJobManager (dlrover/python/master/node/dist_job_manager.py:
87-737): initializes the node set from JobArgs, issues the initial
ScalePlan, consumes watcher events through the node state machine
(common/node.py NODE_STATE_FLOWS), decides relaunches by exit reason
(:400-544: FATAL never; OOM with more memory; budget-capped otherwise),
fails the job when a critical node is unrecoverable, and detects hang
from heartbeats. Its ``export_state`` is the ``job_manager`` key of the
master's snapshot, the same JSON as the JAX job manager's.

``create_job_manager`` wires the local platform's scaler and watcher,
the Kubernetes pod scaler and watcher, or the Ray actor scaler and
watcher, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import (
    JobStage,
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
    PlatformType,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.node import (
    Node,
    NodeGroupResource,
    get_node_state_flow,
)
from dlrover_tpu_torch.master.node.event_callback import NodeEventCallback
from dlrover_tpu_torch.master.scaler.base import ScalePlan, Scaler
from dlrover_tpu_torch.master.watcher.base import NodeEvent, NodeWatcher
from dlrover_tpu_torch.scheduler.job import JobArgs

# Memory bump applied when relaunching an OOM-killed node (the local analog
# of the brain's optimize_job_worker_create_oom_resource algorithm).
_OOM_MEMORY_FACTOR = 1.5


class JobManager:
    def __init__(
        self,
        job_args: JobArgs,
        scaler: Scaler,
        watcher: NodeWatcher,
        speed_monitor=None,
    ):
        self._job_args = job_args
        self._scaler = scaler
        self._watcher = watcher
        self._speed_monitor = speed_monitor
        self._nodes: Dict[str, Dict[int, Node]] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._stage = JobStage.CREATED
        self._exit_reason = ""
        self._event_callbacks: List[NodeEventCallback] = []
        self._threads: List[threading.Thread] = []
        self._relaunch_always = job_args.relaunch_always
        self._model_info: Optional[msg.ModelInfo] = None
        self._paral_config: Optional[msg.ParallelConfig] = None

    # -- setup ---------------------------------------------------------
    def add_event_callback(self, callback: NodeEventCallback) -> None:
        self._event_callbacks.append(callback)

    def _init_nodes(self) -> None:
        """Materialize the Node table from JobArgs (reference:
        _init_nodes, dist_job_manager.py:262-292). Node groups already
        populated by a state-backend restore keep their restored table —
        re-materializing would zero every relaunch budget."""
        with self._lock:
            for node_type, args in self._job_args.node_args.items():
                if self._nodes.get(node_type):
                    continue
                group = args.group_resource
                self._nodes[node_type] = {}
                for node_id in range(group.count):
                    node = Node(
                        node_type,
                        node_id,
                        rank_index=node_id,
                        config_resource=group.node_resource,
                        critical=args.critical,
                        max_relaunch_count=args.restart_count,
                    )
                    node.create_time = time.time()
                    self._nodes[node_type][node_id] = node

    def _initial_scale_plan(self) -> ScalePlan:
        plan = ScalePlan()
        for node_type, args in self._job_args.node_args.items():
            plan.node_group_resources[node_type] = NodeGroupResource(
                count=args.group_resource.count,
                node_resource=args.group_resource.node_resource,
            )
        return plan

    def start(self) -> None:
        # _stage is read by servicer threads and written by the monitor
        # thread: every access holds the lock
        with self._lock:
            self._stage = JobStage.RUNNING
        self._init_nodes()
        self._watcher.prime()
        self._scaler.start()
        self._scaler.scale(self._initial_scale_plan())
        monitor = threading.Thread(target=self._monitor_nodes, daemon=True,
                                   name="node-monitor")
        monitor.start()
        self._threads.append(monitor)

    def stop(self) -> None:
        self._stopped.set()
        self._watcher.stop()
        self._scaler.stop()

    # -- monitoring ----------------------------------------------------
    def _monitor_nodes(self) -> None:
        while not self._stopped.is_set():
            try:
                for event in self._watcher.watch():
                    if self._stopped.is_set():
                        return
                    self._process_event(event)
            except Exception as e:  # noqa: BLE001 - monitor must survive
                logger.warning("node monitor error: %s; relisting", e)
                for node in self._watcher.list():
                    self._process_event(
                        NodeEvent(NodeEventType.MODIFIED, node))
                time.sleep(1.0)

    def _process_event(self, event: NodeEvent) -> None:
        reported = event.node
        with self._lock:
            by_id = self._nodes.setdefault(reported.type, {})
            node = by_id.get(reported.id)
            if node is None:
                # a node we didn't launch (e.g. after master restart):
                # adopt it
                node = reported
                by_id[reported.id] = node
        flow = get_node_state_flow(node.status, event.event_type,
                                   reported.status)
        if flow is None:
            return
        node.exit_reason = reported.exit_reason or node.exit_reason
        if reported.host_addr:
            node.host_addr = reported.host_addr
        node.update_status(flow.to_status)
        logger.info("node %s: %s -> %s (%s)", node.name, flow.from_status,
                    flow.to_status, node.exit_reason or "-")
        self._fire_callbacks(node, flow.to_status)
        if flow.should_relaunch and self._should_relaunch(node):
            self._relaunch_node(node)
        self._update_job_stage()

    def _fire_callbacks(self, node: Node, status: str) -> None:
        for cb in self._event_callbacks:
            try:
                if status == NodeStatus.RUNNING:
                    cb.on_node_started(node)
                elif status == NodeStatus.SUCCEEDED:
                    cb.on_node_succeeded(node)
                elif status in (NodeStatus.FAILED, NodeStatus.BREAKDOWN):
                    cb.on_node_failed(node)
                elif status == NodeStatus.DELETED:
                    cb.on_node_deleted(node)
            except Exception as e:  # noqa: BLE001
                logger.error("event callback %s failed: %s",
                             type(cb).__name__, e)

    # -- relaunch decision tree ----------------------------------------
    def _should_relaunch(self, node: Node) -> bool:
        """Reference: dist_job_manager.py:487-544."""
        if self.job_stage() != JobStage.RUNNING:
            return False
        if not node.relaunchable:
            return False
        if node.is_released:
            return False
        if node.exit_reason == NodeExitReason.FATAL_ERROR and \
                not self._relaunch_always:
            return False
        if node.relaunch_count >= node.max_relaunch_count:
            logger.warning("node %s exhausted relaunch budget (%d)",
                           node.name, node.max_relaunch_count)
            return False
        args = self._job_args.node_args.get(node.type)
        if args is not None and node.rank_index >= args.group_resource.count:
            # rank beyond the current target group size: this deletion is a
            # deliberate scale-down, not a failure
            return False
        return True

    def _relaunch_node(self, node: Node) -> None:
        node.is_released = True
        with self._lock:
            by_id = self._nodes[node.type]
            new_id = max(by_id) + 1
        replacement = node.get_relaunch_node(new_id)
        if node.exit_reason == NodeExitReason.OOM:
            # OOM recovery plan: same node back with more host memory
            replacement.config_resource.memory_mb = (
                node.config_resource.memory_mb * _OOM_MEMORY_FACTOR)
        elif node.exit_reason == NodeExitReason.DRAINED:
            # a graceful drain is a PLANNED departure, not a failure:
            # replace the capacity without charging the relaunch budget
            # (a job surviving N preemptions must still have its full
            # budget for real crashes)
            replacement.relaunch_count = node.relaunch_count
        with self._lock:
            by_id[new_id] = replacement
        logger.info("relaunching %s as %s (attempt %d/%d)", node.name,
                    replacement.name, replacement.relaunch_count,
                    replacement.max_relaunch_count)
        plan = ScalePlan(launch_nodes=[replacement])
        if self._job_args.remove_exited_node and \
                node.status != NodeStatus.DELETED:
            plan.remove_nodes.append(node)
        self._scaler.scale(plan)

    # -- job stage ------------------------------------------------------
    def _update_job_stage(self) -> None:
        with self._lock:
            workers = [
                n for t in (NodeType.WORKER, NodeType.CHIEF,
                            NodeType.EVALUATOR)
                for n in self._nodes.get(t, {}).values()
                if not n.is_released
            ]
            all_nodes = [n for by_id in self._nodes.values()
                         for n in by_id.values() if not n.is_released]
        if not all_nodes:
            return
        # Critical-node death without relaunch ⇒ job failed (reference:
        # dist_job_manager.py:123-125 critical-node handling).
        for node in all_nodes:
            if (node.critical
                    and node.status in (NodeStatus.FAILED,
                                        NodeStatus.BREAKDOWN)
                    and node.is_unrecoverable_failure()):
                self._fail_job(f"critical node {node.name} failed: "
                               f"{node.exit_reason}")
                return
        if workers and all(n.status == NodeStatus.SUCCEEDED
                           for n in workers):
            with self._lock:
                self._stage = JobStage.SUCCEEDED
            return
        failed = [n for n in workers
                  if n.status in (NodeStatus.FAILED, NodeStatus.BREAKDOWN)
                  and n.is_unrecoverable_failure()]
        if workers and len(failed) == len(workers):
            self._fail_job("all workers failed unrecoverably")

    def _fail_job(self, reason: str) -> None:
        with self._lock:
            if self._stage == JobStage.FAILED:
                return
            self._stage = JobStage.FAILED
            self._exit_reason = reason
        logger.error("job failed: %s", reason)

    def job_stage(self) -> str:
        with self._lock:
            return self._stage

    def exit_reason(self) -> str:
        with self._lock:
            return self._exit_reason

    # -- servicer-facing API -------------------------------------------
    def update_node_resource_usage(self, stats: msg.NodeResourceStats
                                   ) -> None:
        with self._lock:
            node = self._nodes.get(stats.node_type, {}).get(stats.node_id)
        if node is None:
            return
        node.used_resource.cpu = stats.cpu_percent
        node.used_resource.memory_mb = stats.memory_mb
        if stats.chip_stats:
            node.used_resource.chips = len(stats.chip_stats)

    def collect_heartbeat(self, node_id: int, timestamp: float,
                          node_type: str = "") -> None:
        """Refresh one node's heartbeat. node_type disambiguates groups that
        reuse ids (a worker beat must not refresh a chief/evaluator with the
        same id, which would weaken all_running_node_hanged)."""
        with self._lock:
            if node_type:
                by_id = self._nodes.get(node_type, {})
                if node_id in by_id:
                    by_id[node_id].heartbeat_time = timestamp
                    return
                # typed miss (old client, or node adopted under another
                # group after a master restart): fall through to the
                # untyped scan rather than drop the liveness signal
            for by_id in self._nodes.values():
                if node_id in by_id:
                    by_id[node_id].heartbeat_time = timestamp

    def handle_failure_report(self, report: msg.NodeFailureReport) -> None:
        with self._lock:
            node = None
            for by_id in self._nodes.values():
                if report.node_id in by_id:
                    node = by_id[report.node_id]
                    break
        if node is None:
            return
        from dlrover_tpu_torch.common.constants import TrainingMsgLevel

        if report.restart_count >= 0:
            node.relaunch_count = max(node.relaunch_count,
                                      report.restart_count)
        if report.level == TrainingMsgLevel.NODE_ERROR:
            # Agent diagnosed a machine-level fault (e.g. a card's error):
            # the host must be replaced, not restarted in place.
            node.exit_reason = NodeExitReason.HARDWARE_ERROR
            node.relaunchable = True

    def handle_scale_request(self, request: msg.ScaleRequest) -> None:
        """Manual scale (reference: ScalePlanReconciler relay +
        handle in master)."""
        logger.info("manual scale: %s -> %d", request.node_type,
                    request.count)
        self.scale_node_group(request.node_type, request.count)

    def scale_node_group(self, node_type: str, count: int,
                         resource=None) -> None:
        """Resize a node group. Shrinks remove explicit top-rank victims
        marked released so their deletion events are not mistaken for
        failures and relaunched."""
        with self._lock:
            args = self._job_args.node_args.get(node_type)
            if args is None:
                return
            resource = resource or args.group_resource.node_resource
            args.group_resource.count = count
            alive = sorted(
                (n for n in self._nodes.get(node_type, {}).values()
                 if n.is_alive() and not n.is_released),
                key=lambda n: n.rank_index,
            )
        plan = ScalePlan()
        if count < len(alive):
            victims = alive[count:]
            for node in victims:
                node.relaunchable = False
                node.is_released = True
            plan.remove_nodes.extend(victims)
        # group resize both grows and catches pods the manager hasn't
        # adopted yet (the scaler trims to the target after removals)
        plan.node_group_resources[node_type] = NodeGroupResource(
            count=count, node_resource=resource)
        self._scaler.scale(plan)

    def collect_model_info(self, info: msg.ModelInfo) -> None:
        with self._lock:
            # export_state snapshots this under the same lock
            self._model_info = info

    # -- crash-consistent state (master/state_backend.py) ---------------
    def export_state(self) -> dict:
        with self._lock:
            return {
                "stage": self._stage,
                "exit_reason": self._exit_reason,
                "nodes": {
                    node_type: {str(nid): node.to_dict()
                                for nid, node in by_id.items()}
                    for node_type, by_id in self._nodes.items()
                },
                # the resource optimizer's model profile: workers report
                # ModelInfo once at loop build — a failover that lost it
                # would leave the optimizer profile-blind until the next
                # full worker restart
                "model_info": (dataclasses.asdict(self._model_info)
                               if self._model_info else None),
            }

    def restore_state(self, state: dict) -> None:
        """Rebuild the node table (incl. restart budgets) and job stage.
        Called before start(): _init_nodes then leaves restored groups
        alone, and the watcher re-adopts any node that changed while the
        master was down through the normal event path."""
        with self._lock:
            self._stage = state.get("stage", self._stage)
            self._exit_reason = state.get("exit_reason", "")
            for node_type, by_id in state.get("nodes", {}).items():
                self._nodes[node_type] = {
                    int(nid): Node.from_dict(d)
                    for nid, d in by_id.items()
                }
            info = state.get("model_info")
            if isinstance(info, dict):
                # filter to known fields: a snapshot written by a newer
                # master must not crash an older one's restore
                known = {f.name for f in dataclasses.fields(msg.ModelInfo)}
                self._model_info = msg.ModelInfo(
                    **{k: v for k, v in info.items() if k in known})

    # -- hang detection -------------------------------------------------
    def all_running_node_hanged(self) -> bool:
        """True when every running node's heartbeat is stale (reference:
        dist_job_manager.py:692)."""
        ctx = Context.singleton()
        now = time.time()
        with self._lock:
            running = [n for by_id in self._nodes.values()
                       for n in by_id.values()
                       if n.status == NodeStatus.RUNNING]
        if not running:
            return False
        return all(
            n.heartbeat_time > 0
            and now - n.heartbeat_time > ctx.hang_seconds
            for n in running
        )

    # -- introspection ---------------------------------------------------
    def get_nodes(self, node_type: Optional[str] = None) -> List[Node]:
        with self._lock:
            if node_type is not None:
                return list(self._nodes.get(node_type, {}).values())
            return [n for by_id in self._nodes.values()
                    for n in by_id.values()]

    def get_running_workers(self) -> List[Node]:
        return [n for n in self.get_nodes(NodeType.WORKER)
                if n.status == NodeStatus.RUNNING]

    @property
    def job_args(self) -> JobArgs:
        return self._job_args


def create_job_manager(
    job_args: JobArgs,
    master_addr: str = "",
    speed_monitor=None,
    cluster=None,
) -> JobManager:
    """Wire the platform-appropriate scaler + watcher (reference:
    create_job_manager, dist_job_manager.py)."""
    if job_args.platform == PlatformType.LOCAL:
        from dlrover_tpu_torch.master.scaler.local_scaler import LocalScaler
        from dlrover_tpu_torch.master.watcher.local_watcher import LocalNodeWatcher
        from dlrover_tpu_torch.scheduler.local import LocalCluster

        cluster = cluster if cluster is not None else LocalCluster()
        scaler = LocalScaler(job_args.job_name, cluster,
                             master_addr=master_addr)
        watcher = LocalNodeWatcher(cluster, job_args.job_name)
    elif job_args.platform == PlatformType.KUBERNETES:
        from dlrover_tpu_torch.master.scaler.pod_scaler import PodScaler
        from dlrover_tpu_torch.master.watcher.k8s_watcher import K8sPodWatcher
        from dlrover_tpu_torch.scheduler.kubernetes import K8sClient

        client = cluster if cluster is not None else K8sClient(
            namespace=job_args.namespace)
        scaler = PodScaler(job_args.job_name, client, master_addr,
                           image=job_args.image, command=job_args.command)
        watcher = K8sPodWatcher(client, job_args.job_name)
    elif job_args.platform == PlatformType.RAY:
        from dlrover_tpu_torch.master.scaler.ray_scaler import RayScaler
        from dlrover_tpu_torch.master.watcher.ray_watcher import RayNodeWatcher
        from dlrover_tpu_torch.scheduler.ray import RayClient

        client = cluster if cluster is not None else RayClient(
            job_args.job_name)
        scaler = RayScaler(job_args.job_name, client, master_addr,
                           command=job_args.command)
        watcher = RayNodeWatcher(client, job_args.job_name)
    else:
        raise ValueError(f"unsupported platform {job_args.platform!r}")
    return JobManager(job_args, scaler, watcher,
                      speed_monitor=speed_monitor)
