"""MasterClient: the sole channel from a node to the master.

Own copy of the JAX package's ``agent/master_client.py``, after
dlrover/python/elastic_agent/master_client.py:49: typed wrappers over
the two-RPC service for every protocol interaction this slice ports, a
retry decorator, and the singleton the worker builds from the agent's
environment contract.

Master-loss handling, as in the JAX client: hot-prefix kv traffic
(``coord/``, ``dcn/``) dials the master's coordination tier when one is
advertised (the env, a join or reconnect result), with a breaker that
falls back to the main tier for 5 s after a transport failure;
``resolve_bootstrap``/``resolve_master_addr`` read the bootstrap file a
restarted or promoted master rewrites, ``reconnect`` re-dials, and
``reconnect_report`` re-registers through the generation handshake.
``reresolve_if_moved`` is there for a worker's failure paths; like the
JAX package, only slice mode (``parallel/dcn_sync.py``) calls it.
"""

from __future__ import annotations

import functools
import json
import os
import random
import time
from typing import Dict, Optional, Tuple

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import (
    MasterStub,
    TransportFaultInjector,
    build_channel,
    local_ip,
)
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import (
    HOT_KV_PREFIXES,
    NodeEnv,
    RendezvousName,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.obs import current_context


def backoff_delay_s(attempt: int, base_s: float, cap_s: float) -> float:
    """Jittered exponential backoff: min(cap, base·2^attempt) scaled by a
    uniform [0.5, 1.0) jitter so a fleet of agents retrying against a
    restarted master doesn't stampede it in lockstep."""
    envelope = min(cap_s, base_s * (2.0 ** min(attempt, 62)))
    return envelope * random.uniform(0.5, 1.0)


def retry_rpc(retries: Optional[int] = None,
              backoff_s: Optional[float] = None,
              max_backoff_s: Optional[float] = None):
    """Retry decorator. None parameters resolve from Context at CALL
    time, so tests can shrink the budget on a live process."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            ctx = Context.singleton()
            attempts = retries if retries is not None else ctx.rpc_retries
            base = backoff_s if backoff_s is not None else ctx.rpc_backoff_s
            cap = (max_backoff_s if max_backoff_s is not None
                   else ctx.rpc_backoff_max_s)
            last_exc = None
            for attempt in range(max(1, attempts)):
                try:
                    return fn(*args, **kwargs)
                except Exception as exc:  # noqa: BLE001 — grpc errors vary
                    last_exc = exc
                    if attempt < attempts - 1:
                        time.sleep(backoff_delay_s(attempt, base, cap))
            raise last_exc

        return wrapped

    return decorator


class MasterClient:
    _singleton: Optional["MasterClient"] = None

    def __init__(self, master_addr: str, node_id: int = 0,
                 node_rank: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 node_type: str = "",
                 slice_id: Optional[int] = None,
                 coord_addr: Optional[str] = None):
        self.master_addr = master_addr
        self.node_id = node_id
        self.node_type = node_type
        self.node_rank = node_rank if node_rank is not None else node_id
        # the slice this node belongs to (slice mode); -1 = a sliceless
        # job. The parameter wins over the env, so in-process tests can
        # run several slices in one process
        self.slice_id = (slice_id if slice_id is not None
                         else int(os.getenv(NodeEnv.SLICE_ID, "-1")))
        # per-call deadline; wait_for_ready means an unreachable master
        # surfaces as DEADLINE_EXCEEDED after exactly this long
        self._timeout_s = (timeout_s if timeout_s is not None
                           else Context.singleton().rpc_timeout_s)
        # the latest master generation any RPC reported (0 = unknown)
        self.master_generation = 0
        # the peer-restore plan the last join result carried ("" =
        # none): the agent publishes it to the worker through a file
        self.last_restore_plan_json = ""
        # the parallelism plan the last join result carried ("" = none):
        # the agent publishes it to the worker through a file
        self.last_shard_plan_json = ""
        # owned by the CLIENT, not the stub: a seeded chaos injector
        # keeps its sequence across reconnect()s
        self._fault_injector = TransportFaultInjector.from_env()
        self._channel = build_channel(master_addr)
        self._stub = MasterStub(self._channel,
                                fault_injector=self._fault_injector)
        # the coordination tier (master/coord_service.py): hot-prefix kv
        # traffic dials this address ("" = single-tier master)
        self.coord_addr = ""
        self._coord_channel = None
        self._coord_stub = None
        # breaker: after a coordination-tier transport failure, hot
        # traffic goes straight to the main tier until this deadline
        self._coord_down_until = 0.0
        self.set_coord_addr(
            coord_addr if coord_addr is not None
            else os.getenv(NodeEnv.COORD_ADDR, ""))

    def set_coord_addr(self, coord_addr: str) -> None:
        """(Re)dial the coordination tier; "" tears it down (hot traffic
        falls back to the main channel)."""
        if coord_addr == self.coord_addr and (
                bool(coord_addr) == (self._coord_stub is not None)):
            return
        old = self._coord_channel
        self.coord_addr = coord_addr or ""
        self._coord_down_until = 0.0   # a fresh dial resets the breaker
        if coord_addr:
            self._coord_channel = build_channel(coord_addr)
            self._coord_stub = MasterStub(
                self._coord_channel,
                fault_injector=self._fault_injector)
        else:
            self._coord_channel = None
            self._coord_stub = None
        if old is not None:
            try:
                old.close()
            except Exception:  # noqa: BLE001 — a dead channel may refuse
                pass

    def reconnect(self, master_addr: Optional[str] = None,
                  coord_addr: Optional[str] = None) -> None:
        """Tear down the channel and dial (a possibly different) master;
        the typed wrappers go through the new stub on their next call.
        A given ``coord_addr`` re-dials the coordination tier too (a
        promoted standby binds a fresh one)."""
        addr = master_addr or self.master_addr
        try:
            self._channel.close()
        except Exception:  # noqa: BLE001 — a dead channel may refuse
            pass
        self.master_addr = addr
        self._channel = build_channel(addr)
        self._stub = MasterStub(self._channel,
                                fault_injector=self._fault_injector)
        if coord_addr is not None:
            self.set_coord_addr(coord_addr)

    @staticmethod
    def resolve_bootstrap() -> dict:
        """The bootstrap file's parsed contents: {"addr", "coord_addr",
        "generation"}; a plain (pre-JSON) file reads as {"addr":
        <contents>}. {} = no file."""
        path = os.getenv(NodeEnv.MASTER_BOOTSTRAP, "") or (
            Context.singleton().master_bootstrap_file)
        if not path:
            return {}
        try:
            with open(path) as f:
                raw = f.read().strip()
        except OSError:
            return {}
        if not raw:
            return {}
        if raw.startswith("{"):
            try:
                parsed = json.loads(raw)
                if isinstance(parsed, dict) and parsed.get("addr"):
                    return parsed
            except ValueError:
                return {}
            return {}
        return {"addr": raw}

    @classmethod
    def resolve_master_addr(cls, default: str = "") -> str:
        """Where is the master NOW? The bootstrap file wins (a restarted
        or promoted master rewrites it with its new address and a bumped
        generation), then the env contract, then ``default``."""
        bootstrap = cls.resolve_bootstrap()
        if bootstrap.get("addr"):
            return str(bootstrap["addr"])
        return os.getenv(NodeEnv.MASTER_ADDR, "") or default

    def reresolve_if_moved(self) -> bool:
        """Re-read the bootstrap file and re-dial when the master moved
        while this process ran. The agent's master-lost loop does this
        itself; a worker, which learns the address from its env at spawn
        and is not respawned on a promotion, may call it from an RPC
        failure path. No-op without a bootstrap file."""
        bootstrap = self.resolve_bootstrap()
        addr = str(bootstrap.get("addr") or "")
        if not addr or addr == self.master_addr:
            return False
        coord = str(bootstrap.get("coord_addr") or "")
        logger.warning(
            "master moved %s -> %s (bootstrap generation %s); "
            "re-dialing", self.master_addr, addr,
            bootstrap.get("generation", "?"))
        self.reconnect(addr, coord_addr=coord)
        return True

    # -- raw --------------------------------------------------------------
    def _get(self, request: msg.Message) -> msg.Message:
        data = self._stub.get(msg.serialize_message(request),
                              timeout=self._timeout_s)
        return msg.deserialize_message(data)

    def _typed(self, send, request: msg.Message,
               expected: type) -> msg.Message:
        """Send via ``send`` and enforce the response type: a generic
        failure Response becomes a raisable (and retryable) error instead
        of an AttributeError in the caller."""
        response = send(request)
        if not isinstance(response, expected):
            reason = getattr(response, "reason", repr(response))
            raise RuntimeError(
                f"master error for {type(request).__name__}: {reason}"
            )
        return response

    def _get_typed(self, request: msg.Message, expected: type) -> msg.Message:
        return self._typed(self._get, request, expected)

    def _report(self, request: msg.Message) -> msg.Message:
        data = self._stub.report(msg.serialize_message(request),
                                 timeout=self._timeout_s)
        return msg.deserialize_message(data)

    def _report_typed(self, request: msg.Message,
                      expected: type) -> msg.Message:
        return self._typed(self._report, request, expected)

    # -- coordination-tier routing ----------------------------------------
    @staticmethod
    def _is_hot_key(key: str) -> bool:
        return key.startswith(HOT_KV_PREFIXES)

    def _coord_send(self, kind: str, request: msg.Message,
                    timeout_s: Optional[float] = None) -> msg.Message:
        """Send a coordination RPC through the coordination tier when one
        is dialed, falling back to the main tier (which answers every
        coordination RPC too) on any transport failure."""
        payload = msg.serialize_message(request)
        timeout = timeout_s if timeout_s is not None else self._timeout_s
        stub = self._coord_stub
        if stub is not None and time.monotonic() >= \
                self._coord_down_until:
            try:
                send = stub.get if kind == "get" else stub.report
                return msg.deserialize_message(
                    send(payload, timeout=timeout))
            except Exception:  # noqa: BLE001 — grpc errors vary
                self._coord_down_until = time.monotonic() + 5.0
        send = self._stub.get if kind == "get" else self._stub.report
        return msg.deserialize_message(send(payload, timeout=timeout))

    def close(self) -> None:
        self._channel.close()
        if self._coord_channel is not None:
            self._coord_channel.close()

    # -- dynamic sharding -------------------------------------------------
    @retry_rpc()
    def report_dataset_shard_params(self, params: msg.DatasetShardParams
                                    ) -> bool:
        return self._report(params).success

    @retry_rpc(retries=3)
    def get_task(self, dataset_name: str) -> msg.Task:
        return self._get_typed(
            msg.TaskRequest(dataset_name=dataset_name,
                            worker_id=self.node_id),
            msg.Task,
        )

    @retry_rpc(retries=3)
    def report_task_result(self, dataset_name: str, task_id: int,
                           success: bool = True, err: str = "") -> bool:
        return self._report(msg.TaskResult(
            dataset_name=dataset_name, task_id=task_id,
            worker_id=self.node_id, success=success, err_message=err,
        )).success

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        result = self._get_typed(
            msg.ShardCheckpointRequest(dataset_name=dataset_name),
            msg.ShardCheckpoint,
        )
        return result.content

    def report_shard_checkpoint(self, content: str) -> bool:
        return self._report(msg.ShardCheckpoint(content=content)).success

    def get_dataset_epoch(self, dataset_name: str) -> int:
        return self._get_typed(
            msg.DatasetEpochInfo(dataset_name=dataset_name),
            msg.DatasetEpochInfo,
        ).epoch

    def get_task_counts(self, dataset_name: str) -> Tuple[int, int]:
        """(todo, doing) task counts of a registered dataset."""
        result = self._get_typed(
            msg.TaskCounts(dataset_name=dataset_name), msg.TaskCounts)
        return result.todo, result.doing

    # -- rendezvous -------------------------------------------------------
    @retry_rpc()
    def join_rendezvous(self, local_world_size: int,
                        rdzv_name: str = RendezvousName.TRAINING) -> int:
        """Returns the rendezvous round this node was placed in."""
        result = self._report_typed(msg.JoinRendezvousRequest(
            node_id=self.node_id,
            node_rank=self.node_rank,
            local_world_size=local_world_size,
            rdzv_name=rdzv_name,
            node_ip=local_ip(),
            trace=current_context() or {},
            slice_id=self.slice_id,
        ), msg.JoinRendezvousResult)
        if result.generation:
            self.master_generation = result.generation
        self.last_restore_plan_json = result.restore_plan_json
        self.last_shard_plan_json = result.shard_plan_json
        self.set_coord_addr(result.coord_addr)
        return result.round

    def reconnect_report(self, local_world_size: int = 1,
                         rdzv_name: str = RendezvousName.TRAINING,
                         rdzv_round: int = -1) -> msg.ReconnectResult:
        """Re-register with a (possibly restarted) master after a
        master-lost episode. Undecorated: the caller's reconnect loop
        owns the pacing, and one clean failure per dial keeps its
        backoff honest."""
        result = self._report_typed(msg.ReconnectRequest(
            node_id=self.node_id,
            node_rank=self.node_rank,
            node_type=self.node_type,
            local_world_size=local_world_size,
            rdzv_name=rdzv_name,
            generation=self.master_generation,
            rdzv_round=rdzv_round,
            slice_id=self.slice_id,
        ), msg.ReconnectResult)
        if result.generation:
            self.master_generation = result.generation
        # a restarted or promoted master's coordination tier is a fresh
        # bind; adopt whatever it advertises (possibly "")
        self.set_coord_addr(result.coord_addr)
        return result

    @retry_rpc()
    def leave_rendezvous(self, rdzv_name: str = RendezvousName.TRAINING
                         ) -> bool:
        """Withdraw from an uncompleted round (poll deadline gave up)."""
        return self._report(msg.LeaveRendezvousRequest(
            node_id=self.node_id,
            node_rank=self.node_rank,
            rdzv_name=rdzv_name,
        )).success

    @retry_rpc(retries=3)
    def get_comm_world(self, rdzv_name: str = RendezvousName.TRAINING
                       ) -> Tuple[int, int, Dict[int, int]]:
        world = self._get_typed(
            msg.CommWorldRequest(node_id=self.node_rank,
                                 rdzv_name=rdzv_name),
            msg.CommWorld,
        )
        if world.rdzv_name and world.rdzv_name != rdzv_name:
            # the echo field guards against a cross-wired dispatch
            raise RuntimeError(
                f"comm world for {world.rdzv_name!r}, "
                f"asked for {rdzv_name!r}")
        return world.round, world.group, world.world

    @retry_rpc(retries=3)
    def num_nodes_waiting(self, rdzv_name: str = RendezvousName.TRAINING
                          ) -> int:
        result = self._get_typed(
            msg.WaitingNodeNumRequest(node_id=self.node_rank,
                                      rdzv_name=rdzv_name),
            msg.WaitingNodeNum,
        )
        return result.waiting_num

    def report_network_status(self, normal: bool, elapsed: float) -> bool:
        return self._report(msg.NetworkStatusReport(
            node_id=self.node_rank, normal=normal, elapsed_time=elapsed,
        )).success

    def get_network_check_verdict(self) -> msg.NetworkCheckVerdict:
        return self._get_typed(
            msg.NetworkCheckResultRequest(node_id=self.node_rank),
            msg.NetworkCheckVerdict,
        )

    # -- peer-to-peer restore ---------------------------------------------
    @retry_rpc(retries=3)
    def report_peer_store(self, addr: str, step: int, keys,
                          total_bytes: int = 0,
                          rdzv_name: str = RendezvousName.TRAINING
                          ) -> bool:
        """Advertise (step >= 0) or withdraw (step < 0) this host's
        staged peer-state cache with the master's donor registry."""
        return self._report(msg.PeerStoreReport(
            node_id=self.node_id, node_rank=self.node_rank, addr=addr,
            step=step, rdzv_name=rdzv_name, keys=list(keys),
            total_bytes=total_bytes, slice_id=self.slice_id,
        )).success

    @retry_rpc(retries=3)
    def get_slice_status(self, rdzv_name: str = RendezvousName.TRAINING
                         ) -> dict:
        """The master's slice registry view and the job's step
        high-water mark ({} = no slice registry): the cross-slice
        gradient sync's present set (``parallel/dcn_sync.py``). Per-step
        traffic, so the coordination tier answers when there is one."""
        result = self._typed(
            lambda request: self._coord_send("get", request),
            msg.SliceStatusRequest(
                node_id=self.node_id, node_rank=self.node_rank,
                rdzv_name=rdzv_name), msg.SliceStatus)
        return self._json_dict(result.status_json)

    @retry_rpc(retries=3)
    def get_shard_plan(self, rdzv_name: str = RendezvousName.TRAINING
                       ) -> dict:
        """The current parallelism plan for this rank's world
        (``parallel/planner.py``; {} = no plan)."""
        result = self._get_typed(msg.ShardPlanRequest(
            node_id=self.node_id, node_rank=self.node_rank,
            rdzv_name=rdzv_name), msg.ShardPlanResult)
        plan = self._json_dict(result.plan_json) if result.found else {}
        if plan:
            # the envelope's epoch and generation are authoritative:
            # staleness checks read them on the plan
            plan.setdefault("epoch", result.epoch)
            plan.setdefault("generation", result.generation)
        return plan

    @retry_rpc(retries=3)
    def get_restore_plan(self, rdzv_name: str = RendezvousName.TRAINING,
                         stripe: bool = False) -> dict:
        """A fresh peer-restore plan for this rank ({} = no donors).
        ``stripe``: entries list every same-step holder, and the receiver
        fetches byte ranges of a shard from all of them."""
        result = self._get_typed(msg.RestorePlanRequest(
            node_id=self.node_id, node_rank=self.node_rank,
            rdzv_name=rdzv_name, stripe=stripe), msg.RestorePlan)
        if not result.found or not result.plan_json:
            return {}
        try:
            plan = json.loads(result.plan_json)
        except json.JSONDecodeError:
            return {}
        if not isinstance(plan, dict):
            return {}
        # the envelope's epoch is authoritative: the commit-time
        # staleness guard compares against the stamp on the plan, and a
        # plan without one would always look fresh
        plan.setdefault("epoch", result.epoch)
        return plan

    @retry_rpc(retries=3)
    def get_restore_epoch(self, rdzv_name: str = RendezvousName.TRAINING
                          ) -> int:
        """The current world epoch: the staleness guard's commit-time
        check against the epoch a restore plan was computed at."""
        return self._get_typed(msg.RestorePlanRequest(
            node_id=self.node_id, node_rank=self.node_rank,
            rdzv_name=rdzv_name, epoch_only=True),
            msg.RestorePlan).epoch

    # -- kv store ---------------------------------------------------------
    # hot-prefix keys route to the coordination tier when the master
    # split one out; cold keys stay on the main tier for its
    # write-through snapshot durability
    def kv_set(self, key: str, value: bytes) -> bool:
        request = msg.KeyValuePair(key=key, value=value)
        if self._is_hot_key(key):
            return self._coord_send("report", request).success
        return self._report(request).success

    def kv_get(self, key: str) -> bytes:
        send = ((lambda request: self._coord_send("get", request))
                if self._is_hot_key(key) else self._get)
        return self._typed(send, msg.KVGetRequest(key=key),
                           msg.KeyValuePair).value

    def kv_add(self, key: str, amount: int) -> int:
        send = ((lambda request: self._coord_send("report", request))
                if self._is_hot_key(key) else self._report)
        return self._typed(send,
                           msg.KVAddRequest(key=key, amount=amount),
                           msg.KVIntResult).value

    def kv_wait(self, key: str, timeout_s: float = 300.0) -> bytes:
        """Block until the key appears: the master holds each RPC open on
        a condition variable for up to ~20 s per window (5 s on the
        coordination tier)."""
        deadline = time.time() + timeout_s
        hot = self._is_hot_key(key)
        while True:
            remaining = deadline - time.time()
            if remaining <= 0:
                raise TimeoutError(f"kv_wait timed out on {key!r}")
            window = min(remaining, 20.0)
            request = msg.KVWaitRequest(keys=[key], timeout_s=window)
            if hot:
                result = self._coord_send(
                    "get", request, timeout_s=window + self._timeout_s)
            else:
                result = self._get(request)
            if getattr(result, "success", False):
                return self.kv_get(key)

    # -- health / status --------------------------------------------------
    def report_global_step(self, step: int, step_time_s: float = 0.0,
                           data_wait_fraction: float = -1.0,
                           mfu: float = -1.0,
                           degraded_steps: int = 0,
                           hbm_peak_bytes: float = 0.0,
                           plan_generation: int = -1) -> bool:
        """Step progress with the sender's windowed speed evidence: mean
        step wall time and data-wait fraction from the worker's phase
        timeline, achieved MFU from its FLOPs model, the steps of the
        window its slice took with a renormalized gradient mean (a peer
        slice absent), and the report window's device-truth memory peak
        (``obs/device.py``; 0 = none).
        ``timestamp`` rides for wire captures only: the master keys
        speed on its own clock."""
        return self._report(msg.GlobalStepReport(
            node_id=self.node_id, step=step, timestamp=time.time(),
            node_rank=self.node_rank, step_time_s=step_time_s,
            data_wait_fraction=data_wait_fraction, mfu=mfu,
            degraded_steps=degraded_steps,
            hbm_peak_bytes=hbm_peak_bytes,
            plan_generation=plan_generation,
        )).success

    # -- diagnosis --------------------------------------------------------
    def poll_diagnosis_actions(self) -> list:
        """Actions the master's diagnosis engine addressed to this rank
        (single delivery: the caller executes or drops them)."""
        result = self._get_typed(
            msg.DiagnosisActionRequest(node_id=self.node_id,
                                       node_rank=self.node_rank),
            msg.DiagnosisActions,
        )
        return self._json_list(result.actions_json)

    def get_diagnosis_reports(self, limit: int = 0) -> list:
        """The master's recent DiagnosisReport dicts, oldest first."""
        result = self._get_typed(
            msg.DiagnosisReportRequest(limit=limit),
            msg.DiagnosisReports,
        )
        return self._json_list(result.reports_json)

    def report_resource_stats(self, stats: msg.NodeResourceStats) -> bool:
        return self._report(stats).success

    def query_timeseries(self, name: str = "", labels=None,
                         window_s: float = 0.0,
                         resolution_s: float = 0.0) -> dict:
        """Windowed, aligned history from the master's time-series store
        (``obs/tsdb.py``): {"series": [...], "tiers": [...], "stats":
        {...}}, or {"names": [...]} with an empty name; {} from a master
        without a store."""
        result = self._get_typed(msg.TimeSeriesQuery(
            name=name, labels=dict(labels or {}),
            window_s=window_s, resolution_s=resolution_s),
            msg.TimeSeriesResult)
        return self._json_dict(result.result_json)

    def query_steptrace(self, start_step: int = -1, end_step: int = -1,
                        last_n: int = 0) -> dict:
        """Assembled per-step critical paths from the master's
        StepTraceAssembler (``master/steptrace.py``): {"version",
        "steps", "summary"}; {} from a master without one."""
        result = self._get_typed(msg.StepTraceRequest(
            start_step=start_step, end_step=end_step, last_n=last_n),
            msg.StepTraceResult)
        return self._json_dict(result.result_json)

    def probe_clock(self) -> float:
        """One NTP-style clock probe: the master's wall clock, or -1.0 on
        failure. A single attempt on the raw path: retries would inflate
        the measured round trip, which is the uncertainty bound
        ClockSync stamps into records."""
        try:
            result = self._get(msg.ClockProbe(node_id=self.node_id))
        except Exception:  # noqa: BLE001 — droppable by contract
            return -1.0
        return float(getattr(result, "server_ts", -1.0) or -1.0)

    @staticmethod
    def _json_dict(text: str) -> dict:
        if not text:
            return {}
        try:
            payload = json.loads(text)
        except json.JSONDecodeError:
            return {}
        return payload if isinstance(payload, dict) else {}

    @staticmethod
    def _json_list(text: str) -> list:
        if not text:
            return []
        try:
            payload = json.loads(text)
        except json.JSONDecodeError:
            return []
        return payload if isinstance(payload, list) else []

    def report_heartbeat(self) -> bool:
        return self._report(msg.NodeHeartbeat(
            node_id=self.node_id, node_type=self.node_type,
            timestamp=time.time(), node_rank=self.node_rank)).success

    def report_failure(self, error_data: str, level: str,
                       restart_count: int = 0,
                       exit_kind: str = "") -> bool:
        return self._report(msg.NodeFailureReport(
            node_id=self.node_id, node_rank=self.node_rank,
            error_data=error_data, level=level,
            restart_count=restart_count, exit_kind=exit_kind,
        )).success

    @retry_rpc(retries=3)
    def report_drain(self, deadline: float, reason: str = "",
                     phase: str = "notice") -> msg.DrainResult:
        """Announce (phase="notice") or conclude (phase="complete") this
        node's preemption drain. A modest retry budget: the drain window
        is finite, and the local emergency checkpoint matters more than
        spending the grace period on retries."""
        return self._report_typed(msg.DrainReport(
            node_id=self.node_id, node_rank=self.node_rank,
            deadline=deadline, reason=reason, phase=phase,
        ), msg.DrainResult)

    def report_telemetry(self, samples=None, spans=None,
                         steptrace=None) -> bool:
        """Push metric samples, finished span dicts and per-step trace
        records to the master (obs/). Best-effort by contract: callers
        treat a False or a raise as droppable telemetry."""
        if not samples and not spans and not steptrace:
            return True
        return self._report(msg.TelemetryReport(
            node_id=self.node_id,
            node_rank=self.node_rank,
            node_type=self.node_type,
            samples=list(samples or ()),
            spans_json=json.dumps(spans) if spans else "",
            steptrace_json=json.dumps(steptrace) if steptrace else "",
        )).success

    def get_plan_calibration(self) -> dict:
        """The planner's calibration table and learned axis discounts
        (``parallel/calibration.py``): {"table": [...], "discounts": {},
        "min_samples": n}; {} from a master without one."""
        result = self._get_typed(msg.PlanCalibrationRequest(),
                                 msg.PlanCalibrationReport)
        return self._json_dict(result.report_json)

    def get_goodput(self, window_s: float = 0.0) -> dict:
        """The master's goodput-ledger snapshot (``obs/goodput.py``); {}
        from a master without one."""
        result = self._get_typed(msg.GoodputRequest(window_s=window_s),
                                 msg.GoodputReport)
        return self._json_dict(result.report_json)

    def get_autoscale_status(self) -> dict:
        """The fleet controller's decision history and guardrail state
        (brain/fleet_controller.py): {"decisions", "watch",
        "quarantine", "offers", ...}; {} from a master without one."""
        result = self._get_typed(msg.AutoscaleStatusRequest(),
                                 msg.AutoscaleStatus)
        return self._json_dict(result.status_json)

    def report_node_address(self, addr: str) -> bool:
        return self._report(msg.NodeAddressReport(
            node_id=self.node_id, node_rank=self.node_rank, addr=addr,
        )).success

    def report_model_info(self, param_count: int, param_bytes: int,
                          flops_per_step: float = 0.0,
                          batch_size: int = 0, seq_len: int = 0,
                          flops_per_token: float = 0.0,
                          peak_flops_per_chip: float = 0.0,
                          chips: int = 0,
                          flops_source: str = "",
                          tensor_divisor: int = 0,
                          fsdp_divisor: int = 0,
                          effective_global_batch: int = 0) -> bool:
        """Static model stats plus the FLOPs model that turns the
        master's tokens/s into MFU."""
        return self._report(msg.ModelInfo(
            param_count=param_count, param_bytes=param_bytes,
            flops_per_step=flops_per_step, batch_size=batch_size,
            seq_len=seq_len, flops_per_token=flops_per_token,
            peak_flops_per_chip=peak_flops_per_chip, chips=chips,
            flops_source=flops_source, tensor_divisor=tensor_divisor,
            fsdp_divisor=fsdp_divisor,
            effective_global_batch=effective_global_batch,
        )).success

    def get_paral_config(self) -> msg.ParallelConfig:
        return self._get_typed(
            msg.ParallelConfigRequest(node_id=self.node_id),
            msg.ParallelConfig,
        )

    def get_job_status(self) -> msg.JobStatus:
        return self._get_typed(msg.JobStatusRequest(), msg.JobStatus)

    # -- barriers / PS versions -------------------------------------------
    def join_sync(self, sync_name: str) -> bool:
        return self._report(msg.SyncJoinRequest(
            sync_name=sync_name, node_id=self.node_id)).success

    def sync_finished(self, sync_name: str) -> bool:
        return self._get(msg.SyncQueryRequest(sync_name=sync_name)).success

    def finish_sync(self, sync_name: str) -> bool:
        return self._report(
            msg.SyncFinishRequest(sync_name=sync_name)).success

    def update_cluster_version(self, version_type: str, version: int,
                               task_type: str = "worker",
                               task_id: Optional[int] = None) -> bool:
        return self._report(msg.ClusterVersionRequest(
            task_type=task_type,
            task_id=task_id if task_id is not None else self.node_id,
            version_type=version_type, version=version,
        )).success

    def get_cluster_version(self, version_type: str,
                            task_type: str = "worker",
                            task_id: Optional[int] = None) -> int:
        return self._get_typed(msg.ClusterVersionRequest(
            task_type=task_type,
            task_id=task_id if task_id is not None else self.node_id,
            version_type=version_type,
        ), msg.ClusterVersion).version

    # -- singleton --------------------------------------------------------
    @classmethod
    def singleton(cls) -> "MasterClient":
        if cls._singleton is None:
            addr = os.getenv(NodeEnv.MASTER_ADDR, "")
            if not addr:
                raise RuntimeError(
                    f"{NodeEnv.MASTER_ADDR} is not set; is this process "
                    "running under dlrover_tpu_torch.run?"
                )
            node_id = int(os.getenv(NodeEnv.NODE_ID, "0"))
            node_rank = int(os.getenv(NodeEnv.NODE_RANK, str(node_id)))
            cls._singleton = cls(addr, node_id, node_rank)
        return cls._singleton

    @classmethod
    def reset_singleton(cls) -> None:
        cls._singleton = None
