"""The coordination tier: KV and slice-status RPCs on their own port.

Own copy of the JAX package's ``master/coord_service.py``. The hot kv
traffic (the ``coord/`` rendezvous barriers, and in slice mode the
per-step ``dcn/`` exchange) would otherwise share one gRPC server,
thread pool and dispatch path with rendezvous joins, telemetry batches
and diagnosis polls, so a join storm or a telemetry flood could stall
it. This module splits it out:

- :class:`CoordServicer` answers exactly the coordination RPCs
  (``KVGetRequest``, ``KVWaitRequest``, ``KeyValuePair``,
  ``KVAddRequest``, ``SliceStatusRequest``) against the SAME
  ``KVStoreService`` and rendezvous registry the main servicer uses, on
  its own server and port. Reads are lock-free (``kv_store.get``).
- :class:`TelemetryIngestQueue` bounds the other direction: telemetry
  reports are enqueued (drop-oldest past ``telemetry_queue_size``,
  counted in ``dlrover_tpu_telemetry_dropped_total``) and replayed by
  one background thread, so a span storm degrades observability, never
  liveness.

The main servicer keeps answering every coordination RPC too (clients
with no coordination address, or a master with ``coord_port`` -1). The
coordination address rides the bootstrap file and the join and
reconnect results; ``MasterClient`` routes hot-prefix KV traffic there.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Callable, Optional

import grpc

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.kv_store import KVStoreService


class CoordServicer:
    """Dispatch for the coordination tier. Thin by design: every
    decision lives in the shared components; a request outside the
    coordination surface is answered with a clean failure (the client
    falls back to the main tier)."""

    def __init__(self, kv_store: KVStoreService,
                 rdzv_manager=None, speed_monitor=None,
                 state_sink: Optional[Callable] = None):
        self.kv_store = kv_store
        # the slice registry and the job's step high-water mark (the
        # re-formed slice's catch-up target)
        self.rdzv_manager = rdzv_manager
        self.speed_monitor = speed_monitor
        # cold keys arriving here still get crash-consistency (an old
        # client routing everything through one addr must lose nothing);
        # hot keys deliberately bypass it — that is the tier's point
        self.state_sink = state_sink

    # -- raw byte endpoints (wired into comm.build_server) ---------------
    def get_bytes(self, payload: bytes,
                  context: Optional[grpc.ServicerContext] = None
                  ) -> bytes:
        try:
            request = msg.deserialize_message(payload)
            response = self.get(request)
        except Exception:
            logger.exception("coord get failed (payload %d bytes)",
                             len(payload))
            response = msg.Response(success=False, reason="internal error")
        return msg.serialize_message(response)

    def report_bytes(self, payload: bytes,
                     context: Optional[grpc.ServicerContext] = None
                     ) -> bytes:
        try:
            request = msg.deserialize_message(payload)
            response = self.report(request)
        except Exception:
            logger.exception("coord report failed (payload %d bytes)",
                             len(payload))
            response = msg.Response(success=False, reason="internal error")
        return msg.serialize_message(response)

    # -- typed dispatch ---------------------------------------------------
    def get(self, request: msg.Message) -> msg.Message:
        if isinstance(request, msg.KVGetRequest):
            return msg.KeyValuePair(key=request.key,
                                    value=self.kv_store.get(request.key))
        if isinstance(request, msg.KVWaitRequest):
            # a SHORTER window than the main tier's 20 s: blocked waits
            # hold tier threads, and this tier's whole point is that a
            # wait pile-up (world formation) can never starve another
            # slice's per-step dcn/ gets. The client's kv_wait loop
            # re-issues until its own deadline either way.
            ok = self.kv_store.wait(request.keys,
                                    min(request.timeout_s, 5.0))
            return msg.Response(success=ok)
        if isinstance(request, msg.SliceStatusRequest):
            if self.rdzv_manager is None:
                return msg.SliceStatus(status_json="")
            status = self.rdzv_manager.slice_status()
            if self.speed_monitor is not None:
                status["fleet_step"] = (
                    self.speed_monitor.completed_global_step)
            return msg.SliceStatus(status_json=json.dumps(status))
        return msg.Response(
            success=False,
            reason=f"{type(request).__name__} is not a coordination-"
                   f"tier request")

    def report(self, request: msg.Message) -> msg.Message:
        if isinstance(request, msg.KeyValuePair):
            self.kv_store.set(request.key, request.value)
            self._sink_if_cold(request.key)
            return msg.Response(success=True)
        if isinstance(request, msg.KVAddRequest):
            value = self.kv_store.add(request.key, request.amount)
            self._sink_if_cold(request.key)
            return msg.KVIntResult(value=value)
        return msg.Response(
            success=False,
            reason=f"{type(request).__name__} is not a coordination-"
                   f"tier request")

    def _sink_if_cold(self, key: str) -> None:
        """Hot keys ride the mutation log; a cold key landing here still
        deserves a snapshot. Failures never fail the RPC."""
        if self.state_sink is None or self.kv_store.is_hot(key):
            return
        try:
            self.state_sink()
        except Exception:  # noqa: BLE001 — durability is best-effort
            logger.exception("coord-tier state snapshot failed")


class TelemetryIngestQueue:
    """Bounded drop-oldest ingest between the telemetry RPC and the
    registry replay. The RPC handler only appends; one daemon thread
    drains. Full queue → the OLDEST report is dropped and counted — a
    span storm can cost observability samples, never master liveness."""

    def __init__(self, process_fn: Callable, maxlen: int = 256):
        self._process = process_fn
        self._maxlen = max(1, maxlen)
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._processed = 0
        # the report the drainer popped but has not finished replaying:
        # flush() must wait it out too, or a caller could observe an
        # empty queue with the last report still mid-replay
        self._in_flight = 0
        self.dropped_total = 0
        self._dropped_counter = obs.get_registry().counter(
            "dlrover_tpu_telemetry_dropped_total",
            "Telemetry reports dropped (oldest-first) because the "
            "bounded ingest queue was full")

    def push(self, report) -> None:
        with self._cond:
            if len(self._queue) >= self._maxlen:
                self._queue.popleft()
                self.dropped_total += 1
                dropped = True
            else:
                dropped = False
            self._queue.append(report)
            if self._thread is None and not self._stopped:
                self._thread = threading.Thread(
                    target=self._drain, daemon=True,
                    name="telemetry-ingest")
                self._thread.start()
            self._cond.notify_all()
        if dropped:
            # registry ops outside the queue lock (they take their own)
            self._dropped_counter.inc()

    def _drain(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    self._cond.wait()
                if self._stopped and not self._queue:
                    return
                report = self._queue.popleft()
                self._in_flight += 1
            try:
                self._process(report)
            except Exception:  # noqa: BLE001 — one bad report must not
                # kill the drainer (and with it all future telemetry)
                logger.exception("telemetry report processing failed")
            with self._cond:
                self._in_flight -= 1
                self._processed += 1
                self._cond.notify_all()

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Block until everything pushed so far is processed (tests +
        graceful master stop). Returns False on timeout."""
        import time

        deadline = time.time() + timeout_s
        with self._cond:
            while self._queue or self._in_flight:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            thread = self._thread
            self._cond.notify_all()
        if thread is not None:
            thread.join(timeout=2.0)
