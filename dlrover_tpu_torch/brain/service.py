"""Brain service over the two-RPC comm layer.

Own copy of the JAX package's ``brain/service.py``, after
dlrover/go/brain/pkg/server/server.go:176: persist_metrics, optimize and
get_job_metrics dispatched from the shared get/report envelope, with the
JAX service's replies byte for byte.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

import grpc

from dlrover_tpu_torch.brain.algorithms import run_algorithm
from dlrover_tpu_torch.brain.datastore import MetricsStore
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import build_server
from dlrover_tpu_torch.common.log import default_logger as logger


class BrainService:
    def __init__(self, store: Optional[MetricsStore] = None,
                 port: int = 0, host: str = "0.0.0.0"):
        self.store = store or MetricsStore()
        self._server, self.port = build_server(
            self._get_bytes, self._report_bytes, port=port, host=host)
        self._started = threading.Event()

    def start(self) -> None:
        self._server.start()
        self._started.set()
        logger.info("brain service on port %d", self.port)

    def stop(self, grace_s: float = 0.5) -> None:
        self._server.stop(grace_s)

    # -- wire handlers ---------------------------------------------------
    def _get_bytes(self, payload: bytes,
                   context: grpc.ServicerContext) -> bytes:
        request = msg.deserialize_message(payload)
        return msg.serialize_message(self._get(request))

    def _report_bytes(self, payload: bytes,
                      context: grpc.ServicerContext) -> bytes:
        request = msg.deserialize_message(payload)
        return msg.serialize_message(self._report(request))

    # -- dispatch --------------------------------------------------------
    def _get(self, request) -> msg.Message:
        if isinstance(request, msg.BrainOptimizeRequest):
            config = (json.loads(request.config_json)
                      if request.config_json else {})
            plan = run_algorithm(request.stage, self.store,
                                 request.job_name, config)
            return msg.BrainResourcePlan(plan_json=json.dumps(plan),
                                         found=bool(plan))
        if isinstance(request, msg.BrainJobMetricsRequest):
            records = self.store.query(job_name=request.job_name or None,
                                       record_type=request.record_type
                                       or None)
            return msg.BrainJobMetrics(records_json=json.dumps(records))
        return msg.Response(success=False, reason="unknown request")

    def _report(self, request) -> msg.Message:
        if isinstance(request, msg.BrainMetricsReport):
            try:
                payload = json.loads(request.payload_json or "{}")
            except json.JSONDecodeError:
                return msg.Response(success=False, reason="bad payload")
            self.store.persist(request.job_name, request.record_type,
                               payload, request.job_uuid)
            return msg.Response(success=True)
        return msg.Response(success=False, reason="unknown request")
