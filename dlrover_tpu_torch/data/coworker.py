"""Coworker data plane: CPU processes push preprocessed batches to the
trainer over the network.

Counterpart of ``dlrover_tpu/data/coworker.py`` (after atorch's
``coworker_data_service.py``, ``data_info_service.py`` and
``CoworkerDataset``): the same two-method gRPC layer as the control plane
(``common/comm.py``) and the same wire messages (``CoworkerBatch``,
``CoworkerBatchRequest``, ``CoworkerInfo`` of ``common/messages.py``,
byte for byte the JAX package's), so a client of either package pushes
into a service of either. A coworker on the trainer's own host should
prefer ``ShmDataContext`` (``data/shm_ring.py``: no serialization); this
service is the cross-host path.
"""

from __future__ import annotations

import pickle
import queue
import threading
import time
from typing import Any, Iterator, Optional

import grpc

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.comm import (
    MasterStub,
    build_channel,
    build_server,
)
from dlrover_tpu_torch.common.log import default_logger as logger


class CoworkerDataService:
    """Runs inside the trainer process; coworkers dial it and push
    batches. One bounded queue a dataset: producers see back-pressure
    through ``CoworkerInfo`` and refused pushes."""

    def __init__(self, capacity: int = 64, port: int = 0,
                 host: str = "0.0.0.0"):
        self._queues: dict = {}
        self._capacity = capacity
        # one False -> True transition, read from RPC threads and the
        # trainer's consumer loop
        self._finished = threading.Event()
        self._lock = threading.Lock()
        self._server, self.port = build_server(
            self._get_bytes, self._report_bytes, port=port, host=host)

    def start(self) -> None:
        self._server.start()
        logger.info("coworker data service on port %d", self.port)

    def stop(self, grace_s: float = 0.5) -> None:
        self._server.stop(grace_s)

    def _queue_for(self, dataset: str) -> "queue.Queue":
        with self._lock:
            if dataset not in self._queues:
                self._queues[dataset] = queue.Queue(self._capacity)
            return self._queues[dataset]

    # -- wire ------------------------------------------------------------
    def _get_bytes(self, payload: bytes,
                   context: grpc.ServicerContext) -> bytes:
        request = msg.deserialize_message(payload)
        if isinstance(request, msg.CoworkerBatchRequest):
            q = self._queue_for(request.dataset_name)
            return msg.serialize_message(msg.CoworkerInfo(
                dataset_name=request.dataset_name,
                queued=q.qsize(), capacity=self._capacity,
                finished=self._finished.is_set(),
            ))
        return msg.serialize_message(
            msg.Response(success=False, reason="unknown request"))

    def _report_bytes(self, payload: bytes,
                      context: grpc.ServicerContext) -> bytes:
        request = msg.deserialize_message(payload)
        if isinstance(request, msg.CoworkerBatch):
            try:
                self._queue_for(request.dataset_name).put(
                    request.payload, timeout=20.0)
                return msg.serialize_message(msg.Response(success=True))
            except queue.Full:
                return msg.serialize_message(msg.Response(
                    success=False, reason="queue full"))
        return msg.serialize_message(
            msg.Response(success=False, reason="unknown request"))

    # -- trainer-side consumption ----------------------------------------
    def mark_finished(self) -> None:
        self._finished.set()

    def batches(self, dataset_name: str = "default",
                timeout_s: Optional[float] = 60.0) -> Iterator[Any]:
        """The dataset's batches in arrival order, until
        ``mark_finished`` and an empty queue; raises TimeoutError when
        none comes for ``timeout_s``."""
        q = self._queue_for(dataset_name)
        last_progress = time.time()
        while True:
            try:
                payload = q.get(timeout=0.2)
                last_progress = time.time()
                yield pickle.loads(payload)
            except queue.Empty:
                if self._finished.is_set():
                    return
                if (timeout_s is not None
                        and time.time() - last_progress > timeout_s):
                    raise TimeoutError(
                        f"no coworker batch for dataset "
                        f"{dataset_name!r} in {timeout_s:.0f}s")


class CoworkerClient:
    """Runs in the coworker process; pushes batches to a trainer's
    ``CoworkerDataService``."""

    def __init__(self, trainer_addr: str, producer_id: int = 0,
                 timeout_s: float = 30.0):
        self._channel = build_channel(trainer_addr)
        self._stub = MasterStub(self._channel)
        self._producer_id = producer_id
        self._timeout_s = timeout_s
        self._seq = 0

    def queue_info(self, dataset_name: str = "default") -> msg.CoworkerInfo:
        raw = self._stub.get(msg.serialize_message(
            msg.CoworkerBatchRequest(dataset_name=dataset_name)),
            timeout=self._timeout_s)
        return msg.deserialize_message(raw)

    def push_batch(self, batch: Any, dataset_name: str = "default") -> bool:
        """Whether the service took the batch (False: its queue stayed
        full)."""
        self._seq += 1
        # producer_id and seq stamp the wire for duplicate and ordering
        # forensics; the service keeps queue order only
        record = msg.CoworkerBatch(
            dataset_name=dataset_name,
            payload=pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL),
            producer_id=self._producer_id,
            seq=self._seq,
        )
        raw = self._stub.report(msg.serialize_message(record),
                                timeout=self._timeout_s)
        response = msg.deserialize_message(raw)
        return bool(getattr(response, "success", False))

    def close(self) -> None:
        self._channel.close()
