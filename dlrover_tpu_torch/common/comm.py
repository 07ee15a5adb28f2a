"""gRPC plumbing for the two-method control plane.

Own copy of the JAX package's ``common/comm.py``: the service
``dlrovertpu.Master`` with two generic unary methods, ``get`` and
``report``, registered through gRPC's generic-handler API with raw-bytes
(de)serializers. The payloads are the pickled dataclasses of
``common/messages.py``, byte for byte the JAX package's, so either
package's client talks to either package's master.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import socket
import time
from concurrent import futures
from typing import Callable, Dict, Optional, Tuple

import grpc

from dlrover_tpu_torch.common.constants import DefaultValues

SERVICE_NAME = "dlrovertpu.Master"
GET_METHOD = f"/{SERVICE_NAME}/get"
REPORT_METHOD = f"/{SERVICE_NAME}/report"

# Transport-level fault injection (the JAX package's chaos injector is
# its step-level twin): "drop:0.2;delay:0.5;error:0.05" makes every
# client RPC drop with p=0.2 (raises UNAVAILABLE before the wire), sleep
# 0.5 s, or fail with p=0.05 (INTERNAL), so retry/reconnect/recovery
# paths can be exercised deterministically (seed via
# DLROVER_TPU_CHAOS_NET_SEED).
CHAOS_NET_ENV = "DLROVER_TPU_CHAOS_NET"
CHAOS_NET_SEED_ENV = "DLROVER_TPU_CHAOS_NET_SEED"

_MAX_MESSAGE_BYTES = DefaultValues.GRPC_MAX_MESSAGE_MB * 1024 * 1024

_RETRY_POLICY = json.dumps({
    "methodConfig": [{
        "name": [{"service": SERVICE_NAME}],
        "retryPolicy": {
            "maxAttempts": 5,
            "initialBackoff": "0.2s",
            "maxBackoff": "3s",
            "backoffMultiplier": 2,
            "retryableStatusCodes": ["UNAVAILABLE"],
        },
    }]
})


def _identity(data: bytes) -> bytes:
    return data


def build_channel(addr: str) -> grpc.Channel:
    options = [
        ("grpc.max_send_message_length", _MAX_MESSAGE_BYTES),
        ("grpc.max_receive_message_length", _MAX_MESSAGE_BYTES),
        ("grpc.enable_retries", 1),
        ("grpc.service_config", _RETRY_POLICY),
    ]
    return grpc.insecure_channel(addr, options=options)


def addr_connectable(addr: str, timeout_s: float = 2.0) -> bool:
    host, _, port = addr.rpartition(":")
    try:
        with socket.create_connection((host or "127.0.0.1", int(port)),
                                      timeout=timeout_s):
            return True
    except OSError:
        return False


class InjectedRpcError(grpc.RpcError):
    """A client-side fault minted by the transport chaos layer. Shaped
    like a real grpc.RpcError (code()/details()) so retry and error
    classification paths cannot tell it from the genuine article."""

    def __init__(self, code: grpc.StatusCode, details: str):
        super().__init__()
        self._code = code
        self._details = details

    def code(self) -> grpc.StatusCode:
        return self._code

    def details(self) -> str:
        return self._details

    def __str__(self) -> str:
        return f"InjectedRpcError({self._code}, {self._details!r})"


@dataclasses.dataclass
class NetFaultSpec:
    drop: float = 0.0       # P(raise UNAVAILABLE before the wire)
    delay_s: float = 0.0    # added latency when the delay fault fires
    delay_p: float = 1.0    # P(delay fires) when delay_s > 0
    error: float = 0.0      # P(raise INTERNAL before the wire)


def parse_net_chaos(spec: str) -> NetFaultSpec:
    """Parse the CHAOS_NET grammar ("drop:P;delay:S[:P];error:P");
    raises ValueError on a bad spec — a chaos run with a typo'd fault
    must fail loudly, not run clean."""
    result = NetFaultSpec()
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        fields = part.split(":")
        kind = fields[0].strip().lower()
        try:
            if kind == "drop" and len(fields) == 2:
                result.drop = float(fields[1])
            elif kind == "delay" and len(fields) in (2, 3):
                result.delay_s = float(fields[1])
                if len(fields) == 3:
                    result.delay_p = float(fields[2])
            elif kind == "error" and len(fields) == 2:
                result.error = float(fields[1])
            else:
                raise ValueError(f"unknown net fault {kind!r}")
        except ValueError as e:
            raise ValueError(
                f"bad net chaos fault {part!r} (want "
                f"'drop:P', 'delay:S[:P]' or 'error:P'): {e}") from e
    for name, prob in (("drop", result.drop), ("delay", result.delay_p),
                       ("error", result.error)):
        if not 0.0 <= prob <= 1.0:
            raise ValueError(
                f"net chaos {name} probability {prob} outside [0, 1]")
    if result.delay_s < 0:
        raise ValueError(f"net chaos delay {result.delay_s} is negative")
    return result


class TransportFaultInjector:
    """Applies a NetFaultSpec before each client RPC. One instance per
    stub; faults are decided by a private seeded RNG so a chaos run is
    reproducible. Injecting client-side (before gRPC's own channel
    retry policy can see the call) exercises OUR retry layer."""

    def __init__(self, spec: str, seed: Optional[int] = None):
        self._spec = parse_net_chaos(spec)
        self._rng = random.Random(seed)
        self.injected: Dict[str, int] = {"drop": 0, "delay": 0,
                                         "error": 0}

    @classmethod
    def from_env(cls) -> Optional["TransportFaultInjector"]:
        spec = os.environ.get(CHAOS_NET_ENV, "")
        if not spec:
            return None
        seed_raw = os.environ.get(CHAOS_NET_SEED_ENV, "")
        return cls(spec, seed=int(seed_raw) if seed_raw else None)

    def before_rpc(self, method: str) -> None:
        spec = self._spec
        if spec.delay_s > 0 and self._rng.random() < spec.delay_p:
            self.injected["delay"] += 1
            time.sleep(spec.delay_s)
        if spec.drop > 0 and self._rng.random() < spec.drop:
            self.injected["drop"] += 1
            raise InjectedRpcError(
                grpc.StatusCode.UNAVAILABLE,
                f"chaos-net dropped {method}")
        if spec.error > 0 and self._rng.random() < spec.error:
            self.injected["error"] += 1
            raise InjectedRpcError(
                grpc.StatusCode.INTERNAL,
                f"chaos-net errored {method}")


class MasterStub:
    """Client-side stub over the generic channel."""

    def __init__(self, channel: grpc.Channel,
                 fault_injector: Optional[TransportFaultInjector] = None):
        self._get = channel.unary_unary(
            GET_METHOD, request_serializer=_identity,
            response_deserializer=_identity,
        )
        self._report = channel.unary_unary(
            REPORT_METHOD, request_serializer=_identity,
            response_deserializer=_identity,
        )
        # env-armed unless an explicit injector was handed in (tests);
        # None when CHAOS_NET is unset — zero cost on the happy path
        self._fault_injector = (fault_injector
                                if fault_injector is not None
                                else TransportFaultInjector.from_env())

    def get(self, payload: bytes, timeout: Optional[float] = None) -> bytes:
        if self._fault_injector is not None:
            self._fault_injector.before_rpc("get")
        return self._get(payload, timeout=timeout, wait_for_ready=True)

    def report(self, payload: bytes,
               timeout: Optional[float] = None) -> bytes:
        if self._fault_injector is not None:
            self._fault_injector.before_rpc("report")
        return self._report(payload, timeout=timeout, wait_for_ready=True)


def build_server(
    get_fn: Callable[[bytes, grpc.ServicerContext], bytes],
    report_fn: Callable[[bytes, grpc.ServicerContext], bytes],
    port: int = 0,
    host: str = "0.0.0.0",
    max_workers: int = 64,
) -> Tuple[grpc.Server, int]:
    """Register the 2 methods and bind; returns (server, bound_port)."""
    handlers = {
        "get": grpc.unary_unary_rpc_method_handler(
            get_fn, request_deserializer=_identity,
            response_serializer=_identity,
        ),
        "report": grpc.unary_unary_rpc_method_handler(
            report_fn, request_deserializer=_identity,
            response_serializer=_identity,
        ),
    }
    generic = grpc.method_handlers_generic_handler(SERVICE_NAME, handlers)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[
            ("grpc.max_send_message_length", _MAX_MESSAGE_BYTES),
            ("grpc.max_receive_message_length", _MAX_MESSAGE_BYTES),
        ],
    )
    server.add_generic_rpc_handlers((generic,))
    bound_port = server.add_insecure_port(f"{host}:{port}")
    if bound_port == 0:
        raise RuntimeError(f"cannot bind master port {port}")
    return server, bound_port


def local_ip() -> str:
    """This host's address by its name, falling back to the loopback
    address. Unlike the JAX package's copy it sends no route probe
    towards an outside address."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def find_free_port() -> int:
    sock = socket.socket()
    sock.bind(("", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port
