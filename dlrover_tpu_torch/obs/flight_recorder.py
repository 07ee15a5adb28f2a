"""Flight recorder: a bounded ring of recent spans/events per process.

A failover postmortem needs the *timeline* — worker died → rendezvous →
recompile → resume — not log archaeology across five processes. Every
process keeps the last N telemetry records in memory and dumps them to
JSON:

- on demand (`dump()`),
- on SIGTERM (the agent sends it before a membership-change restart),
- on an unhandled exception (excepthook chain).

Dumps land in ``$DLROVER_TPU_FLIGHT_DIR`` (default: the system temp
dir's ``dlrover-tpu-flight/``), named ``flight-<role>-<pid>.json``.

Records are plain dicts ({"kind": "span"|"event", "ts": ..., ...});
span records come from `obs.spans` via the default sink, event records
from `record_event` (worker spawn/exit, scale decisions, signals).

Own copy of the JAX package's ``obs/flight_recorder.py``; stdlib-only.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# env override for where dumps land (default: <tempdir>/dlrover-tpu-flight)
FLIGHT_DIR_ENV = "DLROVER_TPU_FLIGHT_DIR"
_DEFAULT_CAPACITY = 4096


def _context_capacities() -> tuple:
    """(event_ring, span_dedup_ring) from the Context knobs
    ``flight_ring_events`` / ``flight_ring_spans`` (env-overridable like
    every knob). obs/ stays importable without the config layer — any
    failure falls back to the historical 4096."""
    try:
        from dlrover_tpu_torch.common.config import Context

        ctx = Context.singleton()
        return (max(1, int(ctx.flight_ring_events)),
                max(1, int(ctx.flight_ring_spans)))
    except Exception:  # noqa: BLE001 — telemetry must never raise
        return _DEFAULT_CAPACITY, _DEFAULT_CAPACITY


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None, role: str = "",
                 dump_dir: str = "", span_capacity: Optional[int] = None):
        # REENTRANT: the SIGTERM handler records + dumps on the very
        # thread it interrupted, which may already hold this lock (every
        # span dispatch appends here) — a plain Lock would deadlock the
        # process in exactly the platform-termination window
        self._lock = threading.RLock()
        ctx_events, ctx_spans = _context_capacities()
        if capacity is None:
            capacity = ctx_events
        if span_capacity is None:
            # an explicit event capacity (tests sizing tiny rings) keeps
            # the historical behavior of sizing both rings together
            span_capacity = capacity if capacity != ctx_events else ctx_spans
        self._events: deque = deque(maxlen=max(1, capacity))
        # span ids already recorded: a standalone master+agent process
        # sees its own spans twice (local sink + telemetry relay)
        self._seen_span_ids: deque = deque(maxlen=max(1, span_capacity))
        self._seen_set: set = set()
        self._role = role or os.environ.get(
            "DLROVER_TPU_NODE_TYPE", "process")
        self._dump_dir = dump_dir
        self._prev_handlers: Dict[int, Any] = {}
        self._prev_excepthook = None
        self._last_dump_path = ""

    # -- recording ---------------------------------------------------------
    def record_event(self, name: str, **attrs: Any) -> None:
        self._append({"kind": "event", "name": name, "ts": time.time(),
                      "pid": os.getpid(), "attrs": attrs})

    def record_span(self, span) -> bool:
        """Accepts an `obs.spans.Span` or an already-serialized dict
        (spans arriving from another process). Re-deliveries of the same
        span id (local sink + telemetry relay in a standalone process)
        are dropped; returns whether the span was newly recorded."""
        record = span if isinstance(span, dict) else span.to_dict()
        span_id = record.get("span_id")
        with self._lock:
            if span_id:
                if span_id in self._seen_set:
                    return False
                if len(self._seen_span_ids) == self._seen_span_ids.maxlen:
                    self._seen_set.discard(self._seen_span_ids[0])
                self._seen_span_ids.append(span_id)
                self._seen_set.add(span_id)
            self._events.append(record)
            return True

    def _append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(record)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    # -- dumping -----------------------------------------------------------
    def _resolve_dir(self) -> str:
        import tempfile

        return (self._dump_dir or os.environ.get(FLIGHT_DIR_ENV, "")
                or os.path.join(tempfile.gettempdir(),
                                "dlrover-tpu-flight"))

    def dump(self, path: str = "", reason: str = "on-demand") -> str:
        """Write the ring to JSON; returns the path. Never raises (a
        crash-path dump failing must not mask the crash)."""
        try:
            if not path:
                directory = self._resolve_dir()
                os.makedirs(directory, exist_ok=True)
                path = os.path.join(
                    directory,
                    f"flight-{self._role}-{os.getpid()}.json")
            payload = {
                "version": 1,
                "role": self._role,
                "pid": os.getpid(),
                "host": socket.gethostname(),
                "reason": reason,
                "dumped_at": time.time(),
                "events": sorted(self.snapshot(),
                                 key=lambda e: e.get("ts", 0.0)),
            }
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, default=str)
            os.replace(tmp, path)
            with self._lock:
                self._last_dump_path = path
            return path
        except Exception:  # noqa: BLE001 — crash-path safety
            return ""

    @property
    def last_dump_path(self) -> str:
        with self._lock:
            return self._last_dump_path

    # -- crash / signal hooks ---------------------------------------------
    def install_signal_handlers(self, signals=(signal.SIGTERM,)) -> None:
        """Dump on the given signals, then chain the previous handler
        (the elastic loop's SIGTERM save handler keeps working). Only
        callable from the main thread (CPython signal contract)."""

        def _make(signum_captured):
            def _handler(signum, frame):
                self.record_event("signal", signum=signum_captured)
                self.dump(reason=f"signal-{signum_captured}")
                prev = self._prev_handlers.get(signum_captured)
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.SIG_DFL:
                    # re-raise with the default disposition so the
                    # process still dies the way the sender expects
                    signal.signal(signum_captured, signal.SIG_DFL)
                    os.kill(os.getpid(), signum_captured)
            return _handler

        for signum in signals:
            prev = signal.signal(signum, _make(signum))
            self._prev_handlers[signum] = prev

    def uninstall_signal_handlers(self) -> None:
        for signum, prev in self._prev_handlers.items():
            signal.signal(signum, prev)
        self._prev_handlers.clear()

    def install_excepthook(self) -> None:
        """Dump on an unhandled exception, then chain."""
        if self._prev_excepthook is not None:
            return
        prev = sys.excepthook

        def _hook(exc_type, exc, tb):
            self.record_event("unhandled_exception",
                              exc_type=exc_type.__name__,
                              message=str(exc)[:512])
            self.dump(reason="crash")
            prev(exc_type, exc, tb)

        self._prev_excepthook = prev
        sys.excepthook = _hook


_default_lock = threading.Lock()
_default_recorder: Optional[FlightRecorder] = None


def get_flight_recorder() -> FlightRecorder:
    """Per-process default recorder (created lazily)."""
    global _default_recorder
    with _default_lock:
        if _default_recorder is None:
            _default_recorder = FlightRecorder()
        return _default_recorder
