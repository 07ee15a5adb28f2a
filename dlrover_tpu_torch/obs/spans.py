"""Lifecycle spans: explicit begin/end timing with parent propagation.

The elastic paths (rendezvous, scale decisions, re-lower/compile,
checkpoint save/restore) only fire during elasticity — a sampling
profiler never sees them. Spans make them first-class: a `span(...)`
context manager times a named region, nests under the thread's current
span, and on completion fans out to registered sinks (the flight
recorder, the duration histogram, a publisher batching spans to the
master).

Cross-process parenting: `current_context()` serializes the active
span's identity into a small dict that travels inside a control-plane
message; the receiving side passes it as ``parent=`` so the master's
rendezvous span and the agent's join span share one trace.

Own copy of the JAX package's ``obs/spans.py``; stdlib-only (imported
by agent, worker and master alike).
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed region. Create via the `span(...)` context manager."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_ts",
                 "end_ts", "duration_s", "attrs", "status", "pid",
                 "_start_mono")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str = "",
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ts = time.time()
        self.end_ts = 0.0
        self.duration_s = 0.0
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.status = "ok"
        self.pid = os.getpid()
        self._start_mono = time.monotonic()

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def finish(self, status: str = "ok") -> None:
        self.end_ts = time.time()
        self.duration_s = time.monotonic() - self._start_mono
        self.status = status

    def context(self) -> Dict[str, str]:
        """The propagation payload a child (possibly in another process)
        parents under."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": "span",
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "ts": self.start_ts,
            "end_ts": self.end_ts,
            "duration_s": round(self.duration_s, 6),
            "status": self.status,
            "pid": self.pid,
            "attrs": self.attrs,
        }


_tls = threading.local()

_sink_lock = threading.Lock()
_sinks: List[Callable[[Span], None]] = []


def add_span_sink(sink: Callable[[Span], None]) -> None:
    with _sink_lock:
        if sink not in _sinks:
            _sinks.append(sink)


def remove_span_sink(sink: Callable[[Span], None]) -> None:
    with _sink_lock:
        if sink in _sinks:
            _sinks.remove(sink)


def _dispatch(finished: Span) -> None:
    with _sink_lock:
        sinks = list(_sinks)
    for sink in sinks:
        try:
            sink(finished)
        except Exception:  # noqa: BLE001 — telemetry must never raise
            pass


def _stack() -> List[Span]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = []
        _tls.stack = stack
    return stack


def current_span() -> Optional[Span]:
    stack = _stack()
    return stack[-1] if stack else None


def current_context() -> Optional[Dict[str, str]]:
    """Serialized identity of the active span for cross-process
    propagation (None outside any span)."""
    active = current_span()
    return active.context() if active else None


def _resolve_parent(parent: Optional[Dict[str, str]],
                    stack: List[Span]) -> tuple:
    """(trace_id, parent_id): explicit remote context wins, else the
    thread's current span, else a fresh trace."""
    if parent:
        return parent.get("trace_id") or _new_id(), parent.get(
            "span_id", "")
    if stack:
        return stack[-1].trace_id, stack[-1].span_id
    return _new_id(), ""


@contextmanager
def span(name: str, attrs: Optional[Dict[str, Any]] = None,
         parent: Optional[Dict[str, str]] = None):
    """Time a region. Nests under the thread's current span unless an
    explicit remote ``parent`` context (from `current_context()` on the
    other side) is given. An exception inside marks status="error" and
    re-raises."""
    stack = _stack()
    trace_id, parent_id = _resolve_parent(parent, stack)
    current = Span(name, trace_id, _new_id(), parent_id, attrs)
    stack.append(current)
    try:
        yield current
        current.finish("ok")
    except BaseException:
        current.finish("error")
        raise
    finally:
        stack.pop()
        _dispatch(current)


def record_span(name: str, duration_s: float,
                attrs: Optional[Dict[str, Any]] = None,
                parent: Optional[Dict[str, str]] = None,
                status: str = "ok") -> Span:
    """Record an already-measured region as a finished span (for paths
    that know their start retroactively, e.g. a rendezvous round timed
    from its first join)."""
    trace_id, parent_id = _resolve_parent(parent, _stack())
    finished = Span(name, trace_id, _new_id(), parent_id, attrs)
    now = time.time()
    finished.start_ts = now - duration_s
    finished.end_ts = now
    finished.duration_s = float(duration_s)
    finished.status = status
    _dispatch(finished)
    return finished


class SpanExporter:
    """A sink that batches finished spans for shipping to the master.

    Bounded: when more than ``capacity`` spans accumulate between
    flushes, the oldest are dropped (and counted): a wedged master must
    not grow worker memory."""

    def __init__(self, capacity: int = 512):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._spans: List[Dict[str, Any]] = []
        self._dropped = 0

    def __call__(self, finished: Span) -> None:
        with self._lock:
            self._spans.append(finished.to_dict())
            overflow = len(self._spans) - self._capacity
            if overflow > 0:
                del self._spans[:overflow]
                self._dropped += overflow

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            batch, self._spans = self._spans, []
            return batch

    def flush_to(self, client) -> None:
        """Drain and ship to the master through
        ``client.report_telemetry(spans=...)``. Telemetry is droppable by
        contract: every failure is swallowed (the batch is lost, the
        caller's work must never be)."""
        spans = self.drain()
        if not spans:
            return
        try:
            client.report_telemetry(spans=spans)
        except Exception:  # noqa: BLE001 — droppable by contract
            pass

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped
