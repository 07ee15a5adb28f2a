"""Telemetry primitives: metrics registry, lifecycle spans and their
exporter to the master, flight recorder, per-step timeline, the goodput
ledger, and the MFU formula.

Own copy of the parts of the JAX package's ``obs/`` that the ported
master, agent and loop call. Importing the package wires the defaults:
every finished span is recorded into the process flight recorder and
observed into the ``dlrover_tpu_span_duration_seconds`` histogram.

Not ported yet (ROADMAP Queue A item 12): the time-series store,
steptrace, device telemetry, the profiler and the metrics HTTP
exporter.
"""

from __future__ import annotations

import threading

from dlrover_tpu_torch.obs import mfu
from dlrover_tpu_torch.obs.flight_recorder import (
    FLIGHT_DIR_ENV,
    FlightRecorder,
    get_flight_recorder,
)
from dlrover_tpu_torch.obs.goodput import (
    BADPUT_BUCKETS,
    BUCKETS,
    GoodputLedger,
    render_snapshot,
    snapshot_from_flight,
)
from dlrover_tpu_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    MetricsRegistry,
    get_registry,
)
from dlrover_tpu_torch.obs.spans import (
    Span,
    SpanExporter,
    add_span_sink,
    current_context,
    current_span,
    record_span,
    remove_span_sink,
    span,
)
from dlrover_tpu_torch.obs.timeline import StepTimeline, load_timeline

__all__ = [
    "BADPUT_BUCKETS",
    "BUCKETS",
    "DEFAULT_BUCKETS",
    "FLIGHT_DIR_ENV",
    "FlightRecorder",
    "GoodputLedger",
    "MetricsRegistry",
    "Span",
    "SpanExporter",
    "StepTimeline",
    "add_span_sink",
    "current_context",
    "current_span",
    "get_flight_recorder",
    "get_registry",
    "load_timeline",
    "mfu",
    "record_remote_spans",
    "record_span",
    "remove_span_sink",
    "render_snapshot",
    "snapshot_from_flight",
    "span",
]

_defaults_lock = threading.Lock()
_defaults_installed = False


def _flight_recorder_sink(finished: Span) -> None:
    get_flight_recorder().record_span(finished)


def _metrics_sink(finished: Span) -> None:
    get_registry().histogram(
        "dlrover_tpu_span_duration_seconds",
        "Duration of lifecycle spans by name",
        labelnames=("span",),
    ).labels(span=finished.name).observe(finished.duration_s)


def _install_defaults() -> None:
    global _defaults_installed
    with _defaults_lock:
        if _defaults_installed:
            return
        add_span_sink(_flight_recorder_sink)
        add_span_sink(_metrics_sink)
        _defaults_installed = True


_install_defaults()


def record_remote_spans(spans, registry: MetricsRegistry = None) -> None:
    """Ingest span dicts that arrived from another process (the
    telemetry path to the master): append them to the local flight
    recorder and feed the span-duration histogram, so the master's
    timeline and exposition cover the whole job. The recorder's span-id
    dedup gates the histogram too: a span recorded locally and relayed
    (a standalone run) counts once."""
    registry = registry or get_registry()
    recorder = get_flight_recorder()
    histogram = registry.histogram(
        "dlrover_tpu_span_duration_seconds",
        "Duration of lifecycle spans by name",
        labelnames=("span",),
    )
    for record in spans:
        if not isinstance(record, dict) or "name" not in record:
            continue
        if not recorder.record_span(record):
            continue
        try:
            histogram.labels(span=str(record["name"])).observe(
                float(record.get("duration_s", 0.0)))
        except (TypeError, ValueError):
            continue
