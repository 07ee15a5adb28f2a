"""Telemetry primitives: metrics registry, lifecycle spans and their
exporter to the master, flight recorder, per-step timeline, the goodput
ledger, the MFU formula, the time-series store, per-step traces, the
card's memory telemetry and the on-demand profiler.

Own copy of the parts of the JAX package's ``obs/`` that the ported
master, agent and loop call. Importing the package wires the defaults:
every finished span is recorded into the process flight recorder and
observed into the ``dlrover_tpu_span_duration_seconds`` histogram.
``start_http_exporter`` serves the registry on ``/metrics``.
"""

from __future__ import annotations

import threading

from dlrover_tpu_torch.obs import device, mfu
from dlrover_tpu_torch.obs.device import DeviceTelemetry
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
    start_http_exporter,
)
from dlrover_tpu_torch.obs.profiler import (
    ProfilerCapture,
    ProfilerSession,
    read_profile_result,
    write_profile_request,
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
from dlrover_tpu_torch.obs.steptrace import (
    TRACE_PHASES,
    ClockSync,
    StepTraceRecorder,
    phase_seconds,
)
from dlrover_tpu_torch.obs.timeline import StepTimeline, load_timeline
from dlrover_tpu_torch.obs.tsdb import (
    TimeSeriesSidecar,
    TimeSeriesStore,
    TsdbCollector,
)

__all__ = [
    "BADPUT_BUCKETS",
    "BUCKETS",
    "DEFAULT_BUCKETS",
    "FLIGHT_DIR_ENV",
    "TRACE_PHASES",
    "ClockSync",
    "DeviceTelemetry",
    "FlightRecorder",
    "GoodputLedger",
    "MetricsRegistry",
    "ProfilerCapture",
    "ProfilerSession",
    "Span",
    "SpanExporter",
    "StepTimeline",
    "StepTraceRecorder",
    "TimeSeriesSidecar",
    "TimeSeriesStore",
    "TsdbCollector",
    "add_span_sink",
    "current_context",
    "current_span",
    "device",
    "get_flight_recorder",
    "get_registry",
    "load_timeline",
    "mfu",
    "phase_seconds",
    "publish_node_stats",
    "read_profile_result",
    "record_remote_spans",
    "record_span",
    "remove_span_sink",
    "render_snapshot",
    "snapshot_from_flight",
    "span",
    "start_http_exporter",
    "write_profile_request",
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


def publish_node_stats(stats, registry: MetricsRegistry = None) -> None:
    """Per-node resource gauges from a NodeResourceStats-shaped object
    (node_id / node_type / cpu_percent / memory_mb / chip_stats). The
    single definition of these series — used by the agent's
    ResourceMonitor for its local registry and by the master servicer
    when the report arrives, so the two expositions cannot drift."""
    registry = registry or get_registry()
    # keyed by RANK when the sender provides one: node_id diverges from
    # rank after a relaunch, and every other per-worker series (the
    # servicer's step-report ingest, the diagnosis gauges) is
    # rank-keyed — a node_id key here would split one physical worker
    # into two dashboard rows the moment it relaunches
    rank = getattr(stats, "node_rank", -1)
    labels = {"node": str(rank if rank >= 0 else stats.node_id),
              "type": stats.node_type or "worker"}
    registry.gauge("dlrover_tpu_node_cpu_percent",
                   "Host CPU utilization reported by the agent",
                   labelnames=("node", "type")).labels(
        **labels).set(stats.cpu_percent)
    registry.gauge("dlrover_tpu_node_memory_mb",
                   "Host memory used reported by the agent",
                   labelnames=("node", "type")).labels(
        **labels).set(stats.memory_mb)
    if stats.chip_stats:
        # HBM series only when the backend actually reported memory
        # stats (any chip with a real total): a CPU backend's absent
        # memory_stats must not publish a forever-0 % series that
        # dashboards read as "plenty of headroom"
        if any(c.hbm_total_mb > 0 for c in stats.chip_stats):
            hbm = sum(c.hbm_used_mb for c in stats.chip_stats)
            registry.gauge("dlrover_tpu_node_hbm_used_mb",
                           "Sum of per-chip HBM in use",
                           labelnames=("node", "type")).labels(
                **labels).set(hbm)
            # the per-step peak watermark (obs/device.py via the chip
            # stats export): the transient IN-step peak, < 0 = unknown.
            # The export windows the lifetime-monotone counter (only a
            # RISE carries hbm_peak_mb), so a report without one means
            # the episode resolved — the gauge must follow the worst
            # current in-use instead of latching the old spike forever
            # (the series the time-series collector samples every tick)
            peaks = [c.hbm_peak_mb for c in stats.chip_stats
                     if getattr(c, "hbm_peak_mb", -1.0) >= 0.0]
            registry.gauge(
                "dlrover_tpu_node_hbm_peak_mb",
                "Worst per-chip HBM allocator peak watermark "
                "(in-step transient when it rose this window, else "
                "the worst current in-use)",
                labelnames=("node", "type")).labels(
                **labels).set(max(peaks) if peaks else
                              max(c.hbm_used_mb
                                  for c in stats.chip_stats))
        # duty < 0 is the "unknown" sentinel (agent/monitor.py
        # export_chip_stats only emits a value when it can derive the
        # proxy): averaging it in would fabricate utilization
        known = [c.duty_cycle_pct for c in stats.chip_stats
                 if c.duty_cycle_pct >= 0.0]
        if known:
            registry.gauge("dlrover_tpu_node_chip_duty_cycle_pct",
                           "Mean per-chip duty cycle",
                           labelnames=("node", "type")).labels(
                **labels).set(sum(known) / len(known))
