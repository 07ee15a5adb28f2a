"""Dependency-free metrics registry with Prometheus text exposition.

Own copy of the JAX package's ``obs/metrics.py``: thread-safe Counter /
Gauge / Histogram families with labels and a process-wide default
registry, rendered in the Prometheus text format 0.0.4, and the small
HTTP exporter the master serves ``/metrics`` from
(``start_http_exporter``, started by ``JobMaster.prepare``).

stdlib-only: the agent and worker import it without torch.
"""

from __future__ import annotations

import bisect
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Sequence, Tuple

# Wide span: sub-ms lock waits up to multi-minute restores/compiles.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)

# Prometheus naming rules. Enforced at family creation: names and label
# KEYS are interpolated verbatim into the exposition (only label VALUES
# are escaped), so one bad name — e.g. replayed from a remote
# TelemetryReport — would otherwise break every subsequent scrape of the
# whole endpoint.
_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _fmt(value: float) -> str:
    """Prometheus number formatting: integers without the trailing .0.
    NaN must render (as 'NaN'), not raise — one poisoned gauge value
    must not take down every subsequent scrape."""
    if value != value:
        return "NaN"
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    as_int = int(value)
    return str(as_int) if as_int == value else repr(value)


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _render_labels(names: Sequence[str], values: Sequence[str],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Child:
    """One labeled time series of a family."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._fn = None

    def set_function(self, fn: Callable[[], float]) -> None:
        """Collect-time callback (e.g. a SpeedMonitor query); wins over
        any stored value until `set` is called again."""
        with self._lock:
            self._fn = fn

    def get(self) -> float:
        with self._lock:
            fn = self._fn
            value = self._value
        if fn is not None:
            try:
                return float(fn())
            except Exception:  # noqa: BLE001 — scrape must not break
                return value
        return value


class _HistogramChild:
    def __init__(self, lock: threading.Lock, buckets: Sequence[float]):
        self._lock = lock
        self._buckets = tuple(buckets)
        self._counts = [0] * (len(self._buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            # per-bucket counts; render() cumulates. bisect_left finds the
            # first bound >= value (le-bucket semantics); past the last
            # bound it lands on the +Inf slot.
            self._counts[bisect.bisect_left(self._buckets, value)] += 1

    def snapshot(self) -> Tuple[Tuple[float, ...], Tuple[int, ...],
                                float, int]:
        with self._lock:
            return (self._buckets, tuple(self._counts), self._sum,
                    self._count)


class _Family:
    """A named metric family: children keyed by label values."""

    def __init__(self, name: str, help_text: str, kind: str,
                 labelnames: Sequence[str],
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        for label in labelnames:
            if not _LABEL_NAME_RE.match(label):
                raise ValueError(
                    f"{name}: invalid label name {label!r}")
        self.name = name
        self.help = help_text
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        if self.kind == "histogram":
            return _HistogramChild(self._lock, self._buckets)
        return _Child(self._lock)

    def labels(self, **labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
        return child

    def remove(self, **labels) -> bool:
        """Drop one labeled child (e.g. a per-worker gauge after the
        worker left the job — a stale series would keep ranking a dead
        rank in every scrape). Returns whether a child was removed."""
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            return self._children.pop(key, None) is not None

    # unlabeled conveniences -------------------------------------------
    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; use .labels()")
        with self._lock:
            return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default().set_function(fn)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def get(self) -> float:
        return self._default().get()

    # rendering --------------------------------------------------------
    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            children = sorted(self._children.items())
        for key, child in children:
            if self.kind == "histogram":
                buckets, counts, total, count = child.snapshot()
                cumulative = 0
                for bound, n in zip(buckets + (float("inf"),), counts):
                    cumulative += n
                    labels = _render_labels(
                        self.labelnames, key, (("le", _fmt(bound)),))
                    lines.append(
                        f"{self.name}_bucket{labels} {cumulative}")
                labels = _render_labels(self.labelnames, key)
                lines.append(f"{self.name}_sum{labels} {_fmt(total)}")
                lines.append(f"{self.name}_count{labels} {count}")
            else:
                labels = _render_labels(self.labelnames, key)
                lines.append(f"{self.name}{labels} {_fmt(child.get())}")
        return "\n".join(lines)


class MetricsRegistry:
    """Thread-safe named registry; get-or-create per family."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, name: str, help_text: str, kind: str,
                       labelnames: Sequence[str],
                       buckets: Sequence[float] = DEFAULT_BUCKETS
                       ) -> _Family:
        with self._lock:
            family = self._families.get(name)
            if family is None:
                family = _Family(name, help_text, kind, labelnames,
                                 buckets)
                self._families[name] = family
            elif family.kind != kind or family.labelnames != tuple(
                    labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered as {kind}"
                    f"{tuple(labelnames)} (was {family.kind}"
                    f"{family.labelnames})")
            return family

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._get_or_create(name, help_text, "counter", labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._get_or_create(name, help_text, "gauge", labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._get_or_create(name, help_text, "histogram",
                                   labelnames, buckets)

    def render(self) -> str:
        with self._lock:
            families = sorted(self._families.values(),
                              key=lambda f: f.name)
        return "\n".join(f.render() for f in families) + "\n"

    def sample_values(self, prefixes: Sequence[str] = ()
                      ) -> list:
        """Point-in-time (name, labels-dict, value) tuples for every
        gauge/counter child whose family name starts with one of
        ``prefixes`` (all scalar families when empty) — the time-series
        collector's read path (obs/tsdb.py). Histograms are excluded:
        their cumulative buckets are not a samplable scalar. Child
        ``get()`` runs OUTSIDE the family lock (collect-time gauge
        callbacks may themselves take component locks)."""
        wanted = tuple(prefixes)
        with self._lock:
            families = [f for f in self._families.values()
                        if f.kind in ("gauge", "counter")
                        and (not wanted or f.name.startswith(wanted))]
        out = []
        for family in families:
            with family._lock:
                children = list(family._children.items())
            for key, child in children:
                try:
                    value = child.get()
                except Exception:  # noqa: BLE001 — one bad callback
                    # must not break the whole sampling tick
                    continue
                out.append((family.name,
                            dict(zip(family.labelnames, key)), value))
        return out

    def reset(self) -> None:
        """Tests only: drop every family."""
        with self._lock:
            self._families.clear()


_default_lock = threading.Lock()
_default_registry: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry


# --------------------------------------------------------------------------
# HTTP exporter (master-side /metrics endpoint)
# --------------------------------------------------------------------------


class _MetricsHandler(BaseHTTPRequestHandler):
    registry: MetricsRegistry  # set on the subclass by start_http_exporter

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        body = self.registry.render().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrapes must not spam the job log
        pass


def start_http_exporter(registry: Optional[MetricsRegistry] = None,
                        host: str = "0.0.0.0", port: int = 0
                        ) -> Tuple[ThreadingHTTPServer, int]:
    """Serve ``registry.render()`` on http://host:port/metrics in a daemon
    thread; returns (server, bound_port). port=0 picks a free port."""
    registry = registry or get_registry()
    handler = type("BoundMetricsHandler", (_MetricsHandler,),
                   {"registry": registry})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="metrics-exporter")
    thread.start()
    return server, server.server_address[1]
