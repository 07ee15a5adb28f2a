"""The port's telemetry primitives (``dlrover_tpu_torch/obs``) against
the JAX package's on the same inputs: the metrics registry's exposition
text, span nesting and cross-process parenting, the flight recorder's
ring and dump, and the per-step timeline's windowed stats."""

import json

import numpy as np
import pytest

from dlrover_tpu.obs import flight_recorder as jfr
from dlrover_tpu.obs import metrics as jmetrics
from dlrover_tpu.obs import spans as jspans
from dlrover_tpu.obs import timeline as jtimeline
from dlrover_tpu_torch.obs import flight_recorder as tfr
from dlrover_tpu_torch.obs import metrics as tmetrics
from dlrover_tpu_torch.obs import spans as tspans
from dlrover_tpu_torch.obs import timeline as ttimeline


def _drive_registry(module, rng):
    registry = module.MetricsRegistry()
    steps = registry.counter("t_steps_total", "steps", labelnames=("rank",))
    speed = registry.gauge("t_speed", "tokens/s")
    latency = registry.histogram("t_latency_seconds", "latency",
                                 labelnames=("rpc",))
    for value in rng:
        steps.labels(rank=str(int(value * 10) % 3)).inc(value)
        speed.set(value * 1e4)
        latency.labels(rpc="get" if value > 0.5 else "report").observe(
            value * 3)
    registry.gauge("t_lazy", "a gauge read at render").set_function(
        lambda: 42.0)
    steps.remove(rank="0")
    return registry


def test_metrics_registry_renders_the_same_text():
    values = np.random.default_rng(0).random(40).tolist()
    want = _drive_registry(jmetrics, values).render()
    got = _drive_registry(tmetrics, values).render()
    assert got == want and "t_latency_seconds_bucket" in got
    registry = tmetrics.MetricsRegistry()
    with pytest.raises(ValueError):
        registry.counter("t_x", labelnames=("a",)).inc(-1)


def _span_tree(module):
    """Nested spans, an explicit record and a remote parent; returns
    what the sink saw as (name, parent name, status, attrs)."""
    seen = []
    module.add_span_sink(seen.append)
    try:
        with module.span("outer", {"k": 1}) as outer:
            outer.set_attr("round", 3)
            with module.span("inner"):
                remote = module.current_context()
            module.record_span("recorded", 0.25, attrs={"x": "y"})
        with pytest.raises(RuntimeError):
            with module.span("failing"):
                raise RuntimeError("boom")
        with module.span("child_of_remote", parent=remote):
            pass
    finally:
        module.remove_span_sink(seen.append)
    names = {s.span_id: s.name for s in seen}
    tree = [(s.name, names.get(s.parent_id), s.status, s.attrs)
            for s in seen]
    return tree, remote, seen


def test_spans_nest_and_parent_alike():
    jtree, jremote, _ = _span_tree(jspans)
    ttree, tremote, tseen = _span_tree(tspans)
    assert ttree == jtree
    assert set(tremote) == set(jremote)
    # a context minted by either package parents the other's span
    with tspans.span("port_child", parent=jremote) as child:
        pass
    assert child.trace_id == jremote["trace_id"]
    assert child.parent_id == jremote["span_id"]
    assert tseen[-1].trace_id == tremote["trace_id"]


def _drive_recorder(module, tmp_path, name):
    recorder = module.FlightRecorder(capacity=4, role="agent",
                                     dump_dir=str(tmp_path / name))
    for i in range(6):
        recorder.record_event("worker_spawn", round=i, world=[0])
    span = {"kind": "span", "name": "rendezvous", "span_id": "s1",
            "ts": 1.0}
    assert recorder.record_span(dict(span))
    assert not recorder.record_span(dict(span))
    path = recorder.dump(reason="agent-exit")
    with open(path) as f:
        payload = json.load(f)
    assert recorder.last_dump_path == path
    for volatile in ("pid", "host", "dumped_at"):
        payload.pop(volatile)
    for event in payload["events"]:
        event.pop("ts"), event.pop("pid", None)
    return payload, path.rsplit("/", 1)[1]


def test_flight_recorder_ring_and_dump_match(tmp_path):
    want, want_name = _drive_recorder(jfr, tmp_path, "jax")
    got, got_name = _drive_recorder(tfr, tmp_path, "port")
    assert got == want and got_name == want_name
    assert [e["attrs"]["round"] for e in got["events"]
            if e["kind"] == "event"] == [3, 4, 5]


def test_step_timeline_stats_match():
    rng = np.random.default_rng(1)
    timelines = (jtimeline.StepTimeline(capacity=8, rank=2),
                 ttimeline.StepTimeline(capacity=8))
    for step in range(1, 12):
        compute, wait = rng.random(2).tolist()
        for timeline in timelines:
            timeline.record(step, compute + wait + 0.01 * step,
                            data_wait=wait, compute=compute)
    for last_n in (0, 1, 3, 20):
        assert (timelines[1].window_stats(last_n)
                == timelines[0].window_stats(last_n))
    assert timelines[1].snapshot() == timelines[0].snapshot()
    assert len(timelines[1].snapshot()) == 8
    empty = ttimeline.StepTimeline().window_stats()
    assert empty == jtimeline.StepTimeline().window_stats()


def test_timeline_export_and_load_match(tmp_path):
    """The export the agent reads for forward progress: each package's
    file loads in the other's reader with the same payload."""
    timelines = (jtimeline.StepTimeline(capacity=8, rank=2),
                 ttimeline.StepTimeline(capacity=8, rank=2))
    for step in range(1, 6):
        for timeline in timelines:
            timeline.record(step, 0.5 + step, data_wait=0.25, compute=0.5)
    payloads = []
    for name, timeline in zip(("jax", "port"), timelines):
        path = str(tmp_path / f"{name}.json")
        assert timeline.export(path, last_n=3)
        loaded = (jtimeline.load_timeline(path),
                  ttimeline.load_timeline(path))
        assert loaded[1] == loaded[0]
        payload = dict(loaded[1])
        assert payload.pop("exported_at") > 0
        payloads.append(payload)
    assert payloads[1] == payloads[0]
    assert [s["step"] for s in payloads[1]["steps"]] == [3, 4, 5]
    assert payloads[1]["role"] == "worker" and payloads[1]["rank"] == 2
    (tmp_path / "torn.json").write_text('{"steps": [')
    for module in (jtimeline, ttimeline):
        assert module.load_timeline(str(tmp_path / "torn.json")) is None
        assert module.load_timeline(str(tmp_path / "absent.json")) is None
    assert not timelines[1].export(str(tmp_path / "no" / "dir.json"))


class _Client:
    def __init__(self, fail=False):
        self.batches, self.fail = [], fail

    def report_telemetry(self, spans=None):
        if self.fail:
            raise RuntimeError("master down")
        self.batches.append(spans)


def test_span_exporter_matches():
    """Bounded batches of finished spans for the master: the same
    drops, drains and flushes as the JAX exporter; a dead master loses
    the batch, never the caller."""
    results = []
    for spans in (jspans, tspans):
        exporter = spans.SpanExporter(capacity=3)
        spans.add_span_sink(exporter)
        try:
            for i in range(5):
                with spans.span(f"s{i}", {"i": i}):
                    pass
        finally:
            spans.remove_span_sink(exporter)
        client, dead = _Client(), _Client(fail=True)
        names = [r["name"] for r in exporter.drain()]
        exporter(spans.record_span("late", 0.5))
        exporter.flush_to(dead)
        exporter(spans.record_span("later", 0.25))
        exporter.flush_to(client)
        exporter.flush_to(client)          # nothing left: no RPC
        results.append((names, exporter.dropped,
                        [[r["name"] for r in b] for b in client.batches]))
    assert results[1] == results[0] == (["s2", "s3", "s4"], 2, [["later"]])
