"""The port's goodput ledger (``dlrover_tpu_torch/obs/goodput.py``)
against the JAX package's: one event stream under one fake clock gives
equal snapshots (windowed too) and equal ``render_snapshot`` text, a JAX
``export_state`` restores into the port's ledger, the span table
classifies alike, and a flight dump's spans rebuild the same snapshot."""

import pytest

from dlrover_tpu.obs import goodput as jgoodput
from dlrover_tpu.obs.metrics import MetricsRegistry as JRegistry
from dlrover_tpu_torch.obs import goodput as tgoodput
from dlrover_tpu_torch.obs.metrics import MetricsRegistry as TRegistry


class FakeClock:
    def __init__(self, start=1000.0):
        self.t = start

    def __call__(self):
        return self.t


def _span(name, duration, span_id, ts, **attrs):
    return {"kind": "span", "name": name, "span_id": span_id,
            "duration_s": duration, "ts": ts, "attrs": attrs}


# (op, args) against one ledger; "tick" advances the clock
STREAM = [
    ("observe_world", (0, 2)),
    ("observe_span", (_span("rendezvous", 1.5, "a", 1000.0), 0)),
    ("observe_span", (_span("rendezvous", 1.25, "b", 1000.0), 1)),
    ("observe_span", (_span("restore_or_init", 4.0, "c", 1001.5), 0)),
    ("observe_span", (_span("restore_or_init", 4.0, "c", 1001.5), 0)),
    ("observe_step_report", (0, 0, 0.0)),
    ("observe_step_report", (1, 0, 0.0)),
    ("tick", 10.0),
    ("observe_step_report", (0, 20, 0.4, 0.1, 0.35)),
    ("observe_step_report", (1, 20, 0.45, -1.0, 0.3)),
    ("observe_span", (_span("checkpoint_save", 0.4, "d", 1009.0), 0)),
    ("observe_span", (_span("recompile", 2.0, "e", 1009.0,
                            phase="aot"), 0)),
    ("observe_span", (_span("recompile", 2.0, "f", 1009.0,
                            phase="relower"), 1)),
    ("tick", 3.0),
    ("mark_draining", (1, 1043.0)),
    ("observe_span", (_span("emergency_checkpoint", 5.0, "g", 1014.0,
                            outcome="saved"), 1)),
    ("tick", 8.0),
    ("complete_drain", (1,)),
    ("observe_world", (1, 1)),
    ("tick", 5.0),
    ("observe_step_report", (0, 30, 0.4)),
    ("tick", 40.0),
    ("observe_hang", (0, 25.0)),
    ("observe_world", (2, 1)),
    ("note_elasticity_event", ("replan",)),
    ("observe_span", (_span("checkpoint_wait", 2.5, "h", 1064.0), 0)),
    ("tick", 4.0),
    ("observe_step_report", (0, 33, 0.4)),
    ("note_elasticity_event", ("worker_lost",)),
    ("evict", ([0],)),
    ("observe_world", (3, 1)),
    ("tick", 2.0),
]


def _play(module, registry_cls, stream=STREAM):
    clock = FakeClock()
    ledger = module.GoodputLedger(registry=registry_cls(), now_fn=clock)
    for op, args in stream:
        if op == "tick":
            clock.t += args
        else:
            getattr(ledger, op)(*args)
    return ledger, clock


def test_one_event_stream_gives_equal_snapshots_and_text():
    jledger, _ = _play(jgoodput, JRegistry)
    tledger, _ = _play(tgoodput, TRegistry)
    for window in (0.0, 30.0):
        want = jledger.snapshot(window_s=window)
        got = tledger.snapshot(window_s=window)
        assert got == want
        assert tgoodput.render_snapshot(got) == jgoodput.render_snapshot(
            want)
    snap = tledger.snapshot()
    # the stream reached every bucket the drain and hang paths feed
    for bucket in ("productive", "data_wait", "rendezvous", "restore",
                   "checkpoint_stall", "compile", "drain", "hang", "idle"):
        assert snap["buckets"][bucket] > 0, bucket
    assert snap["buckets"]["hang"] == pytest.approx(25.0)
    assert tledger.goodput_fraction() == jledger.goodput_fraction()
    assert [i["reason"] for i in snap["incarnations"]] == [
        "job_start", "drain", "hang_restart", "worker_lost"]
    assert tledger.export_state() == jledger.export_state()


def test_buckets_account_for_all_wall_clock():
    """As the JAX ledger's acceptance: productive and badput (idle
    derived) cover the elapsed rank-seconds."""
    tledger, _ = _play(tgoodput, TRegistry, STREAM[:14])
    snap = tledger.snapshot()
    covered = sum(snap["buckets"].values())
    assert covered >= 0.95 * snap["elapsed_rank_seconds"]


def test_jax_export_restores_into_the_port():
    jledger, clock = _play(jgoodput, JRegistry)
    state = jledger.export_state()
    tclock = FakeClock(clock.t)
    tledger = tgoodput.GoodputLedger(registry=TRegistry(), now_fn=tclock)
    tledger.restore_state(state)
    jrestored = jgoodput.GoodputLedger(registry=JRegistry(), now_fn=tclock)
    jrestored.restore_state(state)
    assert tledger.export_state() == jrestored.export_state() == state
    # and both go on alike after the failover
    for ledger in (tledger, jrestored):
        ledger.observe_step_report(0, 40, step_time_s=0.4)
    tclock.t += 3.0
    for ledger in (tledger, jrestored):
        ledger.observe_step_report(0, 45, step_time_s=0.4)
    assert tledger.snapshot() == jrestored.snapshot()


@pytest.mark.parametrize("name,attrs", [
    ("recompile", {"phase": "relower"}), ("recompile", {"phase": "aot"}),
    ("rendezvous", None), ("reconnect", {}), ("restore_or_init", None),
    ("checkpoint_wait", None), ("emergency_checkpoint", None),
    ("drain", None), ("checkpoint_save", None),
    ("checkpoint_restore", None), ("peer_stage", None), ("unknown", {}),
])
def test_span_classification_matches(name, attrs):
    assert tgoodput.classify_span(name, attrs) == jgoodput.classify_span(
        name, attrs)


def test_snapshot_from_flight_matches():
    spans = [args[0] for op, args in STREAM if op == "observe_span"]
    payload = {"events": spans + [{"kind": "event", "name": "other"}]}
    want = jgoodput.snapshot_from_flight(payload)
    got = tgoodput.snapshot_from_flight(payload)
    assert got["rebuilt_from_spans"] and want["rebuilt_from_spans"]

    def accrued(snap):
        # each rebuild runs on its ledger's real clock: compare what the
        # spans decide, not the idle residual
        return ({k: v for k, v in snap["buckets"].items() if k != "idle"},
                {rank: {k: v for k, v in row["buckets"].items()
                        if k != "idle"}
                 for rank, row in snap["per_rank"].items()})

    assert accrued(got) == accrued(want)
    assert accrued(got)[0]["checkpoint_stall"] == pytest.approx(7.5)
    snap = {"version": 1, "buckets": {"drain": 1.0}}
    recorded = {"events": [{"kind": "event", "name": "goodput",
                            "attrs": {"snapshot": snap}}]}
    assert tgoodput.snapshot_from_flight(recorded) == snap
    assert tgoodput.snapshot_from_flight({"events": []}) is None
