"""The port's step traces (``dlrover_tpu_torch/obs/steptrace.py`` and
``master/steptrace.py``) against the JAX package's: ``solve_group`` and
``summarize_solved`` give JSON-equal answers for the same records
(the cross-slice hop included), the assembler's payloads, tsdb series
and eviction agree, the recorder builds the same records, and
``ClockSync`` gives equal estimates for the same probe answers."""

import json

import numpy as np
import pytest

from dlrover_tpu.master import steptrace as jmaster
from dlrover_tpu.obs import steptrace as jobs
from dlrover_tpu.obs.metrics import MetricsRegistry as JRegistry
from dlrover_tpu.obs.tsdb import TimeSeriesStore as JStore
from dlrover_tpu_torch.master import steptrace as tmaster
from dlrover_tpu_torch.obs import steptrace as tobs
from dlrover_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from dlrover_tpu_torch.obs.tsdb import TimeSeriesStore as TStore

T0 = 1.7e9


def _records(seed: int, steps: int = 12, ranks: int = 4):
    """Seeded per-step records of a two-slice world: ranks 0-1 in slice
    0, 2-3 in slice 1; some steps' tails wait on the other slice (the
    hop), some records are malformed."""
    rng = np.random.default_rng(seed)
    out = []
    for gen in (0, 1):
        for step in range(steps):
            for rank in range(ranks):
                sid = rank // 2
                t0 = T0 + gen * 100 + step * 2.0 + rng.random() * 0.01
                data = float(rng.random() * 0.05)
                compute = float(0.5 + rng.random() * 0.2)
                phases = [["data_wait", 0.0, data],
                          ["compute", data, compute]]
                rec = {"v": 1, "step": step, "gen": gen, "slice": sid,
                       "rank": rank, "t0": t0,
                       "off": float(rng.normal(0, 0.002)),
                       "err": float(rng.random() * 0.001)}
                if step % 3 == 1 and sid == 0:
                    # slice 0 waited on slice 1's header
                    wait = float(0.8 + rng.random() * 0.2)
                    phases.append(["cross_slice_wait", data + compute,
                                   wait])
                    rec["peers"] = {"1": data + compute + wait}
                if step % 5 == 4:
                    phases.append(["checkpoint", 1.2, 0.3])
                rec["phases"] = phases
                out.append(rec)
    out.append({"step": "x", "phases": []})          # malformed
    out.append({"step": 3, "rank": -1, "phases": "no"})
    out.append("not a record")
    return out


def _groups(records):
    groups = {}
    for rec in records:
        if isinstance(rec, dict) and isinstance(rec.get("step"), int) \
                and isinstance(rec.get("phases"), list):
            groups.setdefault((rec["gen"], rec["step"]), {})[
                rec["rank"]] = rec
    return groups


@pytest.mark.parametrize("seed", [0, 7])
def test_solve_and_summarize_equal_jax(seed):
    groups = _groups(_records(seed))
    jsolved, tsolved = [], []
    for (gen, step), recs in sorted(groups.items()):
        want = jmaster.solve_group(gen, step, recs)
        got = tmaster.solve_group(gen, step, recs)
        assert json.dumps(got) == json.dumps(want)
        jsolved.append(want)
        tsolved.append(got)
    assert any(s["hopped"] for s in tsolved)     # the cross-slice hop
    assert json.dumps(tmaster.summarize_solved(tsolved)) == json.dumps(
        jmaster.summarize_solved(jsolved))
    assert tmaster.solve_group(0, 0, {}) == {}


def test_solo_rank_gates_every_step():
    recs = [{"step": n, "gen": 0, "rank": 0, "t0": T0 + n,
             "phases": [["compute", 0.0, 0.36]]} for n in range(1, 6)]
    solved = [tmaster.solve_group(0, r["step"], {0: r}) for r in recs]
    summary = tmaster.summarize_solved(solved)
    assert summary["by_rank"]["0"]["gating_steps"] == 5
    assert summary["dominant_gating_rank"] == 0
    assert summary == jmaster.summarize_solved(solved)


def test_assembler_payloads_tsdb_and_eviction_equal_jax():
    records = _records(3)
    runs = []
    for module, store_cls, registry_cls in (
            (jmaster, JStore, JRegistry), (tmaster, TStore, TRegistry)):
        clock = iter(range(10 ** 6)).__next__
        store = store_cls(clock=lambda c=clock: T0 + c())
        asm = module.StepTraceAssembler(tsdb=store,
                                        registry=registry_cls(),
                                        ring_steps=16, summary_window=8)
        accepted = [asm.ingest(records[i:i + 7], node_rank=5)
                    for i in range(0, len(records), 7)]
        payloads = [json.dumps(asm.query_payload()),
                    json.dumps(asm.query_payload(start_step=3, end_step=8)),
                    json.dumps(asm.query_payload(last_n=4)),
                    json.dumps(asm.summary()),
                    json.dumps(asm.flight_snapshot(last_n=3))]
        asm.evict(3)
        asm.evict_departed([0, 1])
        payloads.append(json.dumps(asm.query_payload()))
        runs.append((accepted, payloads, asm.stats(),
                     store.export_state()))
    assert runs[1] == runs[0]
    stats = runs[1][2]
    assert stats["groups"] == 16 and stats["dropped"] == 3


def test_recorder_and_clock_sync_equal_jax():
    """The same probe answers (a skewed master clock, asymmetric
    latency, a failure, a declined probe, a wall clock stepping back)
    give the same estimates, stats and stamped records."""
    answers = [(100.0, 0.010, 0.002), (100.5, 0.004, 0.004),
               ("raise", 0.0, 0.0), (0.0, 0.001, 0.001),
               (101.2, 0.020, 0.001), (101.3, -0.5, 0.0),
               (102.0, 0.001, 0.001)]
    runs = []
    for module in (jobs, tobs):
        wall = [T0]
        mono = [50.0]
        script = iter(answers)

        def probe():
            server, up, down = next(script)
            wall[0] += up
            mono[0] += abs(up)
            if server == "raise":
                raise RuntimeError("master down")
            out = T0 + server if server else 0.0
            wall[0] += down
            mono[0] += down
            return out

        sync = module.ClockSync(probe_fn=probe, wall=lambda: wall[0],
                                mono=lambda: mono[0], window=3)
        trace = [sync.estimate()]
        for _ in answers:
            trace.append(sync.probe())
            trace.append(sync.estimate())
            mono[0] += 10.0
        trace.append(sync.maybe_probe(30.0))
        trace.append(sync.stats())
        rec = module.StepTraceRecorder(capacity=3, rank=2, slice_id=1,
                                       clock_sync=sync)
        rec.set_identity(rank=4)
        for step in range(5):
            rec.record(step, 1, T0 + step,
                       [("data_wait", 0.0, 0.01), ("compute", 0.01, 0.3)],
                       peers={0: 0.25} if step % 2 else None)
        trace.append((rec.drain(), rec.dropped, rec.drain()))
        runs.append(trace)
    assert runs[1] == runs[0]
    # unaligned before the first probe; three records kept of five
    assert runs[1][0] == (0.0, -1.0)
    assert len(runs[1][-1][0]) == 3 and runs[1][-1][1] == 2


def test_phase_seconds_and_flush():
    rec = {"phases": [["compute", 0.0, 0.2], ["compute", 0.3, 0.1],
                      ["bad"], ["data_wait", 0.0, -1.0]]}
    assert tobs.phase_seconds(rec) == jobs.phase_seconds(rec)

    class Client:
        def __init__(self, fail):
            self.fail, self.sent = fail, []

        def report_telemetry(self, steptrace):
            if self.fail:
                raise RuntimeError("down")
            self.sent.append(steptrace)

    recorder = tobs.StepTraceRecorder()
    recorder.record(1, 0, T0, [("compute", 0.0, 0.1)])
    ok = Client(False)
    recorder.flush_to(ok)
    recorder.flush_to(ok)              # nothing new: no RPC
    assert len(ok.sent) == 1 and ok.sent[0][0]["err"] == -1.0
    recorder.record(2, 0, T0, [("compute", 0.0, 0.1)])
    recorder.flush_to(Client(True))     # droppable: swallowed
    assert recorder.drain() == []
