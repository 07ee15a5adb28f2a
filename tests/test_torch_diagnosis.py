"""The port's diagnosis engine (``dlrover_tpu_torch/master/diagnosis/``)
against the JAX package's: each of the rules gives the same reports and
actions in the same order over the same sequence of snapshots (the solo
rank's ``critical_path`` among them), ``parse_action`` agrees, and the
manager keeps the same queues, cooldowns, eviction and exported state
under one fake clock."""

import time

import pytest

from dlrover_tpu.common import messages as J
from dlrover_tpu.common.config import Context as JContext
from dlrover_tpu.master.diagnosis import manager as jmanager
from dlrover_tpu.master.diagnosis import rules as jrules
from dlrover_tpu.master.speed_monitor import WorkerSpeed as JSpeed
from dlrover_tpu_torch.common import messages as T
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.master.diagnosis import manager as tmanager
from dlrover_tpu_torch.master.diagnosis import rules as trules
from dlrover_tpu_torch.master.speed_monitor import WorkerSpeed as TSpeed

T0 = 1.7e9


@pytest.fixture
def contexts(monkeypatch):
    for key, value in {"DLROVER_TPU_GOODPUT_ALERT_THRESHOLD": "0.6",
                       "DLROVER_TPU_DIAGNOSIS_ACTION_COOLDOWN_S": "60"}.items():
        monkeypatch.setenv(key, value)
    JContext.reset()
    Context.reset()
    yield JContext.singleton(), Context.singleton()
    JContext.reset()
    Context.reset()


def _speeds(cls, table):
    return {w: cls(worker_id=w, samples=n, mean_step_time_s=t,
                   data_wait_fraction=dw, mfu=m, step=10)
            for w, (n, t, dw, m) in table.items()}


def _chips(used, total, peak=-1.0):
    chip = {"index": 0, "duty_cycle_pct": -1.0, "hbm_used_mb": used,
            "hbm_total_mb": total}
    if peak >= 0:
        chip["hbm_peak_mb"] = peak
    return {"cpu_percent": 1.0, "memory_mb": 2.0, "ts": T0,
            "chips": [chip]}


def _trace(by_rank, steps):
    return {"steps": steps, "by_rank": {
        str(r): {"gating_steps": n, "gating_s": 0.37 * n,
                 "phases": {"compute": 0.37 * n, "data_wait": 0.01 * n}}
        for r, n in by_rank.items()}}


# one snapshot a round: (worker table {id: (samples, mean_s, wait, mfu)},
# running/peak speed, running/peak mfu, workers, node stats, goodput,
# plan calibration, steptrace)
ROUNDS = [
    # a solo rank: it gates every traced step (critical_path flags it on
    # the second round), nothing to straggle against
    dict(w={0: (5, 0.365, 0.001, 0.35)}, speed=(2.7, 2.7),
         mfu=(0.35, 0.35), n=1, stats={0: _chips(19000.0, 81079.0)},
         trace=_trace({0: 5}, 5)),
    dict(w={0: (9, 0.365, 0.001, 0.35)}, speed=(2.7, 2.8),
         mfu=(0.35, 0.36), n=1,
         stats={0: _chips(19000.0, 81079.0, peak=51000.0)},
         trace=_trace({0: 9}, 9)),
    # the throughput collapses (MFU signal), HBM rises past pressure
    dict(w={0: (20, 0.9, 0.001, 0.14)}, speed=(1.1, 2.8),
         mfu=(0.14, 0.36), n=1,
         stats={0: _chips(19000.0, 81079.0, peak=76000.0)},
         trace=_trace({0: 20}, 20)),
    # a world of three: rank 2 straggles, rank 1 starves on data; the
    # goodput window is covered and low; the plan regresses
    dict(w={0: (6, 0.36, 0.01, -1.0), 1: (6, 0.37, 0.7, -1.0),
            2: (6, 1.2, 0.0, -1.0)}, speed=(0.8, 2.8), mfu=(-1.0, -1.0),
         n=3, stats={0: _chips(19000.0, 81079.0), 1: {
             "ts": T0, "chips": [], "hbm_peak_mb": 78000.0}},
         goodput={"window_s": 600.0, "elapsed_rank_seconds": 1500.0,
                  "goodput_fraction": 0.4, "dominant_badput": "restore",
                  "dominant_badput_s": 300.0, "buckets": {"restore": 300.0}},
         plan={"signature": "a", "predicted_step_s": 0.2,
               "measured_step_s": 0.5, "samples": 5, "mesh": {"data": 3}},
         trace=_trace({0: 2, 2: 10, 1: 0}, 12)),
    dict(w={0: (7, 0.36, 0.01, -1.0), 1: (7, 0.37, 0.7, -1.0),
            2: (7, 1.3, 0.0, -1.0)}, speed=(0.8, 2.8), mfu=(-1.0, -1.0),
         n=3, stats={}, goodput={"window_s": 600.0,
                                 "elapsed_rank_seconds": 1500.0,
                                 "goodput_fraction": 0.4},
         plan={"signature": "a", "predicted_step_s": 0.2,
               "measured_step_s": 0.5, "samples": 6},
         trace=_trace({2: 12}, 12)),
    dict(w={0: (8, 0.36, 0.01, -1.0), 1: (8, 0.37, 0.1, -1.0),
            2: (8, 1.3, 0.0, -1.0)}, speed=(2.7, 2.8), mfu=(-1.0, -1.0),
         n=3, stats={}, goodput={"window_s": 600.0,
                                 "elapsed_rank_seconds": 1500.0,
                                 "goodput_fraction": 0.8},
         plan={"signature": "a", "predicted_step_s": 0.2,
               "measured_step_s": 0.5, "samples": 7},
         trace=_trace({2: 12}, 12)),
    # rank 2 recovers and leaves the critical path; a new plan
    dict(w={0: (9, 0.36, 0.01, -1.0), 1: (9, 0.37, 0.1, -1.0),
            2: (9, 0.38, 0.0, -1.0)}, speed=(2.7, 2.8), mfu=(-1.0, -1.0),
         n=3, stats={}, plan={"signature": "b", "predicted_step_s": 0.4,
                              "measured_step_s": 0.41, "samples": 4},
         trace=_trace({0: 6, 1: 6}, 12)),
    dict(w={0: (9, 0.36, 0.01, -1.0), 1: (9, 0.37, 0.1, -1.0),
            2: (9, 0.38, 0.0, -1.0)}, speed=(2.7, 2.8), mfu=(-1.0, -1.0),
         n=3, stats={}, trace=_trace({0: 6, 1: 6}, 12)),
    # rank 2 departed
    dict(w={0: (9, 0.36, 0.01, -1.0), 1: (9, 0.37, 0.1, -1.0)},
         speed=(2.7, 2.8), mfu=(-1.0, -1.0), n=2, stats={},
         trace=_trace({0: 6, 1: 6}, 12)),
]


def _snapshot(module, speed_cls, i, rnd):
    return module.DiagnosisSnapshot(
        ts=T0 + i, worker_speeds=_speeds(speed_cls, rnd["w"]),
        running_speed=rnd["speed"][0], peak_speed=rnd["speed"][1],
        running_workers=rnd["n"], node_stats=rnd["stats"],
        running_mfu=rnd["mfu"][0], peak_mfu=rnd["mfu"][1],
        goodput=rnd.get("goodput"), plan_calibration=rnd.get("plan"),
        steptrace=rnd.get("trace"))


def test_every_rule_concludes_alike(contexts):
    runs = []
    for module, speed_cls, ctx in ((jrules, JSpeed, contexts[0]),
                                   (trules, TSpeed, contexts[1])):
        rules = module.default_rules()
        out = []
        for i, rnd in enumerate(ROUNDS):
            snap = _snapshot(module, speed_cls, i, rnd)
            for rule in rules:
                out.append((rule.name, [r.to_dict()
                                        for r in rule.evaluate(snap, ctx)]))
        runs.append(out)
    assert [n for n, _ in runs[1]] == [n for n, _ in runs[0]]
    assert runs[1] == runs[0]
    fired = {(r["rule"], r["severity"], tuple(r["actions"]))
             for _, reports in runs[1] for r in reports}
    # every rule spoke at least once, the solo rank's profile first
    assert {name for name, _, _ in fired} == {
        "straggler", "critical_path", "data_pipeline_bound",
        "throughput_collapse", "hbm_pressure", "plan_regression",
        "goodput"}
    first = next(r for _, reports in runs[1] for r in reports)
    assert (first["rule"], first["worker_id"], first["actions"]) == (
        "critical_path", 0, ["profile:0", "alert"])
    assert ("throughput_collapse", "critical", ("alert",)) in fired
    # the report round-trips through its dict
    report = trules.DiagnosisReport.from_dict(first)
    assert report.to_dict() == first


@pytest.mark.parametrize("action", [
    "profile:3", "restart:0", "checkpoint:1", "drain:2", "alert",
    "observe", "PROFILE: 4", "reboot:1", "profile:x", ""])
def test_parse_action_matches_jax(action):
    assert trules.parse_action(action) == jrules.parse_action(action)


class _Speeds:
    """The SpeedMonitor surface the manager reads, over one table."""

    def __init__(self, speed_cls):
        self.speed_cls = speed_cls
        self.table = {}
        self.num_running_workers = 0
        self.speed = (0.0, 0.0)
        self.mfu = (-1.0, -1.0)

    def worker_speeds(self):
        return _speeds(self.speed_cls, self.table)

    def running_speed(self):
        return self.speed[0]

    def peak_speed(self):
        return self.speed[1]

    def running_mfu(self):
        return self.mfu[0]

    def peak_mfu(self):
        return self.mfu[1]


class _Trace:
    def __init__(self):
        self.value = None

    def summary(self):
        return self.value


def _resource(messages, rank, used, total, peak=None):
    chip = dict(index=0, hbm_used_mb=used, hbm_total_mb=total)
    if peak is not None:
        chip["hbm_peak_mb"] = peak
    return messages.NodeResourceStats(
        node_id=rank + 10, node_rank=rank, node_type="worker",
        cpu_percent=5.0, memory_mb=100.0,
        chip_stats=[messages.ChipStats(**chip)])


def _rounds(manager, clock, out, n, dt=2.0):
    for _ in range(n):
        clock.t += dt
        out.append([r.to_dict() for r in manager.diagnose_once()])


def _drive(manager, speeds, trace, messages, clock):
    """One script against a manager; returns what it observed."""
    out = []
    speeds.table = {0: (5, 0.365, 0.001, 0.35), 1: (5, 0.37, 0.001, 0.35)}
    speeds.num_running_workers = 2
    speeds.speed, speeds.mfu = (2.7, 2.7), (0.35, 0.35)
    manager.observe_resource_stats(_resource(messages, 0, 19000.0,
                                             81079.0))
    manager.observe_step_watermark(0, 51000.0)
    manager.observe_step_watermark(0, -1.0)        # no evidence: dropped
    # rank 0 gates: flagged on the second round, profile:0 queued
    trace.value = _trace({0: 5}, 5)
    _rounds(manager, clock, out, 3)
    out.append(manager.poll_actions(0))
    # rank 1 gates instead (rank 0 leaves the critical path), then rank
    # 0 again: flagged anew, but its profile falls in the cooldown
    trace.value = _trace({1: 12}, 12)
    _rounds(manager, clock, out, 2)
    trace.value = _trace({0: 12}, 12)
    _rounds(manager, clock, out, 2)
    out.append(manager.pending_action_counts())
    out.append(manager.poll_actions(1))
    # past the cooldown the same cycle queues a second profile:0
    clock.t += 60.0
    trace.value = _trace({1: 12}, 12)
    _rounds(manager, clock, out, 1)
    trace.value = _trace({0: 12}, 12)
    _rounds(manager, clock, out, 2)
    out.append(manager.poll_actions(0))
    # a world of three; a drain's urgent fan-out bypasses the cooldown
    speeds.table = {0: (6, 0.36, 0.01, -1.0), 1: (6, 0.37, 0.7, -1.0),
                    2: (6, 1.2, 0.0, -1.0)}
    speeds.num_running_workers = 3
    manager.observe_resource_stats(_resource(messages, 2, 79000.0,
                                             81079.0, peak=80000.0))
    out.append(manager.request_checkpoint([0, 2], T0 + 500.0,
                                          reason="peer rank 1 draining"))
    manager.observe_drain_notice(1, clock.t + 60.0, "spot")
    manager.observe_worker_exit(1, "drained", detail="exit 76")
    manager.observe_worker_exit(2, "hang")
    _rounds(manager, clock, out, 2)
    out.append(manager.pending_action_counts())
    manager.evict_workers([0, 1])
    out.append(manager.pending_action_counts())
    out.append(manager.poll_actions(0))
    out.append(manager.poll_actions(2))
    out.append(manager.reports(limit=3))
    out.append(manager.snapshot().node_stats)
    state = manager.export_state()
    out.append(state)
    manager.restore_state(state)
    out.append(manager.export_state())
    out.append(manager.pending_action_counts())
    out.append(manager.reports_to_json(manager.reports(limit=1)))
    return out


def test_manager_queues_cooldown_eviction_and_state(contexts, monkeypatch):
    """The JAX manager reads ``time.time``, patched to the fake clock;
    the port's is given it."""
    clock = type("Clock", (), {"t": T0, "__call__": lambda self: self.t})()
    monkeypatch.setattr(time, "time", clock)
    runs = []
    for module, speed_cls, messages in ((jmanager, JSpeed, J),
                                        (tmanager, TSpeed, T)):
        clock.t = T0
        speeds, trace = _Speeds(speed_cls), _Trace()
        kwargs = {"clock": clock} if module is tmanager else {}
        manager = module.DiagnosisManager(speeds, steptrace=trace,
                                          **kwargs)
        runs.append(_drive(manager, speeds, trace, messages, clock))
    assert runs[1] == runs[0]
    polls = [[a["kind"] + ":" + str(a["rank"]) for a in item]
             for item in runs[1]
             if isinstance(item, list) and item and isinstance(item[0], dict)
             and "kind" in item[0]]
    # one profile of rank 0, one of rank 1, none for rank 0 inside the
    # cooldown, a second once past it, then the urgent checkpoint (rank
    # 2's queue left with rank 2)
    assert polls == [["profile:0"], ["profile:1"], ["profile:0"],
                     ["checkpoint:0"]]
    # the slice-unit drain (slice mode) queues a save-and-exit action a
    # rank, as the JAX manager's does
    port_dm = tmanager.DiagnosisManager(_Speeds(TSpeed))
    assert port_dm.request_drain([0, 1], T0, reason="slice 0") == [0, 1]
    assert [a["kind"] for a in port_dm.poll_actions(1)] == ["drain"]
