"""The port's fleet controller (dlrover_tpu_torch/brain/fleet_controller.py)
against the JAX package's, on the CPU.

Each scenario of tests/test_fleet_controller.py (claim economics,
hysteresis, cooldown, the hourly rate limit, the watchdog window,
rollback with quarantine and backoff, a market revocation, shed gating
and shed-never-on-one-slice) runs through both packages' controllers
under the same fakes and one fake clock: the decision sequences, the
status and the exported state are the same JSON. ``export_state``
restores across packages both ways. Then the whole loop on the port's
master: a chaos ``offer`` through the master's injector, a claim whose
grant joins a second node in one round, a chaos ``revoke`` and the
second node's drain, the ledger's ``autoscale`` and ``drain``
incarnations, the flight events, ``AutoscaleStatusRequest`` over the
wire and the snapshot's ``fleet_controller`` key.
"""

import json
import os
import time
import types

import pytest

from dlrover_tpu.brain import fleet_controller as jfc
from dlrover_tpu.common.config import Context as JContext
from dlrover_tpu_torch.brain import fleet_controller as tfc
from dlrover_tpu_torch.common.config import Context

JAX = types.SimpleNamespace(fc=jfc, Context=JContext)
PORT = types.SimpleNamespace(fc=tfc, Context=Context)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def now(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeLedger:
    def __init__(self, goodput=0.8):
        self.goodput = goodput
        self.incarnations = []
        self.noted = []

    def window_summary(self, window_s):
        return {"goodput_fraction": self.goodput}

    def snapshot(self, window_s=0.0):
        return {"incarnations": list(self.incarnations),
                "degraded_steps_total": 0}

    def note_elasticity_event(self, kind):
        self.noted.append(kind)


class FakeSteptrace:
    def __init__(self, gating_rank=-1, dcn_wait=-1.0):
        self.gating_rank = gating_rank
        self.dcn_wait = dcn_wait

    def summary(self):
        return {"dominant_gating_rank": self.gating_rank,
                "cross_slice_wait_fraction": self.dcn_wait,
                "dominant_gating_phase": "allreduce"}


class FakeRendezvous:
    def __init__(self, slice_map):
        self.slice_map = dict(slice_map)

    def slice_of(self, rank):
        return self.slice_map.get(rank, -1)

    def slice_members(self, sid):
        return [r for r, s in self.slice_map.items() if s == sid]


KNOBS = dict(
    autoscale_hysteresis_windows=1,
    autoscale_cooldown_s=0.0,
    autoscale_max_decisions_per_hour=100,
    autoscale_rollback_window_s=60.0,
    autoscale_rollback_drop_fraction=0.2,
    autoscale_quarantine_backoff_s=600.0,
    autoscale_claim_margin=1.2,
    autoscale_shed_wait_fraction=0.3,
)


@pytest.fixture(autouse=True)
def contexts():
    """Both packages' singletons at the scenarios' knobs, reset after."""
    for ctx_cls in (JContext, Context):
        ctx_cls.reset()
        ctx_cls.singleton().update(**KNOBS)
    yield
    JContext.reset()
    Context.reset()


def test_knobs_match_jax():
    names = [k for k in vars(JContext()) if k.startswith("autoscale_")]
    assert len(names) == 9
    for name in names + ["fleet_controller_enabled"]:
        assert getattr(Context(), name) == getattr(JContext(), name), name


def _knobs(**kw):
    for ctx_cls in (JContext, Context):
        ctx_cls.singleton().update(**kw)


class Run:
    """One controller of ``pkg`` over fakes, and the trace of what each
    call answered (JSON round-tripped, so both packages compare as
    data)."""

    def __init__(self, pkg, goodput=0.8, granted=(1,), rendezvous=None,
                 steptrace=None, provider=True):
        self.pkg = pkg
        self.clock = FakeClock()
        self.ledger = FakeLedger(goodput)
        self.provider = None
        if provider:
            self.provider = pkg.fc.LocalCapacityProvider(
                now_fn=self.clock.now)
            self.provider.grant_fn = lambda offer: list(granted)
        self.shed_calls = []
        self.ctl = pkg.fc.FleetController(
            ledger=self.ledger, provider=self.provider,
            rendezvous=rendezvous, steptrace=steptrace,
            now_fn=self.clock.now)
        self.ctl.shed_sink = lambda rank, deadline, reason: \
            self.shed_calls.append([rank, deadline, reason])
        self.trace = []

    def note(self, what, value):
        self.trace.append([what, json.loads(json.dumps(value))])
        return value

    def offer(self, slices=1, ttl_s=600.0):
        return self.note("offer", self.provider.offer(
            slices=slices, ttl_s=ttl_s).to_dict())

    def evaluate(self):
        return self.note("evaluate", self.ctl.evaluate_once())

    def status(self):
        return self.note("status", self.ctl.status())

    def result(self):
        self.note("state", self.ctl.export_state())
        self.note("noted", self.ledger.noted)
        self.note("sheds", self.shed_calls)
        return self.trace


def _claim_economics(pkg):
    out = []
    blind = Run(pkg, goodput=-1.0)
    blind.offer()
    blind.evaluate()                   # claiming blind is refused
    out += blind.result()
    short = Run(pkg, goodput=0.9)
    short.offer(ttl_s=30.0)            # 27 s gain < 1.2 × 45 s
    short.evaluate()
    out += short.result()
    claim = Run(pkg, goodput=0.9, granted=(2,))
    claim.offer()
    claim.evaluate()                   # claims, priced under autoscale
    claim.status()
    out += claim.result()
    learned = Run(pkg, goodput=0.9)
    learned.ledger.incarnations = [{"reason": "replan", "badput": 450.0},
                                   {"reason": "autoscale", "badput": 550.0}]
    learned.offer()
    learned.evaluate()                 # 540 s < 1.2 × the learned 500 s
    out += learned.result()
    return out


def _hysteresis(pkg):
    _knobs(autoscale_hysteresis_windows=2)
    run = Run(pkg, goodput=0.9)
    offer = run.offer()
    run.evaluate()                     # hold: 1/2 windows
    run.note("claimed away", run.provider.claim(offer["offer_id"]))
    run.evaluate()                     # no candidate: the count restarts
    run.offer()
    run.evaluate()                     # hold again
    run.evaluate()                     # claim
    return run.result()


def _cooldown(pkg):
    _knobs(autoscale_cooldown_s=120.0, autoscale_rollback_window_s=10.0)
    run = Run(pkg, goodput=0.9)
    run.offer()
    run.evaluate()                     # claim
    run.clock.advance(30.0)            # the watch resolves ok
    run.offer()
    run.evaluate()                     # hold: cooldown
    run.clock.advance(120.0)
    run.evaluate()                     # claim
    return run.result()


def _rate_limit(pkg):
    _knobs(autoscale_max_decisions_per_hour=2,
           autoscale_rollback_window_s=1.0)
    run = Run(pkg, goodput=0.9)
    for _ in range(2):
        run.offer()
        run.evaluate()                 # claim
        run.clock.advance(10.0)
        run.evaluate()                 # the watch resolves
    run.offer()
    run.evaluate()                     # hold: rate limit
    run.clock.advance(3600.0)
    run.offer()
    run.evaluate()                     # claim
    return run.result()


def _watchdog_window(pkg):
    run = Run(pkg, goodput=0.9)
    run.offer()
    run.evaluate()                     # claim
    run.offer()
    run.evaluate()                     # hold: one experiment at a time
    return run.result()


def _rollback(pkg):
    run = Run(pkg, goodput=0.8, granted=(3,),
              rendezvous=FakeRendezvous({0: 0, 7: 3}))
    run.offer()
    run.evaluate()                     # claim
    run.ledger.goodput = 0.5
    run.clock.advance(61.0)
    run.evaluate()                     # rollback: sheds rank 7, level 1
    run.status()
    run.offer()
    run.ledger.goodput = 0.8
    run.evaluate()                     # hold: quarantined
    run.clock.advance(601.0)
    run.offer()
    run.evaluate()                     # claim
    run.ledger.goodput = 0.5
    run.clock.advance(61.0)
    run.evaluate()                     # rollback at level 2, 1200 s
    run.status()
    return run.result()


def _watch_ok(pkg):
    run = Run(pkg, goodput=0.8)
    run.offer()
    run.evaluate()
    run.clock.advance(61.0)
    run.evaluate()                     # goodput held: outcome ok
    run.status()
    return run.result()


def _revoke(pkg):
    run = Run(pkg, goodput=0.8, granted=(5,))
    run.offer()
    run.evaluate()                     # claim
    run.provider.revoke(5, grace_s=10.0)
    run.ledger.goodput = 0.1           # the market's dip, not the claim's
    run.clock.advance(61.0)
    run.evaluate()
    run.status()                       # outcome revoked, no quarantine
    return run.result()


def _shed(pkg):
    rdzv = FakeRendezvous({0: 0, 1: 0, 2: 1, 3: 1})
    calm = Run(pkg, steptrace=FakeSteptrace(gating_rank=2, dcn_wait=0.1),
               rendezvous=rdzv, provider=False)
    calm.evaluate()                    # gating but calm: no candidate
    hot = Run(pkg, steptrace=FakeSteptrace(gating_rank=2, dcn_wait=0.5),
              rendezvous=rdzv, provider=False)
    hot.evaluate()                     # shed slice 1 through rank 2
    return calm.result() + hot.result()


def _shed_one_slice(pkg):
    run = Run(pkg, steptrace=FakeSteptrace(gating_rank=1, dcn_wait=0.9),
              rendezvous=FakeRendezvous({0: 0, 1: 0}), provider=False)
    run.evaluate()                     # never shed the only slice
    return run.result()


SCENARIOS = {
    "claim_economics": _claim_economics,
    "hysteresis": _hysteresis,
    "cooldown": _cooldown,
    "rate_limit": _rate_limit,
    "watchdog_window": _watchdog_window,
    "rollback_quarantine": _rollback,
    "watch_ok": _watch_ok,
    "market_revoke": _revoke,
    "shed": _shed,
    "shed_never_on_one_slice": _shed_one_slice,
}


def _kinds(trace):
    return [value and value["kind"] for what, value in trace
            if what == "evaluate"]


EXPECTED_KINDS = {
    "claim_economics": [None, None, "claim", None],
    "hysteresis": ["hold", None, "hold", "claim"],
    "cooldown": ["claim", "hold", "claim"],
    "rate_limit": ["claim", None, "claim", None, "hold", "claim"],
    "watchdog_window": ["claim", "hold"],
    "rollback_quarantine": ["claim", "rollback", "hold", "claim",
                            "rollback"],
    "watch_ok": ["claim", None],
    "market_revoke": ["claim", None],
    "shed": [None, "shed"],
    "shed_never_on_one_slice": [None],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decision_sequence_matches_jax(name):
    want = SCENARIOS[name](JAX)
    got = SCENARIOS[name](PORT)
    assert got == want
    assert _kinds(got) == EXPECTED_KINDS[name]


def test_rollback_and_revoke_outcomes():
    """The port's own reading of two scenarios: the rollback sheds the
    claimed slice's first member and doubles its quarantine; a revoked
    claim ends "revoked" with no quarantine."""
    trace = _rollback(PORT)
    status = [v for what, v in trace if what == "status"]
    assert status[0]["quarantine"]["claim"]["level"] == 1
    rollbacks = [v for what, v in trace
                 if what == "evaluate" and v and v["kind"] == "rollback"]
    assert rollbacks[0]["evidence"]["reverted"] == [3]
    assert rollbacks[1]["evidence"]["quarantine_s"] == pytest.approx(
        1200.0)
    sheds = [v for what, v in trace if what == "sheds"][0]
    assert [s[0] for s in sheds] == [7, 7]
    assert "rollback" in sheds[0][2]
    revoke = _revoke(PORT)
    final = [v for what, v in revoke if what == "status"][-1]
    assert final["quarantine"] == {}
    assert [d["outcome"] for d in final["decisions"]] == ["revoked"]


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_exported_state_restores_across_packages(writer, reader):
    """A controller with history (a claim, a rollback, a quarantine and
    an open watch) exports its state; the other package's controller
    restores it, exports the same JSON, and both go on to the same next
    decision (held by the inherited watch)."""
    _knobs(autoscale_cooldown_s=300.0)
    source = Run(writer, goodput=0.8, granted=(3,))
    source.offer()
    source.evaluate()
    source.ledger.goodput = 0.4
    source.clock.advance(61.0)
    source.evaluate()                  # rollback + quarantine
    source.clock.advance(601.0)
    source.ledger.goodput = 0.8
    source.offer()
    source.evaluate()                  # a claim: the watch is open
    state = json.loads(json.dumps(source.ctl.export_state()))
    heirs = []
    for pkg in (writer, reader):
        heir = Run(pkg, goodput=0.8)
        heir.clock.t = source.clock.t
        heir.ctl.restore_state(state)
        assert json.loads(json.dumps(heir.ctl.export_state())) == state
        heir.offer()
        held = heir.evaluate()
        assert held["kind"] == "hold" and "watchdog" in held["reason"]
        assert held["id"] > state["decisions"][-1]["id"]
        heirs.append(heir.result())
    assert heirs[1] == heirs[0]


# ---------------------------------------------------------------------------
# the whole loop on the port's master
# ---------------------------------------------------------------------------


def _wait_world(client, size, timeout_s=10.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        _, _, world = client.get_comm_world()
        if world and len(world) == size:
            return world
        time.sleep(0.02)
    raise TimeoutError(f"world of {size} never formed")


def test_master_offer_claim_rejoin_revoke_drain(tmp_path, monkeypatch):
    """A chaos offer through the master's injector is claimed, the grant
    joins a second node in one rendezvous round, a chaos revoke books
    the market's take-back and the node drains through the ordinary
    path: world 2 then 1, the claim ``revoked`` with no quarantine over
    the wire, the ledger's ``autoscale`` and ``drain`` incarnations, the
    flight events, and the snapshot's ``fleet_controller`` key."""
    from dlrover_tpu_torch import obs
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.constants import RendezvousName
    from dlrover_tpu_torch.master.job_master import JobMaster
    from dlrover_tpu_torch.master.state_backend import MasterStateBackend

    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DLROVER_TPU_CHAOS", "offer:slice:+1@6")
    Context.singleton().update(
        fleet_controller_enabled=True, goodput_window_s=30.0,
        autoscale_interval_s=3600.0, coord_port=-1, metrics_port=-1,
        diagnosis_enabled=False)
    master = JobMaster(port=0, min_nodes=1, max_nodes=2, host="127.0.0.1",
                       state_dir=str(tmp_path / "state"))
    master.prepare()
    c0 = MasterClient(master.addr, node_id=0, node_rank=0, timeout_s=10.0)
    clients = {}
    try:
        c0.join_rendezvous(local_world_size=1)
        _wait_world(c0, 1)
        for step in range(1, 7):   # step 6 fires the offer
            c0.report_global_step(step, step_time_s=0.02,
                                  data_wait_fraction=0.05)
            time.sleep(0.02)
        provider = master.capacity_provider
        offers = provider.open_offers()
        assert [o.slices for o in offers] == [1] and offers[0].step == 6
        mgr = master.rdzv_managers[RendezvousName.TRAINING]

        def grant(offer):
            mgr.add_alive_node(1)      # the round waits for the grantee
            c1 = MasterClient(master.addr, node_id=1, node_rank=1,
                              timeout_s=10.0)
            c0.join_rendezvous(local_world_size=1)
            c1.join_rendezvous(local_world_size=1)
            clients["c1"] = c1
            return [1]

        provider.grant_fn = grant
        rounds = mgr.rdzv_round
        record = master.fleet_controller.evaluate_once()
        assert record["kind"] == "claim"
        assert record["evidence"]["granted"] == [1]
        assert len(_wait_world(c0, 2)) == 2
        assert mgr.rdzv_round == rounds + 1          # one round
        c1 = clients["c1"]
        for step in range(7, 10):
            c0.report_global_step(step, step_time_s=0.02)
            c1.report_global_step(step - 6, step_time_s=0.02)
            time.sleep(0.02)
        master._arm_master_chaos("revoke:slice:1@10:2")
        c0.report_global_step(10, step_time_s=0.02)  # the master's copy
        c1.report_drain(deadline=time.time() + 2.0,
                        reason="chaos revoke@10", phase="notice")
        c1.report_drain(deadline=0, phase="complete")
        c0.join_rendezvous(local_world_size=1)
        assert len(_wait_world(c0, 1)) == 1

        status = c0.get_autoscale_status()
        by_kind = {d["kind"]: d for d in status["decisions"]}
        assert by_kind["claim"]["outcome"] == "revoked"
        assert status["quarantine"] == {}
        reasons = [inc.get("reason") for inc in
                   master.goodput_ledger.snapshot()["incarnations"]]
        assert "autoscale" in reasons and "drain" in reasons
        events = [e.get("name") for e in
                  obs.get_flight_recorder().snapshot()]
        for name in ("capacity_offer", "autoscale_decision",
                     "capacity_revoke"):
            assert name in events, name
        snapshot = master._export_state()["fleet_controller"]
        assert snapshot == master.fleet_controller.export_state()
    finally:
        for client in clients.values():
            client.close()
        c0.close()
        master.stop(grace_s=0.1)
    state, _ = MasterStateBackend(str(tmp_path / "state")).load_latest()
    assert [d["outcome"] for d in state["fleet_controller"]["decisions"]
            if d["kind"] == "claim"] == ["revoked"]


# ---------------------------------------------------------------------------
# the market faults of the chaos grammar
# ---------------------------------------------------------------------------

MARKET = "offer:slice:+1@10:300;offer:slice:2@3;revoke:slice:1@6:20"


@pytest.mark.parametrize("role,rank,slice_id", [
    ("master", 0, -1), ("worker", 0, -1), ("worker", 3, 1),
    ("worker", 0, 0)])
def test_market_faults_arm_and_fire_as_jax(role, rank, slice_id, tmp_path,
                                           monkeypatch):
    """``offer`` arms on the master only and ``revoke`` on the master and
    the revoked slice's workers, as in the JAX injector; fired step by
    step, the master's copies call the provider hooks with the same
    arguments, and a revoked worker writes the same preemption notice."""
    from dlrover_tpu.diagnostics import chaos as jchaos
    from dlrover_tpu_torch.diagnostics import chaos as tchaos

    monkeypatch.setattr(time, "time", lambda: 5000.0)
    traces = []
    for name, mod in (("jax", jchaos), ("port", tchaos)):
        notice = tmp_path / f"{name}.notice"
        monkeypatch.setenv("DLROVER_TPU_PREEMPTION_NOTICE", str(notice))
        monkeypatch.setenv("DLROVER_TPU_CHAOS_STATE",
                           str(tmp_path / f"{name}.state"))
        injector = mod.ChaosInjector(role=role, rank=rank, spec=MARKET,
                                     slice_id=slice_id)
        calls = []
        injector.offer_fn = lambda *a: calls.append(["offer", *a])
        injector.revoke_fn = lambda *a: calls.append(["revoke", *a])
        armed = [vars(f) for f in injector.faults]
        for step in range(1, 12):
            injector.maybe_inject(step)
        written = (json.loads(notice.read_text())
                   if notice.exists() else None)
        traces.append([armed, calls, written,
                       sorted(os.listdir(tmp_path / f"{name}.state"))
                       if (tmp_path / f"{name}.state").exists() else []])
    assert traces[1] == traces[0]
    armed, calls, written, _ = traces[1]
    if role == "master":
        assert [c[0] for c in calls] == ["offer", "revoke", "offer"]
    elif slice_id == 1:
        assert [f["action"] for f in armed] == ["revoke"]
        assert written["grace_s"] == 20.0
    else:
        assert armed == [] and written is None


def test_the_shed_actuator_drains_as_the_jax_master():
    """The controller's shed sink (``JobMaster._controller_shed``): the
    notice rank gets a save-and-exit drain action and the servicer's
    drain chain marks it draining, in both masters alike."""
    from dlrover_tpu.common import messages as J
    from dlrover_tpu.master.job_master import JobMaster as JMaster
    from dlrover_tpu_torch.common import messages as T
    from dlrover_tpu_torch.master.job_master import JobMaster

    _knobs(fleet_controller_enabled=True, coord_port=-1, metrics_port=-1)
    JContext.singleton().update(rdzv_sharded=False)
    seen = []
    for Master, m in ((JMaster, J), (JobMaster, T)):
        master = Master(port=0, min_nodes=2, max_nodes=2, host="127.0.0.1")
        try:
            for rank in (0, 1):
                master.servicer.report(m.JoinRendezvousRequest(
                    node_id=rank, node_rank=rank, local_world_size=1,
                    rdzv_name="elastic-training"))
            master._controller_shed(1, 2e9, "autoscale: shed slice 1")
            actions = json.loads(master.servicer.get(
                m.DiagnosisActionRequest(node_id=1, node_rank=1))
                .actions_json or "[]")
            draining = sorted(master.rdzv_managers[
                "elastic-training"]._draining)
            seen.append(([(a["kind"], a["rank"], a["reason"])
                          for a in actions], draining))
        finally:
            master.stop(grace_s=0.1)
    assert seen[1] == seen[0]
    assert seen[1][0] and seen[1][0][0][1] == 1 and seen[1][1] == [1]
