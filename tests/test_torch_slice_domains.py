"""The port's slice mode against the JAX package's, on the CPU.

Slice mode is two-level data parallelism with the slice as the failure
domain: per-slice rendezvous worlds with their own generation tokens, a
host-level cross-slice gradient mean through the master's KV store
(``parallel/dcn_sync.py``) that renormalizes over the present slices
while one is absent (a degraded step) and hard-stalls past its budget,
the re-formed slice's catch-up, the slice-unit drain, the chaos slice
faults, the degraded-step accounting, and the in-program mean over a
``dcn`` axis in ``build_trainer``.

Each scenario runs through both packages on the same inputs and the two
are compared: the payloads byte for byte, the means, the decisions and
the state exactly. The train step at dcn 2 (two gloo ranks against JAX's
``build_trainer`` on a two-device CPU mesh, SGD so that a parameter
moves by the gradient itself) is held to 1e-4 relative in its losses
and grad norms and 1e-4 absolute in its parameters, at bits 0 (the
sharded steps' rule) and at bits 8 against JAX's quantized step (where
an input a few ulps off a code boundary may round to the next code, as
XLA contracts the products it sums: C16); the
quantized step's grad norm stays within the int8 quantizer's relative
step (1/127) of the exact one. The in-process acceptance bounds every
wait.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from dlrover_tpu import obs as jobs
from dlrover_tpu.common import messages as J
from dlrover_tpu.common.config import Context as JContext
from dlrover_tpu.diagnostics import chaos as jchaos
from dlrover_tpu.master import rendezvous as jrdzv
from dlrover_tpu.master import servicer as jservicer
from dlrover_tpu.master.diagnosis.manager import (
    DiagnosisManager as JDiagnosisManager,
)
from dlrover_tpu.master.speed_monitor import SpeedMonitor as JSpeedMonitor
from dlrover_tpu.obs.goodput import GoodputLedger as JGoodputLedger
from dlrover_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry
from dlrover_tpu.parallel import dcn_sync as jdcn
from dlrover_tpu_torch import obs as tobs
from dlrover_tpu_torch.common import messages as T
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import NodeEnv, RendezvousName
from dlrover_tpu_torch.diagnostics import chaos as tchaos
from dlrover_tpu_torch.master import rendezvous as trdzv
from dlrover_tpu_torch.master import servicer as tservicer
from dlrover_tpu_torch.master.diagnosis.manager import DiagnosisManager
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.obs.goodput import GoodputLedger
from dlrover_tpu_torch.obs.metrics import MetricsRegistry
from dlrover_tpu_torch.parallel import dcn_sync as tdcn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (dcn_sync, Context) of each package
PACKAGES = {"jax": (jdcn, JContext), "port": (tdcn, Context)}


@pytest.fixture(autouse=True)
def contexts():
    for ctx in (JContext, Context):
        ctx.reset()
    yield
    for ctx in (JContext, Context):
        ctx.reset()


def _both_contexts(**kw):
    for ctx in (JContext, Context):
        ctx.singleton().update(**kw)


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((64, 80)).astype(np.float32),
            rng.standard_normal((300,)).astype(np.float32),   # tiny: exact
            np.arange(4096, dtype=np.int32),                   # integer
            rng.standard_normal((3, 1000)).astype(np.float32),  # padded
            np.zeros((2048,), np.float32)]                     # all-zero


@pytest.mark.parametrize("bits", [0, 8])
def test_payloads_are_jax_bytes_and_each_side_reads_the_other(bits):
    leaves = _leaves()
    extra = {"kind": "state", "from_slice": 1, "token": "ab12"}
    want = jdcn.encode_leaves(leaves, 7, quant_bits=bits, extra=extra)
    got = tdcn.encode_leaves(leaves, 7, quant_bits=bits, extra=extra)
    assert got == want
    assert tdcn.peek_step(want) == jdcn.peek_step(got) == 7
    read_jax, read_port = jdcn.decode_payload(got), tdcn.decode_payload(want)
    assert read_port[0] == read_jax[0]
    for a, b, leaf in zip(read_port[1], read_jax[1], leaves):
        assert a.dtype == b.dtype == leaf.dtype and a.shape == leaf.shape
        np.testing.assert_array_equal(a, b)
        if bits == 0 or leaf.dtype.kind != "f" or leaf.size < 2048:
            np.testing.assert_array_equal(a, leaf)
        else:
            # half a code step of the leaf's largest group, at most
            step = np.abs(leaf).max() / 127.0
            assert np.abs(a - leaf).max() <= step / 2 + 1e-7


@pytest.mark.parametrize("data", [
    b"", b"\xff\xfe not json", b'{"step": 3}',
    b'{"step": 3, "leaves": [{"bytes": 9}]}\n123'])
def test_garbage_reads_as_absence_alike(data):
    assert tdcn.decode_payload(data) == jdcn.decode_payload(data)
    assert tdcn.peek_step(data) == jdcn.peek_step(data)


def test_quant_bits_other_than_0_and_8_are_refused_alike():
    for module in (jdcn, tdcn):
        with pytest.raises(ValueError, match="0 or 8"):
            module.encode_leaves(_leaves(), 1, quant_bits=4)


# ---------------------------------------------------------------------------
# SliceGradSync over a fake client
# ---------------------------------------------------------------------------


class _FakeSyncClient:
    """The MasterClient surface SliceGradSync needs: a shared dict for
    the KV store and a mutable slice registry; ``fail`` makes the status
    RPC raise (a master outage)."""

    def __init__(self, kv, status):
        self.kv = kv
        self.status = status
        self.fail = False

    def kv_set(self, key, value):
        self.kv[key] = value
        return True

    def kv_get(self, key):
        return self.kv.get(key, b"")

    def get_slice_status(self):
        if self.fail:
            raise RuntimeError("master down")
        return json.loads(json.dumps(self.status))


def _grads(value):
    return [np.full((8,), value, np.float32),
            np.linspace(-1.0, 1.0, 4096, dtype=np.float32) * value]


def _info(info):
    """A reduce's info without its clock marks."""
    return {k: v for k, v in info.items() if k not in ("trace",
                                                       "stalled_s")}


def _sync_script(pkg):
    """A deterministic sequence of reduces (the peers' posts made by hand
    with the package's own encoder) and what each answered."""
    dcn, ctx = PACKAGES[pkg]
    ctx.singleton().update(dcn_sync_timeout_s=0.2, dcn_sync_poll_s=0.01,
                           slice_absent_max_steps=5, dcn_sync_quant_bits=8)
    kv = {}
    status = {"total": 2, "fleet_step": 0,
              "slices": {"0": {"formed": True}, "1": {"formed": True}}}
    client = _FakeSyncClient(kv, status)
    sync = dcn.SliceGradSync(client, 0)
    out = []

    def reduce(step, value, **kw):
        reduced, info = sync.reduce(_grads(value), step, **kw)
        out.append([step, [r.tolist() for r in reduced], _info(info),
                    sync.consecutive_degraded, sync.degraded_total])

    # the whole fleet: slice 1 posted its step-1 grads (q8 on the wire)
    kv["dcn/grads/1"] = dcn.encode_leaves(_grads(3.0), 1, quant_bits=8)
    reduce(1, 1.0)
    # slice 1 un-formed: the mean over slice 0 alone, degraded
    status["slices"]["1"]["formed"] = False
    reduce(2, 5.0)
    # formed again but silent for step 3: absent for this step
    status["slices"]["1"]["formed"] = True
    reduce(3, 4.0)
    # a peer already past this step: absent at once
    kv["dcn/grads/1"] = dcn.encode_leaves(_grads(2.0), 9)
    reduce(4, 1.0)
    out.append(["unreported", sync.drain_unreported(),
                sync.drain_unreported()])
    # the rejoin handoff: slice 1 asks for the state at step 2; the
    # leader publishes its state of step 4 in its step-5 sync
    kv["dcn/rejoin"] = json.dumps(
        {"slice": 1, "step": 2, "token": "t0"}).encode()
    kv["dcn/grads/1"] = dcn.encode_leaves(_grads(1.0), 5)
    state = [np.arange(16, dtype=np.float32), np.array([7], np.int64)]
    reduce(5, 3.0, state_leaves_fn=lambda: state)
    out.append(["handoff", kv["dcn/state"].hex(), kv["dcn/rejoin"].hex()])
    # the epoch namespaces every key
    status["epoch"] = 3
    kv["dcn/g3/grads/1"] = dcn.encode_leaves(_grads(5.0), 6)
    reduce(6, 1.0)
    out.append(["keys", sorted(kv), sync.world_epoch])
    # a status outage in a known two-slice fleet: degraded, local only
    client.fail = True
    reduce(7, 2.0)
    client.fail = False
    # one slice in the registry: nothing to exchange
    status.update(total=1, slices={"0": {"formed": True}})
    reduce(8, 6.0)
    # the re-formed side: a catch-up with the fleet ahead reads the state
    status.update(total=2, fleet_step=4,
                  slices={"0": {"formed": True}, "1": {"formed": True}})
    rejoiner = dcn.SliceGradSync(_FakeSyncClient(kv, status), 1,
                                 is_leader=False)
    kv["dcn/g3/state"] = kv["dcn/state"]
    leaves, step = rejoiner.catch_up(2, timeout_s=5.0)
    out.append(["catch_up", step, [leaf.tolist() for leaf in leaves]])
    # not ahead: no catch-up
    out.append(["not_ahead", rejoiner.catch_up(4, timeout_s=0.1)])
    return out


def test_slice_grad_sync_takes_jax_decisions():
    assert _sync_script("port") == _sync_script("jax")


def _stall_script(pkg):
    """The budget blown: the sync stalls until the fleet is whole, then
    takes the whole mean."""
    dcn, ctx = PACKAGES[pkg]
    ctx.singleton().update(dcn_sync_timeout_s=0.2, dcn_sync_poll_s=0.01,
                           slice_absent_max_steps=2)
    kv = {}
    status = {"total": 2, "fleet_step": 0,
              "slices": {"0": {"formed": True}, "1": {"formed": False}}}
    stop = threading.Event()
    sync = dcn.SliceGradSync(_FakeSyncClient(kv, status), 0,
                             abort_fn=stop.is_set)
    for step in (1, 2):
        sync.reduce(_grads(1.0), step)
    done = {}
    thread = threading.Thread(
        target=lambda: done.update(result=sync.reduce(_grads(1.0), 3)))
    thread.start()
    time.sleep(0.3)
    stalled = thread.is_alive()
    kv["dcn/grads/1"] = dcn.encode_leaves(_grads(3.0), 3)
    status["slices"]["1"]["formed"] = True
    thread.join(timeout=10.0)
    stop.set()
    reduced, info = done["result"]
    return [stalled, not thread.is_alive(), info["stalled_s"] > 0,
            [r.tolist() for r in reduced], _info(info),
            sync.consecutive_degraded]


def test_budget_stall_matches_jax_and_sets_the_gauge():
    want = _stall_script("jax")
    got = _stall_script("port")
    assert got == want
    assert got[0] and got[1] and got[2]
    events = [e.get("name") for e in
              tobs.get_flight_recorder().snapshot()]
    assert "slice_absent_budget_blown" in events
    assert ('dlrover_tpu_slice_degraded_steps_total{slice="0"}'
            in tobs.get_registry().render())


# ---------------------------------------------------------------------------
# the slice rendezvous
# ---------------------------------------------------------------------------


SLICE_KEYS = ("slices", "slice_worlds", "slice_rounds", "slice_generation",
              "world_epoch")


def _rdzv_script(mod):
    params = mod.RendezvousParameters(min_nodes=1, max_nodes=16,
                                      wait_new_node_s=30.0)
    mgr = mod.ElasticTrainingRendezvousManager(params)
    out = []

    def note(*what):
        out.append(json.loads(json.dumps(what, default=sorted)))

    def poll(*ranks):
        note("worlds", [mgr.get_comm_world(r) for r in ranks])

    for rank, sid in {0: 0, 1: 0, 2: 1, 3: 1}.items():
        note("join", rank, mgr.join_rendezvous(rank, 1, slice_id=sid))
    poll(0, 1, 2, 3)
    note("status", mgr.slice_status(), mgr.latest_world)
    note("drain plan", mgr.mark_draining(1, time.time() + 30.0))
    mgr.join_rendezvous(1, 1, slice_id=0)     # the re-join cancels it
    poll(1, 0)
    note("after cancel", mgr.slice_status(), sorted(mgr.draining))
    # slice 0's rank 0 dies: only its slice's world goes
    mgr.remove_alive_node(0)
    note("after death", mgr.slice_status(),
         [mgr.num_nodes_waiting(r) for r in (0, 1, 2, 3)])
    poll(1, 2, 3)
    # the victim slice re-forms alone with its generation bumped
    mgr.join_rendezvous(0, 1, slice_id=0)
    mgr.join_rendezvous(1, 1, slice_id=0)
    poll(0, 1, 2)
    note("re-formed", mgr.slice_status(),
         [mgr.num_nodes_waiting(r) for r in (0, 1, 2, 3)],
         [mgr.round_for(r) for r in (0, 2)],
         [mgr.world_for(r) for r in (0, 2)])
    plan, changed = mgr.compute_shard_plan(0)
    note("plan", {k: plan.get(k) for k in ("mesh", "generation", "epoch",
                                           "world_size")}, changed)
    state = mgr.export_state()
    note("export", {k: state[k] for k in SLICE_KEYS})
    return out, mgr


def test_slice_rendezvous_makes_jax_decisions():
    want, jmgr = _rdzv_script(jrdzv)
    got, tmgr = _rdzv_script(trdzv)
    assert got == want
    # each package restores the other's export
    for src, dst_mod in ((jmgr, trdzv), (tmgr, jrdzv)):
        dst = dst_mod.ElasticTrainingRendezvousManager()
        dst.restore_state(src.export_state())
        assert dst.slice_status() == src.slice_status()
        assert dst.world_for(2) == src.world_for(2)
        assert dst.round_for(0) == src.round_for(0)


def test_slice_world_invalidation_names_only_the_victim():
    params = trdzv.RendezvousParameters(min_nodes=1, max_nodes=4,
                                        wait_new_node_s=30.0)
    mgr = trdzv.ElasticTrainingRendezvousManager(params)
    for rank, sid in {0: 0, 1: 0, 2: 1}.items():
        mgr.join_rendezvous(rank, 1, slice_id=sid)
    for rank in (0, 1, 2):
        mgr.get_comm_world(rank)
    before = len(tobs.get_flight_recorder().snapshot())
    mgr.remove_alive_node(1)
    events = tobs.get_flight_recorder().snapshot()[before:]
    invalidated = [e["attrs"] for e in events
                   if e.get("name") == "slice_world_invalidated"]
    assert [a["slice"] for a in invalidated] == [0]
    assert mgr.get_comm_world(2) == (0, 1, {2: 1})


@pytest.mark.parametrize("mod", [jrdzv, trdzv], ids=["jax", "port"])
def test_grace_window_is_timed_from_the_slices_first_joiner(mod):
    """Rank 2, an alive member of slice 0 that never joins: the slice
    cuts when the grace expires, timed from rank 0's join (a later join
    does not re-arm it), in both packages."""
    mgr = mod.ElasticTrainingRendezvousManager(mod.RendezvousParameters(
        min_nodes=1, max_nodes=16, wait_new_node_s=0.3))
    mgr.record_slice(2, 0)
    mgr.add_alive_node(2)
    mgr.join_rendezvous(0, 1, slice_id=0)
    time.sleep(0.35)
    mgr.join_rendezvous(1, 1, slice_id=0)
    assert mgr.get_comm_world(0)[2] == {0: 1, 1: 1}


def test_sliceless_and_network_check_rendezvous_stay_fleet_wide():
    for mod in (jrdzv, trdzv):
        mgr = mod.ElasticTrainingRendezvousManager(
            mod.RendezvousParameters(min_nodes=1, max_nodes=16,
                                     wait_new_node_s=30.0))
        mgr.join_rendezvous(0, 1)
        mgr.join_rendezvous(1, 1)
        assert mgr.get_comm_world(0) == (0, 0, {0: 1, 1: 1})
        assert mgr.slice_status() == {"total": 0, "slices": {},
                                      "epoch": 0}
        check = mod.NetworkCheckRendezvousManager(
            mod.RendezvousParameters(min_nodes=1, max_nodes=16,
                                     wait_new_node_s=30.0))
        check.join_rendezvous(0, 1, slice_id=0)
        check.join_rendezvous(1, 1, slice_id=1)
        assert check.get_comm_world(0)[2] == {0: 1, 1: 1}
        assert check.slice_map == {}


# ---------------------------------------------------------------------------
# the restore plan's same-slice donors
# ---------------------------------------------------------------------------


def _restore_script(mod):
    mgr = mod.ElasticTrainingRendezvousManager()
    for rank, sid in {0: 0, 1: 0, 4: 0, 2: 1, 3: 1}.items():
        mgr.join_rendezvous(rank, 1, slice_id=sid)
    for rank in (0, 1, 4, 2, 3):
        mgr.get_comm_world(rank)
    keys = ["shard/a", "shard/b", "shard/c", "shard/d"]
    for rank in (1, 4, 2, 3):
        mgr.register_peer_store(rank, f"10.0.0.{rank}:9", 5, keys)
    plans = [mgr.compute_restore_plan(0),
             mgr.compute_restore_plan(0, stripe=True)]
    mgr.register_peer_store(0, "10.0.0.0:9", 5, ["shard/a"])
    plans.append(mgr.compute_restore_plan(0))
    # the requester's slice lost its stores: cross-slice donors only
    for rank in (0, 1, 4):
        mgr.register_peer_store(rank, "", -1, [])
    plans.append(mgr.compute_restore_plan(0))
    return plans


def test_restore_plan_prefers_same_slice_donors_as_jax():
    got, want = _restore_script(trdzv), _restore_script(jrdzv)
    assert got == want
    first = got[0]["entries"]
    assert [first[k]["rank"] for k in sorted(first)] == [1, 4, 1, 4]
    assert {e["tier"] for e in got[-1]["entries"].values()} == {
        "cross-slice"}


# ---------------------------------------------------------------------------
# the slice-unit drain, the degraded counter, the slice status RPC
# ---------------------------------------------------------------------------


def _drain_script(msgs, servicer_mod, speed_cls, dm_cls):
    speed = speed_cls()
    servicer = servicer_mod.MasterServicer(
        speed_monitor=speed, diagnosis_manager=dm_cls(speed))
    for rank, sid in {0: 0, 1: 0, 2: 1, 3: 1}.items():
        servicer.report(msgs.JoinRendezvousRequest(
            node_id=rank, node_rank=rank, local_world_size=1,
            rdzv_name=RendezvousName.TRAINING, slice_id=sid))
    servicer.get(msgs.CommWorldRequest(node_id=0,
                                       rdzv_name=RendezvousName.TRAINING))
    result = servicer.report(msgs.DrainReport(
        node_id=0, node_rank=0, deadline=time.time() + 30.0,
        reason="spot reclaim", phase="notice"))
    dm = servicer.diagnosis_manager
    actions = {rank: [a["kind"] for a in dm.poll_actions(rank)]
               for rank in range(4)}
    mgr = servicer.rdzv_managers[RendezvousName.TRAINING]
    status = json.loads(servicer.get(msgs.SliceStatusRequest()).status_json)
    return [sorted(result.checkpoint_ranks), actions, sorted(mgr.draining),
            status]


def test_slice_unit_drain_and_status_rpc_match_jax():
    got = _drain_script(T, tservicer, SpeedMonitor, DiagnosisManager)
    want = _drain_script(J, jservicer, JSpeedMonitor, JDiagnosisManager)
    assert got == want
    assert got[0] == [2, 3] and got[2] == [0, 1]
    assert got[1] == {0: [], 1: ["drain"], 2: ["checkpoint"],
                      3: ["checkpoint"]}


def test_degraded_steps_reach_the_counter_and_the_ledger():
    registry = MetricsRegistry()
    servicer = tservicer.MasterServicer(
        goodput_ledger=GoodputLedger(registry=registry))
    servicer.report(T.JoinRendezvousRequest(
        node_id=0, node_rank=0, local_world_size=1,
        rdzv_name=RendezvousName.TRAINING, slice_id=2))
    servicer.report(T.GlobalStepReport(
        node_id=0, node_rank=0, step=10, timestamp=time.time(),
        step_time_s=0.1, degraded_steps=3))
    assert ('dlrover_tpu_slice_degraded_steps_total{slice="2"} 3'
            in tobs.get_registry().render())
    snap = servicer.goodput_ledger.snapshot()
    assert snap["degraded_steps_total"] == 3
    assert snap["per_rank"]["0"]["slice"] == 2


def _rollup_lines(obs_mod):
    """The speed monitor's per-slice series in a package's registry."""
    names = tuple(f"dlrover_tpu_slice_{name}{{slice=\"{sid}\"}}"
                  for name in ("steps_per_second", "mfu", "workers")
                  for sid in (0, 1))
    return sorted(line for line in obs_mod.get_registry().render()
                  .splitlines() if line.startswith(names))


def test_goodput_and_speed_rollups_match_jax():
    out = []
    for ledger_cls, reg_cls, speed_cls, obs_mod in (
            (JGoodputLedger, JMetricsRegistry, JSpeedMonitor, jobs),
            (GoodputLedger, MetricsRegistry, SpeedMonitor, tobs)):
        ledger = ledger_cls(registry=reg_cls())
        ledger.set_slice_map({0: 0, 1: 1})
        ledger.observe_step_report(0, 10, step_time_s=0.1)
        ledger.observe_degraded_steps(0, 7)
        ledger.observe_degraded_steps(1, 2)
        restored = ledger_cls(registry=reg_cls())
        restored.restore_state(ledger.export_state())
        snap = restored.snapshot()
        monitor = speed_cls()
        monitor.set_slice_map({0: 0, 1: 0, 2: 1})
        for rank in (0, 1, 2):
            monitor.collect_worker_step(rank, 10, step_time_s=0.5,
                                        mfu=0.4)
        lines = _rollup_lines(obs_mod)
        monitor.evict_departed({0, 1})
        after = [line for line in _rollup_lines(obs_mod)
                 if line.startswith("dlrover_tpu_slice_workers")]
        out.append([snap["degraded_steps_total"],
                    {r: (v["slice"], v["degraded_steps"])
                     for r, v in snap["per_rank"].items()},
                    sorted(lines), sorted(after)])
    assert out[1] == out[0]
    assert 'dlrover_tpu_slice_workers{slice="0"} 2' in out[1][2]
    assert out[1][3] == ['dlrover_tpu_slice_workers{slice="0"} 2']


# ---------------------------------------------------------------------------
# the chaos slice faults
# ---------------------------------------------------------------------------


def _fields(faults):
    return [(f.action, f.role, f.rank, f.at_step, f.duration)
            for f in faults]


@pytest.mark.parametrize("spec", [
    "kill:slice:0@5;preempt:slice:1@4:20",
    "hang:slice:1@3:2;slow:slice:0@2:0.5",
    "resize:slice:-1@4;resize:slice:+1@6;kill:worker:1@3",
    "revoke:slice:1@10:20;offer:slice:+1@10:300;kill:slice:1@7"])
def test_slice_faults_arm_on_the_slices_members_as_jax(spec, monkeypatch):
    monkeypatch.delenv(tchaos.CHAOS_STATE_ENV, raising=False)
    for role, rank, sid in (("worker", 0, 0), ("worker", 1, 0),
                            ("worker", 2, 1), ("worker", 3, -1),
                            ("master", 0, -1)):
        port = tchaos.ChaosInjector(role=role, rank=rank, spec=spec,
                                    slice_id=sid)
        jax = jchaos.ChaosInjector(role=role, rank=rank, spec=spec,
                                   slice_id=sid)
        assert _fields(port.faults) == _fields(jax.faults), (role, rank)


def test_slice_faults_fire_as_jax(tmp_path, monkeypatch):
    """``preempt:slice`` writes every member's notice; ``resize:slice``
    sends the highest slices' members out with the clean-drain exit,
    judged against $DLROVER_TPU_NUM_SLICES; ``kill:slice`` SIGKILLs each
    member."""
    monkeypatch.setenv(NodeEnv.NUM_SLICES, "2")
    out = {}
    for name, mod in (("jax", jchaos), ("port", tchaos)):
        state = tmp_path / name
        state.mkdir()
        monkeypatch.setenv(mod.CHAOS_STATE_ENV, str(state))
        kills = []
        monkeypatch.setattr(mod.os, "kill",
                            lambda pid, sig, kills=kills: kills.append(sig))
        record = []
        for rank, sid in ((0, 0), (1, 0), (2, 1)):
            notice = state / f"notice{rank}.json"
            monkeypatch.setenv(NodeEnv.PREEMPTION_NOTICE_FILE, str(notice))
            inj = mod.ChaosInjector(
                role="worker", rank=rank, slice_id=sid,
                spec="preempt:slice:0@3:9;resize:slice:-1@4;kill:slice:1@5")
            exits = []
            for step in (3, 4, 5):
                try:
                    inj.maybe_inject(step)
                except SystemExit as e:
                    exits.append([step, e.code])
            grace = (json.loads(notice.read_text())["grace_s"]
                     if notice.exists() else None)
            record.append([rank, grace, exits])
        out[name] = [record, len(kills)]
    assert out["port"] == out["jax"]
    assert out["port"][0][0][1] == 9.0 and out["port"][0][2][2]


# ---------------------------------------------------------------------------
# the fleet controller's shed through a slice registry
# ---------------------------------------------------------------------------


def test_shed_of_the_gating_slice_matches_jax():
    """The shed of the slowest slice is reachable: each package's
    controller over its own slice-mode rendezvous and the same step-trace
    summary sheds slice 1 through rank 2, and neither sheds a fleet of
    one slice."""
    import test_torch_fleet_controller as tfc_test

    for ctx in (JContext, Context):
        ctx.singleton().update(**tfc_test.KNOBS)
    out = {}
    for name, pkg, mod in (("jax", tfc_test.JAX, jrdzv),
                           ("port", tfc_test.PORT, trdzv)):
        trace = []
        for slices, gating in (({0: 0, 1: 0, 2: 1, 3: 1}, 2),
                               ({0: 0, 1: 0}, 1)):
            mgr = mod.ElasticTrainingRendezvousManager()
            for rank, sid in slices.items():
                mgr.join_rendezvous(rank, 1, slice_id=sid)
            run = tfc_test.Run(pkg, steptrace=tfc_test.FakeSteptrace(
                gating_rank=gating, dcn_wait=0.5), rendezvous=mgr,
                provider=False)
            run.evaluate()
            trace.append([[call[0], call[2]] for call in run.shed_calls])
        out[name] = trace
    assert out["port"] == out["jax"]
    assert [call[0] for call in out["port"][0]] == [2]
    assert out["port"][1] == []


# ---------------------------------------------------------------------------
# the train step over a dcn axis, on gloo ranks
# ---------------------------------------------------------------------------


DCN_WORKER = """
import json, sys
import numpy as np
import torch
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.parallel import quant_collectives
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.trainer.train_step import build_trainer

torch.set_num_threads(1)
init_distributed("cpu")
init_path, batch_path = sys.argv[1], sys.argv[2]
init = {k: torch.from_numpy(v) for k, v in np.load(init_path).items()}
batches = np.load(batch_path)
cfg = LlamaConfig.tiny(attn_impl="flash", dtype=torch.float32)

def model(device, seed):
    m = Llama(cfg, device=device, seed=seed)
    if torch.device(device).type != "meta":
        m.load_state_dict(init)
    return m

mesh = create_mesh(MeshSpec(dcn=2), "cpu")
calls = []
leaf = quant_collectives.quantized_pmean_leaf

def counted(g, group, n=None, bits=8, **kw):
    calls.append(bits)
    return leaf(g, group, n, bits=bits, **kw)

import dlrover_tpu_torch.trainer.train_step as ts
ts.quantized_pmean_leaf = counted

def run(bits, split=False):
    trainer = build_trainer(
        model, lambda p: torch.optim.SGD(p, lr=0.1), mesh,
        np.zeros(batches.shape[1:]), cross_entropy_loss,
        micro_batch=batches.shape[1], grad_reduce_bits=bits,
        split_grad_apply=split)
    state = trainer.init(0)
    losses, norms = [], []
    for tokens in batches:
        tok, tgt = trainer.shard_batch(tokens, tokens[:, ::-1])
        if split:
            grads, m = trainer.grad_step(state, tok, tgt)
            state, m2 = trainer.apply_grads(state, grads)
            m.update(m2)
        else:
            state, m = trainer.step(state, tok, tgt)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    params = {n: p.detach().numpy().tolist()
              for n, p in state.model.named_parameters()}
    return losses, norms, params

result = {}
for bits in (0, 8):
    calls.clear()
    result[bits] = run(bits)
    result[f"calls{bits}"] = sorted(set(calls)), len(calls)
split = run(8, split=True)
result["split_same_bits"] = split == result[8]
print(json.dumps({"losses": {b: result[b][0] for b in (0, 8)},
                  "norms": {b: result[b][1] for b in (0, 8)},
                  "params": {b: result[b][2] for b in (0, 8)},
                  "calls": {b: result[f"calls{b}"] for b in (0, 8)},
                  "split_same_bits": result["split_same_bits"]}))
"""


def test_dcn_axis_trains_as_jax_at_bits_0_and_8(tmp_path, cpu_devices):
    """Two gloo ranks at dcn 2 against JAX's build_trainer on a
    two-device dcn-2 mesh: the mean over dcn is the explicit one (every
    leaf through ``quantized_pmean_leaf``, at the step's bits), and at
    bits 8 the split step gives the fused step's bits."""
    import jax
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.models import llama as jllama
    from dlrover_tpu.parallel.mesh import MeshSpec, create_mesh
    from dlrover_tpu.trainer import train_step as jts
    from dlrover_tpu_torch import convert
    from test_torch_mesh import run_workers

    micro, seq = 4, 32
    jcfg = jllama.LlamaConfig.tiny(attn_impl="reference", dtype=jnp.float32)
    mesh = create_mesh(MeshSpec(dcn=2), cpu_devices[:2])
    rng = np.random.default_rng(11)
    batches = rng.integers(0, 256, (2, micro, seq), dtype=np.int32)
    np.save(tmp_path / "batches.npy", batches)
    want = {}
    for bits in (0, 8):
        jtrainer = jts.build_trainer(
            jllama.Llama(jcfg), optax.sgd(0.1), mesh,
            jnp.zeros((micro, seq), jnp.int32), jllama.cross_entropy_loss,
            micro_batch=micro, grad_reduce_bits=bits)
        jstate = jtrainer.init(jax.random.PRNGKey(0))
        if bits == 0:
            np.savez(tmp_path / "init.npz", **{
                k: v.numpy() for k, v in convert.params_from_jax(
                    jax.tree.map(np.asarray, jstate.params)).items()})
        losses, norms = [], []
        for tokens in batches:
            jstate, m = jtrainer.step(jstate, *jtrainer.shard_batch(
                tokens, np.ascontiguousarray(tokens[:, ::-1])))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        want[bits] = (losses, norms, {
            k: v.numpy() for k, v in convert.params_from_jax(
                jax.tree.map(np.asarray, jstate.params)).items()})
    out = run_workers(tmp_path, DCN_WORKER, 2, args=(
        tmp_path / "init.npz", tmp_path / "batches.npy"), name="dcn")
    n_leaves = len(want[0][2])
    for r in out:
        assert r["losses"] == out[0]["losses"]
        assert r["split_same_bits"]
        for bits in (0, 8):
            key = str(bits)
            np.testing.assert_allclose(r["losses"][key], want[bits][0],
                                       rtol=1e-4)
            np.testing.assert_allclose(r["norms"][key], want[bits][1],
                                       rtol=1e-4)
            for name, value in want[bits][2].items():
                np.testing.assert_allclose(
                    np.asarray(r["params"][key][name], np.float32), value,
                    atol=1e-4, err_msg=f"{name} at bits {bits}")
            # one explicit mean a leaf a step, at the step's bits
            assert r["calls"][key] == [[bits], 2 * n_leaves]
        # the same first batch and parameters: the same first loss
        assert r["losses"]["8"][0] == r["losses"]["0"][0]
        exact, quant = r["norms"]["0"], r["norms"]["8"]
        assert all(abs(q - e) <= e / 127 for q, e in zip(quant, exact))


# ---------------------------------------------------------------------------
# in-process acceptance: losing a slice does not lose the fleet
# ---------------------------------------------------------------------------


SLICE_WORKER = """
import os, sys, time
sys.path.insert(0, {repo!r})
from dlrover_tpu_torch.agent.preemption import DrainRequestSource

with open({out!r}, "a") as f:
    f.write("spawn pid=%d slice=%s world=%s\\n" % (
        os.getpid(), os.environ.get("DLROVER_TPU_SLICE_ID"),
        os.environ.get("DLROVER_TPU_WORLD_SIZE")))
drain = DrainRequestSource()
while True:
    request = drain.poll()
    if request is not None and request.get("exit", True):
        sys.exit(76)
    time.sleep(0.05)
"""


def _wait_until(predicate, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_slice_loss_degraded_step_reform_and_catch_up(tmp_path):
    """Two slices of one agent each under the port's master: the whole of
    slice 0 goes silent. The survivor's world, generation and worker pid
    stay; its real sync takes a degraded step counted by the master;
    slice 0 re-forms alone with its generation bumped and catches up to
    the fleet step through the state handoff. Every wait is bounded."""
    from dlrover_tpu_torch.agent.elastic_agent import ElasticAgent, WorkerSpec
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.job_master import JobMaster

    Context.singleton().update(dead_node_timeout_s=2.0,
                               dcn_sync_timeout_s=0.5,
                               dcn_sync_poll_s=0.02)
    master = JobMaster(min_nodes=1, max_nodes=2, host="127.0.0.1")
    master.prepare()
    mgr = master.rdzv_managers[RendezvousName.TRAINING]
    logs = {rank: str(tmp_path / f"worker{rank}.log") for rank in (0, 1)}
    clients, agents, threads = {}, {}, {}

    def spawn(rank):
        clients[rank] = MasterClient(master.addr, node_id=rank,
                                     node_rank=rank, slice_id=rank)
        script = SLICE_WORKER.format(repo=REPO, out=logs[rank])
        agents[rank] = ElasticAgent(clients[rank], WorkerSpec(
            entrypoint=[sys.executable, "-c", script],
            monitor_interval_s=0.3, rdzv_timeout_s=30.0,
            shutdown_grace_s=2.0, enable_monitors=False))
        threads[rank] = threading.Thread(target=agents[rank].run,
                                         daemon=True)
        threads[rank].start()

    try:
        for rank in (0, 1):
            spawn(rank)
        _wait_until(lambda: agents[0].last_world == {0: 1}
                    and agents[1].last_world == {1: 1}
                    and agents[1].worker_pid is not None, 30.0,
                    "both slice worlds")
        survivor_pid = agents[1].worker_pid
        assert mgr.slice_status()["slices"]["1"]["generation"] == 1
        sync = tdcn.SliceGradSync(clients[1], 1)
        # the fleet at step 5, whole
        clients[0].kv_set("dcn/g0/grads/0", tdcn.encode_leaves(
            [np.full((4,), 2.0, np.float32)], 5))
        reduced, info = sync.reduce([np.full((4,), 4.0, np.float32)], 5)
        assert not info["degraded"] and info["present"] == [0, 1]
        np.testing.assert_allclose(reduced[0], 3.0)
        clients[1].report_global_step(5, step_time_s=0.1)

        # slice 0 goes silent, as when its machines are taken
        agents[0].shutdown()
        threads[0].join(timeout=10.0)
        clients[0].close()
        _wait_until(lambda: not mgr.slice_status()["slices"]["0"]["formed"],
                    15.0, "slice 0 to be reaped")
        # the survivor's real sync against the real master: degraded
        reduced, info = sync.reduce([np.full((4,), 6.0, np.float32)], 6)
        np.testing.assert_allclose(reduced[0], 6.0)
        assert info["degraded"] and info["absent"] == [0]
        clients[1].report_global_step(6, step_time_s=0.1,
                                      degraded_steps=sync.drain_unreported())
        # the master's ledger and its counter (in this one process the
        # counter also holds the sync's own increment: 2)
        assert master.goodput_ledger.snapshot()["degraded_steps_total"] == 1
        assert ('dlrover_tpu_slice_degraded_steps_total{slice="1"} 2'
                in tobs.get_registry().render())
        status = mgr.slice_status()
        assert status["slices"]["1"] == {"formed": True, "ranks": [1],
                                         "generation": 1,
                                         "draining": False}
        assert mgr.num_nodes_waiting(1) == 0

        # slice 0 re-forms alone, its generation bumped
        spawn(0)
        _wait_until(lambda: agents[0].last_world == {0: 1}, 30.0,
                    "slice 0 to re-form")
        status = mgr.slice_status()
        assert status["slices"]["0"]["generation"] == 2
        assert status["slices"]["1"]["generation"] == 1
        assert agents[1].worker_pid == survivor_pid
        with open(logs[1]) as f:
            assert f.read().count("spawn") == 1

        # the catch-up: restored at step 2, slice 0 asks; the survivor's
        # next sync publishes its state of step 6
        rejoiner = tdcn.SliceGradSync(clients[0], 0)
        caught = {}
        thread = threading.Thread(target=lambda: caught.update(
            result=rejoiner.catch_up(2, timeout_s=10.0)))
        thread.start()
        fleet_state = [np.arange(6, dtype=np.float32)]
        _wait_until(lambda: clients[1].kv_get(
            f"dcn/g{mgr.world_epoch}/rejoin"), 10.0, "the rejoin request")
        sync.reduce([np.full((4,), 1.0, np.float32)], 7,
                    state_leaves_fn=lambda: fleet_state)
        thread.join(timeout=15.0)
        leaves, step = caught["result"]
        assert step == 6
        np.testing.assert_array_equal(leaves[0], fleet_state[0])
    finally:
        for agent in agents.values():
            agent.shutdown()
        for thread in threads.values():
            thread.join(timeout=10.0)
        for client in clients.values():
            try:
                client.close()
            except Exception:  # noqa: BLE001 — closed already
                pass
        master.stop(grace_s=0.1)


def test_chip_smoke_slice_phase_on_cpu(monkeypatch):
    """The card phase's flow on the CPU: two ``run --slice-id`` agents of
    the nano GPT under the port's master through the loop's slice step,
    kill:slice:0, degraded steps, slice 0's re-formation, peer restore
    and catch-up, and both slices' parameters bit for bit at the end
    (``slice_finish`` checks each and raises on a miss)."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    import chip_smoke

    out = chip_smoke.slice_finish(chip_smoke.slice_start("cpu rehearsal",
                                                         device="cpu"))
    assert out["degraded"] >= 1


def test_auto_planner_prices_the_int8_reduce_across_slices(monkeypatch):
    """The analysis counts the slices the launcher states
    (``DLROVER_TPU_NUM_SLICES``; a card reports none of its own), and with
    two the engine plans the int8 cross-slice reduce as one more
    candidate, as the JAX planner does for two granules."""
    import functools

    from dlrover_tpu_torch.auto.engine import analyser, planner
    from dlrover_tpu_torch.auto.model_context import ModelContext
    from dlrover_tpu_torch.models import llama as tl

    ctx = ModelContext(functools.partial(tl.Llama, tl.LlamaConfig.tiny()),
                       loss_fn=tl.cross_entropy_loss,
                       sample_batch=np.zeros((2, 16), np.int64),
                       devices=["cpu"] * 2)
    int8 = ("quant_allreduce", {"bits": 8})
    assert analyser.analyse(ctx)["n_dcn_granules"] == 1
    assert not any(int8 in c for c in planner.plan_candidates(ctx))
    monkeypatch.setenv(NodeEnv.NUM_SLICES, "2")
    assert analyser.analyse(ctx)["n_dcn_granules"] == 2
    assert any(int8 in c for c in planner.plan_candidates(ctx))
