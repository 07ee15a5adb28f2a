"""Re-planning on resize in the port against the JAX package
(``tests/test_replan.py``'s cases, each held against the reference).

- The planner (``parallel/planner.py``): the same inputs give the same
  plan as identical JSON, over worlds 1-16 and primes, one and two
  slices, with and without an HBM budget, a previous plan and learned
  discounts; the JAX tests' properties hold on the port's plans.
- The calibration (``parallel/calibration.py``): ``export_state`` equal
  under one fake clock, and each package restores the other's.
- The master: join results, ``ShardPlanRequest`` answers, the epoch bump
  on a membership loss, re-plan detection with its ledger attribution,
  the plan across a failover and the HBM budget, all equal to the JAX
  master's for the same joins and departures; ``reanchor_plan``.
- The striped transfer: stripe plans, ranges, a striped fetch bit for
  bit, a dead donor's key missing and never wrong, the range request's
  full-shard CRC.
- The loop on a tiny Llama (``device="cpu"``): the plan decisions of
  both loops for the same plans; a mesh-changing migration on two gloo
  ranks, bit for bit the checkpoint path's state; the batch adjustment
  and the sampler; the loud fallbacks (three gloo ranks); a plain
  relaunch not priced as a resize; ``replan_enabled=False``.
- Chaos ``resize`` parsing and firing; the ledger's replan grouping.

Tolerances: plans, calibration state and wire bytes are compared exact;
states and losses bit for bit. The three-agent acceptance over real
processes is marked ``slow``, as the JAX test is.
"""

import functools
import json
import os
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from dlrover_tpu.common import messages as J
from dlrover_tpu.common.config import Context as JContext
from dlrover_tpu.diagnostics import chaos as jchaos
from dlrover_tpu.master.rendezvous import (
    ElasticTrainingRendezvousManager as JRendezvous,
)
from dlrover_tpu.master.servicer import MasterServicer as JServicer
from dlrover_tpu.master.speed_monitor import SpeedMonitor as JSpeedMonitor
from dlrover_tpu.parallel import calibration as jcal
from dlrover_tpu.parallel import planner as jplanner
from dlrover_tpu_torch import obs
from dlrover_tpu_torch.checkpoint import peer_restore as T_peer
from dlrover_tpu_torch.common import messages as T
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import (
    NodeEnv,
    RendezvousName,
    WorkerExit,
)
from dlrover_tpu_torch.diagnostics import chaos as tchaos
from dlrover_tpu_torch.master.rendezvous import (
    ElasticTrainingRendezvousManager,
)
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.parallel import calibration as tcal
from dlrover_tpu_torch.parallel import planner
from test_torch_mesh import run_workers

REPO = str(Path(__file__).resolve().parent.parent)
TRAIN = RendezvousName.TRAINING

PROFILE_KW = dict(param_count=110_000, param_bytes=440_000,
                  flops_per_token=6.6e5, peak_flops_per_chip=1e12,
                  seq_len=32, global_batch=12)
PROFILE = planner.ModelProfile(**PROFILE_KW)
JPROFILE = jplanner.ModelProfile(**PROFILE_KW)


def _world(n, chips=1):
    return {r: chips for r in range(n)}


def _same(a, b):
    """Plans as the wire carries them: identical JSON."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.fixture(autouse=True)
def contexts(monkeypatch, tmp_path):
    """Fresh Context singletons of both packages, no plan or peer cache
    inherited from the environment, the flight dumps under the test's
    directory, one torch thread."""
    for key in (NodeEnv.SHARD_PLAN_FILE, NodeEnv.PEER_CACHE_DIR,
                NodeEnv.RESTORE_PLAN_FILE, "DLROVER_TPU_CHAOS_STATE",
                NodeEnv.RESIZE_REQUEST_FILE):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DLROVER_TPU_RDZV_SHARDED", "0")
    JContext.reset()
    Context.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    JContext.reset()
    Context.reset()


# ---------------------------------------------------------------------------
# the planner: identical plans, and the JAX tests' properties
# ---------------------------------------------------------------------------


GRID_WORLDS = list(range(1, 17)) + [17, 19, 23]


@pytest.mark.parametrize("slices", [1, 2])
@pytest.mark.parametrize("hbm", [0, 3_000_000])
@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("discounts", [None, {"fsdp": 0.8, "tensor": 1.3,
                                              "data": 0.5}])
def test_plans_match_jax_over_grid(slices, hbm, with_prev, discounts):
    """Worlds 1-16 and primes, one chip or two a rank: the port's plan is
    the JAX planner's as identical JSON, and so are the helpers' answers
    on the way."""
    kw = dict(PROFILE_KW, hbm_bytes_per_chip=hbm, tensor_divisor=4,
              fsdp_divisor=64, max_micro_per_replica=2)
    profile, jprofile = (planner.ModelProfile(**kw),
                         jplanner.ModelProfile(**kw))
    for n in GRID_WORLDS:
        for chips in (1, 2):
            world = _world(n, chips)
            prev = jprev = None
            if with_prev:
                prev = planner.plan_parallelism(_world(n + 1), profile,
                                                slices=slices)
                jprev = jplanner.plan_parallelism(_world(n + 1), jprofile,
                                                  slices=slices)
                assert _same(prev, jprev)
            got = planner.plan_parallelism(
                world, profile, slices=slices, prev_plan=prev,
                generation=n, epoch=chips, round_=n + 1,
                axis_discounts=discounts)
            want = jplanner.plan_parallelism(
                world, jprofile, slices=slices, prev_plan=jprev,
                generation=n, epoch=chips, round_=n + 1,
                axis_discounts=discounts)
            assert _same(got, want), (n, chips)
            assert planner.slice_mesh(got) == jplanner.slice_mesh(want)
            assert (planner.validate_plan(got, n * chips)
                    == jplanner.validate_plan(want, n * chips))
            assert planner.plans_equivalent(got, prev) == \
                jplanner.plans_equivalent(want, jprev)


def test_helpers_match_jax():
    for chips in (1, 6, 12, 13, 16):
        for slices in (1, 2, 3):
            got = [c.as_dict() for c in planner.enumerate_meshes(
                chips, slices=slices, max_tensor=4, max_pipe=2)]
            want = [c.as_dict() for c in jplanner.enumerate_meshes(
                chips, slices=slices, max_tensor=4, max_pipe=2)]
            assert got == want
    for requested in (0, 3, 10, 12):
        for dp in (0, 1, 4, 5, 13):
            assert (planner.adjust_global_batch(requested, dp)
                    == jplanner.adjust_global_batch(requested, dp))
    for batch, dp, micro in ((12, 2, 2), (16, 4, 8), (9, 3, 1), (8, 8, 0)):
        assert (planner.choose_accum(batch, dp, micro)
                == jplanner.choose_accum(batch, dp, micro))
    prev = {"dcn": 1, "data": 6, "fsdp": 1, "tensor": 1, "pipe": 1}
    for mesh in planner.enumerate_meshes(6):
        jmesh = jplanner.MeshCandidate(**mesh.as_dict())
        assert (planner.score_candidate(mesh, PROFILE, prev, 3)
                == jplanner.score_candidate(jmesh, JPROFILE, prev, 3))
        assert (planner.migration_bytes(mesh, prev, PROFILE, 3, 6)
                == jplanner.migration_bytes(jmesh, prev, JPROFILE, 3, 6))
    got = list(planner.iter_feasible_worlds([1, 5, 7], PROFILE))
    want = list(jplanner.iter_feasible_worlds([1, 5, 7], JPROFILE))
    assert json.dumps(got) == json.dumps(want)


class TestPlanner:
    @pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12,
                                   13, 16, 17, 19, 23, 24])
    def test_any_world_size_is_feasible(self, n):
        plan = planner.plan_parallelism(_world(n), PROFILE)
        assert _same(plan, jplanner.plan_parallelism(_world(n), JPROFILE))
        assert plan["feasible"], (n, plan)
        mesh = plan["mesh"]
        total = (mesh["dcn"] * mesh["data"] * mesh["fsdp"]
                 * mesh["tensor"] * mesh["pipe"])
        assert total == n
        batch = plan["global_batch"]
        assert batch > 0 and batch % plan["dp"] == 0
        assert batch <= PROFILE.global_batch
        assert plan["batch_adjusted"] == (batch != PROFILE.global_batch)
        assert plan["accum_steps"] * plan["micro_batch"] == batch

    def test_deterministic(self):
        a = planner.plan_parallelism(_world(7), PROFILE)
        b = planner.plan_parallelism(_world(7), PROFILE)
        assert a == b
        assert _same(a, jplanner.plan_parallelism(_world(7), JPROFILE))

    def test_divisor_friendly_batch_preserved(self):
        plan = planner.plan_parallelism(_world(6), PROFILE)
        assert plan["global_batch"] == 12 and not plan["batch_adjusted"]
        assert _same(plan, jplanner.plan_parallelism(_world(6), JPROFILE))

    def test_dim_divisor_filters_tensor_and_fsdp(self):
        kw = dict(param_count=110_000, param_bytes=440_000, seq_len=32,
                  global_batch=12, tensor_divisor=4, fsdp_divisor=64)
        for n in (3, 5, 6, 7, 9, 12):
            plan = planner.plan_parallelism(_world(n),
                                            planner.ModelProfile(**kw))
            assert _same(plan, jplanner.plan_parallelism(
                _world(n), jplanner.ModelProfile(**kw)))
            mesh = plan["mesh"]
            assert mesh["tensor"] == 1 or 4 % mesh["tensor"] == 0
            assert mesh["fsdp"] == 1 or 64 % mesh["fsdp"] == 0

    def test_memory_budget_forces_state_sharding(self):
        kw = dict(param_count=250_000_000, param_bytes=10 ** 9,
                  seq_len=128, global_batch=32, hbm_bytes_per_chip=10 ** 9)
        plan = planner.plan_parallelism(_world(8),
                                        planner.ModelProfile(**kw))
        assert _same(plan, jplanner.plan_parallelism(
            _world(8), jplanner.ModelProfile(**kw)))
        mesh = plan["mesh"]
        assert plan["feasible"]
        assert mesh["fsdp"] * mesh["tensor"] * mesh["pipe"] >= 4

    def test_nothing_fits_is_loud_not_silent(self):
        kw = dict(param_count=10 ** 10, param_bytes=4 * 10 ** 10,
                  seq_len=128, global_batch=2, hbm_bytes_per_chip=10 ** 6)
        plan = planner.plan_parallelism(_world(2),
                                        planner.ModelProfile(**kw))
        assert _same(plan, jplanner.plan_parallelism(
            _world(2), jplanner.ModelProfile(**kw)))
        assert not plan["feasible"] and plan["reason"] and plan["mesh"]

    def test_migration_prefers_keeping_the_sharding(self):
        kw = dict(param_count=110_000, param_bytes=440_000, seq_len=32,
                  global_batch=12)
        prev = planner.plan_parallelism(_world(6),
                                        planner.ModelProfile(**kw))
        nxt = planner.plan_parallelism(_world(3),
                                       planner.ModelProfile(**kw),
                                       prev_plan=prev)
        jprev = jplanner.plan_parallelism(_world(6),
                                          jplanner.ModelProfile(**kw))
        assert _same(nxt, jplanner.plan_parallelism(
            _world(3), jplanner.ModelProfile(**kw), prev_plan=jprev))
        assert not nxt["resharded"]
        assert [nxt["mesh"][k] for k in ("fsdp", "tensor", "pipe")] == [
            prev["mesh"][k] for k in ("fsdp", "tensor", "pipe")]

    def test_slice_world_pins_dcn(self):
        plan = planner.plan_parallelism({r: 4 for r in range(4)}, PROFILE,
                                        slices=2)
        assert _same(plan, jplanner.plan_parallelism(
            {r: 4 for r in range(4)}, JPROFILE, slices=2))
        assert plan["mesh"]["dcn"] == 2
        local = planner.slice_mesh(plan)
        assert local["dcn"] == 1 and local["data"] == plan["mesh"]["data"]

    def test_adjust_global_batch_rounds_down_never_up(self):
        assert planner.adjust_global_batch(12, 5) == (10, True)
        assert planner.adjust_global_batch(12, 4) == (12, False)
        assert planner.adjust_global_batch(3, 5) == (0, True)

    def test_validate_plan_catches_mismatches(self):
        plan = planner.plan_parallelism(_world(4), PROFILE)
        for devices, bad in ((4, None), (6, True)):
            assert (planner.validate_plan(plan, devices) is None) == (
                bad is None)
        assert planner.validate_plan({}, 4) is not None
        broken = dict(plan, total_devices=5)
        assert planner.validate_plan(broken, 4) == \
            jplanner.validate_plan(broken, 4) is not None

    def test_prime_world_larger_than_batch_rescues_with_tensor(self):
        plan = planner.plan_parallelism(_world(13), PROFILE)
        assert _same(plan, jplanner.plan_parallelism(_world(13), JPROFILE))
        assert plan["feasible"] and plan["dp"] == 1
        assert plan["mesh"]["tensor"] == 13
        assert plan["global_batch"] == 12


# ---------------------------------------------------------------------------
# the calibration
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self, start=1.7e9):
        self.now = start

    def __call__(self):
        self.now += 0.5
        return self.now


def _calibration_script(cal, plans):
    """The same plans and step reports through one calibration: stamped
    plans (a re-stamp and an infeasible one among them), samples by
    generation, a straggling old-generation report, a fallback worker's
    (-2) and a pre-field sender's (-1)."""
    for i, plan in enumerate(plans):
        cal.observe_plan(plan)
        cal.observe_plan(plan)                # a re-stamp
        for k in range(4):
            cal.observe_step(0.1 * (i + 1) + 0.01 * k, mfu=0.3 + 0.01 * k,
                             plan_generation=plan["generation"])
        cal.observe_step(9.0, plan_generation=-2)
        cal.observe_step(0.5 + i, mfu=-1.0, plan_generation=-1)
    cal.observe_step(7.0, plan_generation=plans[0]["generation"])
    cal.observe_plan({"feasible": False, "mesh": {"data": 1}})
    cal.observe_step(0.0, plan_generation=plans[-1]["generation"])


def _calibration_plans(module):
    profile = module.ModelProfile(**dict(PROFILE_KW, tensor_divisor=4,
                                         fsdp_divisor=64))
    plans = []
    for gen, (n, kw) in enumerate([
            (4, {}), (4, {"max_tensor": 1}), (2, {}), (6, {}),
            (4, {"axis_discounts": {"data": 0.7, "tensor": 1.2}})]):
        plans.append(module.plan_parallelism(_world(n), profile,
                                             generation=gen, **kw))
    # a tensor shape, so that an axis learns a discount
    plans.append(dict(plans[-1], generation=9,
                      mesh={"dcn": 1, "data": 2, "fsdp": 1, "tensor": 2,
                            "pipe": 1}))
    return plans


def test_plan_signature_matches_jax():
    for plan in _calibration_plans(planner) + [{}, {"mesh": None}]:
        assert tcal.plan_signature(plan) == jcal.plan_signature(plan)


def test_calibration_state_matches_jax_under_one_clock():
    port = tcal.PlanCalibration(clock=FakeClock(), min_samples=2)
    ref = jcal.PlanCalibration(clock=FakeClock(), min_samples=2)
    _calibration_script(port, _calibration_plans(planner))
    _calibration_script(ref, _calibration_plans(jplanner))
    assert json.dumps(port.export_state()) == json.dumps(ref.export_state())
    assert port.table() == ref.table()
    assert port.current() == ref.current()
    assert port.axis_discounts() == ref.axis_discounts()
    assert port.axis_discounts(min_samples=9) == \
        ref.axis_discounts(min_samples=9) == {}
    assert port.axis_discounts(), "no axis learned a discount"
    assert port.min_samples == ref.min_samples == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_calibration_restores_the_other_packages_state(writer):
    """Each package restores the other's exported state (through JSON, as
    the snapshot carries it) and exports it back unchanged."""
    port = tcal.PlanCalibration(clock=FakeClock())
    ref = jcal.PlanCalibration(clock=FakeClock())
    _calibration_script(port, _calibration_plans(planner))
    _calibration_script(ref, _calibration_plans(jplanner))
    source = ref if writer == "jax" else port
    state = json.loads(json.dumps(source.export_state()))
    reader = (tcal.PlanCalibration() if writer == "jax"
              else jcal.PlanCalibration())
    reader.restore_state(state)
    assert json.loads(json.dumps(reader.export_state())) == state
    assert reader.table() == source.table()
    assert reader.axis_discounts() == source.axis_discounts()
    # a report for a restored generation lands on its restored entry
    generation = source.current()["generation"]
    reader.observe_step(0.25, plan_generation=generation)
    assert reader.current()["samples"] == source.current()["samples"] + 1


def test_calibration_min_samples_is_the_context_knob():
    Context.singleton().update(calibration_min_samples=5)
    assert tcal.PlanCalibration().min_samples == 5
    JContext.singleton().update(calibration_min_samples=5)
    assert jcal.PlanCalibration().min_samples == 5


# ---------------------------------------------------------------------------
# the master: stamping, staleness, re-plan detection
# ---------------------------------------------------------------------------


def _model_info(m, batch=12):
    return m.ModelInfo(
        param_count=110_000, param_bytes=440_000, flops_per_step=1.0,
        batch_size=batch, seq_len=32, flops_per_token=6.6e5,
        peak_flops_per_chip=1e12, chips=5, flops_source="analytic",
        tensor_divisor=4, fsdp_divisor=64)


def _join(servicer, m, rank, chips=1):
    return servicer.report(m.JoinRendezvousRequest(
        node_id=rank, node_rank=rank, local_world_size=chips,
        rdzv_name=TRAIN))


def _both_servicers(**jkw):
    return ((JServicer(**jkw), J, JRendezvous),
            (MasterServicer(), T, ElasticTrainingRendezvousManager))


class TestMasterPlan:
    def test_join_result_carries_the_plan(self):
        results = []
        for servicer, m, _ in _both_servicers():
            servicer.report(_model_info(m))
            results.append(_join(servicer, m, 0, chips=5).shard_plan_json)
        assert results[0] == results[1]
        plan = json.loads(results[1])
        assert plan["feasible"] and plan["total_devices"] == 5
        assert plan["global_batch"] % plan["dp"] == 0

    def test_plan_rpc_reflects_the_cut_world(self):
        answers = []
        for servicer, m, _ in _both_servicers():
            servicer.report(_model_info(m))
            for rank in range(3):
                _join(servicer, m, rank)
            answers.append(servicer.get(m.ShardPlanRequest(
                node_id=0, node_rank=0, rdzv_name=TRAIN)))
        got, want = answers
        assert (got.plan_json, got.epoch, got.generation, got.found) == (
            want.plan_json, want.epoch, want.generation, want.found)
        plan = json.loads(got.plan_json)
        assert got.found and plan["world_size"] == 3
        assert plan["total_devices"] == 3

    def test_membership_loss_bumps_plan_epoch(self):
        runs = []
        for servicer, m, _ in _both_servicers():
            mgr = servicer.rdzv_managers[TRAIN]
            servicer.report(_model_info(m))
            for rank in range(3):
                _join(servicer, m, rank)

            def ask():
                return servicer.get(m.ShardPlanRequest(
                    node_rank=0, rdzv_name=TRAIN)).plan_json

            before = ask()
            mgr.remove_alive_node(2)
            after = ask()
            mgr.remove_alive_node(1, graceful=True)
            runs.append((before, after, ask()))
        assert runs[0] == runs[1]
        before, after, last = (json.loads(p) for p in runs[1])
        assert after["epoch"] == before["epoch"] + 1
        assert after["world_size"] == 2 and last["world_size"] == 1

    def test_replan_detection_and_ledger_attribution(self):
        """A resize that changes the execution shape notes a ``replan``
        elasticity trigger and re-anchors the speed monitor; a re-stamp
        of the same shape and the formation's joins do not."""
        from dlrover_tpu.obs.goodput import GoodputLedger as JLedger
        from dlrover_tpu.obs.metrics import MetricsRegistry as JRegistry

        runs = []
        for ledger, servicer, m in (
                (lambda l: (l, JServicer(goodput_ledger=l), J))(
                    JLedger(registry=JRegistry())),
                (lambda l: (l, MasterServicer(goodput_ledger=l), T))(
                    obs.GoodputLedger(registry=obs.MetricsRegistry()))):
            mgr = servicer.rdzv_managers[TRAIN]
            mgr.update_rdzv_params(4, 4)
            servicer.report(_model_info(m))
            trace = []
            for rank in range(4):
                _join(servicer, m, rank)
                trace.append(mgr.compute_shard_plan(rank)[1])
            servicer.get(m.CommWorldRequest(node_id=0, rdzv_name=TRAIN))
            ledger.observe_world(1, 4)
            trace.append(mgr.compute_shard_plan(0)[1])
            mgr.remove_alive_node(3)
            plan, changed = mgr.compute_shard_plan(0)
            trace += [changed, mgr.compute_shard_plan(1)[1]]
            servicer._note_replan(plan)
            ledger.observe_world(10, 3)
            kinds = [inc["reason"] for inc in
                     ledger.snapshot()["incarnations"]]
            runs.append((trace, plan, kinds,
                         servicer.speed_monitor.export_state()))
        assert json.dumps(runs[0][:3]) == json.dumps(runs[1][:3])
        trace, plan, kinds, _ = runs[1]
        assert trace == [False] * 5 + [True, False]
        assert plan["world_size"] == 3 and "replan" in kinds
        want = runs[0][3]
        got = runs[1][3]
        assert {k: got[k] for k in want if k in got} == {
            k: want[k] for k in got if k in want}

    def test_profile_and_plan_survive_master_failover(self):
        """The manager's export carries the profile and the last plan:
        a restored manager of either package re-stamps the same plan,
        unchanged, and the two exports agree field for field."""
        for writer in ("jax", "port"):
            servicer, m, _ = _both_servicers()[writer == "port"]
            mgr = servicer.rdzv_managers[TRAIN]
            servicer.report(_model_info(m))
            for rank in range(3):
                _join(servicer, m, rank)
            plan, _ = mgr.compute_shard_plan(0)
            state = json.loads(json.dumps(mgr.export_state()))
            for fresh in (ElasticTrainingRendezvousManager(),
                          JRendezvous()):
                fresh.restore_state(state)
                restored, changed = fresh.compute_shard_plan(0)
                assert planner.plans_equivalent(plan, restored)
                assert not changed
                exported = json.loads(json.dumps(fresh.export_state()))
                for key in ("model_profile", "chip_hbm_bytes",
                            "last_plan", "known_chips", "world_epoch"):
                    assert exported[key] == state[key], (writer, key)

    def test_chip_hbm_feeds_the_memory_budget(self):
        for servicer, m, _ in _both_servicers():
            servicer.report(m.NodeResourceStats(
                node_id=0, node_rank=0,
                chip_stats=[m.ChipStats(index=0, hbm_total_mb=16.0)]))
            assert servicer.rdzv_managers[TRAIN]._chip_hbm_bytes == \
                16 * (1 << 20)

    def test_profile_after_the_cut_restamps_as_a_replan_as_jax(self):
        """Both masters (ROADMAP Queue C): a world planned before the
        first ModelInfo is re-stamped with the real batch when the profile
        arrives, and that counts as a re-plan (the ledger's ``replan``,
        the speed monitor's re-anchor) though no member came or went."""
        runs = []
        for servicer, m, _ in _both_servicers():
            mgr = servicer.rdzv_managers[TRAIN]
            mgr.update_rdzv_params(2, 2)
            for rank in (0, 1):
                _join(servicer, m, rank)
            servicer.get(m.CommWorldRequest(node_id=0, rdzv_name=TRAIN))
            before, changed_before = mgr.compute_shard_plan(0)
            servicer.report(_model_info(m, batch=8))
            after, changed = mgr.compute_shard_plan(1)
            runs.append((before["global_batch"], changed_before,
                         after["global_batch"], changed, after["mesh"]))
        assert runs[0] == runs[1]
        assert runs[1][:4] == (2, False, 8, True)

    def test_axis_discounts_enter_the_plan(self):
        """Pushed discounts are a planning input in both masters: the
        next plan carries them and the memo is recomputed."""
        plans = []
        for servicer, m, _ in _both_servicers():
            servicer.report(_model_info(m))
            for rank in range(4):
                _join(servicer, m, rank)
            servicer.push_axis_discounts({"data": 0.5})
            plans.append(servicer.get(m.ShardPlanRequest(
                node_rank=0, rdzv_name=TRAIN)).plan_json)
        assert plans[0] == plans[1]
        assert json.loads(plans[1])["axis_discounts"] == {"data": 0.5}


def test_client_wrappers_over_the_wire():
    """The agent's side: a join result's plan, ``get_shard_plan`` and
    ``get_plan_calibration`` against a live master of the port."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.job_master import JobMaster

    master = JobMaster(port=0, host="127.0.0.1")
    master.prepare()
    client = MasterClient(master.addr, node_id=0, node_rank=0)
    try:
        empty = client.get_shard_plan()
        assert not empty["feasible"] and empty["reason"] == "empty world"
        master.servicer.report(_model_info(T))
        client.join_rendezvous(local_world_size=2)
        joined = json.loads(client.last_shard_plan_json)
        plan = client.get_shard_plan()
        assert plan["total_devices"] == 2 and plan["feasible"]
        assert {k: plan[k] for k in ("mesh", "global_batch", "epoch")} == {
            k: joined[k] for k in ("mesh", "global_batch", "epoch")}
        table = client.get_plan_calibration()["table"]
        assert [row["total_devices"] for row in table] == [2]
    finally:
        client.close()
        master.stop()


# ---------------------------------------------------------------------------
# the speed monitor's re-anchor
# ---------------------------------------------------------------------------


class TestSpeedMonitorReanchor:
    def _both(self):
        return SpeedMonitor(), JSpeedMonitor()

    def test_peak_rescales_to_the_new_chip_count(self):
        for monitor in self._both():
            monitor.set_model_flops(1e5, 8e12, peak_flops_per_chip=1e12)
            monitor.set_tokens_per_step(12 * 32, seq_len=32)
            monitor.reanchor_plan(chips=5, tokens_per_step=10 * 32)
            state = monitor.export_state()
            assert state["peak_flops_total"] == pytest.approx(5e12)
            assert state["tokens_per_step"] == 10 * 32
            assert monitor.seq_len_hint == 32

    def test_reanchor_resets_windowed_evidence(self):
        for monitor in self._both():
            monitor.collect_worker_step(0, 5, step_time_s=0.1)
            monitor.collect_worker_step(0, 10, step_time_s=0.1)
            assert monitor.worker_speeds()
            monitor.reanchor_plan(chips=2)
            assert not monitor.worker_speeds()
            monitor.collect_global_step(20)
            assert monitor.running_speed() == 0.0
            assert monitor.peak_speed() == 0.0

    def test_reanchor_without_per_chip_peak_is_a_noop_on_peak(self):
        for monitor in self._both():
            monitor.set_model_flops(1e5, 8e12)
            monitor.reanchor_plan(chips=5)
            assert monitor.export_state()["peak_flops_total"] == 8e12


# ---------------------------------------------------------------------------
# the striped transfer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_state():
    """A tiny Llama's trainer state on the CPU, Adam moments filled."""
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    trainer = build_trainer(
        functools.partial(Llama, cfg),
        lambda p: torch.optim.AdamW(p, lr=1e-3), None,
        np.zeros((4, 16), np.int64), cross_entropy_loss, micro_batch=4,
        device="cpu")
    state = trainer.init(2)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16))
    state, _ = trainer.step(state, *trainer.shard_batch(tokens, tokens))
    return state


def _wanted(state):
    return {key: T_peer.host_copy(leaf).numel()
            * T_peer.host_copy(leaf).element_size()
            for key, leaf in T_peer.shard_items(state)}


def _bytes(leaf):
    return bytes(T_peer._byte_view(T_peer.host_copy(leaf).contiguous()))


class TestStripedTransfer:
    def test_stripe_plan_lists_every_holder(self):
        plans = []
        for mgr in (ElasticTrainingRendezvousManager(), JRendezvous()):
            for rank in (0, 1, 2):
                mgr.add_alive_node(rank)
                mgr.register_peer_store(rank, f"h{rank}:1", 7,
                                        ["k1", "k2"], total_bytes=10)
            plans.append((mgr.compute_restore_plan(3, stripe=True),
                          mgr.compute_restore_plan(1, stripe=True)))
        assert plans[0] == plans[1]
        plan, own = plans[0]
        assert plan["mode"] == "stripe"
        entry = plan["entries"]["k1"]
        assert sorted(entry["ranks"]) == [0, 1, 2]
        assert len(entry["addrs"]) == 3 and entry["tier"] == "striped"
        assert own["entries"]["k1"]["tier"] == "local"

    def test_stripe_ranges_partition_exactly(self):
        from dlrover_tpu.checkpoint.peer_restore import (
            _stripe_ranges as j_ranges,
        )

        for nbytes, parts in ((10, 3), (1, 4), (1000, 7), (8, 8)):
            ranges = T_peer._stripe_ranges(nbytes, parts)
            assert ranges == j_ranges(nbytes, parts)
            assert sum(length for _, length in ranges) == nbytes
            offset = 0
            for off, length in ranges:
                assert off == offset and length > 0
                offset += length

    def test_striped_fetch_reassembles_bitwise(self, tiny_state,
                                               tmp_path):
        store = T_peer.PeerStateStore(str(tmp_path / "cache"))
        assert store.stage(5, tiny_state)
        donors = [T_peer.PeerDonorServer(store.directory, port=0)
                  for _ in range(2)]
        addrs = [d.start() for d in donors]
        try:
            wanted = _wanted(tiny_state)
            plan = {"step": 5, "mode": "stripe", "entries": {
                key: {"ranks": [0, 1], "addrs": addrs, "tier": "striped"}
                for key in wanted}}
            got, donor_bytes, missing = T_peer.fetch_shards(plan, wanted)
            assert not missing
            for key, leaf in T_peer.shard_items(tiny_state):
                assert bytes(got[key]) == _bytes(leaf), key
            assert all(donor_bytes.get(a, 0) > 0 for a in addrs)
        finally:
            for donor in donors:
                donor.stop()

    def test_striped_fetch_with_a_dead_donor_is_missing_not_wrong(
            self, tiny_state, tmp_path):
        store = T_peer.PeerStateStore(str(tmp_path / "cache"))
        assert store.stage(5, tiny_state)
        donor = T_peer.PeerDonorServer(store.directory, port=0)
        addr = donor.start()
        try:
            wanted = _wanted(tiny_state)
            # the second donor is a dead address: its ranges fail, so the
            # key is MISSING (the checkpoint's territory), never wrong
            plan = {"step": 5, "mode": "stripe", "entries": {
                key: {"ranks": [0, 1], "addrs": [addr, "127.0.0.1:9"],
                      "tier": "striped"} for key in wanted}}
            got, _, missing = T_peer.fetch_shards(plan, wanted)
            assert sorted(missing) == sorted(
                k for k, n in wanted.items() if n > 0)
            assert all(wanted[k] == 0 for k in got)
        finally:
            donor.stop()

    def test_range_request_carries_full_shard_crc(self, tiny_state,
                                                  tmp_path):
        store = T_peer.PeerStateStore(str(tmp_path / "cache"))
        assert store.stage(9, tiny_state)
        manifest = T_peer.load_manifest(store.directory)
        key = sorted(manifest["shards"])[0]
        meta = manifest["shards"][key]
        donor = T_peer.PeerDonorServer(store.directory, port=0)
        addr = donor.start()
        try:
            conn = T_peer._DonorConnection(addr, timeout_s=5.0)
            try:
                header, data = conn.request(
                    {"op": "shard", "key": key, "step": 9, "offset": 1,
                     "length": 3})
                assert header["ok"] and len(data) == 3
                assert header["crc32"] == meta["crc32"]
                assert header["total_nbytes"] == meta["nbytes"]
                header, _ = conn.request(
                    {"op": "shard", "key": key, "step": 9,
                     "offset": meta["nbytes"], "length": 10})
                assert not header["ok"]
            finally:
                conn.close()
        finally:
            donor.stop()


# ---------------------------------------------------------------------------
# the loop: plan application, migration, loud fallbacks
# ---------------------------------------------------------------------------


def _adamw(params):
    return torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-4)


def _port_loop(tmp_path, batch, ckpt="", **kw):
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )

    cfg = LlamaConfig.tiny(dtype=torch.float32)
    return ElasticTrainLoop(
        functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
        TrainLoopConfig(global_batch=batch, seq_len=16,
                        max_micro_per_replica=4, checkpoint_dir=ckpt,
                        save_interval_steps=1, report_interval_steps=1,
                        **kw), device="cpu")


def _jax_loop(cpu_devices, batch, n_devices=1):
    import jax.numpy as jnp
    import optax

    from dlrover_tpu.models import llama as jllama
    from dlrover_tpu.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )

    cfg = jllama.LlamaConfig.tiny(attn_impl="reference", dtype=jnp.float32)
    return ElasticTrainLoop(
        jllama.Llama(cfg), optax.adamw(1e-3), jllama.cross_entropy_loss,
        TrainLoopConfig(global_batch=batch, seq_len=16,
                        max_micro_per_replica=4),
        devices=cpu_devices[:n_devices])


def _events(name):
    return [e for e in obs.get_flight_recorder().snapshot()
            if e.get("kind") == "event" and e.get("name") == name]


def _jevents(name):
    from dlrover_tpu import obs as jobs

    return [e for e in jobs.get_flight_recorder().snapshot()
            if e.get("kind") == "event" and e.get("name") == name]


def _profile(batch, module=planner, **kw):
    return module.ModelProfile(**dict(
        dict(param_count=110_000, param_bytes=440_000,
             flops_per_token=6.6e5, peak_flops_per_chip=1e12, seq_len=16,
             global_batch=batch, tensor_divisor=4, fsdp_divisor=64), **kw))


def _decision(loop, events, seen):
    fallback = events("replan_fallback")[seen:]
    return {"applied": loop._replan_applied,
            "changed": loop._replan_changed,
            "batch": loop.global_batch, "trim": loop._trim_batch,
            "dp": loop.dp, "planned": loop._shard_plan is not None,
            "fallback": fallback[-1]["attrs"]["reason"] if fallback
            else ""}


PLAN_CASES = {
    # one rank of one card: the whole mesh applies
    "world-1": lambda p: p.plan_parallelism(_world(1), _profile(8, p)),
    # four ranks of one card each, this process one of them: replica
    # mode applies the (trimmed) batch alone
    "replica-4": lambda p: p.plan_parallelism(
        _world(4), _profile(10, p, tensor_divisor=1, fsdp_divisor=1),
        max_tensor=1, max_pipe=1),
    # a plan computed before the master knew the batch
    "stale-profile": lambda p: p.plan_parallelism(_world(2),
                                                  p.ModelProfile()),
    # one rank with four cards: not this process's world
    "mismatch": lambda p: p.plan_parallelism(_world(1, chips=4),
                                             _profile(8, p)),
    "infeasible": lambda p: {
        "feasible": False, "reason": "nothing fits",
        "mesh": {"dcn": 1, "data": 4, "fsdp": 1, "tensor": 1, "pipe": 1},
        "total_devices": 4, "world_size": 1, "global_batch": 0},
    # a replica world wider than the batch
    "dp-over-batch": lambda p: dict(
        p.plan_parallelism(_world(12), _profile(12, p)),
        requested_global_batch=99),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_decisions_match_jax(case, cpu_devices, tmp_path,
                                  monkeypatch):
    """The same plan file in front of each package's loop (one process,
    one device): the same application, batch, trim, dp and fallback."""
    decisions = []
    for which in ("jax", "port"):
        module = jplanner if which == "jax" else planner
        plan_file = tmp_path / f"{which}.json"
        plan_file.write_text(json.dumps(PLAN_CASES[case](module)))
        monkeypatch.setenv(NodeEnv.SHARD_PLAN_FILE, str(plan_file))
        batch = 10 if case == "replica-4" else 8
        events = _jevents if which == "jax" else _events
        seen = len(events("replan_fallback"))
        loop = (_jax_loop(cpu_devices, batch) if which == "jax"
                else _port_loop(tmp_path, batch))
        decisions.append(_decision(loop, events, seen))
        loop.close()
    want, got = decisions
    assert got == want
    assert got["applied"] == {"world-1": "mesh+batch",
                              "replica-4": "batch",
                              "stale-profile": "batch"}.get(case, "")


MIGRATE_WORKER = """
import json, os, sys, zlib
import numpy as np
import torch
from dlrover_tpu_torch import obs
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.checkpoint.peer_restore import shard_items
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.trainer.elastic_loop import ElasticTrainLoop, TrainLoopConfig
import functools

torch.set_num_threads(1)
init_distributed("cpu")
cfg = LlamaConfig.tiny(dtype=torch.float32)

def loop():
    return ElasticTrainLoop(
        functools.partial(Llama, cfg),
        lambda p: torch.optim.AdamW(p, lr=1e-3, weight_decay=1e-4),
        cross_entropy_loss,
        TrainLoopConfig(global_batch=8, seq_len=16, max_micro_per_replica=4,
                        max_steps=1, checkpoint_dir=sys.argv[1],
                        save_interval_steps=100), device="cpu")

def crc(state):
    value = 0
    for key, leaf in shard_items(state):
        local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
        value = zlib.crc32(local.detach().contiguous().numpy().tobytes(),
                           value)
    return value

migrated = loop()
state, start = migrated.restore_or_init(0)
out = {"applied": migrated._replan_applied,
       "changed": migrated._replan_changed, "dp": migrated.dp,
       "mesh": migrated.mesh.shape, "start": start,
       "source": migrated.last_restore_source,
       "timings": sorted(migrated.last_restore_timings),
       "stripe": migrated._peer_restorer.stripe, "crc": crc(state),
       "events": [e["name"] for e in obs.get_flight_recorder().snapshot()
                  if e["name"].startswith("replan")]}
Context.singleton().peer_restore_enabled = False
control = loop()
cstate, cstart = control.restore_or_init(0)
out.update(control_start=cstart, control_source=control.last_restore_source,
           control_crc=crc(cstate), control_changed=control._replan_changed)
rng = np.random.default_rng(7)
tokens = rng.integers(0, cfg.vocab_size, (8, 16), dtype=np.int64)
state, metrics = migrated.run(state, [(tokens, tokens)], start_step=start)
cstate, cmetrics = control.run(cstate, [(tokens, tokens)], start_step=cstart)
out.update(step=metrics["step"], loss=metrics["loss"],
           control_loss=cmetrics["loss"])
print(json.dumps(out))
"""


class TestLoopMigration:
    @pytest.fixture()
    def plan_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv(NodeEnv.PEER_CACHE_DIR, str(tmp_path / "peer"))
        plan_file = tmp_path / "shard_plan.json"
        monkeypatch.setenv(NodeEnv.SHARD_PLAN_FILE, str(plan_file))
        return plan_file

    def test_resize_migrates_bitwise_vs_checkpoint(self, tmp_path,
                                                   plan_env):
        """World 1 → 2 gloo ranks under a plan whose memory budget forces
        FSDP: the state migrates from the staged cut into the new
        sharding, bit for bit the checkpoint path's restore of the same
        step, and both train the same next step."""
        ckpt = str(tmp_path / "ckpt")
        first = _port_loop(tmp_path, 8, ckpt=ckpt)
        state, start = first.restore_or_init(0)
        rng = np.random.default_rng(0)
        data = [(t, t) for t in (rng.integers(0, 256, (8, 16))
                                 for _ in range(2))]
        state, metrics = first.run(state, data, start_step=start)
        first.close()
        assert metrics["step"] == 2
        # the replicated state (12 B a parameter and 4 of gradient)
        # cannot fit a card, two ways of it can: fsdp 2
        params = sum(p.numel() for p in Llama(
            LlamaConfig.tiny(dtype=torch.float32),
            device="meta").parameters())
        profile = _profile(8, param_count=params, param_bytes=4 * params,
                           hbm_bytes_per_chip=int(12 * params / 0.85))
        plan = planner.plan_parallelism(_world(2), profile)
        assert plan["mesh"]["fsdp"] == 2 and plan["feasible"]
        assert _same(plan, jplanner.plan_parallelism(
            _world(2), _profile(8, jplanner, param_count=params,
                                param_bytes=4 * params,
                                hbm_bytes_per_chip=int(12 * params
                                                       / 0.85))))
        plan_env.write_text(json.dumps(plan))
        ranks = run_workers(tmp_path, MIGRATE_WORKER, 2, args=(ckpt,),
                            name="migrate")
        for out in ranks:
            assert out["applied"] == "mesh+batch" and out["changed"]
            assert out["mesh"]["fsdp"] == 2 and out["dp"] == 2
            assert out["start"] == out["control_start"] == 2
            assert out["source"] == "peer" and out["stripe"]
            assert out["control_source"] == "checkpoint"
            assert "replan_migrate_s" in out["timings"]
            assert out["crc"] == out["control_crc"]
            assert not out["control_changed"]
            assert out["step"] == 3
            assert out["loss"] == out["control_loss"]
            assert "replan_applied" in out["events"]

    def test_batch_plan_adjusts_sampler_deliberately(self, cpu_devices,
                                                     tmp_path, plan_env):
        """Replica mode on a world of four where only the batch can give
        (10 → 8): the sampler advances by the ADJUSTED batch, as the JAX
        loop's does for the same plan."""
        from dlrover_tpu.trainer.sampler import (
            ElasticDistributedSampler as JSampler,
        )
        from dlrover_tpu_torch.trainer.sampler import (
            ElasticDistributedSampler,
        )

        completed = []
        for which in ("jax", "port"):
            module = jplanner if which == "jax" else planner
            plan = PLAN_CASES["replica-4"](module)
            assert plan["global_batch"] == 8 and plan["batch_adjusted"]
            plan_env.write_text(json.dumps(plan))
            rng = np.random.default_rng(0)
            data = [(t, t) for t in (rng.integers(0, 256, (10, 16))
                                     for _ in range(2))]
            if which == "jax":
                import jax

                loop = _jax_loop(cpu_devices, 10)
                sampler = JSampler(dataset_size=1000)
                state, start = loop.restore_or_init(
                    jax.random.PRNGKey(0), sampler=sampler)
            else:
                loop = _port_loop(tmp_path, 10)
                sampler = ElasticDistributedSampler(dataset_size=1000)
                state, start = loop.restore_or_init(0, sampler=sampler)
            assert (loop.global_batch, loop._trim_batch) == (8, 8)
            loop.run(state, data, start_step=start, sampler=sampler)
            completed.append(sampler.state_dict()["completed_num"])
            loop.close()
        assert completed == [16, 16]
        applied = _events("replan_applied")[-1]["attrs"]
        assert applied["batch_adjusted"] and applied["global_batch"] == 8

    def test_infeasible_plan_falls_back_loudly(self, tmp_path, plan_env):
        plan_env.write_text(json.dumps(PLAN_CASES["infeasible"](planner)))
        loop = _port_loop(tmp_path, 8)
        assert loop._replan_applied == "" and loop._shard_plan is None
        assert "nothing fits" in \
            _events("replan_fallback")[-1]["attrs"]["reason"]
        loop.close()

    def test_plain_relaunch_is_not_priced_as_a_resize(self, tmp_path,
                                                      plan_env):
        """A relaunch re-applying the UNCHANGED plan mints no replan
        spans; the signature commits only once a restore completed, so
        a worker dying mid-resize re-prices it on respawn."""
        plan_env.write_text(json.dumps(
            planner.plan_parallelism(_world(1), _profile(8))))
        spans = []

        def sink(span):
            spans.append(span.name)

        obs.add_span_sink(sink)
        try:
            self._relaunch(tmp_path, spans)
        finally:
            obs.remove_span_sink(sink)

    def _relaunch(self, tmp_path, spans):
        first = _port_loop(tmp_path, 8)
        assert first._replan_applied == "mesh+batch"
        assert first._replan_changed
        interrupted = _port_loop(tmp_path, 8)
        assert interrupted._replan_changed
        interrupted.close()
        first.restore_or_init(0)
        first.close()
        priced = [name for name in spans if name.startswith("replan_")]
        # the first incarnation and the interrupted one each priced the
        # plan and the rebuild; only the first migrated
        assert sorted(priced) == sorted(
            2 * ["replan_plan", "replan_rebuild"] + ["replan_migrate"])
        relaunch = _port_loop(tmp_path, 8)
        assert relaunch._replan_applied == "mesh+batch"
        assert not relaunch._replan_changed
        assert _events("replan_applied")[-1]["attrs"]["changed"] is False
        relaunch.restore_or_init(0)
        relaunch.close()
        assert [name for name in spans
                if name.startswith("replan_")] == priced

    def test_replan_disabled_pins_the_configured_shape(self, tmp_path,
                                                       plan_env):
        plan_env.write_text(json.dumps(
            planner.plan_parallelism(_world(1), _profile(8))))
        Context.singleton().update(replan_enabled=False)
        loop = _port_loop(tmp_path, 8)
        assert loop._shard_plan is None and loop._replan_applied == ""
        loop.close()


FALLBACK_WORKER = """
import json, os, sys
import numpy as np
import torch
from dlrover_tpu_torch import obs
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.trainer.elastic_loop import ElasticTrainLoop, TrainLoopConfig
import functools

torch.set_num_threads(1)
init_distributed("cpu")
cfg = LlamaConfig.tiny(dtype=torch.float32)

def loop(batch):
    return ElasticTrainLoop(
        functools.partial(Llama, cfg),
        lambda p: torch.optim.AdamW(p, lr=1e-3), cross_entropy_loss,
        TrainLoopConfig(global_batch=batch, seq_len=16,
                        max_micro_per_replica=4), device="cpu")

def events(name):
    return [e["attrs"] for e in obs.get_flight_recorder().snapshot()
            if e.get("name") == name]

planned = loop(12)
out = {"rejected": {"applied": planned._replan_applied, "dp": planned.dp,
                    "batch": planned.global_batch,
                    "fallback": events("replan_fallback")[-1]["reason"]}}
planned.close()
del os.environ["DLROVER_TPU_SHARD_PLAN"]
unfriendly = loop(10)
adjusted = events("replan_batch_adjusted")[-1]
out["unfriendly"] = {"batch": unfriendly.global_batch,
                     "trim": unfriendly._trim_batch, "dp": unfriendly.dp,
                     "requested": adjusted["requested"],
                     "adjusted": adjusted["adjusted"]}
rng = np.random.default_rng(3)
tokens = rng.integers(0, cfg.vocab_size, (10, 16), dtype=np.int64)
state = unfriendly.trainer.init(0)
state, metrics = unfriendly.run(state, [(tokens, tokens)])
out["unfriendly"]["step"] = metrics["step"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def three_rank_fallbacks(tmp_path_factory):
    """Three gloo ranks: a planned tensor axis of 3 the tiny Llama's
    heads reject, then no plan at a world whose dp does not divide the
    batch of 10."""
    tmp_path = tmp_path_factory.mktemp("fallbacks")
    plan = planner.plan_parallelism(_world(3), _profile(12))
    plan["mesh"] = {"dcn": 1, "data": 1, "fsdp": 1, "tensor": 3,
                    "pipe": 1}
    plan["dp"] = 1
    plan_file = tmp_path / "shard_plan.json"
    plan_file.write_text(json.dumps(plan))
    old = os.environ.get(NodeEnv.SHARD_PLAN_FILE)
    os.environ[NodeEnv.SHARD_PLAN_FILE] = str(plan_file)
    try:
        return run_workers(tmp_path, FALLBACK_WORKER, 3, name="fallback")
    finally:
        if old is None:
            os.environ.pop(NodeEnv.SHARD_PLAN_FILE, None)
        else:
            os.environ[NodeEnv.SHARD_PLAN_FILE] = old


def test_untraceable_plan_mesh_falls_back_loudly(three_rank_fallbacks):
    """A planned tensor axis the model's dims cannot divide is rejected
    by the trainer build and falls back to the configured mesh: the
    worker still trains, the event is loud."""
    for out in three_rank_fallbacks:
        rejected = out["rejected"]
        assert rejected["applied"] == "" and rejected["dp"] == 3
        assert rejected["batch"] == 12
        assert "rejected" in rejected["fallback"]


def test_fallback_mesh_survives_divisor_unfriendly_world(
        three_rank_fallbacks, cpu_devices):
    """No plan and a world whose dp does not divide the batch: both
    loops trim it (10 → 9, loudly) instead of crash-looping."""
    jloop = _jax_loop(cpu_devices, 10, n_devices=3)
    want = (jloop.global_batch, jloop._trim_batch, jloop.dp)
    jloop.close()
    assert want == (9, 9, 3)
    for out in three_rank_fallbacks:
        got = out["unfriendly"]
        assert (got["batch"], got["trim"], got["dp"]) == want
        assert (got["requested"], got["adjusted"]) == (10, 9)
        assert got["step"] == 1


# ---------------------------------------------------------------------------
# chaos: resize:±k@step
# ---------------------------------------------------------------------------


def _fields(faults):
    return [vars(f) for f in faults]


def _both_injectors(rank, spec):
    return (jchaos.ChaosInjector(rank=rank, spec=spec, slice_id=-1),
            tchaos.ChaosInjector(rank=rank, spec=spec))


class TestResizeChaos:
    def test_parse_variants(self):
        for spec in ("resize:-2@10", "resize:slice:+1@5", "resize:+3@2"):
            assert _fields(tchaos.parse_chaos(spec)) == _fields(
                jchaos.parse_chaos(spec))
        fault = tchaos.parse_chaos("resize:-2@10")[0]
        assert (fault.action, fault.role, fault.rank, fault.at_step) == (
            "resize", "worker", -2, 10)
        for bad in ("resize:0@5", "resize:pod:+1@5"):
            with pytest.raises(ValueError):
                tchaos.parse_chaos(bad)

    def test_scale_down_drains_only_the_top_ranks(self, monkeypatch):
        monkeypatch.setenv(NodeEnv.WORLD_SIZE, "5")
        for victim in _both_injectors(4, "resize:-2@10"):
            with pytest.raises(SystemExit) as exit_info:
                victim.maybe_inject(10)
            assert exit_info.value.code == WorkerExit.DRAIN
        for survivor in _both_injectors(2, "resize:-2@10"):
            survivor.maybe_inject(10)
            assert survivor.faults[0].fired

    def test_scale_down_fires_once_per_node(self, monkeypatch, tmp_path):
        monkeypatch.setenv(NodeEnv.WORLD_SIZE, "3")
        for which in (0, 1):
            monkeypatch.setenv("DLROVER_TPU_CHAOS_STATE",
                               str(tmp_path / str(which)))
            first = _both_injectors(2, "resize:-1@4")[which]
            with pytest.raises(SystemExit):
                first.maybe_inject(4)
            respawn = _both_injectors(2, "resize:-1@4")[which]
            assert respawn.faults[0].fired
        assert sorted(os.listdir(tmp_path / "0")) == sorted(
            os.listdir(tmp_path / "1"))

    def test_scale_up_writes_the_request_file(self, monkeypatch,
                                              tmp_path):
        monkeypatch.setenv(NodeEnv.WORLD_SIZE, "2")
        payloads = []
        for which in (0, 1):
            request = tmp_path / f"resize{which}.json"
            monkeypatch.setenv(NodeEnv.RESIZE_REQUEST_FILE, str(request))
            _both_injectors(1, "resize:+2@3")[which].maybe_inject(3)
            assert not request.exists()   # only rank 0 writes
            _both_injectors(0, "resize:+2@3")[which].maybe_inject(3)
            payload = json.loads(request.read_text())
            payloads.append({k: v for k, v in payload.items()
                             if k != "ts"})
        assert payloads[0] == payloads[1] == {
            "delta": 2, "unit": "worker", "step": 3}

    def test_scale_down_never_cascades_across_respawns(self, monkeypatch,
                                                       tmp_path):
        for which in (0, 1):
            monkeypatch.setenv("DLROVER_TPU_CHAOS_STATE",
                               str(tmp_path / str(which)))
            monkeypatch.setenv(NodeEnv.WORLD_SIZE, "3")
            victim = _both_injectors(2, "resize:-1@4")[which]
            survivor = _both_injectors(1, "resize:-1@4")[which]
            survivor.maybe_inject(4)
            with pytest.raises(SystemExit):
                victim.maybe_inject(4)
            monkeypatch.setenv(NodeEnv.WORLD_SIZE, "2")
            respawn = _both_injectors(1, "resize:-1@4")[which]
            assert respawn.faults[0].fired
            respawn.maybe_inject(5)   # no exit

    def test_late_leaver_still_fires_against_the_original_world(
            self, monkeypatch, tmp_path):
        for which in (0, 1):
            monkeypatch.setenv("DLROVER_TPU_CHAOS_STATE",
                               str(tmp_path / str(which)))
            monkeypatch.setenv(NodeEnv.WORLD_SIZE, "3")
            with pytest.raises(SystemExit):
                _both_injectors(2, "resize:-2@4")[which].maybe_inject(4)
            monkeypatch.setenv(NodeEnv.WORLD_SIZE, "2")
            late = _both_injectors(1, "resize:-2@4")[which]
            assert not late.faults[0].fired
            with pytest.raises(SystemExit):
                late.maybe_inject(4)
            assert _both_injectors(0, "resize:-2@4")[which].faults[0].fired
        assert sorted(os.listdir(tmp_path / "0")) == sorted(
            os.listdir(tmp_path / "1"))

    def test_slice_unit_scale_down(self, monkeypatch):
        """The slice-unit resize needs slice mode: the JAX injector
        drains the departing slice, the port's refuses the fault by its
        ROADMAP item."""
        monkeypatch.setenv(NodeEnv.WORLD_SIZE, "4")
        monkeypatch.setenv(NodeEnv.NUM_SLICES, "2")
        victim = jchaos.ChaosInjector(rank=3, spec="resize:slice:-1@2",
                                      slice_id=1)
        with pytest.raises(SystemExit):
            victim.maybe_inject(2)
        with pytest.raises(NotImplementedError, match=r"6\.4"):
            tchaos.ChaosInjector(rank=3, spec="resize:slice:-1@2")


# ---------------------------------------------------------------------------
# goodput pricing
# ---------------------------------------------------------------------------


def _span(name, duration, span_id, **attrs):
    return {"name": name, "duration_s": duration, "span_id": span_id,
            "ts": 100.0, "attrs": attrs}


def _ledgers():
    from dlrover_tpu.obs.goodput import GoodputLedger as JLedger
    from dlrover_tpu.obs.metrics import MetricsRegistry as JRegistry

    return (JLedger(registry=JRegistry()),
            obs.GoodputLedger(registry=obs.MetricsRegistry()))


class TestReplanPricing:
    def test_ledger_groups_replan_phases_per_resize(self):
        from dlrover_tpu.obs.goodput import render_snapshot as j_render

        snaps = []
        for ledger in _ledgers():
            ledger.observe_span(_span("replan_plan", 0.05, "a",
                                      generation=3), rank=1)
            ledger.observe_span(_span("replan_migrate", 1.2, "b",
                                      generation=3, source="peer",
                                      bytes=2 ** 20), rank=1)
            ledger.observe_span(_span("replan_rebuild", 0.4, "c",
                                      generation=3), rank=1)
            ledger.observe_span(_span("replan_plan", 0.02, "d",
                                      generation=4), rank=0)
            snaps.append(ledger.snapshot())
        assert snaps[1]["replans"] == snaps[0]["replans"]
        row = snaps[1]["replans"][0]
        assert row["rank"] == 1 and row["generation"] == 3
        assert row["phases"] == {"plan": 0.05, "migrate": 1.2,
                                 "rebuild": 0.4}
        assert row["source"] == "peer"
        rendered = obs.goodput.render_snapshot(snaps[1])
        assert "re-plans" in rendered and "migrate=1.20s" in rendered
        assert rendered.count("\n") == j_render(snaps[0]).count("\n")

    def test_replan_spans_are_not_double_counted(self):
        buckets = []
        for ledger in _ledgers():
            ledger.observe_span(_span("replan_migrate", 5.0, "x"), rank=0)
            snap = ledger.snapshot()
            assert snap["replans"]
            buckets.append(snap["buckets"].get("restore", 0.0))
        assert buckets == [0.0, 0.0]

    def test_diagnose_renders_the_ports_replan_record(self, tmp_path,
                                                      monkeypatch):
        """The reference's ``tools/diagnose.py`` renders the port's own
        flight record of a resize: the stamped re-plan, a fallback and
        the migrate span."""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "diagnose", os.path.join(REPO, "tools", "diagnose.py"))
        diagnose = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(diagnose)
        recorder = obs.get_flight_recorder()
        mgr = ElasticTrainingRendezvousManager()
        mgr.update_rdzv_params(5, 5)
        mgr.set_model_profile(**PROFILE_KW)
        for rank in range(5):
            mgr.join_rendezvous(rank, 1)
        mgr.get_comm_world(0)
        before, _ = mgr.compute_shard_plan(0)
        mgr.remove_alive_node(4)
        after, changed = mgr.compute_shard_plan(0)
        assert changed
        plan_file = tmp_path / "plan.json"
        plan_file.write_text(json.dumps(PLAN_CASES["infeasible"](planner)))
        monkeypatch.setenv(NodeEnv.SHARD_PLAN_FILE, str(plan_file))
        _port_loop(tmp_path, 8).close()
        obs.record_span("replan_migrate", 1.5, attrs={})
        out = diagnose.render_replans({"events": recorder.snapshot()})
        assert "replan_stamped" in out

        def shape(plan):
            return "x".join(str(plan["mesh"][k]) for k in
                            ("dcn", "data", "fsdp", "tensor", "pipe"))

        assert f"{shape(before)} -> {shape(after)}" in out
        assert "replan_fallback" in out and "migrate=1.50s" in out
        assert "re-plan events: 0" in diagnose.render_replans(
            {"events": []})


# ---------------------------------------------------------------------------
# multi-process acceptance: resize N -> N-1, one round, no checkpoint read
# ---------------------------------------------------------------------------


def _log_lines(path):
    try:
        with open(path) as f:
            return f.read().splitlines()
    except FileNotFoundError:
        return []


@pytest.mark.slow
def test_three_agent_resize_replans_in_one_round(tmp_path):
    """Over real processes on the CPU: three agents train the tiny Llama
    as solo replicas at batch 8 (3 does not divide it: the plan trims it
    to 6), ``resize:-1@4`` drains the top rank cleanly, the survivors
    re-plan for world 2 in ONE rendezvous round, restore from their own
    peer caches (no checkpoint read) and train at the full batch of 8
    again; the goodput ledger prices the re-plan."""
    import threading

    from dlrover_tpu_torch.agent.elastic_agent import ElasticAgent, WorkerSpec
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.job_master import JobMaster

    nodes = 3
    master = JobMaster(min_nodes=1, max_nodes=nodes, host="127.0.0.1")
    master.prepare()
    mgr = master.servicer.rdzv_managers[TRAIN]
    # every rank alive up front, so the first round cuts exactly once,
    # when the last of the three joins
    for rank in range(nodes):
        mgr.add_alive_node(rank)
    # every step held to 0.3 s, so that the survivors are still
    # training when the world re-forms. The only saves are the
    # survivors' at the stop: replicas stop at steps of their own, and
    # the one behind restores the newer cut from the other's donor,
    # which no later save may prune away and which must outlive the
    # one behind's respawn (40 steps: seconds of training after it)
    chaos = ";".join(["resize:-1@4"] + [f"slow:worker:{rank}@1:0.3"
                                        for rank in range(nodes)])
    env = {"DLROVER_TPU_CHAOS": chaos,
           "DLROVER_TPU_CHAOS_STATE": str(tmp_path / "chaos"),
           "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    logs = [str(tmp_path / f"rank{rank}.log") for rank in range(nodes)]
    clients, agents, threads = [], [], []
    for rank in range(nodes):
        client = MasterClient(master.addr, node_id=rank, node_rank=rank)
        spec = WorkerSpec(
            entrypoint=[sys.executable, os.path.join(
                REPO, "dlrover_tpu_torch", "examples", "llama_train.py"),
                "--config", "tiny", "--device", "cpu", "--steps", "40",
                "--save-interval", "100", "--report-interval", "1",
                "--solo-replica", "--ckpt-dir", str(tmp_path / "ckpt"),
                "--log-file", logs[rank]],
            devices_per_node=1, max_restarts=3, monitor_interval_s=0.2,
            enable_monitors=False, env=env)
        agent = ElasticAgent(client, spec)
        clients.append(client)
        agents.append(agent)
        thread = threading.Thread(target=agent.run, daemon=True)
        thread.start()
        threads.append(thread)

    deadline = time.time() + 300.0

    def wait_for(predicate, what):
        while time.time() < deadline:
            hit = predicate()
            if hit:
                return hit
            time.sleep(0.1)
        raise TimeoutError(f"timed out waiting for {what}")

    def starts(rank):
        return [line for line in _log_lines(logs[rank])
                if "llama_train: start_step=" in line]

    try:
        wait_for(lambda: all(starts(r) for r in range(nodes)),
                 "three workers started")
        rounds_before = mgr.rdzv_round
        restored = wait_for(
            lambda: [starts(r)[1] for r in (0, 1) if len(starts(r)) > 1]
            if all(len(starts(r)) > 1 for r in (0, 1)) else None,
            "both survivors restored after the resize")
        assert sorted(mgr.latest_world) == [0, 1]
        assert mgr.rdzv_round == rounds_before + 1
        for line in restored:
            assert "source=peer" in line, line
            assert "start_step=0" not in line, line
        plan = mgr.last_shard_plan
        assert plan["world_size"] == 2 and plan["global_batch"] == 8
        assert any(e.get("name") == "node_drained"
                   and e.get("attrs", {}).get("rank") == 2
                   for e in obs.get_flight_recorder().snapshot())
        wait_for(lambda: all(any("llama_train: done step=40" in line
                                 for line in _log_lines(logs[r]))
                             for r in (0, 1)), "the survivors' last step")
        snap = master.goodput_ledger.snapshot()
        assert any(row.get("phases", {}).get("migrate") is not None
                   for row in snap["replans"])
    finally:
        for agent in agents:
            agent.shutdown()
        for client in clients:
            client.close()
        master.stop()
        for thread in threads:
            thread.join(timeout=10.0)
