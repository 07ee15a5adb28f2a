"""Online parallelism re-planning: pick the best mesh for any world size.

Own copy of the JAX package's ``parallel/planner.py`` (stdlib only, held
equal to it by ``tests/test_torch_replan.py``: the same inputs give the
same plan as identical JSON). At a membership cut it enumerates every
DP×TP×PP(×DCN) factorization of the surviving card count, scores each
against the model's memory footprint, a step time predicted from the
MFU model (``obs/mfu.py``) and the bytes a live migration from the
previous plan would move, and emits one deterministic plan keyed by the
rendezvous generation, which the master and every worker agree on
without negotiation.

The master computes plans in the rendezvous path
(``master/rendezvous.py::compute_shard_plan``) and the worker applies
them when it builds its trainer (``trainer/elastic_loop.py``).
Determinism is the correctness property: the plan is a pure function of
(world, profile, previous plan, generation), so every rank that asks
gets the same answer and a resize completes in one rendezvous round.

The batch contract: a dp size that does not divide the requested global
batch rounds the batch DOWN to the nearest dp multiple, a deliberate,
recorded adjustment (``batch_adjusted`` and both values in the plan;
the worker trims its input batches and records a flight event), never a
silently wrong batch and never a crash. Candidates whose dp exceeds the
requested batch are infeasible (rounding up would invent data).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

# -- scoring model coefficients (documented, deterministic) -----------------
# The fraction of peak a well-shaped single-axis data-parallel run is
# assumed to reach; the per-axis penalties below discount it. This is a
# prior, not a measurement of this package on any device: its job is to
# RANK candidates consistently, and the value is the reference
# package's, so both packages stamp identical plans. The calibration
# loop (parallel/calibration.py) confronts the predictions it yields
# with measured step times.
_BASE_EFFICIENCY = 0.6
# tensor-parallel collectives ride every layer's critical path
_TENSOR_PENALTY = 0.05
# fsdp allgather/reduce-scatter overlaps well; mild discount
_FSDP_PENALTY = 0.01
# cross-slice (DCN) reduce per step
_DCN_PENALTY = 0.03
# assumed migration bandwidth for the migration-cost term (a prior of
# the reference package's; the exact figure only scales the migration
# term relative to the step-time horizon)
_MIGRATION_BYTES_PER_S = 2e9
# steps the plan is amortized over when trading step time vs migration
_HORIZON_STEPS = 200.0
# relative penalty weight for shrinking the requested global batch
# (full weight: a shrunken batch changes training semantics — prefer a
# slightly slower mesh that preserves the batch over one that trims it)
_BATCH_PENALTY = 1.0
# HBM headroom reserved for activations/workspace when a memory budget
# is known
_HBM_HEADROOM = 0.85


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """What the planner needs to know about the model + hardware.

    Fed master-side from ModelInfo reports (flops/bytes) and chip-stats
    HBM totals; every field has a safe zero default so a plan can be
    computed before the first worker ever reported (scores then ignore
    the unknown terms instead of guessing)."""

    param_count: int = 0
    param_bytes: int = 0
    flops_per_token: float = 0.0
    peak_flops_per_chip: float = 0.0
    seq_len: int = 0
    global_batch: int = 0
    # optimizer state bytes per param byte (adam: two f32 moments over
    # (possibly) bf16 params ~ 2-4x; 2.0 is the exact-dtype adam figure)
    optimizer_bytes_per_param_byte: float = 2.0
    # per-chip HBM budget in bytes; 0 = unconstrained (CPU harnesses)
    hbm_bytes_per_chip: int = 0
    max_micro_per_replica: int = 8
    # model-dim divisibility granules (ModelInfo): a tensor axis must
    # divide tensor_divisor (gcd of heads/kv/mlp/vocab dims), an fsdp
    # axis fsdp_divisor (the embed dim). 0 = unknown — no filtering
    # (the worker's trace probe + loud fallback catches the rest).
    tensor_divisor: int = 0
    fsdp_divisor: int = 0

    def state_bytes(self) -> float:
        return float(self.param_bytes) * (
            1.0 + max(0.0, self.optimizer_bytes_per_param_byte))


@dataclasses.dataclass(frozen=True)
class MeshCandidate:
    """One DP×TP×PP(×DCN) factorization of the world's chips. The
    ``data``/``fsdp`` split both carry the batch dim (parallel/mesh.py
    ``data_axes``); fsdp additionally shards the state."""

    dcn: int = 1
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    pipe: int = 1

    @property
    def total(self) -> int:
        return self.dcn * self.data * self.fsdp * self.tensor * self.pipe

    @property
    def dp(self) -> int:
        """Replicas the batch shards over (dcn + data + fsdp jointly)."""
        return self.dcn * self.data * self.fsdp

    def state_shards(self) -> int:
        """How many ways the param/optimizer state is sharded (dp
        replicas replicate; fsdp/tensor/pipe shard)."""
        return self.fsdp * self.tensor * self.pipe

    def as_dict(self) -> Dict[str, int]:
        return {"dcn": self.dcn, "data": self.data, "fsdp": self.fsdp,
                "tensor": self.tensor, "pipe": self.pipe}


def _divisors(n: int) -> List[int]:
    out = [d for d in range(1, n + 1) if n % d == 0]
    return out


def enumerate_meshes(chips: int, slices: int = 1,
                     max_tensor: int = 8, max_pipe: int = 8
                     ) -> List[MeshCandidate]:
    """Every feasible factorization of ``chips`` into
    dcn×data×fsdp×tensor×pipe, deterministic order.

    ``slices`` > 1 pins the dcn axis to the slice count when it divides
    the chips (the dcn axis carries the cross-fabric split); a chip
    count the slices do not divide falls back to dcn=1, and the caller
    decides whether that world is acceptable. Tensor/pipe caps keep the
    latency-bound axes inside one fast-interconnect domain."""
    chips = max(1, int(chips))
    dcn = slices if slices > 1 and chips % slices == 0 else 1
    per_slice = chips // dcn
    candidates: List[MeshCandidate] = []
    for tensor in _divisors(per_slice):
        if tensor > max_tensor:
            continue
        rest_t = per_slice // tensor
        for pipe in _divisors(rest_t):
            if pipe > max_pipe:
                continue
            pool = rest_t // pipe
            for fsdp in _divisors(pool):
                candidates.append(MeshCandidate(
                    dcn=dcn, data=pool // fsdp, fsdp=fsdp,
                    tensor=tensor, pipe=pipe))
    return candidates


def adjust_global_batch(requested: int, dp: int) -> Tuple[int, bool]:
    """The deliberate batch adjustment: round DOWN to the nearest dp
    multiple (never up — rounding up would invent data the input
    pipeline does not have). Returns (batch, adjusted). A dp larger
    than the requested batch returns (0, True): infeasible."""
    requested = int(requested)
    if requested <= 0:
        return max(dp, 0), False
    if dp <= 0 or dp > requested:
        return 0, True
    adjusted = (requested // dp) * dp
    return adjusted, adjusted != requested


def choose_accum(global_batch: int, dp: int,
                 max_micro_per_replica: int) -> Tuple[int, int]:
    """(accum_steps, micro_batch_global) for a dp-divisible batch —
    the same policy as trainer.train_step.choose_accumulation,
    restated here so the torch-free master can plan with it."""
    per_replica = global_batch // dp
    accum = 1
    while (per_replica % accum
           or per_replica // accum > max(1, max_micro_per_replica)):
        accum += 1
        if accum > per_replica:
            accum = per_replica
            break
    return accum, global_batch // accum


def _efficiency(candidate: MeshCandidate, accum: int,
                axis_discounts: Optional[Dict[str, float]] = None
                ) -> float:
    """Predicted fraction of aggregate peak the candidate sustains.
    The pipeline term is the classic bubble fraction with ``accum``
    microbatches: m / (m + p - 1).

    ``axis_discounts`` are LEARNED multiplicative corrections from the
    calibration loop (parallel/calibration.py: measured step time vs
    this very prediction, per axis, normalized against shapes not
    using the axis): a discount < 1 on an axis the fleet measured
    slower than the prior predicts shifts scoring away from it. Only
    active axes (> 1 way) are discounted, so plain data parallelism
    stays the un-discounted baseline the corrections are relative to."""
    eff = _BASE_EFFICIENCY
    eff *= 1.0 / (1.0 + _TENSOR_PENALTY * (candidate.tensor - 1))
    eff *= 1.0 / (1.0 + _FSDP_PENALTY * (candidate.fsdp - 1))
    eff *= 1.0 / (1.0 + _DCN_PENALTY * (candidate.dcn - 1))
    if candidate.pipe > 1:
        eff *= accum / (accum + candidate.pipe - 1.0)
    if axis_discounts:
        for axis, ways in (("dcn", candidate.dcn),
                           ("data", candidate.data),
                           ("fsdp", candidate.fsdp),
                           ("tensor", candidate.tensor),
                           ("pipe", candidate.pipe)):
            discount = axis_discounts.get(axis)
            if ways > 1 and discount and discount > 0:
                eff *= float(discount)
    return eff


def migration_bytes(candidate: MeshCandidate,
                    prev_mesh: Optional[Dict[str, int]],
                    profile: ModelProfile,
                    prev_world: int = 0, world: int = 0) -> float:
    """Bytes a live migration from ``prev_mesh`` moves. A changed
    state sharding (fsdp/tensor/pipe) re-shards every replica's state;
    a pure dp resize only fills the ranks with no local replica (the
    peer-restore path serves survivors from their own cache)."""
    if prev_mesh is None:
        return 0.0
    state = profile.state_bytes()
    prev = MeshCandidate(**{k: int(prev_mesh.get(k, 1))
                            for k in ("dcn", "data", "fsdp", "tensor",
                                      "pipe")})
    if (prev.fsdp, prev.tensor, prev.pipe) != (
            candidate.fsdp, candidate.tensor, candidate.pipe):
        # every chip's shard layout changes: the whole state moves once
        return state
    if prev_world and world and world > prev_world:
        # grow: only the new replicas' copies transfer
        return state * (world - prev_world) / max(1, prev_world)
    # shrink or same size with unchanged sharding: survivors keep their
    # shards; only evicted replicas' data (already replicated) vanishes
    return 0.0


def score_candidate(candidate: MeshCandidate, profile: ModelProfile,
                    prev_mesh: Optional[Dict[str, int]] = None,
                    prev_world: int = 0,
                    axis_discounts: Optional[Dict[str, float]] = None
                    ) -> Optional[Dict[str, Any]]:
    """Score one candidate; None when it is infeasible (batch smaller
    than dp, or the state cannot fit the HBM budget)."""
    requested = profile.global_batch
    batch, adjusted = adjust_global_batch(requested, candidate.dp)
    if batch <= 0:
        return None
    # model-dim divisibility: a tensor/fsdp way that does not divide
    # the dims it would shard cannot trace — infeasible by construction
    if (candidate.tensor > 1 and profile.tensor_divisor > 0
            and profile.tensor_divisor % candidate.tensor):
        return None
    if (candidate.fsdp > 1 and profile.fsdp_divisor > 0
            and profile.fsdp_divisor % candidate.fsdp):
        return None
    accum, micro = choose_accum(batch, candidate.dp,
                                profile.max_micro_per_replica)
    # memory fit: per-chip state bytes + one f32 grad accumulator over
    # the same sharding (the scan's grad_sum)
    per_chip = 0.0
    if profile.param_bytes > 0:
        shards = candidate.state_shards()
        per_chip = (profile.state_bytes()
                    + 4.0 * profile.param_count) / shards
        if (profile.hbm_bytes_per_chip > 0
                and per_chip > profile.hbm_bytes_per_chip
                * _HBM_HEADROOM):
            return None
    # predicted step time from the MFU model: tokens × FLOPs/token over
    # the discounted aggregate peak. Unknown model/peak → 0 (candidates
    # then rank purely on migration + batch terms + tie-break).
    eff = _efficiency(candidate, accum, axis_discounts)
    step_s = 0.0
    if (profile.flops_per_token > 0 and profile.peak_flops_per_chip > 0
            and profile.seq_len > 0 and batch > 0):
        tokens = batch * profile.seq_len
        step_s = (tokens * profile.flops_per_token
                  / (profile.peak_flops_per_chip * candidate.total
                     * eff))
        if adjusted and requested > 0:
            # a smaller batch trains fewer tokens per step: normalize
            # the per-token cost so shrinking the batch is not scored
            # as a free speedup
            step_s *= requested / batch
    mig = migration_bytes(candidate, prev_mesh, profile,
                          prev_world=prev_world, world=candidate.total)
    score = step_s * _HORIZON_STEPS + mig / _MIGRATION_BYTES_PER_S
    if adjusted and requested > 0:
        # scale the batch-shrink penalty to the step-time term when one
        # exists (so it competes on the same axis); with no FLOPs model
        # the penalty is the only non-zero term and ranks on its own
        scale = step_s * _HORIZON_STEPS if step_s > 0 else 1.0
        score += (_BATCH_PENALTY * (requested - batch) / requested
                  * scale)
    return {
        "mesh": candidate.as_dict(),
        "feasible": True,
        "score": score,
        "predicted_step_s": step_s,
        "predicted_efficiency": eff,
        "migration_bytes": mig,
        "state_bytes_per_chip": per_chip,
        "global_batch": batch,
        "requested_global_batch": requested,
        "batch_adjusted": bool(adjusted),
        "accum_steps": accum,
        "micro_batch": micro,
        "dp": candidate.dp,
    }


def plan_parallelism(world: Dict[int, int],
                     profile: Optional[ModelProfile] = None,
                     slices: int = 1,
                     prev_plan: Optional[Dict[str, Any]] = None,
                     generation: int = 0,
                     epoch: int = 0,
                     round_: int = 0,
                     max_tensor: int = 8,
                     max_pipe: int = 8,
                     axis_discounts: Optional[Dict[str, float]] = None
                     ) -> Dict[str, Any]:
    """THE planner entry: (new world, model profile, previous plan) →
    one deterministic JSON-safe plan.

    ``world``: rank → local chip count (the rendezvous world map).
    ``slices``: formed slices (dcn axis size when it divides).
    ``prev_plan``: the previously stamped plan (its mesh feeds the
    migration term so a resize that can keep the sharding is preferred
    over an equivalent-speed one that re-shards everything).
    ``axis_discounts``: learned per-axis efficiency corrections from
    the calibration loop — part of the plan's deterministic inputs
    (callers memoize on them too) and stamped into the plan so the
    flight record shows WHICH prior scored it.

    Always returns a plan: when no candidate is feasible (a memory
    budget nothing fits, or an empty world) the least-infeasible
    candidate is returned with ``feasible: false`` — callers must treat
    that loudly (the worker falls back to the checkpoint-restart path),
    but the planner never wedges the fleet by answering nothing."""
    profile = profile or ModelProfile()
    ranks = sorted(world)
    chips = sum(int(world[r]) for r in ranks)
    prev_mesh = (prev_plan or {}).get("mesh")
    prev_world = int((prev_plan or {}).get("total_devices", 0) or 0)
    base = {
        "version": 1,
        "generation": int(generation),
        "epoch": int(epoch),
        "round": int(round_),
        "world_size": len(ranks),
        "ranks": ranks,
        "total_devices": chips,
        "slices": int(slices),
    }
    if chips <= 0:
        return dict(base, feasible=False, mesh=MeshCandidate().as_dict(),
                    reason="empty world", global_batch=0,
                    requested_global_batch=profile.global_batch,
                    batch_adjusted=False, accum_steps=1, micro_batch=0)
    best: Optional[Dict[str, Any]] = None
    best_key: Optional[Tuple] = None
    # two passes: the capped enumeration first (tensor/pipe inside one
    # interconnect domain), then — only when NOTHING capped is feasible
    # (a prime world larger than the batch, say) — uncapped: a tensor axis the
    # size of the world is slow but FEASIBLE, and "any world size" means
    # the planner answers with a working shape, not a shrug
    for pass_caps in ((max_tensor, max_pipe), (chips, chips)):
        for candidate in enumerate_meshes(chips, slices=slices,
                                          max_tensor=pass_caps[0],
                                          max_pipe=pass_caps[1]):
            scored = score_candidate(candidate, profile,
                                     prev_mesh=prev_mesh,
                                     prev_world=prev_world,
                                     axis_discounts=axis_discounts)
            if scored is None:
                continue
            # deterministic total order: score, then prefer the SAFE
            # axes — fewer tensor/pipe/fsdp ways (those shard model
            # dims whose divisibility the planner cannot verify; plain
            # data parallelism always applies), more data last. A
            # memory budget flips this naturally: replicated-state
            # candidates fail the fit filter, so fsdp wins when it is
            # NEEDED, not by default.
            key = (round(scored["score"], 9), candidate.tensor,
                   candidate.pipe, candidate.fsdp, -candidate.data)
            if best_key is None or key < best_key:
                best, best_key = scored, key
        if best is not None:
            break
    if best is None:
        # nothing feasible: answer the least-bad sharded-most candidate
        # LOUDLY rather than nothing — the callers' fallback path needs
        # a concrete shape to log and refuse
        fallback = max(enumerate_meshes(chips, slices=slices,
                                        max_tensor=max_tensor,
                                        max_pipe=max_pipe),
                       key=lambda c: (c.state_shards(), -c.data))
        batch, adjusted = adjust_global_batch(profile.global_batch,
                                              fallback.dp)
        return dict(base, feasible=False, mesh=fallback.as_dict(),
                    reason="no candidate fits the batch/memory budget",
                    global_batch=batch,
                    requested_global_batch=profile.global_batch,
                    batch_adjusted=bool(adjusted or batch <= 0),
                    accum_steps=1, micro_batch=batch, dp=fallback.dp)
    plan = dict(base, **best)
    plan["migration_s_estimate"] = round(
        best["migration_bytes"] / _MIGRATION_BYTES_PER_S, 3)
    if axis_discounts:
        # the calibrated prior this plan was scored with — the flight
        # record of "the loop was closed" (parallel/calibration.py)
        plan["axis_discounts"] = {k: float(v) for k, v
                                  in sorted(axis_discounts.items())}
    # did the sharding change vs the previous plan? (what the worker's
    # replan event and the goodput summary report)
    plan["resharded"] = bool(
        prev_mesh is not None and {
            k: int(prev_mesh.get(k, 1))
            for k in ("fsdp", "tensor", "pipe")} != {
            k: plan["mesh"][k] for k in ("fsdp", "tensor", "pipe")})
    return plan


def slice_mesh(plan: Dict[str, Any]) -> Dict[str, int]:
    """The per-slice portion of a plan's mesh: identical axes with
    dcn=1: what a worker in the multi-world slice mode (host-level DCN
    sync, one program per slice) builds locally."""
    mesh = dict(plan.get("mesh", {}))
    mesh["dcn"] = 1
    return mesh


def plans_equivalent(a: Optional[Dict[str, Any]],
                     b: Optional[Dict[str, Any]]) -> bool:
    """Do two plans describe the same execution shape (mesh + batch +
    accumulation)? Used to detect a REAL re-plan vs a re-stamp of the
    same shape for a late joiner."""
    if not a or not b:
        return False
    keys = ("mesh", "global_batch", "accum_steps", "micro_batch",
            "total_devices")
    return all(a.get(k) == b.get(k) for k in keys)


def validate_plan(plan: Dict[str, Any], n_devices: int) -> Optional[str]:
    """Worker-side sanity check before a plan is applied; returns an
    error string (for the loud fallback event) or None when the plan
    can drive this process's mesh build."""
    if not isinstance(plan, dict) or not plan.get("mesh"):
        return "no plan"
    if not plan.get("feasible", False):
        return str(plan.get("reason") or "planner found no feasible mesh")
    mesh = plan["mesh"]
    try:
        total = math.prod(int(mesh.get(k, 1))
                          for k in ("dcn", "data", "fsdp", "tensor",
                                    "pipe"))
    except (TypeError, ValueError):
        return "malformed mesh"
    if total != int(plan.get("total_devices", -1)):
        return "mesh does not factor the planned device count"
    if n_devices > 0 and total != n_devices:
        return (f"plan covers {total} devices, this process sees "
                f"{n_devices}")
    if int(plan.get("global_batch", 0)) <= 0:
        return "non-positive planned batch"
    return None


def iter_feasible_worlds(world_sizes: Iterable[int],
                         profile: ModelProfile
                         ) -> Iterable[Tuple[int, Dict[str, Any]]]:
    """Test/diagnostic helper: plans for a sweep of world sizes (one
    chip per rank), yielding (world_size, plan)."""
    for n in world_sizes:
        yield n, plan_parallelism({r: 1 for r in range(n)}, profile)
