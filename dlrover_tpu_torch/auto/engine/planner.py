"""Planner: prune the optimization space into candidate strategies.

Counterpart of ``dlrover_tpu/auto/engine/planner.py``, the same lists for
the same analysis. Capability parity: atorch Planner (auto/engine/planner.py:13) gating which
optimizations are considered, PLUS the shard planners' axis sizing
(mip_tp_planner.py:30): when the analysis can size axes (HBM known), the
first candidates are model-aware sized configs — fsdp/tensor sizes and
remat derived from the model and device topology — not bare pass names.
"""

from __future__ import annotations

from itertools import combinations
from typing import List

from dlrover_tpu_torch.auto.engine.analyser import analyse, size_axes
from dlrover_tpu_torch.auto.model_context import ModelContext
from dlrover_tpu_torch.auto.opt_lib import (
    SEMIAUTO_STRATEGIES,
    OptimizationLibrary,
)
from dlrover_tpu_torch.auto.strategy import Strategy


def _pipeline_size(info, n_devices: int) -> int:
    """A sized pipeline candidate is warranted when the model is deep
    enough to cut into balanced stages and its state pressures device
    memory (pipe shards params by depth with one p2p per boundary instead
    of fsdp's per-block gathers). Returns 1 when not warranted."""
    layers = info.get("num_layers", 0) or 0
    if layers < 4 or n_devices < 2 or info["fits_one_device"]:
        return 1
    for stages in (4, 2):
        if n_devices % stages == 0 and layers % stages == 0:
            return stages
    return 1


def _sized_candidates(info, n_devices: int) -> List[Strategy]:
    """Model-aware sized strategies, best-guess first plus neighbors."""
    sizing = size_axes(info)
    # (sequence > 1 implies remat per size_axes's ordering, so these two
    # conditions also cover the long-context case)
    if (sizing["fsdp"] <= 1 and not sizing["remat"]
            and sizing["expert"] <= 1):
        return []

    def build(fsdp: int, tensor: int, remat: bool,
              sequence: int = 1, expert: int = 1,
              pipe: int = 1) -> Strategy:
        strategy: Strategy = [("half", {}), ("module_replace", {})]
        if fsdp > 1:
            strategy.append(("fsdp", {"size": fsdp}))
        if tensor > 1:
            strategy.append(("tensor_parallel", {"size": tensor}))
        if sequence > 1:
            strategy.append(("sequence_parallel", {"size": sequence}))
        if expert > 1:
            strategy.append(("expert_parallel", {"size": expert}))
        if pipe > 1:
            strategy.append(("pipeline_parallel", {"size": pipe}))
        if remat:
            strategy.append(("checkpoint", {}))
        return strategy

    candidates = [build(sizing["fsdp"], sizing["tensor"], sizing["remat"],
                        sizing["sequence"], sizing["expert"])]
    # neighbors: one rung more sharding (cheaper HBM, more comm) and the
    # remat flip, so the dry-run can catch a mis-estimate
    more_fsdp = sizing["fsdp"] * 2
    fixed = (more_fsdp * sizing["tensor"] * sizing["sequence"]
             * sizing["expert"])
    if fixed <= n_devices and n_devices % fixed == 0:
        candidates.append(build(more_fsdp, sizing["tensor"],
                                sizing["remat"], sizing["sequence"],
                                sizing["expert"]))
    candidates.append(build(sizing["fsdp"], sizing["tensor"],
                            not sizing["remat"], sizing["sequence"],
                            sizing["expert"]))
    # depth-sharded alternative: pipeline stages instead of fsdp, the
    # remaining devices on data; MoE configs compose the expert axis
    # INSIDE stages (pipeline_trainer's MoE spec) — the dry-run
    # arbitrates either way
    pipe = _pipeline_size(info, n_devices)
    expert = sizing["expert"]
    if pipe > 1 and n_devices % (pipe * expert) == 0:
        candidates.append(build(1, 1, sizing["remat"], 1, expert, pipe))
    return candidates


def plan_candidates(context: ModelContext,
                    max_candidates: int = 16) -> List[Strategy]:
    info = analyse(context)
    opt_lib = OptimizationLibrary()
    n_devices = info["n_devices"]

    candidates: List[Strategy] = []
    if n_devices > 1:
        candidates.extend(
            _sized_candidates(info, n_devices)[:max_candidates])
    if len(candidates) >= max_candidates:
        return candidates[:max_candidates]

    forced: Strategy = []
    if not info["fits_one_device"] and n_devices > 1:
        forced.append(("fsdp", {}))
    # MoE models must get the expert axis considered: without it every
    # candidate densifies the expert weights onto each device (reference
    # analog: optimization_library registers expert/pipe passes the
    # engine may propose, optimization_library.py:38-53)
    sizing = size_axes(info)
    if sizing["expert"] > 1:
        forced.append(("expert_parallel", {"size": sizing["expert"]}))

    optional: List[str] = []
    for name in SEMIAUTO_STRATEGIES:
        if any(f_name == name for f_name, _ in forced):
            continue
        opt = opt_lib[name]
        if opt.distributed and n_devices < 2:
            continue
        if name == "tensor_parallel" and n_devices % 2:
            continue
        optional.append(name)

    extras: List[Strategy] = []
    if info.get("n_dcn_granules", 1) > 1:
        # several granules: the data-axis gradient reduce crosses the slow
        # fabric — plan the int8 compressed reduce as an alternative the
        # dry-run can score against the exact reduce (quant_reduce.cu)
        extras.append(list(forced) + [("half", {}),
                                      ("quant_allreduce", {"bits": 8})])
    pipe = _pipeline_size(info, n_devices)
    if pipe > 1 and n_devices % (pipe * sizing["expert"]) == 0:
        extra: Strategy = [("half", {}), ("module_replace", {})]
        if sizing["expert"] > 1:
            extra.append(("expert_parallel",
                          {"size": sizing["expert"]}))
        extra.append(("pipeline_parallel", {"size": pipe}))
        extras.append(extra)
    if not info["fits_one_device"]:
        # host-offloaded optimizer state: the single-device escape hatch
        # (and an fsdp alternative the dry-run can score)
        extras.append([("half", {}), ("module_replace", {}),
                       ("offload_optimizer", {})])
        if n_devices == 1:
            # offload alone can't save a model whose params+grads exceed
            # HBM — the streaming per-layer trainer caps peak at params
            # + one layer's grads (per-leaf-optimizer contract logged by
            # the pass; the dry-run scores it like any candidate)
            extras.append([("half", {}), ("module_replace", {}),
                           ("streaming", {})])

    # smallest first: baseline (forced only), then singles, then pairs, ...
    for size in range(0, len(optional) + 1):
        for combo in combinations(optional, size):
            if ("fsdp" in combo and "tensor_parallel" in combo
                    and n_devices < 4):
                continue
            strategy = list(forced) + [(name, {}) for name in combo]
            if strategy not in candidates:
                candidates.append(strategy)
                if len(candidates) >= max_candidates:
                    return candidates
        # after the singles round — or right after the baseline when there
        # are no optional passes at all (extras must still be planned)
        if size == min(1, len(optional)):
            for strategy in extras:
                if strategy not in candidates:
                    candidates.append(strategy)
                    if len(candidates) >= max_candidates:
                        return candidates
    return candidates
