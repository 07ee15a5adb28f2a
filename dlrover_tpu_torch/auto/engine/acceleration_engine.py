"""Strategy search: candidates → dry-run scores → best strategy.

Counterpart of ``dlrover_tpu/auto/engine/acceleration_engine.py`` (after
atorch's AccelerationEngine and sg_algo, auto/engine/
acceleration_engine.py:34, engine/executor.py:36). Candidates are
dry-run in this process, one after another (``dry_runner.py`` gives each
one's memory back before the next); the search is successive halving
over small candidate spaces and Gaussian-process Bayesian optimization
(``sg_algo.bo_search``) when the space outgrows the profiling budget,
with deterministic tie-breaking toward smaller strategies. The same
environment knobs: ``DLROVER_TPU_SEARCH_MAX_CANDIDATES``,
``DLROVER_TPU_SEARCH_BUDGET`` and ``DLROVER_TPU_SEARCH_ALGO``.
"""

from __future__ import annotations

import os
from typing import List, Tuple

from dlrover_tpu_torch.auto.engine.dry_runner import dry_run
from dlrover_tpu_torch.auto.engine.planner import plan_candidates
from dlrover_tpu_torch.auto.engine.sg_algo import bo_search
from dlrover_tpu_torch.auto.model_context import ModelContext
from dlrover_tpu_torch.auto.strategy import Strategy
from dlrover_tpu_torch.common.log import default_logger as logger


def _fallback_default(context: ModelContext) -> Strategy:
    logger.warning(
        "every candidate strategy failed to dry-run; falling back "
        "to the default baseline")
    from dlrover_tpu_torch.auto.accelerate import default_strategy

    return default_strategy(len(context.devices))


def search_strategy(
    context: ModelContext,
    max_candidates: int = 0,
    rungs: Tuple[int, ...] = (1, 3),
    keep_fraction: float = 0.5,
    algo: str = "auto",
    budget: int = 0,
) -> Strategy:
    """Pick the best strategy by profiling candidates.

    algo: "sh" = successive halving (profile every candidate briefly,
    keep the top fraction, re-profile longer); "bo" = GP Bayesian
    optimization spending only `budget` dry-runs (sample-efficient for
    large candidate spaces); "auto" = bo when the candidate list
    outgrows the budget, else sh. Overridable via
    DLROVER_TPU_SEARCH_ALGO.
    """
    max_candidates = max_candidates or int(os.environ.get(
        "DLROVER_TPU_SEARCH_MAX_CANDIDATES", 8))
    # explicit arguments win over the env knobs, uniformly
    budget = max(1, budget or int(os.environ.get(
        "DLROVER_TPU_SEARCH_BUDGET") or 6))
    if algo == "auto":
        algo = os.environ.get("DLROVER_TPU_SEARCH_ALGO", "auto")
    algo = algo.strip().lower()
    if algo not in ("auto", "bo", "sh"):
        logger.warning("unknown search algo %r; using successive halving",
                       algo)
        algo = "sh"
    candidates = plan_candidates(context, max_candidates=max_candidates)
    if not candidates:
        return []
    if algo == "auto":
        algo = "bo" if len(candidates) > budget else "sh"
    if algo == "bo":
        best, best_speed, history = bo_search(
            candidates,
            lambda c: dry_run(context, c, warmup=1, steps=rungs[-1])[0],
            budget=budget)
        if best is None:
            return _fallback_default(context)
        logger.info("bo search picked %s (%.2f steps/s, %d/%d profiled)",
                    [name for name, _ in best], best_speed,
                    len(history), len(candidates))
        return best
    scored: List[Tuple[float, int, Strategy]] = [
        (0.0, i, c) for i, c in enumerate(candidates)]
    for steps in rungs:
        results = []
        for _, i, candidate in scored:
            speed, err = dry_run(context, candidate, warmup=1, steps=steps)
            if err:
                logger.info("candidate %s rejected: %s",
                            [n for n, _ in candidate], err[:200])
                continue  # failed candidates never advance a rung
            results.append((speed, i, candidate))
        if not results:
            return _fallback_default(context)
        results.sort(key=lambda t: (-t[0], len(t[2])))
        keep = max(1, int(len(results) * keep_fraction))
        scored = results[:keep]
        if len(scored) == 1:
            break
    best_speed, _, best = scored[0]
    logger.info("search picked %s (%.2f steps/s)",
                [name for name, _ in best], best_speed)
    return best
