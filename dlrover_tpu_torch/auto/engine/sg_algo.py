"""Sample-efficient strategy search: Bayesian optimization over candidates.

Own copy of the JAX package's ``auto/engine/sg_algo.py`` (numpy only),
held equal to it by ``tests/test_torch_auto_engine.py``. Capability
parity: atorch's strategy-generation algorithms
(atorch/auto/engine/sg_algo/bo_sg.py, sg_algo/hebo/ — sample-efficient
Bayesian optimization proposing strategy combinations scored by dry-runs).
The search space is the planner's candidate list (sized +
combinatorial strategies); each candidate is featurized into a small
numeric vector, a Gaussian-process surrogate with an RBF kernel is fit on
the dry-run scores observed so far, and the next candidate to profile is
chosen by expected improvement. Dry-runs are expensive (each one lowers,
compiles, and times real training steps), so the surrogate exists to spend
the profiling budget on the most promising region of the space instead of
exhaustively timing every combination the way successive halving does.

Pure numpy — no sklearn/GPy dependency; the GP is a direct Cholesky solve,
which is plenty for the ≤ a-few-dozen observations a search ever makes.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dlrover_tpu_torch.auto.strategy import Strategy

# Stable feature vocabulary: every optimization pass the planner can emit.
# Unknown passes hash into the overflow slot so featurize never fails.
_PASS_VOCAB = (
    "half",
    "amp",
    "module_replace",
    "checkpoint",
    "fsdp",
    "zero1",
    "zero2",
    "tensor_parallel",
    "pipeline_parallel",
    "sequence_parallel",
    "expert_parallel",
    "data_parallel",
    "offload_optimizer",
)
_OVERFLOW = len(_PASS_VOCAB)
# vocab + overflow + log2 sizes of every sized axis pass — candidates
# differing only in an axis size must map to distinct feature vectors,
# or the GP treats them as one point and EI never explores the variants
_SIZED_SLOTS = {
    "fsdp": 0, "zero1": 0, "zero2": 0,
    "tensor_parallel": 1,
    "sequence_parallel": 2,
    "expert_parallel": 3,
    "pipeline_parallel": 4,
}
_N_FEATURES = _OVERFLOW + 1 + 1 + max(_SIZED_SLOTS.values())


def featurize(strategy: Strategy) -> np.ndarray:
    """Map a strategy (list of (pass_name, config)) to a fixed vector:
    per-pass indicators plus log2 of each sized axis."""
    x = np.zeros(_N_FEATURES, dtype=np.float64)
    for name, config in strategy:
        try:
            x[_PASS_VOCAB.index(name)] = 1.0
        except ValueError:
            x[_OVERFLOW] = 1.0
        size = int((config or {}).get("size", 0))
        slot = _SIZED_SLOTS.get(name)
        if size > 1 and slot is not None:
            x[_OVERFLOW + 1 + slot] = math.log2(size)
    return x


class GaussianProcess:
    """Minimal RBF-kernel GP regressor (zero mean on z-scored targets).

    Hyperparameters are set by heuristic rather than marginal-likelihood
    optimization: lengthscale = median pairwise distance of the training
    inputs (the classic median heuristic), unit signal variance, small
    noise jitter. With a handful of observations this is as good as
    anything tuned and never diverges.
    """

    def __init__(self, noise: float = 1e-4):
        self.noise = noise
        self._x: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._chol: Optional[np.ndarray] = None
        self._y_mean = 0.0
        self._y_std = 1.0
        self._lengthscale = 1.0

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        sq = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * sq / (self._lengthscale ** 2))

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64)
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        z = (y - self._y_mean) / self._y_std
        if len(x) > 1:
            sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
            pair = np.sqrt(sq[np.triu_indices(len(x), k=1)])
            med = float(np.median(pair))
            self._lengthscale = med if med > 1e-12 else 1.0
        self._x = x
        k = self._kernel(x, x) + self.noise * np.eye(len(x))
        self._chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, z))
        return self

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and stddev in the ORIGINAL target units."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        k_star = self._kernel(x, self._x)
        mean_z = k_star @ self._alpha
        v = np.linalg.solve(self._chol, k_star.T)
        var_z = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        mean = mean_z * self._y_std + self._y_mean
        std = np.sqrt(var_z) * self._y_std
        return mean, std


def expected_improvement(mean: np.ndarray, std: np.ndarray,
                         best: float, xi: float = 0.01) -> np.ndarray:
    """EI for maximization, closed form under the Gaussian posterior."""
    std = np.maximum(std, 1e-12)
    z = (mean - best - xi) / std
    # standard normal pdf/cdf without scipy
    pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2.0 * math.pi)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
    return (mean - best - xi) * cdf + std * pdf


def bo_search(
    candidates: Sequence[Strategy],
    evaluate: Callable[[Strategy], float],
    budget: int,
    n_init: int = 2,
) -> Tuple[Optional[Strategy], float, List[Tuple[float, Strategy]]]:
    """Spend `budget` evaluations over `candidates`, surrogate-guided.

    The first `n_init` evaluations take the planner's own ordering (the
    planner puts its model-aware best guess first, so the seed points are
    informative, not random). Failed evaluations (-inf) are kept in the
    GP's training set at a penalized-but-finite score so the surrogate
    learns to steer away from that region instead of ignoring it.

    Returns (best_strategy_or_None, best_score, history). best is None
    only when every evaluated candidate failed.
    """
    budget = min(budget, len(candidates))
    features = np.stack([featurize(c) for c in candidates])
    evaluated: Dict[int, float] = {}
    history: List[Tuple[float, Strategy]] = []

    def run(i: int) -> None:
        score = float(evaluate(candidates[i]))
        evaluated[i] = score
        history.append((score, candidates[i]))

    for i in range(min(n_init, budget)):
        run(i)

    while len(evaluated) < budget:
        valid = [s for s in evaluated.values() if math.isfinite(s)]
        remaining = [i for i in range(len(candidates)) if i not in evaluated]
        if not remaining:
            break
        if not valid:
            run(remaining[0])  # nothing to model yet: keep seeding
            continue
        floor = min(valid) - 2.0 * (np.std(valid) or abs(min(valid)) or 1.0)
        y = np.array([s if math.isfinite(s) else floor
                      for s in evaluated.values()])
        x = features[list(evaluated.keys())]
        gp = GaussianProcess().fit(x, y)
        mean, std = gp.predict(features[remaining])
        ei = expected_improvement(mean, std, best=max(valid))
        run(remaining[int(np.argmax(ei))])

    finite = [(s, c) for s, c in history if math.isfinite(s)]
    if not finite:
        return None, float("-inf"), history
    # tie-break toward smaller strategies, matching successive halving
    best_score, best = max(finite, key=lambda t: (t[0], -len(t[1])))
    return best, best_score, history
