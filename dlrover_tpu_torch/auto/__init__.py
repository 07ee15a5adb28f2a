"""Auto-acceleration: one call from a strategy to a lowered trainer.

Counterpart of ``dlrover_tpu/auto`` (after atorch's ``auto_accelerate``
stack, atorch/auto/accelerate.py:391, model_context.py,
opt_lib/optimization_library.py:38-53). An optimization does not wrap
modules: it edits an AccelerationPlan (mesh spec, logical-axis sharding
rules, dtypes, remat policy, kernel choices, accumulation), and one final
lowering builds the port's trainer from the whole plan. Strategies are
declarative data, saved and loaded as the JAX package's are.
"""

from dlrover_tpu_torch.auto.accelerate import AccelerateResult, auto_accelerate
from dlrover_tpu_torch.auto.model_context import ModelContext
from dlrover_tpu_torch.auto.opt_lib import OptimizationLibrary
from dlrover_tpu_torch.auto.strategy import (
    Strategy,
    load_strategy,
    save_strategy,
)

__all__ = [
    "AccelerateResult",
    "ModelContext",
    "OptimizationLibrary",
    "Strategy",
    "auto_accelerate",
    "load_strategy",
    "save_strategy",
]
