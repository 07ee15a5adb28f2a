"""Resource plans, optimizers, auto-scaling
(reference: dlrover/python/master/resource/). The brain's optimizer
waits for ROADMAP Queue A item 12.10."""

from dlrover_tpu_torch.master.resource.optimizer import (
    ResourceLimits,
    ResourceOptimizer,
    ResourcePlan,
)
from dlrover_tpu_torch.master.resource.local_optimizer import LocalResourceOptimizer

__all__ = [
    "ResourceLimits",
    "ResourceOptimizer",
    "ResourcePlan",
    "LocalResourceOptimizer",
]
