"""Resource plans, optimizers, auto-scaling
(reference: dlrover/python/master/resource/). The brain's optimizer
is ``brain/client.py::BrainResourceOptimizer``."""

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
