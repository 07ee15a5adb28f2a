"""The optimizer family, per leaf.

Counterpart of ``dlrover_tpu/optim`` (optax transformations there):

- ``adafactor``        optax's ``adafactor`` chain (the MoE example's)
- ``agd``              AGD, gradient-difference preconditioning
- ``bf16_master``      bf16 parameters with f32 master copies
- ``row_sparse_*``     row-sparse Adagrad, Adam and SGD for embeddings
- ``wsam_value_and_grad``  WSAM's gradient of a module's loss
- ``factored_rms``     optax's ``scale_by_factored_rms`` chained with
                       ``scale(-lr)``, the JAX bench's lean optimizer

Each optimizer is a :class:`LeafTransform` (``base.py``), run by
:class:`LeafOptimizer` as a ``torch.optim.Optimizer``
(``build_trainer(..., optimizer_factory=lambda p: LeafOptimizer(p,
factored_rms(3e-4)))``) or leaf by leaf by the streaming step.
"""

from dlrover_tpu_torch.optim.adafactor import adafactor
from dlrover_tpu_torch.optim.agd import agd
from dlrover_tpu_torch.optim.base import LeafOptimizer, LeafTransform
from dlrover_tpu_torch.optim.bf16 import bf16_master
from dlrover_tpu_torch.optim.factored import factored_rms
from dlrover_tpu_torch.optim.sparse import (
    row_sparse_adagrad,
    row_sparse_adam,
    row_sparse_sgd,
)
from dlrover_tpu_torch.optim.wsam import wsam_value_and_grad

__all__ = ["LeafOptimizer", "LeafTransform", "adafactor", "agd",
           "bf16_master", "factored_rms", "row_sparse_adagrad", "row_sparse_adam",
           "row_sparse_sgd", "wsam_value_and_grad"]
