"""Brain: cluster-wide resource optimization from historical job metrics,
and the fleet controller.

Own copy of the JAX package's ``brain/``, after dlrover/go/brain/ (the
Brain service's persist_metrics, optimize and get_job_metrics,
dlrover/proto/brain.proto:196-200): the three operations over the
port's two-RPC comm layer, a sqlite datastore and the optimizer
algorithms over host shapes and card counts. The master consults it only
when ``optimize_mode`` is ``cluster`` with a brain address. The fleet
controller (``fleet_controller.py``) claims offered capacity, sheds a
gating slice and holds behind guardrails, on the master's own evidence.
"""

from dlrover_tpu_torch.brain.client import BrainClient, BrainReporter
from dlrover_tpu_torch.brain.service import BrainService

__all__ = ["BrainClient", "BrainReporter", "BrainService"]
