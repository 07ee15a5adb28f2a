"""Scale-plan actuation (reference: dlrover/python/master/scaler/).

The local scaler, the Kubernetes pod scaler (``pod_scaler.py``) and the
Ray actor scaler (``ray_scaler.py``)."""

from dlrover_tpu_torch.master.scaler.base import ScalePlan, Scaler
from dlrover_tpu_torch.master.scaler.local_scaler import LocalScaler

__all__ = ["ScalePlan", "Scaler", "LocalScaler"]
