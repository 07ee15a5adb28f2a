"""Scale-plan actuation (reference: dlrover/python/master/scaler/).

The local scaler only; the pod and Ray scalers wait for ROADMAP Queue A
item 12.10."""

from dlrover_tpu_torch.master.scaler.base import ScalePlan, Scaler
from dlrover_tpu_torch.master.scaler.local_scaler import LocalScaler

__all__ = ["ScalePlan", "Scaler", "LocalScaler"]
