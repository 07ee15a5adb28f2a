"""ElasticJob operator: the reconcile loop and the master pod's lifecycle.

Own copy of the JAX package's ``operator/``, after the Go operator
(dlrover/go/operator/: the ElasticJob and ScalePlan CRDs of
elasticjob_types.go:29-123, Reconcile in elasticjob_controller.go:85, the
master pod of master/master.go:53-162). The decision core is the native
table of ``native/reconciler.cpp`` behind ctypes (``native.py``, built by
``native_build.py``); this package is the actuation shell over the
Kubernetes REST client or the in-memory ``LocalCluster``.
"""

from dlrover_tpu_torch.operator.native import Action, ActionKind, JobObserved, reconcile
from dlrover_tpu_torch.operator.controller import ElasticJobController

__all__ = ["Action", "ActionKind", "JobObserved", "reconcile",
           "ElasticJobController"]
