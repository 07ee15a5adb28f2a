"""Platform scheduler abstraction.

Own copy of the JAX package's ``scheduler/``, after
dlrover/python/scheduler/: ``JobArgs`` parsed per platform, the platform
clients and the factory: the local platform (an in-memory cluster with a
watch stream, used by tests and the standalone path), the Kubernetes
REST client (``kubernetes.py``) and Ray (``ray.py``).
"""

from dlrover_tpu_torch.scheduler.job import JobArgs, NodeArgs
from dlrover_tpu_torch.scheduler.factory import new_platform_cluster

__all__ = ["JobArgs", "NodeArgs", "new_platform_cluster"]
