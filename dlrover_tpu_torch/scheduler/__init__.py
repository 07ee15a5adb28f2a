"""Platform scheduler abstraction.

Own copy of the JAX package's ``scheduler/``, after
dlrover/python/scheduler/: ``JobArgs`` parsed per platform, the platform
clients, and the factory. Only the local platform is ported: an
in-memory cluster with a watch stream, used by tests and the standalone
path. ``kubernetes`` and ``ray`` are ROADMAP Queue A item 12.10.
"""

from dlrover_tpu_torch.scheduler.job import JobArgs, NodeArgs
from dlrover_tpu_torch.scheduler.factory import new_platform_cluster

__all__ = ["JobArgs", "NodeArgs", "new_platform_cluster"]
