"""Platform factory (reference: dlrover/python/scheduler/factory.py).

Own copy of the JAX package's ``scheduler/factory.py``: the local
platform's in-memory cluster and the Kubernetes REST client (a Ray job's
client is built by ``create_job_manager``, as in the JAX package).
"""

from __future__ import annotations

from typing import Any

from dlrover_tpu_torch.common.constants import PlatformType


def new_platform_cluster(platform: str, namespace: str = "default",
                         **kwargs: Any) -> Any:
    if platform == PlatformType.LOCAL:
        from dlrover_tpu_torch.scheduler.local import LocalCluster

        return LocalCluster(**kwargs)
    if platform == PlatformType.KUBERNETES:
        from dlrover_tpu_torch.scheduler.kubernetes import K8sClient

        return K8sClient(namespace=namespace, **kwargs)
    raise ValueError(f"unknown platform {platform!r}")
