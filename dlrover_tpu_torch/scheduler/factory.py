"""Platform factory (reference: dlrover/python/scheduler/factory.py).

Own copy of the JAX package's ``scheduler/factory.py``: the local
platform only; Kubernetes and Ray wait for ROADMAP Queue A item 12.10.
"""

from __future__ import annotations

from typing import Any

from dlrover_tpu_torch.common.constants import PlatformType


def new_platform_cluster(platform: str, namespace: str = "default",
                         **kwargs: Any) -> Any:
    if platform == PlatformType.LOCAL:
        from dlrover_tpu_torch.scheduler.local import LocalCluster

        return LocalCluster(**kwargs)
    if platform in (PlatformType.KUBERNETES, PlatformType.RAY):
        raise NotImplementedError(
            f"platform {platform!r} is not ported: ROADMAP Queue A item "
            f"12.10")
    raise ValueError(f"unknown platform {platform!r}")
