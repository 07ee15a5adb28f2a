"""Node event watchers (reference: dlrover/python/master/watcher/).

The local watcher, the Kubernetes pod watcher (``k8s_watcher.py``) and
the Ray actor watcher (``ray_watcher.py``)."""

from dlrover_tpu_torch.master.watcher.base import NodeEvent, NodeWatcher
from dlrover_tpu_torch.master.watcher.local_watcher import LocalNodeWatcher

__all__ = ["NodeEvent", "NodeWatcher", "LocalNodeWatcher"]
