"""Node event watchers (reference: dlrover/python/master/watcher/).

The local watcher only; the Kubernetes and Ray watchers wait for ROADMAP
Queue A item 12.10."""

from dlrover_tpu_torch.master.watcher.base import NodeEvent, NodeWatcher
from dlrover_tpu_torch.master.watcher.local_watcher import LocalNodeWatcher

__all__ = ["NodeEvent", "NodeWatcher", "LocalNodeWatcher"]
