"""Named barriers across workers.

Own copy of the JAX package's ``master/sync_service.py``, after
dlrover/python/master/elastic_training/sync_service.py:26 —
workers join a named sync; the barrier is finished either when every expected
worker joined or when explicitly finished by a controller; workers poll the
barrier state. Used e.g. around mesh rebuilds and PS migration points.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set


class SyncService:
    def __init__(self, expected_workers: Optional[int] = None):
        self._lock = threading.Lock()
        self._syncs: Dict[str, Set[int]] = {}
        self._finished: Set[str] = set()
        self._expected_workers = expected_workers

    def set_expected_workers(self, count: int) -> None:
        with self._lock:
            self._expected_workers = count

    def join_sync(self, sync_name: str, node_id: int) -> bool:
        with self._lock:
            members = self._syncs.setdefault(sync_name, set())
            members.add(node_id)
            if (self._expected_workers
                    and len(members) >= self._expected_workers):
                self._finished.add(sync_name)
            return True

    def sync_finished(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._finished

    def finish_sync(self, sync_name: str) -> bool:
        with self._lock:
            self._finished.add(sync_name)
            return True

    def remove_node(self, node_id: int) -> None:
        with self._lock:
            for members in self._syncs.values():
                members.discard(node_id)


class ElasticPsService:
    """Cluster-version arbitration for PS-style failover (reference:
    dlrover/python/master/elastic_training/elastic_ps.py:18).

    Workers hold a local version; the master holds the global version. After
    a PS-style state holder migrates, the global version bumps and workers
    reconcile (re-connect / restore) when their local version lags.
    """

    LOCAL = "local"
    GLOBAL = "global"
    RESTORED = "restored"

    def __init__(self):
        self._lock = threading.Lock()
        self._global_version = 0
        self._node_versions: Dict[str, Dict[int, int]] = {}
        self._restored_version = 0

    def inc_global_cluster_version(self) -> int:
        with self._lock:
            self._global_version += 1
            return self._global_version

    def update_cluster_version(self, version_type: str, version: int,
                               task_type: str, task_id: int) -> None:
        with self._lock:
            if version_type == self.LOCAL:
                self._node_versions.setdefault(task_type, {})[task_id] = (
                    version
                )
            elif version_type == self.GLOBAL:
                self._global_version = version
            elif version_type == self.RESTORED:
                self._restored_version = version

    def remove_node(self, task_type: str, task_id: int) -> None:
        """Drop a dead node's published local version so cluster-wide
        reconciliation checks never wait on it."""
        with self._lock:
            self._node_versions.get(task_type, {}).pop(task_id, None)

    def get_cluster_version(self, version_type: str, task_type: str,
                            task_id: int) -> int:
        with self._lock:
            if version_type == self.LOCAL:
                return self._node_versions.get(task_type, {}).get(task_id, 0)
            if version_type == self.RESTORED:
                return self._restored_version
            return self._global_version
