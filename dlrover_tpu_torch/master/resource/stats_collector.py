"""Runtime-stats store feeding the resource optimizer.

Own copy of the JAX package's ``master/resource/stats_collector.py``,
after the stats side of dlrover/python/master/resource/
local_optimizer.py and master/stats/training_metrics.py: rolling
per-node resource samples and global throughput samples the optimizer
reads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional


@dataclass
class NodeSample:
    timestamp: float
    cpu_percent: float
    memory_mb: float
    chip_duty_cycle_pct: float = 0.0
    hbm_used_mb: float = 0.0


@dataclass
class SpeedSample:
    timestamp: float
    worker_count: int
    steps_per_sec: float


class RuntimeStatsCollector:
    """Rolling window of node/speed samples."""

    def __init__(self, window: int = 200):
        self._node_samples: Dict[str, Dict[int, Deque[NodeSample]]] = {}
        self._speed_samples: Deque[SpeedSample] = deque(maxlen=window)
        self._window = window
        self._lock = threading.Lock()

    def add_node_sample(self, node_type: str, node_id: int,
                        sample: NodeSample) -> None:
        with self._lock:
            by_id = self._node_samples.setdefault(node_type, {})
            samples = by_id.setdefault(
                node_id, deque(maxlen=self._window))
            samples.append(sample)

    def add_speed_sample(self, worker_count: int,
                         steps_per_sec: float) -> None:
        with self._lock:
            self._speed_samples.append(
                SpeedSample(time.time(), worker_count, steps_per_sec))

    def latest_node_sample(self, node_type: str,
                           node_id: int) -> Optional[NodeSample]:
        with self._lock:
            samples = self._node_samples.get(node_type, {}).get(node_id)
            return samples[-1] if samples else None

    def node_ids(self, node_type: str) -> List[int]:
        with self._lock:
            return list(self._node_samples.get(node_type, {}))

    def speed_by_worker_count(self) -> Dict[int, float]:
        """worker count → mean steps/sec (for scale-efficiency estimates)."""
        with self._lock:
            acc: Dict[int, List[float]] = {}
            for s in self._speed_samples:
                acc.setdefault(s.worker_count, []).append(s.steps_per_sec)
        return {k: sum(v) / len(v) for k, v in acc.items() if v}

    def max_node_usage(self, node_type: str) -> Dict[str, float]:
        """Peak cpu%/memory over all nodes of a type (sizing input)."""
        peak = {"cpu_percent": 0.0, "memory_mb": 0.0, "hbm_used_mb": 0.0}
        with self._lock:
            for samples in self._node_samples.get(node_type, {}).values():
                for s in samples:
                    peak["cpu_percent"] = max(peak["cpu_percent"],
                                              s.cpu_percent)
                    peak["memory_mb"] = max(peak["memory_mb"], s.memory_mb)
                    peak["hbm_used_mb"] = max(peak["hbm_used_mb"],
                                              s.hbm_used_mb)
        return peak
