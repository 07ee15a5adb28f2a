"""Stats reporters: the local log store or the brain service.

Own copy of the JAX package's ``master/stats/reporter.py``, after
dlrover/python/master/stats/reporter.py (ReporterType LOCAL /
DLROVER_BRAIN selection in dist_master.py:116-127). The brain reporter
is ``brain/client.py::BrainReporter``.
"""

from __future__ import annotations

import abc
import json
import threading
import time
from typing import Any, Dict, List, Optional


class ReporterType:
    LOCAL = "local"
    BRAIN = "brain"


class StatsReporter(abc.ABC):
    @abc.abstractmethod
    def report(self, record_type: str, payload: Dict[str, Any]) -> None:
        ...

    @classmethod
    def new_reporter(cls, reporter_type: str = ReporterType.LOCAL,
                     **kwargs) -> "StatsReporter":
        if reporter_type == ReporterType.BRAIN:
            from dlrover_tpu_torch.brain.client import BrainReporter

            return BrainReporter(**kwargs)
        return LocalStatsReporter(**kwargs)


class LocalStatsReporter(StatsReporter):
    """Keeps records in memory and (optionally) appends JSON lines to a
    file for offline analysis."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def report(self, record_type: str, payload: Dict[str, Any]) -> None:
        record = {"type": record_type, "ts": time.time(), **payload}
        with self._lock:
            self._records.append(record)
            if self._path:
                with open(self._path, "a") as f:
                    f.write(json.dumps(record) + "\n")

    def records(self, record_type: Optional[str] = None
                ) -> List[Dict[str, Any]]:
        with self._lock:
            if record_type is None:
                return list(self._records)
            return [r for r in self._records if r["type"] == record_type]
