"""Job metric collection/reporting (reference: dlrover/python/master/stats/)."""

from dlrover_tpu_torch.master.stats.job_collector import JobMetricCollector
from dlrover_tpu_torch.master.stats.reporter import (
    LocalStatsReporter,
    StatsReporter,
)

__all__ = ["JobMetricCollector", "StatsReporter", "LocalStatsReporter"]
