"""Training diagnosis engine: the layer where telemetry becomes
decisions (docs/observability.md, "Diagnosis")."""

from dlrover_tpu_torch.master.diagnosis.manager import DiagnosisManager
from dlrover_tpu_torch.master.diagnosis.rules import (
    DataPipelineBoundRule,
    DiagnosisReport,
    DiagnosisSnapshot,
    GoodputRule,
    HbmPressureRule,
    StragglerRule,
    ThroughputCollapseRule,
    default_rules,
    parse_action,
    straggler_scores,
)

__all__ = [
    "DataPipelineBoundRule",
    "DiagnosisManager",
    "DiagnosisReport",
    "DiagnosisSnapshot",
    "GoodputRule",
    "HbmPressureRule",
    "StragglerRule",
    "ThroughputCollapseRule",
    "default_rules",
    "parse_action",
    "straggler_scores",
]
