"""Strategy-search engine (reference: atorch/auto/engine/)."""

from dlrover_tpu_torch.auto.engine.acceleration_engine import search_strategy
from dlrover_tpu_torch.auto.engine.analyser import analyse
from dlrover_tpu_torch.auto.engine.dry_runner import dry_run

__all__ = ["search_strategy", "analyse", "dry_run"]
