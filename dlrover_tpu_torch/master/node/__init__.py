"""Master-side node lifecycle management (reference: dlrover/python/master/node/)."""

from dlrover_tpu_torch.master.node.job_manager import JobManager, create_job_manager

__all__ = ["JobManager", "create_job_manager"]
