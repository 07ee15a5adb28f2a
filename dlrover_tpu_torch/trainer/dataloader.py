"""Elastic data loading: master-tuned batch size + dynamic shard feed.

Own copy of the JAX package's ``trainer/dataloader.py``:
- ElasticDataLoader hot-reloads its batch size from the tuned-config
  file (dlrover/trainer/torch/elastic/dataloader.py:26,97-141), written
  by the agent's ParalConfigTuner (``agent/monitor.py``) from the
  master's merged ParallelConfig.
- ShardedDataset: workers fetch index shards from the master instead of
  partitioning statically (elastic_agent/sharding/client.py:192
  fetch_shard), through ``MasterClient.get_task`` and
  ``report_task_result``. Given ``config_file``, it hot-reloads its batch
  size at batch boundaries as ElasticDataLoader does (the JAX package's
  ShardedDataset has no reload; without the file the two are the same).
Batches are numpy arrays, as in the JAX package; the caller moves a
batch to its device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler


class _TunedBatchSize:
    """A batch size that the tuned-config file may replace."""

    batch_size: int
    _config_file: Optional[str] = None
    _config_version: int = -1

    def load_config(self) -> None:
        """Pick up a master-tuned batch size if the config file changed."""
        if not self._config_file or not os.path.exists(self._config_file):
            return
        try:
            with open(self._config_file) as f:
                config = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        version = config.get("version", 0)
        if version <= self._config_version:
            return
        self._config_version = version
        new_bs = config.get("dataloader_batch_size", 0)
        if new_bs > 0 and new_bs != self.batch_size:
            logger.info("hot-reloaded batch size %d -> %d (config v%d)",
                        self.batch_size, new_bs, version)
            self.batch_size = new_bs


class ElasticDataLoader(_TunedBatchSize):
    """Batch iterator over an indexable dataset with a checkpointable
    sampler and a hot-reloadable batch size."""

    def __init__(
        self,
        dataset,                       # indexable: dataset[i] -> np record
        batch_size: int,
        sampler: Optional[ElasticDistributedSampler] = None,
        collate_fn: Optional[Callable] = None,
        config_file: Optional[str] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ElasticDistributedSampler(
            len(dataset), shuffle=False
        )
        self.collate_fn = collate_fn or _default_collate
        self._config_file = config_file
        self.load_config()

    def __iter__(self) -> Iterator:
        batch: List = []
        for index in self.sampler:
            batch.append(self.dataset[index])
            if len(batch) >= self.batch_size:
                yield self.collate_fn(batch)
                batch = []
                self.load_config()
        if batch:
            yield self.collate_fn(batch)


class ShardedDataset(_TunedBatchSize):
    """Iterates master-dispatched shards of a dataset (dynamic sharding);
    faster workers pull more shards (reference: IndexShardingClient,
    sharding/client.py:233). With ``config_file`` the batch size follows
    the tuned config from the next batch on."""

    def __init__(self, master_client, dataset_name: str, dataset,
                 batch_size: int, collate_fn: Optional[Callable] = None,
                 wait_poll_s: float = 0.2,
                 config_file: Optional[str] = None):
        self._client = master_client
        self.dataset_name = dataset_name
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self._wait_poll_s = wait_poll_s
        self._current_task_id: Optional[int] = None
        self._config_file = config_file
        self.load_config()

    def register(self, shard_size: int, num_epochs: int = 1,
                 shuffle: bool = False, storage_type: str = "text") -> None:
        from dlrover_tpu_torch.common.messages import DatasetShardParams

        self._client.report_dataset_shard_params(DatasetShardParams(
            dataset_name=self.dataset_name,
            dataset_size=len(self.dataset),
            shard_size=shard_size,
            num_epochs=num_epochs,
            shuffle=shuffle,
            task_type=TaskType.TRAINING,
            storage_type=storage_type,
        ))

    def __iter__(self) -> Iterator:
        while True:
            task = self._client.get_task(self.dataset_name)
            if task.task_type == TaskType.WAIT:
                time.sleep(self._wait_poll_s)
                continue
            if task.is_empty or task.task_type == TaskType.NONE:
                return
            self._current_task_id = task.task_id
            shard = task.shard
            indices = (shard.indices if shard.indices is not None
                       else range(shard.start, shard.end))
            batch: List = []
            for index in indices:
                batch.append(self.dataset[index])
                if len(batch) >= self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
                    self.load_config()
            if batch:
                yield self.collate_fn(batch)
                self.load_config()
            self._client.report_task_result(self.dataset_name, task.task_id,
                                            success=True)
            self._current_task_id = None


def _default_collate(batch: Sequence) -> np.ndarray:
    return np.stack([np.asarray(item) for item in batch])
