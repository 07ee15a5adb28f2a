"""Dataset splitting into index-range shards.

Own copy of the JAX package's ``master/shard/dataset_splitter.py``, after
dlrover/python/master/shard/dataset_splitter.py —
`TableDatasetSplitter` (:144, range-only shards), `TextDatasetSplitter`
(:257, shards carry shuffled record indices), huge-dataset sub-epoch splitting
(`_split_epoch_for_huge_dataset` :181), and the `new_dataset_splitter`
factory (:325).
"""

from __future__ import annotations

import random
from abc import ABC, abstractmethod
from typing import List, Optional

from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import Shard

# Above this many shards in one epoch, split the epoch lazily in chunks.
_HUGE_SHARD_COUNT = 102_400


class DatasetSplitter(ABC):
    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int):
        if shard_size <= 0:
            raise ValueError(f"shard_size must be positive, got {shard_size}")
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = shard_size
        self._num_epochs = num_epochs
        self.epoch = 0

    @abstractmethod
    def create_shards(self) -> None:
        """Materialize shards for the next (sub-)epoch."""

    @abstractmethod
    def get_shards(self) -> List[Shard]:
        ...

    def epoch_finished(self) -> bool:
        return self.epoch >= self._num_epochs

    def get_epoch(self) -> int:
        return self.epoch


class TableDatasetSplitter(DatasetSplitter):
    """Shards are pure [start, end) ranges over a record-addressable store
    (reference: TableDatasetSplitter dataset_splitter.py:144)."""

    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int = 1, shuffle: bool = False,
                 max_shard_count: int = _HUGE_SHARD_COUNT,
                 seed: Optional[int] = None):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle
        self._shards: List[Shard] = []
        self._max_shard_count = max_shard_count
        self._rng = random.Random(seed)
        self._huge = (dataset_size // shard_size) > max_shard_count
        self._sub_epoch_offset = 0

    def get_shards(self) -> List[Shard]:
        return self._shards

    def create_shards(self) -> None:
        if self._huge:
            self._create_sub_epoch_shards()
        else:
            self._shards = self._range_shards(0, self.dataset_size)
            if self._shuffle:
                self._rng.shuffle(self._shards)
            self.epoch += 1

    def _range_shards(self, begin: int, end: int) -> List[Shard]:
        shards = []
        for start in range(begin, end, self.shard_size):
            shards.append(
                Shard(start=start, end=min(start + self.shard_size, end))
            )
        return shards

    def _create_sub_epoch_shards(self) -> None:
        """Huge datasets: materialize one chunk of shards at a time so the
        master's memory stays bounded (reference:
        _split_epoch_for_huge_dataset :181)."""
        chunk_records = self._max_shard_count * self.shard_size
        start = self._sub_epoch_offset
        if start >= self.dataset_size:
            self.epoch += 1
            self._sub_epoch_offset = 0
            start = 0
            if self.epoch_finished():
                self._shards = []
                return
        end = min(start + chunk_records, self.dataset_size)
        self._shards = self._range_shards(start, end)
        if self._shuffle:
            self._rng.shuffle(self._shards)
        self._sub_epoch_offset = end
        if self.epoch == 0 and start == 0:
            logger.info(
                "dataset %s is huge: %d records split per %d-shard sub-epoch",
                self.dataset_name, self.dataset_size, self._max_shard_count,
            )


class TextDatasetSplitter(DatasetSplitter):
    """Shards carry explicit (optionally shuffled) record indices (reference:
    TextDatasetSplitter dataset_splitter.py:257)."""

    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int = 1, shuffle: bool = False,
                 seed: Optional[int] = None):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self._shuffle = shuffle
        self._shards: List[Shard] = []
        self._rng = random.Random(seed)

    def get_shards(self) -> List[Shard]:
        return self._shards

    def create_shards(self) -> None:
        indices = list(range(self.dataset_size))
        if self._shuffle:
            self._rng.shuffle(indices)
        shards = []
        for start in range(0, self.dataset_size, self.shard_size):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(
                Shard(start=start, end=end, indices=indices[start:end])
            )
        self._shards = shards
        self.epoch += 1


def new_dataset_splitter(
    storage_type: str,
    dataset_name: str,
    dataset_size: int,
    shard_size: int,
    num_epochs: int = 1,
    shuffle: bool = False,
    seed: Optional[int] = None,
) -> DatasetSplitter:
    """Factory (reference: new_dataset_splitter dataset_splitter.py:325)."""
    if storage_type == "table":
        return TableDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle,
            seed=seed,
        )
    if storage_type in ("text", ""):
        return TextDatasetSplitter(
            dataset_name, dataset_size, shard_size, num_epochs, shuffle,
            seed=seed,
        )
    raise ValueError(f"unknown storage_type: {storage_type!r}")
