"""Checkpointable elastic distributed sampler.

Own copy of the JAX package's ``trainer/sampler.py`` (pure Python): the
same seed yields the same order in both. Capability parity:
dlrover/trainer/torch/elastic/sampler.py:25-130
(ElasticDistributedSampler: rank-partitioned indices, `state_dict` records
completed samples, `load_state_dict` resumes mid-epoch even when the world
size changed between save and restore).
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List


class ElasticDistributedSampler:
    def __init__(
        self,
        dataset_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        # samples already consumed (across all replicas) in this epoch
        self.completed_num = 0

    # -- iteration ---------------------------------------------------------
    def _epoch_indices(self) -> List[int]:
        indices = list(range(self.dataset_size))
        if self.shuffle:
            rng = random.Random(self.seed + self.epoch)
            rng.shuffle(indices)
        return indices

    def __iter__(self) -> Iterator[int]:
        indices = self._epoch_indices()[self.completed_num:]
        if self.drop_last:
            usable = (len(indices) // self.num_replicas) * self.num_replicas
            indices = indices[:usable]
        # round-robin partition so a world resize only re-deals future
        # samples (reference: sampler.py:71-116)
        yield from indices[self.rank::self.num_replicas]

    def __len__(self) -> int:
        remaining = self.dataset_size - self.completed_num
        if self.drop_last:
            return remaining // self.num_replicas
        return (remaining + self.num_replicas - 1 - self.rank
                ) // self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.completed_num = 0

    def record_batch(self, global_batch_size: int) -> None:
        """Advance the consumed-sample cursor by one *global* batch."""
        self.completed_num += global_batch_size

    # -- checkpoint --------------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {
            "epoch": self.epoch,
            "completed_num": self.completed_num,
            "seed": self.seed,
        }

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state.get("epoch", 0))
        self.seed = int(state.get("seed", self.seed))
        completed = int(state.get("completed_num", 0))
        # a resized world may not divide the old position evenly; clamp to a
        # replica boundary so every rank resumes at the same cursor
        completed -= completed % self.num_replicas
        self.completed_num = min(completed, self.dataset_size)
