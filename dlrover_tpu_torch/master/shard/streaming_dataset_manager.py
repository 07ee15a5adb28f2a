"""Streaming dataset manager: unbounded shard stream with offset tracking.

Own copy of the JAX package's ``master/shard/streaming_dataset_manager.py``,
after dlrover/python/master/shard/streaming_dataset_manager.py (:32):
shards arrive as the stream grows (the splitter has no fixed end);
workers fetch the next unread range, report consumed offsets, and the
checkpoint records the high-water mark + in-flight ranges so a restarted
job resumes the stream without loss or duplication. Its checkpoint is
the JSON ``DatasetShardCheckpoint`` the batch manager uses. As in the JAX
master, nothing wires it into the task manager yet.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Tuple

from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import Shard, Task
from dlrover_tpu_torch.master.shard.dataset_manager import (
    DatasetShardCheckpoint,
    DoingTask,
)


class StreamingDatasetManager:
    """Shard queue over an append-only stream.

    `advance_watermark(n)` (fed by the stream source / a size poller)
    extends the readable range; shards of `shard_size` records are minted
    lazily up to the watermark.
    """

    def __init__(self, dataset_name: str, shard_size: int,
                 task_type: str = TaskType.TRAINING):
        self._dataset_name = dataset_name
        self._shard_size = shard_size
        self._task_type = task_type
        self._watermark = 0          # records known to exist
        self._next_offset = 0        # first record not yet sharded
        self._todo: Deque[Task] = deque()
        self._doing: Dict[int, DoingTask] = {}
        self._task_id = 0
        self._completed_records = 0

    @property
    def dataset_name(self) -> str:
        return self._dataset_name

    # -- stream growth -------------------------------------------------
    def advance_watermark(self, total_records: int) -> None:
        if total_records > self._watermark:
            self._watermark = total_records
            self._mint_shards()

    def _mint_shards(self) -> None:
        while self._next_offset + self._shard_size <= self._watermark:
            self._task_id += 1
            task = Task(
                task_id=self._task_id,
                task_type=self._task_type,
                dataset_name=self._dataset_name,
                shard=Shard(
                    start=self._next_offset,
                    end=self._next_offset + self._shard_size,
                ),
            )
            self._todo.append(task)
            self._next_offset += self._shard_size

    # -- worker protocol (same surface as BatchDatasetManager) -----------
    def get_task(self, worker_id: int) -> Task:
        if not self._todo:
            # stream has no end: an empty queue means WAIT, never "done"
            return Task(task_id=-1, task_type=TaskType.WAIT)
        task = self._todo.popleft()
        self._doing[task.task_id] = DoingTask(task, worker_id)
        return task

    def report_task_status(self, task_id: int, success: bool) -> bool:
        doing = self._doing.pop(task_id, None)
        if doing is None:
            return False
        if success:
            self._completed_records += (doing.task.shard.end
                                        - doing.task.shard.start)
        else:
            self._todo.appendleft(doing.task)
        return True

    def recover_worker_tasks(self, worker_id: int) -> int:
        recovered = 0
        for task_id in [tid for tid, d in self._doing.items()
                        if d.worker_id == worker_id]:
            self._todo.appendleft(self._doing.pop(task_id).task)
            recovered += 1
        if recovered:
            logger.info("streaming %s: requeued %d shard(s) of worker %d",
                        self._dataset_name, recovered, worker_id)
        return recovered

    def recover_timeout_tasks(self, timeout_s: float) -> int:
        now = time.time()
        recovered = 0
        for task_id in [tid for tid, d in self._doing.items()
                        if now - d.start_time > timeout_s]:
            self._todo.appendleft(self._doing.pop(task_id).task)
            recovered += 1
        return recovered

    def completed(self) -> bool:
        return False                 # a stream never completes by itself

    def completed_records(self) -> int:
        return self._completed_records

    def counts(self) -> Tuple[int, int]:
        return len(self._todo), len(self._doing)

    def get_epoch(self) -> int:
        return 0

    # -- checkpoint -------------------------------------------------------
    def checkpoint(self) -> DatasetShardCheckpoint:
        undone = [[t.shard.start, t.shard.end] for t in self._todo]
        undone += [[d.task.shard.start, d.task.shard.end]
                   for d in self._doing.values()]
        return DatasetShardCheckpoint(
            dataset_name=self._dataset_name,
            todo=sorted(undone),
            epoch=0,
            completed_records=self._completed_records,
            extra={"watermark": self._watermark,
                   "next_offset": self._next_offset},
        )

    def restore_checkpoint(self, ckpt: DatasetShardCheckpoint) -> None:
        self._todo.clear()
        self._doing.clear()
        for start, end in ckpt.todo:
            self._task_id += 1
            self._todo.append(Task(
                task_id=self._task_id, task_type=self._task_type,
                dataset_name=self._dataset_name,
                shard=Shard(start=start, end=end),
            ))
        self._completed_records = ckpt.completed_records
        extra = ckpt.extra or {}
        self._watermark = int(extra.get("watermark", self._watermark))
        self._next_offset = int(extra.get("next_offset",
                                          self._next_offset))
