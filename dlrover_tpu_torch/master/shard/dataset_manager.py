"""Per-dataset shard-queue managers with checkpointable data position.

Own copy of the JAX package's ``master/shard/dataset_manager.py``, after
dlrover/python/master/shard/base_dataset_manager.py
(`DatasetShardCheckpoint` :60) and batch_dataset_manager.py (`get_task` :52,
`report_task_status` :102, `checkpoint` :157): a todo queue of shard tasks, a
doing map with start times for timeout recovery, and a JSON checkpoint of
undone shards so a restarted job resumes at the exact data position.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import Shard, Task
from dlrover_tpu_torch.master.shard.dataset_splitter import DatasetSplitter


@dataclass
class DoingTask:
    task: Task
    worker_id: int
    start_time: float = field(default_factory=time.time)


@dataclass
class DatasetShardCheckpoint:
    """JSON-serializable data position (reference: base_dataset_manager.py:60).

    Each todo entry is ``[start, end]`` or ``[start, end, indices]`` — the
    indices of a shuffled text shard must survive restore or the job would
    re-read the wrong records.
    """

    dataset_name: str
    todo: List[list]
    epoch: int
    completed_records: int = 0
    # lazy-split huge datasets: records already materialized this epoch
    sub_epoch_offset: int = 0
    # manager-specific state (e.g. the streaming watermark)
    extra: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({
            "dataset_name": self.dataset_name,
            "todo": self.todo,
            "epoch": self.epoch,
            "completed_records": self.completed_records,
            "sub_epoch_offset": self.sub_epoch_offset,
            "extra": self.extra,
        })

    @classmethod
    def from_json(cls, content: str) -> "DatasetShardCheckpoint":
        d = json.loads(content)
        return cls(
            dataset_name=d["dataset_name"],
            todo=[list(t) for t in d["todo"]],
            epoch=d["epoch"],
            completed_records=d.get("completed_records", 0),
            sub_epoch_offset=d.get("sub_epoch_offset", 0),
            extra=d.get("extra", {}),
        )


class BatchDatasetManager:
    """Dispatch shard tasks of a batch (finite) dataset."""

    def __init__(self, task_type: str, splitter: DatasetSplitter):
        self._task_type = task_type
        self._splitter = splitter
        self.todo: Deque[Task] = deque()
        self.doing: Dict[int, DoingTask] = {}
        self._task_id_seq = 0
        self._completed_records = 0
        self._max_task_completed_time = 0.0
        # bumped on every mutation of snapshotted state — including
        # splitter epoch advances that yield NO task (a huge dataset's
        # final sub-epoch flip must reach a snapshot even though the
        # worker only got a WAIT/NONE answer). Gated on by the servicer
        # so idle WAIT polls don't pay for a state export.
        self.mutation_count = 0

    @property
    def dataset_name(self) -> str:
        return self._splitter.dataset_name

    # -- dispatch ----------------------------------------------------------
    def get_task(self, worker_id: int) -> Task:
        """Pop the next todo task; refill from the splitter at epoch края."""
        if not self.todo and not self._splitter.epoch_finished():
            self._create_todo_tasks()
        if not self.todo:
            if self.doing:
                # Epoch exhausted but peers still working: tell the worker to
                # wait — its peers' shards may be requeued on failure.
                return Task(task_id=-1, task_type=TaskType.WAIT,
                            dataset_name=self.dataset_name)
            return Task(task_id=-1, task_type=TaskType.NONE,
                        dataset_name=self.dataset_name)
        task = self.todo.popleft()
        self.doing[task.task_id] = DoingTask(task, worker_id)
        self.mutation_count += 1
        return task

    def _create_todo_tasks(self) -> None:
        self.mutation_count += 1   # the splitter advanced even if no
        # shard comes back (final-epoch flip)
        self._splitter.create_shards()
        shards = self._splitter.get_shards()
        epoch = self._splitter.get_epoch()
        for shard in shards:
            self.todo.append(Task(
                task_id=self._task_id_seq,
                task_type=self._task_type,
                dataset_name=self.dataset_name,
                shard=shard,
                epoch=epoch,
            ))
            self._task_id_seq += 1
        if shards:
            logger.info("dataset %s: created %d tasks (epoch %d)",
                        self.dataset_name, len(shards), epoch)

    def has_pending(self) -> bool:
        """Dispatchable work exists now or after a splitter refill — the
        gate for speed-weighted dispatch (TaskManager): a WAIT answer
        may only defer a worker while there is something left to defer
        it FROM, so end-of-epoch polls never count against its pace."""
        return bool(self.todo) or not self._splitter.epoch_finished()

    # -- completion / failure ---------------------------------------------
    def report_task_status(self, task_id: int, success: bool
                           ) -> Tuple[bool, Optional[DoingTask]]:
        """Returns (known, doing). The popped DoingTask carries the
        assignee and start time so the caller can feed per-rank task
        latency into the worker-speed ledger. Failed tasks are requeued
        at the front."""
        doing = self.doing.pop(task_id, None)
        if doing is None:
            return False, None
        self.mutation_count += 1
        if success:
            elapsed = time.time() - doing.start_time
            self._max_task_completed_time = max(
                self._max_task_completed_time, elapsed
            )
            shard = doing.task.shard
            self._completed_records += shard.end - shard.start
        else:
            self.todo.appendleft(doing.task)
        return True, doing

    def recover_worker_tasks(self, worker_id: int) -> int:
        """Requeue every doing task of a dead worker (reference:
        TaskRescheduleCallback event_callback.py:105)."""
        stale = [tid for tid, d in self.doing.items()
                 if d.worker_id == worker_id]
        for tid in stale:
            self.todo.appendleft(self.doing.pop(tid).task)
        if stale:
            self.mutation_count += 1
        return len(stale)

    def recover_timeout_tasks(self, timeout_s: float) -> int:
        now = time.time()
        stale = [tid for tid, d in self.doing.items()
                 if now - d.start_time > timeout_s]
        for tid in stale:
            doing = self.doing.pop(tid)
            logger.warning("task %d of worker %d timed out; requeueing",
                           tid, doing.worker_id)
            self.todo.appendleft(doing.task)
        if stale:
            self.mutation_count += 1
        return len(stale)

    def completed(self) -> bool:
        return (self._splitter.epoch_finished() and not self.todo
                and not self.doing)

    @property
    def completed_records(self) -> int:
        return self._completed_records

    def counts(self) -> Tuple[int, int]:
        return len(self.todo), len(self.doing)

    def get_epoch(self) -> int:
        return self._splitter.get_epoch()

    # -- data-position checkpoint -----------------------------------------
    def checkpoint(self) -> DatasetShardCheckpoint:
        """Snapshot undone shards: todo + doing (doing counts as undone —
        the worker may die before completing it)."""
        def entry(shard: Shard) -> list:
            if shard.indices is not None:
                return [shard.start, shard.end, shard.indices]
            return [shard.start, shard.end]

        todo = [entry(t.shard) for t in self.todo]
        todo += [entry(d.task.shard) for d in self.doing.values()]
        return DatasetShardCheckpoint(
            dataset_name=self.dataset_name,
            todo=todo,
            epoch=self._splitter.get_epoch(),
            completed_records=self._completed_records,
            sub_epoch_offset=getattr(self._splitter, "_sub_epoch_offset", 0),
        )

    # -- crash-consistent state (master/state_backend.py) -----------------
    # Unlike the worker-facing JSON checkpoint above (which folds doing
    # into todo — a restarted JOB must re-do in-flight shards), the master
    # snapshot keeps todo and doing distinct WITH task ids and owners: a
    # restarted MASTER must neither re-dispatch a shard a live worker is
    # still computing (double assignment) nor forget it (loss), and the
    # worker's eventual TaskResult must still match by task_id.

    @staticmethod
    def _shard_entry(shard: Shard) -> list:
        if shard.indices is not None:
            return [shard.start, shard.end, shard.indices]
        return [shard.start, shard.end]

    @staticmethod
    def _shard_from_entry(entry: list) -> Shard:
        return Shard(start=entry[0], end=entry[1],
                     indices=entry[2] if len(entry) > 2 else None)

    def export_state(self) -> dict:
        def task_entry(task: Task) -> dict:
            return {"id": task.task_id, "epoch": task.epoch,
                    "shard": self._shard_entry(task.shard)}

        return {
            "task_type": self._task_type,
            "task_id_seq": self._task_id_seq,
            "completed_records": self._completed_records,
            "epoch": self._splitter.get_epoch(),
            "sub_epoch_offset": getattr(self._splitter,
                                        "_sub_epoch_offset", 0),
            "todo": [task_entry(t) for t in self.todo],
            "doing": [
                {**task_entry(d.task), "worker_id": d.worker_id,
                 "start_time": d.start_time}
                for d in self.doing.values()
            ],
        }

    def restore_state(self, state: dict) -> None:
        def task_from(entry: dict) -> Task:
            return Task(
                task_id=int(entry["id"]),
                task_type=self._task_type,
                dataset_name=self.dataset_name,
                shard=self._shard_from_entry(entry["shard"]),
                epoch=int(entry.get("epoch", 0)),
            )

        # the exported task_type wins over the constructor's: a dataset
        # re-registered (new_dataset) before the snapshot restored must
        # not flip restored tasks back to the registration default
        self._task_type = str(state.get("task_type", self._task_type))
        self._task_id_seq = int(state.get("task_id_seq", 0))
        self._completed_records = int(state.get("completed_records", 0))
        self._splitter.epoch = int(state.get("epoch", 0))
        if hasattr(self._splitter, "_sub_epoch_offset"):
            self._splitter._sub_epoch_offset = int(
                state.get("sub_epoch_offset", 0))
        self.todo = deque(task_from(e) for e in state.get("todo", ()))
        # in-flight tasks get a fresh timeout clock: charging the master's
        # outage against task_timeout_s would requeue (and double-assign)
        # shards their workers are still legitimately computing
        now = time.time()
        self.doing = {
            int(e["id"]): DoingTask(task_from(e), int(e["worker_id"]),
                                    start_time=now)
            for e in state.get("doing", ())
        }

    def restore_checkpoint(self, ckpt: DatasetShardCheckpoint) -> None:
        """Rebuild the todo queue from a checkpoint, discarding in-memory
        state (reference: batch_dataset_manager.py restore path)."""
        self.todo.clear()
        self.doing.clear()
        self._splitter.epoch = ckpt.epoch
        if hasattr(self._splitter, "_sub_epoch_offset"):
            self._splitter._sub_epoch_offset = ckpt.sub_epoch_offset
        self._completed_records = ckpt.completed_records
        for item in ckpt.todo:
            start, end = item[0], item[1]
            indices = item[2] if len(item) > 2 else None
            self.todo.append(Task(
                task_id=self._task_id_seq,
                task_type=self._task_type,
                dataset_name=self.dataset_name,
                shard=Shard(start=start, end=end, indices=indices),
                epoch=ckpt.epoch,
            ))
            self._task_id_seq += 1
