"""TaskManager: dynamic data sharding front door on the master.

Own copy of the JAX package's ``master/shard/task_manager.py``, after
dlrover/python/master/shard/task_manager.py:37 — owns one
dataset manager per registered dataset, dispatches shard tasks to whichever
worker asks (faster workers naturally get more data), recovers tasks of dead
workers and timed-out tasks, and exposes the data-position checkpoint.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.common.messages import DatasetShardParams, Task
from dlrover_tpu_torch.master.shard.dataset_manager import (
    BatchDatasetManager,
    DatasetShardCheckpoint,
)
from dlrover_tpu_torch.master.shard.dataset_splitter import new_dataset_splitter


class TaskManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._datasets: Dict[str, BatchDatasetManager] = {}
        # registration params, kept verbatim so a restarted master can
        # rebuild each dataset's splitter (master/state_backend.py)
        self._params: Dict[str, DatasetShardParams] = {}
        self.speed_monitor = None   # wired by the job master
        # speed-weighted dispatch (ctx.dispatch_speed_weighted):
        # (dataset, worker) -> [served, polls] stride counters.
        # Deliberately NOT exported — snapshotting poll counts would
        # persist dispatch *rhythm*, not data position.
        self._dispatch_counters: Dict[Tuple[str, int], list] = {}

    @property
    def mutation_count(self) -> int:
        """Aggregate mutation counter over every dataset (+ the set of
        registrations itself): the servicer snapshots a TaskRequest only
        when this moved — idle WAIT polls export nothing."""
        with self._lock:
            return len(self._datasets) + sum(
                d.mutation_count for d in self._datasets.values())

    # -- dataset registration ---------------------------------------------
    def new_dataset(self, params: DatasetShardParams) -> None:
        with self._lock:
            if params.dataset_name in self._datasets:
                return  # idempotent: restarted workers re-register
            splitter = new_dataset_splitter(
                params.storage_type,
                params.dataset_name,
                params.dataset_size,
                params.shard_size,
                params.num_epochs,
                params.shuffle,
            )
            self._datasets[params.dataset_name] = BatchDatasetManager(
                params.task_type, splitter
            )
            self._params[params.dataset_name] = params
            logger.info("registered dataset %s: size=%d shard=%d epochs=%d",
                        params.dataset_name, params.dataset_size,
                        params.shard_size, params.num_epochs)

    def get_dataset(self, name: str) -> Optional[BatchDatasetManager]:
        with self._lock:
            return self._datasets.get(name)

    # -- dispatch ----------------------------------------------------------
    def get_dataset_task(self, worker_id: int, dataset_name: str) -> Task:
        with self._lock:
            dataset = self._datasets.get(dataset_name)
            if dataset is None:
                return Task(task_id=-1, dataset_name=dataset_name)
            if (Context.singleton().dispatch_speed_weighted
                    and self._defer_for_speed(worker_id, dataset)):
                return Task(task_id=-1, task_type=TaskType.WAIT,
                            dataset_name=dataset_name)
            return dataset.get_task(worker_id)

    def _defer_for_speed(self, worker_id: int, dataset) -> bool:
        """(lock held) Deterministic stride deferral: rank r is served
        iff served < polls x weight, with weight = its relative speed
        (SpeedMonitor.relative_speeds) clamped to
        [ctx.dispatch_weight_floor, 1.0]. Faster workers keep weight 1.0
        and are never deferred; a 3x-slow rank at the default 0.25 floor
        sees at most 3 consecutive WAITs, so progress is guaranteed and
        epoch coverage stays exactly-once (a deferral never pops a
        task, it only delays the pop). Polls count only while the
        dataset still has dispatchable work — end-of-epoch WAIT/NONE
        answers must not skew a rank's pace."""
        if self.speed_monitor is None or not dataset.has_pending():
            return False
        scores = self.speed_monitor.relative_speeds()
        score = scores.get(worker_id)
        if score is None or len(scores) < 2:
            return False   # no evidence, or no pack to pace against
        weight = max(Context.singleton().dispatch_weight_floor,
                     min(1.0, score))
        counter = self._dispatch_counters.setdefault(
            (dataset.dataset_name, worker_id), [0, 0])
        counter[1] += 1
        if counter[0] < counter[1] * weight:
            counter[0] += 1
            return False
        return True

    def report_dataset_task(self, dataset_name: str, task_id: int,
                            success: bool) -> bool:
        with self._lock:
            dataset = self._datasets.get(dataset_name)
            if dataset is None:
                return False
            known, doing = dataset.report_task_status(task_id, success)
            if (known and success and doing is not None
                    and self.speed_monitor is not None):
                # per-rank task latency feeds the worker-speed ledger
                # even before any step report carries timing, so
                # speed-weighted dispatch is not blind through the
                # data-only warmup
                shard = doing.task.shard
                self.speed_monitor.collect_task_latency(
                    doing.worker_id,
                    time.time() - doing.start_time,
                    (shard.end - shard.start) if shard else 0,
                )
            return known

    # -- recovery ----------------------------------------------------------
    def recover_tasks(self, worker_id: int) -> None:
        """A worker died: requeue all its doing tasks (reference:
        task_manager.py recover_tasks + TaskRescheduleCallback)."""
        with self._lock:
            for dataset in self._datasets.values():
                n = dataset.recover_worker_tasks(worker_id)
                if n:
                    logger.info("requeued %d tasks of dead worker %d (%s)",
                                n, worker_id, dataset.dataset_name)
            # its dispatch pace dies with it: a replacement rank must
            # not inherit the dead worker's stride position
            self._dispatch_counters = {
                k: v for k, v in self._dispatch_counters.items()
                if k[1] != worker_id
            }

    def recover_timeout_tasks(self) -> None:
        timeout = Context.singleton().task_timeout_s
        with self._lock:
            for dataset in self._datasets.values():
                dataset.recover_timeout_tasks(timeout)

    def start_timeout_recovery(self, interval_s: float = 60.0
                               ) -> threading.Thread:
        def loop():
            while True:
                time.sleep(interval_s)
                self.recover_timeout_tasks()

        thread = threading.Thread(target=loop, daemon=True,
                                  name="task-timeout-recovery")
        thread.start()
        return thread

    # -- status ------------------------------------------------------------
    def finished(self) -> bool:
        """All registered datasets exhausted (and at least one exists)."""
        with self._lock:
            return bool(self._datasets) and all(
                d.completed() for d in self._datasets.values()
            )

    def counts(self, dataset_name: str) -> Tuple[int, int]:
        with self._lock:
            dataset = self._datasets.get(dataset_name)
            return dataset.counts() if dataset else (0, 0)

    def get_epoch(self, dataset_name: str) -> int:
        with self._lock:
            dataset = self._datasets.get(dataset_name)
            return dataset.get_epoch() if dataset else 0

    # -- crash-consistent state (master/state_backend.py) ------------------
    def export_state(self) -> dict:
        with self._lock:
            return {
                "datasets": {
                    name: {
                        "params": dataclasses.asdict(self._params[name]),
                        "progress": mgr.export_state(),
                    }
                    for name, mgr in self._datasets.items()
                    if name in self._params
                }
            }

    def restore_state(self, state: dict) -> None:
        """Rebuild every dataset (splitter from its registration params,
        progress from the manager snapshot). Registration stays
        idempotent afterwards: a restarted worker re-registering the
        dataset hits the existing new_dataset no-op path."""
        for name, entry in state.get("datasets", {}).items():
            params = DatasetShardParams(**entry["params"])
            self.new_dataset(params)
            with self._lock:
                mgr = self._datasets.get(name)
            if mgr is not None:
                mgr.restore_state(entry.get("progress", {}))

    # -- data-position checkpoint -----------------------------------------
    def checkpoint_dataset(self, dataset_name: str
                           ) -> Optional[DatasetShardCheckpoint]:
        with self._lock:
            dataset = self._datasets.get(dataset_name)
            return dataset.checkpoint() if dataset else None

    def restore_dataset_checkpoint(self, content: str) -> bool:
        try:
            ckpt = DatasetShardCheckpoint.from_json(content)
        except (ValueError, KeyError, TypeError):
            # a worker restoring a checkpoint written before any dataset
            # was registered (or a corrupted payload) must not traceback
            # in the master's log — the report RPC just answers False
            return False
        with self._lock:
            dataset = self._datasets.get(ckpt.dataset_name)
            if dataset is None:
                return False
            dataset.restore_checkpoint(ckpt)
            return True
