"""The port's streaming dataset manager against the JAX package's
(``master/shard/streaming_dataset_manager.py``,
tests/test_streaming_and_coworker.py's cases): the same operations give
the same tasks and counts, the checkpoints are equal as JSON, and a
checkpoint of either package restores into the other."""

import dataclasses

import pytest

from dlrover_tpu.master.shard import dataset_manager as jdm
from dlrover_tpu.master.shard import streaming_dataset_manager as jsdm
from dlrover_tpu_torch.master.shard import dataset_manager as tdm
from dlrover_tpu_torch.master.shard import streaming_dataset_manager as tsdm

PACKAGES = ((jsdm, jdm), (tsdm, tdm))


def _task(task):
    return (task.task_id, task.task_type, task.dataset_name,
            None if task.shard is None else
            (task.shard.start, task.shard.end))


def _script(sdm):
    """One run of every operation; what each answered, then the
    manager."""
    mgr = sdm.StreamingDatasetManager("s", shard_size=5)
    out = [_task(mgr.get_task(0))]                    # empty stream: WAIT
    mgr.advance_watermark(23)                         # 20..23 not full
    out += [_task(mgr.get_task(w)) for w in (0, 1, 1)]
    out.append(mgr.report_task_status(1, success=True))
    out.append(mgr.report_task_status(2, success=False))
    out.append(mgr.report_task_status(99, success=True))
    out.append(mgr.recover_worker_tasks(1))
    out.append(mgr.counts())
    mgr.advance_watermark(23)                         # no growth
    mgr.advance_watermark(31)
    out += [_task(mgr.get_task(7)) for _ in range(3)]
    out.append(mgr.recover_timeout_tasks(3600.0))
    out.append(mgr.recover_timeout_tasks(-1.0))
    out += [mgr.counts(), mgr.completed(), mgr.completed_records(),
            mgr.get_epoch(), mgr.dataset_name]
    out.append(_task(mgr.get_task(2)))
    return out, mgr


def test_operations_give_the_same_tasks():
    (want, _), (got, _) = (_script(sdm) for sdm, _ in PACKAGES)
    assert got == want
    # what the script reached: shards minted only when full, a failure
    # and a dead worker's shard requeued at the front
    assert want[0][1] == "wait"
    assert [t[3] for t in want[1:4]] == [(0, 5), (5, 10), (10, 15)]


@pytest.mark.parametrize("case", ["watermark", "failure", "death"])
def test_reference_cases_match_jax(case):
    answers = []
    for sdm, _ in PACKAGES:
        mgr = sdm.StreamingDatasetManager("s", shard_size=10 if
                                          case == "watermark" else 5)
        out = []
        if case == "watermark":
            out.append(_task(mgr.get_task(0)))
            mgr.advance_watermark(35)
            out += [_task(mgr.get_task(0)) for _ in range(4)]
            mgr.advance_watermark(40)
            out.append(_task(mgr.get_task(1)))
        elif case == "failure":
            mgr.advance_watermark(10)
            task = mgr.get_task(0)
            mgr.report_task_status(task.task_id, success=False)
            out.append(_task(mgr.get_task(1)))
        else:
            mgr.advance_watermark(20)
            mgr.get_task(7)
            mgr.get_task(7)
            out += [mgr.recover_worker_tasks(7), mgr.counts()]
        answers.append(out)
    assert answers[1] == answers[0]


def _checkpointed(sdm):
    mgr = sdm.StreamingDatasetManager("s", shard_size=5)
    mgr.advance_watermark(20)
    done = mgr.get_task(0)
    mgr.report_task_status(done.task_id, success=True)
    mgr.get_task(1)          # in flight: survives as todo
    return mgr.checkpoint()


def test_checkpoints_are_equal_json():
    (want, got) = (_checkpointed(sdm) for sdm, _ in PACKAGES)
    assert got.to_json() == want.to_json()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0)],
                         ids=["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_packages(writer, reader):
    """A checkpoint written by one package restores into the other's
    manager: the undone shards come back, and the watermark and the
    next offset survive (new records mint from 20, not 0)."""
    w_sdm, _ = PACKAGES[writer]
    r_sdm, r_dm = PACKAGES[reader]
    content = _checkpointed(w_sdm).to_json()
    restored = r_sdm.StreamingDatasetManager("s", shard_size=5)
    restored.restore_checkpoint(r_dm.DatasetShardCheckpoint.from_json(
        content))
    assert restored.checkpoint().to_json() == content
    starts = []
    while True:
        task = restored.get_task(0)
        if task.task_type == "wait":
            break
        starts.append(task.shard.start)
    assert sorted(starts) == [5, 10, 15]
    restored.advance_watermark(25)
    assert restored.get_task(0).shard.start == 20
    assert restored.completed_records() == 5
