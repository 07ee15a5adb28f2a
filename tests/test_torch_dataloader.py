"""The port's elastic data loading against the JAX package's
(``trainer/dataloader.py``, tests/test_trainer_data.py's cases): the same
batches from the same sampler, the same hot reload of the batch size,
``ShardedDataset`` over the port's master seeing the shard sequence
``ShardedDataset`` sees over the JAX master, and the chain from the
master's merged ParallelConfig through the agent's ``ParalConfigTuner``
and its file to the loader's next batch."""

import json

import numpy as np
import pytest

from dlrover_tpu.agent.master_client import MasterClient as JClient
from dlrover_tpu.master.job_master import JobMaster as JMaster
from dlrover_tpu.trainer import dataloader as jdl
from dlrover_tpu.trainer.sampler import ElasticDistributedSampler as JSampler
from dlrover_tpu_torch.agent.master_client import MasterClient as TClient
from dlrover_tpu_torch.agent.monitor import ParalConfigTuner
from dlrover_tpu_torch.master.job_master import JobMaster as TMaster
from dlrover_tpu_torch.trainer import dataloader as tdl
from dlrover_tpu_torch.trainer.sampler import (
    ElasticDistributedSampler as TSampler,
)
from test_torch_job_manager import make_job_args, wait_until

PACKAGES = [pytest.param((jdl, JSampler), id="jax"),
            pytest.param((tdl, TSampler), id="port")]


class _RangeDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.array([i, i * 2])


def _tolist(batches):
    return [b.tolist() for b in batches]


@pytest.mark.parametrize("kw", [
    dict(), dict(shuffle=True, seed=3),
    dict(num_replicas=3, rank=1, shuffle=True, seed=5)],
    ids=["plain", "shuffled", "rank1_of_3"])
def test_batches_match_jax(kw):
    runs = []
    for dl, sampler_cls in ((jdl, JSampler), (tdl, TSampler)):
        sampler = sampler_cls(23, **kw) if kw else None
        loader = dl.ElasticDataLoader(_RangeDataset(23), batch_size=4,
                                      sampler=sampler)
        batches = list(loader)
        assert all(isinstance(b, np.ndarray) for b in batches)
        runs.append(_tolist(batches))
    assert runs[1] == runs[0]
    assert sum(len(b) for b in runs[1]) == (23 if not kw.get("num_replicas")
                                            else 8)


def _reload_run(dl, config):
    """Batches of a loader whose config file changes twice mid-run,
    once to a stale version (ignored)."""
    loader = dl.ElasticDataLoader(_RangeDataset(64), batch_size=4,
                                  config_file=str(config))
    it = iter(loader)
    sizes = [len(next(it))]
    config.write_text(json.dumps({"dataloader_batch_size": 8,
                                  "version": 2}))
    sizes += [len(next(it)) for _ in range(3)]
    config.write_text(json.dumps({"dataloader_batch_size": 2,
                                  "version": 1}))
    sizes += [len(next(it)) for _ in range(2)]
    config.write_text(json.dumps({"dataloader_batch_size": 16,
                                  "version": 3}))
    sizes += [len(b) for b in it]
    return sizes, loader.batch_size


def test_hot_reload_matches_jax(tmp_path):
    want = _reload_run(jdl, tmp_path / "jax.json")
    got = _reload_run(tdl, tmp_path / "port.json")
    assert got == want
    assert got[0][:2] == [4, 8] and got[1] == 16


@pytest.mark.parametrize("pkg", PACKAGES)
def test_no_or_bad_config_keeps_the_batch_size(pkg, tmp_path):
    dl, _ = pkg
    config = tmp_path / "paral.json"
    config.write_text("{not json")
    loader = dl.ElasticDataLoader(_RangeDataset(8), batch_size=3,
                                  config_file=str(config))
    assert [len(b) for b in loader] == [3, 3, 2]
    assert dl.ElasticDataLoader(_RangeDataset(8), batch_size=3,
                                config_file=str(tmp_path / "missing")
                                ).batch_size == 3


def _shard_run(master_cls, client_cls, dl, num_epochs):
    """One worker pulls every shard of a dataset through ShardedDataset:
    its batches in order, and the master's counts after."""
    master = master_cls(port=0, host="127.0.0.1")
    master.prepare()
    client = client_cls(master.addr, node_id=0)
    try:
        data = dl.ShardedDataset(client, "ds", _RangeDataset(20),
                                 batch_size=3, wait_poll_s=0.01)
        data.register(shard_size=5, num_epochs=num_epochs)
        return _tolist(data), client.get_task_counts("ds")
    finally:
        client.close()
        master.stop()


@pytest.mark.parametrize("num_epochs", [1, 2])
def test_sharded_dataset_sees_the_jax_shard_sequence(num_epochs):
    want = _shard_run(JMaster, JClient, jdl, num_epochs)
    got = _shard_run(TMaster, TClient, tdl, num_epochs)
    assert got == want
    rows = sorted(r[0] for batch in got[0] for r in batch)
    assert rows == sorted(list(range(20)) * num_epochs)
    assert [len(b) for b in got[0][:2]] == [3, 2]    # a shard's tail
    assert got[1] == (0, 0)


def test_two_workers_split_the_shards():
    """Two port workers on their own threads take every record once
    between them."""
    import threading

    master = TMaster(port=0, host="127.0.0.1")
    master.prepare()
    clients = [TClient(master.addr, node_id=i) for i in range(2)]
    seen = [[], []]
    try:
        data = [tdl.ShardedDataset(c, "ds", _RangeDataset(40),
                                   batch_size=4, wait_poll_s=0.01)
                for c in clients]
        data[0].register(shard_size=4, num_epochs=1)

        def pull(i):
            seen[i].extend(_tolist(data[i]))

        threads = [threading.Thread(target=pull, args=(i,), daemon=True)
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        rows = sorted(r[0] for worker in seen for b in worker for r in b)
        assert rows == list(range(40))
    finally:
        for c in clients:
            c.close()
        master.stop()


def test_tuner_file_reaches_the_loader(tmp_path):
    """The master merges a tuned batch size (as its auto-scaler's sink
    does), the port's ParalConfigTuner writes the file, and the loader's
    next batch has the new size; a merge keeps the other tuned fields."""
    master = TMaster(port=0, host="127.0.0.1", job_args=make_job_args(1))
    master.prepare()
    client = TClient(master.addr, node_id=0)
    path = tmp_path / "paral.json"
    try:
        assert wait_until(
            lambda: len(master.job_manager.get_running_workers()) == 1)
        tuner = ParalConfigTuner(client, str(path))
        loader = tdl.ElasticDataLoader(_RangeDataset(40), batch_size=4,
                                       config_file=str(path))
        it = iter(loader)
        assert len(next(it)) == 4
        master.servicer.merge_paral_config(dataloader_workers=2)
        merged = master.servicer.merge_paral_config(dataloader_batch_size=6)
        assert (merged.version, merged.dataloader_workers,
                merged.dataloader_batch_size) == (2, 2, 6)
        assert tuner.poll_once()
        assert not tuner.poll_once()          # same version: no rewrite
        assert json.loads(path.read_text())["dataloader_batch_size"] == 6
        assert len(next(it)) == 6
        assert loader.batch_size == 6
    finally:
        client.close()
        master.stop()


def test_tuner_file_reaches_the_sharded_feed(tmp_path):
    """The same chain into ShardedDataset: the master-dispatched feed's
    next batch, mid-shard, has the tuned size; without the file it keeps
    its own (the JAX feed's behaviour, checked above)."""
    master = TMaster(port=0, host="127.0.0.1", job_args=make_job_args(1))
    master.prepare()
    client = TClient(master.addr, node_id=0)
    path = tmp_path / "paral.json"
    try:
        assert wait_until(
            lambda: len(master.job_manager.get_running_workers()) == 1)
        feed = tdl.ShardedDataset(client, "ds", _RangeDataset(40),
                                  batch_size=4, wait_poll_s=0.01,
                                  config_file=str(path))
        feed.register(shard_size=20, num_epochs=1)
        it = iter(feed)
        assert len(next(it)) == 4
        master.servicer.merge_paral_config(dataloader_batch_size=6)
        assert ParalConfigTuner(client, str(path)).poll_once()
        sizes = [len(b) for b in it]
        assert sizes == [6, 6, 4, 6, 6, 6, 2]
        assert feed.batch_size == 6
        assert client.get_task_counts("ds") == (0, 0)
    finally:
        client.close()
        master.stop()
