"""The port's crash-consistent master state against the JAX package's.

Every case of ``tests/test_state_backend.py`` runs over both packages
(``pkg``): versioned snapshots, checksum fallback, retention, the
per-component export/restore round trips and the snapshot coalescing.
The cross cases write a snapshot and a mutation log with one package and
read them back with the other, in both directions, and require the
bytes of both packages' files to agree.
"""

import importlib
import json
import os
import time
import types

import pytest

PACKAGES = ("dlrover_tpu", "dlrover_tpu_torch")


def _load(root: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    rdzv = mod("master.rendezvous")
    backend = mod("master.state_backend")
    return types.SimpleNamespace(
        root=root,
        MasterStateBackend=backend.MasterStateBackend,
        MutationLog=backend.MutationLog,
        SnapshotCorruptionError=backend.SnapshotCorruptionError,
        KVStoreService=mod("master.kv_store").KVStoreService,
        ElasticTrainingRendezvousManager=(
            rdzv.ElasticTrainingRendezvousManager),
        NetworkCheckRendezvousManager=rdzv.NetworkCheckRendezvousManager,
        RendezvousParameters=rdzv.RendezvousParameters,
        TaskManager=mod("master.shard.task_manager").TaskManager,
        BatchDatasetManager=(
            mod("master.shard.dataset_manager").BatchDatasetManager),
        TableDatasetSplitter=(
            mod("master.shard.dataset_splitter").TableDatasetSplitter),
        DatasetShardParams=mod("common.messages").DatasetShardParams,
        SpeedMonitor=mod("master.speed_monitor").SpeedMonitor,
        PlanCalibration=mod("parallel.calibration").PlanCalibration,
        planner=mod("parallel.planner"),
        Context=mod("common.config").Context,
        JobMaster=mod("master.job_master").JobMaster,
    )


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _load(request.param)


@pytest.fixture
def both():
    return _load("dlrover_tpu"), _load("dlrover_tpu_torch")


# ---------------------------------------------------------------------------
# MasterStateBackend
# ---------------------------------------------------------------------------


def test_save_load_roundtrip(pkg, tmp_path):
    backend = pkg.MasterStateBackend(str(tmp_path))
    backend.save({"a": 1, "nested": {"b": [1, 2, 3]}})
    state, version = backend.load_latest()
    assert state == {"a": 1, "nested": {"b": [1, 2, 3]}}
    assert version == 1


def test_versions_monotonic_across_reopen(pkg, tmp_path):
    backend = pkg.MasterStateBackend(str(tmp_path))
    backend.save({"v": 1})
    backend.save({"v": 2})
    reopened = pkg.MasterStateBackend(str(tmp_path))
    reopened.save({"v": 3})
    assert reopened.versions() == [1, 2, 3]
    state, version = reopened.load_latest()
    assert state == {"v": 3} and version == 3


def test_save_if_changed_skips_identical_state(pkg, tmp_path):
    backend = pkg.MasterStateBackend(str(tmp_path))
    assert backend.save_if_changed({"x": 1}) is not None
    assert backend.save_if_changed({"x": 1}) is None
    assert backend.save_if_changed({"x": 2}) is not None
    assert backend.versions() == [1, 2]


def test_retention_prunes_oldest(pkg, tmp_path):
    backend = pkg.MasterStateBackend(str(tmp_path), retain=3)
    for i in range(7):
        backend.save({"v": i})
    assert backend.versions() == [5, 6, 7]


def test_corrupt_latest_falls_back_to_older(pkg, tmp_path):
    backend = pkg.MasterStateBackend(str(tmp_path))
    backend.save({"v": "good"})
    path = backend.save({"v": "torn"})
    with open(path, "w") as f:          # torn write: truncated JSON
        f.write('{"version": 2, "chec')
    state, version = backend.load_latest()
    assert state == {"v": "good"} and version == 1


def test_checksum_mismatch_detected(pkg, tmp_path):
    backend = pkg.MasterStateBackend(str(tmp_path))
    path = backend.save({"v": 1})
    with open(path) as f:               # bit rot: valid JSON, tampered
        wrapper = json.load(f)
    wrapper["state"]["v"] = 2
    with open(path, "w") as f:
        json.dump(wrapper, f)
    with pytest.raises(pkg.SnapshotCorruptionError, match="checksum"):
        backend.load_version(1)
    assert backend.load_latest() is None


def test_no_tmp_litter_after_save(pkg, tmp_path):
    backend = pkg.MasterStateBackend(str(tmp_path))
    backend.save({"v": 1})
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_fenced_backend_writes_nothing(pkg, tmp_path):
    backend = pkg.MasterStateBackend(str(tmp_path))
    backend.gate = lambda: True
    assert backend.save({"v": 1}) is None
    assert backend.save_if_changed({"v": 2}) is None
    assert backend.versions() == []


# ---------------------------------------------------------------------------
# component round trips
# ---------------------------------------------------------------------------


def test_rendezvous_state(pkg):
    params = pkg.RendezvousParameters(min_nodes=2, max_nodes=2)
    mgr = pkg.ElasticTrainingRendezvousManager(params)
    mgr.join_rendezvous(0, 4, node_ip="10.0.0.1")
    mgr.join_rendezvous(1, 4, node_ip="10.0.0.2")
    mgr.get_comm_world(0)                   # cuts round 0
    exported = json.loads(json.dumps(mgr.export_state()))

    restored = pkg.ElasticTrainingRendezvousManager(
        pkg.RendezvousParameters(min_nodes=2, max_nodes=2))
    restored.restore_state(exported)
    assert restored.rdzv_round == 1
    assert restored.latest_world == {0: 4, 1: 4}
    rnd, _, world = restored.get_comm_world(0)
    assert rnd == 0 and world == {0: 4, 1: 4}
    assert restored.num_nodes_waiting() == 0


def test_network_check_state_keeps_reports(pkg):
    params = pkg.RendezvousParameters(min_nodes=2, max_nodes=2)
    mgr = pkg.NetworkCheckRendezvousManager(params)
    mgr.join_rendezvous(0, 4)
    mgr.join_rendezvous(1, 4)
    mgr.get_comm_world(0)
    mgr.report_network_status(0, True, 1.0)
    mgr.report_network_status(1, False, 9.0)
    exported = json.loads(json.dumps(mgr.export_state()))

    restored = pkg.NetworkCheckRendezvousManager(
        pkg.RendezvousParameters(min_nodes=2, max_nodes=2))
    restored.restore_state(exported)
    fault, rounds = restored.check_fault_node()
    assert fault == [1] and rounds == 1


def test_kv_store_state_is_bytes_safe(pkg):
    store = pkg.KVStoreService()
    store.set("coord", b"10.0.0.1:8476")
    store.set("blob", bytes(range(256)))
    exported = json.loads(json.dumps(store.export_state()))
    restored = pkg.KVStoreService()
    restored.restore_state(exported)
    assert restored.get("coord") == b"10.0.0.1:8476"
    assert restored.get("blob") == bytes(range(256))


def _shard_params(pkg, size=40):
    return pkg.DatasetShardParams(
        dataset_name="ds", dataset_size=size, shard_size=10,
        num_epochs=1, task_type="training", storage_type="table")


def test_task_manager_state_keeps_doing_tasks(pkg):
    tm = pkg.TaskManager()
    tm.new_dataset(_shard_params(pkg))
    t0 = tm.get_dataset_task(0, "ds")
    t1 = tm.get_dataset_task(1, "ds")
    tm.report_dataset_task("ds", t0.task_id, True)
    exported = json.loads(json.dumps(tm.export_state()))

    restored = pkg.TaskManager()
    restored.restore_state(exported)
    assert restored.counts("ds") == (2, 1)   # 1 done, 1 doing, 2 todo
    seen = set()
    while True:
        task = restored.get_dataset_task(2, "ds")
        if task.is_empty or task.task_type in ("wait", "none"):
            break
        assert task.shard.start != t1.shard.start   # no double dispatch
        seen.add(task.shard.start)
    assert len(seen) == 2
    assert restored.report_dataset_task("ds", t1.task_id, True)
    assert restored.counts("ds") == (0, 2)


def test_final_sub_epoch_flip_counts_as_mutation(pkg):
    """The last sub-epoch flip mutates the splitter yet answers NONE:
    the mutation counter must still move, or the flip never reaches a
    snapshot."""
    splitter = pkg.TableDatasetSplitter("huge", dataset_size=20,
                                        shard_size=10, num_epochs=1,
                                        max_shard_count=1)
    mgr = pkg.BatchDatasetManager("training", splitter)
    for _ in range(2):
        task = mgr.get_task(0)
        assert not task.is_empty
        mgr.report_task_status(task.task_id, True)
    before = mgr.mutation_count
    final = mgr.get_task(0)
    assert final.is_empty
    assert mgr.mutation_count > before
    assert splitter.epoch_finished()


def test_snapshot_coalescing_flushes_trailing_mutation(pkg, tmp_path):
    """With min_interval > 0 a mutation inside the window is deferred,
    not dropped: the trailing timer persists it within one interval."""
    pkg.Context.reset()
    pkg.Context.singleton().update(
        master_state_dir=str(tmp_path / "state"),
        master_snapshot_min_interval_s=0.3, coord_port=-1)
    try:
        master = pkg.JobMaster(port=0, min_nodes=1, max_nodes=1)
        master.kv_store.set("a", b"1")
        master._maybe_snapshot()               # first write
        master.kv_store.set("b", b"2")
        master._maybe_snapshot()               # inside window: deferred
        backend = master._state_backend
        state, _ = backend.load_latest()
        assert "b" not in state["kv_store"]
        deadline = time.time() + 2.0
        while time.time() < deadline:
            state, _ = backend.load_latest()
            if "b" in state["kv_store"]:
                break
            time.sleep(0.05)
        assert "b" in state["kv_store"], "trailing flush never fired"
        master._server.stop(0)
    finally:
        pkg.Context.reset()


def test_task_manager_restore_keeps_registration_idempotent(pkg):
    tm = pkg.TaskManager()
    tm.new_dataset(_shard_params(pkg, size=20))
    tm.get_dataset_task(0, "ds")
    restored = pkg.TaskManager()
    restored.restore_state(json.loads(json.dumps(tm.export_state())))
    restored.new_dataset(_shard_params(pkg, size=20))
    assert restored.counts("ds") == (1, 1)


def test_speed_monitor_state_keeps_the_step_mark(pkg):
    mon = pkg.SpeedMonitor()
    mon.set_tokens_per_step(4096, seq_len=128)
    mon.set_model_flops(6e9, 1e15, peak_flops_per_chip=1e15)
    mon.collect_worker_step(0, 11, step_time_s=0.3)
    exported = json.loads(json.dumps(mon.export_state()))
    restored = pkg.SpeedMonitor()
    restored.restore_state(exported)
    assert restored.completed_global_step == 11
    assert restored.export_state() == exported


# ---------------------------------------------------------------------------
# cross-package: one lineage, either reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", [0, 1], ids=["jax-writes",
                                                 "port-writes"])
def test_snapshot_written_by_one_package_loads_in_the_other(
        both, writer, tmp_path):
    """A snapshot of a component set written by either package loads,
    checksum and all, in the other, and both packages write the same
    bytes for the same state."""
    write, read = both[writer], both[1 - writer]
    state = {"generation": 3, "kv_store": {"k": "dmFsdWU="},
             "nested": {"b": [1, 2.5, "x"], "none": None}}
    path = write.MasterStateBackend(str(tmp_path / "a")).save(state)
    loaded, version = read.MasterStateBackend(
        str(tmp_path / "a")).load_latest()
    assert (loaded, version) == (state, 1)
    other = read.MasterStateBackend(str(tmp_path / "b")).save(state)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


def _calibration(pkg):
    """A calibration with two stamped shapes and their samples, under a
    clock that starts at the same instant in either package."""
    ticks = iter(range(100))
    cal = pkg.PlanCalibration(clock=lambda: 1.7e9 + next(ticks),
                              min_samples=2)
    profile = pkg.planner.ModelProfile(
        param_count=110_000, param_bytes=440_000, flops_per_token=6.6e5,
        peak_flops_per_chip=1e12, seq_len=32, global_batch=12)
    for gen, world in enumerate((4, 3)):
        plan = pkg.planner.plan_parallelism(
            {r: 1 for r in range(world)}, profile, generation=gen)
        cal.observe_plan(plan)
        for k in range(3):
            cal.observe_step(0.2 + 0.01 * k + gen, mfu=0.4,
                             plan_generation=gen)
    return cal


@pytest.mark.parametrize("writer", [0, 1], ids=["jax-writes",
                                                 "port-writes"])
def test_snapshot_with_plan_calibration_is_byte_compatible(both, writer,
                                                           tmp_path):
    """A snapshot holding ``plan_calibration`` written by either package
    loads in the other, whose calibration restores it and exports it
    back unchanged; both packages write the same bytes for it."""
    write, read = both[writer], both[1 - writer]
    state = {"generation": 2,
             "plan_calibration": _calibration(write).export_state()}
    path = write.MasterStateBackend(str(tmp_path / "a")).save(state)
    loaded, _ = read.MasterStateBackend(str(tmp_path / "a")).load_latest()
    assert loaded == json.loads(json.dumps(state))
    restored = read.PlanCalibration()
    restored.restore_state(loaded["plan_calibration"])
    assert restored.export_state() == loaded["plan_calibration"]
    assert restored.table() == _calibration(write).table()
    other = read.MasterStateBackend(str(tmp_path / "b")).save(
        {"generation": 2,
         "plan_calibration": restored.export_state()})
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("writer", [0, 1], ids=["jax-writes",
                                                 "port-writes"])
def test_mutation_log_written_by_one_package_reads_in_the_other(
        both, writer, tmp_path):
    """A kv store with the log attached, driven through sets, adds and
    deletes of hot and cold keys: the reader package replays the
    writer's log over the writer's snapshot to the writer's store, and
    the two packages' logs hold the same lines."""
    dirs = [tmp_path / "jax", tmp_path / "port"]
    stores = []
    for which, pkg in enumerate(both):
        log = pkg.MutationLog(str(dirs[which]))
        store = pkg.KVStoreService()
        store.set("coord/elastic-training/0", b"10.0.0.1:1")
        exported = store.export_state()
        store.attach_mutation_log(log)
        store.set("cold", b"c")                      # not logged
        store.set("coord/elastic-training/1", b"10.0.0.1:2")
        store.add("coord/elastic-training/1/n", 2)
        store.add("coord/elastic-training/1/n", 3)
        store.set("dcn/g0/grad", b"x" * 8)           # never logged
        store.delete("coord/elastic-training/0")
        assert log.flush()
        log.close()
        stores.append((store, exported))
    with open(dirs[0] / "kv-mutlog.jsonl") as f, \
            open(dirs[1] / "kv-mutlog.jsonl") as g:
        assert f.read() == g.read()
    store, exported = stores[writer]
    read = both[1 - writer]
    entries = read.MutationLog.read(str(dirs[writer]))
    assert [k for k, _ in entries] == [
        "coord/elastic-training/1", "coord/elastic-training/1/n",
        "coord/elastic-training/1/n", "coord/elastic-training/0"]
    replayed = read.KVStoreService()
    replayed.restore_state(exported)
    assert replayed.replay_mutations(entries) == 4
    hot = {k: v for k, v in store.export_state().items()
           if k.startswith("coord/")}
    assert {k: v for k, v in replayed.export_state().items()
            if k.startswith("coord/")} == hot
    assert replayed.get("coord/elastic-training/1/n") == b"5"


@pytest.mark.parametrize("which", [0, 1], ids=["jax", "port"])
def test_mutation_log_rotation_keeps_post_fence_entries(both, which,
                                                        tmp_path):
    pkg = both[which]
    log = pkg.MutationLog(str(tmp_path))
    log.append("coord/a", b"1")
    log.append("coord/b", b"2")
    fence = log.current_seq()
    log.append("coord/c", b"3")
    assert log.flush()
    log.rotate(up_to_seq=fence)
    log.append("coord/d", b"4")
    assert log.flush()
    log.close()
    assert [k for k, _ in pkg.MutationLog.read(str(tmp_path))] == [
        "coord/c", "coord/d"]
