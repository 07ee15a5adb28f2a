"""The port's peer restore (``dlrover_tpu_torch/checkpoint/peer_restore.py``)
against the JAX package's.

- Staging: the same arrays staged by both packages give the same
  manifest fields, the same file bytes and the same CRCs; pruning, a torn
  manifest and a retained previous step behave alike.
- The wire, both ways: the port's fetch against the JAX donor and the
  JAX fetch against the port's donor, over the same staged bytes (whole
  shards, striped ranges across one donor of each package, a corrupt
  shard and a wrong step come back missing, a local hit never dials).
- The master's plans: ``plan_restore_entries`` and
  ``compute_restore_plan`` equal to JAX's over a scripted sequence of
  registrations, deaths and withdrawals, with equal epochs.
- The loop, with a tiny Llama on the CPU: a peer restore is the bits of
  the checkpoint restore of the same step (the exact state, with an int8
  checkpoint); a newer committed step wins over a stale stage and a
  newer staged cut over storage; missing shards take the mixed path at
  the same step; a step not in storage falls back wholesale; a stale
  epoch is retried once, then falls back; at world 2 under FSDP the
  sharded leaves are not staged and come from the checkpoint.
- The pieces it touches: the flash checkpoint's host buffers are reused
  across saves and a save waits for both readers; the agent's donor
  outlives a worker restart and its report dedups on the manifest.
"""

import functools
import json
import os
import shutil
import sys
import time
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

from dlrover_tpu.checkpoint import peer_restore as J
from dlrover_tpu.common.config import Context as JContext
from dlrover_tpu.master.rendezvous import (
    ElasticTrainingRendezvousManager as JRendezvous,
)
from dlrover_tpu.master.rendezvous import (
    plan_restore_entries as j_plan_restore_entries,
)
from dlrover_tpu_torch.checkpoint import peer_restore as T
from dlrover_tpu_torch.checkpoint.flash_checkpoint import FlashCheckpointer
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.master.rendezvous import (
    ElasticTrainingRendezvousManager,
    plan_restore_entries,
)
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.trainer.elastic_loop import (
    ElasticTrainLoop,
    TrainLoopConfig,
)
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus
from test_torch_mesh import run_workers


@pytest.fixture(autouse=True)
def contexts(monkeypatch):
    """Fresh Context singletons of both packages (peer restore on, an
    ephemeral donor port), no peer cache inherited from the environment,
    and one torch thread (the tests share the host's cores)."""
    monkeypatch.delenv(NodeEnv.PEER_CACHE_DIR, raising=False)
    monkeypatch.delenv(NodeEnv.RESTORE_PLAN_FILE, raising=False)
    JContext.reset()
    Context.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    JContext.reset()
    Context.reset()


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


def _arrays(seed=0):
    """A leaf of each dtype the state can hold, a scalar and an empty one,
    as numpy arrays (bf16 through ml_dtypes, as JAX hands it over)."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((8, 24)).astype(np.float32),
        "h": rng.standard_normal((4, 33)).astype(ml_dtypes.bfloat16),
        "f16": rng.standard_normal(7).astype(np.float16),
        "i": rng.integers(-50, 50, (3, 5)).astype(np.int32),
        "q": rng.integers(-127, 127, 300).astype(np.int8),
        "step": np.asarray(7.0, np.float32),
        "mask": rng.integers(0, 2, 9).astype(bool),
        "none": np.zeros((0, 4), np.float32),
    }


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _port_items(arrays):
    """The JAX store's keys (``jax.tree_util.keystr`` of a dict: sorted
    ``['name']``) with the arrays as torch tensors."""
    return [(f"['{name}']", _tensor(arrays[name])) for name in
            sorted(arrays)]


def _stage_both(tmp_path, step, arrays, data_state=None, defer=False):
    jstore = J.PeerStateStore(str(tmp_path / "jax"))
    tstore = T.PeerStateStore(str(tmp_path / "port"))
    assert jstore.stage(step, dict(arrays), data_state)
    assert tstore.stage(step, _port_items(arrays), data_state,
                        defer_write=defer)
    tstore.flush()
    return jstore, tstore


@pytest.mark.parametrize("defer", [False, True])
def test_stage_matches_jax_manifest_bytes_and_crcs(tmp_path, defer):
    arrays = _arrays()
    jstore, tstore = _stage_both(tmp_path, 5, arrays, {"pos": 3}, defer)
    want = J.load_manifest(jstore.directory)
    got = T.load_manifest(tstore.directory)
    assert abs(got.pop("staged_at") - want.pop("staged_at")) < 60
    assert got == want
    assert want["shards"]["['h']"]["dtype"] == "bfloat16"
    for key, meta in want["shards"].items():
        jbytes = J.read_local_shard(jstore.directory, want, key)
        tbytes = T.read_local_shard(tstore.directory, got, key)
        assert jbytes == tbytes and zlib.crc32(tbytes) == meta["crc32"]
        buf = bytearray(meta["nbytes"])
        assert T.read_local_shard_into(tstore.directory, got, key, buf)
        assert bytes(buf) == jbytes
        # the dtype names map both ways
        assert T.dtype_name(T.torch_dtype(meta["dtype"])) == meta["dtype"]
    assert T.manifest_summary(tstore.directory) == J.manifest_summary(
        jstore.directory)


def test_prune_torn_manifest_and_retained_step_match_jax(tmp_path):
    arrays = _arrays()
    for step in (1, 2, 3, 4):
        jstore, tstore = _stage_both(tmp_path, step, _arrays(step))
    for store in (jstore, tstore):
        assert sorted(n for n in os.listdir(store.directory)
                      if n.startswith("stage-")) == ["stage-3", "stage-4"]
    # the previous step stays readable by its own manifest
    for pkg, store in ((J, jstore), (T, tstore)):
        previous = pkg.load_stage_manifest(store.directory, 3)
        assert previous["step"] == 3
        assert pkg.load_stage_manifest(store.directory, 1) is None
    # a torn manifest reads as absent, in both
    for pkg, store in ((J, jstore), (T, tstore)):
        with open(os.path.join(store.directory, J.MANIFEST), "w") as f:
            f.write('{"step": 5, "shar')
        assert pkg.load_manifest(store.directory) is None
        assert pkg.manifest_summary(store.directory) == (-1, [], 0)
    # a corrupt file reads as missing, never wrong
    manifest = T.load_stage_manifest(tstore.directory, 4)
    key, meta = next(iter(manifest["shards"].items()))
    path = os.path.join(tstore.directory, manifest["dir"], meta["file"])
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    assert T.read_local_shard(tstore.directory, manifest, key) is None
    assert not T.read_local_shard_into(tstore.directory, manifest, key,
                                       bytearray(meta["nbytes"]))
    del arrays


# ---------------------------------------------------------------------------
# the wire, both directions
# ---------------------------------------------------------------------------


@pytest.fixture()
def donors(tmp_path):
    """Steps 4 and 8 staged by the JAX store, served by a donor of each
    package from the same directory."""
    cache = str(tmp_path / "cache")
    store = J.PeerStateStore(cache)
    assert store.stage(4, _arrays(4), {"pos": 4})
    assert store.stage(8, _arrays(8), {"pos": 8})
    jdonor, tdonor = J.PeerDonorServer(cache), T.PeerDonorServer(cache)
    addrs = {"jax": jdonor.start(), "port": tdonor.start()}
    yield cache, addrs
    jdonor.stop()
    tdonor.stop()


def _want(step):
    return {f"['{name}']": arr.tobytes()
            for name, arr in _arrays(step).items()}


def _plan(step, entry):
    return {"epoch": -1, "step": step,
            "entries": {key: dict(entry) for key in _want(step)}}


FETCH = {"port": T.fetch_shards, "jax": J.fetch_shards}
DIRECTIONS = [("port", "jax"), ("jax", "port")]


@pytest.mark.parametrize("fetcher,donor", DIRECTIONS)
def test_fetch_across_packages(donors, fetcher, donor):
    cache, addrs = donors
    fetch, addr = FETCH[fetcher], addrs[donor]
    for step in (8, 4):   # the current stage and the retained one
        want = _want(step)
        wanted = {key: len(v) for key, v in want.items()}
        got, donor_bytes, missing = fetch(
            _plan(step, {"rank": 1, "addr": addr}), wanted)
        assert not missing and {k: bytes(v) for k, v in got.items()} == want
        assert donor_bytes == {addr: sum(wanted.values())}
    fetch_manifest = {"port": T.fetch_manifest,
                      "jax": J.fetch_manifest}[fetcher]
    assert fetch_manifest(addr, step=4)["data_state"] == {"pos": 4}
    assert fetch_manifest(addr)["step"] == 8


@pytest.mark.parametrize("fetcher", ["port", "jax"])
def test_striped_fetch_across_one_donor_of_each_package(donors, fetcher):
    _, addrs = donors
    want = _want(8)
    wanted = {key: len(v) for key, v in want.items()}
    plan = _plan(8, {"ranks": [1, 2],
                     "addrs": [addrs["jax"], addrs["port"]],
                     "tier": "striped"})
    plan["mode"] = "stripe"
    got, donor_bytes, missing = FETCH[fetcher](plan, wanted)
    # (the empty leaf has no range to stripe: it comes whole from the
    # first donor)
    assert not missing
    assert {k: bytes(v) for k, v in got.items()} == want
    assert set(donor_bytes) == set(addrs.values())


@pytest.mark.parametrize("fetcher,donor", DIRECTIONS)
def test_corrupt_shard_and_wrong_step_are_missing(donors, fetcher, donor):
    cache, addrs = donors
    manifest = J.load_manifest(cache)
    key, meta = "['w']", manifest["shards"]["['w']"]
    path = os.path.join(cache, manifest["dir"], meta["file"])
    blob = bytearray(open(path, "rb").read())
    blob[0] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    want = _want(8)
    wanted = {k: len(v) for k, v in want.items()}
    got, _, missing = FETCH[fetcher](
        _plan(8, {"rank": 1, "addr": addrs[donor]}), wanted)
    assert missing == [key] and key not in got
    plan = _plan(8, {"rank": 1, "addr": addrs[donor]})
    plan["step"] = 99
    got, _, missing = FETCH[fetcher](plan, wanted)
    assert not got and sorted(missing) == sorted(wanted)


@pytest.mark.parametrize("fetcher", ["port", "jax"])
def test_local_hit_never_dials(donors, fetcher):
    cache, _ = donors
    want = _want(8)
    got, donor_bytes, missing = FETCH[fetcher](
        _plan(8, {"rank": 1, "addr": "127.0.0.1:1"}),
        {k: len(v) for k, v in want.items()}, local_cache_dir=cache)
    assert not missing and set(donor_bytes) == {"local"}
    assert {k: bytes(v) for k, v in got.items()} == want


# ---------------------------------------------------------------------------
# the master's plans
# ---------------------------------------------------------------------------


def _json(plan):
    return json.loads(json.dumps(plan))


STORES = {
    0: {"addr": "h0:1", "step": 6, "keys": ["a", "b", "c"]},
    1: {"addr": "h1:1", "step": 6, "keys": ["a", "b"]},
    2: {"addr": "h2:1", "step": 6, "keys": ["b", "c", "d"]},
    3: {"addr": "h3:1", "step": 4, "keys": ["a", "b", "c", "d"]},
}


@pytest.mark.parametrize("requester", [0, 3, 9])
@pytest.mark.parametrize("stripe", [False, True])
@pytest.mark.parametrize("slices", [{}, {0: 0, 1: 1, 2: 1, 3: 0, 9: 1}])
def test_plan_restore_entries_matches_jax(requester, stripe, slices):
    got = plan_restore_entries(STORES, requester, slices, stripe=stripe)
    want = j_plan_restore_entries(STORES, requester, slices, stripe=stripe)
    assert got == want
    assert plan_restore_entries({}, 0, {}) == j_plan_restore_entries(
        {}, 0, {})


def test_compute_restore_plan_matches_jax_over_a_script():
    """Register, drain, die, withdraw and re-register: the same plans and
    the same epochs (a draining donor is no donor in either manager)."""
    managers = JRendezvous(), ElasticTrainingRendezvousManager()
    script = [
        ("alive", 0), ("alive", 1), ("alive", 2),
        ("register", 0, "h0:1", 4, ["a", "b"]),
        ("register", 1, "h1:1", 6, ["a", "b"]),
        ("register", 2, "h2:1", 6, ["a", "b"]),
        ("plan", 2), ("plan", 0), ("stripe", 0),
        ("drain", 1), ("plan", 0), ("stripe", 0),
        ("die", 1), ("plan", 0), ("stripe", 0),
        ("register", 1, "h1:1", 6, ["a", "b"]),   # dead: not planned
        ("withdraw", 2), ("plan", 0),
        ("join", 1), ("register", 1, "h1:2", 8, ["a"]), ("plan", 0),
        ("die", 7), ("plan", 1), ("die", 0), ("plan", 1),
    ]
    trace = ([], [])
    for manager, out in zip(managers, trace):
        for op, *args in script:
            if op == "alive":
                manager.add_alive_node(args[0])
            elif op == "register":
                manager.register_peer_store(*args, total_bytes=10)
            elif op == "withdraw":
                manager.register_peer_store(args[0], "", -1, [])
            elif op == "die":
                manager.remove_alive_node(args[0])
            elif op == "join":
                manager.join_rendezvous(args[0], 1)
            elif op == "drain":
                manager.mark_draining(args[0], 4e9)
            else:
                plan = manager.compute_restore_plan(
                    args[0], stripe=op == "stripe")
                out.append(_json(plan))
            out.append(manager.world_epoch)
        out.append(sorted(manager.peer_stores))
    assert trace[1] == trace[0]
    plans = [p for p in trace[1] if isinstance(p, dict)]
    assert plans[0]["step"] == 6 and {
        e["tier"] for e in plans[0]["entries"].values()} == {"local"}
    assert trace[1][-2] == 2 and trace[1][-1] == [1]


# ---------------------------------------------------------------------------
# the loop, with a tiny Llama on the CPU
# ---------------------------------------------------------------------------


CFG = LlamaConfig.tiny(dtype=torch.float32)


def _adamw(params):
    return torch.optim.AdamW(params, lr=1e-3, weight_decay=0.1)


def _loop(ckpt, cache="", interval=0, bits=0, monkeypatch=None):
    if cache:
        monkeypatch.setenv(NodeEnv.PEER_CACHE_DIR, cache)
    else:
        monkeypatch.delenv(NodeEnv.PEER_CACHE_DIR, raising=False)
    return ElasticTrainLoop(
        functools.partial(Llama, CFG), _adamw, cross_entropy_loss,
        TrainLoopConfig(global_batch=4, seq_len=16, max_micro_per_replica=4,
                        max_steps=3, checkpoint_dir=ckpt,
                        save_interval_steps=interval,
                        checkpoint_quantize_bits=bits), device="cpu")


def _run(loop, steps=3):
    """restore_or_init, then ``steps`` steps: (start, sampler position,
    losses, the state's leaves right after the restore)."""
    sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)
    state, start = loop.restore_or_init(0, sampler)
    position = sampler.completed_num
    leaves = {k: v.detach().clone() for k, v in T.shard_items(state)}
    loop.config.max_steps = steps
    data = batches(synthetic_corpus(CFG.vocab_size), sampler, 4, 16)
    state, metrics = loop.run(state, data, start, sampler)
    loop.close()
    return start, position, [r["loss"] for r in metrics["history"]], leaves


def _first_run(tmp_path, monkeypatch, saves=(3,), bits=0, steps=6):
    """A loop with the peer cache: ``steps`` steps, saving at ``saves``;
    returns its losses and its state's leaves at each save."""
    loop = _loop(str(tmp_path / "ckpt"), str(tmp_path / "cache"), 1, bits,
                 monkeypatch)
    sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)
    state, _ = loop.restore_or_init(0, sampler)
    data = batches(synthetic_corpus(CFG.vocab_size), sampler, 4, 16)
    losses, at_save = [], {}
    for step in range(1, steps + 1):
        loop.checkpointer.save_interval_steps = 1 if step in saves else 0
        loop.config.max_steps = 1
        state, metrics = loop.run(state, data, step - 1, sampler)
        losses.append(metrics["history"][0]["loss"])
        if step in saves:
            at_save[step] = {k: v.detach().clone()
                             for k, v in T.shard_items(state)}
    loop.close()
    return losses, at_save


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("bits", [0, 8])
def test_peer_restore_is_the_checkpoint_restore_of_the_step(
        tmp_path, monkeypatch, bits):
    """Exact checkpoint: the peer restore is the checkpoint restore's
    bits. int8 checkpoint: the peer restore is the exact state the save
    copied (the checkpoint restore only within the codec's error)."""
    losses, at_save = _first_run(tmp_path, monkeypatch, bits=bits)
    ckpt, cache = str(tmp_path / "ckpt"), str(tmp_path / "cache")
    peer = _loop(ckpt, cache, monkeypatch=monkeypatch)
    start, position, peer_losses, peer_leaves = _run(peer)
    assert (peer.last_restore_source, start, position) == ("peer", 3, 12)
    timings = peer.last_restore_timings
    assert timings["peer_bytes"] > 0 and {
        "peer_plan_s", "peer_transfer_s", "peer_assemble_s",
        "peer_bandwidth_mbps"} <= set(timings)
    assert _same(peer_leaves, at_save[3]) and peer_losses == losses[3:]
    disk = _loop(ckpt, monkeypatch=monkeypatch)
    start, position, disk_losses, disk_leaves = _run(disk)
    assert (disk.last_restore_source, start, position) == (
        "checkpoint", 3, 12)
    if bits:
        assert not _same(disk_leaves, at_save[3])
        np.testing.assert_allclose(disk_losses, losses[3:], rtol=1e-3)
    else:
        assert _same(disk_leaves, peer_leaves) and disk_losses == losses[3:]


def test_newer_committed_step_wins_over_a_stale_stage(tmp_path,
                                                      monkeypatch):
    losses, _ = _first_run(tmp_path, monkeypatch, saves=(3,), steps=3)
    ckpt = str(tmp_path / "ckpt")
    # a run without the cache commits step 6: the stage stays at 3
    disk = _loop(ckpt, interval=6, monkeypatch=monkeypatch)
    _run(disk)
    loop = _loop(ckpt, str(tmp_path / "cache"), monkeypatch=monkeypatch)
    start, _, _, _ = _run(loop)
    assert (loop.last_restore_source, start) == ("checkpoint", 6)


def test_a_staged_cut_newer_than_storage_is_restored(tmp_path,
                                                     monkeypatch):
    """The reference's rule: only a NEWER committed step beats the stage
    (step 6 staged, its commit gone: the stage wins)."""
    losses, _ = _first_run(tmp_path, monkeypatch, saves=(3, 6), steps=7)
    shutil.rmtree(tmp_path / "ckpt" / "6")
    loop = _loop(str(tmp_path / "ckpt"), str(tmp_path / "cache"),
                 monkeypatch=monkeypatch)
    start, position, resumed, _ = _run(loop, steps=1)
    assert (loop.last_restore_source, start, position) == ("peer", 6, 24)
    assert resumed == losses[6:]


def _break_one_shard(cache, step, how="removed"):
    """Remove the largest staged shard of ``step``, or flip its last
    byte (the CRC fails after every chunk was read and copied)."""
    manifest = T.load_stage_manifest(cache, step)
    key = max(manifest["shards"],
              key=lambda k: manifest["shards"][k]["nbytes"])
    path = os.path.join(cache, manifest["dir"],
                        manifest["shards"][key]["file"])
    if how == "removed":
        os.remove(path)
    else:
        blob = bytearray(open(path, "rb").read())
        blob[-1] ^= 0xFF
        open(path, "wb").write(bytes(blob))
    return key


@pytest.mark.parametrize("how", ["removed", "corrupt"])
def test_missing_shards_take_the_mixed_path_at_the_same_step(
        tmp_path, monkeypatch, how):
    losses, at_save = _first_run(tmp_path, monkeypatch)
    cache = str(tmp_path / "cache")
    _break_one_shard(cache, 3, how)
    loop = _loop(str(tmp_path / "ckpt"), cache, monkeypatch=monkeypatch)
    start, position, resumed, leaves = _run(loop)
    assert (loop.last_restore_source, start, position) == ("mixed", 3, 12)
    assert _same(leaves, at_save[3]) and resumed == losses[3:]


def test_a_step_not_in_storage_falls_back_wholesale(tmp_path, monkeypatch):
    losses, _ = _first_run(tmp_path, monkeypatch, saves=(3, 6), steps=6)
    cache = str(tmp_path / "cache")
    shutil.rmtree(tmp_path / "ckpt" / "6")
    _break_one_shard(cache, 6)
    loop = _loop(str(tmp_path / "ckpt"), cache, monkeypatch=monkeypatch)
    start, position, resumed, _ = _run(loop)
    assert (loop.last_restore_source, start, position) == (
        "checkpoint", 3, 12)
    assert resumed == losses[3:]


class _EpochClient:
    """A master client's restore calls: a local plan stamped with the
    epochs of ``plan_epochs``, and ``current`` as the master's epoch."""

    def __init__(self, cache, plan_epochs, current):
        self._cache = cache
        self._plan_epochs = list(plan_epochs)
        self._current = current
        self.plans = 0

    def get_restore_plan(self):
        step, keys, _ = T.manifest_summary(self._cache)
        epoch = self._plan_epochs[min(self.plans,
                                      len(self._plan_epochs) - 1)]
        self.plans += 1
        return {"epoch": epoch, "step": step,
                "entries": {k: {"rank": 0, "addr": "", "tier": "local"}
                            for k in keys}}

    def get_restore_epoch(self):
        return self._current


@pytest.mark.parametrize("plan_epochs,source", [
    ([0, 1], "peer"),        # stale once, fresh on the retry
    ([0, 0], None),          # stale twice: the checkpoint path
])
def test_a_stale_epoch_is_retried_once(tmp_path, monkeypatch, plan_epochs,
                                       source):
    _first_run(tmp_path, monkeypatch, steps=3)
    cache = str(tmp_path / "cache")
    loop = _loop(str(tmp_path / "ckpt"), cache, monkeypatch=monkeypatch)
    client = _EpochClient(cache, plan_epochs, current=1)
    restorer = T.PeerRestorer(client=client, cache=T.PeerStateStore(cache))
    result = restorer.restore(loop.trainer.abstract_state(),
                              loop.checkpointer, {})
    assert client.plans == 2
    assert (result[3] if result else None) == source
    loop.close()


MIXED_WORKER = """
import json, os, sys
import torch
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.checkpoint.peer_restore import load_manifest
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.parallel.mesh import MeshSpec
from dlrover_tpu_torch.trainer.elastic_loop import ElasticTrainLoop, TrainLoopConfig
from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler
from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus

torch.set_num_threads(1)
init_distributed("cpu")
ckpt, save = sys.argv[1], int(sys.argv[2])
rank = int(os.environ["DLROVER_TPU_PROCESS_ID"])
cache = os.path.join(os.path.dirname(ckpt), f"cache-{rank}")
os.environ["DLROVER_TPU_PEER_CACHE_DIR"] = cache
cfg = LlamaConfig.tiny(dtype=torch.float32)
loop = ElasticTrainLoop(
    lambda device, seed: Llama(cfg, device=device, seed=seed),
    lambda p: torch.optim.AdamW(p, lr=1e-3), cross_entropy_loss,
    TrainLoopConfig(global_batch=4, seq_len=16, max_micro_per_replica=2,
                    max_steps=3, checkpoint_dir=ckpt,
                    save_interval_steps=save,
                    mesh_spec=MeshSpec(fsdp=2)), device="cpu")
sampler = ElasticDistributedSampler(10 ** 6, seed=0)
state, start = loop.restore_or_init(0, sampler)
data = batches(synthetic_corpus(cfg.vocab_size), sampler, 4, 16)
state, metrics = loop.run(state, data, start, sampler)
loop.checkpointer.save_interval_steps = 0
loop.config.max_steps = 3
state, more = loop.run(state, data, metrics["step"], sampler)
loop.close()
# the first run's steps 4-6 are the second run's first three
manifest = load_manifest(cache) or {}
print(json.dumps({"start": start, "source": loop.last_restore_source,
                  "losses": [r["loss"] for r in metrics["history"]
                             + more["history"]],
                  "staged": len(manifest.get("shards", {})),
                  "skipped": len(manifest.get("skipped", []))}))
"""


def test_fsdp_sharded_leaves_come_from_the_checkpoint(tmp_path):
    """World 2 under FSDP: each rank stages only the leaves it holds
    whole (AdamW's step counts; every parameter and moment is sharded),
    so the relaunched world reads the sharded ones from the checkpoint of
    the same step (source "mixed") and trains the same bits as the
    uninterrupted run."""
    ckpt = tmp_path / "ckpt"
    first = run_workers(tmp_path, MIXED_WORKER, 2, args=(ckpt, 3),
                        name="first")
    second = run_workers(tmp_path, MIXED_WORKER, 2, args=(ckpt, 0),
                         name="second")
    for a, b in zip(first, second):
        assert a["source"] == "init" and a["skipped"] and a["staged"]
        assert (b["start"], b["source"]) == (3, "mixed")
        assert b["losses"][:3] == a["losses"][3:]


# ---------------------------------------------------------------------------
# the pieces it touches
# ---------------------------------------------------------------------------


class _SlowReader:
    """A peer store whose deferred write takes ``delay_s``: the save must
    wait for it, after the commit, before it overwrites the buffers."""

    def __init__(self, checkpointer, delay_s):
        self.checkpointer = checkpointer
        self.delay_s = delay_s
        self.snapshot = None
        self.flushes = []

    def flush(self):
        ckpt = self.checkpointer
        if self.snapshot is not None:
            time.sleep(self.delay_s)
            buffers = ckpt.host._buffers
            self.flushes.append((
                ckpt._pending is None,
                all(torch.equal(buffers[k], v)
                    for k, v in self.snapshot.items())))


def test_host_buffers_are_reused_and_a_save_waits_for_both_readers(
        tmp_path):
    from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    trainer = build_trainer(functools.partial(Llama, CFG), _adamw,
                            create_mesh(MeshSpec(), "cpu"),
                            np.zeros((4, 16), np.int64), cross_entropy_loss,
                            micro_batch=4)
    state = trainer.init(0)
    ckpt = FlashCheckpointer(str(tmp_path / "ckpt"), 1)
    reader = _SlowReader(ckpt, delay_s=0.3)
    ckpt.peer_store = reader
    data = batches(synthetic_corpus(CFG.vocab_size),
                   ElasticDistributedSampler(10 ** 6, seed=0), 4, 16)
    pointers = []
    for step in (1, 2, 3):
        tokens, targets = next(data)
        state, _ = trainer.step(state, *trainer.shard_batch(tokens, targets))
        assert ckpt.maybe_save(step, state)
        buffers = ckpt.host._buffers
        pointers.append({k: v.data_ptr() for k, v in buffers.items()})
        # the buffers hold this step's state
        live = dict(T.shard_items(state))
        assert all(torch.equal(buffers[k], live[k]) for k in live)
        reader.snapshot = {k: v.clone() for k, v in buffers.items()}
        assert dict(ckpt.exact_host_items()).keys() == live.keys()
    ckpt.close()
    assert pointers[0] == pointers[1] == pointers[2]
    # each later save waited for the commit, then for the peer reader,
    # and found the buffers unchanged while the reader ran
    assert reader.flushes == [(True, True), (True, True)]
    assert ckpt.last_save["wait_s"] >= 0.3
    assert {"get_state_dict_s", "barrier_s", "host_alloc_s", "host_copy_s",
            "dispatch_s", "blocking_s", "commit_s"} <= set(ckpt.last_save)


def test_agent_donor_outlives_a_worker_restart_and_reports_dedup(
        tmp_path, monkeypatch):
    from dlrover_tpu_torch.agent.elastic_agent import (
        ElasticAgent,
        WorkerSpec,
    )
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.constants import RendezvousName
    from dlrover_tpu_torch.master.job_master import JobMaster

    master = JobMaster(port=0, host="127.0.0.1")
    master.prepare()
    client = MasterClient(master.addr, node_id=0, timeout_s=10.0)
    reports = []
    report = client.report_peer_store
    monkeypatch.setattr(client, "report_peer_store",
                        lambda *a, **k: reports.append(a[1]) or report(
                            *a, **k))
    agent = ElasticAgent(client, WorkerSpec(
        [sys.executable, "-c", "pass"], monitor_interval_s=0.1))
    rdzv = master.rdzv_managers[RendezvousName.TRAINING]
    try:
        agent._start_peer_donor()
        addr = agent._peer_donor.addr
        store = T.PeerStateStore(agent.peer_cache_dir)
        assert store.stage(3, _port_items(_arrays(3)), {"pos": 3})
        agent._report_peer_store()
        agent._report_peer_store()            # unchanged: no RPC
        assert reports == [3]
        assert rdzv.peer_stores[0]["step"] == 3
        agent._spawn()                        # forced report, then join
        assert reports == [3, 3]
        with open(agent.restore_plan_file) as f:
            plan = json.load(f)
        assert plan["step"] == 3 and {e["tier"] for e in
                                      plan["entries"].values()} == {"local"}
        assert store.stage(4, _port_items(_arrays(4)), {"pos": 4})
        agent._report_peer_store()
        assert reports == [3, 3, 4]
        agent._restart_worker(count_against_budget=True)
        agent._proc.wait(timeout=30)
        # the same donor, still serving the staged step
        assert agent._peer_donor.addr == addr
        assert T.fetch_manifest(addr)["data_state"] == {"pos": 4}
        env = agent._bootstrap_env(1, {0: 1})
        assert env[NodeEnv.PEER_CACHE_DIR] == agent.peer_cache_dir
        assert env[NodeEnv.RESTORE_PLAN_FILE] == agent.restore_plan_file
    finally:
        agent.shutdown()
        agent._stop_peer_donor()
        client.close()
        master.stop()
        shutil.rmtree(agent._workdir, ignore_errors=True)
