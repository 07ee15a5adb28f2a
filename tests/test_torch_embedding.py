"""The port's elastic embedding training against the JAX package's
(``trainer/embedding.py``): the lookup for each combiner, three trainer
steps from a carried JAX state (loss, table, row-sparse Adagrad
accumulator, dense tower and Adam state), untouched rows kept bit for
bit, ``tests/test_ps_failover.py``'s four cases on the port's master and
``LocalCluster``, and one gloo launch at fsdp 2 against fsdp 1 with its
checkpoint restored at fsdp 1.

Tolerances (f32): lookups are gathers, equal bit for bit; three steps
agree within rtol 2e-5 / atol 1e-7 (the two Adams round their bias
corrections differently; Adagrad's rows are elementwise)."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from torch import nn

from dlrover_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dlrover_tpu.parallel.mesh import create_mesh as jcreate_mesh
from dlrover_tpu.trainer import embedding as jemb
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.checkpoint.flash_checkpoint import FlashCheckpointer
from dlrover_tpu_torch.common.constants import (
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.convert import embedding_state_from_jax
from dlrover_tpu_torch.master.job_master import JobMaster
from dlrover_tpu_torch.master.node.event_callback import PsFailoverCallback
from dlrover_tpu_torch.master.sync_service import ElasticPsService
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.scheduler.local import LocalCluster
from dlrover_tpu_torch.trainer import embedding as temb
from test_torch_job_manager import make_job_args, wait_until
from test_torch_mesh import run_workers
from test_torch_embedding_model import (
    BATCH,
    DIM,
    FIELDS,
    VOCAB,
    batches,
    dense_init,
    one_thread,
    port_state,
)

RTOL, ATOL = 2e-5, 1e-7


def _jax_dense_apply(p, emb):
    x = emb.reshape(emb.shape[0], -1)
    h = jax.nn.relu(x @ p["w0"] + p["b0"])
    return (h @ p["w1"] + p["b1"])[:, 0]


def _jax_loss(logits, labels):
    return optax.sigmoid_binary_cross_entropy(logits, labels).mean()


def _jax_trainer(cpu_devices):
    mesh = jcreate_mesh(JMeshSpec(fsdp=4), cpu_devices[:4])
    embedding = jemb.ShardedEmbedding(
        jemb.EmbeddingConfig(vocab_size=VOCAB, embed_dim=DIM))
    return jemb.ElasticEmbeddingTrainer(mesh, embedding, _jax_dense_apply,
                                        _jax_loss)


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the lookup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combiner", ["none", "mean", "sum"])
def test_lookup_matches_jax(combiner):
    cfg = dict(vocab_size=VOCAB, embed_dim=DIM, combiner=combiner)
    ids = np.random.default_rng(1).integers(0, VOCAB, (5, 4),
                                            dtype=np.int32)
    module = jemb.ShardedEmbedding(jemb.EmbeddingConfig(**cfg))
    params = fnn.unbox(module.init(jax.random.PRNGKey(0), ids))
    want = np.asarray(module.apply(params, ids))
    port = temb.ShardedEmbedding(temb.EmbeddingConfig(**cfg), device="cpu")
    with torch.no_grad():
        port.table.copy_(torch.from_numpy(
            np.asarray(params["params"]["table"])))
    got = _np(port(ids))
    assert got.shape == want.shape
    if combiner == "none":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_table_init_and_refusals():
    """normal(0.01) from the caller's generator, on the card unless asked
    for the CPU, and only the JAX package's combiners."""
    cfg = temb.EmbeddingConfig(vocab_size=4096, embed_dim=16)
    a = temb.ShardedEmbedding(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    b = temb.ShardedEmbedding(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.table, b.table)
    assert abs(float(a.table.std()) - 0.01) < 5e-4
    assert a.param_axes == {"table": ("embed_rows", "embed_cols")}
    assert temb.EMBEDDING_RULES == [(k, v) for k, v in jemb.EMBEDDING_RULES]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            temb.ShardedEmbedding(cfg)
    with pytest.raises(ValueError):
        temb.ShardedEmbedding(temb.EmbeddingConfig(4, 2, combiner="max"),
                              device="cpu")


def test_fresh_state_is_the_jax_init():
    """A new trainer's state is what the JAX trainer's init makes: the
    accumulator at 0.1 and Adam's moments zero at count 0 (the restore
    targets of ``train_step`` leave them empty)."""
    trainer, state = port_state(seed=2)
    dense = {k: jnp.asarray(v.astype(np.float32))
             for k, v in dense_init(0).items()}
    want = optax.adam(1e-3).init(dense)[0]
    embed_opt, dense_opt = state.optimizer
    table = state.model.embedding.table
    assert bool((embed_opt.state[table]["accumulator"] == 0.1).all())
    for name, p in state.model.dense.named_parameters():
        got = dense_opt.state[p]
        np.testing.assert_array_equal(_np(got["exp_avg"]),
                                      np.asarray(want.mu[name]))
        np.testing.assert_array_equal(_np(got["exp_avg_sq"]),
                                      np.asarray(want.nu[name]))
        assert float(got["step"]) == int(want.count) == 0


# ---------------------------------------------------------------------------
# three steps from a carried state
# ---------------------------------------------------------------------------


def _jax_run(cpu_devices, warm, steps):
    """JAX state after ``warm`` steps, then the losses and the state
    after ``steps`` more (numpy trees)."""
    trainer = _jax_trainer(cpu_devices)
    dense = jax.tree.map(jnp.asarray,
                         {k: v.astype(np.float32)
                          for k, v in dense_init(0).items()})
    embed_params, embed_opt, dense_opt = trainer.init(
        jax.random.PRNGKey(0), jnp.zeros((4, FIELDS), jnp.int32), dense)
    state = (embed_params, embed_opt, dense, dense_opt)
    step = trainer.build_step()
    for ids, labels in warm:
        *state, _ = step(*state, ids, labels)
    carried = jax.tree.map(np.asarray, tuple(state))
    losses = []
    for ids, labels in steps:
        *state, loss = step(*state, ids, labels)
        losses.append(float(loss))
    return carried, losses, jax.tree.map(np.asarray, tuple(state))


def test_three_steps_from_carried_state_match_jax(cpu_devices):
    data = batches(7, 5)
    carried, want_losses, want = _jax_run(cpu_devices, data[:2], data[2:])
    trainer, state = port_state()
    trainer.load_state(state, *embedding_state_from_jax(carried))
    step = trainer.build_step()
    losses = [float(step(state, ids, labels)) for ids, labels in data[2:]]
    assert state.step == 3
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    table = state.model.embedding.table
    np.testing.assert_allclose(_np(table), want[0]["table"], rtol=RTOL,
                               atol=ATOL)
    embed_opt, dense_opt = state.optimizer
    np.testing.assert_allclose(
        _np(embed_opt.state[table]["accumulator"]),
        want[1].accumulator["table"], rtol=RTOL, atol=ATOL)
    adam = want[3][0]
    tower = state.model.dense
    for name in ("w0", "b0", "w1", "b1"):
        p = getattr(tower, name)
        np.testing.assert_allclose(_np(p), want[2][name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(_np(dense_opt.state[p]["exp_avg"]),
                                   adam.mu[name], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(dense_opt.state[p]["exp_avg_sq"]),
                                   adam.nu[name], rtol=RTOL, atol=1e-10)
        assert float(dense_opt.state[p]["step"]) == int(adam.count) == 5


def test_untouched_rows_stay_the_same_bits():
    trainer, state = port_state(seed=4)
    table = state.model.embedding.table
    acc = state.optimizer[0].state[table]
    before, acc_before = table.detach().clone(), acc["accumulator"].clone()
    step = trainer.build_step()
    data = batches(11, 3)
    for ids, labels in data:
        step(state, ids, labels)
    touched = np.unique(np.concatenate([ids.ravel() for ids, _ in data]))
    untouched = np.setdiff1d(np.arange(VOCAB), touched)
    acc = state.optimizer[0].state[table]["accumulator"]
    assert torch.equal(table.detach()[untouched], before[untouched])
    assert torch.equal(acc[untouched], acc_before[untouched])
    assert not torch.equal(table.detach()[touched], before[touched])
    assert bool((acc[touched] > acc_before[touched]).any())


# ---------------------------------------------------------------------------
# tests/test_ps_failover.py's four cases on the port's master
# ---------------------------------------------------------------------------


def _failover_trainer():
    mesh = create_mesh(MeshSpec(), "cpu")
    embedding = temb.ShardedEmbedding(
        temb.EmbeddingConfig(vocab_size=64, embed_dim=8), device="cpu",
        generator=torch.Generator().manual_seed(0))
    dense = nn.Linear(8, 1, bias=False)
    nn.init.zeros_(dense.weight)
    loss_fn = lambda preds, labels: ((preds - labels) ** 2).mean()
    trainer = temb.ElasticEmbeddingTrainer(mesh, embedding, dense, loss_fn)
    return trainer, trainer.init()


def _step_data(rng):
    ids = rng.integers(0, 64, (16,), dtype=np.int32)
    labels = rng.standard_normal((16, 1)).astype(np.float32)
    return ids, labels


def test_ps_failover_restores_consistent_table(tmp_path):
    cluster = LocalCluster()
    master = JobMaster(min_nodes=2, max_nodes=2,
                       job_args=make_job_args(workers=2),
                       cluster=cluster, host="127.0.0.1")
    master.prepare()
    client = MasterClient(master.addr, node_id=0, node_rank=0)
    try:
        assert wait_until(
            lambda: len(master.job_manager.get_running_workers()) == 2)
        trainer, state = _failover_trainer()
        step = trainer.build_step()
        rng = np.random.default_rng(3)
        failover = temb.EmbeddingFailoverClient(client)
        assert failover.start() == 0
        with FlashCheckpointer(str(tmp_path / "ckpt"),
                               save_interval_steps=1) as ckpt:
            # 3 steps, a save after each; remember the committed table
            for i in range(1, 4):
                step(state, *_step_data(rng))
                ckpt.maybe_save(i, state, {"step": i})
            ckpt.wait()
            committed = state.model.embedding.table.detach().clone()
            committed_acc = state.optimizer[0].state[
                state.model.embedding.table]["accumulator"].clone()

            # a state holder dies: PsFailoverCallback bumps the version
            victim = master.job_manager.get_running_workers()[0]
            cluster.fail_pod(victim.name, NodeExitReason.UNKNOWN_ERROR)
            assert wait_until(
                lambda: client.get_cluster_version("global") >= 1)
            assert client.get_cluster_version("global") == 1

            # this worker diverges on a stale view
            for _ in range(2):
                step(state, *_step_data(rng))
            assert not torch.equal(state.model.embedding.table, committed)

            assert failover.needs_reconcile()
            result = trainer.maybe_reconcile(failover, ckpt, state)
            assert result.reconciled
            assert result.step == 3 and state.step == 3
            assert result.data_state == {"step": 3}
            table = result.state.model.embedding.table
            assert torch.equal(table.detach(), committed)
            assert torch.equal(result.state.optimizer[0].state[table][
                "accumulator"], committed_acc)
            assert failover.local_version == client.get_cluster_version(
                "global")
            assert client.get_cluster_version(
                "local", task_id=0) == failover.local_version
            assert failover.wait_reconciled_cluster(task_ids=[0],
                                                    timeout_s=5)
            assert not trainer.maybe_reconcile(failover, ckpt,
                                               state).reconciled
    finally:
        client.close()
        master.stop()


def test_reconcile_commits_the_save_in_flight_first(tmp_path):
    """A reconcile that lands while the checkpointer's own save is still
    being written waits for its commit and restores that step: the
    restore must not take the save's ``<step>.tmp`` for a torn one."""
    trainer, state = _failover_trainer()
    step = trainer.build_step()
    rng = np.random.default_rng(5)
    with FlashCheckpointer(str(tmp_path / "ckpt"),
                           save_interval_steps=3) as ckpt:
        commit = ckpt._commit

        def slow_commit(*args):
            time.sleep(0.5)
            return commit(*args)

        ckpt._commit = slow_commit
        for i in range(1, 4):
            step(state, *_step_data(rng))
            ckpt.maybe_save(i, state, {"step": i})
        saved = state.model.embedding.table.detach().clone()
        assert ckpt._pending is not None              # still in flight
        step(state, *_step_data(rng))
        _, data, restored = ckpt.restore(state)
    assert restored == 3 and data == {"step": 3}
    assert torch.equal(state.model.embedding.table.detach(), saved)


def test_reconcile_falls_back_when_the_save_in_flight_fails(tmp_path):
    """A save in flight whose commit fails (a full disk) does not make the
    restore fail: it restores the newest committed step, drops the failed
    save's ``<step>.tmp``, and a later restore works too."""
    trainer, state = _failover_trainer()
    step = trainer.build_step()
    rng = np.random.default_rng(6)
    directory = tmp_path / "ckpt"
    with FlashCheckpointer(str(directory), save_interval_steps=3) as ckpt:
        for i in range(1, 4):
            step(state, *_step_data(rng))
            ckpt.maybe_save(i, state, {"step": i})
        ckpt.wait()
        committed = state.model.embedding.table.detach().clone()

        def failing_commit(future, *args):
            future.result()
            time.sleep(0.2)
            raise OSError(28, "No space left on device")

        ckpt._commit = failing_commit
        for i in range(4, 7):
            step(state, *_step_data(rng))
            ckpt.maybe_save(i, state, {"step": i})
        assert ckpt._pending is not None              # still in flight
        _, data, restored = ckpt.restore(state)
        assert restored == 3 and data == {"step": 3}
        assert torch.equal(state.model.embedding.table.detach(), committed)
        assert ckpt._pending is None
        assert not [n for n in os.listdir(directory) if n.endswith(".tmp")]
        step(state, *_step_data(rng))
        assert ckpt.restore(state)[2] == 3
    assert torch.equal(state.model.embedding.table.detach(), committed)


def test_reconcile_without_checkpoint_stays_stale(tmp_path):
    master = JobMaster(min_nodes=1, max_nodes=1, host="127.0.0.1")
    master.prepare()
    client = MasterClient(master.addr, node_id=0, node_rank=0)
    try:
        trainer, state = _failover_trainer()
        failover = temb.EmbeddingFailoverClient(client)
        failover.start()
        master.elastic_ps_service.inc_global_cluster_version()
        with FlashCheckpointer(str(tmp_path / "empty"),
                               save_interval_steps=1) as ckpt:
            result = trainer.maybe_reconcile(failover, ckpt, state)
        assert not result.reconciled
        assert failover.needs_reconcile()          # still stale
        assert client.get_cluster_version("local", task_id=0) == 0
    finally:
        client.close()
        master.stop()


def test_dead_node_version_entry_is_dropped():
    service = ElasticPsService()
    callback = PsFailoverCallback(service)
    service.update_cluster_version("local", 5, "worker", 1)
    node = Node(node_type=NodeType.WORKER, node_id=1)
    node.status = NodeStatus.FAILED
    callback.on_node_failed(node)
    assert service.get_cluster_version("global", "worker", 0) == 1
    assert service.get_cluster_version("local", "worker", 1) == 0
    callback.on_node_deleted(node)                 # FAILED -> DELETED
    assert service.get_cluster_version("global", "worker", 0) == 1
    ok_node = Node(node_type=NodeType.WORKER, node_id=2)
    ok_node.status = NodeStatus.SUCCEEDED
    callback.on_node_deleted(ok_node)              # routine cleanup
    assert service.get_cluster_version("global", "worker", 0) == 1
    running = Node(node_type=NodeType.WORKER, node_id=3)
    running.status = NodeStatus.RUNNING
    callback.on_node_deleted(running)              # unexpected kill
    assert service.get_cluster_version("global", "worker", 0) == 2


def test_failover_client_noop_without_version_bump():
    master = JobMaster(min_nodes=1, max_nodes=1, host="127.0.0.1")
    master.prepare()
    client = MasterClient(master.addr, node_id=0, node_rank=0)
    try:
        failover = temb.EmbeddingFailoverClient(client)
        failover.start()
        assert not failover.needs_reconcile()
    finally:
        client.close()
        master.stop()


# ---------------------------------------------------------------------------
# fsdp 2 on gloo ranks against fsdp 1
# ---------------------------------------------------------------------------

FSDP_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[2])
import torch
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.checkpoint.flash_checkpoint import FlashCheckpointer
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from test_torch_embedding_model import batches, port_state

torch.set_num_threads(1)
init_distributed("cpu")
trainer, state = port_state(create_mesh(MeshSpec(fsdp=2), "cpu"))
table = state.model.embedding.table
step = trainer.build_step()
losses = [float(step(state, ids, labels)) for ids, labels in batches(5, 3)]
with FlashCheckpointer(sys.argv[1], save_interval_steps=1) as ckpt:
    ckpt.maybe_save(3, state, {"step": 3})
    ckpt.wait()
acc = state.optimizer[0].state[table]["accumulator"]
print(json.dumps({
    "losses": losses,
    "placements": str(table.placements),
    "local_rows": table.to_local().shape[0],
    "table": table.full_tensor().tolist(),
    "acc": acc.full_tensor().tolist(),
    "w0": state.model.dense.w0.detach().tolist()}))
"""


def test_fsdp2_on_gloo_ranks_matches_fsdp1(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    results = run_workers(tmp_path, FSDP_WORKER, 2,
                          args=[ckpt_dir, os.path.dirname(__file__)],
                          name="fsdp2")
    # the reference at the ranks' one thread: the CPU GEMM of the tower's
    # input gradient sums in another order at another thread count
    with one_thread():
        trainer, state = port_state()
        step = trainer.build_step()
        losses = [float(step(state, ids, labels))
                  for ids, labels in batches(5, 3)]
    table = state.model.embedding.table
    acc = state.optimizer[0].state[table]["accumulator"]
    for rank, got in enumerate(results):
        assert got["placements"] == "(Shard(dim=0),)"
        assert got["local_rows"] == VOCAB // 2
        np.testing.assert_array_equal(got["losses"], losses)
        np.testing.assert_array_equal(np.asarray(got["table"], np.float32),
                                      _np(table))
        np.testing.assert_array_equal(np.asarray(got["acc"], np.float32),
                                      _np(acc))
        np.testing.assert_array_equal(np.asarray(got["w0"], np.float32),
                                      _np(state.model.dense.w0))
    # the fsdp-2 checkpoint restores at fsdp 1, bit for bit
    _, fresh = port_state(seed=9)
    with FlashCheckpointer(str(ckpt_dir)) as ckpt:
        _, data, restored_step = ckpt.restore(fresh)
    assert restored_step == 3 and data == {"step": 3}
    fresh_table = fresh.model.embedding.table
    assert torch.equal(fresh_table.detach(), table.detach())
    assert torch.equal(fresh.optimizer[0].state[fresh_table]["accumulator"],
                       acc)
    assert torch.equal(fresh.model.dense.w0, state.model.dense.w0)


def test_sharded_lookup_backward_is_the_whole_tables_rows():
    """Why the fsdp-2 ranks and an fsdp-1 run agree bit for bit: a shard's
    masked lookup sends each row the whole table's gradient for it, summed
    in the batch's order (a zero to the rows it does not hold), whatever
    the thread count. What moved the bits was the reference's tower GEMM
    at the test process's threads; the reference now runs at the ranks'
    one (``one_thread``), which restores the caller's count."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((VOCAB, DIM), np.float32))
    ids = torch.from_numpy(rng.integers(0, VOCAB, (BATCH, FIELDS)))
    up = torch.from_numpy(rng.standard_normal((BATCH, FIELDS, DIM),
                                              np.float32))
    whole = table.clone().requires_grad_()
    torch.nn.functional.embedding(ids, whole).backward(up)
    half = VOCAB // 2
    for first in (0, half):
        local = table[first:first + half].clone().requires_grad_()
        hit = (ids >= first) & (ids < first + half)
        out = torch.nn.functional.embedding(
            torch.where(hit, ids - first, 0), local)
        (out * hit.unsqueeze(-1).to(out.dtype)).backward(up)
        np.testing.assert_array_equal(local.grad.numpy(),
                                      whole.grad[first:first + half].numpy())
    before = torch.get_num_threads()
    with one_thread():
        assert torch.get_num_threads() == 1
    assert torch.get_num_threads() == before


# ---------------------------------------------------------------------------
# chip_smoke.py's embedding phase, rehearsed on the CPU at a cut size
# ---------------------------------------------------------------------------


def test_chip_smoke_embedding_phase_on_cpu(monkeypatch):
    """The card phase's whole flow (the job-managed master, the sharded
    feed, the saves, the failure, the reconcile and replay, the tuned
    batch size, the stop) with its gates, at 20,000 rows, batch 64 and a
    narrow tower."""
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    for name, value in dict(EMB_ROWS=20000, EMB_BATCH=64, EMB_SHARD=128,
                            EMB_RECORDS=768, EMB_TUNED_BATCH=32,
                            EMB_TOP_MLP=(64, 32, 1)).items():
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_embedding("cpu", device="cpu")
    assert out["parity"]["ok"] and out["rows"]["untouched_moved"] == 0
    assert out["parity"]["acc_moved_rows"] and out["rows"]["acc_moved"]
    assert out["failure"]["global_version"] == 1
    assert out["reconcile"]["replay_same_bits"]
    assert out["batch_reload"]["after"] == 32
    assert out["stop"]["exporter_closed"]
    assert [v for _, v in out["timeline"]] == [0, 1, 1]
    assert not any(out["launches"].values())
