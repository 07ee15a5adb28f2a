"""The MoE family under a tensor axis (dlrover_tpu_torch/parallel/moe.py,
models/llama_moe.py, trainer/train_step.py) against the JAX package's
single-device trainer, on gloo CPU ranks.

The JAX layer gives ``wi`` the axes ``("expert", "embed", "mlp")`` and
``wo`` ``("expert", "mlp", "embed")``, so a tensor axis shards each
expert's columns and XLA sums the products; the port lays the same
leaves out as DTensors (over the 2-D ``(expert, tensor)`` sub-mesh under
both axes) and sums them in the expert layer. The tiny Mixtral (4
experts, top-2, train routing) starts from the JAX model's f32 init
carried across and trains three Adafactor steps of 2 micro-batches
(``min_dim_size_to_factor`` 32, so the 3-D expert leaves keep factored
row and column statistics, whose means run over the sharded ``mlp``
dim) at tensor 2 on 2 ranks, and at expert 2 × tensor 2, fsdp 2 ×
tensor 2 and data 2 × tensor 2 on 4; each rank's losses and grad norms must track the JAX
trainer's on one device at rtol/atol 1e-4 (the routing is the same: the
router runs on the replicated input in f32). The 2-rank launch also
lowers auto_accelerate's ``tensor_parallel`` on the MoE model and trains
it, and the tensor-2 and expert 2 × tensor 2 runs save checkpoints that
this process restores at tensor 1: the same bits. One gloo launch of 2 ranks and one of 4 run
every case while JAX computes its oracle.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu_torch import convert
from test_torch_mesh import run_workers
from test_torch_moe import LR, _batches, _jax_training

TOL = dict(rtol=1e-4, atol=1e-4)
# every expert leaf factored (the tiny model's are (4, 64, 128))
MIN_DIM = 32
# experts, hidden, expert intermediate of mixtral_tiny
E, H, M = 4, 64, 128

WORKER = r'''
import json, os, sys

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.checkpoint.flash_checkpoint import FlashCheckpointer
from dlrover_tpu_torch.models.llama import cross_entropy_loss
from dlrover_tpu_torch.models.llama_moe import LlamaMoE, LlamaMoEConfig
from dlrover_tpu_torch.optim import LeafOptimizer, adafactor
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.trainer.train_step import build_trainer

torch.set_num_threads(1)
init_distributed("cpu")
data_dir, cases = sys.argv[1], json.loads(sys.argv[2])
rank = torch.distributed.get_rank()
world = torch.distributed.get_world_size()
batches = np.load(os.path.join(data_dir, "batches.npy"))
init = torch.load(os.path.join(data_dir, "init.pt"))
cfg = LlamaMoEConfig.mixtral_tiny(attn_impl="flash", dtype=torch.float32)


def factory(device=None, seed=0):
    """The model in train routing holding JAX's init."""
    model = LlamaMoE(cfg, device=device, seed=seed, deterministic=False)
    if torch.device(device).type != "meta":
        model.load_state_dict(init)
    return model


def optimizer(params):
    return LeafOptimizer(params, adafactor(1e-2, min_dim_size_to_factor=32))


def trainer_of(case):
    if case.get("auto"):
        from dlrover_tpu_torch.auto.accelerate import auto_accelerate

        return auto_accelerate(
            factory, optim_factory=lambda: optimizer,
            loss_fn=cross_entropy_loss, sample_batch=np.zeros((4, 16)),
            strategy=[("tensor_parallel", {"size": world})],
            micro_batch=4, global_batch=8, devices=["cpu"] * world).trainer
    return build_trainer(factory, optimizer,
                         create_mesh(MeshSpec(**case["spec"]), "cpu"),
                         np.zeros((4, 16)), cross_entropy_loss,
                         accum_steps=2, micro_batch=4)


def full(t):
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy()


def full_state(state):
    """Every parameter and Adafactor statistic, whole."""
    out = {}
    for name, p in state.model.named_parameters():
        out[name] = full(p)
        for key, value in state.optimizer.state[p].items():
            if torch.is_tensor(value) and value.ndim:
                out[f"{name}/{key}"] = full(value)
    return out


out = {}
for case in cases:
    trainer = trainer_of(case)
    state = trainer.init(0)
    history = []
    for tokens, targets in batches:
        state, m = trainer.step(state, *trainer.shard_batch(tokens, targets))
        history.append([m["loss"].item(), m["grad_norm"].item()])
    experts = state.model.layer_0.moe.ExpertMLP_0
    result = {"history": history, "mesh": trainer.mesh.shape,
              "wi": [list(experts.wi.to_local().shape),
                     str(experts.wi.placements)],
              "wo": [list(experts.wo.to_local().shape),
                     str(experts.wo.placements)],
              "router": str(state.model.layer_0.moe.router.placements)}
    if case.get("ckpt"):
        # saved here for this process to restore at tensor 1
        with FlashCheckpointer(os.path.join(data_dir, "ckpt-" + case["id"]),
                               save_interval_steps=1) as ck:
            ck.maybe_save(len(batches), state, {}, force=True)
            ck.wait()
        # (every rank gathers: full_tensor is a collective)
        whole = full_state(state)
        if rank == 0:
            np.savez(os.path.join(data_dir, f"saved-{case['id']}.npz"),
                     **whole)
    out[case["id"]] = result
print(json.dumps(out))
'''


def _case(spec, **kw):
    name = "-".join(f"{k}{v}" for k, v in spec.items()) or "auto"
    tags = "".join(f"-{k}" for k in sorted(kw))
    return dict(id=f"{name}{tags}", spec=spec, **kw)


CASES = {
    2: [_case({"tensor": 2}, ckpt=True), _case({}, auto=True)],
    4: [_case({"expert": 2, "tensor": 2}, ckpt=True),
        _case({"fsdp": 2, "tensor": 2}),
        _case({"data": 2, "tensor": 2})],
}
ORACLE_CASES = [(w, c) for w, cases in CASES.items() for c in cases]


def _restore_trainer(init):
    """The tiny Mixtral at tensor 1 in this process."""
    from dlrover_tpu_torch.models.llama import cross_entropy_loss
    from dlrover_tpu_torch.models.llama_moe import LlamaMoE, LlamaMoEConfig
    from dlrover_tpu_torch.optim import LeafOptimizer, adafactor
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    cfg = LlamaMoEConfig.mixtral_tiny(attn_impl="flash", dtype=torch.float32)

    def factory(device=None, seed=0):
        model = LlamaMoE(cfg, device=device, seed=seed, deterministic=False)
        if torch.device(device).type != "meta":
            model.load_state_dict(init)
        return model

    return build_trainer(
        factory, lambda p: LeafOptimizer(
            p, adafactor(LR, min_dim_size_to_factor=MIN_DIM)),
        None, np.zeros((4, 16)), cross_entropy_loss, accum_steps=2,
        micro_batch=4, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX oracle's three steps, each launch's per-rank results and
    this process's restore of the tensor-2 checkpoint."""
    from dlrover_tpu_torch.checkpoint.flash_checkpoint import (
        FlashCheckpointer,
    )

    data_dir = tmp_path_factory.mktemp("moe_tp_data")
    batches = np.stack([np.stack(b) for b in _batches()])
    np.save(data_dir / "batches.npy", batches)

    def launch(world):
        return run_workers(tmp_path_factory.mktemp(f"moe_tp{world}"),
                           WORKER, world,
                           args=(str(data_dir), json.dumps(CASES[world])),
                           timeout=240, name=f"moe_tp{world}")

    # the JAX init first (the ranks start from it), then its steps
    # while the ranks train
    jinit = jax.tree.map(np.asarray, _jax_training(
        optax.adafactor(LR, min_dim_size_to_factor=MIN_DIM), steps=0)[0])
    init = convert.params_from_jax(jinit)
    torch.save(init, data_dir / "init.pt")
    with ThreadPoolExecutor(1) as pool:
        launches = {world: pool.submit(launch, world) for world in CASES}
        _, history, _ = _jax_training(
            optax.adafactor(LR, min_dim_size_to_factor=MIN_DIM))
        results = {world: future.result()
                   for world, future in launches.items()}
    restored = {}
    for case in (c for cases in CASES.values() for c in cases
                 if c.get("ckpt")):
        with FlashCheckpointer(str(data_dir / f"ckpt-{case['id']}")) as ck:
            state, _, step = ck.restore(
                _restore_trainer(init).abstract_state())
        got = {}
        for name, p in state.model.named_parameters():
            got[name] = p.detach().numpy()
            for key, value in state.optimizer.state[p].items():
                if torch.is_tensor(value) and value.ndim:
                    got[f"{name}/{key}"] = value.numpy()
        restored[case["id"]] = (step, got, dict(
            np.load(data_dir / f"saved-{case['id']}.npz")))
    return history, results, restored


@pytest.mark.parametrize("world,case", ORACLE_CASES,
                         ids=[f"{w}-{c['id']}" for w, c in ORACLE_CASES])
def test_moe_tensor_parallel_training_tracks_the_jax_oracle(runs, world,
                                                            case):
    """Each rank's three steps' losses and grad norms within 1e-4 of the
    JAX trainer's on one device, the same on every rank, at tensor 2
    (auto_accelerate's ``tensor_parallel`` lowers to it)."""
    history, results, _ = runs
    want = np.asarray(history)
    ranks = [r[case["id"]] for r in results[world]]
    for rank in ranks:
        assert rank["mesh"]["tensor"] == 2
        got = np.asarray(rank["history"])
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got, np.asarray(ranks[0]["history"]))


@pytest.mark.parametrize("world,case", ORACLE_CASES,
                         ids=[f"{w}-{c['id']}" for w, c in ORACLE_CASES])
def test_expert_kernels_hold_their_experts_columns(runs, world, case):
    """``wi`` holds (E/ep, H, M/t) and ``wo`` (E/ep, M/t, H) on each rank:
    over the 2-D (expert, tensor) sub-mesh under both axes, over the
    tensor mesh otherwise (FSDP2, over fsdp or data, composes its own
    mesh dims with it); the router stays replicated over tensor."""
    _, results, _ = runs
    ep = case["spec"].get("expert", 1)
    fsdp = case["spec"].get("fsdp", 1)
    for rank in results[world]:
        got = rank[case["id"]]
        assert got["wi"][0] == [E // ep, H // fsdp, M // 2]
        assert got["wo"][0] == [E // ep, M // 2, H // fsdp]
        if ep > 1:
            assert got["wi"][1] == "(Shard(dim=0), Shard(dim=2))"
            assert got["wo"][1] == "(Shard(dim=0), Shard(dim=1))"
            assert got["router"] == "(Shard(dim=1), Replicate())"
        else:
            # over the tensor mesh, or FSDP2's mesh with it
            assert "Shard(dim=2)" in got["wi"][1]
            assert "Shard(dim=1)" in got["wo"][1]
            assert "Shard(dim=1)" not in got["router"]


@pytest.mark.parametrize("saved", ["tensor2-ckpt", "expert2-tensor2-ckpt"])
def test_checkpoint_saved_at_tensor_2_restores_at_tensor_1(runs, saved):
    """The tiny Mixtral saved after three steps at tensor 2, and at expert
    2 × tensor 2 (its expert leaves on the 2-D sub-mesh): this process
    restores each at tensor 1, every parameter and Adafactor statistic
    the same bits as the ranks held."""
    _, _, restored = runs
    step, got, want = restored[saved]
    assert step == 3
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
