"""The port's logical-axis rules (dlrover_tpu_torch.parallel.sharding)
against the JAX package's, and the kernel boundary under DTensor.

The placements of every tiny-Llama parameter on a (data 2, fsdp 2,
tensor 2) mesh must name the same mesh axes for the same tensor dims as
JAX's ``mesh_shardings`` specs: the two models keep one layout, so a
logical name labels the same dim in both. The gloo cases run two ranks
(``test_torch_mesh.run_workers``).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel import mesh as jmesh
from dlrover_tpu.parallel import sharding as jsharding
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.parallel import mesh as tmesh
from dlrover_tpu_torch.parallel import sharding as tsharding
from test_torch_mesh import run_workers


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {".".join(k.key for k in path): leaf for path, leaf in flat}


def _jax_abstract():
    model = jllama.Llama(jllama.LlamaConfig.tiny(attn_impl="reference"))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((2, 16), jnp.int32))["params"]


def _spec_of(placements, axis_names, ndim):
    """Placements → a PartitionSpec-like tuple, one entry per dim: None,
    one mesh axis, or a tuple of them (major first)."""
    spec = []
    for dim in range(ndim):
        axes = tuple(a for a, p in zip(axis_names, placements)
                     if isinstance(p, Shard) and p.dim == dim)
        spec.append(None if not axes else axes[0] if len(axes) == 1
                    else axes)
    return tuple(spec)


def test_logical_axes_are_the_flax_boxes():
    want = {name: tuple(spec) for name, spec in
            _flat(nn.get_partition_spec(_jax_abstract())).items()}
    model = tllama.Llama(tllama.LlamaConfig.tiny(), device="meta")
    got = tsharding.logical_axes(model)
    assert got == want
    assert set(got) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("rules", [
    None,
    jsharding.make_sharding_rules(fsdp=False),
    jsharding.make_sharding_rules(tensor=False),
    jsharding.make_sharding_rules(extra=[("norm", "tensor")]),
])
def test_placements_match_jax_mesh_shardings(cpu_devices, rules):
    spec = dict(data=2, fsdp=2, tensor=2)
    jax_mesh = jmesh.create_mesh(jmesh.MeshSpec(**spec), cpu_devices)
    abstract = _jax_abstract()
    want = {name: s.spec for name, s in _flat(jax.tree.map(
        lambda s: s, jsharding.mesh_shardings(abstract, jax_mesh, rules),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))).items()}
    mesh = tmesh.Mesh(tmesh.MeshSpec(**spec).with_total_devices(8),
                      torch.device("cpu"))
    model = tllama.Llama(tllama.LlamaConfig.tiny(), device="meta")
    shapes = dict(model.named_parameters())
    got = tsharding.mesh_placements(model, mesh, rules)
    assert set(got) == set(want)
    for name, placements in got.items():
        ndim = shapes[name].ndim
        jspec = tuple(want[name]) + (None,) * (ndim - len(want[name]))
        assert _spec_of(placements, mesh.axis_names, ndim) == jspec, name


@pytest.mark.parametrize("axes,rules", [
    (("b", "a"), [("a", "tensor"), ("b", "tensor"), ("b", "fsdp")]),
    (("act_batch", "act_seq", "act_embed"), jsharding.DEFAULT_RULES),
    (("embed", "mlp"), [("mlp", "fsdp"), ("embed", "fsdp")]),
    (("x", "embed"), jsharding.DEFAULT_RULES),
])
def test_rule_priority_matches_flax(axes, rules):
    names = tmesh.MeshSpec().axis_sizes()
    names = [n for n, _ in names]
    want = nn.logical_to_mesh_axes(axes, rules)
    got = _spec_of(tsharding.logical_to_placements(axes, names, rules),
                   names, len(axes))
    assert got == tuple(want) + (None,) * (len(axes) - len(want))


def test_sanitize_replicates_a_leaf_of_lower_rank():
    placements = {"moment": [Replicate(), Shard(1)], "ok": [Shard(0),
                                                            Replicate()]}
    out = tsharding.sanitize_shardings(placements, {"moment": (8,),
                                                    "ok": (8,)})
    assert out == {"moment": [Replicate(), Replicate()],
                   "ok": [Shard(0), Replicate()]}


WORKER = """
import json
import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.ops.flash_attention import flash_attention
from dlrover_tpu_torch.ops.norms import fused_rms_norm
from dlrover_tpu_torch.parallel import mesh, sharding

init_distributed("cpu")
m = mesh.create_mesh(mesh.MeshSpec(tensor=2), "cpu")
tp = m.submesh(["tensor"])
out = {}

# sharded_from_host: each rank copies only its shard; reshard moves them
full = np.arange(48, dtype=np.float32).reshape(6, 8)
zeros = torch.zeros(6, 8)
targets = {k: distribute_tensor(zeros, tp, [p], src_data_rank=None)
           for k, p in (("rows", Shard(0)), ("cols", Shard(1)),
                        ("all", Replicate()))}
targets["plain"] = zeros
placed = sharding.sharded_from_host({k: full for k in targets}, targets)
out["local_ok"] = all(
    np.array_equal(placed[k].to_local().numpy(),
                   full[sharding.local_slice(full.shape, tp,
                                             placed[k].placements)])
    for k in ("rows", "cols", "all"))
out["plain_ok"] = np.array_equal(placed["plain"].numpy(), full)
moved = sharding.reshard(placed, {"rows": [Shard(1)], "cols": [Replicate()],
                                  "all": [Shard(0)], "plain": None})
out["reshard_ok"] = all(np.array_equal(moved[k].full_tensor().numpy(), full)
                        for k in ("rows", "cols", "all"))
out["placements"] = [str(moved[k].placements) for k in ("rows", "cols",
                                                        "all")]

# the flash kernel boundary: heads sharded, GQA groups local
g = torch.Generator().manual_seed(0)
q = torch.randn(2, 4, 24, 16, generator=g, requires_grad=True)
k, v = (torch.randn(2, 2, 24, 16, generator=g, requires_grad=True)
        for _ in range(2))
want = flash_attention(q, k, v)
want.square().sum().backward()
dq, dk, dv = (t.grad for t in (q, k, v))
qd, kd, vd = (distribute_tensor(t.detach(), tp, [Shard(1)],
                                src_data_rank=None).requires_grad_()
              for t in (q, k, v))
got = flash_attention(qd, kd, vd)
out["flash_placements"] = str(got.placements)
out["flash_err"] = (got.full_tensor() - want).abs().max().item()
got.square().sum().backward()
out["flash_grad_err"] = max((a.grad.full_tensor() - b).abs().max().item()
                            for a, b in ((qd, dq), (kd, dk), (vd, dv)))
try:
    flash_attention(*(distribute_tensor(t.detach(), tp, [Shard(2)],
                                        src_data_rank=None)
                      for t in (q, k, v)))
    out["flash_seq_sharded"] = "accepted"
except ValueError:
    out["flash_seq_sharded"] = "raised"

# the norm: a replicated weight, x replicated or a pending sum
x = torch.randn(2, 5, 32, generator=g)
w = torch.rand(32, generator=g) + 0.5
want = fused_rms_norm(x, w, 1e-5)
wd = distribute_tensor(w, tp, [Replicate()], src_data_rank=None)
xd = distribute_tensor(x, tp, [Replicate()], src_data_rank=None)
out["norm_err"] = (fused_rms_norm(xd, wd, 1e-5).full_tensor()
                   - want).abs().max().item()
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import Partial
half = DTensor.from_local(x * 0.5, tp, [Partial()], run_check=False)
got = fused_rms_norm(half, wd, 1e-5)
out["norm_partial_placements"] = str(got.placements)
out["norm_partial_err"] = (got.full_tensor() - want).abs().max().item()
try:
    fused_rms_norm(distribute_tensor(x, tp, [Shard(2)], src_data_rank=None),
                   wd, 1e-5)
    out["norm_dim_sharded"] = "accepted"
except ValueError:
    out["norm_dim_sharded"] = "raised"
print(json.dumps(out))
"""


def test_host_placement_reshard_and_kernel_boundary_on_gloo(tmp_path):
    """sharded_from_host copies each rank's shard, reshard moves them;
    the flash and norm wrappers take DTensors through local_map (heads
    sharded, GQA groups local; a pending sum reduced before the norm) and
    give the unsharded result and gradients; a placement the kernels
    cannot take raises."""
    for r in run_workers(tmp_path, WORKER, 2):
        assert r["local_ok"] and r["plain_ok"] and r["reshard_ok"]
        assert r["placements"] == ["(Shard(dim=1),)", "(Replicate(),)",
                                   "(Shard(dim=0),)"]
        assert r["flash_placements"] == "(Shard(dim=1),)"
        assert r["flash_err"] <= 1e-6 and r["flash_grad_err"] <= 1e-5
        assert r["norm_err"] <= 1e-6 and r["norm_partial_err"] <= 1e-6
        assert r["norm_partial_placements"] == "(Replicate(),)"
        assert r["flash_seq_sharded"] == r["norm_dim_sharded"] == "raised"
