"""The port's sequence-parallel attention
(dlrover_tpu_torch.parallel.ring_attention) against the JAX package's
``ring_attention`` and ``ulysses_attention`` on the 8-device virtual CPU
mesh, from the same numpy inputs.

Each path runs on gloo CPU ranks, one shard of the sequence a rank: the
einsum ring, the ring over the flash block functions (``RingFlashFn``,
whose blocks are the kernels' plain versions on the CPU), and Ulysses
over the einsum block and over the flash path. The reference of both
port paths of a kind is JAX's ``block_impl="flash"`` (the Pallas kernels
in interpret mode, as tests/test_ring_attention.py runs them, which hold
JAX's einsum path to 1e-4) on a mesh of the same sequence size, jitted.
Causal and not, MHA and GQA (two kv heads: the sequence size 2 divides
them, 4 does not, so Ulysses repeats them first), forward and the
gradients of sum(out²) with respect to q, k and v, all within the f32
tolerance 2e-5. One gloo launch of 2 ranks and one of 4 run every case.
"""

import functools
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu.parallel.ring_attention import (
    ring_attention,
    ulysses_attention,
)
from dlrover_tpu_torch.parallel import ring_attention as tra
from test_torch_mesh import run_workers

BATCH, SEQ, HEADS, DIM = 2, 16, 4, 8
TOL = dict(atol=2e-5, rtol=2e-5)
IMPLS = ("ring-einsum", "ring-flash", "ulysses-einsum", "ulysses-flash")
# (sequence size, kind, causal, kv heads) of each JAX reference: every
# combination at size 2, the causal GQA ones at 4
REFERENCES = ([(2, kind, causal, kv) for kind in ("ring", "ulysses")
               for causal in (True, False) for kv in (HEADS, 2)]
              + [(4, kind, True, 2) for kind in ("ring", "ulysses")])
CASES = [(size, impl, causal, kv) for size, kind, causal, kv in REFERENCES
         for impl in IMPLS if impl.startswith(kind)]


def _inputs(kv):
    rng = np.random.default_rng(kv)
    q = rng.standard_normal((BATCH, SEQ, HEADS, DIM), dtype=np.float32)
    k = rng.standard_normal((BATCH, SEQ, kv, DIM), dtype=np.float32)
    v = rng.standard_normal((BATCH, SEQ, kv, DIM), dtype=np.float32)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _jax_case(size, kind, causal, kv):
    """JAX's flash-block output and gradients of sum(out²) on a sequence
    mesh."""
    mesh = create_mesh(MeshSpec(sequence=size), jax.devices("cpu")[:size])
    fn = ring_attention if kind == "ring" else ulysses_attention
    attn = functools.partial(fn, mesh=mesh, causal=causal,
                             block_impl="flash")

    def loss(q, k, v):
        out = attn(q, k, v)
        return jnp.sum(out * out), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *map(jnp.asarray, _inputs(kv)))
    return [np.asarray(x) for x in (out, *grads)]


WORKER = r'''
import json, os, sys

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.parallel import ring_attention as ra

init_distributed("cpu")
data_dir, cases = sys.argv[1], json.loads(sys.argv[2])
rank, size = dist.get_rank(), dist.get_world_size()
out = {}
for name, impl, causal, kv in cases:
    inputs = np.load(os.path.join(data_dir, f"kv{kv}.npz"))
    local = inputs["q"].shape[1] // size
    q, k, v = (torch.from_numpy(inputs[x][:, rank * local:
                                          (rank + 1) * local].copy()
                                ).requires_grad_() for x in "qkv")
    kind, block = impl.split("-")
    fn = ra.ring_attention if kind == "ring" else ra.ulysses_attention
    o = fn(q, k, v, dist.group.WORLD, causal=causal, block_impl=block)
    (o * o).sum().backward()
    for part, t in zip(("out", "dq", "dk", "dv"),
                       (o, q.grad, k.grad, v.grad)):
        np.save(os.path.join(data_dir, f"{name}-{part}-{rank}.npy"),
                t.detach().numpy())
print(json.dumps({"rank": rank}))
'''


def _name(size, impl, causal, kv):
    return f"s{size}-{impl}-{'causal' if causal else 'full'}-kv{kv}"


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    """Each launch's per-rank outputs and gradients, as .npy files; JAX's
    references are computed while the launches run."""
    data_dir = tmp_path_factory.mktemp("ring_data")
    for kv in (HEADS, 2):
        q, k, v = _inputs(kv)
        np.savez(data_dir / f"kv{kv}.npz", q=q, k=k, v=v)

    def launch(size):
        cases = [(_name(*c), *c[1:]) for c in CASES if c[0] == size]
        run_workers(tmp_path_factory.mktemp(f"ring{size}"), WORKER, size,
                    args=(str(data_dir), json.dumps(cases)), timeout=180,
                    name=f"ring{size}")

    with ThreadPoolExecutor(1) as pool:
        launches = [pool.submit(launch, size) for size in (2, 4)]
        for reference in REFERENCES:
            _jax_case(*reference)
        for future in launches:
            future.result()
    return data_dir


@pytest.mark.parametrize("size,impl,causal,kv", CASES,
                         ids=[_name(*c) for c in CASES])
def test_shards_and_gradients_match_jax(port_dir, size, impl, causal, kv):
    want = _jax_case(size, impl.split("-")[0], causal, kv)
    name = _name(size, impl, causal, kv)
    for part, expected in zip(("out", "dq", "dk", "dv"), want):
        # the ranks' shards end to end are the whole sequence
        got = np.concatenate([
            np.load(port_dir / f"{name}-{part}-{rank}.npy")
            for rank in range(size)], axis=1)
        np.testing.assert_allclose(got, expected, err_msg=part, **TOL)


def test_block_impl_auto_follows_the_device_and_the_override(monkeypatch):
    cpu = torch.zeros(1)
    monkeypatch.delenv("DLROVER_TPU_SP_BLOCK_IMPL", raising=False)
    assert not tra.use_flash_blocks("auto", cpu)
    assert tra.use_flash_blocks("flash", cpu)
    assert not tra.use_flash_blocks("einsum", cpu)
    monkeypatch.setenv("DLROVER_TPU_SP_BLOCK_IMPL", "flash")
    assert tra.use_flash_blocks("auto", cpu)
    # an explicit choice wins over the override
    assert not tra.use_flash_blocks("einsum", cpu)
    with pytest.raises(ValueError, match="unknown SP block impl"):
        tra.use_flash_blocks("pallas", cpu)


def test_ulysses_refuses_indivisible_heads_as_jax():
    with pytest.raises(ValueError, match="not divisible"):
        tra.check_ulysses_heads(3, 2)
    with pytest.raises(ValueError, match="tensor axis 2"):
        tra.check_ulysses_heads(4, 4, tensor=2)
    mesh = create_mesh(MeshSpec(sequence=4), jax.devices("cpu")[:4])
    q = jnp.zeros((1, 8, 3, 8))
    with pytest.raises(ValueError, match="not divisible"):
        ulysses_attention(q, q, q, mesh)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_expected_launches_count_the_visible_blocks(rank):
    """The flash launches one forward and backward makes: the causal
    ring's blocks 0..rank, every block without the mask, Ulysses one."""
    assert tra.expected_launches(4, rank, True, "ring") == (rank + 1,) * 3
    assert tra.expected_launches(4, rank, False, "ring") == (4,) * 3
    assert tra.expected_launches(4, rank, True, "ulysses") == (1, 1, 1)
