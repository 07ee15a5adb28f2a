"""The port's quantized gradient mean
(dlrover_tpu_torch.parallel.quant_collectives) against the JAX package's
``quantized_pmean_leaf`` on the 8-device virtual CPU mesh, from the same
per-member numpy inputs, and the trainer's ``grad_reduce_bits``.

The collective runs on gloo CPU ranks, one member a rank, where JAX runs
it inside a ``shard_map`` manual over a data axis of the same size. In
gather and scatter mode, at 8 and 4 bits, every member's result must be
bit for bit the reference's arithmetic: JAX's own codes and scales
(``_quantize`` jitted), each member's dequantized version ``q·scale``
rounded to f32 (what the dequantize kernel writes), summed in member
order and divided by n. JAX's jitted collective itself contracts each
product into the sum (an FMA, one rounding), so it differs from that by
at most n f32 ulps of the largest term (ROADMAP Queue C16); both are
within JAX's bound of the exact mean (tests/test_quant_allreduce.py:
35-63). ``bits=0``, a leaf under ``MIN_QUANT_SIZE`` and an integer leaf
take the exact mean: the sum and a true division, JAX's bit for bit at 2
members; at 4 the sum's order is the backend's in both packages (gloo's
ring, XLA's), so within one f32 ulp of the sum.

The trainer: Llama tiny (f32, plain attention) trained 6 steps with
``grad_reduce_bits=8`` over data 2 (2 ranks) and data 2 × fsdp 2 (4
ranks) tracks the exact reduce's losses within JAX's 5% band
(tests/test_quant_allreduce.py:183) and descends; 4 bits at data 2
descends too. One gloo launch of 2 ranks and one of 4 run every case.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from dlrover_tpu.common.jax_compat import shard_map
from dlrover_tpu.parallel import quant_collectives as jqc
from dlrover_tpu.parallel.quant_collectives import quantized_pmean_leaf
from dlrover_tpu_torch.parallel import quant_collectives as tqc
from test_torch_mesh import run_workers

SHAPE = (63, 65)          # 4095 elements a member: the pad path
MODES = [("gather", 8), ("gather", 4), ("scatter", 8), ("scatter", 4),
         ("auto", 0)]
EXACT = ("small", "int")


def _member_inputs(n):
    rng = np.random.default_rng(0)
    return {
        "grad": rng.normal(size=(n,) + SHAPE).astype(np.float32),
        # 8 elements a member: under MIN_QUANT_SIZE
        "small": rng.normal(size=(n, 8)).astype(np.float32),
        "int": np.arange(n * 8, dtype=np.int32).reshape(n, 8),
    }


def _jax_mean(x, n, bits, mode):
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("data",))
    fn = shard_map(
        functools.partial(quantized_pmean_leaf, axis_name="data", n=n,
                          bits=bits, mode=mode),
        mesh=mesh, in_specs=P("data"), out_specs=P("data"),
        axis_names=frozenset({"data"}), check_vma=False)
    out = np.asarray(jax.jit(fn)(jnp.asarray(
        x.reshape((n * x.shape[1],) + x.shape[2:]))))
    return out.reshape(x.shape)


def _member_order_reference(x, n, bits, mode, group=256):
    """Every member's result as the reference's steps with the f32
    rounding of each: JAX's codes and scales (``_quantize`` jitted, as in
    the collective), ``q·scale`` rounded, summed in member order, divided
    by n; in scatter mode each member's chunk quantized again."""
    qmax = 127 if bits == 8 else 7
    quantize = jax.jit(functools.partial(jqc._quantize, qmax=qmax))
    size = x[0].size
    quantum = group * (n if mode == "scatter" else 1)
    flats = [np.pad(m.reshape(-1), (0, (-size) % quantum)) for m in x]

    def wire(q):
        # the int4 wire's pack and unpack, exact
        return np.asarray(jqc._wire_decode(jqc._wire_encode(q, bits),
                                           bits)).astype(np.float32)

    def mean(parts):
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total / np.float32(n)

    if mode == "gather":
        codes = [quantize(f.reshape(-1, group)) for f in flats]
        out = mean([wire(q) * np.asarray(s) for q, s in codes])
    else:
        codes = [quantize(f.reshape(n, -1, group)) for f in flats]
        chunks = [quantize(mean([wire(q[me]) * np.asarray(s[me])
                                 for q, s in codes])) for me in range(n)]
        out = np.concatenate([wire(q) * np.asarray(s) for q, s in chunks])
    return out.reshape(-1)[:size].reshape(x.shape[1:])


WORKER = r'''
import functools, json, os, sys

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel import quant_collectives as qc
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.trainer.train_step import build_trainer

init_distributed("cpu")
data_dir, modes, exact, trainings = (sys.argv[1], json.loads(sys.argv[2]),
                                     json.loads(sys.argv[3]),
                                     json.loads(sys.argv[4]))
rank, n = dist.get_rank(), dist.get_world_size()
inputs = np.load(os.path.join(data_dir, f"inputs{n}.npz"))
group = dist.group.WORLD
for mode, bits in modes:
    got = qc.quantized_pmean_leaf(torch.from_numpy(inputs["grad"][rank]),
                                  group, n, bits=bits, mode=mode)
    np.save(os.path.join(data_dir, f"n{n}-{mode}{bits}-{rank}.npy"),
            got.numpy())
for name in exact:
    got = qc.quantized_pmean({"leaf": torch.from_numpy(inputs[name][rank])},
                             group, n, bits=8)["leaf"]
    np.save(os.path.join(data_dir, f"n{n}-{name}-{rank}.npy"), got.numpy())

LR, STEPS = 1e-2, 6
cfg = llama.LlamaConfig(
    vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
    num_heads=4, num_kv_heads=4, max_seq_len=16, attn_impl="reference",
    norm_impl="reference", embed_impl="gather", dtype=torch.float32)
losses = {}
for spec, bits in trainings:
    mesh = create_mesh(MeshSpec(**spec), device="cpu")
    trainer = build_trainer(
        functools.partial(llama.Llama, cfg),
        lambda p: torch.optim.Adam(p, lr=LR), mesh, np.zeros((8, 16)),
        llama.cross_entropy_loss, micro_batch=8, grad_reduce_bits=bits)
    state = trainer.init(0)
    rng = np.random.default_rng(3)
    run = []
    for _ in range(STEPS):
        tokens = rng.integers(0, cfg.vocab_size, (8, 16))
        state, m = trainer.step(state, *trainer.shard_batch(tokens, tokens))
        run.append(m["loss"].item())
    losses[f"{json.dumps(spec, sort_keys=True)}-{bits}"] = run
print(json.dumps(losses))
'''

TRAININGS = {2: [({"data": 2}, 0), ({"data": 2}, 8), ({"data": 2}, 4)],
             4: [({"data": 2, "fsdp": 2}, 0), ({"data": 2, "fsdp": 2}, 8)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("quant_data")
    losses = {}
    for n in (2, 4):
        np.savez(data_dir / f"inputs{n}.npz", **_member_inputs(n))
        ranks = run_workers(
            tmp_path_factory.mktemp(f"quant{n}"), WORKER, n,
            args=(str(data_dir), json.dumps(MODES), json.dumps(EXACT),
                  json.dumps(TRAININGS[n])), timeout=180, name=f"quant{n}")
        losses[n] = ranks
    return data_dir, losses


def _port(data_dir, n, tag):
    return np.stack([np.load(data_dir / f"n{n}-{tag}-{rank}.npy")
                     for rank in range(n)])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode,bits", MODES)
def test_quantized_mean_matches_jax(runs, n, mode, bits):
    data_dir, _ = runs
    x = _member_inputs(n)["grad"]
    want = _jax_mean(x, n, bits, mode)
    got = _port(data_dir, n, f"{mode}{bits}")
    for member in got[1:]:
        np.testing.assert_array_equal(member, got[0])
    if not bits:
        if n == 2:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(
                got, want, rtol=0, atol=np.spacing(np.abs(x).sum(0)).max())
        return
    np.testing.assert_array_equal(
        got[0], _member_order_reference(x, n, bits, mode))
    # JAX's jitted sum rounds each member's product into the sum once
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=n * np.spacing(np.abs(x).max()))
    # JAX's bound: |err| ≤ passes · max|x| / qmax
    qmax = 127 if bits == 8 else 7
    passes = 2 if mode == "scatter" else 1
    for result in (got[0], want[0]):
        assert np.abs(result - x.mean(0)).max() <= (
            passes * np.abs(x).max() / qmax)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", EXACT)
def test_small_and_int_leaves_take_the_exact_mean_as_jax(runs, n, name):
    data_dir, _ = runs
    x = _member_inputs(n)[name]
    want = _jax_mean(x, n, 8, "auto")
    got = _port(data_dir, n, name)
    # an integer leaf's mean comes back float in both packages
    assert got.dtype == want.dtype == np.float32
    if name == "int" or n == 2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=np.spacing(np.abs(x).sum(0)).max())


@pytest.mark.parametrize("n,spec,bits", [
    (2, {"data": 2}, 8), (2, {"data": 2}, 4),
    (4, {"data": 2, "fsdp": 2}, 8)])
def test_trainer_with_quantized_reduce_tracks_exact(runs, n, spec, bits):
    _, losses = runs
    key = json.dumps(spec, sort_keys=True)
    for rank in losses[n]:
        exact, quant = rank[f"{key}-0"], rank[f"{key}-{bits}"]
        assert quant[-1] < quant[0], "quantized run failed to descend"
        if bits == 8:
            for e, q in zip(exact, quant):
                assert abs(e - q) / max(abs(e), 1e-6) < 0.05, (exact, quant)
        # the metrics are the same on every rank
        assert rank == losses[n][0]


def test_quantized_pmean_rejects_bad_bits():
    with pytest.raises(ValueError, match="bits"):
        tqc.quantized_pmean({"g": torch.zeros(4096)}, None, 2, bits=3)
