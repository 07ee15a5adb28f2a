"""The port's flash checkpoint (dlrover_tpu_torch.checkpoint) against the
JAX package's.

The codec (``checkpoint/quantized.py``) is held bit for bit against
JAX's ``encode_tree`` / ``decode_tree`` in each mode ("row", "flat",
"raw"), at 8 and 4 bits, on plain tensors and on DTensor leaves whose
shard boundaries do and do not fall on a group boundary. The
checkpointer's cases are the counterparts of ``tests/test_checkpoint.py``:
round trip, reshard from world 4 to world 2, int8 round trip and
reshard, interval gating and the fallback past a corrupt newest step;
the multi-rank ones run gloo ranks (``test_torch_mesh.run_workers``).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.checkpoint import quantized as jq
from dlrover_tpu_torch.checkpoint import quantized as tq
from dlrover_tpu_torch.checkpoint.flash_checkpoint import FlashCheckpointer
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.trainer.train_step import build_trainer
from test_torch_mesh import run_workers

# name → (shape, dtype): "row" leaves (last dim a multiple of 128),
# "flat" ones (ragged, padded), "raw" ones (small, integer, scalar)
LEAVES = {
    "row": ((4, 256), np.float32), "row3d": ((2, 3, 128), np.float32),
    "flat": ((3, 100), np.float32), "flat_pad": ((5, 77), np.float32),
    "raw_small": ((50,), np.float32), "raw_int": ((8,), np.int32),
    "scalar": ((), np.float32),
}


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in LEAVES.items():
        if dtype == np.int32:
            out[name] = rng.integers(-9, 9, shape, dtype=np.int32)
        else:
            # rows of very different sizes, one all-zero group
            x = rng.standard_normal(shape).astype(np.float32)
            x *= np.float32(10.0) ** rng.integers(-3, 2, shape[:1] + (1,) * (
                len(shape) - 1)).astype(np.float32) if shape else 1
            if len(shape) >= 2:
                x.reshape(-1)[:128] = 0
            out[name] = x
    return out


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("bits", [8, 4])
def test_codec_matches_jax_bit_for_bit(bits):
    arrays = _arrays()
    jenc = jq.encode_tree({k: jnp.asarray(v) for k, v in arrays.items()},
                          bits)
    tenc = tq.encode_tree({k: torch.from_numpy(v) for k, v in
                           arrays.items()}, bits)
    modes = {}
    for name, jnode in jenc.items():
        tnode = tenc[name]
        if isinstance(jnode, dict):
            modes[name] = "encoded"
            assert int(tnode["__quant__"]) == int(jnode["__quant__"]) == bits
            for key in ("q", "s"):
                assert tnode[key].dtype == {"q": torch.int8,
                                            "s": torch.float32}[key]
                np.testing.assert_array_equal(tnode[key].numpy(),
                                              _np(jnode[key]))
        else:
            modes[name] = "raw"
            np.testing.assert_array_equal(tnode.numpy(), _np(jnode))
    assert modes == {"row": "encoded", "row3d": "encoded", "flat": "encoded",
                     "flat_pad": "encoded", "raw_small": "raw",
                     "raw_int": "raw", "scalar": "raw"}
    assert tq.encoded_nbytes(tenc) == jq.encoded_nbytes(jenc)

    jtargets = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                for k, v in arrays.items()}
    ttargets = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype)
                for k, v in arrays.items()}
    jabs, tabs = (jq.abstract_encoded(jtargets, bits),
                  tq.abstract_encoded(ttargets, bits))
    for name, jnode in jabs.items():
        if isinstance(jnode, dict):
            for key in ("q", "s"):
                assert tuple(tabs[name][key].shape) == jnode[key].shape
    jdec = jq.decode_tree(jenc, jtargets, bits)
    tdec = tq.decode_tree(tenc, ttargets, bits)
    for name in arrays:
        np.testing.assert_array_equal(tdec[name].numpy(), _np(jdec[name]))
    with pytest.raises(ValueError):
        tq.encode_tree({}, bits=3)


SHARDED_CODEC_WORKER = """
import json, sys
import numpy as np
import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import Shard, distribute_tensor
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.checkpoint import quantized as q
from dlrover_tpu_torch.parallel import mesh

init_distributed("cpu")
arrays, bits, ckpt = np.load(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
tp = mesh.create_mesh(mesh.MeshSpec(tensor=2), "cpu").submesh(["tensor"])
dims = {"aligned": 1, "unaligned": 1, "rows": 0, "flat": 0}
leaves = {k: distribute_tensor(torch.from_numpy(arrays[k]), tp,
                               [Shard(d)], src_data_rank=None)
          for k, d in dims.items()}
enc = q.encode_tree(leaves, bits)
local = {k: hasattr(enc[k]["q"], "placements") for k in leaves}
full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
out = {k: [full(enc[k]["q"]).numpy().tolist(),
           full(enc[k]["s"]).numpy().tolist()] for k in leaves}
# through DCP into the restore target of the same layout, then decoded
dcp.save({"model": enc}, checkpoint_id=ckpt)
target = q.abstract_encoded(leaves, bits)
dcp.load({"model": target}, checkpoint_id=ckpt)
dec = q.decode_tree(target, leaves, bits)
print(json.dumps({"codes": out, "local": local,
                  "decoded": {k: full(v).numpy().tolist()
                              for k, v in dec.items()},
                  "placements": {k: str(v.placements)
                                 for k, v in dec.items()}}))
"""


@pytest.mark.parametrize("bits", [8, 4])
def test_sharded_leaves_encode_as_jax_whole_leaves(tmp_path, bits):
    """A DTensor leaf whose shards end on group boundaries quantizes its
    own shard (Shard(1) of 256 columns over 2 ranks, Shard(0) of rows);
    one whose shards cut a group (384 columns: 192 a rank) or a flat leaf
    is gathered first. Either way the codes and scales are JAX's for the
    whole leaf, and a DCP save, load and decode give JAX's decode in the
    leaf's own placement."""
    rng = np.random.default_rng(3)
    arrays = {"aligned": rng.standard_normal((8, 256)),
              "unaligned": rng.standard_normal((8, 384)),
              "rows": rng.standard_normal((6, 128)),
              "flat": rng.standard_normal((5, 77))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    np.savez(tmp_path / "leaves.npz", **arrays)
    out = run_workers(tmp_path, SHARDED_CODEC_WORKER, 2,
                      args=(tmp_path / "leaves.npz", bits, tmp_path / "ck"))
    jenc = jq.encode_tree({k: jnp.asarray(v) for k, v in arrays.items()},
                          bits)
    jdec = jq.decode_tree(jenc, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                 for k, v in arrays.items()}, bits)
    for r in out:
        assert r["local"] == {"aligned": True, "unaligned": False,
                              "rows": True, "flat": False}
        for name, (codes, scales) in r["codes"].items():
            np.testing.assert_array_equal(np.asarray(codes, np.int8),
                                          _np(jenc[name]["q"]))
            np.testing.assert_array_equal(np.asarray(scales, np.float32),
                                          _np(jenc[name]["s"]))
            np.testing.assert_array_equal(
                np.asarray(r["decoded"][name], np.float32),
                _np(jdec[name]))
        assert r["placements"]["aligned"] == "(Shard(dim=1),)"
        assert r["placements"]["rows"] == "(Shard(dim=0),)"


CKPT_WORKER = """
import json, os, sys
import numpy as np
import torch
from torch.distributed.tensor import DTensor
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.checkpoint import quantized as q
from dlrover_tpu_torch.checkpoint.flash_checkpoint import FlashCheckpointer
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig, cross_entropy_loss
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.trainer.train_step import build_trainer

torch.set_num_threads(1)
init_distributed("cpu")
phase, root = sys.argv[1], sys.argv[2]
rank = torch.distributed.get_rank()
cfg = LlamaConfig.tiny(attn_impl="flash", dtype=torch.float32)
spec = MeshSpec(fsdp=2, tensor=2) if phase == "save" else MeshSpec(fsdp=2)
trainer = build_trainer(
    lambda device, seed: Llama(cfg, device=device, seed=seed),
    lambda p: torch.optim.AdamW(p, lr=1e-3), create_mesh(spec, "cpu"),
    np.zeros((4, 16)), cross_entropy_loss, micro_batch=4)
rng = np.random.default_rng(0)
batch = rng.integers(0, 256, (4, 16))
tok, tgt = trainer.shard_batch(batch, batch)

def full(model):
    return {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach()
            for n, p in model.named_parameters()}

def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, files in os.walk(path) for f in files)

out = {}
if phase == "save":
    state = trainer.init(0)
    for _ in range(3):
        state, _ = trainer.step(state, tok, tgt)
    data = {"sampler": {"epoch": 1, "completed_num": 128}}
    for bits in (0, 8):
        with FlashCheckpointer(f"{root}/c{bits}", save_interval_steps=1,
                               quantize_bits=bits) as ck:
            assert ck.maybe_save(3, state, data)
            ck.wait()
            out[f"latest{bits}"] = ck.latest_step()
    live = full(state.model)
    # round trip on the same mesh
    with FlashCheckpointer(f"{root}/c0") as ck:
        restored, rdata, step = ck.restore(trainer.abstract_state())
    out["roundtrip_same_bits"] = all(
        torch.equal(live[n], p) for n, p in full(restored.model).items())
    out["roundtrip_data"], out["roundtrip_step"] = rdata, step
    if rank == 0:
        np.savez(f"{root}/live.npz", **{n: p.numpy() for n, p in
                                        live.items()})
else:
    live = {k: torch.from_numpy(v) for k, v in
            np.load(f"{root}/live.npz").items()}
    # reshard: world 4 (fsdp 2 x tensor 2) onto world 2 (fsdp 2)
    with FlashCheckpointer(f"{root}/c0") as ck:
        restored, rdata, step = ck.restore(trainer.abstract_state())
    got = full(restored.model)
    out["reshard_same_bits"] = all(torch.equal(live[n], got[n]) for n in live)
    out["reshard_data"], out["reshard_step"] = rdata, step
    restored, m = trainer.step(restored, tok, tgt)
    out["reshard_loss"] = m["loss"].item()
    # int8 saved at world 4, restored at world 2: groupwise bounded
    with FlashCheckpointer(f"{root}/c8") as ck:
        restored, _, step = ck.restore(trainer.abstract_state())
    got = full(restored.model)
    out["int8_step"] = step
    out["int8_within_bound"] = all(
        (got[n] - live[n]).abs().max().item()
        <= live[n].abs().max().item() / 127 + 1e-7 for n in live)
    # int8 round trip on this mesh: fewer bytes, the loss within noise
    state = trainer.init(0)
    for _ in range(2):
        state, _ = trainer.step(state, tok, tgt)
    for bits in (0, 8):
        with FlashCheckpointer(f"{root}/w2_{bits}", save_interval_steps=1,
                               quantize_bits=bits) as ck:
            ck.maybe_save(2, state, {"pos": 7}, force=True)
    params = {n: p.detach() for n, p in state.model.named_parameters()}
    out["params_bytes"] = q.encoded_nbytes(params)
    out["int8_payload"] = q.encoded_nbytes(q.abstract_encoded(params, 8))
    out["disk"] = [dir_bytes(f"{root}/w2_{b}") for b in (0, 8)]
    live = full(state.model)
    _, m = trainer.step(state, tok, tgt)
    out["baseline_loss"] = m["loss"].item()
    with FlashCheckpointer(f"{root}/w2_8") as ck:
        restored, data, step = ck.restore(trainer.abstract_state())
    got = full(restored.model)
    out["roundtrip_within_bound"] = all(
        (got[n] - live[n]).abs().max().item()
        <= live[n].abs().max().item() / 127 + 1e-7 for n in live)
    out["int8_data"], out["int8_roundtrip_step"] = data, step
    restored, m = trainer.step(restored, tok, tgt)
    out["int8_loss"] = m["loss"].item()
    restored, m = trainer.step(restored, tok, tgt)
    out["int8_next_loss"] = m["loss"].item()
print(json.dumps(out))
"""


def test_round_trip_reshard_and_int8_on_gloo(tmp_path):
    """Counterparts of tests/test_checkpoint.py's round trip, reshard-on-
    restore, int8 round trip and int8 reshard: saved at world 4 (fsdp 2 ×
    tensor 2), restored there bit for bit and at world 2 (fsdp 2) bit for
    bit, int8 within absmax/127 of each leaf; int8 stores under a third
    of the parameters' bytes and the restored model's loss is within 5%
    of the live one's."""
    root = str(tmp_path)
    saved = run_workers(tmp_path, CKPT_WORKER, 4, args=("save", root))
    for r in saved:
        assert r["latest0"] == r["latest8"] == 3
        assert r["roundtrip_same_bits"] and r["roundtrip_step"] == 3
        assert r["roundtrip_data"] == {"sampler": {"epoch": 1,
                                                   "completed_num": 128}}
    for r in run_workers(tmp_path, CKPT_WORKER, 2, args=("restore", root)):
        assert r["reshard_same_bits"] and r["reshard_step"] == 3
        assert r["reshard_data"] == saved[0]["roundtrip_data"]
        assert np.isfinite(r["reshard_loss"])
        assert r["int8_step"] == 3 and r["int8_within_bound"]
        assert r["int8_payload"] < r["params_bytes"] / 3
        assert r["disk"][1] < r["disk"][0] - 0.35 * r["params_bytes"]
        assert r["roundtrip_within_bound"]
        assert r["int8_data"] == {"pos": 7} and r["int8_roundtrip_step"] == 2
        assert abs(r["int8_loss"] - r["baseline_loss"]) < (
            0.05 * abs(r["baseline_loss"]) + 1e-3)
        assert np.isfinite(r["int8_next_loss"])


def _trainer():
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    return build_trainer(functools.partial(Llama, cfg),
                         lambda p: torch.optim.AdamW(p, lr=1e-3), None,
                         np.zeros((2, 16)), cross_entropy_loss,
                         micro_batch=2, device="cpu")


def test_interval_gating(tmp_path):
    state = _trainer().init(0)
    with FlashCheckpointer(str(tmp_path / "c"),
                           save_interval_steps=10) as ckpt:
        assert not ckpt.maybe_save(3, state)      # not on interval
        assert not ckpt.maybe_save(0, state)      # step 0 skipped
        assert ckpt.maybe_save(10, state)         # interval boundary
        assert ckpt.maybe_save(11, state, force=True)   # forced
        assert not ckpt.maybe_save(11, state, force=True)  # committed
        ckpt.wait()
        assert ckpt.all_steps() == [10, 11]
        ckpt.save_interval_steps = 0
        assert not ckpt.maybe_save(20, state)     # interval saves off
    with FlashCheckpointer(str(tmp_path / "k"), save_interval_steps=1,
                           max_to_keep=2) as ckpt:
        for step in (1, 2, 3):
            ckpt.maybe_save(step, state)
        ckpt.wait()
        assert ckpt.all_steps() == [2, 3]


def _corrupt_tree(root):
    corrupted = 0
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            with open(os.path.join(dirpath, name), "wb") as f:
                f.write(b"\x00corrupt\x00")
            corrupted += 1
    assert corrupted


@pytest.mark.parametrize("damage", ["scramble", "truncate"])
def test_restore_falls_back_past_corrupt_latest(tmp_path, damage):
    """A corrupt newest step is skipped and removed; the next older one
    restores, and the resumed run can save the skipped step again."""
    trainer = _trainer()
    state = trainer.init(0)
    tok, tgt = trainer.shard_batch(*(np.ones((2, 16), np.int64),) * 2)
    with FlashCheckpointer(str(tmp_path / "c"),
                           save_interval_steps=1) as ckpt:
        assert ckpt.maybe_save(1, state)
        ckpt.wait()
        step1 = {n: p.detach().clone()
                 for n, p in state.model.named_parameters()}
        state, _ = trainer.step(state, tok, tgt)
        assert ckpt.maybe_save(2, state)
        ckpt.wait()
        assert ckpt.all_steps() == [1, 2]
        if damage == "scramble":
            _corrupt_tree(str(tmp_path / "c" / "2"))
        else:
            shard = tmp_path / "c" / "2" / "__0_0.distcp"
            shard.write_bytes(shard.read_bytes()[:1000])
        restored, _, step = ckpt.restore(trainer.abstract_state())
        assert step == 1 and restored.step == 1
        assert ckpt.all_steps() == [1]
        assert ckpt.maybe_save(2, restored)
        ckpt.wait()
        assert ckpt.all_steps() == [1, 2]
    for name, p in restored.model.named_parameters():
        assert torch.equal(p.detach(), step1[name])
    with FlashCheckpointer(str(tmp_path / "empty")) as ckpt:
        assert ckpt.restore(trainer.abstract_state()) is None


def test_emergency_save_outcomes(tmp_path):
    import time

    state = _trainer().init(0)
    with FlashCheckpointer(str(tmp_path / "c"),
                           save_interval_steps=5) as ckpt:
        # a window below the floor: nothing is written
        assert ckpt.save_emergency(3, state, deadline=time.time() + 1.0,
                                   min_window_s=2.0) == "skipped"
        assert ckpt.all_steps() == []
        assert ckpt.save_emergency(3, state, {"x": 1}) == "saved"
        assert ckpt.all_steps() == [3]
        # the drain lands on a step already saved: awaited, not rewritten
        assert ckpt.maybe_save(5, state)
        assert ckpt.save_emergency(5, state, deadline=time.time() + 60
                                   ) == "saved"
        assert ckpt.all_steps() == [3, 5]
        assert ckpt.restore_data_state(3) == {"x": 1}
        assert ckpt.restore_data_state(9) is None
    # the loop's stop and SIGTERM paths are tests/test_torch_elastic_loop.py
    assert json.loads(json.dumps(ckpt.last_save))["step"] == 5
