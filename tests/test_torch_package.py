"""The port as a package: it stands alone (no JAX, no dlrover_tpu), its
entry points refuse to run off the card unless asked for the CPU, its
own copies of jax-free modules behave as the originals, and its loop
trains on the CPU."""

import ast
import functools
import json
import math
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.obs import mfu as jmfu
from dlrover_tpu.ops.norms import reference_rms_norm as j_rms_norm
from dlrover_tpu.trainer.sampler import (
    ElasticDistributedSampler as JSampler,
)
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    cross_entropy_loss,
)
from dlrover_tpu_torch.obs import mfu as tmfu
from dlrover_tpu_torch.ops.norms import fused_rms_norm, reference_rms_norm
from dlrover_tpu_torch.trainer.elastic_loop import (
    ElasticTrainLoop,
    TrainLoopConfig,
)
from dlrover_tpu_torch.trainer.sampler import (
    ElasticDistributedSampler as TSampler,
)
from dlrover_tpu_torch.trainer.synthetic import batches, synthetic_corpus
from dlrover_tpu_torch.trainer.train_step import build_trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "dlrover_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "dlrover_tpu"}


def _port_sources():
    # the card tests run where JAX is not installed
    return sorted(PACKAGE.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-GPU refusal is moot")


def _adamw(params):
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.1)


# the modules of the drain, hang and goodput slice, which the scans below
# must reach
FAULT_MODULES = ("agent/preemption.py", "trainer/watchdog.py",
                 "diagnostics/chaos.py", "obs/goodput.py")
# the re-planning slice's own copies of the JAX package's stdlib-only
# modules, which the scans must reach too
REPLAN_MODULES = ("parallel/planner.py", "parallel/calibration.py")
# the Llama-7B slice's modules: the per-leaf optimizers, remat, the
# streaming step and the device prefetch
SLICE_7B_MODULES = ("optim/base.py", "optim/factored.py", "optim/agd.py",
                    "optim/bf16.py", "optim/wsam.py", "optim/sparse.py",
                    "ops/remat.py", "trainer/streaming.py",
                    "data/prefetch.py")
# the MoE slice's modules: the expert layer, the model family, Adafactor
# and the worker script
SLICE_MOE_MODULES = ("parallel/moe.py", "models/llama_moe.py",
                     "optim/adafactor.py", "examples/moe_train.py")
# the auto-acceleration, network-check and data-plane slice's modules
SLICE_AUTO_MODULES = (
    "auto/__init__.py", "auto/strategy.py", "auto/model_context.py",
    "auto/accelerate.py", "auto/opt_lib/__init__.py",
    "auto/opt_lib/library.py", "auto/engine/__init__.py",
    "auto/engine/analyser.py", "auto/engine/planner.py",
    "auto/engine/sg_algo.py", "auto/engine/dry_runner.py",
    "auto/engine/acceleration_engine.py", "diagnostics/network_check.py",
    "ops/host_ops.py", "data/shm_ring.py", "data/coworker.py",
    "examples/streaming_train.py")
# the sequence-parallelism and quantized-reduce slice's modules
SLICE_SP_MODULES = ("parallel/ring_attention.py",
                    "parallel/quant_collectives.py",
                    "parallel/collectives.py")
# the tensor-parallelism slice's module
SLICE_TP_MODULES = ("parallel/tensor_parallel.py",)
# slice mode's module: the host-level cross-slice gradient sync
SLICE_DCN_MODULES = ("parallel/dcn_sync.py",)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 10
    for name in (FAULT_MODULES + REPLAN_MODULES + SLICE_7B_MODULES
                 + SLICE_MOE_MODULES + SLICE_AUTO_MODULES
                 + SLICE_SP_MODULES + SLICE_TP_MODULES
                 + SLICE_DCN_MODULES):
        assert PACKAGE / name in sources, name
    for path in sources:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PACKAGE.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules "
        "if k.split('.')[0] in %r)))\n" % (sorted(FORBIDDEN),))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert "dlrover_tpu_torch.trainer.elastic_loop" in modules
    for name in (FAULT_MODULES + REPLAN_MODULES + SLICE_7B_MODULES
                 + SLICE_MOE_MODULES + SLICE_AUTO_MODULES
                 + SLICE_SP_MODULES + SLICE_TP_MODULES
                 + SLICE_DCN_MODULES):
        if name.endswith("__init__.py"):
            continue
        module = "dlrover_tpu_torch." + name[:-3].replace("/", ".")
        assert module in modules, module


def test_entry_points_raise_without_gpu():
    _no_gpu()
    cfg = LlamaConfig.tiny(norm_impl="reference")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        build_trainer(functools.partial(Llama, cfg), _adamw, None,
                      np.zeros((1, 8)), cross_entropy_loss)
    with pytest.raises(RuntimeError):
        Llama(cfg)
    with pytest.raises(RuntimeError):
        ElasticTrainLoop(functools.partial(Llama, cfg), _adamw,
                         cross_entropy_loss,
                         TrainLoopConfig(global_batch=2, seq_len=8))
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    # the worker script of `python -m dlrover_tpu_torch.run`
    sys.path.insert(0, str(PACKAGE / "examples"))
    try:
        import llama_train
    finally:
        sys.path.pop(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama_train.main(["--config", "tiny", "--steps", "1"])


def test_standalone_run_refuses_to_run_off_the_card_unless_asked(tmp_path):
    """`python -m dlrover_tpu_torch.run --standalone` without the worker's
    `--device cpu`: the worker raises, and with no restarts left the agent
    exits with its code."""
    _no_gpu()
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
         "--max-restarts", "0", "--monitor-interval", "0.2",
         "--devices-per-node", "1",
         str(PACKAGE / "examples" / "llama_train.py"), "--config", "tiny",
         "--steps", "1", "--ckpt-dir", str(tmp_path / "c")],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "device='cpu'" in proc.stderr
    assert "restart budget exhausted" in proc.stderr
    assert not (tmp_path / "c").exists()


def test_rms_norms_match_jax_on_cpu():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 32), np.float32)
    w = rng.standard_normal(32, np.float32)
    want = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    for fn in (reference_rms_norm, fused_rms_norm):
        got = fn(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(dataset_size=37, seed=3),
    dict(dataset_size=40, num_replicas=4, rank=1, seed=7),
    dict(dataset_size=41, num_replicas=4, rank=3, drop_last=True),
    dict(dataset_size=20, shuffle=False, num_replicas=3, rank=2),
])
def test_sampler_copy_matches_jax_package(kw):
    j, t = JSampler(**kw), TSampler(**kw)
    assert list(t) == list(j) and len(t) == len(j)
    for s in (j, t):
        s.record_batch(8)
        s.set_epoch(2)
        s.record_batch(4)
    assert list(t) == list(j) and t.state_dict() == j.state_dict()
    j2, t2 = JSampler(**kw), TSampler(**kw)
    j2.load_state_dict({"epoch": 1, "completed_num": 9, "seed": 5})
    t2.load_state_dict({"epoch": 1, "completed_num": 9, "seed": 5})
    assert list(t2) == list(j2)


def test_mfu_copy_matches_jax_package_and_knows_h100():
    args = (1.2e9, 22, 2048, 2048, 65.5e6)
    assert tmfu.flops_per_token(*args) == jmfu.flops_per_token(*args)
    assert (tmfu.achieved_mfu(2.4e4, 7e9, 989e12)
            == jmfu.achieved_mfu(2.4e4, 7e9, 989e12))
    assert tmfu.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert tmfu.peak_flops_for("NVIDIA H100 PCIe") == 756e12
    assert tmfu.peak_flops_for("cpu") == 0.0
    assert tmfu.achieved_mfu(1.0, 1.0, 0.0) == -1.0


def test_elastic_loop_trains_three_tiny_steps_on_cpu():
    cfg = LlamaConfig.tiny(attn_impl="flash", embed_impl="gather")
    loop = ElasticTrainLoop(
        functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
        TrainLoopConfig(global_batch=4, seq_len=32,
                        max_micro_per_replica=2, max_steps=3),
        device="cpu")
    assert (loop.accum, loop.micro_global) == (2, 2)
    sampler = TSampler(dataset_size=10 ** 6, seed=0)
    state, start = loop.restore_or_init(0, sampler)
    assert start == 0
    data = batches(synthetic_corpus(cfg.vocab_size), sampler, 4, 32)
    state, metrics = loop.run(state, data, sampler=sampler)
    loop.close()
    hist = metrics["history"]
    assert metrics["step"] == state.step == len(hist) == 3
    assert sampler.completed_num == 12
    for rec in hist:
        assert math.isfinite(rec["loss"]) and rec["tokens_per_s"] > 0
        assert rec["mfu"] == -1.0      # no card, no peak: not a number
    assert abs(hist[0]["loss"] - math.log(cfg.vocab_size)) < 1.0


def test_kernel_library_name_follows_its_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header names a new library, so a stale one is
    never loaded; the flags and the source count too. No nvcc runs."""
    from dlrover_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.source_digest("k")
    assert _build.source_digest("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build.source_digest("k")
    (tmp_path / "other.cuh").write_text("// new\n")
    third = _build.source_digest("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    fourth = _build.source_digest("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert len({first, second, third, fourth,
                _build.source_digest("k")}) == 5


@pytest.mark.parametrize("option", [
    # an attention no family knows
    (dict(model=functools.partial(Llama,
                                  LlamaConfig.tiny(attn_impl="sparse"))),
     ValueError),
    # remat is ported: only a policy name the JAX package does not know
    (dict(model=functools.partial(Llama, LlamaConfig.tiny(
        remat=True, remat_policy="offload"))), ValueError),
])
def test_elastic_loop_unported_options_raise(option):
    option, error = option
    kw = dict(model=functools.partial(Llama, LlamaConfig.tiny()),
              config=TrainLoopConfig(global_batch=2, seq_len=8))
    kw.update(option)
    with pytest.raises(error):
        ElasticTrainLoop(optimizer_factory=_adamw, loss_fn=cross_entropy_loss,
                         device="cpu", **kw)


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_elastic_loop_trains_the_sequence_impls_in_one_process(attn_impl):
    """A process alone has no sequence axis: ``"ring"`` and ``"ulysses"``
    train through the flash path (its plain version on the CPU)."""
    cfg = LlamaConfig.tiny(attn_impl=attn_impl)
    loop = ElasticTrainLoop(
        functools.partial(Llama, cfg), _adamw, cross_entropy_loss,
        TrainLoopConfig(global_batch=2, seq_len=16, max_steps=1),
        device="cpu")
    sampler = TSampler(dataset_size=10 ** 6, seed=0)
    state, _ = loop.restore_or_init(0, sampler)
    data = batches(synthetic_corpus(cfg.vocab_size), sampler, 2, 16)
    state, metrics = loop.run(state, data, sampler=sampler)
    loop.close()
    assert metrics["step"] == 1
    assert math.isfinite(metrics["history"][0]["loss"])
