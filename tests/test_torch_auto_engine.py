"""The port's strategy-search engine (dlrover_tpu_torch.auto.engine)
against the JAX package's (dlrover_tpu.auto.engine) on the CPU.

- ``analyse``: equal counts, bytes, dims and memory for the same model
  and the same ``DLROVER_TPU_HBM_BYTES``; the optimizer state is each
  package's real optimizer's, so the train-state bytes agree up to the
  optimizers' scalar bookkeeping (optax keeps one int32 step count, torch
  one f32 step a parameter tensor): |difference| ≤ 4 bytes a tensor.
- ``plan_candidates``: equal lists for 1, 2, 4 and 8 devices (the JAX
  package on the 8 forced CPU devices of tests/conftest.py, the port on
  a count of CPU devices), under several memory sizes.
- ``size_axes``, ``featurize``, the GP and expected improvement: equal
  (bit for bit: the same numpy on the same inputs).
- ``search_strategy``: the same pick when each package's dry run is
  replaced by the same table of scores.
"""

import dataclasses
import functools

import jax
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.auto.engine import acceleration_engine as j_engine
from dlrover_tpu.auto.engine import analyser as j_analyser
from dlrover_tpu.auto.engine import planner as j_planner
from dlrover_tpu.auto.engine import sg_algo as j_sg
from dlrover_tpu.auto.model_context import ModelContext as JContext
from dlrover_tpu.models import llama as jl
from dlrover_tpu.models import llama_moe as jmoe
from dlrover_tpu_torch import optim
from dlrover_tpu_torch.auto import ModelContext, auto_accelerate
from dlrover_tpu_torch.auto.engine import acceleration_engine as t_engine
from dlrover_tpu_torch.auto.engine import analyser as t_analyser
from dlrover_tpu_torch.auto.engine import dry_runner as t_dry
from dlrover_tpu_torch.auto.engine import planner as t_planner
from dlrover_tpu_torch.auto.engine import sg_algo as t_sg
from dlrover_tpu_torch.models import llama as tl
from dlrover_tpu_torch.models import llama_moe as tmoe
from dlrover_tpu_torch.ops._build import KernelBuildError, KernelLaunchError

SEQ = 16


def _contexts(n, family="llama", layers=2, j_opt=None, t_opt=None):
    if family == "llama":
        jcfg = dataclasses.replace(jl.LlamaConfig.tiny(
            attn_impl="reference"), num_layers=layers)
        tcfg = dataclasses.replace(tl.LlamaConfig.tiny(
            attn_impl="reference"), num_layers=layers)
        jmodel, tmodel = jl.Llama(jcfg), functools.partial(tl.Llama, tcfg)
    else:
        jcfg = dataclasses.replace(jmoe.LlamaMoEConfig.mixtral_tiny(
            attn_impl="reference"), num_layers=layers)
        tcfg = dataclasses.replace(tmoe.LlamaMoEConfig.mixtral_tiny(
            attn_impl="reference"), num_layers=layers)
        jmodel = jmoe.LlamaMoE(jcfg)
        tmodel = functools.partial(tmoe.LlamaMoE, tcfg)
    jctx = JContext(jmodel, optim_factory=j_opt or (
        lambda lr=1e-3: optax.adamw(lr)), loss_fn=jl.cross_entropy_loss,
        sample_batch=np.zeros((2, SEQ), np.int32),
        devices=jax.devices("cpu")[:n])
    tctx = ModelContext(tmodel, optim_factory=t_opt, loss_fn=tl.cross_entropy_loss,
                        sample_batch=np.zeros((2, SEQ), np.int64),
                        devices=["cpu"] * n)
    return jctx, tctx, tcfg


@pytest.mark.parametrize("family", ["llama", "moe"])
@pytest.mark.parametrize("n", [1, 8])
def test_analyse_matches_jax(family, n, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_HBM_BYTES", str(3 << 20))
    jctx, tctx, cfg = _contexts(n, family)
    j, t = j_analyser.analyse(jctx), t_analyser.analyse(tctx)
    tensors = sum(1 for _ in tctx.abstract_model().parameters())
    if family == "moe":
        # the JAX analysis counts every leaf of ``model.init``, the MoE
        # family's sown aux-loss scalars too (one f32 a layer); the
        # port counts parameters only
        assert j["param_count"] - t["param_count"] == cfg.num_layers
        j["param_count"] -= cfg.num_layers
        j["param_bytes"] -= 4 * cfg.num_layers
        j["train_state_bytes"] -= 8 * cfg.num_layers
    assert abs(t.pop("train_state_bytes") - j.pop("train_state_bytes")) \
        <= 4 * tensors
    assert t == j


def test_analyse_measures_the_real_optimizer_state():
    """An Adafactor user is not sized as if they carried f32 Adam
    moments: lean below 0.7 of fat, in both packages alike."""
    lean_j, lean_t, _ = _contexts(
        1, j_opt=lambda: optax.adafactor(1e-3, min_dim_size_to_factor=8),
        t_opt=lambda: optim.adafactor(1e-3, min_dim_size_to_factor=8))
    fat_j, fat_t, _ = _contexts(1)
    lean, fat = (t_analyser.analyse(lean_t)["train_state_bytes"],
                 t_analyser.analyse(fat_t)["train_state_bytes"])
    assert lean < fat * 0.7
    tensors = sum(1 for _ in fat_t.abstract_model().parameters())
    assert abs(lean - j_analyser.analyse(lean_j)["train_state_bytes"]) \
        <= 4 * tensors
    assert abs(fat - j_analyser.analyse(fat_j)["train_state_bytes"]) \
        <= 4 * tensors
    # fat: f32 params, a transient grad, the f32 accumulator and AdamW's
    # two moments: 20 bytes a parameter, plus the step counters
    count = fat_t.abstract_model().parameters()
    params = sum(p.numel() for p in count)
    assert 20 * params <= fat <= 20 * params + 4 * tensors


def test_device_memory_is_the_override_or_unknown_on_the_cpu(monkeypatch):
    monkeypatch.delenv("DLROVER_TPU_HBM_BYTES", raising=False)
    assert t_analyser.device_memory_bytes(torch.device("cpu")) == 0
    monkeypatch.setenv("DLROVER_TPU_HBM_BYTES", "12345")
    assert t_analyser.device_memory_bytes(torch.device("cpu")) == 12345


@pytest.mark.parametrize("info", [
    {"n_devices": 8, "device_hbm_bytes": 16 << 30,
     "train_state_bytes": 36 << 30, "activation_bytes": 0,
     "num_heads": 16, "num_kv_heads": 16},
    {"n_devices": 8, "device_hbm_bytes": 16 << 30,
     "train_state_bytes": 9 << 30, "activation_bytes": 400 << 30,
     "num_heads": 4, "num_kv_heads": 2},
    {"n_devices": 8, "device_hbm_bytes": 16 << 30,
     "train_state_bytes": 9 << 30, "activation_bytes": 1600 << 30,
     "num_heads": 4, "num_kv_heads": 2, "seq_len": 1 << 18},
    {"n_devices": 8, "device_hbm_bytes": 0, "train_state_bytes": 1},
    {"n_devices": 8, "device_hbm_bytes": 0, "train_state_bytes": 1,
     "num_experts": 4},
    {"n_devices": 8, "device_hbm_bytes": 16 << 30,
     "train_state_bytes": 36 << 30, "activation_bytes": 0,
     "num_heads": 16, "num_kv_heads": 16, "num_experts": 8},
    {"n_devices": 6, "device_hbm_bytes": 80 << 30,
     "train_state_bytes": 200 << 30, "activation_bytes": 30 << 30,
     "num_heads": 12, "num_kv_heads": 12, "seq_len": 4096},
])
def test_size_axes_matches_jax(info):
    assert t_analyser.size_axes(dict(info)) == j_analyser.size_axes(
        dict(info))


def _as_lists(candidates):
    return [[(name, dict(config)) for name, config in strategy]
            for strategy in candidates]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("hbm", ["", "fits", "fsdp4", "overflow"])
@pytest.mark.parametrize("family,layers", [("llama", 2), ("llama", 4),
                                           ("moe", 4)])
def test_plan_candidates_match_jax(n, hbm, family, layers, monkeypatch):
    jctx, tctx, cfg = _contexts(n, family, layers)
    state = cfg.param_count() * 20
    sizes = {"": "", "fits": str(state * 10),
             "fsdp4": str(int(state / 4 / 0.6) + 1),
             "overflow": str(cfg.param_count() * 4)}
    monkeypatch.setenv("DLROVER_TPU_HBM_BYTES", sizes[hbm])
    for max_candidates in (3, 16):
        want = j_planner.plan_candidates(jctx, max_candidates)
        got = t_planner.plan_candidates(tctx, max_candidates)
        assert _as_lists(got) == _as_lists(want)


def _random_strategies(seed, n=12):
    rng = np.random.default_rng(seed)
    names = ["half", "amp", "module_replace", "checkpoint", "fsdp",
             "tensor_parallel", "pipeline_parallel", "expert_parallel",
             "sequence_parallel", "offload_optimizer", "streaming", "zero1"]
    out = []
    for _ in range(n):
        picked = rng.choice(names, size=rng.integers(1, 5), replace=False)
        out.append([(str(name), {"size": int(rng.choice([0, 2, 4, 8]))})
                    for name in picked])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_featurize_gp_and_ei_are_the_jax_package_bit_for_bit(seed):
    strategies = _random_strategies(seed)
    for s in strategies:
        np.testing.assert_array_equal(t_sg.featurize(s), j_sg.featurize(s))
    rng = np.random.default_rng(seed)
    x = np.stack([t_sg.featurize(s) for s in strategies])
    y = rng.standard_normal(len(x)) * 3 + 10
    train, test = slice(0, 7), slice(7, None)
    tm, ts = t_sg.GaussianProcess().fit(x[train], y[train]).predict(x[test])
    jm, js = j_sg.GaussianProcess().fit(x[train], y[train]).predict(x[test])
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(
        t_sg.expected_improvement(tm, ts, best=float(y.max())),
        j_sg.expected_improvement(jm, js, best=float(y.max())))


def _score_table(seed):
    """A deterministic fake dry run: a score for each strategy, -inf for
    some (a failed candidate)."""
    def score(strategy):
        key = repr(sorted((n, sorted(c.items())) for n, c in strategy))
        h = sum(ord(ch) * (i + 1) for i, ch in enumerate(key)) + seed
        return float("-inf") if h % 7 == 0 else float(h % 97) / 10.0
    return score


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("budget", [2, 4, 10])
def test_bo_search_matches_jax(seed, budget):
    candidates = _random_strategies(seed + 10, n=9)
    score = _score_table(seed)
    tb, tscore, thist = t_sg.bo_search(candidates, score, budget)
    jb, jscore, jhist = j_sg.bo_search(candidates, score, budget)
    assert (tb, tscore, thist) == (jb, jscore, jhist)


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("algo,budget,max_candidates", [
    ("sh", "", "8"), ("bo", "3", "8"), ("auto", "4", "8"),
    ("auto", "", "3")])
@pytest.mark.parametrize("seed", [0, 5])
def test_search_strategy_picks_what_jax_picks(n, algo, budget,
                                              max_candidates, seed,
                                              monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SEARCH_ALGO", algo)
    monkeypatch.setenv("DLROVER_TPU_SEARCH_BUDGET", budget)
    monkeypatch.setenv("DLROVER_TPU_SEARCH_MAX_CANDIDATES", max_candidates)
    jctx, tctx, _ = _contexts(n)
    score = _score_table(seed)
    calls = {"jax": [], "port": []}

    def fake(who):
        def dry_run(context, strategy, warmup=0, steps=0):
            calls[who].append((strategy, steps))
            s = score(strategy)
            return s, "" if s > float("-inf") else "failed"
        return dry_run

    monkeypatch.setattr(j_engine, "dry_run", fake("jax"))
    monkeypatch.setattr(t_engine, "dry_run", fake("port"))
    assert (t_engine.search_strategy(tctx)
            == j_engine.search_strategy(jctx))
    assert calls["port"] == calls["jax"]


def test_dry_run_scores_and_survives_a_bad_strategy():
    _, tctx, _ = _contexts(1)
    speed, err = t_dry.dry_run(tctx, [("half", {})], warmup=1, steps=2)
    assert speed > 0 and err == ""
    # a mesh the one device cannot hold
    speed, err = t_dry.dry_run(tctx, [("tensor_parallel", {"size": 64})],
                               warmup=1, steps=1)
    assert speed == float("-inf") and err


@pytest.mark.parametrize("error", [
    KernelBuildError("nvcc failed"), KernelLaunchError("bad launch"),
    RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_dry_run_raises_a_kernel_error_instead_of_scoring_it(error,
                                                             monkeypatch):
    from dlrover_tpu_torch.auto import accelerate

    def broken(context):
        raise error

    monkeypatch.setattr(accelerate, "lower", broken)
    _, tctx, _ = _contexts(1)
    with pytest.raises(type(error)):
        t_dry.dry_run(tctx, [("half", {})], warmup=1, steps=1)


def test_auto_search_end_to_end_on_one_cpu_device(monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SEARCH_MAX_CANDIDATES", "3")
    result = auto_accelerate(
        functools.partial(tl.Llama, tl.LlamaConfig.tiny(
            attn_impl="reference")),
        loss_fn=tl.cross_entropy_loss,
        sample_batch=np.zeros((2, SEQ), np.int64), strategy="auto",
        micro_batch=2, devices=["cpu"])
    assert result.strategy in t_planner.plan_candidates(
        result.context, max_candidates=3)
    state = result.init(0)
    tokens = np.ones((2, SEQ), np.int64)
    state, metrics = result.step(state, *result.trainer.shard_batch(
        tokens, tokens))
    assert np.isfinite(metrics["loss"].item())
