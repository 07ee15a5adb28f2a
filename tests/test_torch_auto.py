"""The port's auto_accelerate (dlrover_tpu_torch.auto) against the JAX
package's (dlrover_tpu.auto) on one CPU device: each JAX strategy test
that one device can run gives the same plan, the same mesh dims and
(accum, micro), and the same losses over 2 steps.

The same initial parameters on both sides: the JAX trainer's init, carried
into the port's model factory (``convert.params_from_jax``), and the same
seeded numpy batches; AdamW(1e-3, weight decay 0.1) on both sides.

Tolerance: the losses within 1e-4 relative. The first step's loss differs
only by the order of f32 sums (and bf16 rounding of the same values
where a strategy computes in bf16); the second also carries one Adam
update, nearly lr·sign(g) an element. Measured on this configuration:
at most 7.2e-5 (``half``, bf16 parameters), 4.2e-5 under ``amp``.
"""

import dataclasses
import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.auto import auto_accelerate as j_auto
from dlrover_tpu.auto import load_strategy as j_load
from dlrover_tpu.auto import save_strategy as j_save
from dlrover_tpu.auto.accelerate import apply_strategy as j_apply
from dlrover_tpu.auto.accelerate import default_strategy as j_default
from dlrover_tpu.auto.model_context import ModelContext as JContext
from dlrover_tpu.auto.opt_lib import OptimizationLibrary as JLib
from dlrover_tpu.models import llama as jl
from dlrover_tpu_torch import convert, optim
from dlrover_tpu_torch.auto import (
    ModelContext,
    OptimizationLibrary,
    auto_accelerate,
    load_strategy,
    save_strategy,
)
from dlrover_tpu_torch.auto.accelerate import apply_strategy, default_strategy
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models import llama as tl

LR, WD, SEQ = 1e-3, 0.1, 16
LOSS_RTOL = 1e-4


def _j_adamw(lr=LR):
    return optax.adamw(lr, weight_decay=WD)


def _t_adamw(lr=LR):
    return lambda p: torch.optim.AdamW(p, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=WD)


def _from_params(params, cfg, device=None, seed=0):
    """A Llama factory whose model holds ``params`` (the JAX init)."""
    model = tl.Llama(cfg, device=device, seed=seed)
    if torch.device(device if device is not None else "cpu").type != "meta":
        model.load_state_dict(params)
    return model


def _carried(jstate):
    return convert.params_from_jax(jax.tree.map(
        lambda x: np.asarray(x, np.float32), jstate.params))


def _dtype_name(value):
    if value is None:
        return None
    if isinstance(value, torch.dtype):
        return str(value).replace("torch.", "")
    return jnp.dtype(value).name


def _plan(plan):
    out = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
    for key in ("compute_dtype", "params_dtype"):
        out[key] = _dtype_name(out[key])
    return out


def _run_both(strategy, steps=2, **kw):
    """auto_accelerate in both packages from the same parameters and
    batches: (jax result, port result, [(jax loss, port loss)])."""
    jres = j_auto(jl.Llama(jl.LlamaConfig.tiny(attn_impl="reference")),
                  optim_factory=_j_adamw, loss_fn=jl.cross_entropy_loss,
                  sample_batch=np.zeros((2, SEQ), np.int32),
                  strategy=strategy, devices=jax.devices("cpu")[:1], **kw)
    jstate = jres.init(jax.random.PRNGKey(0))
    factory = functools.partial(_from_params, _carried(jstate),
                                tl.LlamaConfig.tiny(attn_impl="reference"))
    tres = auto_accelerate(factory, optim_factory=_t_adamw,
                           loss_fn=tl.cross_entropy_loss,
                           sample_batch=np.zeros((2, SEQ), np.int64),
                           strategy=strategy, devices=["cpu"], **kw)
    tstate = tres.init(0)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        rows = jres.trainer.accum_steps * jres.trainer.micro_batch
        tokens = rng.integers(0, 256, (rows, SEQ), dtype=np.int32)
        targets = rng.integers(0, 256, (rows, SEQ), dtype=np.int32)
        jstate, jm = jres.step(jstate, *jres.trainer.shard_batch(tokens,
                                                                 targets))
        tstate, tm = tres.step(tstate, *tres.trainer.shard_batch(tokens,
                                                                 targets))
        losses.append((float(jm["loss"]), tm["loss"].item()))
    return jres, tres, losses


# ---------------------------------------------------------------------------
# the optimization library
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    jlib, tlib = JLib(), OptimizationLibrary()
    assert sorted(tlib.opts) == sorted(jlib.opts)
    for name in jlib.opts:
        j, t = jlib[name], tlib[name]
        assert (t.name, t.distributed, t.group) == (j.name, j.distributed,
                                                    j.group), name
    from dlrover_tpu.auto.opt_lib import SEMIAUTO_STRATEGIES as J_SEMI
    from dlrover_tpu_torch.auto.opt_lib import SEMIAUTO_STRATEGIES

    assert SEMIAUTO_STRATEGIES == J_SEMI


@pytest.mark.parametrize("strategy", [
    [("zero1", {}), ("fsdp", {})],
    [("zero2", {}), ("zero1", {})],
    [("nonexistent", {})],
])
def test_validate_strategy_refuses_as_jax(strategy):
    with pytest.raises(ValueError) as jerr:
        JLib().validate_strategy(strategy)
    with pytest.raises(ValueError) as terr:
        OptimizationLibrary().validate_strategy(strategy)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("strategy", [
    [("half", {}), ("checkpoint", {"policy": "dots"}),
     ("module_replace", {}),
     ("mixed_parallel", {"dims": [["fsdp", 2], ["tensor", 2]]})],
    [("amp", {}), ("remat", {}), ("fsdp", {"size": 4})],
    [("half", {"dtype": "float16"}), ("parallel_mode", {"data": 4})],
    [("3d_parallel", {"data": 2, "tensor": 2, "pipe": 2})],
    [("pipeline_parallel", {"size": 4, "rounds": 2,
                            "memory_bound": True}), ("adam_offload", {})],
    [("sequence_parallel", {"size": 4, "impl": "ulysses"}),
     ("expert_parallel", {"size": 2}), ("zero2", {"size": 2})],
    [("quant_allreduce", {"bits": 4}), ("tensor_parallel", {"size": 8})],
    [("streaming", {}), ("amp_native", {})],
    [("mixed_parallel", {"dims": [["sequence", 2], ["expert", 2],
                                  ["pipe", 2], ["data", 1]]})],
])
def test_passes_edit_the_plan_as_jax(strategy):
    jctx = JContext(jl.Llama(jl.LlamaConfig.tiny()),
                    sample_batch=np.zeros((2, SEQ), np.int32),
                    devices=jax.devices("cpu")[:1])
    tctx = ModelContext(functools.partial(tl.Llama, tl.LlamaConfig.tiny()),
                        sample_batch=np.zeros((2, SEQ), np.int64),
                        devices=["cpu"])
    j_apply(jctx, strategy)
    apply_strategy(tctx, strategy)
    assert _plan(tctx.plan) == _plan(jctx.plan)


@pytest.mark.parametrize("config", [{"bits": 3}, {"size": 2, "impl": "x"}])
def test_pass_config_refusals_match_jax(config):
    name = "quant_allreduce" if "bits" in config else "sequence_parallel"
    jctx = JContext(None, devices=jax.devices("cpu")[:1])
    tctx = ModelContext(None, devices=["cpu"])
    with pytest.raises(ValueError) as jerr:
        JLib()[name].apply(jctx, config)
    with pytest.raises(ValueError) as terr:
        OptimizationLibrary()[name].apply(tctx, config)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_default_strategy_matches_jax(n):
    assert default_strategy(n) == j_default(n)


# ---------------------------------------------------------------------------
# lowering: the same plan, mesh, batch geometry and losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy,kw", [
    (["half"], {}),                                  # explicit
    (None, {}),                                      # default
    (["amp"], {}),
    (["amp", "checkpoint"], {}),
    ([("checkpoint", {"policy": "dots"})], {}),
    (["half", "module_replace"], {"micro_batch": 2}),
    (["amp"], {"global_batch": 8, "micro_batch": 2}),   # accumulation
    (["half"], {"global_batch": 6, "micro_batch": 4}),
])
def test_lowering_matches_jax(strategy, kw):
    jres, tres, losses = _run_both(strategy, **kw)
    assert tres.strategy == jres.strategy
    assert _plan(tres.context.plan) == _plan(jres.context.plan)
    assert tres.mesh.shape == dict(jres.mesh.shape)
    assert ((tres.trainer.accum_steps, tres.trainer.micro_batch)
            == (jres.trainer.accum_steps, jres.trainer.micro_batch))
    jcfg, tcfg = jres.context.model_config(), tres.context.model_config()
    assert _dtype_name(tcfg.dtype) == _dtype_name(jcfg.dtype)
    assert _dtype_name(tcfg.param_dtype) == _dtype_name(jcfg.param_dtype)
    assert (tcfg.attn_impl, tcfg.remat, tcfg.remat_policy) == (
        jcfg.attn_impl, jcfg.remat, jcfg.remat_policy)
    for jloss, tloss in losses:
        np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    assert losses[1][1] != losses[0][1]


def _per_leaf(lr=LR):
    return optax.chain(optax.scale_by_factored_rms(), optax.scale(-lr))


def test_streaming_lowers_and_trains_as_jax():
    jcfg = jl.LlamaConfig.tiny(attn_impl="reference")
    jres = j_auto(jl.Llama(jcfg), optim_factory=_per_leaf,
                  loss_fn=jl.cross_entropy_loss,
                  sample_batch=np.zeros((2, SEQ), np.int32),
                  strategy=[("streaming", {})], micro_batch=2,
                  devices=jax.devices("cpu")[:1])
    tres = auto_accelerate(
        functools.partial(tl.Llama, tl.LlamaConfig.tiny(
            attn_impl="reference")),
        optim_factory=lambda lr=LR: optim.factored_rms(lr),
        loss_fn=tl.cross_entropy_loss,
        sample_batch=np.zeros((2, SEQ), np.int64),
        strategy=[("streaming", {})], micro_batch=2, devices=["cpu"])
    assert ((tres.trainer.accum_steps, tres.trainer.micro_batch)
            == (jres.trainer.accum_steps, jres.trainer.micro_batch))
    jstate = jres.init(jax.random.PRNGKey(0))
    _, params, _ = convert.streaming_state_from_jax(
        jax.tree.map(np.asarray, nn.unbox(jstate)))
    tstate = tres.init(0)
    tstate.model.load_state_dict(params, strict=True)
    rng = np.random.default_rng(3)
    for step in (1, 2):
        tokens = rng.integers(0, 256, (2, SEQ), dtype=np.int32)
        targets = rng.integers(0, 256, (2, SEQ), dtype=np.int32)
        jstate, jm = jres.step(jstate, *jres.trainer.shard_batch(tokens,
                                                                 targets))
        tstate, tm = tres.step(tstate, *tres.trainer.shard_batch(tokens,
                                                                 targets))
        assert tstate.step == step == int(jstate.step)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("kw,match", [
    (dict(global_batch=8, micro_batch=2), "accumulate"),
    (dict(devices=8), "single-device"),
])
def test_streaming_refusals_match_jax(kw, match):
    kw = dict(kw)
    n = kw.pop("devices", 1)
    with pytest.raises(ValueError, match=match) as jerr:
        j_auto(jl.Llama(jl.LlamaConfig.tiny(attn_impl="reference")),
               optim_factory=_per_leaf, loss_fn=jl.cross_entropy_loss,
               sample_batch=np.zeros((2, SEQ), np.int32),
               strategy=[("streaming", {})],
               devices=jax.devices("cpu")[:n], **kw)
    with pytest.raises(ValueError, match=match) as terr:
        auto_accelerate(
            functools.partial(tl.Llama, tl.LlamaConfig.tiny(
                attn_impl="reference")),
            optim_factory=lambda: optim.factored_rms(LR),
            loss_fn=tl.cross_entropy_loss,
            sample_batch=np.zeros((2, SEQ), np.int64),
            strategy=[("streaming", {})], devices=["cpu"] * n, **kw)
    assert str(terr.value) == str(jerr.value).replace("chips", "cards")


def test_streaming_keeps_the_per_leaf_contract():
    """A torch.optim factory (which may hold state across leaves) is
    refused by the streaming branch, never turned into a per-leaf one."""
    with pytest.raises(TypeError, match="per leaf"):
        auto_accelerate(
            functools.partial(tl.Llama, tl.LlamaConfig.tiny()),
            optim_factory=_t_adamw, loss_fn=tl.cross_entropy_loss,
            sample_batch=np.zeros((2, SEQ), np.int64),
            strategy=[("streaming", {})], devices=["cpu"])


@pytest.mark.parametrize("writer,reader", [
    (save_strategy, j_load), (j_save, load_strategy)])
def test_strategy_file_round_trips_between_packages(tmp_path, writer,
                                                    reader):
    strategy = [("half", {}), ("fsdp", {"size": 4}),
                ("checkpoint", {"policy": "dots"}),
                ("mixed_parallel", {"dims": [["tensor", 2]]})]
    path = str(tmp_path / "strategy.json")
    writer(strategy, path)
    assert reader(path) == strategy


def test_save_and_load_strategy_file_lowers_the_same(tmp_path):
    path = str(tmp_path / "s.json")
    jres, tres, losses = _run_both(["amp", ("checkpoint", {})])
    save_strategy(tres.strategy, path)
    j_save(jres.strategy, str(tmp_path / "j.json"))
    assert open(path).read() == open(tmp_path / "j.json").read()
    again = auto_accelerate(
        functools.partial(tl.Llama, tl.LlamaConfig.tiny()),
        loss_fn=tl.cross_entropy_loss,
        sample_batch=np.zeros((2, SEQ), np.int64),
        load_strategy_file=path, save_strategy_to_file=str(
            tmp_path / "again.json"), devices=["cpu"])
    assert again.strategy == tres.strategy == load_strategy(path)
    assert _plan(again.context.plan) == _plan(tres.context.plan)


# ---------------------------------------------------------------------------
# what the port refuses, and models without a dataclass config
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_two():
    """A process group of 2 ranks in this one process (torch's ``fake``
    backend: its collectives move nothing), for what the lowering builds
    before a step: the mesh, the checks and the placements."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("strategy,model,item", [
    ([("tensor_parallel", {"size": 2})], "moe", "item 10c"),
])
def test_unported_passes_raise_naming_their_item(world_of_two, strategy,
                                                 model, item):
    """What the port did not lower raised naming its ROADMAP item; the
    last such pass, tensor_parallel on an MoE model (10c), now lowers: a
    tensor-2 trainer whose expert kernels hold half of each expert's
    columns and whose router stays replicated (its training on gloo ranks:
    tests/test_torch_moe_tensor_parallel.py). Slice mode (6.4) has no
    pass of its own: every pass lowers."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from dlrover_tpu_torch.models import llama_moe as tlm

    cfg = tlm.LlamaMoEConfig.mixtral_tiny()
    factory = functools.partial(tlm.LlamaMoE, cfg)
    result = auto_accelerate(factory, loss_fn=tl.cross_entropy_loss,
                             sample_batch=np.zeros((2, SEQ), np.int64),
                             strategy=strategy, devices=["cpu"] * 2)
    assert result.mesh.shape["tensor"] == 2
    moe = result.init(0).model.layer_0.moe
    for leaf, dim in ((moe.ExpertMLP_0.wi, 2), (moe.ExpertMLP_0.wo, 1)):
        assert isinstance(leaf, DTensor) and leaf.placements == (Shard(dim),)
        assert leaf.to_local().shape[dim] == cfg.intermediate_size // 2
    assert moe.router.placements == (Replicate(),)


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_tensor_parallel_lowers_the_fused_qkv_families(world_of_two,
                                                       family):
    """tensor_parallel on GPT and BERT lowers as on Llama (ROADMAP 10b):
    a tensor-2 trainer whose fused qkv kernel and bias hold half the
    columns on each rank, which the head-major layout makes whole heads
    (their training on two gloo ranks: tests/test_torch_tensor_parallel.py)."""
    from torch.distributed.tensor import DTensor, Shard

    from dlrover_tpu_torch.models import bert as tbert

    if family == "gpt":
        cfg = tgpt.GPTConfig.tiny()
        factory, loss = functools.partial(tgpt.GPT, cfg), tl.cross_entropy_loss
        block, width = "block_0", cfg.n_embd
    else:
        cfg = tbert.BertConfig.tiny()
        factory, loss = functools.partial(tbert.Bert, cfg), tbert.mlm_loss
        block, width = "layer_0", cfg.hidden_size
    result = auto_accelerate(factory, loss_fn=loss,
                             sample_batch=np.zeros((2, SEQ), np.int64),
                             strategy=[("tensor_parallel", {"size": 2})],
                             devices=["cpu"] * 2)
    assert result.mesh.shape["tensor"] == 2
    qkv = getattr(result.init(0).model, block).qkv
    for leaf, dim in ((qkv.kernel, 1), (qkv.bias, 0)):
        assert isinstance(leaf, DTensor) and leaf.placements == (Shard(dim),)
        assert leaf.to_local().shape[dim] == 3 * width // 2


@pytest.mark.parametrize("size,impl,want", [
    (2, "ulysses", "ulysses"), (2, "ring", "ring"),
    # at sequence 1 the flash request stands (the plain attention on CPU)
    (1, "ring", "reference")])
def test_sequence_parallel_sets_the_attention_over_a_flash_request(
        size, impl, want):
    """The JAX lowering's rule (accelerate.py:113-117): at a sequence axis
    above 1 the plan's sequence_impl replaces the attention, a
    module_replace (flash) request included; planned for two devices, the
    lowering's edit alone (a world of 2 lowers on gloo ranks,
    tests/test_torch_sequence_parallel.py)."""
    from dlrover_tpu_torch.auto.accelerate import _edit_model, plan_mesh_spec

    strategy = [("module_replace", {}),
                ("sequence_parallel", {"size": size, "impl": impl})]
    context = ModelContext(functools.partial(tl.Llama,
                                             tl.LlamaConfig.tiny()),
                           loss_fn=tl.cross_entropy_loss,
                           sample_batch=np.zeros((2, SEQ), np.int64),
                           devices=["cpu"] * size)
    apply_strategy(context, strategy)
    spec = plan_mesh_spec(context)
    assert spec.sequence == size
    _edit_model(context, spec)
    assert context.model_config().attn_impl == want


def test_quant_allreduce_lowers_as_grad_reduce_bits():
    """quant_allreduce reaches build_trainer as grad_reduce_bits; on one
    device there is no data axis to reduce over, so the steps are the
    exact ones bit for bit (the JAX trainer's rule: no explicit reduce at
    an axis of 1)."""
    def run(strategy):
        result = auto_accelerate(
            functools.partial(tl.Llama, tl.LlamaConfig.tiny(
                attn_impl="reference", dtype=torch.float32)),
            loss_fn=tl.cross_entropy_loss,
            sample_batch=np.zeros((2, SEQ), np.int64), strategy=strategy,
            micro_batch=2, devices=["cpu"])
        state = result.init(0)
        tokens = np.random.default_rng(4).integers(0, 256, (2, SEQ))
        losses = []
        for _ in range(2):
            state, metrics = result.step(
                state, *result.trainer.shard_batch(tokens, tokens))
            losses.append(metrics["loss"].item())
        return result.trainer, losses

    quantized, q_losses = run([("quant_allreduce", {"bits": 8})])
    exact, e_losses = run([])
    assert (quantized.grad_reduce_bits, exact.grad_reduce_bits) == (8, 0)
    assert q_losses == e_losses


def test_entry_point_raises_without_a_gpu_unless_given_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-GPU refusal is moot")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        auto_accelerate(functools.partial(tl.Llama, tl.LlamaConfig.tiny()),
                        sample_batch=np.zeros((1, SEQ), np.int64))


def test_plain_module_without_a_config_trains():
    class Mlp(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = torch.nn.Embedding(64, 32)
            self.proj = torch.nn.Linear(32, 64)

        def forward(self, x):
            return self.proj(self.embed(x))

    result = auto_accelerate(
        Mlp(), loss_fn=tl.cross_entropy_loss,
        sample_batch=np.zeros((2, 8), np.int64), strategy=["half"],
        devices=["cpu"])
    state = result.init(0)
    rows = result.trainer.accum_steps * result.trainer.micro_batch
    tokens = np.ones((rows, 8), np.int64)
    state, metrics = result.step(state, *result.trainer.shard_batch(
        tokens, tokens))
    assert np.isfinite(metrics["loss"].item())


def test_partial_config_support_applies_the_supported_subset():
    @dataclasses.dataclass(frozen=True)
    class MiniCfg:
        dtype: torch.dtype = torch.float32

    class Mini(torch.nn.Module):
        def __init__(self, config, device=None, seed=0):
            super().__init__()
            self.config = config

    ctx = ModelContext(functools.partial(Mini, MiniCfg()), devices=["cpu"])
    assert ctx.replace_model_config(dtype=torch.bfloat16,
                                    remat=True) == ["remat"]
    assert ctx.model_config().dtype == torch.bfloat16
    assert ModelContext(torch.nn.Linear(4, 4), devices=["cpu"]
                        ).replace_model_config(dtype=torch.bfloat16) is None
    # the JAX context answers the same
    jctx = JContext(jl.Llama(jl.LlamaConfig.tiny()),
                    devices=jax.devices("cpu")[:1])
    assert jctx.replace_model_config(dtype=jnp.bfloat16, nope=1) == ["nope"]


def test_a_built_module_is_rebuilt_holding_its_parameters():
    """A config edit on a built module builds the edited model at init,
    with the module's parameters (cast to the new dtype); nothing is
    allocated before init, and the module itself is left as it was."""
    module = tl.Llama(tl.LlamaConfig.tiny(attn_impl="reference"),
                      device="cpu", seed=3)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    result = auto_accelerate(module, loss_fn=tl.cross_entropy_loss,
                             sample_batch=np.zeros((2, SEQ), np.int64),
                             strategy=["half"], devices=["cpu"])
    state = result.init(0)
    got = state.model.state_dict()
    for key, value in before.items():
        assert got[key].dtype == torch.bfloat16
        assert torch.equal(got[key], value.to(torch.bfloat16)), key
        assert torch.equal(module.state_dict()[key], value)
    assert state.model is not module


# ---------------------------------------------------------------------------
# the examples' entry path
# ---------------------------------------------------------------------------


def test_example_strategy_trains_the_loops_own_bits():
    """The nanoGPT example's lowering (``["amp", "module_replace"]``,
    global batch over micro batches of at most 8) gives the trainer the
    loop builds itself: the same (accum, micro) and the same losses and
    grad norms, bit for bit."""
    from dlrover_tpu_torch.examples import nanogpt_train
    from dlrover_tpu_torch.trainer.elastic_loop import (
        ElasticTrainLoop,
        TrainLoopConfig,
    )
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

    cfg = tgpt.GPTConfig.nano(attn_impl="reference")
    adamw = lambda p: torch.optim.AdamW(p, lr=3e-4, betas=(0.9, 0.999),
                                        eps=1e-8, weight_decay=0.1)
    config = lambda: TrainLoopConfig(global_batch=16, seq_len=32,
                                     max_steps=3, report_interval_steps=0)

    def run(**kw):
        loop = ElasticTrainLoop(functools.partial(tgpt.GPT, cfg), adamw,
                                tl.cross_entropy_loss, config(),
                                device="cpu", **kw)
        sampler = ElasticDistributedSampler(dataset_size=10 ** 6, seed=0)
        state, start = loop.restore_or_init(0, sampler)
        data = nanogpt_train.batches(nanogpt_train.synthetic_corpus(256),
                                     sampler, 16, 32)
        _, metrics = loop.run(state, data, start_step=start,
                              sampler=sampler)
        loop.close()
        return (loop.accum, loop.micro_global), [
            (r["loss"], r["grad_norm"]) for r in metrics["history"]]

    result = auto_accelerate(
        functools.partial(tgpt.GPT, tgpt.GPTConfig.nano()),
        optim_factory=lambda: adamw, loss_fn=tl.cross_entropy_loss,
        sample_batch=np.zeros((1, 32), np.int64),
        strategy=["amp", "module_replace"], global_batch=16,
        micro_batch=nanogpt_train.MAX_MICRO, devices=["cpu"])
    assert result.context.model_config() == cfg
    direct = run()
    lowered = run(trainer=result.trainer)
    assert lowered == direct
    assert direct[0] == (2, 8)


def test_streaming_example_resumes_in_process(tmp_path):
    """The port's streaming example on the CPU: its batches are the JAX
    example's; 2 steps saving at 2, then a second call resumes at 2 and
    finishes 4."""
    import importlib.util
    import os

    from dlrover_tpu.trainer.sampler import ElasticDistributedSampler as JS
    from dlrover_tpu_torch.examples import streaming_train
    from dlrover_tpu_torch.trainer.sampler import ElasticDistributedSampler

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_streaming_train", os.path.join(repo, "examples", "streaming",
                                            "train.py"))
    jexample = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jexample)
    got = streaming_train.token_batches(
        1024, ElasticDistributedSampler(dataset_size=10 ** 6, seed=0), 2, 16)
    want = jexample.token_batches(1024, JS(10 ** 6, seed=0), 2, 16)
    for _ in range(2):
        for a, b in zip(next(got), next(want)):
            np.testing.assert_array_equal(a, b)

    log = tmp_path / "log"
    args = ["--device", "cpu", "--seq", "16", "--hidden", "64",
            "--save-interval", "2", "--ckpt-dir", str(tmp_path / "c"),
            "--log-file", str(log)]
    assert streaming_train.main(args + ["--steps", "2"]) == 0
    assert streaming_train.main(args + ["--steps", "4"]) == 0
    lines = log.read_text().splitlines()
    assert lines[0].startswith("streaming: start_step=0 ")
    assert lines[1].startswith("streaming: done step=2 ")
    assert lines[2].startswith("streaming: start_step=2 ")
    assert lines[3].startswith("streaming: done step=4 ")
