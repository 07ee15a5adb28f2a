"""The port's GPT (dlrover_tpu_torch.models.gpt) and the layers it shares
with BERT (models/layers.py) against the JAX package's, on the CPU, with
the JAX parameters carried across by dlrover_tpu_torch.convert.

f32 comparisons hold the algorithm: 1e-4 absolute and relative on
logits of magnitude ~1, as the Llama tests (the same f32 products
summed in another order, a few ulps each). The JAX flash path runs the
Pallas kernel in interpret mode, the port's its plain versions. bf16
comparisons hold the rounding points too: relative L2 within 2^-6 and
every logit within 2^-5 (8 bf16 ulps at 1.0); measured here at most
0.0088 and 0.0117 (GPT tiny and nano, BERT tiny, three seeds each),
because the two frameworks round the bf16 matmuls'
and GELU's results from f32 sums taken in another order.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu.trainer import train_step as jts
from dlrover_tpu_torch import convert
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models import layers
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.trainer import train_step as tts

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL_L2 = 2.0 ** -6
BF16_ATOL = 2.0 ** -5
LR, WD, SEQ, MICRO = 1e-3, 0.1, 32, 2
# GPT at head dim 64, the width of GPT-2 small's heads, at a tiny size
HEAD64 = dict(vocab_size=128, n_embd=128, n_layer=2, n_head=2,
              block_size=64)


def jax_params(module, tokens, seed=0, *args):
    """A flax model's initial parameters as nested dicts of numpy."""
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(tokens),
                            *args)
    return jax.tree.map(np.asarray, nn.unbox(variables["params"]))


def tokens_of(vocab, batch=2, seq=48, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, seq), dtype=np.int32)


def heads_of(cfg):
    """A GPT or BERT config's head count: what ``convert`` permutes the
    fused qkv by."""
    return getattr(cfg, "n_head", None) or cfg.num_heads


def ported(model_cls, cfg, params):
    model = model_cls(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(params, heads_of(cfg)),
                          strict=True)
    return model


def assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL_L2, rel
    assert np.abs(got - want).max() <= BF16_ATOL


def _configs(preset, attn_impl, dtype):
    if preset == "head64":
        return (jgpt.GPTConfig(attn_impl=attn_impl, dtype=dtype[0], **HEAD64),
                tgpt.GPTConfig(attn_impl=attn_impl, dtype=dtype[1], **HEAD64))
    return (getattr(jgpt.GPTConfig, preset)(attn_impl=attn_impl,
                                            dtype=dtype[0]),
            getattr(tgpt.GPTConfig, preset)(attn_impl=attn_impl,
                                            dtype=dtype[1]))


@pytest.mark.parametrize("preset", ["tiny", "nano", "head64"])
@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_logits_and_loss_match_jax_f32(preset, attn_impl):
    jcfg, tcfg = _configs(preset, attn_impl, (jnp.float32, torch.float32))
    tokens = tokens_of(jcfg.vocab_size)
    targets = tokens_of(jcfg.vocab_size, seed=1)
    params = jax_params(jgpt.GPT(jcfg), tokens)
    model = ported(tgpt.GPT, tcfg, params)
    jlogits = jgpt.GPT(jcfg).apply({"params": params}, jnp.asarray(tokens))
    jloss = jllama.cross_entropy_loss(jlogits, jnp.asarray(targets))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
        loss = tllama.cross_entropy_loss(logits, torch.from_numpy(targets))
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 48, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)


@pytest.mark.parametrize("preset", ["tiny", "head64"])
@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_logits_match_jax_bf16(preset, attn_impl):
    jcfg, tcfg = _configs(preset, attn_impl, (jnp.bfloat16, torch.bfloat16))
    tokens = tokens_of(jcfg.vocab_size, seed=2)
    params = jax_params(jgpt.GPT(jcfg), tokens, seed=2)
    model = ported(tgpt.GPT, tcfg, params)
    jlogits = jgpt.GPT(jcfg).apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
    assert logits.dtype == torch.float32
    assert_bf16_close(logits.numpy(), jlogits)


def test_config_matches_jax():
    for preset in ("__call__", "nano", "tiny"):
        jcfg = (jgpt.GPTConfig() if preset == "__call__"
                else getattr(jgpt.GPTConfig, preset)())
        tcfg = (tgpt.GPTConfig() if preset == "__call__"
                else getattr(tgpt.GPTConfig, preset)())
        for field in ("vocab_size", "n_embd", "n_layer", "n_head",
                      "block_size", "attn_impl", "embed_impl", "remat",
                      "remat_policy"):
            assert getattr(tcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("preset", ["gpt2", "nano", "tiny"])
def test_param_count_is_the_jax_leaf_count(preset):
    """GPT-2 small is 124,475,904 parameters in both packages: the port
    counted on ``meta``, JAX from the abstract init."""
    jcfg = jgpt.GPTConfig() if preset == "gpt2" else getattr(
        jgpt.GPTConfig, preset)()
    tcfg = tgpt.GPTConfig() if preset == "gpt2" else getattr(
        tgpt.GPTConfig, preset)()
    shapes = jax.eval_shape(jgpt.GPT(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(nn.unbox(shapes["params"])))
    got = sum(p.numel() for p in tgpt.GPT(tcfg, device="meta").parameters())
    assert got == want
    if preset == "gpt2":
        assert got == 124_475_904


def test_conversion_round_trip_and_names():
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    params = jax_params(jgpt.GPT(jcfg), tokens_of(jcfg.vocab_size), seed=3)
    state = convert.params_from_jax(params, jcfg.n_head)
    model = tgpt.GPT(tgpt.GPTConfig.tiny(), device="cpu")
    assert set(state) == set(model.state_dict())
    for key in ("wte", "wpe", "block_1.qkv.kernel", "block_0.ln1.scale",
                "block_0.proj.bias", "ln_f.bias"):
        assert key in state
    model.load_state_dict(state, strict=True)
    back = convert.params_to_jax(model.state_dict(), jcfg.n_head)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert_head_major(state, params, "block_1", jcfg.n_head)


def assert_head_major(state, params, block, heads):
    """The port's fused qkv kernel and bias hold head h's q, k and v
    columns side by side, where flax's hold [q | k | v]."""
    for leaf in ("kernel", "bias"):
        flax = np.asarray(params[block]["qkv"][leaf])
        width = flax.shape[-1] // 3
        dim = width // heads
        port = state[f"{block}.qkv.{leaf}"].numpy()
        for h in range(heads):
            for j in range(3):
                np.testing.assert_array_equal(
                    port[..., (h * 3 + j) * dim:(h * 3 + j + 1) * dim],
                    flax[..., j * width + h * dim:j * width + (h + 1) * dim])


def test_param_axes_match_the_flax_boxes():
    """Each parameter's logical axes are the ones flax boxes it with;
    the LayerNorm parameters are unboxed there and carry none here."""
    from dlrover_tpu_torch.parallel.sharding import logical_axes

    jcfg = jgpt.GPTConfig.tiny()
    boxed = jax.eval_shape(jgpt.GPT(jcfg).init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 8), jnp.int32))["params"]
    want = {}

    def walk(node, prefix):
        for name, child in node.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(child, nn.Partitioned):
                want[key] = tuple(child.names)
            elif isinstance(child, dict) or hasattr(child, "items"):
                walk(child, key)

    walk(boxed, "")
    got = logical_axes(tgpt.GPT(tgpt.GPTConfig.tiny(), device="meta"))
    assert got == want


@pytest.mark.parametrize("eps", [1e-6, 1e-12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax(eps, dtype):
    rng = np.random.default_rng(6)
    x = (3.0 * rng.standard_normal((4, 10, 96)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(96)).astype(np.float32)
    jdtype = getattr(jnp, dtype)
    want = nn.LayerNorm(epsilon=eps, dtype=jdtype).apply(
        {"params": {"scale": scale, "bias": bias}},
        jnp.asarray(x).astype(jdtype))
    cfg = tgpt.GPTConfig.tiny(dtype=getattr(torch, dtype))
    norm = layers.LayerNorm(96, eps, cfg, "cpu")
    norm.load_state_dict({"scale": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = norm(torch.from_numpy(x).to(cfg.dtype))
    assert got.dtype == cfg.dtype
    assert norm.scale.dtype == norm.bias.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    else:
        # one rounding to bf16 of f32 values a few f32 ulps apart: equal,
        # or one bf16 ulp apart where they straddle a rounding boundary
        g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        assert np.abs(g - w).max() <= 2.0 ** -7 * np.abs(w).max()
        assert (g != w).mean() < 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_flaxs_tanh_form(dtype):
    rng = np.random.default_rng(7)
    x = (4.0 * rng.standard_normal(4096)).astype(np.float32)
    jdtype = getattr(jnp, dtype)
    want = np.asarray(nn.gelu(jnp.asarray(x).astype(jdtype))
                      .astype(jnp.float32))
    got = layers.gelu(torch.from_numpy(x).to(getattr(torch, dtype)))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        np.testing.assert_allclose(got, want, atol=2.0 ** -8, rtol=2.0 ** -7)
    # and not the erf form torch defaults to
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - np.asarray(nn.gelu(jnp.asarray(x)))).max() > 1e-4


def test_dense_adds_the_bias_in_the_compute_dtype():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    kernel = (0.3 * rng.standard_normal((16, 24))).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    want = nn.Dense(24, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": kernel, "bias": bias}},
        jnp.asarray(x).astype(jnp.bfloat16))
    dense = layers.Dense(16, 24, ("embed", "mlp"), tgpt.GPTConfig.tiny(),
                         "cpu", None)
    dense.load_state_dict({"kernel": torch.from_numpy(kernel),
                           "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = dense(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert dense.param_axes == {"kernel": ("embed", "mlp"), "bias": ("mlp",)}
    assert_bf16_close(got.float().numpy(), want.astype(jnp.float32))


def adamw(params):
    return torch.optim.AdamW(params, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WD)


def three_steps_match_jax(jmodel, tmodel_cls, tcfg, jloss_fn, tloss_fn,
                          vocab, accum=2):
    """Three AdamW steps of JAX's build_trainer and the port's from one
    init on the same numpy batches: losses and grad norms within 1e-4,
    every parameter within 2·lr·steps (a sign flip of a near-zero
    gradient's Adam update each step) and all but a few in 100,000
    within 1e-6 (tests/test_torch_train_step.py says why). The key third
    of each qkv bias is held to the first bound only: adding it shifts
    every score of a row by the same amount, which softmax ignores, so
    its gradient is zero but for f32 noise, and Adam turns noise into
    updates of size lr whose sign is the noise's."""
    mesh = create_mesh(MeshSpec(), jax.devices("cpu")[:1])
    jtrainer = jts.build_trainer(
        jmodel, optax.adamw(LR, weight_decay=WD), mesh,
        jnp.zeros((MICRO, SEQ), jnp.int32), jloss_fn, accum_steps=accum,
        micro_batch=MICRO)
    jstate = jtrainer.init(jax.random.PRNGKey(0))
    flat = lambda p: convert.params_from_jax(jax.tree.map(np.asarray, p),
                                             heads_of(tcfg))
    model = tmodel_cls(tcfg, device="cpu")
    model.load_state_dict(flat(jstate.params), strict=True)
    ttrainer = tts.build_trainer(
        model, adamw, None, np.zeros((MICRO, SEQ), np.int64), tloss_fn,
        accum_steps=accum, micro_batch=MICRO, device="cpu")
    tstate = ttrainer.init(0)
    for step in (1, 2, 3):
        rng = np.random.default_rng(step)
        tokens, targets = (rng.integers(0, vocab, (accum * MICRO, SEQ),
                                        dtype=np.int32) for _ in range(2))
        jstate, jm = jtrainer.step(jstate, *jtrainer.shard_batch(tokens,
                                                                 targets))
        tstate, tm = ttrainer.step(tstate, *ttrainer.shard_batch(tokens,
                                                                 targets))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        want, got = flat(jstate.params), tstate.model.state_dict()
        far = total = 0
        for key, w in want.items():
            diff = (got[key] - w).abs()
            assert diff.max().item() <= 2 * LR * step + 1e-6, key
            if key.endswith("qkv.bias"):
                # flax's [q | k | v] order, the key third in the middle
                diff = torch.from_numpy(convert.qkv_to_jax(
                    diff.numpy(), heads_of(tcfg)))
                third = diff.numel() // 3
                diff = torch.cat([diff[:third], diff[2 * third:]])
            far += int((diff > 1e-6).sum())
            total += diff.numel()
        assert far <= 5e-5 * total, (far, total)


def test_three_adamw_steps_match_jax():
    jcfg = jgpt.GPTConfig.tiny(attn_impl="reference", dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(attn_impl="flash", dtype=torch.float32)
    three_steps_match_jax(jgpt.GPT(jcfg), tgpt.GPT, tcfg,
                          jllama.cross_entropy_loss,
                          tllama.cross_entropy_loss, jcfg.vocab_size)


def test_kernel_libraries_follow_the_attention():
    assert tgpt.GPT(tgpt.GPTConfig.tiny(), device="meta"
                    ).kernel_libraries() == ("flash_attention",)
    assert tgpt.GPT(tgpt.GPTConfig.tiny(attn_impl="reference"),
                    device="meta").kernel_libraries() == ()


@pytest.mark.parametrize("option", [
    # an attention no family knows
    (dict(attn_impl="sparse"), ValueError),
    # remat is ported: only a policy name the JAX package does not know
    (dict(remat=True, remat_policy="offload"), ValueError)])
def test_unported_options_raise(option):
    option, error = option
    with pytest.raises(error):
        tgpt.GPT(tgpt.GPTConfig.tiny(**option), device="cpu")


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_sequence_impls_off_mesh_take_the_flash_path(monkeypatch,
                                                     attn_impl):
    """Off-mesh ``"ring"`` and ``"ulysses"`` run the flash attention, where
    the JAX model falls back to the plain attention: logits within the
    f32 tolerance of JAX's."""
    from test_torch_llama import count_flash_calls

    jcfg, tcfg = _configs("tiny", attn_impl, (jnp.float32, torch.float32))
    tokens = tokens_of(jcfg.vocab_size)
    params = jax_params(jgpt.GPT(jcfg), tokens)
    model = ported(tgpt.GPT, tcfg, params)
    assert model.kernel_libraries() == ("flash_attention",)
    calls = count_flash_calls(monkeypatch, tllama)
    jlogits = jgpt.GPT(jcfg).apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
    assert len(calls) == tcfg.n_layer
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_entry_point_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-GPU refusal is moot")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.GPT(tgpt.GPTConfig.tiny())
    # the nanoGPT worker script, without --device cpu
    from dlrover_tpu_torch.examples import nanogpt_train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        nanogpt_train.main(["--steps", "1"])


@pytest.mark.parametrize("spec,exc", [
    (dict(tensor=2), None),                  # whole heads on each rank
    (dict(tensor=4), ValueError),            # n_head 2 over 4 ranks
])
def test_tensor_axis_is_refused(spec, exc):
    """A tensor axis is refused only where it does not divide the heads:
    at tensor 2 the trainer builds (the head-major fused qkv, ROADMAP
    10b), the qkv kernel and bias sharded over their columns as every
    column-parallel leaf is (the ranks' whole heads and the training
    itself: tests/test_torch_tensor_parallel.py)."""
    from dlrover_tpu_torch.parallel import mesh as tmesh
    from dlrover_tpu_torch.parallel.sharding import mesh_placements

    resolved = tmesh.MeshSpec(**spec).with_total_devices(
        tmesh.MeshSpec(**spec).total)
    mesh = tmesh.Mesh(resolved, torch.device("cpu"))
    build = functools.partial(
        tts.build_trainer, functools.partial(tgpt.GPT, tgpt.GPTConfig.tiny()),
        adamw, mesh, np.zeros((MICRO, SEQ)), tllama.cross_entropy_loss,
        micro_batch=MICRO)
    if exc is not None:
        with pytest.raises(exc, match="n_head"):
            build()
        return
    assert build().mesh.shape["tensor"] == 2
    column = mesh.axis_names.index("tensor")
    placements = mesh_placements(
        tgpt.GPT(tgpt.GPTConfig.tiny(), device="meta"), mesh)
    assert str(placements["block_0.qkv.kernel"][column]) == "S(1)"
    assert str(placements["block_0.qkv.bias"][column]) == "S(0)"


FSDP_WORKER = """
import json, sys
import numpy as np
import torch
from dlrover_tpu_torch.agent.elastic_agent import init_distributed
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
from dlrover_tpu_torch.models.llama import cross_entropy_loss
from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from dlrover_tpu_torch.trainer.train_step import build_trainer

torch.set_num_threads(1)
init_distributed("cpu")
batches = np.load(sys.argv[1])
trainer = build_trainer(
    lambda device, seed: GPT(GPTConfig.tiny(dtype=torch.float32),
                             device=device, seed=seed),
    lambda p: torch.optim.AdamW(p, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.1),
    create_mesh(MeshSpec(fsdp=2), "cpu"), np.zeros((4, batches.shape[2])),
    cross_entropy_loss, accum_steps=1, micro_batch=4, device="cpu")
state = trainer.init(0)
losses, norms = [], []
for tokens in batches:
    state, m = trainer.step(state, *trainer.shard_batch(tokens,
                                                        tokens[:, ::-1]))
    losses.append(m["loss"].item())
    norms.append(m["grad_norm"].item())
print(json.dumps({"losses": losses, "grad_norms": norms,
                  "sharded": sorted(n for n, p in
                                    state.model.named_parameters()
                                    if type(p).__name__ == "DTensor")}))
"""


def test_fsdp_two_ranks_match_one_process(tmp_path):
    """GPT tiny at fsdp = 2 on two gloo ranks (FSDP2, the tied ``wte``
    used by the embedding and the head, LayerNorm parameters
    replicated): two steps equal this process's within 1e-4, from the
    same seed-0 init."""
    from test_torch_mesh import run_workers

    rng = np.random.default_rng(9)
    batches = rng.integers(0, 128, (2, 4, SEQ), dtype=np.int32)
    np.save(tmp_path / "batches.npy", batches)
    trainer = tts.build_trainer(
        functools.partial(tgpt.GPT, tgpt.GPTConfig.tiny(dtype=torch.float32)),
        adamw, None, np.zeros((4, SEQ)), tllama.cross_entropy_loss,
        accum_steps=1, micro_batch=4, device="cpu")
    state = trainer.init(0)
    losses, norms = [], []
    for tokens in batches:
        state, m = trainer.step(state, *trainer.shard_batch(
            tokens, tokens[:, ::-1]))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    two = run_workers(tmp_path, FSDP_WORKER, 2,
                      args=(tmp_path / "batches.npy",))
    for r in two:
        assert r["losses"] == two[0]["losses"]
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)
        np.testing.assert_allclose(r["grad_norms"], norms, rtol=1e-4)
        assert "wte" in r["sharded"] and "block_0.qkv.kernel" in r["sharded"]
        assert not any("ln" in n for n in r["sharded"])
