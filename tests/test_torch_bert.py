"""The port's BERT (dlrover_tpu_torch.models.bert) against the JAX
package's, on the CPU, with the JAX parameters carried across by
dlrover_tpu_torch.convert. Tolerances and helpers are
tests/test_torch_gpt.py's: f32 logits and losses within 1e-4 absolute
and relative; bf16 logits within 2^-6 relative L2 and 2^-5 per logit.
"""

import functools

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from dlrover_tpu.models import bert as jbert
from dlrover_tpu_torch import convert
from dlrover_tpu_torch.models import bert as tbert
from test_torch_gpt import (
    TOL,
    assert_bf16_close,
    assert_head_major,
    jax_params,
    ported,
    three_steps_match_jax,
    tokens_of,
)

# BERT at head dim 64, the width of BERT-base's heads, at a tiny size
HEAD64 = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
              intermediate_size=256, max_seq_len=64)


def _configs(preset, attn_impl, dtype):
    if preset == "head64":
        return (jbert.BertConfig(attn_impl=attn_impl, dtype=dtype[0],
                                 **HEAD64),
                tbert.BertConfig(attn_impl=attn_impl, dtype=dtype[1],
                                 **HEAD64))
    return (jbert.BertConfig.tiny(attn_impl=attn_impl, dtype=dtype[0]),
            tbert.BertConfig.tiny(attn_impl=attn_impl, dtype=dtype[1]))


def _types(seq, batch=2, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (batch, seq), dtype=np.int32)


@pytest.mark.parametrize("preset", ["tiny", "head64"])
@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
@pytest.mark.parametrize("with_types", [False, True])
def test_logits_and_loss_match_jax_f32(preset, attn_impl, with_types):
    jcfg, tcfg = _configs(preset, attn_impl, (jnp.float32, torch.float32))
    tokens = tokens_of(jcfg.vocab_size)
    targets = tokens_of(jcfg.vocab_size, seed=1)
    types = _types(tokens.shape[1]) if with_types else None
    params = jax_params(jbert.Bert(jcfg), tokens)
    model = ported(tbert.Bert, tcfg, params)
    jlogits = jbert.Bert(jcfg).apply(
        {"params": params}, jnp.asarray(tokens),
        None if types is None else jnp.asarray(types))
    jloss = jbert.mlm_loss(jlogits, jnp.asarray(targets))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long(),
                       None if types is None
                       else torch.from_numpy(types).long())
        loss = tbert.mlm_loss(logits, torch.from_numpy(targets))
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 48, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_logits_match_jax_bf16(attn_impl):
    jcfg, tcfg = _configs("tiny", attn_impl, (jnp.bfloat16, torch.bfloat16))
    tokens = tokens_of(jcfg.vocab_size, seed=2)
    params = jax_params(jbert.Bert(jcfg), tokens, seed=2)
    model = ported(tbert.Bert, tcfg, params)
    jlogits = jbert.Bert(jcfg).apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
    assert_bf16_close(logits.numpy(), jlogits)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_bidirectional_not_causal(attn_impl):
    """Changing the last token changes the logits at earlier positions
    (the JAX package's test_bidirectional_not_causal)."""
    cfg = tbert.BertConfig.tiny(attn_impl=attn_impl, dtype=torch.float32)
    model = tbert.Bert(cfg, device="cpu")
    a = torch.from_numpy(tokens_of(cfg.vocab_size, batch=1, seq=16)).long()
    b = a.clone()
    b[0, -1] = (b[0, -1] + 1) % cfg.vocab_size
    with torch.no_grad():
        la, lb = model(a), model(b)
    assert not torch.allclose(la[0, 0], lb[0, 0])


@pytest.mark.parametrize("weights", ["none", "mask", "zeros"])
def test_mlm_loss_matches_jax(weights):
    rng = np.random.default_rng(11)
    logits = (2 * rng.standard_normal((2, 16, 40))).astype(np.float32)
    targets = rng.integers(0, 40, (2, 16), dtype=np.int32)
    w = {"none": None,
         "mask": (rng.random((2, 16)) < 0.15).astype(np.float32),
         "zeros": np.zeros((2, 16), np.float32)}[weights]
    want = jbert.mlm_loss(jnp.asarray(logits), jnp.asarray(targets),
                          None if w is None else jnp.asarray(w))
    got = tbert.mlm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                         None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)
    if weights == "zeros":
        assert got.item() == 0.0


def test_config_matches_jax():
    for preset in ("base", "tiny"):
        jcfg = getattr(jbert.BertConfig, preset)()
        tcfg = getattr(tbert.BertConfig, preset)()
        assert tcfg.param_count() == jcfg.param_count()
        for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                      "intermediate_size", "max_seq_len", "type_vocab_size",
                      "layer_norm_eps", "attn_impl", "embed_impl", "remat",
                      "remat_policy"):
            assert getattr(tcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("preset", ["base", "tiny"])
def test_param_count_is_the_jax_leaf_count(preset):
    """BERT-base is 109,483,776 parameters in both packages: the port
    counted on ``meta``, JAX from the abstract init. The config's own
    ``param_count`` leaves the biases and norms out, in both."""
    jcfg = getattr(jbert.BertConfig, preset)()
    shapes = jax.eval_shape(jbert.Bert(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(nn.unbox(shapes["params"])))
    got = sum(p.numel() for p in tbert.Bert(
        getattr(tbert.BertConfig, preset)(), device="meta").parameters())
    assert got == want
    if preset == "base":
        assert got == 109_483_776


def test_conversion_round_trip_and_names():
    jcfg = jbert.BertConfig.tiny(dtype=jnp.float32)
    params = jax_params(jbert.Bert(jcfg), tokens_of(jcfg.vocab_size),
                        3, jnp.asarray(_types(48)))
    state = convert.params_from_jax(params, jcfg.num_heads)
    model = tbert.Bert(tbert.BertConfig.tiny(), device="cpu")
    assert set(state) == set(model.state_dict())
    for key in ("word_embed", "pos_embed", "type_embed", "embed_norm.scale",
                "layer_0.attn_norm.bias", "layer_1.qkv.kernel",
                "mlm_transform.kernel", "mlm_norm.bias"):
        assert key in state
    model.load_state_dict(state, strict=True)
    back = convert.params_to_jax(model.state_dict(), jcfg.num_heads)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert_head_major(state, params, "layer_1", jcfg.num_heads)


def test_three_adamw_steps_match_jax():
    """Through the port's build_trainer against JAX's with optax.adamw:
    also the token-type table, which the loss never reaches and which
    both decay (a zero gradient in both, as jax.grad gives it)."""
    jcfg = jbert.BertConfig.tiny(attn_impl="reference", dtype=jnp.float32)
    tcfg = tbert.BertConfig.tiny(attn_impl="flash", dtype=torch.float32)
    three_steps_match_jax(jbert.Bert(jcfg), tbert.Bert, tcfg,
                          jbert.mlm_loss, tbert.mlm_loss, jcfg.vocab_size)


@pytest.mark.parametrize("option", [
    # an attention no family knows
    (dict(attn_impl="sparse"), ValueError),
    # remat is ported: only a policy name the JAX package does not know
    (dict(remat=True, remat_policy="offload"), ValueError)])
def test_unported_options_raise(option):
    option, error = option
    with pytest.raises(error):
        tbert.Bert(tbert.BertConfig.tiny(**option), device="cpu")


@pytest.mark.parametrize("attn_impl", ["ring", "ulysses"])
def test_sequence_impls_off_mesh_take_the_flash_path(monkeypatch,
                                                     attn_impl):
    """Off-mesh ``"ring"`` and ``"ulysses"`` run the flash attention
    without the mask, where the JAX model falls back to the plain
    attention: logits within the f32 tolerance of JAX's."""
    from dlrover_tpu_torch.models import llama as tllama
    from test_torch_llama import count_flash_calls

    jcfg, tcfg = _configs("tiny", attn_impl, (jnp.float32, torch.float32))
    tokens = tokens_of(jcfg.vocab_size)
    params = jax_params(jbert.Bert(jcfg), tokens)
    model = ported(tbert.Bert, tcfg, params)
    calls = count_flash_calls(monkeypatch, tllama)
    jlogits = jbert.Bert(jcfg).apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
    assert len(calls) == tcfg.num_layers
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_entry_point_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-GPU refusal is moot")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbert.Bert(tbert.BertConfig.tiny())


def test_tensor_axis_is_refused():
    """A tensor axis is refused only where it does not divide the heads:
    tensor 2 builds (the head-major fused qkv, ROADMAP 10b; the training
    itself: tests/test_torch_tensor_parallel.py), tensor 4 over BERT
    tiny's 2 heads raises."""
    from dlrover_tpu_torch.parallel import mesh as tmesh
    from dlrover_tpu_torch.trainer import train_step as tts

    def build(ways):
        spec = tmesh.MeshSpec(tensor=ways).with_total_devices(ways)
        return tts.build_trainer(
            functools.partial(tbert.Bert, tbert.BertConfig.tiny()),
            functools.partial(torch.optim.AdamW, lr=1e-3),
            tmesh.Mesh(spec, torch.device("cpu")), np.zeros((2, 16)),
            tbert.mlm_loss, micro_batch=2)

    assert build(2).mesh.shape["tensor"] == 2
    with pytest.raises(ValueError, match="num_heads"):
        build(4)
