"""The port's Llama (dlrover_tpu_torch.models.llama) against the JAX
package's, on the CPU, with the JAX parameters carried across by
dlrover_tpu_torch.convert.

Both sides run in f32 (dtype=float32) so the comparison is of the
algorithm, not of bf16 rounding. Tolerance 1e-4 absolute and relative on
logits of magnitude ~1: the two frameworks sum the same f32 products in
another order through two decoder layers, a few ulps (1e-7) each.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch import convert
from dlrover_tpu_torch.models import llama as tllama

TOL = dict(atol=1e-4, rtol=1e-4)


def _jax_params(jcfg, tokens, seed=0):
    variables = jllama.Llama(jcfg).init(jax.random.PRNGKey(seed),
                                        jnp.asarray(tokens))
    return jax.tree.map(np.asarray, nn.unbox(variables["params"]))


def _tokens(vocab, batch=2, seq=48, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, seq), dtype=np.int32)


@pytest.mark.parametrize("attn_impl", ["flash", "reference"])
def test_tiny_logits_and_loss_match_jax(attn_impl):
    jcfg = jllama.LlamaConfig.tiny(attn_impl=attn_impl, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(attn_impl=attn_impl, dtype=torch.float32)
    tokens = _tokens(jcfg.vocab_size)
    targets = _tokens(jcfg.vocab_size, seed=1)
    params = _jax_params(jcfg, tokens)

    model = tllama.Llama(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(params), strict=True)

    jlogits = jllama.Llama(jcfg).apply({"params": params},
                                       jnp.asarray(tokens))
    jloss = jllama.cross_entropy_loss(jlogits, jnp.asarray(targets))
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens).long())
        loss = tllama.cross_entropy_loss(logits,
                                         torch.from_numpy(targets))
    assert logits.dtype == torch.float32
    assert logits.shape == (2, 48, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)


@pytest.mark.parametrize("preset", ["tiny", "llama_410m", "llama_1b",
                                    "llama_wide_1b", "llama_7b"])
def test_param_count_and_flops_match(preset):
    jcfg = getattr(jllama.LlamaConfig, preset)()
    tcfg = getattr(tllama.LlamaConfig, preset)()
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.flops_per_token() == jcfg.flops_per_token()
    for field in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_layers", "num_heads", "num_kv_heads", "max_seq_len",
                  "rope_theta", "rms_norm_eps", "attn_impl", "embed_impl",
                  "norm_impl", "remat", "tie_embeddings"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


def test_tiny_param_count_is_the_model_size():
    cfg = tllama.LlamaConfig.tiny()
    model = tllama.Llama(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()


def test_conversion_round_trip_and_names():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    params = _jax_params(jcfg, _tokens(jcfg.vocab_size), seed=3)
    state = convert.params_from_jax(params)
    model = tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu")
    assert set(state) == set(model.state_dict())
    assert "layer_1.attn.q_proj.kernel" in state
    back = convert.params_to_jax(state)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    # and from the port's own state_dict
    again = convert.params_from_jax(convert.params_to_jax(
        model.state_dict()))
    for key, value in model.state_dict().items():
        torch.testing.assert_close(again[key], value, rtol=0, atol=0)


def test_rope_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 4, 32), np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    want = jllama.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tllama.apply_rope(torch.from_numpy(x), torch.from_numpy(
        np.ascontiguousarray(pos)), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("impl", ["onehot", "gather"])
def test_embed_lookup_matches_jax(impl):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((64, 16), np.float32)
    tokens = rng.integers(0, 64, (2, 10))
    jcfg = jllama.LlamaConfig.tiny(embed_impl=impl, vocab_size=64)
    tcfg = tllama.LlamaConfig.tiny(embed_impl=impl, vocab_size=64)
    want = jllama.embed_lookup(jnp.asarray(table), jnp.asarray(tokens),
                               jcfg)
    got = tllama.embed_lookup(torch.from_numpy(table),
                              torch.from_numpy(tokens), tcfg)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("option", [
    dict(attn_impl="ring"), dict(attn_impl="ulysses"), dict(remat=True)])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError):
        tllama.Llama(tllama.LlamaConfig.tiny(**option), device="cpu")
