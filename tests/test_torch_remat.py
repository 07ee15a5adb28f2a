"""Rematerialization (dlrover_tpu_torch/ops/remat.py) in the three model
families, against remat=False and against the JAX families with
remat=True, on the CPU.

Every policy name of the JAX package recomputes the same arithmetic the
forward ran, so the loss and every gradient equal remat=False's bit for
bit. Against JAX (f32, plain attention and norms, the same parameters
carried across) they agree within 1e-4 absolute and relative, the
families' own f32 tolerance (the same products summed in another
order). Which matmuls a policy keeps is counted at the dispatcher: the
full policy runs the blocks' matmuls again in the backward, the dots
policies do not (``dots_with_no_batch_dims`` recomputes the batched
attention products).
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dlrover_tpu.models import bert as jbert
from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.ops.remat import resolve_remat_policy as j_resolve
from dlrover_tpu_torch import convert
from dlrover_tpu_torch.models import bert as tbert
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.ops.remat import POLICIES, resolve_remat_policy

TOL = dict(atol=1e-4, rtol=1e-4)
BATCH, SEQ = 2, 32


def _family(name):
    """(JAX config class, JAX model, JAX loss, port config class, port
    model, port loss, config kwargs)."""
    if name == "llama":
        return (jllama.LlamaConfig.tiny, jllama.Llama,
                jllama.cross_entropy_loss, tllama.LlamaConfig.tiny,
                tllama.Llama, tllama.cross_entropy_loss,
                dict(attn_impl="reference", norm_impl="reference"))
    if name == "gpt":
        return (jgpt.GPTConfig.tiny, jgpt.GPT, jllama.cross_entropy_loss,
                tgpt.GPTConfig.tiny, tgpt.GPT, tllama.cross_entropy_loss,
                dict(attn_impl="reference"))
    return (jbert.BertConfig.tiny, jbert.Bert, jbert.mlm_loss,
            tbert.BertConfig.tiny, tbert.Bert, tbert.mlm_loss,
            dict(attn_impl="reference"))


def _heads(cfg):
    """The head count ``convert`` permutes GPT's and BERT's head-major
    fused qkv by (the Llama holds none)."""
    return getattr(cfg, "n_head", None) or cfg.num_heads


def _batch(vocab):
    rng = np.random.default_rng(4)
    return (rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32),
            rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32))


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    """The JAX family with remat=True: (params as numpy, loss, grads by
    port name)."""
    jcfg_of, jmodel_cls, jloss_fn, *_, kw = _family(name)
    jcfg = jcfg_of(dtype=jnp.float32, remat=True,
                   remat_policy="nothing_saveable", **kw)
    tokens, targets = _batch(jcfg.vocab_size)
    model = jmodel_cls(jcfg)
    params = jax.tree.map(np.asarray, nn.unbox(model.init(
        jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]))

    def loss_fn(p):
        return jloss_fn(model.apply({"params": p}, jnp.asarray(tokens)),
                        jnp.asarray(targets))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return (params, float(loss),
            convert.params_from_jax(jax.tree.map(np.asarray, grads),
                                    _heads(jcfg)))


def _port_grads(name, params, **cfg_kw):
    *_, tcfg_of, tmodel_cls, tloss_fn, kw = _family(name)
    cfg = tcfg_of(dtype=torch.float32, **kw, **cfg_kw)
    model = tmodel_cls(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(params, _heads(cfg)),
                          strict=True)
    tokens, targets = _batch(cfg.vocab_size)
    loss = tloss_fn(model(torch.from_numpy(tokens).long()),
                    torch.from_numpy(targets).long())
    loss.backward()
    # BERT's type_embed without token types: jax.grad gives it zeros
    return loss.detach(), {n: torch.zeros_like(p) if p.grad is None
                           else p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("name", ["llama", "gpt", "bert"])
def test_remat_equals_no_remat_and_jax(name, policy):
    params, jloss, jgrads = _jax_reference(name)
    loss0, grads0 = _port_grads(name, params)
    loss, grads = _port_grads(name, params, remat=True, remat_policy=policy)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys() == jgrads.keys()
    for n in grads:
        assert torch.equal(grads[n], grads0[n]), n
        np.testing.assert_allclose(grads[n].numpy(), jgrads[n].numpy(),
                                   err_msg=n, **TOL)
    np.testing.assert_allclose(loss.item(), jloss, **TOL)


def test_policy_names_and_refusal_follow_jax():
    assert set(POLICIES) == {"", "full", "nothing_saveable", "dots",
                             "dots_saveable", "dots_with_no_batch_dims"}
    for name in POLICIES:
        j_resolve(name)
        resolve_remat_policy(name)
    for bad in ("offload", "everything_saveable"):
        with pytest.raises(ValueError):
            j_resolve(bad)
        with pytest.raises(ValueError, match="unknown remat policy"):
            resolve_remat_policy(bad)
        with pytest.raises(ValueError, match="unknown remat policy"):
            tllama.Llama(tllama.LlamaConfig.tiny(remat=True,
                                                 remat_policy=bad),
                         device="cpu")


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func.overloadpacket
        if packet in (torch.ops.aten.mm, torch.ops.aten.addmm):
            self.counts["mm"] += 1
        elif packet in (torch.ops.aten.bmm, torch.ops.aten.baddbmm):
            self.counts["bmm"] += 1
        return func(*args, **(kwargs or {}))


def _matmuls(**cfg_kw):
    cfg = tllama.LlamaConfig.tiny(attn_impl="reference",
                                  norm_impl="reference",
                                  dtype=torch.float32, **cfg_kw)
    model = tllama.Llama(cfg, device="cpu")
    tokens, targets = _batch(cfg.vocab_size)
    with _CountMatmuls() as mode:
        tllama.cross_entropy_loss(
            model(torch.from_numpy(tokens).long()),
            torch.from_numpy(targets).long()).backward()
    return mode.counts


def test_policies_keep_the_matmuls_they_name():
    none = _matmuls()
    full = _matmuls(remat=True, remat_policy="full")
    dots = _matmuls(remat=True, remat_policy="dots_saveable")
    flat = _matmuls(remat=True, remat_policy="dots_with_no_batch_dims")
    # per block: 2 attention products and 6 of the 7 projections run
    # again; non-reentrant checkpointing stops recomputing once every
    # tensor the backward saved is back, before down_proj, whose output
    # nothing saves
    layers = tllama.LlamaConfig.tiny().num_layers
    assert full == {"mm": none["mm"] + 6 * layers,
                    "bmm": none["bmm"] + 2 * layers}
    assert dots == none
    assert flat == {"mm": none["mm"], "bmm": none["bmm"] + 2 * layers}
