"""The port on an NVIDIA card: the CUDA kernels against their plain
versions, the wrappers' refusals, the launch counters and the model's two
attention paths. Every test is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. This file imports no JAX, so it
also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are those of chip_smoke.py: ``flash_attention.bf16_error``
holds each element of a bf16 output within a few bf16 ulps of its own
magnitude plus a fraction of the reference's RMS, and the whole tensor
within a relative L2 limit, since kernel and plain version round o, P
and dS from f32 sums taken in another order.
"""

import pytest
import torch

from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops.norms import fused_rms_norm

pytestmark = pytest.mark.cuda

# (batch, heads, kv_heads, seq_q, seq_k, head_dim, causal)
SHAPES = [
    (1, 4, 4, 128, 128, 128, True),
    (2, 4, 2, 192, 192, 64, True),
    (1, 4, 1, 100, 100, 64, True),
    (1, 2, 2, 64, 256, 128, True),
    (1, 2, 2, 256, 64, 128, True),
    (2, 8, 8, 512, 1024, 128, True),
    (1, 2, 2, 100, 300, 64, False),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(*shape, gen):
    return torch.randn(*shape, generator=gen, device="cuda").bfloat16()


def _close(name, got, want):
    err = fa.bf16_error(got, want)
    assert fa.bf16_within_tolerance(err), f"{name}: {err}"


@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain(cuda, shape):
    b, h, h_kv, s_q, s_k, d, causal = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, do = _rand(b, h, s_q, d, gen=gen), _rand(b, h, s_q, d, gen=gen)
    k, v = _rand(b, h_kv, s_k, d, gen=gen), _rand(b, h_kv, s_k, d, gen=gen)
    o, lse = fa.flash_fwd(q, k, v, causal)
    po, plse = fa.flash_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    _close("o", o, po)
    assert (lse - plse).abs().max().item() <= 1e-3
    delta = (do.float() * po.float()).sum(-1, keepdim=True)
    dq = fa.flash_bwd_dq(q, k, v, do, plse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, plse, delta, causal)
    torch.cuda.synchronize()
    _close("dq", dq, fa.flash_bwd_dq_plain(q, k, v, do, plse, delta, causal))
    pdk, pdv = fa.flash_bwd_dkv_plain(q, k, v, do, plse, delta, causal)
    _close("dk", dk, pdk)
    _close("dv", dv, pdv)
    if causal and s_k > s_q:
        # keys past the last query get no gradient: their blocks run no
        # q tile and must write zeros, not what is left in shared memory
        assert not dk[:, :, s_q:].any() and not dv[:, :, s_q:].any()


def test_autograd_counts_one_launch_per_kernel(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (_rand(1, 4, 128, 64, gen=gen).requires_grad_()
               for _ in range(3))
    fa.reset_launch_counts()
    fa.flash_attention(q, k, v).float().sum().backward()
    torch.cuda.synchronize()
    assert fa.launch_counts == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                "flash_bwd_dkv": 1}
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


@pytest.mark.parametrize("bad", ["f32", "head_dim_96", "strided"])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, bad):
    q = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    if bad == "f32":
        q, exc = q.float(), TypeError
    elif bad == "head_dim_96":
        q, exc = torch.zeros(1, 2, 64, 96, device=cuda,
                             dtype=torch.bfloat16), ValueError
    else:
        q, exc = q.transpose(1, 2), ValueError
    with pytest.raises(exc):
        fa.flash_fwd(q, q, q)


def test_fused_norm_raises_on_cuda(cuda):
    with pytest.raises(NotImplementedError):
        Llama(LlamaConfig.tiny(norm_impl="fused"), device=cuda)
    with pytest.raises(NotImplementedError):
        fused_rms_norm(torch.ones(4, 8, device=cuda),
                       torch.ones(8, device=cuda))


def test_flash_and_reference_models_agree(cuda):
    """Same seed, same weights: logits through the kernels and through
    plain attention, bf16 activations (logit rounding of a few bf16 ulps
    at magnitude ~1 allows 3e-2)."""
    logits = {}
    tokens = torch.randint(0, 256, (2, 128), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(2))
    for impl in ("flash", "reference"):
        cfg = LlamaConfig(vocab_size=256, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=2,
                          num_kv_heads=1, max_seq_len=128, attn_impl=impl,
                          norm_impl="reference")
        with torch.no_grad():
            logits[impl] = Llama(cfg, device=cuda, seed=0)(tokens)
    err = (logits["flash"] - logits["reference"]).abs().max().item()
    assert err <= 3e-2, err
