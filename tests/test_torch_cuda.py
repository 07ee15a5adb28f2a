"""The port on an NVIDIA card: the CUDA kernels against their plain
versions, the wrappers' refusals, the launch counters and the model's
attention and norm paths. Every test is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false. This file imports no JAX, so it
also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are those of chip_smoke.py: ``flash_attention.bf16_error``
holds each element of a bf16 output within a few bf16 ulps of its own
magnitude plus a fraction of the reference's RMS, and the whole tensor
within a relative L2 limit, since kernel and plain version round o, P
and dS (or y and dx) from f32 sums taken in another order;
``norms.f32_error`` holds f32 outputs (rstd, dw) within 1e-5 of the
reference's RMS plus their own size. Quantization is bit for bit.
"""

import pytest
import torch

from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import norms
from dlrover_tpu_torch.ops import quantization as quant

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
    # the wgmma kernels' 128-row tiles: one row past a tile, GQA across
    # several tiles, ragged s_q < s_k and s_q > s_k, MQA one tile
    (1, 4, 4, 129, 129, 128, True),
    (2, 8, 2, 320, 320, 128, True),
    (1, 4, 4, 200, 456, 64, True),
    (1, 4, 4, 456, 200, 128, True),
    (1, 4, 1, 64, 64, 64, False),
    # dQ with s_q not a multiple of 64 and GQA over two kv tiles
    (1, 8, 2, 200, 200, 128, True),
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


def test_fwd_dq_and_dkv_are_bitwise_deterministic(cuda):
    """o, dQ, dK and dV are the same bits in two calls: the dQ block sums
    its kv tiles and the dK/dV block its GQA group in registers, in a
    fixed order, with no atomics (GQA, causal, ragged)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, do = _rand(2, 8, 320, 128, gen=gen), _rand(2, 8, 320, 128, gen=gen)
    k, v = _rand(2, 2, 320, 128, gen=gen), _rand(2, 2, 320, 128, gen=gen)
    (o1, lse1), (o2, lse2) = (fa.flash_fwd(q, k, v) for _ in range(2))
    delta = (do.float() * o1.float()).sum(-1, keepdim=True)
    dq1, dq2 = (fa.flash_bwd_dq(q, k, v, do, lse1, delta) for _ in range(2))
    (dk1, dv1), (dk2, dv2) = (fa.flash_bwd_dkv(q, k, v, do, lse1, delta)
                              for _ in range(2))
    torch.cuda.synchronize()
    for a, b in ((o1, o2), (lse1, lse2), (dq1, dq2), (dk1, dk2),
                 (dv1, dv2)):
        assert torch.equal(a, b)


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


# (rows, dim, dtype): ragged rows, narrow and wide rows, a dim that is
# not a multiple of 8, f32, and rows that need 2 and 4 chunks a thread
NORM_SHAPES = [
    (1000, 2048, torch.bfloat16),
    (4096, 64, torch.bfloat16),
    (512, 4096, torch.bfloat16),
    (300, 100, torch.bfloat16),
    (1000, 2048, torch.float32),
    (64, 12288, torch.bfloat16),
    (16, 30000, torch.float32),
]
EPS = 1e-5


def _norm_inputs(rows, dim, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (2 * torch.randn(rows, dim, generator=gen, device="cuda")).to(dtype)
    w = 0.5 + torch.rand(dim, generator=gen, device="cuda")
    g = torch.randn(rows, dim, generator=gen, device="cuda").to(dtype)
    return x, w, g


def _norm_close(name, got, want):
    if got.dtype == torch.bfloat16:
        _close(name, got, want)
    else:
        err = norms.f32_error(got, want)
        assert err["worst"] <= 1.0, f"{name}: {err}"


@pytest.mark.parametrize("shape", NORM_SHAPES,
                         ids=[f"{r}x{d}-{str(t)[6:]}" for r, d, t in
                              NORM_SHAPES])
def test_norm_kernels_match_plain(cuda, shape):
    x, w, g = _norm_inputs(*shape, seed=3)
    y, rstd = norms.rms_fwd(x, w, EPS)
    py, prstd = norms.rms_fwd_plain(x, w, EPS)
    torch.cuda.synchronize()
    _norm_close("y", y, py)
    _norm_close("rstd", rstd, prstd)
    dx, dw = norms.rms_bwd(x, w, prstd, g)
    pdx, pdw = norms.rms_bwd_plain(x, w, prstd, g)
    torch.cuda.synchronize()
    _norm_close("dx", dx, pdx)
    _norm_close("dw", dw, pdw)


def test_norm_dw_is_bitwise_deterministic(cuda):
    x, w, g = _norm_inputs(8192, 2048, torch.bfloat16, seed=4)
    _, rstd = norms.rms_fwd(x, w, EPS)
    first = norms.rms_bwd(x, w, rstd, g)
    second = norms.rms_bwd(x, w, rstd, g)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[0], second[0])


def test_norm_autograd_counts_one_launch_each(cuda):
    x, w, g = _norm_inputs(4 * 128, 256, torch.bfloat16, seed=5)
    x = x.view(4, 128, 256).clone().requires_grad_()
    w.requires_grad_()
    norms.reset_launch_counts()
    norms.fused_rms_norm(x, w, EPS).backward(g.view(4, 128, 256))
    torch.cuda.synchronize()
    assert norms.launch_counts == {"rms_fwd": 1, "rms_bwd": 1}
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()


def _quant_input(rows, cols, group, seed, dtype=torch.float32):
    """Groups of very different sizes, an all-zero group and two tie
    groups (absmax 127/8 and 7/8, values (k+½)/8) in row 0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, cols, generator=gen, device="cuda")
    x *= 10.0 ** (4 * torch.rand(rows, 1, generator=gen, device="cuda") - 3)
    x[0, :group] = 0
    for i, qmax in ((1, 127), (2, 7)):
        k = torch.arange(group - 1, device="cuda")
        half = (k % qmax + 0.5) / 8
        x[0, i * group] = qmax / 8
        x[0, i * group + 1:(i + 1) * group] = torch.where(k % 2 == 1, -half,
                                                          half)
    return x.to(dtype)


@pytest.mark.parametrize("bits,group,dtype", [
    (8, 128, torch.float32), (4, 128, torch.float32),
    (8, 128, torch.bfloat16), (8, 8, torch.float32), (4, 8, torch.bfloat16),
    (8, 96, torch.float32), (8, 6, torch.float32), (4, 6, torch.bfloat16)])
def test_quantization_kernels_match_plain_bitwise(cuda, bits, group, dtype):
    x = _quant_input(512, 768, group, seed=6, dtype=dtype)
    qmax = 127 if bits == 8 else 7
    q, s = quant.quantize_rows(x.reshape(-1, group), qmax)
    pq, ps = quant.quantize_plain(x.reshape(-1, group), qmax)
    torch.cuda.synchronize()
    assert torch.equal(q, pq) and torch.equal(s, ps)
    for out in (torch.float32, torch.bfloat16):
        got = quant.dequantize_rows(q, s, out)
        torch.cuda.synchronize()
        assert torch.equal(got, quant.dequantize_plain(pq, ps, out))


def test_quantization_api_matches_its_cpu_run(cuda):
    """The public functions on the card (kernels) and on the CPU (plain
    versions through the same packing, swizzle and sum code) agree bit
    for bit."""
    x = _quant_input(256, 1024, 128, seed=7)
    chunks = torch.stack([_quant_input(256, 1024, 128, seed=8 + i)
                          for i in range(4)])
    quant.reset_launch_counts()
    for bits in (8, 4):
        got, want = (quant.quantize(t, bits) for t in (x, x.cpu()))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
        assert torch.equal(quant.dequantize(*got, bits).cpu(),
                           quant.dequantize(*want, bits))
        sq = quant.swizzled_quantize(x, 4, bits)
        assert torch.equal(
            quant.unswizzle_dequantize(*sq, x.shape, bits).cpu(),
            quant.unswizzle_dequantize(sq[0].cpu(), sq[1].cpu(), x.shape,
                                       bits))
        qs = [quant.quantize(c, bits) for c in chunks]
        qs, ss = torch.stack([a for a, _ in qs]), torch.stack(
            [b for _, b in qs])
        got = quant.quant_reduce(qs, ss, bits)
        want = quant.quant_reduce(qs.cpu(), ss.cpu(), bits)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert min(quant.launch_counts.values()) > 0


@pytest.mark.parametrize("bad", ["f64", "f16", "strided"])
def test_norm_and_quantization_wrappers_refuse(cuda, bad):
    x = torch.zeros(64, 128, device=cuda)
    w = torch.ones(128, device=cuda)
    if bad == "f64":
        x, exc = x.double(), TypeError
    elif bad == "f16":
        x, exc = x.half(), TypeError
    else:
        x, exc = torch.zeros(128, 64, device=cuda).t(), ValueError
    with pytest.raises(exc):
        norms.rms_fwd(x, w, EPS)
    with pytest.raises(exc):
        norms.rms_bwd(x, w, torch.ones(64, 1, device=cuda), x)
    with pytest.raises(exc):
        quant.quantize_rows(x, 127)
    if bad != "strided":
        with pytest.raises(TypeError):
            norms.rms_fwd(x.float(), w.to(x.dtype), EPS)
        with pytest.raises(TypeError):
            quant.dequantize_rows(torch.zeros(64, 128, dtype=torch.int8,
                                              device=cuda),
                                  torch.ones(64, 1, device=cuda), x.dtype)


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


def test_fused_and_reference_norm_models_agree(cuda):
    """The default configuration (norm_impl="fused") runs on the card,
    through the norm kernels, and gives the plain norm's logits (same
    3e-2 as above: y differs from the plain norm's by at most a bf16
    rounding)."""
    tokens = torch.randint(0, 256, (2, 128), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(2))
    logits = {}
    norms.reset_launch_counts()
    for impl in ("fused", "reference"):
        cfg = LlamaConfig(vocab_size=256, hidden_size=256,
                          intermediate_size=512, num_layers=2, num_heads=2,
                          num_kv_heads=1, max_seq_len=128, norm_impl=impl)
        with torch.no_grad():
            logits[impl] = Llama(cfg, device=cuda, seed=0)(tokens)
    assert norms.launch_counts == {"rms_fwd": 5, "rms_bwd": 0}
    err = (logits["fused"] - logits["reference"]).abs().max().item()
    assert err <= 3e-2, err


# ---------------------------------------------------------------------------
# the checkpoint path on the card
# ---------------------------------------------------------------------------


def test_checkpoint_codec_on_the_card_matches_its_cpu_path(cuda):
    """encode_tree / decode_tree launch the kernels for CUDA leaves and
    give the bits of the same codec on the CPU (the plain versions):
    rows, a flat leaf, a raw one, int8 and int4."""
    from dlrover_tpu_torch.checkpoint import quantized as cq

    gen = torch.Generator(device=cuda).manual_seed(9)
    leaves = {"row": _quant_input(256, 768, 128, seed=9),
              "flat": torch.randn(7, 77, generator=gen, device=cuda),
              "raw": torch.randn(50, generator=gen, device=cuda)}
    for bits in (8, 4):
        quant.reset_launch_counts()
        got = cq.encode_tree(leaves, bits)
        want = cq.encode_tree({k: v.cpu() for k, v in leaves.items()}, bits)
        assert quant.launch_counts["quantize"] == 2
        for name in ("row", "flat"):
            for key in ("q", "s"):
                assert torch.equal(got[name][key].cpu(), want[name][key])
        back = cq.decode_tree(got, leaves, bits)
        assert quant.launch_counts["dequantize"] == 2
        cpu_back = cq.decode_tree(want, {k: v.cpu() for k, v in
                                         leaves.items()}, bits)
        for name in leaves:
            assert back[name].device.type == "cuda"
            assert torch.equal(back[name].cpu(), cpu_back[name])


def _two_layer_trainer(cuda, **kw):
    import dataclasses
    import functools

    import numpy as np

    from dlrover_tpu_torch.models.llama import cross_entropy_loss
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    cfg = dataclasses.replace(LlamaConfig.llama_1b(
        max_seq_len=512, embed_impl="gather"), num_layers=2)
    return build_trainer(
        functools.partial(Llama, cfg),
        lambda p: torch.optim.AdamW(p, lr=3e-4, weight_decay=0.1), None,
        np.zeros((2, 512)), cross_entropy_loss, micro_batch=2, **kw), cfg


def _tokens(cfg, seed):
    import numpy as np

    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 512))
    return t, np.roll(t, -1, axis=1)


def test_two_layer_full_width_round_trip_gives_the_same_bits(cuda,
                                                             tmp_path):
    """A 2-layer Llama at full width (hidden 2048), saved after a step and
    restored into the trainer's abstract state on the card: the
    parameters and moments are the same bits, and the next step's loss
    and grad norm equal the uninterrupted run's."""
    from dlrover_tpu_torch.checkpoint.flash_checkpoint import (
        FlashCheckpointer,
    )

    trainer, cfg = _two_layer_trainer(cuda)
    state = trainer.init(0)
    state, _ = trainer.step(state, *trainer.shard_batch(*_tokens(cfg, 0)))
    with FlashCheckpointer(str(tmp_path / "c"),
                           save_interval_steps=1) as ckpt:
        assert ckpt.maybe_save(1, state, {"pos": 2})
        ckpt.wait()
        restored, data, step = ckpt.restore(trainer.abstract_state())
    assert step == 1 and data == {"pos": 2}
    for (name, a), b in zip(state.model.named_parameters(),
                            restored.model.parameters()):
        assert b.device.type == "cuda" and torch.equal(a, b), name
        sa, sb = state.optimizer.state[a], restored.optimizer.state[b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    batch = trainer.shard_batch(*_tokens(cfg, 1))
    _, want = trainer.step(state, *batch)
    _, got = trainer.step(restored, *batch)
    assert got["loss"].item() == want["loss"].item()
    assert got["grad_norm"].item() == want["grad_norm"].item()


def test_offloaded_moments_live_in_pinned_host_memory(cuda):
    """offload_opt_state keeps AdamW's moments in pinned host memory
    between steps (one buffer each, reused) and gives the same losses as
    the moments on the card."""
    want_trainer, cfg = _two_layer_trainer(cuda)
    trainer, _ = _two_layer_trainer(cuda, offload_opt_state=True)
    state, want_state = trainer.init(0), want_trainer.init(0)
    buffers = None
    for seed in range(3):
        batch = _tokens(cfg, seed)
        state, got = trainer.step(state, *trainer.shard_batch(*batch))
        want_state, want = want_trainer.step(
            want_state, *want_trainer.shard_batch(*batch))
        assert got["loss"].item() == want["loss"].item()
        moments = [v for s in state.optimizer.state.values()
                   for v in s.values() if v.ndim > 0]
        assert all(v.device.type == "cpu" and v.is_pinned()
                   for v in moments)
        ptrs = sorted(v.data_ptr() for v in moments)
        assert buffers is None or ptrs == buffers
        buffers = ptrs
