"""The port on an NVIDIA card: the CUDA kernels against their plain
versions, the wrappers' refusals, the launch counters, the model's
attention and norm paths, the checkpoint on the card, and what the
master observes of it (the allocator telemetry, a profiler capture
naming the kernels, an agent that never opens the card), a worker on
the card training through a standby's promotion, the kernels under
remat, the streaming step and the device prefetch, the MoE model's
kernels, the pipelined trainer's, the elastic embedding step
against its CPU run, auto_accelerate's lowering to the kernels, the
search's dry runs giving the card back, the coworker ring's batches
under the checksum op, and two ranks sharing the card in a gloo group
(the ring and Ulysses over the flash kernels, the quantized mean's
kernels). Every test is marked
``cuda`` and skips where
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

from dlrover_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    cross_entropy_loss,
)
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


@pytest.mark.parametrize("bad", ["f32", "head_dim_160", "strided"])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda, bad):
    q = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    if bad == "f32":
        q, exc = q.float(), TypeError
    elif bad == "head_dim_160":
        # up to 128 a head dim is padded to the kernels' (see
        # test_padded_head_dims_match_plain); above, it raises
        q, exc = torch.zeros(1, 2, 64, 160, device=cuda,
                             dtype=torch.bfloat16), ValueError
    else:
        q, exc = q.transpose(1, 2), ValueError
    with pytest.raises(exc):
        fa.flash_fwd(q, q, q)


# the flash kernels as GPT-2 small (micro 12, seq 1024, causal) and
# BERT-base (micro 32, seq 512, bidirectional) call them, head dim 64,
# and as each rank calls them over a tensor axis of 2 (6 of 12 heads)
MODEL_SHAPES = [
    (12, 12, 12, 1024, 1024, 64, True),
    (32, 12, 12, 512, 512, 64, False),
    (12, 6, 6, 1024, 1024, 64, True),
    (32, 6, 6, 512, 512, 64, False),
]
# head dims the kernels reach by zero-padding to 64 or 128
PADDED_SHAPES = [
    (1, 4, 2, 200, 200, 16, True),
    (2, 4, 4, 130, 130, 32, False),
    (1, 4, 4, 256, 320, 96, True),
]


@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=["gpt2", "bert", "gpt2_tp2", "bert_tp2"])
def test_kernels_match_plain_at_the_model_shapes(cuda, shape):
    test_kernels_match_plain(cuda, shape)


@pytest.mark.parametrize("shape", PADDED_SHAPES, ids=["d16", "d32", "d96"])
def test_padded_head_dims_match_plain(cuda, shape):
    """A head dim the kernels are not built for runs them on zero-padded
    inputs: the outputs keep the true head dim, match the plain versions
    and each wrapper call launches its kernel once."""
    fa.reset_launch_counts()
    test_kernels_match_plain(cuda, shape)
    assert fa.launch_counts == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                "flash_bwd_dkv": 1}


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
# remat, the streaming step and the prefetch on the card
# ---------------------------------------------------------------------------


def _small_llama(**kw):
    return LlamaConfig(vocab_size=256, hidden_size=256,
                       intermediate_size=512, num_layers=2, num_heads=2,
                       num_kv_heads=1, max_seq_len=256, embed_impl="gather",
                       **kw)


def _launches():
    return {**fa.launch_counts, **norms.launch_counts}


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable",
                                    "dots_with_no_batch_dims"])
def test_remat_runs_the_forward_kernels_again_for_the_same_gradients(
        cuda, policy):
    """Under every policy the blocks' forward kernels launch again in the
    backward (flash_fwd 2 a layer, rms_fwd 4 a layer + 1) and the
    gradients are remat=False's bits: the kernels are deterministic."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    tokens, targets = (torch.randint(0, 256, (2, 256), device=cuda,
                                     generator=gen) for _ in range(2))
    grads, launches = {}, {}
    for remat in (False, True):
        model = Llama(_small_llama(remat=remat, remat_policy=policy),
                      device=cuda, seed=0)
        fa.reset_launch_counts()
        norms.reset_launch_counts()
        cross_entropy_loss(model(tokens), targets).backward()
        torch.cuda.synchronize()
        launches[remat] = _launches()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    layers = 2
    assert launches[False] == {"flash_fwd": layers, "flash_bwd_dq": layers,
                               "flash_bwd_dkv": layers,
                               "rms_fwd": 2 * layers + 1,
                               "rms_bwd": 2 * layers + 1}
    assert launches[True] == dict(launches[False], flash_fwd=2 * layers,
                                  rms_fwd=4 * layers + 1)
    for name, g in grads[False].items():
        assert torch.equal(grads[True][name], g), name


def test_pipelined_trainer_on_the_card_matches_the_plain_path(cuda):
    """A small Llama (4 layers, two rounds of 2) through the pipelined
    trainer at pipe 1, 4 microbatches of 2 rows: with flash attention and
    the fused norm, and with both plain, from one init on one batch. The
    loss within 2e-2, the grad norm within 1e-2 relative and every
    gradient within 2^-5 relative L2 (chip_smoke's parity limits: the two
    paths differ by bf16 rounding); each flash kernel launched once a
    layer and microbatch, each norm kernel at the blocks' 2·L norms a
    microbatch (the exit's final norm is the plain one), none on the
    plain path."""
    import dataclasses

    from dlrover_tpu_torch.trainer.pipeline_trainer import (
        build_pipeline_trainer,
    )

    gen = torch.Generator(device=cuda).manual_seed(4)
    tokens, targets = (torch.randint(0, 256, (8, 256), device=cuda,
                                     generator=gen) for _ in range(2))
    layers, micro_steps = 4, 4
    out = {}
    for impl in ("kernels", "plain"):
        fused = impl == "kernels"
        cfg = dataclasses.replace(
            _small_llama(attn_impl="flash" if fused else "reference",
                         norm_impl="fused" if fused else "reference"),
            num_layers=layers)
        trainer = build_pipeline_trainer(
            cfg, lambda p: torch.optim.AdamW(p, lr=1e-3), None, micro_steps,
            2, 256, cross_entropy_loss, num_rounds=2, device=cuda)
        state = trainer.init(0)
        fa.reset_launch_counts()
        norms.reset_launch_counts()
        loss = trainer._accumulate(state, *trainer.shard_batch(tokens,
                                                               targets))
        grad_norm = trainer._grad_norm(state.model)
        torch.cuda.synchronize()
        out[impl] = (loss.item(), grad_norm.item(), _launches(),
                     {n: p.grad.float() for n, p in
                      state.model.named_parameters()})
    flash = layers * micro_steps
    assert out["kernels"][2] == {
        "flash_fwd": flash, "flash_bwd_dq": flash, "flash_bwd_dkv": flash,
        "rms_fwd": 2 * flash, "rms_bwd": 2 * flash}
    assert not any(out["plain"][2].values())
    assert abs(out["kernels"][0] - out["plain"][0]) <= 2e-2
    assert abs(out["kernels"][1] - out["plain"][1]) <= 1e-2 * out["plain"][1]
    for name, want in out["plain"][3].items():
        got = out["kernels"][3][name]
        assert ((got - want).norm() / want.norm()).item() <= 2.0 ** -5, name


def test_moe_model_on_the_card_counts_its_kernels_once_a_layer(cuda):
    """A small LlamaMoE (GQA 4:1, 4 experts top-2, training routing) on
    the card: one step's loss (cross entropy + the router aux) launches
    each flash kernel once a layer and each norm kernel at the 2·L + 1
    norms; under remat the forward kernels launch again, the aux is
    counted once and the gradients are the same bits."""
    from dlrover_tpu_torch.models.llama_moe import (
        LlamaMoE,
        LlamaMoEConfig,
        moe_cross_entropy_loss,
    )

    gen = torch.Generator(device=cuda).manual_seed(4)
    tokens, targets = (torch.randint(0, 256, (2, 256), device=cuda,
                                     generator=gen) for _ in range(2))
    losses, grads, launches = {}, {}, {}
    for remat in (False, True):
        cfg = LlamaMoEConfig(vocab_size=256, hidden_size=256,
                             intermediate_size=512, num_layers=2,
                             num_heads=4, num_kv_heads=1, max_seq_len=256,
                             embed_impl="gather", num_experts=4, remat=remat)
        model = LlamaMoE(cfg, device=cuda, seed=0, deterministic=False)
        fa.reset_launch_counts()
        norms.reset_launch_counts()
        loss = moe_cross_entropy_loss(model, tokens, targets)
        loss.backward()
        torch.cuda.synchronize()
        launches[remat] = _launches()
        losses[remat] = loss.detach()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    layers = 2
    assert launches[False] == {"flash_fwd": layers, "flash_bwd_dq": layers,
                               "flash_bwd_dkv": layers,
                               "rms_fwd": 2 * layers + 1,
                               "rms_bwd": 2 * layers + 1}
    assert launches[True] == dict(launches[False], flash_fwd=2 * layers,
                                  rms_fwd=4 * layers + 1)
    assert torch.isfinite(losses[False]) and torch.equal(losses[False],
                                                         losses[True])
    for name, g in grads[False].items():
        assert torch.equal(grads[True][name], g), name


def test_streaming_step_on_the_card_matches_the_dense_step(cuda):
    """One streaming and one dense step of a small Llama through the
    kernels under the factored-RMS optimizer: the loss within 1e-3, each
    parameter's update within 2^-5 relative L2 (chip_smoke.py's limits
    at full width), the launches with the recompute counted."""
    import functools

    import numpy as np

    from dlrover_tpu_torch.optim import LeafOptimizer, factored_rms
    from dlrover_tpu_torch.trainer.streaming import build_streaming_trainer
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    cfg = _small_llama()
    gen = torch.Generator(device=cuda).manual_seed(4)
    tokens, targets = (torch.randint(0, 256, (1, 2, 256), device=cuda,
                                     generator=gen) for _ in range(2))
    trainers = {
        "streaming": build_streaming_trainer(cfg, factored_rms(1e-3), 2),
        "dense": build_trainer(functools.partial(Llama, cfg),
                               functools.partial(
                                   LeafOptimizer,
                                   transform=factored_rms(1e-3)),
                               None, np.zeros((2, 256)), cross_entropy_loss,
                               micro_batch=2)}
    out = {}
    for name, trainer in trainers.items():
        state = trainer.init(0)
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        fa.reset_launch_counts()
        norms.reset_launch_counts()
        state, metrics = trainer.step(state, tokens, targets)
        torch.cuda.synchronize()
        out[name] = (float(metrics["loss"]), _launches(),
                     {n: (p.detach() - before[n]).float()
                      for n, p in state.model.named_parameters()})
    (s_loss, s_launch, s_upd), (d_loss, d_launch, d_upd) = (
        out["streaming"], out["dense"])
    assert abs(s_loss - d_loss) <= 1e-3
    assert s_launch == dict(d_launch, flash_fwd=4, rms_fwd=9)
    for n, u in d_upd.items():
        err = ((s_upd[n] - u).norm() / u.norm()).item()
        assert err <= 2.0 ** -5, (n, err)


def test_prefetch_hands_over_batches_copied_on_a_side_stream(cuda):
    """Every batch arrives on the card in order with its values, copied on
    the prefetch's own stream and handed to the consumer's stream."""
    import numpy as np

    from dlrover_tpu_torch.data.prefetch import prefetch_to_device

    source = [(np.full((2, 1024), i, np.int32),
               np.arange(1024, dtype=np.int64) + i) for i in range(9)]
    depths = iter([1, 3, 3, 2, 4, 1, 1, 1, 1, 1])
    got = list(prefetch_to_device(iter(source), depth=lambda: next(depths)))
    assert len(got) == len(source)
    for i, (tokens, extra) in enumerate(got):
        assert tokens.is_cuda and extra.is_cuda
        assert torch.equal(tokens.cpu(), torch.from_numpy(source[i][0]))
        assert torch.equal(extra.cpu(), torch.from_numpy(source[i][1]))


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


def test_pinned_host_copy_is_reused_and_restores_from_the_peer_cache(
        cuda, tmp_path):
    """The flash checkpoint's host copy on the card's host: page-locked,
    the same buffers at every save, the state's bits; the peer cache
    stages it, and a peer restore into the abstract state on the card
    gives the same parameters and moments and the same next step."""
    from dlrover_tpu_torch.checkpoint.flash_checkpoint import (
        FlashCheckpointer,
    )
    from dlrover_tpu_torch.checkpoint.peer_restore import (
        PeerRestorer,
        PeerStateStore,
        shard_items,
    )

    trainer, cfg = _two_layer_trainer(cuda)
    state = trainer.init(0)
    store = PeerStateStore(str(tmp_path / "cache"))
    pointers = []
    with FlashCheckpointer(str(tmp_path / "c"), save_interval_steps=1,
                           peer_store=store) as ckpt:
        for step in (1, 2):
            state, _ = trainer.step(
                state, *trainer.shard_batch(*_tokens(cfg, step)))
            assert ckpt.maybe_save(step, state, {"pos": step})
            host = dict(ckpt.exact_host_items())
            assert all(t.is_pinned() for t in host.values() if t.numel())
            live = dict(shard_items(state))
            assert all(torch.equal(host[k].to(cuda), v.to(cuda))
                       for k, v in live.items())
            assert store.stage(step, list(host.items()), {"pos": step},
                               defer_write=True)
            pointers.append(sorted(t.data_ptr() for t in host.values()))
        assert pointers[0] == pointers[1]
        ckpt.wait()
        store.flush()
        timings = {}
        restored, data, step, source = PeerRestorer(cache=store).restore(
            trainer.abstract_state(), ckpt, timings)
    assert (step, source, data) == (2, "peer", {"pos": 2})
    assert timings["peer_bytes"] > 0
    for (name, a), b in zip(state.model.named_parameters(),
                            restored.model.parameters()):
        assert b.device.type == "cuda" and torch.equal(a, b), name
        sa, sb = state.optimizer.state[a], restored.optimizer.state[b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    batch = trainer.shard_batch(*_tokens(cfg, 3))
    _, want = trainer.step(state, *batch)
    _, got = trainer.step(restored, *batch)
    assert got["loss"].item() == want["loss"].item()
    assert got["grad_norm"].item() == want["grad_norm"].item()


def _flash_trainer(cuda, layers=2):
    import dataclasses
    import functools

    import numpy as np

    from dlrover_tpu_torch.models.llama import cross_entropy_loss
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    cfg = dataclasses.replace(LlamaConfig.llama_1b(
        max_seq_len=512, attn_impl="flash", norm_impl="fused",
        embed_impl="gather"), num_layers=layers)
    return build_trainer(
        functools.partial(Llama, cfg),
        lambda p: torch.optim.AdamW(p, lr=3e-4, weight_decay=0.1), None,
        np.zeros((2, 512)), cross_entropy_loss, micro_batch=2), cfg


def test_device_telemetry_reads_the_allocator_peak_of_a_step(cuda):
    """DeviceTelemetry around one step of a 2-layer full-width Llama:
    the drained window peak is ``torch.cuda.max_memory_allocated()``, the
    limit the card's total, the rise at that step."""
    from dlrover_tpu_torch.obs.device import (
        DeviceTelemetry,
        allocator_sampler,
    )

    trainer, cfg = _flash_trainer(cuda)
    state = trainer.init(0)
    telemetry = DeviceTelemetry(allocator_sampler(cuda))
    state, metrics = trainer.step(state,
                                  *trainer.shard_batch(*_tokens(cfg, 0)))
    metrics["loss"].item()
    telemetry.on_step(1)
    drained = telemetry.drain()
    assert drained["hbm_peak_bytes"] == torch.cuda.max_memory_allocated()
    assert drained["hbm_limit_bytes"] == torch.cuda.mem_get_info()[1]
    assert drained["hbm_rise_step"] == 1.0
    assert 0 < drained["hbm_trough_bytes"] < drained["hbm_peak_bytes"]
    assert telemetry.available is True


def test_profiler_capture_names_the_training_kernels(cuda, tmp_path):
    """An on-demand capture of two steps of a 2-layer Llama (flash
    attention, fused norm): status ok, and the Chrome trace's kernel
    events name the forward flash and RMSNorm kernels and their
    backwards."""
    import json
    import os

    from dlrover_tpu_torch.obs import profiler

    trainer, cfg = _flash_trainer(cuda)
    state = trainer.init(0)
    request = str(tmp_path / "request.json")
    session = profiler.ProfilerSession(request_path=request)
    profiler.write_profile_request(request, 1, 2, str(tmp_path / "dump"))
    for step in range(4):
        session.poll(step)
        state, metrics = trainer.step(
            state, *trainer.shard_batch(*_tokens(cfg, step)))
        metrics["loss"].item()
    session.stop()
    done = profiler.read_profile_result(request)
    assert done["status"] == "ok" and done["num_steps"] == 2
    with open(os.path.join(done["trace_dir"], profiler.TRACE_NAME)) as f:
        kernels = {e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"}
    for name in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel", "rms_fwd_kernel",
                 "rms_bwd_kernel"):
        assert any(name in k for k in kernels), name


_CARD_WORKER = r'''
import time

import torch

from dlrover_tpu_torch.agent.monitor import export_chip_stats

torch.zeros(1, device="cuda")
for step in range(8):
    export_chip_stats(step=step, step_time_s=0.1)
    time.sleep(0.5)
'''


def _holds_the_card(pid: int) -> bool:
    """Whether process ``pid`` has the NVIDIA device files open (a CUDA
    context holds /dev/nvidia*)."""
    import os

    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


def test_agent_monitors_never_touch_the_card(cuda, tmp_path):
    """`run --standalone` (master and agent in one process, monitors on,
    a resource report every 0.5 s) around a worker that opens the card
    and exports its stats: the worker holds the card, the agent's
    process never does."""
    import os
    import subprocess
    import sys
    import time

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_CARD_WORKER)
    env = dict(os.environ, PYTHONPATH=repo, TMPDIR=str(tmp_path),
               DLROVER_TPU_REPORT_RESOURCE_INTERVAL_S="0.5",
               DLROVER_TPU_FLIGHT_DIR=str(tmp_path / "flight"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
         "--devices-per-node", "1", "--monitor-interval", "0.2",
         str(script)], cwd=repo, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    agent_held, worker_held = False, False
    try:
        while proc.poll() is None:
            agent_held = agent_held or _holds_the_card(proc.pid)
            for name in os.listdir("/proc"):
                if not name.isdigit():
                    continue
                try:
                    with open(f"/proc/{name}/stat") as f:
                        ppid = int(f.read().rsplit(")", 1)[1].split()[1])
                except OSError:
                    continue
                if ppid == proc.pid:
                    worker_held = worker_held or _holds_the_card(int(name))
            time.sleep(0.1)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    assert worker_held and not agent_held


def test_worker_on_the_card_trains_through_a_standby_promotion(cuda,
                                                               tmp_path):
    """chip_smoke.py's failover drill, short, on the card: Llama-1B's
    width at sequence 128 and batch 2 (the flash and RMSNorm kernels on
    the path), the primary master SIGKILLs itself at step 4's report,
    the standby promotes at generation 2, the agent reconnects with its
    world intact, and the same worker finishes every step in order."""
    import os
    import sys

    from dlrover_tpu_torch.common.config import Context

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    knobs = {"rpc_backoff_s": 0.05, "standby_health_interval_s": 0.25,
             "standby_promote_failures": 2}
    Context.reset()
    Context.singleton().update(**knobs)
    try:
        budget = chip_smoke.failover_budget(0.2, 0.5, kill_at=4,
                                            checkpoint=False)
    finally:
        Context.reset()
    env = {f"DLROVER_TPU_{k.upper()}": str(v) for k, v in knobs.items()}
    env.update(TMPDIR=str(tmp_path), DLROVER_TPU_RPC_TIMEOUT_S="0.5",
               DLROVER_TPU_MASTER_SNAPSHOT_RETAIN="1000",
               DLROVER_TPU_TSDB_SAMPLE_INTERVAL_S="0.2",
               DLROVER_TPU_TSDB_FLUSH_INTERVAL_S="0.5",
               DLROVER_TPU_FLIGHT_DIR=str(tmp_path / "flight"))
    out = chip_smoke.failover_drill(
        str(tmp_path), repo, ["--config", "llama_1b", "--seq", "128",
                              "--global-batch", "2"],
        budget["steps"], 4, 0.2, env, timeout_s=300,
        worker_chaos="slow:worker:0@1:0.2")
    run = out["run"]
    assert "device=cuda" in open(tmp_path / "worker.log").read()
    assert run["launches"]["flash_fwd"] > 0 and run["launches"]["rms_fwd"] > 0
    assert sorted(run["steps"]) == list(range(1, budget["steps"] + 1))
    assert out["snapshot"]["promoted_generation"] == 2
    assert (out["steps_after_reconnect"]
            >= chip_smoke.FAILOVER_AFTER_RECONNECT)


def test_embedding_step_on_the_card_matches_the_plain_path(cuda):
    """Three ElasticEmbeddingTrainer steps on the card against the same
    steps on the CPU from the same state (the card's embedding backward
    sums a row's gradient in another order): the table and accumulator
    within rtol 1e-4 / atol 1e-7, the table's update within 1e-3 and the
    accumulator's within 5e-2 relative L2 (its increments are a few ulps
    of 0.1: chip_smoke.py's EMB_ACC_UPDATE_TOL), the losses within 1e-5
    relative; rows no id touched keep their bits; no kernel launches. The
    ids are skewed (a power law), so hot rows' accumulators move."""
    import numpy as np

    from dlrover_tpu_torch.parallel.mesh import MeshSpec, create_mesh
    from dlrover_tpu_torch.trainer.embedding import (
        ElasticEmbeddingTrainer,
        EmbeddingConfig,
        ShardedEmbedding,
    )

    rows, dim, fields, batch = 50000, 32, 8, 256
    rng = np.random.default_rng(0)
    data = [((rng.zipf(1.2, (batch, fields)) - 1) % (rows // 2),
             (rng.random(batch) < 0.25).astype(np.float32))
            for _ in range(3)]

    def run(device):
        torch.manual_seed(0)
        embedding = ShardedEmbedding(
            EmbeddingConfig(rows, dim), device="cpu",
            generator=torch.Generator().manual_seed(0)).to(device)
        dense = torch.nn.Sequential(
            torch.nn.Flatten(), torch.nn.Linear(fields * dim, 64),
            torch.nn.ReLU(), torch.nn.Linear(64, 1),
            torch.nn.Flatten(0)).to(device)
        trainer = ElasticEmbeddingTrainer(
            create_mesh(MeshSpec(), device), embedding, dense,
            torch.nn.functional.binary_cross_entropy_with_logits)
        state = trainer.init()
        step = trainer.build_step()
        before = embedding.table.detach().cpu().clone()
        losses = [float(step(state, ids, labels)) for ids, labels in data]
        table = embedding.table
        return (losses, before, table.detach().cpu(),
                state.optimizer[0].state[table]["accumulator"].cpu())

    fa.reset_launch_counts()
    norms.reset_launch_counts()
    card = run(cuda)
    assert not any(fa.launch_counts.values())
    assert not any(norms.launch_counts.values())
    plain = run("cpu")
    np.testing.assert_allclose(card[0], plain[0], rtol=1e-5)
    assert torch.equal(card[1], plain[1])
    assert torch.allclose(card[2], plain[2], rtol=1e-4, atol=1e-7)
    assert torch.allclose(card[3], plain[3], rtol=1e-4, atol=1e-7)
    for got, want, start, tol in ((card[2], plain[2], plain[1], 1e-3),
                                  (card[3], plain[3], 0.1, 5e-2)):
        moved = want - start
        assert float(moved.abs().max()) > 0
        assert float((got - want).norm() / moved.norm()) <= tol
    untouched = rows // 2
    assert torch.equal(card[2][untouched:], card[1][untouched:])
    assert bool((card[3][untouched:] == 0.1).all())


# ---------------------------------------------------------------------------
# auto_accelerate, the search's dry runs and the coworker ring on the card
# ---------------------------------------------------------------------------


def _llama_1b_cut(**kw):
    """Llama-1B's width at 2 layers with the plain attention (the auto
    tests' factory; ``_small_llama`` above is the kernels tests')."""
    import dataclasses

    return dataclasses.replace(
        LlamaConfig.llama_1b(max_seq_len=256, attn_impl="reference",
                             **kw), num_layers=2, vocab_size=1024)


def test_auto_accelerate_lowers_to_the_kernels_and_trains_the_direct_bits(
        cuda):
    """``["amp", "module_replace"]`` on the card sets the flash kernels
    (the config asked for the plain attention) and trains the bits of
    the same trainer built directly."""
    import functools

    import numpy as np

    from dlrover_tpu_torch.auto import auto_accelerate
    from dlrover_tpu_torch.trainer.train_step import build_trainer

    def adamw(p):
        return torch.optim.AdamW(p, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.1)

    result = auto_accelerate(
        functools.partial(Llama, _llama_1b_cut()), optim_factory=lambda: adamw,
        loss_fn=cross_entropy_loss, sample_batch=np.zeros((2, 256), np.int64),
        strategy=["amp", "module_replace"], micro_batch=2)
    cfg = result.context.model_config()
    assert cfg.attn_impl == "flash" and result.trainer.device.type == "cuda"
    direct = build_trainer(functools.partial(Llama, cfg), adamw, None,
                           np.zeros((2, 256)), cross_entropy_loss,
                           micro_batch=2)
    tokens = np.random.default_rng(0).integers(0, 1024, (2, 256))
    losses = []
    for trainer in (result.trainer, direct):
        state = trainer.init(0)
        fa.reset_launch_counts()
        run = [trainer.step(state, *trainer.shard_batch(tokens, tokens))[1]
               ["loss"].item() for _ in range(2)]
        torch.cuda.synchronize()
        assert fa.launch_counts == {"flash_fwd": 4, "flash_bwd_dq": 4,
                                    "flash_bwd_dkv": 4}
        losses.append(run)
        del state
    assert losses[0] == losses[1]


def test_dry_run_gives_the_card_back(cuda):
    """A dry run, good or out of memory, leaves the allocator where it
    found it."""
    import functools

    import numpy as np

    from dlrover_tpu_torch.auto import ModelContext
    from dlrover_tpu_torch.auto.engine.dry_runner import dry_run

    context = ModelContext(functools.partial(Llama, _llama_1b_cut()),
                           loss_fn=cross_entropy_loss,
                           sample_batch=np.zeros((2, 256), np.int64))
    before = torch.cuda.memory_allocated()
    speed, err = dry_run(context, [("half", {}), ("module_replace", {})],
                         warmup=1, steps=2)
    assert speed > 0 and err == ""
    assert torch.cuda.memory_allocated() - before < 64 << 20
    # a batch far past the card's memory: scored, not raised
    huge = ModelContext(functools.partial(Llama, _llama_1b_cut()),
                        loss_fn=cross_entropy_loss,
                        sample_batch=np.zeros((1, 256), np.int64))
    huge.plan.micro_batch = 1 << 16
    speed, err = dry_run(huge, [("amp", {})], warmup=1, steps=1)
    assert speed == float("-inf") and "memory" in err.lower()
    assert torch.cuda.memory_allocated() - before < 64 << 20


def test_ring_batches_pass_the_checksum_op_on_the_card(cuda):
    import numpy as np

    from dlrover_tpu_torch.data.shm_ring import ShmRing
    from dlrover_tpu_torch.ops.host_ops import checksum, crc32

    rng = np.random.default_rng(0)
    with ShmRing(capacity=1 << 20) as ring:
        reader = ShmRing(ring.name, owner=False)
        for _ in range(3):
            tokens = rng.integers(0, 32000, (8, 256), dtype=np.int64)
            ring.push({"tokens": tokens, "crc": crc32(tokens)})
            got = reader.pop(timeout_s=5)
            dev = torch.from_numpy(got["tokens"]).to(cuda)
            crc = checksum(dev)
            assert crc.device == dev.device
            assert int(crc) == got["crc"]
        reader.close()


def _sp_phase(tmp_path, parts, cases=()):
    """chip_smoke's sp phase at small shapes on the card: two rank
    processes sharing it in one gloo group (part (d)'s ``cases`` only,
    when given)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    spec = chip_smoke.sp_spec("cuda", small=True, parts=parts, cases=cases)
    workers = chip_smoke._sp_workers(str(tmp_path), spec)
    return chip_smoke.phase_sp("card test", workers, spec)


def test_ring_and_ulysses_kernels_match_the_plain_ring_on_two_ranks(
        cuda, tmp_path):
    """Each rank's output, dQ, dK and dV of the ring over the flash kernels
    and of Ulysses within the flash tolerance of the one-process kernels'
    on the whole sequence and of the plain ring's, with the predicted
    launches; the tiny Llama at sequence 2 trains the one-process run's
    losses (part (a) and (b) of the phase, checked by it)."""
    launches = _sp_phase(tmp_path, "ab")["launches"]
    assert launches["flash_fwd"] > 0 and launches["rms_fwd"] > 0


def test_dcn_axis_step_quantizes_through_the_kernels(cuda, tmp_path):
    """The tiny Llama over a dcn axis of two ranks sharing the card, the
    mean over dcn at int8: three steps within the parity limits of one
    process's exact run, one quantize and one dequantize a leaf a step on
    each rank (part (e), checked by the phase)."""
    launches = _sp_phase(tmp_path, "e")["launches"]
    assert launches["quantize"] == launches["dequantize"] > 0
    assert launches["flash_fwd"] > 0


def test_quantized_mean_kernels_match_the_plain_versions(cuda, tmp_path):
    """quantized_pmean on CUDA leaves (the quantize and dequantize kernels)
    equals the same collective on CPU copies (the plain versions) bit for
    bit in gather and scatter mode at 8 and 4 bits, within the reference's
    bound of the exact mean, a launch of each a leaf and call (part (c))."""
    launches = _sp_phase(tmp_path, "c")["launches"]
    # 3 leaves: gather 1 call each, scatter 2, at two widths, two ranks
    assert launches == {"quantize": 36, "dequantize": 36}


def test_tensor_parallel_fused_qkv_families_launch_on_two_ranks(cuda,
                                                                tmp_path):
    """The tiny GPT and BERT over a tensor axis of 2 (the head-major
    fused qkv: a whole head a rank) train the one-process run's losses
    within the phase's limits, their q, k and v split with no collective,
    and launch the flash kernels (part (d), checked by it)."""
    launches = _sp_phase(tmp_path, "d", ("gpt", "bert"))["launches"]
    assert launches["flash_fwd"] > 0 and launches["rms_fwd"] == 0


def test_moe_and_pipelined_cases_over_tensor_and_expert_on_two_ranks(
        cuda, tmp_path):
    """The tiny Mixtral over tensor 2, the pipelined tiny Llama over pipe
    1 × tensor 2 and the pipelined tiny Mixtral over pipe 1 × expert 2
    train the one-process runs' losses within the phase's limits, the
    MoE over tensor's gradients with routing pinned within the parity
    limit, DTensor running no collective but the grad norm's scalar
    all-reduces, and launch the flash and norm kernels as predicted
    (part (d)'s new cases, checked by it)."""
    launches = _sp_phase(tmp_path, "d", ("moe", "pipe"))["launches"]
    assert launches["flash_fwd"] > 0 and launches["rms_fwd"] > 0
