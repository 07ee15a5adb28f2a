"""Model-FLOPs / MFU accounting for NVIDIA cards.

Own copy of ``flops_per_token`` and ``achieved_mfu`` from the JAX
package's ``obs/mfu.py`` (one formula for every consumer), with a peak
table for NVIDIA cards in place of its TPU rows.
"""

from __future__ import annotations

# Dense bf16 tensor-core peak FLOP/s by a substring of the device name
# (NVIDIA's data sheets). The first match wins, so the PCIe row comes
# before the generic H100 (SXM) row.
PEAK_FLOPS_BY_NAME = (
    ("H100 PCIe", 756e12),
    ("H100", 989e12),      # H100 SXM, reported as "NVIDIA H100 80GB HBM3"
)


def peak_flops_for(device_name: str) -> float:
    """Peak bf16 FLOP/s of the card named ``device_name``
    (``torch.cuda.get_device_name()``); 0.0 when unknown, which makes
    :func:`achieved_mfu` report -1 rather than a made-up number."""
    for key, flops in PEAK_FLOPS_BY_NAME:
        if key in device_name:
            return flops
    return 0.0


def flops_per_token(param_count: float, num_layers: int = 0,
                    hidden_size: int = 0, seq_len: int = 0,
                    uncounted_embed_params: float = 0.0) -> float:
    """Model FLOPs per trained token (fwd+bwd), conservatively.

    ``6·params`` credits the matmul FLOPs of forward (2·params) plus
    backward (4·params). ``uncounted_embed_params`` subtracts parameters
    that do no matmul (a gather-lookup embedding table with untied
    output head). The attention term is QK^T + PV = 4·h·s FLOPs/token
    forward, ×3 for fwd+bwd, ÷2 causal — matching what a
    block-skipping flash kernel actually computes. With
    ``num_layers``/``hidden_size``/``seq_len`` unknown (0), the formula
    degrades to the bare 6·params floor.
    """
    counted = max(0.0, float(param_count) - float(uncounted_embed_params))
    attention = 6.0 * num_layers * hidden_size * seq_len
    return 6.0 * counted + attention


def achieved_mfu(tokens_per_second: float, flops_per_token_: float,
                 peak_flops_total: float) -> float:
    """Achieved / peak model-FLOPs utilization; -1.0 when the FLOPs
    model or the peak is unknown (callers must not mistake "no
    evidence" for "0 % utilized")."""
    if flops_per_token_ <= 0.0 or peak_flops_total <= 0.0:
        return -1.0
    if tokens_per_second < 0.0:
        return -1.0
    return tokens_per_second * flops_per_token_ / peak_flops_total
