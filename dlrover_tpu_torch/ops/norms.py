"""RMSNorm: the plain version, and the fused entry point whose CUDA
kernel is the next slice of the port.

Counterpart of ``dlrover_tpu/ops/norms.py``.
"""

from __future__ import annotations

import torch


def reference_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x²) + eps) * weight in f32, returned in x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight).to(x.dtype)


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """The fused RMSNorm. On a CPU tensor it is the plain version; on a
    CUDA tensor it raises until its kernel is ported."""
    if x.is_cuda:
        raise NotImplementedError(
            "fused_rms_norm has no CUDA kernel yet (ROADMAP Queue B, "
            "items 4-5: _rms_fwd_kernel/_rms_bwd_kernel); use "
            "norm_impl='reference' on the card")
    return reference_rms_norm(x, weight, eps)
