"""What every kernel wrapper asks of its tensors before it launches:
which path their device takes, and the stream to launch on."""

from __future__ import annotations

import torch


def device_kind(what: str, *tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for the tensors' common device; raises on a mix or
    on any other device. ``what`` names the operation in the message."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what} inputs on several devices: "
                         f"{sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what} has no path for device {kind!r}")
    return kind


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
