"""Device-truth worker telemetry: the per-step HBM watermark and compile
events.

The port's counterpart of the JAX package's ``obs/device.py``, over the
CUDA caching allocator. The agent's resource tick samples memory BETWEEN
steps (the trough); what the next batch bump would run out of is the
in-step peak. ``torch.cuda.memory_stats()["allocated_bytes.all.peak"]``
is the allocator's high-water mark, lifetime-monotone unless someone
calls ``torch.cuda.reset_peak_memory_stats()`` (the telemetry never
does), and reading it is a host-side call that does not synchronize the
device. :class:`DeviceTelemetry` tracks that watermark, notes the step
it last ROSE at, and hands the report window's peak to the step report
(``GlobalStepReport.hbm_peak_bytes``). The card's total comes from
``torch.cuda.mem_get_info()``, read once per device.

A CPU-safe no-op by contract: on a device with no allocator statistics
(the CPU) sampling stops after one probe.

Compile events: :func:`record_compile_event` stamps one flight event and
gauge per build of the train step with its wall time
(``trainer.precompile()``: the CUDA kernels' build and the first
allocation). PyTorch's eager step has no ahead-of-time compiled program,
so there is no cost analysis to stamp: the FLOPs and bytes fields stay
0, as the JAX package leaves them when ``cost_analysis`` answers
nothing, and MFU keeps its analytic FLOPs model.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

# a watermark move smaller than this is allocator noise, not a rise
_RISE_THRESHOLD_BYTES = 1 << 20

# device index -> total bytes (mem_get_info), read once per process
_TOTAL_BYTES: Dict[int, float] = {}


def card_total_bytes(index: int) -> float:
    """The card's memory size from ``torch.cuda.mem_get_info``, cached:
    it does not change while the process lives."""
    total = _TOTAL_BYTES.get(index)
    if total is None:
        import torch

        total = float(torch.cuda.mem_get_info(index)[1])
        _TOTAL_BYTES[index] = total
    return total


def allocator_sampler(device=None) -> Callable[
        [], Optional[List[Dict[str, float]]]]:
    """A sampler over the CUDA caching allocator of ``device`` (the
    current card when None): one ``memory_stats`` read per call. It
    answers None when the device is not a card or CUDA is absent (the
    availability probe's signal)."""

    def sample() -> Optional[List[Dict[str, float]]]:
        import torch

        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type != "cuda":
            return None
        if not torch.cuda.is_available():
            return None
        index = (dev.index if dev is not None and dev.index is not None
                 else torch.cuda.current_device())
        stats = torch.cuda.memory_stats(index)
        if not stats:
            return None
        return [{
            "index": float(index),
            "bytes_in_use": float(stats.get("allocated_bytes.all.current",
                                            0) or 0),
            "peak_bytes_in_use": float(stats.get(
                "allocated_bytes.all.peak", 0) or 0),
            "bytes_limit": card_total_bytes(index),
        }]

    return sample


class DeviceTelemetry:
    """Per-step HBM watermark tracker for the training loop.

    ``on_step`` is the hot-path call (one allocator read, nothing
    else); ``drain`` is the report-interval call that returns the
    window's peak and where it last rose, and re-arms the window.
    """

    def __init__(self, sampler: Optional[
            Callable[[], Optional[List[Dict[str, float]]]]] = None):
        self._sampler = (sampler if sampler is not None
                         else allocator_sampler())
        self._lock = threading.Lock()
        # None = not probed yet; False = no allocator statistics (the
        # CPU): every later on_step returns at once
        self._available: Optional[bool] = None
        self._watermark_bytes = 0.0      # lifetime high-water observed
        # the peak counter is monotone, so "the window's peak" cannot be
        # read off it directly. The port builds its train step once per
        # process, and a fixed program's in-step peak recurs every step:
        # a window that sampled a step carries the lifetime watermark
        # (the JAX tracker's windowing with no rebuild in it)
        self._window_sampled = False     # any step sampled this window
        self._trough_bytes = 0.0         # last between-step bytes_in_use
        self._limit_bytes = 0.0
        self._rise_step = -1             # step the watermark last rose

    @property
    def available(self) -> Optional[bool]:
        with self._lock:
            return self._available

    def on_step(self, step: int) -> None:
        """Sample after a finished step; a no-op once probed
        unavailable."""
        with self._lock:
            if self._available is False:
                return
        try:
            stats = self._sampler()
        except Exception:  # noqa: BLE001 — telemetry never kills a step
            stats = None
        with self._lock:
            if not stats:
                if self._available is None:
                    self._available = False
                return
            self._available = True
            peak = max(s["peak_bytes_in_use"] for s in stats)
            in_use = max(s["bytes_in_use"] for s in stats)
            self._trough_bytes = in_use
            self._limit_bytes = max(self._limit_bytes,
                                    max(s["bytes_limit"] for s in stats))
            if peak > self._watermark_bytes + _RISE_THRESHOLD_BYTES:
                self._rise_step = int(step)
            self._watermark_bytes = max(self._watermark_bytes, peak)
            self._window_sampled = True

    def drain(self) -> Dict[str, float]:
        """Report-window summary for the step report; re-arms the
        window. ``hbm_peak_bytes`` 0 = no device truth (the CPU)."""
        with self._lock:
            peak = self._watermark_bytes if self._window_sampled else 0.0
            out = {
                "hbm_peak_bytes": peak,
                "hbm_watermark_bytes": self._watermark_bytes,
                "hbm_trough_bytes": self._trough_bytes,
                "hbm_limit_bytes": self._limit_bytes,
                "hbm_rise_step": float(self._rise_step),
            }
            self._window_sampled = False
        return out

    def peak_mb(self) -> float:
        """Lifetime watermark in MiB (0 = unavailable)."""
        with self._lock:
            return self._watermark_bytes / (1 << 20)


def record_compile_event(wall_s: float, kind: str = "precompile",
                         mesh: Optional[Dict[str, Any]] = None) -> None:
    """One build of the train step into the flight recorder (its FLOPs
    and bytes 0: an eager step has no compiled cost analysis) and the
    ``dlrover_tpu_compile_wall_seconds`` gauge."""
    from dlrover_tpu_torch.obs.flight_recorder import get_flight_recorder
    from dlrover_tpu_torch.obs.metrics import get_registry

    get_flight_recorder().record_event(
        "compile_event", kind=kind, wall_s=round(float(wall_s), 3),
        flops=0.0, bytes_accessed=0.0, mesh=dict(mesh) if mesh else None)
    get_registry().gauge(
        "dlrover_tpu_compile_wall_seconds",
        "Wall-clock of the last train-step compile",
        labelnames=("kind",)).labels(kind=kind).set(float(wall_s))
