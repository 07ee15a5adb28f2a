"""Device prefetch: the host→device copy of the next batches overlaps the
step on this one.

Counterpart of ``dlrover_tpu/data/prefetch.py``. Where the JAX package
relies on ``jax.device_put`` being asynchronous, here each batch is
copied from page-locked host memory on a side CUDA stream, ``depth``
batches ahead of the consumer. A batch is handed over only after the
consumer's stream waits on the event recorded behind its copies, and
``record_stream`` tells the caching allocator that the consumer's
stream uses its tensors, so their memory is not reused while a step
still reads them.

:class:`PrefetchAutoTuner` closes the loop from the step timeline: when
the windowed ``data_wait`` share (``obs/timeline.py``) says the loop
starves on input, the recommended depth grows toward
``Context.prefetch_depth_max``; when it stops starving the depth decays,
so idle batches do not hold device memory. ``tuner.depth_fn`` passed as
``depth`` is re-read at every batch.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.device import resolve_device


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on each leaf of nested tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, leaf) for leaf in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def prefetch_to_device(
    iterator: Iterable,
    depth: Union[int, Callable[[], int]] = 2,
    device: Optional[Union[str, torch.device]] = None,
    transform: Optional[Callable] = None,
) -> Iterator:
    """Yield the batches of ``iterator`` (nested tuples, lists and dicts
    of arrays or tensors) as tensors on ``device`` (the current CUDA
    device when None; raises without a GPU unless ``device="cpu"``),
    ``depth`` batches ahead of consumption.

    ``depth`` may be a callable (``PrefetchAutoTuner.depth_fn``), read
    again at every batch, so a tuned depth applies without rebuilding
    the pipeline; as in the JAX package, a batch is yielded whenever the
    window holds ``depth`` batches, and the rest at the end: none is
    dropped, and a shrink is drained as batches go out."""
    device = resolve_device(device)
    depth_fn = depth if callable(depth) else (lambda: depth)
    queue: collections.deque = collections.deque()
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def to_tensor(x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x)) if not torch.is_tensor(x) \
            else x

    def pinned(x) -> torch.Tensor:
        t = to_tensor(x)
        return t.pin_memory() if t.device.type == "cpu" else t

    def put(batch):
        if transform is not None:
            batch = transform(batch)
        if copy_stream is None:
            return _tree_map(lambda x: to_tensor(x).to(device), batch), None
        with torch.cuda.stream(copy_stream):
            moved = _tree_map(lambda x: pinned(x).to(
                device, non_blocking=True), batch)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return moved, done

    def take():
        batch, done = queue.popleft()
        if done is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            _tree_map(lambda t: t.record_stream(stream), batch)
        return batch

    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= max(1, int(depth_fn())):
            yield take()
    while queue:
        yield take()


class PrefetchAutoTuner:
    """The data-wait-driven prefetch depth (knob: ``Context
    .prefetch_autotune``), the JAX package's rule.

    Fed once a report window by the loop (``ElasticTrainLoop
    ._report_progress``) with the timeline's windowed data-wait share.
    Growth is immediate (a starving card pays every step) while a shrink
    needs two calm windows in a row, and the shrink trigger sits at a
    quarter of the grow trigger (the dead band keeps a pipeline near the
    threshold from oscillating)."""

    _SHRINK_FRACTION = 0.25
    _SHRINK_CALM_WINDOWS = 2

    def __init__(self, depth: int = 2, depth_min: Optional[int] = None,
                 depth_max: Optional[int] = None,
                 wait_threshold: Optional[float] = None):
        ctx = Context.singleton()
        self._min = int(depth_min if depth_min is not None
                        else ctx.prefetch_depth_min)
        self._max = int(depth_max if depth_max is not None
                        else ctx.prefetch_depth_max)
        self._threshold = float(wait_threshold if wait_threshold is not None
                                else ctx.data_wait_tune_fraction)
        self._lock = threading.Lock()
        self._depth = max(self._min, min(self._max, int(depth)))
        self._calm_windows = 0

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    def depth_fn(self) -> int:
        """The bound method to hand ``prefetch_to_device(depth=...)``."""
        return self.depth

    def observe(self, data_wait_fraction: float) -> int:
        """One report window's data-wait share; returns the (possibly
        changed) depth. A negative share means no timeline evidence and
        changes nothing."""
        if data_wait_fraction < 0.0:
            return self.depth
        with self._lock:
            if data_wait_fraction > self._threshold:
                self._calm_windows = 0
                if self._depth < self._max:
                    self._depth += 1
            elif data_wait_fraction < self._threshold * self._SHRINK_FRACTION:
                self._calm_windows += 1
                if (self._calm_windows >= self._SHRINK_CALM_WINDOWS
                        and self._depth > self._min):
                    self._depth -= 1
                    self._calm_windows = 0
            else:
                self._calm_windows = 0
            return self._depth

    def ring_capacity(self, base_capacity: int = 64 << 20) -> int:
        """The ``ShmDataContext`` ring capacity for the current depth:
        the default depth's (2) capacity scaled with the depth, so a
        deeper prefetch window never stalls its producers on a full
        ring. Advisory: read when a ring is (re)built, never live."""
        with self._lock:
            scale = max(1, self._depth) / 2.0
        return int(base_capacity * max(1.0, scale))
