"""The port's device prefetch and its auto-tuner (dlrover_tpu_torch/data/
prefetch.py) against the JAX package's data/prefetch.py, on the CPU.

The tuner's depth after every window of a seeded data-wait series is
JAX's, at the defaults and at other bounds; the prefetch yields every
batch in order with the JAX function's window (how many source batches
it has pulled at each yield) under a fixed and a changing callable
depth; the loop feeds its tuner each report window and exports the
depth as a gauge.
"""

import functools
import time

import numpy as np
import pytest
import torch

from dlrover_tpu.common.config import Context as JContext
from dlrover_tpu.data.prefetch import PrefetchAutoTuner as JTuner
from dlrover_tpu.data.prefetch import prefetch_to_device as j_prefetch
from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.data.prefetch import (
    PrefetchAutoTuner,
    prefetch_to_device,
)
from dlrover_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    cross_entropy_loss,
)
from dlrover_tpu_torch.trainer.elastic_loop import (
    ElasticTrainLoop,
    TrainLoopConfig,
)

KNOBS = ("prefetch_autotune", "prefetch_depth_min", "prefetch_depth_max",
         "data_wait_tune_fraction")


def test_knobs_match_jax():
    for knob in KNOBS:
        assert getattr(Context(), knob) == getattr(JContext(), knob), knob


def _waits(seed, n=200):
    """A data-wait series: calm stretches, starving ones, the dead band
    and windows without evidence (-1)."""
    rng = np.random.default_rng(seed)
    levels = rng.choice([-1.0, 0.0, 0.03, 0.1, 0.19, 0.21, 0.5, 0.9], n)
    return [float(x) for x in levels]


@pytest.mark.parametrize("kw", [
    dict(), dict(depth=5), dict(depth=1, depth_min=1, depth_max=3),
    dict(depth=4, depth_min=2, depth_max=6, wait_threshold=0.1),
])
def test_tuner_depths_match_jax(kw):
    for seed in range(3):
        j, t = JTuner(**kw), PrefetchAutoTuner(**kw)
        assert t.depth == j.depth
        seen = set()
        for wait in _waits(seed):
            assert t.observe(wait) == j.observe(wait)
            assert t.depth_fn() == j.depth_fn()
            seen.add(t.depth)
        assert len(seen) > 1


def _pulls(prefetch, depth, n=12):
    """(the batches yielded, the source batches pulled at each yield)."""
    pulled = []

    def source():
        for i in range(n):
            pulled.append(i)
            yield (np.full((2, 3), i, np.int32), {"mask": np.arange(i)})

    out, window = [], []
    for batch in prefetch(source(), depth=depth):
        window.append(len(pulled))
        out.append(batch)
    return out, window


@pytest.mark.parametrize("schedule", ["fixed", "callable"])
def test_prefetch_order_and_window_match_jax(schedule):
    def depth():
        if schedule == "fixed":
            return 3
        # grows, then shrinks while batches are queued, then grows again
        plan = [2, 2, 4, 4, 4, 1, 1, 3, 3, 5, 2, 2, 2, 2, 2, 2]
        calls[0] += 1
        return plan[min(calls[0], len(plan)) - 1]

    calls = [0]
    want, want_window = _pulls(j_prefetch, depth)
    calls = [0]
    got, got_window = _pulls(
        functools.partial(prefetch_to_device, device="cpu"), depth)
    assert got_window == want_window
    assert len(got) == len(want) == 12
    for i, ((tokens, extra), (jtokens, jextra)) in enumerate(zip(got, want)):
        assert isinstance(tokens, torch.Tensor) and tokens.device.type == "cpu"
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
        np.testing.assert_array_equal(extra["mask"].numpy(),
                                      np.asarray(jextra["mask"]))
        assert int(tokens[0, 0]) == i


def test_prefetch_applies_the_transform_and_refuses_no_gpu():
    out = list(prefetch_to_device(iter([np.ones(3), np.zeros(3)]),
                                  depth=2, device="cpu",
                                  transform=lambda x: x * 2))
    assert [t.tolist() for t in out] == [[2.0] * 3, [0.0] * 3]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(prefetch_to_device(iter([np.ones(3)])))


@pytest.fixture
def default_knobs():
    """The tuner's knobs at their defaults, whatever an earlier test on
    this process left in the singleton."""
    Context.reset()
    yield Context.singleton()
    Context.reset()


def test_loop_feeds_its_tuner_and_exports_the_depth(default_knobs):
    """A starving input under a live master: each step report feeds the
    tuner the window's data-wait share, which grows the depth above its
    start; the gauge reads it.

    The input waits before every batch twice as long as the last step
    took outside its own wait (0.2 s at least), so it starves however
    slow a step is: a fixed sleep did not when the process was loaded
    (a step of seconds behind busy threads holding the interpreter)."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.job_master import JobMaster

    assert all(getattr(default_knobs, k) == getattr(Context(), k)
               for k in KNOBS)
    master = JobMaster(host="127.0.0.1")
    master.prepare()
    client = MasterClient(master.addr, node_id=0, timeout_s=10.0)
    cfg = LlamaConfig.tiny(dtype=torch.float32, attn_impl="reference",
                           norm_impl="reference")
    try:
        loop = ElasticTrainLoop(
            functools.partial(Llama, cfg),
            lambda p: torch.optim.SGD(p, lr=1e-3), cross_entropy_loss,
            TrainLoopConfig(global_batch=2, seq_len=16, max_steps=5,
                            report_interval_steps=1),
            master_client=client, device="cpu")
        tuner = loop.prefetch_tuner
        assert isinstance(tuner, PrefetchAutoTuner) and tuner.depth == 2

        def slow():
            rng = np.random.default_rng(0)
            for _ in range(5):
                last = loop.timeline.snapshot()[-1:]
                busy = sum(e["total_s"] - e["phases"]["data_wait"]
                           for e in last)
                time.sleep(max(0.2, 2.0 * busy))
                tokens = rng.integers(0, cfg.vocab_size, (2, 16))
                yield tokens, tokens

        state, _ = loop.restore_or_init(0)
        loop.run(state, prefetch_to_device(slow(), depth=tuner.depth_fn,
                                           device="cpu"))
        loop.close()
        # starving windows grew it from 2 (the last ones, where the
        # source has run dry and the queue drains, may be calm)
        assert tuner.depth > 2
        lines = [line.split() for line in
                 obs.get_registry().render().splitlines()
                 if line.startswith("dlrover_tpu_prefetch_depth ")]
        assert [float(v) for _, v in lines] == [tuner.depth]
    finally:
        client.close()
        master.stop()


def test_loop_builds_no_tuner_when_the_knob_is_off():
    ctx = Context.singleton()
    ctx.update(prefetch_autotune=False)
    try:
        loop = ElasticTrainLoop(
            functools.partial(Llama, LlamaConfig.tiny()),
            lambda p: torch.optim.SGD(p, lr=1e-3), cross_entropy_loss,
            TrainLoopConfig(global_batch=2, seq_len=8), device="cpu")
        assert loop.prefetch_tuner is None
        loop.close()
    finally:
        ctx.update(prefetch_autotune=True)
