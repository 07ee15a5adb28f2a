"""The port's data plane (dlrover_tpu_torch.data.{shm_ring,coworker} and
PrefetchAutoTuner.ring_capacity) against the JAX package's. Both rings are
native/shm_ring.cpp, so a ring made by either package is read by the
other; both coworker services speak the same wire messages. Every
comparison is exact: records are bytes."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dlrover_tpu.data import coworker as jcw
from dlrover_tpu.data import prefetch as jprefetch
from dlrover_tpu.data import shm_ring as jring
from dlrover_tpu_torch.data import coworker as tcw
from dlrover_tpu_torch.data import prefetch as tprefetch
from dlrover_tpu_torch.data import shm_ring as tring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(n=12, seed=0):
    rng = np.random.default_rng(seed)
    # sizes that wrap a 64 KiB ring several times, one byte among them
    return [rng.integers(0, 256, int(size), dtype=np.uint8).tobytes()
            for size in [1] + list(rng.integers(1, 20_000, n - 1))]


@pytest.mark.parametrize("fallback", [False, True])
def test_ring_carries_records_in_order(fallback):
    records = _records()
    with tring.ShmRing(capacity=1 << 16, _force_fallback=fallback) as ring:
        reader = tring.ShmRing(ring.name, owner=False,
                               _force_fallback=fallback)
        got = []
        for rec in records:
            ring.push_bytes(rec)
            got.append(reader.pop_bytes(timeout_s=5))
        assert got == records
        ring.mark_closed()
        with pytest.raises(tring.RingClosed):
            reader.pop_bytes(timeout_s=1)
        with tring.ShmRing(capacity=1 << 12,
                           _force_fallback=fallback) as empty:
            with pytest.raises(tring.RingTimeout):
                empty.pop_bytes(timeout_s=0.05)
        with pytest.raises(ValueError, match="larger"):
            ring.push_bytes(b"x" * (1 << 17))
        reader.close()


@pytest.mark.parametrize("fallback", [False, True])
def test_an_empty_record_is_refused(fallback):
    """The native ring reads a record length of 0 as "no record": an
    empty record pushed there would wedge its consumer, so the port
    refuses it on either layout."""
    with tring.ShmRing(capacity=1 << 12, _force_fallback=fallback) as ring:
        with pytest.raises(ValueError, match="empty"):
            ring.push_bytes(b"")
        ring.push_bytes(b"\0")
        reader = tring.ShmRing(ring.name, owner=False,
                               _force_fallback=fallback)
        assert reader.pop_bytes(timeout_s=5) == b"\0"
        reader.close()


@pytest.mark.parametrize("writer,reader", [(jring, tring), (tring, jring)])
def test_a_ring_made_by_one_package_is_read_by_the_other(writer, reader):
    records = _records(seed=1)
    with writer.ShmRing(capacity=1 << 16) as ring:
        other = reader.ShmRing(ring.name, owner=False)
        for rec in records:
            ring.push_bytes(rec)
            assert other.pop_bytes(timeout_s=5) == rec
        obj = {"tokens": np.arange(12, dtype=np.int64).reshape(3, 4),
               "step": 7}
        other.push(obj)
        back = ring.pop(timeout_s=5)
        np.testing.assert_array_equal(back["tokens"], obj["tokens"])
        assert back["step"] == 7
        ring.mark_closed()
        with pytest.raises((reader.RingClosed, jring.RingClosed)):
            other.pop_bytes(timeout_s=1)
        other.close()


def test_a_layout_mismatch_is_refused():
    # the Python layout attaching to a native ring
    with tring.ShmRing(capacity=1 << 12) as native:
        with pytest.raises(RuntimeError, match="native C\\+\\+ layout"):
            tring.ShmRing(native.name, owner=False, _force_fallback=True)
    # the native layout attaching to a Python ring (either package's)
    for maker in (tring, jring):
        with maker.ShmRing(capacity=1 << 12, _force_fallback=True) as py:
            with pytest.raises(OSError, match="native layout"):
                tring.ShmRing(py.name, owner=False)
    with jring.ShmRing(capacity=1 << 12) as native:
        with pytest.raises(RuntimeError, match="native"):
            tring.ShmRing(native.name, owner=False, _force_fallback=True)


PRODUCER = r"""
import json, sys, time
t0 = time.monotonic()
from dlrover_tpu_torch.data.shm_ring import ShmDataContext
from dlrover_tpu_torch.ops.host_ops import crc32
import numpy as np
names = json.loads(sys.argv[1])
ctx = ShmDataContext.attach(names)
rng = np.random.default_rng(5)
for i in range(6):
    tokens = rng.integers(0, 1000, (2, 16), dtype=np.int64)
    ctx.push({"i": i, "tokens": tokens, "crc": crc32(tokens)},
             ring_idx=i % len(names))
ctx.close_producers()
print(json.dumps({"torch": "torch" in sys.modules,
                  "start_s": time.monotonic() - t0}))
"""


def test_context_carries_batches_across_processes_without_torch():
    from dlrover_tpu_torch.ops.host_ops import crc32

    with tring.ShmDataContext(num_rings=2, capacity=1 << 16) as ctx:
        proc = subprocess.Popen(
            [sys.executable, "-c", PRODUCER, json.dumps(ctx.ring_names)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=REPO))
        got = list(ctx.batches(timeout_s=60))
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    report = json.loads(out.strip().splitlines()[-1])
    assert report["torch"] is False
    # round-robin over the rings: every batch once, each ring in order
    assert sorted(b["i"] for b in got) == list(range(6))
    for ring in (0, 1):
        mine = [b["i"] for b in got if b["i"] % 2 == ring]
        assert mine == sorted(mine)
    for b in got:
        assert crc32(b["tokens"]) == b["crc"]


def test_context_batches_times_out_on_a_dead_producer():
    with tring.ShmDataContext(num_rings=1, capacity=1 << 12) as ctx:
        with pytest.raises(tring.RingTimeout, match="producer dead"):
            list(ctx.batches(timeout_s=0.2))


@pytest.mark.parametrize("depth", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("base", [64 << 20, 1 << 20, 12345])
def test_ring_capacity_matches_jax(depth, base):
    kw = dict(depth=depth, depth_min=1, depth_max=8)
    assert (tprefetch.PrefetchAutoTuner(**kw).ring_capacity(base)
            == jprefetch.PrefetchAutoTuner(**kw).ring_capacity(base))


@pytest.mark.parametrize("client_pkg,service_pkg", [(jcw, tcw), (tcw, jcw)])
def test_coworker_client_and_service_interoperate(client_pkg, service_pkg):
    service = service_pkg.CoworkerDataService(capacity=4, port=0,
                                              host="127.0.0.1")
    service.start()
    try:
        client = client_pkg.CoworkerClient(f"127.0.0.1:{service.port}",
                                           producer_id=3, timeout_s=10)
        rng = np.random.default_rng(2)
        sent = [rng.integers(0, 50, (2, 8), dtype=np.int64)
                for _ in range(3)]
        for batch in sent:
            assert client.push_batch({"tokens": batch}, "ds")
        info = client.queue_info("ds")
        assert (info.queued, info.capacity, info.finished) == (3, 4, False)
        service.mark_finished()
        got = list(service.batches("ds", timeout_s=5))
        assert len(got) == 3
        for a, b in zip(got, sent):
            np.testing.assert_array_equal(a["tokens"], b)
        assert client.queue_info("ds").finished
    finally:
        service.stop()


def test_coworker_batches_time_out_without_a_producer():
    service = tcw.CoworkerDataService(capacity=2, port=0, host="127.0.0.1")
    service.start()
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            list(service.batches("none", timeout_s=0.3))
        assert time.monotonic() - t0 < 5
    finally:
        service.stop()
