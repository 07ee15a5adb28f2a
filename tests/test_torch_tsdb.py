"""The port's time-series store (``dlrover_tpu_torch/obs/tsdb.py``)
against the JAX package's: the same ingests under one fake clock give
byte-equal ``query_payload`` answers and equal tiers, the store stays
under its memory bound, the sidecar round-trips (and reads the JAX
package's file), and the collector samples a registry and a ledger into
the same points."""

import json
import math

import numpy as np
import pytest

from dlrover_tpu.obs import tsdb as jtsdb
from dlrover_tpu.obs.metrics import MetricsRegistry as JRegistry
from dlrover_tpu_torch.obs import tsdb as ttsdb
from dlrover_tpu_torch.obs.metrics import MetricsRegistry as TRegistry

T0 = 1.7e9


class FakeClock:
    def __init__(self, start=T0):
        self.t = start

    def __call__(self):
        return self.t


def _ingests(seed: int, n: int = 900):
    """A seeded stream of (advance_s, name, labels, value, ts-or-None):
    several series and label sets, late points behind the open bucket,
    NaN and unparsable values, explicit timestamps."""
    rng = np.random.default_rng(seed)
    names = ["dlrover_tpu_worker_step_time_seconds",
             "dlrover_tpu_worker_mfu", "dlrover_tpu_training_mfu",
             "dlrover_tpu_node_hbm_used_mb", "other_series"]
    out = []
    for _ in range(n):
        name = names[int(rng.integers(len(names)))]
        labels = ({"node": str(int(rng.integers(3)))}
                  if rng.random() < 0.7 else None)
        roll = rng.random()
        if roll < 0.02:
            value = float("nan")
        elif roll < 0.04:
            value = "garbage"
        else:
            value = float(np.round(rng.normal(1.0, 0.3), 6))
        ts = None
        if rng.random() < 0.1:
            ts = "late"          # resolved against the clock at play time
        out.append((float(rng.exponential(4.0)), name, labels, value, ts))
    return out


def _play(module, stream, **kwargs):
    clock = FakeClock()
    store = module.TimeSeriesStore(clock=clock, **kwargs)
    accepted = []
    for advance, name, labels, value, ts in stream:
        clock.t += advance
        if ts == "late":
            ts = clock.t - 75.0
        accepted.append(store.ingest(name, value, labels=labels, ts=ts))
    return store, clock, accepted


QUERIES = [
    dict(),
    dict(name="dlrover_tpu_worker_step_time_seconds"),
    dict(name="dlrover_tpu_worker_step_time_seconds", window_s=60.0),
    dict(name="dlrover_tpu_worker_mfu", labels={"node": "1"},
         window_s=900.0),
    dict(name="dlrover_tpu_*", window_s=3600.0, resolution_s=30.0),
    dict(name="dlrover_tpu_node_hbm_used_mb", resolution_s=500.0),
    dict(name="other_series", window_s=20000.0),
    dict(name="absent"),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(tiers=(5.0, 50.0), raw_capacity=16, tier_capacity=8,
         max_series=6),
])
def test_query_payload_and_tiers_equal_jax(seed, kwargs):
    stream = _ingests(seed)
    jstore, _, jaccepted = _play(jtsdb, stream, **kwargs)
    tstore, _, taccepted = _play(ttsdb, stream, **kwargs)
    assert taccepted == jaccepted
    assert tstore.export_state() == jstore.export_state()
    assert tstore.tiers() == jstore.tiers()
    assert tstore.stats() == jstore.stats()
    for query in QUERIES:
        want = json.dumps(jstore.query_payload(**query))
        got = json.dumps(tstore.query_payload(**query))
        assert got == want, query
    # the store never exceeds the bound its construction states
    stats = tstore.stats()
    assert stats["approx_bytes"] <= stats["memory_bound_bytes"]
    if kwargs:
        assert stats["series"] == 6 and stats["dropped_series"] > 0
        assert all(len(s["tiers"]["5.0"]) <= 8
                   for s in tstore.export_state()["series"])


def test_sidecar_round_trip_and_jax_file(tmp_path):
    stream = _ingests(3, n=300)
    tstore, _, _ = _play(ttsdb, stream)
    jstore, _, _ = _play(jtsdb, stream)
    sidecar = ttsdb.TimeSeriesSidecar(str(tmp_path / "port"))
    assert sidecar.save(tstore)
    assert not sidecar.save(tstore, gate=lambda: True)   # fenced
    restored = ttsdb.TimeSeriesStore(clock=FakeClock())
    assert sidecar.load(restored) == tstore.stats()["series"]
    assert restored.export_state() == tstore.export_state()
    # raw rings restart empty: only the tiers persist
    assert restored.stats()["raw_points"] == 0
    # the JAX package's file reads into the port's store
    jsidecar = jtsdb.TimeSeriesSidecar(str(tmp_path / "jax"))
    assert jsidecar.save(jstore)
    from_jax = ttsdb.TimeSeriesStore(clock=FakeClock())
    ttsdb.TimeSeriesSidecar(str(tmp_path / "jax")).load(from_jax)
    assert from_jax.export_state() == jstore.export_state()
    # a corrupt file reads as absent
    with open(sidecar.path, "r+") as f:
        text = f.read()
        f.seek(0)
        f.write(text.replace('"checksum": "', '"checksum": "0'))
    assert sidecar.load(ttsdb.TimeSeriesStore()) == 0


class _Ledger:
    def __init__(self):
        self.n = 0

    def snapshot(self):
        self.n += 1
        return {"goodput_fraction": 0.5 + 0.01 * self.n,
                "buckets": {"productive": 10.0 * self.n,
                            "restore": 2.0}}


def test_collector_samples_alike():
    """One registry state and one ledger, sampled by both collectors
    over the same ticks: the same points land, a negative sentinel is
    skipped, the ledger's series are fed only where the registry did
    not feed them."""
    runs = []
    for module, registry_cls in ((jtsdb, JRegistry), (ttsdb, TRegistry)):
        registry = registry_cls()
        clock = FakeClock()
        store = module.TimeSeriesStore(clock=clock)
        collector = module.TsdbCollector(
            store, registry=registry, goodput_ledger=_Ledger(),
            sample_interval_s=0.0, flush_interval_s=0.0, clock=clock)
        registry.gauge("dlrover_tpu_training_mfu", "m").set(-1.0)
        speed = registry.gauge("dlrover_tpu_training_steps_per_second",
                               "s")
        hbm = registry.gauge("dlrover_tpu_node_hbm_used_mb", "h",
                             labelnames=("node", "type"))
        registry.gauge("dlrover_tpu_goodput_fraction", "g").set(0.25)
        registry.counter("unsampled_total", "u").inc()
        counts = []
        for tick in range(12):
            clock.t += 5.0
            speed.set(2.0 + math.sin(tick))
            hbm.labels(node="0", type="worker").set(1000.0 + tick)
            counts.append(collector.sample_once())
        collector.flush()          # no state dir: nothing to write
        runs.append((counts, store.export_state(),
                     json.dumps(collector.flight_snapshot(
                         names=("dlrover_tpu_training_steps_per_second",
                                "dlrover_tpu_node_hbm_used_mb")))))
    assert runs[1] == runs[0]
    names = [s["name"] for s in runs[1][1]["series"]]
    assert "dlrover_tpu_training_mfu" not in names
    assert "unsampled_total" not in names
    assert "dlrover_tpu_goodput_seconds_total" in names
