"""The master's time-series store: bounded, multi-resolution history.

Own copy of the JAX package's ``obs/tsdb.py`` (stdlib only, held equal to
it by ``tests/test_torch_tsdb.py``). :class:`TimeSeriesStore` keeps
labeled series as a raw ring plus downsampled tiers (count, sum, min,
max and last per aligned bucket), bounded by construction, and answers
the windowed, aligned ``TimeSeriesQuery`` RPC (``query_payload``). Its
clock is injectable: retention and downsampling are tested over fake
time.

:class:`TsdbCollector` samples the allowlisted registry gauges and the
goodput ledger into the store on the master's cadence.
:class:`TimeSeriesSidecar` persists the downsampled tiers to a
checksummed file in the master's state directory (the raw ring does not
persist): the master builds its collector with ``state_dir``, and a
restarted master or a promoted standby reloads the history from it.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch.common.log import default_logger as logger

TSDB_VERSION = 1
SIDECAR_NAME = "tsdb-state.json"

# raw points per series (report-cadence feeds; ~20 min at 5 s)
RAW_CAPACITY = 240
# buckets per downsampled tier per series
TIER_CAPACITY = 180
# tier resolutions, finest first: 180 buckets give 30 min / 3 h / 15 h
# of aligned history per tier — "the last ten minutes" answers from the
# finest tier, "since yesterday" from the coarsest
DEFAULT_TIERS = (10.0, 60.0, 300.0)
# distinct labeled series retained; past it, NEW series are dropped
# (counted) — an unbounded label space must not grow the master
MAX_SERIES = 512

# bucket layout: [start_ts, count, sum, min, max, last]
_B_TS, _B_COUNT, _B_SUM, _B_MIN, _B_MAX, _B_LAST = range(6)


def _labels_key(labels: Optional[Dict[str, str]]
                ) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Tier:
    """One downsampled resolution: a bounded ring of aligned buckets."""

    def __init__(self, resolution_s: float,
                 capacity: int = TIER_CAPACITY):
        self.resolution_s = float(resolution_s)
        self.buckets: deque = deque(maxlen=capacity)

    def ingest(self, ts: float, value: float) -> None:
        start = (ts // self.resolution_s) * self.resolution_s
        if self.buckets:
            last = self.buckets[-1]
            if last[_B_TS] == start:
                last[_B_COUNT] += 1
                last[_B_SUM] += value
                last[_B_MIN] = min(last[_B_MIN], value)
                last[_B_MAX] = max(last[_B_MAX], value)
                last[_B_LAST] = value
                return
            if start < last[_B_TS]:
                # a late point behind the open bucket (clock skew on a
                # remote feed): fold into its bucket when still retained,
                # drop otherwise — never un-order the ring
                for bucket in reversed(self.buckets):
                    if bucket[_B_TS] == start:
                        bucket[_B_COUNT] += 1
                        bucket[_B_SUM] += value
                        bucket[_B_MIN] = min(bucket[_B_MIN], value)
                        bucket[_B_MAX] = max(bucket[_B_MAX], value)
                        return
                    if bucket[_B_TS] < start:
                        break
                return
        self.buckets.append([start, 1, value, value, value, value])

    def export(self) -> List[List[float]]:
        return [list(b) for b in self.buckets]

    def restore(self, buckets: Sequence[Sequence[float]]) -> None:
        self.buckets.clear()
        for raw in buckets:
            if isinstance(raw, (list, tuple)) and len(raw) == 6:
                self.buckets.append([float(x) for x in raw])


class _Series:
    def __init__(self, name: str, labels: Dict[str, str],
                 tiers: Sequence[float], raw_capacity: int,
                 tier_capacity: int):
        self.name = name
        self.labels = dict(labels)
        self.raw: deque = deque(maxlen=raw_capacity)
        self.tiers = [_Tier(r, tier_capacity) for r in tiers]

    def ingest(self, ts: float, value: float) -> None:
        self.raw.append((ts, value))
        for tier in self.tiers:
            tier.ingest(ts, value)


class TimeSeriesStore:
    """Bounded multi-resolution store of labeled numeric series.

    Thread-safe: fed from servicer threads (step reports) and the
    collector's sampling thread, read by query RPCs and exports —
    everything goes through one lock; ``ingest`` is an append plus one
    bucket update per tier (microseconds; the overhead-bound test in
    tests/test_fleet_tsdb.py pins it under 1 % of a CPU bench step).
    """

    def __init__(self, tiers: Sequence[float] = DEFAULT_TIERS,
                 raw_capacity: int = RAW_CAPACITY,
                 tier_capacity: int = TIER_CAPACITY,
                 max_series: int = MAX_SERIES,
                 clock: Callable[[], float] = time.time):
        if not tiers:
            raise ValueError("at least one downsampled tier is required")
        self._tiers = tuple(sorted(float(t) for t in tiers))
        self._raw_capacity = int(raw_capacity)
        self._tier_capacity = int(tier_capacity)
        self._max_series = int(max_series)
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                           _Series] = {}
        self._dropped_series = 0
        self._ingested = 0

    # -- write path --------------------------------------------------------
    def ingest(self, name: str, value: float,
               labels: Optional[Dict[str, str]] = None,
               ts: Optional[float] = None) -> bool:
        """Append one point. Returns False when the series cap refused a
        NEW series (existing series always ingest)."""
        try:
            value = float(value)
        except (TypeError, ValueError):
            return False
        if value != value:           # NaN poisons min/max aggregates
            return False
        key = (str(name), _labels_key(labels))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self._max_series:
                    self._dropped_series += 1
                    return False
                series = _Series(key[0], dict(key[1]), self._tiers,
                                 self._raw_capacity,
                                 self._tier_capacity)
                self._series[key] = series
            series.ingest(self._clock() if ts is None else float(ts),
                          value)
            self._ingested += 1
        return True

    # -- read path ---------------------------------------------------------
    def names(self) -> List[str]:
        with self._lock:
            return sorted({key[0] for key in self._series})

    def tiers(self) -> List[Dict[str, float]]:
        """The store's resolution ladder (raw + downsampled), with the
        per-series coverage each tier can answer."""
        with self._lock:
            tiers = self._tiers
            raw_cap, tier_cap = self._raw_capacity, self._tier_capacity
        out = [{"resolution_s": 0.0, "capacity": raw_cap,
                "kind": "raw"}]
        for res in tiers:
            out.append({"resolution_s": res,
                        "capacity": tier_cap,
                        "coverage_s": res * tier_cap,
                        "kind": "downsampled"})
        return out

    def _match_locked(self, name: str,
                      labels: Optional[Dict[str, str]]) -> List[_Series]:
        """Exact name (or prefix when it ends with ``*``) + label-subset
        match, deterministic order."""
        want = _labels_key(labels)
        prefix = name.endswith("*")
        stem = name[:-1] if prefix else name
        out = []
        for key in sorted(self._series):
            if (key[0].startswith(stem) if prefix else key[0] == stem):
                if all(pair in key[1] for pair in want):
                    out.append(self._series[key])
        return out

    def _pick_resolution(self, window_s: float, resolution_s: float,
                         series: Optional[_Series] = None,
                         start: float = 0.0) -> float:
        """0 = auto: raw when the series' raw ring actually spans the
        window, else the finest tier that covers it; an explicit
        request snaps UP to the nearest available tier (asking for
        30 s granularity must not silently answer 10 s buckets the
        caller will mis-align)."""
        if resolution_s > 0:
            for res in self._tiers:
                if res >= resolution_s - 1e-9:
                    return res
            return self._tiers[-1]
        if window_s <= 0:
            # unbounded read: raw only when the ring actually reaches
            # back to the oldest retained history. After a restart or
            # standby promotion the raw ring deliberately restarts
            # empty while the restored tiers hold hours — answering
            # raw there would read as "history lost"; a wrapped ring
            # similarly hides everything the tiers still retain.
            if series is None:
                return 0.0
            oldest = min((t.buckets[0][_B_TS] for t in series.tiers
                          if t.buckets), default=None)
            if oldest is None:
                return 0.0
            if series.raw and series.raw[0][0] <= oldest + self._tiers[-1]:
                return 0.0
            # finest tier that still reaches the oldest retained data.
            # Tiers align to different grids, so the coarsest bucket's
            # START can precede a finer tier's by up to one coarse
            # bucket with no history lost — the slack is the coarsest
            # resolution, not each tier's own.
            for tier in series.tiers:
                if tier.buckets and tier.buckets[0][_B_TS] \
                        <= oldest + self._tiers[-1]:
                    return tier.resolution_s
            return self._tiers[-1]
        if series is not None and series.raw \
                and series.raw[0][0] <= start:
            return 0.0
        for res in self._tiers:
            if res * self._tier_capacity >= window_s:
                return res
        return self._tiers[-1]

    def query(self, name: str,
              labels: Optional[Dict[str, str]] = None,
              window_s: float = 0.0,
              resolution_s: float = 0.0,
              end_ts: Optional[float] = None) -> List[Dict[str, Any]]:
        """Windowed, aligned read. Each result dict:
        ``{"name", "labels", "resolution_s", "points"}`` where points
        are ``[ts, value]`` for raw reads and
        ``[bucket_start, mean, min, max, count, last]`` for tier reads
        (``last`` = the newest value that landed in the bucket — what a
        "current value" tile should show; the mean of a ramping open
        bucket is history, not now), ascending, bucket starts aligned
        to the resolution grid."""
        now = self._clock() if end_ts is None else float(end_ts)
        start = now - window_s if window_s > 0 else float("-inf")
        with self._lock:
            matched = self._match_locked(name, labels)
            out = []
            for series in matched:
                chosen = self._pick_resolution(window_s, resolution_s,
                                               series=series,
                                               start=start)
                if chosen <= 0.0:
                    points = [[ts, value] for ts, value in series.raw
                              if start <= ts <= now]
                else:
                    tier = next(t for t in series.tiers
                                if t.resolution_s == chosen)
                    points = [
                        [b[_B_TS],
                         b[_B_SUM] / b[_B_COUNT] if b[_B_COUNT] else 0.0,
                         b[_B_MIN], b[_B_MAX], int(b[_B_COUNT]),
                         b[_B_LAST]]
                        for b in tier.buckets
                        if start <= b[_B_TS] <= now]
                out.append({"name": series.name,
                            "labels": dict(series.labels),
                            "resolution_s": chosen,
                            "points": points})
        return out

    def query_payload(self, name: str = "",
                      labels: Optional[Dict[str, str]] = None,
                      window_s: float = 0.0,
                      resolution_s: float = 0.0) -> Dict[str, Any]:
        """The RPC answer shape (master/servicer.py TimeSeriesQuery):
        matched series plus the tier ladder and the store's bounded-
        memory stats; an empty ``name`` lists series names only."""
        payload: Dict[str, Any] = {
            "version": TSDB_VERSION,
            "tiers": self.tiers(),
            "stats": self.stats(),
        }
        if name:
            payload["series"] = self.query(name, labels=labels,
                                           window_s=window_s,
                                           resolution_s=resolution_s)
        else:
            payload["names"] = self.names()
        return payload

    # -- bounded memory ----------------------------------------------------
    def memory_bound_bytes(self) -> int:
        """The hard cap the store can never exceed, from its
        construction parameters (asserted in tests)."""
        with self._lock:
            return self._memory_bound_locked()

    def _memory_bound_locked(self) -> int:
        """(lock held) per-series raw + tier floats at 8 bytes plus a
        generous per-point/bucket python overhead factor."""
        per_series = (self._raw_capacity * 2
                      + len(self._tiers) * self._tier_capacity * 6)
        # ~56 bytes per boxed float + list/tuple overhead, rounded up
        return self._max_series * per_series * 64

    def stats(self) -> Dict[str, int]:
        with self._lock:
            points = sum(len(s.raw) for s in self._series.values())
            buckets = sum(len(t.buckets) for s in self._series.values()
                          for t in s.tiers)
            return {
                "series": len(self._series),
                "max_series": self._max_series,
                "raw_points": points,
                "tier_buckets": buckets,
                "ingested_total": self._ingested,
                "dropped_series": self._dropped_series,
                "approx_bytes": (points * 2 + buckets * 6) * 64,
                "memory_bound_bytes": self._memory_bound_locked(),
            }

    # -- persistence (downsampled tiers only) ------------------------------
    def export_state(self) -> Dict[str, Any]:
        with self._lock:
            series = []
            for key in sorted(self._series):
                s = self._series[key]
                series.append({
                    "name": s.name,
                    "labels": dict(s.labels),
                    "tiers": {str(t.resolution_s): t.export()
                              for t in s.tiers},
                })
            return {"version": TSDB_VERSION,
                    "tiers": list(self._tiers),
                    "series": series}

    def restore_state(self, state: Dict[str, Any]) -> int:
        """Rehydrate downsampled history (raw rings restart empty — the
        dead master's sub-tier points are covered by the first tier).
        Series past the cap are dropped, counted. Returns the number of
        series restored."""
        if not isinstance(state, dict):
            return 0
        restored = 0
        for record in state.get("series", []):
            if not isinstance(record, dict) or not record.get("name"):
                continue
            labels = record.get("labels") or {}
            key = (str(record["name"]), _labels_key(labels))
            with self._lock:
                series = self._series.get(key)
                if series is None:
                    if len(self._series) >= self._max_series:
                        self._dropped_series += 1
                        continue
                    series = _Series(key[0], dict(key[1]), self._tiers,
                                     self._raw_capacity,
                                     self._tier_capacity)
                    self._series[key] = series
                tiers = record.get("tiers") or {}
                for tier in series.tiers:
                    buckets = tiers.get(str(tier.resolution_s))
                    if buckets:
                        tier.restore(buckets)
                restored += 1
        return restored


class TimeSeriesSidecar:
    """Checksummed atomic persistence for the store's downsampled tiers,
    one file in the master's state directory (atomic tmp+rename + sha256
    discipline; a torn write leaves the previous file, a corrupt one
    reads as absent — history loss is bounded by the flush cadence,
    never a crashed restore)."""

    def __init__(self, directory: str):
        self._path = os.path.join(directory, SIDECAR_NAME)
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        return self._path

    @staticmethod
    def _checksum(payload: str) -> str:
        return hashlib.sha256(payload.encode("utf-8")).hexdigest()

    def save(self, store: TimeSeriesStore,
             gate: Optional[Callable[[], bool]] = None) -> bool:
        # fence check at the writer itself, not only in the collector's
        # flush cadence: a deposed master's direct save must not clobber
        # the promoted master's history file either
        if gate is not None and gate():
            return False
        state = store.export_state()
        payload = json.dumps(state, sort_keys=True,
                             separators=(",", ":"))
        wrapper = {"version": TSDB_VERSION,
                   "checksum": self._checksum(payload),
                   "state": state}
        try:
            # pid+thread unique: a stop-time flush racing the cadence
            # flush must not interleave writes into one tmp file and
            # rename torn JSON over the history
            tmp = (f"{self._path}.{os.getpid()}"
                   f".{threading.get_ident()}.tmp")
            with open(tmp, "w") as f:
                json.dump(wrapper, f)
            os.replace(tmp, self._path)
            return True
        except OSError:
            return False

    def load(self, store: TimeSeriesStore) -> int:
        """Restore into ``store``; 0 on missing/corrupt (absence is the
        fresh-job normal, corruption is logged by the caller via the
        return value)."""
        try:
            with open(self._path) as f:
                wrapper = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return 0
        state = wrapper.get("state")
        if not isinstance(state, dict):
            return 0
        payload = json.dumps(state, sort_keys=True,
                             separators=(",", ":"))
        if self._checksum(payload) != wrapper.get("checksum"):
            return 0
        return store.restore_state(state)


# gauge/counter families the collector samples into the store each tick
# (the "fleet vitals" allowlist — an unbounded registry must not become
# an unbounded series space; per-rank device truth additionally arrives
# through the servicer's step-report ingest)
COLLECTED_PREFIXES = (
    "dlrover_tpu_training_",            # step / steps_s / tokens_s / mfu
    "dlrover_tpu_slice_",               # per-slice rollups + degraded
    "dlrover_tpu_worker_straggler_score",
    "dlrover_tpu_worker_data_wait_fraction",
    # dlrover_tpu_worker_mfu is deliberately NOT sampled here: the
    # servicer already ingests it per step report under {node} —
    # resampling the diagnosis registry gauge (labeled node+slice)
    # would store a second, differently-labeled series per rank
    # (double the 512-cap cost, ambiguous label-subset queries)
    "dlrover_tpu_node_hbm_",            # used + peak watermark MB
    "dlrover_tpu_node_cpu_percent",
    "dlrover_tpu_goodput_",
    "dlrover_tpu_elasticity_events_total",
    "dlrover_tpu_capacity_offers_",     # open gauge + lifecycle counter
    "dlrover_tpu_autoscale_",           # decisions + quarantined classes
)

# the dashboard's series set: what flight_snapshot embeds in the
# master's flight dump (the JAX package's tools/top.py renders the same
# set live and from a dump)
DASHBOARD_SERIES = (
    "dlrover_tpu_training_steps_per_second",
    "dlrover_tpu_training_mfu",
    "dlrover_tpu_training_global_step",
    "dlrover_tpu_goodput_fraction",
    "dlrover_tpu_slice_steps_per_second",
    "dlrover_tpu_slice_mfu",
    "dlrover_tpu_slice_workers",
    "dlrover_tpu_worker_hbm_peak_mb",
    "dlrover_tpu_node_hbm_used_mb",
    "dlrover_tpu_steptrace_gating_rank",
    "dlrover_tpu_steptrace_gating_seconds",
    "dlrover_tpu_steptrace_cross_slice_wait_fraction",
    "dlrover_tpu_capacity_offers_open",
    "dlrover_tpu_autoscale_quarantined_classes",
)


class TsdbCollector:
    """Master-side sampler + flusher: every ``sample_interval_s`` it
    snapshots the allowlisted registry gauges and the goodput ledger
    into the store, and every ``flush_interval_s`` it persists the
    downsampled tiers through the sidecar. Injectable clock + manual
    ``sample_once``/``flush`` so tests drive it without threads."""

    def __init__(self, store: TimeSeriesStore, registry=None,
                 goodput_ledger=None, state_dir: str = "",
                 sample_interval_s: Optional[float] = None,
                 flush_interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time):
        from dlrover_tpu_torch.common.config import Context
        from dlrover_tpu_torch.obs.metrics import get_registry

        ctx = Context.singleton()
        self._store = store
        self._registry = registry if registry is not None \
            else get_registry()
        self._goodput = goodput_ledger
        self._sample_interval_s = (
            sample_interval_s if sample_interval_s is not None
            else ctx.tsdb_sample_interval_s)
        self._flush_interval_s = (
            flush_interval_s if flush_interval_s is not None
            else ctx.tsdb_flush_interval_s)
        self._clock = clock
        self._sidecar = (TimeSeriesSidecar(state_dir)
                         if state_dir else None)
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_flush = 0.0
        # fence gate (wired by JobMaster in shared-state-dir setups):
        # a callable answering True when a higher-generation master
        # owns the lineage — a superseded primary's collector must
        # stop overwriting the promoted master's sidecar history
        self.gate: Optional[Callable[[], bool]] = None

    def restore(self) -> int:
        """Reload persisted history (master restart / standby
        promotion); 0 without a state dir or prior file."""
        if self._sidecar is None:
            return 0
        return self._sidecar.load(self._store)

    def sample_once(self, ts: Optional[float] = None) -> int:
        """One sampling tick; returns the number of points ingested."""
        now = self._clock() if ts is None else float(ts)
        count = 0
        fed = set()
        for name, labels, value in self._registry.sample_values(
                COLLECTED_PREFIXES):
            fed.add((name, _labels_key(labels or None)))
            # every allowlisted family is physically non-negative; a
            # negative reading is a "no evidence yet" sentinel (e.g.
            # training_mfu = -1 before a FLOPs model arrives) that
            # would poison bucket mins/means as fake data
            if isinstance(value, (int, float)) and value < 0:
                continue
            if self._store.ingest(name, value, labels=labels or None,
                                  ts=now):
                count += 1
        if self._goodput is not None:
            try:
                snap = self._goodput.snapshot()
            except Exception:  # noqa: BLE001 — evidence, not liveness
                snap = {}
            if snap:
                # one feed per series: the master registry already
                # carries the ledger's fraction gauge + seconds counter
                # (obs/goodput.py registers them), so the manual ingest
                # only covers bare-ledger wirings whose registry did
                # not emit the series this tick — double-landing the
                # same tick would double bucket counts/sums and fill
                # the raw ring at 2x
                if ("dlrover_tpu_goodput_fraction", ()) not in fed \
                        and self._store.ingest(
                            "dlrover_tpu_goodput_fraction",
                            float(snap.get("goodput_fraction", 0.0)),
                            ts=now):
                    count += 1
                for bucket, seconds in (snap.get("buckets")
                                        or {}).items():
                    key = ("dlrover_tpu_goodput_seconds_total",
                           (("bucket", str(bucket)),))
                    if key not in fed and self._store.ingest(
                            key[0], float(seconds),
                            {"bucket": str(bucket)}, ts=now):
                        count += 1
        return count

    def flush(self) -> bool:
        """Persist the downsampled tiers now (collector cadence, master
        stop, and tests). A fenced master (see ``gate``) keeps its
        cadence but never touches the file again."""
        if self._sidecar is None:
            return False
        # cadence marker only: stop() joins the loop before its final
        # flush, and a raced float write merely shifts one interval
        self._last_flush = self._clock()
        if self.gate is not None and self.gate():
            return False
        return self._sidecar.save(self._store, gate=self.gate)

    def start(self) -> None:
        if self._sample_interval_s <= 0 or self._thread is not None:
            return
        self._stopped.clear()
        thread = threading.Thread(target=self._loop, daemon=True,
                                  name="tsdb-collector")
        self._thread = thread
        thread.start()

    def stop(self) -> None:
        self._stopped.set()
        thread, self._thread = self._thread, None
        # join before the final flush: a loop iteration mid-flush must
        # finish first (the tmp names are unique, but two concurrent
        # saves could still rename out of order — older over newer)
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)
        self.flush()

    def _loop(self) -> None:
        failing = False
        while not self._stopped.wait(self._sample_interval_s):
            try:
                self.sample_once()
                if (self._flush_interval_s > 0
                        and self._clock() - self._last_flush
                        >= self._flush_interval_s):
                    self.flush()
                failing = False
            except Exception:  # noqa: BLE001 — sampling must survive
                # a bad tick; the store is observability, not the job.
                # Logged once per failure STREAK: a persistently
                # unwritable state dir means silent history loss the
                # operator must hear about, but not once per second.
                if not failing:
                    logger.exception("tsdb collector tick failed "
                                     "(suppressing repeats until one "
                                     "succeeds)")
                failing = True

    def flight_snapshot(self, window_s: float = 900.0,
                        resolution_s: float = 0.0,
                        names: Sequence[str] = ()) -> Dict[str, Any]:
        """A compact dict of recent history for the master's flight
        dump (sparklines render from it without a live master)."""
        wanted = list(names) or list(DASHBOARD_SERIES)
        series = []
        for name in wanted:
            series.extend(self._store.query(
                name, window_s=window_s, resolution_s=resolution_s))
        return {"version": TSDB_VERSION, "window_s": window_s,
                "series": series, "stats": self._store.stats()}
