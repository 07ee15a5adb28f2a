"""StepTraceAssembler: join per-step trace records, solve the critical
path, name the rank and phase that gated every step.

Own copy of the JAX package's ``master/steptrace.py`` (stdlib only, held
equal to it by ``tests/test_torch_steptrace.py``). Records (the wire
contract is ``obs/steptrace.py``) arrive over ``TelemetryReport`` and
are joined by ``(generation, step)`` into a bounded ring of groups. Each
group is solved into one attribution: every rank's record is aligned
onto the master's clock (``t0 + off``), the tail rank (latest aligned
end) anchors the walk, and a tail whose dominant phase is
``cross_slice_wait`` hops once to the slice whose gradient header came
last.

Consumers: the tsdb gating series (published once a newer step has
arrived), the diagnosis engine's CriticalPathRule (``summary``), and the
``StepTraceRequest`` RPC and the master's stop-time flight dump
(``query_payload``, pure JSON).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.obs.steptrace import phase_seconds

STEPTRACE_PAYLOAD_VERSION = 1

# phases eligible for attribution after the walk hops the barrier edge:
# the gated side's wait must never be re-attributed as the gating
# slice's wait (one hop, no ping-pong)
_HOP_EXCLUDED = ("cross_slice_wait",)


def _sorted_argmax(items: Dict[str, float]) -> Tuple[str, float]:
    """Deterministic argmax: ties go to the lexicographically first key
    (solves must render byte-identically across runs)."""
    best = max(sorted(items.items()), key=lambda kv: kv[1])
    return best[0], best[1]


def solve_group(gen: int, step: int,
                recs: Dict[int, Dict[str, Any]]) -> Dict[str, Any]:
    """One group's critical-path attribution (pure function of the
    records — benches call this without an assembler). All dict keys in
    the result are strings: the payload must survive a JSON round trip
    unchanged (live RPC and flight dump render identical bytes)."""
    lanes: List[Dict[str, Any]] = []
    ends: Dict[int, float] = {}
    starts: Dict[int, float] = {}
    durs_by_rank: Dict[int, Dict[str, float]] = {}
    for rank in sorted(recs):
        rec = recs[rank]
        base = float(rec.get("t0", 0.0)) + float(rec.get("off", 0.0))
        segs = []
        end_off = 0.0
        for seg in rec.get("phases") or []:
            try:
                name, start, dur = str(seg[0]), float(seg[1]), float(seg[2])
            except (TypeError, ValueError, IndexError):
                continue
            segs.append([name, round(start, 6), round(max(0.0, dur), 6)])
            end_off = max(end_off, start + max(0.0, dur))
        starts[rank] = base
        ends[rank] = base + end_off
        durs_by_rank[rank] = phase_seconds(rec)
        lanes.append({
            "rank": rank,
            "slice": int(rec.get("slice", -1)),
            "start": round(base, 6),
            "err": float(rec.get("err", -1.0)),
            "phases": segs,
            "peers": {str(k): float(v)
                      for k, v in (rec.get("peers") or {}).items()},
        })
    if not lanes:
        return {}
    t_min = min(starts.values())
    t_max = max(ends.values())
    # anchor: the tail rank (latest aligned end; ties to lowest rank)
    tail_rank = min(r for r in ends if ends[r] == t_max)
    tail_rec = recs[tail_rank]
    tail_durs = durs_by_rank[tail_rank]
    gating_rank, hopped = tail_rank, False
    gating_phase, gating_s = (_sorted_argmax(tail_durs)
                              if tail_durs else ("", 0.0))
    if gating_phase == "cross_slice_wait":
        peers = tail_rec.get("peers") or {}
        if peers:
            # slowest input edge of the join: the last-observed peer
            last_sid, _ = _sorted_argmax(
                {str(k): float(v) for k, v in peers.items()})
            try:
                last_sid_i = int(last_sid)
            except ValueError:
                last_sid_i = -1
            if last_sid_i != int(tail_rec.get("slice", -1)):
                cands = [r for r in sorted(recs)
                         if int(recs[r].get("slice", -2)) == last_sid_i]
                if cands:
                    peer_rank = max(cands, key=lambda r: (ends[r], -r))
                    pdurs = {k: v
                             for k, v in durs_by_rank[peer_rank].items()
                             if k not in _HOP_EXCLUDED}
                    if pdurs:
                        gating_rank, hopped = peer_rank, True
                        gating_phase, gating_s = _sorted_argmax(pdurs)
    span_s = max(0.0, t_max - t_min)
    cross_wait = max((d.get("cross_slice_wait", 0.0)
                      for d in durs_by_rank.values()), default=0.0)
    errs = [ln["err"] for ln in lanes if ln["err"] >= 0.0]
    return {
        "step": int(step),
        "gen": int(gen),
        "t0": round(t_min, 6),
        "span_s": round(span_s, 6),
        "gating_rank": int(gating_rank),
        "gating_phase": gating_phase,
        "gating_s": round(gating_s, 6),
        "hopped": hopped,
        "cross_slice_wait_s": round(cross_wait, 6),
        "cross_slice_wait_fraction": round(
            cross_wait / span_s if span_s > 0 else 0.0, 6),
        "clock_err_max": round(max(errs), 6) if errs else -1.0,
        "lanes": lanes,
    }


def summarize_solved(solved: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Windowed attribution over solved groups: gating share per rank,
    dominant phase, mean cross-slice-wait fraction. Pure (benches fold
    this shape into their JSON)."""
    by_rank: Dict[str, Dict[str, Any]] = {}
    frac_sum = 0.0
    for group in solved:
        if not group:
            continue
        rank = str(group.get("gating_rank", -1))
        entry = by_rank.setdefault(
            rank, {"gating_steps": 0, "gating_s": 0.0, "phases": {}})
        entry["gating_steps"] += 1
        entry["gating_s"] = round(
            entry["gating_s"] + float(group.get("gating_s", 0.0)), 6)
        phase = str(group.get("gating_phase", ""))
        entry["phases"][phase] = round(
            entry["phases"].get(phase, 0.0)
            + float(group.get("gating_s", 0.0)), 6)
        frac_sum += float(group.get("cross_slice_wait_fraction", 0.0))
    steps = sum(e["gating_steps"] for e in by_rank.values())
    dominant_phase, dominant_rank = "", -1
    if by_rank:
        rank_str, _ = _sorted_argmax(
            {r: float(e["gating_steps"]) for r, e in by_rank.items()})
        dominant_rank = int(rank_str)
        phases: Dict[str, float] = {}
        for entry in by_rank.values():
            for phase, secs in entry["phases"].items():
                phases[phase] = phases.get(phase, 0.0) + secs
        if phases:
            dominant_phase, _ = _sorted_argmax(phases)
    return {
        "steps": steps,
        "by_rank": by_rank,
        "dominant_gating_rank": dominant_rank,
        "dominant_gating_phase": dominant_phase,
        "cross_slice_wait_fraction": round(
            frac_sum / steps if steps else -1.0, 6),
    }


class StepTraceAssembler:
    """Bounded ring of per-step record groups + cached solves.

    Ingest runs on the telemetry drainer thread (already off the RPC
    hot path); solving a group is a few dict scans, tsdb feeds are
    in-memory. Groups older than the newest step seen are published to
    the tsdb exactly once (records for a step keep arriving while the
    fleet runs the next one — publishing on arrival would emit half
    -joined attributions)."""

    def __init__(self, tsdb=None, registry=None,
                 ring_steps: Optional[int] = None,
                 summary_window: int = 64):
        self._lock = threading.Lock()
        self._tsdb = tsdb
        self._registry = registry or obs.get_registry()
        self._ring_steps = max(
            1, int(ring_steps if ring_steps is not None
                   else Context.singleton().steptrace_ring_steps))
        self._summary_window = max(1, int(summary_window))
        # (gen, step) -> {"recs": {rank: record}, "published": bool,
        #                 "solved": Optional[dict]}
        self._groups: "OrderedDict[Tuple[int, int], Dict[str, Any]]" = (
            OrderedDict())
        self._records_total = 0
        self._dropped = 0

    # -- ingest ------------------------------------------------------------
    def ingest(self, records: List[Any], node_rank: int = -1) -> int:
        """Join a telemetry batch; returns how many records were
        accepted. Malformed records are counted and dropped, never
        raised — the wire is telemetry."""
        accepted = 0
        with self._lock:
            for rec in records or []:
                if not self._ingest_one(rec, node_rank):
                    self._dropped += 1
                    continue
                accepted += 1
                self._records_total += 1
            if accepted:
                self._publish_older_locked()
        try:
            if accepted:
                self._registry.counter(
                    "dlrover_tpu_steptrace_records_total",
                    "Per-step trace records joined by the assembler",
                ).inc(accepted)
            if records and accepted < len(records):
                self._registry.counter(
                    "dlrover_tpu_steptrace_dropped_total",
                    "Malformed per-step trace records dropped at ingest",
                ).inc(len(records) - accepted)
        except Exception:  # noqa: BLE001 — telemetry must never raise
            pass
        return accepted

    def _ingest_one(self, rec: Any, node_rank: int) -> bool:
        if not isinstance(rec, dict):
            return False
        try:
            step = int(rec["step"])
            gen = int(rec.get("gen", 0))
            rank = int(rec.get("rank", -1))
        except (KeyError, TypeError, ValueError):
            return False
        if rank < 0:
            rank = int(node_rank)
        if step < 0 or rank < 0:
            return False
        if not isinstance(rec.get("phases"), list):
            return False
        key = (gen, step)
        group = self._groups.get(key)
        if group is None:
            group = {"recs": {}, "published": False, "solved": None}
            self._groups[key] = group
            while len(self._groups) > self._ring_steps:
                self._groups.popitem(last=False)
        group["recs"][rank] = rec
        group["solved"] = None  # new member invalidates the cached solve
        return True

    def _publish_older_locked(self) -> None:
        if self._tsdb is None:
            return
        newest = max(self._groups)
        for key, group in self._groups.items():
            if group["published"] or key >= newest:
                continue
            group["published"] = True
            solved = self._solve_locked(key, group)
            if not solved:
                continue
            self._tsdb.ingest("dlrover_tpu_steptrace_gating_rank",
                              float(solved["gating_rank"]))
            self._tsdb.ingest(
                "dlrover_tpu_steptrace_gating_seconds",
                float(solved["gating_s"]),
                labels={"phase": solved["gating_phase"] or "unknown"})
            self._tsdb.ingest(
                "dlrover_tpu_steptrace_cross_slice_wait_fraction",
                float(solved["cross_slice_wait_fraction"]))

    def _solve_locked(self, key: Tuple[int, int],
                      group: Dict[str, Any]) -> Dict[str, Any]:
        if group["solved"] is None:
            group["solved"] = solve_group(key[0], key[1], group["recs"])
        return group["solved"]

    # -- queries -----------------------------------------------------------
    def query_payload(self, start_step: int = -1, end_step: int = -1,
                      last_n: int = 0) -> Dict[str, Any]:
        """Assembled steps + windowed summary as pure JSON (the single
        shape the live RPC and the flight embed share, byte for byte)."""
        with self._lock:
            keys = sorted(self._groups)
            if start_step >= 0:
                keys = [k for k in keys if k[1] >= start_step]
            if end_step >= 0:
                keys = [k for k in keys if k[1] <= end_step]
            if last_n > 0:
                keys = keys[-last_n:]
            solved = [self._solve_locked(k, self._groups[k]) for k in keys]
            window = [self._solve_locked(k, self._groups[k])
                      for k in sorted(self._groups)[-self._summary_window:]]
        solved = [s for s in solved if s]
        return {
            "version": STEPTRACE_PAYLOAD_VERSION,
            "steps": solved,
            "summary": summarize_solved([s for s in window if s]),
        }

    def summary(self) -> Dict[str, Any]:
        """The windowed attribution alone (DiagnosisSnapshot evidence)."""
        with self._lock:
            window = [self._solve_locked(k, self._groups[k])
                      for k in sorted(self._groups)[-self._summary_window:]]
        return summarize_solved([s for s in window if s])

    def flight_snapshot(self, last_n: int = 128) -> Dict[str, Any]:
        """The stop-time flight embed: the same payload the live RPC
        serves, so a postmortem waterfall renders byte-identically from
        the dump."""
        return self.query_payload(last_n=last_n)

    def evict(self, rank: int) -> None:
        """A reaped rank's records leave every retained group (mirrors
        the servicer's speed/diagnosis eviction): a departed worker must
        not keep gating history it can no longer update."""
        with self._lock:
            for group in self._groups.values():
                if group["recs"].pop(int(rank), None) is not None:
                    group["solved"] = None

    def evict_departed(self, live) -> None:
        """Evict every rank not in ``live`` (the servicer's post-reap
        sweep — same contract as SpeedMonitor.evict_departed)."""
        alive = {int(r) for r in live}
        with self._lock:
            seen = set()
            for group in self._groups.values():
                seen.update(group["recs"])
        for rank in sorted(seen - alive):
            self.evict(rank)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"groups": len(self._groups),
                    "records_total": self._records_total,
                    "dropped": self._dropped}
