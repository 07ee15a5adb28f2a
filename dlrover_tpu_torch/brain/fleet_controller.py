"""Goodput-optimal fleet controller: the diagnosis→actuation loop.

Own copy of the JAX package's ``brain/fleet_controller.py``. The master's
telemetry (the goodput ledger, the step-trace critical path, the plan
calibration, the speed monitor, the diagnosis chain) measures; this
module acts on it. On a fixed cadence the controller decides one of
three things:

- **claim** an offered preemptible slice: the productive time the offer
  would add (its remaining lifetime × the fleet's windowed goodput
  fraction) must beat the join+re-plan cost, estimated from the ledger's
  own recent elasticity incarnations, by ``autoscale_claim_margin``;
- **shed** the slowest slice: the step-trace summary names one rank as
  dominating the critical path AND the cross-slice wait fraction
  exceeds ``autoscale_shed_wait_fraction``. The shed drains the rank's
  slice as a unit (slice mode); a sliceless fleet, or a fleet of one
  slice, is never shed;
- **hold**: anything else, and every candidate blocked by a guardrail
  (hysteresis, cooldown, hourly rate limit, quarantine, an open watchdog
  window). A hold with a live candidate is recorded: "we saw it and
  deliberately did nothing" is a decision.

Every actuation goes through the existing machinery: a shed is a
synthetic advance-notice drain (the servicer's drain chain), a claim is
granted by the :class:`CapacityProvider` (whose local implementation the
chaos grammar and test harnesses drive) and the new capacity joins
through an ordinary rendezvous round and re-plan. Each decision lands as
a diagnosis report, a flight event and, for an actuation, a ledger
incarnation priced under the ``autoscale`` elasticity kind. The metric
and flight-event names are the JAX package's.

The **rollback watchdog** guards every actuation: the windowed goodput
fraction at actuation time is the baseline; ``autoscale_rollback_window_s``
later the window is read again, and a drop beyond
``autoscale_rollback_drop_fraction`` reverts the actuation (a bad claim
sheds what it claimed) and quarantines that decision class with a
backoff that doubles per consecutive rollback (capped 8×). A market
revocation of a slice under watch cancels the watch without penalty.

Threading: ``evaluate_once`` runs serialized on the controller loop (or
a test caller); shared state is guarded by ``self._lock``; registry and
flight-recorder operations happen outside the lock. The clock is
injectable, so guardrail tests run on a fake clock. ``export_state`` is
the JAX controller's JSON, and either package restores the other's.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.log import default_logger as logger

_DECISION_RING = 128       # decisions retained in memory
_PERSISTED_DECISIONS = 64  # newest decisions carried in state snapshots
# join+re-plan price before the ledger has observed one (a deliberately
# conservative figure: one rendezvous round + restore at small scale)
_DEFAULT_ACTUATION_COST_S = 45.0
_COST_SAMPLE_INCARNATIONS = 4   # recent incarnations averaged for cost
_QUARANTINE_MAX_MULTIPLIER = 8  # backoff cap: 8 × base quarantine
# an offer with no TTL is priced over this assumed lifetime
_DEFAULT_OFFER_LIFETIME_S = 300.0


@dataclasses.dataclass
class CapacityOffer:
    """One open offer of preemptible capacity: ``slices`` whole slices,
    valid for ``ttl_s`` from ``offered_at`` (0 = until revoked)."""

    offer_id: int
    slices: int = 1
    ttl_s: float = 0.0
    offered_at: float = 0.0
    step: int = -1

    def remaining_s(self, now: float) -> float:
        if self.ttl_s <= 0.0:
            return _DEFAULT_OFFER_LIFETIME_S
        return max(0.0, self.ttl_s - (now - self.offered_at))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class CapacityProvider:
    """The spot-market surface the controller sees. Implementations:
    :class:`LocalCapacityProvider` (chaos/test-driven, in-process) now;
    a cloud quota/reservation API adapter is the intended production
    shape — the controller only ever calls these three methods."""

    def open_offers(self) -> List[CapacityOffer]:
        raise NotImplementedError

    def claim(self, offer_id: int) -> Optional[List[int]]:
        """Claim an open offer. Returns the granted slice ids (what the
        rollback path would have to shed), None if the offer is gone."""
        raise NotImplementedError

    def on_revoke(self, fn: Callable[[int, float], None]) -> None:
        """Register the revocation listener (slice_id, grace_s)."""
        raise NotImplementedError


class LocalCapacityProvider(CapacityProvider):
    """In-process spot market: offers arrive from the chaos grammar
    (``offer:slice:+k@step[:ttl]`` → ``ChaosInjector.offer_fn``) or a
    test/bench harness calling :meth:`offer` directly; a claim is
    granted by calling ``grant_fn`` (the harness starts the new slice's
    agents and returns their slice ids); revocations
    (``revoke:slice:S@step[:grace]``) notify the registered listener —
    the worker-side preemption notice fires separately through the
    drain path; this hook only keeps the controller's books."""

    def __init__(self, now_fn: Callable[[], float] = time.time):
        self._now = now_fn
        self._lock = threading.Lock()
        self._offers: Dict[int, CapacityOffer] = {}
        self._next_offer_id = 1
        # harness hook: actually materialize the granted capacity
        # (start agents / admit joiners); returns granted slice ids
        self.grant_fn: Optional[Callable[[CapacityOffer],
                                         Optional[List[int]]]] = None
        self._revoke_listener: Optional[Callable[[int, float],
                                                 None]] = None
        self._offers_total = obs.get_registry().counter(
            "dlrover_tpu_capacity_offers_total",
            "Preemptible-capacity market events seen by the local "
            "provider", labelnames=("event",))
        obs.get_registry().gauge(
            "dlrover_tpu_capacity_offers_open",
            "Preemptible-slice offers currently open (unclaimed, "
            "unexpired)").set_function(
                lambda: float(len(self.open_offers())))

    # -- market feeds (chaos offer_fn / revoke_fn, harnesses) --------------
    def offer(self, slices: int, ttl_s: float = 0.0,
              step: int = -1) -> CapacityOffer:
        now = self._now()
        with self._lock:
            offer = CapacityOffer(
                offer_id=self._next_offer_id, slices=max(1, int(slices)),
                ttl_s=float(ttl_s), offered_at=now, step=int(step))
            self._next_offer_id += 1
            self._offers[offer.offer_id] = offer
        self._offers_total.labels(event="offered").inc()
        obs.get_flight_recorder().record_event(
            "capacity_offer", offer_id=offer.offer_id,
            slices=offer.slices, ttl_s=offer.ttl_s, step=step)
        logger.info("capacity offer #%d: +%d slice(s), ttl=%.0fs",
                    offer.offer_id, offer.slices, offer.ttl_s)
        return offer

    def revoke(self, slice_id: int, grace_s: float = 0.0,
               step: int = -1) -> None:
        with self._lock:
            listener = self._revoke_listener
        self._offers_total.labels(event="revoked").inc()
        obs.get_flight_recorder().record_event(
            "capacity_revoke", slice=slice_id, grace_s=grace_s,
            step=step)
        logger.warning("capacity revoke: slice %d departs in %.0fs",
                       slice_id, grace_s)
        if listener is not None:
            try:
                listener(slice_id, grace_s)
            except Exception:  # noqa: BLE001 — books, not the drain
                logger.exception("revoke listener failed")

    # -- the controller's surface ------------------------------------------
    def open_offers(self) -> List[CapacityOffer]:
        now = self._now()
        expired: List[int] = []
        with self._lock:
            for offer_id, offer in list(self._offers.items()):
                if offer.ttl_s > 0.0 and \
                        now - offer.offered_at > offer.ttl_s:
                    expired.append(offer_id)
                    del self._offers[offer_id]
            live = sorted(self._offers.values(),
                          key=lambda o: o.offer_id)
        for _ in expired:
            self._offers_total.labels(event="expired").inc()
        return live

    def claim(self, offer_id: int) -> Optional[List[int]]:
        with self._lock:
            offer = self._offers.pop(offer_id, None)
            grant = self.grant_fn
        if offer is None:
            return None
        self._offers_total.labels(event="claimed").inc()
        granted: Optional[List[int]] = []
        if grant is not None:
            try:
                granted = grant(offer)
            except Exception:  # noqa: BLE001 — a failed grant is an
                # empty grant; the watchdog prices the consequences
                logger.exception("capacity grant failed")
                granted = []
        return list(granted or [])

    def on_revoke(self, fn: Callable[[int, float], None]) -> None:
        with self._lock:
            self._revoke_listener = fn


class FleetController:
    """The decision loop. All collaborators are optional (evidence that
    is absent simply never produces a candidate), so unit tests build a
    controller from fakes and a fake clock."""

    def __init__(self, ledger=None, speed_monitor=None, steptrace=None,
                 plan_calibration=None, rendezvous=None, diagnosis=None,
                 provider: Optional[CapacityProvider] = None,
                 now_fn: Callable[[], float] = time.time):
        self._now = now_fn
        self._ledger = ledger
        self._speed_monitor = speed_monitor
        self._steptrace = steptrace
        self._plan_calibration = plan_calibration
        self._rendezvous = rendezvous
        self._diagnosis = diagnosis
        self._provider = provider
        # actuator hook (JobMaster): (rank, deadline_ts, reason) →
        # the servicer's slice-unit drain-notice chain
        self.shed_sink: Optional[Callable[[int, float, str],
                                          None]] = None
        # crash-consistency hook (JobMaster wires _maybe_snapshot)
        self.state_sink: Optional[Callable[[], None]] = None
        self._lock = threading.Lock()
        self._decisions: deque = deque(maxlen=_DECISION_RING)
        self._next_decision_id = 1
        # class → consecutive evaluations its candidate condition held
        # (evidence re-accumulates within N windows: not persisted)
        self._hysteresis: Dict[str, int] = {}
        self._last_actuation_ts = 0.0
        # actuation timestamps inside the trailing hour (rate limit;
        # rollbacks are exempt — undoing damage is never rate-limited)
        self._actuation_window: deque = deque(maxlen=64)
        self._quarantine_until: Dict[str, float] = {}
        self._quarantine_level: Dict[str, int] = {}
        # the open rollback watch: {decision_id, kind, baseline,
        # until, granted} — one at a time; no new actuation while open
        self._watch: Optional[Dict[str, Any]] = None
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if provider is not None:
            provider.on_revoke(self._handle_revoke)
        registry = obs.get_registry()
        self._decisions_total = registry.counter(
            "dlrover_tpu_autoscale_decisions_total",
            "Fleet-controller decisions by kind (claim / shed / hold "
            "/ rollback)", labelnames=("kind",))
        registry.gauge(
            "dlrover_tpu_autoscale_quarantined_classes",
            "Decision classes currently quarantined by the rollback "
            "watchdog").set_function(self._quarantined_count)

    # -- evidence ----------------------------------------------------------
    def _window(self, ctx: Context) -> Dict[str, Any]:
        if self._ledger is None:
            return {}
        try:
            return self._ledger.window_summary(ctx.goodput_window_s)
        except Exception:  # noqa: BLE001 — evidence, not the loop
            logger.exception("goodput window read failed")
            return {}

    def _steptrace_summary(self) -> Dict[str, Any]:
        if self._steptrace is None:
            return {}
        try:
            return self._steptrace.summary()
        except Exception:  # noqa: BLE001 — evidence, not the loop
            logger.exception("steptrace summary read failed")
            return {}

    def _actuation_cost_s(self) -> float:
        """The join+re-plan price, from the ledger's own recent
        elasticity incarnations (mean badput of the newest few that
        were opened by a resize-shaped trigger). Before any evidence
        exists the conservative default applies — the first claim is
        deliberately the hardest to justify."""
        if self._ledger is None:
            return _DEFAULT_ACTUATION_COST_S
        try:
            incarnations = self._ledger.snapshot().get(
                "incarnations", [])
        except Exception:  # noqa: BLE001 — evidence, not the loop
            return _DEFAULT_ACTUATION_COST_S
        costs = [float(inc.get("badput", 0.0))
                 for inc in incarnations
                 if inc.get("reason") in ("replan", "scale",
                                          "autoscale")]
        costs = [c for c in costs if c > 0.0][-_COST_SAMPLE_INCARNATIONS:]
        if not costs:
            return _DEFAULT_ACTUATION_COST_S
        return sum(costs) / len(costs)

    # -- candidates --------------------------------------------------------
    def _claim_candidate(self, ctx: Context, now: float,
                         window: Dict[str, Any]
                         ) -> Optional[Dict[str, Any]]:
        if self._provider is None:
            return None
        offers = self._provider.open_offers()
        if not offers:
            return None
        goodput = float(window.get("goodput_fraction", -1.0))
        if goodput < 0.0:
            # no measured goodput yet: nothing to predict the marginal
            # contribution from — claiming blind is how rollbacks happen
            return None
        offer = offers[0]
        cost_s = self._actuation_cost_s()
        # predicted productive slice-seconds the offer contributes if
        # the new slice reaches the fleet's measured goodput, amortized
        # over what remains of the offer's lifetime
        gain_s = offer.remaining_s(now) * goodput * offer.slices
        evidence = {
            "offer": offer.to_dict(),
            "goodput_fraction": round(goodput, 4),
            "predicted_gain_s": round(gain_s, 3),
            "actuation_cost_s": round(cost_s, 3),
            "claim_margin": ctx.autoscale_claim_margin,
        }
        if self._plan_calibration is not None:
            try:
                current = self._plan_calibration.current()
                if current:
                    evidence["plan_calibration"] = current
            except Exception:  # noqa: BLE001 — advisory evidence
                pass
        if gain_s <= ctx.autoscale_claim_margin * cost_s:
            return None
        return {"kind": "claim", "evidence": evidence,
                "offer_id": offer.offer_id,
                "reason": (f"offer #{offer.offer_id}: predicted gain "
                           f"{gain_s:.0f}s > {ctx.autoscale_claim_margin:g}"
                           f"× join+re-plan cost {cost_s:.0f}s")}

    def _shed_candidate(self, ctx: Context,
                        window: Dict[str, Any]
                        ) -> Optional[Dict[str, Any]]:
        trace = self._steptrace_summary()
        if not trace or self._rendezvous is None:
            return None
        gating_rank = int(trace.get("dominant_gating_rank", -1))
        dcn_wait = float(trace.get("cross_slice_wait_fraction", -1.0))
        if gating_rank < 0 or dcn_wait < ctx.autoscale_shed_wait_fraction:
            return None
        sid = self._rendezvous.slice_of(gating_rank)
        if sid < 0:
            return None
        slice_map = self._rendezvous.slice_map
        if len(set(slice_map.values())) <= 1:
            # never shed the only slice: the cure would be the disease
            return None
        members = sorted(self._rendezvous.slice_members(sid))
        if not members:
            return None
        evidence = {
            "gating_rank": gating_rank,
            "slice": sid,
            "members": members,
            "cross_slice_wait_fraction": round(dcn_wait, 4),
            "shed_wait_threshold": ctx.autoscale_shed_wait_fraction,
            "dominant_gating_phase": trace.get("dominant_gating_phase",
                                               ""),
            "goodput_fraction": window.get("goodput_fraction", -1.0),
            "degraded_steps_total": self._degraded_steps_total(),
        }
        return {"kind": "shed", "evidence": evidence, "slice": sid,
                "notice_rank": members[0],
                "reason": (f"slice {sid} gates the critical path (rank "
                           f"{gating_rank}); cross-slice wait "
                           f"{dcn_wait:.0%} > "
                           f"{ctx.autoscale_shed_wait_fraction:.0%}")}

    def _degraded_steps_total(self) -> int:
        if self._ledger is None:
            return 0
        try:
            return int(self._ledger.snapshot().get(
                "degraded_steps_total", 0))
        except Exception:  # noqa: BLE001 — advisory evidence
            return 0

    # -- guardrails --------------------------------------------------------
    def _guardrail(self, ctx: Context, now: float,
                   kind: str) -> str:
        """"" = actuate; otherwise the hold reason."""
        until = self._quarantine_until.get(kind, 0.0)
        if now < until:
            return f"quarantined for {until - now:.0f}s more"
        if self._watch is not None:
            return (f"watchdog window open on decision "
                    f"#{self._watch['decision_id']}")
        held = self._hysteresis.get(kind, 0)
        if held < ctx.autoscale_hysteresis_windows:
            return (f"hysteresis {held}/"
                    f"{ctx.autoscale_hysteresis_windows} windows")
        if now - self._last_actuation_ts < ctx.autoscale_cooldown_s:
            return (f"cooldown: {ctx.autoscale_cooldown_s - (now - self._last_actuation_ts):.0f}s"
                    " remaining")
        recent = [ts for ts in self._actuation_window
                  if now - ts < 3600.0]
        if len(recent) >= ctx.autoscale_max_decisions_per_hour:
            return (f"rate limit: {len(recent)} actuations in the "
                    f"last hour (max "
                    f"{ctx.autoscale_max_decisions_per_hour})")
        return ""

    # -- the loop body -----------------------------------------------------
    def evaluate_once(self) -> Optional[Dict[str, Any]]:
        """One evaluation: watchdog first, then candidates, then
        guardrails, then (maybe) actuation. Returns the decision record
        appended to history, None when nothing was worth recording (no
        candidate, no open watch that resolved)."""
        ctx = Context.singleton()
        now = self._now()
        window = self._window(ctx)
        rollback = self._check_watch(ctx, now, window)
        if rollback is not None:
            return rollback
        candidate = self._claim_candidate(ctx, now, window) \
            or self._shed_candidate(ctx, window)
        with self._lock:
            if candidate is None:
                self._hysteresis.clear()
                return None
            kind = candidate["kind"]
            # a flapping candidate class restarts its peer's count:
            # hysteresis measures CONSECUTIVE windows of one condition
            self._hysteresis = {
                kind: self._hysteresis.get(kind, 0) + 1}
            hold_reason = self._guardrail(ctx, now, kind)
        if hold_reason:
            return self._record(
                kind="hold", now=now,
                reason=f"{kind} blocked: {hold_reason}",
                evidence=dict(candidate["evidence"],
                              candidate=kind),
                severity="info")
        return self._actuate(ctx, now, window, candidate)

    def _actuate(self, ctx: Context, now: float,
                 window: Dict[str, Any],
                 candidate: Dict[str, Any]) -> Dict[str, Any]:
        kind = candidate["kind"]
        granted: List[int] = []
        if kind == "claim":
            if self._ledger is not None:
                self._ledger.note_elasticity_event("autoscale")
            result = self._provider.claim(candidate["offer_id"])
            if result is None:
                return self._record(
                    kind="hold", now=now,
                    reason=(f"offer #{candidate['offer_id']} vanished "
                            "before the claim landed"),
                    evidence=candidate["evidence"], severity="info")
            granted = result
        else:  # shed
            if self._ledger is not None:
                self._ledger.note_elasticity_event("autoscale")
            deadline = now + ctx.preempt_default_grace_s
            if self.shed_sink is not None:
                try:
                    self.shed_sink(candidate["notice_rank"], deadline,
                                   f"autoscale: {candidate['reason']}")
                except Exception:  # noqa: BLE001 — the failure is the
                    # watchdog's to price; the decision still records
                    logger.exception("shed actuation failed")
        baseline = float(window.get("goodput_fraction", -1.0))
        record = self._record(
            kind=kind, now=now, reason=candidate["reason"],
            evidence=dict(candidate["evidence"], granted=granted),
            severity="warning" if kind == "shed" else "info")
        with self._lock:
            self._hysteresis.clear()
            self._last_actuation_ts = now
            self._actuation_window.append(now)
            self._watch = {
                "decision_id": record["id"], "kind": kind,
                "baseline": baseline,
                "until": now + ctx.autoscale_rollback_window_s,
                "granted": granted,
            }
        self._sink()
        return record

    # -- rollback watchdog -------------------------------------------------
    def _check_watch(self, ctx: Context, now: float,
                     window: Dict[str, Any]
                     ) -> Optional[Dict[str, Any]]:
        with self._lock:
            watch = self._watch
            if watch is None or now < watch["until"]:
                return None
            self._watch = None
        current = float(window.get("goodput_fraction", -1.0))
        baseline = float(watch.get("baseline", -1.0))
        kind = watch["kind"]
        dropped = (baseline > 0.0 and current >= 0.0
                   and current < baseline
                   * (1.0 - ctx.autoscale_rollback_drop_fraction))
        if not dropped:
            with self._lock:
                self._quarantine_level[kind] = 0
                self._mark_outcome_locked(watch["decision_id"], "ok")
            self._sink()
            return None
        # the actuation made things worse: revert it and quarantine the
        # class, doubling per consecutive rollback
        with self._lock:
            level = self._quarantine_level.get(kind, 0) + 1
            self._quarantine_level[kind] = level
            multiplier = min(_QUARANTINE_MAX_MULTIPLIER,
                             2 ** (level - 1))
            quarantine_s = ctx.autoscale_quarantine_backoff_s \
                * multiplier
            self._quarantine_until[kind] = now + quarantine_s
            self._mark_outcome_locked(watch["decision_id"],
                                      "rolled_back")
            granted = list(watch.get("granted", []))
        reverted: List[int] = []
        if kind == "claim" and granted and self.shed_sink is not None:
            # revert: shed what the bad claim brought in (through the
            # same slice-unit drain chain a shed uses)
            if self._ledger is not None:
                self._ledger.note_elasticity_event("autoscale")
            for sid in granted:
                members = sorted(self._rendezvous.slice_members(sid)) \
                    if self._rendezvous is not None else []
                if not members:
                    continue
                try:
                    self.shed_sink(
                        members[0], now + ctx.preempt_default_grace_s,
                        f"autoscale rollback: reverting claimed slice "
                        f"{sid}")
                    reverted.append(sid)
                except Exception:  # noqa: BLE001 — best-effort revert
                    logger.exception("rollback shed of slice %d failed",
                                     sid)
        obs.get_flight_recorder().record_event(
            "autoscale_rollback", decision_id=watch["decision_id"],
            decision_kind=kind, baseline=round(baseline, 4),
            current=round(current, 4), quarantine_s=quarantine_s,
            reverted=reverted)
        record = self._record(
            kind="rollback", now=now,
            reason=(f"{kind} #{watch['decision_id']} rolled back: "
                    f"windowed goodput {current:.0%} < baseline "
                    f"{baseline:.0%} − "
                    f"{ctx.autoscale_rollback_drop_fraction:.0%}; "
                    f"class quarantined {quarantine_s:.0f}s"),
            evidence={"decision_id": watch["decision_id"],
                      "decision_kind": kind,
                      "baseline": round(baseline, 4),
                      "current": round(current, 4),
                      "quarantine_s": round(quarantine_s, 3),
                      "quarantine_level": level,
                      "reverted": reverted},
            severity="warning")
        self._sink()
        return record

    def _handle_revoke(self, slice_id: int, grace_s: float) -> None:
        """Market revocation listener: a revoked slice under watch
        cancels the watch WITHOUT quarantine — the coming goodput dip
        is the market's doing, not the claim's."""
        with self._lock:
            watch = self._watch
            if watch is not None and slice_id in watch.get("granted",
                                                           []):
                self._watch = None
                self._mark_outcome_locked(watch["decision_id"],
                                          "revoked")
                logger.info(
                    "watch on decision #%d cancelled: claimed slice %d "
                    "revoked by the market", watch["decision_id"],
                    slice_id)
        self._sink()

    # -- bookkeeping -------------------------------------------------------
    def _mark_outcome_locked(self, decision_id: int,
                             outcome: str) -> None:
        for record in self._decisions:
            if record.get("id") == decision_id:
                record["outcome"] = outcome
                return

    def _record(self, kind: str, now: float, reason: str,
                evidence: Dict[str, Any],
                severity: str = "info") -> Dict[str, Any]:
        with self._lock:
            record = {
                "id": self._next_decision_id,
                "kind": kind,
                "ts": now,
                "reason": reason,
                "evidence": evidence,
                "outcome": ("pending" if kind in ("claim", "shed")
                            else ""),
            }
            self._next_decision_id += 1
            self._decisions.append(record)
        self._decisions_total.labels(kind=kind).inc()
        obs.get_flight_recorder().record_event(
            "autoscale_decision", id=record["id"], kind=kind,
            reason=reason[:256], evidence=evidence)
        if self._diagnosis is not None:
            try:
                self._diagnosis.observe_autoscale(kind, reason,
                                                  evidence,
                                                  severity=severity)
            except Exception:  # noqa: BLE001 — reporting, not the loop
                logger.exception("autoscale diagnosis report failed")
        logger.log(30 if severity != "info" else 20,
                   "autoscale [%s]: %s", kind, reason)
        return record

    def _sink(self) -> None:
        sink = self.state_sink
        if sink is None:
            return
        try:
            sink()
        except Exception:  # noqa: BLE001 — durability is best-effort
            logger.exception("fleet-controller state snapshot failed")

    def _quarantined_count(self) -> float:
        now = self._now()
        with self._lock:
            return float(sum(1 for until in
                             self._quarantine_until.values()
                             if until > now))

    # -- tools / RPC view --------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """JSON-safe controller state for the AutoscaleStatusRequest
        RPC and the flight snapshot (tools/diagnose.py render_autoscale
        consumes exactly this shape, live and postmortem)."""
        now = self._now()
        offers = []
        if self._provider is not None:
            try:
                offers = [o.to_dict()
                          for o in self._provider.open_offers()]
            except Exception:  # noqa: BLE001 — view, not the loop
                logger.exception("capacity offers read failed")
        with self._lock:
            return {
                "version": 1,
                "decisions": [dict(d) for d in self._decisions],
                "watch": dict(self._watch) if self._watch else None,
                "quarantine": {
                    kind: {"until": until,
                           "remaining_s": round(max(0.0, until - now),
                                                3),
                           "level": self._quarantine_level.get(kind,
                                                               0)}
                    for kind, until in self._quarantine_until.items()
                    if until > now},
                "last_actuation_ts": self._last_actuation_ts,
                "offers": offers,
            }

    # -- loop --------------------------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> None:
        interval = (interval_s if interval_s is not None
                    else Context.singleton().autoscale_interval_s)

        def _loop():
            while not self._stopped.wait(interval):
                try:
                    self.evaluate_once()
                except Exception:  # noqa: BLE001 — loop must survive
                    logger.exception("autoscale round failed")

        with self._lock:
            if self._thread is not None:
                return
            self._stopped.clear()
            thread = threading.Thread(target=_loop, daemon=True,
                                      name="fleet-controller")
            self._thread = thread
        thread.start()

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            self._thread = None

    # -- crash-consistent state (master/state_backend.py) ------------------
    def export_state(self) -> dict:
        # stored timestamps are stable values (set once at decision
        # time), so a steady-state export stays byte-identical for
        # save_if_changed dedup
        with self._lock:
            return {
                "decisions": [dict(d) for d in
                              self._decisions][-_PERSISTED_DECISIONS:],
                "next_decision_id": self._next_decision_id,
                "last_actuation_ts": self._last_actuation_ts,
                "actuation_window": list(self._actuation_window),
                "quarantine_until": dict(self._quarantine_until),
                "quarantine_level": dict(self._quarantine_level),
                "watch": dict(self._watch) if self._watch else None,
            }

    def restore_state(self, state: dict) -> None:
        """A promoted standby inherits decision history, cooldowns, the
        rate-limit window, quarantines, and any open watchdog window —
        the guardrails must survive failover or a flapping master could
        double-actuate. Hysteresis restarts empty (its evidence
        re-accumulates within N windows)."""
        with self._lock:
            self._decisions.clear()
            for record in state.get("decisions", []):
                if isinstance(record, dict):
                    self._decisions.append(dict(record))
            self._next_decision_id = max(
                1, int(state.get("next_decision_id", 1)))
            self._last_actuation_ts = float(
                state.get("last_actuation_ts", 0.0))
            self._actuation_window.clear()
            for ts in state.get("actuation_window", []):
                self._actuation_window.append(float(ts))
            self._quarantine_until = {
                str(k): float(v) for k, v in
                (state.get("quarantine_until") or {}).items()}
            self._quarantine_level = {
                str(k): int(v) for k, v in
                (state.get("quarantine_level") or {}).items()}
            watch = state.get("watch")
            self._watch = dict(watch) if isinstance(watch, dict) \
                else None
            self._hysteresis.clear()
