"""Host-level cross-slice gradient sync with slice-scoped failure
tolerance.

Own copy of the JAX package's ``parallel/dcn_sync.py`` (numpy and the
standard library only), so that its payloads are byte for byte the JAX
encoder's and a mixed fleet, or a promoted master, reads either.

Slice mode is two-level data parallelism: each slice runs its own
process group (per-slice rendezvous, ``master/rendezvous.py``), the
in-slice mean is the slice program's own (``build_trainer``'s
``grad_step``), and the cross-slice mean is exchanged HERE, through the
master KV store, one post per slice per step. Because the cross-slice leg
is host-level, a dying slice cannot wedge the survivors' collectives: the
fleet degrades instead of stalling.

Degraded mode:

- The master's slice registry (``SliceStatusRequest``) names the PRESENT
  set each step. A slice that is draining or re-forming is absent;
  survivors renormalize the gradient mean over the slices that
  contributed and keep stepping.
- Every such step is a DEGRADED step: counted in
  ``dlrover_tpu_slice_degraded_steps_total{slice}``, reported to the
  master's goodput ledger (``GlobalStepReport.degraded_steps``), and
  flight-recorded at episode boundaries.
- The budget is ``Context.slice_absent_max_steps`` consecutive degraded
  steps. Past it the survivors HARD-STALL with a CRITICAL alert
  (``slice_absent_budget_blown`` flight event and the
  ``dlrover_tpu_slice_absent_stalled`` gauge) and resume only when the
  fleet is whole.
- A re-formed slice catches up: peer restore puts it at the checkpointed
  step (same-slice donors first), then ``catch_up`` fetches the
  fleet-current state a surviving slice leader publishes through the
  rejoin handoff, so it resumes in lockstep.

Timing caveat: the per-step participant set is "slices whose
contribution arrived by the collector's deadline". A contribution
landing inside one collector's window but after another's would diverge
the replicas for a moment; the window is a full ``dcn_sync_timeout_s``
from roughly synchronized step starts, so the race needs a straggler
within epsilon of the deadline.

The caller flattens and unflattens its parameters; this module moves
``List[np.ndarray]`` leaves.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger

# The bare key names: used when the master's slice status carries no
# world epoch. Epoch-aware masters get generation-
# namespaced keys (``dcn/g<E>/...``) instead: every membership loss
# moves the fleet to a fresh namespace, so a stale previous-episode
# payload can never be re-adopted, and the kv store garbage-collects
# the superseded namespaces (master/kv_store.py).
GRAD_KEY_PREFIX = "dcn/grads/"
REJOIN_KEY = "dcn/rejoin"
STATE_KEY = "dcn/state"

_QUANT_GROUP = 256
_QMAX = 127
# below this many elements the quantization bookkeeping costs more than
# the wire savings (same rule as parallel/quant_collectives.py)
_MIN_QUANT_SIZE = 2048


# ---------------------------------------------------------------------------
# wire codec: header JSON line + concatenated leaf bytes
# ---------------------------------------------------------------------------


def _encode_leaf_exact(leaf: np.ndarray) -> Tuple[Dict[str, Any], bytes]:
    arr = np.ascontiguousarray(leaf)
    return ({"shape": list(arr.shape), "dtype": str(arr.dtype),
             "enc": "raw"}, arr.tobytes())


def _encode_leaf_quant(leaf: np.ndarray) -> Tuple[Dict[str, Any], bytes]:
    """Groupwise-symmetric int8 (the quant_collectives scheme, host
    side): codes + float32 scales per group. Non-float / tiny leaves
    ship exact."""
    arr = np.ascontiguousarray(leaf)
    if arr.dtype.kind != "f" or arr.size < _MIN_QUANT_SIZE:
        return _encode_leaf_exact(leaf)
    flat = arr.astype(np.float32).ravel()
    pad = (-flat.size) % _QUANT_GROUP
    if pad:
        flat = np.pad(flat, (0, pad))
    x2 = flat.reshape(-1, _QUANT_GROUP)
    absmax = np.abs(x2).max(axis=-1, keepdims=True)
    scale = absmax / _QMAX
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    codes = np.clip(np.rint(x2 * inv), -_QMAX, _QMAX).astype(np.int8)
    header = {"shape": list(arr.shape), "dtype": str(arr.dtype),
              "enc": "q8", "pad": pad}
    return header, codes.tobytes() + scale.astype(np.float32).tobytes()


def _decode_leaf(meta: Dict[str, Any], raw: bytes) -> np.ndarray:
    shape = tuple(int(s) for s in meta["shape"])
    dtype = np.dtype(meta["dtype"])
    if meta.get("enc") == "q8":
        pad = int(meta.get("pad", 0))
        n = int(np.prod(shape, dtype=np.int64)) + pad
        groups = n // _QUANT_GROUP
        codes = np.frombuffer(raw, np.int8, count=n).reshape(
            groups, _QUANT_GROUP)
        scale = np.frombuffer(raw, np.float32, count=groups,
                              offset=n).reshape(groups, 1)
        flat = codes.astype(np.float32) * scale
        flat = flat.reshape(-1)
        if pad:
            flat = flat[:-pad]
        return flat.astype(dtype).reshape(shape)
    # the copy matters: np.frombuffer views are read-only and may be
    # misaligned
    return np.frombuffer(raw, dtype).reshape(shape).copy()


def encode_leaves(leaves: List[np.ndarray], step: int,
                  quant_bits: int = 0,
                  extra: Optional[Dict[str, Any]] = None) -> bytes:
    """``leaves`` → one payload: header JSON line, then leaf bytes."""
    encode = _encode_leaf_quant if quant_bits == 8 else _encode_leaf_exact
    if quant_bits not in (0, 8):
        raise ValueError(f"dcn sync quant bits must be 0 or 8, "
                         f"got {quant_bits}")
    metas: List[Dict[str, Any]] = []
    blobs: List[bytes] = []
    for leaf in leaves:
        meta, blob = encode(np.asarray(leaf))
        meta["bytes"] = len(blob)
        metas.append(meta)
        blobs.append(blob)
    header = {"step": int(step), "leaves": metas}
    if extra:
        header.update(extra)
    return json.dumps(header).encode() + b"\n" + b"".join(blobs)


def decode_payload(data: bytes
                   ) -> Optional[Tuple[Dict[str, Any],
                                       List[np.ndarray]]]:
    """Payload → (header, leaves); None on empty/torn bytes (a reader
    must treat garbage as absence, never crash the step loop)."""
    if not data:
        return None
    try:
        head_raw, _, body = data.partition(b"\n")
        header = json.loads(head_raw)
        leaves = []
        offset = 0
        for meta in header.get("leaves", ()):
            size = int(meta["bytes"])
            leaves.append(_decode_leaf(meta, body[offset:offset + size]))
            offset += size
        return header, leaves
    except Exception:  # noqa: BLE001 — torn/alien payloads read as absent
        logger.warning("undecodable DCN sync payload (%d bytes)",
                       len(data))
        return None


def peek_step(data: bytes) -> int:
    """The header step of a payload without decoding leaves (-1 on
    garbage) — the collector's cheap freshness probe."""
    if not data:
        return -1
    try:
        head_raw, _, _ = data.partition(b"\n")
        return int(json.loads(head_raw).get("step", -1))
    except Exception:  # noqa: BLE001
        return -1


# ---------------------------------------------------------------------------
# the sync
# ---------------------------------------------------------------------------


class SliceGradSync:
    """One slice's participant in the cross-slice gradient exchange.

    ``client`` needs ``kv_set``/``kv_get``/``get_slice_status`` (the
    MasterClient surface). ``is_leader`` marks the slice's process 0 —
    the only rank that posts payloads (every rank collects, so all
    ranks of a slice compute the identical fleet mean)."""

    def __init__(self, client, slice_id: int, is_leader: bool = True,
                 abort_fn: Optional[Callable[[], bool]] = None,
                 clock: Callable[[], float] = time.monotonic):
        from dlrover_tpu_torch import obs

        self._client = client
        self.slice_id = int(slice_id)
        self.is_leader = bool(is_leader)
        self._abort = abort_fn or (lambda: False)
        self._clock = clock
        # consecutive degraded steps of the CURRENT absence episode —
        # the budget counter; resets the moment the fleet is whole
        self.consecutive_degraded = 0
        # total degraded steps taken since construction, and the count
        # not yet shipped on a step report (elastic_loop drains it)
        self.degraded_total = 0
        self.degraded_unreported = 0
        self._budget_blown_logged = False
        # the fleet size the master last reported: a failed status RPC
        # (master outage) must still count local-only steps as DEGRADED
        # — syncing with nobody IS the shrunken mean the budget bounds
        self._last_known_total = 0
        # the world epoch the master last reported (-1 = unknown /
        # legacy master): namespaces every dcn/ key so payloads from a
        # previous membership episode are unreachable by construction
        self._epoch = -1
        # per-step cross-slice timing marks for the last reduce() —
        # steptrace evidence, consumed via info["trace"]
        self._last_peer_obs: Dict[int, float] = {}
        registry = obs.get_registry()
        self._degraded_counter = registry.counter(
            "dlrover_tpu_slice_degraded_steps_total",
            "Steps this slice took with the gradient mean renormalized "
            "over present slices (a peer slice was absent)",
            labelnames=("slice",))
        self._stalled_gauge = registry.gauge(
            "dlrover_tpu_slice_absent_stalled",
            "1 while this slice is hard-stalled: the degraded-step "
            "budget (slice_absent_max_steps) is blown and a peer slice "
            "is still absent")
        self._stalled_gauge.set(0)

    # -- master status ------------------------------------------------------
    def _status(self) -> Dict[str, Any]:
        try:
            status = self._client.get_slice_status() or {}
        except Exception:  # noqa: BLE001 — a master blip must not kill
            # the step; syncing with nobody is the safe degradation
            logger.warning("slice status unavailable; treating the "
                           "fleet as this slice only for this step")
            # the master may have MOVED (standby promotion — workers
            # are deliberately not respawned): re-dial from the
            # bootstrap file so the degraded episode ends with the
            # promotion instead of stalling out the absent budget
            try:
                reresolve = getattr(self._client, "reresolve_if_moved",
                                    None)
                if reresolve is not None:
                    reresolve()
            except Exception:  # noqa: BLE001 — next step retries
                pass
            return {}
        epoch = status.get("epoch")
        if epoch is not None:
            try:
                self._epoch = int(epoch)
            except (TypeError, ValueError):
                pass
        return status

    @staticmethod
    def _formed_slices(status: Dict[str, Any]) -> Dict[int, bool]:
        out: Dict[int, bool] = {}
        for sid, info in (status.get("slices") or {}).items():
            try:
                out[int(sid)] = bool(info.get("formed"))
            except (TypeError, ValueError, AttributeError):
                continue
        return out

    @property
    def world_epoch(self) -> int:
        """The membership episode the master last reported (-1 =
        unknown / legacy master) — steptrace records group under it."""
        return self._epoch

    # -- keys ---------------------------------------------------------------
    def _ns(self, suffix: str) -> str:
        """Epoch-namespaced key (legacy bare name when the master never
        reported an epoch). All slices read the epoch from the same
        master status, so writers and readers of one episode agree."""
        if self._epoch < 0:
            return f"dcn/{suffix}"
        return f"dcn/g{self._epoch}/{suffix}"

    def _grad_key(self, slice_id: int) -> str:
        return self._ns(f"grads/{slice_id}")

    def _rejoin_key(self) -> str:
        return self._ns("rejoin")

    def _state_key(self) -> str:
        return self._ns("state")

    # -- rejoin handoff (survivor side) -------------------------------------
    def _service_rejoin(self, step: int,
                        state_leaves_fn: Optional[Callable[[], list]],
                        formed: Dict[int, bool]) -> None:
        """A SURVIVING slice leader answers a pending rejoin request by
        publishing its CURRENT state (the post-update state of step
        ``step - 1``) so the re-formed slice resumes in lockstep
        instead of N checkpoint-intervals behind. The request is read
        FIRST and its slice excluded from the leader election — by the
        time a survivor looks, the rejoiner's slice is formed again and
        may well be the lowest id (it must never be its own donor)."""
        if state_leaves_fn is None or not self.is_leader:
            return
        try:
            raw = self._client.kv_get(self._rejoin_key())
        except Exception:  # noqa: BLE001 — next step retries
            return
        if not raw:
            return
        try:
            request = json.loads(raw)
            from_step = int(request.get("step", -1))
            asking = int(request.get("slice", -1))
            token = str(request.get("token", ""))
        except (ValueError, TypeError):
            # garbage request: clear it so it cannot wedge the channel
            self._try_kv_set(self._rejoin_key(), b"")
            return
        if asking == self.slice_id:
            return          # our own pending request — not our job
        active = sorted(sid for sid, ok in formed.items()
                        if ok and sid != asking)
        if not active or active[0] != self.slice_id:
            return
        if from_step >= step - 1:
            # the rejoiner is already current; just clear the request
            self._try_kv_set(self._rejoin_key(), b"")
            return
        from dlrover_tpu_torch import obs

        # the request token rides in the payload header: the rejoiner
        # accepts ONLY the answer to ITS request, so a stale dcn/state
        # from a previous handoff episode can never be adopted
        payload = encode_leaves(state_leaves_fn(), step - 1,
                                extra={"kind": "state",
                                       "from_slice": self.slice_id,
                                       "token": token})
        if self._try_kv_set(self._state_key(), payload):
            self._try_kv_set(self._rejoin_key(), b"")
            logger.warning(
                "slice %d: published fleet state @ step %d for "
                "re-formed slice %d (%d bytes)", self.slice_id,
                step - 1, asking, len(payload))
            obs.get_flight_recorder().record_event(
                "slice_state_handoff", from_slice=self.slice_id,
                to_slice=asking, step=step - 1, bytes=len(payload))

    def _try_kv_set(self, key: str, value: bytes) -> bool:
        try:
            self._client.kv_set(key, value)
            return True
        except Exception:  # noqa: BLE001
            logger.warning("kv_set %s failed", key)
            return False

    # -- rejoin catch-up (re-formed slice side) -----------------------------
    def catch_up(self, start_step: int, timeout_s: Optional[float] = None
                 ) -> Optional[Tuple[List[np.ndarray], int]]:
        """After a peer/Orbax restore at ``start_step``: when the fleet
        is ahead, fetch the state a surviving slice leader publishes and
        return (state leaves, fleet step) — or None when the fleet is
        not ahead (fresh job, lockstep restore) or nobody answered
        inside the window (train from the restored step; the survivors'
        degraded accounting keeps the gap visible)."""
        from dlrover_tpu_torch import obs
        from dlrover_tpu_torch.common.config import Context

        status = self._status()
        fleet_step = int(status.get("fleet_step", 0) or 0)
        formed = self._formed_slices(status)
        others_formed = any(ok for sid, ok in formed.items()
                            if sid != self.slice_id)
        if fleet_step <= start_step or not others_formed:
            return None
        # a fresh token per request (echoed in the answer for
        # debuggability); staleness is gated below on the header STEP —
        # a token check would only work for the leader, and every rank
        # of the slice must adopt the same payload
        import os as _os

        token = _os.urandom(8).hex()
        if self.is_leader:
            self._try_kv_set(self._rejoin_key(), json.dumps(
                {"slice": self.slice_id, "step": start_step,
                 "token": token}).encode())
        logger.warning(
            "slice %d re-formed at step %d but the fleet is at %d: "
            "requesting a state handoff", self.slice_id, start_step,
            fleet_step)
        ctx = Context.singleton()
        budget = (timeout_s if timeout_s is not None
                  else 2.0 * ctx.dcn_sync_timeout_s)
        deadline = self._clock() + budget
        # the answer must carry the fleet head or newer: dcn/state is
        # never cleared, so a payload left by a PREVIOUS handoff
        # episode (step < the fleet head we just observed) must be
        # ignored, or this slice would adopt a months-old state and
        # permanently diverge from the survivors
        min_step = max(fleet_step, start_step + 1)
        last_repost = self._clock()
        while self._clock() < deadline and not self._abort():
            # keep the request alive: a publisher that answered with a
            # state just under min_step consumed the request — re-post
            # so the NEXT survivor step publishes a fresh-enough one
            if (self.is_leader
                    and self._clock() - last_repost >= 1.0):
                last_repost = self._clock()
                try:
                    if not self._client.kv_get(self._rejoin_key()):
                        self._try_kv_set(self._rejoin_key(), json.dumps(
                            {"slice": self.slice_id,
                             "step": start_step,
                             "token": token}).encode())
                except Exception:  # noqa: BLE001 — next tick retries
                    pass
            try:
                raw = self._client.kv_get(self._state_key())
            except Exception:  # noqa: BLE001
                raw = b""
            if peek_step(raw) >= min_step:
                decoded = decode_payload(raw)
                if decoded is not None:
                    header, leaves = decoded
                    step = int(header.get("step", start_step))
                    obs.get_flight_recorder().record_event(
                        "slice_rejoin_catchup", slice=self.slice_id,
                        restored_step=start_step, fleet_step=step,
                        bytes=len(raw))
                    logger.warning(
                        "slice %d: caught up to fleet step %d via the "
                        "DCN state handoff", self.slice_id, step)
                    return leaves, step
            time.sleep(ctx.dcn_sync_poll_s)
        logger.error(
            "slice %d: no state handoff arrived within %.0fs; resuming "
            "from the restored step %d (the fleet's degraded "
            "accounting keeps the gap visible)", self.slice_id, budget,
            start_step)
        return None

    # -- the per-step exchange ----------------------------------------------
    def reduce(self, leaves: List[np.ndarray], step: int,
               state_leaves_fn: Optional[Callable[[], list]] = None,
               ) -> Tuple[List[np.ndarray], Dict[str, Any]]:
        """Exchange this slice's in-slice-mean gradient ``leaves`` for
        step ``step``; returns (fleet-mean leaves over PRESENT slices,
        info). ``state_leaves_fn`` lets the fleet leader answer rejoin
        handoffs with the current pre-update state."""
        from dlrover_tpu_torch.common.config import Context

        t_ready = self._clock()   # gradients in hand, exchange begins
        self._last_peer_obs = {}
        ctx = Context.singleton()
        status = self._status()
        formed = self._formed_slices(status)
        total = max(len(formed),
                    int(status.get("total", len(formed)) or 0))
        info: Dict[str, Any] = {"step": step, "present": [self.slice_id],
                                "absent": [], "total": total,
                                "degraded": False, "stalled_s": 0.0}
        if total <= 1 or not formed:
            if status:
                # the master genuinely says single-slice fleet:
                # nothing to exchange, nothing to degrade against
                self._last_known_total = max(1, total)
                self._note_whole()
            elif self._last_known_total > 1:
                # status unavailable (master blip/outage) in a fleet we
                # KNOW is multi-slice: this local-only step is exactly
                # the shrunken mean the degraded budget exists to bound
                # — and the budget applies here too (a long outage must
                # not buy unbounded solo training)
                if (self.consecutive_degraded
                        >= max(1, ctx.slice_absent_max_steps)):
                    info["stalled_s"] = self._stall_until_whole(
                        step, state_leaves_fn)
                    if not self._abort():
                        return self.reduce(leaves, step,
                                           state_leaves_fn)
                info.update(total=self._last_known_total,
                            degraded=True)
                self._note_degraded(step, ["unknown"],
                                    self._last_known_total)
            now = self._clock()
            info["trace"] = {"grads_ready": t_ready, "local_post": t_ready,
                             "collect_done": now, "peers": {}}
            return leaves, info
        self._last_known_total = total
        formed.setdefault(self.slice_id, True)
        # budget check FIRST: a blown budget means no more renormalized
        # steps — stall until the fleet is whole (or we are told to stop)
        absent_now = sorted(sid for sid, ok in formed.items() if not ok)
        if (absent_now
                and self.consecutive_degraded
                >= max(1, ctx.slice_absent_max_steps)):
            stalled = self._stall_until_whole(step, state_leaves_fn)
            info["stalled_s"] = stalled
            status = self._status()
            formed = self._formed_slices(status)
            formed.setdefault(self.slice_id, True)
        self._service_rejoin(step, state_leaves_fn, formed)
        if self.is_leader:
            self._try_kv_set(self._grad_key(self.slice_id),
                             encode_leaves(
                                 leaves, step,
                                 quant_bits=ctx.dcn_sync_quant_bits))
        t_post = self._clock()    # local contribution on the wire
        contributions: List[List[np.ndarray]] = [
            [np.asarray(leaf, np.float32) for leaf in leaves]]
        expected = sorted(sid for sid, ok in formed.items()
                          if ok and sid != self.slice_id)
        collected, missing = self._collect(expected, step, ctx)
        for peer_leaves in collected.values():
            contributions.append(peer_leaves)
        n = len(contributions)
        reduced = [
            (sum(c[i] for c in contributions) / n).astype(
                np.asarray(leaves[i]).dtype)
            for i in range(len(leaves))
        ] if n > 1 else list(leaves)
        present = sorted([self.slice_id] + list(collected))
        absent = sorted(set(sid for sid in formed if sid not in present)
                        | set(missing))
        info.update(present=present, absent=absent,
                    degraded=len(present) < total)
        # the steptrace decomposition: grads-ready → local-post →
        # per-peer-header-observed → last-peer (collect done); clock()
        # reads only — nothing here blocks or takes a lock
        info["trace"] = {"grads_ready": t_ready, "local_post": t_post,
                         "collect_done": self._clock(),
                         "peers": dict(self._last_peer_obs)}
        if info["degraded"]:
            self._note_degraded(step, absent, total)
        else:
            self._note_whole()
        return reduced, info

    def _collect(self, expected: List[int], step: int, ctx
                 ) -> Tuple[Dict[int, List[np.ndarray]], List[int]]:
        """Poll the formed peers' grad keys until each posts for
        ``step`` or the deadline lands; a peer that un-forms mid-wait
        (the master reaped it) is dropped from the expected set."""
        collected: Dict[int, List[np.ndarray]] = {}
        if not expected:
            return collected, []
        pending = set(expected)
        deadline = self._clock() + ctx.dcn_sync_timeout_s
        last_status_check = self._clock()
        while pending and self._clock() < deadline and not self._abort():
            for sid in sorted(pending):
                try:
                    raw = self._client.kv_get(self._grad_key(sid))
                except Exception:  # noqa: BLE001 — master blip
                    continue
                posted = peek_step(raw)
                if posted == step:
                    decoded = decode_payload(raw)
                    if decoded is not None:
                        # steptrace: when this peer's header for the
                        # step was first observed (the join's input edge)
                        self._last_peer_obs[sid] = self._clock()
                        collected[sid] = decoded[1]
                        pending.discard(sid)
                elif posted > step:
                    # the peer moved past us: we were treated absent
                    # (e.g. resumed behind the fleet) — its old grads
                    # must not be averaged into this step
                    logger.error(
                        "slice %d is at step %d but peer slice %d "
                        "already synced step %d; treating it absent",
                        self.slice_id, step, sid, posted)
                    pending.discard(sid)
            if pending:
                now = self._clock()
                if now - last_status_check >= 1.0:
                    # mid-wait membership change: a peer the master no
                    # longer calls formed will never post — stop waiting
                    last_status_check = now
                    formed = self._formed_slices(self._status())
                    for sid in list(pending):
                        if not formed.get(sid, False):
                            logger.warning(
                                "peer slice %d un-formed mid-step; "
                                "dropping it from step %d's sync",
                                sid, step)
                            pending.discard(sid)
                time.sleep(ctx.dcn_sync_poll_s)
        for sid in sorted(pending):
            logger.warning(
                "formed peer slice %d posted nothing for step %d "
                "within %.0fs; treating it absent for this step",
                sid, step, ctx.dcn_sync_timeout_s)
        return collected, sorted(pending)

    # -- degraded bookkeeping -----------------------------------------------
    def _note_degraded(self, step: int, absent: List[int],
                       total: int) -> None:
        from dlrover_tpu_torch import obs

        first = self.consecutive_degraded == 0
        self.consecutive_degraded += 1
        self.degraded_total += 1
        self.degraded_unreported += 1
        self._degraded_counter.labels(slice=str(self.slice_id)).inc()
        if first:
            logger.warning(
                "DEGRADED step %d: slice(s) %s absent — gradient mean "
                "renormalized over %d/%d slices (budget %d steps)",
                step, absent, total - len(absent), total,
                self.consecutive_degraded)
            obs.get_flight_recorder().record_event(
                "slice_degraded", slice=self.slice_id, step=step,
                absent=absent, total=total)

    def _note_whole(self) -> None:
        if self.consecutive_degraded:
            logger.info(
                "fleet whole again after %d degraded step(s)",
                self.consecutive_degraded)
        self.consecutive_degraded = 0
        self._budget_blown_logged = False

    def _stall_until_whole(self, step: int,
                           state_leaves_fn) -> float:
        """The budget is blown: refuse further renormalized steps.
        CRITICAL alert once, then block until every known slice is
        formed again — servicing rejoin handoffs meanwhile so the
        stall can actually END (the re-formed slice needs the state
        handoff before it can participate)."""
        from dlrover_tpu_torch import obs
        from dlrover_tpu_torch.common.config import Context

        ctx = Context.singleton()
        if not self._budget_blown_logged:
            self._budget_blown_logged = True
            logger.critical(
                "slice-absent budget BLOWN: %d consecutive degraded "
                "steps (slice_absent_max_steps=%d) and a slice is "
                "still absent — HARD-STALLING at step %d until the "
                "fleet is whole (silently training on a shrunken mean "
                "is not an option past the budget)",
                self.consecutive_degraded, ctx.slice_absent_max_steps,
                step)
            obs.get_flight_recorder().record_event(
                "slice_absent_budget_blown", slice=self.slice_id,
                step=step, degraded_steps=self.consecutive_degraded,
                budget=ctx.slice_absent_max_steps)
        self._stalled_gauge.set(1)
        start = self._clock()
        try:
            while not self._abort():
                status = self._status()
                formed = self._formed_slices(status)
                if formed and all(formed.values()):
                    self._note_whole()
                    logger.warning(
                        "fleet whole again after a %.1fs hard stall; "
                        "resuming", self._clock() - start)
                    break
                self._service_rejoin(step, state_leaves_fn, formed)
                time.sleep(max(ctx.dcn_sync_poll_s, 0.2))
        finally:
            self._stalled_gauge.set(0)
        return self._clock() - start

    def drain_unreported(self) -> int:
        """Degraded steps taken since the last call — the step report's
        ``degraded_steps`` field (elastic_loop drains at report
        intervals)."""
        count = self.degraded_unreported
        self.degraded_unreported = 0
        return count
