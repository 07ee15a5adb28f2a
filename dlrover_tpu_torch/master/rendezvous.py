"""Master-side rendezvous managers.

Own copy of the JAX package's ``master/rendezvous.py`` (the single-lock
manager), after dlrover/python/master/elastic_training/rdzv_manager.py:
min/max-node rendezvous with a waiting list and ``node_unit`` rounding,
liveness reaping, and the 2-round network-check rendezvous with pair
grouping, fault isolation and 2×median straggler verdicts.

A "node" is one host running one training process; ``local_world_size``
is its card count. A completed round yields the world map {node_rank →
cards}, from which agents derive the process group's world size, each
process's rank and the rendezvous address.

Peer restore: agents register the host copies their donors serve
(``register_peer_store``), and ``compute_restore_plan`` maps each staged
shard to a donor, stamped with the world epoch that every real
membership loss bumps.

Drains: a preemption notice marks a rank DRAINING (it keeps training,
is no donor, and the post-departure world is planned at once); its
completion removes it so survivors re-form in one round; a draining rank
whose deadline passed is reaped on the next poll, and a re-join cancels
the drain. ``export_state``/``restore_state`` round-trip the protocol
state the port holds (membership, worlds, draining set, donors) in the
JAX manager's format.

Re-planning: ``compute_shard_plan`` runs the parallelism planner
(``parallel/planner.py``) over the world about to form, from the model
profile the servicer feeds (``set_model_profile``, ``set_chip_hbm``,
``set_axis_discounts``), stamped with the round as its generation and
with the world epoch; it reports whether the execution shape really
changed (a re-plan) or was re-stamped for another rank.

Slice-scoped worlds (multi-slice data parallelism): when joins carry a
slice id, the slice is the failure domain. Each slice cuts its own world
with its own round counter and generation token, a member's death
invalidates only its slice's world, and ``slice_status`` is what the
cross-slice gradient sync (``parallel/dcn_sync.py``) divides by. A
sliceless job keeps the fleet world. Not ported yet: the sharded router
(ROADMAP Queue A item 12.2).
"""

from __future__ import annotations

import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.parallel import planner


@dataclass
class RendezvousParameters:
    min_nodes: int = 1
    max_nodes: int = 1
    # after min_nodes have joined, wait this long for late nodes up to max
    wait_new_node_s: float = 30.0
    # the world size is rounded down to a multiple of node_unit
    node_unit: int = 1


@dataclass
class _WaitingNode:
    node_rank: int
    local_world_size: int
    join_time: float = field(default_factory=time.time)


def plan_restore_entries(stores: Dict[int, Dict], node_rank: int,
                         slices: Dict[int, int],
                         stripe: bool = False) -> Dict:
    """The donor-selection core of ``compute_restore_plan``: ``stores``
    already filtered to live donors. Returns {"step", "entries",
    "donors"} (epoch stamping is the caller's)."""
    if not stores:
        return {"step": -1, "entries": {}, "donors": {}}
    step = max(store["step"] for store in stores.values())
    at_step = {rank: store for rank, store in stores.items()
               if store["step"] == step}
    requester_slice = slices.get(node_rank, -1)
    holders: Dict[str, List[int]] = {}
    for rank in sorted(at_step):
        for key in at_step[rank]["keys"]:
            holders.setdefault(key, []).append(rank)
    entries: Dict[str, Dict] = {}
    # independent round-robin cursors per tier, so each tier spreads
    # over its own donors
    spread_same = 0
    spread_cross = 0
    for key in sorted(holders):
        ranks = holders[key]
        if node_rank in ranks:
            donor, tier = node_rank, "local"
        elif stripe and len(ranks) > 1:
            # stripe mode: every holder, same-slice first; the receiver
            # fetches the shard's byte ranges from all of them
            same = [r for r in ranks
                    if requester_slice >= 0
                    and slices.get(r, -1) == requester_slice]
            ordered = same + [r for r in ranks if r not in same]
            entries[key] = {
                "ranks": ordered,
                "addrs": [at_step[r]["addr"] for r in ordered],
                "tier": "striped"}
            continue
        else:
            same = [r for r in ranks
                    if requester_slice >= 0
                    and slices.get(r, -1) == requester_slice]
            if same:
                donor = same[spread_same % len(same)]
                spread_same += 1
                tier = "same-slice"
            else:
                donor = ranks[spread_cross % len(ranks)]
                spread_cross += 1
                tier = "cross-slice"
        entries[key] = {"rank": donor,
                        "addr": at_step[donor]["addr"],
                        "tier": tier}
    return {
        "step": step, "entries": entries,
        "donors": {rank: at_step[rank]["addr"] for rank in at_step},
    }


class RendezvousManager:
    """Base rendezvous: collect joiners, cut a round when complete.

    Slice-scoped mode: when joins carry a slice id (and the class opts in
    with ``slice_scoped``), each slice cuts its own world with its own
    round counter and generation token; a member's death invalidates
    only that slice's world, and the other slices' worlds, tokens and
    worker pids stay as they are. The fleet structures (``_latest_world``,
    ``_rdzv_round``) stay idle in slice mode; the fleet view is the union
    of the slice worlds."""

    name = "base"
    # slice-scoped worlds apply to training rendezvous; the network
    # check pairs across the whole fleet (cross-slice links are what it
    # probes)
    slice_scoped = True

    def __init__(self, params: Optional[RendezvousParameters] = None):
        self._params = params or RendezvousParameters()
        self._lock = threading.Lock()
        self._waiting: Dict[int, _WaitingNode] = {}
        self._alive_nodes: set = set()
        self._rdzv_round = 0
        self._latest_world: Dict[int, int] = {}   # node_rank -> local_world
        self._latest_round_start = 0.0
        self._node_ips: Dict[int, str] = {}
        # survivors of an invalidated world that have not re-joined yet:
        # the membership-change signal stays raised until each of them
        # re-joins or dies
        self._pending_rejoin: set = set()
        # rank -> last RPC touch: the liveness source of reap_dead_nodes
        self._last_seen: Dict[int, float] = {}
        # bumped on every mutation of the protocol state (joins, leaves,
        # round cuts, membership changes; not liveness touches)
        self._mutations = 0
        # peer restore: bumped on every real membership loss (a restore
        # plan computed before it may name a departed donor), and each
        # rank's registered donor store {addr, step, keys, bytes, ts}
        self._world_epoch = 0
        self._peer_stores: Dict[int, Dict] = {}
        # preemption drain: rank -> departure deadline (unix ts). A
        # draining rank keeps training until it departs; on
        # complete_drain (or a blown deadline) the world re-forms in one
        # round
        self._draining: Dict[int, float] = {}
        # -- online parallelism re-planning (parallel/planner.py) ------
        # the model profile from ModelInfo reports and the cards' HBM
        # total from chip stats: what the planner scores against. Empty
        # until the first worker reports (plans then rank on topology)
        self._model_profile: Dict[str, float] = {}
        self._chip_hbm_bytes: int = 0
        # the last stamped plan: its mesh feeds the migration term of
        # the next plan, and a change against it is a REAL re-plan. The
        # inputs it was computed from memoize the planner (every join
        # and every worker's ShardPlanRequest asks)
        self._last_plan: Optional[Dict] = None
        self._last_plan_inputs: Optional[Tuple] = None
        # learned per-axis discounts pushed from the calibration loop:
        # part of every plan's inputs, not exported (the calibration
        # persists and re-pushes after a restore)
        self._axis_discounts: Dict[str, float] = {}
        # rank -> cards, kept across world invalidations: the planner
        # sees the EXPECTED post-re-formation world at the first
        # survivor's join, so a resize stamps one plan, not one a joiner
        self._known_chips: Dict[int, int] = {}
        # -- slice-scoped failure domains ------------------------------
        # rank -> slice id, learned from joins and peer-store reports;
        # any entry (with slice_scoped) switches to per-slice worlds
        self._slices: Dict[int, int] = {}
        self._slice_worlds: Dict[int, Dict[int, int]] = {}
        # per-slice round counters and generation tokens: bumped each
        # time THAT slice's world cuts, untouched when another slice fails
        self._slice_rounds: Dict[int, int] = {}
        self._slice_generation: Dict[int, int] = {}
        self._slice_round_start: Dict[int, float] = {}

    # -- membership --------------------------------------------------------
    def update_rdzv_params(self, min_nodes: int, max_nodes: int,
                           wait_new_node_s: float = 30.0,
                           node_unit: int = 1) -> None:
        with self._lock:
            self._params = RendezvousParameters(
                min_nodes, max_nodes, wait_new_node_s, node_unit
            )

    @property
    def mutation_count(self) -> int:
        with self._lock:
            return self._mutations

    @property
    def alive_nodes(self) -> set:
        with self._lock:
            return set(self._alive_nodes)

    def add_alive_node(self, node_rank: int) -> None:
        with self._lock:
            self._alive_nodes.add(node_rank)
            self._last_seen[node_rank] = time.time()
            self._mutations += 1

    def touch(self, node_rank: int) -> None:
        """Record liveness for a rank (any agent RPC qualifies)."""
        if node_rank < 0:
            return
        with self._lock:
            self._last_seen[node_rank] = time.time()

    # -- slice membership --------------------------------------------------
    def _slice_mode_locked(self) -> bool:
        """(lock held)"""
        return self.slice_scoped and bool(self._slices)

    def _record_slice_locked(self, node_rank: int, slice_id: int) -> None:
        """(lock held)"""
        if slice_id >= 0 and self.slice_scoped:
            if self._slices.get(node_rank) != slice_id:
                self._slices[node_rank] = slice_id
                self._mutations += 1

    def record_slice(self, node_rank: int, slice_id: int) -> None:
        """Teach the registry a rank's slice outside the join path
        (reconnects, peer-store reports that precede the first join)."""
        with self._lock:
            self._record_slice_locked(node_rank, slice_id)

    def slice_of(self, node_rank: int) -> int:
        with self._lock:
            return self._slices.get(node_rank, -1)

    @property
    def slice_map(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._slices)

    def slice_members(self, slice_id: int) -> List[int]:
        with self._lock:
            return sorted(r for r, s in self._slices.items()
                          if s == slice_id)

    def slice_status(self) -> Dict:
        """The registry view the cross-slice gradient sync divides by
        (``parallel/dcn_sync.py``): which slices are formed now, with
        their generation tokens, and the world epoch that namespaces the
        ``dcn/`` keys. JSON-safe."""
        with self._lock:
            sids = sorted(set(self._slices.values()))
            slices = {}
            for sid in sids:
                members = sorted(r for r, s in self._slices.items()
                                 if s == sid)
                world = self._slice_worlds.get(sid, {})
                slices[str(sid)] = {
                    "formed": bool(world),
                    "ranks": sorted(world) if world else members,
                    "generation": self._slice_generation.get(sid, 0),
                    "draining": any(r in self._draining
                                    for r in members),
                }
            return {"total": len(sids), "slices": slices,
                    "epoch": self._world_epoch}

    def _slice_ready_locked(self, sid: int) -> bool:
        """A slice's round completes when every alive member joined, or
        the late-node grace expired with one waiting (lock held).
        ``node_unit`` does not apply: a slice cuts whole."""
        waiting = {r for r in self._waiting
                   if self._slices.get(r) == sid}
        if not waiting:
            return False
        alive = {r for r in self._alive_nodes
                 if self._slices.get(r) == sid}
        if alive and alive.issubset(set(self._waiting)):
            return True
        started = self._slice_round_start.get(sid)
        return (started is not None
                and time.time() - started >= self._params.wait_new_node_s)

    def _cut_slice_locked(self, sid: int):
        """Cut ``sid``'s world from its waiting members (lock held).
        Returns (sid, round, generation, world, duration) for the obs
        emitted outside the lock."""
        members = sorted(r for r in self._waiting
                         if self._slices.get(r) == sid)
        world = {r: self._waiting[r].local_world_size for r in members}
        for rank in members:
            del self._waiting[rank]
        self._slice_worlds[sid] = world
        self._slice_rounds[sid] = self._slice_rounds.get(sid, 0) + 1
        self._slice_generation[sid] = (
            self._slice_generation.get(sid, 0) + 1)
        self._mutations += 1
        started = self._slice_round_start.pop(sid, None)
        duration = (max(0.0, time.time() - started)
                    if started is not None else 0.0)
        logger.info(
            "%s rendezvous: slice %d round %d cut (generation %d): "
            "world=%s", self.name, sid, self._slice_rounds[sid] - 1,
            self._slice_generation[sid], sorted(world))
        return (sid, self._slice_rounds[sid] - 1,
                self._slice_generation[sid], dict(world), duration)

    def _emit_slice_cut_obs(self, cut) -> None:
        """Flight event and metrics of a just-cut slice world (outside
        the manager lock)."""
        sid, round_idx, generation, world, duration = cut
        obs.get_flight_recorder().record_event(
            "slice_world_cut", rdzv=self.name, slice=sid,
            round=round_idx, generation=generation,
            world=sorted(world))
        obs.record_span(
            "rendezvous_round", duration,
            attrs={"rdzv": self.name, "round": round_idx, "slice": sid,
                   "world_size": len(world)})
        registry = obs.get_registry()
        registry.counter(
            "dlrover_tpu_rendezvous_rounds_total",
            "Completed rendezvous rounds", labelnames=("rdzv",),
        ).labels(rdzv=self.name).inc()
        registry.gauge(
            "dlrover_tpu_slice_generation",
            "Per-slice generation token: bumped each time THAT slice's "
            "world re-forms (a peer slice's failure must not move it)",
            labelnames=("slice",)).labels(slice=str(sid)).set(generation)
        registry.gauge(
            "dlrover_tpu_slice_world_size",
            "Node count of the slice's latest cut world",
            labelnames=("slice",)).labels(slice=str(sid)).set(len(world))

    def reap_dead_nodes(self, timeout_s: float) -> None:
        """Declare ranks silent for > timeout_s dead (world invalidation
        via remove_alive_node). 0/negative disables. Runs on live agents'
        polls: no master thread needed.

        Draining ranks whose departure deadline passed are reaped
        regardless of the liveness timeout: the platform took the machine
        at the deadline even if the drain-complete RPC was lost."""
        now = time.time()
        with self._lock:
            overdue = [rank for rank, deadline in self._draining.items()
                       if now > deadline + 5.0]
            for rank in overdue:
                del self._draining[rank]
        for rank in overdue:
            logger.warning(
                "%s rendezvous: draining node %d blew its departure "
                "deadline without reporting completion; removing it",
                self.name, rank)
            self.remove_alive_node(rank, graceful=False)
        if timeout_s <= 0:
            return
        with self._lock:
            dead = [rank for rank in self._alive_nodes
                    if now - self._last_seen.get(rank, now) > timeout_s]
        for rank in dead:
            logger.warning(
                "%s rendezvous: node %d silent for > %.0fs; declaring it "
                "dead", self.name, rank, timeout_s)
            self.remove_alive_node(rank, graceful=False)

    def remove_alive_node(self, node_rank: int,
                          graceful: bool = False) -> None:
        """Drop a node from membership. ``graceful`` marks a clean exit:
        survivors keep running, so the cut world stays valid for them and
        is NOT invalidated; only a death does that."""
        invalidated_round = None
        slice_invalidated = None
        with self._lock:
            in_slice_world = any(
                node_rank in world
                for world in self._slice_worlds.values())
            if (node_rank in self._alive_nodes
                    or node_rank in self._latest_world
                    or in_slice_world):
                # a real membership loss: a restore plan computed before
                # this instant may name the departed rank as a donor,
                # and the epoch bump invalidates it at commit time
                self._world_epoch += 1
            self._alive_nodes.discard(node_rank)
            self._waiting.pop(node_rank, None)
            self._pending_rejoin.discard(node_rank)
            self._draining.pop(node_rank, None)
            # the host's staged state goes with the host
            self._peer_stores.pop(node_rank, None)
            self._mutations += 1
            if self._slice_mode_locked():
                # a slice-scoped cut: only the dead rank's slice loses its
                # world; every other slice's world, round and generation
                # stay. The rank keeps its slice entry and re-joins as
                # the same slice.
                sid = self._slices.get(node_rank, -1)
                world = self._slice_worlds.get(sid, {})
                if not graceful and node_rank in world:
                    logger.info(
                        "%s rendezvous: node %d died after slice %d "
                        "round %d was cut; invalidating ONLY that "
                        "slice's world", self.name, node_rank, sid,
                        self._slice_rounds.get(sid, 1) - 1)
                    self._pending_rejoin |= set(world) - {node_rank}
                    self._slice_worlds[sid] = {}
                    slice_invalidated = (
                        sid, self._slice_rounds.get(sid, 1) - 1)
            elif not graceful and node_rank in self._latest_world:
                # a member of the cut round died: survivors handed this
                # world would only find out at the process group's
                # timeout. Empty it so polls report "still forming" and
                # survivors re-join for a fresh round.
                logger.info(
                    "%s rendezvous: node %d died after round %d was cut; "
                    "invalidating the world", self.name, node_rank,
                    self._rdzv_round - 1,
                )
                self._pending_rejoin |= (
                    set(self._latest_world) - {node_rank}
                )
                self._latest_world = {}
                self._on_world_invalidated()
                invalidated_round = self._rdzv_round - 1
        # obs sinks run OUTSIDE the manager lock (they take their own)
        self._publish_draining_gauge()
        if slice_invalidated is not None:
            sid, round_idx = slice_invalidated
            obs.get_flight_recorder().record_event(
                "slice_world_invalidated", rdzv=self.name, slice=sid,
                dead_rank=node_rank, round=round_idx)
            obs.get_registry().counter(
                "dlrover_tpu_rendezvous_world_invalidations_total",
                "Cut worlds invalidated by a member death",
                labelnames=("rdzv",),
            ).labels(rdzv=self.name).inc()
        if invalidated_round is not None:
            obs.get_flight_recorder().record_event(
                "world_invalidated", rdzv=self.name,
                dead_rank=node_rank, round=invalidated_round)
            obs.get_registry().counter(
                "dlrover_tpu_rendezvous_world_invalidations_total",
                "Cut worlds invalidated by a member death",
                labelnames=("rdzv",),
            ).labels(rdzv=self.name).inc()

    def _on_world_invalidated(self) -> None:
        """Hook for subclasses holding state keyed on the cut world
        (lock held)."""

    # -- agent-facing protocol ---------------------------------------------
    def join_rendezvous(self, node_rank: int, local_world_size: int,
                        node_ip: str = "", slice_id: int = -1) -> int:
        """Register a joiner; returns the round it will be placed in (its
        slice's round in slice mode)."""
        with self._lock:
            self._record_slice_locked(node_rank, slice_id)
            self._waiting[node_rank] = _WaitingNode(node_rank,
                                                    local_world_size)
            # the planner's expected-world card map (kept across world
            # invalidations; see _plan_world_locked)
            self._known_chips[node_rank] = local_world_size
            self._alive_nodes.add(node_rank)
            self._last_seen[node_rank] = time.time()
            self._pending_rejoin.discard(node_rank)
            # a re-joining rank is no longer departing (the drain was
            # cancelled operator-side, or the platform gave it back)
            self._draining.pop(node_rank, None)
            if node_ip:
                self._node_ips[node_rank] = node_ip
            if len(self._waiting) == 1:
                self._latest_round_start = time.time()
            self._mutations += 1
            if (self._slice_mode_locked()
                    and node_rank in self._slices):
                sid = self._slices[node_rank]
                # the slice's grace window is timed from its first
                # waiting member, not the fleet's
                others_waiting = any(
                    r != node_rank and self._slices.get(r) == sid
                    for r in self._waiting)
                if not others_waiting:
                    self._slice_round_start[sid] = time.time()
                joined_round = self._slice_rounds.get(sid, 0)
            else:
                joined_round = self._rdzv_round
        obs.get_registry().counter(
            "dlrover_tpu_rendezvous_joins_total",
            "join_rendezvous RPCs accepted", labelnames=("rdzv",),
        ).labels(rdzv=self.name).inc()
        self._publish_draining_gauge()
        return joined_round

    def leave_waiting(self, node_rank: int) -> None:
        """A joiner abandoning an UNCOMPLETED round (its poll deadline
        expired); the node stays alive and may re-join. A no-op after the
        round cut."""
        with self._lock:
            if self._waiting.pop(node_rank, None) is not None:
                self._mutations += 1
                logger.info(
                    "%s rendezvous: node %d left the waiting list "
                    "(gave up on the forming round)", self.name,
                    node_rank)

    def get_comm_world(self, node_rank: int
                       ) -> Tuple[int, int, Dict[int, int]]:
        """Poll for the completed world. Returns (round, group, world),
        the world empty while the round is still forming. In slice mode
        the world is the polling rank's slice world and ``group`` is the
        slice id."""
        cut_info = None
        slice_cut = None
        with self._lock:
            self._last_seen[node_rank] = time.time()
            if (self._slice_mode_locked()
                    and node_rank in self._slices):
                sid = self._slices[node_rank]
                if self._slice_ready_locked(sid):
                    slice_cut = self._cut_slice_locked(sid)
                world = self._slice_worlds.get(sid, {})
                if (node_rank in world
                        and node_rank not in self._waiting):
                    result = (self._slice_rounds.get(sid, 1) - 1, sid,
                              dict(world))
                else:
                    result = self._slice_rounds.get(sid, 0), sid, {}
            else:
                if self._check_rdzv_completed():
                    cut_info = self._cut_round()
                # a node still in the waiting list has re-joined for the
                # NEXT round: the latest world is stale for it
                if (node_rank in self._latest_world
                        and node_rank not in self._waiting):
                    result = (self._rdzv_round - 1, 0,
                              dict(self._latest_world))
                else:
                    result = self._rdzv_round, 0, {}
        if slice_cut is not None:
            self._emit_slice_cut_obs(slice_cut)
        if cut_info is not None:
            self._emit_round_obs(cut_info)
        return result

    def num_nodes_waiting(self, node_rank: int = -1) -> int:
        """Agents restart workers when >0 while healthy (membership
        change). In slice mode the signal is scoped to the polling rank's
        slice: a peer slice re-forming must not restart this slice's
        worker."""
        with self._lock:
            if (self._slice_mode_locked() and node_rank >= 0
                    and node_rank in self._slices):
                sid = self._slices[node_rank]
                members = {r for r, s in self._slices.items()
                           if s == sid}
                waiting = set(self._waiting) & members
                if self._pending_rejoin & members:
                    return max(1, len(waiting))
                if not self._slice_worlds.get(sid):
                    return 0
                return len(waiting)
            if self._pending_rejoin:
                # a world member died: every survivor must restart and
                # re-join; keep the signal raised until each has
                return max(1, len(self._waiting))
            # before the first round there is no world to change
            if not self._latest_world:
                return 0
            return len(self._waiting)

    # -- internals ---------------------------------------------------------
    def _check_rdzv_completed(self) -> bool:
        """A round completes when every alive node joined, or max_nodes
        joined, or min_nodes joined and the late-node grace window
        expired (lock held)."""
        if not self._waiting:
            return False
        if self._slice_mode_locked() and all(
                rank in self._slices for rank in self._waiting):
            # every waiting rank belongs to a slice: the per-slice cut
            # owns them, and a sliceless poller must not sweep them into
            # a fleet round
            return False
        num = min(len(self._waiting), self._params.max_nodes)
        if num < self._params.min_nodes:
            return False
        alive_all_joined = (
            self._alive_nodes
            and self._alive_nodes.issubset(set(self._waiting))
        )
        if num == self._params.max_nodes or alive_all_joined:
            return self._rounded_size(num) >= self._params.min_nodes
        waited = time.time() - self._latest_round_start
        if waited >= self._params.wait_new_node_s:
            return self._rounded_size(num) >= self._params.min_nodes
        return False

    def _rounded_size(self, num: int) -> int:
        unit = max(1, self._params.node_unit)
        return (num // unit) * unit

    def _cut_round(self):
        """Select the world for this round (lock held). Returns
        (duration_s, round_idx, world_size, world_ranks) for
        ``_emit_round_obs`` once the lock is released."""
        size = self._rounded_size(
            min(len(self._waiting), self._params.max_nodes)
        )
        # keep the lowest-ranked `size` nodes; the rest stay waiting for
        # the next round (node_unit remainder)
        chosen = sorted(self._waiting)[:size]
        self._latest_world = {
            rank: self._waiting[rank].local_world_size for rank in chosen
        }
        for rank in chosen:
            del self._waiting[rank]
        self._rdzv_round += 1
        self._mutations += 1
        logger.info(
            "%s rendezvous round %d completed: world=%s",
            self.name, self._rdzv_round - 1, sorted(self._latest_world),
        )
        duration = max(0.0, time.time() - self._latest_round_start)
        if self._waiting:
            # a node_unit remainder opens the NEXT forming round now
            self._latest_round_start = time.time()
        return (duration, self._rdzv_round - 1, len(self._latest_world),
                sorted(self._latest_world))

    def _emit_round_obs(self, cut_info) -> None:
        """Round span + counters for a just-cut round, called after the
        manager lock is released."""
        duration_s, round_idx, world_size, _ = cut_info
        obs.record_span(
            "rendezvous_round", duration_s,
            attrs={"rdzv": self.name, "round": round_idx,
                   "world_size": world_size},
        )
        registry = obs.get_registry()
        registry.counter(
            "dlrover_tpu_rendezvous_rounds_total",
            "Completed rendezvous rounds", labelnames=("rdzv",),
        ).labels(rdzv=self.name).inc()
        registry.gauge(
            "dlrover_tpu_rendezvous_world_size",
            "Node count of the latest cut world", labelnames=("rdzv",),
        ).labels(rdzv=self.name).set(world_size)

    # -- preemption drain --------------------------------------------------
    def _publish_draining_gauge(self) -> None:
        """Republished by every path that mutates the draining set
        (notice, completion, blown-deadline reap, re-join cancel, death,
        state restore). Called OUTSIDE the manager lock."""
        if self.name != RendezvousName.TRAINING:
            return
        with self._lock:
            count = len(self._draining)
        obs.get_registry().gauge(
            "dlrover_tpu_draining_nodes",
            "Ranks currently draining (announced, not yet departed)",
        ).set(count)

    def mark_draining(self, node_rank: int, deadline: float
                      ) -> Dict[int, int]:
        """A preemption notice for ``node_rank``: it keeps training
        until departure, but the post-departure world is planned NOW.
        Returns that planned world (the latest world minus every
        draining rank)."""
        with self._lock:
            if node_rank in self._alive_nodes:
                self._draining[node_rank] = deadline
                self._mutations += 1
            if (self._slice_mode_locked()
                    and node_rank in self._slices):
                base_world = self._slice_worlds.get(
                    self._slices[node_rank], {})
            else:
                base_world = self._latest_world
            planned = {rank: n for rank, n in base_world.items()
                       if rank not in self._draining}
        logger.info(
            "%s rendezvous: node %d DRAINING (deadline %.0fs away); "
            "planned post-departure world %s", self.name, node_rank,
            max(0.0, deadline - time.time()), sorted(planned))
        self._publish_draining_gauge()
        return planned

    def complete_drain(self, node_rank: int) -> bool:
        """The drained worker exited clean: remove the rank now (a
        planned departure, no liveness timeout) so survivors re-form in
        one round. Returns whether the rank was known draining."""
        with self._lock:
            was_draining = self._draining.pop(node_rank, None) is not None
        # NOT graceful: the cut world held the drained rank, so survivors
        # re-join for the smaller world, and with the rank out of the
        # alive set the round cuts as soon as the last survivor joins
        self.remove_alive_node(node_rank, graceful=False)
        obs.get_flight_recorder().record_event(
            "node_drained", rdzv=self.name, rank=node_rank,
            announced=was_draining)
        return was_draining

    @property
    def draining(self) -> Dict[int, float]:
        with self._lock:
            return dict(self._draining)

    # -- peer-to-peer restore (checkpoint/peer_restore.py) -----------------
    @property
    def world_epoch(self) -> int:
        with self._lock:
            return self._world_epoch

    def register_peer_store(self, node_rank: int, addr: str, step: int,
                            keys, total_bytes: int = 0,
                            slice_id: int = -1) -> None:
        """An agent advertising (or withdrawing: step < 0 or no keys) the
        staged state its donor server can serve. ``slice_id`` also
        teaches the slice registry: store reports land before the join,
        and a restarted master must know the donor's slice to tier the
        plan."""
        with self._lock:
            self._record_slice_locked(node_rank, slice_id)
            if step < 0 or not keys:
                if self._peer_stores.pop(node_rank, None) is not None:
                    self._mutations += 1
                return
            self._peer_stores[node_rank] = {
                "addr": addr, "step": int(step), "keys": list(keys),
                "bytes": int(total_bytes), "ts": time.time(),
            }
            self._mutations += 1

    @property
    def peer_stores(self) -> Dict[int, Dict]:
        with self._lock:
            return {rank: dict(s) for rank, s in self._peer_stores.items()}

    # -- online parallelism re-planning (parallel/planner.py) --------------
    def set_model_profile(self, param_count: int = 0,
                          param_bytes: int = 0,
                          flops_per_token: float = 0.0,
                          peak_flops_per_chip: float = 0.0,
                          seq_len: int = 0,
                          global_batch: int = 0,
                          tensor_divisor: int = 0,
                          fsdp_divisor: int = 0) -> None:
        """Teach the planner the model's shape (fed from ModelInfo
        reports by the servicer). Zero fields leave the previous value
        standing: a re-report that only updates the FLOPs model must not
        erase the batch."""
        updates = {"param_count": param_count, "param_bytes": param_bytes,
                   "flops_per_token": flops_per_token,
                   "peak_flops_per_chip": peak_flops_per_chip,
                   "seq_len": seq_len, "global_batch": global_batch,
                   "tensor_divisor": tensor_divisor,
                   "fsdp_divisor": fsdp_divisor}
        with self._lock:
            for key, value in updates.items():
                if value and value > 0:
                    if self._model_profile.get(key) != value:
                        self._model_profile[key] = value
                        self._mutations += 1

    def set_chip_hbm(self, hbm_bytes: int) -> None:
        """The observed per-card memory total (from NodeResourceStats):
        the planner's memory-fit budget. 0 stays 0, unconstrained."""
        with self._lock:
            if hbm_bytes > 0 and self._chip_hbm_bytes != int(hbm_bytes):
                self._chip_hbm_bytes = int(hbm_bytes)
                self._mutations += 1

    def set_axis_discounts(self, discounts: Dict[str, float]) -> None:
        """Learned per-axis efficiency corrections from the calibration
        loop: a scoring input of every later plan. Derived state, so it
        does not count as a mutation."""
        with self._lock:
            self._axis_discounts = {str(k): float(v)
                                    for k, v in (discounts or {}).items()
                                    if v and v > 0}

    def _plan_world_locked(self) -> Dict[int, int]:
        """(lock held) The world the next plan must cover: every alive,
        non-draining rank, its cards from the cut world, the waiting list
        or the remembered ``_known_chips`` (a survivor whose world was
        invalidated an instant ago is part of the world about to form).
        The first join after a membership change so sees the final plan:
        one re-plan a resize, not one a joiner."""
        chips: Dict[int, int] = dict(self._known_chips)
        if self._slice_mode_locked():
            for world in self._slice_worlds.values():
                chips.update(world)
        else:
            chips.update(self._latest_world)
        for rank, waiting in self._waiting.items():
            chips[rank] = waiting.local_world_size
        return {rank: int(n) for rank, n in chips.items()
                if rank in self._alive_nodes
                and rank not in self._draining}

    def compute_shard_plan(self, node_rank: int) -> Tuple[Dict, bool]:
        """The deterministic parallelism plan for the (forming) world:
        the mesh and the batch and accumulation shape, stamped with the
        round as its generation and with the world epoch. Returns (plan,
        changed): ``changed`` when the execution shape differs from the
        last stamped plan's after a world has formed (a REAL re-plan,
        not a re-stamp for another joiner, nor formation)."""
        with self._lock:
            world = self._plan_world_locked()
            slices = (len({self._slices.get(r, -1) for r in world})
                      if self._slice_mode_locked() and world else 1)
            profile = planner.ModelProfile(
                param_count=int(self._model_profile.get(
                    "param_count", 0)),
                param_bytes=int(self._model_profile.get(
                    "param_bytes", 0)),
                flops_per_token=float(self._model_profile.get(
                    "flops_per_token", 0.0)),
                peak_flops_per_chip=float(self._model_profile.get(
                    "peak_flops_per_chip", 0.0)),
                seq_len=int(self._model_profile.get("seq_len", 0)),
                global_batch=int(self._model_profile.get(
                    "global_batch", 0)),
                hbm_bytes_per_chip=self._chip_hbm_bytes,
                tensor_divisor=int(self._model_profile.get(
                    "tensor_divisor", 0)),
                fsdp_divisor=int(self._model_profile.get(
                    "fsdp_divisor", 0)),
            )
            if self._slice_mode_locked() and node_rank in self._slices:
                sid = self._slices[node_rank]
                generation = self._slice_generation.get(sid, 0)
                round_ = self._slice_rounds.get(sid, 0)
            else:
                generation = round_ = self._rdzv_round
            discounts = dict(self._axis_discounts)
            inputs = (tuple(sorted(world.items())), profile,
                      max(1, slices),
                      generation, self._world_epoch, round_,
                      tuple(sorted(discounts.items())))
            if (self._last_plan is not None
                    and inputs == self._last_plan_inputs):
                # identical inputs give the identical plan: answer the
                # memo instead of re-enumerating under the lock
                return dict(self._last_plan), False
            plan = planner.plan_parallelism(
                world, profile, slices=max(1, slices),
                prev_plan=self._last_plan,
                generation=generation, epoch=self._world_epoch,
                round_=round_, axis_discounts=discounts or None)
            self._last_plan_inputs = inputs
            equivalent = planner.plans_equivalent(self._last_plan, plan)
            # bootstrap joins refine the first plan as members arrive:
            # formation, not a resize
            has_cut = (any(self._slice_rounds.values())
                       if self._slice_mode_locked()
                       else self._rdzv_round > 0)
            changed = (self._last_plan is not None and has_cut
                       and not equivalent)
            prev = None
            if not equivalent:
                prev = self._last_plan
                self._last_plan = plan
                self._mutations += 1
        if changed and prev is not None:
            obs.get_flight_recorder().record_event(
                "replan_stamped", rdzv=self.name,
                world_size=plan.get("world_size"),
                devices=plan.get("total_devices"),
                mesh=plan.get("mesh"), prev_mesh=prev.get("mesh"),
                global_batch=plan.get("global_batch"),
                batch_adjusted=plan.get("batch_adjusted"),
                resharded=plan.get("resharded"),
                generation=plan.get("generation"),
                epoch=plan.get("epoch"))
        return plan, changed

    @property
    def last_shard_plan(self) -> Optional[Dict]:
        with self._lock:
            return dict(self._last_plan) if self._last_plan else None

    def compute_restore_plan(self, node_rank: int,
                             stripe: bool = False) -> Dict:
        """Which live donor serves each staged shard that ``node_rank``
        may need, at the NEWEST step any live donor staged (mixing steps
        would assemble a state that never existed). The requester's own
        store wins for the shards it holds (a local read beats the
        network); the rest go round-robin over the donors. Stamped with
        the world epoch, the staleness guard. ``stripe``: each entry
        lists every same-step holder, for byte-range fetches from all of
        them. Same-slice donors come before the rest, round-robin within
        each tier. A draining rank is no donor."""
        with self._lock:
            stores = {rank: store
                      for rank, store in self._peer_stores.items()
                      if rank in self._alive_nodes
                      and rank not in self._draining}
            plan = plan_restore_entries(stores, node_rank, self._slices,
                                        stripe=stripe)
            plan["epoch"] = self._world_epoch
            if stripe:
                plan["mode"] = "stripe"
            return plan

    @property
    def latest_world(self) -> Dict[int, int]:
        """The fleet view: the union of the slice worlds in slice mode."""
        with self._lock:
            if self._slice_mode_locked():
                merged: Dict[int, int] = {}
                for world in self._slice_worlds.values():
                    merged.update(world)
                return merged
            return dict(self._latest_world)

    def world_for(self, node_rank: int) -> Dict[int, int]:
        """The world ``node_rank`` belongs to (the reconnect handshake's
        intact check): its slice's world in slice mode, else the fleet
        world."""
        with self._lock:
            if self._slice_mode_locked() and node_rank in self._slices:
                return dict(self._slice_worlds.get(
                    self._slices[node_rank], {}))
            return dict(self._latest_world)

    def round_for(self, node_rank: int) -> int:
        """The latest completed round in ``node_rank``'s scope."""
        with self._lock:
            if self._slice_mode_locked() and node_rank in self._slices:
                return self._slice_rounds.get(
                    self._slices[node_rank], 0) - 1
            return self._rdzv_round - 1

    @property
    def rdzv_round(self) -> int:
        with self._lock:
            return self._rdzv_round

    # -- state round trip --------------------------------------------------
    def export_state(self) -> dict:
        """JSON-safe snapshot of the protocol state, in the JAX manager's
        format for the fields the port holds. Liveness clocks are not
        exported: a restored master restarts them (stale clocks would
        reap every member at its first poll)."""
        with self._lock:
            state = {
                "round": self._rdzv_round,
                "latest_world": {str(r): n
                                 for r, n in self._latest_world.items()},
                "waiting": {str(r): w.local_world_size
                            for r, w in self._waiting.items()},
                "alive": sorted(self._alive_nodes),
                "pending_rejoin": sorted(self._pending_rejoin),
                "node_ips": {str(r): ip
                             for r, ip in self._node_ips.items()},
                "draining": {str(r): deadline
                             for r, deadline in self._draining.items()},
                "world_epoch": self._world_epoch,
                "peer_stores": {
                    str(r): {"addr": s["addr"], "step": s["step"],
                             "keys": list(s["keys"]),
                             "bytes": s.get("bytes", 0)}
                    for r, s in self._peer_stores.items()
                },
                # the slices' membership, worlds and generation tokens
                # survive a failover: a master that forgot the tokens
                # would hand every slice a fresh generation
                "slices": {str(r): s for r, s in self._slices.items()},
                "slice_worlds": {
                    str(sid): {str(r): n for r, n in world.items()}
                    for sid, world in self._slice_worlds.items()
                },
                "slice_rounds": {str(sid): r for sid, r
                                 in self._slice_rounds.items()},
                "slice_generation": {
                    str(sid): g for sid, g
                    in self._slice_generation.items()},
                # re-planning: the model profile and the last stamped
                # plan survive a master failover (a master that forgot
                # them would stamp a migration-blind plan and mistake it
                # for a re-plan)
                "model_profile": dict(self._model_profile),
                "chip_hbm_bytes": self._chip_hbm_bytes,
                "last_plan": (dict(self._last_plan)
                              if self._last_plan else None),
                "known_chips": {str(r): n for r, n
                                in self._known_chips.items()},
            }
            # subclass fields join the SAME cut: one lock acquisition
            self._export_extra(state)
            return state

    def _export_extra(self, state: dict) -> None:
        """Subclass hook appending extra exported fields (lock held)."""

    def _restore_extra(self, state: dict) -> None:
        """Subclass hook restoring extra exported fields (lock held)."""

    def restore_state(self, state: dict) -> None:
        """Rehydrate from ``export_state`` (this package's or the JAX
        manager's; the fields the port does not hold are ignored). A
        lineage the JAX package's sharded manager wrote (``"shards"``)
        restores its fleet partition: the per-slice partitions belong to
        the sharded router (ROADMAP Queue A item 12.2)."""
        if "shards" in state:
            state = _fleet_partition(state)
        now = time.time()
        with self._lock:
            self._rdzv_round = int(state.get("round", 0))
            self._latest_world = {
                int(r): int(n)
                for r, n in state.get("latest_world", {}).items()}
            self._waiting = {
                int(r): _WaitingNode(int(r), int(n), join_time=now)
                for r, n in state.get("waiting", {}).items()}
            self._alive_nodes = {int(r) for r in state.get("alive", ())}
            self._pending_rejoin = {
                int(r) for r in state.get("pending_rejoin", ())}
            self._node_ips = {int(r): ip for r, ip in
                              state.get("node_ips", {}).items()}
            # absolute deadlines survive the restart as they are: a drain
            # announced before the master died is still a drain, and a
            # blown deadline is reaped at the first poll
            self._draining = {int(r): float(d) for r, d in
                              state.get("draining", {}).items()}
            self._world_epoch = int(state.get("world_epoch", 0))
            self._peer_stores = {
                int(r): {"addr": s.get("addr", ""),
                         "step": int(s.get("step", -1)),
                         "keys": list(s.get("keys", ())),
                         "bytes": int(s.get("bytes", 0)),
                         "ts": now}
                for r, s in state.get("peer_stores", {}).items()}
            self._slices = {int(r): int(s) for r, s in
                            (state.get("slices") or {}).items()}
            self._slice_worlds = {
                int(sid): {int(r): int(n) for r, n in world.items()}
                for sid, world in
                (state.get("slice_worlds") or {}).items()
            }
            self._slice_rounds = {
                int(sid): int(r) for sid, r in
                (state.get("slice_rounds") or {}).items()}
            self._slice_generation = {
                int(sid): int(g) for sid, g in
                (state.get("slice_generation") or {}).items()}
            self._slice_round_start = {}
            self._model_profile = {
                str(k): float(v) for k, v in
                (state.get("model_profile") or {}).items()}
            self._chip_hbm_bytes = int(state.get("chip_hbm_bytes", 0))
            last_plan = state.get("last_plan")
            self._last_plan = (dict(last_plan)
                               if isinstance(last_plan, dict) else None)
            self._known_chips = {
                int(r): int(n) for r, n in
                (state.get("known_chips") or {}).items()}
            # the memo key is not exported: the first ask after a
            # restore recomputes and re-stamps the same plan, unchanged
            self._last_plan_inputs = None
            # every restored member gets a fresh liveness clock
            self._last_seen = {rank: now for rank in self._alive_nodes}
            self._latest_round_start = now
            self._restore_extra(state)
            self._mutations += 1
        self._publish_draining_gauge()


# the JAX package's sharded rendezvous keeps the sliceless fleet world
# in the partition of this shard id (``master/rendezvous_shards.py``)
_FLEET_SHARD = "-1"


def _fleet_partition(state: dict) -> dict:
    """The flat manager's state from a sharded snapshot: the fleet
    shard's partition plus the router-level fields, as the JAX
    package's ``flatten_sharded_state`` builds them for a sliceless
    job."""
    fleet = (state.get("shards") or {}).get(_FLEET_SHARD, {})
    flat = dict(fleet)
    flat["world_epoch"] = int(state.get("world_epoch", 0))
    flat["peer_stores"] = dict(state.get("peer_stores") or {})
    return flat


class ElasticTrainingRendezvousManager(RendezvousManager):
    name = "elastic-training"


class NetworkCheckRendezvousManager(RendezvousManager):
    """2-round diagnostic rendezvous (reference: rdzv_manager.py:248-461).

    Round 0 groups adjacent pairs; round 1 re-pairs fastest-with-slowest
    so a node that failed round 0 is re-tested against a known-good
    partner. Not slice-scoped: the probe pairs across the whole fleet."""

    name = "network-check"
    slice_scoped = False

    def __init__(self, params: Optional[RendezvousParameters] = None):
        super().__init__(params)
        # round -> {node_rank: (normal, elapsed_time)}
        self._reports: Dict[int, Dict[int, Tuple[bool, float]]] = {}
        self._check_round = 0
        self._groups: Dict[int, List[List[int]]] = {}

    def get_comm_world(self, node_rank: int
                       ) -> Tuple[int, int, Dict[int, int]]:
        cut_info = None
        result = None
        with self._lock:
            self._last_seen[node_rank] = time.time()
            if self._check_rdzv_completed():
                cut_info = self._cut_round()
                self._groups[self._rdzv_round - 1] = self._group_nodes(
                    self._check_round
                )
                self._check_round += 1
            round_idx = self._rdzv_round - 1
            groups = self._groups.get(round_idx, [])
            for gi, group in enumerate(groups):
                if (node_rank in group
                        and all(r in self._latest_world for r in group)):
                    world = {r: self._latest_world[r] for r in group}
                    result = round_idx, gi, world
                    break
            if result is None:
                result = self._rdzv_round, 0, {}
        if cut_info is not None:
            self._emit_round_obs(cut_info)
        return result

    def _on_world_invalidated(self) -> None:
        # groups are keyed on the cut world (lock held)
        self._groups.pop(self._rdzv_round - 1, None)

    def _group_nodes(self, check_round: int) -> List[List[int]]:
        """Pair nodes for the probe (lock held). Round 0: adjacent pairs.
        Round ≥1: sort by last round's elapsed time, pair fastest with
        slowest."""
        ranks = sorted(self._latest_world)
        if check_round == 0 or not self._reports.get(check_round - 1):
            pairs = [ranks[i:i + 2] for i in range(0, len(ranks), 2)]
        else:
            prev = self._reports[check_round - 1]
            by_time = sorted(
                ranks, key=lambda r: prev.get(r, (False, float("inf")))[1]
            )
            pairs = []
            lo, hi = 0, len(by_time) - 1
            while lo < hi:
                pairs.append([by_time[lo], by_time[hi]])
                lo += 1
                hi -= 1
            if lo == hi:
                pairs.append([by_time[lo]])
        # merge a trailing singleton into the previous pair
        if pairs and len(pairs[-1]) == 1 and len(pairs) > 1:
            pairs[-2].extend(pairs.pop())
        return pairs

    def report_network_status(self, node_rank: int, normal: bool,
                              elapsed_time: float) -> None:
        with self._lock:
            round_reports = self._reports.setdefault(
                self._check_round - 1 if self._check_round else 0, {}
            )
            round_reports[node_rank] = (normal, elapsed_time)

    def join_rendezvous(self, node_rank: int, local_world_size: int,
                        node_ip: str = "", slice_id: int = -1) -> int:
        with self._lock:
            if not self._waiting and self._check_round >= 2:
                # a full 2-round cycle was consumed: a new joiner starts a
                # fresh cycle with a clean slate of verdicts
                self._reports.clear()
                self._groups.clear()
                self._check_round = 0
        return super().join_rendezvous(node_rank, local_world_size, node_ip,
                                       slice_id)

    def check_fault_node(self) -> Tuple[List[int], int]:
        """Nodes abnormal in ALL reported rounds are faulty. Returns
        (fault_nodes, rounds_reported)."""
        with self._lock:
            if not self._reports:
                return [], 0
            fault: Optional[set] = None
            for round_reports in self._reports.values():
                bad = {r for r, (ok, _) in round_reports.items() if not ok}
                fault = bad if fault is None else (fault & bad)
            return sorted(fault or ()), len(self._reports)

    def detect_stragglers(self) -> List[int]:
        """elapsed > ratio × median in the latest round."""
        ratio = Context.singleton().straggler_median_ratio
        with self._lock:
            if not self._reports:
                return []
            latest = self._reports[max(self._reports)]
            times = [t for ok, t in latest.values() if t > 0]
            if len(times) < 2:
                return []
            median = statistics.median(times)
            return sorted(
                r for r, (ok, t) in latest.items() if t > ratio * median
            )

    def network_check_success(self) -> bool:
        fault, rounds = self.check_fault_node()
        return rounds > 0 and not fault

    def _export_extra(self, state: dict) -> None:
        """Check-cycle fields join the base export's cut (lock held)."""
        state["check_round"] = self._check_round
        state["reports"] = {
            str(rnd): {str(r): [ok, t]
                       for r, (ok, t) in reports.items()}
            for rnd, reports in self._reports.items()
        }
        state["groups"] = {
            str(rnd): groups
            for rnd, groups in self._groups.items()
        }

    def _restore_extra(self, state: dict) -> None:
        """(lock held)"""
        self._check_round = int(state.get("check_round", 0))
        self._reports = {
            int(rnd): {int(r): (bool(v[0]), float(v[1]))
                       for r, v in reports.items()}
            for rnd, reports in state.get("reports", {}).items()
        }
        self._groups = {
            int(rnd): [[int(r) for r in group] for group in groups]
            for rnd, groups in state.get("groups", {}).items()
        }
