"""Scriptable fault injection for chaos testing.

Own copy of the JAX package's ``diagnostics/chaos.py``: a hook the
training loop polls each step (the worker role) and the master's
servicer feeds each step report (the master role), scripted through one
env var, so a chaos run is a normal job launch with
``DLROVER_TPU_CHAOS`` set on (or forwarded to) the chosen process.

Spec grammar (semicolon-separated faults), the JAX package's whole
grammar:

    DLROVER_TPU_CHAOS="action:role:rank@step[:duration]"

    kill:worker:0@5        SIGKILL worker rank 0 when it reaches step 5
    hang:worker:1@3:120    rank 1 blocks 120 s at step 3 (with
                           DLROVER_TPU_HANG_WATCHDOG_S under the block
                           length, the step-hang watchdog fires first:
                           stack dump, self-abort, agent restart)
    slow:worker:2@4:0.5    rank 2 sleeps 0.5 s EVERY step from step 4 on
    preempt:worker:1@4:20  rank 1 receives an advance PREEMPTION NOTICE
                           at step 4 with a 20 s grace window: the fault
                           atomically writes the notice file the agent's
                           PreemptionWatcher polls
                           ($DLROVER_TPU_PREEMPTION_NOTICE), driving the
                           whole drain chain. Grace defaults to
                           Context.preempt_default_grace_s.
    kill:master:0@10       the master SIGKILLs itself when a worker
                           reports step 10 (armed on the master; a hot
                           standby promotes, the agents reconnect)
    resize:-1@6            at step 6 the highest rank leaves with the
                           clean-drain exit: the master removes it and
                           the survivors re-plan the smaller world in
                           one round (armed on every worker; whether a
                           rank is among the |k| leavers is decided at
                           fire time against $DLROVER_TPU_WORLD_SIZE)
    resize:+2@3            rank 0 writes the resize-request file
                           ($DLROVER_TPU_RESIZE_REQUEST) the launcher
                           polls: spawning processes is its power

Each injector arms the faults of its own role and rank (and a worker
every worker-unit resize) and skips the rest, as the JAX injector does:
a worker skips a ``master`` fault. The grammar also parses the faults
whose subsystem the port lacks, and the injector refuses them by name
(``NotImplementedError`` with their ROADMAP Queue A item): the ``shard``
role (12.2, the sharded rendezvous), the ``slice`` role and the
slice-unit resize (6.4, slice mode), and ``offer``/``revoke`` (12.10,
the brain's fleet controller).

Each kill/hang/preempt/resize fault fires at most once per process;
slow applies from its step onward. A resize fault also records a
JOB-wide consumed marker (with CHAOS_STATE_ENV set) when it fires,
holding the world it was judged against: a survivor respawned into the
smaller world never re-evaluates the delta and drains itself, and a
leaver respawned before it reached the step still leaves. The hook is a
no-op (one env read at construction) when the variable is unset.

One-shot markers (CHAOS_STATE_ENV) are keyed by the fault's INDEX in
the full spec, so duplicate faults fire independently, and are created
atomically (O_EXCL) so two racing incarnations cannot both claim an
unfired fault. A kill or preempt fault records its marker before it
fires (the respawn must not replay it); a hang records it only after
the sleep (an incarnation killed mid-hang replays it on respawn).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import List, Optional

from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import NodeEnv, WorkerExit
from dlrover_tpu_torch.common.log import default_logger as logger

CHAOS_ENV = "DLROVER_TPU_CHAOS"
# directory recording fired one-shot faults: makes kill/hang fire once
# per JOB rather than once per process (a respawned worker re-parses the
# same env; without the marker a kill fault would SIGKILL every
# incarnation and exhaust the restart budget). Unset = per-process only.
CHAOS_STATE_ENV = "DLROVER_TPU_CHAOS_STATE"


@dataclasses.dataclass
class ChaosFault:
    action: str            # "kill" | "hang" | "slow" | "preempt" |
    #                        "resize" | "offer" | "revoke"
    role: str              # node type the fault targets ("worker",
    #                        "master", …); the resize UNIT ("worker" |
    #                        "slice") for resize faults; "slice" for
    #                        the market faults (offer/revoke)
    rank: int              # node rank within the role; the SIGNED
    #                        delta for resize faults; the offered
    #                        slice COUNT for offer; the revoked slice
    #                        id for revoke
    at_step: int           # fire when the target reaches this step
    # hang: block seconds; slow: sleep/step; preempt/revoke: grace
    # window (<= 0 → Context.preempt_default_grace_s); offer: expected
    # lifetime TTL (<= 0 → the provider's default)
    duration: float = 60.0
    fired: bool = False
    # position in the FULL spec (before role/rank filtering): the
    # one-shot marker key, stable across respawns that re-parse the
    # same env — and distinct for duplicate faults
    index: int = 0


def parse_chaos(spec: str) -> List[ChaosFault]:
    """Parse the CHAOS_ENV grammar; raises ValueError on a bad spec (a
    chaos run with a typo'd fault must fail loudly, not run clean)."""
    faults = []
    for index, part in enumerate(
            filter(None, (p.strip() for p in spec.split(";")))):
        try:
            head, at = part.split("@", 1)
            head_fields = head.split(":")
            at_fields = at.split(":")
            if head_fields[0].strip().lower() == "resize":
                # resize:±k@step (ranks) / resize:slice:±k@step
                # (slices): the "rank" field carries the SIGNED delta
                if len(head_fields) == 2:
                    role, delta = "worker", head_fields[1]
                else:
                    role, delta = head_fields[1], head_fields[2]
                delta_n = int(delta)
                if delta_n == 0:
                    raise ValueError("resize delta must be non-zero")
                fault = ChaosFault(
                    action="resize", role=role.strip(),
                    rank=delta_n, at_step=int(at_fields[0]),
                    index=index)
                if fault.role not in ("worker", "slice"):
                    raise ValueError(
                        f"resize unit must be worker or slice, "
                        f"got {fault.role!r}")
                faults.append(fault)
                continue
            action, role, rank = head_fields
            fault = ChaosFault(
                action=action.strip().lower(), role=role.strip(),
                rank=int(rank), at_step=int(at_fields[0]),
                index=index,
            )
            if len(at_fields) > 1:
                fault.duration = float(at_fields[1])
        except (ValueError, IndexError) as e:
            raise ValueError(
                f"bad chaos fault {part!r} (want "
                f"'action:role:rank@step[:duration]' or "
                f"'resize:[slice:]±k@step'): {e}") from e
        if fault.action not in ("kill", "hang", "slow", "preempt",
                                "offer", "revoke"):
            raise ValueError(f"unknown chaos action {fault.action!r}")
        if fault.action in ("preempt", "revoke") and len(at_fields) == 1:
            fault.duration = 0.0   # grace resolves from Context at fire
        if fault.action == "offer":
            # offer:slice:+k@step[:ttl] — the rank field is the offered
            # slice COUNT (the grammar writes it signed, like resize)
            if fault.role != "slice":
                raise ValueError(
                    f"offer targets slices, got role {fault.role!r}")
            if fault.rank <= 0:
                raise ValueError(
                    f"offer count must be positive, got {fault.rank}")
            if len(at_fields) == 1:
                fault.duration = 0.0   # TTL → the provider's default
        elif fault.action == "revoke" and fault.role != "slice":
            raise ValueError(
                f"revoke targets slices, got role {fault.role!r}")
        elif fault.rank < 0:
            raise ValueError(
                f"chaos fault {part!r} has negative rank {fault.rank} "
                f"(no node can match it)")
        faults.append(fault)
    return faults



def _unported_item(fault: ChaosFault) -> str:
    """The ROADMAP Queue A item whose subsystem ``fault`` needs and the
    port lacks, "" when the port can inject it."""
    if fault.action in ("offer", "revoke"):
        return "12.10 (the brain's fleet controller)"
    if fault.role == "shard":
        return "12.2 (the sharded rendezvous)"
    if fault.role == "slice":
        return "6.4 (slice mode)"
    return ""


class ChaosInjector:
    """Per-process injector for the worker or the master role; construct
    once, call ``maybe_inject`` per step."""

    def __init__(self, role: str = "worker",
                 rank: Optional[int] = None,
                 spec: Optional[str] = None):
        spec = spec if spec is not None else os.environ.get(CHAOS_ENV, "")
        if rank is None:
            rank = int(os.environ.get(NodeEnv.NODE_RANK, "0"))
        self._role = role
        self._rank = rank
        self._state_dir = os.environ.get(CHAOS_STATE_ENV, "")
        faults = parse_chaos(spec) if spec else []
        for fault in faults:
            item = _unported_item(fault)
            if item:
                raise NotImplementedError(
                    f"chaos fault {fault.action}:{fault.role}:{fault.rank}"
                    f"@{fault.at_step} is not ported yet (ROADMAP Queue A "
                    f"item {item})")
        # a worker-unit resize arms on EVERY worker: whether this rank
        # leaves is decided at fire time against the world
        self.faults = [f for f in faults
                       if (f.action == "resize" and role == "worker")
                       or (f.action != "resize" and f.role == role
                           and f.rank == rank)]
        for fault in self.faults:
            if self._already_fired(fault):
                fault.fired = True
        if self.faults:
            logger.warning("chaos injector ARMED for %s-%d: %s",
                           role, rank, self.faults)

    def _marker(self, fault: ChaosFault) -> str:
        # keyed by spec index: two faults that agree on
        # action/role/rank/step still get their own markers. A resize
        # fault also keys on THIS node's rank: every leaver fires its
        # own copy
        per_node = f"_n{self._rank}" if fault.action == "resize" else ""
        return os.path.join(
            self._state_dir,
            f"chaos_{fault.index}_{fault.action}_{fault.role}"
            f"_{fault.rank}_{fault.at_step}{per_node}")

    def _job_marker(self, fault: ChaosFault) -> str:
        """The JOB-wide marker of a resize fault, holding the world it
        was judged against when it first fired."""
        return self._marker(fault).replace(f"_n{self._rank}", "_job")

    def _job_fire_world(self, fault: ChaosFault) -> Optional[int]:
        """The world size recorded when the resize fault first fired
        anywhere in the job; None = not fired yet (or no state dir)."""
        if not self._state_dir:
            return None
        try:
            with open(self._job_marker(fault)) as f:
                payload = json.loads(f.read() or "{}")
            return int(payload.get("world", 0)) or 0
        except (OSError, ValueError):
            return None

    def _record_job_fired(self, fault: ChaosFault, world: int) -> None:
        """The first claimer records the fire-time world (O_EXCL: one
        writer; later ranks and incarnations read it back)."""
        if not self._state_dir:
            return
        try:
            os.makedirs(self._state_dir, exist_ok=True)
            fd = os.open(self._job_marker(fault),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError:
            return
        with os.fdopen(fd, "w") as f:
            json.dump({"world": int(world), "pid": os.getpid()}, f)

    def _resize_leaving(self, fault: ChaosFault, world: int) -> bool:
        """Is this rank among the departing set of a scale-down fault
        judged against ``world``?"""
        return self._rank >= world + fault.rank

    def _already_fired(self, fault: ChaosFault) -> bool:
        if not self._state_dir:
            return False
        if os.path.exists(self._marker(fault)):
            return True
        if fault.action != "resize":
            return False
        fired_world = self._job_fire_world(fault)
        if fired_world is None:
            return False
        if fault.rank > 0 or not fired_world:
            # scale-up (one writer), or a marker without its world:
            # consumed
            return True
        # scale-down: consumed for the survivors of the fire-time world;
        # a leaver respawned before the step still fires
        return not self._resize_leaving(fault, fired_world)

    def _record_fired(self, fault: ChaosFault) -> bool:
        """Claim the one-shot marker; returns whether THIS process won.
        O_CREAT|O_EXCL is the atomicity: a racing incarnation loses the
        create and must not fire the fault a second time."""
        fault.fired = True
        if not self._state_dir:
            return True
        os.makedirs(self._state_dir, exist_ok=True)
        try:
            fd = os.open(self._marker(fault),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w") as f:
            f.write(str(os.getpid()))
        return True

    def maybe_inject(self, step: int) -> None:
        for fault in self.faults:
            if fault.fired or step < fault.at_step:
                continue
            if fault.action == "kill":
                # record BEFORE dying, or the respawned incarnation
                # replays the fault forever
                if not self._record_fired(fault):
                    continue
                logger.warning("chaos: SIGKILL self (%s-%d) at step %d",
                               self._role, self._rank, step)
                os.kill(os.getpid(), signal.SIGKILL)
            elif fault.action == "hang":
                logger.warning("chaos: hanging %s-%d for %.1fs at step %d",
                               self._role, self._rank, fault.duration,
                               step)
                time.sleep(fault.duration)
                # record AFTER the sleep: a process killed and respawned
                # mid-hang must replay the hang, not skip it
                self._record_fired(fault)
            elif fault.action == "preempt":
                # record BEFORE writing the notice: a later incarnation
                # (the drain cancelled operator-side) must not re-preempt
                # itself forever
                if not self._record_fired(fault):
                    continue
                self._write_preemption_notice(fault, step)
            elif fault.action == "resize":
                self._inject_resize(fault, step)
            elif fault.action == "slow":
                # applies every step from at_step on (a real straggler)
                time.sleep(fault.duration)

    def _inject_resize(self, fault: ChaosFault, step: int) -> None:
        """A deterministic mid-run resize. Scale-DOWN (delta < 0): this
        process leaves with the clean-drain exit when its rank is among
        the |delta| highest of the fire-time world; the agent reports a
        planned departure, the master removes the rank at once and the
        survivors re-plan and re-form in one round. Scale-UP (delta >
        0): rank 0 atomically writes the resize-request file the
        launcher polls."""
        delta = fault.rank
        if delta < 0:
            # the job marker's recorded world wins over the env: a
            # respawn into the shrunken world neither cascades nor
            # under-delivers
            world = (self._job_fire_world(fault)
                     or int(os.environ.get(NodeEnv.WORLD_SIZE, "0")))
            if world <= 0:
                logger.warning("chaos resize:%d needs %s in the env; "
                               "skipping", delta, NodeEnv.WORLD_SIZE)
                fault.fired = True
                return
            self._record_job_fired(fault, world)
            leaving = self._resize_leaving(fault, world)
            fault.fired = True
            if not leaving:
                return
            if not self._record_fired(fault):
                return
            logger.warning(
                "chaos: resize %+d at step %d — %s-%d leaves with the "
                "clean-drain exit (survivors re-plan the smaller world)",
                delta, step, self._role, self._rank)
            raise SystemExit(WorkerExit.DRAIN)
        # scale-up: one writer (rank 0) hands the request to the
        # launcher; everyone else marks the fault consumed
        fault.fired = True
        if self._rank != 0:
            return
        if not self._record_fired(fault):
            return
        path = os.environ.get(NodeEnv.RESIZE_REQUEST_FILE, "")
        logger.warning("chaos: resize %+d (%ss) requested at step %d -> %s",
                       delta, fault.role, step,
                       path or "<no request file>")
        if not path:
            return
        payload = {"delta": delta, "unit": fault.role, "step": step,
                   "ts": time.time()}
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def _write_preemption_notice(self, fault: ChaosFault,
                                 step: int) -> None:
        """Simulate the platform's advance notice: atomically write the
        JSON notice file the agent's PreemptionWatcher polls."""
        path = os.environ.get(NodeEnv.PREEMPTION_NOTICE_FILE, "")
        grace = (fault.duration if fault.duration > 0
                 else Context.singleton().preempt_default_grace_s)
        logger.warning(
            "chaos: preemption notice for %s-%d at step %d "
            "(grace %.1fs) -> %s", self._role, self._rank, step,
            grace, path or "<no notice file configured>")
        if not path:
            return
        payload = {"deadline": time.time() + grace,
                   "grace_s": grace,
                   "reason": f"chaos {fault.action}@{fault.at_step}"}
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
