"""Preemption notices: pluggable sources + the agent→worker drain file.

Spot reclaims and maintenance events arrive with an advance notice
window; a preempted machine that is treated like a crash loses up to a liveness
timeout of survivor progress plus every unsaved step. This module turns
the notice into a *planned* departure:

- :class:`PreemptionWatcher` polls pluggable sources on the agent —
  SIGTERM with a grace window (chained AFTER the flight-recorder dump
  handler, never clobbering it), a JSON notice file
  (``$DLROVER_TPU_PREEMPTION_NOTICE`` — what the chaos ``preempt``
  fault writes), and a k8s-style static env deadline
  (``$DLROVER_TPU_PREEMPTION_AT``).
- The agent reports ``drain(rank, deadline)`` to the master
  (``DrainReport`` RPC) and publishes a drain request the worker's step
  loop consumes at the next step boundary
  (:func:`write_drain_request` / :class:`DrainRequestSource` — the same
  atomic-file contract as the profiler's request channel).

The drain request carries ``exit``: True means save-and-exit with the
clean-drain code (this node is going away); False means save-and-keep-
running (the master's urgent ``checkpoint:{rank}`` fan-out to the
survivors).

Own copy of the JAX package's ``agent/preemption.py`` (stdlib-only).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger


@dataclasses.dataclass
class PreemptionNotice:
    """One advance notice: this host disappears at ``deadline``."""

    deadline: float              # unix ts
    reason: str = ""
    source: str = ""             # "sigterm" | "file" | "env"

    @property
    def grace_s(self) -> float:
        return max(0.0, self.deadline - time.time())


class NoticeSource:
    """One way a preemption notice can arrive; ``poll()`` returns the
    notice once (idempotent None afterwards)."""

    name = "base"

    def poll(self) -> Optional[PreemptionNotice]:
        raise NotImplementedError

    def close(self) -> None:
        """Release anything installed (signal handlers)."""


class FileNoticeSource(NoticeSource):
    """JSON notice file (``{"deadline": ts}`` or ``{"grace_s": n}``,
    optional ``"reason"``) — the contract the chaos ``preempt`` fault
    and platform node-termination hooks write, atomically."""

    name = "file"

    def __init__(self, path: str = ""):
        self._path = path or os.environ.get(
            NodeEnv.PREEMPTION_NOTICE_FILE, "")
        self._warned_stale = False

    def poll(self) -> Optional[PreemptionNotice]:
        if not self._path:
            return None
        try:
            st = os.stat(self._path)
            with open(self._path) as f:
                raw = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return None
        if not isinstance(raw, dict):
            return None
        deadline = float(raw.get("deadline", 0.0) or 0.0)
        if deadline <= 0.0:
            grace = float(raw.get("grace_s",
                                  Context.singleton()
                                  .preempt_default_grace_s))
            # anchored to the WRITE time, not the read time: a
            # grace-only notice left behind by a previous incarnation
            # would otherwise look fresh on every read and re-drain
            # each relaunched agent forever
            deadline = st.st_mtime + grace
        if deadline <= time.time():
            # the window already closed and this process is still
            # alive: the drain was cancelled (or the file is a
            # leftover) — draining now would skip the checkpoint AND
            # loop, since a DRAINED relaunch is never budget-charged
            if not self._warned_stale:
                self._warned_stale = True
                logger.warning(
                    "ignoring stale preemption notice %s (deadline "
                    "%.0fs in the past)", self._path,
                    time.time() - deadline)
            return None
        self._warned_stale = False
        return PreemptionNotice(deadline=deadline,
                                reason=str(raw.get("reason", "")),
                                source=self.name)


class EnvNoticeSource(NoticeSource):
    """k8s-style static deadline: ``$DLROVER_TPU_PREEMPTION_AT`` holds a
    unix timestamp set at pod creation (a scheduled maintenance window /
    spot VM with a known reclaim time). Fires once the deadline is
    within the default grace horizon — early enough to checkpoint, late
    enough not to drain a week ahead of a known maintenance date."""

    name = "env"

    def poll(self) -> Optional[PreemptionNotice]:
        raw = os.environ.get(NodeEnv.PREEMPTION_AT, "")
        if not raw:
            return None
        try:
            deadline = float(raw)
        except ValueError:
            return None
        now = time.time()
        if deadline <= now:
            # the env var is static by design (set in the pod spec):
            # once the window has passed, a replacement pod inheriting
            # the same spec must NOT drain itself at startup
            return None
        # preempt_env_horizon_s, not the bare-SIGTERM grace, when set:
        # a job whose full save outlasts the 30s grace needs the drain
        # to START earlier than that, and a known-in-advance deadline
        # is exactly the case where it can
        ctx = Context.singleton()
        horizon = max(ctx.preempt_env_horizon_s
                      or ctx.preempt_default_grace_s, 1.0)
        if deadline - now > horizon:
            return None
        return PreemptionNotice(deadline=deadline,
                                reason="scheduled preemption (env)",
                                source=self.name)


class SignalNoticeSource(NoticeSource):
    """SIGTERM with grace: the platform's last-resort notice. The
    handler CHAINS the previous disposition (the flight recorder's dump
    handler — both must fire; install order in the agent puts
    this source underneath so the recorder's handler calls through to
    it). The deadline is now + ``preempt_default_grace_s`` — a bare
    SIGTERM carries no better information."""

    name = "sigterm"

    def __init__(self, signum: int = signal.SIGTERM):
        self._signum = signum
        self._notice: Optional[PreemptionNotice] = None
        self._prev: Any = None
        self._handler: Any = None
        self._installed = False

    def install(self) -> None:
        """Main-thread-only (CPython signal contract)."""
        if self._installed:
            return

        def _handler(signum, frame):
            if self._notice is None:
                grace = Context.singleton().preempt_default_grace_s
                self._notice = PreemptionNotice(
                    deadline=time.time() + grace,
                    reason=f"signal {signum}", source=self.name)
                logger.warning(
                    "SIGTERM: treating as a preemption notice "
                    "(grace %.0fs)", grace)
            prev = self._prev
            if callable(prev):
                prev(signum, frame)
            # SIG_DFL deliberately NOT re-raised here: the whole point
            # of the notice is a graceful drain instead of dying now

        self._handler = _handler
        self._prev = signal.signal(self._signum, _handler)
        self._installed = True

    def poll(self) -> Optional[PreemptionNotice]:
        notice, self._notice = self._notice, None
        return notice

    def close(self) -> None:
        if not self._installed:
            return
        self._installed = False
        try:
            if signal.getsignal(self._signum) is self._handler:
                signal.signal(self._signum, self._prev)
            # else: something chained ON TOP of this source after
            # install (the flight recorder's dump handler in the
            # agent) — restoring _prev would silently rip that handler
            # out with ours. Leave the chain intact: our handler only
            # records a notice nobody polls anymore and calls through.
        except ValueError:
            pass          # not the main thread: leave the disposition


def default_sources(install_signal: bool = True,
                    notice_file: str = "") -> List[NoticeSource]:
    """The standard source set: notice file, static env deadline, and —
    main thread only (CPython signal contract) — SIGTERM with grace."""
    sources: List[NoticeSource] = [FileNoticeSource(notice_file),
                                   EnvNoticeSource()]
    if install_signal and (threading.current_thread()
                           is threading.main_thread()):
        sig = SignalNoticeSource()
        sig.install()
        sources.append(sig)
    return sources


class PreemptionWatcher:
    """Polls the notice sources; delivers the FIRST notice to
    ``on_notice`` exactly once. The callback runs on the watcher thread
    and must only flip an event the agent's main loop consumes (worker
    lifecycle stays single-threaded, like the hang-event contract)."""

    def __init__(self, on_notice: Callable[[PreemptionNotice], None],
                 sources: Optional[List[NoticeSource]] = None,
                 poll_s: Optional[float] = None):
        self._on_notice = on_notice
        self._sources = (sources if sources is not None
                         else default_sources())
        self._poll_s = (poll_s if poll_s is not None
                        else Context.singleton().preempt_notice_poll_s)
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._delivered = False

    def poll_once(self) -> Optional[PreemptionNotice]:
        """One sweep over the sources; delivers on first hit."""
        if self._delivered:
            return None
        for source in self._sources:
            try:
                notice = source.poll()
            except Exception:  # noqa: BLE001 — one source, not the watch
                logger.exception("preemption source %s failed",
                                 source.name)
                continue
            if notice is not None:
                self._delivered = True
                logger.warning(
                    "preemption notice (%s): departing in %.0fs (%s)",
                    notice.source, notice.grace_s,
                    notice.reason or "no reason")
                self._on_notice(notice)
                return notice
        return None

    def start(self) -> None:
        if self._thread is not None:
            return

        def _loop():
            while not self._stopped.wait(self._poll_s):
                if self.poll_once() is not None:
                    return

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="preemption-watcher")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()
        for source in self._sources:
            source.close()


# ---------------------------------------------------------------------------
# Agent → worker drain-request channel (atomic file, one os.stat per step)
# ---------------------------------------------------------------------------


def write_drain_request(path: str, seq: int, deadline: float,
                        reason: str = "", exit_worker: bool = True) -> None:
    """Agent side: atomically publish a drain/checkpoint request for the
    worker's step loop. A new ``seq`` supersedes any previous request."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"seq": int(seq), "deadline": float(deadline),
                   "reason": reason, "exit": bool(exit_worker)}, f)
    os.replace(tmp, path)


class DrainRequestSource:
    """Worker side: polled once per step from the step loop's thread.
    Cheap when idle (one ``os.stat`` of a usually-absent file); a
    respawned worker re-reads the file, so ``seq`` dedup rides on the
    ``.done`` acknowledgement the loop writes after consuming a
    save-and-continue request (an exit request never needs dedup — the
    process is gone)."""

    def __init__(self, path: str = ""):
        self._path = path or os.environ.get(
            NodeEnv.DRAIN_REQUEST_FILE, "")
        self._last_stat = None
        self._handled_seq = -1
        if self._path:
            try:
                with open(self._path + ".done") as f:
                    self._handled_seq = int(json.load(f).get("seq", -1))
            except (OSError, json.JSONDecodeError, ValueError, TypeError):
                pass

    def poll(self) -> Optional[Dict[str, Any]]:
        if not self._path:
            return None
        try:
            st = os.stat(self._path)
        except OSError:
            return None
        # inode in the key: every write is a tmp+rename (fresh inode),
        # so a rewrite inside one coarse-mtime tick (1 s on some NFS)
        # still changes the key — mtime alone would skip it forever
        stat_key = (st.st_ino, st.st_mtime_ns, st.st_size)
        if stat_key == self._last_stat:
            return None
        self._last_stat = stat_key
        try:
            with open(self._path) as f:
                raw = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return None
        if not isinstance(raw, dict):
            return None
        seq = int(raw.get("seq", 0) or 0)
        if seq <= self._handled_seq:
            return None
        self._handled_seq = seq
        return raw

    def acknowledge(self, seq: int) -> None:
        """Record a consumed save-and-continue request so a respawn does
        not replay it."""
        if not self._path:
            return
        try:
            tmp = self._path + ".done.tmp"
            with open(tmp, "w") as f:
                json.dump({"seq": int(seq), "ts": time.time()}, f)
            os.replace(tmp, self._path + ".done")
        except OSError:
            pass
