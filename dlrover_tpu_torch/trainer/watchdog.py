"""Step-hang watchdog: self-abort a silently stuck worker.

A collective that deadlocks after a peer dies (or a wedged host-callback,
or an input pipeline stuck on a dead filesystem) hangs the step loop
*forever* — the worker stays alive, heartbeats keep flowing, and nothing
above notices for `hang_seconds` (default 30 min) of master-side
timeout. This watchdog is the worker-side backstop: a thread that
notices no step progress past ``Context.hang_watchdog_s``, dumps
every thread's stack plus the flight record (the postmortem that tells
*where* it hung), and self-aborts with SIGABRT so the agent's normal
exit path restarts the worker. The agent classifies the abort as
``NodeExitReason.HANG`` — distinct from a crash (no relaunch-budget
charge) and from a drain.

Own copy of the JAX package's ``trainer/watchdog.py``; stdlib + obs
only, so the agent imports it (for ``default_warmup_s``) without torch.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
import traceback
from typing import Callable, Dict, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.common.log import default_logger as logger


def default_warmup_s(hang_s: float) -> float:
    """First-step budget: the first step may legitimately take much
    longer than steady state (a kernel build when the precompile
    missed). Shared with the agent's RelaunchGovernor, whose
    no-progress horizon reasons about when an incarnation watched by
    THIS formula must have stepped — keep them in lockstep."""
    return max(2.0 * hang_s, 300.0)


def all_thread_stacks() -> Dict[str, list]:
    """Formatted stacks of every live thread, keyed by thread name —
    the "where is it stuck" evidence a hang postmortem needs."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for tid, frame in sys._current_frames().items():
        name = names.get(tid, f"thread-{tid}")
        stacks[name] = [line.rstrip("\n")
                        for line in traceback.format_stack(frame)]
    return stacks


def _default_abort() -> None:
    # SIGABRT (not SIGKILL): a distinct, classifiable exit the agent
    # maps to NodeExitReason.HANG, and the default disposition still
    # guarantees death even with exotic signal setups
    os.kill(os.getpid(), signal.SIGABRT)


class StepHangWatchdog:
    """Arm with ``start()``, feed with ``notify_step(step)`` once per
    loop iteration, disarm with ``stop()`` before long non-step phases
    (final checkpoint wait). ``clock``/``abort_fn`` are injectable for
    deterministic tests (fake time, no real abort)."""

    def __init__(self, hang_s: float,
                 poll_s: Optional[float] = None,
                 warmup_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 abort_fn: Callable[[], None] = _default_abort):
        self._hang_s = hang_s
        self._poll_s = (poll_s if poll_s is not None
                        else max(1.0, min(hang_s / 4.0, 30.0)))
        self._warmup_s = (warmup_s if warmup_s is not None
                          else default_warmup_s(hang_s))
        self._clock = clock
        self._abort_fn = abort_fn
        self._lock = threading.Lock()
        self._last_progress = clock()
        self._last_step = -1
        self._fired = False
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- step-loop side ----------------------------------------------------
    def notify_step(self, step: int) -> None:
        with self._lock:
            self._last_step = step
            self._last_progress = self._clock()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Arm (or RE-arm after ``stop()`` — a caller that runs one loop
        instance's ``run()`` repeatedly must stay protected on every
        run, not just the first)."""
        if self._hang_s <= 0 or self._fired:
            return
        if (self._thread is not None and self._thread.is_alive()
                and not self._stopped.is_set()):
            return                       # already armed
        with self._lock:
            self._last_progress = self._clock()
            # a fresh arm gets the warmup budget again: the new run's
            # first step may build kernels just like the first ever
            self._last_step = -1
        # a NEW event per arm: the previous (stopped) thread holds the
        # old set event and winds down on its next poll tick, even
        # though the new thread is already watching
        self._stopped = threading.Event()
        stopped = self._stopped

        def _loop():
            while not stopped.wait(self._poll_s):
                if self.check_once():
                    return

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="step-hang-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    # -- the check (public for fake-clock tests) --------------------------
    def check_once(self) -> bool:
        """Returns True when the hang fired (the loop then exits; in
        production ``abort_fn`` has already killed the process)."""
        with self._lock:
            if self._fired:
                return True
            budget = (self._hang_s if self._last_step >= 0
                      else self._warmup_s)
            stalled = self._clock() - self._last_progress
            if stalled <= budget:
                return False
            self._fired = True
            step, last = self._last_step, stalled
        self._fire(step, last)
        return True

    def _fire(self, step: int, stalled_s: float) -> None:
        stacks = all_thread_stacks()
        logger.error(
            "step-hang watchdog: no progress for %.0fs (last step %d); "
            "dumping stacks and aborting", stalled_s, step)
        recorder = obs.get_flight_recorder()
        recorder.record_event("step_hang", step=step,
                              stalled_s=round(stalled_s, 1),
                              hang_watchdog_s=self._hang_s,
                              stacks=stacks)
        obs.get_registry().counter(
            "dlrover_tpu_step_hang_aborts_total",
            "Workers self-aborted by the step-hang watchdog").inc()
        recorder.dump(reason="step-hang")
        self._abort_fn()
