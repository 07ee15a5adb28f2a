"""On-demand ``torch.profiler`` trace capture.

The port's counterpart of the JAX package's ``obs/profiler.py``. Two
triggers, one mechanism:

- **Static window**: trace steps [start, start+num) of every (re)spawn.
- **On-demand**: the agent (executing a master ``profile:{rank}``
  diagnosis action) atomically writes a request file
  (``$DLROVER_TPU_PROFILE_REQUEST``, JSON ``{"id", "num_steps",
  "dump_dir"}``); the worker's step loop polls it (one ``os.stat`` a
  step) and runs a bounded capture.

Every capture gets its own directory (``capture-<id>-<ts>``) under the
dump dir, holding the Chrome trace (``trace.json``, CPU activity always
and CUDA activity when the process uses a card) and a ``manifest.json``
with the step window and outcome; the manifest is mirrored to
``<request>.done`` so the agent sees completion without knowing the
layout. A request id at or below the served one is a replay and is
skipped: a respawned worker seeds that watermark from the ``.done``
mirror, and a rewrite of the file is recognized by its ``(inode,
mtime_ns, size)``. Every failure degrades to a manifest with ``status !=
"ok"``: profiling is diagnostics, and must never kill training.

The loop polls at the step boundary, outside its timed step, so starting
the profiler and writing the trace (tens of MB for five Llama-1B steps)
never lands inside a step.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

TRACE_NAME = "trace.json"


def _write_json(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def write_profile_request(path: str, request_id: int, num_steps: int,
                          dump_dir: str) -> None:
    """Agent side: atomically publish a capture request for the worker's
    poll loop. A new ``id`` supersedes any previous request."""
    _write_json(path, {"id": int(request_id),
                       "num_steps": int(num_steps),
                       "dump_dir": dump_dir})


def read_profile_result(path: str) -> Optional[Dict[str, Any]]:
    """Agent side: the worker's completion manifest for the request at
    ``path`` (None until the capture finishes)."""
    try:
        with open(path + ".done") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None


def _uses_cuda() -> bool:
    """Whether this process has a CUDA context (the loop's card): only
    then does the capture ask for CUDA activity. Never initializes
    CUDA itself."""
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


class ProfilerCapture:
    """One bounded trace capture. Not thread-safe by itself: driven only
    from the step loop through ProfilerSession."""

    def __init__(self, dump_dir: str, num_steps: int,
                 request_id: int = 0, start_step: int = 0):
        self.request_id = request_id
        self.num_steps = max(1, int(num_steps))
        self.start_step = start_step
        self.status = "pending"
        ts = int(time.time())
        self.trace_dir = os.path.join(
            dump_dir, f"capture-{request_id}-{ts}")
        self._profiler = None
        # wall seconds of the start and of the stop with the trace's
        # export, and the trace's size: the capture's own cost
        self.start_s = 0.0
        self.stop_s = 0.0
        self.trace_bytes = 0

    def start(self) -> bool:
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
        except OSError as e:
            self.status = f"error: mkdir failed: {e}"
            return False
        t0 = time.monotonic()
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if _uses_cuda():
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
        except Exception as e:  # noqa: BLE001 — backend-dependent
            # the capture artifact still lands (the manifest records why
            # the trace is absent), so the action's round trip stays
            # observable where the profiler is unavailable
            self.status = f"unavailable: {e}"
            logger.warning("torch profiler unavailable: %s", e)
            return False
        self._profiler = profiler
        self.start_s = time.monotonic() - t0
        self.status = "tracing"
        return True

    def stop(self) -> Dict[str, Any]:
        """End the trace (if one started), export it and write the
        manifest; returns the manifest dict. Never raises."""
        if self.status == "tracing":
            t0 = time.monotonic()
            profiler, self._profiler = self._profiler, None
            try:
                profiler.stop()
                path = os.path.join(self.trace_dir, TRACE_NAME)
                profiler.export_chrome_trace(path)
                self.trace_bytes = os.path.getsize(path)
                self.status = "ok"
            except Exception as e:  # noqa: BLE001
                self.status = f"error: stop_trace: {e}"
            self.stop_s = time.monotonic() - t0
        manifest = {
            "id": self.request_id,
            "status": self.status,
            "trace_dir": self.trace_dir,
            "start_step": self.start_step,
            "num_steps": self.num_steps,
            "finished_at": time.time(),
            "start_s": round(self.start_s, 6),
            "stop_s": round(self.stop_s, 6),
            "trace_bytes": self.trace_bytes,
        }
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            _write_json(os.path.join(self.trace_dir, "manifest.json"),
                        manifest)
        except OSError:
            pass
        return manifest


class ProfilerSession:
    """Worker-side driver: polls the request file and the static window,
    owns at most one active capture. ``poll(step)`` is called once per
    loop iteration from the step loop's thread; ``stop()`` may be called
    from teardown paths, and the lock keeps the two honest."""

    def __init__(self, request_path: str = "", static_dir: str = "",
                 static_start: int = 3, static_num: int = 3):
        self._lock = threading.Lock()
        self._request_path = request_path or os.environ.get(
            "DLROVER_TPU_PROFILE_REQUEST", "")
        self._static_dir = static_dir
        self._static_start = static_start
        self._static_num = static_num
        self._static_done = False
        self._active: Optional[ProfilerCapture] = None
        self._last_request_stat = None
        self._handled_id = -1
        # a respawned worker must not replay a request its predecessor
        # already served (the agent leaves the request file in place):
        # the completion manifest records the served id. A request with
        # no manifest was never finished, and re-running it is right.
        if self._request_path:
            done = read_profile_result(self._request_path)
            if done is not None:
                try:
                    self._handled_id = int(done.get("id", -1))
                except (TypeError, ValueError):
                    pass

    def poll(self, local_step: int) -> None:
        """Drive captures from the step loop. Cheap when idle: one stat
        of the request file (when configured) and two compares."""
        with self._lock:
            active = self._active
            if active is not None:
                if local_step - active.start_step >= active.num_steps:
                    self._finish_locked()
                return
            request = self._poll_request_locked()
            if request is not None:
                capture = ProfilerCapture(
                    request.get("dump_dir") or self._default_dump_dir(),
                    int(request.get("num_steps", 3) or 3),
                    request_id=int(request.get("id", 0)),
                    start_step=local_step,
                )
                logger.info("profiler: on-demand capture %d for %d "
                            "steps -> %s", capture.request_id,
                            capture.num_steps, capture.trace_dir)
                capture.start()
                self._active = capture
                return
            if (self._static_dir and not self._static_done
                    and local_step == self._static_start):
                self._static_done = True
                capture = ProfilerCapture(
                    self._static_dir, self._static_num,
                    request_id=0, start_step=local_step)
                logger.info("profiler: tracing %d steps to %s",
                            capture.num_steps, capture.trace_dir)
                capture.start()
                self._active = capture

    def stop(self) -> None:
        """Flush any active capture (loop teardown, a step failure)."""
        with self._lock:
            self._finish_locked()

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active is not None

    # -- internals (lock held) --------------------------------------------
    def _default_dump_dir(self) -> str:
        if self._request_path:
            return os.path.join(
                os.path.dirname(self._request_path) or ".", "profiles")
        return self._static_dir or "."

    def _finish_locked(self) -> None:
        if self._active is None:
            return
        capture, self._active = self._active, None
        manifest = capture.stop()
        logger.info("profiler: capture %d finished (%s): %d bytes, "
                    "started in %.3f s, stopped and written in %.3f s",
                    capture.request_id, manifest["status"],
                    capture.trace_bytes, capture.start_s, capture.stop_s)
        if capture.request_id and self._request_path:
            try:
                _write_json(self._request_path + ".done", manifest)
            except OSError:
                pass

    def _poll_request_locked(self) -> Optional[Dict[str, Any]]:
        if not self._request_path:
            return None
        try:
            st = os.stat(self._request_path)
        except OSError:
            return None
        # the inode is in the key: every write is a tmp+rename, so a
        # rewrite inside one coarse mtime tick still changes the key
        stat_key = (st.st_ino, st.st_mtime_ns, st.st_size)
        if stat_key == self._last_request_stat:
            return None
        self._last_request_stat = stat_key
        try:
            with open(self._request_path) as f:
                request = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return None
        if not isinstance(request, dict):
            return None
        request_id = int(request.get("id", 0) or 0)
        if request_id <= self._handled_id:
            return None  # replay of an already-served request
        self._handled_id = request_id
        return request
