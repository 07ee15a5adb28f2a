"""Agent-side monitors: node resources, training progress, hang
detection, tuned-config polling; and the worker's card-stats export.

Own copy of the JAX package's ``agent/monitor.py`` (held equal to it by
``tests/test_torch_monitor.py``), after dlrover's
elastic_agent/monitor/resource.py:86, training.py:78 and atorch's
hanging_detector.py:86:

- :class:`ResourceMonitor` reports host CPU and memory (psutil) and the
  per-card stats every ``report_resource_interval_s``. The agent never
  touches the card (a CUDA context in the agent would hold memory on the
  card its worker trains on): the card stats come from the file the
  worker exports (:func:`export_chip_stats`, ``NodeEnv.CHIP_STATS_FILE``).
- :class:`TrainingMonitor` tails the step-progress file the training
  process writes (:func:`report_step`, ``NodeEnv.METRICS_FILE``) and
  forwards the global step to the master.
- :class:`HangingDetector` restarts the worker when its steps stop.
- :class:`ParalConfigTuner` writes the master's tuned ParallelConfig to
  the file the worker may hot-reload.

The port's agent starts only the :class:`ResourceMonitor`: no worker
writes the step-progress file or reads the tuned config, and the
step-hang watchdog (``trainer/watchdog.py``) covers a stalled worker.
The other three are held equal to the JAX package's for the worker that
will.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch import obs
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common.config import Context
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.obs.device import _RISE_THRESHOLD_BYTES


def report_step(step: int, path: Optional[str] = None,
                step_time_s: float = 0.0,
                data_wait_fraction: float = -1.0,
                plan_generation: int = -1) -> None:
    """Called from the TRAINING process each step (or every k steps).
    One atomic record: readers need only the latest, and long jobs must
    not grow the file. The optional timing fields (windowed mean step
    time and data-wait fraction) ride along so the agent's
    TrainingMonitor can forward the diagnosis engine's straggler
    evidence. ``plan_generation``: the shard-plan generation applied (-1
    = the sender does not track plans)."""
    path = path or os.environ.get(NodeEnv.METRICS_FILE, "")
    if not path:
        return
    record = {"step": int(step), "ts": time.time()}
    if step_time_s > 0.0:
        record["step_time_s"] = float(step_time_s)
    if data_wait_fraction >= 0.0:
        record["data_wait_fraction"] = float(data_wait_fraction)
    if plan_generation != -1:
        record["plan_generation"] = int(plan_generation)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(record) + "\n")
    os.replace(tmp, path)


def _read_last_step(path: str) -> Optional[dict]:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 4096))
            lines = f.read().decode(errors="ignore").strip().splitlines()
        for line in reversed(lines):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    except OSError:
        return None
    return None


class ResourceMonitor:
    """Report host CPU and memory and the card stats to the master
    periodically."""

    def __init__(self, client: MasterClient, node_type: str = "worker",
                 interval_s: Optional[float] = None,
                 chip_stats_file: str = ""):
        self._client = client
        self._node_type = node_type
        self._interval_s = (interval_s if interval_s is not None
                            else Context.singleton()
                            .report_resource_interval_s)
        # an explicit path wins; the env is the worker-process contract
        self._chip_stats_file = chip_stats_file
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # prime psutil's CPU sampler: cpu_percent(interval=None) measures
        # since the LAST call and answers 0.0 on its first
        try:
            import psutil

            psutil.cpu_percent(interval=None)
        except ImportError:
            pass

    def sample(self) -> msg.NodeResourceStats:
        cpu_percent = 0.0
        memory_mb = 0.0
        try:
            import psutil

            cpu_percent = psutil.cpu_percent(interval=None)
            memory_mb = psutil.virtual_memory().used / (1 << 20)
        except ImportError:
            pass
        stats = msg.NodeResourceStats(
            node_id=self._client.node_id,
            node_type=self._node_type,
            cpu_percent=cpu_percent,
            memory_mb=memory_mb,
            node_rank=getattr(self._client, "node_rank", -1),
            chip_stats=self._chip_stats(),
        )
        # the same series the master exposes, in the agent's registry
        obs.publish_node_stats(stats)
        return stats

    def _chip_stats(self) -> List[msg.ChipStats]:
        """The card stats the worker exported (the agent never reads the
        card itself)."""
        path = (self._chip_stats_file
                or os.environ.get(NodeEnv.CHIP_STATS_FILE, ""))
        if not path or not os.path.exists(path):
            return []
        try:
            with open(path) as f:
                raw = json.load(f)
            return [msg.ChipStats(**chip) for chip in raw]
        except (OSError, json.JSONDecodeError, TypeError):
            return []

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="resource-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        while not self._stopped.wait(self._interval_s):
            try:
                self._client.report_resource_stats(self.sample())
                self._client.report_heartbeat()
            except Exception as e:  # noqa: BLE001 - monitoring best-effort
                logger.warning("resource report failed: %s", e)


# the last export's (wall time, step) per path: the duty-cycle proxy
# needs a delta. One training process, one exporter, called only from
# the step loop: no lock.
_chip_export_prev: dict = {}
# the last exported allocator peak per (path, card): the counter is
# lifetime-monotone (obs/device.py), so the export windows it, with the
# same noise threshold as the step-report path
_chip_export_peaks: dict = {}
_PEAK_RISE_BYTES = _RISE_THRESHOLD_BYTES


def _allocator_stats() -> List[Dict[str, float]]:
    """Per-card allocator stats of THIS process's cards, in the JAX
    ``memory_stats`` vocabulary; [] without a CUDA context (a process
    that never used a card, and the CPU)."""
    import torch

    from dlrover_tpu_torch.obs.device import card_total_bytes

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    index = torch.cuda.current_device()
    stats = torch.cuda.memory_stats(index) or {}
    if not stats:
        return [{"id": index}]
    return [{"id": index,
             "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
             "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
             "bytes_limit": card_total_bytes(index)}]


def export_chip_stats(path: Optional[str] = None,
                      step: Optional[int] = None,
                      step_time_s: float = 0.0,
                      sampler: Optional[Callable[[], List[Dict[str, float]]]]
                      = None) -> None:
    """Called from the TRAINING process: dump per-card memory use for the
    agent's ResourceMonitor to relay. ``sampler`` (tests) answers the
    cards' stats as ``[{"id", "bytes_in_use", "peak_bytes_in_use",
    "bytes_limit"}]``; the default reads the CUDA caching allocator (a
    host-side read, no device sync).

    Duty cycle: no per-card busy counter is read, so a proxy comes from
    consecutive exports: steps completed since the last export × the
    per-step DEVICE-BUSY seconds (``step_time_s``, the caller's mean step
    time less the host-starved phases), over the wall-clock elapsed. A
    caller that cannot supply them gets stats without the field."""
    path = path or os.environ.get(NodeEnv.CHIP_STATS_FILE, "")
    if not path:
        return
    now = time.time()
    duty: Optional[float] = None
    prev = _chip_export_prev.get(path)
    if step is not None and step_time_s > 0.0 and prev is not None:
        elapsed = now - prev["ts"]
        steps_done = step - prev["step"]
        if elapsed > 0 and steps_done >= 0:
            duty = min(100.0, 100.0 * steps_done * step_time_s / elapsed)
    if step is not None:
        _chip_export_prev[path] = {"ts": now, "step": int(step)}
    stats = []
    peaks = _chip_export_peaks.setdefault(path, {})
    for mem in (sampler or _allocator_stats)():
        mem = dict(mem)
        card = int(mem.pop("id"))
        chip = {"index": card}
        if mem:
            # memory fields only when the allocator answered: an absent
            # one must not export a forever-0 series read as headroom
            chip["hbm_used_mb"] = mem.get("bytes_in_use", 0) / (1 << 20)
            chip["hbm_total_mb"] = mem.get("bytes_limit", 0) / (1 << 20)
            # the in-step peak the between-steps sample misses, exported
            # only when it ROSE since the last export (between rises,
            # hbm_used_mb is the live signal)
            peak = float(mem.get("peak_bytes_in_use", 0) or 0)
            prev_peak = peaks.get(card, 0.0)
            if peak > prev_peak + _PEAK_RISE_BYTES:
                chip["hbm_peak_mb"] = peak / (1 << 20)
            peaks[card] = max(peak, prev_peak)
        if duty is not None:
            chip["duty_cycle_pct"] = duty
        stats.append(chip)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(stats, f)
    os.replace(tmp, path)


class TrainingMonitor:
    """Tail the worker's metrics file; forward the global step to the
    master."""

    def __init__(self, client: MasterClient, metrics_file: str,
                 interval_s: float = 15.0):
        self._client = client
        self._metrics_file = metrics_file
        self._interval_s = interval_s
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_reported = -1

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="training-monitor")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def last_progress_time(self) -> float:
        record = _read_last_step(self._metrics_file)
        return record["ts"] if record else 0.0

    def _loop(self) -> None:
        step_gauge = obs.get_registry().gauge(
            "dlrover_tpu_agent_reported_step",
            "Last worker step this agent forwarded to the master")
        while not self._stopped.wait(self._interval_s):
            record = _read_last_step(self._metrics_file)
            if record and record["step"] > self._last_reported:
                self._last_reported = record["step"]
                step_gauge.set(record["step"])
                try:
                    self._client.report_global_step(
                        record["step"],
                        step_time_s=float(
                            record.get("step_time_s", 0.0) or 0.0),
                        data_wait_fraction=float(
                            record.get("data_wait_fraction", -1.0)),
                        plan_generation=int(
                            record.get("plan_generation", -1)),
                    )
                except Exception as e:  # noqa: BLE001
                    logger.warning("step report failed: %s", e)


class HangingDetector:
    """Restart the worker when there is no step progress for
    ``hang_seconds`` (atorch's --relaunch_on_hanging)."""

    def __init__(
        self,
        metrics_file: str,
        on_hang: Callable[[], None],
        hang_seconds: Optional[float] = None,
        check_interval_s: float = 30.0,
        warmup_s: float = 300.0,
        clock: Callable[[], float] = time.time,
    ):
        self._metrics_file = metrics_file
        self._on_hang = on_hang
        self._hang_seconds = (hang_seconds if hang_seconds is not None
                              else Context.singleton().hang_seconds)
        self._check_interval_s = check_interval_s
        self._warmup_s = warmup_s
        self._clock = clock
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the grace-period clock is reset from the agent thread (worker
        # restart) while the detector thread reads it
        self._clock_lock = threading.Lock()
        self._started_at = clock()

    def start(self) -> None:
        with self._clock_lock:
            self._started_at = self._clock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hang-detector")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def reset(self) -> None:
        """Call after a worker restart (a fresh first-step grace)."""
        with self._clock_lock:
            self._started_at = self._clock()

    def is_hanged(self) -> bool:
        record = _read_last_step(self._metrics_file)
        now = self._clock()
        with self._clock_lock:
            started_at = self._started_at
        if record is None:
            # no step ever: a hang only after the warmup (the first
            # step builds kernels)
            return now - started_at > max(self._warmup_s,
                                          self._hang_seconds)
        # a stale record from before the last (re)start must not re-fire
        last_progress = max(record["ts"], started_at)
        return now - last_progress > self._hang_seconds

    def _loop(self) -> None:
        while not self._stopped.wait(self._check_interval_s):
            if self.is_hanged():
                logger.error("hang detected: no step progress for %.0fs",
                             self._hang_seconds)
                try:
                    self._on_hang()
                finally:
                    self.reset()


class ParalConfigTuner:
    """Poll the master's tuned ParallelConfig and write it to the JSON
    file the worker may hot-reload (dlrover's
    elastic_agent/config/paral_config_tuner.py:30-60)."""

    def __init__(self, client: MasterClient, config_path: str,
                 interval_s: float = 30.0):
        self._client = client
        self._config_path = config_path
        self._interval_s = interval_s
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # poll_once runs on the tuner thread and directly from tests: the
        # version check-and-set must be atomic
        self._version_lock = threading.Lock()
        self._last_version = -1

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="paral-config-tuner")
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def poll_once(self) -> bool:
        config = self._client.get_paral_config()
        with self._version_lock:
            if config.version <= self._last_version:
                return False
            self._last_version = config.version
        tmp = self._config_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "version": config.version,
                "dataloader_batch_size": config.dataloader_batch_size,
                "dataloader_workers": config.dataloader_workers,
                "learning_rate": config.learning_rate,
                "grad_accum_steps": config.grad_accum_steps,
            }, f)
        os.replace(tmp, self._config_path)  # atomic for the reader
        return True

    def _loop(self) -> None:
        while not self._stopped.wait(self._interval_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001
                logger.warning("paral config poll failed: %s", e)
