"""The ElasticJob reconciler's decision table: the native core
(``native/reconciler.cpp``) through ctypes, and its plain version.

Own copy of the JAX package's ``operator/native.py``. ``reconcile`` runs
the native table, built from ``native/*.cpp`` by ``native_build.py`` on
first use; a library that cannot be built raises (no fallback).
``_python_reconcile`` is the plain version, kept as a kernel keeps one:
the tests hold the two equal case by case. ``native_calls`` counts the
native table's calls, so a caller can tell that it was the one in use."""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List

from dlrover_tpu_torch.native_build import load_native


class PodPhase:
    ABSENT = 0
    PENDING = 1
    RUNNING = 2
    SUCCEEDED = 3
    FAILED = 4


class JobPhase:
    CREATED = 0
    PENDING = 1
    RUNNING = 2
    SUCCEEDED = 3
    FAILED = 4
    SCALING = 5


class ActionKind:
    NONE = 0
    CREATE_MASTER = 1
    RELAUNCH_MASTER = 2
    SET_PHASE = 3
    RELAY_SCALE_PLAN = 4
    FAIL_JOB = 5


@dataclasses.dataclass
class JobObserved:
    job_phase: int = JobPhase.CREATED
    master_phase: int = PodPhase.ABSENT
    master_restarts: int = 0
    max_master_restarts: int = 3
    suspended: bool = False
    pending_scale_plan: bool = False
    workers_total: int = 0
    workers_running: int = 0
    workers_succeeded: int = 0
    workers_failed_unrecoverable: int = 0


@dataclasses.dataclass
class Action:
    kind: int
    arg: int = 0


class _CJobObserved(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int32) for name in (
        "job_phase", "master_phase", "master_restarts",
        "max_master_restarts", "suspended", "pending_scale_plan",
        "workers_total", "workers_running", "workers_succeeded",
        "workers_failed_unrecoverable")]


class _CAction(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("arg", ctypes.c_int32)]


# calls of the native table since import (or the caller's reset)
native_calls = 0


def _native_reconcile(job: JobObserved) -> List[Action]:
    global native_calls
    lib = load_native()
    lib.reconcile_elastic_job.restype = ctypes.c_int32
    lib.reconcile_elastic_job.argtypes = [
        ctypes.POINTER(_CJobObserved), ctypes.POINTER(_CAction),
        ctypes.c_int32]
    c_job = _CJobObserved(
        job.job_phase, job.master_phase, job.master_restarts,
        job.max_master_restarts, int(job.suspended),
        int(job.pending_scale_plan), job.workers_total,
        job.workers_running, job.workers_succeeded,
        job.workers_failed_unrecoverable)
    out = (_CAction * 8)()
    n = lib.reconcile_elastic_job(ctypes.byref(c_job), out, 8)
    native_calls += 1
    return [Action(out[i].kind, out[i].arg) for i in range(n)]


def _python_reconcile(job: JobObserved) -> List[Action]:
    """The plain version of native/reconciler.cpp's table."""
    actions: List[Action] = []
    if job.suspended:
        return actions
    if job.job_phase in (JobPhase.SUCCEEDED, JobPhase.FAILED):
        return actions
    mp = job.master_phase
    if mp == PodPhase.ABSENT:
        actions.append(Action(ActionKind.CREATE_MASTER))
        if job.job_phase != JobPhase.PENDING:
            actions.append(Action(ActionKind.SET_PHASE, JobPhase.PENDING))
    elif mp == PodPhase.PENDING:
        if job.job_phase != JobPhase.PENDING:
            actions.append(Action(ActionKind.SET_PHASE, JobPhase.PENDING))
    elif mp == PodPhase.RUNNING:
        if job.job_phase != JobPhase.RUNNING:
            actions.append(Action(ActionKind.SET_PHASE, JobPhase.RUNNING))
        if job.pending_scale_plan:
            actions.append(Action(ActionKind.RELAY_SCALE_PLAN))
    elif mp == PodPhase.SUCCEEDED:
        actions.append(Action(ActionKind.SET_PHASE, JobPhase.SUCCEEDED))
    elif mp == PodPhase.FAILED:
        if job.master_restarts < job.max_master_restarts:
            actions.append(Action(ActionKind.RELAUNCH_MASTER,
                                  job.master_restarts + 1))
        else:
            actions.append(Action(ActionKind.FAIL_JOB, 1))
            actions.append(Action(ActionKind.SET_PHASE, JobPhase.FAILED))
    if mp == PodPhase.ABSENT and job.workers_total > 0:
        if job.workers_succeeded == job.workers_total:
            actions.append(Action(ActionKind.SET_PHASE,
                                  JobPhase.SUCCEEDED))
        elif job.workers_failed_unrecoverable == job.workers_total:
            actions.append(Action(ActionKind.FAIL_JOB, 2))
            actions.append(Action(ActionKind.SET_PHASE, JobPhase.FAILED))
    return actions


def reconcile(job: JobObserved) -> List[Action]:
    """The actions for one observation, from the native table."""
    return _native_reconcile(job)
