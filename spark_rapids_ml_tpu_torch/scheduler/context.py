#
# The job context and the cooperative preemption flag. The port's copy of
# spark_rapids_ml_tpu/scheduler/context.py.
#
# A scheduler job's worker thread runs its whole fit inside `job_scope(job)`,
# and everything downstream can then ask two questions without a job handle
# passed through every layer:
#
#   * `memory.admit_fit` asks `current_job()`: to RESIZE the job's ledger
#     claim instead of making a second one, and to force-stream a job the
#     scheduler demoted;
#   * the solvers call `preemption_point(solver, iteration)` at their
#     checkpoint boundaries (ops/kmeans.lloyd_loop, resident and streamed;
#     ops/owlqn.LoopCheckpoint.save, which the GLM quasi-Newton and OWL-QN
#     loops save through, dense, ELL and streamed), right AFTER the
#     boundary's `SolverCheckpoint` landed. A flagged job raises
#     `PreemptedError` there with zero lost work: the checkpoint it just
#     saved is what the resumed attempt restores, so a preempted and resumed
#     fit equals an uninterrupted one bit for bit.
#
# Context-local, as core's device_dataset_scope and the checkpoint store:
# jobs on different worker threads never see each other's flags. Outside a
# job both calls cost one ContextVar read.
#
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Optional

__all__ = ["current_job", "job_scope", "preemption_point"]

_CURRENT_JOB: "contextvars.ContextVar[Optional[Any]]" = contextvars.ContextVar(
    "srml_torch_scheduler_job", default=None
)


def current_job() -> Optional[Any]:
    """The `FitJob` whose worker thread runs this code, or None (the common,
    scheduler-less case)."""
    return _CURRENT_JOB.get()


@contextlib.contextmanager
def job_scope(job: Any):
    """Install `job` as the current job for the dynamic extent (the worker
    thread's whole fit attempt)."""
    token = _CURRENT_JOB.set(job)
    try:
        yield job
    finally:
        _CURRENT_JOB.reset(token)


def preemption_point(solver: str = "", iteration: int = 0) -> None:
    """The cooperative yield check of the solvers' checkpoint boundaries,
    called after the boundary's checkpoint saved: raises `PreemptedError`
    when the enclosing job was asked to yield; one ContextVar read
    elsewhere."""
    job = _CURRENT_JOB.get()
    if job is not None:
        job.check_preempt(solver, iteration)
