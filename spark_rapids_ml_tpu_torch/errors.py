#
# Typed errors raised on the port's path: the base `SrmlError`,
# `SolverDivergedError` (`ops.kmeans.kmeans_fit`, on a non-finite center
# shift or inertia), `IngestValidationError` (config["validate_ingest"]
# found a NaN or Inf in an input column), `HbmBudgetError` (a fit or a model
# load the device budget cannot hold), and the serving plane's
# `ServeOverloadError` (a request refused at
# submit), `RequestTimeoutError` (a request whose server-side deadline passed
# before dispatch) and `ServingStoppedError` (the engine stopped first), and
# `NumericsError` (the SRML_NUMCHECK=1 sanitizer, utils/numcheck.py, found a
# NaN or Inf at a boundary), and the fit stages' two failure classes:
# `RendezvousTimeoutError` (TRANSIENT: `core.retryable_stage` retries it;
# the chaos `fail:` plans raise it) and `RankFailedError` (PERMANENT), with
# `is_transient`, the retry predicate, and the fit scheduler's two:
# `PreemptedError` (a job asked to yield at a solver checkpoint boundary;
# not transient: only the scheduler's job runner catches it) and
# `SchedulerSaturatedError` (a job that can never be placed, refused at
# `FitScheduler.submit`).
# Counterparts of spark_rapids_ml_tpu/errors.py, with the same messages and
# attributes, without the flight-recorder hook (A15).
#
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

__all__ = [
    "SrmlError", "RendezvousTimeoutError", "RankFailedError", "SolverDivergedError", "IngestValidationError",
    "HbmBudgetError", "MeshTopologyError", "RequestTimeoutError", "ServeOverloadError", "ServingStoppedError", "NumericsError",
    "PreemptedError", "SchedulerSaturatedError", "is_transient",
]


class SrmlError(Exception):
    """Base class for every error this package raises on purpose."""


class RendezvousTimeoutError(SrmlError, TimeoutError):
    """A control-plane round's deadline elapsed with ranks still missing.

    TRANSIENT: the deadline fires symmetrically on every rank still waiting,
    so all survivors unwind to the fit driver together and a coordinated
    retry is safe. Distinguish from `RankFailedError`, where a peer is KNOWN
    dead. Raised by the rendezvous substrates and the process group's
    collectives (parallel/context.py), and by the chaos `fail:` plans at a
    fit stage or a solver checkpoint boundary."""

    def __init__(
        self,
        message: str,
        *,
        round_index: Optional[int] = None,
        missing_ranks: Optional[Sequence[int]] = None,
        timeout_s: Optional[float] = None,
    ):
        self.round_index = round_index
        self.missing_ranks = list(missing_ranks) if missing_ranks is not None else None
        self.timeout_s = timeout_s
        super().__init__(message)


class RankFailedError(SrmlError, RuntimeError):
    """A peer rank failed mid-fit. `core.recoverable_stage` stamps
    ``recovery_exhausted``/``recovery_generations`` on it as it propagates,
    so callers and post-mortems can tell "never tried" from "tried and ran
    out"; on a rendezvous that can reform it first opens recovery epochs,
    at most ``config["recovery_max_rank_losses"]``. PERMANENT once it
    propagates: an external supervisor, not an in-process retry, must
    relaunch the rank."""

    # stamped by core.recoverable_stage when it re-raises: how many
    # membership reforms this fit survived first (0 = recovery never opened)
    recovery_exhausted: bool = False
    recovery_generations: int = 0

    def __init__(
        self,
        failed_rank: int,
        reason: str = "",
        *,
        round_index: Optional[int] = None,
    ):
        self.failed_rank = int(failed_rank)
        self.reason = reason
        self.round_index = round_index
        where = f" at round {round_index}" if round_index is not None else ""
        super().__init__(
            f"rank {failed_rank} failed{where}: {reason or 'no reason published'}"
        )


class SolverDivergedError(SrmlError, ArithmeticError):
    """An iterative solver produced non-finite state (NaN/Inf objective,
    shift, or coefficients). Carries the last iterate known finite and the
    iteration at which divergence was detected, so callers can warm-restart
    or report precisely where the numerics broke."""

    def __init__(
        self,
        solver: str,
        iteration: int,
        *,
        last_good: Optional[Dict[str, Any]] = None,
        detail: str = "",
    ):
        self.solver = solver
        self.iteration = int(iteration)
        self.last_good: Dict[str, Any] = dict(last_good) if last_good else {}
        msg = f"{solver} diverged at iteration {self.iteration}"
        if detail:
            msg += f": {detail}"
        if self.last_good:
            msg += f" (last-good iterate keys: {sorted(self.last_good)})"
        super().__init__(msg)


class IngestValidationError(SrmlError, ValueError):
    """``config["validate_ingest"]`` found a non-finite value in an input
    column. Names the column (and the first offending row) so the fix points
    at the data, not at a NaN surfacing iterations later inside a solver."""

    def __init__(self, column: str, row: Optional[int] = None, kind: str = "non-finite"):
        self.column = column
        self.row = row
        at = f" (first at row {row})" if row is not None else ""
        super().__init__(
            f"input column {column!r} contains {kind} values{at}; "
            "clean the data or disable config['validate_ingest']"
        )


class MeshTopologyError(SrmlError, ValueError):
    """A requested device layout cannot be built over the device pool: the
    worker count is not positive, exceeds the pool or does not divide it, a
    topology's axis product disagrees with the pool size, or a carve asks
    for chips the parent layout does not hold. Permanent: a configuration
    error. Carries both sides of the mismatch."""

    def __init__(
        self,
        message: str,
        *,
        requested: Optional[int] = None,
        available: Optional[int] = None,
        topology: Optional[Dict[str, int]] = None,
    ):
        self.requested = None if requested is None else int(requested)
        self.available = None if available is None else int(available)
        self.topology: Dict[str, int] = dict(topology) if topology else {}
        parts = [message]
        if requested is not None and available is not None:
            parts.append(f"(requested {self.requested} against {self.available} visible devices)")
        if self.topology:
            parts.append("[topology: " + " x ".join(f"{k}={v}" for k, v in self.topology.items()) + "]")
        super().__init__(" ".join(parts))


class HbmBudgetError(SrmlError, MemoryError):
    """A working set does not fit device memory: a fit whose resident and
    streaming working sets are both over the budget, or that has no
    streaming path (`memory.admit_fit`), a fit whose allocation failed on
    the card twice (`memory.as_hbm_budget_error`), or a model load over the
    serving budget even with every other resident evicted
    (`memory.admit_model_load`). PERMANENT: retrying the same work on the
    same device cannot help — shrink it, raise
    ``config["hbm_budget_bytes"]``, or add cards.

    Carries the per-device byte accounting so the message (and post-mortems)
    name WHAT doesn't fit: ``estimate_bytes`` (total working set),
    ``capacity_bytes`` (per-device budget it was checked against),
    ``largest_term`` / ``largest_term_bytes`` (the dominant line item, e.g.
    ``placement.items`` or ``workspace.topk_block``), and the full ``terms``
    dict."""

    def __init__(
        self,
        message: str,
        *,
        estimate_bytes: Optional[int] = None,
        capacity_bytes: Optional[int] = None,
        largest_term: Optional[str] = None,
        largest_term_bytes: Optional[int] = None,
        terms: Optional[Dict[str, int]] = None,
    ):
        self.estimate_bytes = None if estimate_bytes is None else int(estimate_bytes)
        self.capacity_bytes = None if capacity_bytes is None else int(capacity_bytes)
        self.largest_term = largest_term
        self.largest_term_bytes = (
            None if largest_term_bytes is None else int(largest_term_bytes)
        )
        self.terms: Dict[str, int] = dict(terms) if terms else {}
        parts = [message]
        if estimate_bytes is not None and capacity_bytes is not None:
            parts.append(
                f"(estimated {self.estimate_bytes} bytes/device against a "
                f"{self.capacity_bytes}-byte budget)"
            )
        if largest_term is not None:
            lt = (
                f"largest term: {largest_term}"
                if largest_term_bytes is None
                else f"largest term: {largest_term} = {self.largest_term_bytes} bytes"
            )
            parts.append(f"[{lt}]")
        super().__init__(" ".join(parts))


class PreemptedError(SrmlError):
    """The multi-tenant fit scheduler (`scheduler/queue.py`) asked this fit
    to yield: a higher-priority job needs its device-memory reservation.
    Raised COOPERATIVELY, only at a solver checkpoint boundary
    (``config["checkpoint_every_iters"]``), right AFTER the boundary's
    `SolverCheckpoint` landed in the job's store, so the fit unwinds with
    zero lost work and a later re-admission resumes bit for bit.

    Transient from the tenant's view (the job requeues; its future still
    resolves), but deliberately NOT `is_transient`: an in-place
    `retryable_stage` retry would re-enter the solve while the scheduler is
    freeing the job's claim. The scheduler's job runner is the one catcher."""

    def __init__(
        self,
        job_id: int,
        *,
        solver: str = "",
        iteration: int = 0,
        reason: str = "",
    ):
        self.job_id = int(job_id)
        self.solver = solver
        self.iteration = int(iteration)
        self.reason = reason
        at = f" at {solver} iteration {iteration}" if solver else ""
        super().__init__(
            f"job {job_id} preempted{at}: "
            f"{reason or 'higher-priority job needs the reservation'}"
        )


class SchedulerSaturatedError(SrmlError, MemoryError):
    """A job submitted to the fit scheduler can NEVER be placed: its
    smallest possible working set (the streaming floor for an estimator
    with an out-of-core path, the resident estimate otherwise) exceeds the
    whole per-device budget even with every other job drained. PERMANENT,
    refused at `FitScheduler.submit`, so the tenant learns at once instead
    of queueing forever. Mirrors `HbmBudgetError`'s accounting:
    ``estimate_bytes`` / ``budget_bytes`` / ``largest_term`` /
    ``largest_term_bytes`` / ``terms`` name what does not fit."""

    def __init__(
        self,
        message: str,
        *,
        tenant: Optional[str] = None,
        estimate_bytes: Optional[int] = None,
        budget_bytes: Optional[int] = None,
        largest_term: Optional[str] = None,
        largest_term_bytes: Optional[int] = None,
        terms: Optional[Dict[str, int]] = None,
    ):
        self.tenant = tenant
        self.estimate_bytes = None if estimate_bytes is None else int(estimate_bytes)
        self.budget_bytes = None if budget_bytes is None else int(budget_bytes)
        self.largest_term = largest_term
        self.largest_term_bytes = (
            None if largest_term_bytes is None else int(largest_term_bytes)
        )
        self.terms: Dict[str, int] = dict(terms) if terms else {}
        parts = [message]
        if estimate_bytes is not None and budget_bytes is not None:
            parts.append(
                f"(minimal working set {self.estimate_bytes} bytes/device "
                f"against a {self.budget_bytes}-byte budget)"
            )
        if largest_term is not None:
            parts.append(
                f"[largest term: {largest_term}"
                + (
                    f" = {self.largest_term_bytes} bytes]"
                    if largest_term_bytes is not None
                    else "]"
                )
            )
        super().__init__(" ".join(parts))


class RequestTimeoutError(SrmlError, TimeoutError):
    """A scoring request's server-side deadline elapsed before dispatch
    (``ScoringEngine.submit(deadline_ms=)``, default
    ``config["serve_default_deadline_ms"]``; monotonic clock only).

    The request NEVER touched the device: expired requests are dropped at
    the head of the queue or filtered out of a coalesced group before
    dispatch, so a caller whose client already gave up does not burn device
    time. PERMANENT for this request — resubmit with a larger deadline or
    at lower load. Distinguish from the bare ``TimeoutError`` that
    ``ScoreFuture.result(timeout)`` raises: that is the CLIENT giving up
    while the request may still dispatch; this is the SERVER refusing to
    dispatch stale work."""

    def __init__(
        self,
        message: str,
        *,
        model: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        waited_ms: Optional[float] = None,
        queue_depth: Optional[int] = None,
        queue_rows: Optional[int] = None,
    ):
        self.model = model
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.waited_ms = None if waited_ms is None else float(waited_ms)
        self.queue_depth = None if queue_depth is None else int(queue_depth)
        self.queue_rows = None if queue_rows is None else int(queue_rows)
        parts = [message]
        if deadline_ms is not None:
            w = (
                f" after waiting {self.waited_ms:.1f}ms"
                if waited_ms is not None
                else ""
            )
            parts.append(f"(deadline {self.deadline_ms:.1f}ms elapsed{w})")
        if queue_depth is not None:
            parts.append(
                f"[queue: {self.queue_depth} requests"
                + (
                    f", {self.queue_rows} rows]"
                    if queue_rows is not None
                    else "]"
                )
            )
        super().__init__(" ".join(parts))


class ServeOverloadError(SrmlError, RuntimeError):
    """Serving admission refused this request: the bounded queue is full
    (``config["serve_max_queue_rows"]``), or the live windowed queue-wait
    p99 predicts the deadline cannot be met. PERMANENT for this request, by
    design cheap and synchronous at ``submit()`` — raised BEFORE any
    queueing so callers can back off while the evidence (queue depth,
    predicted wait, deadline, ladder level) names why."""

    def __init__(
        self,
        message: str,
        *,
        model: Optional[str] = None,
        tenant: Optional[str] = None,
        level: Optional[str] = None,
        queue_depth: Optional[int] = None,
        queue_rows: Optional[int] = None,
        predicted_wait_ms: Optional[float] = None,
        deadline_ms: Optional[float] = None,
    ):
        self.model = model
        self.tenant = tenant
        self.level = level
        self.queue_depth = None if queue_depth is None else int(queue_depth)
        self.queue_rows = None if queue_rows is None else int(queue_rows)
        self.predicted_wait_ms = (
            None if predicted_wait_ms is None else float(predicted_wait_ms)
        )
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        parts = [message]
        if predicted_wait_ms is not None and deadline_ms is not None:
            parts.append(
                f"(predicted wait {self.predicted_wait_ms:.1f}ms against a "
                f"{self.deadline_ms:.1f}ms deadline)"
            )
        if queue_depth is not None or queue_rows is not None:
            parts.append(
                f"[queue: {self.queue_depth or 0} requests, "
                f"{self.queue_rows or 0} rows]"
            )
        if level is not None:
            parts.append(f"[tenant {tenant!r} at ladder level {level!r}]")
        super().__init__(" ".join(parts))


class ServingStoppedError(SrmlError, RuntimeError):
    """The scoring engine stopped before this queued request dispatched
    (``ScoringEngine.stop()`` drain deadline elapsed, or the engine was
    never going to run it). Carries the model name and the request's
    position in the queue at shutdown, so a caller distinguishing "my
    request was slow" from "the service went away under me" has the
    evidence in the exception, not in a log."""

    def __init__(self, model: str, *, queue_position: Optional[int] = None):
        self.model = model
        self.queue_position = (
            None if queue_position is None else int(queue_position)
        )
        at = (
            f" (queue position {self.queue_position})"
            if queue_position is not None
            else ""
        )
        super().__init__(
            f"scoring engine stopped before request for model {model!r} "
            f"dispatched{at}"
        )


class NumericsError(SrmlError, ArithmeticError):
    """The runtime numerics sanitizer (``utils.numcheck``, opt-in via
    ``SRML_NUMCHECK=1``) found a non-finite value at a boundary whose values
    are already on the host: the Lloyd loop's shift read, a streamed chunk's
    partials or GLM iteration, or the serving response assembly. PERMANENT:
    a retry re-runs the same arithmetic.

    Carries ``stage`` (the boundary's name, e.g. ``kmeans.iterate``),
    ``solver``, ``iteration``, ``value_name`` (which checked value tripped),
    and ``detail`` (NaN/Inf counts)."""

    def __init__(
        self,
        stage: str,
        *,
        solver: str = "",
        iteration: Optional[int] = None,
        value_name: str = "",
        detail: str = "",
    ):
        self.stage = stage
        self.solver = solver
        self.iteration = None if iteration is None else int(iteration)
        self.value_name = value_name
        self.detail = detail
        parts = [f"non-finite value at numerics boundary {stage!r}"]
        if solver:
            at = f" iteration {self.iteration}" if self.iteration is not None else ""
            parts.append(f"(solver {solver}{at})")
        if value_name:
            parts.append(f"in {value_name!r}")
        if detail:
            parts.append(f"— {detail}")
        super().__init__(" ".join(parts))


def is_transient(exc: BaseException) -> bool:
    """Whether the fit driver may retry the stage after this error.

    Transient: rendezvous round timeouts (symmetric: every rank unwinds
    together) and the distributed-init race (two fits standing up the
    process group at once; the loser sees an 'already initialized'
    RuntimeError and succeeds on retry). `RankFailedError`,
    `SolverDivergedError`, `PreemptedError` (the scheduler's job runner
    requeues it; a retry in place would re-enter the solve the scheduler
    is freeing), `SchedulerSaturatedError` and every other error are NOT
    transient."""
    if isinstance(exc, RendezvousTimeoutError):
        return True
    if isinstance(exc, RuntimeError) and not isinstance(exc, SrmlError):
        # ONLY the already-initialized loser race: a broader 'initialize'
        # match would retry deterministic configuration errors for minutes
        msg = str(exc).lower()
        if "distributed" in msg and "already initialized" in msg:
            return True
    return False
