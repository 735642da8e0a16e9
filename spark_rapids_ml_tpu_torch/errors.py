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
# NaN or Inf at a boundary).
# Counterparts of spark_rapids_ml_tpu/errors.py, with the same messages and
# attributes, without the flight-recorder hook and the control-plane errors
# (the port has no rendezvous yet).
#
from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = [
    "SrmlError", "SolverDivergedError", "IngestValidationError", "HbmBudgetError", "RequestTimeoutError",
    "ServeOverloadError", "ServingStoppedError", "NumericsError",
]


class SrmlError(Exception):
    """Base class for every error this package raises on purpose."""


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
