#
# Overload control for the serving plane: deadline-aware admission and the
# adaptive micro-batching planners. The port's copy of
# spark_rapids_ml_tpu/serving/overload.py, without the per-tenant
# backpressure ladder.
#
#   * ADMISSION (per request, synchronous at submit): the bounded queue
#     (`config["serve_max_queue_rows"]`) and the deadline-feasibility check
#     against the live windowed `serve.queue_wait_s` p99 (and the backlog
#     over the service rate); refusals are typed `ServeOverloadError`s
#     carrying their evidence (queue depth, predicted wait, deadline).
#   * ADAPTIVE BATCHING (pure planners): under congestion (queue-wait p99
#     above the static window) the coalesce window grows toward
#     `serve_coalesce_window_ceiling_ms`, so saturation builds fuller batches
#     instead of longer queues; uncongested traffic keeps the static window
#     exactly, and a zero window disables coalescing.
#
# Not in the port yet (ROADMAP A13): the per-tenant ladder of the JAX package
# (throttle, degrade to `serve_degraded_dtype`, shed; hysteresis; SLO burn
# reads) and its audit records. A serving latency SLO spec in
# `config["slo"]` would drive that ladder, so a controller refuses to start
# with one configured rather than ignore it.
#
# Clocks are time.monotonic() throughout.
#
from __future__ import annotations

from typing import Any, Dict, Optional

from .. import telemetry
from ..errors import ServeOverloadError

__all__ = ["OverloadController", "plan_window", "plan_target_rows"]

# Queue depth below which admission's backlog/service-rate wait estimate is
# ignored (the windowed rate is too idle-biased to price a short queue).
_BACKLOG_MIN_DEPTH = 4
# the one ladder level the port has: every admitted tenant is healthy
_HEALTHY = "healthy"


# ------------------------------------------------------- batching planners --


def plan_window(
    base_s: float,
    *,
    floor_s: float,
    ceiling_s: float,
    arrival_rows_per_s: Optional[float],
    queue_rows: int,
    queue_wait_p99_s: Optional[float],
    max_rows: int,
) -> float:
    """The adaptive coalesce window (seconds), pure arithmetic.

      * ``base_s <= 0`` -> 0.0: an explicit zero window means NO coalescing.
      * uncongested (queue-wait p99 absent or at/under the static window)
        -> exactly ``base_s``.
      * congested with the queue already holding a full batch -> the floor:
        waiting adds latency but no batch size.
      * otherwise -> the time to FILL one max batch at the observed arrival
        rate, clamped to [base, ceiling].
    """
    if base_s <= 0.0:
        return 0.0
    hi = max(float(ceiling_s), base_s)
    lo = min(max(float(floor_s), 0.0), base_s)
    if queue_wait_p99_s is None or queue_wait_p99_s <= base_s:
        return base_s
    if queue_rows >= max_rows:
        return lo
    if not arrival_rows_per_s or arrival_rows_per_s <= 0.0:
        return base_s
    fill_s = (max_rows - queue_rows) / arrival_rows_per_s
    return min(max(base_s, fill_s), hi)


def plan_target_rows(
    *,
    min_rows: int,
    max_rows: int,
    queue_rows: int,
    arrival_rows_per_s: Optional[float],
    window_s: float,
    congested: bool,
) -> int:
    """The coalesce row target. Uncongested -> ``max_rows`` (the window, not
    the target, bounds the batch). Congested -> the bucket-ladder rung
    covering the rows expected in one window (queued backlog + the window's
    arrivals), clamped to ``max_rows``."""
    if not congested:
        return max_rows
    expect = queue_rows
    if arrival_rows_per_s and arrival_rows_per_s > 0.0 and window_s > 0.0:
        expect += int(arrival_rows_per_s * window_s)
    if expect >= max_rows:
        return max_rows
    rung = max(1, int(min_rows))
    while rung < expect:
        rung *= 2
    return min(rung, max_rows)


# --------------------------------------------------------------- admission --


def _serving_latency_spec() -> Optional[Dict[str, Any]]:
    """The first latency SLO spec over a serving histogram in
    `config["slo"]`: what would drive the backpressure ladder."""
    from ..core import config

    for spec in config.get("slo") or []:
        if (
            isinstance(spec, dict)
            and str(spec.get("kind", "")) == "latency"
            and str(spec.get("histogram", "")).startswith("serve.")
        ):
            return dict(spec)
    return None


class OverloadController:
    """Per-engine admission gate. Thread-safe: it keeps no state of its own
    and reads its config on every call, so operators can retune a live
    engine."""

    def __init__(self) -> None:
        spec = _serving_latency_spec()
        if spec is not None:
            raise NotImplementedError(
                f"serving latency SLO spec {spec.get('name') or spec.get('kind')!r}: the "
                "per-tenant backpressure ladder it drives (throttle, degrade, shed) is "
                "not in the PyTorch port yet (ROADMAP item A13)"
            )

    def admit(
        self,
        *,
        model: str,
        tenant: str,
        rows: int,
        deadline_s: Optional[float],
        now: float,
        queue_depth: int,
        queue_rows: int,
    ) -> None:
        """Admission or refusal for one request, BEFORE it queues. Raises
        `ServeOverloadError` (queue bound, predicted wait), ticking
        `serve.rejected_requests`."""
        from ..core import config

        reg = telemetry.registry() if telemetry.enabled() else None
        # --- bounded queue ------------------------------------------------
        max_queue_rows = int(config.get("serve_max_queue_rows", 262144))
        if max_queue_rows > 0 and queue_rows + rows > max_queue_rows:
            if reg is not None:
                reg.inc("serve.rejected_requests")
            raise ServeOverloadError(
                f"request for model {model!r} refused: the serving queue is "
                f"full ({queue_rows} + {rows} rows against a "
                f"{max_queue_rows}-row bound)",
                model=model, tenant=tenant, level=_HEALTHY,
                queue_depth=queue_depth, queue_rows=queue_rows,
            )
        # --- deadline feasibility against the live wait prediction --------
        # The worse of two signals: the windowed queue-wait p99 (what
        # dispatched requests waited) and backlog / service rate (what the
        # current queue implies; the p99 alone is survivorship-biased under
        # saturation, since only requests that made their deadline record a
        # wait). The backlog signal needs a few requests of depth: the
        # windowed rate counts idle time as service time.
        if deadline_s is not None and reg is not None:
            fast_w = reg.bucket_seconds() * 3.0
            p99 = reg.window_quantile("serve.queue_wait_s", 0.99, fast_w)
            service = reg.rate("serve.rows", fast_w)
            backlog_s = (
                queue_rows / service
                if service and queue_rows > 0 and queue_depth >= _BACKLOG_MIN_DEPTH
                else None
            )
            candidates = [w for w in (p99, backlog_s) if w is not None]
            predicted = max(candidates) if candidates else None
            if predicted is not None and now + predicted > deadline_s:
                reg.inc("serve.rejected_requests")
                raise ServeOverloadError(
                    f"request for model {model!r} refused: the live queue "
                    "wait predicts the deadline cannot be met",
                    model=model, tenant=tenant, level=_HEALTHY,
                    queue_depth=queue_depth, queue_rows=queue_rows,
                    predicted_wait_ms=predicted * 1e3,
                    deadline_ms=max(0.0, (deadline_s - now)) * 1e3,
                )
