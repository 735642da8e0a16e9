#
# Overload control for the serving plane: deadline-aware admission, the
# SLO-closed-loop backpressure ladder, and the adaptive micro-batching
# planners. The port's copy of spark_rapids_ml_tpu/serving/overload.py.
#
#   * ADMISSION (per request, synchronous at submit): the tenant's ladder
#     gate, the bounded queue (`config["serve_max_queue_rows"]`), and the
#     deadline-feasibility check against the live windowed
#     `serve.queue_wait_s` p99 (and the backlog over the service rate);
#     refusals are typed `ServeOverloadError`s carrying their evidence
#     (queue depth, predicted wait, deadline, ladder level).
#   * THE LADDER (per tenant, evaluated on the dispatch and submit paths): a
#     tenant burning its serving latency budget (its own burn through
#     `ops_plane.slo.burn_rate` over its histogram sibling, or the global
#     spec's verdict from `ops_plane.slo.last_verdicts`) walks
#     healthy -> throttle (a token bucket) -> degrade (the registry's
#     `serve_degraded_dtype` rung, where the model's `_serve_dtypes` allow
#     it) -> shed, one rung per hysteresis hold
#     (`config["serve_overload_hold_s"]`), and back down one rung per hold
#     once the burn clears. Every transition is recorded through
#     `ops_plane.audit` (kind "backpressure").
#   * ADAPTIVE BATCHING (pure planners): under congestion (queue-wait p99
#     above the static window) the coalesce window grows toward
#     `serve_coalesce_window_ceiling_ms`, so saturation builds fuller batches
#     instead of longer queues; uncongested traffic keeps the static window
#     exactly, and a zero window disables coalescing.
#
# Clocks are time.monotonic() throughout: deadlines and holds must survive
# wall-clock steps.
#
from __future__ import annotations

import logging
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Optional

from .. import telemetry
from ..errors import ServeOverloadError
from ..utils import lockcheck

__all__ = [
    "LEVELS",
    "LEVEL_HEALTHY",
    "LEVEL_THROTTLE",
    "LEVEL_DEGRADE",
    "LEVEL_SHED",
    "OverloadController",
    "plan_window",
    "plan_target_rows",
    "serving_report",
]

_LOG = logging.getLogger(__name__)

# The degradation ladder, mild to severe. Index IS the level.
LEVELS = ("healthy", "throttle", "degrade", "shed")

# Queue depth below which admission's backlog/service-rate wait estimate is
# ignored (the windowed rate is too idle-biased to price a short queue).
_BACKLOG_MIN_DEPTH = 4
LEVEL_HEALTHY, LEVEL_THROTTLE, LEVEL_DEGRADE, LEVEL_SHED = range(4)


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

      * ``base_s <= 0`` -> 0.0: an explicit zero window means NO coalescing,
        adaptive or not.
      * uncongested (queue-wait p99 absent or at/under the static window)
        -> exactly ``base_s``: static behavior until there is congestion
        evidence, so a configured window is an override, not a hint.
      * congested with the queue already holding a full batch -> the floor:
        waiting adds latency but no batch size.
      * otherwise -> the time to FILL one max batch at the observed arrival
        rate, clamped to [base, ceiling]: saturation grows batches.
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
    """The coalesce row target: how many rows a micro-batch aims to collect
    before dispatching. Uncongested -> ``max_rows`` (static behavior: the
    window, not the target, bounds the batch). Congested -> the geometric
    bucket-ladder rung covering the rows expected in one window (queued
    backlog + window's arrivals), so dispatches land on prewarmed bucket
    shapes instead of arbitrary sizes — still clamped to ``max_rows``."""
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


# ------------------------------------------------------------- the ladder --


@dataclass
class _TenantState:
    level: int = LEVEL_HEALTHY
    since: float = 0.0  # monotonic time of the last transition
    burn: Optional[float] = None  # newest per-tenant burn observed
    tokens: float = 0.0  # throttle rung's token bucket (rows)
    refilled: float = 0.0  # monotonic time of the last refill
    transitions: int = 0
    shed: int = 0
    throttled: int = 0
    degraded: int = 0


# Live controllers, for `serving_report()` (ops_plane.report's "serving"
# section): weakly held so an engine's end-of-life does not need an
# unregister call.
_CONTROLLERS: "weakref.WeakSet[OverloadController]" = weakref.WeakSet()


class OverloadController:
    """Per-engine admission gate + per-tenant degradation ladder.

    One instance per ScoringEngine; thread-safe (submit threads call
    `admit`, the worker thread calls `maybe_evaluate`). All config is read
    per call so tests (and live operators) can retune without rebuilding
    the engine."""

    def __init__(self) -> None:
        self._lock = lockcheck.make_lock("serving.overload.OverloadController._lock")
        self._tenants: Dict[str, _TenantState] = {}  # guarded-by: _lock
        self._last_eval = 0.0  # guarded-by: _lock
        _CONTROLLERS.add(self)

    # ------------------------------------------------------------- admit --
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
    ) -> bool:
        """Admission-or-refusal for one request, BEFORE it queues. Returns
        whether the tenant's ladder level asks for the degraded rung (the
        engine honors it only when the resident entry has one). Raises
        `ServeOverloadError` (shed / throttle / queue bound / predicted
        wait), ticking the matching `serve.*` counter."""
        from ..core import config

        reg = telemetry.registry() if telemetry.enabled() else None
        st = self._state(tenant, now)
        level = st.level
        # --- ladder gate: shed refuses outright, throttle meters rows -----
        if level >= LEVEL_SHED:
            with self._lock:
                st.shed += 1
            if reg is not None:
                reg.inc("serve.shed_requests")
            raise ServeOverloadError(
                f"request for model {model!r} shed: tenant {tenant!r} is "
                "over its latency budget",
                model=model, tenant=tenant, level=LEVELS[level],
                queue_depth=queue_depth, queue_rows=queue_rows,
            )
        if level >= LEVEL_THROTTLE and rows > 0:
            if not self._take_tokens(st, tenant, rows, now, reg):
                with self._lock:
                    st.throttled += 1
                if reg is not None:
                    reg.inc("serve.throttled_requests")
                raise ServeOverloadError(
                    f"request for model {model!r} throttled: tenant "
                    f"{tenant!r}'s token bucket is empty",
                    model=model, tenant=tenant, level=LEVELS[level],
                    queue_depth=queue_depth, queue_rows=queue_rows,
                )
        # --- bounded queue ------------------------------------------------
        max_queue_rows = int(config.get("serve_max_queue_rows", 262144))
        if max_queue_rows > 0 and queue_rows + rows > max_queue_rows:
            if reg is not None:
                reg.inc("serve.rejected_requests")
            raise ServeOverloadError(
                f"request for model {model!r} refused: the serving queue is "
                f"full ({queue_rows} + {rows} rows against a "
                f"{max_queue_rows}-row bound)",
                model=model, tenant=tenant, level=LEVELS[level],
                queue_depth=queue_depth, queue_rows=queue_rows,
            )
        # --- deadline feasibility against the live wait prediction --------
        # Two signals, take the worse: the windowed queue-wait p99 (what
        # dispatched requests actually waited), and backlog / service rate
        # (what the CURRENT queue implies). The p99 alone is survivorship-
        # biased under saturation — only requests that waited less than
        # their deadline ever dispatch and record a wait, so a queue whose
        # backlog exceeds every deadline would keep predicting "feasible"
        # while 100% of admissions expire at the head.
        if deadline_s is not None and reg is not None:
            fast_w = reg.bucket_seconds() * 3.0
            p99 = reg.window_quantile("serve.queue_wait_s", 0.99, fast_w)
            service = reg.rate("serve.rows", fast_w)
            # The backlog estimate needs PRESSURE to be meaningful: the
            # windowed rate counts idle time as service time, so a
            # nearly-empty window under light load predicts absurd waits
            # for a one-request queue. A few requests deep is the signal
            # that the queue is actually contended.
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
                    model=model, tenant=tenant, level=LEVELS[level],
                    queue_depth=queue_depth, queue_rows=queue_rows,
                    predicted_wait_ms=predicted * 1e3,
                    deadline_ms=max(0.0, (deadline_s - now)) * 1e3,
                )
        if level >= LEVEL_DEGRADE:
            with self._lock:
                st.degraded += 1
            return True
        return False

    def _take_tokens(
        self, st: _TenantState, tenant: str, rows: int,
        now: float, reg: Any,
    ) -> bool:
        """Refill-then-take on the tenant's token bucket. Rate =
        `config["serve_throttle_rows_per_s"]`, or (auto, 0) half the
        tenant's recent admitted row rate; no measurable rate yet means no
        metering (the ladder just escalated — refusing everything before
        the first refill would be a shed, not a throttle). Burst capacity
        is one second of rate."""
        from ..core import config

        rate = float(config.get("serve_throttle_rows_per_s", 0.0))
        if rate <= 0.0:
            if reg is None:
                return True
            got = reg.rate(
                telemetry.tenant_metric("serve.rows", tenant),
                reg.bucket_seconds() * 3.0,
            )
            if not got:
                return True
            rate = max(1.0, 0.5 * got)
        with self._lock:
            if st.refilled <= 0.0:
                st.tokens, st.refilled = rate, now  # first fill: 1s burst
            else:
                st.tokens = min(rate, st.tokens + (now - st.refilled) * rate)
                st.refilled = now
            if st.tokens < rows:
                return False
            st.tokens -= rows
            return True

    # ---------------------------------------------------------- evaluate --
    def maybe_evaluate(self, now: Optional[float] = None) -> None:
        """The dispatch-path hook (mirrors `slo.maybe_evaluate`): ladder
        evaluation throttled to one pass per metrics bucket width, a no-op
        without a configured serving latency SLO spec, and never raising
        into the hot path."""
        try:
            from ..ops_plane import slo as _slo

            spec = _slo.serving_latency_spec()
            if spec is None or not telemetry.enabled():
                return
            reg = telemetry.registry()
            t = time.monotonic() if now is None else now
            with self._lock:
                if t - self._last_eval < min(reg.bucket_seconds(), self._hold_s()):
                    return
                self._last_eval = t
            self.evaluate(spec, now=t)
        except Exception:  # pragma: no cover - the ladder never fails serving
            _LOG.debug("overload evaluation failed", exc_info=True)

    def evaluate(self, spec: Dict[str, Any], *, now: Optional[float] = None) -> None:
        """One ladder pass: recompute every known tenant's burn and walk
        each one rung up (burning) or down (clear), hysteresis-guarded —
        at most one transition per tenant per `serve_overload_hold_s`
        dwell. Public so tests and ops drills can force a pass."""
        t = time.monotonic() if now is None else now
        hold = self._hold_s()
        global_failing = self._global_failing(spec)
        with self._lock:
            tenants = list(self._tenants)
        for tenant in tenants:
            burn = self._tenant_burn(tenant, spec)
            burning = bool(
                (burn is not None and burn >= self._fast_factor(spec))
                or (global_failing and burn is not None)
            )
            event = None
            with self._lock:
                st = self._tenants[tenant]
                st.burn = burn
                level = st.level
                dwelled = (t - st.since) >= hold
                if burning and level < LEVEL_SHED and (level == LEVEL_HEALTHY or dwelled):
                    event = self._transition_locked(st, tenant, level + 1, t, burn)
                elif not burning and level > LEVEL_HEALTHY and dwelled:
                    event = self._transition_locked(st, tenant, level - 1, t, burn)
            if event is not None:
                self._record_transition(event)

    def _transition_locked(
        self, st: _TenantState, tenant: str, to_level: int,
        now: float, burn: Optional[float],
    ) -> Dict[str, Any]:
        """Mutate one tenant's ladder state under `_lock`; returns the
        transition event for `_record_transition` to emit OUTSIDE the lock
        (audit/recorder/telemetry take their own locks)."""
        from_level = st.level
        st.level, st.since, st.transitions = to_level, now, st.transitions + 1
        if to_level == LEVEL_HEALTHY:
            st.tokens, st.refilled = 0.0, 0.0  # bucket resets with the ladder
        return {
            "tenant": tenant,
            "from_level": from_level,
            "to_level": to_level,
            "burn": burn,
            "max_level": max(s.level for s in self._tenants.values()),
        }

    def _record_transition(self, event: Dict[str, Any]) -> None:
        from ..ops_plane import audit as _audit

        tenant = event["tenant"]
        from_level, to_level = event["from_level"], event["to_level"]
        burn = event["burn"]
        verdict = LEVELS[to_level] if to_level > from_level else "restore"
        reason = (
            f"latency burn {burn:.2f}" if burn is not None else "burn cleared"
        )
        # the audited-decision contract: every throttle/degrade/shed/restore
        # lands in the bounded decision log
        _audit.record_decision(
            "backpressure", "serving", verdict, subject=tenant, tenant=tenant,
            reason=f"{reason}; {LEVELS[from_level]} -> {LEVELS[to_level]}",
            from_level=LEVELS[from_level], to_level=LEVELS[to_level],
            burn=burn,
        )
        # the flight-recorder event (`serve.backpressure`) arrives with A15
        if telemetry.enabled():
            reg = telemetry.registry()
            reg.inc("serve.backpressure_transitions")
            reg.gauge(
                telemetry.tenant_metric("serve.overload_level", tenant),
                float(to_level),
            )
            reg.gauge("serve.overload_level", float(event["max_level"]))
        _LOG.warning(
            "backpressure %s: tenant %r %s -> %s (%s)",
            verdict, tenant, LEVELS[from_level], LEVELS[to_level], reason,
        )

    # ------------------------------------------------------------ signals --
    def _tenant_burn(self, tenant: str, spec: Dict[str, Any]) -> Optional[float]:
        """Per-tenant burn of the configured serving latency objective, read
        from the tenant's histogram sibling over the spec's fast window.
        Overridable seam: the hysteresis tests script it."""
        from ..ops_plane import slo as _slo

        if not telemetry.enabled():
            return None
        hist = telemetry.tenant_metric(str(spec.get("histogram", "")), tenant)
        fast_w = float(spec.get("fast_window_s", _slo.DEFAULT_FAST_WINDOW_S))
        return _slo.burn_rate(
            hist,
            threshold_s=float(spec.get("threshold_s", 0.0)),
            objective=float(spec.get("objective", 0.99)),
            window_s=fast_w,
        )

    @staticmethod
    def _fast_factor(spec: Dict[str, Any]) -> float:
        from ..ops_plane import slo as _slo

        return float(spec.get("fast_burn", _slo.DEFAULT_FAST_BURN))

    @staticmethod
    def _global_failing(spec: Dict[str, Any]) -> bool:
        """Whether the configured spec's GLOBAL verdict is currently
        failing (`slo.last_verdicts`) — escalates every tenant with window
        traffic, so a fleet-wide burn does not hide behind per-tenant
        budgets."""
        from ..ops_plane import slo as _slo

        name = str(spec.get("name") or spec.get("kind") or "slo")
        return any(
            v.get("failing") for v in _slo.last_verdicts() if v.get("name") == name
        )

    def _hold_s(self) -> float:
        from ..core import config

        return max(0.0, float(config.get("serve_overload_hold_s", 30.0)))

    def _state(self, tenant: str, now: float) -> _TenantState:
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                st = self._tenants[tenant] = _TenantState(since=now)
            return st

    # -------------------------------------------------------------- views --
    def level(self, tenant: str) -> int:
        with self._lock:
            st = self._tenants.get(tenant)
            return st.level if st is not None else LEVEL_HEALTHY

    def force_level(self, tenant: str, level: int) -> None:
        """Pin a tenant's ladder level (tests, ops drills). Audited like an
        organic transition so a drill leaves the same evidence."""
        t = time.monotonic()
        st = self._state(tenant, t)
        with self._lock:
            if st.level == level:
                return
            event = self._transition_locked(st, tenant, int(level), t, st.burn)
        self._record_transition(event)

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant ladder state for `ScoringEngine.stats()` and the ops
        report: level, newest burn, dwell, and the refusal counters."""
        t = time.monotonic()
        with self._lock:
            return {
                tenant: {
                    "level": LEVELS[st.level],
                    "burn": st.burn,
                    "dwell_s": t - st.since if st.since else 0.0,
                    "transitions": st.transitions,
                    "shed_requests": st.shed,
                    "throttled_requests": st.throttled,
                    "degraded_requests": st.degraded,
                }
                for tenant, st in self._tenants.items()
            }


def serving_report() -> Dict[str, Any]:
    """The ops-plane `report()`s "serving" section: every live controller's
    per-tenant ladder state plus the per-tenant latency summaries read back
    through the `telemetry.tenant_metric` naming contract."""
    tenants: Dict[str, Any] = {}
    for ctl in list(_CONTROLLERS):
        tenants.update(ctl.stats())
    for tenant, view in tenants.items():
        for base in ("serve.queue_wait_s", "serve.e2e_s"):
            s = telemetry.summarize_histogram(telemetry.tenant_metric(base, tenant))
            key = base.split(".", 1)[1].rsplit("_s", 1)[0]
            view[f"{key}_p50_s"] = s["p50"]
            view[f"{key}_p99_s"] = s["p99"]
    return {"tenants": tenants}
