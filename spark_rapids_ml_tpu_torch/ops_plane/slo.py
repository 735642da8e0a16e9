#
# SLO monitors: declarative objectives over the rolling-window metrics,
# evaluated by multi-window burn rate. The port's copy of the
# single-process part of spark_rapids_ml_tpu/ops_plane/slo.py.
#
# `config["slo"]` is a list of specs; each names a metric surface and an
# objective, and the monitor turns the telemetry registry's windowed views
# into a live health verdict:
#
#   {"name": "serve_p99", "kind": "latency",
#    "histogram": "serve.e2e_s", "threshold_s": 0.25, "objective": 0.99}
#   {"name": "serve_errors", "kind": "error_rate",
#    "errors": "serve.errors", "total": "serve.requests", "threshold": 0.01}
#   {"name": "ledger_util", "kind": "gauge_ceiling",
#    "gauge": "scheduler.ledger_utilization", "ceiling": 0.95}
#
# BURN RATE (the SRE multiwindow pattern): the error budget of a latency SLO
# with objective 0.99 is 1% of requests over threshold; burn = observed bad
# fraction / budget, so burn 1.0 spends the budget exactly and burn 14.4 on
# the FAST window is a page-now spike. Each spec is evaluated over two
# windows, fast (default 60 s) and slow (default 1 h, clamped to the ring
# horizon), and fails when EITHER window's burn crosses its factor
# (`fast_burn` default 14.4, `slow_burn` default 1.0). An EMPTY window is
# healthy: no traffic is not a violation.
#
# Transitions (healthy -> failing and back) tick `slo.trips` / `slo.clears`;
# the failing-spec count rides the `slo.failing` gauge. `maybe_evaluate()`
# is the inline hook the serving engine calls where it records its
# histograms, throttled to one evaluation per bucket width and a no-op
# without configured specs; /healthz and `report()` call `evaluate()` so a
# scrape is always fresh. The serving backpressure ladder reads
# `serving_latency_spec()`, `burn_rate()` and `last_verdicts()`.
#
# `evaluate_reader` and `cluster_health` run the same specs, statelessly,
# over any windowed reader: the fleet plane's merged cluster window
# (telemetry.MergedWindows), where a `min_count` floor lets the fleet's
# burn trip while each rank's thin slice stays healthy. Not here: the
# flight-recorder events of each trip and clear (ROADMAP A15).
#
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ..utils import lockcheck

__all__ = [
    "evaluate",
    "evaluate_reader",
    "cluster_health",
    "maybe_evaluate",
    "health",
    "last_verdicts",
    "reset",
    "burn_rate",
    "serving_latency_spec",
]

DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 3600.0
DEFAULT_FAST_BURN = 14.4
DEFAULT_SLOW_BURN = 1.0

_LOCK = lockcheck.make_lock("ops_plane.slo._LOCK")
_LAST: Dict[str, Dict[str, Any]] = {}  # spec name -> newest verdict  # guarded-by: _LOCK
_TRIPPED: Dict[str, bool] = {}  # guarded-by: _LOCK
_LAST_EVAL: float = 0.0  # guarded-by: _LOCK


def _specs() -> List[Dict[str, Any]]:
    from ..core import config

    raw = config.get("slo") or []
    return [s for s in raw if isinstance(s, dict)]


def _burn_windows(spec: Dict[str, Any], horizon: float):
    fast = min(float(spec.get("fast_window_s", DEFAULT_FAST_WINDOW_S)), horizon)
    slow = min(float(spec.get("slow_window_s", DEFAULT_SLOW_WINDOW_S)), horizon)
    return fast, slow


def _eval_one(spec: Dict[str, Any], reg: Any, horizon: float) -> Dict[str, Any]:
    name = str(spec.get("name") or spec.get("kind") or "slo")
    kind = str(spec.get("kind", ""))
    fast_w, slow_w = _burn_windows(spec, horizon)
    fast_factor = float(spec.get("fast_burn", DEFAULT_FAST_BURN))
    slow_factor = float(spec.get("slow_burn", DEFAULT_SLOW_BURN))
    v: Dict[str, Any] = {
        "name": name,
        "kind": kind,
        "failing": False,
        "fast_window_s": fast_w,
        "slow_window_s": slow_w,
        "fast_burn_threshold": fast_factor,
        "slow_burn_threshold": slow_factor,
        "fast_burn": None,
        "slow_burn": None,
    }

    def burn_from_fraction(window_s: float, budget: float) -> Optional[float]:
        hist = str(spec.get("histogram", ""))
        thr = float(spec.get("threshold_s", 0.0))
        got = reg.window_fraction_over(hist, thr, window_s)
        if got is None:
            return None
        frac, count = got
        v.setdefault("samples", {})[f"{window_s:g}s"] = count
        # statistical floor: a window holding fewer than `min_count`
        # samples is treated as no-traffic (healthy), so a 3-request blip
        # cannot page
        if count < int(spec.get("min_count", 0)):
            return None
        return frac / budget if budget > 0 else (float("inf") if frac else 0.0)

    try:
        if kind == "latency":
            budget = 1.0 - float(spec.get("objective", 0.99))
            v["threshold_s"] = float(spec.get("threshold_s", 0.0))
            v["objective"] = float(spec.get("objective", 0.99))
            v["fast_burn"] = burn_from_fraction(fast_w, budget)
            v["slow_burn"] = burn_from_fraction(slow_w, budget)
            v["p99"] = reg.window_quantile(str(spec.get("histogram", "")), 0.99, fast_w)
        elif kind == "error_rate":
            thr = float(spec.get("threshold", 0.01))
            v["threshold"] = thr
            for key, window_s in (("fast_burn", fast_w), ("slow_burn", slow_w)):
                total = reg.rate(str(spec.get("total", "")), window_s)
                errors = reg.rate(str(spec.get("errors", "")), window_s) or 0.0
                if not total:
                    continue  # no traffic in the window: healthy
                ratio = errors / total
                v.setdefault("ratio", {})[key] = ratio
                v[key] = ratio / thr if thr > 0 else (float("inf") if ratio else 0.0)
        elif kind == "gauge_ceiling":
            ceiling = float(spec.get("ceiling", 1.0))
            v["ceiling"] = ceiling
            value = reg.snapshot()["gauges"].get(str(spec.get("gauge", "")))
            v["value"] = value
            if value is not None:
                burn = value / ceiling if ceiling > 0 else float("inf")
                v["fast_burn"] = v["slow_burn"] = burn
        else:
            v["error"] = f"unknown slo kind {kind!r}"
    except (TypeError, ValueError) as e:
        # a malformed spec must degrade to a visible error verdict, never
        # take down the serving/scheduling path evaluating it
        v["error"] = f"{type(e).__name__}: {e}"
    v["failing"] = bool(
        (v["fast_burn"] is not None and v["fast_burn"] >= fast_factor)
        or (v["slow_burn"] is not None and v["slow_burn"] >= slow_factor)
    )
    return v


def evaluate(force: bool = True) -> List[Dict[str, Any]]:
    """Evaluate every configured SLO spec against the rolling windows; record
    transitions; return the verdict list (empty without specs)."""
    global _LAST_EVAL
    from .. import telemetry

    specs = _specs()
    reg = telemetry.registry()
    now = time.monotonic()
    with _LOCK:
        if not force and specs and now - _LAST_EVAL < reg.bucket_seconds():
            return [dict(v) for v in _LAST.values()]
        _LAST_EVAL = now
    if not specs:
        with _LOCK:
            _LAST.clear()
        return []
    horizon = reg.window_horizon_s()
    verdicts = [_eval_one(s, reg, horizon) for s in specs]
    if telemetry.enabled():
        reg.inc("slo.evaluations")
        reg.gauge("slo.failing", float(sum(v["failing"] for v in verdicts)))
    trips: List[Dict[str, Any]] = []
    clears: List[Dict[str, Any]] = []
    with _LOCK:
        # check-and-set under the lock so a concurrent engine-thread + scrape
        # evaluation cannot both observe the same transition (double trip)
        for v in verdicts:
            was = _TRIPPED.get(v["name"], False)
            if v["failing"] and not was:
                trips.append(v)
            elif was and not v["failing"]:
                clears.append(v)
            _TRIPPED[v["name"]] = v["failing"]
        _LAST.clear()
        for v in verdicts:
            _LAST[v["name"]] = v
    # the flight-recorder events of each trip and clear (`slo.trip`,
    # `slo.clear`) arrive with A15
    if telemetry.enabled():
        for _ in trips:
            reg.inc("slo.trips")
        for _ in clears:
            reg.inc("slo.clears")
    return verdicts


def evaluate_reader(
    reader: Any,
    specs: Optional[List[Dict[str, Any]]] = None,
    horizon: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """Evaluate SLO specs (default: the configured ones) against any
    windowed reader with `window_fraction_over`, `rate`, `window_quantile`
    and `snapshot()["gauges"]`: the live registry or a fleet's
    `telemetry.MergedWindows`. Stateless: no trip or clear state is touched
    (a cluster verdict is a view; each process's monitors stay the source
    of its transitions)."""
    specs = _specs() if specs is None else [s for s in specs if isinstance(s, dict)]
    if not specs:
        return []
    if horizon is None:
        try:
            horizon = float(reader.window_horizon_s())
        except Exception:
            horizon = DEFAULT_SLOW_WINDOW_S
    return [_eval_one(s, reader, horizon) for s in specs]


def cluster_health(reader: Any, specs: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """The health verdict over a fleet's merged window, in `health()`'s
    shape, through `evaluate_reader`."""
    verdicts = evaluate_reader(reader, specs)
    failing = [v["name"] for v in verdicts if v["failing"]]
    return {
        "healthy": not failing,
        "failing": failing,
        "specs": len(verdicts),
        "verdicts": verdicts,
        "t": time.time(),
    }


def maybe_evaluate() -> None:
    """The inline hook at histogram record points (serving dispatch):
    near-free without configured specs, throttled to one evaluation per
    bucket width with them."""
    try:
        if not _specs():
            return
        evaluate(force=False)
    except Exception:  # pragma: no cover - monitors never fail the hot path
        pass


def burn_rate(
    histogram: str,
    *,
    threshold_s: float,
    objective: float,
    window_s: Optional[float] = None,
) -> Optional[float]:
    """Point burn rate of ONE latency surface over ONE window: the observed
    fraction of samples over `threshold_s` divided by the error budget
    (1 - objective). None when the window holds no samples (no traffic is
    not a burn — the same vacuous-health rule `evaluate` applies).

    The public seam the serving backpressure ladder uses to compute
    PER-TENANT burn from the per-tenant histogram siblings
    (``telemetry.tenant_metric("serve.e2e_s", tenant)``) of a configured
    spec's surface — same arithmetic as `_eval_one`'s fast/slow burns, one
    window at a time."""
    from .. import telemetry

    reg = telemetry.registry()
    w = min(
        float(window_s) if window_s is not None else DEFAULT_FAST_WINDOW_S,
        reg.window_horizon_s(),
    )
    got = reg.window_fraction_over(histogram, float(threshold_s), w)
    if got is None:
        return None
    frac, _count = got
    budget = 1.0 - float(objective)
    return frac / budget if budget > 0 else (float("inf") if frac else 0.0)


def serving_latency_spec() -> Optional[Dict[str, Any]]:
    """The first configured latency SLO spec over a serving histogram
    (``serve.*``) — the objective the backpressure ladder closes its loop
    on. None when no such spec is configured (the ladder stays inert;
    deadlines and the queue bound do not need a spec)."""
    for spec in _specs():
        if (
            str(spec.get("kind", "")) == "latency"
            and str(spec.get("histogram", "")).startswith("serve.")
        ):
            return dict(spec)
    return None


def last_verdicts() -> List[Dict[str, Any]]:
    with _LOCK:
        return [dict(v) for v in _LAST.values()]


def health(*, fresh: bool = True) -> Dict[str, Any]:
    """The health verdict /healthz serves: healthy iff no configured SLO is
    failing (a process with no specs is vacuously healthy)."""
    verdicts = evaluate(force=True) if fresh else last_verdicts()
    failing = [v["name"] for v in verdicts if v["failing"]]
    return {
        "healthy": not failing,
        "failing": failing,
        "specs": len(verdicts),
        "verdicts": verdicts,
        "t": time.time(),
    }


def reset() -> None:
    """Forget verdict/trip state (test isolation)."""
    global _LAST_EVAL
    with _LOCK:
        _LAST.clear()
        _TRIPPED.clear()
        _LAST_EVAL = 0.0
