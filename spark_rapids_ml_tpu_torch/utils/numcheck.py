#
# Runtime numerics sanitizer: the port's copy of
# spark_rapids_ml_tpu/utils/numcheck.py.
#
# Opt-in via ``SRML_NUMCHECK=1``. Call sites resolve the hook ONCE per
# fit/loop entry (`_nc = numcheck.hook()`); disabled, `hook()` returns None
# and the boundary guard is a single `is not None` test on a local: zero
# wrapper, zero per-iteration work.
#
# Enabled, the hook runs at boundaries whose values are ALREADY on the host,
# so a check adds arithmetic on bytes the host holds anyway, never a new
# wait for the card: the Lloyd loop's deferred shift read
# (ops/kmeans.lloyd_loop), the streamed solvers' per-chunk partials and the
# streamed GLM's outer iterations (ops/streaming.py, ops/logistic.py), the
# solver checkpoints' fetched state (`kmeans.checkpoint`; `segment.glm_qn`
# and `segment.owlqn`, ops/owlqn.LoopCheckpoint), and the serving plane's
# response assembly (serving/engine.py):
#
#   * every float value passed is swept with `np.isfinite`; a NaN/Inf TRIPS:
#     the violation is recorded here, ticks `numcheck.trips`, and raises a
#     typed `NumericsError` carrying solver/iteration/stage/value-name;
#   * every checked value's dtype lands in a per-stage dtype WATERMARK
#     (which precisions each boundary actually saw);
#   * `numcheck.checks` counts boundary sweeps.
#
# ``SRML_NUMCHECK_REPORT=<path>`` writes the report at interpreter exit.
# `snapshot()`/`restore()` let a test fixture discard its deliberate trips.
#
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "enabled",
    "hook",
    "check",
    "checks",
    "trips",
    "watermarks",
    "report",
    "write_report",
    "reset",
    "snapshot",
    "restore",
]

# a strict LEAF lock (lockcheck discipline): only ever taken inside the
# sanitizer around plain dict/list mutation, never around user code
_META = threading.Lock()
_CHECKS = [0]  # guarded-by: _META
_TRIPS: List[Dict[str, Any]] = []  # guarded-by: _META
_WATERMARKS: Dict[str, Dict[str, int]] = {}  # guarded-by: _META


def enabled() -> bool:
    """Sanitizer opt-in, read per call so tests can flip it; call sites
    resolve it once per fit/loop entry through `hook()`."""
    return os.environ.get("SRML_NUMCHECK", "0") not in ("", "0", "false", "off")


def hook() -> Optional[Callable[..., None]]:
    """THE boundary entry point: the `check` callable when the sanitizer is
    on, None otherwise. Call sites hold the result in a local — the disabled
    path is one env read per fit plus one `is not None` test per boundary
    (zero-cost contract, pinned)."""
    return check if enabled() else None


def check(
    stage: str,
    *,
    solver: str = "",
    iteration: Optional[int] = None,
    watermark: Any = None,
    allow_inf: bool = False,
    **values: Any,
) -> None:
    """Sweep already-host-fetched `values` for NaN/Inf and record dtype
    watermarks for `stage`. `watermark` adds a dtype observation WITHOUT a
    finite-ness sweep — for device arrays whose dtype is free to read but
    whose bytes were not fetched (e.g. the k-means centers between cadence
    checkpoints). `allow_inf=True` restricts the sweep to NaN, for
    boundaries where ±Inf is a DOCUMENTED sentinel (top-k pads short
    result rows with `inf` distances) — NaN is a bug everywhere. A non-finite value
    raises `NumericsError` AFTER recording, so the report names the trip
    even when the caller converts the error."""
    marks: List[str] = []
    if watermark is not None:
        marks.append(str(np.dtype(watermark)))
    trip: Optional[Dict[str, Any]] = None
    for name, value in values.items():
        arr = np.asarray(value)
        marks.append(str(arr.dtype))
        if arr.dtype.kind not in "fc":
            continue
        bad_mask = np.isnan(arr) if allow_inf else ~np.isfinite(arr)
        if bool(bad_mask.any()):
            bad = arr[bad_mask]
            n_nan = int(np.isnan(bad).sum())
            n_inf = int(bad.size - n_nan)
            trip = {
                "stage": stage,
                "solver": solver,
                "iteration": iteration,
                "value": name,
                "nan": n_nan,
                "inf": n_inf,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "t": time.time(),
            }
            break
    with _META:
        _CHECKS[0] += 1
        wm = _WATERMARKS.setdefault(stage, {})
        for m in marks:
            wm[m] = wm.get(m, 0) + 1
        if trip is not None:
            _TRIPS.append(dict(trip))
    if trip is None:
        return
    # mirror AFTER the bookkeeping: a telemetry failure must not lose the
    # recorded trip, and the typed raise comes last
    try:
        from .. import telemetry

        # the flight-recorder event (`numcheck.trip`) arrives with A15
        if telemetry.enabled():
            telemetry.registry().inc("numcheck.trips")
    except Exception:  # pragma: no cover - teardown ordering
        pass
    from ..errors import NumericsError

    raise NumericsError(
        stage,
        solver=solver,
        iteration=iteration,
        value_name=trip["value"],
        detail=f"{trip['nan']} NaN / {trip['inf']} Inf over shape "
        f"{tuple(trip['shape'])} {trip['dtype']}",
    )


# ---------------------------------------------------------------- reports ---


def checks() -> int:
    with _META:
        return _CHECKS[0]


def trips() -> List[Dict[str, Any]]:
    with _META:
        return [dict(t) for t in _TRIPS]


def watermarks() -> Dict[str, Dict[str, int]]:
    with _META:
        return {k: dict(v) for k, v in _WATERMARKS.items()}


def report() -> Dict[str, Any]:
    """The report: boundary sweep count, every trip, and the per-stage
    dtype watermarks."""
    with _META:
        return {
            "enabled": enabled(),
            "checks": _CHECKS[0],
            "trips": [dict(t) for t in _TRIPS],
            "watermarks": {
                k: dict(sorted(v.items())) for k, v in sorted(_WATERMARKS.items())
            },
        }


def write_report(path: str) -> Optional[str]:
    rep = report()
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rep, f, indent=2, default=str)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:  # pragma: no cover - report is best-effort
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return path


def reset() -> None:
    """Forget checks, trips, and watermarks (test isolation)."""
    with _META:
        _CHECKS[0] = 0
        del _TRIPS[:]
        _WATERMARKS.clear()


def snapshot() -> Dict[str, Any]:
    """Copy of the global sanitizer state. The numcheck test fixture
    snapshots before it resets and restores after, so its DELIBERATE trips
    never reach the report while what was observed before the fixture
    survives it."""
    with _META:
        return {
            "checks": _CHECKS[0],
            "trips": [dict(t) for t in _TRIPS],
            "watermarks": {k: dict(v) for k, v in _WATERMARKS.items()},
        }


def restore(state: Dict[str, Any]) -> None:
    """Replace the global state with a `snapshot()` — everything observed
    since the snapshot (the fixture test's own deliberate trips) is
    DISCARDED, everything from before it comes back."""
    with _META:
        _CHECKS[0] = int(state["checks"])
        _TRIPS[:] = [dict(t) for t in state["trips"]]
        _WATERMARKS.clear()
        _WATERMARKS.update({k: dict(v) for k, v in state["watermarks"].items()})


def _atexit_report() -> None:  # pragma: no cover - runs at interpreter exit
    path = os.environ.get("SRML_NUMCHECK_REPORT")
    if path and enabled():
        write_report(path)


atexit.register(_atexit_report)
