#
# Runtime lock-order sanitizer, lockdep-style: the port's copy of
# spark_rapids_ml_tpu/utils/lockcheck.py.
#
# Opt-in via ``SRML_LOCKCHECK=1`` (resolved when each lock is CONSTRUCTED,
# so export it before the package is imported). Disabled,
# `make_lock`/`make_condition` return the plain `threading` primitive: zero
# wrapper, zero overhead.
#
# Enabled, every lock built through `make_lock(name, kind)` is a
# `CheckedLock` that on each acquisition records, per thread, the stack of
# locks already held and feeds a process-global observed-order graph:
#
#   * edge A -> B the first time B is acquired while A is held;
#   * acquiring B while holding A when the REVERSE edge B -> A was observed
#     earlier is an ORDER INVERSION: the two code paths can deadlock under
#     the right interleaving even if this run got lucky. The violation is
#     recorded here and ticks `lockcheck.inversions`;
#   * re-entrant re-acquisition of the same named lock adds no edge;
#   * a hold longer than ``config["lockcheck_long_hold_ms"]`` (seeded from
#     SRML_LOCKCHECK_LONG_HOLD_MS, default 500 ms) records a
#     `lockcheck.long_hold` violation with the per-lock high-watermark.
#
# Lock NAMES are the JAX package's (`<module>.<Class>.<attr>` /
# `<module>.<GLOBAL>` relative to the package), so both packages' reports
# speak one vocabulary: the serving, telemetry, audit, SLO, drift and
# exporter locks are built here.
#
# ``SRML_LOCKCHECK_REPORT=<path>`` writes the violation report at
# interpreter exit.
#
from __future__ import annotations

import atexit
import json
import os
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "enabled",
    "make_lock",
    "make_condition",
    "CheckedLock",
    "violations",
    "edges",
    "report",
    "write_report",
    "reset",
    "snapshot",
    "restore",
    "long_hold_threshold_s",
]

_DEFAULT_LONG_HOLD_MS = 500.0
# the package's config module, probed through sys.modules (never imported)
_CORE_MODULE = __name__.rsplit(".", 2)[0] + ".core"


def enabled() -> bool:
    """Sanitizer opt-in, read per call so tests can flip it; production
    locks resolve it once, at construction."""
    return os.environ.get("SRML_LOCKCHECK", "0") not in ("", "0", "false", "off")


def long_hold_threshold_s() -> float:
    """Long-hold watermark threshold. config["lockcheck_long_hold_ms"] when
    core is already imported (a sys.modules probe — the sanitizer must never
    pay core's import chain from a lock construction), else the env var,
    else 500 ms."""
    import sys

    core = sys.modules.get(_CORE_MODULE)
    if core is not None:
        try:
            return float(core.config.get("lockcheck_long_hold_ms", _DEFAULT_LONG_HOLD_MS)) / 1e3
        except Exception:  # pragma: no cover - teardown ordering
            pass
    try:
        return float(os.environ.get("SRML_LOCKCHECK_LONG_HOLD_MS", _DEFAULT_LONG_HOLD_MS)) / 1e3
    except ValueError:
        return _DEFAULT_LONG_HOLD_MS / 1e3


# ---------------------------------------------------------------- state -----

# the meta lock is a RAW threading.Lock and a strict LEAF: it is only ever
# taken inside the sanitizer with no way to acquire a user lock under it, so
# it can never participate in the orders it polices
_META = threading.Lock()
_EDGES: Dict[Tuple[str, str], Dict[str, Any]] = {}  # guarded-by: _META
_VIOLATIONS: List[Dict[str, Any]] = []  # guarded-by: _META
_MAX_HOLD_S: Dict[str, float] = {}  # guarded-by: _META
_LOCK_NAMES: List[str] = []  # guarded-by: _META

_TLS = threading.local()  # .held: List[dict], .suppress: int


def _held_stack() -> List[Dict[str, Any]]:
    held = getattr(_TLS, "held", None)
    if held is None:
        held = _TLS.held = []
    return held


def _short_stack(skip: int = 3, limit: int = 6) -> List[str]:
    frames = traceback.extract_stack()[:-skip]
    return [f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}" for f in frames[-limit:]]


def _record_violation(v: Dict[str, Any]) -> None:
    """Append + mirror into telemetry. The suppress flag stops the mirror's
    own lock acquisitions (the registry lock is itself a CheckedLock) from
    re-entering the analysis: bounded recursion by construction. The
    recording cost is credited back to every held entry's clock so the
    sanitizer never self-inflicts a long-hold violation."""
    _TLS.suppress = getattr(_TLS, "suppress", 0) + 1
    t_start = time.monotonic()
    try:
        with _META:
            _VIOLATIONS.append(v)
        from .. import telemetry

        # the flight-recorder event (`lockcheck.<kind>`) arrives with A15
        if telemetry.enabled():
            if v["kind"] == "inversion":
                telemetry.registry().inc("lockcheck.inversions")
            else:
                telemetry.registry().inc("lockcheck.long_holds")
    except Exception:  # pragma: no cover - teardown ordering
        pass
    finally:
        cost = time.monotonic() - t_start
        for h in _held_stack():
            h["t0"] += cost
        _TLS.suppress -= 1


def _on_acquired(name: str) -> None:
    held = _held_stack()
    reentrant = any(h["name"] == name for h in held)
    suppressed = getattr(_TLS, "suppress", 0) > 0
    if not reentrant and not suppressed and held:
        # scan EVERY held lock — one inversion must not stop the forward
        # edges (or further inversions) of the other held entries from
        # being recorded, or a later real ABBA pair against them would be
        # reported clean
        inversions: List[Dict[str, Any]] = []
        with _META:
            for h in held:
                if h["reentrant"]:
                    continue
                fwd = (h["name"], name)
                rev = (name, h["name"])
                if rev in _EDGES and fwd not in _EDGES:
                    inversions.append({"held": h["name"], "first": dict(_EDGES[rev])})
                elif fwd not in _EDGES:
                    _EDGES[fwd] = {
                        "thread": threading.current_thread().name,
                        "stack": _short_stack(),
                    }
        for inv in inversions:
            _record_violation(
                {
                    "kind": "inversion",
                    "lock": name,
                    "held": inv["held"],
                    "thread": threading.current_thread().name,
                    "stack": _short_stack(),
                    "first_site": inv["first"].get("stack"),
                    "t": time.time(),
                }
            )
    # t0 stamped AFTER any violation recording above, so the recording cost
    # (first call pays lazy imports) never counts as hold time
    held.append({"name": name, "t0": time.monotonic(), "reentrant": reentrant})


def _on_released(name: str) -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i]["name"] == name:
            entry = held.pop(i)
            break
    else:
        return  # release without a tracked acquire (restore edge cases)
    if entry["reentrant"] or getattr(_TLS, "suppress", 0) > 0:
        return
    dt = time.monotonic() - entry["t0"]
    threshold = long_hold_threshold_s()
    over = dt > threshold
    with _META:
        if dt > _MAX_HOLD_S.get(name, 0.0):
            _MAX_HOLD_S[name] = dt
    if over:
        _record_violation(
            {
                "kind": "long_hold",
                "lock": name,
                "hold_s": dt,
                "threshold_s": threshold,
                "thread": threading.current_thread().name,
                "stack": _short_stack(),
                "t": time.time(),
            }
        )


# ---------------------------------------------------------------- wrapper ---


class CheckedLock:
    """Instrumented Lock/RLock with the `threading` lock interface plus the
    RLock internals (`_is_owned`/`_acquire_restore`/`_release_save`) so
    `threading.Condition` can own one. `cond.wait()` releases through
    `_release_save`, which POPS the held entry — wait time is not hold
    time."""

    def __init__(self, name: str, kind: str = "lock"):
        self.name = name
        self.kind = "rlock" if kind == "condition" else kind
        self._inner = threading.RLock() if self.kind == "rlock" else threading.Lock()
        with _META:
            _LOCK_NAMES.append(name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _on_acquired(self.name)
        return ok

    def release(self) -> None:
        _on_released(self.name)
        self._inner.release()

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        if inner_locked is not None:
            return bool(inner_locked())
        return bool(self._inner._is_owned())  # RLock before 3.12

    # -- threading.Condition integration (RLock protocol) ------------------
    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        _on_released(self.name)
        return self._inner._release_save()

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        _on_acquired(self.name)

    def __repr__(self) -> str:
        return f"<CheckedLock {self.name} ({self.kind})>"


def make_lock(name: str, kind: str = "lock"):
    """THE package's lock factory: a plain `threading.Lock`/`RLock` while the
    sanitizer is off (zero-cost contract), a `CheckedLock` under
    ``SRML_LOCKCHECK=1``. `name` is the JAX package's id for the same lock
    (`<module>.<Class>.<attr>`)."""
    if not enabled():
        return threading.RLock() if kind == "rlock" else threading.Lock()
    return CheckedLock(name, kind)


def make_condition(name: str):
    """`threading.Condition` over a checked RLock when the sanitizer is on,
    a plain Condition otherwise."""
    if not enabled():
        return threading.Condition()
    return threading.Condition(CheckedLock(name, "rlock"))


# ---------------------------------------------------------------- reports ---


def violations() -> List[Dict[str, Any]]:
    with _META:
        return [dict(v) for v in _VIOLATIONS]


def edges() -> Dict[Tuple[str, str], Dict[str, Any]]:
    with _META:
        return {k: dict(v) for k, v in _EDGES.items()}


def report() -> Dict[str, Any]:
    """The violation report: observed order graph,
    inversion/long-hold violations, and per-lock hold watermarks."""
    with _META:
        return {
            "enabled": enabled(),
            "locks": sorted(set(_LOCK_NAMES)),
            "edges": sorted(f"{a} -> {b}" for a, b in _EDGES),
            "inversions": [dict(v) for v in _VIOLATIONS if v["kind"] == "inversion"],
            "long_holds": [dict(v) for v in _VIOLATIONS if v["kind"] == "long_hold"],
            "max_hold_s": dict(sorted(_MAX_HOLD_S.items())),
            "long_hold_threshold_s": long_hold_threshold_s(),
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
    """Forget the observed graph and violations (test isolation)."""
    with _META:
        _EDGES.clear()
        _VIOLATIONS.clear()
        _MAX_HOLD_S.clear()
        del _LOCK_NAMES[:]


def snapshot() -> Dict[str, Any]:
    """Copy of the global sanitizer state. The lockcheck test fixture
    snapshots before it resets and restores after, so its DELIBERATE
    inversions never reach the report while what was observed before the
    fixture survives it."""
    with _META:
        return {
            "edges": {k: dict(v) for k, v in _EDGES.items()},
            "violations": [dict(v) for v in _VIOLATIONS],
            "max_hold_s": dict(_MAX_HOLD_S),
            "lock_names": list(_LOCK_NAMES),
        }


def restore(state: Dict[str, Any]) -> None:
    """Replace the global state with a `snapshot()` — everything observed
    since the snapshot (the fixture test's own deliberate inversions) is
    DISCARDED, everything from before it comes back."""
    with _META:
        _EDGES.clear()
        _EDGES.update({k: dict(v) for k, v in state["edges"].items()})
        _VIOLATIONS[:] = [dict(v) for v in state["violations"]]
        _MAX_HOLD_S.clear()
        _MAX_HOLD_S.update(state["max_hold_s"])
        _LOCK_NAMES[:] = list(state["lock_names"])


def _atexit_report() -> None:  # pragma: no cover - runs at interpreter exit
    path = os.environ.get("SRML_LOCKCHECK_REPORT")
    if path and enabled():
        write_report(path)


atexit.register(_atexit_report)
