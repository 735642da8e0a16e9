#
# Decision audit trail: one bounded per-process log of every control-plane
# VERDICT, keyed by tenant and trace id. The port's copy of
# spark_rapids_ml_tpu/ops_plane/audit.py.
#
# Every fit admission, demotion and refusal (memory.admit_fit), every model
# load's admission or refusal (memory.admit_model_load), every eviction
# (serving.registry) and every step of the serving backpressure ladder
# (serving.overload) appends one structured record here, so "why was tenant
# X refused at 14:02" is one query (`decisions(tenant=..., trace_id=...)`,
# `ops_plane.report()`) against a live process or its snapshot.
#
#   * ALWAYS-ON and bounded: recording is one dict and one locked deque
#     append; capacity is `SRML_AUDIT_EVENTS` (default 4096) and overwrites
#     are counted (`ops.decisions_dropped`), never silent. Decisions record
#     whether telemetry is on or not, like the admission stamps they mirror.
#   * every record carries its tenant (explicit, else "default"; the
#     scheduler's job tenant arrives with ROADMAP A17), the trace tags and
#     the rank (diagnostics.py).
#
# A record's keys and values equal the JAX package's for the same call,
# except its time `t`.
#
from __future__ import annotations

import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils import lockcheck

__all__ = ["record_decision", "decisions", "stats", "clear"]

_DEFAULT_CAPACITY = 4096


def _capacity() -> int:
    try:
        return max(1, int(os.environ.get("SRML_AUDIT_EVENTS", _DEFAULT_CAPACITY)))
    except ValueError:  # a typo'd knob must not crash module import
        return _DEFAULT_CAPACITY


_LOCK = lockcheck.make_lock("ops_plane.audit._LOCK")
_LOG: "deque[Dict[str, Any]]" = deque(maxlen=_capacity())  # guarded-by: _LOCK
_TOTAL = 0  # decisions ever recorded (dropped = total - retained)  # guarded-by: _LOCK


def record_decision(
    kind: str,
    subsystem: str,
    verdict: str,
    *,
    subject: str = "",
    tenant: Optional[str] = None,
    reason: str = "",
    **detail: Any,
) -> Dict[str, Any]:
    """Append one decision record.

    `kind` is the verdict family (``admission`` | ``demotion`` |
    ``eviction`` | ``backpressure``), `subsystem` the plane that decided
    (``fit`` | ``serving``), `subject` what was decided about (estimator or
    model name, or tenant), and `detail` any JSON-able specifics (byte
    terms, ladder levels). Returns the record."""
    global _TOTAL
    from .. import diagnostics, telemetry

    if tenant is None:
        tenant = "default"  # the enclosing scheduler job's tenant: ROADMAP A17
    rec: Dict[str, Any] = {
        "t": time.time(),
        "kind": str(kind),
        "subsystem": str(subsystem),
        "subject": str(subject),
        "tenant": tenant,
        "verdict": str(verdict),
        "reason": str(reason),
        "rank": diagnostics._rank(),
        **diagnostics.trace_tags(),
    }
    if detail:
        rec["detail"] = detail
    with _LOCK:
        dropped = len(_LOG) == _LOG.maxlen
        _LOG.append(rec)
        _TOTAL += 1
    if telemetry.enabled():
        reg = telemetry.registry()
        reg.inc("ops.decisions_recorded")
        if dropped:
            reg.inc("ops.decisions_dropped")
    # the flight-recorder mirror (a `decision` event) arrives with A15
    return rec


def decisions(
    *,
    tenant: Optional[str] = None,
    trace_id: Optional[str] = None,
    kind: Optional[str] = None,
    subsystem: Optional[str] = None,
    limit: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Retained decisions, oldest first, filtered by any combination of
    tenant / trace id / kind / subsystem; `limit` keeps the newest N."""
    with _LOCK:
        out = [dict(r) for r in _LOG]
    if tenant is not None:
        out = [r for r in out if r.get("tenant") == tenant]
    if trace_id is not None:
        out = [r for r in out if r.get("trace_id") == trace_id]
    if kind is not None:
        out = [r for r in out if r.get("kind") == kind]
    if subsystem is not None:
        out = [r for r in out if r.get("subsystem") == subsystem]
    if limit is not None and limit >= 0:
        out = out[-limit:] if limit else []
    return out


def stats() -> Dict[str, Any]:
    with _LOCK:
        return {
            "capacity": _LOG.maxlen,
            "recorded": _TOTAL,
            "retained": len(_LOG),
            "dropped": _TOTAL - len(_LOG),
        }


def clear() -> None:
    """Drop every retained decision (test isolation)."""
    global _TOTAL
    with _LOCK:
        _LOG.clear()
        _TOTAL = 0
