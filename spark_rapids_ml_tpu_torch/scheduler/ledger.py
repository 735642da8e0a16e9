#
# HbmLedger: one per-device byte ledger for every device-memory consumer in
# the process. The port's subset of spark_rapids_ml_tpu/scheduler/ledger.py:
# what the fit and serving admissions use.
#
# Both admissions (memory.py: `admit_fit`, `admit_model_load`) charge
# against the budget MINUS what this ledger already holds, and reserve their
# estimate here: a fit's claim (kind "fit") from admission to the end of the
# fit (core._TpuCaller._call_fit_func), a model's (kind "serve") from
# admission through placement, prewarm and residency to its eviction
# (serving.ModelRegistry). The ledger never decides anything; it is
# bookkeeping with one atomicity guarantee: `admission()` is the lock every
# admission decision runs under, so check-then-reserve is race-free across
# concurrent fits and loads.
#
# Left out (they have no consumer in the port yet): scheduler job
# reservations and resize/rebind (ROADMAP A17), per-tenant accounting, the
# high watermark, the 2-D chip book (A10) and the admission hooks.
#
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["HbmReservation", "HbmLedger", "global_ledger"]


@dataclass
class HbmReservation:
    """One admitted per-device byte claim; `active` flips False exactly once
    on release (a second release is a no-op, never a double credit)."""

    owner: str
    kind: str  # "fit" | "serve"
    nbytes: int
    rid: int = 0
    active: bool = True


class HbmLedger:
    """Thread-safe reservation ledger (see the module note)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._admission_lock = threading.RLock()
        self._by_id: Dict[int, HbmReservation] = {}  # guarded-by: _lock
        self._ids = itertools.count(1)

    def admission(self) -> threading.RLock:
        """The one lock every admission decision (check, then reserve) runs
        under, so two concurrent admissions cannot both see the same free
        bytes."""
        return self._admission_lock

    def reserved_bytes(self) -> int:
        """Bytes of every active reservation."""
        with self._lock:
            return sum(r.nbytes for r in self._by_id.values())

    def reserve(self, owner: str, kind: str, nbytes: int) -> HbmReservation:
        """Record a claim: admission logic (memory.py) decides WHETHER, this
        records THAT."""
        r = HbmReservation(owner=owner, kind=kind, nbytes=max(0, int(nbytes)))
        with self._lock:
            r.rid = next(self._ids)
            self._by_id[r.rid] = r
        return r

    def release(self, r: Optional[HbmReservation]) -> None:
        """Return a claim's bytes. Idempotent; None is a no-op, so callers
        can release unconditionally in `finally` blocks."""
        if r is None:
            return
        with self._lock:
            if not r.active:
                return
            r.active = False
            self._by_id.pop(r.rid, None)


# One ledger per process: every load charges the same device memory.
_GLOBAL = HbmLedger()


def global_ledger() -> HbmLedger:
    return _GLOBAL
