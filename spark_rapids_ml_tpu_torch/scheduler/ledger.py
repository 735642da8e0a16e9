#
# HbmLedger: one per-device byte ledger for every device-memory consumer in
# the process. The port's subset of spark_rapids_ml_tpu/scheduler/ledger.py:
# what the serving plane's admission uses.
#
# Admission (`memory.admit_model_load`) charges a load against the budget
# MINUS what this ledger already holds, and reserves its estimate here: one
# reservation (kind "serve") per resident model, held from admission through
# placement, prewarm and residency, and released on eviction
# (serving.ModelRegistry). The ledger never decides anything; it is
# bookkeeping with one atomicity guarantee: `admission()` is the lock every
# admission decision runs under, so check-then-reserve is race-free across
# concurrent loads.
#
# Left out (they have no consumer in the port yet): fit-side and scheduler
# job reservations, resize/rebind, per-kind and per-tenant accounting, the
# high watermark, the 2-D chip book and the admission hooks.
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
    kind: str  # "serve"
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
