#
# HbmLedger: one per-device byte ledger for every device-memory consumer in
# the process. The port's copy of spark_rapids_ml_tpu/scheduler/ledger.py,
# its 1-D (bytes-only) book.
#
# Both admissions (memory.py: `admit_fit`, `admit_model_load`) charge
# against the budget MINUS what this ledger already holds, and every claim
# is recorded here:
#
#   kind "fit"    a standalone fit's claim, from admission to the end of the
#                 fit (core._TpuCaller._call_fit_func);
#   kind "serve"  a resident model's, from admission through placement,
#                 prewarm and residency to its eviction (serving.ModelRegistry);
#   kind "job"    a scheduler job's (scheduler/queue.py), made at queue
#                 admission from the job's estimate, RESIZED (not
#                 duplicated) by the job's own `admit_fit`, released when the
#                 job completes, fails or is preempted.
#
# The ledger never decides anything; it is bookkeeping with one atomicity
# guarantee: `admission()` is the lock every admission decision runs under
# (the fit and load admissions and the scheduler's co-admission passes), so
# check-then-reserve is race-free. Each claim carries its tenant (the
# enclosing scheduler job's, else "default"; a serving load's
# "serving:<name>"), and the ledger integrates bytes x seconds held and
# chips x seconds held per tenant (`tenant_usage`, the ops report's
# `tenants` section). `admission_hooks` fire after every admission
# decision with (reserved bytes, budget): the "never over budget, at any
# admission" check of the tests and of chip_smoke.py's phase 17.
#
# Left out: the 2-D chip book (claims naming WHICH cards: `chip_ids`,
# `occupied_chips`, `reserved_bytes_on`, `rebind`, `note_chip_pool`) and the
# fleet roll-up `merge_tenant_usage`, ROADMAP A10; the per-tenant
# `device_time` split of the efficiency plane, A15. Without a chip pool the
# JAX package computes chips_busy, the `_pool` row and utilization exactly
# as here; the port's pool is its one card (parallel/), so the
# `scheduler.chips_idle` gauge is published against it, where the JAX
# package publishes it only once a chip pool was announced.
#
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..utils import lockcheck

__all__ = ["HbmReservation", "HbmLedger", "global_ledger", "reset_global_ledger"]

# the cards every claim shares: the port places on one (parallel/)
POOL_CHIPS = 1


def _now() -> float:
    return time.monotonic()


def _fresh_usage() -> Dict[str, float]:
    return {"byte_seconds": 0.0, "chip_seconds": 0.0, "reservations": 0.0}


def _current_tenant() -> str:
    """The enclosing scheduler job's tenant, or "default": every claim
    (standalone fits included) lands in the per-tenant accounting without
    its caller naming a tenant."""
    from . import context as _ctx

    job = _ctx.current_job()
    return str(job.tenant) if job is not None else "default"


@dataclass
class HbmReservation:
    """One admitted per-device byte claim. `nbytes` changes only through
    `HbmLedger.resize` (a job's queue-time estimate trued up by the fit's
    own admission); `active` flips False exactly once on release (a second
    release is a no-op, never a double credit). `tenant` and `chips` feed
    the per-tenant accounting; `t0`/`mark` are its integration anchors (the
    monotonic clock)."""

    owner: str
    kind: str  # "fit" | "serve" | "job"
    nbytes: int
    rid: int = 0
    active: bool = True
    tenant: str = "default"
    chips: int = 1
    t0: float = 0.0
    mark: float = 0.0  # the last byte-seconds integration point


class HbmLedger:
    """Thread-safe reservation ledger (see the module note)."""

    def __init__(self) -> None:
        self._lock = lockcheck.make_lock("scheduler.ledger.HbmLedger._lock", "rlock")
        self._admission_lock = lockcheck.make_lock("scheduler.ledger.HbmLedger._admission_lock", "rlock")
        self._by_id: Dict[int, HbmReservation] = {}  # guarded-by: _lock
        self._ids = itertools.count(1)
        self.high_watermark: int = 0
        self.last_budget: Optional[int] = None
        self.admission_hooks: List[Callable[[int, Optional[int]], None]] = []
        # per-tenant integrated usage of released and resized claims;
        # tenant_usage() adds the live ones
        self._tenant_usage: Dict[str, Dict[str, float]] = {}  # guarded-by: _lock

    def admission(self):
        """The one lock every admission decision (check, then reserve) runs
        under, so two concurrent admissions cannot both see the same free
        bytes."""
        return self._admission_lock

    # ------------------------------------------------------------- reads ---
    def reserved_bytes(self, *, kind: Optional[str] = None, exclude: Optional[HbmReservation] = None) -> int:
        """Bytes of the active claims, of one `kind` only when given, without
        `exclude` (a job's admission re-truing its own claim must not count
        it twice)."""
        with self._lock:
            return sum(
                r.nbytes for r in self._by_id.values()
                if r.active and (kind is None or r.kind == kind) and r is not exclude
            )

    def reservations(self) -> List[HbmReservation]:
        with self._lock:
            return [r for r in self._by_id.values() if r.active]

    def utilization(self) -> Optional[float]:
        """Reserved share of the last budget an admission saw, or None while
        no budget was ever seen (the CPU without `hbm_budget_bytes`)."""
        with self._lock:
            if not self.last_budget:
                return None
            return self.reserved_bytes() / float(self.last_budget)

    def tenant_usage(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant integrated accounting: `byte_seconds` (bytes held x
        wall seconds) and `chip_seconds` (cards x wall seconds), the claims
        ever made (`reservations`), plus the live claims (`live_bytes`,
        `live_reservations`, `chips_busy`: the widest live claim), and the
        `_pool` row (`chips_busy` over all live claims). Live claims are
        integrated up to now."""
        now = _now()
        with self._lock:
            for r in self._by_id.values():
                if r.active:
                    self._accrue_locked(r, now)
            out: Dict[str, Dict[str, float]] = {t: dict(u) for t, u in self._tenant_usage.items()}
            widest = 0
            for r in self._by_id.values():
                if not r.active:
                    continue
                u = out.setdefault(r.tenant, _fresh_usage())
                u["live_bytes"] = u.get("live_bytes", 0.0) + r.nbytes
                u["live_reservations"] = u.get("live_reservations", 0.0) + 1
                # claims share the card: the tenant's busy cards are its
                # widest claim's, never a sum
                u["chips_busy"] = float(max(int(u.get("chips_busy", 0)), r.chips))
                widest = max(widest, r.chips)
            pool = out.setdefault("_pool", _fresh_usage())
            pool["chips_busy"] = float(widest)
        return out

    # ------------------------------------------------------------ writes ---
    def _accrue_locked(self, r: HbmReservation, now: float) -> None:
        """Integrate `r`'s byte- and chip-seconds since its last mark (the
        caller holds the lock; called at every change of `nbytes` and at
        release, so each interval is charged the bytes held through it)."""
        dt = max(0.0, now - r.mark)
        r.mark = now
        if dt == 0.0:
            return
        u = self._tenant_usage.setdefault(r.tenant, _fresh_usage())
        u["byte_seconds"] += r.nbytes * dt
        u["chip_seconds"] += r.chips * dt

    def reserve(
        self, owner: str, kind: str, nbytes: int, *, tenant: Optional[str] = None, chips: int = 1
    ) -> HbmReservation:
        """Record a claim: admission logic (memory.py, scheduler/queue.py)
        decides WHETHER, this records THAT. `tenant` defaults to the
        enclosing scheduler job's (or "default")."""
        if tenant is None:
            tenant = _current_tenant()
        now = _now()
        r = HbmReservation(
            owner=owner, kind=kind, nbytes=max(0, int(nbytes)), tenant=str(tenant),
            chips=max(1, int(chips)), t0=now, mark=now,
        )
        with self._lock:
            r.rid = next(self._ids)
            self._by_id[r.rid] = r
            self._tenant_usage.setdefault(r.tenant, _fresh_usage())["reservations"] += 1
            self._note_locked()
        return r

    def try_reserve(
        self,
        owner: str,
        kind: str,
        nbytes: int,
        *,
        budget: Optional[int] = None,
        exclude: Optional[HbmReservation] = None,
        tenant: Optional[str] = None,
        chips: int = 1,
    ) -> Optional[HbmReservation]:
        """Atomic check-then-reserve: None when ``held + nbytes`` would
        exceed `budget`; a None budget always admits (no capacity
        information, no budgeting)."""
        with self._lock:
            if budget is not None and self.reserved_bytes(exclude=exclude) + max(0, int(nbytes)) > budget:
                return None
            return self.reserve(owner, kind, nbytes, tenant=tenant, chips=chips)

    def resize(self, r: HbmReservation, nbytes: int) -> None:
        """True a claim up (or down) to `nbytes`: a job's queue-time estimate
        replaced by its fit admission's working set. The caller checked the
        new size under `admission()`; the interval up to now is charged the
        OLD size (those were the bytes held)."""
        with self._lock:
            self._accrue_locked(r, _now())
            r.nbytes = max(0, int(nbytes))
            self._note_locked()

    def release(self, r: Optional[HbmReservation]) -> None:
        """Return a claim's bytes. Idempotent; None is a no-op, so callers
        can release unconditionally in `finally` blocks."""
        if r is None:
            return
        with self._lock:
            if not r.active:
                return
            self._accrue_locked(r, _now())
            r.active = False
            # a claim of a ledger that `reset_global_ledger` replaced may
            # share its id with a live claim of this one: remove only itself
            if self._by_id.get(r.rid) is r:
                del self._by_id[r.rid]
            self._note_locked()

    # ---------------------------------------------------------- telemetry --
    def note_admission(self, budget: Optional[int]) -> None:
        """Record one admission DECISION (admit or refuse) against `budget`:
        remember the budget (the utilization denominator), publish the
        `scheduler.ledger_utilization`, `scheduler.chips_busy` and
        `scheduler.chips_idle` gauges, and fire every admission hook with
        (reserved bytes, budget)."""
        from .. import telemetry

        with self._lock:
            if budget is not None:
                self.last_budget = int(budget)
            reserved = self.reserved_bytes()
            last = self.last_budget
            busy = max((r.chips for r in self._by_id.values() if r.active), default=0)
        if telemetry.enabled():
            reg = telemetry.registry()
            if last:
                reg.gauge("scheduler.ledger_utilization", self.utilization() or 0.0)
            reg.gauge("scheduler.chips_busy", busy)
            reg.gauge("scheduler.chips_idle", max(0, POOL_CHIPS - busy))
        for hook in list(self.admission_hooks):
            hook(reserved, budget)

    def _note_locked(self) -> None:
        reserved = sum(r.nbytes for r in self._by_id.values() if r.active)
        if reserved > self.high_watermark:
            self.high_watermark = reserved
        from .. import telemetry

        if telemetry.enabled():
            telemetry.registry().gauge("scheduler.ledger_reserved_bytes", reserved)


# One ledger per process: fits, serving loads and scheduler jobs charge the
# same device memory, so they share one book.
_GLOBAL = HbmLedger()
_GLOBAL_LOCK = lockcheck.make_lock("scheduler.ledger._GLOBAL_LOCK")


def global_ledger() -> HbmLedger:
    return _GLOBAL


def reset_global_ledger() -> HbmLedger:
    """A fresh process-global ledger (a leaked claim of an earlier run must
    not shrink every later budget)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = HbmLedger()
    return _GLOBAL
