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
# The 2-D book: a claim may name WHICH chips of the device pool it holds
# (`chip_ids`, the chip's position in `parallel.default_devices()`). Such a
# claim occupies its chips EXCLUSIVELY (`occupied_chips`; a second claim
# overlapping any of them is refused even with bytes to spare: two SPMD
# programs cannot share a chip without waiting on each other) and its bytes
# count on its chips only (`reserved_bytes_on`); a claim that names none
# counts its bytes on every chip and occupies none. Chips that share one
# card (a pool naming a card twice, `parallel.card_groups`) share its
# memory: the bytes checked against a chip's budget are its card's, each
# claim's once for each of its chips there. `note_chip_pool`
# announces the pool's size (the scheduler's passes do): utilization is
# then chip-weighted, and the `_pool` row and `scheduler.chips_idle` are
# read against it. `rebind` moves a claim to other chips (chip-seconds
# accrue at the old width up to the move). `merge_tenant_usage` sums
# per-host `tenant_usage()` maps.
#
# Left out: the per-tenant `device_time` split of the efficiency plane,
# A15. Before a chip pool is announced, the port publishes the
# `scheduler.chips_idle` gauge against one chip, where the JAX package
# publishes it only once a pool was announced.
#
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..utils import lockcheck

__all__ = ["HbmReservation", "HbmLedger", "global_ledger", "reset_global_ledger", "merge_tenant_usage"]

# the pool the `scheduler.chips_idle` gauge reads before one is announced
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
    monotonic clock). `chip_ids`, when set, are the chips the claim holds
    exclusively (the 2-D book; `chips` is then their count); None keeps
    the bytes-only contract, `chips` a pure accounting multiplier."""

    owner: str
    kind: str  # "fit" | "serve" | "job"
    nbytes: int
    rid: int = 0
    active: bool = True
    tenant: str = "default"
    chips: int = 1
    chip_ids: Optional[Tuple[int, ...]] = None
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
        # the chip pool's size (None until announced by note_chip_pool): the
        # denominator of chip-weighted utilization and of chips_idle
        self.total_chips: Optional[int] = None
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

    def reserved_bytes_on(self, chip: int, *, exclude: Optional[HbmReservation] = None) -> int:
        """Bytes of the active claims charged against ONE chip's memory: a
        claim that names chips counts where it is placed, one that names
        none on every chip (it may live anywhere). Chips that share a card
        (`parallel.card_groups`) share its memory, so what is charged is
        the card's: a claim's bytes once for each of its chips there (an
        unplaced claim up to its width)."""
        card = _card_of(int(chip))
        with self._lock:
            return sum(_bytes_on_card(r, card) for r in self._by_id.values() if r.active and r is not exclude)

    def reserved_bytes_per_card(self, *, exclude: Optional[HbmReservation] = None) -> int:
        """`reserved_bytes` as one card holds it at most: each claim's bytes
        once for each of its chips that share a card (1 where no chips
        share one, so it is then `reserved_bytes`). The bytes-only
        admission's "held"."""
        from ..parallel.mesh import chips_per_card

        share = _max_card()
        with self._lock:
            return sum(
                r.nbytes * (min(r.chips, share) if r.chip_ids is None else chips_per_card(r.chip_ids))
                for r in self._by_id.values() if r.active and r is not exclude
            )

    def occupied_chips(self, *, exclude: Optional[HbmReservation] = None) -> Set[int]:
        """The chips held exclusively by active claims that name chips.
        Claims that name none occupy nothing (they budget bytes only)."""
        with self._lock:
            out: Set[int] = set()
            for r in self._by_id.values():
                if r.active and r is not exclude and r.chip_ids is not None:
                    out.update(r.chip_ids)
            return out

    def note_chip_pool(self, total_chips: Optional[int]) -> None:
        """Announce the chip pool's size (the scheduler's passes do; tests
        may): the denominator of chip-weighted utilization and chips_idle."""
        with self._lock:
            self.total_chips = None if total_chips is None else int(total_chips)

    def utilization(self) -> Optional[float]:
        """Reserved share of the last budget an admission saw, or None while
        no budget was ever seen (the CPU without `hbm_budget_bytes`). With
        an announced pool it is chip-weighted: ``sum(nbytes x chips) /
        (budget x total_chips)``."""
        with self._lock:
            if not self.last_budget:
                return None
            total = self.total_chips
            if total:
                weighted = sum(
                    r.nbytes * (len(r.chip_ids) if r.chip_ids is not None else min(r.chips, total))
                    for r in self._by_id.values() if r.active
                )
                return weighted / float(self.last_budget * total)
            return self.reserved_bytes() / float(self.last_budget)

    def tenant_usage(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant integrated accounting: `byte_seconds` (bytes held x
        wall seconds) and `chip_seconds` (chips x wall seconds), the claims
        ever made (`reservations`), plus the live claims (`live_bytes`,
        `live_reservations`, `chips_busy`: the chips its placed claims hold,
        else its widest unplaced claim's), and the `_pool` row
        (`chips_busy`; with an announced pool `chips_total` and
        `chips_idle`). Live claims are integrated up to now."""
        now = _now()
        with self._lock:
            for r in self._by_id.values():
                if r.active:
                    self._accrue_locked(r, now)
            out: Dict[str, Dict[str, float]] = {t: dict(u) for t, u in self._tenant_usage.items()}
            busy_union: Set[int] = set()
            legacy_span = 0
            per_tenant_chips: Dict[str, Set[int]] = {}
            per_tenant_legacy: Dict[str, int] = {}
            for r in self._by_id.values():
                if not r.active:
                    continue
                u = out.setdefault(r.tenant, _fresh_usage())
                u["live_bytes"] = u.get("live_bytes", 0.0) + r.nbytes
                u["live_reservations"] = u.get("live_reservations", 0.0) + 1
                if r.chip_ids is not None:
                    busy_union.update(r.chip_ids)
                    per_tenant_chips.setdefault(r.tenant, set()).update(r.chip_ids)
                else:
                    legacy_span = max(legacy_span, r.chips)
                    per_tenant_legacy[r.tenant] = max(per_tenant_legacy.get(r.tenant, 0), r.chips)
            # unplaced claims share the pool: a tenant's are its widest, never
            # a sum
            for tenant, u in out.items():
                placed = per_tenant_chips.get(tenant)
                if placed is not None:
                    u["chips_busy"] = float(len(placed))
                elif tenant in per_tenant_legacy:
                    u["chips_busy"] = float(per_tenant_legacy[tenant])
            total = self.total_chips
            pool = out.setdefault("_pool", _fresh_usage())
            pool_busy = max(len(busy_union), legacy_span)
            pool["chips_busy"] = float(pool_busy)
            if total is not None:
                pool["chips_total"] = float(total)
                pool["chips_idle"] = float(max(0, total - pool_busy))
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
        self,
        owner: str,
        kind: str,
        nbytes: int,
        *,
        tenant: Optional[str] = None,
        chips: int = 1,
        chip_ids: Optional[Sequence[int]] = None,
    ) -> HbmReservation:
        """Record a claim: admission logic (memory.py, scheduler/queue.py)
        decides WHETHER, this records THAT. `tenant` defaults to the
        enclosing scheduler job's (or "default"). A `chip_ids` claim holds
        exactly those chips (`chips` follows the set's size)."""
        if tenant is None:
            tenant = _current_tenant()
        now = _now()
        placed = None if chip_ids is None else tuple(sorted(int(c) for c in chip_ids))
        if placed is not None:
            chips = len(placed)
        r = HbmReservation(
            owner=owner, kind=kind, nbytes=max(0, int(nbytes)), tenant=str(tenant),
            chips=max(1, int(chips)), chip_ids=placed, t0=now, mark=now,
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
        chip_ids: Optional[Sequence[int]] = None,
    ) -> Optional[HbmReservation]:
        """Atomic check-then-reserve: None when ``held + nbytes`` would
        exceed `budget`; a None budget always admits (no capacity
        information, no budgeting). With `chip_ids` the check is 2-D:
        occupancy first (a requested chip already held refuses, whatever
        the bytes), then the bytes on each requested chip against the
        per-device budget (a card its chips share holds the new claim's
        bytes once for each of them)."""
        with self._lock:
            if chip_ids is not None:
                want = {int(c) for c in chip_ids}
                if want & self.occupied_chips(exclude=exclude):
                    return None
                if budget is not None:
                    nb = max(0, int(nbytes))
                    if any(
                        self.reserved_bytes_on(c, exclude=exclude) + nb * len(want & _card_of(c)) > budget
                        for c in want
                    ):
                        return None
            elif budget is not None and (
                self.reserved_bytes_per_card(exclude=exclude) + max(0, int(nbytes)) * min(max(1, int(chips)), _max_card())
                > budget
            ):
                return None
            return self.reserve(owner, kind, nbytes, tenant=tenant, chips=chips, chip_ids=chip_ids)

    def resize(self, r: HbmReservation, nbytes: int) -> None:
        """True a claim up (or down) to `nbytes`: a job's queue-time estimate
        replaced by its fit admission's working set. The caller checked the
        new size under `admission()`; the interval up to now is charged the
        OLD size (those were the bytes held)."""
        with self._lock:
            self._accrue_locked(r, _now())
            r.nbytes = max(0, int(nbytes))
            self._note_locked()

    def rebind(self, r: HbmReservation, chip_ids: Optional[Sequence[int]]) -> None:
        """Move a claim to other chips (a resumed job on another run of
        equal width). Bookkeeping only, as `resize`: the caller checked the
        move under `admission()`. The interval up to now accrues at the OLD
        width (those were the chips held)."""
        with self._lock:
            self._accrue_locked(r, _now())
            if chip_ids is None:
                r.chip_ids = None
            else:
                r.chip_ids = tuple(sorted(int(c) for c in chip_ids))
                r.chips = max(1, len(r.chip_ids))
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
            total = self.total_chips
            busy = len(self.occupied_chips())
            if busy == 0:
                busy = max((r.chips for r in self._by_id.values() if r.active), default=0)
                if total is not None:
                    busy = min(busy, total)
        if telemetry.enabled():
            reg = telemetry.registry()
            if last:
                reg.gauge("scheduler.ledger_utilization", self.utilization() or 0.0)
            reg.gauge("scheduler.chips_busy", busy)
            reg.gauge("scheduler.chips_idle", max(0, (POOL_CHIPS if total is None else total) - busy))
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


def _card_of(chip: int) -> Set[int]:
    """The chips that share `chip`'s card (`parallel.card_groups`)."""
    from ..parallel.mesh import card_groups

    return next((set(g) for g in card_groups() if chip in g), {chip})


def _max_card() -> int:
    """The most chips of the pool that share one card (1: none do)."""
    from ..parallel.mesh import card_groups

    return max([len(g) for g in card_groups()] + [1])


def _bytes_on_card(r: HbmReservation, card: Set[int]) -> int:
    """The bytes claim `r` holds on the card of the chips `card`: one block
    on each of its chips there, or, for a claim that names none, one on
    each chip there up to its width."""
    if r.chip_ids is None:
        return r.nbytes * min(r.chips, len(card))
    return r.nbytes * len(card.intersection(r.chip_ids))


def merge_tenant_usage(usages: Sequence[Dict[str, Dict[str, float]]]) -> Dict[str, Dict[str, float]]:
    """The roll-up of several `tenant_usage()` maps (one a host): every
    numeric term summed per tenant (byte- and chip-seconds, live bytes and
    claims, chips_busy, the `_pool` row's chips_total and chips_idle: hosts
    own disjoint chips) and the per-kind `device_time` splits where a map
    has them. A tenant a host never saw contributes nothing there."""
    out: Dict[str, Dict[str, float]] = {}
    for usage in usages:
        for tenant, u in (usage or {}).items():
            acc = out.setdefault(str(tenant), {})
            for k, v in (u or {}).items():
                if k == "device_time" and isinstance(v, dict):
                    dt = acc.setdefault("device_time", {})  # type: ignore[assignment]
                    for kind, sec in v.items():
                        if isinstance(sec, (int, float)):
                            dt[kind] = dt.get(kind, 0.0) + float(sec)  # type: ignore[union-attr]
                elif isinstance(v, (int, float)):
                    acc[k] = acc.get(k, 0.0) + float(v)
    return out
