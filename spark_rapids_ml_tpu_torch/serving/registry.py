#
# ModelRegistry: fitted models resident on the card under admission
# control. The port's copy of spark_rapids_ml_tpu/serving/registry.py.
#
# A load is a three-step transaction:
#
#   1. ADMISSION (under the registry lock) — `memory.admit_model_load`
#      charges the model's placement terms plus one dispatched bucket's
#      workspace against the device budget MINUS what the shared ledger
#      (scheduler/ledger.py) already holds: every resident keeps its
#      reservation from admission until eviction. Over budget: evict the
#      least-recently-USED resident (scoring touches move entries to MRU) and
#      retry; nothing left to evict: the typed `HbmBudgetError` propagates,
#      and the refusal, naming its largest byte term, is stamped on
#      `model._serve_metrics["admission"]`.
#   2. PLACEMENT (no registry lock) — the model's serving hook
#      (`_serve_program`) builds the resident `PredictProgram`: its device
#      state is placed once and held for the entry's lifetime.
#   3. PREWARM (no registry lock) — every bucket-ladder rung up to
#      `config["serve_prewarm_rows"]` is dispatched once, so the kernels are
#      built and launched at load and the first query pays neither.
#
# Serveability is preflighted (`model._serve_check`) before any eviction, so
# a load that can never succeed does not drop residents as a side effect.
# Eviction (explicit `evict()`, pressure during a later load, or a reload of
# the same name) drops the entry's program, the only reference to its device
# state, and re-stamps the evicted model with verdict "evicted".
#
# Not in the port yet (ROADMAP A13): the degraded serving rung
# (`config["serve_degraded_dtype"]`, a second resident program for the
# backpressure ladder) and the audit log of admissions and evictions.
#
from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, List, Optional

from .. import telemetry
from ..errors import HbmBudgetError

__all__ = ["ResidentModel", "ModelRegistry"]

_LOG = logging.getLogger(__name__)


@dataclass
class ResidentModel:
    """One registry entry: the model, its resident PredictProgram, and the
    admission verdict that let it in."""

    name: str
    model: Any
    program: Any  # core.PredictProgram; None once evicted
    admission: Any  # memory.AdmissionDecision
    serve_dtype: Optional[str] = None
    n_cols: int = 0
    prewarmed_rungs: int = 0

    @property
    def resident_bytes(self) -> int:
        return int(self.admission.estimate.total())


class ModelRegistry:
    """Resident multi-model store for the serving plane.

    Thread-safe; `get()` is a use-touch (moves the entry to MRU), so pressure
    eviction during a load removes the model that has served least recently.
    """

    def __init__(
        self, *, prewarm: bool = True, max_batch_rows: Optional[int] = None
    ) -> None:
        from ..core import config

        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, ResidentModel]" = OrderedDict()  # guarded-by: _lock
        self._prewarm_default = bool(prewarm)
        self._cap = int(max_batch_rows or config.get("serve_max_batch_rows", 8192))

    # ------------------------------------------------------------- reads --
    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def resident_bytes(self) -> int:
        """Admitted per-device bytes currently held by resident models."""
        with self._lock:
            return sum(e.resident_bytes for e in self._entries.values())

    def get(self, name: str) -> ResidentModel:
        """The resident entry for `name` (KeyError when absent or evicted).
        A USE-touch: moves the entry to most-recently-used."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise KeyError(
                    f"model {name!r} is not resident (never loaded, or evicted)"
                )
            self._entries.move_to_end(name)
            return entry

    # ------------------------------------------------------------- loads --
    def load(
        self,
        name: str,
        model: Any,
        *,
        serve_dtype: Optional[str] = None,
        prewarm: Optional[bool] = None,
    ) -> ResidentModel:
        """Load a fitted model as `name` (admission -> placement -> prewarm,
        see the module note) on `parallel.default_device()`. Reloading an
        existing name replaces the previous entry. Raises the typed
        `HbmBudgetError` when the model cannot fit even with every other
        resident evicted, or when the card runs out of memory while it is
        placed or prewarmed.

        Placement and prewarm run OUTSIDE the registry lock, so concurrent
        `get()`s (and with them all scoring) go on meanwhile; the admitted
        bytes stay reserved in the shared ledger while the build runs, so
        concurrent loads cannot jointly overshoot the budget."""
        from .. import memory
        from ..core import config
        from ..parallel import default_device

        if config.get("serve_degraded_dtype") is not None:
            raise NotImplementedError(
                f"serve_degraded_dtype={config['serve_degraded_dtype']!r}: the degraded "
                "serving rung of the backpressure ladder is not in the PyTorch port yet "
                "(ROADMAP item A13)"
            )
        do_prewarm = self._prewarm_default if prewarm is None else bool(prewarm)
        model._serve_check(serve_dtype)  # before anything is evicted
        device = default_device()  # raises without a card or set_devices("cpu")
        with self._lock:
            if name in self._entries:
                self._evict_locked(name, reason="reloaded")
            while True:  # each pass admits, or evicts one LRU entry, or raises
                try:
                    # residents are charged through their ledger reservations
                    adm = memory.admit_model_load(
                        model, bucket_rows_count=self._cap, device=device, serve_dtype=serve_dtype
                    )
                    break
                except HbmBudgetError as e:
                    victim = next(iter(self._entries), None)
                    if victim is None:
                        model._serve_metrics["admission"] = {
                            "verdict": "refused",
                            "reason": str(e),
                            "estimate_bytes": e.estimate_bytes,
                            "capacity_bytes": e.capacity_bytes,
                            "largest_term": e.largest_term,
                            "largest_term_bytes": e.largest_term_bytes,
                        }
                        raise
                    _LOG.warning(
                        "serving budget pressure loading %r: evicting LRU "
                        "resident %r (%s)", name, victim, e,
                    )
                    self._evict_locked(victim, reason=f"pressure from load of {name!r}")
        # ---- placement + prewarm: no registry lock held ------------------
        try:
            program = model._serve_program(serve_dtype, cap=self._cap)
            n_cols = model._serve_n_cols()
            rungs = 0
            max_rows = int(config.get("serve_prewarm_rows", 4096))
            if do_prewarm and max_rows > 0:
                rungs = program.prewarm(n_cols, max_rows=max_rows)
        except BaseException as e:
            memory.release_admission(adm)
            if memory.is_oom_error(e):
                est = adm.estimate
                name_, nbytes = est.largest()
                raise HbmBudgetError(
                    f"device out of memory while placing or prewarming {name!r}: {e}",
                    estimate_bytes=est.total(),
                    capacity_bytes=adm.budget_bytes,
                    largest_term=name_,
                    largest_term_bytes=nbytes,
                    terms=est.terms,
                ) from e
            raise
        with self._lock:
            if name in self._entries:  # a concurrent load published first
                self._evict_locked(name, reason="reloaded")
            entry = ResidentModel(
                name=name,
                model=model,
                program=program,
                admission=adm,
                serve_dtype=serve_dtype,
                n_cols=n_cols,
                prewarmed_rungs=rungs,
            )
            self._entries[name] = entry
            model._serve_metrics["admission"] = adm.stamp()
            if telemetry.enabled():
                reg = telemetry.registry()
                reg.inc("serve.models_loaded")
                reg.inc("serve.prewarmed_programs", rungs)
                reg.gauge("serve.resident_bytes", self.resident_bytes())
                reg.gauge("serve.resident_models", len(self._entries))
            return entry

    # --------------------------------------------------------- evictions --
    def evict(self, name: str) -> None:
        """Explicitly drop a resident model (KeyError when absent)."""
        with self._lock:
            if name not in self._entries:
                raise KeyError(f"model {name!r} is not resident")
            self._evict_locked(name, reason="explicit evict")

    def clear(self) -> None:
        """Drop every resident model."""
        with self._lock:
            for name in list(self._entries):
                self._evict_locked(name, reason="registry cleared")

    def _evict_locked(self, name: str, reason: str) -> None:
        from .. import memory

        entry = self._entries.pop(name)
        # the model carries WHY it left residency, largest byte term and all
        stamp = dict(entry.admission.stamp())
        stamp["verdict"] = "evicted"
        stamp["reason"] = reason
        entry.model._serve_metrics["admission"] = stamp
        # the program holds the only references to the device state; the
        # ledger claim returns with it
        memory.release_admission(entry.admission)
        entry.program = None
        if telemetry.enabled():
            reg = telemetry.registry()
            reg.inc("serve.model_evictions")
            reg.gauge("serve.resident_bytes", self.resident_bytes())
            reg.gauge("serve.resident_models", len(self._entries))
        _LOG.info("evicted serving model %r (%s)", name, reason)
