#
# Device-memory admission for the serving plane: the port's serve-side copy
# of spark_rapids_ml_tpu/memory.py.
#
# A model load into `serving.ModelRegistry` gets a preflight verdict: its
# per-device working set (the placement of its resident state, named terms
# from `_serve_placement_terms`, plus one dispatched bucket's predict
# workspace from `_serve_workspace_terms` at the ladder cap) is charged
# against the budget MINUS what the shared ledger (scheduler/ledger.py)
# already holds. It fits: the estimate is reserved there until eviction. It
# does not: a typed `HbmBudgetError` names the largest term, and the
# registry may evict least-recently-used residents and retry.
#
# The budget is capacity x (1 - `config["hbm_headroom_fraction"]`), the
# headroom left for allocator fragmentation and transient buffers. Capacity
# is `config["hbm_budget_bytes"]` when set, else the card's total memory
# (`parallel.device_capacity_bytes`); a CPU device has none, and then every
# load is admitted unbudgeted.
#
# The fit-side admission (resident or streaming verdicts, the out-of-core
# demotion) is ROADMAP item A11.
#
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .errors import HbmBudgetError

__all__ = [
    "RESIDENT", "MemoryEstimate", "AdmissionDecision", "headroom_fraction",
    "model_serve_estimate", "admit_model_load", "release_admission", "is_oom_error",
]

RESIDENT = "resident"


@dataclass
class MemoryEstimate:
    """A per-device byte estimate as named terms (placement.items,
    workspace.topk_block, ...) so failures and logs can name the dominant
    line item."""

    terms: Dict[str, int] = field(default_factory=dict)

    def total(self) -> int:
        return int(sum(self.terms.values()))

    def largest(self) -> Tuple[str, int]:
        if not self.terms:
            return ("", 0)
        name = max(self.terms, key=lambda k: self.terms[k])
        return (name, int(self.terms[name]))


@dataclass
class AdmissionDecision:
    """A load's verdict, the estimate backing it, the capacity and budget it
    was checked against, and the shared-ledger claim it holds (released by
    `release_admission` when the model leaves residency)."""

    verdict: str
    estimate: MemoryEstimate
    capacity_bytes: Optional[int] = None
    budget_bytes: Optional[int] = None
    reason: str = ""
    reservation: Any = None

    def stamp(self) -> Dict[str, Any]:
        """The JSON-able summary stamped on ``model._serve_metrics``."""
        name, nbytes = self.estimate.largest()
        return {
            "verdict": self.verdict,
            "reason": self.reason,
            "estimate_bytes": self.estimate.total(),
            "capacity_bytes": self.capacity_bytes,
            "budget_bytes": self.budget_bytes,
            "chunk_rows": 0,  # serving never streams (the JAX stamp's streaming field)
            "largest_term": name,
            "largest_term_bytes": nbytes,
        }


def headroom_fraction() -> float:
    from .core import config

    try:
        f = float(config.get("hbm_headroom_fraction", 0.1))
    except (TypeError, ValueError):
        return 0.1
    return min(max(f, 0.0), 0.9)


def model_serve_estimate(model: Any, bucket_rows_count: int) -> MemoryEstimate:
    """Per-device working set of a RESIDENT serving model: the placement of
    its state (`_serve_placement_terms`) plus one dispatched bucket's predict
    workspace (`_serve_workspace_terms` at `bucket_rows_count` rows)."""
    dtype = np.float32 if getattr(model, "_float32_inputs", True) else np.float64
    itemsize = int(np.dtype(dtype).itemsize)
    terms: Dict[str, int] = {}
    hook = getattr(model, "_serve_placement_terms", None)
    for name, nbytes in ((hook() if hook is not None else None) or {}).items():
        key = name if name.startswith("placement.") else f"placement.{name}"
        terms[key] = int(nbytes)
    whook = getattr(model, "_serve_workspace_terms", None)
    raw = whook(int(bucket_rows_count), itemsize) if whook is not None else None
    for name, nbytes in (raw or {}).items():
        key = name if name.startswith("workspace.") else f"workspace.{name}"
        terms[key] = int(nbytes)
    return MemoryEstimate(terms)


def admit_model_load(
    model: Any,
    *,
    bucket_rows_count: Optional[int] = None,
    device: Any = None,
) -> AdmissionDecision:
    """Admission verdict for loading a fitted model onto `device` (a torch
    device) in the serving plane: RESIDENT, with its estimate reserved in
    the shared ledger, or a raised `HbmBudgetError` naming the largest
    term."""
    from .core import config
    from .parallel import device_capacity_bytes
    from .scheduler.ledger import global_ledger

    if bucket_rows_count is None:
        bucket_rows_count = int(config.get("serve_max_batch_rows", 8192))
    capacity = device_capacity_bytes(device)
    budget = None if capacity is None else int(capacity * (1.0 - headroom_fraction()))
    led = global_ledger()
    with led.admission():
        held = 0 if budget is None else led.reserved_bytes()
        est = model_serve_estimate(model, bucket_rows_count)
        if budget is None or est.total() + held <= budget:
            return AdmissionDecision(
                verdict=RESIDENT,
                estimate=est,
                capacity_bytes=capacity,
                budget_bytes=budget,
                reason="fits" if budget is not None else "no capacity information",
                reservation=led.reserve(f"serve:{type(model).__name__}", "serve", est.total()),
            )
        name, nbytes = est.largest()
        raise HbmBudgetError(
            f"{type(model).__name__} load does not fit the serving budget "
            f"({held} bytes/device held in the shared ledger)",
            estimate_bytes=est.total(),
            capacity_bytes=budget,
            largest_term=name,
            largest_term_bytes=nbytes,
            terms=est.terms,
        )


def release_admission(adm: Optional[AdmissionDecision]) -> None:
    """Return an admission's shared-ledger claim (idempotent; None-safe for
    `finally` blocks)."""
    if adm is None or adm.reservation is None:
        return
    from .scheduler.ledger import global_ledger

    global_ledger().release(adm.reservation)
    adm.reservation = None


def is_oom_error(exc: BaseException) -> bool:
    """Whether `exc` is a backend out-of-memory failure: torch's
    `torch.OutOfMemoryError` (a RuntimeError), a RuntimeError naming out of
    memory, or MemoryError. An already-typed `HbmBudgetError` is NOT
    matched: it must propagate as it is."""
    if isinstance(exc, HbmBudgetError):
        return False
    if not isinstance(exc, (RuntimeError, MemoryError)):
        return False
    msg = str(exc)
    return (
        "RESOURCE_EXHAUSTED" in msg
        or "out of memory" in msg.lower()
        or isinstance(exc, MemoryError)
    )
