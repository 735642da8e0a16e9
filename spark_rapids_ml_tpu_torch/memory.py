#
# Device-memory admission: the port's copy of spark_rapids_ml_tpu/memory.py,
# its fit half and its serve half.
#
# Every fit that enters `core._TpuCaller._call_fit_func` gets a verdict
# before anything is placed (`admit_fit`):
#
#   RESIDENT  the placement of the rows plus the solver's workspace fits the
#             budget: the rows go to the card as one tensor, as before;
#   STREAM    it does not, but the out-of-core working set (two row chunks
#             in flight plus the workspace at chunk rows) does: the fit
#             demotes to the streaming solvers (ops/streaming.py) and
#             `fit.demotions` advances;
#   raise     not even that fits, or the estimator has no streaming path: a
#             typed `HbmBudgetError` names the largest term.
#
# The estimates are exact byte formulas (tests/test_torch_memory.py holds
# them to analytic counts and to the JAX package's): the placement of the
# rows, labels and weights (`placement_terms`), and the estimator's own
# workspace terms (`_solver_workspace_terms`), which carry the JAX
# package's terms under its names and, under names of their own, what the
# port holds and the reference does not (LogisticRegression `fast`'s bf16
# copy of X, KMeans `fast`'s bf16 row tile).
#
# A model load into `serving.ModelRegistry` gets the serve-side verdict
# (`admit_model_load`): its per-device working set (the placement of its
# resident state, `_serve_placement_terms`, plus one dispatched bucket's
# predict workspace, `_serve_workspace_terms`, at the ladder cap) is
# RESIDENT or refused with a typed `HbmBudgetError`; serving never streams.
#
# Both charge against the budget MINUS what the shared ledger
# (scheduler/ledger.py) already holds, under its admission lock, and
# reserve their estimate there: a fit's claim until the fit ends, a model's
# until its eviction. The budget is capacity x (1 -
# `config["hbm_headroom_fraction"]`). Capacity is a chaos-injected budget
# (`oom:budget=`, parallel/chaos.py), else `config["hbm_budget_bytes"]`, else
# the card's total memory (`parallel.device_capacity_bytes`); a CPU device
# has none, and then everything is admitted unbudgeted.
#
# Every verdict also appends one record to the decision log
# (ops_plane/audit.py): a fit's admission, demotion or refusal (subsystem
# "fit"), a load's admission or refusal (subsystem "serving", tenant
# "serving:<name>"), with the JAX package's keys and values.
#
# Not in the port: the scheduler-job branch (a job's reservation resized,
# a preempted job force-streamed; ROADMAP A17) and the chip-scoped claims
# (A10). A CSR fit is
# charged its padded-ELL placement (`placement_terms`, `row_bytes`: the
# values and int32 indices, padding cells included, as in the JAX
# package) and the ELL solvers' own workspace (`_extraction_workspace_terms`,
# `ell_terms`).
#
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .errors import HbmBudgetError

__all__ = [
    "RESIDENT", "STREAM", "MIN_STREAM_CHUNK_ROWS", "DEFAULT_STREAM_CHUNK_ROWS", "MemoryEstimate",
    "AdmissionDecision", "rows_per_device", "ell_k_max", "ell_terms", "ell_columns_bytes",
    "placement_terms", "row_bytes",
    "workspace_estimate", "resident_estimate", "streaming_estimate", "headroom_fraction", "admit_fit",
    "rereserve_admission", "model_serve_estimate", "admit_model_load", "release_admission",
    "is_oom_error", "as_hbm_budget_error",
]

RESIDENT = "resident"
STREAM = "stream"

# floor of the auto-sized streaming chunk: smaller chunks spend more time on
# launches than on the transfer
MIN_STREAM_CHUNK_ROWS = 256
# the auto chunk when no capacity bounds it
DEFAULT_STREAM_CHUNK_ROWS = 65536


@dataclass
class MemoryEstimate:
    """A per-device byte estimate as named terms (placement.X,
    workspace.gram, ...) so failures and logs can name the dominant line
    item."""

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
    """A verdict, the estimate backing it (the resident one for a resident
    fit or a model load, the streaming one for a demoted fit), the capacity
    and budget it was checked against, the admitted chunk rows (0 unless
    streamed), whether a fit that asked for residency was demoted (by the
    budget, or by the OOM retry), and the shared-ledger claim it holds
    (handed to the fit, or released by `release_admission` when a
    model leaves residency)."""

    verdict: str
    estimate: MemoryEstimate
    capacity_bytes: Optional[int] = None
    budget_bytes: Optional[int] = None
    chunk_rows: int = 0
    reason: str = ""
    demoted: bool = False
    reservation: Any = None

    def stamp(self) -> Dict[str, Any]:
        """The JSON-able summary stamped on ``model._fit_metrics["admission"]``
        (a fit) or ``model._serve_metrics["admission"]`` (a load)."""
        name, nbytes = self.estimate.largest()
        return {
            "verdict": self.verdict,
            "reason": self.reason,
            "estimate_bytes": self.estimate.total(),
            "capacity_bytes": self.capacity_bytes,
            "budget_bytes": self.budget_bytes,
            "chunk_rows": self.chunk_rows,
            "largest_term": name,
            "largest_term_bytes": nbytes,
        }


def _itemsize_of(owner: Any) -> int:
    return 4 if getattr(owner, "_float32_inputs", True) else 8


def rows_per_device(n_rows: int, n_devices: int) -> int:
    """Padded per-device row count of a row layout over `n_devices`
    devices (rows padded to a multiple of the device count). The port
    places on one device, where it is `n_rows`."""
    n_devices = max(1, int(n_devices))
    n_pad = -(-max(0, int(n_rows)) // n_devices) * n_devices
    return n_pad // n_devices


def ell_k_max(csr: Any) -> int:
    """Widest-row nnz of a scipy CSR: the padded-ELL row width (min 1)."""
    if csr.shape[0] == 0:
        return 1
    return max(1, int(np.diff(csr.indptr).max()))


def _is_sparse(extracted: Any) -> bool:
    """Whether the features are a scipy CSR: the sparse extraction of the
    port (`data.ExtractedData.is_sparse`) and of the JAX package alike."""
    return type(extracted.features).__module__.startswith("scipy.sparse")


def placement_terms(extracted: Any, dtype: Any, n_devices: int = 1) -> Dict[str, int]:
    """Per-device bytes of the resident placement of `extracted`: the
    [n, d] rows (sparse: the padded-ELL values and int32 indices, padding
    cells included), one label and one weight per row."""
    itemsize = int(np.dtype(dtype).itemsize)
    rows_dev = rows_per_device(extracted.n_rows, n_devices)
    terms: Dict[str, int] = {}
    if _is_sparse(extracted):
        k_max = ell_k_max(extracted.features)
        terms["placement.ell_values"] = rows_dev * k_max * itemsize
        terms["placement.ell_indices"] = rows_dev * k_max * 4  # int32
    else:
        terms["placement.X"] = rows_dev * int(extracted.n_cols) * itemsize
    if extracted.label is not None:
        terms["placement.y"] = rows_dev * itemsize
    terms["placement.w"] = rows_dev * itemsize
    return terms


def row_bytes(extracted: Any, dtype: Any) -> int:
    """Placed bytes of ONE row (features + label + weight): the unit the
    streaming chunk is sized in. ELL rows cost k_max * (4 + itemsize)."""
    itemsize = int(np.dtype(dtype).itemsize)
    if _is_sparse(extracted):
        per_row = ell_k_max(extracted.features) * (4 + itemsize)
    else:
        per_row = int(extracted.n_cols) * itemsize
    if extracted.label is not None:
        per_row += itemsize
    return per_row + itemsize  # + weight


def ell_terms(extracted: Any, rows_dev: int) -> Tuple[int, int]:
    """(k_max, nonzeros) of the padded-ELL rows a CSR fit holds at once:
    all of them resident, and at most k_max a row in a chunk of `rows_dev`
    rows."""
    csr = extracted.features
    k_max = ell_k_max(csr)
    return k_max, min(int(csr.nnz), max(0, int(rows_dev)) * k_max)


def ell_columns_bytes(nnz: int, d: int, rows: int, chunk: int) -> int:
    """Upper bound of the device bytes of an `ops/sparse.EllColumns` over
    `nnz` cells of `d` columns in `rows` rows: its int64 cell positions and
    the int64 sort temporaries of its build (three arrays of nnz), each
    reduction level's int64 gather (at most the level's values plus one
    chunk of padding per column; a level holds at most a chunk-th of the
    one before plus one value per column), the [d] final gather and the
    [rows] bool of the rows with a (0, 0.0) cell."""
    total, level, widest = 24 * nnz, nnz, nnz
    while widest > 1:
        total += 8 * (level + d * chunk)
        level = level // chunk + d
        widest = -(-widest // chunk)
    return total + 8 * d + rows


def workspace_estimate(
    estimator: Any, extracted: Any, n_devices: int = 1, rows_dev: Optional[int] = None
) -> MemoryEstimate:
    """The estimator's workspace terms (`_solver_workspace_terms`),
    prefixed ``workspace.``, with the row-scaling ones evaluated at
    `rows_dev` rows: the whole dataset for a resident fit (the default),
    one chunk for a streamed one (the streaming solvers hold one chunk's
    per-row state at a time). An estimator's
    `_extraction_workspace_terms(terms, rows_dev, extracted, params,
    itemsize)` then adjusts them to what only the extraction tells: its
    row count, and for CSR input its padded-ELL geometry (`ell_terms`)."""
    itemsize = _itemsize_of(estimator)
    if rows_dev is None:
        rows_dev = rows_per_device(extracted.n_rows, n_devices)
    hook = getattr(estimator, "_solver_workspace_terms", None)
    terms: Dict[str, int] = {}
    if hook is not None:
        params = dict(estimator._solver_params)
        raw = dict(hook(rows_dev, int(extracted.n_cols), params, itemsize) or {})
        data_hook = getattr(estimator, "_extraction_workspace_terms", None)
        if data_hook is not None:
            raw = data_hook(raw, rows_dev, extracted, params, itemsize)
        for name, nbytes in raw.items():
            key = name if name.startswith("workspace.") else f"workspace.{name}"
            terms[key] = int(nbytes)
    return MemoryEstimate(terms)


def resident_estimate(estimator: Any, extracted: Any, n_devices: int = 1) -> MemoryEstimate:
    """The resident working set: placement + workspace."""
    dtype = np.float32 if getattr(estimator, "_float32_inputs", True) else np.float64
    est = MemoryEstimate(dict(placement_terms(extracted, dtype, n_devices)))
    est.terms.update(workspace_estimate(estimator, extracted, n_devices).terms)
    return est


def streaming_estimate(
    estimator: Any, extracted: Any, n_devices: int, chunk_rows: int
) -> MemoryEstimate:
    """The streaming working set: TWO chunks on the card at once (chunk N
    computing while chunk N+1's copy is in flight) plus the workspace with
    its row-scaling terms at the chunk's rows."""
    dtype = np.float32 if getattr(estimator, "_float32_inputs", True) else np.float64
    rb = row_bytes(extracted, dtype)
    chunk_dev = rows_per_device(chunk_rows, n_devices)
    full_dev = rows_per_device(extracted.n_rows, n_devices)
    est = MemoryEstimate({"stream.chunk_buffers": 2 * chunk_dev * rb})
    est.terms.update(
        workspace_estimate(estimator, extracted, n_devices, rows_dev=min(chunk_dev, full_dev)).terms
    )
    return est


def headroom_fraction() -> float:
    from .core import config

    try:
        f = float(config.get("hbm_headroom_fraction", 0.1))
    except (TypeError, ValueError):
        return 0.1
    return min(max(f, 0.0), 0.9)


def _configured_chunk_rows() -> int:
    from .core import config

    try:
        return max(0, int(config.get("stream_chunk_rows", 0)))
    except (TypeError, ValueError):
        return 0


def admit_fit(
    estimator: Any, extracted: Any, device: Any = None, *, force_stream: bool = False
) -> AdmissionDecision:
    """The admission verdict of one fit on `device` (see the module note),
    its estimate reserved in the shared ledger under the ledger's admission
    lock, so two concurrent admissions cannot both claim the same free
    bytes.

    Raises `HbmBudgetError`, naming the largest term, when even the
    streaming working set at the floor chunk exceeds what the ledger
    leaves of the budget, or when the estimator has no streaming path.
    `force_stream` is the OOM retry's entry: the resident check is skipped
    and the streaming path admitted (the capacity may be unknown: a real
    allocation failure is evidence enough). On a card its chunk is sized
    against the smaller of the budget and what the allocator can hand out
    now (`parallel.device_allocatable_bytes`, less the headroom): the budget
    is the card's total memory by default, and a fit whose resident set
    passed it has just failed to allocate."""
    from . import telemetry
    from .ops_plane import audit as _audit
    from .parallel import device_allocatable_bytes, device_capacity_bytes
    from .scheduler.ledger import global_ledger

    n_devices = 1
    capacity = device_capacity_bytes(device)
    budget = None if capacity is None else int(capacity * (1.0 - headroom_fraction()))
    reg = telemetry.registry()
    if capacity is not None:
        reg.gauge("memory.capacity_bytes", capacity)
    led = global_ledger()
    with led.admission():
        held = 0 if budget is None else led.reserved_bytes()
        avail = None if budget is None else max(0, budget - held)
        held_note = (
            f" ({held} bytes/device already reserved in the shared ledger by other fits/serving models)"
            if held else ""
        )

        def _grant(est_obj, verdict, chunk_rows=0, reason="", demoted=False):
            # one decision record per verdict: the queryable side of the
            # _fit_metrics["admission"] stamp
            _audit.record_decision(
                "demotion" if demoted else "admission", "fit", verdict,
                subject=type(estimator).__name__, reason=reason,
                estimate_bytes=est_obj.total(), budget_bytes=budget, chunk_rows=int(chunk_rows),
            )
            return AdmissionDecision(
                verdict=verdict,
                estimate=est_obj,
                capacity_bytes=capacity,
                budget_bytes=budget,
                chunk_rows=int(chunk_rows),
                reason=reason,
                demoted=demoted,
                reservation=led.reserve(f"fit:{type(estimator).__name__}", "fit", est_obj.total()),
            )

        def _refuse(exc):
            _audit.record_decision(
                "admission", "fit", "refused", subject=type(estimator).__name__, reason=str(exc),
                estimate_bytes=getattr(exc, "estimate_bytes", None), budget_bytes=budget,
            )
            raise exc

        res = resident_estimate(estimator, extracted, n_devices)
        if not force_stream:
            reg.gauge("memory.estimate_bytes", res.total())
            if avail is None or res.total() <= avail:
                return _grant(res, RESIDENT, reason="fits" if budget is not None else "no capacity information")
            reason = f"resident working set {res.total()} bytes/device exceeds the {budget}-byte budget{held_note}"
        else:
            reason = "backend OOM caught; retrying out-of-core"
            live = device_allocatable_bytes(device)
            if live is not None:
                live_avail = int(live * (1.0 - headroom_fraction()))
                avail = live_avail if avail is None else min(avail, live_avail)
                reason += f" (sized against {live} bytes the allocator can hand out)"

        # ---- the streaming side of the ladder ------------------------------
        if not getattr(estimator, "_supports_streaming_fit", False):
            name, nbytes = res.largest()
            _refuse(HbmBudgetError(
                f"{type(estimator).__name__} fit does not fit device memory "
                f"and has no out-of-core streaming path{held_note}",
                estimate_bytes=res.total(),
                capacity_bytes=budget,
                largest_term=name,
                largest_term_bytes=nbytes,
                terms=res.terms,
            ))
        dtype = np.float32 if getattr(estimator, "_float32_inputs", True) else np.float64
        rb = row_bytes(extracted, dtype)
        chunk_rows = _configured_chunk_rows()
        if chunk_rows <= 0:
            if avail is None:
                chunk_rows = DEFAULT_STREAM_CHUNK_ROWS
            else:
                # sized against the floor chunk's workspace (its row-scaling
                # terms grow with the chunk; the check below shrinks back to
                # the floor if the chosen chunk's full estimate overshoots)
                floor_dev = rows_per_device(min(MIN_STREAM_CHUNK_ROWS, max(1, int(extracted.n_rows))), n_devices)
                ws = workspace_estimate(estimator, extracted, n_devices, rows_dev=floor_dev).total()
                room = avail - ws
                # two chunks in flight on the device
                chunk_rows = max(MIN_STREAM_CHUNK_ROWS, (room // (2 * rb)) * n_devices if room > 0 else 0)
        chunk_rows = max(1, min(int(chunk_rows), max(1, int(extracted.n_rows))))

        stream = streaming_estimate(estimator, extracted, n_devices, chunk_rows)
        if avail is not None and stream.total() > avail:
            # shrink before giving up: the chunk size is the only knob the
            # admission owns. The JAX package drops to the floor here, which
            # every estimator with a row-scaling workspace term reaches (its
            # terms at the sized chunk exceed those at the floor the sizing
            # used): KMeans and LogisticRegression at 1M x 3000 would stream
            # 256-row chunks. The port takes the largest chunk that fits (the
            # estimate grows with the chunk, so a bisection finds it).
            floor = min(MIN_STREAM_CHUNK_ROWS, chunk_rows)
            stream_floor = streaming_estimate(estimator, extracted, n_devices, floor)
            if stream_floor.total() > avail:
                name, nbytes = stream_floor.largest()
                _refuse(HbmBudgetError(
                    f"{type(estimator).__name__} fit does not fit device "
                    f"memory even on the out-of-core streaming path{held_note}",
                    estimate_bytes=stream_floor.total(),
                    capacity_bytes=budget,
                    largest_term=name,
                    largest_term_bytes=nbytes,
                    terms=stream_floor.terms,
                ))
            lo, hi = floor, chunk_rows  # estimate(lo) fits, estimate(hi) does not
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if streaming_estimate(estimator, extracted, n_devices, mid).total() <= avail:
                    lo = mid
                else:
                    hi = mid
            chunk_rows, stream = lo, streaming_estimate(estimator, extracted, n_devices, lo)
        reg.gauge("memory.estimate_bytes", stream.total())
        return _grant(stream, STREAM, chunk_rows=chunk_rows, reason=reason, demoted=True)


def rereserve_admission(adm: AdmissionDecision, owner: str = "fit:cache-hit"):
    """The ledger claim of a fit served from the device-dataset scope's
    cache (the placement exists; a cache hit skips `admit_fit`). No budget
    check: the bytes are held already, so they are recorded, and later
    admissions see them."""
    from .scheduler.ledger import global_ledger

    return global_ledger().reserve(owner, "fit", adm.estimate.total())


# ------------------------------------------------------- serving plane ------


def model_serve_estimate(model: Any, bucket_rows_count: int, serve_dtype: Optional[str] = None) -> MemoryEstimate:
    """Per-device working set of a RESIDENT serving model: the placement of
    its state (`_serve_placement_terms`) plus one dispatched bucket's predict
    workspace (`_serve_workspace_terms` at `bucket_rows_count` rows, and
    what serving at `serve_dtype` adds, `_serve_dtype_workspace_terms`)."""
    itemsize = _itemsize_of(model)
    terms: Dict[str, int] = {}
    hook = getattr(model, "_serve_placement_terms", None)
    for name, nbytes in ((hook() if hook is not None else None) or {}).items():
        key = name if name.startswith("placement.") else f"placement.{name}"
        terms[key] = int(nbytes)
    whook = getattr(model, "_serve_workspace_terms", None)
    raw = dict((whook(int(bucket_rows_count), itemsize) if whook is not None else None) or {})
    dhook = getattr(model, "_serve_dtype_workspace_terms", None)
    if dhook is not None and serve_dtype is not None:
        raw.update(dhook(int(bucket_rows_count), itemsize, serve_dtype))
    for name, nbytes in raw.items():
        key = name if name.startswith("workspace.") else f"workspace.{name}"
        terms[key] = int(nbytes)
    return MemoryEstimate(terms)


def admit_model_load(
    model: Any,
    *,
    bucket_rows_count: Optional[int] = None,
    device: Any = None,
    serve_dtype: Optional[str] = None,
    tenant: Optional[str] = None,
) -> AdmissionDecision:
    """Admission verdict for loading a fitted model onto `device` (a torch
    device) in the serving plane: RESIDENT, with its estimate reserved in
    the shared ledger, or a raised `HbmBudgetError` naming the largest
    term. `tenant` names the load in the decision log (the registry passes
    "serving:<name>"; default "serving:<model class>")."""
    from .core import config
    from .ops_plane import audit as _audit
    from .parallel import device_capacity_bytes
    from .scheduler.ledger import global_ledger

    if bucket_rows_count is None:
        bucket_rows_count = int(config.get("serve_max_batch_rows", 8192))
    if tenant is None:
        tenant = f"serving:{type(model).__name__}"
    capacity = device_capacity_bytes(device)
    budget = None if capacity is None else int(capacity * (1.0 - headroom_fraction()))
    led = global_ledger()
    with led.admission():
        held = 0 if budget is None else led.reserved_bytes()
        est = model_serve_estimate(model, bucket_rows_count, serve_dtype)
        if budget is None or est.total() + held <= budget:
            _audit.record_decision(
                "admission", "serving", RESIDENT, subject=type(model).__name__, tenant=tenant,
                estimate_bytes=est.total(), budget_bytes=budget,
            )
            return AdmissionDecision(
                verdict=RESIDENT,
                estimate=est,
                capacity_bytes=capacity,
                budget_bytes=budget,
                reason="fits" if budget is not None else "no capacity information",
                reservation=led.reserve(f"serve:{type(model).__name__}", "serve", est.total()),
            )
        name, nbytes = est.largest()
        _audit.record_decision(
            "admission", "serving", "refused", subject=type(model).__name__, tenant=tenant,
            reason="over budget", estimate_bytes=est.total(), budget_bytes=budget, largest_term=name,
        )
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


def as_hbm_budget_error(exc: BaseException, admission: Optional[AdmissionDecision] = None) -> HbmBudgetError:
    """A caught out-of-memory failure as the typed, permanent
    `HbmBudgetError`. With the `admission` the failed attempt ran under, the
    error carries its estimate and names its largest term (the JAX
    package's carries none: the backend, not the preflight, made the
    call)."""
    msg = f"backend out-of-memory during fit: {exc}"
    if admission is None:
        return HbmBudgetError(msg)
    name, nbytes = admission.estimate.largest()
    return HbmBudgetError(
        msg,
        estimate_bytes=admission.estimate.total(),
        capacity_bytes=admission.budget_bytes,
        largest_term=name,
        largest_term_bytes=nbytes,
        terms=admission.estimate.terms,
    )
