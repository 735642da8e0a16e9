#
# Core execution framework: the estimator and model bases, the fit path
# with its multi-fit half and its multi-process (SPMD) half, batched
# transform, the resident
# predict handle the serving plane keeps per model (`PredictProgram`), and
# persistence. The PyTorch counterpart of the parts of
# spark_rapids_ml_tpu/core.py that the estimators' fits, fitMultiple and
# the tuning layer (tuning.py), their transforms, save/load and the serving
# plane run.
#
# Call stack (the JAX package's, without the per-fit telemetry scope and
# the mesh):
# fit(dataset[, maps]) / fitMultiple -> _fit_internal -> _call_fit_func
# [recoverable_stage(stage="fit"): bounded transient retries over one
# checkpoint store] -> [the OOM ladder] -> _call_fit_func_attempt ->
# [_device_dataset: extract
# columns (data.py), then the memory admission (memory.admit_fit) and,
# RESIDENT, the NaN/Inf scan and the placement of the rows on the device
# (parallel), or, STREAM, a `StreamPlan` and no placement at all; or reuse
# a placement cached by an enclosing `device_dataset_scope` -> an optional
# fold mask (w -> w·mask) -> _dispatch_solves: param sets with one
# `_batch_group_key` solve as one batched grid, the others one by one; a
# streamed fit's one by one] -> _create_model per param map.
#
# Out-of-core fits (the fit half of memory.py): a fit whose resident working
# set exceeds the card's budget demotes to the streaming solvers of
# ops/streaming.py when its estimator has one (KMeans, PCA,
# LinearRegression, LogisticRegression), which read the rows from the host
# in double-buffered chunks; `fit.demotions` counts it and the model's
# `_fit_metrics["admission"]` says why. The OOM ladder: a real allocation
# failure on the card (torch.OutOfMemoryError, or the chaos `oom` fault
# shaped like one) is retried ONCE on the streaming path; a second one, or
# an estimator without a streaming path, raises `HbmBudgetError`. Nothing
# over budget runs on the CPU. Each verdict lands in the decision log
# (ops_plane/audit.py, through memory.py). Inside a fit scheduler job
# (scheduler/queue.py) the job owns the ledger claim: the admission resizes
# it, the fit holds none of its own, and the OOM ladder's streamed retry
# resizes it again.
#
# Recovery (checkpoint.py): the whole fit is ONE recoverable stage. A
# transient failure (`errors.is_transient`: a RendezvousTimeoutError, as the
# chaos `fail:` plans raise it) retries the stage at most
# `config["fit_max_retries"]` times with capped exponential backoff
# (`fit.retries`); every attempt shares one `CheckpointStore`, so with
# `config["checkpoint_every_iters"]` > 0 a solver resumes from its last
# checkpoint (`checkpoint.restores`) and the retained statistics of the
# linear family are reused (`checkpoint.stats_reuses`). The OOM ladder runs
# inside the stage, so its streamed retry resumes a resident fit's KMeans
# checkpoint too. A retry of a multi-process fit begins a new rendezvous
# epoch on every rank. A rank lost mid-fit opens a RECOVERY EPOCH on a
# rendezvous that can reform (FileRendezvous, LocalRendezvous): the
# survivors agree on the live set, the context reopens its process group
# over them (`TpuContext.adopt_reform`), and the stage re-enters with each
# survivor's own rows, the layout agreed again over the survivors (a
# placement cached by a `device_dataset_scope` is laid out again from its
# host blocks: `recovery.replacements`); the solvers resume from the
# portable subset of their checkpoints (the k-means centers, the GLM
# iterate), since the placement key names the membership. At most
# `config["recovery_max_rank_losses"]` losses; past them, or on a substrate
# that cannot reform, the rank loss propagates typed. The dead rank's rows
# are not part of the recovered fit. NearestNeighbors, the ANN, DBSCAN and
# UMAP run their own `_fit_internal` outside the stage, as in the JAX
# package, and propagate a rank loss typed.
#
# Multi-process fits (parallel/context.py): under an entered
# `TpuContext(rank, nranks, rendezvous)` with nranks > 1, each rank passes
# its own row block; the global layout is agreed through the rendezvous
# (`PartitionDescriptor`, `FitInputs.desc`; `n_valid` is the global row
# count), each rank places only its block (CSR rows at the padded-ELL
# width the ranks agree on), and the solvers of the estimators that set
# `_supports_multiprocess` (KMeans, PCA, LinearRegression,
# LogisticRegression, dense or sparse; the forests, which gather their
# class set and sketch and split the trees between the ranks) sum their row
# statistics across ranks through the context's process group
# (`parallel.context.allreduce_fixed`, active for the fit's extent).
# NearestNeighbors, ApproximateNearestNeighbors, DBSCAN and UMAP, whose fits
# touch no rows or run in their own `_fit_internal`, gather and merge in
# their own code. Every other estimator refuses, naming A10. A
# multi-process fit must fit resident (memory.py) and outside the fit
# scheduler (A10f); CrossValidator and TrainValidationSplit run over it
# (tuning.py). Each rank drives one card: num_workers past one over a pool
# of several chips is A10i's second half, refused.
#
# One process driving several chips (parallel/mesh.py's pool; JAX's
# single-controller mesh): a fit with ``n = min(num_workers, chips in the
# pool) > 1`` outside a multi-process context FANS OUT
# (`_call_fit_func_fanned`): the host rows are extracted once and cut into
# `parallel.shard_row_ranges` blocks (views, no padding rows), one
# admission covers the n chips, and each chip runs the multi-process fit
# above on its block in its own thread (`parallel.run_on_chips`: the
# caller's context copied, the chip pinned, a `TpuContext` over the
# in-process `LocalGroup`), with its own checkpoint store and placement
# scope. Every chip's model is the same; rank 0's is returned. The fit's
# retries wrap the whole fan-out (an in-process group is not reformed).
# Transforms of at least ``config["distributed_transform_min_rows"]`` rows
# split their rows over the chips the same way (`_transform_arrays`); the
# kNN and ANN searches and DBSCAN fan out in their own code, and UMAP fits
# once on the first chip (models/umap.py). A chip's allocation failure takes
# the OOM ladder's one streamed retry on the first chip
# (`_fanned_oom_retry`).
#
# Persistence keeps the JAX package's on-disk layout exactly:
# metadata.json + arrays.npz + attributes.json, so a directory saved by
# either package loads in the other; `load_instance` dispatches on the
# class a directory names (either package's), `CompositeWriter` saves the
# models made of models (CrossValidatorModel, PipelineModel).
#
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import logging
import os
import shutil
import threading
from abc import abstractmethod
from collections import OrderedDict, namedtuple
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .data import ExtractedData, as_dense, as_pandas, extract_dataset
from .linalg import DenseVector
from .params import Param, _TpuParams

_LOG = logging.getLogger(__name__)


def _env_float(name: str, default: float) -> float:
    """A float from the environment; unset or malformed gives `default`."""
    try:
        return float(os.environ.get(name) or default)
    except ValueError:
        return default


# Framework configuration: the keys this package reads (the JAX package's
# `config` holds many more; they arrive with the layers that read them).
config: Dict[str, Any] = {
    # rows per transform batch copied to the device at once
    "max_records_per_batch": 1 << 16,
    # a transform of at least this many rows is split over the chips of the
    # device pool (`parallel.shard_row_slices`, one block a chip, the outputs
    # back in row order) when the model's num_workers spans more than one;
    # smaller ones run on one chip
    "distributed_transform_min_rows": 1 << 15,
    # rows per tile of the predict-side argmin scan (ops/distance.py)
    "distance_tile_rows": 4096,
    # default precision of the solvers' hot products: "f32" keeps the input
    # precision, "bf16" runs bf16 inputs with float32 accumulation; the
    # per-estimator `solver_precision` solver param overrides it.
    # Seeded from SRML_SOLVER_PRECISION.
    "solver_precision": os.environ.get("SRML_SOLVER_PRECISION") or "f32",
    # --- memory admission (memory.py) -------------------------------------
    # per-device memory override for the admission budgeter; None = the
    # card's total memory (a CPU device has none: loads go unbudgeted)
    "hbm_budget_bytes": None,
    # fraction of the capacity kept out of the budget, for allocator
    # fragmentation and transient buffers: budget = capacity * (1 - this)
    "hbm_headroom_fraction": 0.1,
    # rows per out-of-core streaming chunk (the double-buffered host-to-card
    # pipeline's unit). 0 = auto: sized so two chunks in flight plus the
    # solver workspace fit the budget (floor 256 rows; 65536 when no
    # capacity bounds it)
    "stream_chunk_rows": 0,
    # --- ingest (data.py) ---------------------------------------------------
    # opt-in NaN/Inf scan of the ingested columns (IngestValidationError
    # names the column and the first bad row)
    "validate_ingest": False,
    # bytes per chunk of the ingest conversion and of the NaN/Inf scan
    "ingest_chunk_bytes": 128 << 20,
    # smallest rung of the bucket ladder: serving and transform batches pad
    # up a geometric (x2) ladder of row counts starting here
    "transform_bucket_min_rows": 256,
    # --- serving plane (serving/) -------------------------------------------
    # how long the ScoringEngine holds a dispatched request open for
    # same-model coalescing: the latency/throughput knob; 0 disables
    # coalescing entirely
    "serve_coalesce_window_ms": 2.0,
    # row cap of one coalesced serving batch (and of a resident model's
    # bucket ladder); larger requests split across dispatches
    "serve_max_batch_rows": 8192,
    # load-time prewarm: every ladder rung up to this many rows is dispatched
    # once at load (state placed, every kernel built and launched), so a
    # resident model's first query pays neither; 0 disables prewarm
    "serve_prewarm_rows": 4096,
    # server-side deadline of every submit() that passes none: an expired
    # request never dispatches (RequestTimeoutError), and admission refuses a
    # request whose deadline the live queue-wait p99 predicts unmeetable
    # (ServeOverloadError). Monotonic clock. 0 disables the default deadline.
    "serve_default_deadline_ms": 30000.0,
    # bounded request queue: total rows queued in the ScoringEngine at most
    "serve_max_queue_rows": 262144,
    # adaptive micro-batching: under congestion (queue-wait p99 above the
    # static window) the coalesce window and row target follow the arrival
    # rate, between the floor and the ceiling; uncongested traffic keeps the
    # static window exactly
    "serve_adaptive_batching": True,
    "serve_coalesce_window_floor_ms": 0.5,
    "serve_coalesce_window_ceiling_ms": 20.0,
    # backpressure ladder hysteresis (serving/overload.py): the least dwell
    # (seconds) between two of a tenant's ladder transitions (throttle ->
    # degrade -> shed and every restore step), so a flapping burn cannot
    # flap the ladder
    "serve_overload_hold_s": 30.0,
    # the throttle rung's per-tenant token-bucket rate, rows/second; 0 =
    # auto (half the tenant's recent admitted row rate)
    "serve_throttle_rows_per_s": 0.0,
    # the degraded serving rung: a serve dtype (e.g. "bf16") the registry
    # builds as a SECOND resident program (its bytes admitted against the
    # budget) for models whose `_serve_dtypes` allow it; the ladder routes a
    # burning tenant's traffic there before shedding. None: no rung (the
    # ladder's degrade level then serves the primary program)
    "serve_degraded_dtype": None,
    # rolling-window geometry of the telemetry registry: every counter gets
    # rate() and every histogram window_quantile() over the most recent
    # bucket_seconds x bucket_count (default 10 s x 18 = 3 min). Bound when
    # a ring is first written: change it before recording, or call
    # telemetry.registry().reset()
    "metrics_bucket_seconds": 10.0,
    "metrics_bucket_count": 18,
    # declarative SLO specs evaluated by multi-window burn rate
    # (ops_plane/slo.py): a list of dicts naming a latency histogram, an
    # error-rate counter pair or a gauge ceiling, with thresholds. A latency
    # spec over a serve.* histogram drives the backpressure ladder. None or
    # [] disables the monitors
    "slo": None,
    # directory of the rotating ops-plane snapshots (`ops_snapshot.json` and
    # bounded .1/.2/... generations, ops_plane/export.write_snapshot);
    # seeded from SRML_OPS_SNAPSHOT_DIR. None: no files
    "ops_snapshot_dir": os.environ.get("SRML_OPS_SNAPSHOT_DIR") or None,
    # hold (ms) above which the SRML_LOCKCHECK=1 sanitizer
    # (utils/lockcheck.py) records a `lockcheck.long_hold` violation; seeded
    # from SRML_LOCKCHECK_LONG_HOLD_MS (a malformed value keeps 500)
    "lockcheck_long_hold_ms": _env_float("SRML_LOCKCHECK_LONG_HOLD_MS", 500.0),
    # --- multi-process control plane (parallel/context.py) ------------------
    # per-round rendezvous deadline, and the process group's collective
    # timeout: a round with ranks still missing raises RendezvousTimeoutError
    # (transient, retryable) when it elapses
    "rendezvous_timeout_s": 300.0,
    # liveness-file cadence of FileRendezvous; a peer whose heartbeat goes
    # stale by 1.5x this raises RankFailedError on the others, so a killed
    # rank surfaces within 2x the interval instead of the round deadline
    "heartbeat_interval_s": 5.0,
    # bound of the success-path TpuContext teardown barrier: a peer that
    # already exited must not hang teardown (a timeout there only logs)
    "teardown_timeout_s": 15.0,
    # bytes per round of `parallel.context.allgather_ndarray`
    "broadcast_chunk_bytes": 8 << 30,
    # the address rank 0 advertises for the process group's store; ranks on
    # other hosts must reach rank 0 by it. None: the loopback address (all
    # ranks on one host)
    "coordinator_host": None,
    # --- recovery (checkpoint.py, retryable_stage) -------------------------
    # transient-failure retries of one fit stage (errors.is_transient), with
    # exponential backoff from fit_retry_backoff_s capped at
    # fit_retry_backoff_max_s (seconds)
    "fit_max_retries": 2,
    "fit_retry_backoff_s": 0.5,
    "fit_retry_backoff_max_s": 30.0,
    # solver-checkpoint cadence in inner iterations (0 = off: no checkpoint
    # and no host read is added to a fit)
    "checkpoint_every_iters": 0,
    # rank losses one fit may absorb through recovery epochs (the survivors
    # reform, reopen the process group and resume from the checkpoint
    # store) before the typed RankFailedError propagates
    "recovery_max_rank_losses": 1,
    # the least time a reform round's membership window stays open, so a
    # rank respawned promptly after a kill can rejoin at the epoch boundary
    # (0: close once every known-live rank has voted)
    "recovery_rejoin_grace_s": 0.0,
    # resumes of a CrossValidator/TrainValidationSplit sweep after a failure
    # mid-flight; its completion ledger (tuning.SweepLedger) keeps every
    # finished (fold, paramMap) fit from being redone
    "sweep_max_resumes": 1,
    # --- multi-fit engine -------------------------------------------------
    # placements (rows on the device + the host blocks they came from) a
    # device_dataset_scope keeps at once; the least recently used go beyond
    # this, so a scope around a loop over FRESH dataset objects cannot stack
    # placements until the card runs out of memory
    "device_dataset_cache_entries": 2,
    # --- multi-tenant fit scheduler (scheduler/queue.py) ------------------
    # preemptions one job may absorb before the scheduler demotes it to the
    # out-of-core streaming path (a floor-chunk footprint that packs into
    # almost any budget: degraded-mode service instead of starvation);
    # estimators without a streaming path become non-preemptible instead
    "sched_max_preemptions": 2,
    # co-admitted jobs running concurrently at most, however many bin-pack
    # into the ledger: the number of a scheduler's worker threads, started
    # when it is built, and a bound on the per-job pressure on the card (a
    # fairness and safety knob)
    "sched_max_concurrent": 4,
    # the 2-D book: scheduler claims name WHICH chips of the pool a job
    # holds (contiguous first-fit runs of its width) and each job runs
    # pinned to them (`parallel.chip_scope`); off, claims are bytes only
    "sched_chip_placement": False,
}


def resolve_solver_precision(params: Optional[Dict[str, Any]] = None) -> str:
    """Effective solver precision for ONE fit: the estimator's
    ``solver_precision`` solver-param when set (per-estimator override),
    else ``config["solver_precision"]``. Returns "f32" or "bf16"; anything
    else raises ValueError naming the knob."""
    value = params.get("solver_precision") if params else None
    if value is None:
        value = config.get("solver_precision") or "f32"
    value = str(value).lower()
    if value not in ("f32", "bf16"):
        raise ValueError(
            f"solver_precision must be 'f32' or 'bf16', got {value!r}"
        )
    return value


def evaluator_label_column(params_obj: Any, evaluator: Any) -> str:
    """The label column an evaluator scores against: its own ``labelCol``
    when it defines one, else the estimator's or model's. The one
    resolution the fused transform-evaluate paths and the tuning layer's
    held-out scoring share."""
    if hasattr(evaluator, "hasParam") and evaluator.hasParam("labelCol"):
        return evaluator.getOrDefault("labelCol")
    return params_obj.getOrDefault("labelCol")


def retryable_stage(
    fn: Callable[[int], Any], *, stage: str, rendezvous: Any = None, max_retries: Optional[int] = None
) -> Any:
    """Run ``fn(attempt)`` with bounded retries on TRANSIENT failures
    (`errors.is_transient`); a permanent one (RankFailedError,
    SolverDivergedError, HbmBudgetError, a user error) propagates at once,
    as does a scheduler's `PreemptedError` (its job runner requeues the
    job; a retry here would re-enter the solve whose claim is being
    freed).

    Before each retry: exponential backoff from
    ``config["fit_retry_backoff_s"]`` (attempt N sleeps base * 2^(N-1),
    capped at ``config["fit_retry_backoff_max_s"]``), and the
    ``fit.retries`` counter ticks. The chaos hook
    (`parallel.chaos.maybe_fail_stage`) runs at the top of every attempt.
    A `checkpoint.CheckpointStore` is active for all attempts (adopting
    the enclosing `recoverable_stage`'s when there is one), so solvers that
    checkpoint resume a retry from their last checkpoint. With a
    `rendezvous` (a multi-process fit), `rendezvous.begin_epoch(attempt)`
    re-namespaces the control plane before each retry, so it never reads
    the failed attempt's rounds."""
    import time

    from . import checkpoint as _checkpoint
    from . import telemetry
    from .errors import is_transient
    from .parallel import chaos

    if max_retries is None:
        max_retries = int(config.get("fit_max_retries", 2))
    backoff_s = float(config.get("fit_retry_backoff_s", 0.5))
    backoff_max_s = float(config.get("fit_retry_backoff_max_s", 30.0))
    with _checkpoint.ensure_scope():
        for attempt in range(max_retries + 1):
            try:
                chaos.maybe_fail_stage(stage, attempt)
                return fn(attempt)
            except Exception as e:
                if not is_transient(e) or attempt >= max_retries:
                    raise
                telemetry.registry().inc("fit.retries")
                # the flight-recorder event (`retry`) arrives with A15
                sleep_s = min(backoff_s * (2 ** attempt), backoff_max_s)
                _LOG.warning(
                    "stage %s attempt %d/%d failed transiently (%s: %s); retrying in %.2fs",
                    stage, attempt + 1, max_retries + 1, type(e).__name__, e, sleep_s,
                )
                time.sleep(sleep_s)  # the capped retry backoff
                if rendezvous is not None:
                    rendezvous.begin_epoch(attempt + 1)
    raise AssertionError("unreachable")  # pragma: no cover


def recoverable_stage(
    fn: Callable[[int], Any],
    *,
    stage: str,
    ctx: Any = None,
    rendezvous: Any = None,
    on_recover: Optional[Callable[[Any, int, set], None]] = None,
) -> Any:
    """The elastic outer layer over `retryable_stage`: transient failures
    retry as there (a multi-process fit's in a new epoch of the
    rendezvous), inside one checkpoint store that the stage owns. A
    `RankFailedError`, or a `RendezvousTimeoutError` naming missing ranks
    that outlived the retries, opens a RECOVERY EPOCH when the rendezvous
    can reform: the survivors agree on the live set (`rendezvous.reform`,
    which also admits a respawned rank rejoining at the boundary), the
    context adopts it (`ctx.adopt_reform`: the renumbered rank and size and
    a new process group), and the stage re-enters, its solvers resuming
    from the store. The dead hint comes only from a `failed_rank` within
    the membership: a closed connection (rank -1) or a timeout seeds none,
    and the reform round's own evidence decides, so a merely slow rank that
    votes is re-admitted. At most ``config["recovery_max_rank_losses"]``
    ranks are lost so; past it, or on a substrate that cannot reform, the
    error propagates stamped with ``recovery_exhausted`` (whether an epoch
    was opened) and ``recovery_generations``. A timeout that names no
    missing ranks (a desync, a chaos `fail`) is retryable_stage's alone and
    re-raises. `on_recover(new_rendezvous, generation, dead_original_ranks)`
    lets a caller without a context swap its rendezvous handle. Counted:
    ``fit.recoveries``, ``recovery.epochs``, ``recovery.rank_losses``."""
    from . import checkpoint as _checkpoint
    from . import telemetry
    from .errors import RankFailedError, RendezvousTimeoutError

    if rendezvous is None and ctx is not None:
        rendezvous = getattr(ctx, "rendezvous", None)
    max_rank_losses = int(config.get("recovery_max_rank_losses", 1))
    losses = 0
    with _checkpoint.ensure_scope():
        while True:  # every epoch charges the budget of losses; exhausting it raises
            try:
                return retryable_stage(fn, stage=stage, rendezvous=rendezvous)
            except (RankFailedError, RendezvousTimeoutError) as e:
                if isinstance(e, RendezvousTimeoutError) and not getattr(e, "missing_ranks", None):
                    # no liveness evidence to reform around (a desync, a chaos
                    # `fail` injection): retryable_stage's, and it ran out
                    raise
                if rendezvous is None or not getattr(rendezvous, "can_reform", False) or losses >= max_rank_losses:
                    e.recovery_exhausted = losses > 0
                    e.recovery_generations = losses
                    raise
                live = list(getattr(rendezvous, "live_ranks", range(rendezvous.nranks)))
                dead = set()
                failed_rank = getattr(e, "failed_rank", None)
                if isinstance(e, RankFailedError) and failed_rank is not None and 0 <= failed_rank < len(live):
                    dead.add(live[failed_rank])
                generation = int(getattr(rendezvous, "reform_generation", 0)) + 1
                reg = telemetry.registry()
                reg.inc("fit.recoveries")
                reg.inc("recovery.epochs")
                # the flight-recorder events (`recovery_epoch_begin`,
                # `recovery_epoch`) and the ring's dump arrive with A15
                _LOG.warning(
                    "stage %s: rank failure (%s); entering recovery epoch %d over the survivors",
                    stage, e, generation,
                )
                new_rdv = rendezvous.reform(dead_ranks=dead, generation=generation)
                lost = max(1, len(live) - len(getattr(new_rdv, "live_ranks", range(new_rdv.nranks))))
                losses += lost
                reg.inc("recovery.rank_losses", lost)
                if ctx is not None and hasattr(ctx, "adopt_reform"):
                    ctx.adopt_reform(new_rdv)
                if on_recover is not None:
                    on_recover(new_rdv, generation, dead)
                rendezvous = new_rdv


# Internal column aliases (reference core.py:333): `row_number` names the id
# column kNN adds when the caller set no idCol.
alias = namedtuple("alias", ("row_number",))("unique_id")


@dataclass
class StreamPlan:
    """The out-of-core plan of a demoted fit (`FitInputs.stream`): the
    host-retained extracted blocks and the ADMITTED chunk size. The
    streaming solvers (ops/streaming.py) cut row chunks from `extracted`,
    scan each for NaN/Inf when ``config["validate_ingest"]`` asked for it,
    and feed them through the double-buffered pipeline
    (parallel.stream_place_blocks). Mutable bookkeeping: `validated_rows`
    (the scan's watermark: later passes over scanned rows are free) and
    `staging` (the pipeline's two pinned host buffers and two device
    buffers per column, reused by every pass of the fit) and, for CSR
    input, the padded-ELL host blocks."""

    extracted: Any  # host ExtractedData
    chunk_rows: int
    validate: bool = False
    validated_rows: int = 0
    staging: Any = None  # parallel.StreamStaging
    # a CSR fit's padded-ELL host blocks, converted once per fit at the
    # global k_max (ops/streaming._ell_host_blocks)
    ell_blocks: Any = None
    ell_k_max: int = 0


@dataclass
class FitInputs:
    """Inputs handed to every algorithm's fit function: the rows as one
    tensor on one device, their weights, and their labels for a supervised
    estimator. A streamed (demoted) fit places nothing: X is None, w and y
    are host arrays and `stream` carries the plan the streaming solvers
    read. In a multi-process fit X, w and y are this rank's block, `n_valid`
    is the GLOBAL row count (the sum over ranks), `desc` the agreed layout
    and `ctx` the TpuContext the fit runs under."""

    X: Optional[torch.Tensor]  # [n, d]; None when streamed
    w: Any  # [n] tensor on the device; a host array when streamed
    n_valid: int  # GLOBAL valid rows (the sum over ranks in a multi-process fit)
    n_cols: int
    dtype: Any  # numpy dtype of X
    device: torch.device
    y: Any = None  # [n] at X's dtype (host when streamed); None = unsupervised
    # host boolean row mask of the rows this fit trains on (None = all); set
    # by `with_row_mask`. Fit functions that derive host statistics from the
    # raw columns (a classifier's class set) must respect it.
    host_mask: Optional[np.ndarray] = None
    # the out-of-core plan of a demoted fit (None = resident)
    stream: Optional[StreamPlan] = None
    # the host CSR rows of a sparse fit (X is None then); the solvers read
    # them through `ell_rows` and `ell_columns`
    X_sparse: Any = None
    # per-placement memos shared by every fold variant (`with_row_mask`
    # copies the reference): the ELL tensors and their column grouping
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # the multi-process fit's TpuContext and agreed row layout
    # (parallel.PartitionDescriptor); None on one process
    ctx: Any = None
    desc: Any = None

    @property
    def spmd(self) -> bool:
        return self.ctx is not None and self.ctx.is_spmd

    def allgather_host(self, payload: str) -> List[str]:
        """Control-plane allgather of a small string across ranks (host
        statistics: class sets); `[payload]` on one process."""
        if self.spmd:
            return self.ctx.rendezvous.allgather(payload)
        return [payload]

    def allgather_array(self, arr: np.ndarray) -> np.ndarray:
        """Every rank's host block of `arr` (the same trailing shape and
        dtype on every rank), concatenated in rank order along axis 0 (the
        KMeans init sample); `arr` on one process. It travels through the
        context's process group (host memory under gloo, the card under
        NCCL), or through the rendezvous when the context has no group."""
        if not self.spmd:
            return arr
        arr = np.ascontiguousarray(arr)
        group = self.ctx.group
        if group is None:
            from .parallel.context import allgather_ndarray

            return np.concatenate(allgather_ndarray(self.ctx.rendezvous, arr), axis=0)
        return np.concatenate(group.allgather_arrays(arr), axis=0)

    def ell_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The padded-ELL form of `X_sparse` on the device, (values [n,
        k_max] at the fit's dtype, indices [n, k_max] int32), converted on
        the host (ops/sparse.csr_to_ell, timed as
        host_section.ell_convert_s) and placed (device_wait.ell_layout_s)
        ONCE per placement: a grid or a CrossValidator over CSR data
        converts once, whatever its folds and solves. In a multi-process fit
        k_max is the widest row of every rank."""
        cached = self.extra.get("ell_rows")
        if cached is not None:
            return cached
        from . import telemetry
        from .memory import ell_k_max
        from .ops.sparse import csr_to_ell
        from .parallel import host_tensor

        assert self.X_sparse is not None, "ell_rows() needs a sparse fit input"
        # a multi-process fit pads every rank's rows to the widest row of
        # any rank, agreed in one control-plane round, as the JAX package does
        k_max = max(int(g) for g in self.allgather_host(str(ell_k_max(self.X_sparse))))
        with telemetry.host_section("ell_convert"):
            idx_h, val_h, _ = csr_to_ell(self.X_sparse, k_max=k_max, dtype=self.dtype)
        with telemetry.device_wait("ell_layout", self.device):
            out = (host_tensor(val_h).to(self.device), host_tensor(idx_h).to(self.device))
        self.extra["ell_rows"] = out
        return out

    def ell_columns(self):
        """The column grouping of `ell_rows` (ops/sparse.EllColumns) for the
        per-column sums of the logistic solver, made once per placement."""
        cached = self.extra.get("ell_columns")
        if cached is None:
            from .ops.sparse import EllColumns

            values, indices = self.ell_rows()
            cached = self.extra["ell_columns"] = EllColumns(values, indices, int(self.n_cols))
        return cached

    def with_row_mask(self, mask: np.ndarray) -> "FitInputs":
        """These inputs with the rows where ``mask == 0`` neutralized:
        ``w -> w · mask`` (on the device, or on the host for a streamed
        fit). The solvers treat ``w == 0`` rows as absent, so a masked fit
        over the whole dataset is the fit over the mask's rows: this is how
        CrossValidator realizes a fold without another ingest or placement.
        X and y are shared untouched. In a multi-process fit the mask names
        THIS rank's rows (`n_valid` is the global count)."""
        from .parallel import host_tensor

        m = np.ascontiguousarray(np.asarray(mask), dtype=self.dtype)
        if self.spmd:
            local = self.desc.rows_of(self.ctx.rank)
            if m.shape[0] != local:
                raise ValueError(f"row mask has {m.shape[0]} entries for this rank's {local} rows")
        elif m.shape[0] != self.n_valid:
            raise ValueError(f"row mask has {m.shape[0]} entries for {self.n_valid} rows")
        if self.stream is not None:
            w_masked = np.asarray(self.w) * m
        else:
            w_masked = self.w * host_tensor(m).to(self.device)
        return dataclasses.replace(self, w=w_masked, host_mask=m > 0)


@dataclass
class DeviceDataset:
    """A dataset after ingest and placement, reusable across fits. `key`
    is the cache key (`_TpuCaller._device_dataset_key`); `extracted` keeps
    the host blocks; `source` pins the ORIGINAL dataset object for the
    entry's lifetime: the key is `id()`-based, and without a strong
    reference CPython could give a collected dataset's id to a new object
    of the same shape, a silent false hit training on the wrong data."""

    key: Optional[tuple]
    extracted: ExtractedData
    inputs: FitInputs
    source: Any = None
    # the memory.AdmissionDecision that admitted the placement (a cache hit
    # re-stamps it and re-reserves its bytes)
    admission: Any = None


class DeviceDatasetScope:
    """The cache of one `device_dataset_scope`: placements keyed by
    `_device_dataset_key`, least recently used first. `last` is the
    placement most recently built or reused: the tuning layer scores
    held-out rows from it."""

    __slots__ = ("cache", "lock", "last", "fanout", "chip_scopes")

    def __init__(self) -> None:
        self.cache: "OrderedDict[tuple, DeviceDataset]" = OrderedDict()  # guarded-by: lock
        self.lock = threading.Lock()
        self.last: Optional[DeviceDataset] = None
        # a fit fanned out over the device pool: the extracted host rows and
        # their per-chip blocks by (dataset identity, chip ids), least
        # recently used first, and each chip's own scope (its placement of
        # its block) by (that key, rank), dropped with its layout
        self.fanout: "OrderedDict[tuple, FanOutLayout]" = OrderedDict()  # guarded-by: lock
        self.chip_scopes: Dict[tuple, "DeviceDatasetScope"] = {}  # guarded-by: lock


# Context-local, not process-global: scopes on different threads neither
# share a cache nor clobber each other's enter/exit bookkeeping. Threads
# spawned inside a scope start from a fresh context and do not see it.
_DDS_SCOPE: "contextvars.ContextVar[Optional[DeviceDatasetScope]]" = contextvars.ContextVar(
    "srml_torch_device_dataset_scope", default=None
)


@contextlib.contextmanager
def device_dataset_scope() -> Iterator[DeviceDatasetScope]:
    """Placement reuse for the dynamic extent of the scope.

    >>> with core.device_dataset_scope():
    ...     est.fit(df)            # ingest + placement + solve
    ...     est.copy(pm).fit(df)   # the SAME placement, one more solve

    Nested scopes share the outermost cache, whose exit drops it (releasing
    the device tensors). The key is the dataset object's identity, never a
    hash of its data, so mutating one dataset object in place between fits
    inside one scope is not detected: pass a new object instead."""
    outer = _DDS_SCOPE.get()
    scope = outer if outer is not None else DeviceDatasetScope()
    token = _DDS_SCOPE.set(scope)
    try:
        yield scope
    finally:
        _DDS_SCOPE.reset(token)
        if outer is None:
            with scope.lock:
                scope.cache.clear()
                scope.fanout.clear()
                chips, scope.chip_scopes = list(scope.chip_scopes.values()), {}
            for c in chips:
                with c.lock:
                    c.cache.clear()


def _drop_chip_scopes(scope: DeviceDatasetScope, key: tuple) -> None:
    """Drop the per-chip scopes of the fan-out layout `key` (the caller
    holds ``scope.lock``), their placements with them; other datasets'
    placements on the same chips stay."""
    for ck in [ck for ck in scope.chip_scopes if ck[0] == key]:
        dropped = scope.chip_scopes.pop(ck)
        with dropped.lock:
            dropped.cache.clear()
            dropped.last = None


@dataclass
class FanOutLayout:
    """A dataset laid out over the chips of one fan-out: the extracted host
    rows (once), their blocks (`parallel.shard_row_ranges`, views; empty
    blocks dropped) and the row range of each, and `source`, the dataset
    object whose id() keys the entry."""

    extracted: ExtractedData
    blocks: List[ExtractedData]
    ranges: List[Tuple[int, int]]
    source: Any = None


@dataclass
class _FanOutChip:
    """What a chip's thread of a fanned-out fit reads from its caller: the
    fit stage's attempt (the chaos hooks' index) and the one admission the
    caller made for every chip (no ledger claim of its own)."""

    attempt: int
    admission: Any
    # host seconds this chip spent laying out its block (`_layout`)
    layout_s: float = 0.0


# set in each chip's thread of a fanned-out fit, for the extent of its fit
_FANOUT_CHIP: "contextvars.ContextVar[Optional[_FanOutChip]]" = contextvars.ContextVar(
    "srml_torch_fanout_chip", default=None
)


def _attrs_digest(rows: List[Dict[str, Any]]) -> str:
    """A digest of fitted model attributes (every array's dtype, shape and
    bytes, every other value's repr): equal digests for models equal bit
    for bit."""
    import hashlib

    h = hashlib.sha256()

    def feed(v: Any) -> None:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            h.update(f"{v.dtype}{v.shape}".encode())
            h.update(np.ascontiguousarray(v).tobytes())
        elif isinstance(v, dict):
            for k in sorted(v, key=str):
                h.update(str(k).encode())
                feed(v[k])
        elif isinstance(v, (list, tuple)):
            h.update(f"{type(v).__name__}{len(v)}".encode())
            for x in v:
                feed(x)
        else:
            h.update(repr(v).encode())

    feed(list(rows))
    return h.hexdigest()


FitFunc = Callable[[FitInputs, Dict[str, Any]], Dict[str, Any]]
# (construct() -> device state, predict(state, device batch) -> device
# tensor, or a tuple of them)
TransformFuncs = Tuple[Callable[[], Any], Callable[[Any, torch.Tensor], Any]]


class _TpuCommon(_TpuParams):
    """Input pre-processing shared by estimators (fit side) and models
    (transform side)."""

    # a supervised estimator's fit reads its labelCol
    _supervised: bool = False
    # estimators with a CSR path (the padded-ELL solvers, the sparse kNN)
    # keep sparse input as CSR; the others densify it at extraction
    _supports_sparse_input: bool = False

    def _sparse_mode(self) -> Optional[bool]:
        """The `enable_sparse_data_optim` the extraction runs with: the
        param where there is one, and False (densify) where it is unset and
        this class has no CSR path."""
        mode = self.getOrDefault("enable_sparse_data_optim") if self.hasParam("enable_sparse_data_optim") else None
        if mode is None and not self._supports_sparse_input:
            return False
        return mode

    def _pre_process_data(
        self, dataset: Any, for_fit: bool = True, defer_validation: bool = False
    ) -> ExtractedData:
        """Column selection + dense or CSR extraction (features; labels and
        weights on the fit side; row ids wherever the estimator has an
        idCol). ``defer_validation`` leaves the opt-in NaN/Inf scan to the
        caller (core.py's fit path)."""
        input_col, input_cols = self._get_input_columns()
        label_col = None
        if for_fit and self._supervised:
            label_col = self.getOrDefault("labelCol")
        weight_col = None
        if (
            for_fit
            and self.hasParam("weightCol")
            and self.isDefined("weightCol")
        ):
            weight_col = self.getOrDefault("weightCol")
        id_col = None
        if self.hasParam("idCol") and self.isDefined("idCol"):
            id_col = self.getOrDefault("idCol")
        extracted = extract_dataset(
            dataset,
            input_col=input_col,
            input_cols=input_cols,
            label_col=label_col,
            weight_col=weight_col,
            id_col=id_col,
            float32_inputs=self._float32_inputs,
            enable_sparse_data_optim=self._sparse_mode(),
            validate=not defer_validation,
        )
        if for_fit and extracted.n_rows == 0:
            raise RuntimeError("Dataset is empty — cannot fit")
        return extracted


class _TpuCaller(_TpuCommon):
    """Fit orchestration: extraction, admission, placement, one solver
    call."""

    # portable warm-start payload for the NEXT fit call (set by
    # _TpuEstimator.fit(..., warm_start_from=...), consumed by the
    # per-estimator fit closures, cleared in fit's finally)
    _warm_start: Any = None

    # estimators whose solvers accumulate over row chunks (KMeans, PCA,
    # LinearRegression, LogisticRegression) set this: an over-budget fit
    # demotes to ops/streaming.py; for the rest it raises HbmBudgetError
    _supports_streaming_fit: bool = False

    # estimators whose solvers sum their row statistics across ranks set
    # this: under a multi-process TpuContext the others refuse (A10)
    _supports_multiprocess: bool = False

    # the memory.AdmissionDecision of the latest fit attempt (stamped onto
    # model._fit_metrics by _call_fit_func)
    _last_admission: Any = None

    # this fit's live claim in the shared ledger (scheduler/ledger.py): one
    # reservation from admission to the end of the fit, swapped on the OOM
    # retry's re-admission and released in _call_fit_func's finally. None
    # inside a scheduler job, whose claim the admission resizes instead
    _fit_reservation: Any = None

    def _adopt_reservation(self, reservation: Any) -> None:
        """Swap this fit's ledger claim: release the previous one
        (idempotent) and hold the new. Decisions hand their reservation over
        here, so the decisions cached on DeviceDatasets never carry a live
        claim."""
        from .scheduler.ledger import global_ledger

        old = self._fit_reservation
        if old is not None:
            global_ledger().release(old)
        self._fit_reservation = reservation

    def _solver_workspace_terms(
        self, rows_per_device: int, n_cols: int, params: Dict[str, Any], itemsize: int
    ) -> Dict[str, int]:
        """Per-solver device workspace hook of the admission budgeter
        (memory.py): named byte terms BEYOND the placement of the rows, at
        `rows_per_device` rows (the whole dataset resident, one chunk
        streamed). {} (the default) = no modeled workspace."""
        return {}

    def _build_fit_inputs(self, extracted: ExtractedData, device: torch.device, ctx: Any = None) -> FitInputs:
        """Place the host rows, their weights and their labels on `device` as
        one tensor each; CSR rows are placed in their padded-ELL form when a
        solver first asks (`FitInputs.ell_rows`). In a multi-process fit
        (`ctx`) `extracted` is this rank's block: the global layout is agreed
        through the rendezvous first (one round), and the rank places its
        block alone. No padding to a common local size: no program here
        needs equal blocks."""
        from .parallel import PartitionDescriptor, host_tensor, place_rows

        if ctx is not None:
            desc = PartitionDescriptor.build(
                [extracted.n_rows], extracted.n_cols, rank=ctx.rank, rendezvous=ctx.rendezvous
            )
            return dataclasses.replace(
                self._build_fit_inputs(extracted, device), n_valid=desc.m, ctx=ctx, desc=desc
            )
        dtype = np.float32 if self._float32_inputs else np.float64
        y = None
        if extracted.label is not None:
            y = host_tensor(extracted.label.astype(dtype, copy=False)).to(device)
        if extracted.is_sparse:
            # the CSR rows stay on the host until a solver asks for their
            # padded-ELL form (FitInputs.ell_rows)
            n = extracted.n_rows
            w_np = np.ones(n, dtype=dtype) if extracted.weight is None else np.asarray(extracted.weight, dtype=dtype)
            return FitInputs(
                X=None, w=host_tensor(w_np).to(device), n_valid=n, n_cols=extracted.n_cols,
                dtype=dtype, device=device, y=y, X_sparse=extracted.features,
            )
        X, w = place_rows(
            extracted.features.astype(dtype, copy=False), extracted.weight, device=device
        )
        return FitInputs(
            X=X, w=w, n_valid=extracted.n_rows, n_cols=extracted.n_cols,
            dtype=dtype, device=device, y=y,
        )

    @abstractmethod
    def _get_tpu_fit_func(self, extracted: ExtractedData) -> FitFunc:
        """Per-algorithm fit closure factory."""
        raise NotImplementedError

    def _get_tpu_batched_fit_func(self, extracted: ExtractedData):
        """Per-algorithm factory of the batched grid fit: a function
        (inputs, [solver param sets]) -> [attrs], or None when this
        estimator never batches (the default: sequential solves)."""
        return None

    def _batch_group_key(self, sp: Dict[str, Any]):
        """Hashable signature of everything in a solver param set that
        changes the solve's structure: param sets with equal keys solve as
        one batched grid over the rest. None = this estimator never
        batches."""
        return None

    def _ingest(self, dataset: Any) -> ExtractedData:
        """The fit-side column extraction, timed as host_section.ingest_s
        and counted (ingest.datasets, ingest.rows). The NaN/Inf scan is left
        to `_admit_and_layout`."""
        from . import telemetry

        if isinstance(dataset, ExtractedData):
            return dataset  # a chip's block: its caller ingested (and counted) it
        with telemetry.host_section("ingest"):
            extracted = self._pre_process_data(dataset, defer_validation=True)
        reg = telemetry.registry()
        reg.inc("ingest.datasets")
        reg.inc("ingest.rows", extracted.n_rows)
        return extracted

    def _layout(self, extracted: ExtractedData, device: torch.device, ctx: Any = None) -> FitInputs:
        """The placement of the host blocks on `device`, timed as
        device_wait.layout_s."""
        import time

        from . import telemetry

        t0 = time.perf_counter()
        with telemetry.device_wait("layout", device):
            out = self._build_fit_inputs(extracted, device, ctx)
        fan = _FANOUT_CHIP.get()
        if fan is not None:
            fan.layout_s += time.perf_counter() - t0
        return out

    def _device_dataset_key(self, dataset: Any, device: torch.device, ctx: Any = None) -> tuple:
        """(dataset identity fingerprint, columns, (dtype, sparse mode),
        device): what must match for a cached placement to serve this
        fit. In a multi-process fit the last part also names the group's
        membership (the original ranks of the live set), as the JAX
        package's names the mesh's devices: after a recovery epoch the
        survivors' placement is another layout (`data.same_ingest_identity`
        still matches its host blocks)."""
        from .data import dataset_fingerprint

        input_col, input_cols = self._get_input_columns()
        label_col = self.getOrDefault("labelCol") if self._supervised else None
        weight_col = (
            self.getOrDefault("weightCol")
            if self.hasParam("weightCol") and self.isDefined("weightCol")
            else None
        )
        id_col = self.getOrDefault("idCol") if self.hasParam("idCol") and self.isDefined("idCol") else None
        return (
            dataset_fingerprint(dataset),
            (input_col, tuple(input_cols) if input_cols else None, label_col, weight_col, id_col),
            (np.dtype(np.float32 if self._float32_inputs else np.float64).name, self._sparse_mode()),
            str(device) if ctx is None else (str(device), tuple(ctx.live_ranks_hint())),
        )

    def _admit_and_layout(
        self,
        extracted: ExtractedData,
        device: torch.device,
        *,
        force_stream: bool = False,
        key: Optional[tuple] = None,
        source: Any = None,
        attempt: int = 0,
        ctx: Any = None,
    ) -> DeviceDataset:
        """The admission verdict and the data plane it calls for: RESIDENT
        scans the rows for NaN/Inf (when asked) and places them; STREAM
        (`fit.demotions`, the reason logged and stamped on the model) places
        nothing and hands the streaming solvers a `StreamPlan`, their scan
        deferred to each row block; a fit that fits neither way raises the
        typed `HbmBudgetError` from `memory.admit_fit`. A streamed dataset
        comes back with ``key=None``: there is no placement to reuse, and a
        later fit must budget anew. In a multi-process fit (`ctx`) a rank
        places its own block (`_build_fit_inputs`), CSR rows in the padded-ELL
        width the ranks agree on (`FitInputs.ell_rows`)."""
        from . import memory as _memory
        from . import telemetry
        from .data import run_deferred_validation
        from .parallel import chaos

        fan = _FANOUT_CHIP.get()
        if fan is not None:
            # a chip of a fanned-out fit: its caller admitted every chip's
            # block at once, and holds the claim
            adm = fan.admission
            self._last_admission = adm
        else:
            # hand back this fit's previous claim before re-admitting: the
            # OOM retry must not count the failed attempt's bytes against
            # itself
            self._adopt_reservation(None)
            adm = _memory.admit_fit(self, extracted, device, force_stream=force_stream)
            self._last_admission = adm
            # the claim belongs to this fit call (released in
            # _call_fit_func's finally); the decision may be cached and must
            # carry none
            self._adopt_reservation(adm.reservation)
            adm.reservation = None
        reg = telemetry.registry()
        if adm.verdict == _memory.STREAM:
            reg.inc("memory.admission_stream")
            reg.inc("fit.demotions")
            _LOG.warning(
                "%s fit demoted RESIDENT -> STREAM: %s (chunk_rows=%d)",
                type(self).__name__, adm.reason, adm.chunk_rows,
            )
            plan = StreamPlan(
                extracted=extracted,
                chunk_rows=adm.chunk_rows,
                validate=bool(config.get("validate_ingest", False)),
            )
            inputs = self._build_stream_inputs(extracted, device, plan)
            return DeviceDataset(None, extracted, inputs, source=source, admission=adm)
        reg.inc("memory.admission_resident")
        run_deferred_validation(extracted)  # the full scan, before any placement
        # index = the fit stage's attempt: `oom:stage=placement:round=1`
        # targets the re-placement of a retried attempt, not the first one
        chaos.maybe_fail_oom("placement", attempt)
        inputs = self._layout(extracted, device, ctx)
        telemetry.record_device_memory(device)  # the watermark after placement
        return DeviceDataset(key, extracted, inputs, source=source, admission=adm)

    def _build_stream_inputs(
        self, extracted: ExtractedData, device: torch.device, plan: StreamPlan
    ) -> FitInputs:
        """`FitInputs` of an out-of-core fit: NOTHING is placed. X is None,
        w and y are the host columns, and `stream` carries the plan. The
        solvers treat host w == 0 rows as absent, so `with_row_mask` works
        unchanged."""
        from .parallel import StreamStaging

        dtype = np.float32 if self._float32_inputs else np.float64
        w = extracted.weight
        w_np = np.asarray(w, dtype=dtype) if w is not None else np.ones(extracted.n_rows, dtype=dtype)
        plan.staging = StreamStaging()
        y = None if extracted.label is None else extracted.label.astype(dtype, copy=False)
        return FitInputs(
            X=None, w=w_np, n_valid=extracted.n_rows, n_cols=extracted.n_cols,
            dtype=dtype, device=device, y=y, stream=plan,
            X_sparse=extracted.features if extracted.is_sparse else None,
        )

    def _device_dataset(
        self, dataset: Any, device: torch.device, force_stream: bool = False, attempt: int = 0, ctx: Any = None
    ) -> DeviceDataset:
        """Ingest, admission and placement, or a cache hit inside an active
        `device_dataset_scope`: the ingest and the placement happen only on
        a miss, which is how a numFolds x paramMaps CrossValidator fit
        places its rows once. A streamed (demoted) dataset is never cached;
        a cached entry is a RESIDENT placement that passed admission.

        In a multi-process fit (`ctx`) a hit runs no rendezvous round and a
        miss runs the layout's, so hit and miss must agree across ranks:
        one round first (`fit.device_dataset_spmd_rounds`) in which every
        rank states whether it holds the entry, and the cache serves only
        when all do; otherwise every rank ingests and places anew."""
        from . import memory as _memory
        from . import telemetry

        scope = _DDS_SCOPE.get()
        if scope is None or force_stream:
            extracted = self._ingest(dataset)
            dds = self._admit_and_layout(extracted, device, force_stream=force_stream, attempt=attempt, ctx=ctx)
            if scope is not None:
                scope.last = dds
            return dds
        key = self._device_dataset_key(dataset, device, ctx)
        reg = telemetry.registry()
        allow_hit = True
        if ctx is not None:
            with scope.lock:
                have = key in scope.cache
            votes = ctx.rendezvous.allgather(f"dds-have:{int(have)}")
            allow_hit = all(v == "dds-have:1" for v in votes)
            reg.inc("fit.device_dataset_spmd_rounds")
        # the scope is this rank's own, so holding its lock across the miss
        # branch's layout round blocks no peer
        with scope.lock:
            dds = scope.cache.get(key) if allow_hit else None
            if dds is not None:
                scope.cache.move_to_end(key)
                reg.inc("fit.device_dataset_reuses")
                if ctx is not None and dds.inputs.ctx is not ctx:
                    # the same layout under this fit's context (a chip of a
                    # fan-out enters a new one each fit)
                    dds.inputs = dataclasses.replace(dds.inputs, ctx=ctx)
                if dds.admission is not None and _FANOUT_CHIP.get() is None:
                    # a hit skips the admission: re-stamp the verdict that
                    # admitted the placement, and re-reserve its bytes (they
                    # are held, and other tenants must see them); a chip of a
                    # fanned-out fit holds none, its caller does
                    self._last_admission = dds.admission
                    self._adopt_reservation(_memory.rereserve_admission(dds.admission))
            else:
                from .data import same_ingest_identity

                # the host-retained re-layout: an entry for the SAME data
                # under another membership (the survivors of a recovery
                # epoch) still holds the right host blocks, so the ingest is
                # skipped and only the admission and layout run again. Its
                # placement serves no later fit of this membership and goes
                # first, so the card never holds both
                stale = next((k_ for k_ in scope.cache if same_ingest_identity(k_, key)), None)
                if stale is not None:
                    retained = scope.cache.pop(stale)
                    extracted, source = retained.extracted, retained.source
                    del retained
                    reg.inc("recovery.replacements")
                    reg.inc("recovery.rows_replaced", int(extracted.n_rows))
                    dds = self._admit_and_layout(extracted, device, key=key, source=source, attempt=attempt, ctx=ctx)
                else:
                    extracted = self._ingest(dataset)
                    # `source=dataset` pins the object whose id() keys the entry
                    dds = self._admit_and_layout(
                        extracted, device, key=key, source=dataset, attempt=attempt, ctx=ctx
                    )
                    if dds.key is not None:
                        reg.inc("fit.device_dataset_builds")
                if dds.key is not None:  # streamed datasets are not cached
                    scope.cache[key] = dds
                    cap = max(1, int(config.get("device_dataset_cache_entries", 2)))
                    while len(scope.cache) > cap:
                        scope.cache.popitem(last=False)
                        reg.inc("fit.device_dataset_evictions")
            scope.last = dds
        return dds

    def _call_fit_func(
        self,
        dataset: Any,
        param_maps: Optional[List[Dict[Any, Any]]] = None,
        row_mask: Optional[np.ndarray] = None,
    ) -> List[Dict[str, Any]]:
        """One placement (or one streaming plan), one solve per param map
        (one for None): returns the model-attribute dicts. `row_mask` trains
        on its rows only (`FitInputs.with_row_mask`). The admission verdict
        lands in ``self._last_fit_metrics["admission"]``: always for a
        demoted fit, with telemetry on for a resident one. A multi-process
        fit (an entered TpuContext with nranks > 1) runs under the context's
        process group, its rank, size and backend stamped in
        ``_last_fit_metrics["spmd"]``; an estimator that does not support it
        refuses."""
        from . import telemetry
        from .parallel import default_device, fan_out_width, refuse_devices_per_rank, spmd_context
        from .parallel.context import fit_group_scope

        ctx = spmd_context()
        if ctx is not None:
            if not self._supports_multiprocess:
                raise NotImplementedError(
                    f"{type(self).__name__} does not support multi-process SPMD fit yet; "
                    "run it single-controller (one process driving all devices); its "
                    "multi-process fit is ROADMAP item A10"
                )
            refuse_devices_per_rank(self.num_workers, f"{type(self).__name__} fit")
        else:
            n = fan_out_width(self.num_workers)
            if n > 1:
                return self._call_fit_func_fanned(dataset, param_maps, row_mask, n)
        device = default_device()
        self._last_admission = None
        fan = _FANOUT_CHIP.get()
        try:
            # the whole fit (ingest, admission, placement, solve) is ONE
            # recoverable stage: a transient retry re-derives its state from
            # the immutable dataset, a rank loss opens a recovery epoch (the
            # context adopts the survivors' rendezvous and a new process
            # group), and the solvers resume from the checkpoint store the
            # attempts share. The group is read per attempt: a re-entered
            # attempt reduces over the new group, never the broken one
            def attempt_fit(attempt: int):
                with fit_group_scope(None if ctx is None else ctx.group):
                    return self._call_fit_func_oom_ladder(dataset, param_maps, row_mask, device, attempt, ctx=ctx)

            if fan is not None:
                # a chip of a fanned-out fit: its caller's stage retries the
                # fit over every chip (an in-process group is not reformed)
                rows = attempt_fit(fan.attempt)
            else:
                rows = recoverable_stage(attempt_fit, stage="fit", ctx=ctx)
        finally:
            # the fit's ledger claim ends with the fit, whatever its outcome
            self._adopt_reservation(None)
        adm = self._last_admission
        self._last_fit_metrics = (
            {"admission": adm.stamp()}
            if adm is not None and (telemetry.enabled() or adm.demoted)
            else {}
        )
        if ctx is not None:
            self._last_fit_metrics["spmd"] = {"rank": ctx.rank, "nranks": ctx.nranks, "backend": ctx.backend}
        return rows

    def _fanout_layout(
        self, dataset: Any, device: torch.device, chip_ids: Tuple[int, ...], scope: Optional[DeviceDatasetScope],
    ) -> Tuple[FanOutLayout, List[Optional[DeviceDatasetScope]]]:
        """The dataset's layout over the chips `chip_ids` (extracted once,
        cut into row blocks) and each chip's device-dataset scope. Inside a
        `device_dataset_scope` both are kept: a later fit of the same
        dataset over the same chips reuses every chip's placement, and one
        over another chip set (a narrower num_workers, a carved pin) reuses
        the host rows and lays them out again (`recovery.replacements`),
        the old chips' placements dropped first."""
        from . import telemetry
        from .data import same_ingest_identity
        from .parallel import shard_row_ranges

        def build(extracted: ExtractedData, source: Any) -> FanOutLayout:
            ranges = [(lo, hi) for lo, hi in shard_row_ranges(extracted.n_rows, len(chip_ids)) if hi > lo]
            return FanOutLayout(extracted, [extracted.row_block(lo, hi) for lo, hi in ranges], ranges, source)

        if scope is None:
            lay = build(self._ingest(dataset), dataset)
            return lay, [None] * len(lay.blocks)
        key = self._device_dataset_key(dataset, device)[:3] + (("chips",) + tuple(chip_ids),)
        reg = telemetry.registry()
        with scope.lock:
            lay = scope.fanout.get(key)
            if lay is not None:
                scope.fanout.move_to_end(key)
            else:
                stale = next((k for k in scope.fanout if same_ingest_identity(k, key)), None)
                if stale is not None:
                    old = scope.fanout.pop(stale)
                    _drop_chip_scopes(scope, stale)
                    reg.inc("recovery.replacements")
                    reg.inc("recovery.rows_replaced", int(old.extracted.n_rows))
                    lay = build(old.extracted, old.source)
                    del old
                else:
                    lay = build(self._ingest(dataset), dataset)
                scope.fanout[key] = lay
                cap = max(1, int(config.get("device_dataset_cache_entries", 2)))
                while len(scope.fanout) > cap:
                    gone, _ = scope.fanout.popitem(last=False)
                    _drop_chip_scopes(scope, gone)
                    reg.inc("fit.device_dataset_evictions")
            chips = [scope.chip_scopes.setdefault((key, r), DeviceDatasetScope()) for r in range(len(lay.blocks))]
        return lay, chips

    def _call_fit_func_fanned(
        self,
        dataset: Any,
        param_maps: Optional[List[Dict[Any, Any]]],
        row_mask: Optional[np.ndarray],
        n: int,
    ) -> List[Dict[str, Any]]:
        """The fit over the first `n` chips of the device pool, one process
        driving them: the host rows are extracted once and cut into
        `parallel.shard_row_ranges` blocks (views), one admission covers
        every chip (`memory.admit_fit` with ``n_devices``, the claim's chips
        n), and each chip runs the rank-sharded fit of the multi-process
        path on its block in its own thread (`parallel.run_on_chips`: an
        in-process group, its own checkpoint store and device-dataset
        scope). Every chip's model is the same; rank 0's is returned, and
        ``_fit_metrics["multidevice"]`` says whether the others' digests
        equal it. The fit's transient retries wrap the whole fan-out. A fit
        the admission demotes to streaming streams on the first chip, and so
        does one whose chip failed to allocate (`_fanned_oom_retry`, the
        ladder's one retry)."""
        from . import checkpoint as _ckpt
        from . import memory as _memory
        from . import telemetry
        from .errors import HbmBudgetError
        from .parallel import chip_scope, current_chip_ids, default_devices, run_on_chips

        devices = default_devices()[:n]
        ids = tuple(current_chip_ids()[:n])
        outer = _DDS_SCOPE.get()
        self._last_admission = None
        meta: Dict[str, Any] = {}

        def attempt_fit(attempt: int):
            lay, chip_scopes = self._fanout_layout(dataset, devices[0], ids, outer)
            m = len(lay.blocks)
            self._adopt_reservation(None)
            adm = _memory.admit_fit(self, lay.extracted, devices[0], n_devices=m)
            self._last_admission = adm
            self._adopt_reservation(adm.reservation)
            adm.reservation = None
            if adm.verdict == _memory.STREAM or m < 2:
                self._adopt_reservation(None)
                with chip_scope(devices[:1], chip_ids=ids[:1]):
                    return self._call_fit_func_oom_ladder(dataset, param_maps, row_mask, devices[0], attempt)
            masks = None if row_mask is None else [np.asarray(row_mask)[lo:hi] for lo, hi in lay.ranges]
            store = _ckpt.active_store()
            chip_adm = dataclasses.replace(adm, reservation=None)

            def chip(r: int):
                est = self.copy()  # the chips' fits share no state (the copy carries the warm start)
                est._fit_reservation = None
                est._last_admission = None
                fan = _FanOutChip(attempt=attempt, admission=chip_adm)
                t_fan = _FANOUT_CHIP.set(fan)
                t_dds = _DDS_SCOPE.set(chip_scopes[r])
                try:
                    with _ckpt.checkpoint_scope(store=store.chip_store(r)):
                        rows = est._call_fit_func(lay.blocks[r], param_maps, None if masks is None else masks[r])
                finally:
                    _DDS_SCOPE.reset(t_dds)
                    _FANOUT_CHIP.reset(t_fan)
                return rows, getattr(est, "_last_fit_metrics", {}), _attrs_digest(rows), fan.layout_s

            oom = None
            try:
                results, stats = run_on_chips(m, chip)
            except HbmBudgetError as e:
                # a chip's allocation failed (its ladder converts, as a rank's
                # does); the fit retries ONCE streamed on the first chip, as
                # the one-chip ladder does
                if not (self._supports_streaming_fit and _memory.is_oom_error(e.__cause__)):
                    raise
                oom = str(e)
            if oom is not None:
                # outside the handler: its traceback would pin the failed
                # chips' placements
                return self._fanned_oom_retry(oom, dataset, param_maps, row_mask, devices, ids, chip_scopes, attempt)
            for st, res in zip(stats, results):
                st["placement_s"] = res[3]
            digests = [res[2] for res in results]
            meta["multidevice"] = {
                "chips": m, "chip_ids": list(ids[:m]), "rows": [hi - lo for lo, hi in lay.ranges],
                "models_equal": all(d == digests[0] for d in digests), "per_chip": stats,
            }
            meta["rank0"] = results[0][1]
            if outer is not None:
                # the tuning layer scores held-out rows from here: the host
                # rows, placed on the first chip batch by batch
                dtype = np.float32 if self._float32_inputs else np.float64
                outer.last = DeviceDataset(None, lay.extracted, FitInputs(
                    X=None, w=None, n_valid=lay.extracted.n_rows, n_cols=lay.extracted.n_cols,
                    dtype=dtype, device=devices[0],
                ))
            return results[0][0]

        try:
            rows = recoverable_stage(attempt_fit, stage="fit")
        finally:
            self._adopt_reservation(None)
        adm = self._last_admission
        metrics = dict(meta.get("rank0") or {})
        metrics.pop("spmd", None)
        if adm is not None and (telemetry.enabled() or adm.demoted):
            metrics["admission"] = adm.stamp()
        if "multidevice" in meta:
            metrics["multidevice"] = meta["multidevice"]
        self._last_fit_metrics = metrics
        return rows

    def _fanned_oom_retry(
        self,
        why: str,
        dataset: Any,
        param_maps: Optional[List[Dict[Any, Any]]],
        row_mask: Optional[np.ndarray],
        devices: List[torch.device],
        ids: Tuple[int, ...],
        chip_scopes: List[Optional[DeviceDatasetScope]],
        attempt: int,
    ) -> List[Dict[str, Any]]:
        """The fan-out's rung of the OOM ladder: the chips' claim and
        placements go, and the fit runs once on the streaming path on the
        first chip; a second allocation failure raises `HbmBudgetError`."""
        from . import memory as _memory
        from . import telemetry
        from .parallel import chip_scope

        _LOG.warning(
            "%s: out of memory on a chip of a fanned-out fit (%s); retrying ONCE on the out-of-core "
            "streaming path on the first chip", type(self).__name__, why,
        )
        self._adopt_reservation(None)
        n_evicted = 0
        for c in chip_scopes:
            if c is not None:
                with c.lock:
                    n_evicted += len(c.cache)
                    c.cache.clear()
                    c.last = None
        if n_evicted:
            telemetry.registry().inc("fit.device_dataset_evictions", n_evicted)
        if devices[0].type == "cuda":
            torch.cuda.empty_cache()
        with chip_scope(devices[:1], chip_ids=ids[:1]):
            try:
                return self._call_fit_func_attempt(
                    dataset, param_maps, row_mask, devices[0], force_stream=True, attempt=attempt
                )
            except Exception as e2:
                if _memory.is_oom_error(e2):
                    raise _memory.as_hbm_budget_error(e2, self._last_admission) from e2
                raise

    def _call_fit_func_oom_ladder(
        self,
        dataset: Any,
        param_maps: Optional[List[Dict[Any, Any]]],
        row_mask: Optional[np.ndarray],
        device: torch.device,
        attempt: int = 0,
        ctx: Any = None,
    ) -> List[Dict[str, Any]]:
        """One attempt, with the OOM ladder around it: a real allocation
        failure on the card (`memory.is_oom_error`: torch.OutOfMemoryError,
        or the chaos `oom` fault shaped like one) is retried ONCE on the
        streaming path. A second failure, an estimator with no streaming
        path, or a multi-process fit (which must fit resident), raises
        `HbmBudgetError`; a raw OOM never leaves a fit."""
        from . import memory as _memory
        from . import telemetry

        try:
            return self._call_fit_func_attempt(dataset, param_maps, row_mask, device, attempt=attempt, ctx=ctx)
        except Exception as e:
            if not _memory.is_oom_error(e):
                raise
            telemetry.registry().inc("memory.oom_caught")
            if not self._supports_streaming_fit or ctx is not None:
                raise _memory.as_hbm_budget_error(e, self._last_admission) from e
            _LOG.warning(
                "%s: out of memory on the card during the fit (%s); retrying ONCE on "
                "the out-of-core streaming path", type(self).__name__, e,
            )
        # the retry runs OUTSIDE the handler: the handler's traceback pins the
        # failed attempt's frames, and with them its dead placement, while `e`
        # lives. Placements cached by an enclosing scope go too: a cache hit
        # is worth less than room for the streaming retry.
        scope = _DDS_SCOPE.get()
        if scope is not None:
            with scope.lock:
                n_evicted = len(scope.cache)
                scope.cache.clear()
                scope.last = None
            if n_evicted:
                telemetry.registry().inc("fit.device_dataset_evictions", n_evicted)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        try:
            return self._call_fit_func_attempt(
                dataset, param_maps, row_mask, device, force_stream=True, attempt=attempt
            )
        except Exception as e2:
            if _memory.is_oom_error(e2):
                raise _memory.as_hbm_budget_error(e2, self._last_admission) from e2
            raise

    def _call_fit_func_attempt(
        self,
        dataset: Any,
        param_maps: Optional[List[Dict[Any, Any]]],
        row_mask: Optional[np.ndarray],
        device: torch.device,
        force_stream: bool = False,
        attempt: int = 0,
        ctx: Any = None,
    ) -> List[Dict[str, Any]]:
        dds = self._device_dataset(dataset, device, force_stream=force_stream, attempt=attempt, ctx=ctx)
        extracted, inputs = dds.extracted, dds.inputs
        fit_func = self._get_tpu_fit_func(extracted)
        if row_mask is not None:
            # in a multi-process fit each rank passes its LOCAL fold mask
            inputs = inputs.with_row_mask(row_mask)
        _LOG.info(
            "fit: %d rows x %d cols on %s (%s)%s", inputs.n_valid, inputs.n_cols, device,
            "sparse" if inputs.X_sparse is not None else "dense",
            f" [SPMD rank {ctx.rank}/{ctx.nranks}, {ctx.backend}]" if ctx is not None else "",
        )
        if param_maps is None:
            solver_param_sets = [dict(self._solver_params)]
        else:
            solver_param_sets = []
            for pm in param_maps:
                est = self.copy(pm)
                mapping = est._param_mapping()
                for p, v in pm.items():
                    mapped = mapping.get(p.name if isinstance(p, Param) else p)
                    if mapped:
                        est._set_solver_param(mapped, v, silent=True)
                solver_param_sets.append(dict(est._solver_params))
        try:
            return self._dispatch_solves(inputs, extracted, fit_func, solver_param_sets)
        finally:
            if inputs.stream is not None:
                # the pipeline's page-locked and device buffers end with the
                # fit (a scope's `last` keeps the dataset for scoring)
                inputs.stream.staging = None

    def _dispatch_solves(
        self,
        inputs: FitInputs,
        extracted: ExtractedData,
        fit_func: FitFunc,
        solver_param_sets: List[Dict[str, Any]],
    ) -> List[Dict[str, Any]]:
        """Every solver param set's solve. Sets whose `_batch_group_key`s
        match, two or more of them, solve as one batched grid
        (`_get_tpu_batched_fit_func`); the others one by one. The counters
        fit.solves_batched and fit.solves_sequential say which way each
        went."""
        from . import telemetry
        from .parallel import chaos

        chaos.maybe_fail_oom("solve")  # round-less `oom:stage=solve` plans
        n_sets = len(solver_param_sets)
        rows: List[Optional[Dict[str, Any]]] = [None] * n_sets
        # a streamed fit solves one by one: the batched grids run over a
        # resident placement
        batched_fn = (
            self._get_tpu_batched_fit_func(extracted)
            if n_sets > 1 and inputs.stream is None
            else None
        )
        groups: Dict[Any, List[int]] = {}
        for i, sp in enumerate(solver_param_sets):
            key = self._batch_group_key(sp) if batched_fn is not None else None
            groups.setdefault(("seq", i) if key is None else ("batch", key), []).append(i)
        reg = telemetry.registry()
        for gid, idxs in groups.items():
            if gid[0] == "batch" and len(idxs) > 1:
                out = batched_fn(inputs, [solver_param_sets[i] for i in idxs])
                if len(out) != len(idxs):
                    raise RuntimeError(
                        f"{type(self).__name__} batched fit returned {len(out)} results "
                        f"for {len(idxs)} param sets"
                    )
                reg.inc("fit.solves_batched", len(idxs))
                for i, attrs in zip(idxs, out):
                    rows[i] = attrs
                continue
            for i in idxs:
                rows[i] = fit_func(inputs, solver_param_sets[i])
                reg.inc("fit.solves_sequential")
        return rows


class _TpuEstimator(_TpuCaller):
    """Estimator base."""

    def fit(
        self,
        dataset: Any,
        params: Optional[Union[Dict, List[Dict]]] = None,
        warm_start_from: Any = None,
    ):
        """Fit on `dataset`. `params` is one param map applied to a copy of
        this estimator, or a list of them: then the list of their models,
        fitted over one placement (`fitMultiple`). `warm_start_from` seeds
        the solver from a previous result's iterate (a fitted model of the
        same family) instead of a cold init."""
        if isinstance(params, (list, tuple)):
            if warm_start_from is not None:
                raise ValueError(
                    "warm_start_from is a single-fit seed; combine it with "
                    "one param dict, not a param-map list"
                )
            return [m for _, m in sorted(self.fitMultiple(dataset, list(params)), key=lambda im: im[0])]
        if isinstance(params, dict) and params:
            return self.copy(params).fit(dataset, warm_start_from=warm_start_from)
        if warm_start_from is not None:
            self._warm_start = self._resolve_warm_start(warm_start_from)
        try:
            models = self._fit_internal(dataset, None)
        finally:
            self._warm_start = None
        return models[0]

    def _resolve_warm_start(self, source: Any) -> Dict[str, Any]:
        """Per-estimator hook: the portable warm-start payload of `source`."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support warm_start_from"
        )

    def fitMultiple(self, dataset: Any, paramMaps: Sequence[Dict[Any, Any]]) -> "_FitMultipleIterator":
        """Fit every param map over ONE placement of the data: an iterator
        of (index, model), all models made by the first `next`."""
        maps = list(paramMaps)
        return _FitMultipleIterator(lambda: self._fit_internal(dataset, maps), len(maps))

    def _fit_internal(
        self,
        dataset: Any,
        paramMaps: Optional[List[Dict[Any, Any]]],
        row_mask: Optional[np.ndarray] = None,
    ) -> List["_TpuModel"]:
        attr_rows = self._call_fit_func(dataset, paramMaps, row_mask)
        fit_metrics = getattr(self, "_last_fit_metrics", {})
        models = []
        for i, attrs in enumerate(attr_rows):
            model = self._create_model(attrs)
            model._model_attributes = attrs
            model._fit_metrics = fit_metrics
            self._copyValues(model, paramMaps[i] if paramMaps else None)
            if paramMaps:
                self.copy(paramMaps[i])._copy_solver_params(model)
            else:
                self._copy_solver_params(model)
            models.append(model)
        return models

    @abstractmethod
    def _create_model(self, attrs: Dict[str, Any]) -> "_TpuModel":
        raise NotImplementedError

    def _supportsTransformEvaluate(self, evaluator: Any) -> bool:
        """Whether CrossValidator can score this estimator's models through
        the fused `_combine` + `_transform_evaluate` path."""
        return False

    # persistence ---------------------------------------------------------
    def write(self) -> "_TpuWriter":
        return _TpuWriter(self)

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def read(cls) -> "_TpuReader":
        return _TpuReader(cls)

    @classmethod
    def load(cls, path: str):
        return cls.read().load(path)


class _TpuEstimatorSupervised(_TpuEstimator):
    """Estimator base of the supervised estimators: the fit extracts the
    labelCol beside the features and places it as `FitInputs.y`."""

    _supervised = True


class _FitMultipleIterator:
    """Thread-safe (index, model) iterator; every model comes from ONE fit
    pass, run by whoever claims index 0."""

    def __init__(self, fitMultipleModels: Callable[[], List["_TpuModel"]], numModels: int):
        self.fitMultipleModels = fitMultipleModels
        self.numModels = numModels
        self.counter = 0  # guarded-by: lock
        self.lock = threading.Lock()
        # written once by the index-0 claimant, then published through
        # `_materialized`; readers wait on the event, not on the lock
        self.models: Optional[List["_TpuModel"]] = None
        self._materialized = threading.Event()
        self._fit_error: Optional[BaseException] = None

    def __iter__(self) -> Iterator[Tuple[int, "_TpuModel"]]:
        return self

    def __next__(self) -> Tuple[int, "_TpuModel"]:
        with self.lock:
            index = self.counter
            if index >= self.numModels:
                raise StopIteration()
            self.counter += 1
        if index == 0:
            try:
                self.models = self.fitMultipleModels()
            except BaseException as e:
                self._fit_error = e
                raise
            finally:
                self._materialized.set()
        else:
            self._materialized.wait()
            if self._fit_error is not None:
                raise RuntimeError(
                    "the fit pass materializing this iterator's models failed"
                ) from self._fit_error
        return index, self.models[index]

    next = __next__


class _TpuModel(_TpuCommon):
    """Model base."""

    def __init__(self, **model_attrs: Any) -> None:
        super().__init__()
        self._model_attributes: Dict[str, Any] = model_attrs
        # the fit's stamps: its memory admission verdict under "admission"
        # (a demoted fit's always, a resident one's with telemetry on); {}
        # otherwise
        self._fit_metrics: Dict[str, Any] = {}
        # the serving plane's stamps: why the model is (or is no longer)
        # resident, set by serving.ModelRegistry
        self._serve_metrics: Dict[str, Any] = {}

    def transform(self, dataset: Any):
        raise NotImplementedError

    # the fused cross-validation path: models that support it pack a fold's
    # models into one (`_combine`) and score them all in one pass
    def _combine(self, models: List["_TpuModel"]) -> "_TpuModel":
        raise NotImplementedError(f"{type(self).__name__} does not support the fused CV path (_combine)")

    def _transform_evaluate(self, dataset: Any, evaluator: Any) -> List[float]:
        raise NotImplementedError(f"{type(self).__name__} does not support transform-evaluate")

    @classmethod
    def _transformEvaluate_supported(cls, evaluator: Any) -> bool:
        return False

    # serving hooks -------------------------------------------------------
    # The per-model surface the serving plane composes: a resident
    # PredictProgram factory, plus the placement / per-bucket workspace byte
    # terms the admission budgeter (memory.admit_model_load) charges.

    # serving dtypes this model accepts; the distance-core models extend
    # with "bf16"
    _serve_dtypes: tuple = (None, "float32", "float64")

    def _serve_program(
        self, serve_dtype: Optional[str] = None, *, cap: Optional[int] = None
    ) -> "PredictProgram":
        """Resident predict handle for the serving plane. Models without a
        batched predict surface have nothing to keep resident."""
        raise NotImplementedError(
            f"{type(self).__name__} has no serving hook (no batched predict "
            "surface to keep resident)"
        )

    def _serve_check(self, serve_dtype: Optional[str] = None) -> None:
        """Cheap serveability preflight: raises exactly what `_serve_program`
        would, WITHOUT placing anything on the device. The registry runs it
        before its admission/eviction loop, so a load that can never succeed
        cannot evict resident models as a side effect."""
        if type(self)._serve_program is _TpuModel._serve_program:
            self._serve_program(serve_dtype)  # the standard NotImplementedError
        if serve_dtype not in self._serve_dtypes:
            raise ValueError(
                f"{type(self).__name__} serves at its fit dtype; "
                f"serve_dtype={serve_dtype!r} is only available on the "
                "distance-core models"
            )
        self._serve_n_cols()

    def _serve_n_cols(self) -> int:
        """Feature width the serving plane prewarms and validates against."""
        n = int(getattr(self, "n_cols", 0) or 0)
        if n <= 0:
            raise ValueError(
                f"{type(self).__name__} does not know its feature width; "
                "cannot prewarm the serving ladder"
            )
        return n

    def _serve_placement_terms(self) -> Dict[str, int]:
        """Per-device bytes of this model's RESIDENT state (what
        `construct()` places), as named terms for the admission budgeter.
        Default: every array model attribute at the working dtype."""
        itemsize = 4 if self._float32_inputs else 8
        total = 0
        for v in self._model_attributes.values():
            if isinstance(v, np.ndarray):
                total += int(v.size) * itemsize
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], np.ndarray):
                total += sum(int(a.size) for a in v) * itemsize
        return {"placement.params": total}

    def _serve_workspace_terms(
        self, bucket_rows_count: int, itemsize: int
    ) -> Dict[str, int]:
        """Bytes live during ONE dispatched batch of `bucket_rows_count` rows
        beyond the model state and the batch itself. {} = none modeled."""
        return {}

    # persistence ---------------------------------------------------------
    def write(self) -> "_TpuWriter":
        return _TpuWriter(self)

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def read(cls) -> "_TpuReader":
        return _TpuReader(cls)

    @classmethod
    def load(cls, path: str):
        return cls.read().load(path)


class PredictProgram:
    """Resident, reusable predict handle: construct the device state once,
    pad every host batch up the geometric bucket ladder, run `predict` on the
    device, slice the outputs back.

    Two consumers share it so they cannot drift: `_transform_arrays` builds a
    short-lived one per transform call, and the serving plane
    (`serving/`) holds one per RESIDENT model for its registry lifetime.

      * `dispatch(xb)` pads a host batch UP its ladder rung
        (`parallel.bucket_rows`), copies it to the device and runs `predict`;
        it fetches nothing back, and returns the device outputs;
      * `fetch(result, n_valid)` is the one device-to-host copy, slicing
        every output back to the valid rows;
      * `prewarm(...)` dispatches zeros through every ladder rung, so every
        kernel of every rung is built and launched at load time, not at the
        first query.

    `predict` is row-parallel: padding rows cannot change the valid rows'
    outputs, so a request's answer does not depend on the rung it lands on.
    The top-k merge of the kNN models reads a count back from the device
    once per item block (ops/distance.py `_smallest_columns`), so their
    `dispatch` returns with the last block's work still in flight, not all
    of it."""

    def __init__(
        self,
        model: "_TpuModel",
        *,
        construct: Optional[Callable[[], Any]] = None,
        predict: Optional[Callable[[Any, torch.Tensor], Any]] = None,
        cap: Optional[int] = None,
        mesh: Any = None,
    ) -> None:
        from .parallel import default_device

        if mesh is not None:
            # the JAX package's program replicated over a mesh's devices
            raise NotImplementedError(
                "a PredictProgram over several devices is ROADMAP item A10h; the port serves from one device"
            )
        if construct is None or predict is None:
            c0, p0 = model._get_transform_func()
            construct = construct or c0
            predict = predict or p0
        self.model = model
        self.predict_fn = predict
        self.device = default_device()
        self.cap = int(cap) if cap else int(config["max_records_per_batch"])
        self.bucket_min = int(config["transform_bucket_min_rows"])
        self.dtype = np.float32 if model._float32_inputs else np.float64
        self.state = construct()
        # bucketed shapes already dispatched: what the engine's
        # `serve.bucket_hits` counter reads
        self._shapes_seen: set = set()
        self.last_dispatch_new_shape: bool = False

    def ladder(self, max_rows: Optional[int] = None) -> List[int]:
        """The rungs batches of 1..max_rows pad up to: what `prewarm`
        dispatches."""
        from .parallel import bucket_ladder

        return bucket_ladder(
            min(int(max_rows), self.cap) if max_rows else self.cap,
            min_rows=self.bucket_min,
            cap=self.cap,
        )

    def dispatch(self, xb: np.ndarray) -> Tuple[Any, int]:
        """Pad one host batch up its rung, place it and run `predict`; no
        device-to-host copy. Returns (device outputs, valid row count). A
        zero-row batch still dispatches one rung, so multi-output models
        yield one correctly shaped empty array per output at `fetch`."""
        from .parallel import bucket_rows, host_tensor

        xp, n_valid = bucket_rows(
            np.asarray(xb, dtype=self.dtype), min_rows=self.bucket_min, cap=self.cap
        )
        sig = tuple(xp.shape)
        self.last_dispatch_new_shape = sig not in self._shapes_seen
        self._shapes_seen.add(sig)
        return self.predict_fn(self.state, host_tensor(xp).to(self.device)), n_valid

    def fetch(self, result: Any, n_valid: int) -> Any:
        """THE device-to-host copy: every output sliced to the valid rows,
        as numpy arrays."""
        from . import telemetry

        with telemetry.device_wait("predict_fetch", self.device):
            if isinstance(result, tuple):
                return tuple(r[:n_valid].cpu().numpy() for r in result)
            return result[:n_valid].cpu().numpy()

    def prewarm(self, n_cols: int, *, max_rows: Optional[int] = None) -> int:
        """Dispatch a zeros batch through every ladder rung up to `max_rows`
        rows and wait for it, so the kernels are built and every rung's
        buffers have been allocated once before the first query. Returns the
        rung count."""
        rungs = self.ladder(max_rows)
        for r in rungs:
            result, _ = self.dispatch(np.zeros((r, int(n_cols)), dtype=self.dtype))
            self.fetch(result, 0)
        return len(rungs)


class _TpuModelWithColumns(_TpuModel):
    """Transform = append prediction column(s), batched over rows.

    `construct` runs once per transform (model attributes -> device state);
    `predict` runs per batch of at most ``config["max_records_per_batch"]``
    rows, each copied to the device in turn, so device memory holds one
    batch at a time whatever the dataset's size."""

    @abstractmethod
    def _get_transform_func(self) -> TransformFuncs:
        raise NotImplementedError

    def _serve_program(
        self, serve_dtype: Optional[str] = None, *, cap: Optional[int] = None
    ) -> PredictProgram:
        """Default serving hook: the model's own (construct, predict) pair as
        a resident PredictProgram."""
        self._serve_check(serve_dtype)
        return PredictProgram(self, cap=cap)

    @abstractmethod
    def _out_column_names(self) -> List[str]:
        """Names of the appended columns."""
        raise NotImplementedError

    def _transform_arrays(self, features: np.ndarray) -> Any:
        """Batched predict over a host feature block, through a short-lived
        PredictProgram: each batch is padded up the bucket ladder,
        dispatched, fetched and sliced back, as the serving plane does. The
        outputs of the batches are concatenated (per output, for a tuple). A
        CSR block is densified one batch at a time. A zero-row block still
        runs one batch, so the output keeps the type
        and arity `predict` gives it.

        At ``config["distributed_transform_min_rows"]`` rows and up, with a
        num_workers spanning more than one chip of the pool, the block is
        split by `parallel.shard_row_slices` and each chip transforms its
        rows in its own thread (`parallel.run_on_chips`); the outputs come
        back in row order. `predict` is row-parallel, so every row gets the
        bits one chip gives it."""
        from .parallel import fan_out_width, run_on_chips, shard_row_slices

        n = features.shape[0]
        if n >= int(config["distributed_transform_min_rows"]):
            width = fan_out_width(self.num_workers)
            pieces = [p for p in shard_row_slices(features, width)[0] if p.shape[0]]
            if len(pieces) > 1:
                outs, _ = run_on_chips(len(pieces), lambda r: self._transform_arrays(pieces[r]),
                                       name="srml-transform")
                if isinstance(outs[0], tuple):
                    return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))
                return np.concatenate(outs, axis=0)
        batch = int(config["max_records_per_batch"])
        program = PredictProgram(self, cap=batch)
        outs = []
        for start in range(0, n, batch) if n else (0,):
            # a CSR block is densified batch by batch
            result, n_valid = program.dispatch(as_dense(features[start:min(start + batch, n)]))
            outs.append(program.fetch(result, n_valid))
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))
        return np.concatenate(outs, axis=0)

    def _transform_resident(self, X: torch.Tensor) -> Any:
        """`_transform_arrays` over rows already on the device (the tuning
        layer's held-out rows, taken from the fit's placement): the same
        predict in batches of ``config["max_records_per_batch"]`` rows,
        fetched as numpy. `predict` is row-parallel, so a row's outputs are
        the bits `_transform_arrays` gives it."""
        construct, predict = self._get_transform_func()
        state = construct()
        n = X.shape[0]
        batch = int(config["max_records_per_batch"])
        outs = []
        for start in range(0, n, batch) if n else (0,):
            result = predict(state, X[start:start + batch])
            if isinstance(result, tuple):
                outs.append(tuple(r.cpu().numpy() for r in result))
            else:
                outs.append(result.cpu().numpy())
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))
        return np.concatenate(outs, axis=0)

    def transform(self, dataset: Any):
        pdf = as_pandas(dataset)
        extracted = self._pre_process_data(dataset, for_fit=False)
        result = self._transform_arrays(extracted.features)
        out = pdf.copy(deep=False)
        names = self._out_column_names()
        for name, vals in self._split_output(result, names, extracted).items():
            out[name] = vals
        return out

    def _split_output(
        self, result: np.ndarray, names: List[str], extracted: ExtractedData
    ) -> Dict[str, Any]:
        """Map raw predict output to output columns: a 1-D result is one
        scalar column; a 2-D result is one vector column, of DenseVectors
        when the input features were vectors, else of per-row arrays."""
        name = names[0]
        if result.ndim > 1:
            if extracted.feature_kind == "vector":
                return {name: [DenseVector(row) for row in result]}
            return {name: list(result)}
        return {name: result}


# ---------------------------------------------------------------------------
# Persistence: metadata JSON + npz array sidecar (the JAX package's layout).
# ---------------------------------------------------------------------------


def _prepare_save_path(path: str, overwrite: bool) -> None:
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(f"Path {path} already exists; use write().overwrite().save()")
        shutil.rmtree(path)
    os.makedirs(path)


class CompositeWriter:
    """Writer for models made of other models (CrossValidatorModel,
    TrainValidationSplitModel, PipelineModel): one metadata.json with the
    class and the caller's fields, then one sub-save per child in the
    child's own format.

    build_meta(instance) -> dict of extra metadata fields;
    iter_children(instance) -> iterable of (relative_subdir, child)."""

    def __init__(self, instance: Any, build_meta, iter_children) -> None:
        self.instance = instance
        self._build_meta = build_meta
        self._iter_children = iter_children
        self._overwrite = False

    def overwrite(self) -> "CompositeWriter":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        inst = self.instance
        _prepare_save_path(path, self._overwrite)
        meta = {"class": f"{type(inst).__module__}.{type(inst).__qualname__}", **self._build_meta(inst)}
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=2)
        for rel, child in self._iter_children(inst):
            child.write().overwrite().save(os.path.join(path, rel))


_JAX_PACKAGE = "spark_rapids_ml_tpu"


def load_instance(path: str):
    """Load any saved estimator or model by the class its metadata names.
    A class of the JAX package is loaded as this package's class of the same
    module path and name (the on-disk layout is shared)."""
    import importlib

    with open(os.path.join(path, "metadata.json")) as f:
        qualname = json.load(f)["class"]
    module, _, name = qualname.rpartition(".")
    head, _, rest = module.partition(".")
    if head == _JAX_PACKAGE:
        module = f"{__package__}.{rest}" if rest else __package__
    obj: Any = importlib.import_module(module)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj.load(path)


class _TpuWriter:
    def __init__(self, instance: Union[_TpuEstimator, _TpuModel]):
        self.instance = instance
        self._overwrite = False

    def overwrite(self) -> "_TpuWriter":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        inst = self.instance
        _prepare_save_path(path, self._overwrite)
        metadata = {
            "class": f"{type(inst).__module__}.{type(inst).__qualname__}",
            "uid": inst.uid,
            "paramMap": {p.name: v for p, v in inst._paramMap.items() if _jsonable(v)},
            "defaultParamMap": {p.name: v for p, v in inst._defaultParamMap.items() if _jsonable(v)},
            "solver_params": {k: v for k, v in inst._solver_params.items() if _jsonable(v)},
            "num_workers": inst._num_workers,
            "float32_inputs": inst._float32_inputs,
            "is_model": isinstance(inst, _TpuModel),
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2)
        if isinstance(inst, _TpuModel):
            self._write_model_attributes(inst, path)

    def _write_model_attributes(self, inst: "_TpuModel", path: str) -> None:
        """npz bundle of the array attributes + JSON of the scalars."""
        arrays = {}
        scalars = {}
        for k, v in inst._model_attributes.items():
            if isinstance(v, np.ndarray):
                arrays[k] = v
            elif isinstance(v, (list, tuple)) and len(v) and isinstance(v[0], np.ndarray):
                for i, a in enumerate(v):
                    arrays[f"{k}__list{i}"] = a
                scalars[f"{k}__listlen"] = len(v)
            else:
                scalars[k] = v
        np.savez(os.path.join(path, "arrays.npz"), **arrays)
        with open(os.path.join(path, "attributes.json"), "w") as f:
            json.dump(scalars, f, default=_np_default)


class _TpuReader:
    def __init__(self, cls: type):
        self.cls = cls

    def load(self, path: str):
        with open(os.path.join(path, "metadata.json")) as f:
            metadata = json.load(f)
        cls = self.cls
        if metadata["is_model"]:
            attrs = self._read_model_attributes(path)
            inst = cls(**attrs)
            inst._model_attributes = attrs
        else:
            inst = cls()
        self._restore_params(inst, metadata)
        return inst

    def _read_model_attributes(self, path: str) -> Dict[str, Any]:
        """Inverse of `_TpuWriter._write_model_attributes`."""
        scalars: Dict[str, Any] = {}
        attrs_path = os.path.join(path, "attributes.json")
        if os.path.exists(attrs_path):
            with open(attrs_path) as f:
                scalars = json.load(f)
        arrays_path = os.path.join(path, "arrays.npz")
        attrs: Dict[str, Any] = {}
        if os.path.exists(arrays_path):
            with np.load(arrays_path, allow_pickle=False) as npz:
                attrs.update({k: npz[k] for k in npz.files})
        # reassemble list-of-array attributes
        list_lens = {k[: -len("__listlen")]: v for k, v in scalars.items() if k.endswith("__listlen")}
        for base, ln in list_lens.items():
            attrs[base] = [attrs.pop(f"{base}__list{i}") for i in range(ln)]
            scalars.pop(f"{base}__listlen")
        attrs.update(scalars)
        return attrs

    def _restore_params(self, inst: Any, metadata: Dict[str, Any]) -> None:
        for name, v in metadata["defaultParamMap"].items():
            if inst.hasParam(name):
                inst._defaultParamMap[inst.getParam(name)] = v
        for name, v in metadata["paramMap"].items():
            if inst.hasParam(name):
                inst._paramMap[inst.getParam(name)] = v
        inst._solver_params.update(metadata["solver_params"])
        inst._num_workers = metadata["num_workers"]
        inst._float32_inputs = metadata["float32_inputs"]
        inst.uid = metadata["uid"]
        return inst


def _jsonable(v: Any) -> bool:
    try:
        json.dumps(v, default=_np_default)
        return True
    except (TypeError, ValueError):
        return False


def _np_default(o: Any):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
