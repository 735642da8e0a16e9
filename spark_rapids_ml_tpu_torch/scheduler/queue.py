#
# FitScheduler: the multi-tenant fit queue. The port's copy of
# spark_rapids_ml_tpu/scheduler/queue.py, with its 2-D book.
#
# Many tenants share one card's memory. The scheduler composes three things
# earlier layers built:
#
#   * the admission's byte estimates (memory.resident_estimate /
#     streaming_estimate) are the BIN-PACKING input: jobs whose placements
#     and workspaces fit the shared `HbmLedger` together are CO-ADMITTED and
#     run at once, each on a worker thread of the scheduler; the rest queue in
#     priority order (higher first, FIFO among equals);
#   * the solver checkpoints (checkpoint.py) are PREEMPTION: a
#     higher-priority job that does not fit asks the lowest-priority running
#     fit to yield at its next checkpoint boundary (the cooperative flag of
#     scheduler/context.py); the yielded fit's checkpoint stays in the
#     job-owned store, its claim is freed at once, and a later re-admission
#     resumes bit for bit;
#   * the out-of-core path is DEGRADED-MODE service: a job preempted
#     `config["sched_max_preemptions"]` times is demoted to streaming (a
#     floor-chunk footprint that packs into almost any budget), so a tenant
#     displaced again and again makes progress instead of starving.
#     Estimators with no streaming path are never demoted.
#
# Passes run on submit and on every job transition (no dispatcher thread).
# Each scans the priority-ordered queue first-fit under the ledger's
# admission lock, stops backfilling while a preemption is pending for a
# blocked higher-priority job (the room is coming; filling it would starve
# that job again), and otherwise backfills smaller jobs into what is left.
#
# Preemption needs a checkpoint cadence: at
# ``config["checkpoint_every_iters"] == 0`` solvers reach no boundary, so
# running fits are not preemptible, no preemption is requested, and a
# higher-priority job waits for a completion.
#
# Admitted jobs run on a fixed pool of `config["sched_max_concurrent"]`
# worker threads, started when the scheduler is built. Each worker takes
# its cuBLAS handle and workspace on the card first (one small product),
# and the constructor waits for that: the handles live as long as the
# scheduler, and their workspaces are allocated before any job's
# placement. A thread made for each job would take a fresh workspace,
# which the caching allocator can carve out of a freed placement's
# segment, keeping the whole segment reserved.
#
# A worker starts from a fresh context: the device pin
# (`parallel.set_devices`) is process-global and reaches it; a caller's
# `core.device_dataset_scope` does not (each job places its own rows, so
# two co-admitted jobs never share a placement, a page-locked staging
# buffer or a scope's cache entry).
#
# A job is as wide as its fit: ``min(num_workers, chips in the pool)``
# (`parallel.default_devices`). With chip placement on
# (`FitScheduler(chip_placement=True)`, default
# ``config["sched_chip_placement"]``) claims name WHICH chips they hold: a
# pass first-fits each job onto a CONTIGUOUS run of free chips of its
# width (`_place_job_locked`; the ledger refuses an overlap whatever the
# bytes), and the job's fit runs pinned to its run (`parallel.chip_scope`),
# so jobs of half the pool's width co-admit onto disjoint halves. A
# preemption is requested only when evicting the lower-priority jobs frees
# both the bytes and a run of the width (`_chips_freeable_locked`). A
# claim's chips return to the pool when the job ends or yields; a resumed
# job places first-fit again, possibly on another run (its checkpoints are
# the chips' host-side state). Off, claims are bytes only and name no
# chips.
#
# Under a multi-process TpuContext the scheduler refuses (A10i, second
# half: each rank driving several chips).
#
from __future__ import annotations

import logging
import threading
import time
from queue import SimpleQueue
from typing import Any, Dict, List, Optional

from ..errors import PreemptedError, SchedulerSaturatedError
from ..ops_plane import audit as _audit
from ..ops_plane import slo as _slo
from ..utils import lockcheck
from .context import job_scope
from .ledger import global_ledger

__all__ = ["FitJob", "FitScheduler"]

_LOG = logging.getLogger(__name__)

# seconds a new scheduler waits for its workers to take their handles
_WORKER_START_TIMEOUT_S = 120.0


def _take_library_handles() -> None:
    """Make the calling thread's cuBLAS handle and workspace on the card the
    jobs run on: one small product, plain and with a bias (the cuBLAS and
    cuBLASLt routes). Nothing to do on the CPU, or without a card (each
    job's fit then raises that itself)."""
    from ..parallel import default_device

    try:
        dev = default_device()
    except RuntimeError:
        return
    if dev.type != "cuda":
        return
    import torch

    with torch.cuda.device(dev):
        a = torch.ones((8, 8), device=dev)
        torch.addmm(a[0], a, a)
        torch.mm(a, a)
        torch.cuda.synchronize(dev)


class FitJob:
    """One submitted fit: the estimator and dataset, its tenant and
    priority, the job-owned `CheckpointStore` (it outlives preemptions: the
    resume's substrate), and a future's surface (`result()`, `done()`).

    `stats()` is the per-tenant telemetry the scheduler stamps on the
    finished model's ``_fit_metrics["scheduler"]``: queue wait, preemptions
    and resumes, demotion, and the job's share of the budget at admission."""

    def __init__(
        self,
        job_id: int,
        estimator: Any,
        dataset: Any,
        tenant: str,
        priority: int,
        warm_start_from: Any = None,
    ) -> None:
        from .. import checkpoint as _ckpt

        self.job_id = int(job_id)
        self.estimator = estimator
        self.dataset = dataset
        self.tenant = str(tenant)
        self.priority = int(priority)
        self.warm_start_from = warm_start_from
        # installed around every run attempt (checkpoint_scope(store=...)),
        # so the checkpoints a preemption leaves are what the resume restores
        self.store = _ckpt.CheckpointStore()
        # queued -> running -> completed | failed, or -> preempted -> running;
        # refused at submit
        self.state = "queued"
        self.preemptions = 0
        self.resumes = 0
        self.demoted = False
        self.demote_to_stream = False
        self.reservation: Any = None  # the ledger's HbmReservation while admitted
        self.admitted_bytes = 0
        self.hbm_share = 0.0
        self.queue_wait_s = 0.0
        self.run_s = 0.0
        self._wait_since = time.monotonic()
        self._run_since: Optional[float] = None
        # the preflight's byte estimates, and the cards they span (the
        # chip-seconds multiplier of the per-tenant accounting)
        self.resident_estimate: Any = None
        self.stream_floor_estimate: Any = None
        self.chips = 1
        # 2-D placement: the chip ids the job's claim holds and their
        # devices, while admitted (None without chip placement)
        self.chip_ids: Any = None
        self.placed_devices: Any = None
        self._preempt = threading.Event()
        self._preempt_reason = ""
        self._done = threading.Event()
        self._model: Any = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------ future --
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Wait for the job's end and return the fitted model, or raise the
        job's failure (a `SchedulerSaturatedError` refusal, a shutdown). The
        model's ``_fit_metrics["scheduler"]`` carries `stats()`."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"job {self.job_id} ({self.tenant!r}) not done within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._model

    # -------------------------------------------------------- preemption --
    def request_preempt(self, reason: str) -> None:
        self._preempt_reason = reason
        self._preempt.set()

    def preempt_requested(self) -> bool:
        return self._preempt.is_set()

    def check_preempt(self, solver: str, iteration: int) -> None:
        """The cooperative yield point (`context.preemption_point` calls it):
        raises `PreemptedError` when flagged. Called only at checkpoint
        boundaries, after the boundary's checkpoint saved, so unwinding here
        loses no work."""
        if self._preempt.is_set():
            raise PreemptedError(self.job_id, solver=solver, iteration=iteration, reason=self._preempt_reason)

    # ------------------------------------------------------------- stats --
    def stats(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id,
            "tenant": self.tenant,
            "priority": self.priority,
            "state": self.state,
            "queue_wait_s": self.queue_wait_s,
            "run_s": self.run_s,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "demoted": self.demoted,
            "admitted_bytes": self.admitted_bytes,
            "hbm_share": self.hbm_share,
            "chips": self.chips,
            "chip_ids": list(self.chip_ids) if self.chip_ids is not None else None,
        }

    def _finish(self, model: Any) -> None:
        self.state = "completed"
        self._model = model
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self.state = "refused" if isinstance(exc, SchedulerSaturatedError) else "failed"
        self._error = exc
        self._done.set()


class FitScheduler:
    """Priority job queue with bin-packed co-admission and checkpoint
    preemption over the shared `HbmLedger` (see the module note).

    ``submit(estimator, dataset, tenant=, priority=)`` returns a `FitJob`
    future. Higher `priority` runs first; ties are FIFO. Admitted jobs run
    on the scheduler's worker threads (`config["sched_max_concurrent"]` of
    them, started here, or `max_concurrent`), so co-admitted fits overlap
    on the card. `chip_placement` turns the 2-D book on (default
    ``config["sched_chip_placement"]``). The ledger is the process-global
    one, and `config["sched_max_preemptions"]` is read here too.
    `shutdown()` (or leaving a ``with`` block) stops the workers."""

    def __init__(self, *, chip_placement: Optional[bool] = None, max_concurrent: Optional[int] = None) -> None:
        from ..core import config

        self._ledger = global_ledger()
        self._chip_placement = bool(
            chip_placement if chip_placement is not None else config.get("sched_chip_placement", False)
        )
        self._max_concurrent = max(1, int(
            max_concurrent if max_concurrent is not None else config.get("sched_max_concurrent", 4)
        ))
        self._max_preemptions = int(config.get("sched_max_preemptions", 2))
        self._lock = lockcheck.make_lock("scheduler.queue.FitScheduler._lock", "rlock")
        self._queue: List[FitJob] = []  # guarded-by: _lock
        self._running: Dict[int, FitJob] = {}  # guarded-by: _lock
        self._jobs: List[FitJob] = []  # guarded-by: _lock
        self._next_id = 1  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # admitted jobs, for the workers; one None per worker stops it
        self._work: "SimpleQueue[Optional[FitJob]]" = SimpleQueue()
        ready = [threading.Event() for _ in range(self._max_concurrent)]
        failed: List[BaseException] = []
        self._workers = [
            threading.Thread(target=self._worker, args=(e, failed), name=f"srml-sched-worker-{i}", daemon=True)
            for i, e in enumerate(ready)
        ]
        for t in self._workers:
            t.start()
        if not all(e.wait(_WORKER_START_TIMEOUT_S) for e in ready) or failed:
            self.shutdown(wait=False)
            if failed:
                raise failed[0]
            raise RuntimeError(f"FitScheduler: a worker took no card handle within {_WORKER_START_TIMEOUT_S} s")
        # the opt-in scrape surface (SRML_METRICS_PORT): a long-lived
        # scheduler is the process an operator wants /metrics on
        from ..ops_plane import ensure_server

        ensure_server()

    # ------------------------------------------------------------ submit --
    def submit(
        self,
        estimator: Any,
        dataset: Any,
        *,
        tenant: str = "default",
        priority: int = 0,
        warm_start_from: Any = None,
    ) -> FitJob:
        """Queue one fit; returns at once with its `FitJob`.

        Raises `SchedulerSaturatedError`, the typed refusal, when the job's
        SMALLEST footprint (the streaming floor, or the resident estimate of
        an estimator with no out-of-core path) exceeds the whole budget: no
        queueing or preemption could ever place it."""
        from .. import telemetry
        from ..parallel import refuse_spmd

        refuse_spmd("FitScheduler (each rank driving several chips)", "A10i, second half")
        with self._lock:
            if self._closed:
                raise RuntimeError("FitScheduler is shut down")
            job = FitJob(self._next_id, estimator, dataset, tenant, priority, warm_start_from)
            self._next_id += 1
            # registered BEFORE the preflight: a refused job still shows in
            # stats()'s per-tenant roll-up
            self._jobs.append(job)
        self._preflight(job)
        reg = telemetry.registry()
        reg.inc("scheduler.jobs_submitted")
        with self._lock:
            self._queue.append(job)
            self._schedule_locked()
            if job.state == "queued":
                reg.inc("scheduler.jobs_queued")
        return job

    def _preflight(self, job: FitJob) -> None:
        """The byte estimates of bin-packing, and the cannot-ever-fit
        refusal. The extraction selects columns on the host: a 2-D float
        block of the fit's dtype is viewed, not copied, and is dropped after
        estimating (the fit extracts again), so a queued job holds no second
        copy of its rows."""
        from .. import memory, telemetry
        from ..parallel import default_devices

        est = job.estimator
        extracted = est._pre_process_data(job.dataset, for_fit=True, defer_validation=True)
        job.chips = max(1, min(int(est.num_workers), len(default_devices())))
        job.resident_estimate = memory.resident_estimate(est, extracted, job.chips)
        if getattr(est, "_supports_streaming_fit", False):
            floor = min(memory.MIN_STREAM_CHUNK_ROWS, max(1, int(extracted.n_rows)))
            job.stream_floor_estimate = memory.streaming_estimate(est, extracted, job.chips, floor)
        del extracted
        budget = self._budget()
        minimal = job.stream_floor_estimate if job.stream_floor_estimate is not None else job.resident_estimate
        if budget is not None and minimal.total() > budget:
            name, nbytes = minimal.largest()
            exc = SchedulerSaturatedError(
                f"job for tenant {job.tenant!r} ({type(est).__name__}) cannot ever be scheduled: "
                "its smallest working set exceeds the whole budget",
                tenant=job.tenant,
                estimate_bytes=minimal.total(),
                budget_bytes=budget,
                largest_term=name,
                largest_term_bytes=nbytes,
                terms=minimal.terms,
            )
            telemetry.registry().inc("scheduler.jobs_refused")
            _audit.record_decision(
                "admission", "scheduler", "refused", subject=f"job:{job.job_id}", tenant=job.tenant,
                reason=str(exc), estimate_bytes=minimal.total(), budget_bytes=budget,
            )
            job._fail(exc)
            raise exc

    # -------------------------------------------------------- scheduling --
    def _budget(self) -> Optional[int]:
        """The budget of the card the jobs run on: capacity x (1 - headroom),
        read without spending an `oom:budget=` fault's firing (passes read it
        often; each such entry must demote exactly its count of fit
        admissions)."""
        from .. import memory
        from ..parallel import default_device, device_capacity_bytes

        capacity = device_capacity_bytes(default_device(), consume_chaos=False)
        if capacity is None:
            return None
        return int(capacity * (1.0 - memory.headroom_fraction()))

    def _need_bytes(self, job: FitJob, budget: Optional[int]) -> int:
        """The bytes the job's NEXT admission claims: the streaming floor
        once demoted (or when the resident set alone exceeds the budget: the
        fit's own admission would stream it anyway), else the resident
        estimate."""
        resident = job.resident_estimate.total()
        if job.stream_floor_estimate is not None and (
            job.demote_to_stream or (budget is not None and resident > budget)
        ):
            return int(job.stream_floor_estimate.total())
        return int(resident)

    def _chip_pool(self) -> List[Any]:
        """(device, chip id) of every chip of the pool, in pool order."""
        from ..parallel import current_chip_ids, default_devices

        return list(zip(default_devices(), current_chip_ids()))

    def _place_job_locked(self, job: FitJob, need: int, budget: Optional[int], pool: List[Any]) -> Any:
        """2-D admission of one job (the caller holds the ledger's admission
        lock): first-fit over CONTIGUOUS runs of the job's width in pool
        order; the ledger's `try_reserve(chip_ids=...)` checks occupancy and
        each chip's bytes, so a run that fails either slides right. Returns
        the claim (the chips recorded on the job) or None."""
        width = max(1, min(int(job.chips), len(pool)))
        for start in range(0, len(pool) - width + 1):
            window = pool[start:start + width]
            chip_ids = [c for _, c in window]
            r = self._ledger.try_reserve(
                f"job:{job.job_id}:{job.tenant}", "job", need, budget=budget, tenant=job.tenant, chip_ids=chip_ids,
            )
            if r is not None:
                job.chip_ids = tuple(chip_ids)
                job.placed_devices = [d for d, _ in window]
                return r
        return None

    def _schedule_locked(self) -> None:
        """One co-admission pass (the caller holds `self._lock`): first-fit
        over the priority-ordered queue under the ledger's admission lock,
        preemption for a blocked higher-priority job, backfill otherwise.
        With chip placement the first-fit is over contiguous chip runs as
        well as bytes."""
        from .. import telemetry

        if self._closed:
            return
        budget = self._budget()
        self._queue.sort(key=lambda j: (-j.priority, j.job_id))  # FIFO among equals
        reg = telemetry.registry()
        to_start: List[FitJob] = []
        pool = self._chip_pool() if self._chip_placement else []
        self._ledger.note_chip_pool(len(pool) if self._chip_placement else None)
        with self._ledger.admission():
            for job in list(self._queue):
                if len(self._running) + len(to_start) >= self._max_concurrent:
                    break
                need = self._need_bytes(job, budget)
                if self._chip_placement:
                    r = self._place_job_locked(job, need, budget, pool)
                else:
                    r = self._ledger.try_reserve(
                        f"job:{job.job_id}:{job.tenant}", "job", need, budget=budget, tenant=job.tenant,
                        chips=job.chips,
                    )
                self._ledger.note_admission(budget)
                if r is not None:
                    job.reservation = r
                    job.admitted_bytes = need
                    job.hbm_share = (need / budget) if budget else 0.0
                    to_start.append(job)
                    continue
                # blocked: the highest-priority job that does not fit may
                # preempt; while its preemption is pending, no backfill
                if self._maybe_preempt_locked(job, need, budget):
                    break
                if any(v.preempt_requested() for v in self._running.values()):
                    break
                # no victim: keep scanning, a smaller job lower in the queue
                # may still pack into what is left
        now = time.monotonic()
        for job in to_start:
            self._queue.remove(job)
            wait = now - job._wait_since
            job.queue_wait_s += wait
            reg.inc("scheduler.jobs_admitted")
            reg.observe("scheduler.queue_wait_s", wait)
            reg.observe("scheduler.hbm_share", job.hbm_share)
            _audit.record_decision(
                "admission", "scheduler", "resumed" if job.state == "preempted" else "admitted",
                subject=f"job:{job.job_id}", tenant=job.tenant, priority=job.priority,
                admitted_bytes=job.admitted_bytes, queue_wait_s=round(wait, 6),
            )
            if job.state == "preempted":
                job.resumes += 1
                reg.inc("scheduler.jobs_resumed")
            job.state = "running"
            job._run_since = now
            self._running[job.job_id] = job
            self._work.put(job)
        if to_start:
            # queue-wait histograms were just recorded: the SLO monitors'
            # inline evaluation point (throttled; a no-op without specs)
            _slo.maybe_evaluate()

    def _maybe_preempt_locked(self, job: FitJob, need: int, budget: Optional[int]) -> bool:
        """Ask the lowest-priority running fit to yield when that can make
        room for `job`; returns whether a preemption is now pending for it.
        One victim at a time: the pass runs again when the victim unwinds,
        and escalates only if still blocked.

        With no checkpoint cadence solvers never reach a yield point, so a
        request would never be honored while its pending flag halted all
        backfill: none is made; high-priority jobs wait for completions."""
        from .. import checkpoint as _ckpt

        if budget is None or _ckpt.every_iters() <= 0:
            return False
        victims = [v for v in self._running.values() if v.priority < job.priority]
        if not victims:
            return False
        freeable = sum(v.reservation.nbytes for v in victims if v.reservation is not None)
        if self._ledger.reserved_bytes() - freeable + need > budget:
            return False  # even evicting every lower-priority fit cannot make room
        if self._chip_placement and not self._chips_freeable_locked(job, victims):
            return False  # room in bytes but not in chips: other claims pin every run of the width
        if any(v.preempt_requested() for v in victims):
            return True  # already waiting on a boundary
        victim = min(victims, key=lambda v: (v.priority, -v.job_id))
        _LOG.info(
            "preempting job %d (tenant %r, priority %d) for job %d (tenant %r, priority %d)",
            victim.job_id, victim.tenant, victim.priority, job.job_id, job.tenant, job.priority,
        )
        victim.request_preempt(f"higher-priority job {job.job_id} (tenant {job.tenant!r}) needs the reservation")
        _audit.record_decision(
            "preemption", "scheduler", "requested", subject=f"job:{victim.job_id}", tenant=victim.tenant,
            reason=victim._preempt_reason, victim_priority=victim.priority, for_job=job.job_id,
            for_tenant=job.tenant, for_priority=job.priority,
        )
        return True

    def _chips_freeable_locked(self, job: FitJob, victims: List[FitJob]) -> bool:
        """Whether evicting every lower-priority victim opens a contiguous
        run of the job's width; chips held by other claims stay held."""
        victim_chips: set = set()
        for v in victims:
            if v.reservation is not None and v.reservation.chip_ids is not None:
                victim_chips.update(v.reservation.chip_ids)
        pinned = self._ledger.occupied_chips() - victim_chips
        pool = self._chip_pool()
        width = max(1, min(int(job.chips), len(pool)))
        run = 0
        for _, chip in pool:
            run = 0 if chip in pinned else run + 1
            if run >= width:
                return True
        return False

    # ----------------------------------------------------------- running --
    def _worker(self, ready: threading.Event, failed: List[BaseException]) -> None:
        """A worker thread's body: take the card handles, then run admitted
        jobs one after another until a None arrives."""
        try:
            _take_library_handles()
        except BaseException as e:
            failed.append(e)
            return
        finally:
            ready.set()
        while True:
            job = self._work.get()
            if job is None:
                return
            self._run_job(job)

    def _run_job(self, job: FitJob) -> None:
        """One admitted job on a worker: the whole fit inside `job_scope` (so
        `memory.admit_fit` trues up the job's claim and the solvers see the
        preemption flag) and the job-owned checkpoint store (so a preempted
        attempt's checkpoints survive into the resume); with chip placement,
        pinned to the job's chips, so every placement and fan-out of its fit
        lands on them."""
        import contextlib

        from .. import checkpoint as _ckpt
        from .. import telemetry
        from ..parallel import chip_scope

        reg = telemetry.registry()
        requeue = False
        pin = (
            chip_scope(job.placed_devices, chip_ids=job.chip_ids)
            if job.placed_devices else contextlib.nullcontext()
        )
        try:
            with pin, job_scope(job), _ckpt.checkpoint_scope(store=job.store):
                if job.warm_start_from is not None:
                    model = job.estimator.fit(job.dataset, warm_start_from=job.warm_start_from)
                else:
                    model = job.estimator.fit(job.dataset)
            # the scheduler's telemetry rides the result, always (why a fit
            # waited, yielded or streamed is robustness state, not a metric);
            # `_fit_metrics` is shared by a fit's models, so stamp a copy
            job.state = "completed"
            metrics = dict(getattr(model, "_fit_metrics", {}) or {})
            metrics["scheduler"] = job.stats()
            model._fit_metrics = metrics
            job._finish(model)
            reg.inc("scheduler.jobs_completed")
        except PreemptedError:
            requeue = True
        except BaseException as e:  # a dead job must never keep its claim or wedge the queue
            job._fail(e)
            reg.inc("scheduler.jobs_failed")
            _LOG.warning("job %d (tenant %r) failed: %s: %s", job.job_id, job.tenant, type(e).__name__, e)
        finally:
            with self._lock:
                self._running.pop(job.job_id, None)
                if job._run_since is not None:
                    job.run_s += time.monotonic() - job._run_since
                    job._run_since = None
                self._ledger.release(job.reservation)
                job.reservation = None
                # the chips return to the pool with the bytes; a resumed job
                # places first-fit again, possibly on another run
                job.chip_ids = None
                job.placed_devices = None
                if requeue and not self._closed:
                    job.preemptions += 1
                    job._preempt.clear()
                    job._preempt_reason = ""
                    job.state = "preempted"
                    job._wait_since = time.monotonic()
                    reg.inc("scheduler.jobs_preempted")
                    _audit.record_decision(
                        "preemption", "scheduler", "preempted", subject=f"job:{job.job_id}", tenant=job.tenant,
                        preemptions=job.preemptions, priority=job.priority,
                    )
                    if (
                        job.preemptions >= self._max_preemptions
                        and job.stream_floor_estimate is not None
                        and not job.demote_to_stream
                    ):
                        # degraded-mode service: the job streams from here on
                        job.demote_to_stream = True
                        job.demoted = True
                        reg.inc("scheduler.jobs_demoted")
                        _audit.record_decision(
                            "demotion", "scheduler", "stream", subject=f"job:{job.job_id}", tenant=job.tenant,
                            reason=f"preempted {job.preemptions} time(s) (config['sched_max_preemptions'])",
                        )
                        _LOG.warning(
                            "job %d (tenant %r) preempted %d time(s); demoting it to the streaming path",
                            job.job_id, job.tenant, job.preemptions,
                        )
                    self._queue.append(job)
                elif requeue:
                    job._fail(RuntimeError("FitScheduler shut down mid-preemption"))
                self._schedule_locked()

    # ------------------------------------------------------------- stats --
    def stats(self) -> Dict[str, Any]:
        """Per-tenant roll-up of every job this scheduler saw (queue waits
        with their p50/p99, preemptions, resumes, demotions, completions),
        the ledger's view (reserved bytes, high watermark, utilization,
        per-tenant byte- and chip-seconds) and the process-wide queue-wait
        percentiles (`telemetry.summarize_histogram`)."""
        from .. import telemetry

        with self._lock:
            jobs = list(self._jobs)
            running = len(self._running)
            queued = len(self._queue)
        tenants: Dict[str, Dict[str, Any]] = {}
        for j in jobs:
            t = tenants.setdefault(j.tenant, {
                "jobs": 0, "completed": 0, "failed": 0, "preemptions": 0, "resumes": 0, "demotions": 0,
                "queue_wait_s": [],
            })
            t["jobs"] += 1
            t["completed"] += int(j.state == "completed")
            t["failed"] += int(j.state in ("failed", "refused"))
            t["preemptions"] += j.preemptions
            t["resumes"] += j.resumes
            t["demotions"] += int(j.demoted)
            t["queue_wait_s"].append(j.queue_wait_s)
        for t in tenants.values():
            t["queue_wait_p50_s"] = telemetry.quantile_of(t["queue_wait_s"], 0.5)
            t["queue_wait_p99_s"] = telemetry.quantile_of(t["queue_wait_s"], 0.99)
        wait = telemetry.summarize_histogram("scheduler.queue_wait_s")
        return {
            "tenants": tenants,
            "running": running,
            "queued": queued,
            "queue_wait_p50_s": wait["p50"],
            "queue_wait_p99_s": wait["p99"],
            "ledger_reserved_bytes": self._ledger.reserved_bytes(),
            "ledger_high_watermark": self._ledger.high_watermark,
            "ledger_utilization": self._ledger.utilization(),
            "ledger_occupied_chips": sorted(self._ledger.occupied_chips()),
            "chip_placement": self._chip_placement,
            "tenant_usage": self._ledger.tenant_usage(),
        }

    # ---------------------------------------------------------- shutdown --
    def shutdown(self, wait: bool = True, timeout: Optional[float] = None) -> None:
        """Stop admitting. Queued (never run) jobs fail typed; admitted jobs
        finish, and then the workers stop, joined when `wait`. Idempotent."""
        with self._lock:
            stopping = not self._closed
            self._closed = True
            drained, self._queue = self._queue, []
        for job in drained:
            job._fail(RuntimeError("FitScheduler shut down before the job ran"))
        if stopping:
            for _ in self._workers:
                self._work.put(None)  # after every admitted job: the queue is FIFO
        if wait:
            deadline = None if timeout is None else time.monotonic() + timeout
            for t in self._workers:
                if t is not threading.current_thread():
                    t.join(None if deadline is None else max(0.0, deadline - time.monotonic()))

    def __enter__(self) -> "FitScheduler":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown(wait=True)
