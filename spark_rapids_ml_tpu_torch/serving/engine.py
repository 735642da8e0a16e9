#
# ScoringEngine: concurrent predict requests, micro-batched up the bucket
# ladder and dispatched to the card. The port's copy of
# spark_rapids_ml_tpu/serving/engine.py.
#
# The path of one request:
#
#   submit() ──queue──▶ coalesce (bounded window, same-model requests merge
#   into one block) ──▶ PredictProgram.dispatch per ≤cap chunk (pads up the
#   geometric bucket ladder, launches the model's kernels; no device-to-host
#   copy) ──▶ response assembly: the ONE `torch.cuda.synchronize` point ──▶
#   PredictProgram.fetch per chunk ──▶ per-request output slices ──▶ futures
#   resolve.
#
# Because `predict` is row-parallel, and every per-row result of the
# kernels on the path is one fixed-order sum whatever the batch, a coalesced
# batch's per-request slices are bit-identical to serving each request solo.
#
# Every request carries a server-side monotonic deadline (submit(deadline_ms=),
# default `config["serve_default_deadline_ms"]`): an expired request NEVER
# dispatches (typed RequestTimeoutError). Admission, the refusal point, runs
# before the request queues: the bounded queue and the deadline-feasibility
# check live in `serving.overload.OverloadController` and raise typed
# ServeOverloadError.
#
# Telemetry (telemetry.py, while enabled): serve.requests / rows / batches /
# coalesced_batches / coalesced_requests / bucket_hits / expired_requests /
# errors / flops counters, and the serve.queue_wait_s / serve.e2e_s
# histograms with their per-tenant siblings (`telemetry.tenant_metric`).
#
# One thread, the engine's loop, launches every kernel; client threads only
# queue. Not in the port yet (ROADMAP A13): chaos delay injection at
# dispatch, the numerics sweep of responses, SLO evaluation, and the ops
# HTTP server.
#
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import telemetry
from ..data import as_dense
from ..errors import RequestTimeoutError, ServingStoppedError
from .overload import OverloadController, plan_target_rows, plan_window
from .registry import ModelRegistry

__all__ = ["ScoreFuture", "ScoringEngine"]

_LOG = logging.getLogger(__name__)


class ScoreFuture:
    """Handle for one in-flight scoring request."""

    __slots__ = (
        "name", "features", "_event", "_result", "_error", "t_submit",
        "t_done", "rows", "tenant", "deadline",
    )

    def __init__(
        self,
        name: str,
        features: np.ndarray,
        t_submit: float,
        *,
        tenant: str = "default",
        deadline: Optional[float] = None,
    ) -> None:
        self.name = name
        self.features = features
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self.t_submit = t_submit
        self.t_done: Optional[float] = None  # set at resolution
        self.rows = int(features.shape[0])
        self.tenant = tenant
        # server-side deadline, ABSOLUTE monotonic seconds (None = none)
        self.deadline = deadline

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = 30.0) -> Any:
        """Block until the response is assembled. Returns the model's predict
        output for THIS request's rows (an array, or a tuple of arrays for
        multi-output models). Raises the scoring error if the dispatch
        failed, a bare TimeoutError if `timeout` elapses first.

        A client timeout does NOT cancel the request: it stays queued (or in
        flight) and still resolves this future. Only the SERVER-side deadline
        (``submit(deadline_ms=)``) stops undispatched work."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"scoring request for model {self.name!r} did not complete "
                f"within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result: Any = None, error: Optional[BaseException] = None) -> None:
        self._result = result
        self._error = error
        self.t_done = time.monotonic()
        self._event.set()


class ScoringEngine:
    """Resident scoring service over a `ModelRegistry`.

    One worker thread drains the request queue: the oldest request opens a
    micro-batch, same-model requests arriving within the coalesce window
    (``config["serve_coalesce_window_ms"]``) merge into it, and the whole
    block dispatches as one predict call per ``config["serve_max_batch_rows"]``
    chunk. Use as a context manager, or `start()`/`stop()`."""

    _POLL_S = 0.05  # worker wake-up bound: stop/new-work latency ceiling

    def __init__(
        self,
        registry: ModelRegistry,
        *,
        coalesce_window_s: Optional[float] = None,
        max_batch_rows: Optional[int] = None,
    ) -> None:
        from ..core import config

        self.registry = registry
        # an EXPLICIT constructor window is a static override: the adaptive
        # planner never touches it
        self._window_overridden = coalesce_window_s is not None
        if coalesce_window_s is None:
            coalesce_window_s = float(config.get("serve_coalesce_window_ms", 2.0)) / 1e3
        self._window_s = max(0.0, float(coalesce_window_s))
        self._max_rows = int(max_batch_rows or config.get("serve_max_batch_rows", 8192))
        self._cond = threading.Condition()
        self._queue: "deque[ScoreFuture]" = deque()  # guarded-by: _cond
        self._queued_rows = 0  # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._overload = OverloadController()

    # ---------------------------------------------------------- lifecycle --
    def start(self) -> "ScoringEngine":
        with self._cond:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, name="srml-scoring-engine", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Drain the queue, then stop the worker. Requests still queued when
        the drain deadline elapses fail with the typed `ServingStoppedError`
        (carrying the model name and the request's queue position at
        shutdown)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
        with self._cond:
            position = 0
            while self._queue:
                fut = self._queue.popleft()
                fut._resolve(
                    error=ServingStoppedError(fut.name, queue_position=position)
                )
                position += 1
            self._queued_rows = 0
            self._thread = None

    def __enter__(self) -> "ScoringEngine":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # ------------------------------------------------------------ requests --
    def submit(
        self,
        name: str,
        features: Any,
        *,
        deadline_ms: Optional[float] = None,
        tenant: str = "default",
    ) -> ScoreFuture:
        """Enqueue one scoring request against resident model `name`.
        Residency and feature width are checked AT SUBMIT, so the caller
        gets those errors synchronously, not inside a future.

        `deadline_ms` is the SERVER-side deadline (monotonic clock, default
        ``config["serve_default_deadline_ms"]``; <= 0 disables): the engine
        never dispatches an expired request (typed `RequestTimeoutError` on
        the future), and admission refuses synchronously (typed
        `ServeOverloadError`) when the bounded queue is full or the live
        queue-wait p99 predicts the deadline cannot be met."""
        from ..core import config

        entry = self.registry.get(name)  # KeyError for unknown/evicted models
        feats = np.asarray(as_dense(features))  # a CSR request is densified
        if feats.ndim != 2:
            raise ValueError(
                f"features must be a [rows, {entry.n_cols}] block; got shape "
                f"{feats.shape}"
            )
        if entry.n_cols and feats.shape[1] != entry.n_cols:
            raise ValueError(
                f"model {name!r} expects {entry.n_cols} features; got "
                f"{feats.shape[1]}"
            )
        now = time.monotonic()
        if deadline_ms is None:
            deadline_ms = float(config.get("serve_default_deadline_ms", 30000.0))
        deadline = now + deadline_ms / 1e3 if deadline_ms > 0 else None
        # admission: the typed refusal point, BEFORE anything queues, on a
        # snapshot of the queue taken under the lock
        with self._cond:
            q_depth, q_rows = len(self._queue), self._queued_rows
        self._overload.admit(
            model=name, tenant=tenant, rows=int(feats.shape[0]),
            deadline_s=deadline, now=now,
            queue_depth=q_depth, queue_rows=q_rows,
        )
        fut = ScoreFuture(name, feats, now, tenant=tenant, deadline=deadline)
        with self._cond:
            if self._stop or self._thread is None:
                raise RuntimeError("scoring engine is not running (call start())")
            self._queue.append(fut)
            self._queued_rows += fut.rows
            if telemetry.enabled():
                reg = telemetry.registry()
                reg.gauge("serve.queue_depth", float(len(self._queue)))
                reg.gauge("serve.queue_rows", float(self._queued_rows))
            self._cond.notify_all()
        return fut

    def score(self, name: str, features: Any, timeout: Optional[float] = 30.0) -> Any:
        """Blocking convenience: submit, then wait for the response."""
        return self.submit(name, features).result(timeout)

    def stats(self) -> Dict[str, Any]:
        """Latency view of the serve.* telemetry (p50/p99 through
        `telemetry.summarize_histogram`; None while telemetry is off or
        nothing has been served), the live queue, the request counters, and
        each tenant's queue-wait and end-to-end p50/p99."""
        qw = telemetry.summarize_histogram("serve.queue_wait_s")
        e2e = telemetry.summarize_histogram("serve.e2e_s")
        counters: Dict[str, float] = {}
        if telemetry.enabled():
            counters = telemetry.registry().snapshot()["counters"]
        with self._cond:
            q_depth, q_rows = len(self._queue), self._queued_rows
        tenants: Dict[str, Any] = {}
        prefix = "serve.e2e_s."
        for hist in telemetry.registry().snapshot()["histograms"]:
            if hist.startswith(prefix):
                tenant = hist[len(prefix):]
                tqw = telemetry.summarize_histogram(
                    telemetry.tenant_metric("serve.queue_wait_s", tenant)
                )
                te2e = telemetry.summarize_histogram(hist)
                tenants[tenant] = {
                    "queue_wait_p50_s": tqw["p50"],
                    "queue_wait_p99_s": tqw["p99"],
                    "e2e_p50_s": te2e["p50"],
                    "e2e_p99_s": te2e["p99"],
                }
        return {
            "queue_wait_p50_s": qw["p50"],
            "queue_wait_p99_s": qw["p99"],
            "e2e_p50_s": e2e["p50"],
            "e2e_p99_s": e2e["p99"],
            "queue_depth": q_depth,
            "queue_rows": q_rows,
            "requests": int(counters.get("serve.requests", 0)),
            "rows": int(counters.get("serve.rows", 0)),
            "batches": int(counters.get("serve.batches", 0)),
            "coalesced_batches": int(counters.get("serve.coalesced_batches", 0)),
            "expired_requests": int(counters.get("serve.expired_requests", 0)),
            "rejected_requests": int(counters.get("serve.rejected_requests", 0)),
            "tenants": tenants,
        }

    # -------------------------------------------------------------- worker --
    def _loop(self) -> None:
        while True:  # every wait is bounded by _POLL_S; exits once stopped and drained
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(self._POLL_S)
                if not self._queue:
                    if self._stop:
                        return
                    continue
                first = self._queue.popleft()
                self._queued_rows -= first.rows
            # an expired request NEVER dispatches: it fails here, typed,
            # before any coalescing or device work
            if first.deadline is not None and time.monotonic() > first.deadline:
                self._expire(first)
                continue
            self._dispatch_group(self._coalesce(first))

    def _expire(self, fut: ScoreFuture) -> None:
        """Fail one expired request with the typed `RequestTimeoutError`
        (counter serve.expired_requests). It never touched the device."""
        now = time.monotonic()
        if telemetry.enabled():
            telemetry.registry().inc("serve.expired_requests")
        with self._cond:
            q_depth, q_rows = len(self._queue), self._queued_rows
        fut._resolve(
            error=RequestTimeoutError(
                f"scoring request for model {fut.name!r} expired before "
                "dispatch",
                model=fut.name,
                deadline_ms=(fut.deadline - fut.t_submit) * 1e3,
                waited_ms=(now - fut.t_submit) * 1e3,
                queue_depth=q_depth,
                queue_rows=q_rows,
            )
        )

    def _plan_batch(self) -> Tuple[float, int]:
        """(window_s, target_rows) of the NEXT coalesce. Static (adaptive
        batching off, telemetry off, or an explicit constructor window): the
        configured window and the row cap. Adaptive: the pure planners of
        `serving.overload`, fed the windowed arrival rate and queue-wait p99;
        uncongested traffic still gets exactly the static values."""
        from ..core import config

        base = self._window_s
        if (
            self._window_overridden
            or not bool(config.get("serve_adaptive_batching", True))
            or not telemetry.enabled()
        ):
            return base, self._max_rows
        reg = telemetry.registry()
        fast_w = reg.bucket_seconds() * 3.0
        rate = reg.rate("serve.rows", fast_w)
        p99 = reg.window_quantile("serve.queue_wait_s", 0.99, fast_w)
        with self._cond:
            q_rows = self._queued_rows
        window_s = plan_window(
            base,
            floor_s=float(config.get("serve_coalesce_window_floor_ms", 0.5)) / 1e3,
            ceiling_s=float(config.get("serve_coalesce_window_ceiling_ms", 20.0)) / 1e3,
            arrival_rows_per_s=rate,
            queue_rows=q_rows,
            queue_wait_p99_s=p99,
            max_rows=self._max_rows,
        )
        target_rows = plan_target_rows(
            min_rows=int(config.get("transform_bucket_min_rows", 256)),
            max_rows=self._max_rows,
            queue_rows=q_rows,
            arrival_rows_per_s=rate,
            window_s=window_s,
            congested=bool(p99 is not None and base > 0.0 and p99 > base),
        )
        reg.gauge("serve.adaptive_window_ms", window_s * 1e3)
        return window_s, target_rows

    def _coalesce(self, first: ScoreFuture) -> List[ScoreFuture]:
        """Grow a micro-batch from `first`: same-model requests already
        queued, or arriving inside the coalesce window, merge until the batch
        reaches the row target. Other models' requests stay queued in order.
        A zero window disables coalescing: even queued same-model requests
        dispatch solo."""
        window_s, target_rows = self._plan_batch()
        if window_s <= 0.0:
            return [first]
        group = [first]
        rows = first.rows
        deadline = time.monotonic() + window_s
        while rows < target_rows:
            with self._cond:
                took = None
                for i, fut in enumerate(self._queue):
                    if fut.name == first.name:
                        took = fut
                        del self._queue[i]
                        self._queued_rows -= fut.rows
                        break
                if took is None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop:
                        break
                    self._cond.wait(min(remaining, self._POLL_S))
                    continue
            group.append(took)
            rows += took.rows
        return group

    def _dispatch_group(self, group: List[ScoreFuture]) -> None:
        t0 = time.monotonic()
        reg = telemetry.registry() if telemetry.enabled() else None
        # members whose deadline passed while the batch formed fail typed
        # HERE, before any device work
        live: List[ScoreFuture] = []
        for fut in group:
            if fut.deadline is not None and t0 > fut.deadline:
                self._expire(fut)
            else:
                live.append(fut)
        group = live
        if not group:
            return
        if reg is not None:
            reg.inc("serve.requests", len(group))
            reg.inc("serve.batches")
            if len(group) > 1:
                reg.inc("serve.coalesced_batches")
                reg.inc("serve.coalesced_requests", len(group))
            for fut in group:
                wait = t0 - fut.t_submit
                reg.observe("serve.queue_wait_s", wait)
                reg.observe(telemetry.tenant_metric("serve.queue_wait_s", fut.tenant), wait)
        try:
            entry = self.registry.get(group[0].name)  # use-touch: keeps it MRU
            program = entry.program
            if program is None:
                # evicted between get() and here (eviction nulls the
                # program): fail typed like a never-resident model
                raise KeyError(f"model {group[0].name!r} was evicted mid-flight")
            sizes = [f.rows for f in group]
            block = (
                np.concatenate([f.features for f in group], axis=0)
                if len(group) > 1
                else group[0].features
            )
            n = int(block.shape[0])
            fhook = getattr(entry.model, "_serve_flop_estimate", None)
            if reg is not None and n and fhook is not None:
                reg.inc("serve.flops", float(fhook(n, int(block.shape[1]))))
            # chunk oversized blocks at the program's ladder cap; a zero-row
            # block still dispatches once (shaped empty outputs)
            in_flight = []
            for start in range(0, n, program.cap) if n else (0,):
                in_flight.append(program.dispatch(block[start:min(start + program.cap, n)]))
                if reg is not None and not program.last_dispatch_new_shape:
                    reg.inc("serve.bucket_hits")
            # ---- response assembly: THE one wait for the card -------------
            with telemetry.device_wait("serve_assembly", program.device):
                pass
            outs = [program.fetch(r, nv) for r, nv in in_flight]
            with telemetry.host_section("serve_response"):
                self._resolve_group(group, sizes, outs)
            if reg is not None:
                reg.inc("serve.rows", n)
                t1 = time.monotonic()
                for fut in group:
                    e2e = t1 - fut.t_submit
                    reg.observe("serve.e2e_s", e2e)
                    reg.observe(telemetry.tenant_metric("serve.e2e_s", fut.tenant), e2e)
                    reg.inc(telemetry.tenant_metric("serve.rows", fut.tenant), fut.rows)
        except Exception as e:
            if reg is not None:
                reg.inc("serve.errors", len(group))
            _LOG.warning(
                "scoring dispatch for model %r failed: %s: %s",
                group[0].name, type(e).__name__, e,
            )
            for fut in group:
                if not fut.done():
                    fut._resolve(error=e)

    @staticmethod
    def _resolve_group(
        group: List[ScoreFuture], sizes: List[int], outs: List[Any]
    ) -> None:
        """Concatenate the per-chunk outputs and slice each request's rows
        back out, keeping the model's output structure (array or tuple)."""
        if isinstance(outs[0], tuple):
            merged: Any = tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))
        else:
            merged = np.concatenate(outs, axis=0)
        offset = 0
        for fut, rows in zip(group, sizes):
            if isinstance(merged, tuple):
                fut._resolve(tuple(m[offset:offset + rows] for m in merged))
            else:
                fut._resolve(merged[offset:offset + rows])
            offset += rows
