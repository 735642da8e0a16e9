#
# In-process metrics for the serving plane: counters, gauges and histograms
# with cumulative and rolling-window views, and two timing contexts. The
# port's own trimmed copy of spark_rapids_ml_tpu/telemetry.py.
#
# Off by default; `enable()` turns recording on (or SRML_TELEMETRY=1 in the
# environment), and every recorder is a no-op while it is off. What the
# serving plane records (serving/engine.py, serving/registry.py):
#
#   serve.requests / rows / batches / coalesced_batches / coalesced_requests
#   / bucket_hits / expired_requests / rejected_requests / errors
#   / models_loaded / model_evictions          counters
#   serve.queue_wait_s, serve.e2e_s            histograms (+ per-tenant
#                                              siblings, `tenant_metric`)
#   device_wait.<stage>_s, host_section.<stage>_s   histograms of the timing
#                                              contexts below
#
# and what a finished solve records (`record_solver_result`, called by
# LogisticRegression's fit): <solver>.fits, <solver>.iterations and
# <solver>.line_search_stalls counters, the <solver>.objective gauge.
#
# The fit side's memory plane (memory.py, core.py, parallel.py) records:
#
#   memory.admission_resident / admission_stream, fit.demotions,
#   memory.oom_caught                           counters (one per fit)
#   memory.capacity_bytes, memory.estimate_bytes   gauges (the admission's)
#   ingest.stream_chunks / stream_rows          counters (per streamed pass)
#   ingest.overlap_fraction                     gauge (the last pass's)
#   device.peak_bytes_in_use, device.bytes_in_use   gauges: the card's
#       allocator watermark (`record_device_memory`), sampled after a
#       resident placement and at every streamed chunk boundary
#
# `device_wait(stage, device)` closes on `torch.cuda.synchronize(device)`
# for a CUDA device, so the time it records is the wait for the card's
# queued work; `host_section(stage)` times host work. Left out of this copy
# (ROADMAP A15): the JSONL sinks, spans, the fleet merge, the efficiency
# attribution plane, and the solvers' diagnostics events and convergence
# ring.
#
from __future__ import annotations

import os
import re
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "enable",
    "disable",
    "enabled",
    "registry",
    "MetricsRegistry",
    "quantile_of",
    "summarize_histogram",
    "tenant_metric",
    "device_wait",
    "host_section",
    "record_device_memory",
    "record_solver_result",
]

# Most-recent observations retained per histogram for quantile() (serving
# latency p50/p99); count/sum/min/max see every observation.
_MAX_HIST_SAMPLES = 1024
# Per-bucket sample retention of the time-windowed quantile view.
_MAX_BUCKET_SAMPLES = 256

_ON = bool(os.environ.get("SRML_TELEMETRY"))


def enabled() -> bool:
    """Whether recording is on (the one hot-path check)."""
    return _ON


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    """Turn recording off; what was recorded stays in the registry."""
    global _ON
    _ON = False


def _window_params() -> Tuple[float, int]:
    """(bucket seconds, bucket count) of the rolling windows, from
    `core.config` when it is loaded (defaults 10 s x 18)."""
    bucket_s, n = 10.0, 18
    core = sys.modules.get(__package__ + ".core")
    if core is not None:
        try:
            bucket_s = float(core.config.get("metrics_bucket_seconds") or 10.0)
            n = int(core.config.get("metrics_bucket_count") or 18)
        except (TypeError, ValueError):
            pass
    return max(0.001, bucket_s), max(2, n)


class _Ring:
    """Per-metric ring of per-bucket (sum, count, bounded samples) over the
    rolling horizon (bucket width x bucket count)."""

    __slots__ = ("bucket_s", "n", "sums", "counts", "samples", "head")

    def __init__(self, bucket_s: float, n: int) -> None:
        self.bucket_s = bucket_s
        self.n = n
        self.head: Optional[int] = None  # absolute index of the newest bucket
        self._clear()

    def _clear(self) -> None:
        self.sums = [0.0] * self.n
        self.counts = [0.0] * self.n
        self.samples: List[List[float]] = [[] for _ in range(self.n)]

    def _advance(self, now: float) -> None:
        b = int(now // self.bucket_s)
        if self.head is None or b - self.head >= self.n:
            self._clear()
            self.head = b
            return
        while self.head < b:
            self.head += 1
            i = self.head % self.n
            self.sums[i], self.counts[i], self.samples[i] = 0.0, 0.0, []

    def add(self, now: float, v: float, keep_sample: bool) -> None:
        self._advance(now)
        i = self.head % self.n
        self.sums[i] += v
        self.counts[i] += 1.0
        if keep_sample and len(self.samples[i]) < _MAX_BUCKET_SAMPLES:
            self.samples[i].append(v)

    def slots(self, now: float, window_s: Optional[float]) -> Tuple[List[int], float]:
        """Bucket slots of the most recent `window_s` (clamped to the
        horizon), and the span they cover in seconds."""
        self._advance(now)
        horizon = self.n * self.bucket_s
        span = horizon if window_s is None else min(max(float(window_s), self.bucket_s), horizon)
        k = max(1, min(self.n, int(round(span / self.bucket_s))))
        return [(self.head - i) % self.n for i in range(k)], k * self.bucket_s


def quantile_of(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank quantile over a (possibly unsorted) sample list; None on
    an empty list. The one quantile extraction every reader shares."""
    if not values:
        return None
    ordered = sorted(values)
    q = min(max(float(q), 0.0), 1.0)
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return float(ordered[idx])


class MetricsRegistry:
    """Process-global metrics store. Thread-safe; every record method is a
    no-op while telemetry is disabled."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}  # guarded-by: _lock
        self._gauges: Dict[str, float] = {}  # guarded-by: _lock
        self._hists: Dict[str, Dict[str, float]] = {}  # guarded-by: _lock
        self._hist_samples: Dict[str, List[float]] = {}  # guarded-by: _lock
        self._win_cfg: Optional[Tuple[float, int]] = None  # guarded-by: _lock
        self._win_counters: Dict[str, _Ring] = {}  # guarded-by: _lock
        self._win_hists: Dict[str, _Ring] = {}  # guarded-by: _lock

    def _ring(self, rings: Dict[str, _Ring], name: str) -> _Ring:
        ring = rings.get(name)
        if ring is None:
            if self._win_cfg is None:
                self._win_cfg = _window_params()
            ring = rings[name] = _Ring(*self._win_cfg)
        return ring

    # -- record ------------------------------------------------------------
    def inc(self, name: str, value: float = 1.0) -> None:
        if not _ON:
            return
        now = time.monotonic()
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value
            self._ring(self._win_counters, name).add(now, value, keep_sample=False)

    def gauge(self, name: str, value: float) -> None:
        if not _ON:
            return
        with self._lock:
            self._gauges[name] = float(value)

    def gauge_max(self, name: str, value: float) -> None:
        """A high-water gauge: keeps the larger of its value and `value`."""
        if not _ON:
            return
        with self._lock:
            self._gauges[name] = max(self._gauges.get(name, float("-inf")), float(value))

    def observe(self, name: str, value: float) -> None:
        """Histogram observation (count/sum/min/max and retained samples)."""
        if not _ON:
            return
        now = time.monotonic()
        value = float(value)
        with self._lock:
            h = self._hists.setdefault(
                name, {"count": 0.0, "sum": 0.0, "min": float("inf"), "max": float("-inf")}
            )
            h["count"] += 1.0
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)
            samples = self._hist_samples.setdefault(name, [])
            samples.append(value)
            if len(samples) > _MAX_HIST_SAMPLES:
                del samples[: -_MAX_HIST_SAMPLES // 2]
            self._ring(self._win_hists, name).add(now, value, keep_sample=True)

    # -- read --------------------------------------------------------------
    def quantile(self, name: str, q: float) -> Optional[float]:
        """Quantile over histogram `name`'s retained samples; None when it
        has none."""
        with self._lock:
            samples = list(self._hist_samples.get(name) or ())
        return quantile_of(samples, q)

    def bucket_seconds(self) -> float:
        with self._lock:
            if self._win_cfg is None:
                self._win_cfg = _window_params()
            return self._win_cfg[0]

    def rate(self, name: str, window_s: Optional[float] = None) -> Optional[float]:
        """Counter increments per second over the most recent `window_s`;
        None for a counter never incremented since the last reset."""
        with self._lock:
            ring = self._win_counters.get(name)
            if ring is None:
                return None
            slots, span = ring.slots(time.monotonic(), window_s)
            total = sum(ring.sums[i] for i in slots)
        return total / span if span > 0 else None

    def window_quantile(
        self, name: str, q: float, window_s: Optional[float] = None
    ) -> Optional[float]:
        """Quantile over histogram `name`'s observations within the most
        recent `window_s`; None when the window holds none."""
        with self._lock:
            ring = self._win_hists.get(name)
            if ring is None:
                return None
            slots, _ = ring.slots(time.monotonic(), window_s)
            samples = [v for i in slots for v in ring.samples[i]]
        return quantile_of(samples, q)

    def snapshot(self) -> Dict[str, Any]:
        """Counters, gauges and histogram summaries (JSON-able)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: dict(v) for k, v in self._hists.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._hist_samples.clear()
            # the rings rebuild against the current config on next record
            self._win_cfg = None
            self._win_counters.clear()
            self._win_hists.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def summarize_histogram(name: str) -> Dict[str, Optional[float]]:
    """One histogram's view: count/sum/mean/min/max and p50/p99 over its
    retained samples. All values None when nothing was observed."""
    with _REGISTRY._lock:
        h = _REGISTRY._hists.get(name)
        cum = dict(h) if h else None
    return {
        "count": cum["count"] if cum else None,
        "sum": cum["sum"] if cum else None,
        "mean": (cum["sum"] / cum["count"]) if cum and cum["count"] else None,
        "min": cum["min"] if cum else None,
        "max": cum["max"] if cum else None,
        "p50": _REGISTRY.quantile(name, 0.5),
        "p99": _REGISTRY.quantile(name, 0.99),
    }


def tenant_metric(base: str, tenant: str) -> str:
    """The per-tenant metric name ``<base>.<tenant>``, the tenant sanitized to
    the metric-name alphabet (each run of characters outside
    ``[A-Za-z0-9_.:-]`` becomes one ``_``)."""
    safe = re.sub(r"[^A-Za-z0-9_.:\-]+", "_", tenant) or "_"
    return f"{base}.{safe}"


@contextmanager
def device_wait(stage: str, device: Any = None) -> Iterator[None]:
    """Wait for the card at a point that already synchronizes: the body runs,
    then `torch.cuda.synchronize(device)` for a CUDA device (nothing for the
    CPU). The whole wait is recorded as ``device_wait.<stage>_s`` while
    telemetry is on."""
    t0 = time.monotonic()
    yield
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch

        torch.cuda.synchronize(device)
    if _ON:
        _REGISTRY.observe(f"device_wait.{stage}_s", time.monotonic() - t0)


@contextmanager
def host_section(stage: str) -> Iterator[None]:
    """Time host-side work (response slicing) as ``host_section.<stage>_s``
    while telemetry is on."""
    t0 = time.monotonic()
    yield
    if _ON:
        _REGISTRY.observe(f"host_section.{stage}_s", time.monotonic() - t0)


def record_device_memory(device: Any = None) -> None:
    """Sample the card's allocator into the watermark gauges: the peak of
    `torch.cuda.max_memory_allocated` into ``device.peak_bytes_in_use`` and
    `torch.cuda.memory_allocated` into ``device.bytes_in_use``. Neither
    synchronizes. A CPU device has no such statistics: nothing is
    recorded."""
    if not _ON or device is None or getattr(device, "type", None) != "cuda":
        return
    import torch

    _REGISTRY.gauge_max("device.peak_bytes_in_use", torch.cuda.max_memory_allocated(device))
    _REGISTRY.gauge("device.bytes_in_use", torch.cuda.memory_allocated(device))


def record_solver_result(
    solver: str,
    *,
    n_iter: int,
    objective: Optional[float] = None,
    stalled: bool = False,
) -> None:
    """Host-side record of a completed iterative solve: the fit and
    iteration counters, a stall counter, and the final objective gauge."""
    if not _ON:
        return
    _REGISTRY.inc(f"{solver}.fits")
    _REGISTRY.inc(f"{solver}.iterations", float(n_iter))
    if stalled:
        _REGISTRY.inc(f"{solver}.line_search_stalls")
    if objective is not None:
        _REGISTRY.gauge(f"{solver}.objective", float(objective))
