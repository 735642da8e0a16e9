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
# The serving overload ladder and the ops plane (serving/overload.py,
# ops_plane/) record:
#
#   serve.shed_requests / throttled_requests / degraded_requests
#   / degraded_rows / overdeadline_dispatches / backpressure_transitions
#                                               counters
#   serve.overload_level (+ per-tenant)         gauge: the ladder's level
#   slo.evaluations / trips / clears, ops.decisions_recorded / _dropped,
#   numcheck.trips, lockcheck.inversions / long_holds    counters
#
# and read the rolling windows back: `rate`, `window_quantile`,
# `window_fraction_over` (the SLO burn numerator) over the most recent
# `window_s`, within `window_horizon_s()`; `mark()`/`delta()` give the
# counters and histograms accumulated between two points (a benchmark
# phase's view). `enable()` also starts the ops plane's HTTP exporter when
# SRML_METRICS_PORT names a port.
#
# `device_wait(stage, device)` closes on `torch.cuda.synchronize(device)`
# for a CUDA device, so the time it records is the wait for the card's
# queued work; `host_section(stage)` times host work.
#
# The fleet plane (ops_plane/fleet.py) merges the ranks' views through the
# one set of merge definitions here: `windows_export()` gives the rolling
# windows indexed by bucket age, `merge_counters` / `merge_gauges` /
# `merge_histograms` / `merge_windows` combine the ranks', and
# `MergedWindows` reads a merged window as the SLO evaluator reads the
# registry. Left out of this copy (ROADMAP A15): the JSONL sinks, spans, the
# efficiency attribution plane, and the solvers' diagnostics events and
# convergence ring.
#
from __future__ import annotations

import os
import re
import sys
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .utils import lockcheck

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
    "merge_counters",
    "merge_gauges",
    "merge_histograms",
    "merge_windows",
    "MergedWindows",
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
    """Turn recording on. When SRML_METRICS_PORT names a port, the ops
    plane's exporter thread starts too (best-effort: a busy port leaves no
    server, never a failed call)."""
    global _ON
    _ON = True
    if os.environ.get("SRML_METRICS_PORT"):
        try:
            from . import ops_plane

            ops_plane.ensure_server()
        except Exception:  # pragma: no cover - the exporter never breaks enable
            pass


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


# ---------------------------------------------------------------- merges --
#
# The cross-rank merge definitions, which both of the fleet plane's
# transports (the live ops round and the offline snapshot merge) use:
# counters sum; gauges keep every rank's value with min/max/sum (an average
# of a watermark would lie); window histograms merge per bucket age with
# exact counts and sums and the sample lists concatenated and sorted. A
# merge is associative and independent of rank order, and merging one rank
# is the identity.


def merge_counters(per_rank: List[Dict[str, float]]) -> Dict[str, float]:
    """Sum counter dicts across ranks (a missing name contributes 0)."""
    out: Dict[str, float] = {}
    for counters in per_rank:
        for name, v in (counters or {}).items():
            out[name] = out.get(name, 0.0) + float(v)
    return out


def merge_gauges(per_rank: Dict[Any, Dict[str, float]]) -> Dict[str, Dict[str, Any]]:
    """Merge gauge dicts keyed by rank: each name keeps the per-rank map
    (`by_rank`, keyed by int rank; JSON's string keys are accepted) and
    its min/max/sum."""
    out: Dict[str, Dict[str, Any]] = {}
    for rank in sorted(per_rank, key=lambda r: int(r)):
        for name, v in (per_rank[rank] or {}).items():
            e = out.setdefault(name, {"by_rank": {}, "min": float("inf"), "max": float("-inf"), "sum": 0.0})
            v = float(v)
            e["by_rank"][int(rank)] = v
            e["min"] = min(e["min"], v)
            e["max"] = max(e["max"], v)
            e["sum"] += v
    return out


def merge_histograms(per_rank: List[Dict[str, Dict[str, float]]]) -> Dict[str, Dict[str, float]]:
    """Merge cumulative histogram summaries: counts and sums add, min and
    max fold."""
    out: Dict[str, Dict[str, float]] = {}
    for hists in per_rank:
        for name, h in (hists or {}).items():
            e = out.setdefault(name, {"count": 0.0, "sum": 0.0, "min": float("inf"), "max": float("-inf")})
            e["count"] += float(h.get("count", 0.0))
            e["sum"] += float(h.get("sum", 0.0))
            e["min"] = min(e["min"], float(h.get("min", float("inf"))))
            e["max"] = max(e["max"], float(h.get("max", float("-inf"))))
    return out


def merge_windows(exports: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge several ranks' `windows_export()`s, aligned by bucket age
    (newest first). The exports must share one bucket width: ranks with
    different widths have no common window, and ValueError is raised
    (buckets of different widths are never averaged). Per-bucket counts and
    sums stay exact; the merged sample lists are the sorted
    concatenation."""
    exports = [e for e in exports if e]
    if not exports:
        return {"bucket_seconds": None, "bucket_count": 0, "counters": {}, "hists": {}, "ranks": 0}
    bucket_s = float(exports[0]["bucket_seconds"])
    for e in exports[1:]:
        if abs(float(e["bucket_seconds"]) - bucket_s) > 1e-9:
            raise ValueError(
                "merge_windows: mismatched bucket_seconds "
                f"({e['bucket_seconds']} vs {bucket_s}) — ranks must share "
                "metrics_bucket_seconds for their windows to align"
            )
    n = max(int(e["bucket_count"]) for e in exports)
    counters: Dict[str, List[float]] = {}
    hists: Dict[str, Dict[str, List[Any]]] = {}
    for e in exports:
        for name, vals in (e.get("counters") or {}).items():
            acc = counters.setdefault(name, [0.0] * n)
            for i, v in enumerate(vals[:n]):
                acc[i] += float(v)
        for name, h in (e.get("hists") or {}).items():
            hacc = hists.setdefault(name, {"counts": [0.0] * n, "sums": [0.0] * n, "samples": [[] for _ in range(n)]})
            for i in range(min(n, len(h["counts"]))):
                hacc["counts"][i] += float(h["counts"][i])
                hacc["sums"][i] += float(h["sums"][i])
                hacc["samples"][i].extend(h["samples"][i])
    for h in hists.values():
        h["samples"] = [sorted(s) for s in h["samples"]]
    return {"bucket_seconds": bucket_s, "bucket_count": n, "counters": counters, "hists": hists,
            "ranks": len(exports)}


class MergedWindows:
    """A reader over a `merge_windows()` result with the registry's windowed
    reads (`rate`, `window_count`, `window_quantile`,
    `window_fraction_over`, `snapshot()["gauges"]`), so the SLO evaluator
    runs unchanged over a cluster's window (`ops_plane.slo.evaluate_reader`).
    The merged export is a snapshot: "now" is its newest bucket, and a
    `window_s` reads the newest ``round(window_s / bucket)`` buckets.
    `gauges` is the value each gauge ceiling judges (the fleet plane passes
    the ranks' max: a ceiling breached anywhere is breached)."""

    def __init__(self, merged: Optional[Dict[str, Any]], gauges: Optional[Dict[str, float]] = None) -> None:
        self._m = merged or {"bucket_seconds": None, "bucket_count": 0, "counters": {}, "hists": {}}
        self._gauges = dict(gauges or {})

    def _k(self, window_s: Optional[float]) -> int:
        bucket_s = self._m.get("bucket_seconds") or 0.0
        n = int(self._m.get("bucket_count") or 0)
        if not bucket_s or not n:
            return 0
        horizon = bucket_s * n
        span = horizon if window_s is None else min(max(float(window_s), bucket_s), horizon)
        return max(1, min(n, int(round(span / bucket_s))))

    def bucket_seconds(self) -> float:
        return float(self._m.get("bucket_seconds") or 0.0)

    def window_horizon_s(self) -> float:
        return self.bucket_seconds() * int(self._m.get("bucket_count") or 0)

    def rate(self, name: str, window_s: Optional[float] = None) -> Optional[float]:
        vals = (self._m.get("counters") or {}).get(name)
        k = self._k(window_s)
        if vals is None or not k:
            return None
        span = k * float(self._m["bucket_seconds"])
        return sum(vals[:k]) / span if span > 0 else None

    def window_samples(self, name: str, window_s: Optional[float] = None) -> List[float]:
        h = (self._m.get("hists") or {}).get(name)
        if h is None:
            return []
        out: List[float] = []
        for i in range(min(self._k(window_s), len(h["samples"]))):
            out.extend(h["samples"][i])
        return out

    def window_count(self, name: str, window_s: Optional[float] = None) -> float:
        h = (self._m.get("hists") or {}).get(name)
        if h is None:
            return 0.0
        return float(sum(h["counts"][: self._k(window_s)]))

    def window_quantile(self, name: str, q: float, window_s: Optional[float] = None) -> Optional[float]:
        return quantile_of(self.window_samples(name, window_s), q)

    def window_fraction_over(
        self, name: str, threshold: float, window_s: Optional[float] = None
    ) -> Optional[Tuple[float, int]]:
        samples = self.window_samples(name, window_s)
        if not samples:
            return None
        bad = sum(1 for s in samples if s > threshold)
        return bad / len(samples), len(samples)

    def snapshot(self) -> Dict[str, Any]:
        return {"gauges": dict(self._gauges)}


class MetricsRegistry:
    """Process-global metrics store. Thread-safe; every record method is a
    no-op while telemetry is disabled."""

    def __init__(self) -> None:
        self._lock = lockcheck.make_lock("telemetry.MetricsRegistry._lock")
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
            ring = rings[name] = _Ring(*self._win())
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

    def _win(self) -> Tuple[float, int]:
        """Window params, resolved once per construction or reset (the
        caller holds the lock)."""
        if self._win_cfg is None:
            self._win_cfg = _window_params()
        return self._win_cfg

    def bucket_seconds(self) -> float:
        with self._lock:
            return self._win()[0]

    def window_horizon_s(self) -> float:
        """The rolling-window horizon (bucket width x bucket count)."""
        with self._lock:
            bucket_s, n = self._win()
        return bucket_s * n

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

    def window_fraction_over(
        self, name: str, threshold: float, window_s: Optional[float] = None
    ) -> Optional[Tuple[float, int]]:
        """(fraction of the windowed observations of histogram `name`
        strictly above `threshold`, their count): the SLO burn numerator.
        None when the window is empty (no traffic is not a violation)."""
        with self._lock:
            ring = self._win_hists.get(name)
            if ring is None:
                return None
            slots, _ = ring.slots(time.monotonic(), window_s)
            samples = [v for i in slots for v in ring.samples[i]]
        if not samples:
            return None
        bad = sum(1 for v in samples if v > threshold)
        return bad / len(samples), len(samples)

    def windows_snapshot(self) -> Dict[str, Any]:
        """The rolling windows as the ops report serves them: each counter's
        rate over the fast window (60 s, within the horizon) and over the
        whole horizon, each histogram's p50/p99/count over the horizon; one
        lock hold at one clock reading, so every metric describes the same
        window."""
        now = time.monotonic()
        with self._lock:
            bucket_s, n = self._win()
            horizon = bucket_s * n
            fast = min(60.0, horizon)
            rates: Dict[str, Any] = {}
            for name, ring in self._win_counters.items():
                out = {}
                for key, window in (("fast_per_s", fast), ("horizon_per_s", None)):
                    slots, span = ring.slots(now, window)
                    out[key] = sum(ring.sums[i] for i in slots) / span if span > 0 else None
                rates[name] = out
            quantiles: Dict[str, Any] = {}
            for name, ring in self._win_hists.items():
                slots, _ = ring.slots(now, None)
                samples = [v for i in slots for v in ring.samples[i]]
                quantiles[name] = {
                    "p50": quantile_of(samples, 0.5),
                    "p99": quantile_of(samples, 0.99),
                    "count": float(sum(ring.counts[i] for i in slots)),
                }
        return {
            "bucket_seconds": bucket_s,
            "bucket_count": n,
            "horizon_s": horizon,
            "rates": rates,
            "quantiles": quantiles,
        }

    def windows_export(self) -> Dict[str, Any]:
        """The rolling windows in the form the fleet plane merges: each
        counter's per-bucket increment sums and each histogram's per-bucket
        counts, sums and sorted samples, indexed by bucket age (newest
        first). A ring's head is a bucket of this process's
        `time.monotonic()`, which means nothing in another process, so age
        is the only alignment across ranks (their skew is at most one bucket
        width). Sorted samples make the merge canonical. Taken under one
        lock hold at one clock reading, as `windows_snapshot`."""
        now = time.monotonic()
        with self._lock:
            bucket_s, n = self._win()
            counters: Dict[str, List[float]] = {}
            for name, ring in self._win_counters.items():
                ring._advance(now)
                counters[name] = [float(ring.sums[(ring.head - i) % ring.n]) for i in range(ring.n)]
            hists: Dict[str, Dict[str, List[Any]]] = {}
            for name, ring in self._win_hists.items():
                ring._advance(now)
                idx = [(ring.head - i) % ring.n for i in range(ring.n)]
                hists[name] = {
                    "counts": [float(ring.counts[i]) for i in idx],
                    "sums": [float(ring.sums[i]) for i in idx],
                    "samples": [sorted(ring.samples[i]) for i in idx],
                }
        return {"bucket_seconds": bucket_s, "bucket_count": n, "counters": counters, "hists": hists}

    def snapshot(self) -> Dict[str, Any]:
        """Counters, gauges and histogram summaries (JSON-able)."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: dict(v) for k, v in self._hists.items()},
            }

    class _Mark:
        __slots__ = ("counters", "hists")

    def mark(self) -> "MetricsRegistry._Mark":
        """Cheap position marker for `delta()`."""
        m = MetricsRegistry._Mark()
        with self._lock:
            m.counters = dict(self._counters)
            m.hists = {k: dict(v) for k, v in self._hists.items()}
        return m

    def delta(self, m: "MetricsRegistry._Mark") -> Dict[str, Any]:
        """Counters and histogram counts/sums accumulated SINCE `m`, and the
        current gauges."""
        with self._lock:
            counters = {
                k: v - m.counters.get(k, 0.0)
                for k, v in self._counters.items()
                if v != m.counters.get(k, 0.0)
            }
            hists = {}
            for k, v in self._hists.items():
                prev = m.hists.get(k)
                count = v["count"] - (prev["count"] if prev else 0.0)
                if count:
                    hists[k] = {"count": count, "sum": v["sum"] - (prev["sum"] if prev else 0.0)}
            gauges = dict(self._gauges)
        return {"counters": counters, "gauges": gauges, "histograms": hists}

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
