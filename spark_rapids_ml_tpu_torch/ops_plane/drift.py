#
# Drift statistics: per-column feature statistics riding the ingest NaN/Inf
# scan. The port's copy of spark_rapids_ml_tpu/ops_plane/drift.py.
#
# When `config["validate_ingest"]` is on, `data.validate_extracted` already
# walks every ingested row block chunk by chunk computing a finite mask.
# This module accumulates per-column running moments off that same pass
# (count, mean, std, non-finite ("null") fraction) at zero extra data
# passes, and publishes them as `ingest.feature.<col>.mean` / `.std` /
# `.null_fraction` gauges when the scan completes (a streamed fit
# accumulates across its per-row-block scans and publishes at the last
# block).
#
# PSI: register a baseline snapshot (`register_baseline(build_baseline(
# reference_extracted))`) and every later scan also bins each column against
# the baseline's decile edges, publishing the population-stability index per
# column (`ingest.feature.<col>.psi`) and the max across columns
# (`ingest.feature.psi_max`); PSI > 0.2 is the usual "investigate" line.
# Accumulation is skipped entirely while telemetry is disabled and on sparse
# ingests (a CSR block's per-column statistics would need a transpose pass
# the scan does not make). The arithmetic is the JAX package's, in float64
# numpy, so both packages publish equal statistics for the same chunks.
#
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..utils import lockcheck

__all__ = [
    "build_baseline",
    "register_baseline",
    "clear_baseline",
    "current_baseline",
    "accumulator_for",
    "last_stats",
]

_PSI_EPS = 1e-6


class Baseline:
    """Per-column reference distribution: decile bin edges + bin fractions
    (for PSI) and the reference moments. JSON-able via `to_dict`."""

    def __init__(
        self,
        edges: List[np.ndarray],
        fracs: List[np.ndarray],
        mean: np.ndarray,
        std: np.ndarray,
        null_fraction: np.ndarray,
        columns: List[str],
    ) -> None:
        self.edges = edges
        self.fracs = fracs
        self.mean = mean
        self.std = std
        self.null_fraction = null_fraction
        self.columns = columns

    @property
    def n_cols(self) -> int:
        return len(self.edges)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "columns": list(self.columns),
            "edges": [e.tolist() for e in self.edges],
            "fracs": [f.tolist() for f in self.fracs],
            "mean": self.mean.tolist(),
            "std": self.std.tolist(),
            "null_fraction": self.null_fraction.tolist(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Baseline":
        return cls(
            [np.asarray(e, dtype=np.float64) for e in d["edges"]],
            [np.asarray(f, dtype=np.float64) for f in d["fracs"]],
            np.asarray(d["mean"], dtype=np.float64),
            np.asarray(d["std"], dtype=np.float64),
            np.asarray(d["null_fraction"], dtype=np.float64),
            [str(c) for c in d["columns"]],
        )


_BASELINE_LOCK = lockcheck.make_lock("ops_plane.drift._BASELINE_LOCK")
_BASELINE: Optional[Baseline] = None  # guarded-by: _BASELINE_LOCK
# the most recent published stats (ops_plane.report()'s drift section)
_LAST_STATS: Optional[Dict[str, Any]] = None  # guarded-by: _BASELINE_LOCK


def build_baseline(
    extracted: Any, *, bins: int = 10, sample_rows: int = 100_000
) -> Baseline:
    """Snapshot a reference dataset's per-column distribution from a bounded
    row sample (deterministic head-stride sample — the baseline is a
    reference, not an estimator). Dense features only."""
    feats = extracted.features
    if hasattr(feats, "todense"):
        raise ValueError("drift baselines support dense feature blocks only")
    x = np.asarray(feats, dtype=np.float64)
    n = x.shape[0]
    if n > sample_rows:
        x = x[:: max(1, n // sample_rows)][:sample_rows]
    names = _column_names(extracted)
    edges: List[np.ndarray] = []
    fracs: List[np.ndarray] = []
    qs = np.linspace(0.0, 1.0, max(2, int(bins)) + 1)[1:-1]
    for c in range(x.shape[1]):
        col = x[:, c]
        col = col[np.isfinite(col)]
        if col.size == 0:
            e = np.array([0.0])
        else:
            e = np.unique(np.quantile(col, qs))
        counts = np.histogram(col, bins=np.concatenate(([-np.inf], e, [np.inf])))[0]
        total = max(1, int(counts.sum()))
        edges.append(e)
        fracs.append(counts / total)
    with np.errstate(invalid="ignore"):
        mask = np.isfinite(x)
        cnt = np.maximum(1, mask.sum(axis=0))
        xz = np.where(mask, x, 0.0)
        mean = xz.sum(axis=0) / cnt
        var = (xz * xz).sum(axis=0) / cnt - mean**2
    return Baseline(
        edges,
        fracs,
        mean,
        np.sqrt(np.maximum(0.0, var)),
        1.0 - mask.sum(axis=0) / max(1, x.shape[0]),
        names,
    )


def register_baseline(baseline: Baseline) -> None:
    global _BASELINE
    with _BASELINE_LOCK:
        _BASELINE = baseline


def clear_baseline() -> None:
    global _BASELINE
    with _BASELINE_LOCK:
        _BASELINE = None


def current_baseline() -> Optional[Baseline]:
    with _BASELINE_LOCK:
        return _BASELINE


def last_stats() -> Optional[Dict[str, Any]]:
    """The most recently published per-column stats (and PSI when a baseline
    was registered) — the `report()["drift"]` feed."""
    with _BASELINE_LOCK:
        return dict(_LAST_STATS) if _LAST_STATS else None


def _column_names(extracted: Any) -> List[str]:
    n = int(extracted.n_cols)
    names = list(getattr(extracted, "feature_names", []) or [])
    if len(names) == n:
        return [str(c) for c in names]
    return [str(i) for i in range(n)]


class DriftAccumulator:
    """Running per-column moments (+ optional baseline bin counts) fed one
    validation chunk at a time. One accumulator per ExtractedData scan; the
    streaming path's per-row-block calls share it across blocks."""

    def __init__(self, extracted: Any) -> None:
        d = int(extracted.n_cols)
        self.columns = _column_names(extracted)
        self.rows = 0
        self.finite = np.zeros(d, dtype=np.int64)
        self.sum = np.zeros(d, dtype=np.float64)
        self.sumsq = np.zeros(d, dtype=np.float64)
        self.baseline = current_baseline()
        if self.baseline is not None and self.baseline.n_cols != d:
            self.baseline = None  # a baseline for a different width is noise
        self.bin_counts: Optional[List[np.ndarray]] = (
            [np.zeros(len(b) + 1, dtype=np.int64) for b in self.baseline.edges]
            if self.baseline is not None
            else None
        )
        self.published = False

    def update(self, chunk: np.ndarray) -> None:
        if chunk.ndim == 1:
            chunk = chunk[:, None]
        x = np.asarray(chunk, dtype=np.float64)
        mask = np.isfinite(x)
        self.rows += int(x.shape[0])
        self.finite += mask.sum(axis=0)
        xz = np.where(mask, x, 0.0)
        self.sum += xz.sum(axis=0)
        self.sumsq += (xz * xz).sum(axis=0)
        if self.bin_counts is not None and self.baseline is not None:
            for c, edges in enumerate(self.baseline.edges):
                col = x[:, c][mask[:, c]]
                self.bin_counts[c] += np.histogram(
                    col, bins=np.concatenate(([-np.inf], edges, [np.inf]))
                )[0]

    def stats(self) -> Dict[str, Any]:
        cnt = np.maximum(1, self.finite)
        mean = self.sum / cnt
        var = np.maximum(0.0, self.sumsq / cnt - mean**2)
        out: Dict[str, Any] = {
            "rows": self.rows,
            "columns": list(self.columns),
            "mean": mean.tolist(),
            "std": np.sqrt(var).tolist(),
            "null_fraction": (
                1.0 - self.finite / max(1, self.rows)
            ).tolist(),
        }
        if self.bin_counts is not None and self.baseline is not None:
            psis = []
            for c, counts in enumerate(self.bin_counts):
                total = max(1, int(counts.sum()))
                actual = np.maximum(counts / total, _PSI_EPS)
                ref = np.maximum(self.baseline.fracs[c], _PSI_EPS)
                psis.append(float(np.sum((actual - ref) * np.log(actual / ref))))
            out["psi"] = psis
            out["psi_max"] = max(psis) if psis else 0.0
        return out

    def publish(self) -> Optional[Dict[str, Any]]:
        """Gauge the accumulated stats (idempotent per scan)."""
        global _LAST_STATS
        from .. import telemetry

        if self.published or not self.rows:
            return None
        self.published = True
        stats = self.stats()
        if telemetry.enabled():
            reg = telemetry.registry()
            for i, col in enumerate(self.columns):
                reg.gauge(f"ingest.feature.{col}.mean", stats["mean"][i])
                reg.gauge(f"ingest.feature.{col}.std", stats["std"][i])
                reg.gauge(
                    f"ingest.feature.{col}.null_fraction", stats["null_fraction"][i]
                )
                if "psi" in stats:
                    reg.gauge(f"ingest.feature.{col}.psi", stats["psi"][i])
            if "psi_max" in stats:
                reg.gauge("ingest.feature.psi_max", stats["psi_max"])
        with _BASELINE_LOCK:
            _LAST_STATS = stats
        return stats


def accumulator_for(extracted: Any) -> Optional[DriftAccumulator]:
    """The scan's accumulator, created on first ask and cached on the
    ExtractedData record (streaming per-block validation calls share it).
    None — and zero cost — while telemetry is disabled or the block is
    sparse."""
    from .. import telemetry

    if not telemetry.enabled() or extracted.is_sparse:
        return None
    acc = getattr(extracted, "_drift_acc", None)
    if acc is None:
        acc = DriftAccumulator(extracted)
        extracted._drift_acc = acc
    return acc
