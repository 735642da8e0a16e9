#
# Regression metrics from streaming moment buffers, as Spark's
# SummarizerBuffer and RegressionMetrics compute them: the port's own copy of
# spark_rapids_ml_tpu/metrics/RegressionMetrics.py.
#
# Each buffer tracks weighted moments of the 2-column stream
# [label, label - prediction]: currMean, currM2n (Σw(x-μ)²), currM2 (Σw x²),
# currL1 (Σw|x|), totalCnt, weightSum — with the numerically-stable streaming
# merge (reference RegressionMetrics.py:63-168).
#
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["RegressionMetrics", "_SummarizerBuffer"]


class _SummarizerBuffer:
    def __init__(
        self,
        mean: Sequence[float] = (0.0, 0.0),
        m2n: Sequence[float] = (0.0, 0.0),
        m2: Sequence[float] = (0.0, 0.0),
        l1: Sequence[float] = (0.0, 0.0),
        total_cnt: int = 0,
        weight_sum: float = 0.0,
        weight_square_sum: float = 0.0,
    ):
        self._curr_mean = np.asarray(mean, dtype=np.float64).copy()
        self._curr_m2n = np.asarray(m2n, dtype=np.float64).copy()
        self._curr_m2 = np.asarray(m2, dtype=np.float64).copy()
        self._curr_l1 = np.asarray(l1, dtype=np.float64).copy()
        self._total_cnt = int(total_cnt)
        self._weight_sum = float(weight_sum)
        self._weight_square_sum = float(weight_square_sum)
        self._num_cols = len(self._curr_mean)

    @classmethod
    def from_values(cls, label: np.ndarray, prediction: np.ndarray, weight: np.ndarray) -> "_SummarizerBuffer":
        """Build the buffer for one partition from raw columns."""
        label = np.asarray(label, dtype=np.float64)
        residual = label - np.asarray(prediction, dtype=np.float64)
        w = np.asarray(weight, dtype=np.float64)
        cols = np.stack([label, residual], axis=1)  # [n, 2]
        weight_sum = float(w.sum())
        mean = (w[:, None] * cols).sum(axis=0) / weight_sum
        m2n = (w[:, None] * (cols - mean) ** 2).sum(axis=0)
        m2 = (w[:, None] * cols**2).sum(axis=0)
        l1 = (w[:, None] * np.abs(cols)).sum(axis=0)
        return cls(mean, m2n, m2, l1, len(label), weight_sum, float((w**2).sum()))

    def merge(self, other: "_SummarizerBuffer") -> "_SummarizerBuffer":
        """Streaming merge of two buffers (reference RegressionMetrics.py:63-100)."""
        if other._weight_sum == 0:
            return self
        if self._weight_sum == 0:
            return other
        total_w = self._weight_sum + other._weight_sum
        delta = other._curr_mean - self._curr_mean
        mean = self._curr_mean + delta * (other._weight_sum / total_w)
        m2n = (
            self._curr_m2n
            + other._curr_m2n
            + delta * delta * self._weight_sum * other._weight_sum / total_w
        )
        return _SummarizerBuffer(
            mean,
            m2n,
            self._curr_m2 + other._curr_m2,
            self._curr_l1 + other._curr_l1,
            self._total_cnt + other._total_cnt,
            total_w,
            self._weight_square_sum + other._weight_square_sum,
        )

    @property
    def total_count(self) -> int:
        return self._total_cnt

    @property
    def weight_sum(self) -> float:
        return self._weight_sum

    def mean(self, col: int) -> float:
        return float(self._curr_mean[col])

    def m2n(self, col: int) -> float:
        return float(self._curr_m2n[col])

    def m2(self, col: int) -> float:
        return float(self._curr_m2[col])

    def l1(self, col: int) -> float:
        return float(self._curr_l1[col])


_LABEL, _RESIDUAL = 0, 1


class RegressionMetrics:
    """rmse/mse/r2/mae/explainedVariance from a (merged) SummarizerBuffer
    (reference RegressionMetrics.py:170-267)."""

    def __init__(self, buffer: _SummarizerBuffer):
        self._buffer = buffer

    @classmethod
    def from_values(cls, label, prediction, weight=None) -> "RegressionMetrics":
        label = np.asarray(label)
        if weight is None:
            weight = np.ones_like(label, dtype=np.float64)
        return cls(_SummarizerBuffer.from_values(label, prediction, weight))

    @classmethod
    def merge_all(cls, metrics: List["RegressionMetrics"]) -> "RegressionMetrics":
        buf = metrics[0]._buffer
        for m in metrics[1:]:
            buf = buf.merge(m._buffer)
        return cls(buf)

    @property
    def _ss_err(self) -> float:  # Σw·residual²
        return self._buffer.m2(_RESIDUAL)

    @property
    def _ss_tot(self) -> float:  # Σw(y-ȳ)²
        return self._buffer.m2n(_LABEL)

    def mean_squared_error(self) -> float:
        return self._ss_err / self._buffer.weight_sum

    def root_mean_squared_error(self) -> float:
        return float(np.sqrt(self.mean_squared_error()))

    def mean_absolute_error(self) -> float:
        return self._buffer.l1(_RESIDUAL) / self._buffer.weight_sum

    def r2(self, through_origin: bool = False) -> float:
        # through-origin r2 normalizes by Σw·y² instead of Σw(y-ȳ)² (Spark parity)
        denom = self._buffer.m2(_LABEL) if through_origin else self._ss_tot
        return 1.0 - self._ss_err / denom

    def explained_variance(self) -> float:
        # Var(y) - Var(residual) form (Spark's explainedVariance)
        return (self._ss_tot - self._buffer.m2n(_RESIDUAL)) / self._buffer.weight_sum

    def evaluate(self, evaluator) -> float:
        metric = evaluator.getMetricName()
        if metric == "rmse":
            return self.root_mean_squared_error()
        if metric == "mse":
            return self.mean_squared_error()
        if metric == "mae":
            return self.mean_absolute_error()
        if metric == "r2":
            through_origin = bool(
                evaluator.hasParam("throughOrigin") and evaluator.getOrDefault("throughOrigin")
            ) if hasattr(evaluator, "hasParam") else False
            return self.r2(through_origin)
        if metric == "var":
            return self.explained_variance()
        raise ValueError(f"Unsupported metric name {metric!r}")
