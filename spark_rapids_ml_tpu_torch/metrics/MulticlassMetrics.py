#
# Multiclass metrics from confusion-matrix sufficient statistics, as Spark's
# Scala MulticlassMetrics computes them: the port's own copy of
# spark_rapids_ml_tpu/metrics/MulticlassMetrics.py.
#
# Sufficient stats per partition: {(label, prediction): weighted count} plus an
# optional log-loss partial sum; partitions merge by dict addition.
#
from __future__ import annotations

from typing import Dict, Optional, Tuple

__all__ = ["MulticlassMetrics"]


class MulticlassMetrics:
    SUPPORTED_MULTI_CLASS_METRIC_NAMES = [
        "f1",
        "accuracy",
        "weightedPrecision",
        "weightedRecall",
        "weightedTruePositiveRate",
        "weightedFalsePositiveRate",
        "weightedFMeasure",
        "truePositiveRateByLabel",
        "falsePositiveRateByLabel",
        "precisionByLabel",
        "recallByLabel",
        "fMeasureByLabel",
        "logLoss",
        "hammingLoss",
    ]

    def __init__(
        self,
        tp: Optional[Dict[float, float]] = None,
        fp: Optional[Dict[float, float]] = None,
        label: Optional[Dict[float, float]] = None,
        label_count: float = 0.0,
        log_loss: Optional[float] = None,
    ):
        self._tp_by_class = tp or {}
        self._fp_by_class = fp or {}
        self._label_count_by_class = label or {}
        self._label_count = label_count
        self._log_loss = log_loss

    # -- construction from sufficient statistics ---------------------------
    @classmethod
    def from_confusion(
        cls, confusion: Dict[Tuple[float, float], float], log_loss: Optional[float] = None
    ) -> "MulticlassMetrics":
        """confusion: {(label, prediction): weighted count}."""
        tp: Dict[float, float] = {}
        fp: Dict[float, float] = {}
        label_count: Dict[float, float] = {}
        total = 0.0
        for (lbl, pred_), cnt in confusion.items():
            total += cnt
            label_count[lbl] = label_count.get(lbl, 0.0) + cnt
            tp.setdefault(lbl, 0.0)
            fp.setdefault(pred_, 0.0)
            if lbl == pred_:
                tp[lbl] = tp.get(lbl, 0.0) + cnt
            else:
                fp[pred_] = fp.get(pred_, 0.0) + cnt
        return cls(tp, fp, label_count, total, log_loss)

    @staticmethod
    def merge_confusion(
        a: Dict[Tuple[float, float], float], b: Dict[Tuple[float, float], float]
    ) -> Dict[Tuple[float, float], float]:
        out = dict(a)
        for k, v in b.items():
            out[k] = out.get(k, 0.0) + v
        return out

    # -- per-label metrics (reference MulticlassMetrics.py:40-121) ----------
    def _precision(self, label: float) -> float:
        tp = self._tp_by_class.get(label, 0.0)
        fp = self._fp_by_class.get(label, 0.0)
        return 0.0 if (tp + fp) == 0 else tp / (tp + fp)

    def _recall(self, label: float) -> float:
        cnt = self._label_count_by_class.get(label, 0.0)
        return 0.0 if cnt == 0 else self._tp_by_class.get(label, 0.0) / cnt

    def _f_measure(self, label: float, beta: float = 1.0) -> float:
        p = self._precision(label)
        r = self._recall(label)
        b2 = beta * beta
        return 0.0 if (p + r) == 0 else (1 + b2) * p * r / (b2 * p + r)

    def false_positive_rate(self, label: float) -> float:
        fp = self._fp_by_class.get(label, 0.0)
        denom = self._label_count - self._label_count_by_class.get(label, 0.0)
        return 0.0 if denom == 0 else fp / denom

    def weighted_fmeasure(self, beta: float = 1.0) -> float:
        return sum(
            self._f_measure(k, beta) * v / self._label_count
            for k, v in self._label_count_by_class.items()
        )

    def accuracy(self) -> float:
        return sum(self._tp_by_class.values()) / self._label_count

    def weighted_precision(self) -> float:
        return sum(
            self._precision(k) * v / self._label_count
            for k, v in self._label_count_by_class.items()
        )

    def weighted_recall(self) -> float:
        return sum(
            self._recall(k) * v / self._label_count for k, v in self._label_count_by_class.items()
        )

    def weighted_true_positive_rate(self) -> float:
        return self.weighted_recall()

    def weighted_false_positive_rate(self) -> float:
        return sum(
            self.false_positive_rate(k) * v / self._label_count
            for k, v in self._label_count_by_class.items()
        )

    def hamming_loss(self) -> float:
        return 1.0 - self.accuracy()

    def log_loss(self) -> float:
        assert self._log_loss is not None, "log-loss sufficient stats were not collected"
        return self._log_loss / self._label_count

    def evaluate(self, evaluator) -> float:
        """Dispatch on the evaluator's metricName (reference MulticlassMetrics.py:149-180)."""
        metric = evaluator.getMetricName()
        if metric == "f1":
            return self.weighted_fmeasure()
        if metric == "accuracy":
            return self.accuracy()
        if metric == "weightedPrecision":
            return self.weighted_precision()
        if metric == "weightedRecall":
            return self.weighted_recall()
        if metric == "weightedTruePositiveRate":
            return self.weighted_true_positive_rate()
        if metric == "weightedFalsePositiveRate":
            return self.weighted_false_positive_rate()
        if metric == "weightedFMeasure":
            return self.weighted_fmeasure(evaluator.getBeta())
        if metric == "truePositiveRateByLabel":
            return self._recall(evaluator.getMetricLabel())
        if metric == "falsePositiveRateByLabel":
            return self.false_positive_rate(evaluator.getMetricLabel())
        if metric == "precisionByLabel":
            return self._precision(evaluator.getMetricLabel())
        if metric == "recallByLabel":
            return self._recall(evaluator.getMetricLabel())
        if metric == "fMeasureByLabel":
            return self._f_measure(evaluator.getMetricLabel(), evaluator.getBeta())
        if metric == "hammingLoss":
            return self.hamming_loss()
        if metric == "logLoss":
            return self.log_loss()
        raise ValueError(f"Unsupported metric name {metric!r}")
