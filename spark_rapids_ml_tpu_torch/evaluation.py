#
# Evaluators, drop-in for `pyspark.ml.evaluation.{RegressionEvaluator,
# MulticlassClassificationEvaluator, BinaryClassificationEvaluator}`: the
# port's own copy of spark_rapids_ml_tpu/evaluation.py (host numpy code).
# The tuning layer reads their params to score folds through the models'
# fused path (`_transform_evaluate`); `evaluate(dataset)` works on any
# DataFrame-like input with the prediction columns.
#
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .data import as_pandas
from .metrics import MulticlassMetrics, RegressionMetrics
from .params import (
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasWeightCol,
    Param,
    Params,
    TypeConverters,
)


# numpy 2 names it trapezoid, numpy 1 trapz
_trapezoid = getattr(np, "trapezoid", None) or getattr(np, "trapz")


class Evaluator(Params):
    def evaluate(self, dataset: Any) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True


class RegressionEvaluator(Evaluator, HasLabelCol, HasPredictionCol, HasWeightCol):
    """metricName in rmse|mse|r2|mae|var."""

    metricName = Param("metricName", "metric name in evaluation (rmse|mse|r2|mae|var)", TypeConverters.toString)
    throughOrigin = Param("throughOrigin", "whether regression is through the origin", TypeConverters.toBoolean)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(metricName="rmse", throughOrigin=False)
        self._set(**kwargs)

    def getMetricName(self) -> str:
        return self.getOrDefault("metricName")

    def setMetricName(self, value: str) -> "RegressionEvaluator":
        return self._set(metricName=value)

    def setLabelCol(self, value: str) -> "RegressionEvaluator":
        return self._set(labelCol=value)

    def setPredictionCol(self, value: str) -> "RegressionEvaluator":
        return self._set(predictionCol=value)

    def isLargerBetter(self) -> bool:
        return self.getMetricName() in ("r2", "var")

    def evaluate(self, dataset: Any) -> float:
        pdf = as_pandas(dataset)
        label = pdf[self.getOrDefault("labelCol")].to_numpy(dtype=np.float64)
        prediction = pdf[self.getOrDefault("predictionCol")].to_numpy(dtype=np.float64)
        weight = (
            pdf[self.getOrDefault("weightCol")].to_numpy(dtype=np.float64)
            if self.isDefined("weightCol")
            else None
        )
        return RegressionMetrics.from_values(label, prediction, weight).evaluate(self)


class MulticlassClassificationEvaluator(
    Evaluator, HasLabelCol, HasPredictionCol, HasProbabilityCol, HasWeightCol
):
    metricName = Param(
        "metricName",
        "metric name in evaluation "
        "(f1|accuracy|weightedPrecision|weightedRecall|weightedTruePositiveRate|"
        "weightedFalsePositiveRate|weightedFMeasure|truePositiveRateByLabel|"
        "falsePositiveRateByLabel|precisionByLabel|recallByLabel|fMeasureByLabel|"
        "logLoss|hammingLoss)",
        TypeConverters.toString,
    )
    metricLabel = Param("metricLabel", "the class whose metric will be computed", TypeConverters.toFloat)
    beta = Param("beta", "beta value in weightedFMeasure|fMeasureByLabel", TypeConverters.toFloat)
    eps = Param("eps", "log-loss clamp epsilon", TypeConverters.toFloat)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(metricName="f1", metricLabel=0.0, beta=1.0, eps=1e-15)
        self._set(**kwargs)

    def getMetricName(self) -> str:
        return self.getOrDefault("metricName")

    def setMetricName(self, value: str) -> "MulticlassClassificationEvaluator":
        return self._set(metricName=value)

    def setLabelCol(self, value: str) -> "MulticlassClassificationEvaluator":
        return self._set(labelCol=value)

    def setPredictionCol(self, value: str) -> "MulticlassClassificationEvaluator":
        return self._set(predictionCol=value)

    def getMetricLabel(self) -> float:
        return self.getOrDefault("metricLabel")

    def getBeta(self) -> float:
        return self.getOrDefault("beta")

    def isLargerBetter(self) -> bool:
        return self.getMetricName() not in (
            "weightedFalsePositiveRate",
            "falsePositiveRateByLabel",
            "logLoss",
            "hammingLoss",
        )

    def evaluate(self, dataset: Any) -> float:
        pdf = as_pandas(dataset)
        label = pdf[self.getOrDefault("labelCol")].to_numpy(dtype=np.float64)
        prediction = pdf[self.getOrDefault("predictionCol")].to_numpy(dtype=np.float64)
        weight = (
            pdf[self.getOrDefault("weightCol")].to_numpy(dtype=np.float64)
            if self.isDefined("weightCol")
            else np.ones_like(label)
        )
        # vectorized weighted confusion counts over unique (label, prediction) pairs
        pairs = np.stack([label, prediction], axis=1)
        uniq, inverse = np.unique(pairs, axis=0, return_inverse=True)
        counts = np.bincount(inverse, weights=weight, minlength=len(uniq))
        confusion: Dict = {
            (float(uniq[i, 0]), float(uniq[i, 1])): float(counts[i]) for i in range(len(uniq))
        }
        log_loss = None
        if self.getMetricName() == "logLoss":
            prob_col = self.getOrDefault("probabilityCol")
            probs = np.stack([np.asarray(p) for p in pdf[prob_col]])
            eps = self.getOrDefault("eps")
            # resolve each label to its probability-vector column: direct index
            # when labels are already 0..k-1 (the Spark convention), otherwise
            # by position among the sorted class values — matching how models
            # order probability columns by classes_. The fallback needs every
            # class present in this dataset; a partial batch with exotic labels
            # is ambiguous, so raise rather than silently mis-index.
            lab_int = label.astype(int)
            if np.array_equal(lab_int, label) and lab_int.min() >= 0 and lab_int.max() < probs.shape[1]:
                col = lab_int
            else:
                classes = np.unique(label)
                if len(classes) != probs.shape[1]:
                    raise ValueError(
                        "logLoss cannot map labels to probability columns: labels are not "
                        f"0..{probs.shape[1] - 1} indices and the {len(classes)} distinct label "
                        f"values do not cover the {probs.shape[1]} probability columns"
                    )
                col = np.searchsorted(classes, label)
            p_true = np.clip(probs[np.arange(len(label)), col], eps, 1 - eps)
            log_loss = float(np.sum(-np.log(p_true) * weight))
        return MulticlassMetrics.from_confusion(confusion, log_loss).evaluate(self)


class BinaryClassificationEvaluator(Evaluator, HasLabelCol, HasRawPredictionCol, HasWeightCol):
    """metricName in areaUnderROC|areaUnderPR (computed from raw scores)."""

    metricName = Param("metricName", "metric name in evaluation (areaUnderROC|areaUnderPR)", TypeConverters.toString)
    numBins = Param("numBins", "number of bins for curve computation (0 = exact)", TypeConverters.toInt)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(metricName="areaUnderROC", numBins=1000)
        self._set(**kwargs)

    def getMetricName(self) -> str:
        return self.getOrDefault("metricName")

    def setMetricName(self, value: str) -> "BinaryClassificationEvaluator":
        return self._set(metricName=value)

    def setLabelCol(self, value: str) -> "BinaryClassificationEvaluator":
        return self._set(labelCol=value)

    def setRawPredictionCol(self, value: str) -> "BinaryClassificationEvaluator":
        return self._set(rawPredictionCol=value)

    def evaluate(self, dataset: Any) -> float:
        pdf = as_pandas(dataset)
        label = pdf[self.getOrDefault("labelCol")].to_numpy(dtype=np.float64)
        raw = pdf[self.getOrDefault("rawPredictionCol")]
        first = raw.iloc[0]
        if np.ndim(first) > 0 or isinstance(first, (list, np.ndarray)) or hasattr(first, "toArray"):
            score = np.stack([np.asarray(v.toArray() if hasattr(v, "toArray") else v) for v in raw])[:, -1]
        else:
            score = raw.to_numpy(dtype=np.float64)
        weight = (
            pdf[self.getOrDefault("weightCol")].to_numpy(dtype=np.float64)
            if self.isDefined("weightCol")
            else np.ones_like(label)
        )
        order = np.argsort(-score, kind="stable")
        score, label, weight = score[order], label[order], weight[order]
        tp_row = np.cumsum(weight * (label > 0.5))
        fp_row = np.cumsum(weight * (label <= 0.5))
        # group tied scores: one ROC/PR point per unique threshold, taken at the
        # LAST row of each tie group (counting the whole group at once)
        is_last_of_group = np.append(score[1:] != score[:-1], True)
        tp = tp_row[is_last_of_group]
        fp = fp_row[is_last_of_group]
        num_bins = self.getOrDefault("numBins")
        if num_bins and len(tp) > num_bins:
            # downsample curve points (Spark's numBins behavior), keeping the end
            keep = np.unique(np.concatenate([
                np.linspace(0, len(tp) - 1, num_bins).astype(int), [len(tp) - 1]
            ]))
            tp, fp = tp[keep], fp[keep]
        tot_p, tot_n = tp_row[-1], fp_row[-1]
        if self.getMetricName() == "areaUnderROC":
            tpr = np.concatenate([[0.0], tp / max(tot_p, 1e-30)])
            fpr = np.concatenate([[0.0], fp / max(tot_n, 1e-30)])
            return float(_trapezoid(tpr, fpr))
        if self.getMetricName() == "areaUnderPR":
            precision = tp / np.maximum(tp + fp, 1e-30)
            recall = tp / max(tot_p, 1e-30)
            recall = np.concatenate([[0.0], recall])
            precision = np.concatenate([[1.0], precision])
            return float(_trapezoid(precision, recall))
        raise ValueError(f"Unsupported metric name {self.getMetricName()!r}")
