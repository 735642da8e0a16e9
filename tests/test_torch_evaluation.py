#
# The port's metrics and evaluators (metrics/, evaluation.py) against the
# JAX package's on the same predictions, case for case with the metric
# half of tests/test_tuning.py: every metric name of the three evaluators,
# weighted and unweighted, the summarizer merge, ties and numBins of the
# binary curves, the logLoss label mapping, and sklearn where the JAX tests
# use it. The metrics are numpy code in both packages: the same inputs give
# the same float64 operations, so the metrics are held equal (rtol 1e-12
# where the JAX test itself states a float64 bound).
#
import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_tpu import evaluation as jev
from spark_rapids_ml_tpu.metrics import MulticlassMetrics as JaxMulticlassMetrics
from spark_rapids_ml_tpu.metrics import RegressionMetrics as JaxRegressionMetrics
from spark_rapids_ml_tpu_torch import (
    BinaryClassificationEvaluator,
    MulticlassClassificationEvaluator,
    RegressionEvaluator,
)
from spark_rapids_ml_tpu_torch.metrics import MulticlassMetrics, RegressionMetrics, _SummarizerBuffer
from spark_rapids_ml_tpu_torch.metrics import transform_evaluate_metric

F64 = 1e-12


def _reg_frame(rng, n=200, weighted=False):
    y = rng.normal(size=n)
    p = y + 0.3 * rng.normal(size=n)
    df = pd.DataFrame({"label": y, "prediction": p})
    if weighted:
        df["w"] = rng.uniform(0.2, 2.0, size=n)
    return df


def _cls_frame(rng, n=300, k=3, weighted=False):
    y = rng.integers(0, k, size=n).astype(float)
    p = np.where(rng.uniform(size=n) < 0.7, y, rng.integers(0, k, size=n)).astype(float)
    prob = rng.dirichlet(np.ones(k), size=n)
    df = pd.DataFrame({"label": y, "prediction": p, "probability": list(prob)})
    if weighted:
        df["w"] = rng.uniform(0.2, 2.0, size=n)
    return df


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric", ["rmse", "mse", "r2", "mae", "var"])
def test_regression_evaluator_matches_jax(rng, metric, weighted):
    df = _reg_frame(rng, weighted=weighted)
    kw = {"metricName": metric, **({"weightCol": "w"} if weighted else {})}
    got = RegressionEvaluator(**kw).evaluate(df)
    want = jev.RegressionEvaluator(**kw).evaluate(df)
    assert got == want
    assert RegressionEvaluator(**kw).isLargerBetter() == jev.RegressionEvaluator(**kw).isLargerBetter()


def test_regression_r2_through_origin_matches_jax(rng):
    df = _reg_frame(rng)
    got = RegressionEvaluator(metricName="r2", throughOrigin=True).evaluate(df)
    assert got == jev.RegressionEvaluator(metricName="r2", throughOrigin=True).evaluate(df)
    assert got != RegressionEvaluator(metricName="r2").evaluate(df)


_MULTI = [m for m in MulticlassMetrics.SUPPORTED_MULTI_CLASS_METRIC_NAMES]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric", _MULTI)
def test_multiclass_evaluator_matches_jax(rng, metric, weighted):
    df = _cls_frame(rng, weighted=weighted)
    kw = {"metricName": metric, "metricLabel": 1.0, "beta": 0.5, **({"weightCol": "w"} if weighted else {})}
    got = MulticlassClassificationEvaluator(**kw).evaluate(df)
    want = jev.MulticlassClassificationEvaluator(**kw).evaluate(df)
    np.testing.assert_allclose(got, want, rtol=F64)
    assert MulticlassClassificationEvaluator(**kw).isLargerBetter() == \
        jev.MulticlassClassificationEvaluator(**kw).isLargerBetter()


def test_supported_metric_names_match_jax():
    assert MulticlassMetrics.SUPPORTED_MULTI_CLASS_METRIC_NAMES == JaxMulticlassMetrics.SUPPORTED_MULTI_CLASS_METRIC_NAMES
    assert tuple(transform_evaluate_metric) == ("accuracy_like", "log_loss", "regression")


@pytest.mark.parametrize("num_bins", [0, 1000, 25])
@pytest.mark.parametrize("metric", ["areaUnderROC", "areaUnderPR"])
def test_binary_evaluator_matches_jax(rng, metric, num_bins):
    y = rng.integers(0, 2, size=300).astype(float)
    score = np.round(y + rng.normal(scale=0.8, size=300), 1)  # ties
    df = pd.DataFrame({"label": y, "rawPrediction": [np.array([-s, s]) for s in score], "w": rng.uniform(0.5, 1.5, 300)})
    for kw in ({}, {"weightCol": "w"}):
        got = BinaryClassificationEvaluator(metricName=metric, numBins=num_bins, **kw).evaluate(df)
        want = jev.BinaryClassificationEvaluator(metricName=metric, numBins=num_bins, **kw).evaluate(df)
        np.testing.assert_allclose(got, want, rtol=F64)


def test_regression_metrics_vs_sklearn(rng):
    from sklearn.metrics import mean_absolute_error, mean_squared_error, r2_score

    y = rng.normal(size=200)
    p = y + 0.3 * rng.normal(size=200)
    m = RegressionMetrics.from_values(y, p)
    np.testing.assert_allclose(m.mean_squared_error(), mean_squared_error(y, p), rtol=1e-10)
    np.testing.assert_allclose(m.mean_absolute_error(), mean_absolute_error(y, p), rtol=1e-10)
    np.testing.assert_allclose(m.r2(), r2_score(y, p), rtol=1e-10)
    j = JaxRegressionMetrics.from_values(y, p)
    assert (m.mean_squared_error(), m.r2(), m.explained_variance()) == (
        j.mean_squared_error(), j.r2(), j.explained_variance())


def test_summarizer_buffer_merge_equals_whole(rng):
    y = rng.normal(size=300)
    p = y + 0.1 * rng.normal(size=300)
    whole = RegressionMetrics.from_values(y, p)
    parts = [RegressionMetrics.from_values(y[i:i + 100], p[i:i + 100]) for i in (0, 100, 200)]
    merged = RegressionMetrics.merge_all(parts)
    np.testing.assert_allclose(merged.mean_squared_error(), whole.mean_squared_error(), rtol=F64)
    np.testing.assert_allclose(merged.r2(), whole.r2(), rtol=F64)
    np.testing.assert_allclose(merged.mean_absolute_error(), whole.mean_absolute_error(), rtol=F64)
    empty = _SummarizerBuffer()
    assert empty.merge(whole._buffer) is whole._buffer and whole._buffer.merge(empty) is whole._buffer


def test_multiclass_metrics_vs_sklearn_and_jax(rng):
    from sklearn.metrics import accuracy_score, f1_score, precision_score, recall_score

    y = rng.integers(0, 3, size=300).astype(float)
    p = np.where(rng.uniform(size=300) < 0.8, y, rng.integers(0, 3, size=300)).astype(float)
    confusion = {}
    for a, b in zip(y, p):
        confusion[(a, b)] = confusion.get((a, b), 0.0) + 1.0
    m = MulticlassMetrics.from_confusion(confusion)
    ev = MulticlassClassificationEvaluator(metricName="accuracy")
    np.testing.assert_allclose(m.evaluate(ev), accuracy_score(y, p), rtol=F64)
    for name, sk in (("f1", f1_score), ("weightedPrecision", precision_score), ("weightedRecall", recall_score)):
        ev.setMetricName(name)
        np.testing.assert_allclose(m.evaluate(ev), sk(y, p, average="weighted"), rtol=1e-10)
        assert m.evaluate(ev) == JaxMulticlassMetrics.from_confusion(confusion).evaluate(ev)
    half = {k: v / 2 for k, v in confusion.items()}
    assert MulticlassMetrics.merge_confusion(half, half) == JaxMulticlassMetrics.merge_confusion(half, half)


def test_binary_evaluator_auc_vs_sklearn(rng):
    from sklearn.metrics import average_precision_score, roc_auc_score

    y = rng.integers(0, 2, size=300).astype(float)
    score = y + rng.normal(scale=0.8, size=300)
    df = pd.DataFrame({"label": y, "rawPrediction": score})
    ev = BinaryClassificationEvaluator()
    np.testing.assert_allclose(ev.evaluate(df), roc_auc_score(y, score), atol=1e-9)
    ev.setMetricName("areaUnderPR")
    np.testing.assert_allclose(ev.evaluate(df), average_precision_score(y, score), atol=5e-3)


def test_binary_auc_ties_and_order_invariance(rng):
    from sklearn.metrics import roc_auc_score

    y = np.array([1.0, 1, 1, 0, 0, 0])
    df = pd.DataFrame({"label": y, "rawPrediction": np.zeros(6)})
    ev = BinaryClassificationEvaluator(numBins=0)
    np.testing.assert_allclose(ev.evaluate(df), 0.5, atol=F64)
    np.testing.assert_allclose(ev.evaluate(df.iloc[::-1].reset_index(drop=True)), 0.5, atol=F64)
    yy = rng.integers(0, 2, size=200).astype(float)
    ss = np.round(yy + rng.normal(scale=0.8, size=200), 1)  # heavy ties
    np.testing.assert_allclose(
        ev.evaluate(pd.DataFrame({"label": yy, "rawPrediction": ss})), roc_auc_score(yy, ss), atol=1e-10
    )


def test_logloss_non_contiguous_labels(rng):
    from sklearn.metrics import log_loss as sk_log_loss

    classes = np.array([1.0, 3.0, 5.0])
    y = classes[rng.integers(0, 3, size=120)]
    probs = rng.dirichlet(np.ones(3), size=120)
    df = pd.DataFrame({"label": y, "prediction": classes[np.argmax(probs, axis=1)], "probability": list(probs)})
    got = MulticlassClassificationEvaluator(metricName="logLoss").evaluate(df)
    np.testing.assert_allclose(got, sk_log_loss(y, probs, labels=classes), rtol=1e-10)
    assert got == jev.MulticlassClassificationEvaluator(metricName="logLoss").evaluate(df)
    bad = df.iloc[:5].copy()
    bad["label"] = [1.0, 3.0, 9.0, 9.0, 11.0]  # 3 distinct labels, none mappable by index
    with pytest.raises(ValueError, match="logLoss cannot map labels"):
        MulticlassClassificationEvaluator(metricName="logLoss").evaluate(bad.iloc[:2])


def test_logloss_contiguous_labels_vs_sklearn(rng):
    from sklearn.metrics import log_loss as sk_log_loss

    y = rng.integers(0, 3, size=150).astype(float)
    probs = rng.dirichlet(np.ones(3), size=150)
    df = pd.DataFrame({"label": y, "prediction": np.argmax(probs, axis=1).astype(float), "probability": list(probs)})
    np.testing.assert_allclose(MulticlassClassificationEvaluator(metricName="logLoss").evaluate(df),
                               sk_log_loss(y, probs, labels=[0, 1, 2]), rtol=1e-10)


def test_unknown_metric_names_raise():
    df = pd.DataFrame({"label": [0.0, 1.0], "prediction": [0.0, 1.0], "rawPrediction": [0.1, 0.9]})
    for ev in (RegressionEvaluator(metricName="nope"), MulticlassClassificationEvaluator(metricName="nope"),
               BinaryClassificationEvaluator(metricName="nope")):
        with pytest.raises(ValueError, match="Unsupported metric name"):
            ev.evaluate(df)
