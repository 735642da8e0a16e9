#
# Metrics from sufficient statistics, as Spark's Scala MulticlassMetrics,
# RegressionMetrics and SummarizerBuffer compute them, so CrossValidator
# scores all the models of a fold from one pass. The port's own copy of
# spark_rapids_ml_tpu/metrics/ (numpy code, no device work).
#
from __future__ import annotations

from collections import namedtuple

# Which sufficient-stats schema a fused transform+evaluate pass must produce
# (reference metrics/__init__.py:22-37).
transform_evaluate_metric = namedtuple(
    "transform_evaluate_metric", ("accuracy_like", "log_loss", "regression")
)("accuracy_like", "log_loss", "regression")


class EvalMetricInfo:
    """What the evaluator needs from the transform pass
    (reference metrics/__init__.py:31-40)."""

    def __init__(self, eval_metric: str, eps: float = 1e-15):
        self.eval_metric = eval_metric
        self.eps = eps


from .MulticlassMetrics import MulticlassMetrics  # noqa: E402,F401
from .RegressionMetrics import RegressionMetrics, _SummarizerBuffer  # noqa: E402,F401
