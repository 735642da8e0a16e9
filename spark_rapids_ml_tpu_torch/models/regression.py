#
# RandomForestRegressor and LinearRegression (ridge, lasso and elastic net
# through its params), estimators and models, drop-in for their
# `pyspark.ml.regression` namesakes: the PyTorch counterpart of
# spark_rapids_ml_tpu/models/regression.py, on one device. The forest's
# shared machinery (fit, model base, what it leaves out) is in tree.py.
#
# LinearRegression: solver choice by the reg params as in the JAX package,
# OLS / ridge(alpha·Σw) / coordinate descent. Left out, each raising
# NotImplementedError naming its ROADMAP item: `evaluate` and `.cpu()`
# (Spark interop, A16), and the fused cross-validation path `_combine` /
# `_transform_evaluate` (A9).
#
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core import FitInputs, _TpuEstimatorSupervised, _TpuModelWithColumns
from ..data import ExtractedData
from ..params import (
    HasElasticNetParam,
    HasFeaturesCol,
    HasFeaturesCols,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasRegParam,
    HasStandardization,
    HasTol,
    HasWeightCol,
    Param,
    TypeConverters,
)
from .tree import _as_row, _RandomForestEstimator, _RandomForestModel


class RandomForestRegressor(_RandomForestEstimator):
    """RandomForestRegressor, drop-in for
    ``pyspark.ml.regression.RandomForestRegressor``: the classifier's
    level-wise growth with the variance split criterion."""

    _is_classification = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._setDefault(impurity="variance")
        if self._solver_params.get("split_criterion") is None:
            self._solver_params["split_criterion"] = "variance"

    def _set_params(self, **kwargs):
        if "impurity" in kwargs and kwargs["impurity"] != "variance":
            raise ValueError("impurity must be 'variance' for regression")
        return super()._set_params(**kwargs)

    def _create_model(self, attrs: Dict[str, Any]) -> "RandomForestRegressionModel":
        return RandomForestRegressionModel(**attrs)


class RandomForestRegressionModel(_RandomForestModel):
    """Fitted random-forest regression model: the prediction is the mean
    of the trees' leaf means."""

    _is_classification = False

    def _leaf_values(self) -> np.ndarray:
        # node mean: Σwy / Σw, kept as [M, 1]
        w = self.node_stats[..., 0]
        wy = self.node_stats[..., 1]
        return (wy / np.maximum(w, 1e-30))[..., None]

    def _out_column_names(self) -> List[str]:
        return [self.getOrDefault("predictionCol")]

    def _split_output(self, result, names, extracted):
        return {names[0]: np.asarray(result)[:, 0]}

    def predict(self, value) -> float:
        return float(np.asarray(self._raw_forest_output(_as_row(value)))[0, 0])



class _LinearRegressionParams(
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasMaxIter,
    HasTol,
    HasRegParam,
    HasElasticNetParam,
    HasFitIntercept,
    HasStandardization,
    HasWeightCol,
):
    solver = Param("solver", "solver algorithm: 'auto', 'normal' or 'eig'", TypeConverters.toString)
    loss = Param("loss", "loss function: only 'squaredError'", TypeConverters.toString)

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "maxIter": "max_iter",
            "regParam": "alpha",
            "elasticNetParam": "l1_ratio",
            "tol": "tol",
            "fitIntercept": "fit_intercept",
            "standardization": "normalize",
            "solver": "solver",
            "loss": "loss",
            "weightCol": "",
        }

    @classmethod
    def _param_value_mapping(cls):
        def _solver(v):
            return {"auto": "eig", "normal": "eig", "eig": "eig"}.get(v)

        def _loss(v):
            return "squared_loss" if v in ("squaredError", "squared_loss") else None

        return {"solver": _solver, "loss": _loss}

    def _get_solver_params_default(self) -> Dict[str, Any]:
        return {
            "alpha": 0.0001,
            "l1_ratio": 0.0,
            "fit_intercept": True,
            "normalize": False,
            "max_iter": 1000,
            "tol": 1e-3,
            "solver": "eig",
            "loss": "squared_loss",
            "verbose": False,
            # per-estimator override of config["solver_precision"]; "bf16"
            # runs the sufficient-statistics gram contraction bf16-in /
            # float32-accumulate; the solve stays full precision
            "solver_precision": None,
        }


class LinearRegression(_LinearRegressionParams, _TpuEstimatorSupervised):
    """LinearRegression estimator, drop-in for
    ``pyspark.ml.regression.LinearRegression``.

    One pass over the rows builds the normal-equation sufficient statistics
    (XᵀWX, XᵀWy) on the device; OLS and ridge solve on the d×d gram,
    L1/elastic net runs gram-space coordinate descent (ops/linear.py). The
    ridge path scales alpha by Σw for Spark objective parity."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        # Spark's defaults; standardization=True reaches the solver's
        # `normalize` (whose own default is False) through _setDefault
        self._setDefault(
            maxIter=100, regParam=0.0, elasticNetParam=0.0, tol=1e-6,
            fitIntercept=True, standardization=True, solver="auto", loss="squaredError",
        )
        self._set_params(**kwargs)

    def setMaxIter(self, value: int) -> "LinearRegression":
        return self._set_params(maxIter=value)

    def setRegParam(self, value: float) -> "LinearRegression":
        return self._set_params(regParam=value)

    def setElasticNetParam(self, value: float) -> "LinearRegression":
        return self._set_params(elasticNetParam=value)

    def setTol(self, value: float) -> "LinearRegression":
        return self._set_params(tol=value)

    def setFitIntercept(self, value: bool) -> "LinearRegression":
        return self._set_params(fitIntercept=value)

    def setStandardization(self, value: bool) -> "LinearRegression":
        return self._set_params(standardization=value)

    def setLoss(self, value: str) -> "LinearRegression":
        return self._set_params(loss=value)

    def setFeaturesCol(self, value) -> "LinearRegression":
        return self._set_params(featuresCol=value) if isinstance(value, str) else self._set_params(featuresCols=value)

    def setLabelCol(self, value: str) -> "LinearRegression":
        return self._set_params(labelCol=value)

    def setPredictionCol(self, value: str) -> "LinearRegression":
        return self._set_params(predictionCol=value)

    def setWeightCol(self, value: str) -> "LinearRegression":
        return self._set_params(weightCol=value)

    def _get_tpu_fit_func(self, extracted: ExtractedData):
        from ..core import resolve_solver_precision
        from ..ops.linear import linear_fit

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            alpha = float(params["alpha"])
            l1_ratio = float(params["l1_ratio"])
            state = linear_fit(
                inputs.X, inputs.y, inputs.w,
                alpha=alpha,
                l1_ratio=l1_ratio,
                fit_intercept=bool(params["fit_intercept"]),
                standardize=bool(params.get("normalize", False)),
                use_cd=bool(alpha > 0 and l1_ratio > 0),
                max_iter=int(params["max_iter"]),
                tol=float(params["tol"]),
                fast=resolve_solver_precision(params) == "bf16",
            )
            return {
                "coef_": state["coef_"].cpu().numpy(),
                "intercept_": float(state["intercept_"]),
                "n_iter_": int(state["n_iter_"]),
                "n_cols": inputs.n_cols,
                "dtype": np.dtype(inputs.dtype).name,
            }

        return _fit

    def _create_model(self, attrs: Dict[str, Any]) -> "LinearRegressionModel":
        return LinearRegressionModel(**attrs)


class LinearRegressionModel(_LinearRegressionParams, _TpuModelWithColumns):
    """Fitted linear regression model."""

    def __init__(
        self,
        coef_: Optional[np.ndarray] = None,
        intercept_: float = 0.0,
        n_iter_: int = 0,
        n_cols: int = 0,
        dtype: str = "float32",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            coef_=coef_, intercept_=intercept_, n_iter_=n_iter_, n_cols=n_cols, dtype=dtype
        )
        self.coef_ = np.asarray(coef_)
        self.intercept_ = float(intercept_)
        self.n_iter_ = int(n_iter_)
        self.n_cols = int(n_cols)
        self.dtype = dtype

    # -- Spark ML model surface -------------------------------------------
    @property
    def coefficients(self):
        from ..linalg import DenseVector

        return DenseVector(self.coef_)

    @property
    def intercept(self) -> float:
        return self.intercept_

    @property
    def numFeatures(self) -> int:
        return self.n_cols

    @property
    def hasSummary(self) -> bool:
        return False

    @property
    def scale(self) -> float:
        """Huber loss is unsupported (squaredError only); 1.0 for API
        compatibility."""
        return 1.0

    def evaluate(self, dataset):
        raise NotImplementedError(
            "LinearRegressionModel.evaluate (through the converted Spark ML "
            "model) is not in the PyTorch port yet (ROADMAP item A16)"
        )

    def cpu(self):
        raise NotImplementedError(
            "LinearRegressionModel.cpu() (conversion to a Spark ML model) is "
            "not in the PyTorch port yet (ROADMAP item A16)"
        )

    def _combine(self, models: List["LinearRegressionModel"]) -> "LinearRegressionModel":
        raise NotImplementedError(
            "the fused cross-validation path (_combine) is not in the PyTorch "
            "port yet (ROADMAP item A9)"
        )

    def _transform_evaluate(self, dataset: Any, evaluator: Any) -> List[float]:
        raise NotImplementedError(
            "the fused cross-validation path (_transform_evaluate) is not in "
            "the PyTorch port yet (ROADMAP item A9)"
        )

    def setFeaturesCol(self, value) -> "LinearRegressionModel":
        return self._set_params(featuresCol=value) if isinstance(value, str) else self._set_params(featuresCols=value)

    def setPredictionCol(self, value: str) -> "LinearRegressionModel":
        return self._set_params(predictionCol=value)

    def predict(self, value) -> float:
        """Single-vector predict (Spark ML model surface), on the host."""
        from ..linalg import Vector

        v = value.toArray() if isinstance(value, Vector) else np.asarray(value)
        return float(v @ self.coef_ + self.intercept_)

    def _out_column_names(self) -> List[str]:
        return [self.getOrDefault("predictionCol")]

    def _get_transform_func(self):
        from ..ops.linear import linear_predict
        from ..parallel import default_device, host_tensor

        coef = self.coef_
        intercept = self.intercept_
        dtype = np.float32 if self._float32_inputs else np.float64

        def construct():
            dev = default_device()
            return (
                host_tensor(coef.astype(dtype)).to(dev),
                host_tensor(np.asarray(intercept, dtype=dtype)).to(dev),
            )

        def predict(state, xb):
            c, b = state
            return linear_predict(xb, c, b)

        return construct, predict

    # serving hooks -------------------------------------------------------

    def _serve_workspace_terms(self, bucket_rows_count, itemsize):
        # one prediction scalar per row (the reference's term), and the
        # port's own: one [rows, 1, d] product block of the fixed-order dot
        # (linalg.rows_dot_fixed) and its first halving
        from ..ops.linalg import rows_dot_block_rows

        d = int(self.n_cols)
        rows = min(int(bucket_rows_count), rows_dot_block_rows(1, d))
        return {"pred": int(bucket_rows_count) * itemsize, "dot_block": rows * d * itemsize * 3 // 2}

    def _serve_flop_estimate(self, n_rows, n_cols):
        # the X @ coef dot per row
        return 2.0 * n_rows * n_cols
