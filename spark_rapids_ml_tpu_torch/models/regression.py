#
# RandomForestRegressor and LinearRegression (ridge, lasso and elastic net
# through its params), estimators and models, drop-in for their
# `pyspark.ml.regression` namesakes: the PyTorch counterpart of
# spark_rapids_ml_tpu/models/regression.py, on one device. The forest's
# shared machinery (fit, model base, what it leaves out) is in tree.py.
#
# LinearRegression: solver choice by the reg params as in the JAX package,
# OLS / ridge(alpha·Σw) / coordinate descent; a (regParam,
# elasticNetParam) grid of one solver solves as one batched grid over one
# statistics pass (ops/linear.py `linear_fit_batched`), and the fused
# cross-validation path (`_combine`, `_transform_evaluate`) scores every
# model of a fold at once. Left out, each raising NotImplementedError
# naming its ROADMAP item: `evaluate` and `.cpu()` (Spark interop, A16).
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
            return self._attrs(state, inputs)

        return _fit

    def _batch_group_key(self, sp: Dict[str, Any]):
        # regParam (alpha) and elasticNetParam (l1_ratio) vary inside a
        # batched grid; the solver choice use_cd derived from them splits a
        # grid mixing elastic-net and ridge/OLS points into one group per
        # solver; everything else in the param set must be equal
        use_cd = float(sp["alpha"]) > 0 and float(sp["l1_ratio"]) > 0
        rest = tuple(sorted((k, repr(v)) for k, v in sp.items() if k not in ("alpha", "l1_ratio")))
        return (use_cd, rest)

    def _get_tpu_batched_fit_func(self, extracted: ExtractedData):
        from ..core import resolve_solver_precision
        from ..ops.linear import linear_fit_batched

        def _fit_batch(inputs: FitInputs, param_sets) -> List[Dict[str, Any]]:
            alphas = [float(sp["alpha"]) for sp in param_sets]
            l1rs = [float(sp["l1_ratio"]) for sp in param_sets]
            p0 = param_sets[0]  # uniform per group key
            states = linear_fit_batched(
                inputs.X, inputs.y, inputs.w, alphas, l1rs,
                fit_intercept=bool(p0["fit_intercept"]),
                standardize=bool(p0.get("normalize", False)),
                use_cd=bool(alphas[0] > 0 and l1rs[0] > 0),
                max_iter=int(p0["max_iter"]),
                tol=float(p0["tol"]),
                fast=resolve_solver_precision(p0) == "bf16",
            )
            return [self._attrs(state, inputs) for state in states]

        return _fit_batch

    @staticmethod
    def _attrs(state: Dict[str, Any], inputs: FitInputs) -> Dict[str, Any]:
        return {
            "coef_": state["coef_"].cpu().numpy(),
            "intercept_": float(state["intercept_"]),
            "n_iter_": int(state["n_iter_"]),
            "n_cols": inputs.n_cols,
            "dtype": np.dtype(inputs.dtype).name,
        }

    def _supportsTransformEvaluate(self, evaluator: Any) -> bool:
        if not hasattr(evaluator, "getMetricName"):
            return False
        if evaluator.getMetricName() not in ("rmse", "mse", "r2", "mae", "var"):
            return False
        # a weighted evaluator takes the fallback path: the fused pass makes
        # unweighted statistics
        return not (evaluator.hasParam("weightCol") and evaluator.isDefined("weightCol"))

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

    # -- fused CV path ----------------------------------------------------
    def _combine(self, models: List["LinearRegressionModel"]) -> "LinearRegressionModel":
        """Pack N fitted models into one multi-model (coef_ stacked [m, d])."""
        combined = LinearRegressionModel(
            coef_=np.stack([m.coef_ for m in models]),
            intercept_=0.0,
            n_iter_=self.n_iter_,
            n_cols=self.n_cols,
            dtype=self.dtype,
        )
        combined._intercepts = np.asarray([m.intercept_ for m in models])
        self._copyValues(combined)
        self._copy_solver_params(combined)
        return combined

    def _transform_evaluate(self, dataset: Any, evaluator: Any) -> List[float]:
        """Score every packed model in one pass over a dataset (the feature
        block extracted, then `_transform_evaluate_arrays`)."""
        from ..core import evaluator_label_column
        from ..data import as_pandas

        extracted = self._pre_process_data(dataset, for_fit=False)
        # the evaluator's labelCol governs scoring (it may differ from the model's)
        label = as_pandas(dataset)[evaluator_label_column(self, evaluator)].to_numpy(dtype=np.float64)
        return self._transform_evaluate_arrays(extracted.features, label, evaluator)

    def _transform_evaluate_arrays(self, features: Any, label: np.ndarray, evaluator: Any) -> List[float]:
        """Score every packed model over an extracted block: predictions
        [n, m] in float64 (features @ coefᵀ + intercepts), then each
        model's regression statistics. `features` is a host block, or rows
        already on the device (the tuning layer's held-out rows, taken from
        the fit's placement), multiplied there in float64 in row tiles."""
        import torch

        from ..metrics import RegressionMetrics
        from ..ops.linalg import row_tiles

        assert self.coef_.ndim == 2 and hasattr(self, "_intercepts"), "call _combine first"
        if isinstance(features, torch.Tensor):
            coef_t = torch.from_numpy(np.ascontiguousarray(self.coef_.T, dtype=np.float64)).to(features.device)
            preds = np.concatenate(
                [(features[rows].to(torch.float64) @ coef_t).cpu().numpy() for rows in row_tiles(features.shape[0])]
                or [np.zeros((0, self.coef_.shape[0]))]
            ) + self._intercepts[None, :]
        else:
            preds = np.asarray(features, dtype=np.float64) @ self.coef_.T + self._intercepts[None, :]
        return [
            RegressionMetrics.from_values(label, preds[:, j]).evaluate(evaluator)
            for j in range(preds.shape[1])
        ]

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
