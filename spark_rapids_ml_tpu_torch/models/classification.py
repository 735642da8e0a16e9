#
# RandomForestClassifier and LogisticRegression, estimators and models,
# drop-in for their `pyspark.ml.classification` namesakes: the PyTorch
# counterpart of spark_rapids_ml_tpu/models/classification.py, on one
# device. The forest's shared machinery (fit, model base, what it leaves
# out) is in tree.py.
#
# LogisticRegression: binomial and multinomial, standardization, the
# multinomial intercepts centered, the single-class degenerate model,
# rawPrediction / probability / prediction columns, threshold(s), warm
# start from a fitted model. Solver choice as there: the GLM quasi-Newton
# when regParam·elasticNetParam = 0, OWL-QN otherwise (ops/logistic.py). A
# (regParam, elasticNetParam) grid of one solver solves in lockstep
# (`logistic_fit_batched`), and the fused cross-validation path
# (`_combine`, `_transform_evaluate`) scores every model of a fold at once.
# An over-budget fit streams its rows from the host
# (ops/streaming.logistic_fit_streaming; L2 only: a demoted L1/elastic-net
# fit raises HbmBudgetError, as in the JAX package). CSR input fits on its
# padded-ELL form (`logistic_fit_ell`, `logistic_fit_ell_batched`, and
# streamed), with scale-only standardization. With solver checkpoints
# active (checkpoint.py) a single fit, resident, sparse or streamed,
# checkpoints its loop under "logistic:<its params>" (streamed:
# "logistic_stream:..."), the JAX package's keys; warm start takes a fitted
# model or a `SolverCheckpoint` with an original-space `coef_`. It fits
# across processes too (a TpuContext with nranks > 1): the class sets are
# merged over the rendezvous and every row reduction of the solvers, dense
# or padded-ELL, is summed across ranks (ops/logistic.py); the forests'
# fit splits its trees between the ranks (models/tree.py). Left out,
# each raising NotImplementedError naming its ROADMAP item: `evaluate` and
# `.cpu()` (Spark interop, A16).
#
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core import FitInputs, _TpuEstimatorSupervised, _TpuModelWithColumns
from ..data import ExtractedData, as_dense, as_pandas
from ..linalg import DenseVector
from ..params import (
    HasElasticNetParam,
    HasEnableSparseDataOptim,
    HasFeaturesCol,
    HasFeaturesCols,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasRegParam,
    HasStandardization,
    HasTol,
    HasWeightCol,
    Param,
    TypeConverters,
)
from .tree import _as_row, _RandomForestEstimator, _RandomForestModel


class RandomForestClassifier(HasProbabilityCol, HasRawPredictionCol, _RandomForestEstimator):
    """RandomForestClassifier, drop-in for
    ``pyspark.ml.classification.RandomForestClassifier``: level-wise
    histogram tree growth on the device (ops/trees.py). Impurity: gini
    (default) or entropy."""

    _is_classification = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._setDefault(impurity="gini")
        if self._solver_params.get("split_criterion") is None:
            self._solver_params["split_criterion"] = "gini"

    def _set_params(self, **kwargs):
        if "impurity" in kwargs and kwargs["impurity"] not in ("gini", "entropy"):
            raise ValueError("impurity must be 'gini' or 'entropy' for classification")
        return super()._set_params(**kwargs)

    def setProbabilityCol(self, value: str) -> "RandomForestClassifier":
        return self._set_params(probabilityCol=value)

    def setRawPredictionCol(self, value: str) -> "RandomForestClassifier":
        return self._set_params(rawPredictionCol=value)

    def _create_model(self, attrs: Dict[str, Any]) -> "RandomForestClassificationModel":
        return RandomForestClassificationModel(**attrs)


class RandomForestClassificationModel(HasProbabilityCol, HasRawPredictionCol, _RandomForestModel):
    """Fitted random-forest classification model: rawPrediction is the
    mean of the trees' leaf class distributions times numTrees,
    probability that mean normalized, prediction its argmax class."""

    _is_classification = True

    @property
    def numClasses(self) -> int:
        return len(self.classes_)

    def _leaf_values(self) -> np.ndarray:
        # normalized per-node class distribution (Spark averages leaf distributions)
        totals = self.node_stats.sum(axis=2, keepdims=True)
        return self.node_stats / np.maximum(totals, 1e-30)

    def setProbabilityCol(self, value: str) -> "RandomForestClassificationModel":
        return self._set_params(probabilityCol=value)

    def setRawPredictionCol(self, value: str) -> "RandomForestClassificationModel":
        return self._set_params(rawPredictionCol=value)

    def _out_column_names(self) -> List[str]:
        return [
            self.getOrDefault("rawPredictionCol"),
            self.getOrDefault("probabilityCol"),
            self.getOrDefault("predictionCol"),
        ]

    def _split_output(self, result, names, extracted) -> Dict[str, Any]:
        mean_dist = np.asarray(result, dtype=np.float64)
        prob = mean_dist / np.maximum(mean_dist.sum(axis=1, keepdims=True), 1e-30)
        raw = mean_dist * self.num_trees  # Spark raw = summed tree votes
        prediction = self.classes_[np.argmax(prob, axis=1)].astype(np.float64)
        as_vec = extracted.feature_kind == "vector"
        return {
            names[0]: [DenseVector(r) for r in raw] if as_vec else list(raw),
            names[1]: [DenseVector(p) for p in prob] if as_vec else list(prob),
            names[2]: prediction,
        }

    def _one_dist(self, value) -> np.ndarray:
        return np.asarray(self._raw_forest_output(_as_row(value)), dtype=np.float64)[0]

    def predict(self, value) -> float:
        return float(self.classes_[int(np.argmax(self._one_dist(value)))])

    def predictRaw(self, value) -> DenseVector:
        """Summed per-tree normalized votes (Spark's RF raw prediction)."""
        return DenseVector(self._one_dist(value) * self.num_trees)

    def predictProbability(self, value) -> DenseVector:
        dist = self._one_dist(value)
        return DenseVector(dist / max(dist.sum(), 1e-30))


# Spark's defaults of the estimator's params (the model gets them too, so a
# model built from attributes alone predicts with threshold 0.5)
_SPARK_DEFAULTS = dict(
    maxIter=100, regParam=0.0, elasticNetParam=0.0, tol=1e-6, fitIntercept=True,
    standardization=True, family="auto", threshold=0.5,
)


class _LogisticRegressionParams(
    HasEnableSparseDataOptim,
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasMaxIter,
    HasTol,
    HasRegParam,
    HasElasticNetParam,
    HasFitIntercept,
    HasStandardization,
    HasWeightCol,
):
    family = Param("family", "label distribution: 'auto', 'binomial' or 'multinomial'", TypeConverters.toString)
    threshold = Param("threshold", "binary prediction threshold in [0, 1]", TypeConverters.toFloat)
    thresholds = Param(
        "thresholds",
        "multiclass thresholds: predict argmax(p/threshold)",
        TypeConverters.toListFloat,
    )

    def getFamily(self) -> str:
        return self.getOrDefault("family")

    def getThreshold(self) -> float:
        return self.getOrDefault("threshold")

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "maxIter": "max_iter",
            "regParam": "alpha",
            "elasticNetParam": "l1_ratio",
            "tol": "tol",
            "fitIntercept": "fit_intercept",
            "standardization": "standardization",
            "family": "",  # resolved from the label cardinality at fit time
            "threshold": "",
            "thresholds": "",
            "weightCol": "",
        }

    def _get_solver_params_default(self) -> Dict[str, Any]:
        return {
            "alpha": 0.0,
            "l1_ratio": 0.0,
            "max_iter": 100,
            "tol": 1e-6,
            "fit_intercept": True,
            "standardization": True,
            "lbfgs_memory": 10,
            "verbose": False,
            # per-estimator override of config["solver_precision"]; "bf16"
            # runs the X·β / Xᵀr products bf16-in / float32-accumulate; the
            # L-BFGS state, line search and convergence scalars stay at the
            # inputs' precision
            "solver_precision": None,
        }

    def _set_params(self, **kwargs):
        if "family" in kwargs and kwargs["family"] not in ("auto", "binomial", "multinomial"):
            raise ValueError(
                f"family must be 'auto', 'binomial' or 'multinomial', got {kwargs['family']!r}"
            )
        return super()._set_params(**kwargs)


class LogisticRegression(_LogisticRegressionParams, _TpuEstimatorSupervised):
    """LogisticRegression estimator, drop-in for
    ``pyspark.ml.classification.LogisticRegression``.

    The standardization statistics are computed on the device and folded
    into the coefficients (no standardized copy of the rows); the GLM
    quasi-Newton or OWL-QN solver then passes over the rows twice per
    iteration (ops/logistic.py)."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(**_SPARK_DEFAULTS)
        self._set_params(**kwargs)

    # full-batch gradients accumulate over row chunks: an over-budget
    # dataset demotes to ops/streaming.logistic_fit_streaming (the L2 path;
    # OWL-QN has no streaming form and a demoted L1 fit raises)
    _supports_streaming_fit = True
    # its row statistics summed across ranks (a multi-process fit)
    _supports_multiprocess = True
    # CSR input fits on the padded-ELL layout (ops/logistic.logistic_fit_ell)
    _supports_sparse_input = True

    def _extraction_workspace_terms(self, terms, rows_dev, extracted, params, itemsize):
        """The port's own terms of a CSR fit (memory.workspace_estimate):
        the column grouping of the ELL cells (`sparse.EllColumns`) and the
        ELL products' temporaries in place of the dense `fast` copy of X,
        and under `fast` the bf16-rounded copy of the ELL values."""
        from ..core import resolve_solver_precision
        from ..memory import _is_sparse, ell_columns_bytes, ell_terms
        from ..ops.sparse import MATVEC_TILE_CELLS, SEGMENT_CHUNK

        if not _is_sparse(extracted):
            return terms
        k_max, nnz = ell_terms(extracted, rows_dev)
        terms = {k: v for k, v in terms.items() if k != "bf16_X"}
        d = int(extracted.n_cols)
        terms["ell_columns"] = ell_columns_bytes(nnz, d, rows_dev, SEGMENT_CHUNK)
        # one product's temporaries: a row tile's gathered operands and
        # their products, and a column sum's cell products and first level
        terms["ell_products"] = (2 * min(rows_dev * k_max, MATVEC_TILE_CELLS) + 2 * nnz + d * SEGMENT_CHUNK) * itemsize
        if resolve_solver_precision(params) == "bf16":
            terms["ell_fast_values"] = rows_dev * k_max * itemsize
        return terms

    def _solver_workspace_terms(
        self, rows_per_device: int, n_cols: int, params: Dict[str, Any], itemsize: int
    ) -> Dict[str, int]:
        # the JAX package's terms: the per-row logits held twice (at the
        # iterate and along the direction) and the L-BFGS (S, Y) history;
        # the class count is unknown before the labels are read, so k_out is
        # 1 unless the family is multinomial (then its floor, 2). The port's
        # own: `fast` rounds X to bf16 on the card, once per resident fit
        # (ops/logistic._dense_ops) or once per chunk when streamed
        from ..core import resolve_solver_precision

        k_out = 2 if self.getOrDefault("family") == "multinomial" else 1
        n_flat = n_cols * k_out + k_out
        mem = int(params.get("lbfgs_memory", 10))
        terms = {
            "glm_logits": 2 * rows_per_device * k_out * itemsize,
            "lbfgs_history": 2 * mem * n_flat * itemsize,
        }
        if resolve_solver_precision(params) == "bf16":
            terms["bf16_X"] = 2 * rows_per_device * n_cols
        return terms

    def _fit_streaming(
        self, inputs: FitInputs, params: Dict[str, Any], classes, labels_host, alpha: float, l1_ratio: float
    ) -> Dict[str, Any]:
        """The out-of-core fit: the streamed GLM quasi-Newton. L1/elastic
        net has no streaming form (OWL-QN's pseudo-gradient projection does
        not accumulate over chunks), so a demoted L1 fit raises typed."""
        from ..errors import HbmBudgetError
        from ..ops.logistic import fetch_state
        from ..ops.streaming import logistic_fit_streaming

        if alpha * l1_ratio > 0:
            raise HbmBudgetError(
                "logistic L1/elastic-net fit does not fit device memory and "
                "the OWL-QN solver has no out-of-core streaming path "
                "(set elasticNetParam=0 or raise the budget)",
                largest_term="solver.owlqn",
            )
        multinomial, y_idx_host = self._fit_geometry_host(classes, labels_host)
        statics = self._solver_statics(params)
        common = dict(k=len(classes), multinomial=multinomial, lam_l2=alpha, lam_l1=0.0, use_l1=False, **statics)
        state = logistic_fit_streaming(
            inputs, y_idx_host,
            k=len(classes), multinomial=multinomial, lam_l2=alpha,
            fit_intercept=statics["fit_intercept"], standardize=statics["standardize"],
            max_iter=statics["max_iter"], tol=statics["tol"],
            lbfgs_memory=statics["lbfgs_memory"], fast=statics["fast"],
            # the param-naming key of the resident fit's form, so the
            # sequential param sets of one demoted stage never resume each
            # other's trajectories
            ckpt_key="logistic_stream:" + repr(sorted(common.items())),
        )
        return self._finalize_state(fetch_state(state), classes, inputs, common)

    def setMaxIter(self, value: int) -> "LogisticRegression":
        return self._set_params(maxIter=value)

    def setRegParam(self, value: float) -> "LogisticRegression":
        return self._set_params(regParam=value)

    def setElasticNetParam(self, value: float) -> "LogisticRegression":
        return self._set_params(elasticNetParam=value)

    def setTol(self, value: float) -> "LogisticRegression":
        return self._set_params(tol=value)

    def setFitIntercept(self, value: bool) -> "LogisticRegression":
        return self._set_params(fitIntercept=value)

    def setStandardization(self, value: bool) -> "LogisticRegression":
        return self._set_params(standardization=value)

    def setFamily(self, value: str) -> "LogisticRegression":
        return self._set_params(family=value)

    def setThreshold(self, value: float) -> "LogisticRegression":
        return self._set_params(threshold=value)

    def setThresholds(self, value: List[float]) -> "LogisticRegression":
        return self._set_params(thresholds=value)

    def setFeaturesCol(self, value) -> "LogisticRegression":
        return self._set_params(featuresCol=value) if isinstance(value, str) else self._set_params(featuresCols=value)

    def setLabelCol(self, value: str) -> "LogisticRegression":
        return self._set_params(labelCol=value)

    def setPredictionCol(self, value: str) -> "LogisticRegression":
        return self._set_params(predictionCol=value)

    def setProbabilityCol(self, value: str) -> "LogisticRegression":
        return self._set_params(probabilityCol=value)

    def setRawPredictionCol(self, value: str) -> "LogisticRegression":
        return self._set_params(rawPredictionCol=value)

    def setWeightCol(self, value: str) -> "LogisticRegression":
        return self._set_params(weightCol=value)

    @staticmethod
    def _resolve_classes(labels_host: np.ndarray, inputs: FitInputs) -> np.ndarray:
        """Sorted class values of this fit's labels. A fold's row mask is
        honored: a weight-masked CV fold finds its classes among its train
        rows only, as the physical split would. In a multi-process fit the
        ranks' class sets are merged (one rendezvous round), so a rank that
        holds one class still fits every class."""
        import json

        lbl = labels_host if inputs.host_mask is None else labels_host[inputs.host_mask]
        local = np.unique(lbl).astype(np.float64)
        if not inputs.spmd:
            return local
        gathered = inputs.allgather_host(json.dumps(local.tolist()))
        return np.unique(np.concatenate([np.asarray(json.loads(g), dtype=np.float64) for g in gathered]))

    @staticmethod
    def _degenerate_single_class(classes: np.ndarray, inputs: FitInputs) -> Dict[str, Any]:
        # a single class: P(class) = 1 (Spark parity)
        return {
            "coef_": np.zeros((1, inputs.n_cols)),
            "intercept_": np.array([np.inf if classes[0] == 1.0 else -np.inf]),
            "classes_": classes,
            "n_iter_": 0,
            "objective_": 0.0,
            "n_cols": inputs.n_cols,
            "dtype": np.dtype(inputs.dtype).name,
        }

    def _fit_geometry_host(self, classes: np.ndarray, labels_host: np.ndarray):
        """(multinomial, y_idx host array): the label geometry of the fit."""
        family = self.getOrDefault("family")
        k = len(classes)
        multinomial = family == "multinomial" or (family == "auto" and k > 2)
        if family == "binomial" and k > 2:
            raise ValueError(f"family='binomial' but found {k} classes")
        # exact for every label in `classes` (sorted unique); the clip keeps
        # any other index in [0, k) for the gather
        y_idx_host = np.clip(np.searchsorted(classes, labels_host), 0, k - 1).astype(np.int64)
        return multinomial, y_idx_host

    @staticmethod
    def _finalize_state(state: Dict[str, Any], classes, inputs: FitInputs, common) -> Dict[str, Any]:
        """Host-fetched solver state -> model attribute dict, running the
        divergence guard, the stall warning and the telemetry record."""
        from .. import telemetry
        from ..ops.logistic import check_glm_result, warn_if_early_stall

        check_glm_result(state)
        warn_if_early_stall(state, standardize=common["standardize"], max_iter=common["max_iter"])
        telemetry.record_solver_result(
            "logistic",
            n_iter=int(state["n_iter_"]),
            objective=float(state["objective_"]),
            stalled=bool(state.get("stalled_", False)),
        )
        return {
            "coef_": np.asarray(state["coef_"], dtype=np.float64),
            "intercept_": np.asarray(state["intercept_"], dtype=np.float64),
            "classes_": classes,
            "n_iter_": int(state["n_iter_"]),
            "objective_": float(state["objective_"]),
            "n_cols": inputs.n_cols,
            "dtype": np.dtype(inputs.dtype).name,
        }

    @staticmethod
    def _solver_statics(params: Dict[str, Any]) -> Dict[str, Any]:
        from ..core import resolve_solver_precision

        return dict(
            fit_intercept=bool(params["fit_intercept"]),
            standardize=bool(params["standardization"]),
            max_iter=int(params["max_iter"]),
            tol=float(params["tol"]),
            lbfgs_memory=int(params["lbfgs_memory"]),
            fast=resolve_solver_precision(params) == "bf16",
        )

    def _resolve_warm_start(self, source: Any) -> Dict[str, Any]:
        """Warm-start payload for `fit(..., warm_start_from=...)`: a fitted
        `LogisticRegressionModel`'s original-space (coef_, intercept_), or a
        `SolverCheckpoint` (of either package, known by its class name)
        carrying one. GLM loop checkpoints hold the STANDARDIZED flat
        iterate, which is the dataset's own and not portable across fits:
        those are refused with a pointer at the model route, as in the JAX
        package."""
        if type(source).__name__ == "SolverCheckpoint":
            st = dict(source.portable or {})
            st.update({k: v for k, v in (source.state or {}).items() if k not in st})
            if "coef_" not in st:
                raise ValueError(
                    "SolverCheckpoint warm start for LogisticRegression needs "
                    "an original-space 'coef_' payload; GLM segment "
                    "checkpoints carry the standardized iterate (dataset-"
                    "specific) — warm-start from the fitted model instead"
                )
            coef = np.asarray(st["coef_"])
            return {
                "coef_": coef,
                "intercept_": np.asarray(st.get("intercept_", np.zeros(coef.shape[0], coef.dtype))),
                "n_iter_": int(st.get("n_iter_", source.iteration) or 0),
            }
        coef = getattr(source, "coef_", None)
        if coef is None:
            raise TypeError(
                f"cannot warm-start LogisticRegression from "
                f"{type(source).__name__}: expected a fitted LogisticRegressionModel "
                "or a SolverCheckpoint"
            )
        coef = np.asarray(coef)
        return {
            "coef_": coef,
            "intercept_": np.asarray(getattr(source, "intercept_", np.zeros(coef.shape[0], coef.dtype))),
            "n_iter_": int(np.max(getattr(source, "n_iter_", 0)) or 0),
        }

    def _warm_tuple(self, k_out: int, inputs: FitInputs):
        """The warm-start seed (coef, intercept) at the inputs' dtype, or
        None; a donor of another shape raises."""
        warm = self._warm_start
        if warm is None:
            return None
        wcoef = np.asarray(warm["coef_"])
        if tuple(wcoef.shape) != (k_out, int(inputs.n_cols)):
            raise ValueError(
                f"warm-start coef shape {tuple(wcoef.shape)} does not "
                f"match this fit (k_out={k_out}, d={inputs.n_cols})"
            )
        from .. import telemetry

        if telemetry.enabled():
            reg = telemetry.registry()
            reg.inc("fit.warm_starts")
            reg.inc("fit.warm_start_iterations_saved", int(warm.get("n_iter_", 0) or 0))
        return wcoef.astype(inputs.dtype), np.asarray(warm["intercept_"]).astype(inputs.dtype)

    def _get_tpu_fit_func(self, extracted: ExtractedData):
        from .. import checkpoint as _ckpt
        from ..ops.logistic import fetch_state, logistic_fit, logistic_fit_ell
        from ..parallel import host_tensor

        labels_host = extracted.label

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            alpha = float(params["alpha"])
            l1_ratio = float(params["l1_ratio"])
            classes = self._resolve_classes(labels_host, inputs)
            if len(classes) == 1:
                return self._degenerate_single_class(classes, inputs)
            if inputs.stream is not None:
                return self._fit_streaming(inputs, params, classes, labels_host, alpha, l1_ratio)
            multinomial, y_idx_host = self._fit_geometry_host(classes, labels_host)
            common = dict(
                k=len(classes),
                multinomial=multinomial,
                lam_l2=alpha * (1.0 - l1_ratio),
                lam_l1=alpha * l1_ratio,
                use_l1=alpha * l1_ratio > 0,
                **self._solver_statics(params),
            )
            warm = self._warm_tuple(len(classes) if multinomial else 1, inputs)
            y_idx = host_tensor(y_idx_host).to(inputs.device)
            # recovery: with a checkpoint cadence and a store installed by
            # the enclosing fit stage, the loop checkpoints under this key,
            # so a retried fit resumes from its last boundary
            ckpt_common = dict(ckpt_key="logistic:" + repr(sorted(common.items())),
                               placement_key=_ckpt.placement_key_of(inputs))
            if inputs.X_sparse is not None:
                values, indices = inputs.ell_rows()
                state = logistic_fit_ell(
                    values, indices, y_idx, inputs.w, d=inputs.n_cols, warm_start=warm,
                    columns=inputs.ell_columns(), **common, **ckpt_common,
                )
            else:
                state = logistic_fit(inputs.X, y_idx, inputs.w, warm_start=warm, **common, **ckpt_common)
            return self._finalize_state(fetch_state(state), classes, inputs, common)

        return _fit

    def _batch_group_key(self, sp: Dict[str, Any]):
        # regParam (alpha) and elasticNetParam (l1_ratio) vary inside a
        # batched grid; the solver choice use_l1 derived from them splits a
        # grid mixing L1-on and L1-off points into one group per solver;
        # everything else in the param set must be equal
        use_l1 = float(sp["alpha"]) * float(sp["l1_ratio"]) > 0
        rest = tuple(sorted((k, repr(v)) for k, v in sp.items() if k not in ("alpha", "l1_ratio")))
        return (use_l1, rest)

    def _get_tpu_batched_fit_func(self, extracted: ExtractedData):
        from ..ops.logistic import fetch_states, logistic_fit_batched, logistic_fit_ell_batched
        from ..parallel import host_tensor

        labels_host = extracted.label

        def _fit_batch(inputs: FitInputs, param_sets) -> List[Dict[str, Any]]:
            classes = self._resolve_classes(labels_host, inputs)
            if len(classes) == 1:
                return [self._degenerate_single_class(classes, inputs) for _ in param_sets]
            multinomial, y_idx_host = self._fit_geometry_host(classes, labels_host)
            alphas = [float(sp["alpha"]) for sp in param_sets]
            l1rs = [float(sp["l1_ratio"]) for sp in param_sets]
            common = dict(
                k=len(classes),
                multinomial=multinomial,
                use_l1=alphas[0] * l1rs[0] > 0,  # uniform per group key
                **self._solver_statics(param_sets[0]),
            )
            y_idx = host_tensor(y_idx_host).to(inputs.device)
            lam_l2s = [a * (1.0 - r) for a, r in zip(alphas, l1rs)]
            lam_l1s = [a * r for a, r in zip(alphas, l1rs)]
            if inputs.X_sparse is not None:
                values, indices = inputs.ell_rows()
                states = logistic_fit_ell_batched(
                    values, indices, y_idx, inputs.w, lam_l2s, lam_l1s, d=inputs.n_cols,
                    columns=inputs.ell_columns(), **common,
                )
            else:
                states = logistic_fit_batched(inputs.X, y_idx, inputs.w, lam_l2s, lam_l1s, **common)
            return [self._finalize_state(st, classes, inputs, common) for st in fetch_states(states)]

        return _fit_batch

    def _supportsTransformEvaluate(self, evaluator: Any) -> bool:
        if not hasattr(evaluator, "getMetricName"):
            return False
        from ..metrics import MulticlassMetrics

        if evaluator.getMetricName() not in MulticlassMetrics.SUPPORTED_MULTI_CLASS_METRIC_NAMES:
            return False
        return not (evaluator.hasParam("weightCol") and evaluator.isDefined("weightCol"))

    def _create_model(self, attrs: Dict[str, Any]) -> "LogisticRegressionModel":
        return LogisticRegressionModel(**attrs)


class LogisticRegressionModel(_LogisticRegressionParams, _TpuModelWithColumns):
    """Fitted logistic regression model."""

    def __init__(
        self,
        coef_: Optional[np.ndarray] = None,
        intercept_: Optional[np.ndarray] = None,
        classes_: Optional[np.ndarray] = None,
        n_iter_: int = 0,
        objective_: float = 0.0,
        n_cols: int = 0,
        dtype: str = "float32",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            coef_=coef_, intercept_=intercept_, classes_=classes_, n_iter_=n_iter_,
            objective_=objective_, n_cols=n_cols, dtype=dtype,
        )
        self._setDefault(**_SPARK_DEFAULTS)
        self.coef_ = np.atleast_2d(np.asarray(coef_))
        self.intercept_ = np.atleast_1d(np.asarray(intercept_))
        self.classes_ = np.asarray(classes_)
        self.n_iter_ = int(n_iter_)
        self.objective_ = float(objective_)
        self.n_cols = int(n_cols)
        self.dtype = dtype

    # -- Spark ML model surface -------------------------------------------
    @property
    def numClasses(self) -> int:
        return len(self.classes_)

    @property
    def numFeatures(self) -> int:
        return self.n_cols

    @property
    def _is_multinomial(self) -> bool:
        return self.coef_.shape[0] > 1

    @property
    def coefficients(self) -> DenseVector:
        if self._is_multinomial:
            raise Exception(
                "Multinomial models contain a matrix of coefficients, use coefficientMatrix instead."
            )
        return DenseVector(self.coef_[0])

    @property
    def intercept(self) -> float:
        if self._is_multinomial:
            raise Exception(
                "Multinomial models contain a vector of intercepts, use interceptVector instead."
            )
        return float(self.intercept_[0])

    @property
    def coefficientMatrix(self) -> np.ndarray:
        return self.coef_

    @property
    def interceptVector(self) -> DenseVector:
        return DenseVector(self.intercept_)

    def setFeaturesCol(self, value) -> "LogisticRegressionModel":
        return self._set_params(featuresCol=value) if isinstance(value, str) else self._set_params(featuresCols=value)

    def setThreshold(self, value: float) -> "LogisticRegressionModel":
        return self._set_params(threshold=value)

    def setThresholds(self, value: List[float]) -> "LogisticRegressionModel":
        return self._set_params(thresholds=value)

    def setProbabilityCol(self, value: str) -> "LogisticRegressionModel":
        return self._set_params(probabilityCol=value)

    def setRawPredictionCol(self, value: str) -> "LogisticRegressionModel":
        return self._set_params(rawPredictionCol=value)

    def setPredictionCol(self, value: str) -> "LogisticRegressionModel":
        return self._set_params(predictionCol=value)

    # -- prediction machinery ---------------------------------------------
    def _out_column_names(self) -> List[str]:
        return [
            self.getOrDefault("rawPredictionCol"),
            self.getOrDefault("probabilityCol"),
            self.getOrDefault("predictionCol"),
        ]

    def _get_transform_func(self):
        from ..ops.logistic import logistic_predict
        from ..parallel import default_device, host_tensor

        coef, intercept = self.coef_, self.intercept_
        multinomial = self._is_multinomial
        dtype = np.float32 if self._float32_inputs else np.float64

        def construct():
            dev = default_device()
            return (
                host_tensor(coef.astype(dtype)).to(dev),
                host_tensor(intercept.astype(dtype)).to(dev),
            )

        def predict(state, xb):
            c, b = state
            return logistic_predict(xb, c, b, multinomial=multinomial)

        return construct, predict

    def _serve_workspace_terms(self, bucket_rows_count, itemsize):
        # the raw-margin and probability blocks, [bucket, k] each (the
        # reference's term), and the port's own: one [rows, k_out, d] product
        # block of the fixed-order margins (linalg.rows_dot_fixed) and its
        # first halving
        from ..ops.linalg import rows_dot_block_rows

        k_out = int(self.coef_.shape[0])
        d = int(self.n_cols)
        rows = min(int(bucket_rows_count), rows_dot_block_rows(k_out, d))
        return {
            "logits": 2 * int(bucket_rows_count) * max(2, k_out) * itemsize,
            "dot_block": rows * k_out * d * itemsize * 3 // 2,
        }

    def _serve_flop_estimate(self, n_rows, n_cols):
        # the X @ coef.T margins (2·n·d·k); the link epilogue is omitted
        return 2.0 * n_rows * n_cols * max(1, int(self.coef_.shape[0]))

    def _raw_prob(self, features) -> tuple:
        """Batched (raw, prob) float64 arrays for a host feature block, or
        for rows already on the device (`_transform_resident`); the
        single-class model tiles its ±inf intercept without the device."""
        import torch

        if np.isinf(self.intercept_).any():
            n = features.shape[0]
            return np.tile(self.intercept_, (n, 1)), np.ones((n, 1))
        if isinstance(features, torch.Tensor):
            raw, prob = self._transform_resident(features)
        else:
            raw, prob = self._transform_arrays(features)
        return raw.astype(np.float64), prob.astype(np.float64)

    def _predict_from_prob(self, prob: np.ndarray) -> np.ndarray:
        if self.numClasses == 1:
            return np.full(prob.shape[0], float(self.classes_[0]))
        if self.isDefined("thresholds"):
            t = np.asarray(self.getOrDefault("thresholds"))
            idx = np.argmax(prob / t[None, :], axis=1)
        elif not self._is_multinomial and self.numClasses == 2:
            idx = (prob[:, 1] > self.getThreshold()).astype(int)
        else:
            idx = np.argmax(prob, axis=1)
        return self.classes_[idx].astype(np.float64)

    def transform(self, dataset: Any):
        pdf = as_pandas(dataset)
        extracted = self._pre_process_data(dataset, for_fit=False)
        raw, prob = self._raw_prob(extracted.features)
        out = pdf.copy(deep=False)
        as_vec = extracted.feature_kind == "vector"
        raw_name, prob_name, pred_name = self._out_column_names()
        out[raw_name] = [DenseVector(r) for r in raw] if as_vec else list(raw)
        out[prob_name] = [DenseVector(p) for p in prob] if as_vec else list(prob)
        out[pred_name] = self._predict_from_prob(prob)
        return out

    def _one_row(self, value) -> tuple:
        from ..linalg import Vector

        v = value.toArray() if isinstance(value, Vector) else np.asarray(value)
        return self._raw_prob(v[None, :])

    def predict(self, value) -> float:
        """Single-vector predict (Spark ML model surface)."""
        _, prob = self._one_row(value)
        return float(self._predict_from_prob(prob)[0])

    def predictProbability(self, value) -> DenseVector:
        return DenseVector(self._one_row(value)[1][0])

    def predictRaw(self, value) -> DenseVector:
        """Raw margin scores per class."""
        return DenseVector(self._one_row(value)[0][0])

    @property
    def summary(self):
        """No training summary is retained (reference parity)."""
        raise RuntimeError(f"No training summary available for this {type(self).__name__}")

    def evaluate(self, dataset):
        raise NotImplementedError(
            "LogisticRegressionModel.evaluate (through the converted Spark ML "
            "model) is not in the PyTorch port yet (ROADMAP item A16)"
        )

    def cpu(self):
        raise NotImplementedError(
            "LogisticRegressionModel.cpu() (conversion to a Spark ML model) is "
            "not in the PyTorch port yet (ROADMAP item A16)"
        )

    # -- fused CV path ----------------------------------------------------
    def _combine(self, models: List["LogisticRegressionModel"]) -> "LogisticRegressionModel":
        combined = LogisticRegressionModel(
            coef_=self.coef_, intercept_=self.intercept_, classes_=self.classes_,
            n_iter_=self.n_iter_, objective_=self.objective_, n_cols=self.n_cols, dtype=self.dtype,
        )
        combined._sub_models = list(models)
        self._copyValues(combined)
        self._copy_solver_params(combined)
        return combined

    def _transform_evaluate(self, dataset: Any, evaluator: Any) -> List[float]:
        """Score every packed model over a dataset: the feature block
        extracted once, then one pass over it per model
        (`_transform_evaluate_arrays`)."""
        from ..core import evaluator_label_column

        pdf = as_pandas(dataset)
        label = pdf[evaluator_label_column(self, evaluator)].to_numpy(dtype=np.float64)
        extracted = self._pre_process_data(dataset, for_fit=False)
        return self._transform_evaluate_arrays(extracted.features, label, evaluator)

    def _transform_evaluate_arrays(self, features: Any, label: np.ndarray, evaluator: Any) -> List[float]:
        """Score every packed model over an extracted block (host, or rows
        already on the device), one pass over the block per model, as the
        JAX package does: each model's predictions (its transform's own
        fixed-order row products), their confusion counts, and for logLoss
        the clipped log-probability of the true class."""
        from ..metrics import MulticlassMetrics

        assert hasattr(self, "_sub_models"), "call _combine first"
        features = as_dense(features)  # a CSR block once, not once per model
        want_logloss = evaluator.getMetricName() == "logLoss"
        eps = evaluator.getOrDefault("eps") if evaluator.hasParam("eps") else 1e-15
        scores = []
        for m in self._sub_models:
            _, prob = m._raw_prob(features)
            prediction = m._predict_from_prob(prob)
            pairs = np.stack([label, prediction], axis=1)
            uniq, inverse = np.unique(pairs, axis=0, return_inverse=True)
            counts = np.bincount(inverse.reshape(-1), minlength=len(uniq)).astype(np.float64)
            confusion = {
                (float(uniq[i, 0]), float(uniq[i, 1])): float(counts[i]) for i in range(len(uniq))
            }
            log_loss = None
            if want_logloss:
                # exact class membership: a label this fold's model never saw
                # gets probability eps (the model gives it ~0 mass)
                cls_idx = np.clip(np.searchsorted(m.classes_, label), 0, len(m.classes_) - 1)
                known = m.classes_[cls_idx] == label
                p_raw = prob[np.arange(len(label)), cls_idx]
                p_true = np.clip(np.where(known, p_raw, 0.0), eps, 1 - eps)
                log_loss = float(np.sum(-np.log(p_true)))
            scores.append(MulticlassMetrics.from_confusion(confusion, log_loss).evaluate(evaluator))
        return scores
