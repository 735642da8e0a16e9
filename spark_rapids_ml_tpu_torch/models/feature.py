#
# PCA estimator and model, drop-in for `pyspark.ml.feature.PCA`: the PyTorch
# counterpart of spark_rapids_ml_tpu/models/feature.py (PCA, PCAModel, with
# PCAModel's serving hooks), on one device. An over-budget fit streams its
# rows from the host (ops/streaming.pca_fit_streaming). With solver
# checkpoints active (checkpoint.py) a fit retains its statistics in the
# fit stage's store (`pca_fit_checkpointed`), so a retry re-runs only the
# eigendecomposition. It fits across processes too (a TpuContext with
# nranks > 1): the weighted moments and the centered gram are summed across
# ranks (ops/linalg.weighted_cov) and every rank solves the same
# eigensystem. `.cpu()` (Spark interop) is A16.
#
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core import FitInputs, _TpuEstimator, _TpuModelWithColumns
from ..data import ExtractedData
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasInputCol,
    HasInputCols,
    HasOutputCol,
    Param,
    TypeConverters,
)


class _PCAParams(HasInputCol, HasInputCols, HasFeaturesCol, HasFeaturesCols, HasOutputCol):
    k = Param("k", "the number of principal components", TypeConverters.toInt)

    def getK(self) -> int:
        return self.getOrDefault("k")

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        # Spark `k` -> cuML `n_components`
        return {"k": "n_components"}

    def _get_solver_params_default(self) -> Dict[str, Any]:
        return {
            "n_components": 1,
            "svd_solver": "auto",
            "whiten": False,
            "verbose": False,
            # per-estimator override of config["solver_precision"]; "bf16"
            # runs the covariance contraction bf16-in / float32-accumulate;
            # the eigendecomposition and reported variances stay full
            # precision
            "solver_precision": None,
        }


class PCA(_PCAParams, _TpuEstimator):
    """PCA estimator, drop-in for ``pyspark.ml.feature.PCA``.

    >>> PCA(k=2, inputCol="features").fit(df).transform(df)

    Fit: one pass for the weighted mean and d×d covariance on the device,
    then the top-k symmetric eigendecomposition with sign canonicalization
    (ops/pca.py)."""

    # the (mean, covariance) statistics accumulate over row chunks: an
    # over-budget dataset demotes to ops/streaming.pca_fit_streaming
    _supports_streaming_fit = True
    # its row statistics summed across ranks (a multi-process fit)
    _supports_multiprocess = True

    def _solver_workspace_terms(
        self, rows_per_device: int, n_cols: int, params: Dict[str, Any], itemsize: int
    ) -> Dict[str, int]:
        # the JAX package's terms: the d x d covariance and the eigenvector
        # output of its size, and the mean and variance d-vectors
        return {
            "covariance": 2 * n_cols * n_cols * itemsize,
            "vectors": 2 * n_cols * itemsize,
        }

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(k=1)
        self._set_params(**kwargs)

    def setK(self, value: int) -> "PCA":
        return self._set_params(k=value)

    def setInputCol(self, value: str) -> "PCA":
        return self._set_params(inputCol=value) if isinstance(value, str) else self._set_params(inputCols=value)

    def setInputCols(self, value: List[str]) -> "PCA":
        return self._set_params(inputCols=value)

    def setOutputCol(self, value: str) -> "PCA":
        return self._set_params(outputCol=value)

    def _get_tpu_fit_func(self, extracted: ExtractedData):
        from .. import checkpoint as _ckpt
        from ..core import resolve_solver_precision
        from ..ops.pca import check_pca_state, pca_fit, pca_fit_checkpointed, record_pca_fit
        from ..ops.streaming import pca_fit_streaming

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            k = int(params["n_components"])
            fast = resolve_solver_precision(params) == "bf16"
            if k < 1:
                raise ValueError(f"k must be >= 1, got {k}")
            if k > inputs.n_cols:
                raise ValueError(f"k={k} exceeds the number of features {inputs.n_cols}")
            if inputs.stream is not None:
                # out-of-core: two streamed passes (the mean, then the
                # centered covariance), the resident fit's finish
                state = pca_fit_streaming(inputs, k=k, fast=fast)
            elif _ckpt.solver_checkpoints_active():
                # recovery: the (mean, covariance) statistics retained, so a
                # transient retry (or a k sweep of the stage) skips the pass
                state = pca_fit_checkpointed(
                    inputs.X, inputs.w, k=k, fast=fast, placement_key=_ckpt.placement_key_of(inputs),
                )
            else:
                state = pca_fit(inputs.X, inputs.w, k=k, fast=fast)
            out: Dict[str, Any] = {name: v.cpu().numpy() for name, v in state.items()}
            check_pca_state(out, k=k)  # guard on the host-fetched attributes
            record_pca_fit(out, k=k)
            out["n_cols"] = inputs.n_cols
            out["dtype"] = np.dtype(inputs.dtype).name
            return out

        return _fit

    def _create_model(self, attrs: Dict[str, Any]) -> "PCAModel":
        return PCAModel(**attrs)


class PCAModel(_PCAParams, _TpuModelWithColumns):
    """Fitted PCA model: the Spark ML surface (``pc``,
    ``explainedVariance``, ``mean``) and the solver-native attributes
    (``components_`` etc.)."""

    def __init__(
        self,
        mean_: Optional[np.ndarray] = None,
        components_: Optional[np.ndarray] = None,
        explained_variance_: Optional[np.ndarray] = None,
        explained_variance_ratio_: Optional[np.ndarray] = None,
        singular_values_: Optional[np.ndarray] = None,
        n_cols: int = 0,
        dtype: str = "float32",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            mean_=mean_,
            components_=components_,
            explained_variance_=explained_variance_,
            explained_variance_ratio_=explained_variance_ratio_,
            singular_values_=singular_values_,
            n_cols=n_cols,
            dtype=dtype,
        )
        self.mean_ = np.asarray(mean_)
        self.components_ = np.asarray(components_)
        self.explained_variance_ = np.asarray(explained_variance_)
        self.explained_variance_ratio_ = np.asarray(explained_variance_ratio_)
        self.singular_values_ = np.asarray(singular_values_)
        self.n_cols = int(n_cols)
        self.dtype = dtype
        self._setDefault(k=int(self.components_.shape[0]) if components_ is not None else 1)

    # -- Spark ML model surface -------------------------------------------
    @property
    def mean(self) -> List[float]:
        return self.mean_.tolist()

    @property
    def pc(self) -> np.ndarray:
        """Principal components as a d×k column matrix (Spark's DenseMatrix layout)."""
        return self.components_.T

    @property
    def explainedVariance(self) -> np.ndarray:
        """Variance ratio per component (Spark parity: ratio, not raw variance)."""
        return self.explained_variance_ratio_

    def cpu(self):
        raise NotImplementedError(
            "PCAModel.cpu() (conversion to a Spark ML model) is not in the "
            "PyTorch port yet (ROADMAP item A16)"
        )

    def setInputCol(self, value: str) -> "PCAModel":
        return self._set_params(inputCol=value) if isinstance(value, str) else self._set_params(inputCols=value)

    def setOutputCol(self, value: str) -> "PCAModel":
        return self._set_params(outputCol=value)

    def _out_column_names(self) -> List[str]:
        if self.hasParam("outputCol") and self.isDefined("outputCol"):
            return [self.getOrDefault("outputCol")]
        return [f"{self.uid}__output"]

    def _get_transform_func(self):
        from ..ops.pca import pca_transform
        from ..parallel import default_device, host_tensor

        components = self.components_
        explained_variance = self.explained_variance_
        whiten = bool(self._solver_params.get("whiten", False))
        dtype = np.float32 if self._float32_inputs else np.float64

        def construct():
            dev = default_device()
            return (
                host_tensor(components.astype(dtype)).to(dev),
                host_tensor(explained_variance.astype(dtype)).to(dev),
            )

        def predict(state, xb):
            comps, ev = state
            return pca_transform(xb, comps, ev, whiten=whiten)

        return construct, predict

    # serving hooks -------------------------------------------------------

    def _serve_workspace_terms(self, bucket_rows_count, itemsize):
        # the [bucket, k] projection block (the reference's term), and the
        # port's own: one [rows, k, d] product block of the fixed-order
        # projection (linalg.rows_dot_fixed) and its first halving
        from ..ops.linalg import rows_dot_block_rows

        k = int(self.components_.shape[0])
        d = int(self.n_cols)
        rows = min(int(bucket_rows_count), rows_dot_block_rows(k, d))
        return {"proj": int(bucket_rows_count) * k * itemsize, "dot_block": rows * k * d * itemsize * 3 // 2}

    def _serve_flop_estimate(self, n_rows, n_cols):
        # the X @ components.T projection
        k = max(1, int(self.components_.shape[0]))
        return 2.0 * n_rows * n_cols * k
