#
# Carrying fitted state across from the JAX package: its model attributes,
# as numpy arrays and scalars, become this package's models. (A directory
# the JAX package saved also loads directly with `KMeansModel.load`,
# `PCAModel.load`, `LinearRegressionModel.load`,
# `LogisticRegressionModel.load`, `RandomForestClassificationModel.load` or
# `RandomForestRegressionModel.load`: both packages write the same layout.)
# An ANN model of the JAX package, which cannot be saved, carries its index
# across in memory (`approximate_nearest_neighbors_model_from_jax`).
#
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from .models.classification import LogisticRegressionModel, RandomForestClassificationModel
from .models.clustering import DBSCANModel, KMeansModel
from .models.feature import PCAModel
from .models.knn import ApproximateNearestNeighborsModel
from .models.regression import LinearRegressionModel, RandomForestRegressionModel
from .models.umap import UMAPModel

__all__ = [
    "kmeans_model_from_jax", "pca_model_from_jax", "linear_regression_model_from_jax",
    "logistic_regression_model_from_jax", "random_forest_classification_model_from_jax",
    "random_forest_regression_model_from_jax", "approximate_nearest_neighbors_model_from_jax",
    "dbscan_model_from_jax", "umap_model_from_jax",
]

_KMEANS_KEYS = ("cluster_centers_", "inertia_", "n_iter_", "n_cols", "dtype")
_PCA_KEYS = (
    "mean_", "components_", "explained_variance_", "explained_variance_ratio_", "singular_values_",
    "n_cols", "dtype",
)
_LINREG_KEYS = ("coef_", "intercept_", "n_iter_", "n_cols", "dtype")
_LOGREG_KEYS = ("coef_", "intercept_", "classes_", "n_iter_", "objective_", "n_cols", "dtype")
_FOREST_KEYS = ("feature", "threshold", "node_stats", "classes_", "num_trees", "max_depth", "n_cols", "dtype")
_FOREST_ARRAYS = {"feature": 2, "threshold": 2, "node_stats": 3, "classes_": 1}
_UMAP_KEYS = ("embedding_", "raw_data_", "a_", "b_", "n_cols", "dtype")


def _model_from_jax(cls, name: str, attrs: Dict[str, Any], keys: Tuple[str, ...], arrays: Dict[str, int]):
    """`cls` built from the JAX model's attribute dict (the dict its writer
    saves): every key present, each array of its rank. A float64 `dtype`
    keeps the model at float64 on transform (``float32_inputs=False``), as
    a model of the JAX package fitted on float64 inputs would be."""
    missing = [key for key in keys if key not in attrs]
    if missing:
        raise ValueError(f"JAX {name} attributes lack {missing}")
    values = {key: attrs[key] for key in keys}
    for key, ndim in arrays.items():
        values[key] = np.asarray(values[key])
        if values[key].ndim != ndim:
            raise ValueError(f"{key} must be {ndim}-D, got shape {values[key].shape}")
    model = cls(**values)
    model._float32_inputs = np.dtype(str(attrs["dtype"])) != np.float64
    return model


def kmeans_model_from_jax(attrs: Dict[str, Any]) -> KMeansModel:
    """A KMeansModel from the JAX KMeansModel's attributes
    (`cluster_centers_` [k, d], `inertia_`, `n_iter_`, `n_cols`, `dtype`)."""
    return _model_from_jax(KMeansModel, "KMeans", attrs, _KMEANS_KEYS, {"cluster_centers_": 2})


def pca_model_from_jax(attrs: Dict[str, Any]) -> PCAModel:
    """A PCAModel from the JAX PCAModel's attributes (`mean_` [d],
    `components_` [k, d], `explained_variance_`, `explained_variance_ratio_`,
    `singular_values_` [k], `n_cols`, `dtype`)."""
    return _model_from_jax(
        PCAModel, "PCA", attrs, _PCA_KEYS,
        {"mean_": 1, "components_": 2, "explained_variance_": 1, "explained_variance_ratio_": 1,
         "singular_values_": 1},
    )


def linear_regression_model_from_jax(attrs: Dict[str, Any]) -> LinearRegressionModel:
    """A LinearRegressionModel from the JAX LinearRegressionModel's
    attributes (`coef_` [d], `intercept_`, `n_iter_`, `n_cols`, `dtype`)."""
    return _model_from_jax(LinearRegressionModel, "LinearRegression", attrs, _LINREG_KEYS, {"coef_": 1})


def logistic_regression_model_from_jax(attrs: Dict[str, Any]) -> LogisticRegressionModel:
    """A LogisticRegressionModel from the JAX LogisticRegressionModel's
    attributes (`coef_` [k_out, d], `intercept_` [k_out], `classes_`,
    `n_iter_`, `objective_`, `n_cols`, `dtype`)."""
    return _model_from_jax(
        LogisticRegressionModel, "LogisticRegression", attrs, _LOGREG_KEYS,
        {"coef_": 2, "intercept_": 1, "classes_": 1},
    )


def random_forest_classification_model_from_jax(attrs: Dict[str, Any]) -> RandomForestClassificationModel:
    """A RandomForestClassificationModel from the JAX model's attributes
    (`feature`, `threshold` [T, M], `node_stats` [T, M, k], `classes_` [k],
    `num_trees`, `max_depth`, `n_cols`, `dtype`)."""
    return _model_from_jax(
        RandomForestClassificationModel, "RandomForestClassificationModel", attrs, _FOREST_KEYS, _FOREST_ARRAYS
    )


def random_forest_regression_model_from_jax(attrs: Dict[str, Any]) -> RandomForestRegressionModel:
    """A RandomForestRegressionModel from the JAX model's attributes
    (`feature`, `threshold` [T, M], `node_stats` [T, M, 3], `classes_`
    (empty), `num_trees`, `max_depth`, `n_cols`, `dtype`)."""
    return _model_from_jax(
        RandomForestRegressionModel, "RandomForestRegressionModel", attrs, _FOREST_KEYS, _FOREST_ARRAYS
    )


# the arrays of each ANN index, by algorithm, and their dtypes on the device
_ANN_INDEX = {
    "ivfflat": {"centroids": "float32", "buckets": "float32", "bucket_ids": "int64"},
    "ivfpq": {"centroids": "float32", "codebooks": "float32", "code_buckets": None, "bucket_ids": "int64"},
    "cagra": {"x": "float32", "graph": "int32"},
}


def approximate_nearest_neighbors_model_from_jax(attrs: Dict[str, Any], index: Dict[str, Any], items: Any):
    """An ApproximateNearestNeighborsModel searching the index a JAX
    ApproximateNearestNeighborsModel built. `attrs` holds its `algorithm`
    ("ivfflat", "ivfpq" or "cagra"), `solver_params` (the JAX model's
    `_solver_params`), and optionally `n_cols`, `dtype`, `inputCol`,
    `idCol`; `index` its `_index` (`centroids`, `buckets`, `bucket_ids`,
    stored unpadded as `ops/knn.build_ivfflat` stores them; `centroids`,
    `codebooks`, `code_buckets`, `bucket_ids`; or `x`, `graph`), each
    array copied to the device `set_devices` chose; `items`
    the item dataset it was fitted on, bound as the model's items. For
    ivfpq the refine scores the item rows (unit rows under cosine) at
    float32, as the index was built from."""
    from .data import as_pandas
    from .ops.knn import ivfflat_from_padded
    from .parallel import default_device, host_tensor
    from .utils import unit_rows

    algo = str(attrs.get("algorithm", ""))
    if algo not in _ANN_INDEX:
        raise ValueError(f"algorithm must be one of {sorted(_ANN_INDEX)}, got {algo!r}")
    missing = [key for key in _ANN_INDEX[algo] if key not in index]
    if missing:
        raise ValueError(f"JAX {algo} index lacks {missing}")
    device = default_device()
    model = ApproximateNearestNeighborsModel(n_cols=int(attrs.get("n_cols", 0)), dtype=str(attrs.get("dtype", "float32")))
    model._solver_params.update(dict(attrs["solver_params"]))
    model._float32_inputs = np.dtype(str(attrs.get("dtype", "float32"))) != np.float64
    for name in ("inputCol", "idCol"):
        if attrs.get(name) is not None:
            model.set(name, attrs[name])
    arrays = {key: host_tensor(np.asarray(index[key], dtype=dt) if dt else np.asarray(index[key]))
              for key, dt in _ANN_INDEX[algo].items()}
    if algo == "ivfflat":  # the JAX package's padded lists, unpadded
        arrays = ivfflat_from_padded(arrays["centroids"], arrays["buckets"], arrays["bucket_ids"])
    model._index = {key: v if key == "offsets" else v.to(device) for key, v in arrays.items()}
    model._algorithm = algo
    model._item_pdf = as_pandas(items)
    model._item_extracted = model._pre_process_data(items, for_fit=False)
    model.n_cols = model._item_extracted.n_cols
    if algo == "ivfpq":
        feats = model._item_extracted.features
        if str(model._solver_params["metric"]) == "cosine":
            feats = unit_rows(feats)
        model._refine_x = host_tensor(np.asarray(feats)).to(device)
    return model


def _set_jax_params(model, params: Dict[str, Any]):
    """`model` with the JAX model's Spark params (name -> value) that it
    has set; None values keep the model's defaults."""
    model._set_params(**{k: v for k, v in params.items() if v is not None and model.hasParam(k)})
    return model


def dbscan_model_from_jax(params: Dict[str, Any]) -> DBSCANModel:
    """A DBSCANModel from the JAX DBSCANModel's params (`eps`,
    `min_samples`, `metric`, `max_mbytes_per_batch`,
    `calc_core_sample_indices`, the column names; name -> value)."""
    return _set_jax_params(DBSCANModel(), params)


def umap_model_from_jax(attrs: Dict[str, Any], params: Dict[str, Any]) -> UMAPModel:
    """A UMAPModel from the JAX UMAPModel's attributes (`embedding_` [n, c],
    `raw_data_` [n, d], `a_`, `b_`, `n_cols`, `dtype`) and its params
    (`n_neighbors`, `n_epochs`, `random_state`, `metric`, the column
    names, ...; name -> value)."""
    model = _model_from_jax(UMAPModel, "UMAP", attrs, _UMAP_KEYS, {"embedding_": 2, "raw_data_": 2})
    return _set_jax_params(model, params)
