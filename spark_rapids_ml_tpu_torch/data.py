#
# Data plane: DataFrame-like input -> one contiguous (row-major) numpy feature
# block, ready to be placed on the device as one tensor (parallel.place_rows).
#
# The dense half of the JAX package's spark_rapids_ml_tpu/data.py: a dict
# holding a 2-D ndarray (the at-scale path), and pandas / pyarrow / dict
# inputs whose feature column holds arrays, lists or DenseVectors, or whose
# features are several scalar columns; a label column beside them for the
# supervised estimators. Sparse input (SparseVector cells, scipy
# CSR) raises NotImplementedError: the CSR path is ROADMAP item A11.
#
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from .linalg import DenseVector, SparseVector

# Per-row feature cells are converted to the dense block in row chunks of at
# most this many bytes, so the per-row temporaries never hold a second copy
# of the dataset (the JAX package's config["ingest_chunk_bytes"] default).
_INGEST_CHUNK_BYTES = 128 << 20

_SPARSE_TODO = (
    "sparse feature input is not supported by the PyTorch port yet "
    "(ROADMAP item A11: memory admission, out-of-core, sparse)"
)


@dataclass
class ExtractedData:
    """Columnar view of a dataset after ingest."""

    features: np.ndarray  # [n, d]
    label: Optional[np.ndarray] = None  # [n] at the features' dtype, None = unsupervised
    weight: Optional[np.ndarray] = None  # [n], None = all ones
    row_id: Optional[np.ndarray] = None  # [n] int64, None = no id column
    # how the features arrived: "vector" (DenseVector cells), "array" (array
    # or list cells, or a dict's 2-D block) or "multi_cols" (scalar columns);
    # a 2-D transform result goes back as DenseVectors only for "vector"
    feature_kind: str = "array"

    @property
    def n_rows(self) -> int:
        return int(self.features.shape[0])

    @property
    def n_cols(self) -> int:
        return int(self.features.shape[1])


def _is_scipy_sparse(v: Any) -> bool:
    return type(v).__module__.startswith("scipy.sparse")


def as_pandas(dataset: Any):
    """Normalize any accepted dataset type to a pandas DataFrame (zero-copy where possible)."""
    import pandas as pd

    if isinstance(dataset, pd.DataFrame):
        return dataset
    try:
        import pyarrow as pa

        if isinstance(dataset, pa.Table):
            return dataset.to_pandas()
    except ImportError:  # pragma: no cover
        pass
    if isinstance(dataset, dict):
        return pd.DataFrame({k: (list(v) if getattr(v, "ndim", 1) > 1 else v) for k, v in dataset.items()})
    # pyspark.sql.DataFrame (optional dependency)
    if hasattr(dataset, "toPandas") and hasattr(dataset, "sparkSession"):
        return dataset.toPandas()
    raise TypeError(f"Unsupported dataset type {type(dataset)}; expected pandas/pyarrow/dict")


def dataset_fingerprint(dataset: Any) -> tuple:
    """Identity fingerprint of a dataset object, for the placement cache's
    keys (core.device_dataset_scope).

    Identity-based by design: hashing the data would cost a host pass per
    fit, more than the ingest it is meant to skip. The id() is only stable
    while the object lives, so every cache entry pins its source object
    (`core.DeviceDataset.source`); shape and columns ride along as defense
    in depth. An in-place mutation of the same object between fits inside
    one scope is not detected."""
    if isinstance(dataset, dict):
        shapes = tuple(
            (str(k), tuple(getattr(v, "shape", ())) or (len(v) if hasattr(v, "__len__") else None))
            for k, v in dataset.items()
        )
        return (id(dataset), type(dataset).__name__, shapes)
    cols = getattr(dataset, "columns", None)
    cols_t = tuple(map(str, cols)) if cols is not None else None
    shape = getattr(dataset, "shape", None)
    if shape is None and hasattr(dataset, "__len__"):
        shape = (len(dataset),)
    return (id(dataset), type(dataset).__name__, cols_t, tuple(shape) if shape else None)


def _fill_dense_chunked(values, n_cols: int, dtype, to_row) -> np.ndarray:
    """Object column of per-row cells -> preallocated [n, n_cols] block,
    converted one row chunk at a time (see _INGEST_CHUNK_BYTES)."""
    n = len(values)
    out = np.empty((n, n_cols), dtype=dtype)
    step = max(1, _INGEST_CHUNK_BYTES // max(1, n_cols * np.dtype(dtype).itemsize))
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        out[lo:hi] = [to_row(v) for v in values[lo:hi]]
    return out


def _column_to_matrix(col, dtype) -> Tuple[np.ndarray, str]:
    """One feature column of DenseVectors / arrays / lists -> (2-D block,
    feature kind)."""
    values = col.to_numpy() if hasattr(col, "to_numpy") else np.asarray(col, dtype=object)
    if len(values) == 0:
        raise ValueError("empty feature column")
    first = values[0]
    if isinstance(first, SparseVector) or _is_scipy_sparse(first):
        raise NotImplementedError(_SPARSE_TODO)
    if isinstance(first, DenseVector):
        if any(isinstance(v, SparseVector) for v in values):
            raise NotImplementedError(_SPARSE_TODO)
        return _fill_dense_chunked(values, first.size, dtype, lambda v: v.toArray()), "vector"
    if isinstance(first, np.ndarray) and first.ndim == 1:
        return _fill_dense_chunked(values, len(first), dtype, lambda v: v), "array"
    if isinstance(first, (list, tuple)):
        return _fill_dense_chunked(values, len(first), dtype, np.asarray), "array"
    raise TypeError(f"Unsupported feature cell type {type(first)} in feature column")


def extract_dataset(
    dataset: Any,
    *,
    input_col: Optional[str] = None,
    input_cols: Optional[Sequence[str]] = None,
    label_col: Optional[str] = None,
    weight_col: Optional[str] = None,
    id_col: Optional[str] = None,
    float32_inputs: bool = True,
) -> ExtractedData:
    """Extract the features (one column of row cells, several scalar
    columns, or a dict's 2-D block), the labels and weights at the features'
    dtype, and the int64 row ids, as contiguous blocks. A named column the
    dataset lacks raises ValueError."""
    dtype = np.float32 if float32_inputs else np.float64

    def _scalar(columns, colname: Optional[str], dt) -> Optional[np.ndarray]:
        if not colname:
            return None
        if colname not in columns:
            raise ValueError(f"column {colname!r} not in dataset")
        col = columns[colname]
        return np.ascontiguousarray(col.to_numpy(dtype=dt) if hasattr(col, "to_numpy") else np.asarray(col, dtype=dt))

    # Fast path for dict datasets whose feature entry is ALREADY a 2-D block:
    # skip the per-row object column entirely (the at-scale ingest).
    if isinstance(dataset, dict) and input_col is not None and input_col in dataset:
        block = dataset[input_col]
        if _is_scipy_sparse(block):
            raise NotImplementedError(_SPARSE_TODO)
        if isinstance(block, np.ndarray) and block.ndim == 2:
            return ExtractedData(
                np.ascontiguousarray(block, dtype=dtype),
                label=_scalar(dataset, label_col, dtype),
                weight=_scalar(dataset, weight_col, dtype),
                row_id=_scalar(dataset, id_col, np.int64),
            )

    pdf = as_pandas(dataset)

    if input_cols is not None:
        missing = [c for c in input_cols if c not in pdf.columns]
        if missing:
            raise ValueError(f"feature columns not in dataset: {missing}")
        features = np.ascontiguousarray(pdf[list(input_cols)].to_numpy(dtype=dtype))
        kind = "multi_cols"
    else:
        if input_col is None:
            raise ValueError("an input column is required")
        if input_col not in pdf.columns:
            raise ValueError(f"feature column {input_col!r} not in dataset")
        features, kind = _column_to_matrix(pdf[input_col], dtype)
    return ExtractedData(
        features,
        label=_scalar(pdf, label_col, dtype),
        weight=_scalar(pdf, weight_col, dtype),
        row_id=_scalar(pdf, id_col, np.int64),
        feature_kind=kind,
    )
