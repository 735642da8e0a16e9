#
# Data plane: DataFrame-like input -> one contiguous (row-major) numpy feature
# block, ready to be placed on the device as one tensor (parallel.place_rows)
# or streamed to it in row chunks (parallel.stream_place_blocks).
#
# The PyTorch counterpart of the JAX package's spark_rapids_ml_tpu/data.py:
# a dict holding a 2-D ndarray or a scipy sparse matrix (the at-scale path),
# and pandas / pyarrow / dict inputs whose feature column holds arrays,
# lists, DenseVectors, SparseVectors or scipy rows, or whose features are
# several scalar columns; a label column beside them for the supervised
# estimators. Sparse cells come out as one scipy CSR matrix (nnz counted
# first, then filled in place); `enable_sparse_data_optim` decides whether
# it stays CSR (None: autodetect; True: required, dense input raises
# ValueError; False: densified). The estimators without a CSR path ask for
# the densified form (core._TpuCommon._pre_process_data).
#
# The opt-in NaN/Inf scan (`config["validate_ingest"]`, off by default)
# raises `IngestValidationError` naming the column and the first bad row.
# Transforms and the estimators that bind their rows without a fit scan at
# extraction; a fit defers the scan to core.py's fit path, which scans
# everything before a resident placement and each row block as it enters
# the stream on the out-of-core path. The same scan of dense rows feeds the
# drift statistics (ops_plane/drift.py: per-column moments and PSI against
# a registered baseline, while telemetry is on).
#
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .linalg import DenseVector, SparseVector

try:
    import scipy.sparse as _sp
except ImportError:  # pragma: no cover
    _sp = None


@dataclass
class ExtractedData:
    """Columnar view of a dataset after ingest."""

    features: Any  # np.ndarray [n, d], or a scipy CSR matrix
    label: Optional[np.ndarray] = None  # [n] at the features' dtype, None = unsupervised
    weight: Optional[np.ndarray] = None  # [n], None = all ones
    row_id: Optional[np.ndarray] = None  # [n] int64, None = no id column
    # how the features arrived: "vector" (DenseVector cells), "array" (array
    # or list cells, or a dict's 2-D block) or "multi_cols" (scalar columns);
    # a 2-D transform result goes back as DenseVectors only for "vector"
    feature_kind: str = "array"
    # source column names, for naming a bad value (the streaming path scans
    # each row block long after extraction, so the names ride with the data)
    feature_names: List[str] = field(default_factory=list)
    label_name: Optional[str] = None
    weight_name: Optional[str] = None

    @property
    def n_rows(self) -> int:
        return int(self.features.shape[0])

    @property
    def n_cols(self) -> int:
        return int(self.features.shape[1])

    @property
    def is_sparse(self) -> bool:
        return _is_scipy_sparse(self.features)

    def row_block(self, lo: int, hi: int) -> "ExtractedData":
        """Rows [lo, hi) of every column, as views (a CSR row slice for
        sparse features)."""

        def cut(a):
            return None if a is None else a[lo:hi]

        return ExtractedData(
            self.features[lo:hi], label=cut(self.label), weight=cut(self.weight), row_id=cut(self.row_id),
            feature_kind=self.feature_kind, feature_names=list(self.feature_names),
            label_name=self.label_name, weight_name=self.weight_name,
        )


def _is_scipy_sparse(v: Any) -> bool:
    return _sp is not None and _sp.issparse(v)


def as_dense(features: Any) -> Any:
    """A feature block as dense rows: a scipy sparse matrix densified
    (duplicate entries summed in storage order, as scipy does), anything
    else as it is."""
    if _is_scipy_sparse(features):
        return np.asarray(features.todense())
    return features


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


def same_ingest_identity(key_a: Any, key_b: Any) -> bool:
    """Whether two placement-cache keys name the SAME ingested data (the
    dataset fingerprint, the extraction columns, the dtype and sparse mode)
    whatever the device and membership they were placed under (the key's
    last part): after a recovery epoch changes the group under one fit, the
    stale placement's host blocks are still the right data, and only the
    layout is redone."""
    return key_a is not None and key_b is not None and len(key_a) == len(key_b) == 4 and key_a[:3] == key_b[:3]


def ingest_chunk_rows(row_bytes: int) -> int:
    """Rows per ingest chunk under ``core.config["ingest_chunk_bytes"]``."""
    from .core import config  # lazy: core imports this module at load time

    chunk_bytes = int(config.get("ingest_chunk_bytes", 128 << 20))
    return max(1, chunk_bytes // max(1, int(row_bytes)))


def _first_nonfinite_row(block: np.ndarray, lo: int) -> int:
    """Row index (absolute, given chunk offset `lo`) of the first non-finite
    entry in a dense chunk."""
    finite_rows = np.isfinite(block).all(axis=tuple(range(1, block.ndim)))
    return lo + int(np.argmin(finite_rows))


def validate_extracted(
    extracted: "ExtractedData",
    label_col=None,
    weight_col=None,
    lo: int = 0,
    hi: Optional[int] = None,
) -> None:
    """NaN/Inf scan over rows ``[lo, hi)`` of the ingested blocks.

    Chunked under the same ``ingest_chunk_bytes`` bound as the ingest
    itself, so the scan's temporaries (the per-chunk finite mask) never
    scale with the dataset. Raises `IngestValidationError` naming the
    offending column and the ABSOLUTE first bad row. The full-range call is
    the eager scan; the streaming fit path calls it per row block as chunks
    enter the pipeline, so the dataset is never read a second time just to
    validate it. A CSR block is scanned through its stored values only."""
    from .core import config
    from .errors import IngestValidationError

    feats = extracted.features
    n = extracted.n_rows
    hi = n if hi is None else min(int(hi), n)
    lo = max(0, int(lo))
    if extracted.is_sparse:
        # CSR: only the stored values can be non-finite; the rows' slice of
        # the values in chunks, a bad element mapped back to its absolute
        # row through indptr
        indptr = feats.indptr
        e_lo, e_hi = int(indptr[lo]), int(indptr[hi])
        data = feats.data
        step = max(1, int(config.get("ingest_chunk_bytes", 128 << 20)) // max(1, data.itemsize))
        for elo in range(e_lo, e_hi, step):
            chunk = data[elo:min(elo + step, e_hi)]
            if not np.isfinite(chunk).all():
                elem = elo + int(np.argmin(np.isfinite(chunk)))
                row = int(np.searchsorted(indptr, elem, side="right") - 1)
                raise IngestValidationError(extracted.feature_names[0], row)
    else:
        # the drift statistics accumulate off this same pass (no extra read
        # of the data); a failing chunk is counted before the raise, and
        # partial statistics are never published. None, and no cost, while
        # telemetry is off
        from .ops_plane import drift as _drift

        acc = _drift.accumulator_for(extracted)
        row_bytes = feats.shape[1] * feats.itemsize if feats.ndim > 1 else feats.itemsize
        step = ingest_chunk_rows(row_bytes)
        for clo in range(lo, hi, step):
            chunk = np.asarray(feats[clo : min(clo + step, hi)])
            if acc is not None:
                acc.update(chunk)
            if np.isfinite(chunk).all():
                continue
            if extracted.feature_kind == "multi_cols" and chunk.ndim > 1:
                # name the exact offending source column, not the block
                bad_cols = ~np.isfinite(chunk).all(axis=0)
                name = extracted.feature_names[int(np.argmax(bad_cols))]
                col = chunk[:, int(np.argmax(bad_cols))]
                raise IngestValidationError(name, clo + int(np.argmin(np.isfinite(col))))
            raise IngestValidationError(extracted.feature_names[0], _first_nonfinite_row(chunk, clo))
        if acc is not None and acc.rows >= n:
            # the whole dataset has been scanned (eagerly, or by the last of
            # a streamed fit's per-block scans): publish the gauges
            acc.publish()
    for name, arr in ((label_col, extracted.label), (weight_col, extracted.weight)):
        if arr is None:
            continue
        part = arr[lo:hi]
        if not np.isfinite(part).all():
            raise IngestValidationError(str(name), lo + int(np.argmin(np.isfinite(part))))


def run_deferred_validation(extracted: "ExtractedData", lo: int = 0, hi: Optional[int] = None) -> None:
    """`validate_extracted` gated on ``config["validate_ingest"]``, with the
    column names taken from the extraction record: the entry point for the
    fit path (the full scan before a resident placement) and the streaming
    pipeline (per row block)."""
    from .core import config

    if not config.get("validate_ingest", False):
        return
    validate_extracted(extracted, extracted.label_name, extracted.weight_name, lo=lo, hi=hi)


def _record_ingest(extracted: "ExtractedData", label_col, weight_col, validate: bool) -> "ExtractedData":
    """The column names of a completed extraction, its eager scan unless
    `validate` is False (a fit, whose fit path runs the scan itself), and
    the ingest's host bytes (`ingest.bytes`; CSR counts its data, index and
    indptr arrays) while telemetry is on."""
    from . import telemetry

    extracted.label_name = None if label_col is None else str(label_col)
    extracted.weight_name = None if weight_col is None else str(weight_col)
    if validate:
        run_deferred_validation(extracted)
    if telemetry.enabled():
        feats = extracted.features
        if extracted.is_sparse:
            nbytes = feats.data.nbytes + feats.indices.nbytes + feats.indptr.nbytes
        else:
            nbytes = feats.nbytes
        for aux in (extracted.label, extracted.weight, extracted.row_id):
            if aux is not None:
                nbytes += aux.nbytes
        telemetry.registry().inc("ingest.bytes", nbytes)
    return extracted


def _fill_dense_chunked(values, n_cols: int, dtype, to_row) -> np.ndarray:
    """Object column of per-row cells -> preallocated [n, n_cols] block,
    converted one row chunk at a time (`ingest_chunk_rows`), so the per-row
    temporaries never hold a second copy of the dataset."""
    n = len(values)
    out = np.empty((n, n_cols), dtype=dtype)
    step = ingest_chunk_rows(n_cols * np.dtype(dtype).itemsize)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        out[lo:hi] = [to_row(v) for v in values[lo:hi]]
    return out


def _column_to_csr(values, size: int, dtype):
    """An object column of sparse (and dense) vector cells -> one scipy CSR
    matrix [n, size] at `dtype`. Each row is decoded once (a SparseVector
    gives references to its own arrays, no copy), the row lengths fill
    indptr, then the cells are copied in place, each row's decode freed as
    it goes: no second whole-nnz copy exists."""

    def _row_parts(v):
        if isinstance(v, SparseVector):
            return v.indices, v.values
        if isinstance(v, DenseVector):
            idx = np.nonzero(v.values)[0].astype(np.int32)
            return idx, v.values[idx]
        v = v.tocsr()  # a scipy sparse row
        return v.indices, v.data

    n = len(values)
    parts = [_row_parts(v) for v in values]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(idx) for idx, _ in parts], dtype=np.int64, out=indptr[1:])
    data = np.empty(int(indptr[-1]), dtype=dtype)
    indices = np.empty(int(indptr[-1]), dtype=np.int32)
    for i in range(n):
        idx, val = parts[i]
        parts[i] = None
        lo, hi = indptr[i], indptr[i + 1]
        indices[lo:hi] = idx
        data[lo:hi] = val  # cast to dtype on assignment
    return _sp.csr_matrix((data, indices, indptr), shape=(n, size), dtype=dtype)


def _column_to_matrix(col, dtype) -> Tuple[Any, str]:
    """One feature column of vectors / arrays / lists -> (2-D block,
    feature kind): a scipy CSR matrix when any cell is sparse (a
    SparseVector or a scipy row), else a dense block."""
    values = col.to_numpy() if hasattr(col, "to_numpy") else np.asarray(col, dtype=object)
    if len(values) == 0:
        raise ValueError("empty feature column")
    first = values[0]
    if isinstance(first, (DenseVector, SparseVector)) or _is_scipy_sparse(first):
        if any(isinstance(v, SparseVector) or _is_scipy_sparse(v) for v in values):
            size = first.size if isinstance(first, (DenseVector, SparseVector)) else first.shape[1]
            return _column_to_csr(values, size, dtype), "vector"
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
    enable_sparse_data_optim: Optional[bool] = None,
    validate: bool = True,
) -> ExtractedData:
    """Extract the features (one column of row cells, several scalar
    columns, or a dict's 2-D block or scipy sparse matrix), the labels and
    weights at the features' dtype, and the int64 row ids, as contiguous
    blocks. A named column the dataset lacks raises ValueError.
    ``enable_sparse_data_optim``: None keeps sparse input as CSR; True
    requires it (dense input raises ValueError); False densifies it.
    ``validate=False`` defers the opt-in NaN/Inf scan to the caller
    (`run_deferred_validation`)."""
    if isinstance(dataset, ExtractedData):
        # a chip's block of a fit fanned out over the device pool
        # (core.py): extracted once by the caller, sliced into views
        return dataset
    dtype = np.float32 if float32_inputs else np.float64

    def _scalar(columns, colname: Optional[str], dt) -> Optional[np.ndarray]:
        if not colname:
            return None
        if colname not in columns:
            raise ValueError(f"column {colname!r} not in dataset")
        col = columns[colname]
        return np.ascontiguousarray(col.to_numpy(dtype=dt) if hasattr(col, "to_numpy") else np.asarray(col, dtype=dt))

    # Fast path for dict datasets whose feature entry is ALREADY a 2-D block
    # or a scipy sparse matrix: skip the per-row object column entirely (the
    # at-scale ingest). A sparse block keeps its own dtype until it is
    # converted for the device (ops/sparse.csr_to_ell casts to the fit's).
    if isinstance(dataset, dict) and input_col is not None and input_col in dataset:
        block = dataset[input_col]
        features = None
        if _is_scipy_sparse(block):
            features, kind = block.tocsr(), "vector"
            if enable_sparse_data_optim is False:
                features = np.asarray(features.todense(), dtype=dtype)
        elif isinstance(block, np.ndarray) and block.ndim == 2:
            if enable_sparse_data_optim is True:
                raise ValueError("enable_sparse_data_optim=True requires sparse input")
            features, kind = np.ascontiguousarray(block, dtype=dtype), "array"
        if features is not None:
            return _record_ingest(ExtractedData(
                features,
                label=_scalar(dataset, label_col, dtype),
                weight=_scalar(dataset, weight_col, dtype),
                row_id=_scalar(dataset, id_col, np.int64),
                feature_kind=kind,
                feature_names=[input_col],
            ), label_col, weight_col, validate)

    pdf = as_pandas(dataset)

    if input_cols is not None:
        missing = [c for c in input_cols if c not in pdf.columns]
        if missing:
            raise ValueError(f"feature columns not in dataset: {missing}")
        features = np.ascontiguousarray(pdf[list(input_cols)].to_numpy(dtype=dtype))
        kind = "multi_cols"
        names = list(input_cols)
    else:
        if input_col is None:
            raise ValueError("an input column is required")
        if input_col not in pdf.columns:
            raise ValueError(f"feature column {input_col!r} not in dataset")
        features, kind = _column_to_matrix(pdf[input_col], dtype)
        names = [input_col]
    if _is_scipy_sparse(features):
        if enable_sparse_data_optim is False:
            features = np.asarray(features.todense(), dtype=dtype)
    elif enable_sparse_data_optim is True:
        raise ValueError("enable_sparse_data_optim=True requires sparse vector input")
    return _record_ingest(ExtractedData(
        features,
        label=_scalar(pdf, label_col, dtype),
        weight=_scalar(pdf, weight_col, dtype),
        row_id=_scalar(pdf, id_col, np.int64),
        feature_kind=kind,
        feature_names=names,
    ), label_col, weight_col, validate)
