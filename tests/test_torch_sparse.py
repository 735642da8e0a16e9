#
# Sparse input in the PyTorch port (spark_rapids_ml_tpu_torch/ops/sparse.py,
# the CSR half of data.py, the sparse admission terms of memory.py and the
# estimators) against the JAX package on the same numpy and scipy inputs,
# after tests/test_sparse_ops.py, tests/test_ingest.py and
# tests/test_memory.py. CPU throughout; data from numpy seeds.
#
# Tolerances:
#   * the padded-ELL host arrays equal JAX's `csr_to_ell` bit for bit
#     (int32 indices, values at the fit dtype), chunked or not;
#   * the ELL products in float64 within rtol 1e-12 of JAX's (another
#     summation order: per column in fixed chunks, where JAX scatters);
#     against scipy's dense products rtol 1e-4 in float32, as
#     tests/test_sparse_ops.py;
#   * the column sums of `EllColumns` equal a numpy reference that adds in
#     the same fixed order bit for bit, and `ell_densify` equals scipy's
#     `todense` bit for bit (duplicate columns included);
#   * extraction (CSR arrays, row ids, labels) equal to JAX's exactly, and
#     the admission terms under JAX's names equal to JAX's exactly; the
#     port's own terms equal analytic byte counts.
#
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu import memory as jmemory
from spark_rapids_ml_tpu.data import extract_dataset as jax_extract
from spark_rapids_ml_tpu.errors import IngestValidationError as JaxIngestValidationError
from spark_rapids_ml_tpu.linalg import SparseVector as JaxSparseVector
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.models.regression import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu.ops import sparse as jsparse
from spark_rapids_ml_tpu_torch import KMeans, LinearRegression, LogisticRegression, memory, set_devices, telemetry
from spark_rapids_ml_tpu_torch.core import config
from spark_rapids_ml_tpu_torch.data import as_dense, extract_dataset, validate_extracted
from spark_rapids_ml_tpu_torch.errors import IngestValidationError
from spark_rapids_ml_tpu_torch.linalg import DenseVector, SparseVector
from spark_rapids_ml_tpu_torch.models.knn import NearestNeighbors
from spark_rapids_ml_tpu_torch.ops import sparse as tsparse
from tests.sparse_gen import random_csr

F64_OPS_RTOL = 1e-12


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    # a fresh shared ledger: what another test left resident must not count
    # against these budgets
    from spark_rapids_ml_tpu_torch.scheduler import ledger

    monkeypatch.setattr(ledger, "_GLOBAL", ledger.HbmLedger())
    set_devices("cpu")
    saved = {k: config[k] for k in ("ingest_chunk_bytes", "hbm_budget_bytes", "stream_chunk_rows",
                                    "validate_ingest", "solver_precision")}
    jsaved = {k: jcore.config[k] for k in saved}
    yield
    config.update(saved)
    jcore.config.update(jsaved)
    set_devices(None)


def _csr(rng, n, d, density, dtype=np.float64, dedup=True):
    x = random_csr(rng, n, d, density, dtype=dtype, values="normal")
    if dedup:
        x.sum_duplicates()
    return x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------- CSR -> ELL ---------


@pytest.mark.parametrize("n,d,density", [(200, 50, 0.1), (64, 8, 0.5), (500, 300, 0.01)])
def test_ell_roundtrip_and_matmul_parity(rng, n, d, density):
    # tests/test_sparse_ops.py's first case, through both packages
    x = _csr(rng, n, d, density, dtype=np.float32)
    indices, values, k_max = tsparse.csr_to_ell(x)
    jidx, jval, jk = jsparse.csr_to_ell(x)
    assert k_max == jk and indices.dtype == np.int32 and values.dtype == np.float32
    np.testing.assert_array_equal(indices, jidx)
    np.testing.assert_array_equal(values, jval)
    dense = np.zeros((n, d), np.float32)
    np.add.at(dense, (np.arange(n)[:, None].repeat(k_max, 1), indices), values)
    np.testing.assert_allclose(dense, x.toarray(), atol=1e-7)
    B = rng.normal(size=(d, 3)).astype(np.float32)
    got = tsparse.ell_matmul(_t(values), _t(indices), _t(B)).numpy()
    np.testing.assert_allclose(got, x.toarray() @ B, rtol=1e-4, atol=1e-4)
    got_v = tsparse.ell_matvec(_t(values), _t(indices), _t(B[:, 0])).numpy()
    np.testing.assert_allclose(got_v, x.toarray() @ B[:, 0], rtol=1e-4, atol=1e-4)
    r = rng.normal(size=n).astype(np.float32)
    got_r = tsparse.ell_rmatvec(_t(values), _t(indices), _t(r), d).numpy()
    np.testing.assert_allclose(got_r, x.toarray().T @ r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,d,density", [(300, 40, 0.15), (1200, 25, 0.3), (150, 6, 0.2)])
def test_ell_ops_equal_jax_in_float64(rng, n, d, density):
    x = _csr(rng, n, d, density, dedup=False)  # duplicate columns stay separate cells
    idx, val, _ = tsparse.csr_to_ell(x, dtype=np.float64)
    jidx, jval, _ = jsparse.csr_to_ell(x, dtype=np.float64)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(val, jval)
    B = rng.normal(size=(d, 4))
    r = rng.normal(size=n)
    w = rng.uniform(0.5, 2.0, size=n)
    np.testing.assert_allclose(tsparse.ell_matmul(_t(val), _t(idx), _t(B)).numpy(),
                               np.asarray(jsparse.ell_matmul(val, idx, B)), rtol=F64_OPS_RTOL, atol=1e-13)
    np.testing.assert_allclose(tsparse.ell_matvec(_t(val), _t(idx), _t(B[:, 1])).numpy(),
                               np.asarray(jsparse.ell_matvec(val, idx, B[:, 1])), rtol=F64_OPS_RTOL, atol=1e-13)
    np.testing.assert_allclose(tsparse.ell_rmatvec(_t(val), _t(idx), _t(r), d).numpy(),
                               np.asarray(jsparse.ell_rmatvec(val, idx, r, d)), rtol=F64_OPS_RTOL, atol=1e-12)
    got = tsparse.ell_col_moments(_t(val), _t(idx), _t(w), d)
    want = jsparse.ell_col_moments(val, idx, w, d)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-11, atol=1e-13)


def test_ell_col_moments_match_dense(rng):
    # tests/test_sparse_ops.py's second case
    x = _csr(rng, 300, 40, 0.15)
    w = rng.random(300)
    indices, values, _ = tsparse.csr_to_ell(x, dtype=np.float64)
    tw, mean, var = tsparse.ell_col_moments(_t(values), _t(indices), _t(w), 40)
    dense = x.toarray()
    np.testing.assert_allclose(float(tw), w.sum(), rtol=1e-12)
    want_mean = (dense * w[:, None]).sum(0) / w.sum()
    want_var = (dense ** 2 * w[:, None]).sum(0) / w.sum() - want_mean ** 2
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(var.numpy(), want_var, rtol=1e-9, atol=1e-12)


def test_ell_edge_cases(rng):
    # tests/test_sparse_ops.py's third case: all-empty rows, an explicit
    # k_max, a k_max below the widest row, a zero-row matrix
    x = sp.csr_matrix((5, 7), dtype=np.float32)
    indices, values, k_max = tsparse.csr_to_ell(x)
    assert k_max == 1 and not values.any()
    got = tsparse.ell_matmul(_t(values), _t(indices), torch.ones((7, 2))).numpy()
    np.testing.assert_array_equal(got, np.zeros((5, 2)))
    assert not tsparse.ell_rmatvec(_t(values), _t(indices), torch.ones(5), 7).any()
    x2 = _csr(rng, 30, 10, 0.3, dtype=np.float32)
    i2, v2, km = tsparse.csr_to_ell(x2, k_max=9)
    assert km == 9 and i2.shape == (30, 9)
    B = rng.normal(size=(10, 2)).astype(np.float32)
    np.testing.assert_allclose(tsparse.ell_matmul(_t(v2), _t(i2), _t(B)).numpy(), x2.toarray() @ B,
                               rtol=1e-4, atol=1e-5)
    wide = sp.csr_matrix(np.ones((2, 6), np.float32))
    with pytest.raises(ValueError, match="k_max"):
        tsparse.csr_to_ell(wide, k_max=3)
    empty = sp.csr_matrix((0, 4), dtype=np.float32)
    ie, ve, ke = tsparse.csr_to_ell(empty)
    assert ie.shape == (0, max(ke, 1)) and ve.shape == ie.shape
    assert tsparse.ell_rmatvec(_t(ve), _t(ie), torch.zeros(0), 4).shape == (4,)


def _col_sums_reference(values, indices, x, d, chunk):
    """The column sums of `EllColumns` in numpy, in its order: each
    column's cells (the (0, 0.0) cells left out) in row order, summed
    level by level in chunks of `chunk`, each chunk by torch's sum of a
    [rows, chunk] block (zero-padded)."""
    n, k_max = values.shape
    real = (indices != 0) | (values != 0)
    out = np.zeros(d, dtype=values.dtype)
    for j in range(d):
        mask = (indices == j) & real
        rows, slots = np.nonzero(mask)  # row-major: row order, then slot
        level = values[rows, slots] * x[rows]
        while level.size > 1:
            pad = -level.size % chunk
            blocks = np.concatenate([level, np.zeros(pad, level.dtype)]).reshape(-1, chunk)
            level = torch.from_numpy(blocks).sum(dim=1).numpy()
        out[j] = level[0] if level.size else 0.0
    return out


@pytest.mark.parametrize("chunk", [2, 3, 32])
def test_column_sums_add_in_the_layouts_fixed_order(rng, chunk):
    x = _csr(rng, 700, 9, 0.4, dedup=False)
    idx, val, _ = tsparse.csr_to_ell(x, dtype=np.float64)
    r = rng.normal(size=700)
    cols = tsparse.EllColumns(_t(val), _t(idx), 9, chunk=chunk)
    got = cols.col_sums(_t(val), _t(r)).numpy()
    np.testing.assert_array_equal(got, _col_sums_reference(val, idx, r, 9, chunk))
    assert cols.nbytes() <= memory.ell_columns_bytes(int(x.nnz), 9, 700, chunk)


def test_a_padding_cell_propagates_non_finite_like_jax(rng):
    # a (0, 0.0) padding cell adds 0 · r[row] into column 0: NaN where r is
    # NaN or inf, as JAX's scatter gives; a row without padding does not
    x = sp.csr_matrix(np.array([[0.0, 2.0, 3.0], [0.0, 1.0, 0.0], [4.0, 0.0, 0.0]]))
    idx, val, _ = tsparse.csr_to_ell(x, dtype=np.float64)
    for bad_row, col0_nan in ((1, True), (0, False)):
        r = np.ones(3)
        r[bad_row] = np.inf
        got = tsparse.ell_rmatvec(_t(val), _t(idx), _t(r), 3).numpy()
        want = np.asarray(jsparse.ell_rmatvec(val, idx, r, 3))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert bool(np.isnan(got[0])) == col0_nan
    B = np.ones((3, 1))
    B[0, 0] = np.nan  # the gather of B[0] by a padding cell: NaN in JAX too
    got = tsparse.ell_matmul(_t(val), _t(idx), _t(B)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(np.asarray(jsparse.ell_matmul(val, idx, B))))


def test_densify_equals_scipy_todense_with_duplicates(rng):
    x = random_csr(rng, 400, 12, 0.6, dtype=np.float32, values="normal")  # duplicate columns kept
    summed = x.copy()
    summed.sum_duplicates()
    assert summed.nnz < x.nnz  # rows that hold a column twice or more
    idx, val, _ = tsparse.csr_to_ell(x, dtype=np.float32)
    got = tsparse.ell_densify(_t(val), _t(idx), 12).numpy()
    np.testing.assert_array_equal(got, np.asarray(x.todense()))
    np.testing.assert_array_equal(as_dense(x), np.asarray(x.todense()))


def test_csr_to_ell_counters_like_jax(rng):
    x = _csr(rng, 120, 10, 0.2)
    telemetry.enable()
    telemetry.registry().reset()
    try:
        tsparse.csr_to_ell(x)
        snap = telemetry.registry().snapshot()
    finally:
        telemetry.disable()
    idx, _, k_max = jsparse.csr_to_ell(x)
    assert snap["counters"]["sparse.csr_to_ell_calls"] == 1
    assert snap["counters"]["sparse.ell_rows"] == 120
    assert snap["counters"]["sparse.ell_bytes"] == 120 * k_max * (4 + 8)
    assert snap["counters"]["sparse.ell_pad_cells"] == 120 * k_max - x.nnz
    assert snap["gauges"]["sparse.k_max"] == k_max


# ------------------------------------------------------------- ingest -------


def _set_chunk_bytes(nbytes):
    config["ingest_chunk_bytes"] = nbytes
    jcore.config["ingest_chunk_bytes"] = nbytes


def test_chunked_extraction_and_conversion_bit_identical(rng):
    # tests/test_ingest.py:152-175, the sparse halves: a SparseVector column
    # and csr_to_ell at a tiny chunk equal the one-chunk results, and JAX's
    d = 6
    sv = [SparseVector(d, np.sort(rng.choice(d, 2, replace=False)).astype(np.int32), rng.normal(size=2))
          for _ in range(257)]
    jsv = [JaxSparseVector(d, v.indices, v.values) for v in sv]
    _set_chunk_bytes(1 << 30)
    ref = extract_dataset(pd.DataFrame({"f": sv}), input_col="f", enable_sparse_data_optim=True).features
    x = random_csr(rng, 311, 40, 0.12)
    ref_ell = tsparse.csr_to_ell(x)
    _set_chunk_bytes(64)
    got = extract_dataset(pd.DataFrame({"f": sv}), input_col="f", enable_sparse_data_optim=True).features
    want = jax_extract(pd.DataFrame({"f": jsv}), input_col="f", enable_sparse_data_optim=True).features
    for a in (got, want):
        np.testing.assert_array_equal(a.indptr, ref.indptr)
        np.testing.assert_array_equal(a.indices, ref.indices)
        np.testing.assert_array_equal(a.data, ref.data)
    for a, b in zip(tsparse.csr_to_ell(x), ref_ell):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsparse.csr_to_ell(x), jsparse.csr_to_ell(x)):
        np.testing.assert_array_equal(a, b)


def test_sparse_fit_invariant_to_chunk_size(rng):
    # tests/test_ingest.py:95: CSR through chunked conversion gives the same
    # coefficients bit for bit at any chunk size
    x = random_csr(rng, 600, 24, 0.15)
    s = np.asarray(x.sum(axis=1)).ravel()
    df = {"features": x, "label": (s > np.median(s)).astype(np.float64)}

    def fit_coef():
        return LogisticRegression(maxIter=25, regParam=0.01).setFeaturesCol("features").fit(df).coef_

    c_default = fit_coef()
    _set_chunk_bytes(512)
    np.testing.assert_array_equal(c_default, fit_coef())


@pytest.mark.parametrize("kind", ["sparse_vectors", "mixed", "scipy_rows", "dict_csr", "dict_coo"])
@pytest.mark.parametrize("f32", [True, False], ids=["float32", "float64"])
def test_extraction_equals_jax(rng, kind, f32):
    x = _csr(rng, 50, 7, 0.3)
    y = rng.normal(size=50)
    if kind == "sparse_vectors":
        port = pd.DataFrame({"f": [SparseVector(7, r.indices, r.data) for r in x], "y": y})
        jax_ = pd.DataFrame({"f": [JaxSparseVector(7, r.indices, r.data) for r in x], "y": y})
    elif kind == "mixed":  # a DenseVector among the SparseVectors
        from spark_rapids_ml_tpu.linalg import DenseVector as JaxDenseVector

        port = pd.DataFrame({"f": [DenseVector(x[0].toarray()[0])] + [SparseVector(7, r.indices, r.data)
                                                                        for r in x[1:]], "y": y})
        jax_ = pd.DataFrame({"f": [JaxDenseVector(x[0].toarray()[0])] + [JaxSparseVector(7, r.indices, r.data)
                                                                           for r in x[1:]], "y": y})
    elif kind == "scipy_rows":
        port = jax_ = pd.DataFrame({"f": [r for r in x], "y": y})
    elif kind == "dict_csr":
        port = jax_ = {"f": x, "y": y}
    else:
        port = jax_ = {"f": x.tocoo(), "y": y}
    got = extract_dataset(port, input_col="f", label_col="y", float32_inputs=f32)
    want = jax_extract(jax_, input_col="f", label_col="y", float32_inputs=f32)
    assert got.is_sparse and want.is_sparse and got.feature_kind == want.feature_kind
    assert got.features.dtype == want.features.dtype
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got.features, attr), getattr(want.features, attr))
    np.testing.assert_array_equal(got.label, want.label)
    # densified on request, as JAX does
    got_d = extract_dataset(port, input_col="f", label_col="y", float32_inputs=f32, enable_sparse_data_optim=False)
    want_d = jax_extract(jax_, input_col="f", label_col="y", float32_inputs=f32, enable_sparse_data_optim=False)
    assert not got_d.is_sparse
    np.testing.assert_array_equal(got_d.features, want_d.features)


@pytest.mark.parametrize("dataset", ["dict", "pandas"])
def test_the_switch_on_dense_input_raises_like_jax(rng, dataset):
    x = rng.normal(size=(20, 3))
    data = {"f": x} if dataset == "dict" else pd.DataFrame({"f": list(x)})
    with pytest.raises(ValueError) as got:
        extract_dataset(data, input_col="f", enable_sparse_data_optim=True)
    with pytest.raises(ValueError) as want:
        jax_extract(data, input_col="f", enable_sparse_data_optim=True)
    assert str(got.value) == str(want.value)


def test_estimators_without_a_csr_path_densify_and_the_ones_with_keep_it(rng):
    x = _csr(rng, 60, 5, 0.4)
    data = {"features": x, "label": (rng.random(60) > 0.5).astype(float)}
    assert not KMeans(k=2)._pre_process_data(data).is_sparse
    assert LinearRegression()._pre_process_data(data).is_sparse
    assert LogisticRegression()._pre_process_data(data).is_sparse
    assert NearestNeighbors().setInputCol("features")._pre_process_data(data).is_sparse
    assert not LogisticRegression(enable_sparse_data_optim=False)._pre_process_data(data).is_sparse
    # the models densify their sparse input unless the switch is on
    m = LogisticRegression(maxIter=5).fit(data)
    assert not m._pre_process_data(data, for_fit=False).is_sparse


def test_validation_of_csr_names_the_row_like_jax(rng):
    x = _csr(rng, 400, 10, 0.2)
    bad = x.copy()
    bad.data[bad.indptr[233] + 0] = np.nan if bad.indptr[234] > bad.indptr[233] else bad.data[0]
    row = int(np.searchsorted(bad.indptr, int(np.argmax(~np.isfinite(bad.data))), side="right") - 1)
    config["validate_ingest"] = True
    jcore.config["validate_ingest"] = True
    _set_chunk_bytes(80)  # many chunks of the values
    with pytest.raises(IngestValidationError) as got:
        extract_dataset({"f": bad}, input_col="f")
    with pytest.raises(JaxIngestValidationError) as want:
        jax_extract({"f": bad}, input_col="f")
    assert got.value.row == want.value.row == row and got.value.column == "f"
    ex = extract_dataset({"f": bad}, input_col="f", validate=False)
    validate_extracted(ex, lo=0, hi=row)  # rows before the bad one pass
    with pytest.raises(IngestValidationError):
        validate_extracted(ex, lo=row, hi=row + 1)


def test_ingest_bytes_count_the_csr_arrays_like_jax(rng):
    x = _csr(rng, 90, 8, 0.25)
    y = rng.normal(size=90)
    telemetry.enable()
    telemetry.registry().reset()
    try:
        extract_dataset({"f": x, "y": y}, input_col="f", label_col="y")
        got = telemetry.registry().snapshot()["counters"]["ingest.bytes"]
    finally:
        telemetry.disable()
    assert got == x.data.nbytes + x.indices.nbytes + x.indptr.nbytes + y.astype(np.float32).nbytes


# ---------------------------------------------------------- admission -------


def _sparse_extracted(rng, n=600, d=40, label=True, f32=False):
    x = _csr(rng, n, d, 0.1)
    y = rng.normal(size=n) if label else None
    data = {"f": x} if y is None else {"f": x, "y": y}
    kw = dict(input_col="f", label_col="y" if label else None, float32_inputs=f32)
    return extract_dataset(data, **kw), jax_extract(data, **kw)


def test_ell_placement_terms_include_padding(rng):
    # tests/test_memory.py:77-95 on the port's own extraction
    ex, jex = _sparse_extracted(rng)
    k_max = int(np.diff(ex.features.indptr).max())
    assert k_max >= 2
    terms = memory.placement_terms(ex, np.float64)
    assert terms == jmemory.placement_terms(jex, np.float64, 1)
    assert terms["placement.ell_values"] == 600 * k_max * 8
    assert terms["placement.ell_indices"] == 600 * k_max * 4
    assert terms["placement.y"] == terms["placement.w"] == 600 * 8
    assert memory.row_bytes(ex, np.float64) == jmemory.row_bytes(jex, np.float64) == k_max * 12 + 16
    un, _ = _sparse_extracted(rng, label=False)
    assert "placement.y" not in memory.placement_terms(un, np.float64)


class _OneDevice:
    def __init__(self):
        self.mesh = type("M", (), {"devices": np.array([0])})()
        self.is_spmd = False


@pytest.mark.parametrize("name", ["linear", "logistic"])
@pytest.mark.parametrize("fast", [False, True])
def test_sparse_workspace_terms(rng, name, fast):
    # JAX's terms unchanged under its names; the port's own ELL terms at
    # their analytic counts, resident and at a chunk's rows
    ex, jex = _sparse_extracted(rng)
    params = {"solver_precision": "bf16"} if fast else {}
    est = (LinearRegression if name == "linear" else LogisticRegression)(float32_inputs=False, **params)
    jest = (JaxLinearRegression if name == "linear" else JaxLogisticRegression)(
        float32_inputs=False, num_workers=1, **params)
    k_max = int(np.diff(ex.features.indptr).max())
    nnz = int(ex.features.nnz)
    for rows in (600, 256):
        terms = memory.workspace_estimate(est, ex, rows_dev=rows).terms
        jterms = jmemory.workspace_estimate(jest, jex, 1, rows_dev=rows).terms
        own = {k: v for k, v in terms.items() if k not in jterms}
        assert {k: v for k, v in terms.items() if k in jterms} == \
            {k: v for k, v in jterms.items() if k != "workspace.bf16_X"}
        cells = min(nnz, rows * k_max)
        if name == "linear":
            want = {"workspace.ell_row_tile": (3 if fast else 2) * min(8192, rows) * 40 * 8}
        else:
            want = {"workspace.ell_columns": memory.ell_columns_bytes(cells, 40, rows, tsparse.SEGMENT_CHUNK),
                    "workspace.ell_products": (2 * min(rows * k_max, tsparse.MATVEC_TILE_CELLS) + 2 * cells
                                               + 40 * tsparse.SEGMENT_CHUNK) * 8}
        if fast:
            want["workspace.ell_fast_values"] = rows * k_max * 8
        assert own == want


def test_ell_columns_bytes_analytic():
    # 24 bytes a cell held at the build, each level's int64 gather (its
    # values and one chunk of padding a column), the final gather and a
    # bool a row
    assert memory.ell_columns_bytes(0, 4, 10, 32) == 8 * 4 + 10
    assert memory.ell_columns_bytes(1, 4, 10, 32) == 24 + 8 * 4 + 10
    # 100 cells, chunk 32: level 0 gathers 100 + 4·32 values; then at most
    # 100 // 32 + 4 = 7 values wide... the widest segment 100 -> 4 -> 1
    want = 24 * 100 + 8 * (100 + 4 * 32) + 8 * (7 + 4 * 32) + 8 * 4 + 10
    assert memory.ell_columns_bytes(100, 4, 10, 32) == want


def test_sparse_fit_admission_verdicts_like_jax(rng):
    # a CSR fit is admitted on its ELL placement: resident or streamed by
    # the same rules as a dense fit, the JAX terms equal to JAX's
    ex, jex = _sparse_extracted(rng, n=2000, d=30)
    est = LinearRegression(float32_inputs=False)
    need = memory.resident_estimate(est, ex).total()
    for budget, verdict in ((int(need / 0.9) + 16, memory.RESIDENT), (int(need * 0.6), memory.STREAM)):
        config.update(hbm_budget_bytes=budget, stream_chunk_rows=0)
        dec = memory.admit_fit(est, ex)
        assert dec.verdict == verdict
        memory.release_admission(dec)
    jest = JaxLinearRegression(float32_inputs=False, num_workers=1)
    placed = {k: v for k, v in memory.resident_estimate(est, ex).terms.items() if k.startswith("placement.")}
    assert placed == {k: v for k, v in jmemory.resident_estimate(jest, jex, 1).terms.items()
                      if k.startswith("placement.")}
    config.update(hbm_budget_bytes=None)


# ------------------------------------------- the two satellite terms --------


def test_knn_serving_prices_the_fast_staging(rng):
    # serve_dtype="bf16": the item block and the query bucket staged to bf16
    # on every dispatch; 16,384 items x 3000 -> 16,384 x 3008 bf16 = 98.6 MB,
    # a 4096-row bucket 24.6 MB, an 8192-row one 49.3 MB
    from spark_rapids_ml_tpu_torch.ops._kernels import D2_TILE, STAGE_DEPTH

    items = rng.normal(size=(20000, 3000)).astype(np.float32)
    model = NearestNeighbors(k=4).setInputCol("features").fit({"features": items})
    terms = model._serve_dtype_workspace_terms(4096, 4, "bf16")
    assert terms == {"fast_staging_items": 16384 * 3008 * 2, "fast_staging_q": 4096 * 3008 * 2}
    assert terms["fast_staging_items"] == 98_566_144
    assert model._serve_dtype_workspace_terms(8192, 4, "bf16")["fast_staging_q"] == 8192 * 3008 * 2
    assert model._serve_dtype_workspace_terms(300, 4, "bf16")["fast_staging_q"] == \
        -(-300 // D2_TILE["f32-fast"][0]) * D2_TILE["f32-fast"][0] * 3008 * 2
    assert model._serve_dtype_workspace_terms(4096, 4, None) == {}
    assert STAGE_DEPTH == 64
    est = memory.model_serve_estimate(model, 4096, "bf16").terms
    plain = memory.model_serve_estimate(model, 4096).terms
    assert set(est) - set(plain) == {"workspace.fast_staging_items", "workspace.fast_staging_q"}
    small = NearestNeighbors(k=2).setInputCol("features").fit({"features": items[:100, :10]})
    assert small._serve_dtype_workspace_terms(1, 4, "bf16") == {
        "fast_staging_items": 256 * 64 * 2, "fast_staging_q": 128 * 64 * 2}


def test_kmeans_parallel_seeding_subsample_is_priced(rng):
    # the k-means|| seeding (k >= 64) places up to 262,144 rows of the
    # WHOLE dataset, whether or not the fit streams: at 1M x 3000, k = 1000
    # the subsample, its min-d², one [subsample, 2k] distance block and the
    # 6 candidate blocks of 2k rows
    from spark_rapids_ml_tpu_torch.ops.kmeans import _INIT_SAMPLE_CAP, INIT_ROUNDS

    class _Big:
        n_rows, n_cols = 1_000_000, 3000

    est = KMeans(k=1000)
    terms = est._extraction_workspace_terms({}, 32768, _Big, dict(est._solver_params), 4)
    n_sub, l = _INIT_SAMPLE_CAP, 2000
    assert terms == {"init_subsample": n_sub * 3001 * 4 + n_sub * l * 4 + (INIT_ROUNDS + 1) * l * 3000 * 4}
    assert terms["init_subsample"] == 262144 * 3001 * 4 + 262144 * 2000 * 4 + 6 * 2000 * 3000 * 4
    # not for k < 64 (k-means++ on the host), random init, or a warm start
    assert KMeans(k=10)._extraction_workspace_terms({}, 100, _Big, dict(KMeans(k=10)._solver_params), 4) == {}
    rnd = KMeans(k=1000, initMode="random")
    assert rnd._extraction_workspace_terms({}, 100, _Big, dict(rnd._solver_params), 4) == {}
    small = type("S", (), {"n_rows": 5000, "n_cols": 8})
    assert est._extraction_workspace_terms({}, 100, small, dict(est._solver_params), 8) == \
        {"init_subsample": 5000 * 9 * 4 + 5000 * 2000 * 4 + 6 * 2000 * 8 * 4}


def test_streamed_kmeans_admission_charges_the_seeding(rng):
    x = rng.normal(size=(6000, 8))
    ex = extract_dataset({"f": x}, input_col="f", float32_inputs=False)
    est = KMeans(k=64, float32_inputs=False)
    config.update(hbm_budget_bytes=6_000_000, stream_chunk_rows=512)
    dec = memory.admit_fit(est, ex)
    try:
        assert dec.verdict == memory.STREAM
        assert dec.estimate.terms["workspace.init_subsample"] == 6000 * 9 * 4 + 6000 * 128 * 4 + 6 * 128 * 8 * 4
    finally:
        memory.release_admission(dec)


# ------------------------------------------------ fault C7 (the card) -------


@pytest.mark.parametrize("chunk", [2, 32])
def test_segment_sums_add_in_an_order_the_keys_fix(rng, chunk):
    # the k-means|| candidate weights (ops/kmeans.scalable_kmeans_init_device)
    # are summed per candidate in the keys' stable order, chunk by chunk, as
    # a column of EllColumns is: fault C7 was a float index_add_ there, whose
    # sums on the card differed between two runs (phase 14f)
    keys = rng.integers(0, 9, size=500)
    vals = rng.uniform(0.5, 2.0, size=500).astype(np.float32)
    got = tsparse.segment_sums(_t(vals), _t(keys), 10, chunk=chunk).numpy()
    want = np.zeros(10, np.float32)
    for s in range(10):
        level = vals[keys == s]
        while level.size > 1:
            pad = -level.size % chunk
            level = torch.from_numpy(np.concatenate([level, np.zeros(pad, np.float32)]).reshape(-1, chunk)).sum(1).numpy()
        want[s] = level[0] if level.size else 0.0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.bincount(keys, weights=vals, minlength=10), rtol=1e-5)


def test_kmeans_parallel_weights_are_the_fixed_order_sums(rng, monkeypatch):
    from spark_rapids_ml_tpu_torch.ops import distance as tdist
    from spark_rapids_ml_tpu_torch.ops import kmeans as tkm

    x = torch.from_numpy(rng.normal(size=(3000, 6)).astype(np.float32))
    sw = rng.uniform(0.5, 2.0, size=3000).astype(np.float32)
    seen = {}
    real = tkm._kmeanspp_device

    def spy(xc, w, seed, *, k):
        seen["cand"], seen["w"] = xc, w
        return real(xc, w, seed, k=k)

    monkeypatch.setattr(tkm, "_kmeanspp_device", spy)
    tkm.scalable_kmeans_init_device(x, 64, 5, sample_weight=sw)
    assign = tdist.argmin_assign(x, seen["cand"]).long()
    want = torch.clamp_min(tsparse.segment_sums(torch.from_numpy(sw), assign, seen["cand"].shape[0]), 1e-12)
    assert torch.equal(seen["w"], want)
