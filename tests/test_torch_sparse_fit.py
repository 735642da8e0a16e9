#
# The padded-ELL fits of the PyTorch port (ops/linear.py `linear_fit_ell`,
# `linear_fit_ell_batched`; ops/logistic.py `logistic_fit_ell`,
# `logistic_fit_ell_batched`; their streamed forms in ops/streaming.py; the
# estimators, CrossValidator and TrainValidationSplit over CSR data) against
# the JAX package on the same numpy and scipy inputs, after
# tests/test_precision.py, tests/test_oocore.py and tests/test_multifit.py.
# CPU throughout; data from numpy seeds.
#
# Tolerances:
#   * ops in float64: coefficients within rtol 1e-9 of JAX's ELL fit (the
#     same math, the sums in another order: JAX scatters, the port sums per
#     column in fixed chunks and takes the gram from densified row tiles);
#     in float32, 1e-4 of the largest coefficient;
#   * the sparse linear fit equals the dense fit of the same rows (rtol
#     1e-9 in float64): the centering is on the statistics; the sparse
#     logistic fit is held to JAX's ELL fit, not the dense one (its
#     standardization is scale-only);
#   * `fast` (values rounded through bf16 once): tests/test_precision.py's
#     bounds against the full-precision fit;
#   * a batched grid equals its single fits bit for bit; a CV's fold metrics
#     equal the physical weight-column fits bit for bit; streamed = resident
#     rtol 1e-9 in float64 (tests/test_oocore.py's bound);
#   * L1 (OWL-QN) fits converged to tol 1e-10: coefficients within 1e-5 of
#     the largest (the two OWL-QNs part in their last bits near the orthant
#     faces; tests/test_torch_logistic.py holds them to each other).
#
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu.evaluation import MulticlassClassificationEvaluator as JaxMulticlassEvaluator
from spark_rapids_ml_tpu.evaluation import RegressionEvaluator as JaxRegressionEvaluator
from spark_rapids_ml_tpu.linalg import SparseVector as JaxSparseVector
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.models.regression import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu.ops import linear as jlinear
from spark_rapids_ml_tpu.ops import logistic as jlogistic
from spark_rapids_ml_tpu.tuning import CrossValidator as JaxCrossValidator
from spark_rapids_ml_tpu.tuning import TrainValidationSplit as JaxTrainValidationSplit
from spark_rapids_ml_tpu_torch import (
    CrossValidator,
    LinearRegression,
    LogisticRegression,
    MulticlassClassificationEvaluator,
    ParamGridBuilder,
    RegressionEvaluator,
    TrainValidationSplit,
    parallel,
    set_devices,
    telemetry,
)
from spark_rapids_ml_tpu_torch.core import config
from spark_rapids_ml_tpu_torch.linalg import SparseVector
from spark_rapids_ml_tpu_torch.ops import linear as tlinear
from spark_rapids_ml_tpu_torch.ops import logistic as tlogistic
from spark_rapids_ml_tpu_torch.ops import sparse as tsparse
from tests.sparse_gen import random_csr

F64_FIT_RTOL = 1e-9
F32_FIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    # a fresh shared ledger: what another test left resident must not count
    # against these budgets
    from spark_rapids_ml_tpu_torch.scheduler import ledger

    monkeypatch.setattr(ledger, "_GLOBAL", ledger.HbmLedger())
    set_devices("cpu")
    saved = {k: config[k] for k in ("hbm_budget_bytes", "stream_chunk_rows", "solver_precision")}
    yield
    config.update(saved)
    jcore.config.update(hbm_budget_bytes=None, stream_chunk_rows=0)
    set_devices(None)


@pytest.fixture
def tele():
    telemetry.enable()
    telemetry.registry().reset()
    yield telemetry.registry()
    telemetry.disable()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sparse(rng, n=800, d=12, density=0.3, dtype=np.float64):
    """CSR rows with column scales and duplicate cells (the generator draws
    columns with replacement), as host arrays and their ELL form."""
    x = random_csr(rng, n, d, density, dtype=dtype, values="normal")
    x = sp.csr_matrix(x.multiply(np.linspace(0.5, 3.0, d)[None, :]).astype(dtype))
    x.data += 0.3  # an offset on the stored values: the columns have means
    idx, val, _ = tsparse.csr_to_ell(x, dtype=dtype)
    return x, idx, val


def _reg_labels(rng, x, noise=0.05):
    return np.asarray(x @ rng.normal(size=x.shape[1])).ravel() + 0.7 + noise * rng.normal(size=x.shape[0])


# -------------------------------------------------------- linear ops --------


LINEAR_CASES = [
    dict(alpha=0.0, l1_ratio=0.0), dict(alpha=0.01, l1_ratio=0.0),
    dict(alpha=0.01, l1_ratio=0.5, use_cd=True, max_iter=200, tol=1e-12),
]


@pytest.mark.parametrize("case", LINEAR_CASES, ids=["ols", "ridge", "cd"])
@pytest.mark.parametrize("fit_intercept,standardize", [(True, True), (True, False), (False, True)])
def test_linear_fit_ell_equals_jax_and_the_dense_fit(rng, case, fit_intercept, standardize):
    x, idx, val = _sparse(rng)
    y = _reg_labels(rng, x)
    w = rng.uniform(0.5, 2.0, size=x.shape[0])
    kw = dict(case, fit_intercept=fit_intercept, standardize=standardize)
    got = tlinear.linear_fit_ell(_t(val), _t(idx), _t(y), _t(w), d=x.shape[1], tile=97, **kw)
    want = jlinear.linear_fit_ell(val, idx, y, w, d=x.shape[1], **kw)
    np.testing.assert_allclose(got["coef_"].numpy(), np.asarray(want["coef_"]), rtol=F64_FIT_RTOL, atol=1e-12)
    np.testing.assert_allclose(float(got["intercept_"]), float(want["intercept_"]), rtol=F64_FIT_RTOL, atol=1e-12)
    assert int(got["n_iter_"]) == int(want["n_iter_"])
    dense = tlinear.linear_fit(_t(x.toarray()), _t(y), _t(w), **kw)
    np.testing.assert_allclose(got["coef_"].numpy(), dense["coef_"].numpy(), rtol=F64_FIT_RTOL, atol=1e-12)


def test_linear_fit_ell_float32_within_bound(rng):
    x, idx, val = _sparse(rng, dtype=np.float32)
    y = _reg_labels(rng, x).astype(np.float32)
    w = np.ones(x.shape[0], np.float32)
    got = tlinear.linear_fit_ell(_t(val), _t(idx), _t(y), _t(w), d=x.shape[1], alpha=0.001, l1_ratio=0.0)
    want = jlinear.linear_fit_ell(val, idx, y, w, d=x.shape[1], alpha=0.001, l1_ratio=0.0)
    scale = float(np.abs(np.asarray(want["coef_"])).max())
    assert np.abs(got["coef_"].numpy() - np.asarray(want["coef_"])).max() <= F32_FIT_TOL * scale


@pytest.mark.parametrize("use_cd", [False, True])
def test_linear_fit_ell_batched_equals_single_fits_bit_for_bit(rng, use_cd):
    x, idx, val = _sparse(rng)
    y = _reg_labels(rng, x)
    w = np.ones(x.shape[0])
    alphas, l1rs = ([0.01, 0.1, 0.001], [0.5, 0.3, 0.9]) if use_cd else ([0.0, 0.01, 0.5], [0.0, 0.0, 0.0])
    common = dict(d=x.shape[1], use_cd=use_cd, max_iter=100, tol=1e-10)
    grid = tlinear.linear_fit_ell_batched(_t(val), _t(idx), _t(y), _t(w), alphas, l1rs, **common)
    jgrid = jlinear.linear_fit_ell_batched(val, idx, y, w, np.asarray(alphas), np.asarray(l1rs), **common)
    for i, (a, r) in enumerate(zip(alphas, l1rs)):
        one = tlinear.linear_fit_ell(_t(val), _t(idx), _t(y), _t(w), alpha=a, l1_ratio=r, **common)
        assert torch.equal(grid[i]["coef_"], one["coef_"]) and torch.equal(grid[i]["intercept_"], one["intercept_"])
        np.testing.assert_allclose(grid[i]["coef_"].numpy(), np.asarray(jgrid["coef_"])[i], rtol=F64_FIT_RTOL,
                                   atol=1e-12)


def test_linear_ell_bf16_parity(rng):
    # tests/test_precision.py:134: the values rounded through bf16 once, the
    # sums at full precision; the port's fast fit also within JAX's fast
    x = rng.normal(size=(400, 6))
    x = np.where(np.abs(x) > 0.6, x, 0.0)
    y = x @ rng.normal(size=6) - 0.25 + 0.01 * rng.normal(size=400)
    w = np.ones(400)
    idx, val, _ = tsparse.csr_to_ell(sp.csr_matrix(x), dtype=np.float64)
    kw = dict(d=6, alpha=1e-3, l1_ratio=0.0)
    full = tlinear.linear_fit_ell(_t(val), _t(idx), _t(y), _t(w), **kw)
    fast = tlinear.linear_fit_ell(_t(val), _t(idx), _t(y), _t(w), fast=True, **kw)
    assert not torch.equal(fast["coef_"], full["coef_"])
    np.testing.assert_allclose(fast["coef_"].numpy(), full["coef_"].numpy(), rtol=5e-3, atol=5e-4)
    jfast = jlinear.linear_fit_ell(val, idx, y, w, fast=True, **kw)
    np.testing.assert_allclose(fast["coef_"].numpy(), np.asarray(jfast["coef_"]), rtol=F64_FIT_RTOL, atol=1e-12)


# ------------------------------------------------------ logistic ops --------


def _cls_labels(rng, x, k=2):
    s = np.asarray(x @ rng.normal(size=(x.shape[1], max(1, k - 1))))
    if k == 2:
        return (s[:, 0] + 0.3 * rng.normal(size=x.shape[0]) > 0.5).astype(np.int64)
    return np.argmax(np.concatenate([np.zeros((x.shape[0], 1)), s], axis=1), axis=1).astype(np.int64)


@pytest.mark.parametrize("k", [2, 3], ids=["binomial", "multinomial"])
@pytest.mark.parametrize("fit_intercept,standardize", [(True, True), (True, False), (False, True)])
def test_logistic_fit_ell_equals_jax(rng, k, fit_intercept, standardize):
    x, idx, val = _sparse(rng, n=600, d=10)
    y = _cls_labels(rng, x, k)
    w = rng.uniform(0.5, 2.0, size=600)
    kw = dict(d=10, k=k, multinomial=k > 2, lam_l2=0.01, fit_intercept=fit_intercept,
              standardize=standardize, max_iter=60, tol=1e-10)
    got = tlogistic.logistic_fit_ell(_t(val), _t(idx), _t(y), _t(w), **kw)
    want = jlogistic.logistic_fit_ell(val, idx, y.astype(np.int32), w, **kw)
    assert int(got["n_iter_"]) == int(want["n_iter_"])
    np.testing.assert_allclose(got["coef_"].numpy(), np.asarray(want["coef_"]), rtol=F64_FIT_RTOL, atol=1e-10)
    np.testing.assert_allclose(got["intercept_"].numpy(), np.asarray(want["intercept_"]), rtol=F64_FIT_RTOL,
                               atol=1e-10)
    np.testing.assert_allclose(float(got["objective_"]), float(want["objective_"]), rtol=1e-12)


def test_logistic_ell_standardization_is_scale_only(rng):
    # never centered: mu = 0, d_scale from the unbiased column std
    x, idx, val = _sparse(rng, n=300, d=7)
    w = rng.uniform(0.5, 2.0, size=300)
    mu, d_scale, tw = tlogistic._ell_scaling(_t(val), _t(idx), _t(w), 7, True)
    jmu, jscale, jtw = jlogistic._ell_scaling(val, idx, w, 7, True)
    assert not mu.any() and not np.asarray(jmu).any()
    np.testing.assert_allclose(d_scale.numpy(), np.asarray(jscale), rtol=1e-12)
    dense = x.toarray()
    mean = (w @ dense) / w.sum()
    var = (w @ dense ** 2) / w.sum() - mean ** 2
    np.testing.assert_allclose(d_scale.numpy(), 1.0 / np.sqrt(var * w.sum() / (w.sum() - 1.0)), rtol=1e-10)


def test_logistic_fit_ell_l1_converged_like_jax(rng):
    x, idx, val = _sparse(rng, n=600, d=10)
    y = _cls_labels(rng, x)
    w = np.ones(600)
    kw = dict(d=10, k=2, multinomial=False, lam_l2=0.005, lam_l1=0.02, use_l1=True, max_iter=300, tol=1e-12)
    got = tlogistic.logistic_fit_ell(_t(val), _t(idx), _t(y), _t(w), **kw)
    want = jlogistic.logistic_fit_ell(val, idx, y.astype(np.int32), w, **kw)
    coef, jcoef = got["coef_"].numpy(), np.asarray(want["coef_"])
    assert np.abs(coef - jcoef).max() <= 1e-5 * np.abs(jcoef).max()
    np.testing.assert_array_equal(coef == 0, jcoef == 0)  # the same exact zeros
    np.testing.assert_allclose(float(got["objective_"]), float(want["objective_"]), rtol=1e-9)


@pytest.mark.parametrize("use_l1", [False, True], ids=["glm_qn", "owlqn"])
def test_logistic_fit_ell_batched_equals_single_fits_bit_for_bit(rng, use_l1):
    x, idx, val = _sparse(rng, n=500, d=9)
    y = _cls_labels(rng, x)
    w = np.ones(500)
    l2s, l1s = ([0.005, 0.01, 0.1], [0.01, 0.02, 0.005]) if use_l1 else ([1e-4, 0.01, 0.1], [0.0, 0.0, 0.0])
    common = dict(d=9, k=2, multinomial=False, use_l1=use_l1, max_iter=50, tol=1e-9)
    cols = tsparse.EllColumns(_t(val), _t(idx), 9)
    grid = tlogistic.logistic_fit_ell_batched(_t(val), _t(idx), _t(y), _t(w), l2s, l1s, columns=cols, **common)
    for i, (l2, l1) in enumerate(zip(l2s, l1s)):
        one = tlogistic.logistic_fit_ell(_t(val), _t(idx), _t(y), _t(w), lam_l2=l2, lam_l1=l1, **common)
        assert grid[i]["n_iter_"] == one["n_iter_"]
        for key in ("coef_", "intercept_", "objective_"):
            assert torch.equal(grid[i][key], one[key]), key


def test_logistic_ell_bf16_parity(rng):
    # tests/test_precision.py:167
    x = rng.normal(size=(500, 6))
    x = np.where(np.abs(x) > 0.6, x, 0.0)
    y = (x @ rng.normal(size=6) > 0).astype(np.int64)
    w = np.ones(500)
    idx, val, _ = tsparse.csr_to_ell(sp.csr_matrix(x), dtype=np.float64)
    kw = dict(d=6, k=2, multinomial=False, lam_l2=0.01, max_iter=80, tol=1e-9)
    full = tlogistic.logistic_fit_ell(_t(val), _t(idx), _t(y), _t(w), **kw)
    fast = tlogistic.logistic_fit_ell(_t(val), _t(idx), _t(y), _t(w), fast=True, **kw)
    np.testing.assert_allclose(fast["coef_"].numpy(), full["coef_"].numpy(), rtol=5e-2, atol=5e-3)
    jfast = jlogistic.logistic_fit_ell(val, idx, y.astype(np.int32), w, fast=True, **kw)
    np.testing.assert_allclose(fast["coef_"].numpy(), np.asarray(jfast["coef_"]), rtol=1e-8, atol=1e-10)


# ------------------------------------------------------- estimators ---------


def _rows(x, cls=SparseVector):
    return [cls(x.shape[1], r.indices, r.data) for r in x]


@pytest.mark.parametrize("kind", ["dict_csr", "sparse_vectors"])
@pytest.mark.parametrize("params", [{}, {"regParam": 0.01}, {"regParam": 0.01, "elasticNetParam": 0.5},
                                    {"fitIntercept": False, "regParam": 0.01}],
                         ids=["ols", "ridge", "enet", "no_intercept"])
def test_linear_regression_on_csr_equals_jax_and_dense(rng, kind, params):
    x, _, _ = _sparse(rng, n=500, d=8)
    y = _reg_labels(rng, x)
    params = dict(params, float32_inputs=False, tol=1e-12, maxIter=300)
    if kind == "dict_csr":
        data = jdata = {"features": x, "label": y}
    else:
        data = pd.DataFrame({"features": _rows(x), "label": y})
        jdata = pd.DataFrame({"features": _rows(x, JaxSparseVector), "label": y})
    tm = LinearRegression(**params).fit(data)
    jm = JaxLinearRegression(num_workers=1, **params).fit(jdata)
    dm = LinearRegression(**params).fit({"features": x.toarray(), "label": y})
    np.testing.assert_allclose(tm.coef_, jm.coef_, rtol=F64_FIT_RTOL, atol=1e-11)
    np.testing.assert_allclose(tm.coef_, dm.coef_, rtol=F64_FIT_RTOL, atol=1e-11)
    np.testing.assert_allclose(tm.intercept_, jm.intercept_, rtol=F64_FIT_RTOL, atol=1e-11)
    # the transform on CSR input equals the transform of the densified rows
    np.testing.assert_array_equal(tm.transform({"features": x})["prediction"],
                                  tm.transform({"features": x.toarray()})["prediction"])


@pytest.mark.parametrize("kind", ["dict_csr", "sparse_vectors"])
@pytest.mark.parametrize("params", [{}, {"regParam": 0.01, "family": "multinomial"},
                                    {"regParam": 0.02, "standardization": False}],
                         ids=["default", "multinomial", "unstandardized"])
def test_logistic_regression_on_csr_equals_jax(rng, kind, params):
    x, _, _ = _sparse(rng, n=500, d=8)
    y = _cls_labels(rng, x, 3 if params.get("family") == "multinomial" else 2).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=500)
    params = dict(params, float32_inputs=False, maxIter=60, tol=1e-10)
    if kind == "dict_csr":
        data = jdata = {"features": x, "label": y, "w": w}
    else:
        data = pd.DataFrame({"features": _rows(x), "label": y, "w": w})
        jdata = pd.DataFrame({"features": _rows(x, JaxSparseVector), "label": y, "w": w})
    tm = LogisticRegression(**params).setWeightCol("w").fit(data)
    jm = JaxLogisticRegression(num_workers=1, **params).setWeightCol("w").fit(jdata)
    assert tm.n_iter_ == jm.n_iter_
    np.testing.assert_allclose(tm.coef_, jm.coef_, rtol=F64_FIT_RTOL, atol=1e-10)
    np.testing.assert_allclose(tm.intercept_, jm.intercept_, rtol=F64_FIT_RTOL, atol=1e-10)
    out_csr = tm.transform({"features": x})
    out_dense = tm.transform({"features": x.toarray()})
    np.testing.assert_array_equal(np.stack(out_csr["probability"]), np.stack(out_dense["probability"]))
    np.testing.assert_array_equal(out_csr["prediction"], out_dense["prediction"])


def test_sparse_fit_in_float32_within_bound_of_jax(rng):
    x, _, _ = _sparse(rng, n=600, d=10, dtype=np.float32)
    y = _cls_labels(rng, x).astype(np.float32)
    tm = LogisticRegression(regParam=0.01, maxIter=200, tol=1e-6).fit({"features": x, "label": y})
    jm = JaxLogisticRegression(regParam=0.01, maxIter=200, tol=1e-6, num_workers=1).fit({"features": x, "label": y})
    assert np.abs(tm.coef_ - jm.coef_).max() <= 2e-3 * np.abs(jm.coef_).max()  # converged float32 fits
    assert abs(tm.n_iter_ - jm.n_iter_) <= 2


@pytest.mark.parametrize("name", ["linear", "logistic"])
def test_estimator_grid_over_csr_equals_single_fits(rng, name):
    x, _, _ = _sparse(rng, n=400, d=8)
    if name == "linear":
        est, y = LinearRegression(float32_inputs=False), _reg_labels(rng, x)
    else:
        est, y = LogisticRegression(float32_inputs=False, maxIter=40), _cls_labels(rng, x).astype(float)
    data = {"features": x, "label": y}
    maps = [{est.getParam("regParam"): v} for v in (0.0, 0.01, 0.1)]
    grid = est.fit(data, maps)
    for pm, gm in zip(maps, grid):
        one = est.copy(pm).fit(data)
        np.testing.assert_array_equal(gm.coef_, one.coef_)
        np.testing.assert_array_equal(gm.intercept_, one.intercept_)


def test_a_sparse_fit_without_a_card_raises(monkeypatch, rng):
    x, _, _ = _sparse(rng, n=50, d=4)
    parallel.set_devices(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for est in (LinearRegression(), LogisticRegression()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            est.fit({"features": x, "label": (np.arange(50) % 2).astype(float)})


# ---------------------------------------------------------- streamed --------


def _force_stream(est, data):
    """The budget at 60% of the resident working set, so the fit streams."""
    from spark_rapids_ml_tpu_torch import memory

    ex = est._pre_process_data(data)
    need = memory.resident_estimate(est, ex).total()
    config.update(hbm_budget_bytes=int(need * 0.6), stream_chunk_rows=0)


def _assert_streamed(model, reg):
    assert model._fit_metrics["admission"]["verdict"] == "stream"
    assert reg.snapshot()["counters"].get("fit.demotions") == 1


@pytest.mark.parametrize("fast", [False, True])
def test_linear_streaming_matches_resident_ell(tele, rng, fast):
    # tests/test_oocore.py:162
    x, _, _ = _sparse(rng, n=1500, d=20)
    y = _reg_labels(rng, x)
    data = {"features": x, "label": y}
    est = lambda: LinearRegression(regParam=0.001, float32_inputs=False,  # noqa: E731
                                   **({"solver_precision": "bf16"} if fast else {}))
    res = est().fit(data)
    _force_stream(est(), data)
    tele.reset()
    stream = est().fit(data)
    _assert_streamed(stream, tele)
    np.testing.assert_allclose(stream.coef_, res.coef_, rtol=F64_FIT_RTOL)
    np.testing.assert_allclose(stream.intercept_, res.intercept_, rtol=F64_FIT_RTOL)


@pytest.mark.parametrize("standardization", [True, False])
def test_logistic_streaming_matches_resident_ell(tele, rng, standardization):
    # tests/test_oocore.py:179; the scaling streamed too (scale-only)
    x, _, _ = _sparse(rng, n=1500, d=20)
    y = _cls_labels(rng, x).astype(float)
    data = {"features": x, "label": y}
    est = lambda: LogisticRegression(regParam=0.01, float32_inputs=False,  # noqa: E731
                                     standardization=standardization)
    res = est().fit(data)
    _force_stream(est(), data)
    tele.reset()
    stream = est().fit(data)
    _assert_streamed(stream, tele)
    assert stream.n_iter_ == res.n_iter_
    np.testing.assert_allclose(stream.coef_, res.coef_, rtol=F64_FIT_RTOL, atol=1e-12)
    np.testing.assert_allclose(stream.intercept_, res.intercept_, rtol=F64_FIT_RTOL)
    # and JAX's streamed ELL fit under its own budget (8 devices' worth)
    jcore.config.update(hbm_budget_bytes=30_000, stream_chunk_rows=512)
    jm = JaxLogisticRegression(regParam=0.01, float32_inputs=False, standardization=standardization).fit(data)
    np.testing.assert_allclose(stream.coef_, jm.coef_, rtol=1e-8, atol=1e-10)


def test_streamed_glm_converts_once_per_fit(tele, rng):
    x, _, _ = _sparse(rng, n=1500, d=20)
    data = {"features": x, "label": _cls_labels(rng, x).astype(float)}
    _force_stream(LogisticRegression(float32_inputs=False), data)
    tele.reset()
    m = LogisticRegression(float32_inputs=False, maxIter=5).fit(data)
    c = tele.snapshot()["counters"]
    chunks = -(-1500 // m._fit_metrics["admission"]["chunk_rows"])
    assert c["sparse.csr_to_ell_calls"] == chunks  # each chunk once, whatever the passes
    assert c["ingest.stream_chunks"] > chunks


# ------------------------------------------------------------ tuning --------


def _sparse_df(rng, n, y):
    x = np.where(np.abs(rng.normal(size=(n, 5))) > 0.5, rng.normal(size=(n, 5)), 0.0)
    rows = [SparseVector(5, np.nonzero(r)[0].astype(np.int32), r[np.nonzero(r)[0]]) for r in x]
    return x, pd.DataFrame({"features": rows, "label": y(x)})


def _fold_bit_identity_check(df, est, eva, reg_grid):
    """tests/test_multifit.py:155-190's csr cases: the engine's
    weight-masked fold fits equal the same split written as a weight column
    and fitted through fitMultiple with its own ingest, bit for bit."""
    grid = ParamGridBuilder().addGrid(est.getParam("regParam"), reg_grid).build()
    cv = CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, numFolds=2, seed=5)
    engine_avg = np.asarray(cv.fit(df).avgMetrics)
    n = len(df)
    folds = cv._kfold_indices(n, df)
    feats_full = est._pre_process_data(df, for_fit=False).features
    assert sp.issparse(feats_full)
    labels = df["label"].to_numpy(dtype=np.float64)
    baseline = np.zeros((2, len(grid)))
    for f, (train_idx, valid_idx) in enumerate(folds):
        mask = np.zeros(n)
        mask[train_idx] = 1.0
        df_w = df.copy()
        df_w["w_"] = mask
        est_w = est.copy()._set_params(weightCol="w_")
        models = [m for _, m in sorted(est_w.fitMultiple(df_w, grid), key=lambda im: im[0])]
        baseline[f] = models[0]._combine(models)._transform_evaluate_arrays(
            feats_full[valid_idx], labels[valid_idx], eva)
    np.testing.assert_array_equal(engine_avg, baseline.mean(axis=0))
    return engine_avg, grid


def test_cv_fold_metrics_bit_identical_logistic_csr(rng):
    _, df = _sparse_df(rng, 180, lambda x: (x @ np.arange(1.0, 6.0) > 0).astype(float))
    est = LogisticRegression(maxIter=40, float32_inputs=False, enable_sparse_data_optim=True)
    eva = MulticlassClassificationEvaluator(metricName="accuracy")
    avg, grid = _fold_bit_identity_check(df, est.setFeaturesCol("features"), eva, [0.01, 0.1])
    jdf = pd.DataFrame({"features": [JaxSparseVector(5, v.indices, v.values) for v in df["features"]],
                        "label": df["label"]})
    jest = JaxLogisticRegression(maxIter=40, float32_inputs=False, enable_sparse_data_optim=True, num_workers=1)
    jgrid = [{jest.getParam("regParam"): v} for v in (0.01, 0.1)]
    jcv = JaxCrossValidator(estimator=jest, estimatorParamMaps=jgrid,
                            evaluator=JaxMulticlassEvaluator(metricName="accuracy"), numFolds=2, seed=5)
    np.testing.assert_array_equal(avg, jcv.fit(jdf).avgMetrics)


def test_cv_fold_metrics_bit_identical_linear_csr(rng):
    _, df = _sparse_df(rng, 180, lambda x: x @ np.array([1.0, -2.0, 0.0, 0.0, 3.0]) + 0.5
                       + 0.2 * np.random.default_rng(3).normal(size=len(x)))
    est = LinearRegression(float32_inputs=False, enable_sparse_data_optim=True).setFeaturesCol("features")
    avg, _ = _fold_bit_identity_check(df, est, RegressionEvaluator(metricName="rmse"), [0.0, 0.1])
    jdf = pd.DataFrame({"features": [JaxSparseVector(5, v.indices, v.values) for v in df["features"]],
                        "label": df["label"]})
    jest = JaxLinearRegression(float32_inputs=False, enable_sparse_data_optim=True, num_workers=1)
    jgrid = [{jest.getParam("regParam"): v} for v in (0.0, 0.1)]
    jcv = JaxCrossValidator(estimator=jest, estimatorParamMaps=jgrid,
                            evaluator=JaxRegressionEvaluator(metricName="rmse"), numFolds=2, seed=5)
    np.testing.assert_allclose(avg, jcv.fit(jdf).avgMetrics, rtol=1e-9)


@pytest.mark.parametrize("tuner", ["cv", "tvs"])
def test_sparse_tuning_converts_and_places_ell_once(tele, rng, tuner):
    # tests/test_multifit.py:240: one ingest, one conversion, one placement
    # for every fold and map (FitInputs.ell_rows is kept per placement)
    x, _, _ = _sparse(rng, n=120, d=6)
    data = {"features": x, "label": _cls_labels(rng, x).astype(float)}
    lr = LogisticRegression(maxIter=10, float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1]).build()
    eva = MulticlassClassificationEvaluator(metricName="accuracy")
    tele.reset()  # `_sparse` converted once for the ops tests' ELL arrays
    if tuner == "cv":
        m = CrossValidator(estimator=lr, estimatorParamMaps=grid, evaluator=eva, numFolds=2, seed=2).fit(data)
    else:
        m = TrainValidationSplit(estimator=lr, estimatorParamMaps=grid, evaluator=eva, seed=2).fit(data)
    c = tele.snapshot()["counters"]
    assert c["ingest.datasets"] == 1
    assert c["sparse.csr_to_ell_calls"] == 1
    assert c["fit.device_dataset_builds"] == 1
    jlr = JaxLogisticRegression(maxIter=10, float32_inputs=False, num_workers=1).setFeaturesCol("features")
    jgrid = [{jlr.getParam("regParam"): v} for v in (0.0, 0.1)]
    jeva = JaxMulticlassEvaluator(metricName="accuracy")
    if tuner == "cv":
        jm = JaxCrossValidator(estimator=jlr, estimatorParamMaps=jgrid, evaluator=jeva, numFolds=2, seed=2)
        np.testing.assert_array_equal(m.avgMetrics, jm.fit(data).avgMetrics)
    else:
        jm = JaxTrainValidationSplit(estimator=jlr, estimatorParamMaps=jgrid, evaluator=jeva, seed=2)
        np.testing.assert_array_equal(m.validationMetrics, jm.fit(data).validationMetrics)
