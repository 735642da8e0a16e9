#
# The PyTorch port's LinearRegression slice (spark_rapids_ml_tpu_torch/
# ops/linear.py, models/regression.py, the label plumbing of data.py and
# core.py, the new param mixins, convert.py, and the serving of PCA and
# LinearRegression models) against the JAX package's on the same inputs,
# made with numpy from a seed. The port runs on the CPU (set_devices("cpu"));
# the JAX side on its CPU devices. No Pallas kernel is on this path in the
# JAX package.
#
# Tolerances, and why:
#   * float32 statistics: rtol 1e-5 of the largest entry (the same float32
#     sums in another order: the port sums the gram over row tiles);
#     float64 rtol 1e-12;
#   * coefficients, intercept and RSS: the solve amplifies the statistics'
#     error by the gram's condition number; the data here (6 features, one
#     pair correlated at 0.9) keep it below 100, so float32 rtol 1e-4 of the
#     largest coefficient and float64 1e-10. The RSS is a difference of
#     large sums (syy - 2 bᵀc + bᵀGb), so it is held to the same rtol of
#     syy, the largest term in it;
#   * coordinate descent: the same sweeps on both sides, so n_iter_ equal
#     and the coefficients at the solve's tolerance. Its stopping tol is
#     1e-5 in float32 and 1e-9 in float64, far above the rounding floor of
#     a sweep's largest change (an ulp of a coefficient near 1: 1.2e-7 in
#     float32): a tol at that floor stops on rounding noise, which differs
#     with the summation order, not on convergence;
#   * predictions: rtol 1e-5 (float32) of the largest |prediction|;
#   * degenerate data: NaN where JAX gives NaN, exactly 0 where it gives 0;
#   * `fast` (bf16 products, float32 sums): the JAX package's own bounds
#     (tests/test_precision.py::test_linear_dense_bf16_parity: coefficients
#     rtol 5e-3, atol 5e-4; intercept atol 5e-3);
#   * serving: a coalesced response equals the same request served alone
#     bit for bit, and equals transform bit for bit.
#
import os
import threading

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu import params as jparams
from spark_rapids_ml_tpu.models.regression import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu.models.regression import LinearRegressionModel as JaxLinearRegressionModel
from spark_rapids_ml_tpu.ops import linear as jlinear
from spark_rapids_ml_tpu_torch import (
    PCA,
    LinearRegression,
    LinearRegressionModel,
    ModelRegistry,
    ScoringEngine,
    Vectors,
    params as tparams,
    set_devices,
)
from spark_rapids_ml_tpu_torch.convert import linear_regression_model_from_jax
from spark_rapids_ml_tpu_torch.core import config
from spark_rapids_ml_tpu_torch.data import extract_dataset
from spark_rapids_ml_tpu_torch.ops import linear as tlinear

F32_RTOL, F64_RTOL = 1e-5, 1e-12
F32_SOLVE, F64_SOLVE = 1e-4, 1e-10


@pytest.fixture(autouse=True)
def port_on_cpu():
    set_devices("cpu")
    yield
    set_devices(None)


def _data(n=500, seed=0, dtype=np.float32, noise=0.05):
    """6 features of different scales and offsets (columns 0 and 1
    correlated at 0.9), y = X·β + 0.7 + noise."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 6))
    z[:, 1] = 0.9 * z[:, 0] + np.sqrt(1 - 0.81) * z[:, 1]
    x = z * np.array([1.0, 2.0, 0.5, 3.0, 1.5, 0.8]) + np.array([1.0, -2.0, 0.0, 0.5, 3.0, -1.0])
    beta = rng.normal(size=6)
    y = x @ beta + 0.7 + noise * rng.normal(size=n)
    return x.astype(dtype), y.astype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol, scale=None):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * scale, (err, rtol * scale)


def _tol(dtype):
    return (F32_RTOL, F32_SOLVE) if dtype == np.float32 else (F64_RTOL, F64_SOLVE)


# ------------------------------------------------- sufficient statistics ----


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("tile_rows", [64, 1 << 20])
def test_sufficient_stats_match_jax(dtype, fast, tile_rows, monkeypatch):
    from spark_rapids_ml_tpu_torch.ops import linalg as tlinalg

    monkeypatch.setattr(tlinalg, "STATS_TILE_ROWS", tile_rows)
    x, y = _data(dtype=dtype, seed=1)
    w = np.random.default_rng(2).uniform(0.5, 2.0, size=len(x)).astype(dtype)
    w[::9] = 0.0
    got = tlinear._sufficient_stats(_t(x), _t(y), _t(w), fast)
    want = jlinear._sufficient_stats(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), fast)
    rtol = F32_RTOL if fast else _tol(dtype)[0]
    for name, g, j in zip(("sw", "sx", "sy", "G", "c", "syy"), got, want):
        assert g.dtype == _t(x).dtype, name
        _close(g.numpy(), np.asarray(j), rtol)


# ---------------------------------------------------------------- solves ----


_SOLVES = [
    pytest.param(dict(alpha=0.0, l1_ratio=0.0, use_cd=False), id="ols"),
    pytest.param(dict(alpha=0.1, l1_ratio=0.0, use_cd=False), id="ridge"),
    pytest.param(dict(alpha=0.05, l1_ratio=0.3, use_cd=True), id="cd-0.3"),
    pytest.param(dict(alpha=0.05, l1_ratio=0.5, use_cd=True), id="cd-0.5"),
    pytest.param(dict(alpha=0.02, l1_ratio=1.0, use_cd=True), id="lasso"),
]


@pytest.mark.parametrize("solve", _SOLVES)
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_solve_from_stats_matches_jax(solve, fit_intercept, standardize, dtype):
    x, y = _data(dtype=dtype, seed=3)
    w = np.ones(len(x), dtype)
    stats = jlinear._sufficient_stats(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    tol = 1e-5 if dtype == np.float32 else 1e-9
    kw = dict(solve, fit_intercept=fit_intercept, standardize=standardize, max_iter=200, tol=tol)
    want = jlinear._solve_from_stats(stats, x.dtype, **kw)
    got = tlinear._solve_from_stats(tuple(_t(np.asarray(s)) for s in stats), _t(x).dtype, **kw)
    stat_rtol, rtol = _tol(dtype)
    coef_scale = float(np.abs(np.asarray(want["coef_"])).max())
    _close(got["coef_"].numpy(), np.asarray(want["coef_"]), rtol, coef_scale)
    _close(got["intercept_"].numpy(), np.asarray(want["intercept_"]), rtol,
           max(coef_scale, abs(float(want["intercept_"]))))
    assert int(got["n_iter_"]) == int(want["n_iter_"])
    _close(got["rss_"].numpy(), np.asarray(want["rss_"]), rtol, float(np.asarray(stats[5])))
    _close(got["sw_"].numpy(), np.asarray(want["sw_"]), stat_rtol)
    if not fit_intercept:
        assert float(got["intercept_"]) == 0.0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_linear_fit_matches_jax(dtype, fast, weighted):
    x, y = _data(dtype=dtype, seed=4)
    w = (np.random.default_rng(5).uniform(0.2, 3.0, size=len(x)) if weighted else np.ones(len(x))).astype(dtype)
    kw = dict(alpha=1e-3, l1_ratio=0.0)
    got = tlinear.linear_fit(_t(x), _t(y), _t(w), fast=fast, **kw)
    want = jlinear.linear_fit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), fast=fast, **kw)
    rtol = F32_SOLVE if (fast or dtype == np.float32) else F64_SOLVE
    _close(got["coef_"].numpy(), np.asarray(want["coef_"]), rtol)
    coef_scale = float(np.abs(np.asarray(want["coef_"])).max())
    _close(got["intercept_"].numpy(), np.asarray(want["intercept_"]), rtol, coef_scale)


def test_cd_max_iter_bounds_the_sweeps():
    # tol below any change: every sweep runs, as BASELINE.md's
    # {regParam=1e-5, elasticNetParam=0.5, tol=1e-30, maxIter=10} does
    x, y = _data(seed=6)
    w = np.ones(len(x), np.float32)
    kw = dict(alpha=1e-5, l1_ratio=0.5, use_cd=True, max_iter=10, tol=1e-30)
    got = tlinear.linear_fit(_t(x), _t(y), _t(w), **kw)
    want = jlinear.linear_fit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), **kw)
    assert int(got["n_iter_"]) == int(want["n_iter_"]) == 10
    _close(got["coef_"].numpy(), np.asarray(want["coef_"]), F32_SOLVE)
    zero = tlinear.linear_fit(_t(x), _t(y), _t(w), **dict(kw, max_iter=0))
    assert int(zero["n_iter_"]) == 0 and not zero["coef_"].any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_linear_predict_matches_jax(dtype):
    x, _ = _data(dtype=dtype, seed=7)
    coef = np.random.default_rng(8).normal(size=6).astype(dtype)
    b = np.asarray(-1.25, dtype)
    got = tlinear.linear_predict(_t(x), _t(coef), _t(b)).numpy()
    want = np.asarray(jlinear.linear_predict(jnp.asarray(x), jnp.asarray(coef), jnp.asarray(b)))
    _close(got, want, _tol(dtype)[0])


def test_linear_fast_parity_bounds():
    # tests/test_precision.py::test_linear_dense_bf16_parity, on the port
    rng = np.random.default_rng(42)
    x = rng.normal(size=(500, 8))
    y = x @ rng.normal(size=8) + 0.5 + 0.01 * rng.normal(size=500)
    w = np.ones(500)
    kw = dict(alpha=1e-3, l1_ratio=0.0)
    full = tlinear.linear_fit(_t(x), _t(y), _t(w), **kw)
    fast = tlinear.linear_fit(_t(x), _t(y), _t(w), fast=True, **kw)
    assert not torch.equal(fast["coef_"], full["coef_"])
    np.testing.assert_allclose(fast["coef_"].numpy(), full["coef_"].numpy(), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(float(fast["intercept_"]), float(full["intercept_"]), atol=5e-3)


# ------------------------------------------------------ degenerate data ----


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_all_constant_features_give_nan_coefficients_as_jax(dtype):
    # standardized, no penalty: Gs = 0 and the jitter 1e-10·trace/d = 0, so
    # the system is 0·b = 0; jnp.linalg.solve gives NaN, and so must the
    # port (torch.linalg.solve would raise)
    n = 50
    x = np.tile(np.array([1.0, -2.0, 3.5], dtype), (n, 1))
    y = np.random.default_rng(9).normal(size=n).astype(dtype)
    data = {"features": x, "label": y}
    f32 = dtype == np.float32
    tm = LinearRegression(float32_inputs=f32).fit(data)
    jm = JaxLinearRegression(num_workers=1, float32_inputs=f32).fit(data)
    assert np.isnan(jm.coef_).all() and np.isnan(jm.intercept_)
    assert np.isnan(tm.coef_).all() and np.isnan(tm.intercept_)
    assert np.isnan(np.asarray(tm.transform(data)["prediction"])).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("params", [{}, {"regParam": 0.1}, {"regParam": 0.05, "elasticNetParam": 0.5}])
def test_one_constant_column_gets_coefficient_zero_as_jax(dtype, params):
    x, y = _data(dtype=dtype, seed=10)
    x[:, 2] = 4.0  # d_scale = 0 for this column
    data = {"features": x, "label": y}
    f32 = dtype == np.float32
    tm = LinearRegression(float32_inputs=f32, **params).fit(data)
    jm = JaxLinearRegression(num_workers=1, float32_inputs=f32, **params).fit(data)
    assert jm.coef_[2] == 0.0 and tm.coef_[2] == 0.0
    _close(tm.coef_, jm.coef_, _tol(dtype)[1])


# --------------------------------------------- the estimator, the model ----


def _fit_both(data, **kw):
    return LinearRegression(**kw).fit(data), JaxLinearRegression(num_workers=1, **kw).fit(data)


def _pred(model, data, name="prediction"):
    return np.asarray(model.transform(data)[name], dtype=np.float64)


@pytest.mark.parametrize("kind", ["dict", "pandas", "vector", "multi_cols"])
@pytest.mark.parametrize("params", [
    {}, {"regParam": 0.1}, {"regParam": 0.05, "elasticNetParam": 0.5, "maxIter": 50, "tol": 1e-8},
    {"regParam": 0.02, "standardization": False}, {"fitIntercept": False, "regParam": 0.01},
])
def test_estimator_matches_jax_through_the_public_api(kind, params):
    x, y = _data(seed=11)
    w = np.random.default_rng(12).uniform(0.5, 2.0, size=len(x)).astype(np.float32)
    if kind == "dict":
        port_data = jax_data = {"features": x, "label": y, "w": w}
    elif kind == "pandas":
        port_data = jax_data = pd.DataFrame({"features": list(x), "label": y, "w": w})
    elif kind == "vector":
        from spark_rapids_ml_tpu.linalg import Vectors as JaxVectors

        port_data = pd.DataFrame({"features": [Vectors.dense(v) for v in x], "label": y, "w": w})
        jax_data = pd.DataFrame({"features": [JaxVectors.dense(v) for v in x], "label": y, "w": w})
    else:
        port_data = jax_data = pd.DataFrame({**{f"c{i}": x[:, i] for i in range(6)}, "label": y, "w": w})
    est = LinearRegression(**params).setWeightCol("w")
    jest = JaxLinearRegression(num_workers=1, **params).setWeightCol("w")
    if kind == "multi_cols":
        est.setFeaturesCol([f"c{i}" for i in range(6)])
        jest.setFeaturesCol([f"c{i}" for i in range(6)])
    tm, jm = est.fit(port_data), jest.fit(jax_data)
    scale = float(np.abs(jm.coef_).max())
    _close(tm.coef_, jm.coef_, F32_SOLVE)
    _close(tm.intercept_, jm.intercept_, F32_SOLVE, max(scale, abs(jm.intercept_)))
    assert tm.n_iter_ == jm.n_iter_ and tm.numFeatures == jm.numFeatures == 6
    assert tm.dtype == jm.dtype == "float32"
    _close(_pred(tm, port_data), _pred(jm, jax_data), F32_SOLVE)


def test_weights_change_the_fit():
    x, y = _data(seed=13)
    y[:50] += 20.0  # the first rows disagree with the rest
    w = np.ones(len(x), np.float32)
    w[:50] = 0.0
    weighted = LinearRegression().setWeightCol("w").fit({"features": x, "label": y, "w": w})
    dropped = LinearRegression().fit({"features": x[50:], "label": y[50:]})
    _close(weighted.coef_, dropped.coef_, F32_SOLVE)
    plain = LinearRegression().fit({"features": x, "label": y})
    assert np.abs(plain.intercept_ - weighted.intercept_) > 1.0


def test_linear_regression_standardizes_by_default():
    est = LinearRegression()
    assert est.getStandardization() is True and est.solver_params["normalize"] is True
    assert JaxLinearRegression().solver_params == est.solver_params
    # standardization changes a penalized fit, and the default is the
    # standardized one, in both packages
    x, y = _data(seed=14)
    data = {"features": x, "label": y}
    default, jdefault = _fit_both(data, regParam=0.5)
    std, _ = _fit_both(data, regParam=0.5, standardization=True)
    raw, jraw = _fit_both(data, regParam=0.5, standardization=False)
    np.testing.assert_array_equal(default.coef_, std.coef_)
    assert np.abs(default.coef_ - raw.coef_).max() > 1e-2
    _close(default.coef_, jdefault.coef_, F32_SOLVE)
    _close(raw.coef_, jraw.coef_, F32_SOLVE)


def test_params_mirror_the_jax_estimator():
    kw = dict(regParam=0.3, elasticNetParam=0.2, maxIter=7, tol=1e-5, fitIntercept=False,
              standardization=False, solver="normal", loss="squaredError")
    assert LinearRegression(**kw).solver_params == JaxLinearRegression(**kw).solver_params
    assert LinearRegression(solver="auto").solver_params["solver"] == "eig"
    with pytest.raises(ValueError, match="not supported by the solver"):
        LinearRegression(loss="huber")
    with pytest.raises(ValueError, match="not supported by the solver"):
        LinearRegression(solver="l-bfgs")
    with pytest.raises(TypeError, match="Boolean"):
        LinearRegression(fitIntercept=1)
    est = LinearRegression().setLabelCol("y").setPredictionCol("p").setRegParam(0.1).setElasticNetParam(0.5)
    assert est.getLabelCol() == "y" and est.getRegParam() == 0.1 and est.getElasticNetParam() == 0.5
    assert est.solver_params["alpha"] == 0.1 and est.solver_params["l1_ratio"] == 0.5


@pytest.mark.parametrize(
    "name,default",
    [("outputCol", None), ("regParam", 0.0), ("elasticNetParam", 0.0), ("fitIntercept", True),
     ("standardization", True)],
)
def test_new_param_mixins_mirror_jax(name, default):
    mixin = {"outputCol": "HasOutputCol", "regParam": "HasRegParam", "elasticNetParam": "HasElasticNetParam",
             "fitIntercept": "HasFitIntercept", "standardization": "HasStandardization"}[name]
    port, jax_ = getattr(tparams, mixin)(), getattr(jparams, mixin)()
    assert port.hasParam(name) and jax_.hasParam(name)
    assert port.hasDefault(name) == jax_.hasDefault(name) == (default is not None)
    if default is not None:
        assert port.getOrDefault(name) == jax_.getOrDefault(name) == default


def test_model_surface_and_single_vector_predict():
    x, y = _data(seed=15)
    tm = LinearRegression(regParam=0.01).setPredictionCol("p").fit({"features": x, "label": y})
    assert tm.coefficients.toArray().tolist() == tm.coef_.tolist()
    assert tm.intercept == tm.intercept_ and tm.scale == 1.0 and not tm.hasSummary
    out = np.asarray(tm.transform({"features": x})["p"])
    assert [tm.predict(v) for v in x[:10]] == pytest.approx(list(out[:10]), rel=1e-5)
    assert tm.predict(Vectors.dense(x[0])) == pytest.approx(float(out[0]), rel=1e-5)


@pytest.mark.parametrize("call,item", [
    (lambda m: m.evaluate({"features": np.zeros((1, 6), np.float32)}), "A16"),
    (lambda m: m.cpu(), "A16"),
])
def test_left_out_surface_names_its_roadmap_item(call, item):
    x, y = _data(seed=16)
    tm = LinearRegression().fit({"features": x, "label": y})
    with pytest.raises(NotImplementedError, match=item):
        call(tm)


@pytest.mark.parametrize("entry", ["arrays", "dataset"])
def test_combine_and_transform_evaluate_score_like_jax(entry):
    # the fused CV path: the JAX models packed by `_combine` and scored by
    # `_transform_evaluate(_arrays)` in both packages give the same metrics
    # (the same float64 numpy products: exactly equal); the port's packed
    # coefficients are the stack of its models'
    from spark_rapids_ml_tpu.evaluation import RegressionEvaluator as JaxRegressionEvaluator
    from spark_rapids_ml_tpu_torch import RegressionEvaluator

    x, y = _data(seed=16, dtype=np.float64)
    data = {"features": x, "label": y}
    jms = [JaxLinearRegression(num_workers=1, float32_inputs=False, regParam=r).fit(data) for r in (0.0, 0.1, 1.0)]
    tms = [linear_regression_model_from_jax(dict(m._model_attributes)) for m in jms]
    tc, jc = tms[0]._combine(tms), jms[0]._combine(jms)
    np.testing.assert_array_equal(tc.coef_, np.stack([m.coef_ for m in tms]))
    np.testing.assert_array_equal(tc._intercepts, jc._intercepts)
    for metric in ("rmse", "mse", "r2", "mae", "var"):
        tev, jev = RegressionEvaluator(metricName=metric), JaxRegressionEvaluator(metricName=metric)
        if entry == "arrays":
            got, want = tc._transform_evaluate_arrays(x[:200], y[:200], tev), jc._transform_evaluate_arrays(x[:200], y[:200], jev)
            # and from rows on the device: float64 products there, rtol 1e-12
            np.testing.assert_allclose(tc._transform_evaluate_arrays(torch.from_numpy(x[:200]), y[:200], tev), want, rtol=1e-12)
        else:
            got, want = tc._transform_evaluate(data, tev), jc._transform_evaluate(data, jev)
        np.testing.assert_array_equal(got, want)


def test_fast_estimator_matches_jax_fast():
    # the data of test_precision.py's parity test (zero-mean features),
    # through the public API
    rng = np.random.default_rng(17)
    x = rng.normal(size=(500, 8)).astype(np.float32)
    y = (x @ rng.normal(size=8) + 0.5 + 0.01 * rng.normal(size=500)).astype(np.float32)
    data = {"features": x, "label": y}
    tm, jm = _fit_both(data, regParam=1e-3, solver_precision="bf16")
    full = LinearRegression(regParam=1e-3).fit(data)
    _close(tm.coef_, jm.coef_, F32_SOLVE)
    np.testing.assert_allclose(tm.coef_, full.coef_, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(tm.intercept_, full.intercept_, atol=5e-3)


# ------------------------------------------------------- persistence ----


@pytest.mark.parametrize("float32_inputs", [True, False])
def test_jax_saved_model_loads_and_predicts_the_same(tmp_path, float32_inputs):
    dtype = np.float32 if float32_inputs else np.float64
    x, y = _data(seed=18, dtype=dtype)
    jm = JaxLinearRegression(num_workers=1, regParam=0.01, float32_inputs=float32_inputs) \
        .setPredictionCol("p").fit({"features": x, "label": y})
    path = str(tmp_path / "jax_linreg")
    jm.write().overwrite().save(path)
    tm = LinearRegressionModel.load(path)
    np.testing.assert_array_equal(tm.coef_, jm.coef_)
    assert tm.intercept_ == jm.intercept_ and tm.n_iter_ == jm.n_iter_
    assert tm.float32_inputs == float32_inputs and tm.getOrDefault("predictionCol") == "p"
    want = _pred(jm, {"features": x}, "p")
    rtol = _tol(dtype)[0]
    _close(_pred(tm, {"features": x}, "p"), want, rtol)
    conv = linear_regression_model_from_jax(jm._model_attributes)
    assert conv.float32_inputs == float32_inputs
    _close(_pred(conv, {"features": x}), want, rtol)


def test_port_saved_model_loads_in_jax_and_back(tmp_path):
    x, y = _data(seed=19)
    tm = LinearRegression(regParam=0.05, elasticNetParam=0.5).fit({"features": x, "label": y})
    path = str(tmp_path / "port_linreg")
    tm.write().overwrite().save(path)
    assert sorted(os.listdir(path)) == ["arrays.npz", "attributes.json", "metadata.json"]
    jm = JaxLinearRegressionModel.load(path)
    back = LinearRegressionModel.load(path)
    want = _pred(tm, {"features": x})
    np.testing.assert_array_equal(_pred(back, {"features": x}), want)
    _close(_pred(jm, {"features": x}), want, F32_RTOL)
    assert back.uid == tm.uid and back.n_iter_ == tm.n_iter_ and back.getRegParam() == 0.05


def test_convert_refuses_incomplete_attributes():
    with pytest.raises(ValueError, match="lack"):
        linear_regression_model_from_jax({"coef_": np.zeros(3)})
    with pytest.raises(ValueError, match="coef_ must be 1-D"):
        linear_regression_model_from_jax(
            {"coef_": np.zeros((2, 3)), "intercept_": 0.0, "n_iter_": 1, "n_cols": 3, "dtype": "float32"}
        )


# --------------------------------------------------- the label plumbing ----


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_extract_dataset_label_on_pandas_and_dict(dtype):
    x, y = _data(n=20, seed=20)
    f32 = dtype == np.float32
    for data in ({"features": x, "label": list(y)}, pd.DataFrame({"features": list(x), "label": y})):
        e = extract_dataset(data, input_col="features", label_col="label", float32_inputs=f32)
        assert e.label.dtype == dtype and e.label.flags.c_contiguous and e.label.shape == (20,)
        np.testing.assert_array_equal(e.label, y.astype(dtype))
    strided = {"features": x, "label": np.repeat(y, 2)[::2]}
    e = extract_dataset(strided, input_col="features", label_col="label")
    assert e.label.flags.c_contiguous


@pytest.mark.parametrize("data", [
    {"features": np.zeros((3, 2), np.float32)},
    pd.DataFrame({"features": [np.zeros(2)] * 3}),
])
def test_extract_dataset_missing_label_raises(data):
    with pytest.raises(ValueError, match="'label' not in dataset"):
        extract_dataset(data, input_col="features", label_col="label")
    with pytest.raises(ValueError, match="not in dataset"):
        LinearRegression().fit(data)


def test_fit_inputs_carry_the_labels():
    x, y = _data(n=30, seed=21)
    est = LinearRegression()
    extracted = est._pre_process_data({"features": x, "label": y})
    inputs = est._build_fit_inputs(extracted, torch.device("cpu"))
    assert inputs.y.dtype == inputs.X.dtype == torch.float32 and inputs.y.shape == (30,)
    np.testing.assert_array_equal(inputs.y.numpy(), y)
    pca = PCA(k=1).setInputCol("features")
    assert pca._build_fit_inputs(pca._pre_process_data({"features": x, "label": y}), torch.device("cpu")).y is None


@pytest.mark.parametrize("kind", ["vector", "array", "multi_cols"])
def test_split_output_turns_a_2d_result_into_a_vector_column(kind):
    x, _ = _data(n=12, seed=22)
    if kind == "vector":
        data = pd.DataFrame({"features": [Vectors.dense(v) for v in x]})
        est = PCA(k=2).setInputCol("features")
    elif kind == "array":
        data = {"features": x}
        est = PCA(k=2).setInputCol("features")
    else:
        data = pd.DataFrame({f"c{i}": x[:, i] for i in range(6)})
        est = PCA(k=2).setInputCols([f"c{i}" for i in range(6)])
    model = est.setOutputCol("o").fit(data)
    extracted = model._pre_process_data(data, for_fit=False)
    result = np.arange(24, dtype=np.float32).reshape(12, 2)
    col = model._split_output(result, ["o"], extracted)["o"]
    assert len(col) == 12
    cells = [c.toArray() if kind == "vector" else c for c in col]
    assert all(type(c).__name__ == ("DenseVector" if kind == "vector" else "ndarray") for c in col)
    np.testing.assert_array_equal(np.stack(cells), result)
    one_d = model._split_output(result[:, 0], ["o"], extracted)["o"]
    np.testing.assert_array_equal(one_d, result[:, 0])


# ----------------------------------------------------------- serving ----


_SERVE_KEYS = ("transform_bucket_min_rows", "serve_prewarm_rows", "serve_max_batch_rows", "serve_coalesce_window_ms")


@pytest.fixture
def small_ladder():
    saved = {k: config[k] for k in _SERVE_KEYS}
    config.update({"transform_bucket_min_rows": 8, "serve_prewarm_rows": 64, "serve_max_batch_rows": 256,
                   "serve_coalesce_window_ms": 25.0})
    yield
    config.update(saved)


@pytest.mark.parametrize("float32_inputs", [True, False])
def test_pca_and_linear_serving_coalesced_equals_solo_and_transform(small_ladder, float32_inputs):
    dtype = np.float32 if float32_inputs else np.float64
    x, y = _data(n=600, seed=23, dtype=dtype)
    data = {"features": x, "label": y}
    pca = PCA(k=3, float32_inputs=float32_inputs).setInputCol("features").setOutputCol("o").fit(data)
    ols = LinearRegression(float32_inputs=float32_inputs).fit(data)
    registry = ModelRegistry()
    registry.load("pca", pca)
    registry.load("ols", ols)
    requests = [(lo, n) for lo, n in ((0, 1), (3, 7), (10, 64), (80, 200), (300, 255), (7, 33))]
    with ScoringEngine(registry, coalesce_window_s=0.0) as engine:
        solo = {name: [engine.score(name, x[lo:lo + n]) for lo, n in requests] for name in ("pca", "ols")}
    with ScoringEngine(registry) as engine:
        futs = {name: [None] * len(requests) for name in ("pca", "ols")}

        def submit(name, i):
            lo, n = requests[i]
            futs[name][i] = engine.submit(name, x[lo:lo + n])

        ts = [threading.Thread(target=submit, args=(name, i)) for name in futs for i in range(len(requests))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        coalesced = {name: [f.result(timeout=120) for f in fs] for name, fs in futs.items()}
    pca_all = np.stack(pca.transform(data)["o"].to_numpy())
    ols_all = np.asarray(ols.transform(data)["prediction"])
    for i, (lo, n) in enumerate(requests):
        for name, whole in (("pca", pca_all), ("ols", ols_all)):
            got = coalesced[name][i]
            assert got.dtype == dtype and got.shape[0] == n
            np.testing.assert_array_equal(got, solo[name][i])
            np.testing.assert_array_equal(got, whole[lo:lo + n])
    registry.clear()


def test_serving_workspace_terms_price_the_projection():
    x, y = _data(n=100, seed=24)
    pca = PCA(k=3).setInputCol("features").fit({"features": x})
    terms = pca._serve_workspace_terms(256, 4)
    assert terms["proj"] == 256 * 3 * 4 and terms["dot_block"] == 256 * 3 * 6 * 4 * 3 // 2
    ols = LinearRegression().fit({"features": x, "label": y})
    assert ols._serve_workspace_terms(512, 8)["pred"] == 512 * 8


# -------------------------------------------------------------- the card ----


@pytest.fixture
def card():
    """A CUDA device for the card tests; skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: LinearRegression on the card runs on an NVIDIA GPU only (chip_smoke.py phase 7)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("solve", _SOLVES)
@pytest.mark.parametrize("fast", [False, True])
def test_linear_fit_on_card_matches_cpu(card, solve, fast):
    x, y = _data(n=5000, seed=25)
    w = np.ones(len(x), np.float32)
    kw = dict(solve, fit_intercept=True, standardize=True, max_iter=50, tol=1e-5, fast=fast)
    cpu = tlinear.linear_fit(_t(x), _t(y), _t(w), **kw)
    gpu = tlinear.linear_fit(_t(x).to(card), _t(y).to(card), _t(w).to(card), **kw)
    _close(gpu["coef_"].cpu().numpy(), cpu["coef_"].numpy(), F32_SOLVE)
    assert int(gpu["n_iter_"]) == int(cpu["n_iter_"])


@pytest.mark.cuda
def test_all_constant_features_give_nan_on_card(card):
    n = 64
    x = _t(np.tile(np.array([1.0, -2.0, 3.5], np.float32), (n, 1))).to(card)
    y = _t(np.random.default_rng(26).normal(size=n).astype(np.float32)).to(card)
    state = tlinear.linear_fit(x, y, torch.ones(n, device=card), alpha=0.0, l1_ratio=0.0)
    assert torch.isnan(state["coef_"]).all()


# ---------------------------------------------------- import boundary ----


_GUARD = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
from spark_rapids_ml_tpu_torch import PCA, LinearRegression, ModelRegistry, ScoringEngine, set_devices
set_devices("cpu")
rng = np.random.default_rng(0)
x = rng.normal(size=(200, 4)).astype(np.float32)
y = (x @ rng.normal(size=4)).astype(np.float32)
p = PCA(k=2).setInputCol("features").fit({"features": x})
p.transform({"features": x})
m = LinearRegression(regParam=0.01, elasticNetParam=0.5).fit({"features": x, "label": y})
m.transform({"features": x})
LinearRegression(solver_precision="bf16").fit({"features": x, "label": y})
registry = ModelRegistry()
registry.load("pca", p)
registry.load("ols", m)
with ScoringEngine(registry) as engine:
    assert engine.score("pca", x[:3]).shape == (3, 2)
    assert engine.score("ols", x[:3]).shape == (3,)
bad = sorted(n for n in sys.modules
             if n == "spark_rapids_ml_tpu" or n.startswith("spark_rapids_ml_tpu."))
assert not bad, bad
assert sys.modules["jax"] is None
print("GUARD-OK")
"""


def test_pca_and_linear_regression_run_without_jax_or_the_jax_package():
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD], cwd=str(root), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
