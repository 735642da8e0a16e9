#
# The port's multi-fit engine against the JAX package's, case for case with
# tests/test_multifit.py, on the same numpy inputs: placement reuse in a
# device_dataset_scope (one ingest, LRU, no stale id reuse), the
# CrossValidator engine's counters, its weight-masked folds bit for bit
# against the weight-column fits, batched grids against sequential fits
# (bit for bit in the port, the same n_iter_, and within JAX's own
# tolerances against JAX), grouping by solver structure, masked class sets,
# and the column-block products that make a batched column independent of
# the grid.
#
import gc
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu.evaluation import MulticlassClassificationEvaluator as JaxMulticlassEvaluator
from spark_rapids_ml_tpu.evaluation import RegressionEvaluator as JaxRegressionEvaluator
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.models.regression import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu.tuning import CrossValidator as JaxCrossValidator
from spark_rapids_ml_tpu_torch import (
    PCA,
    CrossValidator,
    KMeans,
    LinearRegression,
    LogisticRegression,
    MulticlassClassificationEvaluator,
    ParamGridBuilder,
    RegressionEvaluator,
    Vectors,
    core,
    set_devices,
    telemetry,
)
from spark_rapids_ml_tpu_torch.linalg import SparseVector
from spark_rapids_ml_tpu_torch.ops import linear as tlinear
from spark_rapids_ml_tpu_torch.ops import logistic as tlog

# JAX's own tolerance (tests/test_multifit.py) of the engine against the
# literal row-subset fit; batched against sequential is held exactly here,
# tighter than JAX's rtol 1e-9
SUBSET_RTOL, SUBSET_ATOL = 1e-6, 1e-9
# the port against JAX in float64: solves of the same statistics and GLM
# trajectories summed in another order (tests/test_torch_logistic.py's
# converged-fit bound)
PORT_JAX_RTOL = 1e-7


@pytest.fixture(autouse=True)
def port_on_cpu():
    set_devices("cpu")
    yield
    set_devices(None)


@pytest.fixture
def tele():
    """Port telemetry on with a fresh registry; restored after."""
    telemetry.registry().reset()
    telemetry.enable()
    yield telemetry.registry()
    telemetry.disable()
    telemetry.registry().reset()


def _counters():
    return telemetry.registry().snapshot()["counters"]


def _hist_count(name):
    return telemetry.registry().snapshot()["histograms"].get(name, {}).get("count", 0)


def _reg_df(rng, n=200, d=5):
    x = rng.normal(size=(n, d))
    coef = np.array([1.0, -2.0, 0.0, 0.0, 3.0])
    y = x @ coef + 0.5 + 0.2 * rng.normal(size=n)
    return pd.DataFrame({"features": list(x), "label": y})


def _cls_df(rng, n=200, d=4):
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) > 0).astype(np.float64)
    return pd.DataFrame({"features": list(x), "label": y})


def _jax(est):
    """The JAX estimator of the same class and params as the port's `est`."""
    cls = {LinearRegression: JaxLinearRegression, LogisticRegression: JaxLogisticRegression}[type(est)]
    kw = {p.name: v for p, v in est._paramMap.items()}
    return cls(num_workers=1, float32_inputs=est.float32_inputs, **kw)


def _jax_grid(jest, grid):
    return [{jest.getParam(p.name): v for p, v in pm.items()} for pm in grid]


# ------------------------------------------------------------ DeviceDataset --


def test_device_dataset_scope_single_ingest(tele, rng):
    df = _reg_df(rng)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    with core.device_dataset_scope():
        m1 = lr.fit(df)
        m2 = lr.copy({lr.getParam("regParam"): 0.5}).fit(df)
    c = _counters()
    assert c["ingest.datasets"] == 1
    assert c["fit.device_dataset_builds"] == 1
    assert c["fit.device_dataset_reuses"] == 1
    assert _hist_count("host_section.ingest_s") == 1
    assert _hist_count("device_wait.layout_s") == 1
    assert not np.allclose(m1.coef_, m2.coef_)  # the other regParam really fit
    j2 = _jax(lr.copy({lr.getParam("regParam"): 0.5})).fit(df)
    np.testing.assert_allclose(m2.coef_, j2.coef_, rtol=PORT_JAX_RTOL)
    # outside a scope, every fit ingests
    lr.fit(df)
    assert _counters()["ingest.datasets"] == 2


def test_device_dataset_no_stale_reuse_after_gc(tele, rng):
    # the key is id()-based: every entry pins its source, or a collected
    # dataset's id on a new same-shaped object would be a silent false hit
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    with core.device_dataset_scope():
        m1 = lr.fit(_reg_df(rng))  # unreferenced after the call
        gc.collect()
        m2 = lr.fit(_reg_df(rng))  # same shape and columns, other data
    c = _counters()
    assert c["fit.device_dataset_builds"] == 2
    assert "fit.device_dataset_reuses" not in c
    assert not np.allclose(m1.coef_, m2.coef_)


def test_device_dataset_scope_distinct_datasets(tele, rng):
    df1, df2 = _reg_df(rng), _reg_df(rng, n=100)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    with core.device_dataset_scope():
        lr.fit(df1)
        lr.fit(df2)
    c = _counters()
    assert c["ingest.datasets"] == 2
    assert c["fit.device_dataset_builds"] == 2
    assert "fit.device_dataset_reuses" not in c


def test_device_dataset_scope_bounded_lru(tele, rng, monkeypatch):
    dfs = [_reg_df(rng, n=60 + i) for i in range(3)]
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    monkeypatch.setitem(core.config, "device_dataset_cache_entries", 2)
    with core.device_dataset_scope() as scope:
        for df in dfs:
            lr.fit(df)
        assert len(scope.cache) == 2  # the oldest evicted
        lr.fit(dfs[2])  # the newest still cached
        c = _counters()
        assert c["fit.device_dataset_builds"] == 3
        assert c["fit.device_dataset_evictions"] == 1
        assert c["fit.device_dataset_reuses"] == 1
        lr.fit(dfs[0])  # evicted: ingested again, never a stale hit
        assert _counters()["fit.device_dataset_builds"] == 4
    assert not scope.cache  # the outermost exit drops the placements


def test_device_dataset_scope_is_context_local(tele, rng):
    # a fit on another thread neither sees nor disturbs the scope
    df = _reg_df(rng)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    with core.device_dataset_scope() as scope:
        lr.fit(df)
        t = threading.Thread(target=lambda: lr.fit(df))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive() and len(scope.cache) == 1
    c = _counters()
    assert c["ingest.datasets"] == 2 and c["fit.device_dataset_builds"] == 1


# ------------------------------------------- CV: one placement, every fit --


@pytest.mark.parametrize("family", ["linear", "logistic"])
def test_cv_telemetry_one_ingest_one_layout(tele, rng, family):
    # a numFolds=3 x 4-map CrossValidator fit: 1 ingest, 1 placement, the
    # grid batched in every fold (12 solves) and 1 sequential refit; the
    # avgMetrics equal JAX's on the same folds
    if family == "linear":
        df = _reg_df(rng, n=240)
        est = LinearRegression(float32_inputs=False).setFeaturesCol("features")
        regs, eva, jeva = [0.0, 0.01, 0.1, 1.0], RegressionEvaluator(metricName="rmse"), JaxRegressionEvaluator(metricName="rmse")
    else:
        df = _cls_df(rng, n=240)
        est = LogisticRegression(maxIter=30, float32_inputs=False).setFeaturesCol("features")
        regs = [1e-4, 1e-2, 0.1, 1.0]
        eva, jeva = MulticlassClassificationEvaluator(metricName="accuracy"), JaxMulticlassEvaluator(metricName="accuracy")
    grid = ParamGridBuilder().addGrid(est.getParam("regParam"), regs).build()
    model = CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, numFolds=3, seed=1).fit(df)
    c = _counters()
    assert c["ingest.datasets"] == 1
    assert _hist_count("host_section.ingest_s") == 1 and _hist_count("device_wait.layout_s") == 1
    assert c["fit.device_dataset_builds"] == 1
    assert c["fit.device_dataset_reuses"] == 3  # 2 more folds + the refit
    assert c["fit.solves_batched"] == 12
    assert c["fit.solves_sequential"] == 1
    jest = _jax(est)
    jmodel = JaxCrossValidator(
        estimator=jest, estimatorParamMaps=_jax_grid(jest, grid), evaluator=jeva, numFolds=3, seed=1
    ).fit(df)
    if family == "linear":
        np.testing.assert_allclose(model.avgMetrics, jmodel.avgMetrics, rtol=1e-9)
    else:
        np.testing.assert_array_equal(model.avgMetrics, jmodel.avgMetrics)
    assert int(np.argmin(model.avgMetrics) if family == "linear" else np.argmax(model.avgMetrics)) == \
        int(np.argmin(jmodel.avgMetrics) if family == "linear" else np.argmax(jmodel.avgMetrics))


def _fold_bit_identity_check(df, est, eva, reg_grid):
    """The engine's weight-masked fold fits against the same split written
    as a weight column and fitted through fitMultiple with its own ingest:
    the same rows, the same products, so the fold metrics are equal bit for
    bit; against the literal row-subset fit (other sums), within JAX's
    tolerance."""
    grid = ParamGridBuilder().addGrid(est.getParam("regParam"), reg_grid).build()
    cv = CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, numFolds=2, seed=5)
    engine_avg = np.asarray(cv.fit(df).avgMetrics)
    n = len(df)
    folds = cv._kfold_indices(n, df)
    feats_full = est._pre_process_data(df, for_fit=False).features
    labels = df["label"].to_numpy(dtype=np.float64)
    baseline = np.zeros((2, len(grid)))
    subset = np.zeros_like(baseline)
    for f, (train_idx, valid_idx) in enumerate(folds):
        mask = np.zeros(n)
        mask[train_idx] = 1.0
        df_w = df.copy()
        df_w["w_"] = mask
        est_w = est.copy()._set_params(weightCol="w_")
        models = [m for _, m in sorted(est_w.fitMultiple(df_w, grid), key=lambda im: im[0])]
        baseline[f] = models[0]._combine(models)._transform_evaluate_arrays(
            feats_full[valid_idx], labels[valid_idx], eva
        )
        train = df.iloc[train_idx].reset_index(drop=True)
        sub = [m for _, m in sorted(est.fitMultiple(train, grid), key=lambda im: im[0])]
        subset[f] = sub[0]._combine(sub)._transform_evaluate_arrays(feats_full[valid_idx], labels[valid_idx], eva)
    np.testing.assert_array_equal(engine_avg, baseline.mean(axis=0))
    np.testing.assert_allclose(engine_avg, subset.mean(axis=0), rtol=SUBSET_RTOL, atol=SUBSET_ATOL)
    return engine_avg, grid


def test_cv_fold_metrics_bit_identical_logistic(rng):
    df = _cls_df(rng, n=180)
    est = LogisticRegression(maxIter=40, float32_inputs=False).setFeaturesCol("features")
    eva = MulticlassClassificationEvaluator(metricName="accuracy")
    engine_avg, grid = _fold_bit_identity_check(df, est, eva, [0.01, 0.1])
    jest = _jax(est)
    jcv = JaxCrossValidator(estimator=jest, estimatorParamMaps=_jax_grid(jest, grid),
                            evaluator=JaxMulticlassEvaluator(metricName="accuracy"), numFolds=2, seed=5)
    np.testing.assert_array_equal(engine_avg, jcv.fit(df).avgMetrics)


def test_cv_fold_metrics_bit_identical_linear(rng):
    df = _reg_df(rng, n=180)
    est = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    engine_avg, grid = _fold_bit_identity_check(df, est, RegressionEvaluator(metricName="rmse"), [0.0, 0.1])
    jest = _jax(est)
    jcv = JaxCrossValidator(estimator=jest, estimatorParamMaps=_jax_grid(jest, grid),
                            evaluator=JaxRegressionEvaluator(metricName="rmse"), numFolds=2, seed=5)
    np.testing.assert_allclose(engine_avg, jcv.fit(df).avgMetrics, rtol=1e-9)


def test_sparse_cv_is_refused_naming_a11(rng):
    # (named when the sparse half of the engine raised for ROADMAP A11) a
    # sparse CV runs the engine: one ingest, one conversion, and JAX's
    # avgMetrics
    x = np.where(np.abs(rng.normal(size=(40, 4))) > 0.8, 1.0, 0.0)
    rows = [SparseVector(4, np.nonzero(r)[0].astype(np.int32), r[np.nonzero(r)[0]]) for r in x]
    df = pd.DataFrame({"features": rows, "label": (x[:, 0] > 0).astype(float)})
    lr = LogisticRegression(maxIter=5, float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1]).build()
    cv = CrossValidator(estimator=lr, estimatorParamMaps=grid,
                        evaluator=MulticlassClassificationEvaluator(metricName="accuracy"), numFolds=2)
    telemetry.enable()
    telemetry.registry().reset()
    try:
        avg = cv.fit(df).avgMetrics
        c = telemetry.registry().snapshot()["counters"]
    finally:
        telemetry.disable()
    assert c["ingest.datasets"] == 1 and c["sparse.csr_to_ell_calls"] == 1
    from spark_rapids_ml_tpu.linalg import SparseVector as JaxSparseVector

    jx = pd.DataFrame({"features": [JaxSparseVector(4, v.indices, v.values) for v in rows], "label": df["label"]})
    jest = _jax(lr)
    jcv = JaxCrossValidator(estimator=jest, estimatorParamMaps=_jax_grid(jest, grid),
                            evaluator=JaxMulticlassEvaluator(metricName="accuracy"), numFolds=2)
    np.testing.assert_array_equal(avg, jcv.fit(jx).avgMetrics)


def test_cv_masked_fold_respects_train_classes(rng):
    # a fold whose train rows miss a class behaves like the physical split
    n = 30
    x = rng.normal(size=(n, 3))
    y = np.zeros(n)
    y[-3:] = 1.0
    df = pd.DataFrame({"features": list(x), "label": y, "fold": [0] * (n - 3) + [1] * 3})
    lr = LogisticRegression(maxIter=10, float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0]).build()
    cv = CrossValidator(estimator=lr, estimatorParamMaps=grid,
                        evaluator=MulticlassClassificationEvaluator(metricName="accuracy"),
                        numFolds=2, foldCol="fold")
    m = cv.fit(df)  # fold 1 trains on class-0 rows only: the single-class model
    assert np.isfinite(m.avgMetrics[0])
    jlr = _jax(lr)
    jm = JaxCrossValidator(estimator=jlr, estimatorParamMaps=_jax_grid(jlr, grid),
                           evaluator=JaxMulticlassEvaluator(metricName="accuracy"),
                           numFolds=2, foldCol="fold").fit(df)
    np.testing.assert_array_equal(m.avgMetrics, jm.avgMetrics)
    # and the masked fit itself finds one class
    inputs = lr._build_fit_inputs(lr._pre_process_data(df), torch.device("cpu"))
    mask = (df["fold"].to_numpy() == 0).astype(float)
    assert lr._resolve_classes(df["label"].to_numpy(), inputs.with_row_mask(mask)).tolist() == [0.0]


def test_with_row_mask_scales_the_weights_and_checks_its_length(rng):
    lr = LinearRegression(float32_inputs=False)
    inputs = lr._build_fit_inputs(lr._pre_process_data(_reg_df(rng, n=20)), torch.device("cpu"))
    mask = (np.arange(20) % 3 != 0).astype(float)
    masked = inputs.with_row_mask(mask)
    assert masked.X is inputs.X and masked.y is inputs.y
    np.testing.assert_array_equal(masked.w.numpy(), mask)
    np.testing.assert_array_equal(masked.host_mask, mask > 0)
    with pytest.raises(ValueError, match="19 entries for 20 rows"):
        inputs.with_row_mask(mask[:19])


# ----------------------------------------------------------- batched sweeps --


@pytest.mark.parametrize("k", [2, 3], ids=["binomial", "multinomial"])
def test_batched_sweep_matches_sequential_logistic(rng, k):
    df = _cls_df(rng, n=150)
    if k == 3:
        x = np.stack(df["features"].to_numpy())
        df["label"] = np.digitize(x @ np.array([1.0, -1.0, 0.5, 0.2]), [-0.7, 0.7]).astype(float)
    lr = LogisticRegression(maxIter=40, float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [1e-4, 1e-2, 1.0]).build()
    swept = [m for _, m in sorted(lr.fitMultiple(df, grid), key=lambda im: im[0])]
    jlr = _jax(lr)
    jswept = [m for _, m in sorted(jlr.fitMultiple(df, _jax_grid(jlr, grid)))]
    for pm, m_b, m_j in zip(grid, swept, jswept):
        m_s = lr.copy(pm).fit(df)  # the single fit: the sequential solver
        np.testing.assert_array_equal(m_b.coef_, m_s.coef_)  # lockstep: bit for bit
        np.testing.assert_array_equal(m_b.intercept_, m_s.intercept_)
        assert m_b.n_iter_ == m_s.n_iter_ == m_j.n_iter_  # the same trajectory
        np.testing.assert_allclose(m_b.coef_, m_j.coef_, rtol=PORT_JAX_RTOL, atol=1e-10)


def test_batched_sweep_groups_by_program_structure(tele, rng):
    # use_l1 splits a grid into one batched group per solver; a maxIter
    # grid changes the solve's structure and runs sequentially
    df = _cls_df(rng, n=120)
    lr = LogisticRegression(maxIter=30, float32_inputs=False).setFeaturesCol("features")
    grid = (
        ParamGridBuilder()
        .addGrid(lr.getParam("regParam"), [0.01, 0.1])
        .addGrid(lr.getParam("elasticNetParam"), [0.0, 0.5])
        .build()
    )
    swept = [m for _, m in sorted(lr.fitMultiple(df, grid), key=lambda im: im[0])]
    c = _counters()
    assert c["fit.solves_batched"] == 4  # 2 groups of 2
    assert "fit.solves_sequential" not in c
    jlr = _jax(lr)
    jswept = [m for _, m in sorted(jlr.fitMultiple(df, _jax_grid(jlr, grid)))]
    for pm, m_b, m_j in zip(grid, swept, jswept):
        m_s = lr.copy(pm).fit(df)
        np.testing.assert_array_equal(m_b.coef_, m_s.coef_)
        np.testing.assert_array_equal(m_b.coef_ == 0.0, m_j.coef_ == 0.0)  # the lasso's zeros
        np.testing.assert_allclose(m_b.coef_, m_j.coef_, rtol=1e-6, atol=1e-8)
    telemetry.registry().reset()
    grid_iter = ParamGridBuilder().addGrid(lr.getParam("maxIter"), [5, 10]).build()
    list(lr.fitMultiple(df, grid_iter))
    c = _counters()
    assert c["fit.solves_sequential"] == 2
    assert "fit.solves_batched" not in c


def test_batched_sweep_matches_sequential_linear_cd(rng):
    df = _reg_df(rng, n=150)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    grid = (
        ParamGridBuilder()
        .addGrid(lr.getParam("regParam"), [0.01, 0.1, 1.0])
        .addGrid(lr.getParam("elasticNetParam"), [0.5])
        .build()
    )
    swept = [m for _, m in sorted(lr.fitMultiple(df, grid), key=lambda im: im[0])]
    jlr = _jax(lr)
    jswept = [m for _, m in sorted(jlr.fitMultiple(df, _jax_grid(jlr, grid)))]
    for pm, m_b, m_j in zip(grid, swept, jswept):
        m_s = lr.copy(pm).fit(df)
        np.testing.assert_array_equal(m_b.coef_, m_s.coef_)
        assert m_b.n_iter_ == m_s.n_iter_ == m_j.n_iter_
        np.testing.assert_allclose(m_b.coef_, m_j.coef_, rtol=1e-10, atol=1e-13)


def test_compile_probe_guarded_after_batching(tele, rng):
    # identical param maps batch too: one grid of three
    df = _reg_df(rng, n=80)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.1, 0.1, 0.1]).build()
    models = [m for _, m in sorted(lr.fitMultiple(df, grid), key=lambda im: im[0])]
    assert _counters()["fit.solves_batched"] == 3
    assert all(np.array_equal(m.coef_, models[0].coef_) for m in models)


# ---------------------------------------- the lockstep solves, op by op --


def test_column_blocks_make_a_column_independent_of_the_grid():
    # a column's product is the same bits alone, beside 1 or 11 others and
    # at any position: what makes batched = sequential (a plain X @ B is
    # not: its kernel and sums change with the column count)
    rng = np.random.default_rng(0)
    for dtype in (torch.float64, torch.float32):
        X = torch.tensor(rng.normal(size=(300, 8)), dtype=dtype)
        B = torch.tensor(rng.normal(size=(8, 12)), dtype=dtype)
        R = torch.tensor(rng.normal(size=(300, 12)), dtype=dtype)
        for fast in (False, True):
            matvec, rmat = tlog._dense_ops(X, fast)
            full, full_t = matvec(B), rmat(R)
            for j in (0, 5, 11):
                assert torch.equal(matvec(B[:, j:j + 1])[:, 0], full[:, j])
                assert torch.equal(rmat(R[:, j:j + 1])[:, 0], full_t[:, j])
                assert torch.equal(matvec(B[:, [3, j]])[:, 1], full[:, j])
            np.testing.assert_allclose(full.numpy(), (X.double() @ B.double()).numpy(), rtol=1e-3 if fast else 1e-5,
                                       atol=0.05 if fast else 1e-5)


@pytest.mark.parametrize("use_l1", [False, True], ids=["glm_qn", "owlqn"])
@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
def test_logistic_fit_batched_is_the_sequential_fits(use_l1, fast):
    # float32 (and its bf16 products): each grid point's state equals its
    # logistic_fit bit for bit, the points stopping at different iterations
    rng = np.random.default_rng(3)
    X = torch.tensor(rng.normal(size=(250, 6)), dtype=torch.float32)
    y = torch.tensor((rng.normal(size=250) + X[:, 0].numpy() > 0).astype(np.int64))
    w = torch.tensor((rng.uniform(size=250) > 0.3).astype(np.float32))  # a fold mask
    regs = [(1e-2, 0.5), (1e-1, 1.0), (3e-2, 0.3)] if use_l1 else [(1e-4, 0.0), (1e-2, 0.0), (1.0, 0.0)]
    l2s, l1s = [a * (1 - r) for a, r in regs], [a * r for a, r in regs]
    common = dict(k=2, multinomial=False, use_l1=use_l1, max_iter=40, tol=1e-6, fast=fast)
    states = tlog.logistic_fit_batched(X, y, w, l2s, l1s, **common)
    iters, reads = [], []
    for st, l2, l1 in zip(states, l2s, l1s):
        single = tlog.logistic_fit(X, y, w, lam_l2=l2, lam_l1=l1, **common)
        assert st["n_iter_"] == single["n_iter_"] and st["host_reads_"] == single["host_reads_"]
        for key in ("coef_", "intercept_", "objective_"):
            assert torch.equal(st[key], single[key]), key
        iters.append(st["n_iter_"])
        reads.append(st["host_reads_"])
    # one read per iteration (per trial for OWL-QN) for the whole grid: the
    # grid reads as often as its longest point alone
    assert states[0]["grid_host_reads_"] == max(reads)


def test_grid_reads_the_card_once_per_iteration():
    # tol = 0: every point runs max_iter iterations; the grid reads the
    # card max_iter times in all, as one fit does, not S times as many
    rng = np.random.default_rng(4)
    X = torch.tensor(rng.normal(size=(200, 5)))
    y = torch.tensor((X[:, 0].numpy() + rng.normal(size=200) > 0).astype(np.int64))
    w = torch.ones(200, dtype=torch.float64)
    states = tlog.logistic_fit_batched(X, y, w, [1e-3, 1e-2, 1e-1, 1.0], [0.0] * 4, k=2, multinomial=False,
                                       max_iter=6, tol=0.0)
    assert [s["n_iter_"] for s in states] == [6] * 4
    assert [s["host_reads_"] for s in states] == [6] * 4
    assert states[0]["grid_host_reads_"] == 6


def test_batched_cd_freezes_stopped_points():
    # the batched coordinate descent: each point's b equals its own run bit
    # for bit, with its own sweep count, while the others go on
    rng = np.random.default_rng(5)
    x = rng.normal(size=(120, 6))
    y = x @ rng.normal(size=6) + 0.1 * rng.normal(size=120)
    stats = tlinear._sufficient_stats(torch.tensor(x), torch.tensor(y), torch.ones(120, dtype=torch.float64))
    alphas, l1rs = [1e-3, 0.05, 0.5], [0.5, 0.9, 1.0]
    kw = dict(fit_intercept=True, standardize=True, use_cd=True, max_iter=200, tol=1e-9)
    grid = tlinear._solve_grid_from_stats(stats, torch.float64, alphas, l1rs, **kw)
    iters = []
    for st, a, r in zip(grid, alphas, l1rs):
        single = tlinear._solve_from_stats(stats, torch.float64, alpha=a, l1_ratio=r, **kw)
        assert torch.equal(st["coef_"], single["coef_"]) and int(st["n_iter_"]) == int(single["n_iter_"])
        iters.append(int(st["n_iter_"]))
    assert len(set(iters)) > 1  # the points really stopped apart


# ------------------------------------------ fitMultiple on every estimator --


def test_fit_multiple_places_once_for_estimators_without_a_grid(tele, rng):
    # KMeans and PCA have no batched grid: one placement, sequential solves,
    # each model equal to its single fit
    x = rng.normal(size=(200, 6))
    data = {"features": x}
    km = KMeans(k=3, maxIter=5, seed=1, float32_inputs=False)
    maps = [{km.getParam("k"): 3}, {km.getParam("k"): 4}]
    models = [m for _, m in sorted(km.fitMultiple(data, maps), key=lambda im: im[0])]
    c = _counters()
    assert c["ingest.datasets"] == 1 and c["fit.solves_sequential"] == 2
    for pm, m in zip(maps, models):
        np.testing.assert_array_equal(m.cluster_centers_, km.copy(pm).fit(data).cluster_centers_)
    pca = PCA(k=2, float32_inputs=False).setInputCol("features")
    pms = [m for _, m in sorted(pca.fitMultiple(data, [{pca.getParam("k"): 2}, {pca.getParam("k"): 3}]),
                                key=lambda im: im[0])]
    assert [m.components_.shape[0] for m in pms] == [2, 3]


def test_fit_multiple_iterator_is_thread_safe(rng):
    # one fit pass, whoever claims index 0; every other claimant waits
    df = _reg_df(rng, n=100)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1, 1.0, 10.0]).build()
    it = lr.fitMultiple(df, grid)
    got = []
    threads = [threading.Thread(target=lambda: got.append(next(it))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert sorted(i for i, _ in got) == [0, 1, 2, 3]
    with pytest.raises(StopIteration):
        next(it)
    for i, m in got:
        np.testing.assert_array_equal(m.coef_, lr.copy(grid[i]).fit(df).coef_)


def test_fit_multiple_models_carry_their_map(rng):
    df = _cls_df(rng, n=100)
    lr = LogisticRegression(maxIter=10, float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.01, 0.5]).build()
    models = lr.fit(df, grid)
    assert [m.getOrDefault("regParam") for m in models] == [0.01, 0.5]
    assert [m.solver_params["alpha"] for m in models] == [0.01, 0.5]
    assert core.evaluator_label_column(models[0], MulticlassClassificationEvaluator(labelCol="y")) == "y"
    assert Vectors.dense(models[0].coef_[0]).toArray().shape == (4,)


# --------------------------------------------------------- bucketed transform --


def test_transform_bucket_ladder_pads_to_the_rungs(rng, monkeypatch):
    # 19 batch sizes pad up to the rungs 8, 16, 32 and 64 only, and the
    # outputs are sliced back to the valid rows
    df = _reg_df(rng, n=64, d=5)
    model = LinearRegression(float32_inputs=False).setFeaturesCol("features").fit(df)
    monkeypatch.setitem(core.config, "transform_bucket_min_rows", 8)
    seen = set()
    real = core.PredictProgram.dispatch

    def spy(self, xb):
        out = real(self, xb)
        seen.update(self._shapes_seen)
        return out

    monkeypatch.setattr(core.PredictProgram, "dispatch", spy)
    for n in [1, 2, 3, 5, 7, 8, 9, 11, 13, 17, 19, 23, 29, 31, 33, 40, 47, 55, 63]:
        assert model._transform_arrays(rng.normal(size=(n, 5))).shape == (n,)
    assert {s[0] for s in seen} == {8, 16, 32, 64}


def test_transform_bucket_values_unchanged(rng):
    # padding never reaches the valid rows' outputs; the same as JAX's model
    df = _reg_df(rng, n=50, d=5)
    model = LinearRegression(float32_inputs=False).setFeaturesCol("features").fit(df)
    x = rng.normal(size=(37, 5))
    np.testing.assert_allclose(model._transform_arrays(x), x @ model.coef_ + model.intercept_, rtol=1e-12)
    jm = _jax(LinearRegression(float32_inputs=False)).fit(df)
    np.testing.assert_allclose(model._transform_arrays(x), jm._transform_arrays(x), rtol=1e-10)


def test_transform_zero_rows_multi_output(rng):
    # a zero-row block through a multi-output predict gives one correctly
    # shaped empty array per output, through the full transform too
    df = _cls_df(rng, n=80)
    model = LogisticRegression(maxIter=10, float32_inputs=False).setFeaturesCol("features").fit(df)
    out = model._transform_arrays(np.zeros((0, 4)))
    assert isinstance(out, tuple) and len(out) == 2
    assert out[0].shape == (0, 2) and out[1].shape == (0, 2)
    empty = model.transform({"features": np.zeros((0, 4)), "label": np.zeros(0)})
    assert len(empty) == 0
    for col in ("rawPrediction", "probability", "prediction"):
        assert col in empty.columns
    lin = LinearRegression(float32_inputs=False).setFeaturesCol("features").fit(_reg_df(rng, n=60, d=5))
    assert lin._transform_arrays(np.zeros((0, 5))).shape == (0,)
