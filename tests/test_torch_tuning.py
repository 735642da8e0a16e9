#
# The port's tuning layer and Pipeline (tuning.py, pipeline.py) against the
# JAX package's, case for case with tests/test_tuning.py and
# tests/test_pipeline.py, on the same numpy inputs (<= 300 rows, <= 8
# columns, float64): the same fold indices, the same avgMetrics,
# stdMetrics and best param map (accuracy exactly, rmse and r2 to rtol
# 1e-9), both paths (the engine, the per-model fallback the forests take),
# and the composite save/load, a model saved by the JAX package loaded by
# the port included.
#
import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_tpu import evaluation as jev
from spark_rapids_ml_tpu import tuning as jtun
from spark_rapids_ml_tpu.linalg import Vectors as JaxVectors
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.models.classification import RandomForestClassifier as JaxRandomForestClassifier
from spark_rapids_ml_tpu.models.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.models.regression import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu.pipeline import Pipeline as JaxPipeline
from spark_rapids_ml_tpu_torch import (
    PCA,
    CrossValidator,
    CrossValidatorModel,
    LinearRegression,
    LinearRegressionModel,
    LogisticRegression,
    MulticlassClassificationEvaluator,
    ParamGridBuilder,
    Pipeline,
    PipelineModel,
    RandomForestClassifier,
    RegressionEvaluator,
    TrainValidationSplit,
    TrainValidationSplitModel,
    Vectors,
    core,
    set_devices,
    telemetry,
)

RMSE_RTOL = 1e-9  # the port's and JAX's fits of one fold differ in float64 rounding only


@pytest.fixture(autouse=True)
def port_on_cpu():
    set_devices("cpu")
    yield
    set_devices(None)


@pytest.fixture
def tele():
    telemetry.registry().reset()
    telemetry.enable()
    yield telemetry.registry()
    telemetry.disable()
    telemetry.registry().reset()


def _cv_data(rng, n=300, d=5):
    x = rng.normal(size=(n, d))
    coef = np.array([1.0, -2.0, 0.0, 0.0, 3.0])
    y = x @ coef + 0.5 + 0.2 * rng.normal(size=n)
    return pd.DataFrame({"features": list(x), "label": y})


def _jax_twin(est):
    cls = {LinearRegression: JaxLinearRegression, LogisticRegression: JaxLogisticRegression,
           RandomForestClassifier: JaxRandomForestClassifier}[type(est)]
    return cls(num_workers=1, float32_inputs=est.float32_inputs, **{p.name: v for p, v in est._paramMap.items()})


def _jax_eval(eva):
    cls = getattr(jev, type(eva).__name__)
    return cls(**{p.name: v for p, v in eva._paramMap.items()})


def _jax_grid(jest, grid):
    return [{jest.getParam(p.name): v for p, v in pm.items()} for pm in grid]


def _both_cv(est, grid, eva, data, **kw):
    jest = _jax_twin(est)
    m = CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, **kw).fit(data)
    jm = jtun.CrossValidator(estimator=jest, estimatorParamMaps=_jax_grid(jest, grid),
                             evaluator=_jax_eval(eva), **kw).fit(data)
    return m, jm


def test_param_grid_builder():
    lr = LinearRegression()
    grid = (
        ParamGridBuilder()
        .addGrid(lr.getParam("regParam"), [0.0, 0.1])
        .addGrid(lr.getParam("elasticNetParam"), [0.0, 0.5, 1.0])
        .build()
    )
    assert len(grid) == 6 and all(len(g) == 2 for g in grid)
    jlr = JaxLinearRegression()
    jgrid = (jtun.ParamGridBuilder().addGrid(jlr.getParam("regParam"), [0.0, 0.1])
             .addGrid(jlr.getParam("elasticNetParam"), [0.0, 0.5, 1.0]).build())
    assert [{p.name: v for p, v in g.items()} for g in grid] == [{p.name: v for p, v in g.items()} for g in jgrid]
    base = ParamGridBuilder().baseOn({lr.getParam("maxIter"): 5}).addGrid(lr.getParam("tol"), [1e-3, 1e-4]).build()
    assert [g[lr.getParam("maxIter")] for g in base] == [5, 5]
    with pytest.raises(TypeError, match="Param"):
        ParamGridBuilder().addGrid("regParam", [0.1])


@pytest.mark.parametrize("fold_col", [False, True])
@pytest.mark.parametrize("n,num_folds,seed", [(300, 3, 0), (7, 3, 4), (100, 5, 9)])
def test_kfold_indices_equal_jax(rng, n, num_folds, seed, fold_col):
    df = _cv_data(rng, n=n)
    kw = dict(numFolds=num_folds, seed=seed)
    if fold_col:
        df["f"] = np.arange(n) % num_folds
        kw["foldCol"] = "f"
    got = CrossValidator(**kw)._kfold_indices(n, df)
    want = jtun.CrossValidator(**kw)._kfold_indices(n, df)
    assert len(got) == len(want) == num_folds
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)
    # and from a dict dataset, which the engine reads without pandas
    dict_folds = CrossValidator(**kw)._kfold_indices(n, {c: df[c].to_numpy() for c in df.columns})
    for (gt, _), (dt, _) in zip(got, dict_folds):
        np.testing.assert_array_equal(gt, dt)


def test_kfold_indices_refusals(rng):
    df = _cv_data(rng, n=10)
    with pytest.raises(ValueError, match="numFolds=3"):
        CrossValidator(numFolds=3)._kfold_indices(2, df)
    df["f"] = [0] * 9 + [3]
    with pytest.raises(ValueError, match=r"foldCol values must be in \[0, 3\)"):
        CrossValidator(numFolds=3, foldCol="f")._kfold_indices(10, df)
    df["f"] = [0] * 5 + [1] * 5
    with pytest.raises(ValueError, match="fold 2 is empty"):
        CrossValidator(numFolds=3, foldCol="f")._kfold_indices(10, df)


def test_cross_validator_fused_path(rng):
    df = _cv_data(rng)
    lr = LinearRegression(standardization=False, float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.5, 10.0]).build()
    ev = RegressionEvaluator(metricName="rmse")
    assert lr._supportsTransformEvaluate(ev)
    m, jm = _both_cv(lr, grid, ev, df, numFolds=3, seed=42)
    assert isinstance(m, CrossValidatorModel) and len(m.avgMetrics) == 3
    np.testing.assert_allclose(m.avgMetrics, jm.avgMetrics, rtol=RMSE_RTOL)
    np.testing.assert_allclose(m.stdMetrics, jm.stdMetrics, rtol=1e-7)
    assert int(np.argmin(m.avgMetrics)) == int(np.argmin(jm.avgMetrics)) == 0
    out = m.transform(df)
    assert "prediction" in out.columns
    np.testing.assert_allclose(m.bestModel.coef_, jm.bestModel.coef_, rtol=1e-10)


def test_cross_validator_matches_manual_scores(rng):
    # the engine equals the naive per-model loop on the same folds
    df = _cv_data(rng, n=200)
    lr = LinearRegression(standardization=False, float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 1.0]).build()
    ev = RegressionEvaluator(metricName="r2")
    m, jm = _both_cv(lr, grid, ev, df, numFolds=2, seed=7)
    folds = CrossValidator(numFolds=2, seed=7)._kfold_indices(len(df), df)
    manual = np.zeros(2)
    for train_idx, valid_idx in folds:
        train, valid = df.iloc[train_idx], df.iloc[valid_idx]
        for j, pm in enumerate(grid):
            manual[j] += ev.evaluate(lr.copy(pm).fit(train).transform(valid))
    manual /= len(folds)
    np.testing.assert_allclose(m.avgMetrics, manual, rtol=1e-8)
    np.testing.assert_allclose(m.avgMetrics, jm.avgMetrics, rtol=RMSE_RTOL)


@pytest.mark.parametrize("family", ["linear", "logistic"])
def test_engine_scores_like_per_fold_fits(rng, family):
    # the engine (masks over one placement, held-out rows scored from it)
    # against fitMultiple on each fold's own rows and one scoring pass over
    # its held-out rows, and against JAX's CrossValidator
    df = _cv_data(rng, n=180)
    if family == "linear":
        est = LinearRegression(float32_inputs=False)
        ev, regs, rtol = RegressionEvaluator(metricName="rmse"), [0.0, 0.1], 1e-9
    else:
        df["label"] = (df["label"] > 0.5).astype(float)
        est = LogisticRegression(maxIter=30, float32_inputs=False)
        ev, regs, rtol = MulticlassClassificationEvaluator(metricName="accuracy"), [1e-3, 0.3], 0.0
    grid = ParamGridBuilder().addGrid(est.getParam("regParam"), regs).build()
    cv = CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=ev, numFolds=3, seed=2)
    engine = cv.fit(df)
    per_fold = np.zeros((3, len(grid)))
    for f, (train_idx, valid_idx) in enumerate(cv._kfold_indices(len(df), df)):
        models = [m for _, m in sorted(est.fitMultiple(df.iloc[train_idx], grid), key=lambda im: im[0])]
        per_fold[f] = models[0]._combine(models)._transform_evaluate(df.iloc[valid_idx], ev)
    np.testing.assert_allclose(per_fold.mean(axis=0), engine.avgMetrics, rtol=max(rtol, 1e-9))
    jest = _jax_twin(est)
    jm = jtun.CrossValidator(estimator=jest, estimatorParamMaps=_jax_grid(jest, grid), evaluator=_jax_eval(ev),
                             numFolds=3, seed=2).fit(df)
    np.testing.assert_allclose(engine.avgMetrics, jm.avgMetrics, rtol=rtol)


def test_cross_validator_parallel(rng):
    df = _cv_data(rng, n=150)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1]).build()
    m, jm = _both_cv(lr, grid, RegressionEvaluator(), df, numFolds=3, parallelism=3)
    assert len(m.avgMetrics) == 2
    np.testing.assert_allclose(m.avgMetrics, jm.avgMetrics, rtol=RMSE_RTOL)


def test_cross_validator_fold_col(rng):
    df = _cv_data(rng, n=90)
    df["my_fold"] = np.arange(90) % 3
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0]).build()
    m, jm = _both_cv(lr, grid, RegressionEvaluator(), df, numFolds=3, foldCol="my_fold")
    np.testing.assert_allclose(m.avgMetrics, jm.avgMetrics, rtol=RMSE_RTOL)


def test_cv_small_dataset_folds_nonempty(rng):
    df = _cv_data(rng, n=7)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0]).build()
    m = CrossValidator(estimator=lr, estimatorParamMaps=grid, evaluator=RegressionEvaluator(),
                       numFolds=3, seed=0).fit(df)
    assert np.isfinite(m.avgMetrics[0])


def test_cv_collect_sub_models(rng):
    df = _cv_data(rng, n=60)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1]).build()
    m = CrossValidator(estimator=lr, estimatorParamMaps=grid, evaluator=RegressionEvaluator(),
                       numFolds=2, collectSubModels=True).fit(df)
    assert m.subModels is not None and len(m.subModels) == 2
    assert all(len(fold_models) == 2 for fold_models in m.subModels)
    assert [fm.getOrDefault("regParam") for fm in m.subModels[1]] == [0.0, 0.1]


def test_cv_over_a_dict_dataset_places_once(tele, rng):
    # a dict with a 2-D feature block goes to the engine as it is: one
    # ingest, one placement, the same metrics as its pandas form
    df = _cv_data(rng, n=120)
    data = {"features": np.stack(df["features"].to_numpy()), "label": df["label"].to_numpy()}
    lr = LinearRegression(float32_inputs=False)
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1]).build()
    kw = dict(estimator=lr, estimatorParamMaps=grid, evaluator=RegressionEvaluator(), numFolds=3, seed=3)
    m = CrossValidator(**kw).fit(data)
    c = telemetry.registry().snapshot()["counters"]
    assert c["ingest.datasets"] == 1 and c["fit.device_dataset_builds"] == 1
    np.testing.assert_array_equal(m.avgMetrics, CrossValidator(**kw).fit(df).avgMetrics)


def test_train_validation_split_fused_and_fallback(rng):
    df = _cv_data(rng)
    lr = LinearRegression(standardization=False, float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.5, 10.0]).build()
    ev = RegressionEvaluator(metricName="rmse")
    m = TrainValidationSplit(estimator=lr, estimatorParamMaps=grid, evaluator=ev, trainRatio=0.75, seed=4).fit(df)
    assert isinstance(m, TrainValidationSplitModel) and len(m.validationMetrics) == 3
    assert int(np.argmin(m.validationMetrics)) == 0
    assert "prediction" in m.transform(df).columns
    perm = np.random.default_rng(4).permutation(len(df))
    n_train = int(round(0.75 * len(df)))
    train, valid = df.iloc[perm[:n_train]], df.iloc[perm[n_train:]]
    manual = [ev.evaluate(lr.copy(pm).fit(train).transform(valid)) for pm in grid]
    np.testing.assert_allclose(m.validationMetrics, manual, rtol=1e-8)
    jlr = _jax_twin(lr)
    jm = jtun.TrainValidationSplit(estimator=jlr, estimatorParamMaps=_jax_grid(jlr, grid), evaluator=_jax_eval(ev),
                                   trainRatio=0.75, seed=4).fit(df)
    np.testing.assert_allclose(m.validationMetrics, jm.validationMetrics, rtol=RMSE_RTOL)
    # the per-model fallback (a weighted evaluator) on the same split
    df["w"] = 1.0
    wev = RegressionEvaluator(metricName="rmse", weightCol="w")
    fb = TrainValidationSplit(estimator=lr, estimatorParamMaps=grid, evaluator=wev, trainRatio=0.75, seed=4,
                              parallelism=2).fit(df)
    np.testing.assert_allclose(fb.validationMetrics, manual, rtol=1e-8)
    assert "numFolds" not in TrainValidationSplit().explainParams()


@pytest.mark.parametrize("elastic", [0.5, 1.0])
def test_train_validation_split_owlqn_grid_matches_jax(rng, elastic):
    # the OWL-QN group of the chip's phase 10c, small: the same zero pattern
    # and metrics as JAX's TVS
    df = _cv_data(rng, n=240)
    df["label"] = (df["label"] > 0.5).astype(float)
    lr = LogisticRegression(maxIter=30, float32_inputs=False, regParam=1e-2)
    grid = ParamGridBuilder().addGrid(lr.getParam("elasticNetParam"), [elastic, 0.3]).build()
    ev = MulticlassClassificationEvaluator(metricName="accuracy")
    kw = dict(trainRatio=0.75, seed=1, collectSubModels=True)
    m = TrainValidationSplit(estimator=lr, estimatorParamMaps=grid, evaluator=ev, **kw).fit(df)
    jlr = _jax_twin(lr)
    jm = jtun.TrainValidationSplit(estimator=jlr, estimatorParamMaps=_jax_grid(jlr, grid), evaluator=_jax_eval(ev),
                                   **kw).fit(df)
    np.testing.assert_array_equal(m.validationMetrics, jm.validationMetrics)
    for a, b in zip(m.subModels, jm.subModels):
        np.testing.assert_array_equal(a.coef_ == 0.0, b.coef_ == 0.0)
        assert a.n_iter_ == b.n_iter_


def test_train_validation_split_persistence(rng, tmp_path):
    df = _cv_data(rng, n=150)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1]).build()
    m = TrainValidationSplit(estimator=lr, estimatorParamMaps=grid, evaluator=RegressionEvaluator(),
                             collectSubModels=True).fit(df)
    assert m.subModels is not None and len(m.subModels) == 2
    path = str(tmp_path / "tvs")
    m.save(path)
    loaded = TrainValidationSplitModel.load(path)
    np.testing.assert_allclose(loaded.validationMetrics, m.validationMetrics, rtol=1e-12)
    assert len(loaded.subModels) == 2
    np.testing.assert_allclose(loaded.transform(df)["prediction"].to_numpy(),
                               m.transform(df)["prediction"].to_numpy(), rtol=1e-10)
    with pytest.raises(ValueError, match="trainRatio"):
        TrainValidationSplit(estimator=lr, estimatorParamMaps=grid, evaluator=RegressionEvaluator(),
                             trainRatio=1.5).fit(df)


def test_cv_model_persistence_roundtrip(rng, tmp_path):
    df = _cv_data(rng, n=80)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1]).build()
    m = CrossValidator(estimator=lr, estimatorParamMaps=grid, evaluator=RegressionEvaluator(),
                       numFolds=2, collectSubModels=True, seed=3).fit(df)
    path = str(tmp_path / "cv_model")
    m.save(path)
    with pytest.raises(FileExistsError):
        m.save(path)
    m.write().overwrite().save(path)
    loaded = CrossValidatorModel.load(path)
    np.testing.assert_allclose(loaded.avgMetrics, m.avgMetrics, rtol=1e-12)
    np.testing.assert_allclose(loaded.stdMetrics, m.stdMetrics, rtol=1e-12)
    np.testing.assert_allclose(loaded.bestModel.coefficients, m.bestModel.coefficients, rtol=1e-12)
    assert loaded.subModels is not None and all(len(f) == 2 for f in loaded.subModels)
    np.testing.assert_allclose(loaded.subModels[1][1].coefficients, m.subModels[1][1].coefficients, rtol=1e-12)
    np.testing.assert_allclose(loaded.transform(df)["prediction"].to_numpy(),
                               m.transform(df)["prediction"].to_numpy(), rtol=1e-10)


def test_cv_model_persistence_no_submodels(rng, tmp_path):
    df = _cv_data(rng, n=60)
    lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0]).build()
    m = CrossValidator(estimator=lr, estimatorParamMaps=grid, evaluator=RegressionEvaluator(), numFolds=2).fit(df)
    assert m.subModels is None
    path = str(tmp_path / "cv2")
    m.save(path)
    loaded = CrossValidatorModel.load(path)
    assert loaded.subModels is None
    np.testing.assert_allclose(loaded.avgMetrics, m.avgMetrics, rtol=1e-12)
    with pytest.raises(ValueError, match="no bestModel"):
        CrossValidatorModel().save(str(tmp_path / "empty"))


@pytest.mark.parametrize("kind", ["cv", "tvs"])
def test_jax_saved_tuning_model_loads_in_the_port(rng, tmp_path, kind):
    # a CrossValidatorModel / TrainValidationSplitModel saved by the JAX
    # package loads as the port's, its sub-models as the port's models,
    # and predicts what the JAX model predicts
    df = _cv_data(rng, n=120)
    jlr = JaxLinearRegression(num_workers=1, float32_inputs=False)
    grid = _jax_grid(jlr, ParamGridBuilder().addGrid(LinearRegression().getParam("regParam"), [0.0, 0.1]).build())
    if kind == "cv":
        jm = jtun.CrossValidator(estimator=jlr, estimatorParamMaps=grid, evaluator=jev.RegressionEvaluator(),
                                 numFolds=2, collectSubModels=True).fit(df)
    else:
        jm = jtun.TrainValidationSplit(estimator=jlr, estimatorParamMaps=grid, evaluator=jev.RegressionEvaluator(),
                                       collectSubModels=True).fit(df)
    path = str(tmp_path / kind)
    jm.save(path)
    loaded = core.load_instance(path)
    assert type(loaded) is (CrossValidatorModel if kind == "cv" else TrainValidationSplitModel)
    assert isinstance(loaded.bestModel, LinearRegressionModel)
    subs = loaded.subModels[0] if kind == "cv" else loaded.subModels
    assert all(isinstance(s, LinearRegressionModel) for s in subs)
    np.testing.assert_array_equal(loaded.bestModel.coef_, jm.bestModel.coef_)
    np.testing.assert_allclose(loaded.transform(df)["prediction"].to_numpy(),
                               jm.transform(df)["prediction"].to_numpy(), rtol=1e-12)


def test_fused_path_respects_evaluator_label_col(rng):
    df = _cv_data(rng, n=100).rename(columns={"label": "target"})
    lr = LinearRegression(float32_inputs=False, labelCol="target").setFeaturesCol("features")
    ev = RegressionEvaluator(metricName="rmse").setLabelCol("target")
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0]).build()
    m, jm = _both_cv(lr, grid, ev, df, numFolds=2)
    assert np.isfinite(m.avgMetrics[0])
    np.testing.assert_allclose(m.avgMetrics, jm.avgMetrics, rtol=RMSE_RTOL)


def test_weighted_evaluator_takes_fallback(rng):
    lr, lg = LinearRegression(), LogisticRegression()
    assert lr._supportsTransformEvaluate(RegressionEvaluator(metricName="rmse"))
    assert not lr._supportsTransformEvaluate(RegressionEvaluator(metricName="rmse", weightCol="w"))
    assert lg._supportsTransformEvaluate(MulticlassClassificationEvaluator(metricName="logLoss"))
    assert not lg._supportsTransformEvaluate(MulticlassClassificationEvaluator(metricName="f1", weightCol="w"))
    assert not lg._supportsTransformEvaluate(object())
    assert not RandomForestClassifier()._supportsTransformEvaluate(MulticlassClassificationEvaluator())


def test_the_engine_takes_what_scores_itself():
    # the engine for an estimator of the port whose models score the
    # evaluator's metric; the per-model fallback for a forest, a Pipeline
    # and a weighted evaluator
    def engine(est, ev):
        return CrossValidator(estimator=est, estimatorParamMaps=[{}], evaluator=ev)._parts()[3]

    rmse, acc = RegressionEvaluator(metricName="rmse"), MulticlassClassificationEvaluator(metricName="accuracy")
    assert engine(LinearRegression(), rmse) and engine(LogisticRegression(), acc)
    assert not engine(LinearRegression(), RegressionEvaluator(metricName="rmse", weightCol="w"))
    assert not engine(RandomForestClassifier(), acc)
    assert not engine(Pipeline(stages=[LinearRegression()]), rmse)
    with pytest.raises(ValueError, match="must all be set"):
        CrossValidator(estimator=LinearRegression(), evaluator=rmse)._parts()


def test_cv_over_a_forest_takes_the_fallback_and_matches_jax(rng):
    # the forests score through evaluate(transform): the per-model path;
    # without the bootstrap the port's forests are JAX's exactly, so are
    # the fold metrics
    df = _cv_data(rng, n=160, d=5)
    df["label"] = (df["label"] > 0.5).astype(float)
    rf = RandomForestClassifier(numTrees=2, maxDepth=3, maxBins=8, bootstrap=False, seed=3, float32_inputs=False)
    grid = ParamGridBuilder().addGrid(rf.getParam("maxDepth"), [2, 3]).build()
    ev = MulticlassClassificationEvaluator(metricName="accuracy")
    m, jm = _both_cv(rf, grid, ev, df, numFolds=2, seed=1)
    np.testing.assert_array_equal(m.avgMetrics, jm.avgMetrics)


@pytest.mark.parametrize("parallelism", [1, 2])
def test_fallback_paths_keep_their_sub_models(rng, parallelism):
    # the per-model fallback (a weighted evaluator) of both validators: the
    # sub-models in map order, each the single fit of its map on the fold's
    # rows, scored like the engine
    df = _cv_data(rng, n=120)
    df["w"] = 1.0
    lr = LinearRegression(float32_inputs=False)
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1]).build()
    wev = RegressionEvaluator(metricName="rmse", weightCol="w")
    kw = dict(estimator=lr, estimatorParamMaps=grid, seed=3, collectSubModels=True, parallelism=parallelism)
    cv = CrossValidator(evaluator=wev, numFolds=2, **kw)
    m = cv.fit(df)
    for (train_idx, _), fold_models in zip(cv._kfold_indices(len(df), df), m.subModels):
        for pm, sub in zip(grid, fold_models):
            np.testing.assert_array_equal(sub.coef_, lr.copy(pm).fit(df.iloc[train_idx]).coef_)
    engine = CrossValidator(evaluator=RegressionEvaluator(metricName="rmse"), numFolds=2, **kw).fit(df)
    np.testing.assert_allclose(m.avgMetrics, engine.avgMetrics, rtol=1e-9)
    t = TrainValidationSplit(evaluator=wev, trainRatio=0.75, **kw).fit(df)
    assert [sub.getOrDefault("regParam") for sub in t.subModels] == [0.0, 0.1]
    perm = np.random.default_rng(3).permutation(len(df))
    train = df.iloc[perm[:90]]
    for pm, sub in zip(grid, t.subModels):
        np.testing.assert_array_equal(sub.coef_, lr.copy(pm).fit(train).coef_)


# ------------------------------------------------------------- Pipeline --


def _pipe_data(rng, n=300, d=8):
    x = rng.normal(size=(n, d))
    x[:, 0] *= 6.0
    x[:, 1] *= 4.0
    y = (x[:, 0] / 6.0 + 0.5 * x[:, 1] / 4.0 > 0).astype(float)
    return pd.DataFrame({"features": [Vectors.dense(r) for r in x], "label": y}), x, y


def test_pipeline_pca_then_logreg(rng, tmp_path):
    df, x, y = _pipe_data(rng)
    pca = PCA(k=4, inputCol="features", outputCol="pca_features", float32_inputs=False)
    lr = LogisticRegression(maxIter=100, regParam=0.01, float32_inputs=False).setFeaturesCol("pca_features")
    model = Pipeline(stages=[pca, lr]).fit(df)
    assert isinstance(model, PipelineModel) and len(model.stages) == 2
    out = model.transform(df)
    assert {"pca_features", "prediction", "probability"} <= set(out.columns)
    assert (out["prediction"].to_numpy() == y).mean() > 0.9
    pca_model = pca.fit(df)
    manual = lr.fit(pca_model.transform(df)).transform(pca_model.transform(df))["prediction"].to_numpy()
    np.testing.assert_array_equal(out["prediction"].to_numpy(), manual)
    # the JAX pipeline on the same data predicts the same
    jdf = pd.DataFrame({"features": [JaxVectors.dense(r) for r in x], "label": y})
    jmodel = JaxPipeline(stages=[
        JaxPCA(k=4, inputCol="features", outputCol="pca_features", float32_inputs=False, num_workers=1),
        JaxLogisticRegression(maxIter=100, regParam=0.01, float32_inputs=False, num_workers=1)
        .setFeaturesCol("pca_features"),
    ]).fit(jdf)
    np.testing.assert_array_equal(out["prediction"].to_numpy(), jmodel.transform(jdf)["prediction"].to_numpy())
    path = str(tmp_path / "pipe")
    model.save(path)
    with pytest.raises(FileExistsError):
        model.save(path)
    loaded = PipelineModel.load(path)
    np.testing.assert_array_equal(loaded.transform(df)["prediction"].to_numpy(), out["prediction"].to_numpy())
    # a pipeline saved by the JAX package loads in the port
    jpath = str(tmp_path / "jpipe")
    jmodel.save(jpath)
    jloaded = PipelineModel.load(jpath)
    assert type(jloaded.stages[1]).__module__.startswith("spark_rapids_ml_tpu_torch.")
    np.testing.assert_array_equal(jloaded.transform(df)["prediction"].to_numpy(),
                                  jmodel.transform(jdf)["prediction"].to_numpy())


def test_pipeline_transformer_stage_passthrough(rng):
    df, x, y = _pipe_data(rng, n=200)
    pca_model = PCA(k=3, inputCol="features", outputCol="p", float32_inputs=False).fit(df)
    model = Pipeline(stages=[pca_model, LogisticRegression(maxIter=50, float32_inputs=False).setFeaturesCol("p")]).fit(df)
    assert model.stages[0] is pca_model
    out = model.transform(df)
    assert "prediction" in out.columns and len(out) == 200


def test_cross_validator_over_pipeline(rng):
    # CV sweeping a stage param of a Pipeline takes the per-model fallback
    # (Pipeline.copy routes the grid entry to the stage that owns it)
    df, x, y = _pipe_data(rng, n=240)
    lr = LogisticRegression(maxIter=60, float32_inputs=False).setFeaturesCol("pca_features")
    pipe = Pipeline(stages=[PCA(k=4, inputCol="features", outputCol="pca_features", float32_inputs=False), lr])
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.001, 1.0]).build()
    cv_model = CrossValidator(estimator=pipe, estimatorParamMaps=grid,
                              evaluator=MulticlassClassificationEvaluator(metricName="accuracy"),
                              numFolds=2, seed=1).fit(df)
    assert len(cv_model.avgMetrics) == 2
    assert int(np.argmax(cv_model.avgMetrics)) == 0
    assert (cv_model.transform(df)["prediction"].to_numpy() == y).mean() > 0.9


def test_pipeline_copy_ambiguous_param_raises():
    lr, pca = LogisticRegression(), PCA(k=2)
    pipe = Pipeline(stages=[pca, lr])
    with pytest.raises(ValueError, match="ambiguous"):
        pipe.copy({lr.getParam("featuresCol"): "x"})
    out = pipe.copy({lr.getParam("regParam"): 0.5})
    assert out.getStages()[1].getOrDefault("regParam") == 0.5
    assert out.getStages()[0].getOrDefault("k") == 2


def test_pipeline_copy_unmatched_param_raises():
    pipe = Pipeline(stages=[PCA(k=2), LogisticRegression()])
    with pytest.raises(ValueError, match="no stage"):
        pipe.copy({"regParamm": 0.5})
    with pytest.raises(ValueError, match="no stage"):
        pipe.copy({"maxDepth": 3})


def test_pipeline_validation():
    with pytest.raises(ValueError, match="stages"):
        Pipeline().fit(pd.DataFrame({"features": []}))
    with pytest.raises(TypeError, match="stage 0"):
        Pipeline(stages=[object()]).fit(pd.DataFrame({"features": []}))
    with pytest.raises(ValueError, match="no stages"):
        PipelineModel().save("unused")
