#
# The PyTorch port's RandomForestClassifier and RandomForestRegressor
# (spark_rapids_ml_tpu_torch/models/tree.py, the forest classes of
# models/classification.py and models/regression.py, their convert.py
# functions and their serving) against the JAX package's, through the
# public API, on the same inputs made with numpy from a seed. The port runs
# on the CPU; the JAX estimators on one CPU device (num_workers=1), float64
# enabled (tests/conftest.py). The JAX fits are few and small (1200 rows,
# 10 columns, 3 trees of depth 4, 16 bins) and shared through module-scope
# fixtures.
#
# Tolerances, and why:
#   * without the bootstrap, `feature`, `threshold` and `node_stats` equal
#     JAX's exactly: the statistics are integers (class counts, integer
#     labels, integer weights), so both packages' histograms are exact, and
#     the draws of feature subsets are the same bits (tests/
#     test_torch_trees.py);
#   * the transform: probabilities and predictions within rtol 1e-6 of
#     JAX's (the port sums the trees' leaf values in tree order, jnp.mean
#     in XLA's order: a few float32 ulps), the predicted class equal on
#     every row whose two largest probabilities lie more than 1e-5 apart;
#   * with the bootstrap on, the forests part where the draws do (the port
#     counts, JAX searches a float32 cumulative sum): holdout accuracy
#     within 0.05 of JAX's and R² within 0.05. On 600 holdout rows at an
#     accuracy near 0.8 the binomial standard error is 0.016, so 0.05 is
#     three of them, and at most 1% of the draws part;
#   * featureImportances, treesToJson, toDebugString, totalNumNodes: equal,
#     the same host code on the same arrays;
#   * save/load, convert.py and serving: bit for bit (a coalesced response
#     equals the same request served alone and the transform).
#
import types
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models.classification import RandomForestClassificationModel as JaxRFCModel
from spark_rapids_ml_tpu.models.classification import RandomForestClassifier as JaxRFC
from spark_rapids_ml_tpu.models.regression import RandomForestRegressionModel as JaxRFRModel
from spark_rapids_ml_tpu.models.regression import RandomForestRegressor as JaxRFR
from spark_rapids_ml_tpu_torch import (
    ModelRegistry,
    RandomForestClassificationModel,
    RandomForestClassifier,
    RandomForestRegressionModel,
    RandomForestRegressor,
    ScoringEngine,
    Vectors,
    set_devices,
)
from spark_rapids_ml_tpu_torch.convert import (
    random_forest_classification_model_from_jax,
    random_forest_regression_model_from_jax,
)
from spark_rapids_ml_tpu_torch.core import config

FOREST = {"numTrees": 3, "maxDepth": 4, "maxBins": 16, "seed": 7}


@pytest.fixture(autouse=True)
def port_on_cpu():
    set_devices("cpu")
    yield
    set_devices(None)


def _data(n=1200, d=10, seed=0):
    """Features of different scales; 3 classes from a noisy score of the
    first three; integer regression labels from a nonlinear function; integer
    row weights 0..3."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d)).astype(np.float32)
    y3 = np.argmax(x[:, :3] + 0.8 * rng.normal(size=(n, 3)), axis=1).astype(np.float64)
    yi = np.round(2 * x[:, 0] + x[:, 1] ** 2 / 4 + rng.normal(size=n)).astype(np.float64)
    w = rng.integers(0, 4, size=n).astype(np.float64)
    return x, y3, yi, w


X, Y3, YI, W = _data()

# name -> (classification, estimator params, data keys)
CASES = {
    "gini": (True, {"impurity": "gini"}, {}),
    "entropy": (True, {"impurity": "entropy"}, {}),
    "variance": (False, {}, {}),
    "weighted": (True, {"weightCol": "w"}, {"w": W}),
    "min_instances": (False, {"minInstancesPerNode": 8}, {}),
    "min_info_gain": (True, {"impurity": "entropy", "minInfoGain": 0.01}, {}),
    "float64_clf": (True, {"float32_inputs": False}, {}),
    "float64_reg": (False, {"float32_inputs": False, "featureSubsetStrategy": "all"}, {}),
}


def _case_data(name):
    clf, params, extra = CASES[name]
    x = X if params.get("float32_inputs", True) else X.astype(np.float64)
    return {"features": x, "label": Y3 if clf else YI, **extra}


@pytest.fixture(scope="module")
def fits():
    set_devices("cpu")
    out = {}
    for name, (clf, params, _) in CASES.items():
        kw = dict(FOREST, bootstrap=False, **params)
        data = _case_data(name)
        jcls, tcls = (JaxRFC, RandomForestClassifier) if clf else (JaxRFR, RandomForestRegressor)
        out[name] = (jcls(num_workers=1, **kw).fit(data), tcls(**kw).fit(data))
    set_devices(None)
    return out


def _arrays(m):
    return m.feature, m.threshold, m.node_stats


def _columns(model, data):
    out = model.transform(data)
    if "probability" in out:
        return np.stack(out["rawPrediction"].to_numpy()), np.stack(out["probability"].to_numpy()), \
            np.asarray(out["prediction"])
    return (np.asarray(out["prediction"]),)


@pytest.mark.parametrize("name", list(CASES))
def test_forest_matches_jax_without_bootstrap(fits, name):
    jm, tm = fits[name]
    for got, want in zip(_arrays(tm), _arrays(jm)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.classes_, jm.classes_)
    assert (tm.feature >= 0).any() and tm.dtype == jm.dtype
    if name in ("min_instances", "min_info_gain"):  # the limits prune
        base = fits["variance" if name == "min_instances" else "entropy"][1]
        assert (tm.feature >= 0).sum() < (base.feature >= 0).sum()
    data = _case_data(name)
    got, want = _columns(tm, data), _columns(jm, data)
    if len(got) == 1:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        return
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    top2 = np.sort(want[1], axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-5
    np.testing.assert_array_equal(got[2][clear], want[2][clear])
    np.testing.assert_allclose(got[1].sum(axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("name", ["gini", "entropy", "variance", "min_info_gain"])
def test_model_surface_matches_jax(fits, name):
    jm, tm = fits[name]
    np.testing.assert_array_equal(tm.featureImportances.toArray(), jm.featureImportances.toArray())
    assert tm.treesToJson() == jm.treesToJson()
    assert tm.toDebugString() == jm.toDebugString()
    assert tm.totalNumNodes == jm.totalNumNodes and tm.getNumTrees == jm.getNumTrees == 3
    assert tm.numFeatures == jm.numFeatures == X.shape[1]
    if CASES[name][0]:
        assert tm.numClasses == jm.numClasses == 3


def test_single_vector_predict_agrees_with_transform(fits):
    _, clf = fits["gini"]
    raw, prob, pred = _columns(clf, {"features": X[:25]})
    for i in range(25):
        assert clf.predict(X[i]) == pred[i]
        np.testing.assert_array_equal(clf.predictRaw(Vectors.dense(X[i])).toArray(), raw[i])
        np.testing.assert_array_equal(clf.predictProbability(X[i]).toArray(), prob[i])
    _, reg = fits["variance"]
    (pred,) = _columns(reg, {"features": X[:25]})
    assert [reg.predict(v) for v in X[:25]] == list(pred.astype(np.float64))


def test_vector_column_gives_vector_outputs(fits):
    _, clf = fits["gini"]
    out = clf.transform({"features": [Vectors.dense(v) for v in X[:6]]})
    assert all(hasattr(v, "toArray") for v in out["probability"])
    np.testing.assert_array_equal(np.stack([v.toArray() for v in out["probability"]]),
                                  _columns(clf, {"features": X[:6]})[1])


def test_transform_does_not_depend_on_its_batch(fits, monkeypatch):
    for name in ("entropy", "variance"):
        _, m = fits[name]
        whole = m._transform_arrays(X)
        monkeypatch.setitem(config, "max_records_per_batch", 37)
        np.testing.assert_array_equal(m._transform_arrays(X), whole)
        monkeypatch.setitem(config, "max_records_per_batch", 1 << 16)


@pytest.mark.parametrize("clf", [True, False], ids=["classifier", "regressor"])
def test_bootstrap_forest_quality_within_bound_of_jax(clf):
    x, y3, yi, _ = _data(n=1800, seed=3)
    y = y3 if clf else yi
    train, test = slice(0, 1200), slice(1200, None)
    kw = dict(FOREST, bootstrap=True)
    jcls, tcls = (JaxRFC, RandomForestClassifier) if clf else (JaxRFR, RandomForestRegressor)
    jm = jcls(num_workers=1, **kw).fit({"features": x[train], "label": y[train]})
    tm = tcls(**kw).fit({"features": x[train], "label": y[train]})
    again = tcls(**kw).fit({"features": x[train], "label": y[train]})
    for a, b in zip(_arrays(again), _arrays(tm)):
        np.testing.assert_array_equal(a, b)  # the same fit twice: bit for bit

    def score(m):
        pred = np.asarray(m.transform({"features": x[test]})["prediction"], dtype=np.float64)
        if clf:
            return np.mean(pred == y[test])
        return 1.0 - np.sum((pred - y[test]) ** 2) / np.sum((y[test] - y[test].mean()) ** 2)

    ours, theirs = score(tm), score(jm)
    assert ours > (0.5 if clf else 0.3)
    assert abs(ours - theirs) <= 0.05, (ours, theirs)


# ------------------------------------------------------------ the API ----


def test_params_mirror_the_jax_estimator():
    for tcls, jcls in ((RandomForestClassifier, JaxRFC), (RandomForestRegressor, JaxRFR)):
        est, jest = tcls(numTrees=9, maxDepth=3, seed=4), jcls(numTrees=9, maxDepth=3, seed=4)
        want = {k: v for k, v in jest.solver_params.items() if k != "node_chunk"}
        assert est.solver_params == want
        assert est.getNumTrees() == 9 and est.getMaxDepth() == 3
    with pytest.raises(ValueError, match="gini"):
        RandomForestClassifier(impurity="variance")
    with pytest.raises(ValueError, match="variance"):
        RandomForestRegressor(impurity="gini")
    with pytest.raises(ValueError, match="Unknown parameter"):
        RandomForestClassifier(node_chunk=64)
    from spark_rapids_ml_tpu_torch import parallel

    with pytest.MonkeyPatch.context() as mp:  # two cards for a rank of a multi-process context: A10i
        mp.setattr(parallel, "visible_device_count", lambda: 2)
        mp.setattr(parallel, "spmd_context", lambda: types.SimpleNamespace(backend="gloo", is_spmd=True, rank=0, nranks=2))
        with pytest.raises(NotImplementedError, match="A10"):
            RandomForestClassifier(num_workers=2, **FOREST).fit({"features": X, "label": Y3})


@pytest.mark.parametrize("call", ["cpu", "predictLeaf", "evaluate"])
def test_left_out_surface_names_a16(fits, call):
    _, m = fits["gini"]
    with pytest.raises(NotImplementedError, match="A16"):
        getattr(m, call)(*(() if call == "cpu" else (X[0],) if call == "predictLeaf" else ({"features": X},)))


# ------------------------------------------------------- persistence ----


@pytest.mark.parametrize("name", ["gini", "float64_reg"])
def test_jax_saved_model_loads_and_predicts_the_same(fits, name, tmp_path):
    jm, tm = fits[name]
    path = str(tmp_path / name)
    jm.write().overwrite().save(path)
    cls = RandomForestClassificationModel if CASES[name][0] else RandomForestRegressionModel
    loaded = cls.load(path)
    for got, want in zip(_arrays(loaded), _arrays(jm)):
        np.testing.assert_array_equal(got, want)
    assert loaded.float32_inputs == jm.float32_inputs
    data = _case_data(name)
    for got, want in zip(_columns(loaded, data), _columns(tm, data)):
        np.testing.assert_array_equal(got, want)
    convert = random_forest_classification_model_from_jax if CASES[name][0] else random_forest_regression_model_from_jax
    conv = convert(jm._model_attributes)
    assert conv.float32_inputs == jm.float32_inputs
    for got, want in zip(_columns(conv, data), _columns(tm, data)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["entropy", "variance"])
def test_port_saved_model_loads_in_jax_and_back(fits, name, tmp_path):
    _, tm = fits[name]
    path = str(tmp_path / name)
    tm.write().overwrite().save(path)
    assert sorted(os.listdir(path)) == ["arrays.npz", "attributes.json", "metadata.json"]
    jcls, tcls = (JaxRFCModel, RandomForestClassificationModel) if CASES[name][0] else \
        (JaxRFRModel, RandomForestRegressionModel)
    jm, back = jcls.load(path), tcls.load(path)
    for a, b, c in zip(_arrays(back), _arrays(jm), _arrays(tm)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    data = _case_data(name)
    for got, want, theirs in zip(_columns(back, data), _columns(tm, data), _columns(jm, data)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(theirs, want, rtol=1e-6)
    assert back.uid == tm.uid and back.getOrDefault("impurity") == tm.getOrDefault("impurity")
    assert back.toDebugString() == tm.toDebugString()


def test_convert_refuses_incomplete_attributes(fits):
    with pytest.raises(ValueError, match="lack"):
        random_forest_classification_model_from_jax({"feature": np.zeros((1, 3))})
    attrs = dict(fits["gini"][0]._model_attributes, node_stats=np.zeros((3, 31)))
    with pytest.raises(ValueError, match="node_stats must be 3-D"):
        random_forest_classification_model_from_jax(attrs)


# ----------------------------------------------------------- serving ----


@pytest.fixture
def small_ladder(monkeypatch):
    for k, v in {"transform_bucket_min_rows": 8, "serve_prewarm_rows": 64, "serve_max_batch_rows": 256,
                 "serve_coalesce_window_ms": 25.0}.items():
        monkeypatch.setitem(config, k, v)


def test_forests_serving_coalesced_equals_solo_and_transform(fits, small_ladder):
    models = {"rfc": fits["gini"][1], "rfr": fits["float64_reg"][1]}
    registry = ModelRegistry()
    for name, m in models.items():
        registry.load(name, m)
    rows = {name: (X if m.float32_inputs else X.astype(np.float64)) for name, m in models.items()}
    requests = [(0, 1), (3, 7), (10, 64), (80, 200), (300, 255), (7, 33)]
    with ScoringEngine(registry, coalesce_window_s=0.0) as engine:
        solo = {name: [engine.score(name, rows[name][lo:lo + n]) for lo, n in requests] for name in models}
    with ScoringEngine(registry) as engine:
        futs = {name: [None] * len(requests) for name in models}

        def submit(name, i):
            lo, n = requests[i]
            futs[name][i] = engine.submit(name, rows[name][lo:lo + n])

        ts = [threading.Thread(target=submit, args=(name, i)) for name in futs for i in range(len(requests))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        coalesced = {name: [f.result(timeout=120) for f in fs] for name, fs in futs.items()}
    whole = {name: m._transform_arrays(rows[name]) for name, m in models.items()}
    for name, m in models.items():
        for i, (lo, n) in enumerate(requests):
            got = coalesced[name][i]
            assert got.dtype == whole[name].dtype and got.shape == (n, m.node_stats.shape[-1] if name == "rfc" else 1)
            np.testing.assert_array_equal(got, solo[name][i])
            np.testing.assert_array_equal(got, whole[name][lo:lo + n])
    registry.clear()


def test_serving_workspace_terms_price_the_descent(fits):
    _, m = fits["gini"]
    terms = m._serve_workspace_terms(256, 4)
    assert terms == {"descent": 3 * 256 * (8 + 8 + 8), "leaf_sum": 2 * 256 * 3 * 4}


# -------------------------------------------------------------- the card ----


@pytest.fixture
def card():
    """A CUDA device for the card tests; skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the forests on the card run on an NVIDIA GPU only (chip_smoke.py phase 9)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("clf", [True, False], ids=["classifier", "regressor"])
def test_forest_on_card_equals_cpu(card, clf):
    cls = RandomForestClassifier if clf else RandomForestRegressor
    data = {"features": X, "label": Y3 if clf else YI}
    cpu = cls(**FOREST).fit(data)
    set_devices(card)
    gpu = cls(**FOREST).fit(data)
    for a, b in zip(_arrays(gpu), _arrays(cpu)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gpu._transform_arrays(X), cpu._transform_arrays(X))


# ---------------------------------------------------- import boundary ----


_GUARD = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
from spark_rapids_ml_tpu_torch import (ModelRegistry, RandomForestClassifier, RandomForestRegressor, ScoringEngine,
                                       set_devices)
set_devices("cpu")
rng = np.random.default_rng(0)
x = rng.normal(size=(300, 5)).astype(np.float32)
c = RandomForestClassifier(numTrees=2, maxDepth=3).fit({"features": x, "label": (x[:, 0] > 0).astype(float)})
r = RandomForestRegressor(numTrees=2, maxDepth=3, bootstrap=False, subsamplingRate=0.5).fit(
    {"features": x, "label": x[:, 1]})
c.transform({"features": x})
r.transform({"features": x})
registry = ModelRegistry()
registry.load("rfc", c)
registry.load("rfr", r)
with ScoringEngine(registry) as engine:
    assert engine.score("rfc", x[:3]).shape == (3, 2)
    assert engine.score("rfr", x[:3]).shape == (3, 1)
bad = sorted(n for n in sys.modules
             if n == "spark_rapids_ml_tpu" or n.startswith("spark_rapids_ml_tpu."))
assert not bad, bad
assert sys.modules["jax"] is None
print("GUARD-OK")
"""


def test_forests_run_without_jax_or_the_jax_package():
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD], cwd=str(root), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
