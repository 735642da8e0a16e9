#
# The PyTorch port as a package: it imports neither jax nor anything of the
# JAX package, it runs on the card unless asked for the CPU, it reads and
# writes the JAX package's saved-model layout, and its API surface (params,
# feature column kinds) behaves as the JAX package's does.
#
import types
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu.models.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.models.clustering import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu_torch import KMeans, KMeansModel, Vectors, set_devices
from spark_rapids_ml_tpu_torch.convert import kmeans_model_from_jax

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "spark_rapids_ml_tpu_torch"


@pytest.fixture(autouse=True)
def port_on_cpu():
    set_devices("cpu")
    yield
    set_devices(None)


def _x(n=300, d=5, seed=0):
    from sklearn.datasets import make_blobs

    x, _ = make_blobs(n_samples=n, n_features=d, centers=4, cluster_std=0.8, random_state=seed)
    return x.astype(np.float32)


def _pred(model, data):
    return np.asarray(model.transform(data)["prediction"], dtype=np.int64)


# ------------------------------------------------------ import boundary ----


_GUARD = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
from spark_rapids_ml_tpu_torch import KMeans, NearestNeighbors, set_devices
set_devices("cpu")
x = np.random.default_rng(0).normal(size=(200, 4)).astype(np.float32)
m = KMeans(k=3, maxIter=4, seed=1).fit({"features": x})
m.transform({"features": x})
KMeans(k=64, maxIter=2, seed=1).fit({"features": x})  # k-means|| seeding too
from spark_rapids_ml_tpu_torch.core import config
config.update(hbm_budget_bytes=30000, stream_chunk_rows=64)  # the out-of-core path too
assert KMeans(k=3, maxIter=4, seed=1).fit({"features": x})._fit_metrics["admission"]["verdict"] == "stream"
config.update(hbm_budget_bytes=None, stream_chunk_rows=0)
from spark_rapids_ml_tpu_torch import LogisticRegression, PCA
from spark_rapids_ml_tpu_torch.parallel import chaos  # recovery: checkpoints, a retry, a resume
config.update(checkpoint_every_iters=2, fit_retry_backoff_s=0.01)
for est in (KMeans(k=3, maxIter=4, seed=1), LogisticRegression(maxIter=6), PCA(k=2, inputCol="features")):
    chaos.set_fault_plan("fail:stage=solve:times=1")
    est.fit({"features": x, "label": (x[:, 0] > 0).astype(float)})
config.update(checkpoint_every_iters=0)
import scipy.sparse as sp
from spark_rapids_ml_tpu_torch import LinearRegression, LogisticRegression
xs = sp.csr_matrix(np.where(np.abs(x) > 0.7, x, 0.0))  # CSR: the padded-ELL fits and the sparse kNN
sdata = {"features": xs, "label": (x[:, 0] > 0).astype(float)}
LinearRegression().fit(sdata).transform(sdata)
slr = LogisticRegression(maxIter=5)
slr.fit(sdata, [{slr.getParam("regParam"): v} for v in (0.0, 0.1)])
config.update(hbm_budget_bytes=30000, stream_chunk_rows=64)
assert LogisticRegression(maxIter=3).fit(sdata)._fit_metrics["admission"]["verdict"] == "stream"
config.update(hbm_budget_bytes=None, stream_chunk_rows=0)
NearestNeighbors(k=3).setInputCol("features").fit({"features": xs}).kneighbors({"features": x[:4]})
nn = NearestNeighbors(k=5).setInputCol("features").fit({"features": x})
nn.exactNearestNeighborsJoin({"features": x[:7]})  # kneighbors inside
from spark_rapids_ml_tpu_torch import ApproximateNearestNeighbors
for algo, ap in (("ivfflat", {"nlist": 64}), ("ivfpq", {"nlist": 4, "M": 2}), ("cagra", {})):
    ann = ApproximateNearestNeighbors(k=5, algorithm=algo, algoParams=ap).setInputCol("features")
    ann.fit({"features": x}).approxSimilarityJoin({"features": x[:7]})
from spark_rapids_ml_tpu_torch import ModelRegistry, RandomForestClassifier, ScoringEngine
rf = RandomForestClassifier(numTrees=2, maxDepth=3).fit({"features": x, "label": (x[:, 0] > 0).astype(float)})
registry = ModelRegistry()
registry.load("km", m)
registry.load("nn", nn, serve_dtype="bf16")
registry.load("rf", rf)
with ScoringEngine(registry) as engine:
    assert engine.score("km", x[:3]).shape == (3,)
    d, i = engine.score("nn", x[:2])
    assert list(i[:, 0]) == [0, 1]
    assert engine.score("rf", x[:3]).shape == (3, 2)
from spark_rapids_ml_tpu_torch import (
    CrossValidator, LinearRegression, ParamGridBuilder, Pipeline, PipelineModel, PCA, RegressionEvaluator,
)
data = {"features": x, "label": x[:, 0] - 2.0 * x[:, 1]}
lr = LinearRegression()
grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1]).build()
cvm = CrossValidator(estimator=lr, estimatorParamMaps=grid, evaluator=RegressionEvaluator(), numFolds=2).fit(data)
assert len(cvm.avgMetrics) == 2
pm = Pipeline(stages=[PCA(k=2, inputCol="features", outputCol="p"), LinearRegression(featuresCol="p")]).fit(data)
import tempfile, os
with tempfile.TemporaryDirectory() as tmp:
    pm.save(os.path.join(tmp, "pipe"))
    PipelineModel.load(os.path.join(tmp, "pipe")).transform(data)
from spark_rapids_ml_tpu_torch import DBSCAN, DBSCANModel, UMAP, UMAPModel
labels = DBSCAN(eps=1.5, min_samples=4).setFeaturesCol("features").fit({"features": x}).transform({"features": x})
assert len(labels["prediction"]) == len(x)
um = UMAP(n_epochs=4, random_state=0).setFeaturesCol("features").fit({"features": x})
assert um.transform({"features": x[:5]})["embedding"].shape == (5,)
from spark_rapids_ml_tpu_torch import ops_plane, telemetry
from spark_rapids_ml_tpu_torch.serving.overload import LEVEL_DEGRADE, LEVELS
telemetry.enable()  # one ladder walk: scripted burns, then a degraded request and a shed
spec = {"name": "p99", "kind": "latency", "histogram": "serve.e2e_s", "threshold_s": 0.1, "fast_burn": 1.0}
config.update(serve_degraded_dtype="bf16", serve_throttle_rows_per_s=1e9, serve_overload_hold_s=1e6, slo=[spec])
registry = ModelRegistry()
registry.load("km", m)
with ScoringEngine(registry) as engine:
    ctl = engine._overload
    ctl.force_level("t", LEVEL_DEGRADE)
    assert engine.submit("km", x[:3], tenant="t").result(30).shape == (3,)
    ctl._tenant_burn = lambda tenant, spec: 5.0
    ctl.evaluate(spec, now=1e9)
    assert LEVELS[ctl.level("t")] == "shed"
ctr = telemetry.registry().snapshot()["counters"]
assert ctr["serve.degraded_requests"] == 1 and ctr["serve.backpressure_transitions"] == 2
assert [d["verdict"] for d in ops_plane.report()["decisions"] if d["kind"] == "backpressure"] == ["degrade", "shed"]
from spark_rapids_ml_tpu_torch import FitScheduler, checkpoint  # the fit scheduler: two tenants, a preemption
from spark_rapids_ml_tpu_torch.errors import PreemptedError
from spark_rapids_ml_tpu_torch.scheduler import FitJob, job_scope
with FitScheduler() as sched:
    jobs = [sched.submit(KMeans(k=3, maxIter=4, seed=1), {"features": x}, tenant=t) for t in ("a", "b")]
    assert [j.result(60)._fit_metrics["scheduler"]["tenant"] for j in jobs] == ["a", "b"]
config.update(checkpoint_every_iters=2)
job = FitJob(1, LogisticRegression(maxIter=6), {"features": x, "label": (x[:, 0] > 0).astype(float)}, "t", 0)
job.request_preempt("guard")
try:
    with job_scope(job), checkpoint.checkpoint_scope(store=job.store):
        job.estimator.fit(job.dataset)
    raise AssertionError("not preempted")
except PreemptedError as e:
    assert (e.solver, e.iteration) == ("glm_qn", 2)
config.update(checkpoint_every_iters=0)
assert {"a", "b", "_pool"} <= set(ops_plane.report()["tenants"])
import threading  # the fleet plane: one ops round of three thread ranks
from spark_rapids_ml_tpu_torch.ops_plane import fleet
from spark_rapids_ml_tpu_torch.parallel import LocalRendezvous
rdvs = LocalRendezvous.create(3, timeout_s=30.0)
ts = [threading.Thread(target=fleet.ops_round, args=(rdvs[r],), kwargs={"force": True}) for r in range(3)]
[t.start() for t in ts]
[t.join(60) for t in ts]
view = ops_plane.report(cluster=True)["cluster"]
assert view["ranks_reporting"] == 3 and view["missing"] == [] and view["health"]["healthy"], view
bad = sorted(n for n in sys.modules
             if n == "spark_rapids_ml_tpu" or n.startswith("spark_rapids_ml_tpu."))
assert not bad, bad
assert sys.modules["jax"] is None
print("GUARD-OK")
"""


def test_port_fit_runs_without_jax_or_the_jax_package():
    # a subprocess: this process has imported both already (conftest)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_module_imports_jax_or_the_jax_package(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax"), f"{path}: imports {name}"
        assert top != "spark_rapids_ml_tpu", f"{path}: imports {name}"


# ------------------------------------------------------------- devices ----


def test_entry_points_raise_without_a_card_or_set_devices(monkeypatch):
    set_devices(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _x()
    with pytest.raises(RuntimeError, match=r'set_devices\("cpu"\)'):
        KMeans(k=2, maxIter=2).fit({"features": x})
    model = KMeansModel(cluster_centers_=x[:2], n_cols=5)
    with pytest.raises(RuntimeError, match=r'set_devices\("cpu"\)'):
        model.transform({"features": x})
    from spark_rapids_ml_tpu_torch import ModelRegistry

    with pytest.raises(RuntimeError, match=r'set_devices\("cpu"\)'):
        ModelRegistry().load("km", model)


def test_more_than_one_worker_is_refused(monkeypatch):
    # num_workers is clamped to the visible devices, as the JAX package
    # clamps it: on one device num_workers=2 fits there, equal to
    # num_workers=1; a rank of a multi-process context driving more than
    # one card (A10i, second half) is refused
    x = _x()
    two = KMeans(k=2, seed=1, num_workers=2).fit({"features": x})
    one = KMeans(k=2, seed=1).fit({"features": x})
    np.testing.assert_array_equal(two.cluster_centers_, one.cluster_centers_)
    from spark_rapids_ml_tpu_torch import parallel

    monkeypatch.setattr(parallel, "visible_device_count", lambda: 2)
    monkeypatch.setattr(parallel, "spmd_context", lambda: types.SimpleNamespace(backend="gloo", is_spmd=True, rank=0, nranks=2))
    with pytest.raises(NotImplementedError, match="A10"):
        KMeans(k=2, num_workers=2).fit({"features": x})


def test_param_map_lists_return_the_single_fits():
    # a list of param maps fits each over one placement: the models equal
    # the single fits of the same maps, in the list's order
    est = KMeans(k=2, maxIter=5, seed=1)
    data = {"features": _x()}
    maps = [{est.getParam("k"): 3}, {est.getParam("k"): 2, est.getParam("maxIter"): 2}]
    models = est.fit(data, maps)
    assert [m.cluster_centers_.shape[0] for m in models] == [3, 2]
    for pm, m in zip(maps, models):
        single = est.copy(pm).fit(data)
        np.testing.assert_array_equal(m.cluster_centers_, single.cluster_centers_)
        assert m.n_iter_ == single.n_iter_ and m.getOrDefault("k") == single.getOrDefault("k")
    with pytest.raises(ValueError, match="warm_start_from"):
        est.fit(data, maps, warm_start_from=models[0])


# --------------------------------------------------------- persistence ----


def test_jax_saved_model_loads_and_predicts_the_same(tmp_path):
    x = _x(seed=3)
    jm = JaxKMeans(k=4, maxIter=10, seed=2, num_workers=1).setPredictionCol("cluster").fit({"features": x})
    path = str(tmp_path / "jax_model")
    jm.write().overwrite().save(path)
    tm = KMeansModel.load(path)
    np.testing.assert_array_equal(tm.cluster_centers_, jm.cluster_centers_)
    assert tm.n_iter_ == jm.n_iter_ and tm.inertia_ == jm.inertia_
    assert tm.getOrDefault("predictionCol") == "cluster"
    jp = np.asarray(jm.transform({"features": x})["cluster"])
    np.testing.assert_array_equal(np.asarray(tm.transform({"features": x})["cluster"]), jp)
    conv = kmeans_model_from_jax(jm._model_attributes)
    np.testing.assert_array_equal(_pred(conv, {"features": x}), jp)
    assert conv.numClusters == 4 and len(conv.clusterCenters()) == 4


def test_port_saved_model_loads_in_jax_and_back(tmp_path):
    x = _x(seed=4)
    tm = KMeans(k=4, maxIter=10, seed=3).fit({"features": x})
    path = str(tmp_path / "port_model")
    tm.write().overwrite().save(path)
    assert sorted(os.listdir(path)) == ["arrays.npz", "attributes.json", "metadata.json"]
    jm = JaxKMeansModel.load(path)
    back = KMeansModel.load(path)
    expect = _pred(tm, {"features": x})
    np.testing.assert_array_equal(_pred(jm, {"features": x}), expect)
    np.testing.assert_array_equal(_pred(back, {"features": x}), expect)
    assert back.uid == tm.uid and back.inertia_ == tm.inertia_
    with pytest.raises(FileExistsError):
        tm.write().save(path)


def test_float64_model_from_jax_attributes_stays_float64():
    x = _x(seed=5).astype(np.float64)
    jm = JaxKMeans(k=3, maxIter=5, seed=1, num_workers=1, float32_inputs=False).fit({"features": x})
    conv = kmeans_model_from_jax(jm._model_attributes)
    assert not conv.float32_inputs
    np.testing.assert_array_equal(_pred(conv, {"features": x}), _pred(jm, {"features": x}))
    with pytest.raises(ValueError, match="lack"):
        kmeans_model_from_jax({"cluster_centers_": x[:3]})


def test_estimator_save_load_keeps_params(tmp_path):
    est = KMeans(k=7, maxIter=3, seed=9, initMode="random").setTol(0.0)
    path = str(tmp_path / "est")
    est.write().overwrite().save(path)
    back = KMeans.load(path)
    assert back.getK() == 7 and back.getInitMode() == "random"
    assert back.solver_params["tol"] == 1e-16 and back.solver_params["max_iter"] == 3


# ------------------------------------------------- API surface, ingest ----


@pytest.mark.parametrize("kind", ["array", "vector", "list", "multi_cols", "pandas_array"])
def test_feature_column_kinds_give_the_same_fit(kind):
    x = _x(seed=6)
    ref = KMeans(k=4, maxIter=10, seed=5).fit({"features": x})
    if kind == "array":
        data, est = {"features": x}, KMeans(k=4, maxIter=10, seed=5)
    elif kind == "vector":
        data = pd.DataFrame({"features": [Vectors.dense(v) for v in x]})
        est = KMeans(k=4, maxIter=10, seed=5)
    elif kind == "list":
        data = pd.DataFrame({"features": [list(map(float, v)) for v in x]})
        est = KMeans(k=4, maxIter=10, seed=5)
    elif kind == "multi_cols":
        data = pd.DataFrame({f"c{i}": x[:, i] for i in range(x.shape[1])})
        est = KMeans(k=4, maxIter=10, seed=5).setFeaturesCol([f"c{i}" for i in range(x.shape[1])])
    else:
        data = pd.DataFrame({"features": list(x)})
        est = KMeans(k=4, maxIter=10, seed=5)
    model = est.fit(data)
    np.testing.assert_allclose(model.cluster_centers_, ref.cluster_centers_, rtol=1e-6)
    np.testing.assert_array_equal(_pred(model, data), _pred(ref, {"features": x}))


def test_sparse_input_names_its_roadmap_item():
    # (named when sparse input raised for ROADMAP A11b) KMeans has no CSR
    # path: SparseVector cells and a scipy CSR block are densified at
    # extraction, as in the JAX package, and fit as the dense rows do
    import scipy.sparse as sp

    x = np.round(_x(seed=31)) * (np.random.default_rng(31).random((300, 5)) > 0.4)
    rows = [Vectors.sparse(5, np.nonzero(r)[0].tolist(), r[np.nonzero(r)[0]].tolist()) for r in x]
    dense = KMeans(k=4, maxIter=10, seed=5).fit({"features": x})
    for data in (pd.DataFrame({"features": rows}), {"features": sp.csr_matrix(x)}):
        model = KMeans(k=4, maxIter=10, seed=5).fit(data)
        np.testing.assert_array_equal(model.cluster_centers_, dense.cluster_centers_)
    jm = JaxKMeans(k=4, maxIter=10, seed=5, num_workers=1).fit({"features": sp.csr_matrix(x)})
    np.testing.assert_allclose(dense.cluster_centers_, jm.cluster_centers_, rtol=1e-6)
    np.testing.assert_array_equal(_pred(dense, {"features": sp.csr_matrix(x)}), _pred(dense, {"features": x}))


def test_params_mirror_the_jax_estimator():
    est = KMeans(k=5, maxIter=7, seed=3, initMode="random").setTol(0.0)
    jest = JaxKMeans(k=5, maxIter=7, seed=3, initMode="random").setTol(0.0)
    assert est.solver_params == jest.solver_params
    assert est.solver_params["tol"] == 1e-16
    with pytest.raises(ValueError, match="euclidean"):
        KMeans(k=2, distanceMeasure="cosine")
    with pytest.raises(ValueError, match="Unknown parameter"):
        KMeans(no_such_param=1)
    with pytest.raises(ValueError, match="solver_precision"):
        KMeans(k=2, solver_precision="fp8").fit({"features": _x()})


def test_single_vector_predict_agrees_with_transform():
    x = _x(seed=7)
    model = KMeans(k=4, maxIter=10, seed=2).setPredictionCol("c").fit({"features": x})
    out = model.transform({"features": x})
    assert [model.predict(v) for v in x[:20]] == list(np.asarray(out["c"][:20]))
    assert model.predict(Vectors.dense(x[0])) == int(out["c"].iloc[0])


def test_transform_of_zero_rows():
    model = KMeans(k=2, maxIter=2, seed=1).fit({"features": _x()})
    out = model.transform({"features": np.zeros((0, 5), np.float32)})
    assert len(out["prediction"]) == 0


def test_warm_start_rejects_a_mismatched_donor():
    x = _x()
    donor = KMeans(k=3, maxIter=2).fit({"features": x})
    with pytest.raises(ValueError, match="warm-start centers shape"):
        KMeans(k=4).fit({"features": x}, warm_start_from=donor)
    with pytest.raises(TypeError, match="cannot warm-start"):
        KMeans(k=4).fit({"features": x}, warm_start_from=object())
