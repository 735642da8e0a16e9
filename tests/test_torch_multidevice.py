#
# One process driving several chips (the PyTorch port's fan-out: core.py
# `_call_fit_func_fanned`, parallel `run_on_chips` and the in-process
# `LocalGroup`) on the CPU, the port on `set_devices(["cpu"] * 8)`, the JAX
# package on conftest's eight virtual devices, both at the same
# `num_workers`:
#   * the group: gathers in rank order, `allreduce_fixed` equal bit for bit
#     to sums in rank order, fresh tensors, a failing thread raising
#     RankFailedError in its peers within the round deadline;
#   * every estimator the port fits under a multi-process TpuContext, at
#     num_workers 2 and 4, against JAX's fit at the same num_workers, to the
#     tolerance the port's multi-process and one-device tests state (float64:
#     KMeans, PCA, LinearRegression rtol 1e-6 / atol 1e-8; LogisticRegression
#     rtol 1e-4 / atol 1e-6; exact for labels, trees' predictions and kNN ids
#     on data without near-ties), and every chip's model equal to rank 0's
#     bit for bit (the fan-out's digests);
#   * KMeans and LogisticRegression equal bit for bit to the port's two-rank
#     multi-process fit over the same blocks (tests/torch_mp_worker.py
#     `even`);
#   * transforms split over the chips equal to one chip's (the counterparts
#     of tests/test_parallel.py:115/149);
#   * recovery: the host-retained re-layout from 8 chips to 4 with one
#     ingest (tests/test_recovery.py:511) and a sweep resumed inside a carved
#     chip scope (:604).
# Deliberate differences, pinned here: the fan-out places no padding rows
# (a chip's block is the JAX block's valid rows, and chips with no rows do
# not take part); counters of per-chip work (`fit.device_dataset_builds`)
# count once a chip, where JAX counts the mesh's one placement.
#
import os
import subprocess
import sys
import time
import uuid

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_tpu import telemetry as jtele
from spark_rapids_ml_tpu_torch import core as tcore
from spark_rapids_ml_tpu_torch import parallel
from spark_rapids_ml_tpu_torch import telemetry as ttele
from spark_rapids_ml_tpu_torch.errors import RankFailedError
from spark_rapids_ml_tpu_torch.parallel import LocalGroup, TpuContext, run_on_chips

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")


@pytest.fixture(autouse=True)
def _pool():
    parallel.set_devices(["cpu"] * 8)
    saved = {k: tcore.config[k] for k in ("rendezvous_timeout_s", "distributed_transform_min_rows")}
    ttele.enable()
    ttele.registry().reset()
    yield
    tcore.config.update(saved)
    ttele.disable()
    ttele.registry().reset()
    parallel.set_devices(None)


def _blobs(n=600, d=6, k=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8.0, size=(k, d))
    x = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    return x, y


def _md(model):
    md = model._fit_metrics["multidevice"]
    assert md["models_equal"], "a chip's model differs from rank 0's"
    return md


# --------------------------------------------------------------- the group --


def test_group_gathers_in_rank_order_as_fresh_tensors():
    def chip(r):
        g = TpuContext.current().group
        assert isinstance(g, LocalGroup) and g.backend == "local"
        src = torch.full((3,), float(r), dtype=torch.float64)
        got = g.allgather(src)
        rows = g.allgather_rows(torch.arange(r + 1, dtype=torch.float32).reshape(-1, 1))
        arrays = g.allgather_arrays(np.full((r, 2), r))
        got[r].add_(100.0)  # writing into what it got touches no peer's
        return [t.clone() for t in got], src, rows, arrays

    out, stats = run_on_chips(4, chip)
    for r, (got, src, rows, arrays) in enumerate(out):
        for q in range(4):
            want = q + (100.0 if q == r else 0.0)
            assert torch.equal(got[q], torch.full((3,), want, dtype=torch.float64))
        assert torch.equal(src, torch.full((3,), float(r), dtype=torch.float64))
        assert [int(x.shape[0]) for x in rows] == [1, 2, 3, 4]
        assert [a.shape for a in arrays] == [(q, 2) for q in range(4)]
    assert [s["chip_id"] for s in stats] == [0, 1, 2, 3]
    assert all(s["collective_calls"] == 3 for s in stats)


def test_allreduce_fixed_equals_sums_in_rank_order_bit_for_bit():
    rng = np.random.default_rng(5)
    parts = [rng.normal(size=1000).astype(np.float32) * 10.0 ** rng.integers(-6, 6, 1000) for _ in range(4)]
    ints = [rng.integers(-5, 5, size=(3, 4)) for _ in range(4)]

    def chip(r):
        return TpuContext.current().group.allreduce_fixed(torch.from_numpy(parts[r]), torch.from_numpy(ints[r]))

    out, _ = run_on_chips(4, chip)
    want = torch.from_numpy(parts[0])
    for p in parts[1:]:
        want = want + torch.from_numpy(p)
    for f, i in out:
        assert torch.equal(f, want)  # the bits of one order of summation
        np.testing.assert_array_equal(i.numpy(), sum(ints))
    # another order gives other bits somewhere: the rank order is what holds
    other = ((torch.from_numpy(parts[3]) + torch.from_numpy(parts[2])) + torch.from_numpy(parts[1])) + \
        torch.from_numpy(parts[0])
    assert not torch.equal(other, want)


def test_a_failing_thread_unwinds_its_peers_typed_within_the_deadline():
    tcore.config["rendezvous_timeout_s"] = 30.0
    seen = {}

    def chip(r):
        g = TpuContext.current().group
        g.allgather(torch.zeros(2))
        if r == 2:
            raise ValueError("chip 2 fails mid-fit")
        try:
            g.allgather(torch.zeros(2))
        except RankFailedError as e:
            seen[r] = e
            raise

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="chip 2 fails"):
        run_on_chips(4, chip)
    assert time.perf_counter() - t0 < 5.0  # far inside the 30 s deadline
    assert sorted(seen) == [0, 1, 3]
    assert all(e.failed_rank == 2 and "chip 2 fails" in str(e) for e in seen.values())


def test_an_in_process_rendezvous_does_not_reform():
    from spark_rapids_ml_tpu_torch.parallel import InProcessRendezvous

    assert not InProcessRendezvous.create(2)[0].can_reform


# ----------------------------------------------- the estimators, vs JAX ----


def _jax(cls_path, **kw):
    import importlib

    mod, name = cls_path.rsplit(".", 1)
    return getattr(importlib.import_module(mod), name)(**kw)


@pytest.mark.parametrize("workers", [2, 4])
def test_kmeans_equals_jax_at_the_same_num_workers(workers):
    from spark_rapids_ml_tpu_torch import KMeans

    x, _ = _blobs()
    kw = dict(k=4, maxIter=20, seed=3, float32_inputs=False, num_workers=workers)
    t = KMeans(**kw).fit({"features": x})
    j = _jax("spark_rapids_ml_tpu.models.clustering.KMeans", **kw).fit({"features": x})
    md = _md(t)
    assert md["chips"] == workers and md["chip_ids"] == list(range(workers))
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(t.inertia_, j.inertia_, rtol=1e-6)
    assert t.n_iter_ == j.n_iter_
    pt = t.transform({"features": x})["prediction"].to_numpy()
    pj = np.asarray(j.transform({"features": x})["prediction"])
    np.testing.assert_array_equal(pt, pj)


@pytest.mark.parametrize("workers", [2, 4])
def test_pca_and_linear_regression_equal_jax(workers):
    from spark_rapids_ml_tpu_torch import PCA, LinearRegression

    x, _ = _blobs(seed=1)
    y = x @ np.arange(1.0, 7.0) + 0.3
    t = PCA(k=3, inputCol="features", float32_inputs=False, num_workers=workers).fit({"features": x})
    j = _jax("spark_rapids_ml_tpu.models.feature.PCA", k=3, inputCol="features", float32_inputs=False,
             num_workers=workers).fit({"features": x})
    _md(t)
    np.testing.assert_allclose(np.abs(t.components_), np.abs(j.components_), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(t.mean_, j.mean_, rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(t.explained_variance_ratio_, j.explained_variance_ratio_, rtol=1e-6)
    for reg in (0.0, 0.1):
        kw = dict(regParam=reg, elasticNetParam=0.0, float32_inputs=False, num_workers=workers)
        tl = LinearRegression(**kw).fit({"features": x, "label": y})
        jl = _jax("spark_rapids_ml_tpu.models.regression.LinearRegression", **kw).fit({"features": x, "label": y})
        _md(tl)
        np.testing.assert_allclose(tl.coef_, jl.coef_, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(tl.intercept_, jl.intercept_, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("workers", [2, 4])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "ell"])
def test_logistic_regression_equals_jax(workers, sparse):
    from spark_rapids_ml_tpu_torch import LogisticRegression

    x, y = _blobs(seed=2)
    feats = sp.csr_matrix(np.where(np.abs(x) > 2.0, x, 0.0)) if sparse else x
    kw = dict(maxIter=100, regParam=0.1, tol=1e-10, float32_inputs=False, num_workers=workers)
    t = LogisticRegression(**kw).fit({"features": feats, "label": y})
    j = _jax("spark_rapids_ml_tpu.models.classification.LogisticRegression", **kw).fit(
        {"features": feats, "label": y})
    _md(t)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    np.testing.assert_allclose(t.coef_, j.coef_, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t.intercept_, j.intercept_, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("workers", [2, 4])
def test_forests_equal_jax(workers):
    from spark_rapids_ml_tpu_torch import RandomForestClassifier, RandomForestRegressor

    x, y = _blobs(n=300, seed=4)
    yr = x[:, 0] * 2.0 + x[:, 1]
    for name, data, kw in (
        ("RandomForestClassifier", {"features": x, "label": y}, dict(numTrees=4, maxDepth=3, maxBins=16)),
        ("RandomForestRegressor", {"features": x, "label": yr}, dict(numTrees=4, maxDepth=3, maxBins=16)),
    ):
        kw = dict(kw, seed=1, float32_inputs=False, num_workers=workers)
        t = getattr(__import__("spark_rapids_ml_tpu_torch"), name)(**kw).fit(data)
        mod = "classification" if name.endswith("Classifier") else "regression"
        j = _jax(f"spark_rapids_ml_tpu.models.{mod}.{name}", **kw).fit(data)
        _md(t)
        pt = t.transform(data)["prediction"].to_numpy()
        pj = np.asarray(j.transform(data)["prediction"])
        np.testing.assert_allclose(pt, pj, rtol=1e-12, atol=0)


@pytest.mark.parametrize("workers", [2, 4])
def test_dbscan_umap_and_the_searches_equal_jax(workers):
    from spark_rapids_ml_tpu_torch import DBSCAN, UMAP, ApproximateNearestNeighbors, NearestNeighbors

    x, _ = _blobs(n=400, seed=6)
    df = pd.DataFrame({"features": list(x)})
    t = DBSCAN(eps=1.5, min_samples=4, num_workers=workers).setFeaturesCol("features").fit(df).transform(df)
    j = _jax("spark_rapids_ml_tpu.models.clustering.DBSCAN", eps=1.5, min_samples=4, num_workers=workers) \
        .setFeaturesCol("features").fit(df).transform(df)
    np.testing.assert_array_equal(t["prediction"].to_numpy(), np.asarray(j["prediction"]))
    # exact kNN, dense and CSR items, and an exhaustively probed IVFFlat:
    # the ids JAX's merge gives
    q = pd.DataFrame({"features": list(x[:23] + 0.01)})
    _, _, jk = _jax("spark_rapids_ml_tpu.models.knn.NearestNeighbors", k=5, float32_inputs=False,
                    num_workers=workers).setInputCol("features").fit(df).kneighbors(q)
    _, _, tk = NearestNeighbors(k=5, float32_inputs=False, num_workers=workers).setInputCol("features") \
        .fit(df).kneighbors(q)
    np.testing.assert_array_equal(np.stack(tk["indices"]), np.stack(jk["indices"]))
    np.testing.assert_allclose(np.stack(tk["distances"]), np.stack(jk["distances"]), rtol=1e-9)
    np.testing.assert_array_equal(tk["query_id"].to_numpy(), np.arange(23))
    xs = sp.csr_matrix(np.where(np.abs(x) > 3.0, x, 0.0))
    _, _, tks = NearestNeighbors(k=5, float32_inputs=False, num_workers=workers).setInputCol("features") \
        .fit({"features": xs}).kneighbors({"features": xs[:11]})
    _, _, jks = _jax("spark_rapids_ml_tpu.models.knn.NearestNeighbors", k=5, float32_inputs=False,
                     num_workers=1).setInputCol("features").fit({"features": xs}).kneighbors({"features": xs[:11]})
    # the sparse kNN's bound (tests/test_torch_multiprocess_estimators.py)
    np.testing.assert_array_equal(np.stack(tks["indices"]), np.stack(jks["indices"]))
    np.testing.assert_allclose(np.stack(tks["distances"]), np.stack(jks["distances"]), rtol=1e-7, atol=1e-6)
    ap = {"nlist": 4, "nprobe": 4}
    _, _, ta = ApproximateNearestNeighbors(k=5, algorithm="ivfflat", algoParams=ap, num_workers=workers) \
        .setInputCol("features").fit(df).kneighbors(q)
    _, _, ja = _jax("spark_rapids_ml_tpu.models.knn.ApproximateNearestNeighbors", k=5, algorithm="ivfflat",
                    algoParams=ap, num_workers=workers).setInputCol("features").fit(df).kneighbors(q)
    np.testing.assert_array_equal(np.stack(ta["indices"]), np.stack(ja["indices"]))
    np.testing.assert_array_equal(np.stack(ta["indices"]), np.stack(tk["indices"]))
    # UMAP fits once on the first chip over every row, so num_workers does
    # not change its bits (and one chip holds JAX within the one-device
    # bounds, tests/test_torch_umap.py and the test below)
    u_kw = dict(n_epochs=5, init="random", random_state=3)
    u1 = UMAP(num_workers=1, **u_kw).setFeaturesCol("features").fit(df)
    uw = UMAP(num_workers=workers, **u_kw).setFeaturesCol("features").fit(df)
    assert "multidevice" not in (getattr(uw, "_fit_metrics", None) or {})
    np.testing.assert_array_equal(uw.embedding_, u1.embedding_)
    np.testing.assert_array_equal(uw.transform(q)["embedding"].tolist(), u1.transform(q)["embedding"].tolist())


@pytest.mark.parametrize("case", ["sample_fraction", "precomputed_knn"])
def test_umap_at_two_workers_fits_as_jax_single_controller_fit(case):
    """UMAP at num_workers=2 against JAX's fit at num_workers=2: one fit
    over every row, so a sampleFraction below 1 keeps JAX's draw (seed + 0
    over all rows) and a precomputed kNN graph is accepted. Integer rows
    (no kNN ties), 5 random-init epochs: the embedding within
    tests/test_torch_umap.py's atol 1e-3, the sampled rows exact."""
    from spark_rapids_ml_tpu_torch import UMAP
    from spark_rapids_ml_tpu_torch.ops import umap as TO

    rng = np.random.default_rng(4)
    centers = rng.integers(-1000, 1001, size=(4, 8))
    x = (centers[rng.integers(0, 4, 300)] + rng.integers(-60, 61, size=(300, 8))).astype(np.float32)
    df = pd.DataFrame({"features": list(x)})
    kw = dict(n_components=2, n_epochs=5, init="random", random_state=3, num_workers=2)
    if case == "sample_fraction":
        kw["sample_fraction"] = 0.5
    else:
        idx, dist = TO.build_knn_graph(torch.from_numpy(x), 15)
        kw["precomputed_knn"] = (np.asarray(idx), np.asarray(dist))
    t = UMAP(**kw).setFeaturesCol("features").fit(df)
    j = _jax("spark_rapids_ml_tpu.models.umap.UMAP", **kw).setFeaturesCol("features").fit(df)
    np.testing.assert_array_equal(t.raw_data_, np.asarray(j.raw_data_))
    if case == "sample_fraction":
        assert 100 < t.raw_data_.shape[0] < 200
    np.testing.assert_allclose(t.embedding_, np.asarray(j.embedding_), rtol=0, atol=1e-3)
    one = UMAP(**dict(kw, num_workers=1)).setFeaturesCol("features").fit(df)
    np.testing.assert_array_equal(t.embedding_, one.embedding_)


def test_fanned_fits_equal_the_ports_two_rank_multiprocess_fit(tmp_path):
    """KMeans and LogisticRegression over two chips of one process equal the
    port's two processes over the same blocks, bit for bit."""
    from mp_worker import make_dataset

    from spark_rapids_ml_tpu_torch import KMeans, LogisticRegression

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
    env["CUDA_VISIBLE_DEVICES"] = ""
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    run_id = uuid.uuid4().hex
    procs = [subprocess.Popen([sys.executable, WORKER, "even", str(r), "2", str(tmp_path / "rdv"), str(out_dir),
                               run_id], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    X, y_log, _ = make_dataset()
    km = KMeans(k=4, maxIter=15, seed=3, float32_inputs=False, num_workers=2).fit({"features": X})
    lr = LogisticRegression(maxIter=100, regParam=0.1, tol=1e-10, float32_inputs=False, num_workers=2).fit(
        {"features": X, "label": y_log})
    for r, p in enumerate(procs):
        out = p.communicate(timeout=120)[0].decode()
        assert p.returncode == 0, f"rank {r}:\n{out}"
    for r in range(2):
        g = np.load(out_dir / f"rank{r}.npz")
        np.testing.assert_array_equal(g["km_centers"], km.cluster_centers_)
        np.testing.assert_array_equal(g["lr_coef"], lr.coef_)
        np.testing.assert_array_equal(g["lr_intercept"], np.asarray(lr.intercept_))
        assert int(g["lr_iter"]) == lr.n_iter_
    assert _md(km)["rows"] == [60, 60]


# -------------------------------------------------------------- transforms --


def test_distributed_transform_matches_single_device():
    from spark_rapids_ml_tpu_torch import LogisticRegression

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 8))
    y = (x[:, 0] > 0).astype(np.float64)
    df = pd.DataFrame({"features": list(x), "label": y})
    m = LogisticRegression(maxIter=30, float32_inputs=False, num_workers=4).setFeaturesCol("features").fit(df)
    tcore.config["distributed_transform_min_rows"] = 1000
    split = m.transform(df)
    tcore.config["distributed_transform_min_rows"] = 1 << 60
    single = m.transform(df)
    np.testing.assert_array_equal(split["prediction"].to_numpy(), single["prediction"].to_numpy())
    np.testing.assert_array_equal(np.stack(split["probability"]), np.stack(single["probability"]))


def test_distributed_transform_rf_and_kmeans(monkeypatch):
    from spark_rapids_ml_tpu_torch import KMeans, RandomForestRegressor

    rng = np.random.default_rng(1)
    x = rng.normal(size=(3300, 6))
    df = pd.DataFrame({"features": list(x), "label": x[:, 0] * 2 + rng.normal(size=3300) * 0.1})
    km = KMeans(k=5, maxIter=5, seed=1, num_workers=8).setFeaturesCol("features").fit(df)
    rf = RandomForestRegressor(numTrees=4, maxDepth=4, seed=1, num_workers=8).setFeaturesCol("features").fit(df)
    calls = []
    real = parallel.run_on_chips
    monkeypatch.setattr(parallel, "run_on_chips", lambda n, fn, **kw: calls.append(n) or real(n, fn, **kw))
    tcore.config["distributed_transform_min_rows"] = 1000
    km_split, rf_split = km.transform(df), rf.transform(df)
    assert calls == [8, 8]  # both transforms went over the eight chips
    tcore.config["distributed_transform_min_rows"] = 1 << 60
    np.testing.assert_array_equal(km_split["prediction"].to_numpy(), km.transform(df)["prediction"].to_numpy())
    np.testing.assert_array_equal(rf_split["prediction"].to_numpy(), rf.transform(df)["prediction"].to_numpy())


# ---------------------------------------------------------------- recovery --


def test_replacement_reuses_host_blocks_after_the_chip_set_changes():
    """tests/test_recovery.py:511's counterpart: a fit over 8 chips, then
    the same data over 4 inside one scope; the second skips the ingest and
    lays the host rows out again. Builds count once a chip (8), where the
    JAX package counts its one mesh placement."""
    from spark_rapids_ml_tpu_torch import KMeans

    rng = np.random.default_rng(0)
    centers = rng.normal(scale=5.0, size=(4, 5))
    x = centers[rng.integers(0, 4, 600)] + rng.normal(size=(600, 5))
    df = pd.DataFrame({"features": list(x)})
    with tcore.device_dataset_scope():
        KMeans(k=4, maxIter=3, seed=1, num_workers=8).fit(df)
        snap1 = dict(ttele.registry().snapshot()["counters"])
        KMeans(k=4, maxIter=3, seed=1, num_workers=8).fit(df)  # every chip reuses its placement
        snap_reuse = dict(ttele.registry().snapshot()["counters"])
        m4 = KMeans(k=4, maxIter=3, seed=1, num_workers=4).fit(df)
        snap2 = dict(ttele.registry().snapshot()["counters"])
    assert snap1.get("fit.device_dataset_builds") == 8
    assert snap_reuse.get("fit.device_dataset_reuses") == 8
    assert snap2.get("recovery.replacements") == 1
    assert snap2.get("recovery.rows_replaced") == 600
    assert snap2.get("ingest.datasets") == snap1.get("ingest.datasets") == 1
    one = KMeans(k=4, maxIter=3, seed=1, num_workers=1).fit(df)
    np.testing.assert_allclose(m4.cluster_centers_, one.cluster_centers_, rtol=1e-5, atol=1e-5)


def test_evicting_one_datasets_layout_keeps_the_others_placements():
    """Per-chip placements belong to their dataset's layout: with room for
    two layouts, a third evicts the least recently used one (and clears its
    chips' placements), and the datasets still cached reuse every chip's
    placement."""
    from spark_rapids_ml_tpu_torch import KMeans

    rng = np.random.default_rng(2)
    frames = [pd.DataFrame({"features": list(rng.normal(size=(160, 4)))}) for _ in range(3)]
    with tcore.device_dataset_scope() as scope:
        for df in frames:
            KMeans(k=2, maxIter=2, seed=1, num_workers=4).fit(df)
        assert len(scope.fanout) == 2 and len(scope.chip_scopes) == 8
        before = dict(ttele.registry().snapshot()["counters"])
        KMeans(k=2, maxIter=2, seed=1, num_workers=4).fit(frames[2])
        after = dict(ttele.registry().snapshot()["counters"])
        assert all(len(c.cache) == 1 for c in scope.chip_scopes.values())
    assert after.get("fit.device_dataset_builds") == before.get("fit.device_dataset_builds") == 12
    assert after["fit.device_dataset_reuses"] - before.get("fit.device_dataset_reuses", 0) == 4


def _cv_setup(rng, fail_at_fit=None):
    from spark_rapids_ml_tpu_torch import (
        CrossValidator, LogisticRegression, MulticlassClassificationEvaluator, ParamGridBuilder,
    )

    x = rng.normal(size=(300, 5)).astype(np.float32)
    y = (x @ rng.normal(size=5) > 0).astype(float)
    pdf = pd.DataFrame({"features": list(x), "label": y})
    state = {"n": 0}

    class FlakyLR(LogisticRegression):
        def _fit_internal(self, *a, **kw):
            state["n"] += 1
            if fail_at_fit is not None and state["n"] == fail_at_fit:
                raise RankFailedError(1, "injected rank loss mid-sweep")
            return super()._fit_internal(*a, **kw)

    lr = FlakyLR(maxIter=10)
    grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1]).build()
    cv = CrossValidator(estimator=lr, estimatorParamMaps=grid,
                        evaluator=MulticlassClassificationEvaluator(metricName="accuracy"), numFolds=3, seed=1)
    return cv, pdf, state


def test_cv_sweep_resumes_inside_carved_chip_scope():
    """tests/test_recovery.py:604's counterpart: the whole sweep on the
    pool's right half (a chip_scope pin), a rank loss injected entering fold
    2; the resume redoes no completed fit, and the metrics equal a clean
    sweep on the same half bit for bit."""
    pool = parallel.default_devices()
    half = pool[4:]
    cv, pdf, state = _cv_setup(np.random.default_rng(5), fail_at_fit=3)
    with parallel.chip_scope(half):
        assert parallel.get_mesh().size == 4
        resumed = cv.fit(pdf)
    snap = ttele.registry().snapshot()["counters"]
    assert snap["sweep.resumes"] == 1
    assert snap["sweep.fits_completed"] == 6
    assert snap["sweep.fits_skipped"] == 4
    assert state["n"] == 5  # 2 clean + 1 failed + 1 resumed + 1 refit
    assert resumed.bestModel._fit_metrics["multidevice"]["chip_ids"] == [4, 5, 6, 7]
    cv2, pdf2, _ = _cv_setup(np.random.default_rng(5))
    with parallel.chip_scope(half):
        clean = cv2.fit(pdf2)
    np.testing.assert_array_equal(resumed.avgMetrics, clean.avgMetrics)
    # and the JAX package's sweep on its half-pool picks the same winner
    jtele.enable()
    try:
        from spark_rapids_ml_tpu.evaluation import MulticlassClassificationEvaluator as JEval
        from spark_rapids_ml_tpu.models.classification import LogisticRegression as JLR
        from spark_rapids_ml_tpu.parallel import chip_scope as jchip_scope
        from spark_rapids_ml_tpu.parallel import default_devices as jdefault_devices
        from spark_rapids_ml_tpu.tuning import CrossValidator as JCV
        from spark_rapids_ml_tpu.tuning import ParamGridBuilder as JGrid

        jlr = JLR(maxIter=10)
        jgrid = JGrid().addGrid(jlr.getParam("regParam"), [0.0, 0.1]).build()
        jcv = JCV(estimator=jlr, estimatorParamMaps=jgrid, evaluator=JEval(metricName="accuracy"), numFolds=3, seed=1)
        with jchip_scope(jdefault_devices()[4:]):
            jm = jcv.fit(pdf2)
        np.testing.assert_allclose(clean.avgMetrics, jm.avgMetrics, atol=1e-9)
    finally:
        jtele.disable()


@pytest.mark.parametrize("stage", ["placement", "solve"])
def test_an_oom_on_a_chip_streams_once_on_the_first_chip(stage):
    """The OOM ladder of a fanned-out fit: a chip's allocation failure (the
    chaos `oom` fault, at placement or as the solves dispatch) is retried
    ONCE on the streaming path on the first chip, as a one-chip fit is;
    the model equals the one-chip fit, and no claim is left."""
    from spark_rapids_ml_tpu_torch import LinearRegression
    from spark_rapids_ml_tpu_torch.parallel import chaos
    from spark_rapids_ml_tpu_torch.scheduler import ledger as tledger

    x, _ = _blobs(n=800, seed=8)
    y = x @ np.arange(1.0, 7.0) + 0.25
    data = {"features": x, "label": y}
    one = LinearRegression(regParam=0.001, float32_inputs=False, num_workers=1).fit(data)
    ttele.registry().reset()
    chaos.set_fault_plan(f"oom:stage={stage}")
    try:
        m = LinearRegression(regParam=0.001, float32_inputs=False, num_workers=2).fit(data)
    finally:
        chaos.clear_fault_plan()
    adm = m._fit_metrics["admission"]
    assert adm["verdict"] == "stream" and adm["reason"].startswith("backend OOM")
    assert "multidevice" not in m._fit_metrics
    assert ttele.registry().snapshot()["counters"]["memory.oom_caught"] == 1
    np.testing.assert_allclose(m.coefficients.toArray(), one.coefficients.toArray(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(m.intercept, one.intercept, rtol=1e-9, atol=1e-12)
    assert tledger.global_ledger().reserved_bytes() == 0
    # a failure on the streamed retry too (it places nothing: solve-stage
    # faults, every firing the chips and the retry could take) raises typed
    from spark_rapids_ml_tpu_torch.errors import HbmBudgetError

    chaos.set_fault_plan("oom:stage=solve:times=8")
    try:
        with pytest.raises(HbmBudgetError, match="backend out-of-memory"):
            LinearRegression(regParam=0.001, float32_inputs=False, num_workers=2).fit(data)
    finally:
        chaos.clear_fault_plan()
    assert tledger.global_ledger().reserved_bytes() == 0


def test_multi_process_contexts_still_refuse_several_chips_a_rank(monkeypatch):
    import types

    from spark_rapids_ml_tpu_torch import FitScheduler, KMeans

    monkeypatch.setattr(parallel, "spmd_context",
                        lambda: types.SimpleNamespace(backend="gloo", is_spmd=True, rank=0, nranks=2))
    with pytest.raises(NotImplementedError, match="A10i, second half"):
        KMeans(k=2, num_workers=2).fit({"features": np.zeros((4, 2))})
    assert KMeans(k=2).num_workers == 1  # a rank drives one card by default
    with pytest.raises(NotImplementedError, match="A10i, second half"):
        FitScheduler().submit(KMeans(k=2), {"features": np.zeros((4, 2))})


def test_num_workers_defaults_to_the_pool_and_must_divide_it():
    from spark_rapids_ml_tpu_torch import KMeans
    from spark_rapids_ml_tpu_torch.errors import MeshTopologyError

    assert KMeans().num_workers == 8
    with pytest.raises(MeshTopologyError):
        KMeans(k=2, num_workers=3).fit({"features": np.random.default_rng(0).normal(size=(40, 2))})
    with parallel.chip_scope(parallel.default_devices()[:2]):
        assert KMeans().num_workers == 2
    # a fit admitted over n chips charges n chips (tests/test_ops_plane.py:410)
    est = KMeans(k=2, maxIter=2, seed=1, num_workers=8)
    est.fit({"features": np.random.default_rng(1).normal(size=(400, 4)).astype(np.float32)})
    assert est._last_admission.chips == 8
