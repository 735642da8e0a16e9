#
# The port's multi-process fits on the CPU: 2 and 3 ranks, each a fresh
# interpreter holding its ragged block of the JAX multi-process test's
# dataset (tests/mp_worker.py: make_dataset, split_bounds; labels sorted so
# that a later rank sees one class), meet through a FileRendezvous and fit
# under TpuContext over a gloo process group (tests/torch_mp_worker.py).
# Every rank's model must equal rank 0's bit for bit, and hold to the JAX
# package's single-process fits at JAX's own tolerances
# (tests/test_multiprocess.py) in float64, and to the port's single-process
# fit in both dtypes.
#
import json
import os
import subprocess
import sys
import threading
import uuid

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu_torch import set_devices

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mp_worker.py")
MODEL_KEYS = (
    "km_centers", "km_inertia", "km_iter", "km_pp_centers", "km_rand_centers", "km_init_pp", "km_init_rand",
    "pca_components", "pca_mean", "pca_var_ratio", "lin_coef", "lin_intercept",
    "lr_coef", "lr_intercept", "lr_classes", "lr_iter", "lr_objective",
)


@pytest.fixture(autouse=True)
def port_on_cpu():
    set_devices("cpu")
    yield
    set_devices(None)


def _launch(mode, nranks, tmp_path, *extra, timeout=120):
    """Start `nranks` workers as fresh interpreters; returns (out_dir,
    procs, outputs). A worker that outlives `timeout` is killed, so a hang
    fails the test instead of the suite."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("SRML_FAULT_PLAN", None)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    run_id = uuid.uuid4().hex
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, mode, str(r), str(nranks), str(tmp_path / "rdv"), str(out_dir), run_id,
             *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(nranks)
    ]
    outputs = []
    for p in procs:
        try:
            outputs.append(p.communicate(timeout=timeout)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return out_dir, procs, outputs


def _dataset():
    sys.path.insert(0, HERE)
    try:
        from mp_worker import make_dataset, split_bounds
    finally:
        sys.path.remove(HERE)
    return make_dataset(), split_bounds


def _frame(X, y_log, y_lin):
    return pd.DataFrame({"features": list(X), "label": y_log, "target": y_lin,
                         "id": np.arange(len(X), dtype=np.int64)})


_REFS = {}


def _jax_reference():
    """The JAX package's single-process fits (float64, one device), as
    tests/test_multiprocess.py makes them."""
    if "jax" not in _REFS:
        from spark_rapids_ml_tpu.models.classification import LogisticRegression
        from spark_rapids_ml_tpu.models.clustering import KMeans
        from spark_rapids_ml_tpu.models.feature import PCA
        from spark_rapids_ml_tpu.models.knn import NearestNeighbors
        from spark_rapids_ml_tpu.models.regression import LinearRegression

        (X, y_log, y_lin), _ = _dataset()
        df = _frame(X, y_log, y_lin)
        _REFS["jax"] = dict(
            pca=PCA(k=3, inputCol="features", float32_inputs=False, num_workers=1).fit(df),
            lin=LinearRegression(regParam=0.0, float32_inputs=False, labelCol="target", num_workers=1)
            .setFeaturesCol("features").fit(df),
            lr=LogisticRegression(maxIter=100, regParam=0.1, tol=1e-10, float32_inputs=False, num_workers=1)
            .setFeaturesCol("features").fit(df),
            km=KMeans(k=4, maxIter=15, seed=3, float32_inputs=False, num_workers=1).setFeaturesCol("features").fit(df),
            gnn=NearestNeighbors(k=3, float32_inputs=False, num_workers=1).setInputCol("features").setIdCol("id")
            .fit(df),
            df=df,
        )
    return _REFS["jax"]


def _port_reference(dtype):
    """The port's single-process fits of the same estimators."""
    if dtype not in _REFS:
        from spark_rapids_ml_tpu_torch import PCA, KMeans, LinearRegression, LogisticRegression

        f32 = dtype == "float32"
        (X, y_log, y_lin), _ = _dataset()
        df = _frame(X, y_log, y_lin)
        _REFS[dtype] = dict(
            km=KMeans(k=4, maxIter=15, seed=3, float32_inputs=f32).setFeaturesCol("features").fit(df),
            pca=PCA(k=3, inputCol="features", float32_inputs=f32).fit(df),
            lin=LinearRegression(regParam=0.0, float32_inputs=f32, labelCol="target").setFeaturesCol("features")
            .fit(df),
            lr=LogisticRegression(maxIter=100, regParam=0.1, tol=1e-10, float32_inputs=f32).setFeaturesCol(
                "features").fit(df),
        )
    return _REFS[dtype]


# the port's single-process fit against its multi-process fit: the same
# rows summed in another order (float64 to ~1e-15, float32 to ~1e-7 of
# each sum; LogisticRegression's iterates compound it)
PORT_RTOL = {"float64": 1e-9, "float32": 2e-4}
PORT_ATOL = {"float64": 1e-11, "float32": 1e-5}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nranks", [2, 3])
def test_multiprocess_fit_matches_single_process(nranks, dtype, tmp_path):
    out_dir, procs, outputs = _launch("fit", nranks, tmp_path, dtype)
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    (X, y_log, y_lin), split_bounds = _dataset()
    bounds = split_bounds(len(X), nranks)
    got = [np.load(out_dir / f"rank{r}.npz") for r in range(nranks)]
    info = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(nranks)]
    port = _port_reference(dtype)
    rtol, atol = PORT_RTOL[dtype], PORT_ATOL[dtype]
    for r in range(nranks):
        # every rank holds rank 0's model, bit for bit
        for key in MODEL_KEYS:
            np.testing.assert_array_equal(got[r][key], got[0][key], err_msg=f"rank {r} {key}")
        assert info[r]["backend"] == "gloo"
        assert info[r]["spmd_metrics"] == {"rank": r, "nranks": nranks, "backend": "gloo"}
        assert info[r]["counters"]["collective.allgathers"] > 0
        # one agreement round per fit in the scope, the second a reuse
        assert info[r]["counters"]["fit.device_dataset_spmd_rounds"] == 2
        assert info[r]["counters"]["fit.device_dataset_reuses"] == 1
    g = got[0]
    # against the port's single-process fit
    np.testing.assert_allclose(g["km_centers"], port["km"].cluster_centers_, rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(g["km_inertia"]), port["km"].inertia_, rtol=rtol)
    assert int(g["km_iter"]) == port["km"].n_iter_
    np.testing.assert_allclose(g["pca_components"], port["pca"].components_, rtol=rtol, atol=atol)
    np.testing.assert_allclose(g["pca_mean"], port["pca"].mean_, rtol=rtol, atol=atol)
    np.testing.assert_allclose(g["lin_coef"], port["lin"].coef_, rtol=rtol, atol=atol)
    np.testing.assert_allclose(g["lin_intercept"], port["lin"].intercept_, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(g["lr_classes"], port["lr"].classes_)
    # a float32 GLM stops where its objective change falls into float32
    # noise, so the two orders of summation may stop a few iterations apart:
    # the objective holds to float32 rounding, the iterate to 2e-3
    lr_rtol, lr_atol = (rtol, atol) if dtype == "float64" else (2e-3, 1e-3)
    np.testing.assert_allclose(float(g["lr_objective"]), port["lr"].objective_, rtol=rtol if dtype == "float64" else 1e-6)
    np.testing.assert_allclose(g["lr_coef"], port["lr"].coef_, rtol=lr_rtol, atol=lr_atol)
    np.testing.assert_allclose(g["lr_intercept"], port["lr"].intercept_, rtol=lr_rtol, atol=lr_atol)
    if dtype == "float64":
        # against the JAX package's single-process fits, at the tolerances
        # of its own multi-process test
        jx = _jax_reference()
        np.testing.assert_allclose(g["pca_components"], jx["pca"].components_, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(g["pca_mean"], jx["pca"].mean_, rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(g["pca_var_ratio"], jx["pca"].explained_variance_ratio_, rtol=1e-6)
        np.testing.assert_allclose(g["lin_coef"], jx["lin"].coef_, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(g["lin_intercept"], jx["lin"].intercept_, rtol=1e-6, atol=1e-8)
        # the sorted labels leave later ranks one class: the merged set has both
        np.testing.assert_array_equal(g["lr_classes"], jx["lr"].classes_)
        np.testing.assert_allclose(g["lr_coef"], jx["lr"].coef_, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g["lr_intercept"], jx["lr"].intercept_, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g["km_centers"], jx["km"].cluster_centers_, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(float(g["km_inertia"]), jx["km"].inertia_, rtol=1e-6)
    # the init: JAX's k-means++ and random init on the union of the ranks'
    # rows (under the sample cap every rank sends all of its rows, in rank
    # order: the whole dataset)
    from spark_rapids_ml_tpu.ops.kmeans import kmeans_plus_plus_init, random_init

    np.testing.assert_array_equal(g["km_init_pp"], kmeans_plus_plus_init(X, 4, 3).astype(dtype))
    np.testing.assert_array_equal(g["km_init_rand"], random_init(X, 4, 5).astype(dtype))
    # kNN: each rank's first 5 rows queried against every rank's items
    jx_gnn = _jax_reference()["gnn"]
    full = _jax_reference()["df"]
    for r in range(nranks):
        lo = bounds[r]
        _, _, want = jx_gnn.kneighbors(full.iloc[lo:lo + 5])
        np.testing.assert_array_equal(got[r]["knn_query_ids"], want["query_id"].to_numpy())
        np.testing.assert_array_equal(got[r]["knn_indices"], np.stack(want["indices"].to_numpy()))
        np.testing.assert_allclose(got[r]["knn_distances"], np.stack(want["distances"].to_numpy()),
                                   rtol=1e-7 if dtype == "float64" else 1e-5, atol=1e-6 if dtype == "float64" else 1e-3)
    # default ids are global row numbers, and a NaN query row (rank 0's
    # sixth) keeps its first k rows, as on one process; the query ids
    # follow the ragged query blocks
    from spark_rapids_ml_tpu_torch import NearestNeighbors

    plain = full.drop(columns=["id"])
    nn1 = NearestNeighbors(k=3, float32_inputs=dtype == "float32").setInputCol("features").fit(plain)
    q_off = 0
    for r in range(nranks):
        lo = bounds[r]
        q = plain.iloc[lo:lo + 5].copy()
        if r == 0:
            q.loc[len(q)] = [np.full(X.shape[1], np.nan), 0.0, 0.0]
        _, _, want = nn1.kneighbors(q)
        np.testing.assert_array_equal(got[r]["knn2_indices"], np.stack(want["indices"].to_numpy()))
        np.testing.assert_allclose(got[r]["knn2_distances"], np.stack(want["distances"].to_numpy()),
                                   rtol=1e-12 if dtype == "float64" else 1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[r]["knn2_query_ids"], q_off + np.arange(len(q)))
        np.testing.assert_array_equal(got[r]["knn2_query_frame_ids"], q_off + np.arange(len(q)))
        q_off += len(q)
    # outside the slice: typed refusals naming A10, and the resident-only rule
    for r in range(nranks):
        for name, msg in info[r]["refusals"].items():
            assert "A10" in msg, f"rank {r} {name}: {msg}"
        assert sorted(info[r]["refusals"]) == ["cv", "join", "scheduler", "tvs"]
        for name in ("demoted", "demoted_sparse"):
            assert "SPMD fits must fit resident" in info[r][name], info[r][name]


def test_nan_item_row_on_a_short_rank_merges_as_one_process(tmp_path):
    # ROADMAP fault C8: rank 1 holds items [60, 64), the all-NaN row 61
    # among them, and its local top-k takes that row; the merge must rank
    # NaN after +inf and a short rank's pad slots after NaN, as one
    # process does over the global rows: query 0 gets [21, 45, 33, 42]
    # (the JAX package's one-process result), and a NaN query row the first
    # k global rows
    from spark_rapids_ml_tpu.models.knn import NearestNeighbors as JaxNearestNeighbors

    out_dir, procs, outputs = _launch("nan", 2, tmp_path)
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    sys.path.insert(0, HERE)
    try:
        from torch_mp_worker import nan_items
    finally:
        sys.path.remove(HERE)
    items, queries = nan_items()
    queries = np.concatenate([queries, np.full((1, 6), np.nan)])
    got = [np.load(out_dir / f"rank{r}.npz") for r in range(2)]
    for k in (4, 5):
        _, _, want = JaxNearestNeighbors(k=k, float32_inputs=False, num_workers=1).setInputCol("features").fit(
            pd.DataFrame({"features": list(items)})).kneighbors(pd.DataFrame({"features": list(queries)}))
        want_idx, want_d = np.stack(want["indices"].to_numpy()), np.stack(want["distances"].to_numpy())
        idx = np.concatenate([g[f"k{k}_indices"] for g in got])
        dist = np.concatenate([g[f"k{k}_distances"] for g in got])
        np.testing.assert_array_equal(np.concatenate([g[f"k{k}_query_ids"] for g in got]), np.arange(7))
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_allclose(dist[:6], want_d[:6], rtol=1e-7)
        assert not np.isnan(dist[:6]).any()
        np.testing.assert_array_equal(idx[6], np.arange(k))  # the NaN query row: the first k rows
        assert np.isnan(dist[6]).all()
    assert list(got[0]["k4_indices"][0]) == [21, 45, 33, 42]


@pytest.mark.parametrize("how, error, within", [
    ("raise", "RankFailedError", 10.0),  # the peer's published abort
    ("kill", "RankFailedError", 10.0),  # SIGKILL: its connections close, nothing published
    ("stall", "RendezvousTimeoutError", 10.0),  # past the 3 s collective deadline
])
def test_rank_failure_surfaces_typed_at_the_peer(how, error, within, tmp_path):
    # rank 1 fails inside its line search; rank 0, waiting in a collective,
    # must raise the typed error within its budget, not hang and not a bare
    # RuntimeError
    out_dir, procs, outputs = _launch("fail", 2, tmp_path, how, timeout=90)
    res0 = json.loads((out_dir / "result_rank0.json").read_text())
    t_fail = json.loads((out_dir / "failed_at.json").read_text())["t"]
    assert res0["error"] == error, (res0, outputs[0])
    assert res0["t"] - t_fail < within
    if how == "raise":
        res1 = json.loads((out_dir / "result_rank1.json").read_text())
        assert res1["error"] == "RuntimeError" and "injected" in res1["reason"], outputs[1]
        assert res0["failed_rank"] == 1, res0
    if how == "kill":
        assert procs[1].returncode == -9


def test_row_mask_names_this_ranks_rows():
    from spark_rapids_ml_tpu_torch.core import FitInputs
    from spark_rapids_ml_tpu_torch.parallel import LocalRendezvous, PartitionDescriptor, TpuContext

    rdv = LocalRendezvous.create(2)[1]
    desc = PartitionDescriptor([(0, 5), (1, 3)], m=8, n=2, rank=1)
    w = torch.ones(3, dtype=torch.float64)
    inputs = FitInputs(X=torch.zeros((3, 2), dtype=torch.float64), w=w, n_valid=8, n_cols=2, dtype=np.float64,
                       device=torch.device("cpu"), ctx=TpuContext(1, 2, rdv), desc=desc)
    masked = inputs.with_row_mask(np.array([1, 0, 1]))
    assert masked.w.tolist() == [1.0, 0.0, 1.0] and masked.n_valid == 8
    with pytest.raises(ValueError, match="this rank's 3 rows"):
        inputs.with_row_mask(np.ones(8))


def test_rank_tags_follow_the_context():
    from spark_rapids_ml_tpu_torch import diagnostics
    from spark_rapids_ml_tpu_torch.parallel import TpuContext

    with TpuContext(3, 1):
        assert diagnostics._rank() == 3
    assert diagnostics._rank() == int(os.environ.get("SRML_RANK", "0") or 0)


def test_multiprocess_default_is_opt_in():
    from spark_rapids_ml_tpu_torch import PCA, KMeans, LinearRegression, LogisticRegression
    from spark_rapids_ml_tpu_torch.core import _TpuCaller
    from spark_rapids_ml_tpu_torch.models.tree import _RandomForestEstimator

    for cls in (KMeans, PCA, LinearRegression, LogisticRegression, _RandomForestEstimator):
        assert cls._supports_multiprocess
    assert not _TpuCaller._supports_multiprocess


def test_spmd_kmeans_init_union_matches_jax_draws():
    # over the sample cap each rank draws max(4k, 262144 // nranks) of its
    # rows from default_rng(seed * 100003 + rank), as the JAX package does;
    # every rank gets the same union, and the random init (which gathers
    # only its k drawn rows) equals JAX's random_init on that union
    from spark_rapids_ml_tpu.ops.kmeans import random_init as jax_random_init

    from spark_rapids_ml_tpu_torch.core import FitInputs
    from spark_rapids_ml_tpu_torch.models.clustering import _init_rows, _random_init
    from spark_rapids_ml_tpu_torch.parallel import LocalRendezvous, TpuContext

    k, seed, nranks = 5, 7, 2
    rng = np.random.default_rng(0)
    blocks = [rng.normal(size=(140_000, 2)).astype(np.float32), rng.normal(size=(131_100, 2)).astype(np.float32)]
    rdvs = LocalRendezvous.create(nranks, timeout_s=60.0)
    out = [None] * nranks

    def work(r):
        inputs = FitInputs(X=None, w=None, n_valid=0, n_cols=2, dtype=np.float32, device=None,
                           ctx=TpuContext(r, nranks, rdvs[r]))
        out[r] = _init_rows(inputs, blocks[r], None, k, seed) + (_random_init(inputs, blocks[r], k, seed),)

    threads = [threading.Thread(target=work, args=(r,)) for r in range(nranks)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    assert not any(t.is_alive() for t in threads)
    cap = max(4 * k, 262_144 // nranks)
    want = []
    for r, b in enumerate(blocks):
        sel = np.sort(np.random.default_rng(seed * 100_003 + r).choice(len(b), cap, replace=False))
        want.append(np.asarray(b[sel], dtype=np.float64))
    want = np.concatenate(want)
    for r in range(nranks):
        union, w, centers = out[r]
        assert w is None
        np.testing.assert_array_equal(union, want)
        np.testing.assert_array_equal(centers, jax_random_init(want, k, seed))
