#
# The port's multi-process fits after the headline five, on the CPU: the
# forests, DBSCAN, UMAP, the three ANN indexes, sparse LinearRegression and
# LogisticRegression, and the sparse kNN, each rank a fresh interpreter
# holding its ragged block of the JAX multi-process test's dataset
# (tests/mp_worker.py: make_dataset, split_bounds; labels sorted, so a later
# rank holds one class), under TpuContext over gloo (tests/torch_mp_worker.py,
# mode "estimators"). The runs (2 and 3 ranks, float64 and float32) start
# together, one interpreter a rank, and every test reads their models.
#
# Every rank's model equals rank 0's bit for bit. Against the JAX package:
#   * the forests, bootstrap off: the trees (feature, threshold,
#     node_stats, classes) equal JAX's SPMD forest exactly: JAX's
#     `forest_fit` on a CPU mesh of one device a rank, each device's rows
#     the rank's block padded to the largest, as JAX's SPMD layout pads
#     them, with the edges of the gathered sketch. The statistics are
#     integers (class counts, integer regression labels), so both sums are
#     exact. Bootstrap on: JAX's own gate (prediction/target correlation
#     above 0.5) and a bit-for-bit repeat;
#   * DBSCAN: labels and core indices equal JAX's one-process fit (JAX's
#     multi-process test);
#   * UMAP: equal bit for bit to the port's one-process fit of the
#     gathered rows; a 5-epoch fit within tests/test_torch_umap.py's layout
#     tolerance (atol 1e-3) of JAX's one-process fit of those rows;
#   * the ANN: ids equal JAX's SPMD result (JAX's index on each rank's
#     block, searched with the float32 queries of every rank, merged as
#     JAX merges); distances at rtol 1e-5, atol 3e-3 (a query's match with
#     itself is the square root of a float32 cancellation); with nprobe =
#     nlist the id sets equal brute force (JAX's multi-process test);
#   * sparse fits: float64 at JAX's multi-process tolerances of its
#     one-process sparse fits (LinearRegression rtol 1e-6, atol 1e-8;
#     LogisticRegression rtol 1e-4, atol 1e-6); float32 against the port's
#     one-process sparse fit at the dense multi-process test's float32
#     tolerances. The sparse kNN equals the dense global result (JAX's
#     one-process kNN of the same rows).
#
import os
import subprocess
import sys
import uuid

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from spark_rapids_ml_tpu_torch import set_devices

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mp_worker.py")
RUNS = [(2, "float64"), (3, "float64"), (2, "float32"), (3, "float32")]
sys.path.insert(0, HERE)
from mp_worker import make_dataset, split_bounds  # noqa: E402
from torch_mp_worker import ANN, FOREST_COMMON, FORESTS, int_target, sparse_rows  # noqa: E402

sys.path.remove(HERE)
X, Y_LOG, Y_LIN = make_dataset()


@pytest.fixture(autouse=True)
def port_on_cpu():
    set_devices("cpu")
    yield
    set_devices(None)


def _start(mode, nranks, root, *extra):
    """Start `nranks` workers of `mode` (one thread each); returns (out_dir,
    procs)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    env.pop("SRML_FAULT_PLAN", None)
    out_dir = root / "out"
    out_dir.mkdir(parents=True)
    run_id = uuid.uuid4().hex
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, mode, str(r), str(nranks), str(root / "rdv"), str(out_dir), run_id, *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(nranks)
    ]
    return out_dir, procs


def _finish(out_dir, procs, timeout=150):
    """Every rank's npz, or a failure carrying the ranks' output. A worker
    that outlives `timeout` is killed, so a hang fails the test."""
    outputs = []
    for p in procs:
        try:
            outputs.append(p.communicate(timeout=timeout)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four runs and the sketch run, started together; runs(key) waits
    for one and returns its ranks' npz (key: (nranks, dtype) or
    "sketch"), so a test computes its references while the workers run."""
    started = {
        run: _start("estimators", run[0], tmp_path_factory.mktemp(f"est{run[0]}{run[1]}"), run[1]) for run in RUNS
    }
    started["sketch"] = _start("sketch", 2, tmp_path_factory.mktemp("sketch"))
    done = {}

    def get(key):
        if key not in done:
            done[key] = _finish(*started[key])
        return done[key]

    yield get
    for key in started:  # a failed test leaves no worker behind
        if key not in done:
            for p in started[key][1]:
                p.kill()


def _blocks(nranks, x=X):
    b = split_bounds(len(x), nranks)
    return [x[b[r]:b[r + 1]] for r in range(nranks)], b


def _assert_ranks_equal(got, prefix=""):
    for r in range(1, len(got)):
        for key in got[0]:
            if key.startswith(prefix):
                np.testing.assert_array_equal(got[r][key], got[0][key], err_msg=f"rank {r} {key}")


# ------------------------------------------------------- the forests ----


def _jax_spmd_forest(x_blocks, y_blocks, clf, params, dtype):
    """The JAX package's multi-process forest on these blocks, in one
    process: its fit closure's steps (models/tree.py) with forest_fit on a
    CPU mesh of one device a rank, every device's rows its rank's block
    padded with zero-weight rows to the largest block."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from spark_rapids_ml_tpu.models.classification import RandomForestClassifier as JaxRFC
    from spark_rapids_ml_tpu.models.regression import RandomForestRegressor as JaxRFR
    from spark_rapids_ml_tpu.models.tree import _fill_empty_nodes, resolve_max_features
    from spark_rapids_ml_tpu.ops.trees import bin_features, forest_fit, quantile_bins, split_bins_to_thresholds
    from spark_rapids_ml_tpu.parallel import get_mesh
    from spark_rapids_ml_tpu.parallel.mesh import ROWS_AXIS

    R, d = len(x_blocks), x_blocks[0].shape[1]
    est = (JaxRFC if clf else JaxRFR)(**params)
    sp_ = est._solver_params
    seed, max_bins = int(sp_["random_state"] or 0), int(sp_["n_bins"])
    classes = np.unique(np.concatenate([np.unique(y) for y in y_blocks])).astype(np.float64) if clf else np.zeros(0)
    cap = 100_000 // R
    sketch = []
    for r, x in enumerate(x_blocks):
        if len(x) > cap:
            sel = np.sort(np.random.default_rng(seed * 99_991 + r).choice(len(x), cap, replace=False))
            x = x[sel]
        sketch.append(np.asarray(x, dtype=np.float64))
    edges = quantile_bins(np.concatenate(sketch), max_bins, seed=seed)
    L = max(len(x) for x in x_blocks)
    xp = np.zeros((R * L, d), dtype)
    wp = np.zeros(R * L, dtype)
    yp = np.full(R * L, classes[0] if clf else 0.0)
    for r, (x, y) in enumerate(zip(x_blocks, y_blocks)):
        xp[r * L:r * L + len(x)], wp[r * L:r * L + len(x)], yp[r * L:r * L + len(x)] = x, 1, y
    mesh = get_mesh(R, devices=jax.devices()[:R])
    rows2, rows1 = NamedSharding(mesh, P(ROWS_AXIS, None)), NamedSharding(mesh, P(ROWS_AXIS))
    w = jax.device_put(wp, rows1)
    stats = jax.device_put(est._row_stats(yp, classes), rows2)
    n_trees = int(sp_["n_estimators"])
    state = forest_fit(
        bin_features(jax.device_put(xp, rows2), edges.astype(np.float32)), stats * w[:, None], w, seed, mesh=mesh,
        n_trees=n_trees, max_depth=int(sp_["max_depth"]), max_bins=max_bins,
        max_features=resolve_max_features(sp_["max_features"], d, clf), impurity=sp_["split_criterion"],
        node_chunk=int(sp_["node_chunk"]), bootstrap=bool(sp_["bootstrap"]), subsample_rate=float(sp_["max_samples"]),
        min_instances=float(sp_["min_samples_leaf"]), min_info_gain=float(sp_["min_impurity_decrease"]),
        n_stats=stats.shape[1],
    )
    feature = np.asarray(state["feature"])[:n_trees].astype(np.int32)
    node_stats = np.asarray(state["node_stats"], dtype=np.float64)[:n_trees]
    return {
        "feature": feature,
        "threshold": split_bins_to_thresholds(feature, np.asarray(state["split_bin"])[:n_trees], edges),
        "node_stats": _fill_empty_nodes(feature, node_stats),
        "classes": classes,
    }


@pytest.mark.parametrize("run", RUNS, ids=[f"{n}-{d}" for n, d in RUNS])
def test_forests_equal_jax_spmd_trees(runs, run):
    nranks, dtype = run
    x_blocks, b = _blocks(nranks, X.astype(dtype))
    want = {}
    for name, (clf, params) in FORESTS.items():
        y = Y_LOG if clf else int_target(Y_LIN)
        want[name] = _jax_spmd_forest(x_blocks, [y[b[r]:b[r + 1]] for r in range(nranks)], clf,
                                      dict(FOREST_COMMON, float32_inputs=dtype == "float32", **params), dtype)
        assert (want[name]["feature"] >= 0).any()
    got = runs(run)
    _assert_ranks_equal(got, "rf")
    for name, (clf, _) in FORESTS.items():
        for key, v in want[name].items():
            np.testing.assert_array_equal(got[0][f"{name}_{key}"], v, err_msg=f"{name} {key}")
        if clf:  # the later ranks hold one class; the merged set has both
            np.testing.assert_array_equal(got[0][f"{name}_classes"], [0.0, 1.0])


@pytest.mark.parametrize("run", RUNS, ids=[f"{n}-{d}" for n, d in RUNS])
def test_bootstrap_forest_fits_its_rows_and_repeats(runs, run):
    nranks, _ = run
    got = runs(run)
    _assert_ranks_equal(got, "boot_threshold")
    _, b = _blocks(nranks)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["boot_pred"], g["boot_pred_again"])
        corr = np.corrcoef(g["boot_pred"], Y_LIN[b[r]:b[r + 1]])[0, 1]
        assert corr > 0.5, f"rank {r} RF pred/target correlation {corr}"


def test_forest_sketch_over_the_cap_equals_jax(runs):
    # both ranks hold more than 100_000 // 2 rows: each sends its sampled
    # sketch rows, and rank 1 (the shorter) draws its subsample over rank
    # 0's block length
    sys.path.insert(0, HERE)
    try:
        from torch_mp_worker import SKETCH_FOREST, sketch_data
    finally:
        sys.path.remove(HERE)
    x, y, bounds = sketch_data()
    want = _jax_spmd_forest([x[bounds[r]:bounds[r + 1]] for r in range(2)],
                            [y[bounds[r]:bounds[r + 1]] for r in range(2)], True, SKETCH_FOREST, np.float32)
    assert (want["feature"] >= 0).sum() > 4
    got = runs("sketch")
    _assert_ranks_equal(got)
    for key, v in want.items():
        np.testing.assert_array_equal(got[0][key], v, err_msg=key)


def test_each_rank_grows_the_trees_of_jaxs_round_major_forest():
    from spark_rapids_ml_tpu_torch.models.tree import spmd_tree_ids

    # JAX: device r grows trees r·tpd + t; the forest is round-major and
    # cut at numTrees, so the trees past the cut are never grown
    assert [spmd_tree_ids(6, 2, r) for r in range(2)] == [[0, 1, 2], [3, 4, 5]]
    assert [spmd_tree_ids(4, 3, r) for r in range(3)] == [[0, 1], [2], [4]]
    assert [spmd_tree_ids(1, 3, r) for r in range(3)] == [[0], [], []]
    assert [spmd_tree_ids(7, 3, r) for r in range(3)] == [[0, 1, 2], [3, 4], [6, 7]]


# ------------------------------------------------------------- DBSCAN ----


@pytest.mark.parametrize("run", RUNS, ids=[f"{n}-{d}" for n, d in RUNS])
def test_dbscan_labels_equal_jax_one_process(runs, run):
    from spark_rapids_ml_tpu.models.clustering import DBSCAN as JaxDBSCAN

    nranks, _ = run
    got = runs(run)
    full = pd.DataFrame({"features": list(X)})
    jm = JaxDBSCAN(eps=1.5, min_samples=3, num_workers=1).setFeaturesCol("features").fit(full)
    want = jm.transform(full)["prediction"].to_numpy()
    _, b = _blocks(nranks)
    for r, g in enumerate(got):
        for name in ("db", "db_tiles"):
            np.testing.assert_array_equal(g[f"{name}_labels"], want[b[r]:b[r + 1]], err_msg=f"rank {r} {name}")
            np.testing.assert_array_equal(g[f"{name}_core"], jm.core_sample_indices_)
    assert set(np.unique(want)) == {-1, 0}  # noise and a cluster


# --------------------------------------------------------------- UMAP ----


@pytest.mark.parametrize("run", RUNS, ids=[f"{n}-{d}" for n, d in RUNS])
def test_umap_ranks_fit_the_gathered_rows_as_one_process(runs, run):
    import jax

    from spark_rapids_ml_tpu.ops import umap as jax_umap
    from spark_rapids_ml_tpu.parallel import get_mesh
    from spark_rapids_ml_tpu.parallel.mesh import dtype_scope
    from spark_rapids_ml_tpu_torch import UMAP

    nranks, _ = run
    got = runs(run)
    _assert_ranks_equal(got, "um")
    x32 = X.astype(np.float32)
    blocks, _ = _blocks(nranks, x32)
    sampled = np.concatenate([
        blk[np.random.default_rng(3 + r).random(len(blk)) < 0.7] for r, blk in enumerate(blocks)
    ])
    for name, rows, kw in (("um", x32, {"n_epochs": 30}), ("um5", x32, {"n_epochs": 5}),
                           ("um_frac", sampled, {"n_epochs": 5})):
        one = UMAP(n_components=2, n_neighbors=5.0, random_state=3, init="random", **kw).setFeaturesCol(
            "features").fit(pd.DataFrame({"features": list(rows)}))
        np.testing.assert_array_equal(got[0][f"{name}_raw"], rows)
        np.testing.assert_array_equal(got[0][f"{name}_emb"], one.embedding_, err_msg=name)
        if name == "um5":  # each rank's transform of its own first rows
            for r, blk in enumerate(blocks):
                want = one.transform(pd.DataFrame({"features": list(blk[:4])}))["embedding"].to_numpy()
                np.testing.assert_array_equal(got[r]["transform5"], np.stack(want))
    with dtype_scope(np.float32):
        want = jax_umap.umap_fit(x32, None, mesh=get_mesh(1, devices=jax.devices()[:1]), n_neighbors=5,
                                 n_components=2, init="random", n_epochs=5, random_state=3)
    np.testing.assert_allclose(got[0]["um5_emb"], np.asarray(want["embedding_"]), rtol=0, atol=1e-3)


# ---------------------------------------------------------------- ANN ----


def _jax_spmd_ann(nranks, algo, ap, dtype):
    """The JAX package's multi-process ANN search, in one process: JAX's
    index on each rank's block, every rank's first 5 rows as float32
    queries, the ids offset to global rows, the candidates merged by a
    stable argsort (JAX models/knn.py's SPMD branch); returns the global
    (ids, distances) in query order."""
    from spark_rapids_ml_tpu.models.knn import ApproximateNearestNeighbors as JaxANN

    blocks, b = _blocks(nranks, X.astype(dtype))
    q = np.concatenate([blk[:5] for blk in blocks]).astype(np.float32).astype(dtype)
    d_all, i_all = [], []
    for r, blk in enumerate(blocks):
        jm = JaxANN(k=3, algorithm=algo, algoParams=ap, float32_inputs=dtype == "float32", num_workers=1) \
            .setInputCol("features").fit(pd.DataFrame({"features": list(blk)}))
        _, _, knn = jm.kneighbors(pd.DataFrame({"features": list(q)}))
        idx = np.stack(knn["indices"].to_numpy())
        d_all.append(np.stack(knn["distances"].to_numpy()))
        i_all.append(np.where(idx >= 0, idx + b[r], -1))
    d_all, i_all = np.concatenate(d_all, axis=1), np.concatenate(i_all, axis=1)
    order = np.argsort(d_all, axis=1, kind="stable")[:, :3]
    return np.take_along_axis(i_all, order, axis=1), np.take_along_axis(d_all, order, axis=1)


@pytest.mark.parametrize("run", RUNS, ids=[f"{n}-{d}" for n, d in RUNS])
def test_ann_equals_jax_spmd_merge(runs, run):
    nranks, dtype = run
    got = runs(run)  # each rank holds its own queries' rows
    _, b = _blocks(nranks)
    for name, (algo, ap) in ANN.items():
        ids, dist = _jax_spmd_ann(nranks, algo, ap, dtype)
        for r, g in enumerate(got):
            rows = slice(5 * r, 5 * r + 5)
            np.testing.assert_array_equal(g[f"{name}_indices"], ids[rows], err_msg=f"{name} rank {r}")
            np.testing.assert_allclose(g[f"{name}_distances"], dist[rows], rtol=1e-5, atol=3e-3)
            np.testing.assert_array_equal(g[f"{name}_query_ids"], 5 * r + np.arange(5))
    for r, g in enumerate(got):
        # nprobe == nlist: every local search is exhaustive, so the merged
        # id sets are brute force's (JAX's multi-process test)
        q = X[b[r]:b[r] + 5]
        brute = np.argsort(((q[:, None, :] - X[None, :, :]) ** 2).sum(-1), axis=1, kind="stable")[:, :3]
        for qi in range(5):
            assert set(g["ivfflat_all_indices"][qi]) == set(brute[qi]), (r, qi)


# ------------------------------------------------------------- sparse ----


@pytest.mark.parametrize("run", RUNS, ids=[f"{n}-{d}" for n, d in RUNS])
def test_sparse_fits_hold_to_one_process(runs, run):
    from spark_rapids_ml_tpu_torch import LinearRegression, LogisticRegression

    nranks, dtype = run
    got = runs(run)
    _assert_ranks_equal(got, "sp_l")
    g = got[0]
    xs = sp.csr_matrix(sparse_rows(X))
    widths = [int(np.diff(sp.csr_matrix(blk).indptr).max()) for blk in _blocks(nranks, sparse_rows(X))[0]]
    assert len(set(widths)) > 1  # the ranks' widest rows differ: k_max is agreed
    data = {"features": xs, "label": Y_LOG, "target": Y_LIN}
    if dtype == "float64":
        from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogReg
        from spark_rapids_ml_tpu.models.regression import LinearRegression as JaxLinReg

        lin = JaxLinReg(regParam=0.0, float32_inputs=False, labelCol="target", num_workers=1).fit(data)
        lr = JaxLogReg(maxIter=100, regParam=0.1, tol=1e-10, float32_inputs=False, num_workers=1).fit(data)
        rtol_lin, atol_lin, rtol_lr, atol_lr = 1e-6, 1e-8, 1e-4, 1e-6
    else:
        lin = LinearRegression(regParam=0.0, float32_inputs=True, labelCol="target").fit(data)
        lr = LogisticRegression(maxIter=100, regParam=0.1, tol=1e-10, float32_inputs=True).fit(data)
        rtol_lin, atol_lin, rtol_lr, atol_lr = 2e-4, 1e-5, 2e-3, 1e-3
        np.testing.assert_allclose(float(g["sp_lr_objective"]), lr.objective_, rtol=1e-6)
    np.testing.assert_allclose(g["sp_lin_coef"], lin.coef_, rtol=rtol_lin, atol=atol_lin)
    np.testing.assert_allclose(g["sp_lin_intercept"], lin.intercept_, rtol=rtol_lin, atol=atol_lin)
    np.testing.assert_array_equal(g["sp_lr_classes"], lr.classes_)
    np.testing.assert_allclose(g["sp_lr_coef"], lr.coef_, rtol=rtol_lr, atol=atol_lr)
    np.testing.assert_allclose(g["sp_lr_intercept"], lr.intercept_, rtol=rtol_lr, atol=atol_lr)


@pytest.mark.parametrize("run", RUNS, ids=[f"{n}-{d}" for n, d in RUNS])
def test_sparse_knn_equals_the_dense_global_result(runs, run):
    from spark_rapids_ml_tpu.models.knn import NearestNeighbors as JaxNN

    nranks, dtype = run
    got = runs(run)
    rows = sparse_rows(X)
    full = pd.DataFrame({"features": list(rows), "id": np.arange(len(rows), dtype=np.int64)})
    jm = JaxNN(k=3, float32_inputs=dtype == "float32", num_workers=1).setInputCol("features").setIdCol("id").fit(full)
    _, b = _blocks(nranks)
    f64 = dtype == "float64"
    for r, g in enumerate(got):
        _, _, want = jm.kneighbors(full.iloc[b[r]:b[r] + 5])
        np.testing.assert_array_equal(g["sp_knn_indices"], np.stack(want["indices"].to_numpy()))
        np.testing.assert_allclose(g["sp_knn_distances"], np.stack(want["distances"].to_numpy()),
                                   rtol=1e-7 if f64 else 1e-5, atol=1e-6 if f64 else 1e-3)


# -------------------------------------------------------- the merge ----


def test_merge_orders_as_one_exact_knn_over_the_global_rows():
    from spark_rapids_ml_tpu_torch.ops.knn import merge_topk

    inf, nan = np.inf, np.nan
    # two ranks' lists side by side: ties go to the earlier (lower global)
    # row, NaN after +inf, a short rank's pad slots (id -1) after NaN
    dist = np.array([[0.5, 2.0, nan, 0.5, inf, inf],
                     [nan, nan, nan, nan, nan, inf]])
    ids = np.array([[3, 7, 9, 60, 61, -1],
                    [0, 1, 2, 60, 61, -1]])
    d, i = merge_topk(dist, ids, 5)
    np.testing.assert_array_equal(i, [[3, 60, 7, 61, 9], [0, 1, 2, 60, 61]])
    np.testing.assert_array_equal(d[0], [0.5, 0.5, 2.0, inf, nan])
    # the JAX package's sparse and ANN merges (a stable argsort of the
    # distances alone) put a pad's +inf before NaN; the port keeps one
    # process's order here (a deliberate difference, ROADMAP §A)
    jax_order = np.argsort(dist[1], kind="stable")[:5]
    assert list(ids[1][jax_order]) == [-1, 0, 1, 2, 60]
    # distances that round together (the square root, + ||q||^2) keep the
    # order of the values the ranks ordered on
    d, i = merge_topk(np.array([[3.0, 3.0, 3.0, 3.0]]), np.array([[5, 9, 60, 70]]), 3,
                      key=np.array([[0.25, 0.5, 0.125, 0.75]]))
    np.testing.assert_array_equal(i, [[60, 5, 9]])
