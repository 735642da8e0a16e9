#
# The PyTorch port's DBSCAN against the JAX package on the CPU: the same
# numpy inputs, made from a seed, through both estimators. Labels and core
# sample indices must be EQUAL (tolerance: none) on every data set of
# tests/test_dbscan.py (blobs, moons with noise, uniform noise, border
# points, cosine, precomputed, all noise, one cluster, the ambiguous
# border), and on integer-valued rows with eps^2 a half-integer, where no
# pair lies within rounding of eps in any summation order.
#
import numpy as np
import pandas as pd
import types
import pytest
import torch

from spark_rapids_ml_tpu.models.clustering import DBSCAN as JaxDBSCAN
from spark_rapids_ml_tpu.models.clustering import DBSCANModel as JaxDBSCANModel
from spark_rapids_ml_tpu_torch import DBSCAN, DBSCANModel, convert, parallel
from spark_rapids_ml_tpu_torch.core import load_instance
from spark_rapids_ml_tpu_torch.ops import _kernels
from spark_rapids_ml_tpu_torch.ops import dbscan as tdb
from spark_rapids_ml_tpu_torch.ops import distance as D


@pytest.fixture(autouse=True)
def port_on_cpu():
    parallel.set_devices("cpu")
    yield
    parallel.set_devices(None)


def _df(x):
    return pd.DataFrame({"features": list(np.asarray(x, dtype=np.float64))})


def _both(x, **params):
    """(JAX labels, JAX core indices, port labels, port core indices, port
    model) of one DBSCAN configuration on the rows x."""
    j = JaxDBSCAN(**params).setFeaturesCol("features").fit(_df(x))
    jl = j.transform(_df(x))["prediction"].to_numpy()
    t = DBSCAN(**params).setFeaturesCol("features").fit(_df(x))
    tl = t.transform(_df(x))["prediction"].to_numpy()
    return jl, j.core_sample_indices_, tl, t.core_sample_indices_, t


def _assert_same(x, **params):
    jl, jc, tl, tc, _ = _both(x, **params)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, jc)
    assert tl.dtype == np.int64
    return tl


def _blobs(n, centers, std, seed, d=2):
    from sklearn.datasets import make_blobs

    return make_blobs(n_samples=n, centers=centers, n_features=d, cluster_std=std, random_state=seed)[0]


def _int_rows(n, d, seed):
    """Integer-valued rows around a few integer centers: every squared
    distance is an integer, exact in float32 in any order, so with eps^2 a
    half-integer no pair lies at eps."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-30, 31, size=(4, d))
    return (centers[rng.integers(0, 4, n)] + rng.integers(-3, 4, size=(n, d))).astype(np.float64)


def _rays(seed):
    rng = np.random.default_rng(seed)
    angles = np.concatenate([rng.normal(0.0, 0.05, 40), rng.normal(1.5, 0.05, 40)])
    r = rng.uniform(0.5, 3.0, 80)
    return np.stack([r * np.cos(angles), r * np.sin(angles)], axis=1)


# ------------------------------------------------------ labels = JAX's ----


_BORDER = np.array(
    [[0.0, 0], [0.1, 0], [0.2, 0], [0.3, 0], [0.95, 0],
     [5.0, 0], [5.1, 0], [5.2, 0], [5.3, 0], [5.75, 0], [9.0, 0]]
)
_AMBIGUOUS = np.array([[0.0, 0.0], [0.1, 0.0], [0.2, 0.0], [1.0, 0.0], [1.8, 0.0], [1.9, 0.0], [2.0, 0.0]])


def _case(name):
    from sklearn.datasets import make_moons

    rng = np.random.default_rng(7)
    return {
        "blobs": (_blobs(500, 4, 0.5, 3), {"eps": 0.8, "min_samples": 5}),
        "moons": (make_moons(n_samples=400, noise=0.05, random_state=1)[0], {"eps": 0.15, "min_samples": 5}),
        "uniform_noise": (rng.uniform(-5, 5, size=(300, 2)), {"eps": 0.3, "min_samples": 4}),
        "border_points": (_BORDER, {"eps": 0.5, "min_samples": 3}),
        "cosine": (_rays(11), {"eps": 0.02, "min_samples": 4, "metric": "cosine"}),
        "tiling": (_blobs(300, 3, 0.6, 7), {"eps": 0.9, "min_samples": 5, "max_mbytes_per_batch": 1}),
        "all_noise": (rng.uniform(-100, 100, size=(50, 3)), {"eps": 0.1, "min_samples": 3}),
        "one_cluster": (rng.normal(size=(60, 3)) * 0.01, {"eps": 0.5, "min_samples": 3}),
        "ambiguous_border": (_AMBIGUOUS, {"eps": 0.85, "min_samples": 4}),
        "integer_euclidean": (_int_rows(400, 6, 3), {"eps": float(np.sqrt(12.5)), "min_samples": 6}),
        "integer_cosine": (_int_rows(300, 5, 4), {"eps": 0.015, "min_samples": 5, "metric": "cosine"}),
    }[name]


@pytest.mark.parametrize("name", [
    "blobs", "moons", "uniform_noise", "border_points", "cosine", "tiling", "all_noise", "one_cluster",
    "ambiguous_border", "integer_euclidean", "integer_cosine",
])
def test_labels_and_core_indices_equal_jax(name):
    x, params = _case(name)
    labels = _assert_same(x, **params)
    if name == "all_noise":
        assert (labels == -1).all()
    elif name == "one_cluster":
        assert (labels == 0).all()
    elif name == "ambiguous_border":
        assert labels[3] == 0  # the lower cluster id, deterministically
    elif name == "uniform_noise":
        assert (labels == -1).any() and labels.max() >= 0
    else:
        assert labels.max() >= 1


def test_precomputed_equals_jax_and_the_euclidean_run():
    from scipy.spatial.distance import cdist

    x = _blobs(300, 3, 0.6, 5)
    labels = _assert_same(cdist(x, x), eps=0.8, min_samples=5, metric="precomputed")
    own = DBSCAN(eps=0.8, min_samples=5).setFeaturesCol("features").fit(_df(x)).transform(_df(x))
    np.testing.assert_array_equal(labels, own["prediction"].to_numpy())
    xi = _int_rows(200, 4, 9)
    _assert_same(cdist(xi, xi) ** 2, eps=10.5, min_samples=4, metric="precomputed")
    with pytest.raises(ValueError, match="square"):
        D_ = cdist(x, x)[:, :10]
        DBSCAN(eps=0.5, min_samples=3, metric="precomputed").setFeaturesCol("features").fit(_df(D_)).transform(_df(D_))


def test_tile_budgets_give_identical_labels():
    x = _int_rows(600, 6, 5)
    runs = []
    for budget in (None, 1, 2):
        m = DBSCAN(eps=float(np.sqrt(12.5)), min_samples=6, max_mbytes_per_batch=budget).setFeaturesCol("features")
        runs.append(m.fit(_df(x)).transform(_df(x))["prediction"].to_numpy())
    assert tdb._tile_rows_for_budget(600, 1) == 416 and tdb._tile_rows_for_budget(600, None) == 8192
    for r in runs[1:]:
        np.testing.assert_array_equal(r, runs[0])


# ------------------------------------------------------------ the passes ----


def test_passes_against_a_dense_reference():
    """core_mask, core_components and border_assign on integer rows against
    the whole [n, n] matrix in numpy: the rounds stop once no label moves,
    and a tile smaller than the rows changes nothing."""
    x = _int_rows(257, 5, 8).astype(np.float32)
    eps2 = 12.5
    d2 = ((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    nb = d2 <= eps2
    X = torch.from_numpy(x)
    for tile in (64, 8192):
        core = tdb.core_mask(X, eps2, 5, tile_rows=tile).numpy()
        np.testing.assert_array_equal(core, nb.sum(1) >= 5)
        idx = np.flatnonzero(core)
        roots, rounds = tdb.core_components(X[idx], eps2, tile_rows=tile)
        # the dense fixpoint: every core row's root is the smallest core
        # index of its component
        lab = np.arange(len(idx))
        a = nb[np.ix_(idx, idx)]
        for _ in range(len(idx)):
            lab = np.minimum(lab, np.where(a, lab[None, :], len(idx)).min(1))
        np.testing.assert_array_equal(roots.numpy(), lab)
        assert 1 <= rounds <= len(idx)
        cl = np.searchsorted(np.unique(lab), lab).astype(np.int32)
        out = tdb.border_assign(X, X[idx], torch.from_numpy(cl), eps2, tile_rows=tile).numpy()
        want = np.where(nb[:, idx].any(1), np.where(nb[:, idx], cl[None, :], 2**30).min(1), -1)
        np.testing.assert_array_equal(out, want)


def test_pairwise_d2_metrics():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(-3, 4, size=(5, 7)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-3, 4, size=(9, 7)).astype(np.float32))
    want = ((q[:, None] - x[None]) ** 2).sum(-1)
    assert torch.equal(D.pairwise_d2(q, x), want)
    assert torch.equal(D.pairwise_d2(q, x, "euclidean"), want)
    assert torch.equal(D.pairwise_d2(q, x, "cosine"), 1.0 - q @ x.T)
    assert D.pairwise_d2(q, x, "precomputed") is q


def test_no_kernel_launched():
    _kernels.reset_launches()
    _assert_same(_blobs(200, 3, 0.5, 2), eps=0.8, min_samples=5)
    assert not any(_kernels.launches.values())


def test_ieee_f32_products_restores_the_setting():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with D.ieee_f32_products():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


# ------------------------------------------------------ estimator surface ----


def test_param_validation_and_surface():
    DBSCAN(metric="precomputed")
    with pytest.raises(ValueError, match="metric"):
        DBSCAN(metric="manhattan")
    with pytest.raises(ValueError, match="algorithm"):
        DBSCAN(algorithm="kdtree")
    d = DBSCAN(eps=0.25, min_samples=7)
    assert d.getEps() == 0.25 and d.getMinSamples() == 7
    assert d.solver_params["eps"] == 0.25
    assert d.setAlgorithm("rbc").getAlgorithm() == "rbc"
    assert d.setCalcCoreSampleIndices(False).getCalcCoreSampleIndices() is False
    # the same params and defaults as the JAX estimator
    j = JaxDBSCAN()
    t = DBSCAN()
    assert sorted(p.name for p in t.params) == sorted(p.name for p in j.params)
    for p in j.params:
        if j.hasDefault(p):
            assert t.getOrDefault(p.name) == j.getOrDefault(p), p.name
    assert t.solver_params == {k: v for k, v in j.solver_params.items()}


def test_fit_touches_no_data_and_calc_core_indices_off():
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"fit read the data ({name})")

    model = DBSCAN(eps=0.7, min_samples=4).setFeaturesCol("features").fit(Untouchable())
    assert isinstance(model, DBSCANModel) and model.getEps() == 0.7
    x = _blobs(100, 2, 0.4, 1)
    m = DBSCAN(eps=0.7, min_samples=4, calc_core_sample_indices=False).setFeaturesCol("features").fit(_df(x))
    m.transform(_df(x))
    assert m.core_sample_indices_ is None


def test_fit_multiple_gives_one_model_per_map():
    x = _blobs(80, 2, 0.4, 4)
    est = DBSCAN(eps=0.5, min_samples=3).setFeaturesCol("features")
    grid = [{est.getParam("eps"): 0.3}, {est.getParam("eps"): 0.8}]
    models = est.fit(_df(x), grid)
    assert len(models) == 2
    assert models[0].getEps() == 0.3 and models[1].getEps() == 0.8
    assert models[0].solver_params["eps"] == 0.3 and models[1].solver_params["eps"] == 0.8
    jl = [jm.transform(_df(x))["prediction"].to_numpy()
          for jm in JaxDBSCAN(eps=0.5, min_samples=3).setFeaturesCol("features").fit(
              _df(x), [{JaxDBSCAN().getParam("eps"): 0.3}, {JaxDBSCAN().getParam("eps"): 0.8}])]
    for m, want in zip(models, jl):
        np.testing.assert_array_equal(m.transform(_df(x))["prediction"].to_numpy(), want)


def test_prediction_and_id_columns():
    x = _blobs(60, 2, 0.3, 6)
    df = _df(x)
    df["id"] = np.arange(100, 160)
    out = (DBSCAN(eps=0.5, min_samples=3).setFeaturesCol("features").setPredictionCol("cluster")
           .setIdCol("id").fit(df).transform(df))
    assert "cluster" in out.columns
    np.testing.assert_array_equal(out["id"].to_numpy(), np.arange(100, 160))


def test_save_load_both_ways(tmp_path):
    x = _blobs(120, 3, 0.4, 2)
    model = DBSCAN(eps=0.7, min_samples=4, metric="euclidean").setFeaturesCol("features").fit(_df(x))
    want = model.transform(_df(x))["prediction"].to_numpy()
    p = str(tmp_path / "port")
    model.write().overwrite().save(p)
    loaded = DBSCANModel.load(p)
    assert loaded.getEps() == 0.7 and loaded.getMinSamples() == 4
    np.testing.assert_array_equal(loaded.transform(_df(x))["prediction"].to_numpy(), want)
    np.testing.assert_array_equal(JaxDBSCANModel.load(p).transform(_df(x))["prediction"].to_numpy(), want)
    jp = str(tmp_path / "jax")
    JaxDBSCAN(eps=0.7, min_samples=4).setFeaturesCol("features").fit(_df(x)).write().overwrite().save(jp)
    for m in (DBSCANModel.load(jp), load_instance(jp)):
        assert isinstance(m, DBSCANModel)
        np.testing.assert_array_equal(m.transform(_df(x))["prediction"].to_numpy(), want)


def test_model_from_jax_params_transforms_alike():
    x = _rays(3)
    jm = JaxDBSCAN(eps=0.02, min_samples=4, metric="cosine").setFeaturesCol("features").fit(_df(x))
    params = {p.name: jm.getOrDefault(p) for p in jm.params if jm.isDefined(p)}
    tm = convert.dbscan_model_from_jax(params)
    assert tm.getMetric() == "cosine" and tm.solver_params["eps"] == 0.02
    np.testing.assert_array_equal(
        tm.transform(_df(x))["prediction"].to_numpy(), jm.transform(_df(x))["prediction"].to_numpy()
    )
    np.testing.assert_array_equal(tm.core_sample_indices_, jm.core_sample_indices_)


def test_refusals_name_their_items():
    x = _blobs(40, 2, 0.3, 1)
    m = DBSCAN(eps=0.5, min_samples=3).setFeaturesCol("features").fit(_df(x))
    m.num_workers = 2
    from spark_rapids_ml_tpu_torch import parallel

    with pytest.MonkeyPatch.context() as mp:  # two cards for a rank of a multi-process context: A10i
        mp.setattr(parallel, "visible_device_count", lambda: 2)
        mp.setattr(parallel, "spmd_context", lambda: types.SimpleNamespace(backend="gloo", is_spmd=True, rank=0, nranks=2))
        with pytest.raises(NotImplementedError, match="A10"):
            m.transform(_df(x))
    with pytest.raises(NotImplementedError):
        DBSCAN().fit(_df(x), warm_start_from=m)
    with pytest.raises(NotImplementedError, match="serving hook"):
        DBSCANModel()._serve_program()
