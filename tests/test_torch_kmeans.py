#
# The PyTorch port's KMeans (spark_rapids_ml_tpu_torch) against the JAX
# package's (spark_rapids_ml_tpu) on the CPU: the same data, made with numpy
# from a seed, through both estimators' public fit/transform API. The JAX
# side runs one device (num_workers=1) with its distance core in its own CPU
# mode, as tests/test_kmeans.py runs it; the port runs its plain PyTorch
# versions (set_devices("cpu")).
#
import numpy as np
import pytest

from spark_rapids_ml_tpu.models.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.ops import kmeans as jkm
from spark_rapids_ml_tpu_torch import parallel as port_parallel
from spark_rapids_ml_tpu_torch.errors import SolverDivergedError
from spark_rapids_ml_tpu_torch.models.clustering import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.ops import kmeans as tkm


@pytest.fixture(autouse=True)
def port_on_cpu():
    port_parallel.set_devices("cpu")
    yield
    port_parallel.set_devices(None)


def _blobs(n, d, centers, std, seed, dtype=np.float32):
    from sklearn.datasets import make_blobs

    x, _ = make_blobs(n_samples=n, n_features=d, centers=centers, cluster_std=std, random_state=seed)
    return x.astype(dtype)


def _fit_both(x, **params):
    jm = JaxKMeans(num_workers=1, **params).setFeaturesCol("features").fit({"features": x})
    tm = KMeans(**params).setFeaturesCol("features").fit({"features": x})
    return jm, tm


def _predictions(model, x):
    return np.asarray(model.transform({"features": x})["prediction"], dtype=np.int64)


# ------------------------------------------------------------- seeders ----


@pytest.mark.parametrize("seed", [1, 7, 123])
def test_random_init_identical_to_jax(seed):
    x = np.random.default_rng(seed).normal(size=(300, 5))
    np.testing.assert_array_equal(tkm.random_init(x, 9, seed), jkm.random_init(x, 9, seed))


@pytest.mark.parametrize("seed", [1, 7, 123])
@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_plus_plus_init_identical_to_jax(seed, weighted):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(400, 6))
    w = rng.uniform(0.5, 2.0, size=400) if weighted else None
    np.testing.assert_array_equal(
        tkm.kmeans_plus_plus_init(x, 12, seed, w), jkm.kmeans_plus_plus_init(x, 12, seed, w)
    )


# ------------------------------------------------------- Lloyd parity ----


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fit_high_precision_matches_jax(seed):
    # same data, same init (random_init is a copy), distance_precision="high":
    # the Lloyd trajectories agree, so n_iter_ is equal and the centers and
    # inertia agree to f32 summation-order noise (rtol 1e-5)
    x = _blobs(600, 5, 6, 1.5, seed=seed)
    jm, tm = _fit_both(
        x, k=6, maxIter=30, tol=1e-8, initMode="random", seed=seed, distance_precision="high"
    )
    assert tm.n_iter_ == jm.n_iter_
    np.testing.assert_allclose(tm.cluster_centers_, jm.cluster_centers_, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.inertia_, jm.inertia_, rtol=1e-5)
    np.testing.assert_array_equal(_predictions(tm, x), _predictions(jm, x))


@pytest.mark.parametrize("max_iter", [1, 2, 5])
def test_fit_stops_at_max_iter_like_jax(max_iter):
    # the deferred (one iteration late) convergence check: n_iter_ equal at
    # every cut-off, including a 1-iteration fit
    x = _blobs(500, 4, 5, 2.5, seed=4)
    jm, tm = _fit_both(
        x, k=5, maxIter=max_iter, tol=1e-20, initMode="random", seed=3, distance_precision="high"
    )
    assert tm.n_iter_ == jm.n_iter_ == max_iter
    np.testing.assert_allclose(tm.cluster_centers_, jm.cluster_centers_, rtol=1e-5, atol=1e-5)


def test_fit_float64_matches_jax():
    x = _blobs(400, 6, 4, 1.0, seed=9, dtype=np.float64)
    jm, tm = _fit_both(
        x, k=4, maxIter=20, tol=1e-10, initMode="random", seed=5, float32_inputs=False
    )
    assert tm.cluster_centers_.dtype == np.float64
    assert tm.n_iter_ == jm.n_iter_
    np.testing.assert_allclose(tm.cluster_centers_, jm.cluster_centers_, rtol=1e-9)
    np.testing.assert_allclose(tm.inertia_, jm.inertia_, rtol=1e-9)


@pytest.mark.parametrize("seed", [5, 6])
def test_fit_fast_mode_same_predictions_on_separated_blobs(seed):
    # default distance_precision="fast" (bf16 products, f32 accumulation) on
    # well-separated blobs: identical predictions, inertia to rtol 1e-5
    x = _blobs(800, 8, 5, 0.5, seed=seed)
    jm, tm = _fit_both(x, k=5, maxIter=20, seed=seed, initMode="random")
    assert tm.n_iter_ == jm.n_iter_
    np.testing.assert_array_equal(_predictions(tm, x), _predictions(jm, x))
    np.testing.assert_allclose(tm.inertia_, jm.inertia_, rtol=1e-5)


def test_fit_weighted_matches_jax():
    x = _blobs(300, 3, 3, 1.0, seed=8)
    w = np.random.default_rng(8).uniform(0.1, 3.0, size=300).astype(np.float32)
    data = {"features": x, "w": w}
    params = dict(k=3, maxIter=15, tol=1e-9, seed=2, distance_precision="high")
    jm = JaxKMeans(num_workers=1, **params).setWeightCol("w").fit(data)
    tm = KMeans(**params).setWeightCol("w").fit(data)
    assert tm.n_iter_ == jm.n_iter_
    np.testing.assert_allclose(tm.cluster_centers_, jm.cluster_centers_, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.inertia_, jm.inertia_, rtol=1e-5)


def test_warm_start_from_the_same_centers_matches_jax():
    # identical init through warm_start_from, here from the JAX package's
    # k-means|| seeding
    x = _blobs(2000, 6, 70, 1.0, seed=3)
    donor = JaxKMeans(k=64, maxIter=1, seed=4, num_workers=1).fit({"features": x})
    params = dict(k=64, maxIter=8, tol=1e-12, seed=4, distance_precision="high")
    jm = JaxKMeans(num_workers=1, **params).fit({"features": x}, warm_start_from=donor)
    tm = KMeans(**params).fit({"features": x}, warm_start_from=donor)
    assert tm.n_iter_ == jm.n_iter_
    np.testing.assert_allclose(tm.cluster_centers_, jm.cluster_centers_, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tm.inertia_, jm.inertia_, rtol=1e-5)


def test_scalable_init_inertia_ratio_to_jax_over_seeds():
    # k >= 64 takes k-means|| seeding, whose last reduce-to-k draws from
    # JAX's threefry stream on both sides (fault C4, fixed): on Gaussian
    # blobs the inits agree, and the inertia per seed to float32 noise
    # (tests/test_torch_ann.py pins the inits bit for bit on integer rows)
    x = _blobs(3000, 8, 80, 1.0, seed=3)
    jax_total = port_total = 0.0
    for seed in range(1, 7):
        jm, tm = _fit_both(x, k=64, maxIter=5, seed=seed)
        assert abs(tm.inertia_ / jm.inertia_ - 1.0) <= 1e-5, (seed, tm.inertia_, jm.inertia_)
        jax_total += jm.inertia_
        port_total += tm.inertia_
    assert abs(port_total / jax_total - 1.0) <= 1e-5


def test_empty_cluster_keeps_its_center():
    # a center far from every row gets no rows: it stays where it was
    x = np.array([[0.0, 0.0], [0.0, 1.0], [10.0, 10.0], [10.0, 11.0]], dtype=np.float32)
    init = KMeansModel(
        cluster_centers_=np.array([[0.0, 0.5], [10.0, 10.5], [500.0, 500.0]], dtype=np.float32),
        n_cols=2,
    )
    tm = KMeans(k=3, maxIter=5, distance_precision="high").fit({"features": x}, warm_start_from=init)
    np.testing.assert_array_equal(tm.cluster_centers_[2], [500.0, 500.0])


def test_non_finite_rows_raise_solver_diverged():
    x = _blobs(100, 3, 2, 1.0, seed=1)
    x[5, 1] = np.nan
    with pytest.raises(SolverDivergedError, match="kmeans diverged"):
        KMeans(k=2, maxIter=4, initMode="random", seed=1).fit({"features": x})
