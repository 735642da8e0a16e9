#
# The PyTorch port's UMAP against the JAX package on the CPU: the same numpy
# inputs, made from a seed, through both packages, stage by stage and whole.
#
# Tolerances, stated per test:
#   * find_ab_params, smooth_knn (rho, sigma), fuzzy_simplicial_set,
#     _inverse_adjacency, _self_first and the negative samples: equal bit
#     for bit (the port evaluates JAX's CPU float32 exp, its left-to-right
#     row sums and its float64 bisection target; an rtol of 1e-5 would be
#     met with room);
#   * the kNN graph: ids equal on tie-free rows, distances equal on
#     integer rows and within the float32 summation bound on Gaussian ones;
#   * optimize_embedding, 1 and 5 epochs from the same Y0, fit and
#     transform mode: atol 1e-3 on coordinates of scale 10 (XLA's and
#     torch's float32 pow differ in the last bit, and the SGD doubles such
#     a difference every epoch or so, so longer runs are held by quality);
#   * spectral_init on a connected graph (a Gaussian cloud, a noisy circle,
#     whose two top modes nearly coincide): atol 5e-3 on coordinates of
#     scale 10 up to each column's sign;
#   * umap_fit with init="random" and 5 epochs on integer rows: atol 1e-3;
#   * whole fits at the JAX tests' sizes (200 epochs each side, to keep
#     the file fast): trustworthiness within 0.02 of JAX's and above 0.90;
#     supervised silhouette at least JAX's.
#
import numpy as np
import pandas as pd
import types
import pytest
import torch

import jax.numpy as jnp
from spark_rapids_ml_tpu.models.umap import UMAP as JaxUMAP
from spark_rapids_ml_tpu.models.umap import UMAPModel as JaxUMAPModel
from spark_rapids_ml_tpu.ops import umap as JO
from spark_rapids_ml_tpu.parallel import get_mesh
from spark_rapids_ml_tpu.parallel.mesh import dtype_scope
from spark_rapids_ml_tpu_torch import UMAP, UMAPModel, convert, parallel
from spark_rapids_ml_tpu_torch.core import load_instance
from spark_rapids_ml_tpu_torch.ops import umap as TO

CPU = torch.device("cpu")
ATOL_LAYOUT = 1e-3
ATOL_SPECTRAL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def port_on_cpu():
    # module-scoped: the shared fits below are made before any test runs.
    # One torch thread: the port's CPU epochs are hundreds of small ops,
    # which a thread pool only slows where test workers share the cores
    # (no result here depends on the thread count)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    parallel.set_devices("cpu")
    yield
    parallel.set_devices(None)
    torch.set_num_threads(threads)


def _blobs(n=600, d=10, k=5, seed=0, std=1.0):
    from sklearn.datasets import make_blobs

    x, y = make_blobs(n_samples=n, centers=k, n_features=d, cluster_std=std, random_state=seed)
    return x.astype(np.float64), y


def _df(x, y=None):
    d = {"features": list(x)}
    if y is not None:
        d["label"] = y.astype(np.float64)
    return pd.DataFrame(d)


def _emb(frame, col="embedding"):
    return np.stack(frame[col].to_list())


def _int_rows(n, d, seed):
    """Integer-valued float32 rows around a few integer centers, wide
    enough that no row's 16 nearest squared distances tie (checked): every
    squared distance is an exact float32 integer, the same in every
    summation order."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-1000, 1001, size=(4, d))
    x = (centers[rng.integers(0, 4, n)] + rng.integers(-100, 101, size=(n, d))).astype(np.float32)
    d2 = np.sort(((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1), axis=1)[:, 1:17]
    assert (np.diff(d2, axis=1) > 0).all(), "tied neighbours: pick another seed"
    # |q|^2, 2 q.x and every partial sum below 2^24: exact in float32
    assert 4 * float((x.astype(np.float64) ** 2).sum(1).max()) < 2**24
    return x


def _jax_graph(x, k=15):
    with dtype_scope(np.float32):
        return JO.build_knn_graph(np.asarray(x, np.float32), k, get_mesh())


def _dists(seed, n=2000, k=15):
    rng = np.random.default_rng(seed)
    d = np.sort(rng.uniform(0.1, 2.0, size=(n, k)), axis=1).astype(np.float32)
    d[:, 0] = 0.0
    d[:5, 1:4] = 0.0  # duplicate rows: zeros past the self column
    d[5] = 0.0  # a row of duplicates only: rho 0, the global floor
    return d


# ------------------------------------------------------- the graph stage ----


@pytest.mark.parametrize("spread,min_dist", [(1.0, 0.1), (2.0, 0.25), (1.0, 0.5)])
def test_find_ab_params_equal_jax(spread, min_dist):
    assert TO.find_ab_params(spread, min_dist) == JO.find_ab_params(spread, min_dist)


@pytest.mark.parametrize("lc", [1.0, 1.5, 0.5, 3.0, 2.25])
def test_smooth_knn_equals_jax_bit_for_bit(lc):
    d = _dists(int(lc * 10))
    rj, sj = JO.smooth_knn(jnp.asarray(d), lc)
    rt, st = TO.smooth_knn(torch.from_numpy(d), lc)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    # row 5 (duplicates only, rho 0) is floored at the mean of ALL the
    # distances, a sum XLA takes in an order of its own: rtol 1e-6 there
    rows = np.arange(len(d)) != 5
    np.testing.assert_array_equal(st.numpy()[rows], np.asarray(sj)[rows])
    np.testing.assert_allclose(st.numpy()[5], np.asarray(sj)[5], rtol=1e-6)
    # the calibration hits its target: log2(k) effective neighbours
    psum = np.sum(np.exp(-np.maximum(d - rt.numpy()[:, None], 0) / st.numpy()[:, None]), axis=1)
    if lc == 1.0:
        np.testing.assert_allclose(psum[6:], np.log2(15), rtol=1e-3)


@pytest.mark.parametrize("mix", [1.0, 0.3, 0.55])
def test_fuzzy_simplicial_set_equals_jax_bit_for_bit(mix):
    x = _blobs(300, seed=4)[0]
    idx, dist = _jax_graph(x)
    rj, sj = JO.smooth_knn(jnp.asarray(dist))
    want = np.asarray(JO.fuzzy_simplicial_set(jnp.asarray(idx), jnp.asarray(dist), rj, sj, mix))
    got = TO.fuzzy_simplicial_set(
        torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(dist),
        torch.from_numpy(np.asarray(rj)), torch.from_numpy(np.asarray(sj)), mix,
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_exp_f32_is_jax_exp():
    from spark_rapids_ml_tpu_torch.ops.prng import exp_f32

    rng = np.random.default_rng(0)
    x = np.concatenate([-rng.uniform(0, 20, 200_000), rng.uniform(-200, 80, 200_000),
                        [0.0, -0.0, -1e-40, -87.3, -88.0, -1e4, -np.inf]]).astype(np.float32)
    np.testing.assert_array_equal(exp_f32(torch.from_numpy(x)).numpy(), np.asarray(jnp.exp(jnp.asarray(x))))


def test_inverse_adjacency_self_first_and_overflow():
    rng = np.random.default_rng(3)
    n, k = 200, 6
    tail = rng.integers(0, n, size=(n, k))
    tail[:, 2] = 7  # a hub: in-degree 200 against the cap
    for cap in (None, 20):
        inv_t, ov_t = TO._inverse_adjacency(tail, n, cap)
        inv_j, ov_j = JO._inverse_adjacency(tail, n, cap)
        np.testing.assert_array_equal(inv_t, inv_j)
        np.testing.assert_array_equal(ov_t, ov_j)
    # every edge once: through inv or through the overflow table, under its tail
    flat = tail.reshape(-1)
    hubs, table = TO._overflow_gather(flat, ov_t)
    seen = np.zeros(n * k + 1, int)
    for t in range(n):
        for e in inv_t[t]:
            if e < n * k:
                assert flat[e] == t
                seen[e] += 1
    for h, row in zip(hubs, table):
        assert list(row[row < n * k]) == sorted(row[row < n * k])  # in edge order
        for e in row[row < n * k]:
            assert flat[e] == h
            seen[e] += 1
    assert (seen[:-1] == 1).all() and len(set(hubs)) == len(hubs)

    idx = rng.integers(0, n, size=(n, k))
    idx[np.arange(0, n, 3), 2] = np.arange(0, n, 3)  # self elsewhere than column 0
    dist = rng.uniform(0, 1, size=(n, k)).astype(np.float32)
    a = TO._self_first(idx.copy(), dist.copy())
    b = JO._self_first(idx.copy(), dist.copy())
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_segment_sum_against_in_order_sums():
    rng = np.random.default_rng(5)
    n = 50
    counts = rng.integers(0, 80, n)
    counts[3] = 0
    seg = torch.from_numpy(np.repeat(np.arange(n), counts))
    vals = torch.from_numpy(rng.integers(-9, 10, size=(int(counts.sum()), 3)).astype(np.float32))
    got = TO._SegmentSum(seg, n)(vals)
    want = torch.zeros((n, 3)).index_add_(0, seg, vals)  # integers: exact in any order
    assert torch.equal(got, want) and got[3].abs().sum() == 0
    assert torch.equal(TO._SegmentSum(seg, n)(vals[:, 0]), want[:, 0])


def test_knn_graph_ids_equal_jax():
    # Gaussian blobs (no two distances tie): ids equal, distances within
    # the float32 bound of the expanded ||q||^2 - 2 q.x + ||x||^2
    x = _blobs(600, seed=0)[0].astype(np.float32)
    ji, jd = _jax_graph(x)
    ti, td = TO.build_knn_graph(torch.from_numpy(x), 15)
    np.testing.assert_array_equal(ti, ji)
    bound = 8 * x.shape[1] * 2.0**-24 * float((x.astype(np.float64) ** 2).sum(1).max())
    assert np.abs(td.astype(np.float64) ** 2 - jd.astype(np.float64) ** 2).max() <= bound
    assert (ti[:, 0] == np.arange(len(x))).all() and (td[:, 0] == 0).all()
    # integer rows: every distance exact
    xi = _int_rows(300, 8, 2)
    ji, jd = _jax_graph(xi)
    ti, td = TO.build_knn_graph(torch.from_numpy(xi), 15)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("seed", [0, 42])
def test_negative_samples_bit_for_bit(seed):
    import jax

    shape, m = (300, 15, 5), 300
    for e in (0, 1, 199):
        want = np.asarray(jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(seed), e), shape, 0, m))
        np.testing.assert_array_equal(TO.negative_samples(seed, e, shape, m, CPU).numpy(), want)


# ------------------------------------------------------ the layout stage ----


@pytest.fixture(scope="module")
def graph600():
    x = _blobs(600, seed=0)[0].astype(np.float32)
    idx, dist = _jax_graph(x)
    r, s = JO.smooth_knn(jnp.asarray(dist))
    w = np.asarray(JO.fuzzy_simplicial_set(jnp.asarray(idx), jnp.asarray(dist), r, s))
    return x, idx, dist, w


@pytest.mark.parametrize("n_epochs", [1, 5])
def test_optimize_embedding_fit_mode_equals_jax(graph600, n_epochs):
    _, idx, _, w = graph600
    n = len(idx)
    a, b = JO.find_ab_params(1.0, 0.1)
    Y0 = np.random.default_rng(0).uniform(-10, 10, (n, 2)).astype(np.float32)
    w_opt = np.where(w >= w.max() / 200.0, w, 0.0)
    inv, ov = JO._inverse_adjacency(idx.astype(np.int32), n, cap=20)  # hubs overflow
    assert len(ov)
    want = np.asarray(JO.optimize_embedding(
        jnp.asarray(Y0), jnp.asarray(Y0), jnp.asarray(idx.astype(np.int32)), jnp.asarray(w_opt),
        jnp.asarray(inv), jnp.asarray(ov), n_epochs=n_epochs, a=a, b=b, fit_mode=True, seed=7,
    ))
    hubs, table = TO._overflow_gather(idx.reshape(-1).astype(np.int64), ov)
    got = TO.optimize_embedding(
        torch.from_numpy(Y0), torch.from_numpy(Y0), torch.from_numpy(idx.astype(np.int64)),
        torch.from_numpy(w_opt), torch.from_numpy(inv), (torch.from_numpy(hubs), torch.from_numpy(table)),
        n_epochs=n_epochs, a=a, b=b, fit_mode=True, seed=7,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_LAYOUT)
    assert np.abs(got - Y0).max() > 0.1  # the layout moved


@pytest.mark.parametrize("n_epochs", [1, 5])
def test_optimize_embedding_transform_mode_equals_jax(graph600, n_epochs):
    _, idx, _, w = graph600
    a, b = JO.find_ab_params(1.0, 0.1)
    ref = np.random.default_rng(1).uniform(-10, 10, (len(idx), 2)).astype(np.float32)
    Y0 = ref[:100] + np.float32(0.5)
    want = np.asarray(JO.optimize_embedding(
        jnp.asarray(Y0), jnp.asarray(ref), jnp.asarray(idx[:100].astype(np.int32)), jnp.asarray(w[:100]), None,
        n_epochs=n_epochs, a=a, b=b, fit_mode=False, seed=3,
    ))
    got = TO.optimize_embedding(
        torch.from_numpy(Y0), torch.from_numpy(ref), torch.from_numpy(idx[:100].astype(np.int64)),
        torch.from_numpy(w[:100]), None, n_epochs=n_epochs, a=a, b=b, fit_mode=False, seed=3,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_LAYOUT)


def _connected(kind):
    rng = np.random.default_rng(0)
    if kind == "cloud":
        return rng.normal(size=(400, 5)).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, 400)
    return (np.stack([np.cos(th), np.sin(th)], 1) + 0.05 * rng.normal(size=(400, 2))).astype(np.float32)


@pytest.mark.parametrize("kind", ["cloud", "circle"])
def test_spectral_init_up_to_sign_on_a_connected_graph(kind):
    idx, dist = _jax_graph(_connected(kind))
    r, s = JO.smooth_knn(jnp.asarray(dist))
    w = np.asarray(JO.fuzzy_simplicial_set(jnp.asarray(idx), jnp.asarray(dist), r, s))
    want = JO.spectral_init(idx, w, 2, 5)
    got = TO.spectral_init(idx, w, 2, 5, CPU)
    sign = np.sign((want * got).sum(0))
    np.testing.assert_allclose(got * sign, want, rtol=0, atol=ATOL_SPECTRAL)
    assert np.abs(got).max() == pytest.approx(10.0, abs=1e-3)


def test_spectral_init_on_blobs_is_a_valid_layout():
    # with several components the top eigenspace is not unique: any
    # rotation in it is right, so hold the layout's quality, not its values
    from sklearn.metrics import silhouette_score

    x, y = _blobs(300, seed=2)
    idx, dist = _jax_graph(x)
    r, s = JO.smooth_knn(jnp.asarray(dist))
    w = np.asarray(JO.fuzzy_simplicial_set(jnp.asarray(idx), jnp.asarray(dist), r, s))
    got = TO.spectral_init(idx, w, 2, 5, CPU)
    assert np.isfinite(got).all() and silhouette_score(got, y) > 0.5


def test_umap_fit_random_init_5_epochs_equals_jax():
    x = _int_rows(300, 8, 2)
    with dtype_scope(np.float32):
        want = JO.umap_fit(x, None, mesh=get_mesh(), init="random", n_epochs=5, random_state=3)
    got = TO.umap_fit(x, None, device=CPU, init="random", n_epochs=5, random_state=3)
    np.testing.assert_allclose(got["embedding_"], want["embedding_"], rtol=0, atol=ATOL_LAYOUT)
    assert got["a_"] == want["a_"] and got["b_"] == want["b_"]


# ------------------------------------------- the estimator, whole fits ----


@pytest.fixture(scope="module")
def blob_fits():
    x, y = _blobs()
    jm = JaxUMAP(n_components=2, random_state=42, n_epochs=200).setFeaturesCol("features").fit(_df(x))
    tm = UMAP(n_components=2, random_state=42, n_epochs=200).setFeaturesCol("features").fit(_df(x))
    return x, y, jm, tm


def test_fit_quality_against_jax(blob_fits):
    from sklearn.manifold import trustworthiness

    x, _, jm, tm = blob_fits
    assert tm.embedding_.shape == (600, 2) and tm.embedding_.dtype == np.float32
    tw_t = trustworthiness(x, tm.embedding_, n_neighbors=15)
    tw_j = trustworthiness(x, jm.embedding_, n_neighbors=15)
    assert tw_t > 0.90 and abs(tw_t - tw_j) <= 0.02, (tw_t, tw_j)
    np.testing.assert_array_equal(tm.raw_data_, x.astype(np.float32))
    assert (tm.a_, tm.b_) == (jm.a_, jm.b_)


def test_transform_of_near_duplicates_lands_near_the_fit(blob_fits):
    x, _, _, tm = blob_fits
    out = tm.transform(_df(x[:80] + 0.01))
    assert list(out.columns) == ["features", "embedding"]
    emb_new = _emb(out)
    d = np.linalg.norm(emb_new - tm.embedding_[:80], axis=1)
    assert np.median(d) < 0.15 * np.abs(tm.embedding_).max()


def test_fit_repeats_bit_for_bit(blob_fits):
    x, _, _, tm = blob_fits
    again = UMAP(n_components=2, random_state=42, n_epochs=200).setFeaturesCol("features").fit(_df(x))
    np.testing.assert_array_equal(again.embedding_, tm.embedding_)


def test_supervised_separates_at_least_as_well_as_jax():
    from sklearn.datasets import make_blobs
    from sklearn.metrics import silhouette_score

    x, y = make_blobs(n_samples=500, centers=3, n_features=8, cluster_std=6.0, random_state=5)
    x = x.astype(np.float64)
    un = UMAP(n_components=2, random_state=3, n_epochs=200).setFeaturesCol("features").fit(_df(x))
    sup = UMAP(n_components=2, random_state=3, n_epochs=200).setFeaturesCol("features").setLabelCol("label") \
        .fit(_df(x, y))
    jsup = JaxUMAP(n_components=2, random_state=3, n_epochs=200).setFeaturesCol("features").setLabelCol("label") \
        .fit(_df(x, y))
    s_un, s_sup = silhouette_score(un.embedding_, y), silhouette_score(sup.embedding_, y)
    assert s_sup > s_un and s_sup >= silhouette_score(jsup.embedding_, y), (s_sup, s_un)


def test_categorical_intersection_equals_jax():
    rng = np.random.default_rng(2)
    w = rng.uniform(0, 1, (50, 6)).astype(np.float32)
    idx = rng.integers(0, 50, (50, 6))
    lab = rng.integers(0, 3, 50).astype(np.float64)
    lab[[3, 9]] = np.nan
    np.testing.assert_array_equal(
        TO.categorical_intersection(w, idx, lab), JO.categorical_intersection(w, idx, lab)
    )


def test_cosine_metric():
    from sklearn.manifold import trustworthiness
    from sklearn.metrics import silhouette_score

    rng = np.random.default_rng(3)
    dirs = rng.normal(size=(4, 16))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    lab = rng.integers(0, 4, size=400)
    x = dirs[lab] * rng.uniform(0.1, 100.0, size=400)[:, None] + 0.01 * rng.normal(size=(400, 16))
    model = UMAP(n_components=2, metric="cosine", random_state=4, n_epochs=200).setFeaturesCol("features") \
        .fit(_df(x))
    emb = model.embedding_
    assert silhouette_score(emb, lab) > 0.5
    assert trustworthiness(x, emb, n_neighbors=15, metric="cosine") > 0.9
    emb_new = _emb(model.transform(_df(x[:50])))
    assert emb_new.shape == (50, 2) and np.isfinite(emb_new).all()
    # the graph on unit rows (here of tie-free blobs): the JAX package's ids
    from spark_rapids_ml_tpu_torch.utils import unit_rows

    xb = unit_rows(_blobs(300, seed=4)[0])
    ti, ji = TO.build_knn_graph(torch.from_numpy(xb), 15)[0], _jax_graph(xb)[0]
    d2 = np.sort(((xb[:, None].astype(np.float64) - xb[None]) ** 2).sum(-1), axis=1)[:, :16]
    tie_free = np.diff(d2, axis=1).min(1) > 1e-5  # no two of the 16 nearest within rounding
    assert tie_free.mean() > 0.8
    np.testing.assert_array_equal(ti[tie_free], ji[tie_free])


def test_precomputed_knn_matches_builtin_and_validation():
    from sklearn.manifold import trustworthiness
    from sklearn.neighbors import NearestNeighbors as SkNN

    x, _ = _blobs(n=300)
    base = UMAP(n_components=2, random_state=7, n_epochs=60).setFeaturesCol("features").fit(_df(x))
    idx, dist = TO.build_knn_graph(torch.from_numpy(x.astype(np.float32)), 15)
    pre = UMAP(n_components=2, random_state=7, n_epochs=60, precomputed_knn=(idx, dist)) \
        .setFeaturesCol("features").fit(_df(x))
    np.testing.assert_array_equal(pre.embedding_, base.embedding_)
    # a wide pair without the self column keeps each row's k-1 nearest
    far = np.random.default_rng(0).integers(0, 300, size=(300, 10))
    wide = UMAP(n_components=2, random_state=7, n_epochs=60, precomputed_knn=(
        np.concatenate([idx[:, 1:], far], 1), np.concatenate([dist[:, 1:], np.full((300, 10), 1e6, np.float32)], 1),
    )).setFeaturesCol("features").fit(_df(x))
    np.testing.assert_array_equal(wide.embedding_, base.embedding_)
    # normalisation equal to the JAX package's
    a = TO._normalized_precomputed(np.concatenate([idx[:, 1:], far], 1), np.concatenate(
        [dist[:, 1:], np.full((300, 10), 1e6, np.float32)], 1), 300, 15)
    np.testing.assert_array_equal(a[0], idx)
    sk_dist, sk_idx = SkNN(n_neighbors=15).fit(x).kneighbors(x)
    pre_sk = UMAP(n_components=2, random_state=7, n_epochs=200, precomputed_knn=(sk_idx, sk_dist)) \
        .setFeaturesCol("features").fit(_df(x))
    assert trustworthiness(x, pre_sk.embedding_, n_neighbors=15) > 0.90

    with pytest.raises(ValueError, match="pair"):
        UMAP(precomputed_knn=np.zeros((100, 15)))
    x100 = x[:100]
    with pytest.raises(ValueError, match="precomputed_knn"):
        UMAP(precomputed_knn=(np.zeros((50, 15), np.int64), np.zeros((50, 15)))).setFeaturesCol("features").fit(_df(x100))
    good = (np.zeros((100, 15), np.int64), np.zeros((100, 15)))
    with pytest.raises(ValueError, match="sample_fraction"):
        UMAP(precomputed_knn=good, sample_fraction=0.5).setFeaturesCol("features").fit(_df(x100))


def test_sample_fraction_keeps_jax_rows():
    x, _ = _blobs(n=400)
    m = UMAP(n_components=2, sample_fraction=0.5, random_state=0, n_epochs=30).setFeaturesCol("features").fit(_df(x))
    assert 100 < m.embedding_.shape[0] < 300
    assert m.raw_data_.shape[0] == m.embedding_.shape[0]
    keep = np.random.default_rng(0).random(400) < 0.5  # the JAX package's draw
    np.testing.assert_array_equal(m.raw_data_, x[keep].astype(np.float32))


def test_random_init_and_epochs():
    x, _ = _blobs(n=200)
    m = UMAP(n_components=2, init="random", n_epochs=50, random_state=0).setFeaturesCol("features").fit(_df(x))
    assert np.isfinite(m.embedding_).all()


# ---------------------------------------------- persistence, conversion ----


def test_save_load_npy_sidecar(tmp_path, blob_fits):
    import os

    x, _, _, model = blob_fits
    p = str(tmp_path / "umap")
    model.write().overwrite().save(p)
    assert os.path.exists(os.path.join(p, "data", "embedding_.npy"))
    assert os.path.exists(os.path.join(p, "data", "raw_data_.npy"))
    loaded = UMAPModel.load(p)
    np.testing.assert_array_equal(loaded.embedding_, model.embedding_)
    np.testing.assert_array_equal(loaded.raw_data_, model.raw_data_)
    assert (loaded.a_, loaded.b_) == (model.a_, model.b_)
    np.testing.assert_array_equal(_emb(loaded.transform(_df(x[:20]))), _emb(model.transform(_df(x[:20]))))
    jl = JaxUMAPModel.load(p)  # and the JAX package reads it
    np.testing.assert_array_equal(jl.embedding_, model.embedding_)


def test_jax_saved_model_loads_and_transforms_alike(tmp_path):
    # n_epochs=15: the transform runs 5 epochs, inside the layout tolerance
    x = _int_rows(300, 8, 2)
    q = x[:40] + np.float32(3)
    jm = JaxUMAP(n_components=2, random_state=11, n_epochs=15).setFeaturesCol("features").fit(_df(x))
    p = str(tmp_path / "jax_umap")
    jm.write().overwrite().save(p)
    for tm in (UMAPModel.load(p), load_instance(p)):
        assert isinstance(tm, UMAPModel)
        np.testing.assert_array_equal(tm.embedding_, jm.embedding_)
        np.testing.assert_array_equal(tm.raw_data_, jm.raw_data_)
        assert tm.getOrDefault("n_epochs") == 15
        np.testing.assert_allclose(_emb(tm.transform(_df(q))), _emb(jm.transform(_df(q))), rtol=0, atol=ATOL_LAYOUT)
    params = {p_.name: jm.getOrDefault(p_) for p_ in jm.params if jm.isDefined(p_)}
    cm = convert.umap_model_from_jax(dict(jm._model_attributes), params)
    np.testing.assert_array_equal(_emb(cm.transform(_df(q))), _emb(UMAPModel.load(p).transform(_df(q))))


# ------------------------------------------------------ surface, refusals ----


def test_param_surface_mirrors_jax():
    u = UMAP(n_neighbors=10, min_dist=0.25, spread=2.0)
    assert u.getNNeighbors() == 10 and u.getMinDist() == 0.25
    assert u.solver_params["min_dist"] == 0.25
    assert u.setNComponents(3).getNComponents() == 3
    with pytest.raises(ValueError, match="metric"):
        UMAP(metric="manhattan")
    with pytest.raises(ValueError, match="init"):
        UMAP(init="pca")
    with pytest.raises(ValueError, match="precomputed_knn"):
        UMAP(precomputed_knn=[[0, 1]])
    j, t = JaxUMAP(), UMAP()
    assert sorted(p.name for p in t.params) == sorted(p.name for p in j.params)
    for p in j.params:
        if j.hasDefault(p):
            assert t.getOrDefault(p.name) == j.getOrDefault(p), p.name
    assert t.solver_params == j.solver_params
    assert TO.default_n_epochs(10000) == JO.default_n_epochs(10000) == 500
    assert TO.default_n_epochs(10001) == JO.default_n_epochs(10001) == 200


def test_refusals():
    x, _ = _blobs(n=60)
    est = UMAP(n_epochs=5).setFeaturesCol("features")
    with pytest.raises(NotImplementedError, match="fitMultiple"):
        est.fit(_df(x), [{est.getParam("n_epochs"): 3}])
    m = est.fit(_df(x))
    with pytest.raises(NotImplementedError):
        UMAP().setFeaturesCol("features").fit(_df(x), warm_start_from=m)
    with pytest.raises(NotImplementedError, match="serving hook"):
        m._serve_program()
    m.num_workers = 2
    from spark_rapids_ml_tpu_torch import parallel

    with pytest.MonkeyPatch.context() as mp:  # two cards for a rank of a multi-process context: A10i
        mp.setattr(parallel, "visible_device_count", lambda: 2)
        mp.setattr(parallel, "spmd_context", lambda: types.SimpleNamespace(backend="gloo", is_spmd=True, rank=0, nranks=2))
        with pytest.raises(NotImplementedError, match="A10"):
            m.transform(_df(x))
        est.num_workers = 2
        with pytest.raises(NotImplementedError, match="A10"):
            est.fit(_df(x))


def test_chip_smoke_quality_measures_equal_sklearn():
    # chip_smoke.py's phase 12 computes ARI and trustworthiness in numpy
    # (sklearn is not on the card's machine): both equal sklearn's here
    import sys
    from pathlib import Path

    from sklearn.manifold import trustworthiness
    from sklearn.metrics import adjusted_rand_score

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    rng = np.random.default_rng(0)
    a = rng.integers(-1, 6, 3000)
    b = np.where(rng.random(3000) < 0.8, a, rng.integers(-1, 6, 3000))
    assert cs.adjusted_rand_index(a, b) == pytest.approx(adjusted_rand_score(a, b), abs=1e-12)
    assert cs.adjusted_rand_index(a, a + 7) == 1.0
    x, y = cs.make_blobs(503, 16, 5, 1)
    assert x.shape == (503, 16) and x.dtype == np.float32
    assert list(np.bincount(y)) == [101, 101, 101, 100, 100]
    emb = x[:, :2] + rng.normal(size=(503, 2)).astype(np.float32)
    assert cs.trustworthiness(x, emb, 15) == pytest.approx(trustworthiness(x, emb, n_neighbors=15), abs=1e-12)
