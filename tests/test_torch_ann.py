#
# The PyTorch port's ApproximateNearestNeighbors (IVFFlat, IVFPQ) and the
# draws under it against the JAX package on the CPU: the same numpy inputs,
# made from a seed, through JAX's functions and the port's.
#
#   * ops/prng.py's randint, gumbel and categorical against jax.random
#     (bit for bit; a float64 gumbel within one unit in the last place:
#     torch's float64 log is not glibc's), and its float32 log against
#     jnp.log bit for bit;
#   * fault C4: KMeans's k-means|| seeding draws from JAX's stream, so on
#     integer-valued rows and weights, where every float32 sum is exact,
#     the initial centers equal JAX's;
#   * the device k-means|| seeding of the ANN builds, the IVF layout, the
#     searches on an index carried across from JAX, the PQ codes and the
#     float64 refine;
#   * the estimator surface, its metrics and its refusals.
#
# CAGRA has its own file, tests/test_torch_cagra.py.
#
import types
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu.models.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.models.knn import ApproximateNearestNeighbors as JaxANN
from spark_rapids_ml_tpu.ops import kmeans as jkm
from spark_rapids_ml_tpu.ops import knn as jknn
from spark_rapids_ml_tpu.utils import unit_rows as jax_unit_rows
from spark_rapids_ml_tpu_torch import ApproximateNearestNeighbors, KMeans, NearestNeighbors, convert, parallel
from spark_rapids_ml_tpu_torch.linalg import Vectors
from spark_rapids_ml_tpu_torch.ops import kmeans as tkm
from spark_rapids_ml_tpu_torch.ops import knn as tknn
from spark_rapids_ml_tpu_torch.ops import prng
from spark_rapids_ml_tpu_torch.utils import unit_rows


@pytest.fixture(autouse=True)
def port_on_cpu():
    parallel.set_devices("cpu")
    yield
    parallel.set_devices(None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _int_rows(n, d, seed, lo=-4, hi=5):
    """Integer-valued float32 rows: every sum of their squares and products
    below 2^24 is exact in float32, in any order."""
    return np.random.default_rng(seed).integers(lo, hi, size=(n, d)).astype(np.float32)


def _blobs(n, d, centers, seed, std=0.3):
    from sklearn.datasets import make_blobs

    x, _ = make_blobs(n_samples=n, n_features=d, centers=centers, cluster_std=std, random_state=seed)
    return x.astype(np.float32)


def _frames(items, queries):
    item_df = pd.DataFrame({"features": list(items), "id": np.arange(len(items), dtype=np.int64)})
    query_df = pd.DataFrame({"features": list(queries), "id": np.arange(len(queries), dtype=np.int64) + 1000})
    return item_df, query_df


def _padded_bucket_ids(index):
    """The JAX package's padded list layout [C, L] (-1 pad) of the port's
    unpadded IVFFlat index."""
    offsets = index["offsets"].numpy()
    counts = np.diff(offsets)
    out = np.full((len(counts), int(counts.max())), -1, np.int64)
    for c, (o0, o1) in enumerate(zip(offsets[:-1], offsets[1:])):
        out[c, :o1 - o0] = index["row_ids"].numpy()[o0:o1]
    return out


def _ids(knn_df):
    return np.stack(knn_df["indices"].to_list())


def _dists(knn_df):
    return np.stack(knn_df["distances"].to_list())


# ------------------------------------------------------------ the stream ----


@pytest.mark.parametrize("seed", [0, 3, 2 ** 40 + 5])
@pytest.mark.parametrize("lo,hi", [(0, 7), (3, 1000), (0, 1_000_000), (17, 128), (5, 5), (0, 2 ** 31 - 1)])
def test_randint_matches_jax(seed, lo, hi):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    want = np.asarray(jax.random.randint(jk, (40, 3), lo, hi, jnp.int32))
    np.testing.assert_array_equal(prng.randint(tk, (40, 3), lo, hi).numpy(), want)


def test_batched_keys_draw_as_a_loop_over_the_keys():
    # the descent's per-tile draws: fold_in over a tensor of tile numbers,
    # split in three, randint under each key
    jk, tk = jax.random.PRNGKey(11), prng.prng_key(11)
    keys = prng.split(prng.fold_in(tk, torch.arange(6)), 3)
    got = prng.randint(keys[:, 1], (5, 2), 2, 77).numpy()
    for t in range(6):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(jk, t), 3)
        np.testing.assert_array_equal(got[t], np.asarray(jax.random.randint(k2, (5, 2), 2, 77, jnp.int32)))


def test_log_f32_matches_jnp_log_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 1, 200_000), np.exp(rng.uniform(-87, 88, 200_000)),
                        [0.0, 1.0, 2.0, np.inf, 0.70710677, 0.7071068]]).astype(np.float32)
    np.testing.assert_array_equal(prng.log_f32(_t(x)).numpy(), np.asarray(jax.jit(jnp.log)(x)))
    assert np.isnan(prng.log_f32(_t(np.float32([-1.0]))).numpy()).all()


@pytest.mark.parametrize("seed", [0, 7])
def test_uniform_on_a_range_gumbel_and_categorical_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        want = np.asarray(jax.random.uniform(jk, (5000,), jdt, minval=1e-20, maxval=1.0))
        np.testing.assert_array_equal(prng.uniform(tk, (5000,), tdt, 1e-20, 1.0).numpy(), want)
    np.testing.assert_array_equal(prng.gumbel(tk, (50_000,), torch.float32).numpy(),
                                  np.asarray(jax.random.gumbel(jk, (50_000,), jnp.float32)))
    # float64: torch's log is not glibc's (one unit in the last place apart
    # in a few values in a thousand), and the outer log carries the inner
    # one's difference on as an absolute one: within 2 ulp of 1.0
    g = prng.gumbel(tk, (50_000,), torch.float64).numpy()
    want = np.asarray(jax.random.gumbel(jk, (50_000,), jnp.float64))
    np.testing.assert_allclose(g, want, rtol=4.5e-16, atol=4.5e-16)
    assert (g == want).mean() > 0.99
    logits = np.log(np.random.default_rng(seed).uniform(0.05, 3.0, size=(300, 400))).astype(np.float32)
    np.testing.assert_array_equal(prng.categorical(tk, _t(logits)).numpy(),
                                  np.asarray(jax.random.categorical(jk, logits)))


@pytest.mark.parametrize("seed", [0, 1, 99])
def test_key_chain_and_its_uniforms_match_jax(seed):
    key, subs = jax.random.PRNGKey(seed), []
    for _ in range(5):
        key, sub = jax.random.split(key)
        subs.append(sub)
    assert prng.key_chain(seed, 5) == [tuple(int(v) for v in np.asarray(s)) for s in subs]
    np.testing.assert_array_equal(prng.uniform_f32_of(prng.key_chain(seed, 5)),
                                  [np.asarray(jax.random.uniform(s, (), jnp.float32)) for s in subs])


# ---------------------------------------------------------- C4: seeding ----


@pytest.mark.parametrize("seed", [1, 4, 17])
def test_kmeanspp_device_matches_jax(seed):
    x = _int_rows(700, 6, seed)
    w = np.random.default_rng(seed).integers(1, 4, 700).astype(np.float32)
    want = np.asarray(jkm._kmeanspp_device(jnp.asarray(x), jnp.asarray(w), seed, k=40))
    np.testing.assert_array_equal(tkm._kmeanspp_device(_t(x), _t(w), seed, k=40).numpy(), want)


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_scalable_init_matches_jax_on_integer_rows(seed):
    x = _int_rows(1500, 5, seed)
    w = np.random.default_rng(seed + 1).integers(1, 3, 1500).astype(np.float64)
    want = jkm.scalable_kmeans_init(x, 64, seed, w)
    np.testing.assert_array_equal(tkm.scalable_kmeans_init(x, 64, seed, w, device=torch.device("cpu")), want)


def _capture(monkeypatch, module, name, into):
    orig = getattr(module, name)

    def spy(*a, **k):
        out = orig(*a, **k)
        into.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("seed", [1, 3, 8])
def test_kmeans_parallel_init_of_the_estimator_equals_jax(monkeypatch, seed):
    # KMeans(initMode="k-means||", k >= 64) seeds by scalable_kmeans_init:
    # its initial centers equal the JAX estimator's, and so does the fit
    x = _int_rows(1200, 4, seed)
    got, want = [], []
    _capture(monkeypatch, tkm, "scalable_kmeans_init", got)
    _capture(monkeypatch, jkm, "scalable_kmeans_init", want)
    params = dict(k=64, maxIter=2, seed=seed, initMode="k-means||", distance_precision="high")
    tm = KMeans(**params).fit({"features": x})
    jm = JaxKMeans(num_workers=1, **params).fit({"features": x})
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(tm.cluster_centers_, jm.cluster_centers_, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 2, 6])
def test_scalable_init_device_matches_jax(monkeypatch, seed):
    # the ANN builds' seeding: the same candidate rows and weights (the
    # arguments of the final k-means++) and the same centers
    x = _int_rows(2000, 6, seed)
    got, want = [], []
    for module, into in ((tkm, got), (jkm, want)):
        orig = module._kmeanspp_device

        def spy(cand, w, s, *, k, _orig=orig, _into=into):
            _into.append((np.asarray(cand), np.asarray(w)))
            return _orig(cand, w, s, k=k)

        monkeypatch.setattr(module, "_kmeanspp_device", spy)
    c_port = tkm.scalable_kmeans_init_device(_t(x), 64, seed).numpy()
    c_jax = np.asarray(jkm.scalable_kmeans_init_device(jnp.asarray(x), 64, seed))
    np.testing.assert_array_equal(got[0][0], want[0][0])  # 6 blocks of 128 candidates
    np.testing.assert_array_equal(got[0][1], want[0][1])
    np.testing.assert_array_equal(c_port, c_jax)


def test_kmeanspar_round_matches_jax():
    x = _int_rows(900, 5, 3)
    xd = jnp.asarray(x)
    sw = np.ones(900, np.float32)
    cand = x[:16]
    key = jax.random.PRNGKey(4)
    jc, jd = jkm._kmeanspar_round(xd, jnp.asarray(cand), jnp.full((900,), jnp.inf, jnp.float32),
                                  jnp.asarray(sw), key, l=16)
    tc, td = tkm._kmeanspar_round(_t(x), _t(cand), torch.full((900,), float("inf")), _t(sw),
                                  prng.prng_key(4), l=16)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# -------------------------------------------------------------- IVFFlat ----


def test_ivf_layout_from_jax_centroids_equals_jax():
    x = _blobs(1500, 8, 30, 2)
    xd, centroids, assign, *_ = jknn._coarse_quantizer(x, 24, 0)
    index = jknn.build_ivfflat(x, 24, seed=0)
    a = tknn.argmin_assign(_t(x), _t(np.asarray(centroids))).numpy()
    np.testing.assert_array_equal(a, assign)
    sorted_assign, order, offsets, n_lists, L = tknn._list_layout(a, 24)
    ids = np.full((n_lists, L), -1, np.int64)
    ids[sorted_assign, offsets] = order
    np.testing.assert_array_equal(ids, np.asarray(index["bucket_ids"]))


@pytest.mark.parametrize("n_lists", [16, 64])
def test_ivfflat_build_on_blobs_equals_jax(n_lists):
    # n_lists < 64 seeds by k-means++ on the leading rows, >= 64 by the
    # device k-means||; both then run 10 fast Lloyd iterations
    x = _blobs(3000, 12, 90, 5)
    # the port stores the lists unpadded: the same slots, without the pads
    want = jknn.build_ivfflat(x, n_lists, seed=0)
    got = tknn.build_ivfflat(_t(x), n_lists, seed=0)
    np.testing.assert_allclose(got["centroids"].numpy(), np.asarray(want["centroids"]), rtol=1e-5, atol=1e-5)
    ids = np.asarray(want["bucket_ids"])
    np.testing.assert_array_equal(_padded_bucket_ids(got), ids)
    np.testing.assert_array_equal(got["rows"].numpy(), np.asarray(want["buckets"])[ids >= 0])
    carried = tknn.ivfflat_from_padded(want["centroids"], want["buckets"], want["bucket_ids"])
    for key in ("rows", "row_ids", "offsets"):
        np.testing.assert_array_equal(carried[key].numpy(), got[key].numpy())


@pytest.mark.parametrize("n_probes,batch", [(3, 1024), (8, 16)])
def test_ivfflat_search_on_a_jax_index_equals_jax(n_probes, batch):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1200, 10)).astype(np.float32)
    q = rng.normal(size=(70, 10)).astype(np.float32)
    ix = jknn.build_ivfflat(x, 20, seed=0)
    wd, wi = jknn.ivfflat_search(jnp.asarray(q), ix["centroids"], ix["buckets"], ix["bucket_ids"],
                                 k=9, n_probes=n_probes, batch_queries=batch)
    carried = tknn.ivfflat_from_padded(ix["centroids"], ix["buckets"], ix["bucket_ids"])
    gd, gi = tknn.ivfflat_search(_t(q), carried, k=9, n_probes=n_probes, batch_queries=batch)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_allclose(gd, np.asarray(wd), rtol=1e-5)


def test_ivfflat_search_ties_equal_jax_on_integer_rows():
    # integer rows, many repeated: exact distances with ties across probes
    # and slots, broken the same way (earlier probe, then earlier slot)
    x = _int_rows(900, 6, 8, lo=-2, hi=3)
    q = np.concatenate([x[:20], _int_rows(20, 6, 9, lo=-2, hi=3)])
    ix = jknn.build_ivfflat(x, 12, seed=0)
    wd, wi = jknn.ivfflat_search(jnp.asarray(q), ix["centroids"], ix["buckets"], ix["bucket_ids"],
                                 k=15, n_probes=5, batch_queries=16)
    carried = tknn.ivfflat_from_padded(ix["centroids"], ix["buckets"], ix["bucket_ids"])
    gd, gi = tknn.ivfflat_search(_t(q), carried, k=15, n_probes=5, batch_queries=16)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_array_equal(gd, np.asarray(wd))


def test_ivfflat_probing_every_list_is_exact():
    rng = np.random.default_rng(0)
    items, queries = rng.normal(size=(512, 8)), rng.normal(size=(32, 8))
    item_df, query_df = _frames(items, queries)
    model = ApproximateNearestNeighbors(k=8, algoParams={"nlist": 16, "nprobe": 16}) \
        .setInputCol("features").setIdCol("id").fit(item_df)
    _, _, knn_df = model.kneighbors(query_df)
    from sklearn.neighbors import NearestNeighbors as SkNN

    sk_d, sk_i = SkNN(n_neighbors=8).fit(items).kneighbors(queries)
    np.testing.assert_array_equal(_ids(knn_df), sk_i)
    np.testing.assert_allclose(_dists(knn_df), sk_d, rtol=1e-5)


def test_under_filled_results_carry_minus_one_and_the_join_drops_them():
    rng = np.random.default_rng(2)
    item_df, query_df = _frames(rng.normal(size=(20, 3)), rng.normal(size=(5, 3)))
    ann = ApproximateNearestNeighbors(k=10, algoParams={"nlist": 10, "nprobe": 1}).setInputCol("features").setIdCol("id")
    model = ann.fit(item_df)
    _, _, knn_df = model.kneighbors(query_df)
    ids, dists = _ids(knn_df), _dists(knn_df)
    assert (ids == -1).any()
    assert np.isinf(dists[ids == -1]).all() and np.isfinite(dists[ids >= 0]).all()
    _, _, jknn_df = JaxANN(k=10, algoParams={"nlist": 10, "nprobe": 1}).setInputCol("features").setIdCol("id") \
        .fit(item_df).kneighbors(query_df)
    np.testing.assert_array_equal(ids, _ids(jknn_df))
    out = model.approxSimilarityJoin(query_df)
    assert len(out) == (ids >= 0).sum()
    assert (out["item_id"] != -1).all() and np.isfinite(out["distCol"]).all()


# ---------------------------------------------------------------- IVFPQ ----


def test_pq_codes_from_jax_centroids_and_codebooks_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3000, 16)).astype(np.float32)
    ix = jknn.build_ivfpq(x, 12, M=4, n_bits=5, seed=0)
    C = np.asarray(ix["centroids"])
    A = tknn.argmin_assign(_t(x), _t(C))
    want = np.asarray(jknn._encode_residuals(jnp.asarray(x), jnp.asarray(C), jnp.asarray(A.numpy()),
                                             jnp.asarray(ix["codebooks"])))
    got = tknn._encode_residuals(_t(x), _t(C), A, _t(ix["codebooks"])).numpy()
    np.testing.assert_array_equal(got, want)


def _carried_ivfpq(ix):
    return {
        "centroids": _t(np.asarray(ix["centroids"])), "codebooks": _t(ix["codebooks"]),
        "code_buckets": _t(ix["code_buckets"]), "bucket_ids": _t(ix["bucket_ids"]),
    }


@pytest.mark.parametrize("n_bits", [4, 8])
def test_adc_search_on_a_jax_index_equals_jax(n_bits):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1500, 12)).astype(np.float32)
    q = rng.normal(size=(40, 12)).astype(np.float32)
    ix = jknn.build_ivfpq(x, 10, M=3, n_bits=n_bits, seed=0)
    wd, wi = jknn.ivfpq_search(jnp.asarray(q), ix, k=20, n_probes=4, batch_queries=16)
    gd, gi = tknn.ivfpq_search(_t(q), _carried_ivfpq(ix), k=20, n_probes=4, batch_queries=16)
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_allclose(gd, np.asarray(wd), rtol=1e-5)


def test_ivfpq_build_codebooks_and_codes_equal_jax_on_blobs():
    x = _blobs(2500, 16, 40, 6)
    want = jknn.build_ivfpq(x, 16, M=4, n_bits=6, seed=0)
    got = tknn.build_ivfpq(_t(x), 16, M=4, n_bits=6, seed=0)
    np.testing.assert_array_equal(got["bucket_ids"].numpy(), want["bucket_ids"])
    np.testing.assert_allclose(got["codebooks"].numpy(), want["codebooks"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["code_buckets"].numpy(), want["code_buckets"])


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_refine_equals_jax_refine_exact(metric):
    # tie-free candidates: the same ids, float64 distances to 1e-12
    rng = np.random.default_rng(5)
    items = rng.normal(size=(600, 9))
    item_df, _ = _frames(items, items[:1])
    jm = JaxANN(k=6, algorithm="ivfpq", metric=metric, algoParams={"nlist": 8, "M": 3}) \
        .setInputCol("features").fit(item_df)
    q = rng.normal(size=(25, 9)).astype(np.float32)
    q = jax_unit_rows(q) if metric == "cosine" else q
    cand = rng.integers(-1, 600, size=(25, 30))
    cand[:, :6] = np.arange(6)  # no row short of k
    wd, wi = jm._refine_exact(q, cand, 6)
    feats = np.asarray(items, np.float32)
    x = unit_rows(feats) if metric == "cosine" else feats
    gd, gi = tknn.refine_exact(_t(x), _t(q), _t(cand), 6)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-12)


def test_ivfpq_recall_and_the_estimator_surface():
    x = _blobs(2000, 32, 20, 4, std=1.0).astype(np.float64)
    df = pd.DataFrame({"features": list(x)})
    ann = ApproximateNearestNeighbors(k=8, algorithm="ivfpq",
                                      algoParams={"nlist": 32, "nprobe": 8, "M": 8, "n_bits": 6}) \
        .setInputCol("features").fit(df)
    assert ann._solver_params["pq_m"] == 8 and ann._solver_params["pq_n_bits"] == 6
    _, _, knn_df = ann.kneighbors(df.iloc[:200])
    _, _, exact_df = NearestNeighbors(k=8).setInputCol("features").fit(df).kneighbors(df.iloc[:200])
    got, ref = _ids(knn_df), _ids(exact_df)
    recall = np.mean([len(set(got[i]) & set(ref[i])) / 8 for i in range(200)])
    assert recall > 0.6, recall


def test_ivfpq_rejects_an_m_that_does_not_divide_d():
    df = pd.DataFrame({"features": list(np.random.default_rng(0).normal(size=(100, 10)))})
    with pytest.raises(ValueError, match="M=3 must divide"):
        ApproximateNearestNeighbors(k=3, algorithm="ivfpq", algoParams={"M": 3}).setInputCol("features").fit(df)


# ------------------------------------------------- the estimator vs JAX ----


@pytest.mark.parametrize("algo,ap", [
    ("ivfflat", {"nlist": 8, "nprobe": 3}),
    ("ivfpq", {"nlist": 8, "nprobe": 4, "M": 4, "n_bits": 5}),
])
@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
def test_estimator_equals_jax(algo, ap, metric):
    rng = np.random.default_rng(6)
    items, queries = rng.normal(size=(500, 12)), rng.normal(size=(30, 12))
    item_df, query_df = _frames(items, queries)
    kw = dict(k=6, algorithm=algo, metric=metric, algoParams=ap)
    _, _, got = ApproximateNearestNeighbors(**kw).setInputCol("features").setIdCol("id").fit(item_df).kneighbors(query_df)
    _, _, want = JaxANN(**kw).setInputCol("features").setIdCol("id").fit(item_df).kneighbors(query_df)
    np.testing.assert_array_equal(_ids(got), _ids(want))
    np.testing.assert_allclose(_dists(got), _dists(want), rtol=1e-5)
    np.testing.assert_array_equal(got["query_id"].to_numpy(), want["query_id"].to_numpy())


def test_carried_jax_model_searches_as_jax():
    rng = np.random.default_rng(7)
    items, queries = rng.normal(size=(800, 10)), rng.normal(size=(25, 10))
    item_df, query_df = _frames(items, queries)
    for algo, ap in (("ivfflat", {"nlist": 12, "nprobe": 4}), ("ivfpq", {"nlist": 12, "nprobe": 4, "M": 5})):
        jm = JaxANN(k=5, algorithm=algo, algoParams=ap).setInputCol("features").setIdCol("id").fit(item_df)
        attrs = {"algorithm": algo, "solver_params": jm._solver_params, "n_cols": 10,
                 "inputCol": "features", "idCol": "id"}
        tm = convert.approximate_nearest_neighbors_model_from_jax(attrs, jm._index, item_df)
        _, _, got = tm.kneighbors(query_df)
        _, _, want = jm.kneighbors(query_df)
        np.testing.assert_array_equal(_ids(got), _ids(want))
        np.testing.assert_allclose(_dists(got), _dists(want), rtol=1e-5)


def test_set_algo_params_replaces_the_earlier_keys():
    est = ApproximateNearestNeighbors(algoParams={"nlist": 32, "nprobe": 16})
    assert est.solver_params["n_lists"] == 32 and est.solver_params["n_probes"] == 16
    est.setAlgoParams({"nprobe": 4})
    assert est.solver_params["n_probes"] == 4 and est.solver_params["n_lists"] == 64
    est.setAlgoParams({})
    assert est.solver_params["n_probes"] == 8
    est.setAlgoParams({"itopk_size": 96, "M": 4})
    assert est.solver_params["itopk_size"] == 96 and est.solver_params["pq_m"] == 4
    for calls in ([{"nlist": 32, "nprobe": 16}, {"nprobe": 4}], [{"M": 4, "nlist": 9}, {"refine_ratio": 2}, {}]):
        port, jest = ApproximateNearestNeighbors(), JaxANN()
        for ap in calls:
            port.setAlgoParams(ap)
            jest.setAlgoParams(ap)
        assert port.solver_params == jest.solver_params
    assert est.getMetric() == "euclidean" and est.getAlgorithm() == "ivfflat"
    assert est.setMetric("cosine").getMetric() == "cosine"


def test_metrics_sqeuclidean_and_cosine_against_sklearn():
    from sklearn.neighbors import NearestNeighbors as SkNN

    rng = np.random.default_rng(8)
    items, queries = rng.normal(size=(500, 12)), rng.normal(size=(30, 12))
    item_df, query_df = _frames(items, queries)
    base = ApproximateNearestNeighbors(k=6, algoParams={"nlist": 8, "nprobe": 8}).setInputCol("features").setIdCol("id")
    _, _, eu = base.fit(item_df).kneighbors(query_df)
    _, _, sq = base.copy().setMetric("sqeuclidean").fit(item_df).kneighbors(query_df)
    np.testing.assert_allclose(_dists(sq), _dists(eu) ** 2, rtol=1e-5)
    np.testing.assert_array_equal(_ids(sq), _ids(eu))
    cos = ApproximateNearestNeighbors(k=6, metric="cosine", algoParams={"nlist": 8, "nprobe": 8}) \
        .setInputCol("features").setIdCol("id")
    _, _, kc = cos.fit(item_df).kneighbors(query_df)
    sk_d, sk_i = SkNN(n_neighbors=6, metric="cosine").fit(items).kneighbors(queries)
    np.testing.assert_array_equal(_ids(kc), sk_i)
    np.testing.assert_allclose(_dists(kc), sk_d, atol=1e-5)
    with pytest.raises(ValueError, match="metric"):
        ApproximateNearestNeighbors(metric="manhattan")
    with pytest.raises(ValueError, match="not supported"):
        ApproximateNearestNeighbors(algorithm="hnsw")


def test_zero_row_cosine_convention():
    # a zero row stays zero: cosine distance 0.5 to every unit item, in
    # both packages
    x = np.random.default_rng(9).normal(size=(7, 4)).astype(np.float32)
    x[3] = 0.0
    np.testing.assert_array_equal(unit_rows(x), jax_unit_rows(x))
    assert not unit_rows(x)[3].any()
    items = np.random.default_rng(10).normal(size=(60, 4))
    item_df, query_df = _frames(items, np.zeros((2, 4)))
    kw = dict(k=4, metric="cosine", algoParams={"nlist": 4, "nprobe": 4})
    _, _, got = ApproximateNearestNeighbors(**kw).setInputCol("features").fit(item_df).kneighbors(query_df)
    _, _, want = JaxANN(**kw).setInputCol("features").fit(item_df).kneighbors(query_df)
    np.testing.assert_allclose(_dists(got), 0.5, rtol=1e-6)
    np.testing.assert_allclose(_dists(got), _dists(want), rtol=1e-6)


def test_empty_queries_give_empty_frames():
    rng = np.random.default_rng(11)
    items = rng.normal(size=(60, 8)).astype(np.float32)
    df = pd.DataFrame({"features": list(items)})
    model = ApproximateNearestNeighbors(k=3, algoParams={"nlist": 4}).setInputCol("features").fit(df)
    empty = pd.DataFrame({"features": list(items[:0])})
    _, query_out, knn_df = model.kneighbors(empty)
    assert len(query_out) == 0 and len(knn_df) == 0
    assert list(knn_df.columns) == ["query_id", "indices", "distances"]
    joined = model.approxSimilarityJoin(pd.DataFrame({"features": list(items[:5])}))
    assert list(model.approxSimilarityJoin(empty).columns) == list(joined.columns)


def test_refusals():
    df = pd.DataFrame({"features": list(np.random.default_rng(12).normal(size=(40, 4)))})
    est = ApproximateNearestNeighbors(k=2, algoParams={"nlist": 4}).setInputCol("features")
    with pytest.raises(NotImplementedError, match="saving"):
        est.write()
    with pytest.raises(NotImplementedError, match="saving"):
        est.fit(df).write()
    from spark_rapids_ml_tpu_torch import parallel

    with pytest.MonkeyPatch.context() as mp:  # two cards for a rank of a multi-process context: A10i
        mp.setattr(parallel, "visible_device_count", lambda: 2)
        mp.setattr(parallel, "spmd_context", lambda: types.SimpleNamespace(backend="gloo", is_spmd=True, rank=0, nranks=2))
        with pytest.raises(NotImplementedError, match="A10"):
            ApproximateNearestNeighbors(k=2, num_workers=2).setInputCol("features").fit(df)
    # sparse items are densified, as in the JAX package: the same index as
    # the dense rows' (this case raised for ROADMAP A11b before)
    sparse = pd.DataFrame({"features": [Vectors.sparse(4, [0], [1.0 + i]) for i in range(10)]})
    dense = pd.DataFrame({"features": [np.array([1.0 + i, 0, 0, 0], np.float32) for i in range(10)]})
    ann = ApproximateNearestNeighbors(k=2, algoParams={"nlist": 2}).setInputCol("features")
    q = pd.DataFrame({"features": [np.array([2.2, 0, 0, 0], np.float32)]})
    _, _, got = ann.fit(sparse).kneighbors(q)
    _, _, want = ann.fit(dense).kneighbors(q)
    np.testing.assert_array_equal(np.stack(got["indices"]), np.stack(want["indices"]))
    np.testing.assert_array_equal(np.stack(got["distances"]), np.stack(want["distances"]))
    with pytest.raises(ValueError, match="compression"):
        ApproximateNearestNeighbors(k=2, algorithm="cagra", algoParams={"compression": {}})


def test_fit_without_a_card_or_set_devices_raises(monkeypatch):
    parallel.set_devices(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = pd.DataFrame({"features": list(np.random.default_rng(13).normal(size=(40, 4)))})
    for algo in ("ivfflat", "ivfpq", "cagra"):
        with pytest.raises(RuntimeError, match=r'set_devices\("cpu"\)'):
            ApproximateNearestNeighbors(k=2, algorithm=algo, algoParams={"nlist": 4, "M": 2}) \
                .setInputCol("features").fit(df)


def test_serving_answers_an_ann_model_by_exact_knn_as_jax_does():
    # neither package serves through the index: the ANN model inherits the
    # exact model's serving hooks, so the registry answers exact kNN
    from spark_rapids_ml_tpu.models.knn import ApproximateNearestNeighborsModel as JaxANNModel
    from spark_rapids_ml_tpu.models.knn import NearestNeighborsModel as JaxNNModel
    from spark_rapids_ml_tpu.serving import ModelRegistry as JaxModelRegistry
    from spark_rapids_ml_tpu.serving import ScoringEngine as JaxScoringEngine
    from spark_rapids_ml_tpu_torch import (ApproximateNearestNeighborsModel, ModelRegistry, NearestNeighborsModel,
                                           ScoringEngine)

    assert JaxANNModel._serve_program is JaxNNModel._serve_program
    assert ApproximateNearestNeighborsModel._serve_program is NearestNeighborsModel._serve_program
    rng = np.random.default_rng(14)
    items, queries = rng.normal(size=(200, 6)), rng.normal(size=(9, 6))
    item_df, query_df = _frames(items, queries)
    answers = []
    for est, reg, eng in ((ApproximateNearestNeighbors, ModelRegistry, ScoringEngine),
                          (JaxANN, JaxModelRegistry, JaxScoringEngine)):
        model = est(k=4, algoParams={"nlist": 8, "nprobe": 1}).setInputCol("features").setIdCol("id").fit(item_df)
        registry = reg()
        registry.load("ann", model)
        with eng(registry) as engine:
            answers.append(engine.score("ann", queries))
    _, _, exact = NearestNeighbors(k=4).setInputCol("features").setIdCol("id").fit(item_df).kneighbors(query_df)
    for d, i in answers:
        np.testing.assert_array_equal(np.asarray(i), _ids(exact) + 0)
        np.testing.assert_allclose(np.asarray(d), _dists(exact), rtol=1e-5)


# ------------------------------------------------- C5: odd-depth row norms ----


@pytest.mark.parametrize("d", [375, 77, 3001, 3000])
def test_repeated_rows_get_the_same_norm_and_the_first_copy_at_any_depth(d):
    # the k-means|| candidates repeat a row; the argmin must give its rows to
    # the first copy, so every copy needs the same norm, wherever it lies
    from spark_rapids_ml_tpu_torch.ops import distance as tdist

    rng = np.random.default_rng(d)
    c = rng.standard_normal((256, d)).astype(np.float32)
    c[224:255] = c[223]
    x = (c[223] + 0.01 * rng.standard_normal((300, d))).astype(np.float32)
    assert len(set(tdist.row_sq(_t(c))[223:255].tolist())) == 1
    best = tdist.argmin_assign(_t(x), _t(c)).numpy()
    assert set(best) == {223}
    want = np.asarray(jknn._assign_rows(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_array_equal(best, want)


# ------------------------------------------------------------- on the card ----


def _card_and_cpu(fn):
    out = {}
    for device in ("cpu", "cuda"):
        parallel.set_devices(device)
        out[device] = fn()
    return out


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
@pytest.mark.parametrize("algo,ap", [
    ("ivfflat", {"nlist": 64, "nprobe": 8}),
    ("ivfpq", {"nlist": 16, "nprobe": 4, "M": 4, "n_bits": 6}),
])
def test_ann_on_the_card_equals_the_cpu_on_integer_rows(algo, ap):
    # values in [-4, 4] are exact in bf16 and every sum of theirs in
    # float32: the card's index and neighbours equal the CPU's
    x = _int_rows(4000, 16, 21)
    item_df, query_df = _frames(x, x[:50])
    kw = dict(k=8, algorithm=algo, algoParams=ap)

    def run():
        m = ApproximateNearestNeighbors(**kw).setInputCol("features").setIdCol("id").fit(item_df)
        _, _, knn_df = m.kneighbors(query_df)
        return {key: v.cpu().numpy() for key, v in m._index.items()}, _ids(knn_df), _dists(knn_df)

    out = _card_and_cpu(run)
    for key in out["cpu"][0]:
        np.testing.assert_array_equal(out["cuda"][0][key], out["cpu"][0][key])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
@pytest.mark.parametrize("d", [375, 3001])
def test_row_norms_of_repeated_rows_on_the_card(d):
    # fault C5: torch.sum over rows of an odd depth reads each row's
    # unaligned head apart, so equal rows could differ in the last bit and a
    # later copy win a tie; row_sq pads to a multiple of 4 first
    from spark_rapids_ml_tpu_torch.ops import distance as tdist

    c = torch.randn(256, d, device="cuda", generator=torch.Generator("cuda").manual_seed(d))
    c[224:255] = c[223]
    assert len(set(tdist.row_sq(c)[223:255].tolist())) == 1
    x = c[223] + 0.01 * torch.randn(4096, d, device="cuda")
    for fast in (False, True):
        assert set(tdist.argmin_assign(x, c, fast=fast).tolist()) == {223}


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
@pytest.mark.parametrize("fast", [False, True])
def test_b1_b2_at_the_pq_subspace_depth_on_the_card(fast):
    # d = 375, k = 256: the scalar path of the kernels (d % 4 != 0) against
    # their plain versions on the same card
    from spark_rapids_ml_tpu_torch.ops import distance as tdist

    g = torch.Generator().manual_seed(3)
    x = torch.randn(8192, 375, generator=g).cuda()
    c = x[:256].clone()
    w = torch.ones(8192, device="cuda")
    mind, a = tdist.assign_argmin(x, c, fast=fast)
    pm, pa = tdist.assign_argmin_plain(x, c, tdist._c_sq(c), fast)
    assert (a == pa).float().mean() > 0.999
    sums, counts = tdist.accumulate(x, w, pa, 256, fast=fast)
    ps, pc = tdist.accumulate_plain(x, w, pa, 256, fast)
    torch.testing.assert_close(counts, pc)
    torch.testing.assert_close(sums, ps, rtol=1e-5, atol=1e-3)
