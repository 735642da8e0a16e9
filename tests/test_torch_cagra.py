#
# The PyTorch port's CAGRA (spark_rapids_ml_tpu_torch/ops/cagra.py) against
# the JAX package's (spark_rapids_ml_tpu/ops/cagra.py) on the CPU: the
# same numpy inputs, made from a seed, through both. The merge, the reverse
# edges, one seeding repetition and one descent round from the same state
# are equal; a search over a graph JAX built, carried across, finds the
# same ids; the estimator's recall, early exit and validation follow
# tests/test_knn.py.
#
# JAX's `jax.lax.approx_min_k` is exact on the CPU, but breaks ties in an
# order of its own (not the lower position first); the port's smallest-k
# takes the lower position first. The comparisons run on data without ties
# among the entries that are kept, and one test pins where the two orders
# part.
#
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu.models.knn import ApproximateNearestNeighbors as JaxANN
from spark_rapids_ml_tpu.ops import cagra as jcg
from spark_rapids_ml_tpu_torch import ApproximateNearestNeighbors, parallel
from spark_rapids_ml_tpu_torch.ops import cagra as tcg
from spark_rapids_ml_tpu_torch.ops import distance as tdist
from spark_rapids_ml_tpu_torch.ops import prng


@pytest.fixture(autouse=True)
def port_on_cpu():
    parallel.set_devices("cpu")
    yield
    parallel.set_devices(None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _item_query(rng, n_items, n_queries, d):
    items = rng.normal(size=(n_items, d))
    queries = rng.normal(size=(n_queries, d))
    item_df = pd.DataFrame({"features": list(items), "id": np.arange(n_items, dtype=np.int64)})
    query_df = pd.DataFrame({"features": list(queries), "id": np.arange(n_queries, dtype=np.int64) + 1000})
    return item_df, query_df, items, queries


def _recall(got, want):
    k = want.shape[1]
    return np.mean([len(set(a) & set(b)) / k for a, b in zip(got, want)])


def _sk(items, queries, k):
    from sklearn.neighbors import NearestNeighbors as SkNN

    return SkNN(n_neighbors=k).fit(items).kneighbors(queries)


# ------------------------------------------------------------ the pieces ----


@pytest.mark.parametrize("keep", [5, 12])
def test_merge_dedup_topk_matches_jax(keep):
    rng = np.random.default_rng(keep)
    ids = rng.integers(0, 30, size=(40, 24)).astype(np.int32)
    d2 = rng.uniform(0, 10, size=(40, 24)).astype(np.float32)
    d2[:, -3:] = np.inf
    flags = rng.integers(0, 2, size=(40, 24)).astype(bool)
    wi, wd, we = jcg._merge_dedup_topk(jnp.asarray(ids), jnp.asarray(d2), keep, extra=jnp.asarray(flags))
    gi, gd, ge = tcg._merge_dedup_topk(_t(ids), _t(d2), keep, extra=_t(flags))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))


@pytest.mark.parametrize("r_max", [4, 64])
def test_reverse_edges_match_jax(r_max):
    ids = np.random.default_rng(r_max).integers(0, 300, size=(300, 20)).astype(np.int32)
    want = np.asarray(jcg._reverse_edges(jnp.asarray(ids), r_max=r_max))
    np.testing.assert_array_equal(tcg._reverse_edges(_t(ids), r_max=r_max).numpy(), want)


def test_cluster_seed_rep_matches_jax():
    x = np.random.default_rng(1).normal(size=(3000, 8)).astype(np.float32)
    xj = jnp.asarray(x)
    wi, wd = jcg._cluster_seed_rep(xj, jnp.sum(xj * xj, axis=1), 3000, 6, 16, 5)
    gi, gd = tcg._cluster_seed_rep(_t(x), tdist.row_sq(_t(x)), 3000, 6, 16, 5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)


def _seeded_state(x, k_int=16):
    """A graph from three of JAX's seeding repetitions: every list full of
    distinct finite distances."""
    xj = jnp.asarray(x)
    xsq = jnp.sum(xj * xj, axis=1)
    reps = [jcg._cluster_seed_rep(xj, xsq, len(x), len(x) // 512, k_int, s) for s in range(3)]
    ids, d2 = jcg._merge_dedup_topk(jnp.concatenate([r[0] for r in reps], 1),
                                    jnp.concatenate([r[1] for r in reps], 1), k_int)
    return np.asarray(ids), np.asarray(d2)


def test_descent_round_matches_jax():
    x = np.random.default_rng(2).normal(size=(3000, 8)).astype(np.float32)
    ids, d2 = _seeded_state(x)
    assert np.isfinite(d2).all()
    rev = np.asarray(jcg._reverse_edges(jnp.asarray(ids), r_max=8))
    kw = dict(tile=448, s_top=2, s_rnd=1, s_rev=1, c_rnd=8, fast=False)
    xj = jnp.asarray(x)
    wi, wd, wn = jcg._descent_round(xj, jnp.sum(xj * xj, axis=1), jnp.asarray(ids), jnp.asarray(d2),
                                    jnp.asarray(rev), jax.random.PRNGKey(9), **kw)
    gi, gd, gn = tcg._descent_round(_t(x), tdist.row_sq(_t(x)), _t(ids).clone(), _t(d2).clone(), _t(rev),
                                    prng.prng_key(9), **kw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)
    assert int(gn) == int(wn) > 0


def test_approx_min_k_ties_jax_cpu_order_against_the_port():
    # on the CPU JAX's approx_min_k is exact: its values equal the port's
    # smallest-k, and so do its positions where no kept value ties; among
    # tied values it takes positions in an order of its own
    rng = np.random.default_rng(0)
    free = rng.permutation(200).astype(np.float32)[None, :].repeat(3, 0)
    tied = rng.integers(0, 4, size=(3, 200)).astype(np.float32)
    for d2, same_positions in ((free, True), (tied, False)):
        wv, wp = jax.lax.approx_min_k(jnp.asarray(d2), 40)
        gv, gp = tdist._topk_lex(_t(d2), 40)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        assert (gp.numpy() == np.asarray(wp)).all() == same_positions
        # the port: the lower position first among equal values
        for row_v, row_p in zip(gv.numpy(), gp.numpy()):
            for v in np.unique(row_v):
                assert (np.diff(row_p[row_v == v]) > 0).all()


def test_cagra_search_on_a_jax_graph_equals_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4000, 12)).astype(np.float32)
    q = rng.normal(size=(50, 12)).astype(np.float32)
    index = jcg.build_cagra(x, graph_degree=32, intermediate_graph_degree=48, build_algo="nn_descent",
                            nn_descent_niter=4, seed=0)
    kw = dict(k=8, itopk_size=64, search_width=2, num_random_samplings=2, batch_queries=32)
    wi, wd = jcg.cagra_search(q, index, **kw)
    gi, gd = tcg.cagra_search(_t(q), {"x": _t(index["x"]), "graph": _t(index["graph"])}, **kw)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)


def test_build_cagra_graph_equals_jax():
    x = np.random.default_rng(4).normal(size=(3000, 8)).astype(np.float32)
    kw = dict(graph_degree=16, intermediate_graph_degree=24, cluster_reps=3, fast_score=False, seed=0)
    want = np.asarray(jcg.build_cagra(x, **kw)["graph"])
    got = tcg.build_cagra(_t(x), **kw)["graph"].numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- the estimator ----


def test_cagra_recall_and_estimator():
    rng = np.random.default_rng(5)
    item_df, query_df, items, queries = _item_query(rng, 800, 40, 16)
    ann = ApproximateNearestNeighbors(
        k=8, algorithm="cagra",
        algoParams={"build_algo": "nn_descent", "graph_degree": 32, "intermediate_graph_degree": 48,
                    "itopk_size": 64},
    ).setInputCol("features").setIdCol("id")
    _, _, knn_df = ann.fit(item_df).kneighbors(query_df)
    ours = np.stack(knn_df["indices"].to_list())
    dist = np.stack(knn_df["distances"].to_list())
    sk_d, sk_i = _sk(items, queries, 8)
    assert _recall(ours, sk_i) >= 0.85
    assert (np.diff(dist, axis=1) >= -1e-6).all()
    assert np.all(dist[:, 0] >= sk_d[:, 0] - 1e-5)


def test_cagra_ivf_pq_seeded_build_recall():
    rng = np.random.default_rng(6)
    item_df, query_df, items, queries = _item_query(rng, 600, 25, 8)
    _, _, knn_df = ApproximateNearestNeighbors(k=5, algorithm="cagra").setInputCol("features") \
        .setIdCol("id").fit(item_df).kneighbors(query_df)
    assert _recall(np.stack(knn_df["indices"].to_list()), _sk(items, queries, 5)[1]) >= 0.85


def test_cagra_estimator_equals_jax():
    rng = np.random.default_rng(7)
    item_df, query_df, items, queries = _item_query(rng, 2500, 30, 10)
    kw = dict(k=6, algorithm="cagra", metric="sqeuclidean",
              algoParams={"graph_degree": 24, "intermediate_graph_degree": 32, "cluster_reps": 3,
                          "fast_score": False})
    _, _, got = ApproximateNearestNeighbors(**kw).setInputCol("features").setIdCol("id").fit(item_df) \
        .kneighbors(query_df)
    _, _, want = JaxANN(**kw).setInputCol("features").setIdCol("id").fit(item_df).kneighbors(query_df)
    np.testing.assert_array_equal(np.stack(got["indices"].to_list()), np.stack(want["indices"].to_list()))
    np.testing.assert_allclose(np.stack(got["distances"].to_list()), np.stack(want["distances"].to_list()),
                               rtol=1e-5)


def test_cagra_pads_when_k_exceeds_the_items():
    rng = np.random.default_rng(8)
    item_df, query_df, *_ = _item_query(rng, 20, 3, 4)
    _, _, knn_df = ApproximateNearestNeighbors(k=25, algorithm="cagra").setInputCol("features") \
        .setIdCol("id").fit(item_df).kneighbors(query_df)
    ids = np.stack(knn_df["indices"].to_list())
    dists = np.stack(knn_df["distances"].to_list())
    assert (ids[:, 20:] == -1).all() and np.isinf(dists[:, 20:]).all()
    assert np.isfinite(dists[:, :20]).all()


def test_cagra_early_exit_triggers(monkeypatch):
    calls = []
    orig = tcg._descent_round

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(int(out[2]))
        return out

    monkeypatch.setattr(tcg, "_descent_round", spy)
    x = _t(np.random.default_rng(9).normal(size=(600, 8)).astype(np.float32))
    idx = tcg.build_cagra(x, build_algo="nn_descent", termination_threshold=1.0, seed=0)
    assert len(calls) < 14, calls
    assert idx["graph"].shape[0] == 600
    calls.clear()
    tcg.build_cagra(x, build_algo="nn_descent", termination_threshold=0.0, seed=0, nn_descent_niter=5)
    assert len(calls) == 5


def test_cagra_param_validation():
    rng = np.random.default_rng(10)
    item_df, *_ = _item_query(rng, 100, 4, 4)
    with pytest.raises(ValueError, match="itopk_size"):
        ApproximateNearestNeighbors(k=40, algorithm="cagra", algoParams={"itopk_size": 1}) \
            .setInputCol("features").setIdCol("id").fit(item_df)
    # itopk 33 -> internal 64 >= k = 40: accepted
    ApproximateNearestNeighbors(k=40, algorithm="cagra", algoParams={"itopk_size": 33}) \
        .setInputCol("features").setIdCol("id").fit(item_df)
    with pytest.raises(ValueError, match="compression"):
        ApproximateNearestNeighbors(k=4, algorithm="cagra", algoParams={"compression": {}})
    with pytest.raises(ValueError, match="not supported"):
        ApproximateNearestNeighbors(k=4, algorithm="hnsw")
    with pytest.raises(ValueError, match="build_algo"):
        ApproximateNearestNeighbors(k=4, algorithm="cagra", algoParams={"build_algo": "bogus"}) \
            .setInputCol("features").setIdCol("id").fit(item_df)
    with pytest.raises(ValueError, match="itopk_size"):
        tcg.cagra_search(torch.zeros((2, 4)), {"x": torch.zeros((50, 4)), "graph": torch.zeros((50, 8), dtype=torch.int32)},
                         k=70, itopk_size=64)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
def test_cagra_on_the_card_equals_the_cpu_on_integer_rows():
    # values in [-4, 4]: bf16 and float32 sums exact, ties broken the same
    # way on both devices
    x = np.random.default_rng(11).integers(-4, 5, size=(3000, 16)).astype(np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        parallel.set_devices(device)
        xd = _t(x).to(device)
        index = tcg.build_cagra(xd, graph_degree=16, intermediate_graph_degree=32, cluster_reps=3, seed=0)
        ids, d2 = tcg.cagra_search(xd[:40], index, k=8, itopk_size=64)
        out[device] = (index["graph"].cpu().numpy(), ids, d2)
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(a, b)
