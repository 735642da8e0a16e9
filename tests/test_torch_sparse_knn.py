#
# Sparse exact kNN of the PyTorch port (ops/knn.py `exact_knn_sparse`,
# NearestNeighbors over a CSR item set) and the densify of CSR input
# everywhere else (kneighbors' queries, ApproximateNearestNeighbors,
# DBSCAN, UMAP, the serving engine) against the JAX package and against the
# same calls on the densified rows, after tests/test_knn.py:168-230. CPU
# throughout; data from numpy seeds.
#
# Tolerances: neighbour ids exactly, on data built without near-ties (a
# distinct last column makes every distance unique, as tests/test_knn.py
# does); euclidean distances within rtol 1e-6 in float64 (the port ranks
# by ||x||² − 2q·x and adds ||q||² last, JAX sums the full d², so a
# self-match differs by the square root of a rounding residue); every
# densifying path equal to its dense call bit for bit.
#
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_tpu.linalg import Vectors as JaxVectors
from spark_rapids_ml_tpu.models.knn import NearestNeighbors as JaxNearestNeighbors
from spark_rapids_ml_tpu.ops.knn import exact_knn_sparse as jax_exact_knn_sparse
from spark_rapids_ml_tpu_torch import (
    DBSCAN,
    UMAP,
    ApproximateNearestNeighbors,
    LinearRegression,
    ModelRegistry,
    NearestNeighbors,
    ScoringEngine,
    Vectors,
    set_devices,
)
from spark_rapids_ml_tpu_torch.ops import _kernels
from spark_rapids_ml_tpu_torch.ops import distance as tdist
from spark_rapids_ml_tpu_torch.ops.knn import exact_knn_sparse

DIST_RTOL = 1e-6


@pytest.fixture(autouse=True)
def port_on_cpu():
    set_devices("cpu")
    yield
    set_devices(None)


def _items(n=400, d=24, density=0.2, seed=5):
    """CSR items whose distances are all distinct: a random sparse block and
    a last column i·1e-3 (tests/test_knn.py's construction)."""
    x = sp.random(n, d, density=density, random_state=np.random.RandomState(seed), format="csr")
    return sp.hstack([x[:, :-1], sp.csr_matrix(np.arange(n)[:, None] * 1e-3)]).tocsr()


def _ids(df):
    return np.stack(df["indices"].to_numpy())


def _dists(df):
    return np.stack(df["distances"].to_numpy())


def test_sparse_knn_matches_dense_and_jax():
    # tests/test_knn.py:168: the CSR item set through the public API equals
    # the dense item set's answer and JAX's
    x = _items()
    xd = np.asarray(x.todense())
    rows = [Vectors.sparse(24, x[i].indices.tolist(), x[i].data.tolist()) for i in range(400)]
    jrows = [JaxVectors.sparse(24, x[i].indices.tolist(), x[i].data.tolist()) for i in range(400)]
    q = pd.DataFrame({"features": list(xd[:37])})
    m_sp = NearestNeighbors(k=5, float32_inputs=False).setInputCol("features").fit(pd.DataFrame({"features": rows}))
    m_dn = NearestNeighbors(k=5, float32_inputs=False).setInputCol("features").fit(pd.DataFrame({"features": list(xd)}))
    assert m_sp._item_extracted.is_sparse
    _, _, knn_sp = m_sp.kneighbors(q)
    _, _, knn_dn = m_dn.kneighbors(q)
    np.testing.assert_array_equal(_ids(knn_sp), _ids(knn_dn))
    np.testing.assert_allclose(_dists(knn_sp), _dists(knn_dn), rtol=DIST_RTOL, atol=1e-9)
    jm = JaxNearestNeighbors(k=5, float32_inputs=False, num_workers=1).setInputCol("features")
    _, _, knn_j = jm.fit(pd.DataFrame({"features": jrows})).kneighbors(q)
    np.testing.assert_array_equal(_ids(knn_sp), _ids(knn_j))
    # a query's distance to itself is the square root of a float64 rounding
    # residue of the full d² in JAX (~2e-8), 0 in the port
    np.testing.assert_allclose(_dists(knn_sp), _dists(knn_j), rtol=DIST_RTOL, atol=1e-7)


@pytest.mark.parametrize("batch_items,batch_queries", [(64, 16), (97, 37), (400, 5), (1000, 64)])
def test_tiling_invariance_and_jax(batch_items, batch_queries):
    # small item and query tiles (the last of each clamped back and its
    # overlap masked) give the one-tile answer and JAX's
    x = _items().astype(np.float64)
    q = np.asarray(x[:37].todense()) + 0.01
    d_ref, i_ref = exact_knn_sparse(x, torch.from_numpy(q), k=5, batch_items=400)
    d_t, i_t = exact_knn_sparse(x, torch.from_numpy(q), k=5, batch_items=batch_items, batch_queries=batch_queries)
    np.testing.assert_array_equal(i_t, i_ref)
    np.testing.assert_allclose(d_t, d_ref, rtol=1e-12)
    d_j, i_j = jax_exact_knn_sparse(x, q, 5, batch_items=batch_items)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=DIST_RTOL, atol=1e-9)


def test_ties_go_to_the_lower_item_index_like_jax():
    # duplicated rows across tiles: the lower index first
    base = sp.random(30, 8, density=0.4, random_state=np.random.RandomState(3), format="csr")
    x = sp.vstack([base, base, base]).tocsr()  # rows i, i+30, i+60 equal
    q = np.asarray(base[:6].todense())
    d, i = exact_knn_sparse(x, torch.from_numpy(q), k=3, batch_items=16)
    dj, ij = jax_exact_knn_sparse(x.astype(np.float64), q, 3, batch_items=16)
    np.testing.assert_array_equal(i, np.asarray(ij))
    np.testing.assert_array_equal(i[:, 0], np.arange(6))
    np.testing.assert_array_equal(i[:, 1], np.arange(6) + 30)


def test_fewer_items_than_k_pads_with_minus_one_and_inf():
    x = _items(n=4, d=6, density=0.5)
    q = np.asarray(x.todense())[:2]
    d, i = exact_knn_sparse(x, torch.from_numpy(q), k=7)
    dj, ij = jax_exact_knn_sparse(x, q, 7)
    np.testing.assert_array_equal(i, np.asarray(ij))
    assert (i[:, 4:] == -1).all() and np.isinf(d[:, 4:]).all()
    np.testing.assert_allclose(d[:, :4], np.asarray(dj)[:, :4], rtol=DIST_RTOL, atol=1e-9)


def test_empty_query_frames():
    # tests/test_knn.py:211
    x = sp.csr_matrix(np.random.default_rng(0).normal(size=(100, 8)).astype(np.float32))
    d, i = exact_knn_sparse(x, torch.zeros((0, 8)), k=3)
    assert d.shape == (0, 3) and i.shape == (0, 3)
    model = NearestNeighbors(k=3).setInputCol("features").fit({"features": x})
    _, query_out, knn = model.kneighbors({"features": np.zeros((0, 8), np.float32)})
    assert len(knn) == 0 and len(query_out) == 0


def test_every_item_tile_goes_through_the_d2_block_kernel(monkeypatch):
    # the kernel route as the card takes it: d2_block's wrapper reached for
    # every block of every tile (the plain version stands in on the CPU)
    calls = []

    def fake(q, xt, xt_sq, fast=False):
        calls.append(tuple(xt.shape))
        return tdist.d2_block_plain(q, xt, xt_sq, fast)

    monkeypatch.setattr(tdist, "_on_kernel_device", lambda *a, **k: True)
    monkeypatch.setattr(_kernels, "d2_block", fake)
    monkeypatch.setattr(tdist, "_DEFAULT_K_TILE", 32)
    x = _items()
    q = torch.from_numpy(np.asarray(x[:20].todense()).astype(np.float32))
    d, i = exact_knn_sparse(x.astype(np.float32), q, k=5, batch_items=96)
    # ceil(400 / 96) = 5 item tiles, each 3 blocks of 32 items
    assert len(calls) == 5 * 3 and set(calls) == {(32, 24)}
    monkeypatch.setattr(tdist, "_on_kernel_device", lambda *a, **k: False)
    d_p, i_p = exact_knn_sparse(x.astype(np.float32), q, k=5, batch_items=96)
    np.testing.assert_array_equal(i, i_p)
    np.testing.assert_array_equal(d, d_p)


def test_csr_queries_and_the_join_equal_dense_ones():
    x = _items()
    xd = np.asarray(x.todense())
    model = NearestNeighbors(k=4, float32_inputs=False).setInputCol("features").fit({"features": xd})
    _, _, a = model.kneighbors({"features": x[:25]})
    _, _, b = model.kneighbors({"features": xd[:25]})
    np.testing.assert_array_equal(_ids(a), _ids(b))
    np.testing.assert_array_equal(_dists(a), _dists(b))
    sp_model = NearestNeighbors(k=4, float32_inputs=False).setInputCol("features").fit({"features": x})
    ja = sp_model.exactNearestNeighborsJoin({"features": xd[:25]})
    jb = model.exactNearestNeighborsJoin({"features": xd[:25]})
    np.testing.assert_array_equal(ja["item_unique_id"].to_numpy(), jb["item_unique_id"].to_numpy())
    np.testing.assert_allclose(ja["distCol"].to_numpy(), jb["distCol"].to_numpy(), rtol=DIST_RTOL)


def test_ann_on_csr_items_equals_dense():
    x = _items(n=300, d=16, density=0.3)
    xd = np.asarray(x.todense()).astype(np.float32)
    q = {"features": xd[:10]}
    for algo, params in (("ivfflat", {"nlist": 4, "nprobe": 4}), ("ivfpq", {"nlist": 4, "nprobe": 4, "M": 4})):
        ann = ApproximateNearestNeighbors(k=3, algorithm=algo, algoParams=params).setInputCol("features")
        _, _, got = ann.fit({"features": x}).kneighbors(q)
        _, _, want = ann.fit({"features": xd}).kneighbors(q)
        np.testing.assert_array_equal(_ids(got), _ids(want))
        np.testing.assert_array_equal(_dists(got), _dists(want))


def test_dbscan_and_umap_on_csr_equal_dense():
    rng = np.random.default_rng(4)
    centers = rng.normal(scale=5.0, size=(3, 8))
    xd = (centers[rng.integers(0, 3, 150)] + rng.normal(scale=0.3, size=(150, 8))).astype(np.float32)
    xd[np.abs(xd) < 0.5] = 0.0
    x = sp.csr_matrix(xd)
    db = DBSCAN(eps=1.5, min_samples=4).setFeaturesCol("features")
    got = db.fit({"features": x}).transform({"features": x})
    want = db.fit({"features": xd}).transform({"features": xd})
    np.testing.assert_array_equal(got["prediction"].to_numpy(), want["prediction"].to_numpy())
    um = UMAP(n_epochs=5, random_state=1, n_neighbors=8).setFeaturesCol("features")
    m_sp, m_dn = um.fit({"features": x}), um.fit({"features": xd})
    np.testing.assert_array_equal(m_sp.embedding_, m_dn.embedding_)
    np.testing.assert_array_equal(np.stack(m_sp.transform({"features": x[:20]})[m_sp.getOutputCol()]),
                                  np.stack(m_dn.transform({"features": xd[:20]})[m_dn.getOutputCol()]))


def test_serving_a_csr_request_equals_the_dense_request():
    rng = np.random.default_rng(6)
    xd = rng.normal(size=(200, 6))
    xd[np.abs(xd) < 0.7] = 0.0
    model = LinearRegression(float32_inputs=False).fit({"features": xd, "label": xd @ np.arange(6.0)})
    reg = ModelRegistry()
    reg.load("lin", model, prewarm=False)
    with ScoringEngine(reg) as eng:
        got = eng.score("lin", sp.csr_matrix(xd[:17]))
        want = eng.score("lin", xd[:17])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
