#
# Exact kNN in the PyTorch port (spark_rapids_ml_tpu_torch/ops/knn.py,
# models/knn.py) against the JAX package's (spark_rapids_ml_tpu/ops/knn.py,
# models/knn.py) on the same inputs, made with numpy from a seed.
#
# The port runs on the CPU (its plain d2-block version); the JAX estimator
# runs with num_workers=1, its one-device path, as the port has no other.
# Gaussian data has no near-ties at these sizes, so indices must agree
# exactly; distances to rtol 1e-5 in float32 and 1e-9 in float64. Queries
# are drawn apart from the items: a distance near 0 comes out of
# ||x||^2 - 2 q.x + ||q||^2 with an error of a few ulps of ||q||^2, which
# no relative tolerance on the distance holds.
#
import numpy as np
import pandas as pd
import types
import pytest
import torch

import jax

from spark_rapids_ml_tpu.models.knn import NearestNeighbors as JaxNearestNeighbors
from spark_rapids_ml_tpu.ops import distance as jdist
from spark_rapids_ml_tpu.ops.knn import exact_knn as jax_exact_knn
from spark_rapids_ml_tpu.parallel import get_mesh, make_global_rows
from spark_rapids_ml_tpu_torch import NearestNeighbors, Vectors, set_devices
from spark_rapids_ml_tpu_torch.core import config
from spark_rapids_ml_tpu_torch.models.knn import NearestNeighborsModel
from spark_rapids_ml_tpu_torch.ops import distance as tdist
from spark_rapids_ml_tpu_torch.ops.knn import exact_knn


@pytest.fixture(autouse=True)
def port_on_cpu():
    set_devices("cpu")
    yield
    set_devices(None)


@pytest.fixture
def interpret_mode():
    """The JAX package's real d2-block kernel through the Pallas interpreter."""
    saved = jdist._MODE
    jdist._MODE = "interpret"
    yield
    jdist._MODE = saved


def _rows(n, d, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(dtype)


def _frame(x, ids=None):
    cols = {"features": list(x)}
    if ids is not None:
        cols = {"id": ids, **cols}
    return pd.DataFrame(cols)


def _stack(knn_df, col):
    return np.stack(knn_df[col].to_numpy()) if len(knn_df) else np.zeros((0, 0))


# ------------------------------------------------------------- exact_knn ----


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5), (np.float64, 1e-9)])
@pytest.mark.parametrize(
    "nq,batch_queries,k",
    [
        (21, 8, 5),    # 3 query tiles, the last clamped back
        (16, 8, 3),    # tiles that divide evenly
        (5, None, 7),  # the config default tile, larger than nq
        (9, 4, 40),    # k > n items: +inf columns
    ],
)
def test_exact_knn_matches_jax(nq, batch_queries, k, dtype, rtol):
    items = _rows(30, 6, seed=nq, dtype=dtype)
    queries = _rows(nq, 6, seed=nq + 1, dtype=dtype)
    mesh = get_mesh(1)
    X, w, _ = make_global_rows(mesh, items)
    jd, ji = jax_exact_knn(X, w > 0, jax.device_put(queries), mesh=mesh, k=k,
                           batch_queries=batch_queries)
    td, ti = exact_knn(torch.from_numpy(items), None, torch.from_numpy(queries), k=k,
                       batch_queries=batch_queries)
    assert td.shape == ti.shape == (nq, k)
    assert td.dtype == np.asarray(jd).dtype and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=rtol, atol=rtol)


def test_exact_knn_empty_query_block():
    items = torch.from_numpy(_rows(10, 4, seed=1))
    d, i = exact_knn(items, None, items[:0], k=3)
    assert d.shape == (0, 3) and i.shape == (0, 3)
    assert d.dtype == np.float32 and i.dtype == np.int32


def test_exact_knn_query_tile_follows_config():
    items = torch.from_numpy(_rows(40, 5, seed=2, dtype=np.float64))
    queries = torch.from_numpy(_rows(11, 5, seed=3, dtype=np.float64))
    ref = exact_knn(items, None, queries, k=4, batch_queries=11)
    saved = config["distance_tile_rows"]
    config["distance_tile_rows"] = 3
    try:
        assert tdist.tile_rows() == 3
        got = exact_knn(items, None, queries, k=4)
    finally:
        config["distance_tile_rows"] = saved
    np.testing.assert_array_equal(got[1], ref[1])
    # products of other row counts may round differently in the last bit
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-12)


def test_exact_knn_ties_across_item_blocks_match_jax_kernel(interpret_mode, monkeypatch):
    # integer rows repeated across item blocks of 4: exact distances, and
    # the lower index first, on the JAX Pallas kernel and the port alike
    rng = np.random.default_rng(7)
    base = rng.integers(-3, 4, size=(7, 5)).astype(np.float64)
    items = np.concatenate([base, base, base[:3]])
    queries = rng.integers(-3, 4, size=(6, 5)).astype(np.float64)
    jd2, jidx = jdist.topk_tile(jax.device_put(queries), jax.device_put(items), None, 8,
                                k_tile=4, block_rows=8)
    monkeypatch.setattr(tdist, "_DEFAULT_K_TILE", 4)
    td, ti = exact_knn(torch.from_numpy(items), None, torch.from_numpy(queries), k=8,
                       batch_queries=4)
    np.testing.assert_array_equal(ti, np.asarray(jidx))
    q_sq = np.sum(queries * queries, 1)[:, None]
    np.testing.assert_array_equal(td, np.sqrt(np.maximum(np.asarray(jd2) + q_sq, 0.0)))


# ------------------------------------------------ the estimator, end to end ----


@pytest.mark.parametrize("float32_inputs,rtol", [(True, 1e-5), (False, 1e-9)])
@pytest.mark.parametrize("with_ids", [True, False])
def test_kneighbors_matches_jax(float32_inputs, rtol, with_ids):
    x = _rows(120, 8, seed=11, dtype=np.float64)
    ids = np.arange(1000, 1120)[::-1].copy() if with_ids else None
    items, queries = _frame(x, ids), _frame(_rows(37, 8, seed=12, dtype=np.float64), None if ids is None else ids[:37])
    outs = []
    for cls, extra in ((NearestNeighbors, {}), (JaxNearestNeighbors, {"num_workers": 1})):
        est = cls(k=6, float32_inputs=float32_inputs, **extra).setInputCol("features")
        if with_ids:
            est = est.setIdCol("id")
        outs.append(est.fit(items).kneighbors(queries))
    (ti, tq, tk), (ji, jq, jk) = outs
    assert list(tk.columns) == list(jk.columns) == ["query_id", "indices", "distances"]
    np.testing.assert_array_equal(tk["query_id"].to_numpy(), jk["query_id"].to_numpy())
    np.testing.assert_array_equal(_stack(tk, "indices"), _stack(jk, "indices"))
    assert _stack(tk, "distances").dtype == np.float64
    np.testing.assert_allclose(_stack(tk, "distances"), _stack(jk, "distances"), rtol=rtol, atol=rtol)
    assert list(ti.columns) == list(ji.columns) and list(tq.columns) == list(jq.columns)
    id_col = "id" if with_ids else "unique_id"
    np.testing.assert_array_equal(ti[id_col].to_numpy(), ji[id_col].to_numpy())
    np.testing.assert_array_equal(tq[id_col].to_numpy(), jq[id_col].to_numpy())


@pytest.mark.parametrize("float32_inputs,rtol", [(True, 1e-5), (False, 1e-9)])
def test_kneighbors_nan_query_row_matches_jax(float32_inputs, rtol):
    # one all-NaN query among finite ones, the items in one block: its
    # neighbors are the first k items at NaN distance, as in the reference
    rng = np.random.default_rng(1)
    x = rng.normal(size=(120, 8))
    q = rng.normal(size=(5, 8))
    q[1] = np.nan
    outs = []
    for cls, extra in ((NearestNeighbors, {}), (JaxNearestNeighbors, {"num_workers": 1})):
        est = cls(k=6, float32_inputs=float32_inputs, **extra).setInputCol("features")
        outs.append(est.fit(_frame(x)).kneighbors(_frame(q))[2])
    tk, jk = outs
    np.testing.assert_array_equal(_stack(tk, "indices"), _stack(jk, "indices"))
    np.testing.assert_array_equal(_stack(tk, "indices")[1], np.arange(6))
    td, jd = _stack(tk, "distances"), _stack(jk, "distances")
    np.testing.assert_array_equal(np.isnan(td), np.isnan(jd))
    assert np.isnan(td[1]).all() and not np.isnan(np.delete(td, 1, axis=0)).any()
    finite = ~np.isnan(jd)
    np.testing.assert_allclose(td[finite], jd[finite], rtol=rtol, atol=rtol)


def test_kneighbors_multi_column_and_dict_inputs_match_jax():
    x, q = _rows(60, 4, seed=12), _rows(9, 4, seed=13)
    cols = [f"c{i}" for i in range(4)]
    frame = pd.DataFrame({c: x[:, i] for i, c in enumerate(cols)})
    qframe = pd.DataFrame({c: q[:, i] for i, c in enumerate(cols)})
    tk = NearestNeighbors(k=3).setInputCol(cols).fit(frame).kneighbors(qframe)[2]
    jk = JaxNearestNeighbors(k=3, num_workers=1).setInputCol(cols).fit(frame).kneighbors(qframe)[2]
    np.testing.assert_array_equal(_stack(tk, "indices"), _stack(jk, "indices"))
    np.testing.assert_allclose(_stack(tk, "distances"), _stack(jk, "distances"), rtol=1e-5, atol=1e-5)
    # a dict holding a 2-D block (the at-scale ingest) gives the same answer
    dk = NearestNeighbors(k=3).setInputCol("features").fit({"features": x}).kneighbors({"features": q})[2]
    np.testing.assert_array_equal(_stack(dk, "indices"), _stack(tk, "indices"))
    np.testing.assert_array_equal(_stack(dk, "distances"), _stack(tk, "distances"))


def test_every_query_finds_itself_first():
    x = _rows(200, 16, seed=13)
    knn = NearestNeighbors(k=4).setInputCol("features").fit({"features": x}).kneighbors({"features": x[:50]})[2]
    np.testing.assert_array_equal(_stack(knn, "indices")[:, 0], np.arange(50))
    # ||q||^2 - 2 q.q + ||q||^2 in float32: zero up to ulps of ||q||^2
    q_sq = np.sum(x[:50].astype(np.float64) ** 2, 1)
    assert (_stack(knn, "distances")[:, 0] <= np.sqrt(1e-5 * q_sq)).all()


def test_k_larger_than_the_item_set_raises():
    x = _rows(5, 3, seed=14)
    for cls, extra in ((NearestNeighbors, {}), (JaxNearestNeighbors, {"num_workers": 1})):
        model = cls(k=6, **extra).setInputCol("features").fit(_frame(x))
        with pytest.raises(ValueError, match="exceeds"):
            model.kneighbors(_frame(x[:2]))


@pytest.mark.parametrize("with_ids", [True, False])
def test_empty_query_frame_keeps_the_reference_columns(with_ids):
    x = _rows(20, 3, seed=15)
    ids = np.arange(20) * 3 if with_ids else None
    outs = []
    for cls, extra in ((NearestNeighbors, {}), (JaxNearestNeighbors, {"num_workers": 1})):
        est = cls(k=2, **extra).setInputCol("features")
        if with_ids:
            est = est.setIdCol("id")
        outs.append(est.fit(_frame(x, ids)).kneighbors(_frame(x, ids).iloc[:0]))
    for t, j in zip(*outs):
        assert list(t.columns) == list(j.columns)
        assert len(t) == len(j)
    assert len(outs[0][2]) == 0


@pytest.mark.parametrize("with_ids", [True, False])
def test_exact_nearest_neighbors_join_matches_jax(with_ids):
    x = _rows(40, 5, seed=16)
    ids = np.arange(500, 540) if with_ids else None
    items, queries = _frame(x, ids), _frame(x[:6] + 0.05, None if ids is None else ids[:6])
    joins = []
    for cls, extra in ((NearestNeighbors, {}), (JaxNearestNeighbors, {"num_workers": 1})):
        est = cls(k=3, **extra).setInputCol("features")
        if with_ids:
            est = est.setIdCol("id")
        joins.append(est.fit(items).exactNearestNeighborsJoin(queries, distCol="dist"))
    tj, jj = joins
    assert list(tj.columns) == list(jj.columns)
    assert len(tj) == len(jj) == 6 * 3
    for col in tj.columns:
        if col == "dist":
            np.testing.assert_allclose(tj[col].to_numpy(), jj[col].to_numpy(), rtol=1e-5, atol=1e-5)
        elif col.endswith("features"):
            np.testing.assert_array_equal(np.stack(tj[col].to_numpy()), np.stack(jj[col].to_numpy()))
        else:
            np.testing.assert_array_equal(tj[col].to_numpy(), jj[col].to_numpy())


def test_params_mirror_the_jax_estimator():
    est = NearestNeighbors(k=7, batch_queries=64).setInputCol("f").setIdCol("id")
    jest = JaxNearestNeighbors(k=7, batch_queries=64).setInputCol("f").setIdCol("id")
    assert est.solver_params == jest.solver_params
    assert est.getK() == 7 and est.getIdCol() == "id"
    assert sorted(p.name for p in est.params) == sorted(p.name for p in jest.params)
    for name in ("k", "labelCol", "featuresCol"):
        assert est.getOrDefault(name) == jest.getOrDefault(name)
    model = est.fit(_frame(_rows(8, 2, seed=17), np.arange(8)).rename(columns={"features": "f"}))
    assert model.solver_params == est.solver_params and model.getK() == 7
    with pytest.raises(ValueError, match="Unknown parameter"):
        NearestNeighbors(no_such_param=1)


# --------------------------------------------- what the port leaves out ----


def test_kneighbors_raises_without_a_card_or_set_devices(monkeypatch):
    x = _rows(10, 3, seed=18)
    model = NearestNeighbors(k=2).setInputCol("features").fit({"features": x})
    set_devices(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r'set_devices\("cpu"\)'):
        model.kneighbors({"features": x[:3]})


def test_more_than_one_worker_is_refused(monkeypatch):
    # a rank of a multi-process context driving more than one card is
    # A10i's second half; on one device num_workers is clamped to it
    # (tests/test_torch_port.py), and one process over a pool of several
    # chips fans out (tests/test_torch_multidevice.py)
    from spark_rapids_ml_tpu_torch import parallel

    monkeypatch.setattr(parallel, "visible_device_count", lambda: 2)
    monkeypatch.setattr(parallel, "spmd_context", lambda: types.SimpleNamespace(backend="gloo", is_spmd=True, rank=0, nranks=2))
    with pytest.raises(NotImplementedError, match="A10"):
        NearestNeighbors(k=2, num_workers=2).setInputCol("features").fit({"features": _rows(10, 3, seed=19)})


def test_sparse_items_name_their_roadmap_item():
    # (named when sparse items raised for ROADMAP A11b) a SparseVector item
    # set is kept CSR and searched tile by tile, with JAX's answer
    from spark_rapids_ml_tpu.linalg import Vectors as JaxVectors

    items = [(3, [0], [1.0]), (3, [2], [2.0]), (3, [0, 1], [0.5, 4.0]), (3, [1], [-1.0])]
    data = pd.DataFrame({"features": [Vectors.sparse(*c) for c in items]})
    jdata = pd.DataFrame({"features": [JaxVectors.sparse(*c) for c in items]})
    model = NearestNeighbors(k=2).setInputCol("features").fit(data)
    assert model._item_extracted.is_sparse
    q = {"features": np.array([[1.0, 0.0, 0.0], [0.0, 3.0, 1.0]], np.float32)}
    _, _, knn = model.kneighbors(q)
    _, _, jknn = JaxNearestNeighbors(k=2, num_workers=1).setInputCol("features").fit(jdata).kneighbors(q)
    np.testing.assert_array_equal(np.stack(knn["indices"]), np.stack(jknn["indices"]))
    np.testing.assert_allclose(np.stack(knn["distances"]), np.stack(jknn["distances"]), rtol=1e-6)


def test_no_persistence_and_no_transform():
    est = NearestNeighbors(k=2).setInputCol("features")
    model = est.fit({"features": _rows(6, 2, seed=20)})
    with pytest.raises(NotImplementedError, match="saving"):
        est.write()
    with pytest.raises(NotImplementedError, match="saving"):
        model.write()
    with pytest.raises(NotImplementedError, match="kneighbors"):
        model.transform({"features": _rows(2, 2, seed=21)})
    with pytest.raises(ValueError, match="not bound"):
        NearestNeighborsModel(n_cols=2).kneighbors({"features": _rows(2, 2, seed=22)})
