#
# The PyTorch port's PCA slice (spark_rapids_ml_tpu_torch/ops/linalg.py,
# ops/pca.py, models/feature.py, the 2-D output column and the label-free
# extraction it runs) against the JAX package's (spark_rapids_ml_tpu/ops/
# linalg.py, ops/pca.py, models/feature.py) on the same inputs, made with
# numpy from a seed. The port runs on the CPU (set_devices("cpu")); the JAX
# side on its CPU devices. Neither PCA nor its statistics reach a Pallas
# kernel in the JAX package.
#
# Tolerances, and why:
#   * float32 statistics, variances and projections: rtol 1e-5 of the
#     largest entry: the same float32 formulas summed in another order (the
#     port sums the covariance over row tiles) over at most 1000 rows;
#   * float64: rtol 1e-12, the same argument at 2^-53;
#   * components: compared only where the eigenvalues are apart. The data
#     are built with a stated eigengap (scales 6, 5, 4, 3, 2, 1 on random
#     orthogonal axes: sample eigenvalues near 36, 25, 16, 9, 4, 1, gaps of
#     at least 3 against a largest of 36), because an eigenvector of a
#     repeated eigenvalue is not unique. A perturbation E of the covariance
#     moves a component by at most ‖E‖/gap, so the float32 bound is 1e-4
#     (the 1e-5 statistics bound times λ1/gap = 12) and float64 1e-10;
#   * `fast` (bf16 products, float32 sums): the JAX package's own parity
#     bounds (tests/test_precision.py::test_pca_bf16_parity: explained
#     variance rtol 2e-3, |components| atol 5e-3), and port fast against
#     JAX fast at the float32 bounds (the same bf16-rounded operands).
#
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu.models.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.models.feature import PCAModel as JaxPCAModel
from spark_rapids_ml_tpu.ops import linalg as jlinalg
from spark_rapids_ml_tpu.ops import pca as jpca
from spark_rapids_ml_tpu_torch import PCA, KMeans, PCAModel, Vectors, set_devices
from spark_rapids_ml_tpu_torch.convert import pca_model_from_jax
from spark_rapids_ml_tpu_torch.data import extract_dataset
from spark_rapids_ml_tpu_torch.errors import SolverDivergedError
from spark_rapids_ml_tpu_torch.ops import linalg as tlinalg
from spark_rapids_ml_tpu_torch.ops import pca as tpca

F32_RTOL, F64_RTOL = 1e-5, 1e-12
F32_VEC, F64_VEC = 1e-4, 1e-10


@pytest.fixture(autouse=True)
def port_on_cpu():
    set_devices("cpu")
    yield
    set_devices(None)


def _gapped(n=400, seed=0, dtype=np.float32, shift=2.0):
    """Rows with sample eigenvalues near 36, 25, 16, 9, 4, 1 on random
    orthogonal axes, plus a mean of `shift`: gaps of 3 and more."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    z = rng.normal(size=(n, 6)) * np.array([6.0, 5.0, 4.0, 3.0, 2.0, 1.0])
    return (z @ q.T + shift).astype(dtype)


def _weights(n, seed=1, zeros=True):
    w = np.random.default_rng(seed).uniform(0.5, 2.0, size=n)
    if zeros:
        w[::7] = 0.0  # zero-weight rows must count for nothing
    return w


def _tol(dtype):
    return (F32_RTOL, F32_VEC) if dtype == np.float32 else (F64_RTOL, F64_VEC)


def _close(got, want, rtol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (np.abs(got - want).max(), rtol * scale)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------ ops/linalg.py ----


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("zeros", [False, True])
def test_weighted_moments_match_jax(dtype, zeros, monkeypatch):
    monkeypatch.setattr(tlinalg, "STATS_TILE_ROWS", 64)  # 7 tiles, the last ragged
    x = _gapped(dtype=dtype)
    w = _weights(len(x), zeros=zeros).astype(dtype)
    got = tlinalg.weighted_moments(_t(x), _t(w))
    want = jlinalg.weighted_moments(jnp.asarray(x), jnp.asarray(w))
    rtol, _ = _tol(dtype)
    for g, j in zip(got, want):
        _close(g.numpy(), np.asarray(j), rtol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("tile_rows", [64, 1 << 20])
def test_weighted_cov_matches_jax(dtype, fast, zeros, tile_rows, monkeypatch):
    monkeypatch.setattr(tlinalg, "STATS_TILE_ROWS", tile_rows)
    x = _gapped(dtype=dtype, seed=3)
    w = _weights(len(x), seed=4, zeros=zeros).astype(dtype)
    tw, mean, cov = tlinalg.weighted_cov(_t(x), _t(w), ddof=1, fast=fast)
    jw, jmean, jcov = jlinalg.weighted_cov(jnp.asarray(x), jnp.asarray(w), ddof=1, fast=fast)
    assert cov.dtype == _t(x).dtype
    # fast: float32 sums of bf16-exact products on both sides
    rtol = F32_RTOL if fast else _tol(dtype)[0]
    _close(tw.numpy(), np.asarray(jw), rtol)
    _close(mean.numpy(), np.asarray(jmean), rtol)
    _close(cov.numpy(), np.asarray(jcov), rtol)


def test_weighted_cov_fast_accumulates_in_float32_for_float64_inputs():
    # the product is summed in float32 and cast back, as JAX's
    # preferred_element_type=float32 does: the float64 result carries the
    # float32 sum of the bf16-rounded operands, within bf16 rounding
    # (2^-8 of each operand) of the full-precision covariance
    x = _gapped(dtype=np.float64, seed=5)
    w = np.ones(len(x))
    _, mean, full = tlinalg.weighted_cov(_t(x), _t(w))
    _, _, fast = tlinalg.weighted_cov(_t(x), _t(w), fast=True)
    assert fast.dtype == torch.float64
    assert not torch.equal(fast, full)
    xc = _t(x) - mean
    want = (tlinalg._bf16(xc).T @ tlinalg._bf16(xc)).to(torch.float64) / (len(x) - 1)
    assert torch.equal(fast, want)
    np.testing.assert_allclose(fast.numpy(), full.numpy(), rtol=2e-2, atol=2e-2 * np.abs(full.numpy()).max())


@pytest.mark.parametrize(
    "rows",
    [
        [[1.0, -1.0, 0.5]],  # tie in |value|: the first index decides (+)
        [[-1.0, 1.0, 0.5]],  # the same tie, the first entry negative: flipped
        [[0.0, 0.0, 0.0]],  # a zero row keeps sign +1
        [[0.2, -3.0, 3.0], [-2.0, 2.0, 1.0], [0.0, 0.0, -0.0]],
        [[-0.5, 0.25, -0.5, 0.5]],  # three-way tie
    ],
)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sign_flip_matches_jax(rows, dtype):
    c = np.asarray(rows, dtype=dtype)
    got = tlinalg.sign_flip(_t(c)).numpy()
    want = np.asarray(jlinalg.sign_flip(jnp.asarray(c)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_topk_eigh_desc_matches_jax(dtype, k):
    x = _gapped(dtype=dtype, seed=6)
    cov = np.cov(x.T.astype(np.float64)).astype(dtype)
    ev, vec = tlinalg.topk_eigh_desc(_t(cov), k)
    jev, jvec = jlinalg.topk_eigh_desc(jnp.asarray(cov), k)
    rtol, vtol = _tol(dtype)
    assert ev.shape == (k,) and vec.shape == (k, 6)
    assert (np.diff(ev.numpy()) <= 0).all()  # descending
    _close(ev.numpy(), np.asarray(jev), rtol)
    # eigenvectors are defined up to sign: compare after canonicalization
    got = tlinalg.sign_flip(vec).numpy()
    want = np.asarray(jlinalg.sign_flip(jvec))
    assert np.abs(got - want).max() <= vtol


@pytest.mark.parametrize("n,k", [(5, 1), (37, 3), (1000, 2)])
def test_rows_dot_fixed_is_a_product_and_batch_independent(n, k, monkeypatch):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 29)).astype(np.float32)
    m = rng.normal(size=(k, 29)).astype(np.float32)
    got = tlinalg.rows_dot_fixed(_t(x), _t(m)).numpy()
    np.testing.assert_allclose(got, x.astype(np.float64) @ m.T.astype(np.float64), rtol=1e-5, atol=1e-5)
    # every row alone, and through product blocks of 3 rows: the same bits
    alone = np.concatenate([tlinalg.rows_dot_fixed(_t(x[i:i + 1]), _t(m)).numpy() for i in range(n)])
    np.testing.assert_array_equal(alone, got)
    monkeypatch.setattr(tlinalg, "DOT_BLOCK_ELEMS", 3 * k * 29)
    np.testing.assert_array_equal(tlinalg.rows_dot_fixed(_t(x), _t(m)).numpy(), got)


# --------------------------------------------------------- ops/pca.py ----


_ATTRS = ("mean_", "components_", "explained_variance_", "explained_variance_ratio_", "singular_values_")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 3, 6])
@pytest.mark.parametrize("weighted", [False, True])
def test_pca_fit_matches_jax(dtype, k, weighted):
    x = _gapped(dtype=dtype, seed=7)
    w = (_weights(len(x), seed=8) if weighted else np.ones(len(x))).astype(dtype)
    got = tpca.pca_fit(_t(x), _t(w), k=k)
    want = jpca.pca_fit(jnp.asarray(x), jnp.asarray(w), k=k)
    rtol, vtol = _tol(dtype)
    for name in _ATTRS:
        g, j = got[name].numpy(), np.asarray(want[name])
        assert g.shape == j.shape and g.dtype == j.dtype, name
        if name == "components_":
            assert np.abs(g - j).max() <= vtol, name
        else:
            _close(g, j, rtol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("whiten", [False, True])
def test_pca_transform_matches_jax(dtype, whiten):
    x = _gapped(dtype=dtype, seed=9)
    state = jpca.pca_fit(jnp.asarray(x), jnp.asarray(np.ones(len(x), dtype)), k=3)
    comps, ev = np.asarray(state["components_"]), np.asarray(state["explained_variance_"])
    got = tpca.pca_transform(_t(x), _t(comps), _t(ev), whiten=whiten).numpy()
    want = np.asarray(jpca.pca_transform(jnp.asarray(x), jnp.asarray(comps), jnp.asarray(ev), whiten=whiten))
    _close(got, want, _tol(dtype)[0])


def test_pca_fast_parity_bounds():
    # tests/test_precision.py::test_pca_bf16_parity on the port, and the
    # port's fast fit against JAX's fast fit
    rng = np.random.default_rng(42)
    x = rng.normal(size=(800, 6)) @ np.diag([5.0, 4.0, 3.0, 0.5, 0.2, 0.1])
    w = np.ones(800)
    full = tpca.pca_fit(_t(x), _t(w), k=3)
    fast = tpca.pca_fit(_t(x), _t(w), k=3, fast=True)
    np.testing.assert_allclose(fast["explained_variance_"].numpy(), full["explained_variance_"].numpy(), rtol=2e-3)
    np.testing.assert_allclose(np.abs(fast["components_"].numpy()), np.abs(full["components_"].numpy()), atol=5e-3)
    jfast = jpca.pca_fit(jnp.asarray(x), jnp.asarray(w), k=3, fast=True)
    _close(fast["explained_variance_"].numpy(), np.asarray(jfast["explained_variance_"]), F32_RTOL)
    assert np.abs(fast["components_"].numpy() - np.asarray(jfast["components_"])).max() <= F32_VEC


def test_check_pca_state_keeps_the_finite_parts():
    state = {
        "mean_": np.ones(3), "components_": np.full((2, 3), np.nan),
        "explained_variance_": np.array([1.0, np.nan]), "singular_values_": np.ones(2),
    }
    with pytest.raises(SolverDivergedError) as e:
        tpca.check_pca_state(state, k=2)
    assert e.value.solver == "pca" and e.value.iteration == 0
    assert sorted(e.value.last_good) == ["mean_", "singular_values_"]
    ok = {"mean_": np.ones(3), "components_": np.eye(3)[:2], "explained_variance_": np.ones(2)}
    assert tpca.check_pca_state(ok, k=2) is ok


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nan_row_raises_solver_diverged_in_both_packages(dtype):
    x = _gapped(dtype=dtype, seed=10)
    x[17, 2] = np.nan
    f32 = dtype == np.float32
    with pytest.raises(SolverDivergedError, match="pca diverged"):
        PCA(k=2, float32_inputs=f32).setInputCol("features").fit({"features": x})
    from spark_rapids_ml_tpu.errors import SolverDivergedError as JaxSolverDivergedError

    with pytest.raises(JaxSolverDivergedError, match="pca diverged"):
        JaxPCA(k=2, num_workers=1, float32_inputs=f32).setInputCol("features").fit({"features": x})


# --------------------------------------------- the estimator, the model ----


def _fit_both(data, k=3, float32_inputs=True, **kw):
    models = []
    for cls, extra in ((PCA, {}), (JaxPCA, {"num_workers": 1})):
        est = cls(k=k, float32_inputs=float32_inputs, **kw, **extra).setInputCol("features").setOutputCol("pcs")
        models.append(est.fit(data))
    return models


def _column(model, data, name="pcs"):
    return np.stack([np.asarray(v.toArray() if hasattr(v, "toArray") else v) for v in model.transform(data)[name]])


@pytest.mark.parametrize("kind", ["dict", "array", "list", "vector"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_estimator_matches_jax_through_the_public_api(kind, dtype):
    x = _gapped(dtype=dtype, seed=11)
    if kind == "dict":
        port_data = jax_data = {"features": x}
    elif kind == "vector":
        from spark_rapids_ml_tpu.linalg import Vectors as JaxVectors

        port_data = pd.DataFrame({"features": [Vectors.dense(v) for v in x]})
        jax_data = pd.DataFrame({"features": [JaxVectors.dense(v) for v in x]})
    elif kind == "list":
        port_data = jax_data = pd.DataFrame({"features": [list(map(float, v)) for v in x]})
    else:
        port_data = jax_data = pd.DataFrame({"features": list(x)})
    f32 = dtype == np.float32
    tm = PCA(k=3, float32_inputs=f32).setInputCol("features").setOutputCol("pcs").fit(port_data)
    jm = JaxPCA(k=3, num_workers=1, float32_inputs=f32).setInputCol("features").setOutputCol("pcs").fit(jax_data)
    rtol, vtol = _tol(dtype)
    assert tm.components_.dtype == jm.components_.dtype and tm.dtype == jm.dtype
    assert np.abs(tm.components_ - jm.components_).max() <= vtol
    for name in ("mean_", "explained_variance_", "explained_variance_ratio_", "singular_values_"):
        _close(getattr(tm, name), getattr(jm, name), rtol)
    out = tm.transform(port_data)
    cell = out["pcs"].iloc[0]
    # a 2-D result is a vector column: DenseVectors for vector input
    assert type(cell).__name__ == ("DenseVector" if kind == "vector" else "ndarray")
    _close(_column(tm, port_data), _column(jm, jax_data), rtol)
    np.testing.assert_array_equal(tm.pc, tm.components_.T)
    np.testing.assert_array_equal(tm.explainedVariance, tm.explained_variance_ratio_)
    assert tm.mean == tm.mean_.tolist() and tm.getK() == 3


def test_multi_column_input_and_whiten_match_jax():
    x = _gapped(seed=12)
    data = pd.DataFrame({f"c{i}": x[:, i] for i in range(6)})
    cols = [f"c{i}" for i in range(6)]
    tm = PCA(k=2, whiten=True).setInputCols(cols).setOutputCol("o").fit(data)
    jm = JaxPCA(k=2, whiten=True, num_workers=1).setInputCols(cols).setOutputCol("o").fit(data)
    assert tm.solver_params["whiten"] is True
    got, want = _column(tm, data, "o"), _column(jm, data, "o")
    _close(got, want, F32_RTOL)
    # whitened projections of centered rows have unit sample variance
    np.testing.assert_allclose(np.var(got, axis=0, ddof=1), 1.0, rtol=1e-3)


def test_default_output_column_and_params_mirror_jax():
    tm = PCA(k=2).setInputCol("features").fit({"features": _gapped(seed=13)})
    assert tm._out_column_names() == [f"{tm.uid}__output"]
    est, jest = PCA(k=4), JaxPCA(k=4)
    assert est.solver_params == jest.solver_params
    assert PCA().getK() == JaxPCA().getK() == 1
    with pytest.raises(ValueError, match="Unknown parameter"):
        PCA(no_such_param=1)


@pytest.mark.parametrize("k,match", [(0, "k must be >= 1"), (7, "exceeds the number of features")])
def test_k_out_of_range_raises(k, match):
    x = _gapped(seed=14)
    with pytest.raises(ValueError, match=match):
        PCA(k=k).setInputCol("features").fit({"features": x})
    with pytest.raises(ValueError, match=match):
        JaxPCA(k=k, num_workers=1).setInputCol("features").fit({"features": x})


def test_fast_estimator_matches_jax_fast():
    x = _gapped(seed=15)
    tm, jm = _fit_both({"features": x}, solver_precision="bf16")
    full = PCA(k=3).setInputCol("features").fit({"features": x})
    assert np.abs(tm.components_ - jm.components_).max() <= F32_VEC
    _close(tm.explained_variance_, jm.explained_variance_, F32_RTOL)
    np.testing.assert_allclose(tm.explained_variance_, full.explained_variance_, rtol=2e-3)


def test_cpu_conversion_names_its_roadmap_item():
    tm = PCA(k=1).setInputCol("features").fit({"features": _gapped(seed=16)})
    with pytest.raises(NotImplementedError, match="A16"):
        tm.cpu()


# ------------------------------------------------------- persistence ----


@pytest.mark.parametrize("float32_inputs", [True, False])
def test_jax_saved_model_loads_and_transforms_the_same(tmp_path, float32_inputs):
    x = _gapped(seed=17, dtype=np.float32 if float32_inputs else np.float64)
    jm = JaxPCA(k=3, num_workers=1, float32_inputs=float32_inputs).setInputCol("features") \
        .setOutputCol("pcs").fit({"features": x})
    path = str(tmp_path / "jax_pca")
    jm.write().overwrite().save(path)
    tm = PCAModel.load(path)
    assert tm.float32_inputs == float32_inputs and tm.getOrDefault("outputCol") == "pcs"
    for name in _ATTRS:
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    want = _column(jm, {"features": x})
    rtol = _tol(x.dtype.type)[0]
    _close(_column(tm, {"features": x}), want, rtol)
    conv = pca_model_from_jax(jm._model_attributes)
    assert conv.float32_inputs == float32_inputs
    conv.setInputCol("features").setOutputCol("pcs")
    _close(_column(conv, {"features": x}), want, rtol)


def test_port_saved_model_loads_in_jax_and_back(tmp_path):
    x = _gapped(seed=18)
    tm = PCA(k=2).setInputCol("features").setOutputCol("pcs").fit({"features": x})
    path = str(tmp_path / "port_pca")
    tm.write().overwrite().save(path)
    assert sorted(os.listdir(path)) == ["arrays.npz", "attributes.json", "metadata.json"]
    jm = JaxPCAModel.load(path)
    back = PCAModel.load(path)
    want = _column(tm, {"features": x})
    np.testing.assert_array_equal(_column(back, {"features": x}), want)
    _close(_column(jm, {"features": x}), want, F32_RTOL)
    assert back.uid == tm.uid and back.getK() == 2


def test_convert_refuses_incomplete_or_misshapen_attributes():
    attrs = {"mean_": np.zeros(3), "components_": np.eye(3)[:2], "explained_variance_": np.ones(2),
             "explained_variance_ratio_": np.ones(2) / 2, "singular_values_": np.ones(2), "n_cols": 3,
             "dtype": "float32"}
    assert pca_model_from_jax(attrs).components_.shape == (2, 3)
    with pytest.raises(ValueError, match="lack"):
        pca_model_from_jax({k: v for k, v in attrs.items() if k != "mean_"})
    with pytest.raises(ValueError, match="components_ must be 2-D"):
        pca_model_from_jax(dict(attrs, components_=np.ones(3)))


# --------------------------------------------- ingest without a label ----


def test_unsupervised_fits_extract_no_label():
    x = _gapped(seed=19)
    data = {"features": x, "label": np.arange(len(x), dtype=np.float64)}
    assert extract_dataset(data, input_col="features").label is None
    m1 = KMeans(k=3, maxIter=5, seed=2).fit(data)
    m2 = KMeans(k=3, maxIter=5, seed=2).fit({"features": x})
    np.testing.assert_array_equal(m1.cluster_centers_, m2.cluster_centers_)
    p1 = PCA(k=2).setInputCol("features").fit(data)
    np.testing.assert_array_equal(p1.components_, PCA(k=2).setInputCol("features").fit({"features": x}).components_)


# -------------------------------------------------------------- the card ----


@pytest.fixture
def card():
    """A CUDA device for the card tests; skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: PCA on the card runs on an NVIDIA GPU only (chip_smoke.py phase 7)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_pca_fit_on_card_matches_cpu(card, fast):
    x = _gapped(n=5000, seed=20)
    w = np.ones(len(x), np.float32)
    cpu = tpca.pca_fit(_t(x), _t(w), k=3, fast=fast)
    gpu = tpca.pca_fit(_t(x).to(card), _t(w).to(card), k=3, fast=fast)
    for name in _ATTRS:
        g, c = gpu[name].cpu().numpy(), cpu[name].numpy()
        assert np.abs(g - c).max() <= (F32_VEC if name == "components_" else F32_RTOL * np.abs(c).max())


@pytest.mark.cuda
def test_pca_transform_on_card_is_batch_independent(card):
    x = _gapped(n=3000, seed=21)
    comps = np.linalg.qr(np.random.default_rng(0).normal(size=(6, 6)))[0][:3].astype(np.float32)
    xd, cd = _t(x).to(card), _t(comps).to(card)
    ev = torch.ones(3, device=card)
    whole = tpca.pca_transform(xd, cd, ev).cpu().numpy()
    for lo, n in ((0, 1), (5, 7), (100, 256), (1000, 2000)):
        part = tpca.pca_transform(xd[lo:lo + n], cd, ev).cpu().numpy()
        np.testing.assert_array_equal(part, whole[lo:lo + n])
