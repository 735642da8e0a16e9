#
# The PyTorch port's distance core (spark_rapids_ml_tpu_torch/ops/distance.py)
# against the JAX package's (spark_rapids_ml_tpu/ops/distance.py) on the same
# inputs, made with numpy from a seed.
#
# On the CPU the port runs the plain PyTorch versions of its kernels; the
# JAX side runs its REAL Pallas kernels through the interpreter (the
# `interpret_mode` fixture, as tests/test_distance.py does), with blocks of
# (8 rows, 4 centers) so every shape below crosses a block boundary or a
# ragged tail, or its jnp branch (`jnp_mode`). The top-k merge runs with
# item blocks of 4 on both sides, so ties and masks straddle block
# boundaries. `fast` (bf16 products, float32 sums, the result in the input
# dtype) is held against the JAX kernels' `fast` bodies for float32 and
# float64 inputs: exactly on integer data, to rtol 1e-5 of the scale on
# Gaussian data. The CUDA kernels themselves are held against the plain
# versions by the `cuda`-marked tests at the end, which need the card.
#
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import distance as jdist
from spark_rapids_ml_tpu_torch import parallel as port_parallel
from spark_rapids_ml_tpu_torch.ops import _kernels
from spark_rapids_ml_tpu_torch.ops import distance as tdist


@pytest.fixture(autouse=True)
def port_on_cpu():
    port_parallel.set_devices("cpu")
    yield
    port_parallel.set_devices(None)


@pytest.fixture
def interpret_mode():
    """The JAX package's real kernels through the Pallas interpreter."""
    saved = jdist._MODE
    jdist._MODE = "interpret"
    yield
    jdist._MODE = saved


@pytest.fixture
def jnp_mode():
    """The JAX package's jnp branch (the bit-compatible fallback)."""
    saved = jdist._MODE
    jdist._MODE = "jnp"
    yield
    jdist._MODE = saved


@pytest.fixture
def card():
    """A CUDA device for the kernel tests; skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU form "
            "(their plain versions are held against JAX above)"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(n, k, d, dtype, seed=0, integer=False):
    rng = np.random.default_rng(seed)
    if integer:  # exact in bf16, f32 and f64: every sum is exact
        X = rng.integers(-4, 5, size=(n, d)).astype(dtype)
        C = rng.integers(-4, 5, size=(k, d)).astype(dtype)
        C[k // 2] = C[0]  # a duplicated center: ties must go to the first
        w = rng.integers(1, 4, size=n).astype(dtype)
    else:
        X = rng.normal(size=(n, d)).astype(dtype)
        C = rng.normal(size=(k, d)).astype(dtype)
        w = rng.uniform(0.5, 2.0, size=n).astype(dtype)
    return X, C, w


def _both(*arrays):
    """The same numpy arrays as jax arrays and as CPU torch tensors."""
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


def _np(t):
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


# ------------------------------------------- plain versions against JAX ----


@pytest.mark.parametrize("n", [7, 8, 9])
@pytest.mark.parametrize("k", [3, 4, 5])
@pytest.mark.parametrize("d", [5, 8])
def test_assign_accumulate_matches_jax_kernels_f64(interpret_mode, n, k, d):
    X, C, w = _data(n, k, d, np.float64, seed=n * 100 + k * 10 + d)
    (jX, jC, jw), (tX, tC, tw) = _both(X, C, w)
    js, jc, ji = jdist.assign_accumulate(jX, jw, jC, block_rows=8, block_k=4)
    ts, tc, ti = tdist.assign_accumulate(tX, tw, tC)
    # the same f64 formulas summed in another order: rtol 1e-9
    np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-9)
    np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-9)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-9)
    jm, jb = jdist.assign_argmin(jX, jC, block_rows=8, block_k=4)
    tm, tb = tdist.assign_argmin(tX, tC)
    assert (_np(tb) == _np(jb)).all()
    assert tb.dtype == torch.int32
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=1e-9)


@pytest.mark.parametrize("n,k", [(9, 5), (16, 4), (33, 7)])
def test_assign_argmin_matches_jax_kernels_f32_exact(interpret_mode, n, k):
    X, C, _ = _data(n, k, 6, np.float32, seed=n)
    (jX, jC), (tX, tC) = _both(X, C)
    jm, jb = jdist.assign_argmin(jX, jC, block_rows=8, block_k=4)
    tm, tb = tdist.assign_argmin(tX, tC)
    assert (_np(tb) == _np(jb)).all()  # assignments exactly
    # f32 dot products summed in another order: rtol 1e-5, atol for values near 0
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k,d", [(33, 5, 8), (9, 4, 5), (17, 9, 13)])
def test_fast_mode_integer_data_exact(interpret_mode, n, k, d):
    # bf16 inputs, f32 accumulation: on integer-valued data every product and
    # sum is exact, so the port's plain version and the JAX kernels agree
    # bit for bit, ties (a duplicated center) included
    X, C, w = _data(n, k, d, np.float32, seed=d, integer=True)
    (jX, jC, jw), (tX, tC, tw) = _both(X, C, w)
    js, jc, ji = jdist.assign_accumulate(jX, jw, jC, fast=True, block_rows=8, block_k=4)
    ts, tc, ti = tdist.assign_accumulate(tX, tw, tC, fast=True)
    np.testing.assert_array_equal(_np(ts), _np(js))
    np.testing.assert_array_equal(_np(tc), _np(jc))
    assert float(ti) == float(ji)
    jm, jb = jdist.assign_argmin(jX, jC, fast=True, block_rows=8, block_k=4)
    tm, tb = tdist.assign_argmin(tX, tC, fast=True)
    np.testing.assert_array_equal(_np(tb), _np(jb))
    np.testing.assert_array_equal(_np(tm), _np(jm))


def test_integer_ties_go_to_first_center(interpret_mode):
    X, C, _ = _data(40, 6, 4, np.float64, seed=5, integer=True)
    C[4] = C[1]  # more duplicates: index 1 must win over 4, 0 over 3
    C[3] = C[0]
    (jX, jC), (tX, tC) = _both(X, C)
    _, jb = jdist.assign_argmin(jX, jC, block_rows=8, block_k=4)
    _, tb = tdist.assign_argmin(tX, tC)
    np.testing.assert_array_equal(_np(tb), _np(jb))
    assert not np.isin(_np(tb), [3, 4]).any()


def test_zero_weight_rows_contribute_nothing(interpret_mode):
    X, C, w = _data(11, 4, 5, np.float64, seed=7)
    Xp = np.concatenate([X, np.full((5, 5), 1e6)])
    wp = np.concatenate([w, np.zeros(5)])
    (jX, jC, jw), _ = _both(X, C, w)
    js, jc, ji = jdist.assign_accumulate(jX, jw, jC, block_rows=8, block_k=4)
    _, (tXp, tC, twp) = _both(Xp, C, wp)
    ts, tc, ti = tdist.assign_accumulate(tXp, twp, tC)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-9)
    np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-9)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-9)


@pytest.mark.parametrize("n,batch_rows", [(37, 8), (64, 16), (5, 8), (100, 33)])
def test_argmin_assign_ragged_tiles(n, batch_rows):
    X, C, _ = _data(n, 6, 5, np.float64, seed=11 + n)
    (jX, jC), (tX, tC) = _both(X, C)
    ja = jdist.argmin_assign(jX, jC, batch_rows=batch_rows)
    ta = tdist.argmin_assign(tX, tC, batch_rows=batch_rows)
    ref = np.argmin(np.sum(C * C, 1)[None, :] - 2.0 * (X @ C.T), axis=1)
    np.testing.assert_array_equal(_np(ta), ref)
    np.testing.assert_array_equal(_np(ta), _np(ja))
    assert ta.dtype == torch.int32


def test_tile_assign_accumulate_matches_one_tile():
    # the Lloyd row-tile loop (ragged tail last) equals one tile over all rows
    X, C, w = _data(50, 4, 3, np.float64, seed=2)
    _, (tX, tC, tw) = _both(X, C, w)
    s1, c1, i1 = tdist.tile_assign_accumulate(tX, tw, tC, batch_rows=16)
    s0, c0, i0 = tdist.assign_accumulate(tX, tw, tC)
    np.testing.assert_allclose(_np(s1), _np(s0), rtol=1e-12)
    np.testing.assert_allclose(_np(c1), _np(c0), rtol=1e-12)
    np.testing.assert_allclose(float(i1), float(i0), rtol=1e-12)


def test_min_d2_update_and_pairwise_match_jax():
    X, C, _ = _data(20, 7, 4, np.float64, seed=3)
    prev = np.full(20, 3.0)
    (jX, jC, jp), (tX, tC, tp) = _both(X, C, prev)
    np.testing.assert_allclose(
        _np(tdist.pairwise_d2(tX, tC)), np.asarray(jdist.pairwise_d2(jX, jC)), rtol=1e-12
    )
    np.testing.assert_allclose(
        _np(tdist.min_d2_update(tX, tC, tp)), np.asarray(jdist.min_d2_update(jX, jC, jp)),
        rtol=1e-12,
    )


# ------------------------------------------------------- top-k (kNN) ----


def _topk_reference(q, items, valid, kk):
    """One full-matrix `jax.lax.top_k`: the tie order both merges must give."""
    q, items = np.asarray(q), np.asarray(items)
    d2 = np.sum(items * items, 1)[None, :] - 2.0 * (q @ items.T)
    if valid is not None:
        d2 = np.where(np.asarray(valid)[None, :], d2, np.inf)
    neg_d, idx = jax.lax.top_k(jnp.asarray(-d2), kk)
    return -np.asarray(neg_d), np.asarray(idx)


def _dup_integer_items(seed):
    """Integer rows (every dot product exact) whose copies tie exactly:
    ids 6, 7, 8 repeat 0, 1, 2, across a 4-item block boundary."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-3, 4, size=(6, 5)).astype(np.float64)
    items = np.concatenate([base, base[:3]])
    q = rng.integers(-3, 4, size=(4, 5)).astype(np.float64)
    return q, items


@pytest.mark.parametrize("mode_fixture", ["interpret_mode", "jnp_mode"])
@pytest.mark.parametrize("n", [7, 8, 9, 20])
def test_topk_tile_boundary_parity(request, mode_fixture, n):
    request.getfixturevalue(mode_fixture)
    rng = np.random.default_rng(n)
    q, items = rng.normal(size=(5, 6)), rng.normal(size=(n, 6))
    kk = min(4, n)
    (jq, ji), (tq, ti) = _both(q, items)
    jd2, jidx = jdist.topk_tile(jq, ji, None, kk, k_tile=4, block_rows=8)
    td2, tidx = tdist.topk_tile(tq, ti, None, kk, k_tile=4)
    rd2, ridx = _topk_reference(q, items, None, kk)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
    np.testing.assert_array_equal(_np(tidx), ridx)
    np.testing.assert_allclose(_np(td2), np.asarray(jd2), rtol=1e-9)
    np.testing.assert_allclose(_np(td2), rd2, rtol=1e-9)


@pytest.mark.parametrize("mode_fixture", ["interpret_mode", "jnp_mode"])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_tie_ordering_matches_lax_top_k(request, mode_fixture, seed):
    # exactly tied distances straddling a block boundary: lower index first
    request.getfixturevalue(mode_fixture)
    q, items = _dup_integer_items(seed)
    (jq, ji), (tq, ti) = _both(q, items)
    jd2, jidx = jdist.topk_tile(jq, ji, None, 6, k_tile=4, block_rows=4)
    td2, tidx = tdist.topk_tile(tq, ti, None, 6, k_tile=4)
    rd2, ridx = _topk_reference(q, items, None, 6)
    np.testing.assert_array_equal(_np(td2), np.asarray(jd2))
    np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
    np.testing.assert_array_equal(_np(td2), rd2)
    np.testing.assert_array_equal(_np(tidx), ridx)


def test_topk_invalid_items_masked(interpret_mode):
    # items with valid=False never appear among finite neighbors
    rng = np.random.default_rng(2)
    items, q = rng.normal(size=(9, 4)), rng.normal(size=(3, 4))
    valid = np.array([True] * 6 + [False] * 3)
    (jq, ji, jv), (tq, ti, tv) = _both(q, items, valid)
    jd2, jidx = jdist.topk_tile(jq, ji, jv, 6, k_tile=4, block_rows=4)
    td2, tidx = tdist.topk_tile(tq, ti, tv, 6, k_tile=4)
    finite = np.isfinite(_np(td2))
    assert finite.sum() == 3 * 6  # all six real items found
    assert (_np(tidx)[finite] < 6).all()
    np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
    np.testing.assert_allclose(_np(td2), np.asarray(jd2), rtol=1e-9)


@pytest.mark.parametrize("k_tile", [1, 3, 4, 5, 9, 16, 40, None])
@pytest.mark.parametrize("kk", [1, 6, 10])
def test_topk_tile_does_not_depend_on_k_tile(k_tile, kk):
    # the same answer, ties and masked items included, whatever the block
    # size: smaller than kk, ragged, one block, and the default
    q, base = _dup_integer_items(3)
    items = np.concatenate([base, base, base[:7], base[:4]])  # 29 rows, many ties
    valid = np.ones(len(items), dtype=bool)
    valid[[2, 11, 28]] = False
    _, (tq, ti, tv) = _both(q, items, valid)
    td2, tidx = tdist.topk_tile(tq, ti, tv, kk, k_tile=k_tile)
    rd2, ridx = _topk_reference(q, items, valid, kk)
    np.testing.assert_array_equal(_np(td2), rd2)
    np.testing.assert_array_equal(_np(tidx), ridx)


def test_topk_tile_default_block_is_the_ports_constant(monkeypatch):
    # the default block is one fixed item count on every device; shrinking
    # it makes the same call merge several blocks, with the same answer
    q, items = np.random.default_rng(4).normal(size=(3, 5)), np.random.default_rng(5).normal(size=(50, 5))
    _, (tq, ti) = _both(q, items)
    one = tdist.topk_tile(tq, ti, None, 7)
    calls = []
    real = tdist.d2_block
    monkeypatch.setattr(
        tdist, "d2_block", lambda *a, **kw: calls.append(a[1].shape[0]) or real(*a, **kw)
    )
    monkeypatch.setattr(tdist, "_DEFAULT_K_TILE", 16)
    many = tdist.topk_tile(tq, ti, None, 7)
    assert calls == [16, 16, 16, 16]  # 50 items: 3 blocks and the clamped-back tail
    assert torch.equal(one[1], many[1]) and torch.equal(one[0], many[0])


def _nan_query_rows(dtype):
    """300 Gaussian items and 4 queries, query 1 all NaN: every distance of
    that row is NaN, and the merge must still rank it as `jax.lax.top_k`
    does (NaN after +inf, the lower column first)."""
    rng = np.random.default_rng(1)
    items = rng.normal(size=(300, 8)).astype(dtype)
    q = rng.normal(size=(4, 8)).astype(dtype)
    q[1] = np.nan
    return q, items


def _assert_nan_aware_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    scale = np.abs(want[finite]).max()
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("mode_fixture", ["interpret_mode", "jnp_mode"])
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-9), (np.float32, 1e-5)])
@pytest.mark.parametrize("k_tile", [300, 64])  # one block of all items; five blocks
@pytest.mark.parametrize("fast", [False, True])
def test_topk_tile_nan_query_row_matches_jax(request, mode_fixture, dtype, rtol, k_tile, fast):
    request.getfixturevalue(mode_fixture)
    q, items = _nan_query_rows(dtype)
    (jq, ji), (tq, ti) = _both(q, items)
    jd2, jidx = jdist.topk_tile(jq, ji, None, 10, k_tile=k_tile, block_rows=8, fast=fast)
    td2, tidx = tdist.topk_tile(tq, ti, None, 10, k_tile=k_tile, fast=fast)
    np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
    if k_tile == 300:  # one block: the NaN row's first columns, in order
        np.testing.assert_array_equal(_np(tidx)[1], np.arange(10))
        assert np.isnan(_np(td2)[1]).all()
    else:  # the carried +inf entries are never displaced by NaN
        assert (_np(tidx)[1] == 0).all() and np.isposinf(_np(td2)[1]).all()
    _assert_nan_aware_close(_np(td2), np.asarray(jd2), 1e-5 if fast else rtol)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-9), (np.float32, 1e-5)])
@pytest.mark.parametrize("B,kt,d", [(13, 11, 7), (8, 4, 5), (33, 17, 130), (1, 1, 1)])
def test_d2_block_plain_matches_pallas_kernel(B, kt, d, dtype, rtol):
    rng = np.random.default_rng(B * kt + d)
    q = rng.normal(size=(B, d)).astype(dtype)
    xt = rng.normal(size=(kt, d)).astype(dtype)
    xt_sq = np.sum(xt * xt, 1).astype(dtype)
    qp = np.concatenate([q, np.zeros((-B % 8, d), dtype)])  # the kernel's row blocks of 8
    jout = np.asarray(jdist._pl_d2_block(
        jnp.asarray(qp), jnp.asarray(xt), jnp.asarray(xt_sq), block_rows=8, fast=False, interpret=True,
    ))[:B]
    _, (tq, txt, tsq) = _both(q, xt, xt_sq)
    tout = tdist.d2_block(tq, txt, tsq)
    assert tout.dtype == tq.dtype and tout.shape == (B, kt)
    # the same formula, dot products summed in another order: rtol of the scale
    scale = np.abs(jout).max()
    np.testing.assert_allclose(_np(tout), jout, rtol=rtol, atol=rtol * scale)


# ------------------------------------------ fast (bf16) mode, f32 and f64 ----


def test_mm_fast_accumulates_in_float32_for_float64_inputs():
    # bf16 operands, float32 sums, the result cast back: 1 + 2^-25 is exact
    # in float64 but rounds to 1 in float32, as JAX's _mm gives it
    a = np.array([[1.0, 2.0 ** -25]])
    b = np.array([[1.0], [1.0]])
    (ja, jb), (ta, tb) = _both(a, b)
    got = tdist._mm(ta, tb, True)
    assert got.dtype == torch.float64
    assert float(got[0, 0]) == 1.0
    np.testing.assert_array_equal(_np(got), np.asarray(jdist._mm(ja, jb, True)))
    assert float(tdist._mm(ta, tb, False)[0, 0]) == 1.0 + 2.0 ** -25


def _d2_fast_inputs(B, kt, d, dtype, integer, seed):
    rng = np.random.default_rng(seed)
    if integer:  # |v| <= 4: exact in bf16, every sum exact in float32
        q = rng.integers(-4, 5, size=(B, d)).astype(dtype)
        xt = rng.integers(-4, 5, size=(kt, d)).astype(dtype)
    else:
        q = rng.normal(size=(B, d)).astype(dtype)
        xt = rng.normal(size=(kt, d)).astype(dtype)
    return q, xt, np.sum(xt * xt, 1).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("B,kt,d", [(13, 11, 7), (8, 4, 5), (33, 17, 130), (1, 1, 1)])
def test_d2_block_fast_matches_pallas_kernel(B, kt, d, dtype, integer):
    q, xt, xt_sq = _d2_fast_inputs(B, kt, d, dtype, integer, seed=B * kt + d)
    qp = np.concatenate([q, np.zeros((-B % 8, d), dtype)])  # the kernel's row blocks of 8
    jout = np.asarray(jdist._pl_d2_block(
        jnp.asarray(qp), jnp.asarray(xt), jnp.asarray(xt_sq), block_rows=8, fast=True, interpret=True,
    ))[:B]
    _, (tq, txt, tsq) = _both(q, xt, xt_sq)
    tout = tdist.d2_block(tq, txt, tsq, fast=True)
    assert tout.dtype == tq.dtype and tout.shape == (B, kt)
    if integer:
        np.testing.assert_array_equal(_np(tout), jout)
    else:
        # the same bf16 operands and exact products, summed in float32 in
        # another order: rtol 1e-5 of the block's scale, in f32 and f64 alike
        scale = np.abs(jout).max()
        np.testing.assert_allclose(_np(tout), jout, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("mode_fixture", ["interpret_mode", "jnp_mode"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_tile_fast_ties_match_jax(request, mode_fixture, dtype, seed):
    # integer rows repeated across a 4-item block boundary: bf16 is exact on
    # them, so the fast merge gives lax.top_k's order exactly, lower index first
    request.getfixturevalue(mode_fixture)
    q, items = _dup_integer_items(seed)
    q, items = q.astype(dtype), items.astype(dtype)
    (jq, ji), (tq, ti) = _both(q, items)
    jd2, jidx = jdist.topk_tile(jq, ji, None, 6, k_tile=4, block_rows=4, fast=True)
    td2, tidx = tdist.topk_tile(tq, ti, None, 6, k_tile=4, fast=True)
    rd2, ridx = _topk_reference(q, items, None, 6)
    assert td2.dtype == tq.dtype
    np.testing.assert_array_equal(_np(td2), np.asarray(jd2))
    np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
    np.testing.assert_array_equal(_np(td2), rd2)
    np.testing.assert_array_equal(_np(tidx), ridx)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [7, 9, 20])
def test_topk_tile_fast_gaussian_matches_jax_kernel(interpret_mode, dtype, n):
    rng = np.random.default_rng(40 + n)
    q, items = rng.normal(size=(5, 6)).astype(dtype), rng.normal(size=(n, 6)).astype(dtype)
    kk = min(4, n)
    (jq, ji), (tq, ti) = _both(q, items)
    jd2, jidx = jdist.topk_tile(jq, ji, None, kk, k_tile=4, block_rows=8, fast=True)
    td2, tidx = tdist.topk_tile(tq, ti, None, kk, k_tile=4, fast=True)
    # separated data: the same neighbors; distances summed in float32 in
    # another order: rtol 1e-5 of their scale
    np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
    scale = np.abs(np.asarray(jd2)).max()
    np.testing.assert_allclose(_np(td2), np.asarray(jd2), rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,k,d", [(33, 5, 8), (17, 9, 13)])
def test_fast_mode_float64_matches_jax_kernels(interpret_mode, integer, n, k, d):
    # float64 inputs in `fast` mode: bf16 products summed in float32, the
    # result in float64, in the argmin and the accumulation alike
    X, C, w = _data(n, k, d, np.float64, seed=n + k, integer=integer)
    (jX, jC, jw), (tX, tC, tw) = _both(X, C, w)
    jm, jb = jdist.assign_argmin(jX, jC, fast=True, block_rows=8, block_k=4)
    tm, tb = tdist.assign_argmin(tX, tC, fast=True)
    js, jc, _ = jdist.assign_accumulate(jX, jw, jC, fast=True, block_rows=8, block_k=4)
    ts, tc, _ = tdist.assign_accumulate(tX, tw, tC, fast=True)
    assert tm.dtype == torch.float64 and ts.dtype == torch.float64
    np.testing.assert_array_equal(_np(tb), _np(jb))
    # counts stay at full precision: float64 sums in another order
    np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-12)
    if integer:
        np.testing.assert_array_equal(_np(tc), _np(jc))
        np.testing.assert_array_equal(_np(tm), _np(jm))
        np.testing.assert_array_equal(_np(ts), _np(js))
    else:
        # float32 sums in another order: rtol 1e-5 of the scale
        np.testing.assert_allclose(_np(tm), _np(jm), rtol=1e-5, atol=1e-5 * np.abs(_np(jm)).max())
        np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-5, atol=1e-5 * np.abs(_np(js)).max())


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8, 130, 3000])
def test_row_sq_fixed_is_a_row_norm_independent_of_the_batch(d):
    x = np.random.default_rng(d).normal(size=(37, d)).astype(np.float32)
    t = torch.from_numpy(x)
    got = tdist.row_sq_fixed(t)
    np.testing.assert_allclose(_np(got), np.sum(x.astype(np.float64) ** 2, 1), rtol=1e-6)
    # each row's norm is the same bits whatever rows it is computed with
    for lo, hi in ((0, 1), (5, 6), (3, 20), (0, 37)):
        assert torch.equal(tdist.row_sq_fixed(t[lo:hi]), got[lo:hi])
    assert tdist.row_sq_fixed(torch.zeros((4, 0))).shape == (4,)


# ------------------------------------------------ dispatch, no fallbacks ----


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty((4, 3), device="meta")
    c = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or all be CUDA"):
        tdist.assign_argmin(x, c)


@pytest.mark.parametrize("fn", ["assign_argmin", "assign_accumulate", "d2_block"])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    x = torch.zeros((4, 3))
    args = {
        "assign_argmin": (x, torch.zeros((2, 3)), torch.zeros(2)),
        "assign_accumulate": (x, torch.ones(4), torch.zeros(4, dtype=torch.int32), 2),
        "d2_block": (x, torch.zeros((2, 3)), torch.zeros(2)),
    }[fn]
    before = _kernels.launch_total(fn)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(_kernels, fn)(*args)
    assert _kernels.launch_total(fn) == before


def test_launch_counters_are_per_kernel_variant():
    # every kernel has the JAX kernels' four forms: f32, f64, and `fast`
    # (bf16 products, float32 sums) on either
    assert set(_kernels.launches) == {
        f"{name}/{v}"
        for name in ("assign_argmin", "assign_accumulate", "d2_block")
        for v in ("f32", "f32-fast", "f64", "f64-fast")
    }


def test_library_name_follows_every_source_it_is_built_from(monkeypatch, tmp_path):
    # an edited shared header must not load a library built before the edit
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels._CSRC, csrc)
    monkeypatch.setattr(_kernels, "_CSRC", csrc)
    before = {n: _kernels._lib_path(n) for n in _kernels.SOURCES}
    header = csrc / "f64_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _kernels._lib_path(n) for n in _kernels.SOURCES}
    assert after["assign_argmin"] != before["assign_argmin"]
    assert after["d2_block"] != before["d2_block"]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_kernels, "_LIBS", {})
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()


# ------------------------------------------- the CUDA kernels, on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,fast", [(np.float32, False), (np.float32, True), (np.float64, False), (np.float64, True)]
)
@pytest.mark.parametrize("n,k,d", [(1000, 1001, 77), (37, 5, 3), (4096, 64, 300)])
def test_kernels_match_plain_versions_on_card(card, dtype, fast, n, k, d):
    # integer-valued data: exact, ties included
    X, C, w = _data(n, k, d, dtype, seed=n + k + d, integer=True)
    x, c, wt = (torch.from_numpy(a).to(card) for a in (X, C, w))
    c_sq = tdist._c_sq(c)
    m1, b1 = _kernels.assign_argmin(x, c, c_sq, fast=fast)
    m0, b0 = tdist.assign_argmin_plain(x, c, c_sq, fast)
    assert torch.equal(b1, b0) and torch.equal(m1, m0)
    s1, n1 = _kernels.assign_accumulate(x, wt, b0, k, fast=fast)
    s2, n2 = _kernels.assign_accumulate(x, wt, b0, k, fast=fast)
    s0, n0 = tdist.accumulate_plain(x, wt, b0, k, fast)
    assert torch.equal(s1, s2) and torch.equal(n1, n2)  # deterministic
    assert torch.equal(s1, s0) and torch.equal(n1, n0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize(
    "B,kt,d",
    [(4095, 16383, 300), (37, 5, 3), (64, 64, 16), (1, 1, 1), (256, 130, 3000)]
    # the serving ladder's rungs against an odd item block at d = 3000
    + [(b, 1001, 3000) for b in (512, 1024, 2048, 4096, 8192)],
)
def test_d2_block_kernel_matches_plain_version_on_card(card, dtype, fast, B, kt, d):
    # integer-valued data: every sum is exact, so the kernel equals the plain version
    rng = np.random.default_rng(B + kt + d)
    q = torch.from_numpy(rng.integers(-4, 5, size=(B, d)).astype(dtype)).to(card)
    xt = torch.from_numpy(rng.integers(-4, 5, size=(kt, d)).astype(dtype)).to(card)
    xt_sq = tdist.row_sq(xt)
    variant = f"d2_block/{'f32' if dtype == np.float32 else 'f64'}{'-fast' if fast else ''}"
    before = _kernels.launches[variant]
    out = _kernels.d2_block(q, xt, xt_sq, fast=fast)
    assert _kernels.launches[variant] == before + 1
    assert torch.equal(out, tdist.d2_block_plain(q, xt, xt_sq, fast))


@pytest.mark.cuda
def test_topk_tile_on_card_matches_cpu(card):
    q, base = _dup_integer_items(6)
    items = np.concatenate([base] * 5)
    _, (tq, ti) = _both(q, items)
    cpu = tdist.topk_tile(tq, ti, None, 9, k_tile=4)
    gpu = tdist.topk_tile(tq.to(card), ti.to(card), None, 9, k_tile=4)
    assert torch.equal(gpu[0].cpu(), cpu[0]) and torch.equal(gpu[1].cpu(), cpu[1])
