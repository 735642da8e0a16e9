#
# The float64 forms of the port's assign_argmin and d2_block kernels, which
# share the FP64 tensor-core (DMMA) tile of csrc/f64_tile.cuh, in the parts a
# CPU can run:
#
#   * a model of the tile's decomposition in torch (`tile_dots`): the
#     outputs cut into CTA tiles of `_kernels.D2_TILE["f64"]` /
#     `ARGMIN_TILE["f64"]`, both operands zero-filled past their rows and,
#     in depth, to whole DMMA steps of `_kernels.F64_STEP` products, each
#     output summed in ascending steps, every step's products in ascending
#     order; for assign_argmin each row's (minimum, first index) over each
#     center tile, then the tiles merged in ascending order by the kernel's
#     rule (NaN first, then the smaller value, then the lower index);
#   * the model and the port's plain float64 versions held against the JAX
#     package's `_pl_argmin` and `_pl_d2_block` in float64, run by the
#     Pallas interpreter: exactly on integer data (every sum is exact), and
#     on seeded Gaussian data within the float64 summation bound
#     4 d 2^-53 max||a|| max||b|| (plus one rounding of the result, 2^-52 of
#     its scale), with the nearest center equal wherever the two nearest
#     lie further apart than twice that bound; at ragged shapes and odd
#     depths; with a repeated center straddling the boundary of the tile's
#     center tiles (the first copy wins); and the model's rows independent
#     of their batch, bit for bit.
#
# The `cuda`-marked tests at the end hold the kernels themselves to their
# plain versions; they need the card and skip here.
#
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import distance as jdist
from spark_rapids_ml_tpu_torch.ops import _kernels
from spark_rapids_ml_tpu_torch.ops import distance as tdist

# (rows, centers or items, depth): ragged against the 128 x 128 tile, odd
# depths among them
SHAPES = [(37, 5, 3), (1000, 1001, 77), (333, 64, 1000), (300, 300, 301)]


@pytest.fixture
def card():
    """A CUDA device for the kernel tests; skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU form "
            "(their decomposition is held against JAX above)"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------- the tile, modelled ----


def tile_dots(a, b, tile):
    """a [na, d] . b [nb, d]^T as the float64 tile sums it (module note)."""
    bm, bn = tile
    step = _kernels.F64_STEP
    na, d = a.shape
    nb = b.shape[0]
    dp = -(-d // step) * step
    out = torch.empty((na, nb), dtype=torch.float64)
    for m0 in range(0, na, bm):
        at = torch.zeros((bm, dp), dtype=torch.float64)
        at[:min(bm, na - m0), :d] = a[m0:m0 + bm]
        for n0 in range(0, nb, bn):
            bt = torch.zeros((bn, dp), dtype=torch.float64)
            bt[:min(bn, nb - n0), :d] = b[n0:n0 + bn]
            acc = torch.zeros((bm, bn), dtype=torch.float64)
            for k0 in range(0, dp, step):  # ascending DMMA steps
                for k in range(k0, k0 + step):
                    acc = acc + at[:, k, None] * bt[None, :, k]
            out[m0:m0 + bm, n0:n0 + bn] = acc[:min(bm, na - m0), :min(bn, nb - n0)]
    return out


def _take(v, j, bv, bj):
    """The kernel's rule: candidate (v, j) replaces (bv, bj) when it is NaN
    and bv is not, or both are numbers and v is smaller or equal at a lower
    index (or both NaN at a lower index)."""
    v_nan, b_nan = torch.isnan(v), torch.isnan(bv)
    lower = j < bj
    return torch.where(v_nan != b_nan, v_nan, torch.where(v_nan, lower, (v < bv) | ((v == bv) & lower)))


def tile_argmin(x, c, c_sq):
    """assign_argmin's float64 form, modelled: per center tile of the
    tile's width the first minimum of c_sq - 2 x.c, then the tiles merged
    in ascending order by `_take`."""
    tile = _kernels.ARGMIN_TILE["f64"]
    d2 = c_sq[None, :] - 2.0 * tile_dots(x, c, tile)
    mind = best = None
    for t0 in range(0, c.shape[0], tile[1]):
        blk = d2[:, t0:t0 + tile[1]]
        # the first NaN, else the first minimum, of each row of the tile
        has_nan = torch.isnan(blk).any(dim=1)
        first_nan = torch.isnan(blk).to(torch.int8).argmax(dim=1)
        j = torch.where(has_nan, first_nan, torch.argmin(torch.nan_to_num(blk, nan=np.inf), dim=1))
        v = blk.gather(1, j[:, None])[:, 0]
        j = (j + t0).to(torch.int32)
        if mind is None:
            mind, best = v, j
        else:
            take = _take(v, j, mind, best)
            mind, best = torch.where(take, v, mind), torch.where(take, j, best)
    return mind, best


def tile_d2(q, xt, xt_sq):
    """d2_block's float64 form, modelled: xt_sq - 2 q.xt over the tile."""
    return xt_sq[None, :] - 2.0 * tile_dots(q, xt, _kernels.D2_TILE["f64"])


# ------------------------------------------------------------- helpers ----


def _data(n, k, d, integer, seed):
    rng = np.random.default_rng(seed)
    if integer:  # every product and sum exact in float64
        a = rng.integers(-4, 5, size=(n, d)).astype(np.float64)
        b = rng.integers(-4, 5, size=(k, d)).astype(np.float64)
        b[k // 2] = b[0]  # a repeated center: the first copy must win its ties
    else:
        a = rng.standard_normal((n, d))
        b = rng.standard_normal((k, d))
    return a, b


def f64_bound(d, a, b, scale):
    """How far two float64 computations of c_sq - 2 a.b (sums of the same
    d products in any order) may lie apart: 4 d 2^-53 max||a|| max||b||,
    plus one rounding of each result up to `scale`."""
    norms = float(np.linalg.norm(a, axis=1).max() * np.linalg.norm(b, axis=1).max())
    return 4 * d * 2.0 ** -53 * norms + 2.0 ** -52 * scale


def _pallas_argmin(x, c, c_sq):
    """The JAX package's kernel in float64 through the interpreter, rows
    padded to its 128-row blocks, centers to whole 128-center blocks (the
    padding centers at +inf)."""
    n, d = x.shape
    k = c.shape[0]
    br = bk = 128
    xp = np.concatenate([x, np.zeros((-n % br, d))])
    kp = -(-k // bk) * bk
    cp = np.concatenate([c, np.zeros((kp - k, d))])
    csq = np.concatenate([c_sq, np.full(kp - k, np.inf)])
    jm, jb = jdist._pl_argmin(jnp.asarray(xp), jnp.asarray(cp), jnp.asarray(csq),
                              block_rows=br, block_k=bk, fast=False, interpret=True)
    return np.asarray(jm)[:n], np.asarray(jb)[:n]


def _pallas_d2(q, xt, xt_sq):
    B, d = q.shape
    qp = np.concatenate([q, np.zeros((-B % 128, d))])
    return np.asarray(jdist._pl_d2_block(jnp.asarray(qp), jnp.asarray(xt), jnp.asarray(xt_sq),
                                         block_rows=128, fast=False, interpret=True))[:B]


# ----------------------------------------------- the model against JAX ----


def test_the_model_is_built_from_the_wrappers_tables():
    assert _kernels.ARGMIN_TILE["f64"] == _kernels.D2_TILE["f64"] == (128, 128)
    assert _kernels.F64_STEP == 4  # the depth of an m16n8k4 DMMA step


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,k,d", SHAPES)
def test_argmin_model_and_plain_match_pallas_kernel_f64(n, k, d, integer):
    X, C = _data(n, k, d, integer, seed=n + k + d)
    tx, tc = torch.from_numpy(X), torch.from_numpy(C)
    c_sq = tdist._c_sq(tc)
    jm, jb = _pallas_argmin(X, C, c_sq.numpy())
    mm, mb = tile_argmin(tx, tc, c_sq)
    pm, pb = tdist.assign_argmin_plain(tx, tc, c_sq)
    if integer:
        for m, b in ((mm, mb), (pm, pb)):
            np.testing.assert_array_equal(b.numpy(), jb)
            np.testing.assert_array_equal(m.numpy(), jm)
        assert not (mb == k // 2).any()  # the repeated center never beats its first copy
    else:
        d2 = c_sq.numpy()[None, :] - 2.0 * (X @ C.T)
        tol = f64_bound(d, X, C, np.abs(d2).max())
        two = np.sort(d2, axis=1)[:, :2]
        clear = (two[:, 1] - two[:, 0]) > 2 * tol
        for m, b in ((mm, mb), (pm, pb)):
            assert np.abs(m.numpy() - jm).max() <= tol
            np.testing.assert_array_equal(b.numpy()[clear], jb[clear])


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("B,kt,d", SHAPES)
def test_d2_block_model_and_plain_match_pallas_kernel_f64(B, kt, d, integer):
    Q, XT = _data(B, kt, d, integer, seed=B * kt + d)
    tq, txt = torch.from_numpy(Q), torch.from_numpy(XT)
    xt_sq = tdist.row_sq(txt)
    jout = _pallas_d2(Q, XT, xt_sq.numpy())
    for out in (tile_d2(tq, txt, xt_sq), tdist.d2_block_plain(tq, txt, xt_sq)):
        assert out.dtype == torch.float64 and out.shape == (B, kt)
        if integer:
            np.testing.assert_array_equal(out.numpy(), jout)
        else:
            assert np.abs(out.numpy() - jout).max() <= f64_bound(d, Q, XT, np.abs(jout).max())


@pytest.mark.parametrize("integer", [True, False])
def test_repeated_center_across_the_center_tile_boundary_f64(integer):
    # copies of center tile - 4 fill tile - 3 .. tile + 3, across the
    # boundary of center tiles 0 and 1; rows lying on it must take the
    # first copy, in the model, the plain version and the JAX kernel
    tile = _kernels.ARGMIN_TILE["f64"][1]
    X, C = _data(200, 2 * tile + 37, 130, True, seed=tile)
    C[tile - 3:tile + 4] = C[tile - 4]
    X[:16] = C[tile - 4]
    if not integer:
        rng = np.random.default_rng(1)
        C = C + 1e-3 * rng.standard_normal(C.shape)
        C[tile - 3:tile + 4] = C[tile - 4]
        X[:16] = C[tile - 4] + 1e-3 * rng.standard_normal((16, X.shape[1]))
    tx, tc = torch.from_numpy(X), torch.from_numpy(C)
    c_sq = tdist._c_sq(tc)
    _, jb = _pallas_argmin(X, C, c_sq.numpy())
    _, mb = tile_argmin(tx, tc, c_sq)
    _, pb = tdist.assign_argmin_plain(tx, tc, c_sq)
    for b in (jb, mb.numpy(), pb.numpy()):
        assert (b[:16] == tile - 4).all()
    np.testing.assert_array_equal(mb.numpy(), jb)


def test_nan_rows_take_the_first_center_in_the_model():
    X, C = _data(40, 300, 9, True, seed=3)
    X[7, 2] = np.nan
    tx, tc = torch.from_numpy(X), torch.from_numpy(C)
    c_sq = tdist._c_sq(tc)
    jm, jb = _pallas_argmin(X, C, c_sq.numpy())
    mm, mb = tile_argmin(tx, tc, c_sq)
    assert torch.isnan(mm[7]) and mb[7] == 0 and jb[7] == 0
    np.testing.assert_array_equal(mb.numpy(), jb)
    np.testing.assert_array_equal(mm.numpy(), jm)


@pytest.mark.parametrize("kernel", ["assign_argmin", "d2_block"])
def test_the_models_rows_do_not_depend_on_their_batch(kernel):
    # rows sent as slices equal the same rows of the whole call bit for bit:
    # the tile, its depth steps and their order depend on d alone
    X, C = _data(600, 300, 77, False, seed=11)
    tx, tc = torch.from_numpy(X), torch.from_numpy(C)
    sq = tdist.row_sq(tc)
    run = (lambda x: tile_argmin(x, tc, sq)) if kernel == "assign_argmin" else (lambda x: (tile_d2(x, tc, sq),))
    whole = run(tx)
    for B, lo in ((1, 5), (7, 130), (255, 1), (128, 300), (600, 0)):
        for part, full in zip(run(tx[lo:lo + B]), whole):
            assert torch.equal(part, full[lo:lo + B])


# -------------------------------------------- the CUDA kernels, on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,k,d", SHAPES + [(4096, 1000, 3000)])
def test_f64_kernels_match_plain_versions_on_card(card, n, k, d, integer):
    X, C = _data(n, k, d, integer, seed=n + k + d)
    x, c = torch.from_numpy(X).to(card), torch.from_numpy(C).to(card)
    c_sq = tdist._c_sq(c)
    before = dict(_kernels.launches)
    m1, b1 = _kernels.assign_argmin(x, c, c_sq)
    out1 = _kernels.d2_block(x, c, c_sq)
    assert _kernels.launches["assign_argmin/f64"] == before["assign_argmin/f64"] + 1
    assert _kernels.launches["d2_block/f64"] == before["d2_block/f64"] + 1
    m0, b0 = tdist.assign_argmin_plain(x, c, c_sq)
    out0 = tdist.d2_block_plain(x, c, c_sq)
    if integer:
        assert torch.equal(b1, b0) and torch.equal(m1, m0) and torch.equal(out1, out0)
    else:
        d2 = out0.cpu().numpy()
        tol = f64_bound(d, X, C, np.abs(d2).max())
        two = np.sort(d2, axis=1)[:, :2]
        clear = torch.from_numpy((two[:, 1] - two[:, 0]) > 2 * tol).to(card)
        assert (m1 - m0).abs().max().item() <= tol
        assert not ((b1 != b0) & clear).any()
        assert (out1 - out0).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_f64_rows_do_not_depend_on_their_batch_on_card(card, fast):
    X, C = _data(4096, 1000, 300, False, seed=8)
    x, c = torch.from_numpy(X).to(card), torch.from_numpy(C).to(card)
    c_sq = tdist._c_sq(c)
    m_full, b_full = _kernels.assign_argmin(x, c, c_sq, fast=fast)
    d_full = _kernels.d2_block(x, c, c_sq, fast=fast)
    for B, lo in ((1, 5), (7, 130), (255, 1), (1000, 2345), (2000, 2096)):
        m, b = _kernels.assign_argmin(x[lo:lo + B], c, c_sq, fast=fast)
        assert torch.equal(m, m_full[lo:lo + B]) and torch.equal(b, b_full[lo:lo + B])
        assert torch.equal(_kernels.d2_block(x[lo:lo + B], c, c_sq, fast=fast), d_full[lo:lo + B])


@pytest.mark.cuda
def test_f64_kernel_takes_the_first_copy_across_the_center_tile_boundary_on_card(card):
    tile = _kernels.ARGMIN_TILE["f64"][1]
    X, C = _data(200, 2 * tile + 37, 130, True, seed=tile)
    C[tile - 3:tile + 4] = C[tile - 4]
    X[:16] = C[tile - 4]
    x, c = torch.from_numpy(X).to(card), torch.from_numpy(C).to(card)
    _, b = _kernels.assign_argmin(x, c, tdist._c_sq(c))
    assert (b[:16] == tile - 4).all()
    _, b_model = tile_argmin(torch.from_numpy(X), torch.from_numpy(C), tdist._c_sq(torch.from_numpy(C)))
    assert torch.equal(b.cpu(), b_model)
