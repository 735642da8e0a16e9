#
# The PyTorch port's assign_argmin kernel (csrc/assign_argmin.cu through
# spark_rapids_ml_tpu_torch/ops/_kernels.py), in the parts a CPU can run:
#
#   * the bf16 staging of the `fast` operands (`_kernels.stage_bf16`)
#     against the rounding of the reference's `astype(jnp.bfloat16)`;
#   * the kernel's decomposition: each row's (minimum, first index) over
#     each center tile, then the tiles merged in ascending order with a
#     strict '<', written here in torch, against the JAX package's real
#     `_pl_argmin` run by the Pallas interpreter with `block_k` equal to the
#     tile, on tie-heavy integer data whose repeated centers straddle a tile
#     boundary, and rows holding a NaN;
#   * the wrapper's refusals and its check of the library's tiles.
#
# The `cuda`-marked tests at the end hold the kernel itself to the cross-tile
# tie and to batch independence; they need the card and skip here.
#
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import distance as jdist
from spark_rapids_ml_tpu_torch.ops import _kernels
from spark_rapids_ml_tpu_torch.ops import distance as tdist


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


# ------------------------------------------------------------ staging -------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,d,row_multiple", [(5, 3, 1), (7, 64, 128), (130, 77, 256), (1, 130, 8)])
def test_stage_bf16_rounds_as_jax_and_pads_with_zeros(dtype, n, d, row_multiple):
    rng = np.random.default_rng(n * d)
    a = (rng.standard_normal((n, d)) * 10.0 ** rng.integers(-3, 4, size=(n, d))).astype(dtype)
    a[0, 0] = 1.0 + 2.0 ** -8 + 2.0 ** -30  # rounds to 1.0 through float32, up to 1 + 2^-7 directly
    got = _kernels.stage_bf16(torch.from_numpy(a), row_multiple)
    np_ = -(-n // row_multiple) * row_multiple
    dp = -(-d // 64) * 64
    assert got.dtype == torch.bfloat16 and got.shape == (np_, dp) and got.is_contiguous()
    assert got.stride(0) % 64 == 0
    vals = got[:n, :d].to(torch.float32)
    # the port's own rounding, and the reference's astype(bfloat16) (float64
    # through float32, as the JAX package's kernels see it)
    assert torch.equal(vals, tdist._bf16(torch.from_numpy(a)))
    ref = jnp.asarray(a).astype(jnp.float32).astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref))
    if dtype == np.float64:
        assert float(vals[0, 0]) == 1.0
    assert not got[:n, d:].to(torch.float32).any()
    assert not got[n:].to(torch.float32).any()


# ------------------------------------------- the split decomposition -------


def split_argmin(x, c, c_sq, tile, fast):
    """What the kernel computes, in torch: per center tile the minimum of
    c_sq - 2 x.c and its first index, then the tiles merged in ascending
    order, a later tile taking a row only when strictly smaller."""
    d2 = c_sq[None, :] - 2.0 * tdist._mm(x, c.T, fast)
    mind = best = None
    for t0 in range(0, c.shape[0], tile):
        blk = d2[:, t0:t0 + tile]
        v, j = torch.amin(blk, dim=1), torch.argmin(blk, dim=1).to(torch.int32) + t0
        if mind is None:
            mind, best = v, j
        else:
            take = v < mind
            mind, best = torch.where(take, v, mind), torch.where(take, j, best)
    return mind, best


def _tie_data(n, tile, d, dtype, seed):
    """Integer data with many ties: a block of copies of one center across
    the boundary of center tiles 0 and 1, copies of center 0 in tile 2, rows
    lying on the copied centers, and two rows holding a NaN."""
    rng = np.random.default_rng(seed)
    k = 2 * tile + 37
    X = rng.integers(-2, 3, size=(n, d)).astype(dtype)
    C = rng.integers(-2, 3, size=(k, d)).astype(dtype)
    C[tile - 3:tile + 3] = C[tile - 4]
    C[2 * tile + 1:2 * tile + 4] = C[0]
    X[:4] = C[tile - 4]
    X[4:6] = C[0]
    X[7, 1] = np.nan
    X[n - 1, 0] = np.nan
    return X, C


# 64: the float64 tile width before the DMMA tile, kept as a case
@pytest.mark.parametrize("tile", sorted({4, 64} | {t for _, t in _kernels.ARGMIN_TILE.values()}))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fast", [False, True])
def test_split_decomposition_matches_pallas_kernel(tile, dtype, fast):
    n, d = 21, 6
    X, C = _tie_data(n, tile, d, dtype, seed=tile + d)
    k = C.shape[0]
    tx, tc = torch.from_numpy(X), torch.from_numpy(C)
    c_sq = tdist._c_sq(tc)
    mind, best = split_argmin(tx, tc, c_sq, tile, fast)

    # the JAX package's kernel, rows padded to its 8-row block, centers to
    # whole tiles (padding centers at +inf)
    br = 8
    xp = np.concatenate([X, np.zeros((-n % br, d), dtype)])
    kp = -(-k // tile) * tile
    cp = np.concatenate([C, np.zeros((kp - k, d), dtype)])
    csq_p = np.concatenate([c_sq.numpy(), np.full(kp - k, np.inf, dtype)])
    jm, jb = jdist._pl_argmin(
        jnp.asarray(xp), jnp.asarray(cp), jnp.asarray(csq_p),
        block_rows=br, block_k=tile, fast=fast, interpret=True,
    )
    np.testing.assert_array_equal(best.numpy(), np.asarray(jb)[:n])
    np.testing.assert_array_equal(mind.numpy(), np.asarray(jm)[:n])  # NaN rows equal as NaN
    assert torch.isnan(mind[[7, n - 1]]).all() and (best[[7, n - 1]] == 0).all()
    # the copies straddling the tile boundary: the first copy wins
    assert (best[:4] == tile - 4).all() and (best[4:6] == 0).all()
    # and the plain version over the whole row agrees
    pm, pb = tdist.assign_argmin_plain(tx, tc, c_sq, fast)
    assert torch.equal(pb, best)
    np.testing.assert_array_equal(pm.numpy(), mind.numpy())


# ------------------------------------------------- the wrapper's checks -----


def test_wrapper_refuses_mixed_dtypes_and_other_types():
    x = torch.zeros((4, 3))
    c = torch.zeros((2, 3), dtype=torch.float64)
    before = _kernels.launch_total("assign_argmin")
    with pytest.raises(ValueError, match="share a dtype"):
        _kernels.assign_argmin(x, c, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="share a dtype"):
        _kernels.assign_argmin(x, c.float(), torch.zeros(2, dtype=torch.float64), fast=True)
    with pytest.raises(ValueError, match="float32 or float64"):
        _kernels.assign_argmin(x.half(), c.half(), torch.zeros(2).half())
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.assign_argmin(x, c.float(), torch.zeros(2), fast=True)
    # 2^23 row tiles x 313 center tiles of 128: a grid past int32
    xb = torch.empty((2**30, 1), dtype=torch.float64, device="meta")
    cb = torch.empty((40000, 1), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="fit int32"):
        _kernels.assign_argmin(xb, cb, torch.empty(40000, dtype=torch.float64, device="meta"))
    assert _kernels.launch_total("assign_argmin") == before


def _fake_lib(values):
    return types.SimpleNamespace(srml_argmin_config=lambda i: values[i])


def _check_argmin_config(lib):
    _kernels._check_config("assign_argmin", lib.srml_argmin_config, _kernels.ARGMIN_TILE)


def test_library_tiles_must_match_the_wrapper():
    good = [128, 128, 128, 128, 128, 256, 64, 197696, 221184, 4]
    _check_argmin_config(_fake_lib(good))
    for i in (*range(7), 9):  # the tiles, the `fast` depth, the float64 DMMA step
        bad = list(good)
        bad[i] *= 2
        with pytest.raises(RuntimeError, match="disagree"):
            _check_argmin_config(_fake_lib(bad))


# ------------------------------------------- the CUDA kernel, on the card ----


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(_kernels.ARGMIN_TILE))
@pytest.mark.parametrize("integer", [True, False])
def test_kernel_cross_tile_tie_on_card(card, variant, integer):
    tile = _kernels.ARGMIN_TILE[variant][1]
    dtype = np.float64 if variant.startswith("f64") else np.float32
    fast = variant.endswith("fast")
    X, C = _tie_data(300, tile, 130, dtype, seed=3)
    if not integer:
        rng = np.random.default_rng(4)
        X = X + (0.01 * rng.standard_normal(X.shape)).astype(dtype)
    x, c = torch.from_numpy(X).to(card), torch.from_numpy(C).to(card)
    c_sq = tdist._c_sq(c)
    before = _kernels.launches[f"assign_argmin/{variant}"]
    m1, b1 = _kernels.assign_argmin(x, c, c_sq, fast=fast)
    assert _kernels.launches[f"assign_argmin/{variant}"] == before + 1  # one count per call
    m0, b0 = tdist.assign_argmin_plain(x, c, c_sq, fast)
    assert (b1[:4] == tile - 4).all() and (b1[4:6] == 0).all()
    assert torch.isnan(m1[[7, 299]]).all() and (b1[[7, 299]] == 0).all()  # NaN first
    if integer:
        assert torch.equal(b1, b0)
        torch.testing.assert_close(m1, m0, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_kernel_batch_independence_on_card(card, fast):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((4096, 300)).astype(np.float32)).to(card)
    c = torch.from_numpy(rng.standard_normal((1000, 300)).astype(np.float32)).to(card)
    c_sq = tdist._c_sq(c)
    m_full, b_full = _kernels.assign_argmin(x, c, c_sq, fast=fast)
    for B, a in ((1, 5), (7, 130), (255, 1), (1000, 2345), (2000, 2096)):
        m, b = _kernels.assign_argmin(x[a:a + B], c, c_sq, fast=fast)
        assert torch.equal(m, m_full[a:a + B]) and torch.equal(b, b_full[a:a + B])
