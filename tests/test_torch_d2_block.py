#
# The PyTorch port's d2_block kernel (csrc/d2_block.cu through
# spark_rapids_ml_tpu_torch/ops/_kernels.py), in the parts a CPU can run:
#
#   * the `fast` operand layout: q staged as bf16 in whole 128-row query
#     tiles, the item block in whole 256-row item tiles, the depth padded
#     with zeros to a multiple of 64 (`_kernels.stage_bf16`);
#   * the product the kernel takes on that layout (bf16 operands, float32
#     sums over the padded depth, the padded rows sliced away, the epilogue
#     xt_sq - 2 dot in the inputs' dtype), written here in torch, against
#     the port's plain version and the JAX package's real `_pl_d2_block`
#     run by the Pallas interpreter: exact on integer data, rtol 1e-5 of
#     the block's scale on Gaussian data (float32 sums in another order);
#   * the wrapper's refusals and its check of the library's tiles.
#
# The `cuda`-marked tests at the end hold the kernel itself to batch
# independence, to the library's tiles and to a NaN query row; they need the
# card and skip here.
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
            "(their staged layout is held against JAX above)"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, kt, d, dtype, integer, seed):
    rng = np.random.default_rng(seed)
    if integer:  # |v| <= 4: exact in bf16, every sum exact in float32
        q = rng.integers(-4, 5, size=(B, d)).astype(dtype)
        xt = rng.integers(-4, 5, size=(kt, d)).astype(dtype)
    else:
        q = rng.normal(size=(B, d)).astype(dtype)
        xt = rng.normal(size=(kt, d)).astype(dtype)
    return q, xt, np.sum(xt * xt, 1).astype(dtype)


# ------------------------------------------------------------ staging -------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("variant_rows", [0, 1])  # the query tile, then the item tile
@pytest.mark.parametrize("n,d", [(1, 1), (127, 64), (128, 65), (257, 3000), (300, 130)])
def test_stage_bf16_pads_to_whole_d2_tiles(dtype, variant_rows, n, d):
    rows = _kernels.D2_TILE["f32-fast"][variant_rows]
    a = np.random.default_rng(n + d).normal(size=(n, d)).astype(dtype)
    got = _kernels.stage_bf16(torch.from_numpy(a), rows)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == (-(-n // rows) * rows, -(-d // _kernels.STAGE_DEPTH) * _kernels.STAGE_DEPTH)
    # each row of the staged buffer is a whole number of 128-byte TMA rows
    assert got.shape[0] % rows == 0 and (got.shape[1] * 2) % 128 == 0
    np.testing.assert_array_equal(got[:n, :d].to(torch.float32).numpy(),
                                  tdist._bf16(torch.from_numpy(a)).numpy())
    assert not got[:n, d:].to(torch.float32).any() and not got[n:].to(torch.float32).any()


# ------------------------------------------- the staged product -------------


def staged_d2_block(q, xt, xt_sq):
    """What the `fast` kernel computes, in torch: both operands staged as
    bf16 in whole tiles, the product of the padded buffers with float32
    sums, the padding sliced away, then xt_sq - 2 dot in the inputs' dtype."""
    rows, cols = _kernels.D2_TILE["f32-fast"]
    qs, xs = _kernels.stage_bf16(q, rows), _kernels.stage_bf16(xt, cols)
    acc = qs.to(torch.float32) @ xs.to(torch.float32).T
    B, kt = q.shape[0], xt.shape[0]
    return xt_sq[None, :] - 2.0 * acc[:B, :kt].to(q.dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("B,kt,d", [(13, 11, 7), (1, 1, 1), (129, 257, 65), (33, 300, 130), (8, 5, 3000)])
def test_staged_product_matches_plain_version_and_pallas_kernel(dtype, integer, B, kt, d):
    q, xt, xt_sq = _inputs(B, kt, d, dtype, integer, seed=B + kt + d)
    tq, txt, tsq = (torch.from_numpy(a) for a in (q, xt, xt_sq))
    got = staged_d2_block(tq, txt, tsq)
    plain = tdist.d2_block_plain(tq, txt, tsq, fast=True)
    qp = np.concatenate([q, np.zeros((-B % 8, d), dtype)])  # the JAX kernel's row blocks of 8
    jout = np.asarray(jdist._pl_d2_block(
        jnp.asarray(qp), jnp.asarray(xt), jnp.asarray(xt_sq), block_rows=8, fast=True, interpret=True,
    ))[:B]
    assert got.dtype == tq.dtype and got.shape == (B, kt)
    if integer:  # every sum exact: the zeros of the padding add nothing
        assert torch.equal(got, plain)
        np.testing.assert_array_equal(got.numpy(), jout)
    else:
        # the same bf16 operands and exact products, summed in float32 in
        # another order: rtol 1e-5 of the block's scale
        scale = np.abs(jout).max()
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(got.numpy(), jout, rtol=1e-5, atol=1e-5 * scale)


# ------------------------------------------------- the wrapper's checks -----


def test_wrapper_refuses_mixed_dtypes_cpu_tensors_and_wrong_ranks():
    q, xt, sq = torch.zeros((4, 3)), torch.zeros((2, 3)), torch.zeros(2)
    before = _kernels.launch_total("d2_block")
    with pytest.raises(ValueError, match="share a dtype"):
        _kernels.d2_block(q, xt.double(), sq)
    with pytest.raises(ValueError, match="share a dtype"):
        _kernels.d2_block(q, xt, sq.double(), fast=True)
    with pytest.raises(ValueError, match="float32 or float64"):
        _kernels.d2_block(q.half(), xt.half(), sq.half())
    with pytest.raises(ValueError, match=r"q \[B,d\]"):
        _kernels.d2_block(q[None], xt, sq)
    with pytest.raises(ValueError, match=r"q \[B,d\]"):
        _kernels.d2_block(q, xt, sq[None])
    with pytest.raises(ValueError, match="disagree"):
        _kernels.d2_block(q, torch.zeros((2, 4)), sq)
    with pytest.raises(ValueError, match="kt > 0"):
        _kernels.d2_block(q, torch.zeros((0, 3)), torch.zeros(0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.d2_block(q, xt, sq, fast=True)
    # 2^23 query tiles x 2^8 item tiles of the fast form: a grid past int32
    qb = torch.empty((2**30, 1), device="meta")
    xb = torch.empty((2**16, 1), device="meta")
    with pytest.raises(ValueError, match="fit int32"):
        _kernels.d2_block(qb, xb, torch.empty(2**16, device="meta"), fast=True)
    assert _kernels.launch_total("d2_block") == before


def test_library_tiles_must_match_the_d2_wrapper():
    good = [128, 128, 128, 128, 128, 256, 64, 197696, 221184, 4]
    lib = types.SimpleNamespace(srml_d2_config=lambda i: good[i])
    _kernels._check_config("d2_block", lib.srml_d2_config, _kernels.D2_TILE)
    assert _kernels.library_tiles(lib.srml_d2_config) == (_kernels.D2_TILE, _kernels.STAGE_DEPTH)
    for i in (*range(7), 9):  # the tiles, the `fast` depth, the float64 DMMA step
        bad = list(good)
        bad[i] *= 2
        with pytest.raises(RuntimeError, match="d2_block library tiles"):
            _kernels._check_config("d2_block", lambda j, b=bad: b[j], _kernels.D2_TILE)


# ------------------------------------------- the CUDA kernel, on the card ----


@pytest.mark.cuda
def test_library_tiles_on_card_equal_the_wrappers(card):
    _kernels.build()
    for name, fn, expected in (("d2_block", "srml_d2_config", _kernels.D2_TILE),
                               ("assign_argmin", "srml_argmin_config", _kernels.ARGMIN_TILE)):
        config = getattr(_kernels._lib(name), fn)
        assert _kernels.library_tiles(config) == (expected, _kernels.STAGE_DEPTH)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_d2_block_rows_do_not_depend_on_their_batch_on_card(card, fast):
    # rows sent as batches of 1 to 8192 equal the same rows of one
    # 8192-row call bit for bit (Gaussian data, an odd item count, d = 3000)
    q, xt, xt_sq = (torch.from_numpy(a).to(card)
                    for a in _inputs(8192, 1001, 3000, np.float32, False, seed=5))
    full = _kernels.d2_block(q, xt, xt_sq, fast=fast)
    for B, lo in ((1, 5), (7, 130), (255, 1), (4096, 2345), (8192, 0)):
        assert torch.equal(_kernels.d2_block(q[lo:lo + B], xt, xt_sq, fast=fast), full[lo:lo + B])


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("k_tile", [300, 64])
def test_topk_tile_nan_query_row_on_card_matches_cpu(card, fast, k_tile):
    rng = np.random.default_rng(1)
    items = rng.normal(size=(300, 8)).astype(np.float32)
    q = rng.normal(size=(4, 8)).astype(np.float32)
    q[1] = np.nan
    tq, ti = torch.from_numpy(q), torch.from_numpy(items)
    cpu_d2, cpu_i = tdist.topk_tile(tq, ti, None, 10, k_tile=k_tile, fast=fast)
    gpu_d2, gpu_i = tdist.topk_tile(tq.to(card), ti.to(card), None, 10, k_tile=k_tile, fast=fast)
    assert torch.equal(gpu_i.cpu(), cpu_i)
    # finite distances summed in another order: rtol 1e-5 of their scale
    scale = float(cpu_d2[torch.isfinite(cpu_d2)].abs().max())
    torch.testing.assert_close(gpu_d2.cpu(), cpu_d2, rtol=1e-5, atol=1e-5 * scale, equal_nan=True)
