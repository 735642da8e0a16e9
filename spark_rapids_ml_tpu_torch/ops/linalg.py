#
# Dense linear-algebra primitives shared by PCA and the linear models: the
# weighted mean, variance and covariance, the symmetric eigensolve (top-k,
# descending) with eigenvector sign canonicalization, and the batch-
# independent row products their transforms run. The PyTorch counterpart
# of spark_rapids_ml_tpu/ops/linalg.py, on one device: the contractions go
# to cuBLAS and `eigh` to cuSOLVER through torch (the JAX package leaves
# them to XLA; no Pallas kernel is involved). In a multi-process fit the
# row sums of `weighted_cov` and `global_moments` are summed across ranks
# (parallel/context.allreduce_fixed; the identity on one process).
#
# Two differences in form, none in math:
#
#   * the centered covariance (and ops/linear.py's gram) is accumulated over
#     row tiles of `STATS_TILE_ROWS` rows, so the workspace is one tile, not
#     a centered copy of X (at 1M x 3000 float32 that copy is 12 GB, and the
#     JAX form makes two); only the summation order differs from the one
#     contraction the JAX package writes;
#   * `fast` (solver_precision="bf16") rounds both operands of the big
#     contraction to bf16 and accumulates in float32, as the JAX package's
#     `einsum(bf16, bf16, preferred_element_type=float32)` does. On the card
#     that is cuBLAS's bf16 GEMM with a float32 output
#     (`torch.mm(..., out_dtype=torch.float32)`); the CPU, which has no such
#     GEMM, multiplies the bf16-rounded operands in float32 (exact products,
#     float32 sums).
#
from __future__ import annotations

from typing import Tuple

import torch

from ..parallel.context import allreduce_fixed
from .distance import _bf16, fixed_sum

# Rows per tile of the statistics passes (the Lloyd tile of ops/kmeans.py):
# 393 MB of float32 at d = 3000. Read at each call.
STATS_TILE_ROWS = 32768

# Elements of one [rows, k, d] product block of `rows_dot_fixed` (64 MB of
# float32): the block and its first halving are the transform's workspace.
DOT_BLOCK_ELEMS = 1 << 24

def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to bf16 and float32 accumulation;
    the result is float32 whatever the inputs' dtype."""
    if a.device.type == "cuda":
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16), out_dtype=torch.float32)
    return _bf16(a) @ _bf16(b)


def row_tiles(n: int):
    """Row slices of `STATS_TILE_ROWS` rows covering [0, n)."""
    return [slice(lo, lo + STATS_TILE_ROWS) for lo in range(0, n, STATS_TILE_ROWS)]


def weighted_sums(X: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Σw, Σw·x [d], Σw·x² [d]): the raw weighted moments, the squares
    summed over row tiles. The streaming solvers sum them over row chunks
    (ops/streaming.py)."""
    sq = torch.zeros((X.shape[1],), dtype=X.dtype, device=X.device)
    for rows in row_tiles(X.shape[0]):
        xt = X[rows]
        sq += w[rows] @ (xt * xt)
    return torch.sum(w), w @ X, sq


def weighted_moments(X: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total_weight, mean [d], var [d]); zero-weight rows count for
    nothing. The squares are summed over row tiles."""
    return moments_from_sums(*weighted_sums(X, w))


def global_moments(X: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`weighted_moments` over the rows of every rank: the raw sums are
    summed across ranks first (one collective in a multi-process fit)."""
    return moments_from_sums(*allreduce_fixed(*weighted_sums(X, w)))


def moments_from_sums(total_w: torch.Tensor, sx: torch.Tensor, sq: torch.Tensor):
    """(total_weight, mean, var) from the raw sums of `weighted_sums`,
    taken over all rows at once or summed over streamed chunks."""
    mean = sx / total_w
    var = torch.clamp_min(sq / total_w - mean * mean, 0.0)
    return total_w, mean, var


def centered_gram(X: torch.Tensor, w: torch.Tensor, mean: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """Σ w (x-μ)(x-μ)ᵀ [d, d] over row tiles, float32 when `fast` (the
    operands rounded to bf16, `mm_bf16`; the weighting and the centering at
    full precision), else at X's dtype."""
    d = X.shape[1]
    acc = torch.zeros((d, d), dtype=torch.float32 if fast else X.dtype, device=X.device)
    for rows in row_tiles(X.shape[0]):
        xc = X[rows] - mean
        xcw = xc * w[rows, None]
        if fast:
            acc += mm_bf16(xcw.T, xc)
        else:
            acc.addmm_(xcw.T, xc)
    return acc


def weighted_cov(
    X: torch.Tensor, w: torch.Tensor, ddof: int = 1, fast: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted covariance: (total_weight, mean [d], cov [d, d]) with
    ``cov = Σ w_i (x_i-μ)(x_i-μ)ᵀ / (Σw - ddof)`` (cuML's and the JAX
    package's sample covariance).

    The mean comes first (one `w @ X`); the centered contraction then runs
    over row tiles (`centered_gram`). ``fast`` rounds the operands of that
    contraction to bf16 and sums in float32 (`mm_bf16`); the weighting and
    the centering stay at full precision, as in the JAX package. In a
    multi-process fit Σw and Σw·x are summed across ranks before the mean,
    and the centered gram before the division, so every rank holds the
    global covariance."""
    total_w, sx = allreduce_fixed(torch.sum(w), w @ X)
    mean = sx / total_w
    (gram,) = allreduce_fixed(centered_gram(X, w, mean, fast))
    cov = gram.to(X.dtype) / (total_w - ddof)
    return total_w, mean, cov


def sign_flip(components: torch.Tensor) -> torch.Tensor:
    """Canonicalize eigenvector signs: the max-|value| element of each
    component row is made positive (ties in |value| go to the first index,
    as `jnp.argmax` picks; a zero row keeps sign +1)."""
    idx = torch.argmax(torch.abs(components), dim=1)
    signs = torch.sign(components[torch.arange(components.shape[0], device=components.device), idx])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return components * signs[:, None]


def topk_eigh_desc(sym: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full symmetric eigendecomposition, top-k in descending eigenvalue
    order: (eigvals [k], eigvecs [k, d]). `torch.linalg.eigh` is ascending,
    as LAPACK is; values and vectors are both reversed."""
    evals, evecs = torch.linalg.eigh(sym)  # ascending
    return torch.flip(evals, (0,))[:k], torch.flip(evecs.T, (0,))[:k]


def rows_dot_fixed(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """X @ Mᵀ ([n, d] x [k, d] -> [n, k]) with every dot product summed in
    an order fixed by d alone (`distance.fixed_sum`), so a row's answer is
    the same bits whatever batch it arrives in (the serving plane's
    coalesced = solo contract; a GEMM may change its split with the row
    count). Runs over row blocks of at most `DOT_BLOCK_ELEMS` products."""
    n, d = X.shape
    k = M.shape[0]
    if n == 0 or k == 0:
        return X.new_zeros((n, k))
    step = rows_dot_block_rows(k, d)
    return torch.cat(
        [fixed_sum(X[lo:lo + step, None, :] * M[None, :, :]) for lo in range(0, n, step)], dim=0
    )


def rows_dot_block_rows(k: int, d: int) -> int:
    """Rows of one `rows_dot_fixed` product block at k outputs of width d."""
    return max(1, DOT_BLOCK_ELEMS // max(1, k * d))
