#
# Linear regression solvers on one device: the PyTorch counterpart of
# spark_rapids_ml_tpu/ops/linear.py (`_sufficient_stats`, `_cd_elastic_net`,
# `_solve_from_stats`, `linear_fit`, `linear_predict`).
#
# Every solve runs ONE pass over the rows for the normal-equation
# sufficient statistics (XᵀWX gram, XᵀWy, weighted sums; the gram over row
# tiles, see ops/linalg.py), then solves on the d x d statistics:
#   * reg = 0        -> weighted OLS (a jitter of 1e-10 · trace/d),
#   * l1 = 0, reg > 0 -> ridge with alpha scaled by Σw (Spark's
#                       1/(2n)·RSS + λ/2‖b‖² ⇔ RSS + nλ‖b‖²),
#   * l1 > 0         -> coordinate descent on the gram, incremental q = A·b,
#                       the host reading one scalar per sweep.
# `standardize` scales the penalty space by the feature std and unscales
# afterward; the intercept is never penalized.
#
# The solve is `torch.linalg.solve_ex`, which returns where
# `torch.linalg.solve` would raise: a singular system (every feature
# constant, standardized, no penalty: Gs = 0) gives NaN coefficients, as
# `jnp.linalg.solve` does.
#
# A (regParam, elasticNetParam) grid (`linear_fit_batched`) takes ONE
# statistics pass whatever its size; its normal-equation points solve one
# by one on the shared statistics, its CD points in one batched
# coordinate descent that updates coordinate j of every point at once, so
# a sweep costs one point's launches. A single fit is the grid of one, so
# each grid point equals its `linear_fit` bit for bit. The ELL forms,
# batched ones included, and the checkpointed forms wait for ROADMAP A11
# and A12.
#
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .linalg import mm_bf16, row_tiles, rows_dot_fixed
from .owlqn import freeze_when_done


def _sufficient_stats(X, y, w, fast: bool = False):
    """One pass: (Σw, Σwx [d], Σwy, XᵀWX [d, d], XᵀWy [d], Σwy²).

    The gram and the correlation are summed over row tiles. ``fast``
    (solver_precision="bf16") runs both bf16-in / float32-accumulate
    (`linalg.mm_bf16`); the weighting and every scalar moment stay full
    precision."""
    sw = torch.sum(w)
    sx = w @ X
    sy = torch.sum(w * y)
    d = X.shape[1]
    acc_dtype = torch.float32 if fast else X.dtype
    G = torch.zeros((d, d), dtype=acc_dtype, device=X.device)
    c = torch.zeros((d,), dtype=acc_dtype, device=X.device)
    for rows in row_tiles(X.shape[0]):
        xt, yt = X[rows], y[rows]
        xw = xt * w[rows, None]
        if fast:
            G += mm_bf16(xw.T, xt)
            c += mm_bf16(xw.T, yt[:, None])[:, 0]
        else:
            G.addmm_(xw.T, xt)
            c += xw.T @ yt
    syy = torch.sum(w * y * y)
    return sw, sx, sy, G.to(X.dtype), c.to(X.dtype), syy


def _cd_elastic_net(A, r, lams, l1_ratios, max_iter: int, tol: float) -> Tuple[torch.Tensor, List[int]]:
    """Coordinate descent on the normalized gram A = G/n, r = c/n, for S
    points (lams [S], l1_ratios [S]) at once.

    Soft-threshold updates with incremental q = A·b; a point stops when the
    largest coefficient change of its sweep is <= tol, or after max_iter
    sweeps. Every point updates coordinate j in the same launch, in the
    same order as a point alone would; a stopped point is frozen
    (`freeze_when_done`): its b and q stay exactly. The host reads the S
    changes once per sweep, never once per coordinate. b and q are held
    [d, S], so a coordinate is one row of each (the sweep is launch-bound:
    the host's work per coordinate is its time). Returns (b [S, d], sweeps
    run by each point)."""
    d = A.shape[0]
    S = lams.shape[0]
    l1 = lams * l1_ratios
    l2 = lams * (1.0 - l1_ratios)
    diag = torch.diagonal(A)
    denom = torch.clamp_min(diag[:, None] + l2[None, :], 1e-30)  # [d, S]
    cols = A.T.contiguous()[:, :, None]  # cols[j] = A[:, j] as [d, 1]
    b = torch.zeros((d, S), dtype=A.dtype, device=A.device)
    q = torch.zeros((d, S), dtype=A.dtype, device=A.device)
    n_iter = [0] * S
    live = [max_iter > 0] * S
    frozen = None  # the stopped points' mask, once one has stopped
    while any(live):
        max_delta = torch.zeros((S,), dtype=A.dtype, device=A.device)
        for j in range(d):
            b_j = b[j]
            rho = r[j] - q[j] + diag[j] * b_j
            bj = torch.sign(rho) * torch.clamp_min(torch.abs(rho) - l1, 0.0) / denom[j]
            if frozen is not None:
                bj = freeze_when_done(frozen, b_j, bj)
            delta = bj - b_j
            q += cols[j] * delta
            b[j] = bj
            max_delta = torch.maximum(max_delta, torch.abs(delta))
        changes = max_delta.tolist()  # the one read of the sweep
        for i in range(S):
            if live[i]:
                n_iter[i] += 1
                live[i] = n_iter[i] < max_iter and changes[i] > tol
        if not all(live):
            frozen = torch.tensor([not v for v in live], dtype=torch.bool, device=A.device)
    return b.T, n_iter


def _solve_grid_from_stats(
    stats, dtype, alphas: Sequence[float], l1_ratios: Sequence[float], *,
    fit_intercept, standardize, use_cd, max_iter, tol,
) -> List[Dict[str, torch.Tensor]]:
    """The (alpha, l1_ratio) grid's solves on one set of sufficient
    statistics: one state dict per point. `use_cd` is uniform over the
    grid (the model layer groups by it)."""
    sw, sx, sy, G, c, syy = stats
    device = G.device

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    if fit_intercept:
        xm = sx / sw
        ym = sy / sw
        Gc = G - sw * torch.outer(xm, xm)
        cc = c - sx * ym
    else:
        xm = torch.zeros_like(sx)
        ym = scalar(0.0)
        Gc, cc = G, c

    var = torch.clamp_min(torch.diagonal(Gc) / sw, 0.0)
    if standardize:
        sigma = torch.sqrt(var)
        d_scale = torch.where(sigma > 0, 1.0 / torch.clamp_min(sigma, 1e-30), torch.zeros_like(sigma))
    else:
        d_scale = torch.ones_like(var)

    Gs = Gc * d_scale[:, None] * d_scale[None, :]
    cs = cc * d_scale

    if use_cd:
        b_all, iters = _cd_elastic_net(
            Gs / sw, cs / sw, scalar(list(map(float, alphas))), scalar(list(map(float, l1_ratios))),
            int(max_iter), float(tol),
        )
        solved = [(b_all[i], iters[i]) for i in range(len(iters))]
    else:
        # ridge normal equations; alpha == 0 is OLS with a tiny jitter for
        # singular grams
        eye = torch.eye(Gs.shape[0], dtype=dtype, device=device)
        solved = []
        for alpha in alphas:
            ridge_term = scalar(float(alpha)) * sw + scalar(1e-10) * torch.trace(Gs) / Gs.shape[0]
            solved.append((torch.linalg.solve_ex(Gs + ridge_term * eye, cs, check_errors=False).result, 1))

    out = []
    for b_s, n_iter in solved:
        coef = b_s * d_scale
        intercept = ym - torch.dot(xm, coef) if fit_intercept else scalar(0.0)
        # training summary (RegressionMetrics inputs)
        rss = syy - 2.0 * torch.dot(coef, c) - 2.0 * intercept * sy + torch.dot(coef, G @ coef) \
            + 2.0 * intercept * torch.dot(sx, coef) + intercept * intercept * sw
        out.append({
            "coef_": coef, "intercept_": intercept, "n_iter_": torch.tensor(n_iter, dtype=torch.int32),
            "rss_": torch.clamp_min(rss, 0.0), "sw_": sw,
        })
    return out


def _solve_from_stats(
    stats, dtype, *, alpha, l1_ratio, fit_intercept, standardize, use_cd, max_iter, tol
) -> Dict[str, torch.Tensor]:
    return _solve_grid_from_stats(
        stats, dtype, [alpha], [l1_ratio], fit_intercept=fit_intercept, standardize=standardize,
        use_cd=use_cd, max_iter=max_iter, tol=tol,
    )[0]


def linear_fit(
    X: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    *,
    alpha: float,
    l1_ratio: float,
    fit_intercept: bool = True,
    standardize: bool = True,
    use_cd: bool = False,
    max_iter: int = 1000,
    tol: float = 1e-6,
    fast: bool = False,
) -> Dict[str, torch.Tensor]:
    """Weighted linear regression on rows X [n, d], labels y [n], weights
    w [n], on X's device. `alpha` is Spark's regParam (per-sample-normalized
    objective); `fast` runs the sufficient-statistics contractions bf16-in /
    float32-accumulate."""
    return _solve_from_stats(
        _sufficient_stats(X, y, w, fast), X.dtype,
        alpha=alpha, l1_ratio=l1_ratio, fit_intercept=fit_intercept,
        standardize=standardize, use_cd=use_cd, max_iter=max_iter, tol=tol,
    )


def linear_fit_batched(
    X: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    alphas: Sequence[float],  # [S] Spark regParam grid
    l1_ratios: Sequence[float],  # [S] elasticNetParam grid
    *,
    fit_intercept: bool = True,
    standardize: bool = True,
    use_cd: bool = False,
    max_iter: int = 1000,
    tol: float = 1e-6,
    fast: bool = False,
) -> List[Dict[str, torch.Tensor]]:
    """A whole (alpha, l1_ratio) grid: ONE sufficient-statistics pass over
    the rows, then every point's solve on the shared d x d statistics
    (`_solve_grid_from_stats`). `use_cd` is uniform over the grid. Returns
    one `linear_fit` state per point."""
    return _solve_grid_from_stats(
        _sufficient_stats(X, y, w, fast), X.dtype, alphas, l1_ratios,
        fit_intercept=fit_intercept, standardize=standardize, use_cd=use_cd,
        max_iter=max_iter, tol=tol,
    )


def linear_predict(X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor) -> torch.Tensor:
    """X @ coef + intercept, each row summed in a fixed order
    (`linalg.rows_dot_fixed`), so it does not depend on its batch."""
    return rows_dot_fixed(X, coef[None, :])[:, 0] + intercept
