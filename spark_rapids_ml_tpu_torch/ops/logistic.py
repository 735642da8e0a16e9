#
# Logistic regression on one device: the PyTorch counterpart of the dense
# path of spark_rapids_ml_tpu/ops/logistic.py (`_make_scaling`,
# `_glm_qn_setup` + `_glm_qn_minimize`, `_dense_ops`, `_build_glm_problem`,
# `_finish_glm`, `_warm_x0`, `_fit_common`, `logistic_fit`,
# `logistic_predict`, `check_glm_result`, `warn_if_early_stall`).
#
# Objective (Spark semantics): (Σ wᵢ·loglossᵢ)/Σw + λ·[(1−α)/2·‖B_std‖² +
# α·‖B_std‖₁], the penalty in standardized space when standardization is
# on, never on the intercepts. The scaling is folded into the coefficients
# (logits = X·(D·B) + (b0 − μᵀD·B)), so no standardized copy of X is made.
# Binomial: sigmoid, coef [1, d]; multinomial: softmax, coef [k, d], the
# intercepts centered.
#
# Solvers, as in the JAX package: the GLM quasi-Newton below when the L1
# term is off, OWL-QN (ops/owlqn.py) when it is on. Both walk the flat
# (B, b0) vector with an L-BFGS memory of 10 pairs. Their loops run on the
# host; an iteration reads the device once (ops/owlqn.py's note), and the
# GLM iteration passes over X twice: z_D = X·(D·d) scores all 12 step
# candidates, and the gradient Xᵀ·r comes from the logits z_p + a·z_D at
# the accepted step. Xᵀ·r runs on the transposed view of X: no copy of Xᵀ.
#
# `fast` (solver_precision="bf16") rounds X to bf16 once per fit and runs
# both products with bf16 operands and float32 sums (`linalg.mm_bf16`),
# cast back to X's dtype; everything else stays at X's dtype.
#
# Both products run in blocks of `COL_BLOCK` columns, each zero-padded to
# the block (`_col_blocks`): a GEMM's kernel, and so its sums, change with
# its column count, and a fixed block makes a column's product depend on X
# and that column alone. That is what lets `logistic_fit_batched` solve a
# (regParam, elasticNetParam) grid in lockstep (ops/owlqn.py
# `run_lockstep`): the S solves share one [d, S·k] product per pass over X
# and one flag read per iteration, and each returns the iterates of its
# `logistic_fit` bit for bit (with GEMVs for a single fit, a float32 fit
# that stops on a stall or on `tol` may stop at another iteration than its
# grid's point).
#
# The streamed fit (ops/streaming.logistic_fit_streaming) is `_fit_common`
# with products served chunk by chunk from the host.
#
# The ELL forms (`logistic_fit_ell`, `logistic_fit_ell_batched`) run
# `_fit_common` over the padded-ELL products of ops/sparse.py (`_ell_ops`):
# X·B column by column, Xᵀ·R per column through the placement's column
# grouping (`sparse.EllColumns`), so a column's products are the same bits
# whatever columns ride beside it and the grid equals its single fits bit
# for bit. Their standardization is scale-only (`_ell_scaling`): the data
# is divided by the column std and never centered, which keeps it sparse,
# as the reference's sparse path does; so a sparse fit equals JAX's ELL
# fit, not the dense fit of the same rows. `fast` rounds the stored values
# through bf16 once and sums at full precision.
#
# Waiting, each named in ROADMAP: the checkpointed forms (A12), the
# per-iteration convergence trace (A15). The JAX package's optax
# `_lbfgs_minimize` is reached by no entry point there and is not ported.
#
from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .linalg import mm_bf16, rows_dot_fixed, weighted_moments
from .owlqn import LbfgsMemory, check_solver_state, owlqn_steps, relative_change_exceeds, run_lockstep

_LOG = logging.getLogger(__name__)

# the GLM line search's step candidates, 2, 1, 1/2, ..., 2^-10: one growth
# step, the unit step, then geometric backtracking (sorted descending: the
# first that passes is the largest)
N_ALPHAS = 12

# Columns of one block of the solvers' products (`_col_blocks`).
COL_BLOCK = 8


def _make_scaling(X, w, standardize: bool, fit_intercept: bool):
    """Returns (mu [d], d_scale [d], total_w): logits use Beff = d_scale·B,
    offset −μ·Beff. The standard deviation is the unbiased one (Spark's
    summarizer); a constant column gets d_scale = 0."""
    return scaling_from_moments(*weighted_moments(X, w), standardize, fit_intercept)


def scaling_from_moments(total_w, mean, var, standardize: bool, fit_intercept: bool):
    """`_make_scaling` from the weighted moments, resident or streamed."""
    if not standardize:
        return torch.zeros_like(mean), torch.ones_like(mean), total_w
    sigma = torch.sqrt(var * (total_w / torch.clamp_min(total_w - 1.0, 1.0)))
    d_scale = torch.where(sigma > 0, 1.0 / torch.clamp_min(sigma, 1e-30), torch.zeros_like(sigma))
    mu = mean if fit_intercept else torch.zeros_like(mean)
    return mu, d_scale, total_w


def _ell_scaling(values, indices, w, d: int, standardize: bool, columns=None):
    """Scale-only standardization of padded-ELL rows: (mu = 0, d_scale [d],
    total_w). The column std comes from `sparse.ell_col_moments` (the
    population variance, unclamped, made unbiased as `_make_scaling`
    does); the data is never centered."""
    from .sparse import ell_col_moments

    if standardize:
        total_w, _, var = ell_col_moments(values, indices, w, d, columns)
        sigma = torch.sqrt(var * (total_w / torch.clamp_min(total_w - 1.0, 1.0)))
        d_scale = torch.where(sigma > 0, 1.0 / torch.clamp_min(sigma, 1e-30), torch.zeros_like(sigma))
    else:
        total_w = torch.sum(w)
        d_scale = values.new_ones((d,))
    return values.new_zeros((d,)), d_scale, total_w


def _ell_ops(values, indices, d: int, fast: bool = False, columns=None):
    """(matvec, rmat) closures over padded-ELL rows: B ↦ X·B column by
    column (`sparse.ell_matmul`), R ↦ Xᵀ·R column by column through the
    column grouping `columns` (made at the first Xᵀ·R when None). `fast`
    rounds the stored values through bf16 once, here."""
    from .sparse import EllColumns, ell_matmul, round_bf16

    gv = round_bf16(values) if fast else values
    held = [columns]

    def rmat(r):
        if held[0] is None:
            held[0] = EllColumns(values, indices, d)
        return torch.stack([held[0].col_sums(gv, r[:, j]) for j in range(r.shape[1])], dim=1)

    return (lambda Beff: ell_matmul(gv, indices, Beff)), rmat


def softplus(z: torch.Tensor) -> torch.Tensor:
    """log(1 + eᶻ) as `jax.nn.softplus` computes it (logaddexp(z, 0));
    `F.softplus` returns z itself above its threshold of 20."""
    return torch.logaddexp(z, z.new_zeros(()))


def _col_blocks(mm, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b in blocks of `COL_BLOCK` columns of b, each zero-padded to the
    block and contiguous, so a column's product is the same bits whatever
    columns ride beside it. Each block runs as the transposed product
    (blkᵀ·aᵀ)ᵀ: on the H100, cuBLAS picks a faster kernel for it than for
    a·blk, faster than a one-column GEMV too (tools/col_block_widths.py)."""
    c = b.shape[1]
    outs = []
    for lo in range(0, c, COL_BLOCK):
        blk = b.new_zeros((b.shape[0], COL_BLOCK))
        blk[:, :min(COL_BLOCK, c - lo)] = b[:, lo:lo + COL_BLOCK]
        outs.append(mm(blk.T, a.T).T)
    return torch.cat(outs, dim=1)[:, :c]


def _dense_ops(X: torch.Tensor, fast: bool = False):
    """(matvec, rmat) closures over dense X: B ↦ X·B and R ↦ Xᵀ·R, in
    column blocks (`_col_blocks`), the latter on the transposed view.
    `fast` stages X to bf16 here, once per fit."""
    if not fast:
        return (
            lambda Beff: _col_blocks(torch.mm, X, Beff),
            lambda r: _col_blocks(torch.mm, X.T, r),
        )
    bX = X.to(torch.bfloat16)
    return (
        lambda Beff: _col_blocks(mm_bf16, bX, Beff).to(X.dtype),
        lambda r: _col_blocks(mm_bf16, bX.T, r).to(X.dtype),
    )


def _build_glm_problem(
    dtype, d, y_idx, w, mu, d_scale, total_w, *, k, multinomial, lam_l2, fit_intercept,
) -> Dict[str, Any]:
    """The GLM objective closures over the flat parameters xf = (B [d, k_out]
    row-major, b0 [k_out]):

      z_solve(xf) -> logits [n, k_out]             (linear in xf)
      rowloss(z) -> data term
      rowloss_alphas(z_p, z_d, a [S]) -> [S]      (data term at p + a·d)
      penalty_terms(xf, df) -> (p0, p1, p2)       (penalty(x + a·d) =
                                                   p0 + a·p1 + a²·p2)
      grad_solve(xf, z) -> flat gradient           (penalty included)

    The two passes over the rows, z_solve and grad_solve, are solves of
    `run_lockstep`: they request their products (X·B, Xᵀ·R) from it."""
    k_out = k if multinomial else 1
    n_flat = d * k_out + k_out

    def unflatten(xf):
        return xf[: d * k_out].reshape(d, k_out), xf[d * k_out:]

    def z_in(xf):
        """(Beff, offset): z = X·Beff + offset."""
        B, b0 = unflatten(xf)
        Beff = B * d_scale[:, None]
        offset = (b0 - mu @ Beff) if fit_intercept else -(mu @ Beff)
        return Beff, offset

    def z_solve(xf):
        Beff, offset = z_in(xf)
        return (yield ("mm", Beff)) + offset[None, :]

    if multinomial:
        def rowloss(z):
            z_true = torch.gather(z, 1, y_idx[:, None])[:, 0]
            return torch.sum(w * (torch.logsumexp(z, dim=1) - z_true)) / total_w

        def rowloss_alphas(z_p, z_d, a):
            z = z_p[:, None, :] + a[None, :, None] * z_d[:, None, :]  # [n, S, k]
            idx = y_idx[:, None, None].expand(z.shape[0], a.shape[0], 1)
            z_true = torch.gather(z, 2, idx)[..., 0]  # [n, S]
            return (w @ (torch.logsumexp(z, dim=2) - z_true)) / total_w
    else:
        y = y_idx.to(dtype)

        def rowloss(z):
            z0 = z[:, 0]
            return torch.sum(w * (softplus(z0) - y * z0)) / total_w

        def rowloss_alphas(z_p, z_d, a):
            z = z_p[:, :1] + a[None, :] * z_d[:, :1]  # [n, S]
            return (w @ (softplus(z) - y[:, None] * z)) / total_w

    def penalty_terms(xf, df):
        Bx, Bd = xf[: d * k_out], df[: d * k_out]
        return (
            0.5 * lam_l2 * torch.sum(Bx * Bx),
            lam_l2 * torch.dot(Bx, Bd),
            0.5 * lam_l2 * torch.sum(Bd * Bd),
        )

    def residual(z):
        """∂loss/∂z, the GLM residual [n, k_out]."""
        if multinomial:
            p = torch.softmax(z, dim=1)
            return w[:, None] * (p - F.one_hot(y_idx, k).to(dtype)) / total_w
        p = torch.sigmoid(z[:, 0])
        return ((w * (p - y)) / total_w)[:, None]  # [n, 1]

    def grad_out(xf, r, xr):
        """The flat gradient from the residual r and its product xr = Xᵀ·r:
        the chain through z = X·(B·D) + (b0 − μ·Beff) is vector algebra."""
        B, _ = unflatten(xf)
        r_sum = torch.sum(r, dim=0)
        g_beff = xr - mu[:, None] * r_sum[None, :]  # [d, k_out]
        dB = g_beff * d_scale[:, None] + lam_l2 * B
        db0 = r_sum if fit_intercept else torch.zeros((k_out,), dtype=dtype, device=r.device)
        return torch.cat([dB.reshape(-1), db0])

    def grad_solve(xf, z):
        """One transposed pass over the rows plus vector algebra."""
        r = residual(z)
        return grad_out(xf, r, (yield ("rmat", r)))

    return dict(
        k_out=k_out, n_flat=n_flat, unflatten=unflatten, z_solve=z_solve, rowloss=rowloss,
        rowloss_alphas=rowloss_alphas, penalty_terms=penalty_terms, grad_solve=grad_solve,
    )


def armijo_pick(f_cand, f_cur, a, gd, c1: float = 1e-4):
    """The batched Armijo check: (step, its objective, whether any passed).
    The candidates `a` are sorted descending, so the first that passes is
    the largest; `torch.argmax` refuses a bool tensor, so the mask is cast.
    With none passing, the first candidate is returned beside ok = False."""
    ok_mask = f_cand <= f_cur + c1 * a * gd
    first_ok = torch.argmax(ok_mask.to(torch.int32)).reshape(1)
    return a.index_select(0, first_ok)[0], f_cand.index_select(0, first_ok)[0], torch.any(ok_mask)


def _glm_qn_steps(
    prob: Dict[str, Any], z_shape, dtype, device, max_iter: int, tol: float, memory: int = 10,
    c1: float = 1e-4, x0=None,
):
    """L-BFGS specialized to GLM objectives loss(p) = rowloss(z(p)) +
    penalty(p) with z linear in p, as a solve of `run_lockstep`. Each
    iteration: the two-loop direction (steepest descent when it is not a
    descent one), one new logit pass z_d = z(d) scoring all step
    candidates, the largest passing step, the gradient from the logits z_p
    + a·z_d, one flag read. Stops at `max_iter`, when the relative objective
    change is at most `tol`, or when no candidate passes (stalled). Returns
    (flat params, objective, n_iter, stalled, its flag reads)."""
    rowloss, rowloss_alphas, penalty_terms = prob["rowloss"], prob["rowloss_alphas"], prob["penalty_terms"]
    z_solve, grad_solve, n_flat = prob["z_solve"], prob["grad_solve"], prob["n_flat"]
    # the step candidates made on the device, exactly (products of powers of
    # 2), so the fit copies nothing from the host
    alphas = 4.0 * torch.full((N_ALPHAS,), 0.5, dtype=dtype, device=device).cumprod(0)
    if x0 is None:
        x = torch.zeros((n_flat,), dtype=dtype, device=device)
        z_p = torch.zeros(z_shape, dtype=dtype, device=device)  # z(0) == 0: z has no constant
    else:
        x = x0
        z_p = yield from z_solve(x0)
    g = yield from grad_solve(x, z_p)
    f_cur = rowloss(z_p) + penalty_terms(x, torch.zeros_like(x))[0]
    hist = LbfgsMemory(memory, n_flat, x)
    # the loop's test before its first iteration (f_prev = +inf): it holds
    # exactly when f0 is finite; read with the first iteration's flags
    go_first = relative_change_exceeds(torch.full_like(f_cur, float("inf")), f_cur, tol)
    it, reads, stalled = 0, 0, False
    while it < max_iter:
        d = hist.direction(g)
        gd = torch.dot(g, d)
        descent = gd < 0
        d = torch.where(descent, d, -g)
        gd = torch.where(descent, gd, -torch.dot(g, g))
        z_d = yield from z_solve(d)  # [X read 1]
        p0, p1, p2 = penalty_terms(x, d)
        f_cand = rowloss_alphas(z_p, z_d, alphas) + p0 + alphas * p1 + alphas * alphas * p2
        a_sel, f_new, ok = armijo_pick(f_cand, f_cur, alphas, gd, c1)
        xn = x + a_sel * d
        z_n = z_p + a_sel * z_d  # the logits at the accepted point, no X pass
        gn = yield from grad_solve(xn, z_n)  # [X read 2]
        s, yv = xn - x, gn - g
        sy = torch.dot(s, yv)
        flags = [ok, ok & (sy > 1e-10), relative_change_exceeds(f_cur, torch.where(ok, f_new, f_cur), tol)]
        if it == 0:
            flags.append(go_first)
        ok, keep, go, *first = yield ("read", flags)
        reads += 1
        if first and not first[0]:
            return x, f_cur, 0, False, reads  # JAX's loop would not have run
        if keep:
            hist.push(s, yv, sy)
        if ok:
            x, z_p, g, f_cur = xn, z_n, gn, f_new
        it += 1
        if "numcheck" in prob:
            # the streamed fit's state is host tensors: the outer iteration
            # IS its host boundary, swept with no new read
            nc, stage = prob["numcheck"]
            nc(stage, solver="glm_qn_stream", iteration=it - 1, objective=f_cur, iterate=x, gradient=g)
        stalled = not ok
        if stalled or not go:
            break
    return x, f_cur, it, stalled, reads


def _finish_glm(xf, obj, n_iter, stalled, unflatten, d_scale, mu, *, fit_intercept, multinomial) -> Dict[str, Any]:
    """Flat iterate -> model-attribute dict in ORIGINAL feature space
    (standardization folded out, the multinomial intercepts centered)."""
    B, b0 = unflatten(xf)
    coef = (B * d_scale[:, None]).T  # [k_out, d]
    intercept = b0 - coef @ mu if fit_intercept else torch.zeros_like(b0)
    if multinomial:
        intercept = intercept - torch.mean(intercept)  # softmax shift invariance (Spark)
    return {"coef_": coef, "intercept_": intercept, "objective_": obj, "n_iter_": n_iter, "stalled_": stalled}


def _warm_x0(warm_start, d, k_out, mu, d_scale, fit_intercept, dtype):
    """ORIGINAL-space (coef [k_out, d], intercept [k_out]) -> the flat
    standardized iterate: the exact inverse of `_finish_glm`'s fold-out.
    Columns whose d_scale is 0 (constant features) get 0."""
    coef, intercept = warm_start
    dev = mu.device
    coef = torch.as_tensor(np.asarray(coef), dtype=dtype, device=dev).reshape(k_out, d)
    intercept = torch.as_tensor(np.asarray(intercept), dtype=dtype, device=dev).reshape(k_out)
    scale = d_scale[:, None]
    B = torch.where(scale != 0, coef.T / torch.where(scale == 0, torch.ones_like(scale), scale),
                    torch.zeros_like(coef.T))
    b0 = (intercept + coef @ mu) if fit_intercept else torch.zeros((k_out,), dtype=dtype, device=dev)
    return torch.cat([B.reshape(-1), b0])


def _glm_solve(prob, n_rows, dtype, device, d, *, lam_l1, use_l1, max_iter, tol, lbfgs_memory, x_warm):
    """One GLM fit as a solve of `run_lockstep`, returning (flat params,
    objective, n_iter, stalled, its flag reads): OWL-QN when the L1 term is
    on, the GLM quasi-Newton otherwise."""
    k_out, n_flat = prob["k_out"], prob["n_flat"]
    if not use_l1:
        return (yield from _glm_qn_steps(
            prob, (n_rows, k_out), dtype, device, max_iter=max_iter, tol=tol, memory=lbfgs_memory, x0=x_warm,
        ))
    # L1 / elastic net: OWL-QN over (B, b0), the L1 mask on the coefficients
    # only; its gradient from the accepted trial's logits
    rowloss, penalty_terms = prob["rowloss"], prob["penalty_terms"]

    def value_fn(xf):
        z = yield from prob["z_solve"](xf)
        return rowloss(z) + penalty_terms(xf, torch.zeros_like(xf))[0], z

    l1_mask = torch.cat([torch.ones((d * k_out,), dtype=dtype, device=device),
                         torch.zeros((k_out,), dtype=dtype, device=device)])
    x0 = x_warm if x_warm is not None else torch.zeros((n_flat,), dtype=dtype, device=device)
    xf, obj, n_iter, reads = yield from owlqn_steps(
        value_fn, prob["grad_solve"], x0, l1_mask, lam_l1, max_iter=max_iter, tol=tol, memory=lbfgs_memory,
    )
    return xf, obj, n_iter, False, reads


def _fit_common_grid(
    matvec, rmat, n_rows, dtype, d, y_idx, w, mu, d_scale, total_w,
    *, k, multinomial, lam_l2s, lam_l1s, use_l1, fit_intercept, max_iter, tol, lbfgs_memory,
    warm_start=None, numcheck_stage=None,
) -> list:
    """The fits of a (lam_l2, lam_l1) grid over one placement, in lockstep
    (`run_lockstep`): one list of `_fit_common` states, each with its own
    `host_reads_` and the reads the whole grid made, `grid_host_reads_`.
    `numcheck_stage` (the streamed fit's, whose state lives on the host)
    sweeps each GLM iteration's objective, iterate and gradient at
    `<stage>.iterate` under SRML_NUMCHECK=1."""
    from ..utils import numcheck

    _nc = numcheck.hook() if numcheck_stage else None
    device = w.device
    solves, probs = [], []
    for lam_l2, lam_l1 in zip(lam_l2s, lam_l1s):
        prob = _build_glm_problem(
            dtype, d, y_idx, w, mu, d_scale, total_w,
            k=k, multinomial=multinomial, lam_l2=lam_l2, fit_intercept=fit_intercept,
        )
        x_warm = (
            _warm_x0(warm_start, d, prob["k_out"], mu, d_scale, fit_intercept, dtype)
            if warm_start is not None else None
        )
        if _nc is not None:
            prob["numcheck"] = (_nc, f"{numcheck_stage}.iterate")
        probs.append(prob)
        solves.append(_glm_solve(
            prob, n_rows, dtype, device, d, lam_l1=lam_l1, use_l1=use_l1, max_iter=max_iter, tol=tol,
            lbfgs_memory=lbfgs_memory, x_warm=x_warm,
        ))
    results, grid_reads = run_lockstep(solves, matvec, rmat)
    states = []
    for prob, (xf, obj, n_iter, stalled, reads) in zip(probs, results):
        out = _finish_glm(xf, obj, n_iter, stalled, prob["unflatten"], d_scale, mu,
                          fit_intercept=fit_intercept, multinomial=multinomial)
        out["host_reads_"] = reads
        out["grid_host_reads_"] = grid_reads
        states.append(out)
    return states


def _fit_common(
    matvec, rmat, n_rows, dtype, d, y_idx, w, mu, d_scale, total_w,
    *, k, multinomial, lam_l2, lam_l1, use_l1, fit_intercept, max_iter, tol, lbfgs_memory,
    warm_start=None, numcheck_stage=None,
) -> Dict[str, Any]:
    (out,) = _fit_common_grid(
        matvec, rmat, n_rows, dtype, d, y_idx, w, mu, d_scale, total_w,
        k=k, multinomial=multinomial, lam_l2s=[lam_l2], lam_l1s=[lam_l1], use_l1=use_l1,
        fit_intercept=fit_intercept, max_iter=max_iter, tol=tol, lbfgs_memory=lbfgs_memory,
        warm_start=warm_start, numcheck_stage=numcheck_stage,
    )
    del out["grid_host_reads_"]
    return out


def logistic_fit(
    X: torch.Tensor,
    y_idx: torch.Tensor,  # int64 class indices in [0, k)
    w: torch.Tensor,
    *,
    k: int,
    multinomial: bool,
    lam_l2: float,
    lam_l1: float = 0.0,
    use_l1: bool = False,
    fit_intercept: bool = True,
    standardize: bool = True,
    max_iter: int = 100,
    tol: float = 1e-6,
    lbfgs_memory: int = 10,
    fast: bool = False,
    warm_start=None,  # (coef [k_out, d], intercept [k_out]) original-space seed
) -> Dict[str, Any]:
    """Weighted logistic regression on rows X [n, d] on X's device. Returns
    coef_ [k_out, d], intercept_ [k_out] (ORIGINAL feature space) and
    objective_ as device tensors, and n_iter_, stalled_ and host_reads_ (the
    solver's reads of the device) as host values."""
    d = X.shape[1]
    mu, d_scale, total_w = _make_scaling(X, w, standardize, fit_intercept)
    matvec, rmat = _dense_ops(X, fast)
    return _fit_common(
        matvec, rmat, X.shape[0], X.dtype, d, y_idx, w, mu, d_scale, total_w,
        k=k, multinomial=multinomial, lam_l2=lam_l2, lam_l1=lam_l1, use_l1=use_l1,
        fit_intercept=fit_intercept, max_iter=max_iter, tol=tol, lbfgs_memory=lbfgs_memory,
        warm_start=warm_start,
    )


def logistic_fit_batched(
    X: torch.Tensor,
    y_idx: torch.Tensor,
    w: torch.Tensor,
    lam_l2s,  # [S] per-grid-point L2 strengths
    lam_l1s,  # [S] per-grid-point L1 strengths
    *,
    k: int,
    multinomial: bool,
    use_l1: bool = False,
    fit_intercept: bool = True,
    standardize: bool = True,
    max_iter: int = 100,
    tol: float = 1e-6,
    lbfgs_memory: int = 10,
    fast: bool = False,
) -> list:
    """A whole (lam_l2, lam_l1) grid over one placement of X: the scaling
    once, then the S solves in lockstep, so X is read twice per iteration
    for the whole grid (one [d, S·k_out] product each way) and the host
    reads the card once per iteration for the whole grid. A solve that
    stops issues nothing more, so its state stays exactly where it stopped,
    and each returned state equals its `logistic_fit` bit for bit (same
    n_iter_). Statics (use_l1, max_iter, ...) are uniform over the grid.
    Returns one `logistic_fit` state per grid point."""
    d = X.shape[1]
    mu, d_scale, total_w = _make_scaling(X, w, standardize, fit_intercept)
    matvec, rmat = _dense_ops(X, fast)
    return _fit_common_grid(
        matvec, rmat, X.shape[0], X.dtype, d, y_idx, w, mu, d_scale, total_w,
        k=k, multinomial=multinomial, lam_l2s=[float(v) for v in lam_l2s],
        lam_l1s=[float(v) for v in lam_l1s], use_l1=use_l1, fit_intercept=fit_intercept,
        max_iter=max_iter, tol=tol, lbfgs_memory=lbfgs_memory,
    )


def logistic_fit_ell(
    values: torch.Tensor,  # [n, k_max] padded-ELL values (ops/sparse.py)
    indices: torch.Tensor,  # [n, k_max] int32 column indices
    y_idx: torch.Tensor,
    w: torch.Tensor,
    *,
    d: int,
    k: int,
    multinomial: bool,
    lam_l2: float,
    lam_l1: float = 0.0,
    use_l1: bool = False,
    fit_intercept: bool = True,
    standardize: bool = True,
    max_iter: int = 100,
    tol: float = 1e-6,
    lbfgs_memory: int = 10,
    fast: bool = False,
    warm_start=None,
    columns=None,  # sparse.EllColumns of (values, indices), made once per placement
) -> Dict[str, Any]:
    """Sparse (padded-ELL) logistic fit: `logistic_fit`'s solvers over the
    ELL products, with scale-only standardization (`_ell_scaling`).
    Coefficients return in original space."""
    from .sparse import EllColumns

    if columns is None:
        columns = EllColumns(values, indices, d)
    mu, d_scale, total_w = _ell_scaling(values, indices, w, d, standardize, columns)
    matvec, rmat = _ell_ops(values, indices, d, fast, columns)
    return _fit_common(
        matvec, rmat, values.shape[0], values.dtype, d, y_idx, w, mu, d_scale, total_w,
        k=k, multinomial=multinomial, lam_l2=lam_l2, lam_l1=lam_l1, use_l1=use_l1,
        fit_intercept=fit_intercept, max_iter=max_iter, tol=tol, lbfgs_memory=lbfgs_memory,
        warm_start=warm_start,
    )


def logistic_fit_ell_batched(
    values: torch.Tensor,
    indices: torch.Tensor,
    y_idx: torch.Tensor,
    w: torch.Tensor,
    lam_l2s,
    lam_l1s,
    *,
    d: int,
    k: int,
    multinomial: bool,
    use_l1: bool = False,
    fit_intercept: bool = True,
    standardize: bool = True,
    max_iter: int = 100,
    tol: float = 1e-6,
    lbfgs_memory: int = 10,
    fast: bool = False,
    columns=None,
) -> list:
    """`logistic_fit_batched` on padded-ELL rows: the scale-only scaling
    once, the S solves in lockstep over the ELL products; each state equals
    its `logistic_fit_ell` bit for bit."""
    from .sparse import EllColumns

    if columns is None:
        columns = EllColumns(values, indices, d)
    mu, d_scale, total_w = _ell_scaling(values, indices, w, d, standardize, columns)
    matvec, rmat = _ell_ops(values, indices, d, fast, columns)
    return _fit_common_grid(
        matvec, rmat, values.shape[0], values.dtype, d, y_idx, w, mu, d_scale, total_w,
        k=k, multinomial=multinomial, lam_l2s=[float(v) for v in lam_l2s],
        lam_l1s=[float(v) for v in lam_l1s], use_l1=use_l1, fit_intercept=fit_intercept,
        max_iter=max_iter, tol=tol, lbfgs_memory=lbfgs_memory,
    )


def fetch_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """`logistic_fit`'s state on the host in ONE device-to-host copy: the
    coefficients, the intercepts and the objective travel as one tensor."""
    return fetch_states([state])[0]


def fetch_states(states) -> list:
    """The states of a grid (`logistic_fit_batched`) on the host in ONE
    device-to-host copy."""
    keys = ("coef_", "intercept_", "objective_")
    flat = torch.cat([st[k].reshape(-1) for st in states for k in keys]).cpu().numpy()
    out, lo = [], 0
    for st in states:
        host = {k: v for k, v in st.items() if k not in keys}
        for k in keys:
            n = st[k].numel()
            host[k] = flat[lo:lo + n].reshape(tuple(st[k].shape))
            lo += n
        out.append(host)
    return out


def check_glm_result(state: Dict, *, solver: str = "logistic") -> Dict:
    """Divergence guard for a fetched GLM fit state: NaN/Inf in the
    objective or the coefficients raises `SolverDivergedError`; returns
    `state` otherwise."""
    return check_solver_state(solver, state)


def warn_if_early_stall(state: Dict, *, standardize: bool, max_iter: int, logger=None) -> bool:
    """Warn when the Armijo stall check ended an UNSTANDARDIZED fit before
    maxIter: badly scaled features shrink the per-step objective
    improvements below float32 noise, and the model may be
    under-converged. Returns whether the warning fired."""
    stalled = bool(np.asarray(state.get("stalled_", False)))
    n_iter = int(np.asarray(state.get("n_iter_", 0)))
    if not stalled or standardize or n_iter >= max_iter:
        return False
    (logger or _LOG).warning(
        "L-BFGS line search stalled after %d/%d iterations on an "
        "unstandardized fit — the model may be under-converged. Badly scaled "
        "features shrink per-step objective improvements below f32 noise; "
        "set standardization=True.",
        n_iter, max_iter,
    )
    return True


def logistic_predict(
    X: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor, *, multinomial: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (raw [n, k], prob [n, k]), Spark's rawPrediction and
    probability; binary raw = [−m, m] with m the margin, prob = [1 − σ(m),
    σ(m)]. A row's answer does not depend on its batch: its margins are
    summed in a fixed order (`linalg.rows_dot_fixed`), and the link is a
    softmax, which works row by row (binary: softmax([0, m])). An
    elementwise `torch.sigmoid` would not do: on the CPU it runs vector code
    on the body of a tensor and scalar code on its tail, so an element's
    last bit depends on where it sits in the batch. At m = +inf the softmax
    is NaN (inf − inf); that row gets the limit [0, 1], as 1 − σ(m), σ(m)
    gives it."""
    if multinomial:
        raw = rows_dot_fixed(X, coef) + intercept[None, :]
        return raw, torch.softmax(raw, dim=1)
    m = rows_dot_fixed(X, coef[:1])
    m = m + intercept[0]
    prob = torch.softmax(torch.cat([torch.zeros_like(m), m], dim=1), dim=1)
    prob = torch.where(torch.isposinf(m), torch.tensor([0.0, 1.0], dtype=prob.dtype, device=prob.device), prob)
    return torch.cat([-m, m], dim=1), prob
