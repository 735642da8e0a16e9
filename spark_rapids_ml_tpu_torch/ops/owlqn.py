#
# The quasi-Newton family's shared pieces, on one device: the divergence
# guard, the L-BFGS two-loop recursion over circular (s, y) buffers, and
# OWL-QN (Andrew & Gao 2007), the L1-capable solver behind
# LogisticRegression's elastic net. The PyTorch counterpart of
# spark_rapids_ml_tpu/ops/owlqn.py (`check_solver_state`,
# `lbfgs_two_loop`, `_owlqn_setup` + `owlqn_minimize`).
#
# The JAX package runs each minimization as ONE `lax.while_loop` on the
# device. Here the loop is Python on the host, and the device work of an
# iteration is queued without a host read until its end:
#
#   * the host keeps the L-BFGS bookkeeping (`count`, `pos`) as ints, so the
#     two-loop visits only the valid history entries (the JAX loop visits
#     all `memory` slots and masks the others, which add exactly 0);
#   * each line-search trial reads one small flag tensor (did Armijo pass),
#     and each iteration one more (is the pair kept, is the loop to go on):
#     the only host reads of the solver, counted in `host_reads`;
#   * the gradient at the accepted point comes from the caller's
#     `grad_fn(x, aux)` on what `value_fn` returned for it (the GLM passes
#     the logits, so the gradient costs one transposed pass over the rows
#     instead of autodiff's forward and backward).
#
# `freeze_when_done` (vmap-safe loops) waits for the batched grid (ROADMAP
# A9), and the segmented, checkpointed forms for A12.
#
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry


def check_solver_state(
    solver: str,
    state: dict,
    *,
    scalars: Tuple[str, ...] = ("objective_",),
    arrays: Tuple[str, ...] = ("coef_", "intercept_"),
) -> dict:
    """Host-side divergence guard on the values the model layer fetches
    anyway (no extra device sync): non-finite state raises
    `SolverDivergedError` carrying the iteration count and whatever parts
    of the state are still finite as the last-good iterate. Returns `state`
    unchanged so call sites can wrap."""
    from ..errors import SolverDivergedError

    bad = []
    for key in scalars:
        if key in state and not np.isfinite(_host(state[key])).all():
            bad.append(key)
    for key in arrays:
        if key in state and not np.isfinite(_host(state[key])).all():
            bad.append(key)
    if not bad:
        return state
    n_iter = int(_host(state.get("n_iter_", 0)))
    last_good = {
        k: _host(v)
        for k, v in state.items()
        if k not in bad and isinstance(v, (np.ndarray, torch.Tensor))
        and np.isfinite(_host(v)).all()
    }
    telemetry.registry().inc("solver.divergence")
    telemetry.registry().inc(f"{solver}.divergence")
    raise SolverDivergedError(
        solver, n_iter, last_good=last_good, detail=f"non-finite {', '.join(bad)}"
    )


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class LbfgsMemory:
    """The circular (S, Y, rho) history of L-BFGS: `memory` slots of flat
    [n] pairs on the device, with the host's `count` (valid pairs) and
    `pos` (next slot to write)."""

    def __init__(self, memory: int, n: int, like: torch.Tensor) -> None:
        self.m = int(memory)
        self.S = like.new_zeros((self.m, n))
        self.Y = like.new_zeros((self.m, n))
        self.rho = like.new_zeros((self.m,))
        self.count = 0
        self.pos = 0

    def push(self, s: torch.Tensor, y: torch.Tensor, sy: torch.Tensor) -> None:
        """Keep the pair (s, y) with sᵀy = `sy` in the oldest slot."""
        self.S[self.pos] = s
        self.Y[self.pos] = y
        self.rho[self.pos] = 1.0 / torch.clamp_min(sy, 1e-30)
        self.count = min(self.count + 1, self.m)
        self.pos = (self.pos + 1) % self.m

    def direction(self, pg: torch.Tensor) -> torch.Tensor:
        return lbfgs_two_loop(pg, self.S, self.Y, self.rho, self.count, self.pos, self.m)


def lbfgs_two_loop(pg, S, Y, rho, count: int, pos: int, m: int) -> torch.Tensor:
    """Shared L-BFGS two-loop recursion over circular (s, y) history
    buffers: returns the descent direction −H·pg. `count` and `pos` are host
    ints; the newest pair sits in slot pos − 1, and the initial Hessian is
    γ·I with γ = sᵀy / yᵀy of the newest pair (1 with no pair, or yᵀy = 0)."""
    q = pg
    alphas: List[Optional[torch.Tensor]] = [None] * m
    for i in range(count):
        j = (pos - 1 - i) % m
        a = rho[j] * torch.dot(S[j], q)
        q = q - a * Y[j]
        alphas[j] = a
    if count > 0:
        newest = (pos - 1) % m
        sy = torch.dot(S[newest], Y[newest])
        yy = torch.dot(Y[newest], Y[newest])
        gamma = torch.where(yy > 0, sy / torch.clamp_min(yy, 1e-30), torch.ones_like(yy))
        q = gamma * q
    r = q
    for i in range(count):
        j = (pos - count + i) % m
        beta = rho[j] * torch.dot(Y[j], r)
        r = r + (alphas[j] - beta) * S[j]
    return -r


def relative_change_exceeds(f_prev: torch.Tensor, f_cur: torch.Tensor, tol: float) -> torch.Tensor:
    """The loops' convergence test on the device, at the objective's dtype:
    |f_prev − f_cur| / max(|f_cur|, 1) > tol (False for NaN)."""
    return torch.abs(f_prev - f_cur) / torch.clamp_min(torch.abs(f_cur), 1.0) > tol


def read_flags(*flags: torch.Tensor) -> List[bool]:
    """THE host read of the solvers: several 0-dim boolean device tensors
    fetched as one small tensor."""
    return [bool(v) for v in torch.stack(flags).tolist()]


def owlqn_minimize(
    value_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, object]],
    grad_fn: Callable[[torch.Tensor, object], torch.Tensor],
    x0: torch.Tensor,  # flat [n]
    l1_mask: torch.Tensor,  # [n]: per-coordinate L1 weight multiplier (0 = unpenalized)
    lam1: float,
    *,
    max_iter: int,
    tol: float,
    memory: int = 10,
    ls_max: int = 25,
    c1: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Minimize smooth(x) + lam1 · Σ l1_mask·|x| by OWL-QN.

    `value_fn(x)` returns (smooth(x), aux); `grad_fn(x, aux)` the gradient
    of smooth at x from that aux. The line search backtracks from a = 1,
    halving at most `ls_max` times, on the projection of x + a·d onto x's
    orthant, with Armijo against the pseudo-gradient; an iteration whose
    search finds no step ends the loop (stalled). Returns (x, objective,
    n_iter, host reads); with lam1 = 0 it is plain two-loop L-BFGS."""
    lam = lam1 * l1_mask
    hist = LbfgsMemory(memory, x0.shape[0], x0)

    def f_total(x):
        f, aux = value_fn(x)
        return f + torch.sum(lam * torch.abs(x)), aux

    def pseudo_grad(x, g):
        zero = torch.zeros_like(g)
        at0 = torch.where(g + lam < 0, g + lam, torch.where(g - lam > 0, g - lam, zero))
        return torch.where(x > 0, g + lam, torch.where(x < 0, g - lam, at0))

    x = x0
    f_cur, aux = f_total(x0)
    g = grad_fn(x0, aux).to(x0.dtype)
    # the loop's test before its first iteration: f_prev = +inf, so it holds
    # exactly when f0 is finite; read with the first trial's flag
    go_first = relative_change_exceeds(torch.full_like(f_cur, float("inf")), f_cur, tol)
    it, reads = 0, 0
    while it < max_iter:
        pg = pseudo_grad(x, g)
        d = hist.direction(pg)
        # orthant-wise sign alignment: drop components fighting the pseudo-grad
        d = torch.where(d * (-pg) > 0, d, torch.zeros_like(d))
        xi = torch.where(x != 0, torch.sign(x), torch.sign(-pg))
        a, ok = 1.0, False
        for _ in range(ls_max):
            xn = x + a * d
            xn = torch.where(xn * xi < 0, torch.zeros_like(xn), xn)
            fn, aux = f_total(xn)
            passed = fn <= f_cur + c1 * torch.dot(pg, xn - x)
            if it == 0:
                passed, go = read_flags(passed, go_first)
                if not go:
                    return x0, f_cur, 0, reads + 1
            else:
                (passed,) = read_flags(passed)
            reads += 1
            if passed:
                ok = True
                break
            a *= 0.5
        it += 1
        if not ok:
            break  # stalled: the iterate and objective stay
        gn = grad_fn(xn, aux).to(x0.dtype)
        s, y = xn - x, gn - g
        sy = torch.dot(s, y)
        keep, go = read_flags(sy > 1e-10, relative_change_exceeds(f_cur, fn, tol))
        reads += 1
        if keep:
            hist.push(s, y, sy)
        x, g, f_cur = xn, gn, fn
        if not go:
            break
    return x, f_cur, it, reads
