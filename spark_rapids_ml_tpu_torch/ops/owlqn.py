#
# The quasi-Newton family's shared pieces, on one device: the divergence
# guard, the L-BFGS two-loop recursion over circular (s, y) buffers, and
# OWL-QN (Andrew & Gao 2007), the L1-capable solver behind
# LogisticRegression's elastic net. The PyTorch counterpart of
# spark_rapids_ml_tpu/ops/owlqn.py (`check_solver_state`,
# `lbfgs_two_loop`, `_owlqn_setup` + `owlqn_minimize` as `owlqn_steps`).
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
# A hyperparameter grid (ROADMAP A9) runs its S solves in lockstep on the
# host: each solve is a generator that yields its device requests (a
# product over the rows, a transposed product, a flag read), and
# `run_lockstep` serves the requests of every live solve together: one
# product of [d, S·k] columns instead of S of [d, k], one flag read for the
# whole grid. A solve that stops issues no more requests, so its state is
# frozen exactly (the host-loop form of the JAX package's
# `freeze_when_done`, which the batched coordinate descent of
# ops/linear.py uses as a select). Each solve keeps its own `LbfgsMemory`,
# with its own push count and position, so every dot product of its
# two-loop has the shape of the sequential one.
#
# Checkpoints (checkpoint.py; the JAX package's `owlqn_minimize_segmented`
# and `glm_qn_minimize_segmented` over `run_segmented_while`): a single
# fit's loop takes a `LoopCheckpoint`, and every `every` iterations (and
# where the loop stops, as a segment ends there) saves its whole state in
# ONE device-to-host copy, then consults the chaos hooks. A fit that starts
# under an equal placement key continues from the saved state exactly. A
# batched grid takes none (the JAX package checkpoints the single fit only).
#
from __future__ import annotations

from typing import Any, Callable, Dict, Generator, List, Optional, Sequence, Tuple

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

    @classmethod
    def restored(cls, S: torch.Tensor, Y: torch.Tensor, rho: torch.Tensor, count: int, pos: int) -> "LbfgsMemory":
        """A history put back from a checkpoint's buffers and positions."""
        hist = cls.__new__(cls)
        hist.m, hist.S, hist.Y, hist.rho = S.shape[0], S, Y, rho
        hist.count, hist.pos = int(count), int(pos)
        return hist

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


class LoopCheckpoint:
    """The checkpoint boundary of one host-stepped solver loop: the place in
    the Python loop where the JAX package's `run_segmented_while` ends a
    segment. `active` gives one only when `checkpoint.solver_checkpoints_active()`
    (a cadence and a store), so a fit at cadence 0 does no checkpoint work
    and adds no host read."""

    def __init__(self, store, key: str, solver: str, every: int, placement_key=None) -> None:
        self.store, self.key, self.solver = store, key, solver
        self.every, self.placement_key = int(every), placement_key

    @classmethod
    def active(cls, key: Optional[str], solver: str, placement_key=None) -> Optional["LoopCheckpoint"]:
        from .. import checkpoint as _ckpt

        if key is None or not _ckpt.solver_checkpoints_active():
            return None
        return cls(_ckpt.active_store(), key, solver, _ckpt.every_iters(), placement_key)

    def restore(self):
        """(the checkpoint under this key and an EQUAL placement key, counted
        as a restore, or None; the portable iterate of one taken under
        another placement, or None)."""
        saved = self.store.peek(self.key)
        if saved is None:
            return None, None
        if saved.placement_key != self.placement_key:
            return None, saved.portable.get("x")
        self.store.load(self.key)  # counts the restore
        return saved, None

    def boundary(self, it: int, stop: bool) -> bool:
        """Whether iteration `it` ends a segment: every `every` iterations,
        and where the loop stops."""
        return stop or it % self.every == 0

    def save(self, it: int, tensors: Dict[str, torch.Tensor], host: Dict[str, Any]) -> int:
        """Save the loop's state after iteration `it`: `tensors` (of one
        dtype) in ONE device-to-host copy, beside the host values `host`,
        swept under SRML_NUMCHECK=1 at `segment.<solver>` (allow_inf: the
        loops' objectives start at +inf); then the mid-solve fault hooks
        `maybe_fail_oom("solve", it)` and `maybe_fail_stage("solve", it)`,
        after the checkpoint landed, and the scheduler's
        `preemption_point(solver, it)`. Returns the host reads made (1)."""
        from .. import checkpoint as _ckpt
        from ..parallel import chaos
        from ..scheduler.context import preemption_point
        from ..utils import numcheck

        flat = torch.cat([t.reshape(-1) for t in tensors.values()]).cpu().numpy()
        state: Dict[str, Any] = {}
        lo = 0
        for name, t in tensors.items():
            state[name] = flat[lo:lo + t.numel()].reshape(tuple(t.shape))
            lo += t.numel()
        _nc = numcheck.hook()
        if _nc is not None:
            # a NaN here would poison every later resume of this trajectory;
            # the bytes are on the host already
            _nc(f"segment.{self.solver}", solver=self.solver, iteration=it, allow_inf=True, **state)
        state.update(host)
        self.store.save(self.key, _ckpt.SolverCheckpoint(
            solver=self.solver, iteration=it, state=state, placement_key=self.placement_key,
            portable={"x": state["x"]},
        ))
        # then the scheduler's cooperative preemption: the job yields here
        # and its resumed attempt restores this checkpoint
        chaos.maybe_fail_oom("solve", it)
        chaos.maybe_fail_stage("solve", it)
        preemption_point(self.solver, it)
        return 1


def restore_tensor(state: Dict[str, Any], name: str, like: torch.Tensor) -> torch.Tensor:
    """A checkpointed array back on `like`'s device and dtype, in memory of
    its own (the loops update the history buffers in place)."""
    return torch.from_numpy(np.array(state[name])).to(device=like.device, dtype=like.dtype)


def relative_change_exceeds(f_prev: torch.Tensor, f_cur: torch.Tensor, tol: float) -> torch.Tensor:
    """The loops' convergence test on the device, at the objective's dtype:
    |f_prev − f_cur| / max(|f_cur|, 1) > tol (False for NaN)."""
    return torch.abs(f_prev - f_cur) / torch.clamp_min(torch.abs(f_cur), 1.0) > tol


def read_flags(*flags: torch.Tensor) -> List[bool]:
    """THE host read of the solvers: several 0-dim boolean device tensors
    fetched as one small tensor."""
    return [bool(v) for v in torch.stack(flags).tolist()]


def freeze_when_done(done: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per-element select of a batched update: elements whose `done` flag is
    set keep `old` exactly, the others take `new` (the JAX package's
    `freeze_when_done`, for the batched loops whose elements share one
    launch: `done` broadcasts over the trailing axes)."""
    return torch.where(done.reshape(done.shape + (1,) * (new.dim() - done.dim())), old, new)


# A solve of the lockstep driver: a generator that yields requests and is
# sent their answers; it returns its result.
#   ("mm", B [d, c])      -> matvec(B): X·B, [n, c]
#   ("rmat", R [n, c])    -> rmat(R): Xᵀ·R, [d, c]
#   ("read", [flags])     -> the flags (0-dim bool tensors) as host bools
Solve = Generator[Tuple[str, Any], Any, Any]
_REQUEST_ORDER = ("mm", "rmat", "read")


def _split_cols(out: torch.Tensor, widths: Sequence[int]) -> List[torch.Tensor]:
    """Columns of `out` back to their requesters, each contiguous (as a
    solve run alone receives it)."""
    parts, lo = [], 0
    for c in widths:
        parts.append(out[:, lo:lo + c].contiguous())
        lo += c
    return parts


def run_lockstep(solves: Sequence[Solve], matvec=None, rmat=None) -> Tuple[List[Any], int]:
    """Drive `solves` together until each has returned: every round serves
    the pending requests of one kind for all the solves that made it, the
    products first and the flag reads last, so solves that run in step
    share one product and one read. Returns (their results, the host reads
    made). A solve alone gets exactly the products and reads it would get
    in any grid where `matvec` and `rmat` are column-independent (those of
    ops/logistic.py `_dense_ops` work in fixed column blocks)."""
    results: List[Any] = [None] * len(solves)
    pending = {}

    def advance(i, answer):
        try:
            pending[i] = solves[i].send(answer)
        except StopIteration as stop:
            pending.pop(i, None)
            results[i] = stop.value

    for i in range(len(solves)):
        advance(i, None)
    reads = 0
    while pending:
        kind = next(k for k in _REQUEST_ORDER if any(r[0] == k for r in pending.values()))
        ids = [i for i in sorted(pending) if pending[i][0] == kind]
        payloads = [pending[i][1] for i in ids]
        if kind == "read":
            flat = read_flags(*[f for p in payloads for f in p])
            reads += 1
            answers, lo = [], 0
            for p in payloads:
                answers.append(flat[lo:lo + len(p)])
                lo += len(p)
        else:
            fn = matvec if kind == "mm" else rmat
            answers = _split_cols(fn(torch.cat(payloads, dim=1)), [p.shape[1] for p in payloads])
        for i, answer in zip(ids, answers):
            advance(i, answer)
    return results, reads


def owlqn_steps(
    value_fn: Callable[[torch.Tensor], Solve],
    grad_fn: Callable[[torch.Tensor, object], Solve],
    x0: torch.Tensor,  # flat [n]
    l1_mask: torch.Tensor,  # [n]: per-coordinate L1 weight multiplier (0 = unpenalized)
    lam1: float,
    *,
    max_iter: int,
    tol: float,
    memory: int = 10,
    ls_max: int = 25,
    c1: float = 1e-4,
    ckpt: Optional[LoopCheckpoint] = None,
) -> Solve:
    """OWL-QN as a solve of `run_lockstep`: minimize smooth(x) + lam1 ·
    Σ l1_mask·|x|.

    `value_fn(x)` is a solve returning (smooth(x), aux); `grad_fn(x, aux)`
    a solve returning the gradient of smooth at x from that aux. The line
    search backtracks from a = 1, halving at most `ls_max` times, on the
    projection of x + a·d onto x's orthant, with Armijo against the
    pseudo-gradient; an iteration whose search finds no step ends the loop
    (stalled). Returns (x, objective, n_iter, its own host reads); with
    lam1 = 0 it is plain two-loop L-BFGS. With `ckpt` (a single fit) the
    loop saves (x, g, f_cur, the history) at its boundaries and
    continues from a checkpoint of an equal placement (the JAX package's
    `owlqn_minimize_segmented`, which has no portable resume)."""
    lam = lam1 * l1_mask

    def f_total(x):
        f, aux = yield from value_fn(x)
        return f + torch.sum(lam * torch.abs(x)), aux

    def pseudo_grad(x, g):
        zero = torch.zeros_like(g)
        at0 = torch.where(g + lam < 0, g + lam, torch.where(g - lam > 0, g - lam, zero))
        return torch.where(x > 0, g + lam, torch.where(x < 0, g - lam, at0))

    saved = ckpt.restore()[0] if ckpt is not None else None
    if saved is not None:
        st = saved.state
        x, g, f_cur = (restore_tensor(st, n, x0) for n in ("x", "g", "f_cur"))
        hist = LbfgsMemory.restored(*(restore_tensor(st, n, x0) for n in ("S", "Y", "rho")), st["count"], st["pos"])
        it, reads = saved.iteration, 0
        if st["done"]:
            return x, f_cur, it, reads
    else:
        hist = LbfgsMemory(memory, x0.shape[0], x0)
        x = x0
        f_cur, aux = yield from f_total(x0)
        g = (yield from grad_fn(x0, aux)).to(x0.dtype)
        # the loop's test before its first iteration: f_prev = +inf, so it
        # holds exactly when f0 is finite; read with the first trial's flag
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
            fn, aux = yield from f_total(xn)
            passed = fn <= f_cur + c1 * torch.dot(pg, xn - x)
            if it == 0:
                passed, go = yield ("read", [passed, go_first])
                if not go:
                    return x0, f_cur, 0, reads + 1
            else:
                (passed,) = yield ("read", [passed])
            reads += 1
            if passed:
                ok = True
                break
            a *= 0.5
        it += 1
        if ok:
            gn = (yield from grad_fn(xn, aux)).to(x0.dtype)
            s, y = xn - x, gn - g
            sy = torch.dot(s, y)
            keep, go = yield ("read", [sy > 1e-10, relative_change_exceeds(f_cur, fn, tol)])
            reads += 1
            if keep:
                hist.push(s, y, sy)
            x, g, f_cur = xn, gn, fn
        # a search that found no step stalls the loop: the iterate and the
        # objective stay
        stop = not ok or not go or it >= max_iter
        if ckpt is not None and ckpt.boundary(it, stop):
            reads += ckpt.save(
                it, {"x": x, "g": g, "f_cur": f_cur, "S": hist.S, "Y": hist.Y, "rho": hist.rho},
                {"count": hist.count, "pos": hist.pos, "stalled": not ok, "done": stop},
            )
        if stop:
            break
    return x, f_cur, it, reads
