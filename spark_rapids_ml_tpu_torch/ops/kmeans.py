#
# KMeans solver on one device: Lloyd iterations over row tiles through the
# distance core (ops/distance.py), the seeders, and predict. The PyTorch
# counterpart of spark_rapids_ml_tpu/ops/kmeans.py.
#
# The JAX package has three step programs (_lloyd_step, _lloyd_step_fused_1dev,
# _lloyd_step_1dev) that compute the same thing and differ only in how XLA
# buffers X. PyTorch runs eagerly, so one device needs one host loop over row
# tiles of `batch_rows` rows (`distance.tile_assign_accumulate`). In a
# multi-process fit each rank scans its own rows and the step's sums,
# counts and inertia are summed across ranks (`allreduce_fixed`, the rank
# partials added in rank order) before the center update, so every rank
# computes the same centers and the same shift, and every rank's host loop
# stops at the same iteration. The loop, its checkpoints and the streamed
# form run unchanged.
#
# Solver checkpoints (checkpoint.py): with `config["checkpoint_every_iters"]`
# > 0 inside a fit stage, the Lloyd loop saves its centers, the divergence
# fallback iterate and the deferred shift every that many iterations, under
# `kmeans_ckpt_key` (the JAX package's key), and a retried fit resumes from
# the last one. The loop is shared by the resident and the streamed fit
# (ops/streaming.py), so a resident fit's checkpoint resumes the OOM
# ladder's streamed retry. Centers are the whole state of a Lloyd step, so
# a resumed fit equals an uninterrupted one bit for bit.
#
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..parallel.context import allreduce_fixed
from . import prng
from .distance import _topk_lex, argmin_assign, min_d2_update, row_sq, tile_assign_accumulate
from .sparse import segment_sums


def _finish_centers(sums, counts, inertia, centers):
    # empty clusters keep their previous center (cuML behavior)
    new_centers = torch.where(
        counts[:, None] > 0, sums / torch.clamp_min(counts, 1e-30)[:, None], centers
    )
    shift = torch.sum((new_centers - centers) ** 2)
    return new_centers, inertia, shift


def _lloyd_step(X, w, centers, batch_rows, fast=False):
    """One Lloyd iteration: tiled assignment + accumulation, summed across
    ranks in a multi-process fit, then the center update. Returns (new
    centers, inertia of the entering centers, shift)."""
    sums, counts, inertia = allreduce_fixed(*tile_assign_accumulate(X, w, centers, batch_rows, fast))
    return _finish_centers(sums, counts, inertia, centers)


def kmeans_ckpt_key(init_centers, max_iter: int, tol: float) -> str:
    """The checkpoint key of one Lloyd trajectory, the JAX package's string:
    the init centers' digest and shape and the loop statics. One format for
    the resident and the streamed loop, so a resident fit's checkpoint
    resumes a streamed retry and the other way round (the callers append
    ":bf16" for a `fast` trajectory)."""
    import hashlib

    init = init_centers.cpu().numpy() if isinstance(init_centers, torch.Tensor) else np.asarray(init_centers)
    init_digest = hashlib.sha1(np.ascontiguousarray(init).tobytes()).hexdigest()[:12]
    return f"kmeans:{tuple(np.shape(init))}:{init_digest}:{max_iter}:{tol}"


def _raise_diverged(iteration: int, last_good_centers, detail: str) -> None:
    """Typed divergence error off the already-fetched per-iteration shift:
    carries the iterate that ENTERED the diverging update (still finite)."""
    from ..errors import SolverDivergedError

    raise SolverDivergedError(
        "kmeans",
        iteration,
        last_good={"cluster_centers_": last_good_centers.cpu().numpy()},
        detail=detail,
    )


def lloyd_loop(
    step, centers, *, max_iter: int, tol: float, fast: bool, final_inertia: bool = True, solver: str = "kmeans",
    init_centers=None,
):
    """The Lloyd host loop over `step(centers, fast)` -> (new centers,
    inertia of the entering centers, shift): one pass over the rows each,
    resident (`_lloyd_step`) or streamed (ops/streaming.py). The convergence
    check one iteration late, the last-good iterate, the divergence guard
    and the final inertia at full precision; see `kmeans_fit`. Under
    SRML_NUMCHECK=1 the shift each iteration reads anyway is swept at
    `<solver>.iterate` (utils/numcheck.py), and each checkpoint's centers
    at `kmeans.checkpoint`.

    Checkpoints: when `checkpoint.solver_checkpoints_active()`, the loop
    resumes from the store's entry under `kmeans_ckpt_key(init_centers,
    ...)` (the host array the fit was seeded with; `centers` when None),
    and every `every_iters()` iterations saves (centers, the deferred shift,
    the last-good iterate) in one device-to-host copy, then consults the
    chaos hooks `maybe_fail_oom("solve", n_iter)` and
    `maybe_fail_stage("solve", n_iter)`, so a retried fit provably resumes,
    and the scheduler's `preemption_point(solver, n_iter)`, so a preempted
    job resumes there."""
    from .. import checkpoint as _ckpt
    from ..utils import numcheck

    _nc = numcheck.hook()  # resolved once per solve; None when off
    n_iter = 0
    prev_shift = None
    last_good = centers  # iterate entering the step that produced prev_shift
    ckpt_store = _ckpt.active_store()
    ckpt_every = _ckpt.every_iters()
    ckpt_key = None
    if ckpt_store is not None and ckpt_every > 0:
        # the key names THIS trajectory (the init centers' digest and the
        # loop statics): the sequential solves of one stage share the store.
        # A `fast` trajectory walks another path, so it is keyed apart, with
        # the same suffix on the resident and the streamed loop
        ckpt_key = kmeans_ckpt_key(centers if init_centers is None else init_centers, max_iter, tol)
        if fast:
            ckpt_key += ":bf16"
        saved = ckpt_store.load(ckpt_key)
        if saved is not None and tuple(saved.state["centers"].shape) == tuple(centers.shape):
            def _dev(a):
                return torch.from_numpy(np.array(a)).to(device=centers.device, dtype=centers.dtype)

            centers = _dev(saved.state["centers"])
            # last_good is the iterate ENTERING the step that produced
            # prev_shift, one step behind the checkpointed centers
            lg = saved.state.get("last_good")
            last_good = centers if lg is None else _dev(lg)
            n_iter = int(saved.iteration)
            ps = saved.state.get("prev_shift")
            prev_shift = None if ps is None else float(ps)
    while n_iter < max_iter:
        step_in = centers
        centers, inertia, shift = step(centers, fast)
        n_iter += 1
        if prev_shift is not None:
            shift_host = float(prev_shift)
            if not math.isfinite(shift_host):
                _raise_diverged(n_iter - 1, last_good, f"center shift = {shift_host}")
            if _nc is not None:
                # after the divergence guard (SolverDivergedError owns a
                # non-finite shift): the scalar already read, and the
                # iterate's dtype as a watermark, with no new read
                _nc(f"{solver}.iterate", solver=solver, iteration=n_iter - 1,
                    watermark=str(centers.dtype).replace("torch.", ""), shift=shift_host)
            if shift_host <= tol:
                break
        prev_shift = shift
        last_good = step_in
        if ckpt_key is not None and n_iter % ckpt_every == 0:
            # ONE device-to-host copy of the boundary's state; the shift
            # survives the round trip exactly, so the resumed convergence
            # test reads what the uninterrupted run would
            k = centers.numel()
            flat = torch.cat([centers.reshape(-1), last_good.reshape(-1), prev_shift.reshape(1)]).cpu().numpy()
            centers_host = flat[:k].reshape(tuple(centers.shape))
            prev_shift = float(flat[-1])
            if _nc is not None:
                # the checkpoint already fetched the whole iterate: sweep it
                # (a non-finite checkpoint would poison every later resume)
                _nc("kmeans.checkpoint", solver="kmeans", iteration=n_iter, centers=centers_host)
            ckpt_store.save(ckpt_key, _ckpt.SolverCheckpoint(
                solver="kmeans", iteration=n_iter,
                state={
                    "centers": centers_host,
                    "prev_shift": prev_shift,
                    # the divergence-fallback iterate (one step behind)
                    "last_good": flat[k:2 * k].reshape(tuple(centers.shape)),
                },
            ))
            # the mid-solve fault injection points fire AFTER the boundary's
            # checkpoint landed, so a retried fit (the bounded transient
            # retry, or the OOM ladder's streamed retry) resumes from it; so
            # does the scheduler's cooperative preemption, whose resumed job
            # restores this iterate ("kmeans" resident, "kmeans_stream"
            # streamed, as the JAX package names them)
            from ..parallel import chaos
            from ..scheduler.context import preemption_point

            chaos.maybe_fail_oom("solve", n_iter)
            chaos.maybe_fail_stage("solve", n_iter)
            preemption_point(solver, n_iter)
    if not final_inertia:
        inertia = torch.full((), float("nan"), dtype=centers.dtype, device=centers.device)
    else:
        _, inertia, _ = step(centers, False)
        inertia_host = float(inertia)
        if not math.isfinite(inertia_host):
            # the deferred check trails by one fetch: a divergence on the
            # FINAL step (or a 1-iteration fit) is caught here
            _raise_diverged(n_iter, last_good, f"final inertia = {inertia_host}")
    return {
        "cluster_centers_": centers,
        "inertia_": inertia,
        "n_iter_": torch.tensor(n_iter, dtype=torch.int32),
    }


def kmeans_fit(
    X: torch.Tensor,
    w: torch.Tensor,
    init_centers,
    *,
    max_iter: int = 20,
    tol: float = 1e-4,
    batch_rows: int = 32768,
    precision_mode: str = "fast",
    final_inertia: bool = True,
) -> Dict[str, torch.Tensor]:
    """Lloyd's algorithm on rows X [n, d] with weights w [n], on X's device.
    Returns cluster_centers_ [k, d], inertia_, n_iter_.

    Convergence: squared center movement <= tol (sklearn/cuML semantics).
    The check is one iteration LATE, as in the JAX package: the shift of
    iteration i-1 is fetched to the host while iteration i is queued, so the
    host waits once per iteration and `n_iter_` is the JAX package's (at most
    one higher than sklearn's; the extra iteration runs at the converged
    fixpoint). A non-finite shift raises SolverDivergedError.

    precision_mode: "fast" (float32 only) runs the in-loop distance and
    center-update products in bf16 with float32 accumulation; "high" keeps
    the input precision. The reported inertia is recomputed with the final
    centers at high precision in both modes; with ``final_inertia=False``
    (the IVF coarse quantizer and the PQ codebooks, which read no inertia)
    that pass is skipped and `inertia_` is NaN. `init_centers` is a host
    array or a tensor on X's device."""
    if isinstance(init_centers, torch.Tensor):
        centers = init_centers.to(device=X.device, dtype=X.dtype)
    else:
        centers = torch.as_tensor(np.asarray(init_centers), dtype=X.dtype).to(X.device)
    return lloyd_loop(
        lambda c, f: _lloyd_step(X, w, c, batch_rows, f), centers, max_iter=max_iter, tol=tol,
        fast=precision_mode == "fast" and X.dtype == torch.float32, final_inertia=final_inertia,
        init_centers=init_centers,
    )


def kmeans_predict(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center assignment for a batch of rows (transform path),
    row-tiled through the distance core (`distance.argmin_assign`,
    `config["distance_tile_rows"]` rows per tile)."""
    return argmin_assign(X, centers)


_INIT_SAMPLE_CAP = 262_144  # rows used for seeding (both init paths)
INIT_ROUNDS = 5  # k-means|| oversampling rounds


def _init_subsample(x_host, sample_weight, rng):
    """Bounded (row, weight) subsample shared by both seeding paths."""
    n = x_host.shape[0]
    if n > _INIT_SAMPLE_CAP:
        idx = np.sort(rng.choice(n, _INIT_SAMPLE_CAP, replace=False))
        x = np.ascontiguousarray(np.asarray(x_host[idx], dtype=np.float64))
        sw = None if sample_weight is None else np.asarray(sample_weight[idx], dtype=np.float64)
    else:
        x = np.ascontiguousarray(np.asarray(x_host, dtype=np.float64))
        sw = None if sample_weight is None else np.asarray(sample_weight, dtype=np.float64)
    if sw is None:
        sw = np.ones(x.shape[0])
    return x, sw


def _kmeanspp_device(x: torch.Tensor, sw: torch.Tensor, seed: int, *, k: int) -> torch.Tensor:
    """Classic k-means++ on the device, draw for draw the JAX package's
    `_kmeanspp_device`: from PRNGKey(seed), `key, sub = split(key)` before
    each of the k draws, and each draw one float32 uniform of `sub` scaled
    by the last element of the cumulative sum of d^2 * weight (the weights
    alone for the first), then `searchsorted`. The key chain and its
    uniforms are hashed on the host up front (ops/prng.py) and sent to the
    device once, so the loop never waits for the host."""
    n, d = x.shape
    x_sq = row_sq(x)
    u = prng.uniform_f32_of(prng.key_chain(seed, k))
    u = torch.from_numpy(u).to(x.device)  # float32, as the weights are

    def sample(probs, i):
        c = torch.cumsum(probs, dim=0)
        return torch.clamp(torch.searchsorted(c, u[i:i + 1] * c[-1]), 0, n - 1)

    idx = torch.empty((k,), dtype=torch.int64, device=x.device)
    idx[0:1] = sample(sw, 0)
    closest = torch.full((n,), float("inf"), dtype=x.dtype, device=x.device)
    for i in range(1, k):
        prev = x.index_select(0, idx[i - 1:i])[0]
        d2 = x_sq - 2.0 * (x @ prev) + torch.sum(prev * prev)
        closest = torch.minimum(closest, torch.clamp_min(d2, 0.0))
        probs = closest * sw
        probs = torch.where(torch.sum(probs) > 0, probs, sw)  # degenerate: all points covered
        idx[i:i + 1] = sample(probs, i)
    return x.index_select(0, idx)


def scalable_kmeans_init(
    x_host, k: int, seed: int, sample_weight=None, rounds: int = INIT_ROUNDS, *, device: torch.device
):
    """k-means|| (Bahmani et al.) seeding — the reference's
    'scalable-k-means++'. Each round computes distances to ONLY the new
    candidates on the device, samples ~2k further candidates with
    probability ∝ d² on the host, then the ~2k·rounds candidate set is
    weighted by assignment counts (the argmin kernel, through
    `argmin_assign`) and reduced to k with k-means++ on the device."""
    rng = np.random.default_rng(seed)
    x, sw = _init_subsample(x_host, sample_weight, rng)
    x = x.astype(np.float32)
    n_sub = x.shape[0]
    l = max(1, 2 * k)  # oversampling factor per round

    xd = torch.from_numpy(x).to(device)
    # every candidate block is padded to exactly l rows by repeating one row
    # (duplicates never change a running min-distance), as in the JAX package
    first = np.broadcast_to(x[rng.choice(n_sub, p=sw / sw.sum())], (l, x.shape[1]))
    cand_list = [np.ascontiguousarray(first)]
    min_d2 = min_d2_update(
        xd, torch.from_numpy(cand_list[0]).to(device),
        torch.full((n_sub,), float("inf"), dtype=torch.float32, device=device),
    )
    for _ in range(rounds):
        probs = np.maximum(min_d2.cpu().numpy(), 0.0) * sw
        s = probs.sum()
        # without-replacement sampling needs enough nonzero-probability rows
        n_new = min(l, n_sub, int(np.count_nonzero(probs)))
        if s <= 0 or n_new == 0:
            break
        new_idx = rng.choice(n_sub, size=n_new, replace=False, p=probs / s)
        new = x[np.sort(new_idx)]
        if n_new < l:  # pad to the fixed block shape
            new = np.concatenate([new, np.broadcast_to(new[0], (l - n_new, new.shape[1]))])
        cand_list.append(new)
        min_d2 = min_d2_update(xd, torch.from_numpy(np.ascontiguousarray(new)).to(device), min_d2)
    cand = np.concatenate(cand_list, axis=0)
    cand_d = torch.from_numpy(cand).to(device)
    # weight candidates by how many points they own (one assignment pass);
    # duplicate (padding) rows lose every argmin tie, so they get weight 0
    assign = argmin_assign(xd, cand_d).cpu().numpy()
    weights = np.bincount(assign, weights=sw, minlength=len(cand)).astype(np.float32)
    centers = _kmeanspp_device(
        cand_d, torch.from_numpy(np.maximum(weights, 1e-12)).to(device), seed + 1, k=k
    )
    return centers.cpu().numpy().astype(np.float64)


def _kmeanspar_round(xd, cand_prev, min_d2, sw, key, *, l: int):
    """One k-means|| round on the device (the JAX package's
    `_kmeanspar_round`): the running min-d² against the previous candidate
    block, then `l` new candidates drawn without replacement with
    probability ∝ d²·w by Gumbel-top-l (keys log p + Gumbel(0, 1), the
    uniform on [1e-20, 1) at JAX's default float dtype, float64 as the JAX
    package's tests run it). Returns (candidate block [l, d], min_d2)."""
    min_d2 = min_d2_update(xd, cand_prev, min_d2)
    probs = min_d2 * sw
    # degenerate (all points covered): uniform by weight
    probs = torch.where(torch.sum(probs) > 0, probs, sw)
    u = prng.uniform(key, (xd.shape[0],), torch.float64, minval=1e-20, maxval=1.0)
    gumbel = -torch.log(-torch.log(u))
    keys = torch.where(probs > 0, prng.log_f32(probs) + gumbel, float("-inf"))
    _, idx = _topk_lex(-keys[None, :], l)  # jax.lax.top_k(keys, l): the lower row first on ties
    return xd.index_select(0, idx[0]), min_d2


def scalable_kmeans_init_device(
    xd: torch.Tensor, k: int, seed: int, sample_weight=None, rounds: int = 5
) -> torch.Tensor:
    """k-means|| seeding with every step on the device, for rows already
    placed there (the ANN index builds): the JAX package's
    `scalable_kmeans_init_device`, draw for draw. The first candidate is
    `categorical` over log-weights, repeated to a block of l = min(2k, n)
    rows; each of `rounds` rounds is `_kmeanspar_round`; the candidates are
    weighted by the rows they own (the argmin kernel through
    `argmin_assign`, then the row weights summed per candidate in a fixed
    order, `sparse.segment_sums`) and reduced to
    k by `_kmeanspp_device(seed + 1)`. Returns [k, d] float32 centers on
    the device; no row, distance or weight goes to the host."""
    n, d = xd.shape
    l = max(1, min(2 * k, n))
    if sample_weight is None:
        sw = torch.ones((n,), dtype=torch.float32, device=xd.device)
    else:
        sw = torch.as_tensor(sample_weight, dtype=torch.float32).to(xd.device)
    key = prng.prng_key(seed, xd.device)
    k0, key = prng.split(key)
    i0 = prng.categorical(k0, prng.log_f32(torch.clamp_min(sw, 1e-30)))
    blocks = [xd.index_select(0, i0.reshape(1)).expand(l, d)]
    min_d2 = torch.full((n,), float("inf"), dtype=torch.float32, device=xd.device)
    for _ in range(rounds):
        key, kr = prng.split(key)
        cand, min_d2 = _kmeanspar_round(xd, blocks[-1], min_d2, sw, kr, l=l)
        blocks.append(cand)
    cand_all = torch.cat(blocks, dim=0)
    # duplicate rows (the first block) lose every argmin tie to the first
    # copy, so they own nothing. The weights are summed in an order the
    # assignment fixes (a float index_add_ on the card did not give the same
    # bits twice: fault C7)
    assign = argmin_assign(xd, cand_all)
    weights = segment_sums(sw, assign, cand_all.shape[0])
    return _kmeanspp_device(
        cand_all, torch.clamp_min(weights, 1e-12), seed + 1, k=min(k, cand_all.shape[0])
    )


def kmeans_plus_plus_init(x_host, k: int, seed: int, sample_weight=None):
    """k-means++ seeding on the host (numpy), optionally on a subsample —
    the small-k init of Spark's default ``k-means||`` mode."""
    rng = np.random.default_rng(seed)
    x, sw = _init_subsample(x_host, sample_weight, rng)
    centers = np.empty((k, x.shape[1]), dtype=np.float64)
    p = sw / sw.sum()
    centers[0] = x[rng.choice(x.shape[0], p=p)]
    closest = np.full(x.shape[0], np.inf)
    for i in range(1, k):
        d2 = np.sum((x - centers[i - 1]) ** 2, axis=1)
        closest = np.minimum(closest, d2)
        probs = closest * sw
        s = probs.sum()
        if s <= 0:
            centers[i] = x[rng.choice(x.shape[0], p=p)]
        else:
            centers[i] = x[rng.choice(x.shape[0], p=probs / s)]
    return centers


def random_init(x_host, k: int, seed: int):
    """Sample k distinct rows as initial centers (initMode='random')."""
    rng = np.random.default_rng(seed)
    n = x_host.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds number of rows {n}")
    idx = rng.choice(n, k, replace=False)
    return np.asarray(x_host[idx], dtype=np.float64)
