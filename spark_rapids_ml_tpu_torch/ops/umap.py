#
# UMAP on one device: the PyTorch counterpart of spark_rapids_ml_tpu/ops/umap.py,
# with the same stages, constants and force model:
#
#  * the kNN graph comes from exact kNN (ops/knn.exact_knn), whose distance
#    blocks are the d2-block kernel on the card (B3 float32);
#  * smooth-kNN calibration (each row's rho and sigma, 64 bisection steps)
#    and the fuzzy simplicial set (the transpose weights found by an
#    [n, k, k] membership probe) are torch ops over the [n, k] edge layout,
#    with JAX's CPU float32 exp (ops/prng.exp_f32) and its left-to-right
#    row sums, so given the same distances their weights are the JAX
#    package's bit for bit, on the CPU and the card;
#  * the spectral init runs deflated orthogonal iteration on the card; its
#    sums over the symmetrised edge list are fixed-order gathers
#    (`_SegmentSum`), not scatter-adds, so a fit is the same bit for bit
#    on every run;
#  * the SGD layout is a host loop over epochs of ~40 torch ops each: the
#    head side a per-row sum, the tail side a gather through the capped
#    inverse adjacency plus a second gather for the edges of hub nodes past
#    the cap (no scatter-add, whose order on the card is not fixed), and
#    the negative samples JAX's threefry draws (ops/prng.py) bit for bit.
#
# The host keeps what the JAX package keeps on the host: `find_ab_params`
# (scipy), `_inverse_adjacency`, `_self_first`, `categorical_intersection`,
# the precomputed_knn normalisation and the numpy draws (`u0`, the init
# noise, the random init).
#
from __future__ import annotations

import logging
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import prng
from .distance import ieee_f32_products

_LOG = logging.getLogger(__name__)

MIN_K_DIST_SCALE = 1e-3
# entries a row of `_SegmentSum`'s first level sums
SEGMENT_WIDTH = 32


def find_ab_params(spread: float, min_dist: float) -> Tuple[float, float]:
    """Fit the differentiable curve 1/(1+a*x^(2b)) to the desired fuzzy-member
    curve (umap-learn's find_ab_params)."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.ones_like(xv)
    mask = xv >= min_dist
    yv[mask] = np.exp(-(xv[mask] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """v rounded to float32, as a 0-d tensor on `like`'s device: how the
    JAX package's float32 programs see a Python scalar."""
    return torch.tensor(np.float32(v), device=like.device)


def _sum_last(t: torch.Tensor) -> torch.Tensor:
    """Sum over the (short) last dim left to right, the order of XLA's CPU
    row reductions: the same bits on the CPU and the card."""
    s = t[..., 0]
    for j in range(1, t.shape[-1]):
        s = s + t[..., j]
    return s


def _membership(knn_dist: torch.Tensor, rho: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """exp(-max(0, d - rho)/sigma) with JAX's CPU float32 exp
    (`prng.exp_f32`): the weights decide which edges are due in each SGD
    epoch (w_max/w against the epoch), and an edge whose weight moves by
    one bit off w_max moves a whole step there."""
    return prng.exp_f32(-torch.clamp_min(knn_dist - rho[:, None], 0.0) / sigma[:, None])


def smooth_knn(
    knn_dist: torch.Tensor,  # [n, k] ascending distances, col 0 = self (0.0)
    local_connectivity: float = 1.0,
    bandwidth: float = 1.0,
    n_iter: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (rho, sigma): rho = the distance to the local_connectivity-th
    nearest neighbour (interpolated); sigma solves
    sum_j exp(-max(0, d_ij - rho)/sigma) = log2(k) by `n_iter` bisection
    steps, floored at MIN_K_DIST_SCALE times the mean distance."""
    n, k = knn_dist.shape
    # the JAX package's target is a float64 scalar under jax_enable_x64
    # (its tests' setting), so each row's sum is compared in float64
    target = math.log2(k) * bandwidth

    # rho: the interpolated local_connectivity-th smallest NONZERO distance
    nonzero = knn_dist > 0.0
    num_nonzero = nonzero.sum(dim=1)
    big = knn_dist.max() + 1.0
    nz_sorted = torch.sort(torch.where(nonzero, knn_dist, big), dim=1).values
    lc = np.float32(local_connectivity)
    idx = int(np.floor(lc)) - 1
    frac = _f32(lc - np.floor(lc), knn_dist)
    if idx >= 0:
        lo = nz_sorted[:, idx]
        interp = prng._fma(frac, nz_sorted[:, min(idx + 1, k - 1)] - lo, lo)  # contracted as XLA does
    else:
        interp = frac * nz_sorted[:, 0]
    # fewer nonzero distances than local_connectivity: rho is the largest
    last = nz_sorted.gather(1, torch.clamp_min(num_nonzero - 1, 0)[:, None])[:, 0]
    rho = torch.where(
        num_nonzero.to(knn_dist.dtype) >= _f32(lc, knn_dist),
        interp,
        torch.where(num_nonzero > 0, last, torch.zeros_like(last)),
    )

    d = torch.clamp_min(knn_dist - rho[:, None], 0.0)
    lo = torch.zeros(n, dtype=knn_dist.dtype, device=knn_dist.device)
    hi = torch.full((n,), float("inf"), dtype=knn_dist.dtype, device=knn_dist.device)
    mid = torch.ones(n, dtype=knn_dist.dtype, device=knn_dist.device)
    for _ in range(n_iter):
        too_big = _sum_last(prng.exp_f32(-d / mid[:, None])).double() > target
        hi = torch.where(too_big, mid, hi)
        lo = torch.where(too_big, lo, mid)
        mid = torch.where(too_big | ~torch.isinf(hi), (lo + hi) / 2.0, mid * 2.0)
    # umap-learn's floor: sigma >= MIN_K_DIST_SCALE * the mean distance,
    # each mean a sum times the float32 constant MIN_K_DIST_SCALE * (1/count),
    # as XLA folds it (the global sum's order is torch's)
    scale = float(np.float32(MIN_K_DIST_SCALE) * np.float32(1.0 / k))
    scale_all = float(np.float32(MIN_K_DIST_SCALE) * np.float32(1.0 / knn_dist.numel()))
    floor = torch.where(rho > 0.0, _sum_last(knn_dist) * scale, knn_dist.sum() * scale_all)
    return rho, torch.maximum(mid, floor)


def fuzzy_simplicial_set(
    knn_idx: torch.Tensor,  # [n, k] neighbour indices (col 0 = self), int64
    knn_dist: torch.Tensor,  # [n, k]
    rho: torch.Tensor,
    sigma: torch.Tensor,
    set_op_mix_ratio: float = 1.0,
) -> torch.Tensor:
    """Symmetrised membership strengths in the fixed [n, k] edge layout.

    w_ij = exp(-max(0, d_ij - rho_i)/sigma_i); the transpose entry w_ji is
    found by probing for i in knn[j] ([n, k, k]), then
    sym = mix*(w + wT - w*wT) + (1-mix)*(w*wT)."""
    n, k = knn_idx.shape
    rows = torch.arange(n, device=knn_idx.device)
    w = _membership(knn_dist, rho, sigma)
    w = torch.where(knn_idx == rows[:, None], 0.0, w)  # no self-edges
    match = knn_idx[knn_idx] == rows[:, None, None]  # [n, k, k]
    wT = _sum_last(torch.where(match, w[knn_idx], 0.0))
    prod = w * wT
    # the second product fused into the sum, as XLA contracts it
    return prng._fma(prod, 1.0 - set_op_mix_ratio, set_op_mix_ratio * (w + wT - prod))


class _SegmentSum:
    """Sums of the values of sorted segments in an order fixed by the
    segments' lengths alone: `seg` [L] (ascending segment ids in [0, n))
    is cut into chunks of SEGMENT_WIDTH consecutive entries of one segment;
    each chunk is summed left to right by a gather, then each segment's
    chunks by a second gather. What `jax.ops.segment_sum` computes, without
    the atomic adds of a scatter on the card, whose order changes from run
    to run."""

    def __init__(self, seg: torch.Tensor, n: int, width: int = SEGMENT_WIDTH) -> None:
        L = seg.shape[0]
        dev = seg.device
        counts = torch.bincount(seg, minlength=n)
        pos = torch.arange(L, device=dev) - (torch.cumsum(counts, 0) - counts)[seg]
        n_chunks = (counts + width - 1) // width
        base = torch.cumsum(n_chunks, 0) - n_chunks
        total = int(n_chunks.sum())
        self.chunks = torch.full((total, width), L, dtype=torch.int64, device=dev)
        self.chunks[base[seg] + pos // width, pos % width] = torch.arange(L, device=dev)
        per_seg = max(1, int(n_chunks.max())) if n else 1
        j = torch.arange(per_seg, device=dev)
        self.segs = torch.where(j[None, :] < n_chunks[:, None], base[:, None] + j[None, :], total)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        pad = values.new_zeros((1,) + values.shape[1:])
        s1 = torch.cat([values, pad])[self.chunks].sum(dim=1)
        return torch.cat([s1, pad])[self.segs].sum(dim=1)


def _spectral_subspace(rows_s, cols_s, vals_s, u0, *, n: int, iters: int) -> torch.Tensor:
    """Deflated orthogonal iteration for the top `c` non-trivial
    eigenvectors of the normalised adjacency P = D^-1/2 A D^-1/2 of the
    row-sorted symmetric edge list: each matvec is one gather and one
    fixed-order segment sum, each round a [n, c] QR. Ends with a
    Rayleigh-Ritz rotation, columns by descending eigenvalue of P."""
    seg = _SegmentSum(rows_s, n)
    deg = seg(vals_s)
    dis = 1.0 / torch.sqrt(torch.clamp_min(deg, 1e-12))
    v0 = torch.sqrt(torch.clamp_min(deg, 0.0))
    v0 = v0 / torch.clamp_min(torch.linalg.vector_norm(v0), 1e-12)

    def pmat(U):  # (I + P)/2 @ U: the spectrum shifted into [0, 1], so
        # power iteration cannot lock onto the lambda ~ -1 modes of a
        # near-bipartite graph
        su = dis[:, None] * U
        pu = dis[:, None] * seg(vals_s[:, None] * su[cols_s])
        return 0.5 * (U + pu)

    U = u0
    for _ in range(iters):
        U = pmat(U)
        U = U - v0[:, None] * (v0 @ U)[None, :]  # deflate the trivial mode
        U = torch.linalg.qr(U).Q
    B = U.T @ pmat(U)
    _, R = torch.linalg.eigh((B + B.T) / 2.0)
    return U @ torch.flip(R, dims=[1])


def spectral_init(
    knn_idx: np.ndarray, weights: np.ndarray, n_components: int, seed: int, device: torch.device
) -> np.ndarray:
    """Normalised-Laplacian spectral layout of the fuzzy graph (umap-learn's
    spectral_layout), computed on `device` over the symmetrised edge list:
    120 rounds of `_spectral_subspace`, scaled to a largest coordinate of 10
    plus N(0, 1e-4) noise. Falls back to a uniform [-10, 10) init when the
    iteration does not stay finite."""
    from ..parallel import host_tensor

    n, k = knn_idx.shape
    rng = np.random.default_rng(seed)
    if n <= n_components + 1:
        return rng.uniform(-10, 10, (n, n_components)).astype(np.float32)
    rows = torch.arange(n, device=device).repeat_interleave(k)
    cols = host_tensor(knn_idx.reshape(-1).astype(np.int64)).to(device)
    vals = host_tensor(weights.reshape(-1).astype(np.float32) / 2.0).to(device)
    # (A + A^T)/2 as a doubled edge list, sorted by row once (stable)
    r2 = torch.cat([rows, cols])
    order = torch.sort(r2, stable=True).indices
    u0 = rng.normal(size=(n, n_components)).astype(np.float32)
    with ieee_f32_products():
        emb = _spectral_subspace(
            r2[order], torch.cat([cols, rows])[order], torch.cat([vals, vals])[order],
            host_tensor(u0).to(device), n=n, iters=120,
        ).cpu().numpy()
    if not np.all(np.isfinite(emb)):
        _LOG.warning("spectral initialization diverged; falling back to random init")
        return rng.uniform(-10, 10, (n, n_components)).astype(np.float32)
    expansion = 10.0 / max(np.abs(emb).max(), 1e-12)
    return (emb * expansion + rng.normal(0, 1e-4, emb.shape)).astype(np.float32)


def _inverse_adjacency(
    tail_idx: np.ndarray, n: int, cap: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side inverse adjacency of the [n, k] edge layout: inv[t, s] = flat
    edge id e (= i*k + j) whose tail is node t, padded with E, so the
    tail-side SGD update is a gather. In-degree is capped at `cap` (default
    max(64, min(8·k, 5e8 // (8n)))): a hub's edges past the cap come back as
    a flat-id overflow list. Returns (inv [n, k_in <= cap], overflow edge
    ids [E_ov])."""
    flat = tail_idx.reshape(-1).astype(np.int64)
    E = flat.shape[0]
    if cap is None:
        cap = max(64, min(8 * tail_idx.shape[1], int(5e8 // max(n * 8, 1))))
    counts = np.bincount(flat, minlength=n)
    k_in = int(min(counts.max(), cap)) if E else 0
    order = np.argsort(flat, kind="stable")
    sorted_t = flat[order]
    offs = np.arange(E) - (np.cumsum(counts) - counts)[sorted_t]
    keep = offs < k_in
    inv = np.full((n, max(k_in, 1)), E, dtype=np.int64)
    inv[sorted_t[keep], offs[keep]] = order[keep]
    return inv, order[~keep]


def _overflow_gather(tail_flat: np.ndarray, ov_idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The overflow edges as a second gather: (hubs [H], the tails they
    land on, each once; table [H, w] of their overflow edge ids in edge
    order, padded with E). Summing the table's rows adds each hub's
    overflow in a fixed order, where the JAX package scatter-adds it."""
    E = tail_flat.shape[0]
    hubs, which, counts = np.unique(tail_flat[ov_idx], return_inverse=True, return_counts=True)
    table = np.full((len(hubs), max(1, int(counts.max()) if len(hubs) else 1)), E, dtype=np.int64)
    if len(ov_idx):
        order = np.argsort(which, kind="stable")
        slot = np.arange(len(ov_idx)) - (np.cumsum(counts) - counts)[which[order]]
        table[which[order], slot] = ov_idx[order]
    return hubs, table


def negative_samples(seed: int, epoch: int, shape: Tuple[int, ...], m: int, device) -> torch.Tensor:
    """Epoch `epoch`'s negative samples, int64 on [0, m):
    jax.random.randint(fold_in(PRNGKey(seed), epoch), shape, 0, m) bit for
    bit, at JAX's default integer type under jax_enable_x64 (int64, 64-bit
    draws), the setting the JAX package's tests run it with, as the
    forests' float64 draws follow it too."""
    return prng.randint(prng.fold_in(prng.prng_key(seed, device), epoch), shape, 0, m, bit_width=64)


def optimize_embedding(
    Y0: torch.Tensor,  # [n, c] initial embedding (the optimised rows)
    ref: torch.Tensor,  # [m, c] frozen reference embedding (transform mode)
    tail_idx: torch.Tensor,  # [n, k] tail node of each edge (head = row), int64
    weights: torch.Tensor,  # [n, k] membership strengths
    inv_idx: Optional[torch.Tensor] = None,  # [n, k_in] capped inverse adjacency (fit mode)
    overflow: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (hubs, table), `_overflow_gather`
    *,
    n_epochs: int,
    a: float,
    b: float,
    gamma: float = 1.0,
    initial_alpha: float = 1.0,
    negative_sample_rate: int = 5,
    fit_mode: bool = True,
    seed: int = 0,
) -> torch.Tensor:
    """Epoch-scheduled SGD over the fuzzy graph, every due edge at once
    (umap-learn's optimize_layout_euclidean force model and
    epochs_per_sample schedule), one host iteration an epoch.

    `fit_mode=True`: tails index the optimised embedding and both ends of
    an edge move (the tail side through `inv_idx` and `overflow`).
    `fit_mode=False` (transform): tails index the frozen `ref`."""
    n, k = tail_idx.shape
    c = Y0.shape[1]
    E = n * k
    S = int(negative_sample_rate)
    w_max = weights.max()
    eps_per_sample = torch.where(
        weights > 0, w_max / torch.maximum(weights, _f32(1e-12, weights)), float("inf")
    )
    next_due = eps_per_sample - 1.0
    att_scale, rep_scale = -2.0 * a * b, 2.0 * gamma * b
    rows = torch.arange(n, device=Y0.device)
    Y = Y0
    for e in range(n_epochs):
        alpha = float(np.float32(initial_alpha) * (np.float32(1.0) - np.float32(e) / np.float32(n_epochs)))
        due = (next_due <= float(e)).to(Y.dtype)  # [n, k]

        tails = Y if fit_mode else ref
        diff = Y[:, None, :] - tails[tail_idx]  # [n, k, c]
        d2 = _sum_last(diff * diff)
        # attraction: the d2^(b-1) factor (negative exponent for b < 1)
        # takes a zero guard, not an exponent clamp
        d2_safe = torch.where(d2 > 0, d2, 1.0)
        att = (att_scale * d2_safe ** (b - 1.0)) / (1.0 + a * d2 ** b)
        att = torch.where(d2 > 0, att, 0.0)
        g_att = torch.clamp(att[..., None] * diff, -4.0, 4.0) * due[..., None]
        delta = alpha * g_att.sum(dim=1)  # head side
        if fit_mode:
            g_flat = torch.cat([g_att.reshape(E, c), g_att.new_zeros((1, c))])
            delta = delta - alpha * g_flat[inv_idx].sum(dim=1)
            if overflow is not None and overflow[0].numel():
                hubs, table = overflow
                delta[hubs] = delta[hubs] - alpha * g_flat[table].sum(dim=1)

        # repulsion from negative samples of the tail set
        neg = negative_samples(seed, e, (n, k, S), tails.shape[0], Y.device)
        diff_n = Y[:, None, None, :] - tails[neg]  # [n, k, S, c]
        d2n = _sum_last(diff_n * diff_n)
        rep = rep_scale / ((0.001 + d2n) * (1.0 + a * d2n ** b))
        g_rep = torch.clamp(rep[..., None] * diff_n, -4.0, 4.0)
        # coincident but distinct points repel at the clip bound; a point
        # drawn as its own negative adds nothing (umap-learn skips it)
        g_rep = torch.where(d2n[..., None] > 0, g_rep, 4.0)
        if fit_mode:
            g_rep = torch.where((neg == rows[:, None, None])[..., None], 0.0, g_rep)
        g_rep = g_rep * due[..., None, None]
        delta = delta + alpha * g_rep.sum(dim=(1, 2))

        next_due = torch.where(due > 0, next_due + eps_per_sample, next_due)
        Y = Y + delta
    return Y


def default_n_epochs(n: int) -> int:
    return 500 if n <= 10000 else 200


def _self_first(idx: np.ndarray, dist: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Normalise a kNN graph so column 0 is the point itself at distance 0
    (ties can reorder equal-distance neighbours; precomputed graphs may omit
    self entirely — then the farthest slot is sacrificed)."""
    n, k = idx.shape
    row = np.arange(n)
    self_pos = np.argmax(idx == row[:, None], axis=1)
    has_self = (idx == row[:, None]).any(axis=1)
    for i in np.flatnonzero(~has_self):  # degenerate duplicates / no self
        idx[i, -1] = i
        dist[i, -1] = 0.0
        self_pos[i] = k - 1
    idx[row, self_pos], idx[:, 0] = idx[:, 0].copy(), row
    dist[row, self_pos], dist[:, 0] = dist[:, 0].copy(), 0.0
    return idx, dist


def build_knn_graph(
    X: torch.Tensor, n_neighbors: int, batch_queries: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN graph of the rows X [n, d] (on the device) with the point
    itself in column 0: ([n, k] int32 ids, [n, k] float32 distances) on the
    host. The rows are the items and the queries; every distance block is
    the d2-block kernel on the card. `batch_queries` defaults to
    ``config["distance_tile_rows"]``."""
    from .knn import exact_knn

    dist, idx = exact_knn(X, None, X, k=n_neighbors, batch_queries=batch_queries)
    return _self_first(np.array(idx), np.array(dist, dtype=np.float32))


def categorical_intersection(
    weights: np.ndarray, knn_idx: np.ndarray, labels: np.ndarray, far_dist: float = 5.0
) -> np.ndarray:
    """Supervised fit: intersect the fuzzy set with the label metric —
    different-label edges are downweighted by exp(-far_dist) (umap-learn's
    categorical_simplicial_set_intersection with unknown labels untouched)."""
    lab_i = labels[:, None]
    lab_j = labels[knn_idx]
    known = ~(np.isnan(lab_i) | np.isnan(lab_j))
    differ = known & (lab_i != lab_j)
    return np.where(differ, weights * np.exp(-far_dist), weights).astype(weights.dtype)


def _normalized_precomputed(pre_idx, pre_dist, n: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """A caller's (knn_indices, knn_dists) [n, >=k] pair as the graph:
    the row itself in column 0 at distance 0, then its k-1 nearest other
    entries (a self entry elsewhere in the row is dropped)."""
    pre_idx = np.asarray(pre_idx)
    pre_dist = np.asarray(pre_dist, dtype=np.float32)
    if pre_idx.shape != pre_dist.shape or pre_idx.shape[0] != n or pre_idx.shape[1] < k:
        raise ValueError(
            f"precomputed_knn must be ([n, >=k], [n, >=k]) over the fit rows; "
            f"got {pre_idx.shape}/{pre_dist.shape} for n={n}, k={k}"
        )
    # a -1-distance self column beats every real distance; a self entry
    # the caller gave goes to +inf; a stable row sort keeps the k best
    rows = np.arange(n)
    dist_m = np.where(pre_idx == rows[:, None], np.inf, pre_dist)
    idx_aug = np.concatenate([rows[:, None].astype(pre_idx.dtype), pre_idx], axis=1)
    dist_aug = np.concatenate([np.full((n, 1), -1.0, np.float32), dist_m.astype(np.float32)], axis=1)
    order = np.argsort(dist_aug, axis=1, kind="stable")[:, :k]
    knn_idx = np.take_along_axis(idx_aug, order, axis=1)
    knn_dist = np.take_along_axis(dist_aug, order, axis=1)
    knn_dist[:, 0] = 0.0
    return knn_idx, knn_dist


def umap_fit(
    x: np.ndarray,
    y: Optional[np.ndarray],
    *,
    device: torch.device,
    n_neighbors: int = 15,
    n_components: int = 2,
    n_epochs: Optional[int] = None,
    learning_rate: float = 1.0,
    init: str = "spectral",
    min_dist: float = 0.1,
    spread: float = 1.0,
    set_op_mix_ratio: float = 1.0,
    local_connectivity: float = 1.0,
    repulsion_strength: float = 1.0,
    negative_sample_rate: int = 5,
    a: Optional[float] = None,
    b: Optional[float] = None,
    random_state: Optional[int] = None,
    precomputed_knn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    metric: str = "euclidean",
) -> Dict[str, np.ndarray]:
    """Full UMAP fit of the host rows `x` on `device`: {'embedding_' [n, c],
    'a_', 'b_'}.

    `precomputed_knn` is a (knn_indices, knn_dists) pair of [n, >=k] arrays
    over these rows; the graph build is skipped. metric="cosine" scales the
    rows to unit norm, builds the graph with the euclidean kernel (the same
    neighbour ranking on unit rows) and stores d_cos = d²/2; the layout is
    metric-free."""
    from ..parallel import host_tensor
    from ..utils import unit_rows

    if metric not in ("euclidean", "cosine"):
        raise ValueError(f"metric must be 'euclidean' or 'cosine', got {metric!r}")
    x = np.ascontiguousarray(unit_rows(x) if metric == "cosine" else x, dtype=np.float32)
    n = x.shape[0]
    k = min(n_neighbors, n)
    seed = int(random_state if random_state is not None else 0)
    if a is None or b is None:
        a, b = find_ab_params(spread, min_dist)
    n_epochs = int(n_epochs) if n_epochs else default_n_epochs(n)

    if precomputed_knn is not None:
        knn_idx, knn_dist = _normalized_precomputed(*precomputed_knn, n, k)
    else:
        knn_idx, knn_dist = build_knn_graph(host_tensor(x).to(device), k)
        if metric == "cosine":
            knn_dist = (knn_dist * knn_dist) / 2.0  # unit rows: 1 - cos
    dist_t = host_tensor(knn_dist).to(device)
    idx_t = host_tensor(knn_idx.astype(np.int64)).to(device)
    rho, sigma = smooth_knn(dist_t, local_connectivity)
    w = fuzzy_simplicial_set(idx_t, dist_t, rho, sigma, set_op_mix_ratio).cpu().numpy()
    if y is not None:
        w = categorical_intersection(w, knn_idx, np.asarray(y, dtype=np.float64))

    if init == "spectral":
        Y0 = spectral_init(knn_idx, w, n_components, seed, device)
    else:
        Y0 = np.random.default_rng(seed).uniform(-10, 10, (n, n_components)).astype(np.float32)

    # umap-learn drops the edges below max_w/n_epochs before optimising
    w_opt = np.where(w >= w.max() / float(n_epochs), w, 0.0).astype(np.float32)
    inv, ov = _inverse_adjacency(knn_idx, n)
    hubs, table = _overflow_gather(knn_idx.reshape(-1).astype(np.int64), ov)
    Y0_t = host_tensor(Y0).to(device)
    Y = optimize_embedding(
        Y0_t, Y0_t, idx_t, host_tensor(w_opt).to(device), host_tensor(inv).to(device),
        (host_tensor(hubs.astype(np.int64)).to(device), host_tensor(table).to(device)),
        n_epochs=n_epochs, a=float(a), b=float(b), gamma=float(repulsion_strength),
        initial_alpha=float(learning_rate), negative_sample_rate=int(negative_sample_rate),
        fit_mode=True, seed=seed,
    )
    return {
        "embedding_": Y.cpu().numpy().astype(np.float32),
        "a_": np.float64(a),
        "b_": np.float64(b),
    }


def umap_transform(
    x_new: np.ndarray,
    raw_data: np.ndarray,
    embedding: np.ndarray,
    *,
    device: torch.device,
    n_neighbors: int = 15,
    n_epochs: Optional[int] = None,
    learning_rate: float = 1.0,
    local_connectivity: float = 1.0,
    repulsion_strength: float = 1.0,
    negative_sample_rate: int = 5,
    a: float = 1.577,
    b: float = 0.895,
    random_state: Optional[int] = None,
    metric: str = "euclidean",
) -> np.ndarray:
    """Embed new rows against a fitted model on `device`: exact kNN into the
    training rows (the d2-block kernel on the card), smooth-kNN weights, the
    weighted mean of the neighbours' embeddings as the init, then a short
    SGD against the frozen training embedding (umap-learn's transform).
    metric="cosine" follows the fit's convention (unit rows on both sides,
    d_cos = d²/2)."""
    from ..parallel import host_tensor
    from ..utils import unit_rows
    from .knn import exact_knn

    x_new = np.ascontiguousarray(x_new, dtype=np.float32)
    raw_data = np.ascontiguousarray(raw_data, dtype=np.float32)
    if metric == "cosine":
        x_new = np.ascontiguousarray(unit_rows(x_new))
        raw_data = np.ascontiguousarray(unit_rows(raw_data))
    n_new = x_new.shape[0]
    k = min(n_neighbors, raw_data.shape[0])
    seed = int(random_state if random_state is not None else 0)

    dist, idx = exact_knn(host_tensor(raw_data).to(device), None, host_tensor(x_new).to(device), k=k)
    dist = np.asarray(dist, np.float32)
    if metric == "cosine":
        dist = (dist * dist) / 2.0
    dist_t = host_tensor(dist).to(device)
    rho, sigma = smooth_knn(dist_t, local_connectivity)
    wgt = _membership(dist_t, rho, sigma).cpu().numpy()
    wsum = np.maximum(wgt.sum(axis=1, keepdims=True), 1e-12)
    Y0 = (wgt[:, :, None] * embedding[idx]).sum(axis=1) / wsum

    # umap-learn's transform schedule: an explicit n_epochs runs a third of
    # it (0 epochs returns the weighted-mean init); by default 100 epochs
    # for up to 10000 transformed rows, 30 beyond
    total_epochs = int(n_epochs) // 3 if n_epochs is not None else (100 if n_new <= 10000 else 30)
    Y = optimize_embedding(
        host_tensor(Y0.astype(np.float32)).to(device),
        host_tensor(np.ascontiguousarray(embedding, dtype=np.float32)).to(device),
        host_tensor(idx.astype(np.int64)).to(device), host_tensor(wgt.astype(np.float32)).to(device), None,
        n_epochs=total_epochs, a=float(a), b=float(b), gamma=float(repulsion_strength),
        initial_alpha=float(learning_rate), negative_sample_rate=int(negative_sample_rate),
        fit_mode=False, seed=seed,
    )
    return Y.cpu().numpy().astype(np.float32)
