#
# DBSCAN on one device: the PyTorch counterpart of
# spark_rapids_ml_tpu/ops/dbscan.py.
#
# Three passes over the rows, each a host loop over row tiles of one
# [tile, n] distance product (ops/distance.pairwise_d2, cuBLAS) and its
# threshold at eps; only [n]-sized results come back to the host:
#
#   1. CORE pass: each row's eps-neighbour count (itself included) against
#      min_samples gives the core mask;
#   2. EXPANSION: connected components of the core-core eps-graph, on the
#      core rows alone (nc x nc a round), by min-label propagation with two
#      pointer-jumping hops a round, until a round changes no label (one
#      flag read a round);
#   3. BORDER pass: every row takes the minimum cluster id among its
#      eps-neighbouring core rows, or -1 (noise) when it has none.
#
# Cluster ids are the ranks of the components' roots, each root the
# component's smallest core index: sklearn's and cuML's numbering. A border
# row within eps of two clusters takes the lower id (deterministic, where
# sklearn's is scan order). `max_mbytes_per_batch` sizes the tile, as in
# the JAX package; labels do not depend on it.
#
# A multi-process transform (the JAX package's replicated-data SPMD) gives
# every rank all the rows; each pass splits its row tiles between the ranks
# on the one-process tile boundaries and gathers the per-row results in
# rank order over the process group. Nothing is padded: every row and
# column here is real.
#
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .distance import ieee_f32_products, pairwise_d2


def _tile_rows_for_budget(n: int, max_mbytes: Optional[int], default: int = 8192) -> int:
    """Rows per distance tile so one [tile, n] f32 tile fits the budget."""
    if not max_mbytes:
        return default
    rows = int(max_mbytes * 1e6 / (4 * max(n, 1)))
    return max(64, min(rows, max(n, 64)))


def _tiles(n: int, tile_rows: int, group=None):
    """The row tiles [s, e) of n rows; with a process `group`, this rank's
    share of the one-process tiles: a contiguous run, rank r taking tiles
    [r·T // R, (r+1)·T // R) of the T tiles."""
    tiles = [(s, min(s + tile_rows, n)) for s in range(0, n, tile_rows)]
    if group is None:
        return tiles
    T, R = len(tiles), group.nranks
    return tiles[group.rank * T // R:(group.rank + 1) * T // R]


def _gathered(group, part: torch.Tensor) -> torch.Tensor:
    """The ranks' per-row results of their tile shares, in rank order: the
    result of every row (`part` itself on one process)."""
    if group is None:
        return part
    return torch.cat(group.allgather_rows(part))


def _per_row(fn, n: int, tile_rows: int, group, dtype: torch.dtype, device) -> torch.Tensor:
    """fn(s, e) over the row tiles of this rank's share, concatenated and
    gathered: the [n] per-row result."""
    parts = [fn(s, e) for s, e in _tiles(n, tile_rows, group)]
    local = torch.cat(parts) if parts else torch.zeros((0,), dtype=dtype, device=device)
    return _gathered(group, local)


def core_mask(
    X: torch.Tensor, eps2: float, min_samples: int, *, metric: str = "euclidean", tile_rows: int = 8192,
    group=None,
) -> torch.Tensor:
    """bool [n]: the rows whose eps-neighbourhood (the row itself included)
    holds at least `min_samples` rows. For "precomputed", X is the [n, n]
    distance matrix. With a process `group` each rank counts its share of
    the row tiles and the counts are gathered."""
    def count(s, e):
        return (pairwise_d2(X[s:e], X, metric) <= eps2).sum(dim=1)

    return _per_row(count, X.shape[0], tile_rows, group, torch.int64, X.device) >= min_samples


def core_components(
    Xc: torch.Tensor, eps2: float, *, metric: str = "euclidean", tile_rows: int = 8192, group=None,
) -> Tuple[torch.Tensor, int]:
    """Connected components of the core-core eps-graph: (root [nc] int32,
    the smallest core index of each row's component; rounds run).

    Min-label propagation (one tiled nc x nc pass a round) with two
    pointer-jumping hops a round, so the rounds grow with the log of a
    component's diameter. The loop ends after the first round that
    changes no label, or after nc rounds, as the JAX package's while_loop
    does; each round reads one flag on the host. With a process `group`
    each rank propagates over its share of the row tiles and the labels
    are gathered before the hops, so every rank holds the same labels and
    the same flag, and all stop at the same round."""
    nc = Xc.shape[0]
    labels = torch.arange(nc, dtype=torch.int32, device=Xc.device)
    rounds = 0
    while True:
        def propagate(s, e):
            neigh = pairwise_d2(Xc[s:e], Xc, metric) <= eps2
            m = torch.where(neigh, labels[None, :], nc).amin(dim=1)
            return torch.minimum(m, labels[s:e])

        new = _per_row(propagate, nc, tile_rows, group, torch.int32, Xc.device)
        for _ in range(2):  # pointer jumping: each label hops to its label's label
            new = torch.minimum(new, new[new.long()])
        rounds += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed or rounds >= nc:
            return labels, rounds


def border_assign(
    X: torch.Tensor,
    Xc: torch.Tensor,
    core_labels: torch.Tensor,
    eps2: float,
    *,
    metric: str = "euclidean",
    tile_rows: int = 8192,
    group=None,
) -> torch.Tensor:
    """int32 [n]: for every row the smallest cluster id among its
    eps-neighbouring core rows, or -1 (noise) when there is none. Core rows
    are their own neighbours. For "precomputed", X holds each row's
    distances to the core rows. With a process `group` each rank assigns
    its share of the row tiles and the labels are gathered."""
    big = 2**30

    def assign(s, e):
        neigh = pairwise_d2(X[s:e], Xc, metric) <= eps2
        m = torch.where(neigh, core_labels[None, :], big).amin(dim=1)
        return torch.where(m < big, m, -1).to(torch.int32)

    return _per_row(assign, X.shape[0], tile_rows, group, torch.int32, X.device)


def dbscan_fit(
    x_host: np.ndarray,
    *,
    device: torch.device,
    eps: float,
    min_samples: int,
    metric: str = "euclidean",
    max_mbytes_per_batch: Optional[int] = None,
    calc_core_sample_indices: bool = False,
    group=None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Full DBSCAN of the host rows on `device`: (labels [n] int32 with -1
    for noise, the core rows' indices or None).

    metric="euclidean" thresholds squared distances at eps^2; "cosine"
    scales the rows to unit norm on the host and thresholds 1 - cos at
    eps; "precomputed" takes `x_host` as the [n, n] distance matrix and
    thresholds it at eps, each pass reading the matching columns (the core
    columns for the components and the border). The threshold is eps2
    rounded to float32, the type of the distances."""
    from ..parallel import host_tensor
    from ..utils import unit_rows

    n, d = x_host.shape
    x = np.ascontiguousarray(x_host, dtype=np.float32)
    if metric == "precomputed":
        if n != d:
            raise ValueError(f"precomputed metric needs a square distance matrix, got {n}x{d}")
        eps2 = float(eps)
    elif metric == "cosine":
        x = unit_rows(x)
        eps2 = float(eps)
    elif metric == "euclidean":
        eps2 = float(eps) ** 2
    else:
        raise ValueError(f"metric must be 'euclidean', 'cosine' or 'precomputed', got {metric!r}")
    eps2 = float(np.float32(eps2))
    with ieee_f32_products():
        X = host_tensor(x).to(device)
        tile = _tile_rows_for_budget(n, max_mbytes_per_batch)
        core_idx = np.flatnonzero(core_mask(X, eps2, min_samples, metric=metric, tile_rows=tile, group=group).cpu().numpy())
        nc = len(core_idx)
        if nc == 0:
            return np.full(n, -1, np.int32), (core_idx if calc_core_sample_indices else None)
        core_t = torch.from_numpy(core_idx).to(device)
        if metric == "precomputed":
            X_border = X.index_select(1, core_t)  # [n, nc]: distances to the core rows
            Xc = X_border.index_select(0, core_t)  # [nc, nc]
        else:
            X_border = X
            Xc = X.index_select(0, core_t)
        roots, _ = core_components(
            Xc, eps2, metric=metric, tile_rows=_tile_rows_for_budget(nc, max_mbytes_per_batch), group=group,
        )
        # sklearn/cuML numbering: clusters in ascending order of their
        # first (smallest) core index, the propagation's roots
        roots = roots.cpu().numpy()
        core_cluster = np.searchsorted(np.unique(roots), roots).astype(np.int32)
        labels = border_assign(
            X_border, Xc, torch.from_numpy(core_cluster).to(device), eps2, metric=metric, tile_rows=tile, group=group,
        ).cpu().numpy()
    return labels, (core_idx if calc_core_sample_indices else None)
