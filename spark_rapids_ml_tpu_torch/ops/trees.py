#
# Random-forest fit and predict on one device: the PyTorch counterpart of
# spark_rapids_ml_tpu/ops/trees.py (`quantile_bins`, `bin_features`,
# `_split_gains`, `_feature_subset_ids`, `_tree_level`,
# `_tree_final_level`, `forest_fit`, `forest_raw_predict`,
# `split_bins_to_thresholds`). The JAX package leaves all of it to XLA (no
# Pallas kernel); here it is plain torch ops, the same on the CPU and the
# card.
#
# The scheme is the JAX package's: features are quantile-binned once
# (uint8 ids at <= 256 bins), trees grow level by level in the full binary
# layout (node i has children 2i+1 and 2i+2), each level builds one
# (node, feature, bin, stat) histogram over the rows still in the tree, on
# a random subset of m features per node, and the best split per node is
# the first argmax of the impurity gains. A forest is feature [T, M],
# split_bin [T, M] and node_stats [T, M, S], M = 2^(max_depth+1) − 1.
#
# What differs in form, and why:
#
#   * the histograms are sums of integers. Each tree's per-row statistics
#     are written as int64 multiples of 2^q, one q per statistic, chosen
#     from the largest |value| and the row count so that no partial sum
#     leaves 62 bits (`_fixed_point`); the histogram is an int64
#     `index_add_`. Integer sums do not depend on their order, so a fit
#     gives the same bits on every run, on the CPU and on the card, where
#     float atomics would not. Integer statistics (class counts, integer
#     labels, unit weights) are exact at q <= 0, and then equal the JAX
#     package's float sums wherever those are exact (below 2^24 in
#     float32); real statistics are rounded once, at 2^q, which is below
#     2^-62 of the column's mass bound: closer to the exact sum than a
#     float32 or float64 sum in any order. The prefix sums over bins and
#     right = total − left are taken in integers too, then each is
#     converted once to the statistics' dtype;
#   * the rows are not masked but dropped: a tree keeps the rows with
#     nonzero statistics (bootstrap count and weight above 0), and each
#     level keeps those sent on to a child of a split node. Rows whose
#     statistics are 0 add nothing to any sum, so nothing changes;
#   * the bootstrap draw takes JAX's uniform bits (ops/prng.py) but picks
#     the ceil(V·(1 − u))-th of the V rows of positive weight by an exact
#     count, where jax.random.choice searches a float cumulative sum of the
#     probabilities, whose rounding differs between implementations. The
#     draws are held to JAX's statistically; without the bootstrap a
#     subsample is jax.random.permutation's, bit for bit;
#   * nodes are taken in chunks of at most `HIST_BUDGET` histogram
#     elements and rows in tiles of at most `PAIR_BUDGET` (row, feature)
#     pairs: no [n, m] temporary. A node's histogram does not depend on
#     either. (The JAX package's chunk cap, per-stat scatters and retry
#     loop work around its TPU runtime and are not carried over.)
#
# The forest's predict (`forest_raw_predict`) is a fixed-depth gather
# descent of every tree at once; the trees' leaf values are summed in tree
# order and divided by T, so a row's answer does not depend on its batch.
#
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import prng

# Histogram elements (nodes × features × bins × statistics) of one node
# chunk, and (row, feature) pairs of one row tile of the histogram pass;
# read at each call.
HIST_BUDGET = 1 << 26
PAIR_BUDGET = 1 << 26
# bytes of X per row tile of the binning (a transposed copy of the tile is
# made, never of X)
BIN_TILE_BYTES = 1 << 29
# the stream of each level's feature subsets (jax: fold_in(tree_key, 7919 + depth))
LEVEL_STREAM = 7919


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------


def quantile_bins(x_host: np.ndarray, max_bins: int, sample_cap: int = 100_000, seed: int = 0) -> np.ndarray:
    """Per-feature quantile bin edges from a host sample: [d, max_bins-1],
    float64 (the JAX package's sample and `np.quantile`, on the host).

    Each column's quantiles depend on that column alone, so the columns
    are taken as a transposed contiguous copy, in runs on the host's
    cores: the same values as the JAX package's one `np.quantile(sample,
    qs, axis=0)`, which selects along a strided axis on one core and took
    most of a forest fit at 1M x 3000 (PERF.md)."""
    from concurrent.futures import ThreadPoolExecutor

    n, d = x_host.shape
    if n > sample_cap:
        idx = np.random.default_rng(seed).choice(n, sample_cap, replace=False)
        sample = np.asarray(x_host[idx], dtype=np.float64)
    else:
        sample = np.asarray(x_host, dtype=np.float64)
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    cols = np.ascontiguousarray(sample.T)  # [d, rows]
    del sample
    bounds = np.linspace(0, d, min(d, os.cpu_count() or 1) + 1).astype(int)
    with ThreadPoolExecutor(len(bounds) - 1) as pool:
        parts = list(pool.map(lambda a, b: np.quantile(cols[a:b], qs, axis=1), bounds[:-1], bounds[1:]))
    return np.ascontiguousarray(np.concatenate(parts, axis=1).T)  # [d, max_bins-1]


def _bin_dtype(n_edges: int) -> torch.dtype:
    """uint8 bin ids when there are at most 256 bins, else int32."""
    return torch.uint8 if n_edges + 1 <= 256 else torch.int32


def bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """X [n, d] -> bin ids [n, d]: per feature, the left insertion index
    of each value among its edges [d, B-1] (compared at X's dtype), NaN
    past the last edge. Row tiles of `BIN_TILE_BYTES` are transposed for
    `torch.searchsorted` one at a time."""
    n, d = X.shape
    out = torch.empty((n, d), dtype=_bin_dtype(edges.shape[1]), device=X.device)
    e = edges.to(device=X.device, dtype=X.dtype).contiguous()
    tile = max(1, BIN_TILE_BYTES // max(1, d * X.element_size()))
    for lo in range(0, n, tile):
        xt = X[lo:lo + tile].T.contiguous()
        out[lo:lo + tile] = torch.searchsorted(e, xt, side="left", out_int32=True).T
    return out


# ---------------------------------------------------------------------------
# Impurity / split evaluation
# ---------------------------------------------------------------------------


def _fold(t: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 from the first entry on, in order (XLA's reduce of a
    short leading axis on the CPU, written out so every device adds alike)."""
    acc = t[0]
    for s in range(1, t.shape[0]):
        acc = acc + t[s]
    return acc


def _gains_from_sides(left: torch.Tensor, right: torch.Tensor, total_s: torch.Tensor, impurity: str,
                      min_instances: float) -> torch.Tensor:
    """gain [C, d, B] of splitting node c on feature f at bin <= b, from the
    left and right statistics [S, C, d, B] and the node totals [S, C]; the
    JAX package's formulas, op by op, at the statistics' dtype. Splits with
    a child under `min_instances`, and the last bin (everything left), are
    -inf."""
    if impurity in ("gini", "entropy"):
        def node_impurity(stats):  # stats [S, ...] class counts
            cnt = _fold(stats)
            p = stats / torch.clamp_min(cnt, 1e-30)[None]
            if impurity == "gini":
                return 1.0 - _fold(p * p), cnt
            return -_fold(torch.where(p > 0, p * torch.log2(p), 0.0)), cnt

        imp_l, cnt_l = node_impurity(left)
        imp_r, cnt_r = node_impurity(right)
        imp_p, cnt_p = node_impurity(total_s)  # [C], [C]
        cnt_p_b = cnt_p[:, None, None]
        weighted_child = (cnt_l * imp_l + cnt_r * imp_r) / torch.clamp_min(cnt_p_b, 1e-30)
        gain = imp_p[:, None, None] - weighted_child
    elif impurity == "variance":  # S = (w, wy, wyy)
        w_l, wy_l, wyy_l = left[0], left[1], left[2]
        w_r, wy_r, wyy_r = right[0], right[1], right[2]
        w_p = total_s[0][:, None, None]

        def var_sum(w_, wy_, wyy_):  # Σw·(y-μ)² = Σwy² − (Σwy)²/Σw
            return wyy_ - wy_ * wy_ / torch.clamp_min(w_, 1e-30)

        ss_p = var_sum(total_s[0], total_s[1], total_s[2])[:, None, None]
        ss_child = var_sum(w_l, wy_l, wyy_l) + var_sum(w_r, wy_r, wyy_r)
        gain = (ss_p - ss_child) / torch.clamp_min(w_p, 1e-30)
        cnt_l, cnt_r = w_l, w_r
    else:
        raise ValueError(f"unknown impurity {impurity!r}")

    n_bins = left.shape[3]
    valid = (cnt_l >= min_instances) & (cnt_r >= min_instances)
    valid = valid & (torch.arange(n_bins, device=left.device)[None, None, :] < n_bins - 1)
    return torch.where(valid, gain, -math.inf)


def _split_gains(hist: torch.Tensor, impurity: str, min_instances: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """hist [S, C, d, B] float per-node histograms -> (gain [C, d, B],
    total [C, S]), as the JAX package's `_split_gains` (prefix sums over
    the bins in float)."""
    left = torch.cumsum(hist, dim=3)
    total_s = left[:, :, 0, -1]
    right = total_s[:, :, None, None] - left
    return _gains_from_sides(left, right, total_s, impurity, min_instances), total_s.T


def _fixed_point(stats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """stats [r, S] -> (ints [r, S] int64, scale [S] float64) with
    stats ≈ ints · scale, scale = 2^q per column: q is the exponent of the
    column's largest |value| plus ceil(log2 r), less 62, so every partial
    sum of a column fits in 62 bits. Exact where the values are multiples
    of 2^q (integers, when the bound is below 2^62)."""
    r, S = stats.shape
    peak = stats.abs().amax(dim=0).to(torch.float64).cpu() if r else torch.zeros(S, dtype=torch.float64)
    if not torch.isfinite(peak).all():
        raise ValueError("RandomForest: the labels and weights must be finite")
    exps = torch.frexp(peak).exponent.to(torch.int64) + max(0, (r - 1).bit_length()) - 62
    scale = torch.pow(2.0, exps.to(torch.float64)).to(stats.device)
    ints = torch.round(stats.to(torch.float64) / scale).to(torch.int64)
    return ints, scale


def _from_fixed(ints: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """ints [S, ...] int64 multiples of scale [S] -> the values at `dtype`."""
    return (ints.to(torch.float64) * scale.view(-1, *([1] * (ints.dim() - 1)))).to(dtype)


def _feature_subset_ids(key: torch.Tensor, n_nodes: int, d: int, m: int) -> torch.Tensor:
    """Exact-m random feature subset per node: int64 ids [n_nodes, m], the
    first m of a stable argsort of a float64 uniform [n_nodes, d] (JAX's
    draw under jax_enable_x64); all features in order when m >= d."""
    if m >= d:
        return torch.arange(d, device=key.device).expand(n_nodes, d)
    u = prng.uniform(key, (n_nodes, d), torch.float64)
    return torch.argsort(u, dim=1, stable=True)[:, :m]


# ---------------------------------------------------------------------------
# Single-tree growth (level-wise, full binary layout)
# ---------------------------------------------------------------------------


def _histogram(Xb: torch.Tensor, rows: torch.Tensor, local: torch.Tensor, vals: torch.Tensor,
               fids: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int64 histogram [S, C, m, B] of the rows `rows` (at chunk-local
    nodes `local`, fixed-point statistics `vals` [r, S]) over each node's
    features `fids` [C, m], accumulated over row tiles of `PAIR_BUDGET`
    pairs."""
    c, m = fids.shape
    S = vals.shape[1]
    hist = torch.zeros((c * m * n_bins, S), dtype=torch.int64, device=Xb.device)
    col = torch.arange(m, device=Xb.device) * n_bins
    tile = max(1, PAIR_BUDGET // m)
    for lo in range(0, rows.shape[0], tile):
        r, loc = rows[lo:lo + tile], local[lo:lo + tile]
        # flat segment id: (node_local * m + j) * B + bin of the row at
        # its node's j-th feature
        seg = (loc * (m * n_bins))[:, None] + col + Xb[r[:, None], fids[loc]]
        src = vals[lo:lo + tile, None, :].expand(-1, m, -1).reshape(-1, S)
        hist.index_add_(0, seg.reshape(-1), src)
    return hist.view(c, m, n_bins, S).permute(3, 0, 1, 2)


def _tree_level(key: torch.Tensor, Xb: torch.Tensor, rows: torch.Tensor, node_id: torch.Tensor,
                vals: torch.Tensor, scale: torch.Tensor, feature: torch.Tensor, split_bin: torch.Tensor,
                node_stats: torch.Tensor, params: Dict[str, Any],
                depth: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grow ONE level of one tree: histograms by node chunk, split choice,
    row advance. `rows` [r] are the rows still in the tree, `node_id` [r]
    their nodes (all on this level), `vals` [r, S] their fixed-point
    statistics (`_fixed_point`, with `scale`). Writes the level's entries
    of `feature`, `split_bin` and `node_stats` (at the statistics' dtype);
    returns (rows, node_id, vals) of the rows sent on to a child."""
    d = Xb.shape[1]
    S = vals.shape[1]
    B = params["max_bins"]
    m = min(params["max_features"], d)
    level_size = 2**depth
    offset = level_size - 1
    fids_level = _feature_subset_ids(key, level_size, d, m)
    chunk = max(1, min(level_size, HIST_BUDGET // (m * B * S)))
    if chunk < level_size:
        order = torch.argsort(node_id, stable=True)
        rows, node_id, vals = rows[order], node_id[order], vals[order]
        starts = torch.arange(offset, offset + level_size, chunk, device=node_id.device)
        bounds = torch.searchsorted(node_id, starts).tolist() + [rows.shape[0]]
    else:
        bounds = [0, rows.shape[0]]
    dtype = node_stats.dtype
    for i, c0 in enumerate(range(0, level_size, chunk)):
        c = min(chunk, level_size - c0)
        lo, hi = bounds[i], bounds[i + 1]
        fids = fids_level[c0:c0 + c]
        hist = _histogram(Xb, rows[lo:hi], node_id[lo:hi] - (offset + c0), vals[lo:hi], fids, B)
        left = hist.cumsum(dim=3)
        total = left[:, :, 0, -1]
        right = total[:, :, None, None] - left
        total_s = _from_fixed(total, scale, dtype)
        gain = _gains_from_sides(_from_fixed(left, scale, dtype), _from_fixed(right, scale, dtype), total_s,
                                 params["impurity"], params["min_instances"]).reshape(c, -1)
        flat_best = torch.argmax(gain, dim=1)
        best_gain = gain.gather(1, flat_best[:, None])[:, 0]
        best_f = fids.gather(1, (flat_best // B)[:, None])[:, 0]
        is_split = best_gain > params["min_info_gain"]
        nodes = slice(offset + c0, offset + c0 + c)
        feature[nodes] = torch.where(is_split, best_f, -1)
        split_bin[nodes] = torch.where(is_split, flat_best % B, 0)
        node_stats[nodes] = total_s.T

    # advance rows: split nodes send rows to children; rows at a leaf leave
    node_f = feature[node_id]
    went = node_f >= 0
    row_bin = Xb[rows, node_f.clamp(min=0)].to(torch.int64)
    child = 2 * node_id + torch.where(row_bin <= split_bin[node_id], 1, 2)
    return rows[went], child[went], vals[went]


def _tree_final_level(node_id: torch.Tensor, vals: torch.Tensor, scale: torch.Tensor, node_stats: torch.Tensor,
                      max_depth: int) -> None:
    """Record the statistics of the rows that reached the last level."""
    level_size = 2**max_depth
    offset = level_size - 1
    sums = torch.zeros((level_size, vals.shape[1]), dtype=torch.int64, device=vals.device)
    sums.index_add_(0, node_id - offset, vals)
    node_stats[offset:] = _from_fixed(sums.T, scale, node_stats.dtype).T


def tree_weights(key: torch.Tensor, w: torch.Tensor, dtype: torch.dtype, *, bootstrap: bool,
                 subsample_rate: float, draw_rows: Optional[int] = None) -> torch.Tensor:
    """Per-row draw counts [n] of one tree, at `dtype`, from the tree's key.

    The draws are made over `draw_rows` rows (None: n), the first n of them
    these rows and the rest rows of no weight: a rank of a multi-process
    fit draws over the largest rank's block, as the JAX package's padded
    layout does. bootstrap: n_draws = round(rate·draw_rows) draws with
    replacement, uniform over the V rows of positive weight; a draw of
    JAX's uniform u (at `dtype`, from the first half of split(key)) takes
    the ceil(V·(1 − u))-th of them. Without it and rate < 1: the first
    n_draws of jax.random.permutation(that key, draw_rows), once each,
    those past n dropped. Else every row once."""
    n = w.shape[0]
    n_all = n if draw_rows is None else int(draw_rows)
    k1 = prng.split(key)[0]
    n_draws = int(max(1, round(subsample_rate * n_all)))
    if bootstrap:
        valid = torch.nonzero(w > 0).squeeze(1)
        n_valid = valid.shape[0]
        if n_valid == 0:  # no row carries weight: every statistic is 0 anyway
            return torch.zeros(n, dtype=dtype, device=w.device)
        u = prng.uniform(k1, (n_draws,), dtype)
        rank = torch.ceil((1.0 - u).to(torch.float64) * n_valid).to(torch.int64).clamp_(1, n_valid)
        return torch.bincount(valid[rank - 1], minlength=n).to(dtype)
    if subsample_rate < 1.0:
        wb = torch.zeros(n, dtype=dtype, device=w.device)
        picked = prng.permutation(k1, n_all)[:n_draws]
        wb[picked[picked < n]] = 1
        return wb
    return torch.ones(n, dtype=dtype, device=w.device)


def grow_tree(Xb: torch.Tensor, stats_row: torch.Tensor, w: torch.Tensor, seed: int, tree: int,
              params: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tree `tree` of the forest of `seed`: (feature [M], split_bin [M],
    node_stats [M, S]) on the device. Its key is fold_in(PRNGKey(seed),
    tree); its draw counts come from that key (`tree_weights`, over
    params["draw_rows"] rows when set), level
    `depth`'s feature subsets from fold_in(key, 7919 + depth)."""
    max_depth = params["max_depth"]
    M = 2 ** (max_depth + 1) - 1
    dev = Xb.device
    key = prng.fold_in(prng.prng_key(seed, dev), tree)
    wb = tree_weights(key, w, stats_row.dtype, bootstrap=params["bootstrap"],
                      subsample_rate=params["subsample_rate"], draw_rows=params.get("draw_rows"))
    stw = stats_row * wb[:, None]
    rows = torch.nonzero((stw != 0).any(dim=1)).squeeze(1)
    vals, scale = _fixed_point(stw[rows])
    node_id = torch.zeros(rows.shape[0], dtype=torch.int64, device=dev)
    feature = torch.full((M,), -1, dtype=torch.int64, device=dev)
    split_bin = torch.zeros(M, dtype=torch.int64, device=dev)
    node_stats = torch.zeros((M, stats_row.shape[1]), dtype=stats_row.dtype, device=dev)
    for depth in range(max_depth):
        rows, node_id, vals = _tree_level(prng.fold_in(key, LEVEL_STREAM + depth), Xb, rows, node_id, vals, scale,
                                          feature, split_bin, node_stats, params, depth)
    _tree_final_level(node_id, vals, scale, node_stats, max_depth)
    return feature, split_bin, node_stats


def forest_fit(Xb: torch.Tensor, stats_row: torch.Tensor, w: torch.Tensor, seed: int, *, n_trees: int,
               max_depth: int, max_bins: int, max_features: int, impurity: str, bootstrap: bool = True,
               subsample_rate: float = 1.0, min_instances: float = 1.0, min_info_gain: float = 0.0,
               tree_ids: Optional[Sequence[int]] = None, draw_rows: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Fit `n_trees` trees on the binned rows Xb [n, d] with per-row
    statistics stats_row [n, S] (already weighted) and weights w [n] (the
    bootstrap's population: rows of positive weight). A host loop over
    trees and levels on Xb's device; each tree lands on the host as it
    finishes. Returns feature [T, M] int32, split_bin [T, M] int32 and
    node_stats [T, M, S] at the statistics' dtype.

    `tree_ids` grows those trees of the forest instead (a rank's share in
    a multi-process fit; T = len(tree_ids), possibly 0), each drawing over
    `draw_rows` rows (`tree_weights`)."""
    params = {
        "max_depth": max_depth, "max_bins": max_bins, "max_features": max_features, "impurity": impurity,
        "bootstrap": bootstrap, "subsample_rate": subsample_rate, "min_instances": min_instances,
        "min_info_gain": min_info_gain, "draw_rows": draw_rows,
    }
    M = 2 ** (max_depth + 1) - 1
    trees = [
        tuple(t.cpu().numpy() for t in grow_tree(Xb, stats_row, w, seed, t_i, params))
        for t_i in (range(n_trees) if tree_ids is None else tree_ids)
    ]
    if not trees:
        return {
            "feature": np.zeros((0, M), np.int32), "split_bin": np.zeros((0, M), np.int32),
            "node_stats": np.zeros((0, M, stats_row.shape[1]), torch.empty((), dtype=stats_row.dtype).numpy().dtype),
        }
    return {
        "feature": np.stack([t[0] for t in trees]).astype(np.int32),
        "split_bin": np.stack([t[1] for t in trees]).astype(np.int32),
        "node_stats": np.stack([t[2] for t in trees]),
    }


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------


def forest_raw_predict(X: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor, leaf_value: torch.Tensor,
                       *, max_depth: int) -> torch.Tensor:
    """Mean of the trees' leaf values [n, S]: every tree descends
    `max_depth` steps at once (x <= threshold goes to child 2i+1, else
    2i+2; a leaf stays), then the leaf values are summed in tree order and
    divided by T. feature [T, M] int64, threshold [T, M] and leaf_value
    [T, M, S] at X's dtype."""
    T = feature.shape[0]
    n = X.shape[0]
    node = torch.zeros((T, n), dtype=torch.int64, device=X.device)
    row = torch.arange(n, device=X.device)[None, :]
    for _ in range(max_depth):
        f = feature.gather(1, node)
        xv = X[row, f.clamp(min=0)]
        child = 2 * node + torch.where(xv <= threshold.gather(1, node), 1, 2)
        node = torch.where(f >= 0, child, node)
    acc = leaf_value[0, node[0]]
    for t in range(1, T):
        acc = acc + leaf_value[t, node[t]]
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which may differ from the quotient in the last bit
    return acc / torch.tensor(T, dtype=acc.dtype, device=acc.device)


def split_bins_to_thresholds(feature: np.ndarray, split_bin: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bin-id splits as real thresholds: split 'bin <= b' is
    'x <= edges[f, b]' (searchsorted-left); leaves get +inf."""
    f = np.maximum(feature, 0)
    b = np.minimum(split_bin, edges.shape[1] - 1)
    thr = edges[f, b]
    return np.where(feature >= 0, thr, np.inf).astype(np.float64)
