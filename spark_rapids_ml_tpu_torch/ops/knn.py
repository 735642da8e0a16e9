#
# k-nearest-neighbors on one device: the PyTorch counterpart of
# spark_rapids_ml_tpu/ops/knn.py.
#
# Exact kNN (`exact_knn`, the JAX package's `_exact_knn_1dev`): query tiles
# of `batch_queries` rows run the shared distance core's running top-k
# (ops/distance.py topk_tile), whose distance blocks come from the d2-block
# kernel on the card.
#
# IVFFlat and IVFPQ: a KMeans coarse quantizer (the k-means|| seeding and
# the Lloyd loop of ops/kmeans.py, on the argmin and accumulation kernels)
# with inverted lists; the queries probe their `n_probes` nearest lists
# through `topk_tile` (the d2-block kernel). IVFFlat keeps its lists'
# rows back to back and reads each probed list once per query tile; IVFPQ
# keeps the JAX package's padded code lists (one byte a subspace) and ranks
# by ADC lookup tables. The index stays on the device. The list scans, the
# lookup tables and the PQ encoding are plain torch on cuBLAS, as the JAX
# package leaves them to XLA.
#
# Sparse item sets (`exact_knn_sparse`): item tiles of the CSR rows are
# converted to padded ELL on the host, densified on the card
# (`sparse.ell_densify`, the tile scipy's `todense` gives) and merged into
# each query tile's running top-k through `topk_tile`, so every tile's
# distances come from the d2-block kernel. A multi-process search runs
# `exact_knn` (or `exact_knn_sparse`, or an ANN index's search) on each
# rank's own items and merges the ranks' candidates in `merge_topk`
# (models/knn.py), which gives the JAX package's global-mesh result without
# its sharded search (`_exact_knn_sharded`, `tile_topk`).
#
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .distance import _topk_lex, argmin_assign, row_sq, tile_rows, topk_tile
from .sparse import csr_to_ell, ell_densify


def exact_knn(
    items: torch.Tensor,  # [n, d] on the device
    valid: Optional[torch.Tensor],  # [n] bool, or None for all-valid
    queries: torch.Tensor,  # [nq, d] on the same device
    *,
    k: int,
    batch_queries: Optional[int] = None,
    keys: bool = False,
):
    """Exact kNN of every query against all items: host arrays (euclidean
    distances [nq, k], item row indices [nq, k] int32), ascending by
    distance, lower index first on ties. `batch_queries` defaults to
    ``config["distance_tile_rows"]``. With fewer than k items the missing
    columns hold +inf and index 0. `keys` adds a third array, the values
    the order was taken on (‖x‖² − 2q·x, before ‖q‖² and the square root
    round distinct values together), for `merge_topk`.

    Item norms are computed once; each query tile is a view of `queries`
    and every item block a view of `items`, so no copy of either is made.
    The last query tile is clamped back to full size and its overlap rows
    dropped, as the reference does to compile one tile program."""
    nq = queries.shape[0]
    if nq == 0:
        empty = queries.new_zeros((0, k)).cpu().numpy()
        return (empty, np.zeros((0, k), dtype=np.int32)) + ((empty,) if keys else ())
    kk = min(k, items.shape[0])
    batch_queries = min(batch_queries or tile_rows(), nq)
    item_sq = row_sq(items)
    k_parts, d_parts, i_parts = [], [], []
    for start in range(0, nq, batch_queries):
        s0 = min(start, nq - batch_queries)
        q = queries[s0:s0 + batch_queries]
        d2, idx = topk_tile(q, items, valid, kk, item_sq=item_sq)
        fresh = start - s0
        k_parts.append(d2[fresh:].cpu().numpy())
        d_parts.append((d2 + row_sq(q)[:, None])[fresh:].cpu().numpy())
        i_parts.append(idx[fresh:].cpu().numpy())
    key = np.concatenate(k_parts, axis=0)
    d2 = np.concatenate(d_parts, axis=0)
    idx = np.concatenate(i_parts, axis=0)
    if kk < k:
        key = np.pad(key, ((0, 0), (0, k - kk)), constant_values=np.inf)
        d2 = np.pad(d2, ((0, 0), (0, k - kk)), constant_values=np.inf)
        idx = np.pad(idx, ((0, 0), (0, k - kk)))
    return (np.sqrt(np.maximum(d2, 0.0)), idx) + ((key,) if keys else ())


def merge_topk(dist: np.ndarray, ids: np.ndarray, k: int, key: Optional[np.ndarray] = None):
    """The k best of each row of the ranks' candidate lists, laid side by
    side in rank order (dist [nq, R·k] float, ids [nq, R·k] int64, each
    rank's list ascending with the lower row first on ties, -1 marking a
    pad slot of a rank short of candidates): (dist [nq, k], ids [nq, k]).

    The order is one `exact_knn` over the global rows: ascending distance
    (or `key`, the values the ranks ordered on, from `exact_knn(...,
    keys=True)`: distances that round together keep their order), the
    earlier candidate (the lower global row) first on ties, NaN after +inf,
    and the pad slots after every real candidate, NaN included, so a NaN
    query row keeps the first k global rows. A stable sort by the key
    (numpy ranks NaN last), then a stable sort of the pads to the end."""
    order = np.argsort(dist if key is None else key, axis=1, kind="stable")
    pad = np.take_along_axis(ids, order, axis=1) < 0
    order = np.take_along_axis(order, np.argsort(pad, axis=1, kind="stable"), axis=1)[:, :k]
    return np.take_along_axis(dist, order, axis=1), np.take_along_axis(ids, order, axis=1)


def exact_knn_sparse(
    items_csr,  # scipy CSR [n, d]
    queries: torch.Tensor,  # [nq, d] on the device
    *,
    k: int,
    batch_items: int = 65536,
    batch_queries: Optional[int] = None,
    keys: bool = False,
):
    """Exact kNN of dense queries against a CSR item set, never densified
    whole: host arrays (euclidean distances [nq, k], item row indices [nq,
    k] int32), ascending by distance, lower index first on ties. With
    fewer than k items the missing columns hold +inf and index -1. `keys`
    adds the values the order was taken on, as `exact_knn`'s.

    Item tiles of `batch_items` rows are densified on the device one at a
    time and merged into every query tile's running best list; the last
    item tile is clamped back to full size and its rows already merged are
    masked, as the JAX package does. Within a tile `topk_tile` scans the
    items in blocks through the d2-block kernel; the carried list comes
    first in each merge, so ties go to the lower item index."""
    n, d = items_csr.shape
    nq = queries.shape[0]
    np_dtype = np.float32 if queries.dtype == torch.float32 else np.float64
    if nq == 0:
        empty = np.zeros((0, k), dtype=np_dtype)
        return (empty, np.zeros((0, k), dtype=np.int32)) + ((empty,) if keys else ())
    device = queries.device
    kk = min(k, n)
    batch_items = min(batch_items, n)
    batch_queries = min(batch_queries or tile_rows(), nq)
    q_starts = list(range(0, nq, batch_queries))
    best = [
        (torch.full((batch_queries, kk), float("inf"), dtype=queries.dtype, device=device),
         torch.full((batch_queries, kk), -1, dtype=torch.int32, device=device))
        for _ in q_starts
    ]
    for start in range(0, n, batch_items):
        s0 = min(start, n - batch_items)
        idx_h, val_h, _ = csr_to_ell(items_csr[s0:s0 + batch_items], dtype=np_dtype)
        xt = ell_densify(torch.from_numpy(val_h).to(device), torch.from_numpy(idx_h).to(device), d)
        xt_sq = row_sq(xt)
        fresh = torch.arange(s0, s0 + batch_items, device=device) >= start if s0 < start else None
        for qi, qs in enumerate(q_starts):
            q0 = min(qs, nq - batch_queries)
            td2, ti = topk_tile(queries[q0:q0 + batch_queries], xt, fresh, kk, item_sq=xt_sq)
            cat_d = torch.cat([best[qi][0], td2], dim=1)
            cat_i = torch.cat([best[qi][1], ti + s0], dim=1)
            order = torch.sort(cat_d, dim=1, stable=True).indices[:, :kk]
            best[qi] = (cat_d.gather(1, order), cat_i.gather(1, order))
    k_parts, d_parts, i_parts = [], [], []
    for qs, (bd2, bi) in zip(q_starts, best):
        q0 = min(qs, nq - batch_queries)
        fresh_q = qs - q0
        k_parts.append(bd2[fresh_q:].cpu().numpy())
        d_parts.append((bd2 + row_sq(queries[q0:q0 + batch_queries])[:, None])[fresh_q:].cpu().numpy())
        i_parts.append(bi[fresh_q:].cpu().numpy())
    key = np.concatenate(k_parts, axis=0)
    dist = np.sqrt(np.maximum(np.concatenate(d_parts, axis=0), 0.0))
    idx = np.concatenate(i_parts, axis=0)
    if kk < k:
        key = np.pad(key, ((0, 0), (0, k - kk)), constant_values=np.inf)
        dist = np.pad(dist, ((0, 0), (0, k - kk)), constant_values=np.inf)
        idx = np.pad(idx, ((0, 0), (0, k - kk)), constant_values=-1)
    return (dist, idx) + ((key,) if keys else ())


# ---------------------------------------------------------------- IVFFlat --


def _coarse_quantizer(xd: torch.Tensor, n_lists: int, seed: int, kmeans_iters: int = 10):
    """The IVF coarse step on float32 rows on the device: KMeans centroids
    (k-means|| seeding for n_lists >= 64, else k-means++ on the first
    262,144 rows; then `kmeans_iters` Lloyd iterations at the `fast`
    precision, tol 1e-6, no final inertia), one assignment of every row
    (the argmin kernel at float32) and the sorted-fill layout: (centroids
    [C, d] on the device, assignment [n], sorted assignment, order, offsets,
    C, L) on the host. The [n] int32 assignment is the only fetch."""
    from .kmeans import _kmeanspp_device, kmeans_fit, scalable_kmeans_init_device

    n = xd.shape[0]
    n_lists = min(n_lists, n)
    ones = torch.ones((n,), dtype=torch.float32, device=xd.device)
    if n_lists >= 64:
        centers0 = scalable_kmeans_init_device(xd, n_lists, seed)
    else:
        # a bounded k-means++ scan over one contiguous slice; the Lloyd
        # iterations over every row wash out its ordering bias
        n_pp = min(n, 262_144)
        centers0 = _kmeanspp_device(xd[:n_pp], ones[:n_pp], seed, k=n_lists)
    state = kmeans_fit(xd, ones, centers0, max_iter=kmeans_iters, tol=1e-6, final_inertia=False)
    centroids = state["cluster_centers_"].to(torch.float32)
    assign = argmin_assign(xd, centroids).cpu().numpy()
    return (centroids, assign) + _list_layout(assign, n_lists)


def _list_layout(assign: np.ndarray, n_lists: int):
    """The sorted-fill layout of the lists on the host: (sorted assignment,
    order, offsets, n_lists, L); row order[i] goes to slot offsets[i] of
    list sorted_assign[i], each list holding its rows in row order, L the
    largest list's length."""
    counts = np.bincount(assign, minlength=n_lists)
    L = max(1, int(counts.max()))
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    offsets = np.arange(len(assign)) - (np.cumsum(counts) - counts)[sorted_assign]
    return sorted_assign, order, offsets, n_lists, L


def build_ivfflat(xd: torch.Tensor, n_lists: int, seed: int = 0, kmeans_iters: int = 10):
    """An IVFFlat index over float32 rows xd [n, d] on the device:
    {"centroids" [C, d], "rows" [n, d] (the rows list by list, each list in
    row order), "row_ids" [n] int64 (the row number of each), "offsets"
    [C + 1] int64 on the host (list c is rows[offsets[c]:offsets[c+1]])}.

    The JAX package pads every list to the largest one's length L
    ([C, L, d] buckets, C·L·d·4 bytes: 236 GB at 1M × 3000 rows of 1000
    isotropic blobs, where L = 76,820); here the lists are stored back to
    back, n·d·4 bytes whatever L is, and the search reads them in place.
    The slot of a row in its list is the same in both layouts."""
    centroids, _, sorted_assign, order, _, n_lists, _ = _coarse_quantizer(xd, n_lists, seed, kmeans_iters)
    counts = np.bincount(sorted_assign, minlength=n_lists)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int64))
    row_ids = torch.from_numpy(order.astype(np.int64)).to(xd.device)
    return {"centroids": centroids, "rows": xd.index_select(0, row_ids), "row_ids": row_ids, "offsets": offsets}


def ivfflat_from_padded(centroids, buckets, bucket_ids) -> dict:
    """The IVFFlat index of `build_ivfflat` from the JAX package's padded
    one (numpy or tensors): each list's real slots (id >= 0) come first, in
    slot order."""
    ids = torch.as_tensor(np.asarray(bucket_ids)).long()
    real = ids >= 0
    counts = real.sum(dim=1)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
    rows = torch.as_tensor(np.asarray(buckets, dtype=np.float32))[real]
    return {"centroids": torch.as_tensor(np.asarray(centroids, dtype=np.float32)), "rows": rows,
            "row_ids": ids[real], "offsets": offsets}


def _pad_result(dist: torch.Tensor, ids: torch.Tensor, k: int):
    """(sqrt of d² clamped at 0, ids) [B, k]: columns past the candidates
    as +inf and -1."""
    kk = dist.shape[1]
    dist = torch.sqrt(torch.clamp_min(dist, 0.0))
    if kk < k:
        dist = torch.cat([dist, dist.new_full((dist.shape[0], k - kk), float("inf"))], dim=1)
        ids = torch.cat([ids, ids.new_full((ids.shape[0], k - kk), -1)], dim=1)
    return dist, ids


def ivfflat_search(
    queries: torch.Tensor, index, *, k: int, n_probes: int, batch_queries: int = 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """Probe the n_probes nearest lists of each query (`topk_tile`, the
    d2-block kernel): host arrays (euclidean distances [nq, k] float32,
    item ids [nq, k] int64, -1 and +inf where a query has fewer than k
    candidates), ascending, the earlier probe and then the earlier slot
    first on ties: the JAX package's running merge over its padded
    buckets, probe by probe.

    Per query tile the (query, probe) pairs are grouped by list, and each
    probed list is read once, in place, by one product with all the tile's
    queries that probe it; each pair keeps the kk smallest of its list, and
    each query the kk smallest of its pairs' in probe order. (The JAX
    package gathers [B, L, d] per probe instead: each query reads its
    lists, padded, on its own.) The host reads the tile's per-list pair
    counts once."""
    centroids, rows, row_ids = index["centroids"], index["rows"], index["row_ids"]
    offsets = index["offsets"].tolist()
    nq = queries.shape[0]
    C = centroids.shape[0]
    P = min(n_probes, C)
    kk = min(k, P * max(b - a for a, b in zip(offsets[:-1], offsets[1:])))
    rows_sq = row_sq(rows)  # once per call
    dist_out = np.empty((nq, k), np.float32)
    ids_out = np.empty((nq, k), np.int64)
    for s in range(0, nq, batch_queries):
        q = queries[s:s + batch_queries]
        B = q.shape[0]
        _, probe = topk_tile(q, centroids, None, P)
        pair_list = probe.reshape(-1).long()  # pair b * P + p
        by_list = torch.sort(pair_list, stable=True).indices
        per_list = torch.bincount(pair_list, minlength=C).tolist()
        q_sq = row_sq(q)
        best_v = torch.full((B * P, kk), float("inf"), dtype=q.dtype, device=q.device)
        best_r = torch.full((B * P, kk), -1, dtype=torch.int64, device=q.device)
        start = 0
        for c in range(C):
            m, (o0, o1) = per_list[c], offsets[c:c + 2]
            pairs = by_list[start:start + m]
            start += m
            if m == 0 or o1 == o0:
                continue
            b = pairs // P
            d2 = q_sq[b][:, None] - 2.0 * (q[b] @ rows[o0:o1].T) + rows_sq[o0:o1][None, :]
            v, r = _topk_lex(d2, min(kk, o1 - o0))
            best_v[pairs, :v.shape[1]] = v
            best_r[pairs, :v.shape[1]] = r + o0
        v, pos = _topk_lex(best_v.reshape(B, P * kk), kk)
        r = best_r.reshape(B, P * kk).gather(1, pos)
        ids = torch.where(r >= 0, row_ids[r.clamp_min(0)], -1)
        dist, ids = _pad_result(v, ids, k)
        dist_out[s:s + B] = dist.cpu().numpy()
        ids_out[s:s + B] = ids.cpu().numpy()
    return dist_out, ids_out


# ------------------------------------------------------------------ IVFPQ --


def _residual_block(X, C, A, off: int, size: int) -> torch.Tensor:
    """Residuals of one contiguous row block: X[off:off+size] - C[A[...]]."""
    return X[off:off + size] - C[A[off:off + size].long()]


def _encode_residuals(X, C, A, CB) -> torch.Tensor:
    """PQ codes [n, M] int32 of every row: the nearest codeword (the first
    on ties) of each subspace of x - centroid, over row tiles of about 4M
    values so the residual never exists in full. CB [M, K, dsub]."""
    n, d = X.shape
    M, K, dsub = CB.shape
    tile = max(256, min(n, 4_000_000 // max(d, 1)))
    cb_sq = torch.sum(CB * CB, dim=2)  # [M, K]
    out = torch.empty((n, M), dtype=torch.int32, device=X.device)
    for r0 in range(0, n, tile):
        R = (X[r0:r0 + tile] - C[A[r0:r0 + tile].long()]).reshape(-1, M, dsub)
        d2 = cb_sq[None] - 2.0 * torch.einsum("nmd,mkd->nmk", R, CB)
        out[r0:r0 + tile] = torch.argmin(d2, dim=2).to(torch.int32)
    return out


def build_ivfpq(
    xd: torch.Tensor, n_lists: int, *, M: int = 8, n_bits: int = 8, seed: int = 0,
    kmeans_iters: int = 10, pq_iters: int = 10, train_cap: int = 65536,
):
    """An IVFPQ index over float32 rows xd [n, d] on the device: the coarse
    quantizer, then product quantization of the residuals x - centroid.
    Returns {"centroids" [C, d], "codebooks" [M, K, dsub] (K = 2^n_bits),
    "code_buckets" [C, L, M] (uint8 for n_bits <= 8, else int32),
    "bucket_ids" [C, L] int64 (-1 pad)}, all on xd's device.

    The codebooks train on a residual sample of at most `train_cap` rows,
    taken as up to 16 contiguous row blocks at offsets drawn by
    `np.random.default_rng(seed)`; subspace m fits K centers by
    `_kmeanspp_device(seed + m)` and `pq_iters` Lloyd iterations on its
    own contiguous copy [cap, dsub] (the kernels take contiguous rows)."""
    from .kmeans import _kmeanspp_device, kmeans_fit

    n, d = xd.shape
    if d % M:
        raise ValueError(f"M={M} must divide the feature dimension d={d}")
    centroids, assign, sorted_assign, order, offsets, n_lists, L = _coarse_quantizer(xd, n_lists, seed, kmeans_iters)
    dsub = d // M
    K = 1 << n_bits
    rs = np.random.default_rng(seed)
    cap = min(n, train_cap)
    n_blocks = min(16, max(1, cap // 1024)) if cap < n else 1
    bs = cap // n_blocks
    assign_dev = torch.from_numpy(assign).to(xd.device)
    blocks = []
    for b in range(n_blocks):
        off = int(rs.integers(0, max(1, n - bs + 1))) if cap < n else b * bs
        blocks.append(_residual_block(xd, centroids, assign_dev, off, bs))
    train = torch.cat(blocks, dim=0) if len(blocks) > 1 else blocks[0]
    codebooks = torch.zeros((M, K, dsub), dtype=torch.float32, device=xd.device)
    for m in range(M):
        sub = train[:, m * dsub:(m + 1) * dsub].contiguous()
        sub_w = torch.ones((sub.shape[0],), dtype=torch.float32, device=xd.device)
        k_eff = min(K, sub.shape[0])
        c0 = _kmeanspp_device(sub, sub_w, seed + m, k=k_eff)
        st = kmeans_fit(sub, sub_w, c0, max_iter=pq_iters, tol=1e-6, final_inertia=False)
        codebooks[m, :k_eff] = st["cluster_centers_"]
        if k_eff < K:  # a tiny sample: the first center repeated
            codebooks[m, k_eff:] = codebooks[m, 0]
    del train, blocks
    codes = _encode_residuals(xd, centroids, assign_dev, codebooks)
    codes = codes.to(torch.uint8 if n_bits <= 8 else torch.int32)
    code_buckets = torch.zeros((n_lists, L, M), dtype=codes.dtype, device=xd.device)
    bucket_ids = torch.full((n_lists, L), -1, dtype=torch.int64, device=xd.device)
    rows = torch.from_numpy(sorted_assign).to(xd.device)
    slots = torch.from_numpy(offsets).to(xd.device)
    order_t = torch.from_numpy(order).to(xd.device)
    code_buckets[rows, slots] = codes[order_t]
    bucket_ids[rows, slots] = order_t
    return {"centroids": centroids, "codebooks": codebooks, "code_buckets": code_buckets, "bucket_ids": bucket_ids}


def ivfpq_search(queries: torch.Tensor, index, *, k: int, n_probes: int, batch_queries: int = 256):
    """ADC search over an IVFPQ index (`build_ivfpq`): host arrays
    (approximate euclidean distances [nq, k] float32, item ids [nq, k]
    int64, -1 and +inf where short), ascending, the earlier (probe, slot)
    first on ties.

    Per query tile: the probe (`topk_tile`), the residual of the query
    against each probed centroid, and its lookup table [B, P, M, K] of
    squared distances to every codeword; a candidate's distance is the sum
    over subspaces of the table entries its codes pick, read one probe at a
    time by indexing the K axis with the codes (no [B, P, L, M, K] block)."""
    centroids, codebooks = index["centroids"], index["codebooks"]
    code_buckets, bucket_ids = index["code_buckets"], index["bucket_ids"]
    nq, d = queries.shape
    C, L, M = code_buckets.shape
    dsub = d // M
    n_probes = min(n_probes, C)
    cb_sq = torch.sum(codebooks * codebooks, dim=2)  # [M, K]
    kk = min(k, n_probes * L)
    dist_out = np.empty((nq, k), np.float32)
    ids_out = np.empty((nq, k), np.int64)
    for s in range(0, nq, batch_queries):
        q = queries[s:s + batch_queries]
        B = q.shape[0]
        _, probe = topk_tile(q, centroids, None, n_probes)
        probe = probe.long()
        q_res = (q[:, None, :] - centroids[probe]).reshape(B, n_probes, M, dsub)
        lut = (
            torch.sum(q_res * q_res, dim=3)[..., None]
            - 2.0 * torch.einsum("bpmd,mkd->bpmk", q_res, codebooks)
            + cb_sq[None, None]
        )  # [B, P, M, K]
        dist = torch.empty((B, n_probes, L), dtype=lut.dtype, device=q.device)
        for p in range(n_probes):
            codes = code_buckets[probe[:, p]].transpose(1, 2).long()  # [B, M, L]
            dist[:, p] = torch.gather(lut[:, p], 2, codes).sum(dim=1)
        ids = bucket_ids[probe].reshape(B, n_probes * L)
        dist = torch.where(ids >= 0, dist.reshape(B, n_probes * L), float("inf"))
        out_d, pos = _topk_lex(dist, kk)
        out_d, out_i = _pad_result(out_d, ids.gather(1, pos), k)
        dist_out[s:s + B] = out_d.cpu().numpy()
        ids_out[s:s + B] = out_i.cpu().numpy()
    return dist_out, ids_out


def refine_exact(x: torch.Tensor, queries: torch.Tensor, cand_idx: torch.Tensor, k: int, *, batch_queries: int = 256):
    """Exact re-rank of ADC candidates (the cuVS refine; the JAX package's
    `_refine_exact`): the candidates' rows of x gathered per query tile and
    scored in float64 as sum((x - q)^2), pads (-1) last; returns host
    arrays (euclidean distances [nq, k] float64, ids [nq, k] int64) in
    ascending order, the earlier candidate first on ties. Only the
    candidates go to float64, never the whole item matrix."""
    nq = queries.shape[0]
    dist_out = np.empty((nq, k), np.float64)
    ids_out = np.empty((nq, k), np.int64)
    for s in range(0, nq, batch_queries):
        ci = cand_idx[s:s + batch_queries]
        q = queries[s:s + batch_queries].double()
        cand = x[ci.clamp_min(0)].double()  # [B, k_adc, d]
        d2 = torch.sum((cand - q[:, None, :]) ** 2, dim=2)
        d2 = torch.where(ci >= 0, d2, float("inf"))
        order = torch.sort(d2, dim=1, stable=True).indices[:, :k]
        dist_out[s:s + len(ci)] = torch.sqrt(d2.gather(1, order)).cpu().numpy()
        ids_out[s:s + len(ci)] = ci.gather(1, order).cpu().numpy()
    return dist_out, ids_out
