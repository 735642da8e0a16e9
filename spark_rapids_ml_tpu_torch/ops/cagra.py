#
# CAGRA-class graph ANN on one device: the PyTorch counterpart of
# spark_rapids_ml_tpu/ops/cagra.py, step for step.
#
# Build: `build_algo="ivf_pq"` seeds the graph by clustered brute force
# (`_cluster_seed_rep`: rows partitioned by their nearest random anchor,
# through the argmin kernel, exact kNN inside each padded bucket by one
# batched product) over several repetitions, merged by `_merge_dedup_topk`;
# "nn_descent" starts from a random graph. Then NN-descent rounds
# (`_descent_round`) over row tiles: each tile expands the lists of its
# closest, random and reverse neighbors, scores the candidates
# (`distance.score_candidates`, bf16 products with float32 sums when
# `fast_score`) and keeps the smallest distances. Reverse edges
# (`_reverse_edges`) are rebuilt every other round by one stable sort; the
# host reads one count per round (`n_new`) for the early exit.
#
# Search: per query tile, a greedy expansion of an itopk-wide candidate
# list from random starts (`_search_tile`).
#
# The random draws are the JAX package's: the threefry stream of
# ops/prng.py where it uses jax.random (batched over a round's tiles here),
# numpy's default_rng where it uses that. Its `jax.lax.approx_min_k` is the
# exact smallest-k here, the lower position first on ties (on the CPU JAX's
# is exact too, but orders ties its own way; its values and, on data
# without ties, its positions agree). Distances are squared L2.
#
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from . import prng
from .distance import _topk_lex, argmin_assign, batched_self_topk, row_sq, score_candidates

__all__ = ["build_cagra", "cagra_search"]

_INF = float("inf")


def _merge_dedup_topk(all_ids, all_d2, keep: int, extra=None):
    """Per-row merge of candidate lists: duplicate ids dropped (the
    smallest-d² copy kept), then the `keep` smallest distances. A stable
    sort by d², then a stable sort by id, so the first entry of every
    equal-id run is its best copy; later copies get +inf and fall out of
    the final top-k. `extra` (the search's expanded flags) rides along."""
    ord1 = torch.sort(all_d2, dim=1, stable=True).indices
    ids1 = all_ids.gather(1, ord1)
    d21 = all_d2.gather(1, ord1)
    ord2 = torch.sort(ids1, dim=1, stable=True).indices
    ids2 = ids1.gather(1, ord2)
    d22 = d21.gather(1, ord2)
    dup = torch.zeros_like(ids2, dtype=torch.bool)
    dup[:, 1:] = ids2[:, 1:] == ids2[:, :-1]
    d22 = torch.where(dup, _INF, d22)
    out_d2, pos = _topk_lex(d22, keep)
    out_ids = ids2.gather(1, pos)
    if extra is None:
        return out_ids, out_d2
    return out_ids, out_d2, extra.gather(1, ord1).gather(1, ord2).gather(1, pos)


def _reverse_edges(ids: torch.Tensor, *, r_max: int) -> torch.Tensor:
    """[n, r_max] reverse adjacency (pad -1): the flat edge list stably
    sorted by its head, each edge's position within its head's run, one
    scatter that drops positions past r_max (a hub keeps the sources of
    its first r_max edges in row order)."""
    n, k = ids.shape
    flat = ids.reshape(-1).long()
    src = torch.arange(n, dtype=torch.int32, device=ids.device).repeat_interleave(k)
    order = torch.sort(flat, stable=True).indices
    st = flat[order]
    ss = src[order]
    seg_start = torch.searchsorted(st, torch.arange(n, dtype=st.dtype, device=ids.device))
    offs = torch.arange(st.shape[0], device=ids.device) - seg_start[st]
    keep = offs < r_max
    rev = torch.full((n, r_max), -1, dtype=torch.int32, device=ids.device)
    rev[st[keep], offs[keep]] = ss[keep]
    return rev


def _pair_mask(cand: torch.Tensor) -> torch.Tensor:
    """[T, C] True where a candidate repeats an earlier one of its row."""
    c_w = cand.shape[1]
    earlier = torch.arange(c_w, device=cand.device)[None, :] < torch.arange(c_w, device=cand.device)[:, None]
    return torch.any((cand[:, :, None] == cand[:, None, :]) & earlier[None], dim=2)


def _descent_round(x, x_sq, ids, d2, rev, key, *, tile: int, s_top: int, s_rnd: int,
                   s_rev: int, c_rnd: int, fast: bool = False):
    """One NN-descent round over every row, in tiles of `tile` rows in row
    order, each reading the graph as the tiles before it left it (the last
    tile is clamped back). Per tile: the top-64 of the lists of `s_top`
    closest + `s_rnd` random + `s_rev` reverse neighbors, the reverse edges
    themselves and `c_rnd` random ids are scored; pads, self, ids already in
    the list and repeats within the block are +inf; the k_int smallest of
    list + candidates stay. The tile's key is fold_in(key, tile) and its
    three draws split(tile key, 3), all hashed for the round at once.
    `ids` and `d2` are updated in place. Returns (ids, d2, n_new), n_new
    the count of accepted candidates in rows the tile owns, on the device."""
    n, d = x.shape
    k_int = ids.shape[1]
    n_tiles = -(-n // tile)
    half = min(64, k_int)
    r_w = rev.shape[1]
    tkeys = prng.split(prng.fold_in(key, torch.arange(n_tiles, device=x.device)), 3)  # [T, 3, 2]
    rnd_lo = s_top if k_int > s_top else 0
    rnd_slots = prng.randint(tkeys[:, 0], (tile, s_rnd), rnd_lo, k_int)
    rev_slots = prng.randint(tkeys[:, 1], (tile, s_rev), 0, r_w)
    cand_rnd = prng.randint(tkeys[:, 2], (tile, c_rnd), 0, n).to(ids.dtype)
    n_new = torch.zeros((), dtype=torch.int64, device=x.device)
    for ti in range(n_tiles):
        r0 = min(ti * tile, n - tile)
        rows = torch.arange(r0, r0 + tile, device=x.device)
        ids_t = ids[r0:r0 + tile].clone()
        d2_t = d2[r0:r0 + tile].clone()
        rev_t = rev[r0:r0 + tile]
        src = torch.cat([
            ids_t[:, :s_top],
            ids_t.gather(1, rnd_slots[ti]),
            rev_t.gather(1, rev_slots[ti]).clamp(0, n - 1).to(ids.dtype),
        ], dim=1)
        cand_fwd = ids[src.long()][:, :, :half].reshape(tile, -1)
        cand = torch.cat([cand_fwd, rev_t.to(ids.dtype), cand_rnd[ti]], dim=1)
        invalid = (cand < 0) | (cand == rows[:, None])
        invalid |= torch.any(cand[:, :, None] == ids_t[:, None, :], dim=2)
        invalid |= _pair_mask(cand)
        cand = cand.clamp(0, n - 1)
        d2_cand = torch.where(invalid, _INF, score_candidates(x[r0:r0 + tile], cand.long(), x, x_sq, fast=fast))
        new_d2, pos = _topk_lex(torch.cat([d2_t, d2_cand], dim=1), k_int)
        new_ids = torch.cat([ids_t, cand], dim=1).gather(1, pos)
        fresh = (rows >= ti * tile)[:, None]
        n_new += torch.sum(fresh & (pos >= k_int))
        ids[r0:r0 + tile] = new_ids
        d2[r0:r0 + tile] = new_d2
    return ids, d2, n_new


def _cluster_seed_rep(xd, x_sq, n: int, anchors_c: int, kk: int, seed: int):
    """One clustered brute-force seeding repetition: rows partitioned by
    their nearest of min(anchors_c, n) random anchor rows (the argmin
    kernel), laid out as padded buckets in row order (a bucket holds at most
    max(kk + 1, 4·n/C) rows: overflow rows miss this repetition), exact kNN
    inside each bucket (`batched_self_topk`, buckets batched so a batch's
    [Cb, L, L] and [Cb, L, d] stay near 0.5 GB), each row's result written
    to its own row. Returns (ids [n, kk] int32, d2 [n, kk]); a row in no
    bucket keeps ids 0 at +inf, an under-filled bucket's pad neighbors
    become id 0 at +inf."""
    d = xd.shape[1]
    rng = np.random.default_rng(seed)
    pick = torch.from_numpy(rng.choice(n, min(anchors_c, n), replace=False)).to(xd.device)
    anchors = xd.index_select(0, pick)
    assign = argmin_assign(xd, anchors).cpu().numpy()
    C = anchors.shape[0]
    counts = np.bincount(assign, minlength=C)
    l_cap = max(kk + 1, int(4 * max(1, n // max(C, 1))))
    L = int(min(counts.max(), l_cap))
    order = np.argsort(assign, kind="stable")
    offs = np.arange(n) - (np.cumsum(counts) - counts)[assign[order]]
    keep = offs < L
    ids_b = np.full((C, L), -1, np.int64)
    ids_b[assign[order][keep], offs[keep]] = order[keep]
    idsj = torch.from_numpy(ids_b).to(xd.device)

    rep_d2 = torch.full((n, kk), _INF, dtype=torch.float32, device=xd.device)
    rep_id = torch.zeros((n, kk), dtype=torch.int32, device=xd.device)
    cb = max(1, int(500_000_000 // max(L * L * 4 + L * d * 4, 1)))
    for c0 in range(0, C, cb):
        idc = idsj[c0:c0 + cb]
        xb = xd[idc.clamp(0, n - 1)]
        nd2, nid = batched_self_topk(xb, idc, kk=kk)
        flat = idc.reshape(-1)
        real = flat >= 0  # pad slots write nowhere
        rep_d2[flat[real]] = nd2.reshape(-1, kk)[real]
        rep_id[flat[real]] = nid.reshape(-1, kk)[real].clamp_min(0).to(torch.int32)
    return rep_id, rep_d2


def build_cagra(
    xd: torch.Tensor,
    *,
    graph_degree: int = 64,
    intermediate_graph_degree: int = 128,
    build_algo: str = "ivf_pq",
    nn_descent_niter: int = 0,
    cluster_reps: int = 8,
    seed: int = 0,
    termination_threshold: float = 0.003,
    fast_score: bool = True,
) -> Dict[str, Any]:
    """The CAGRA graph index over float32 rows xd [n, d] on the device:
    {"x": xd, "graph": [n, graph_degree] int32}, both on the device.

    build_algo "ivf_pq" (n > 4·k_int): `cluster_reps` seeding repetitions
    (anchors ~n/512, bucket kNN of min(64, k_int, n-1)) merged into the
    k_int = min(intermediate_graph_degree, n-1) lists, then up to 3 descent
    rounds; "nn_descent" (or a small n): a random graph from
    `np.random.default_rng(seed)`, then up to 14 rounds; nn_descent_niter
    > 0 sets the round count. The descent stops after a round that accepts
    fewer than termination_threshold·n·k_int candidates. Tiles are sized so
    the [tile, c_total, d] candidate gather stays near 1.5 GB. The lists
    are distance-sorted; the graph keeps the first graph_degree of each."""
    n, d = xd.shape
    if build_algo not in ("ivf_pq", "nn_descent"):
        raise ValueError(f"build_algo {build_algo!r} not supported (ivf_pq | nn_descent)")
    k_int = int(min(intermediate_graph_degree, max(n - 1, 1)))
    k_out = int(min(graph_degree, k_int))
    use_seeding = build_algo == "ivf_pq" and n > 4 * k_int
    n_rounds = int(nn_descent_niter) or (3 if use_seeding else 14)
    rng = np.random.default_rng(seed)
    x_sq = row_sq(xd)

    if use_seeding:
        anchors_c = max(2, n // 512)
        kk = min(64, k_int, n - 1)
        reps = [_cluster_seed_rep(xd, x_sq, n, anchors_c, kk, seed * 1000 + rep) for rep in range(max(1, cluster_reps))]
        rep_ids = torch.cat([r[0] for r in reps], dim=1)
        rep_d2 = torch.cat([r[1] for r in reps], dim=1)
        del reps
        if rep_ids.shape[1] < k_int:  # top-k needs width >= k_int: +inf slots
            pad = k_int - rep_ids.shape[1]
            rep_ids = torch.cat([rep_ids, rep_ids.new_zeros((n, pad))], dim=1)
            rep_d2 = torch.cat([rep_d2, rep_d2.new_full((n, pad), _INF)], dim=1)
        ids, d2 = _merge_dedup_topk(rep_ids, rep_d2, k_int)
        del rep_ids, rep_d2
    else:
        # random lists; round 0 scores them through the candidate channels
        ids = torch.from_numpy(rng.integers(0, n, size=(n, k_int)).astype(np.int32)).to(xd.device)
        d2 = torch.full((n, k_int), _INF, dtype=torch.float32, device=xd.device)

    s_top, s_rnd, s_rev, c_rnd, r_max = 2, 1, 1, 32, 64
    c_total = (s_top + s_rnd + s_rev) * min(64, k_int) + r_max + c_rnd
    tile = int(min(n, max(64, (1_500_000_000 // (c_total * d * 4)) & ~63)))
    tile = max(1, min(tile, n))
    key = prng.prng_key(seed, xd.device)
    rev = None
    min_new = max(1, int(termination_threshold * n * k_int))
    for rnd in range(n_rounds):
        if rnd % 2 == 0 or rev is None:
            rev = _reverse_edges(ids, r_max=r_max)
        ids, d2, n_new = _descent_round(
            xd, x_sq, ids, d2, rev, prng.fold_in(key, rnd),
            tile=tile, s_top=s_top, s_rnd=s_rnd, s_rev=s_rev, c_rnd=c_rnd, fast=bool(fast_score),
        )
        if int(n_new) < min_new:  # the one read of the round
            break
    return {"x": xd, "graph": ids[:, :k_out].contiguous()}


def _search_tile(xq, x, x_sq, graph, key, *, itopk: int, k: int, search_width: int, iters: int):
    """Greedy graph search of one query tile. Each query keeps `itopk` ids,
    their d² and an expanded flag, from random starts (randint(key)); each
    of `iters` iterations expands its best `search_width` unexpanded
    entries, scores their adjacency rows (repeats of a listed id or of an
    earlier candidate +inf) and keeps the itopk smallest, flags riding
    along. Returns (ids [Q, k], d2 [Q, k]), ascending."""
    qn = xq.shape[0]
    n = x.shape[0]
    deg = graph.shape[1]
    init_ids = prng.randint(key, (qn, itopk), 0, n).to(torch.int32)
    ids, d2 = _merge_dedup_topk(init_ids, score_candidates(xq, init_ids.long(), x, x_sq), itopk)
    expanded = torch.zeros((qn, itopk), dtype=torch.bool, device=xq.device)
    for _ in range(iters):
        _, sel = _topk_lex(torch.where(expanded, _INF, d2), search_width)
        sel_ids = ids.gather(1, sel)
        expanded = expanded.scatter(1, sel, True)
        cand = graph[sel_ids.long()].reshape(qn, search_width * deg)
        dup = torch.any(cand[:, :, None] == ids[:, None, :], dim=2) | _pair_mask(cand)
        d2c = torch.where(dup | (cand < 0), _INF, score_candidates(xq, cand.long().clamp_min(0), x, x_sq))
        d2, pos = _topk_lex(torch.cat([d2, d2c], dim=1), itopk)
        ids = torch.cat([ids, cand], dim=1).gather(1, pos)
        expanded = torch.cat([expanded, torch.zeros_like(dup)], dim=1).gather(1, pos)
    out_d2, pos = _topk_lex(d2, k)
    return ids.gather(1, pos), out_d2


def cagra_search(
    queries: torch.Tensor,
    index: Dict[str, Any],
    *,
    k: int,
    itopk_size: int = 64,
    search_width: int = 1,
    max_iterations: int = 0,
    min_iterations: int = 0,
    num_random_samplings: int = 1,
    seed: int = 0,
    batch_queries: int = 4096,
):
    """Batched greedy search over the CAGRA graph: host arrays (ids [nq, k]
    int64, d² [nq, k] float32). itopk_size is rounded up to a multiple of
    32 and must be >= k; max_iterations 0 takes enough iterations to expand
    the whole list at the search width. Query tiles hold at most
    `batch_queries` rows, fewer when the [tile, width·degree, d] frontier
    gather would pass ~1.5 GB; the last tile is padded with zero rows. Tile
    s, sampling r draws its starts from fold_in(PRNGKey(seed), s·131 + r);
    the samplings are merged by `_merge_dedup_topk`."""
    itopk = max(32, int(math.ceil(itopk_size / 32) * 32))
    if itopk < k:
        raise ValueError(f"itopk_size ({itopk}) must be >= k ({k})")
    width = max(1, int(search_width))
    iters = int(max_iterations) if max_iterations else -(-itopk // width)
    iters = max(iters, int(min_iterations), 1)
    x, graph = index["x"], index["graph"]
    nq, d = queries.shape
    x_sq = row_sq(x)
    out_i = np.empty((nq, k), np.int64)
    out_d = np.empty((nq, k), np.float32)
    deg = graph.shape[1]
    cap = int(max(256, (1_500_000_000 // (width * deg * d * 4)) & ~63))
    bq = max(1, min(batch_queries, cap, max(nq, 1)))
    key = prng.prng_key(seed, queries.device)
    for s in range(0, nq, bq):
        qt = queries[s:s + bq]
        valid = qt.shape[0]
        if valid < bq:
            qt = torch.cat([qt, qt.new_zeros((bq - valid, d))], dim=0)
        best_i = best_d = None
        for r in range(max(1, int(num_random_samplings))):
            ti, td = _search_tile(qt, x, x_sq, graph, prng.fold_in(key, s * 131 + r),
                                  itopk=itopk, k=k, search_width=width, iters=iters)
            if best_i is None:
                best_i, best_d = ti, td
            else:
                best_i, best_d = _merge_dedup_topk(torch.cat([best_i, ti], dim=1), torch.cat([best_d, td], dim=1), k)
        out_i[s:s + valid] = best_i[:valid].cpu().numpy()
        out_d[s:s + valid] = best_d[:valid].cpu().numpy()
    return out_i, out_d
