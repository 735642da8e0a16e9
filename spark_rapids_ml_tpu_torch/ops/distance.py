#
# The tiled distance core in PyTorch: the public functions of
# spark_rapids_ml_tpu/ops/distance.py that the KMeans fit, transform and
# k-means|| seeding run, the running top-k of exact kNN, and DBSCAN's dense
# distance tiles (`pairwise_d2`), with the same contracts and the same
# ||x||^2-free results.
#
# Each function that holds a kernel has a plain PyTorch version beside it,
# the counterpart of the JAX package's jnp branch. Dispatch is on the
# tensor's device: a CPU tensor takes the plain version; a CUDA tensor takes
# the hand-written kernel (ops/_kernels.py) or raises. Nothing falls back.
#
# `fast` = bf16 inputs with float32 accumulation (distance_precision="fast",
# serve_dtype="bf16"): the plain versions round both operands to bf16, widen
# them to float32, multiply in float32 and cast the product back to the
# inputs' dtype, which is exactly a bf16 product with float32 accumulation (a
# product of two bf16 values is exact in float32), as the JAX package's `_mm`
# and its Pallas `fast` bodies compute it for float32 and float64 inputs alike.
# float64 reaches bf16 through float32 (two roundings), as both torch's and
# XLA's casts do.
#
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from . import _kernels

# Outer row-tile default when config["distance_tile_rows"] is missing or
# invalid (the config default matches this).
_DEFAULT_TILE_ROWS = 4096

# Items per distance block of the top-k merge (`topk_tile`), on the CPU and
# the card alike, so the CPU tests run the merge the card runs: at a
# 4096-row query tile one block is 256 MB in float32, and 1M items take 62
# merges (the JAX package's VMEM-sized 128-item blocks would take 7,813).
# Results do not depend on it.
_DEFAULT_K_TILE = 16384


def tile_rows() -> int:
    """Outer row-tile size of the predict-side scan — `config["distance_tile_rows"]`."""
    from ..core import config

    try:
        v = int(config.get("distance_tile_rows", _DEFAULT_TILE_ROWS))
    except (TypeError, ValueError):
        return _DEFAULT_TILE_ROWS
    return v if v > 0 else _DEFAULT_TILE_ROWS


def _on_kernel_device(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (-> the kernel), False for CPU tensors (-> the
    plain version). Any other device, or a mix, raises."""
    devs = {t.device.type for t in tensors}
    if devs == {"cuda"}:
        return True
    if devs == {"cpu"}:
        return False
    raise ValueError(f"{name}: inputs must all be CPU or all be CUDA tensors, got {sorted(devs)}")


# --------------------------------------------------------------- helpers ----


# Rows per chunk of `row_sq`: its temporaries (the padded copy and the
# squares) are one chunk, never the size of its input (at 1M x 3000 float32
# that was 12 GB each). Read at each call.
ROW_SQ_CHUNK_ROWS = 8192


def row_sq(x: torch.Tensor) -> torch.Tensor:
    """Squared row norms, equal bit for bit for equal rows wherever they lie
    in x. torch's CUDA reduction reads the unaligned head of a row apart, so
    at a depth that is not a multiple of 4 two equal rows at different
    offsets could sum in different orders, and a tie between repeated
    centers or items go to the later copy; such rows are summed from a copy
    padded with zero columns to a multiple of 4, where every row starts
    16-byte aligned.

    The rows are summed in chunks of `ROW_SQ_CHUNK_ROWS`, so no temporary
    is larger than a chunk. Past one chunk every chunk is that size, the
    last padded with zero rows: a reduction's order may change with its row
    count, and equal rows in the last chunk must sum as in the others."""
    n, d = x.shape
    step = ROW_SQ_CHUNK_ROWS
    pad = (0, (4 - d % 4) % 4)
    if n <= step:
        xp = torch.nn.functional.pad(x, pad) if pad[1] else x
        return torch.sum(xp * xp, dim=1)
    out = torch.empty((n,), dtype=x.dtype, device=x.device)
    for lo in range(0, n, step):
        blk = x[lo:lo + step]
        rows = blk.shape[0]
        blk = torch.nn.functional.pad(blk, pad + (0, step - rows))
        out[lo:lo + rows] = torch.sum(blk * blk, dim=1)[:rows]
    return out


def fixed_sum(s: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in an order fixed by its length alone: a
    pairwise tree of elementwise adds (entry j + entry j + half, halving the
    width). `torch.sum` or a matmul on the card may pick its reduction split
    from the number of rows, so a row's sum could change with the batch it
    arrives in; here it cannot, which keeps a served request's answer
    independent of the requests it was coalesced with."""
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        odd = s[..., 2 * half:]
        s = s[..., :half] + s[..., half:2 * half]
        if odd.shape[-1]:
            s = torch.cat([s, odd], dim=-1)
    return s[..., 0] if s.shape[-1] else s.new_zeros(s.shape[:-1])


def row_sq_fixed(x: torch.Tensor) -> torch.Tensor:
    """Row norms summed in an order fixed by the row length alone
    (`fixed_sum`)."""
    return fixed_sum(x * x)


def _c_sq(c: torch.Tensor) -> torch.Tensor:
    return row_sq(c)


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """`a` rounded to bf16 (round to nearest even) and widened to float32."""
    return a.to(torch.bfloat16).to(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, fast: bool) -> torch.Tensor:
    """Matmul at the loop precision: `fast` = bf16-rounded inputs, float32
    accumulation, the product cast back to the inputs' dtype (see the module
    note); else the inputs' own precision."""
    if fast:
        return (_bf16(a) @ _bf16(b)).to(a.dtype)
    return a @ b


# -------------------------------------------------- fused assign (KMeans) ----


def assign_argmin_plain(
    xb: torch.Tensor, centers: torch.Tensor, c_sq: torch.Tensor, fast: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the argmin kernel: (min d2 [B] WITHOUT the ||x||^2
    term, first argmin [B] int32), through the full [B, k] matrix."""
    d2 = c_sq[None, :] - 2.0 * _mm(xb, centers.T, fast)
    return torch.amin(d2, dim=1), torch.argmin(d2, dim=1).to(torch.int32)


def assign_argmin(
    xb: torch.Tensor, centers: torch.Tensor, *, fast: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-center reduction for one row tile: (min d2 [B] WITHOUT the
    ||x||^2 term, assignment [B] int32); ties go to the first center."""
    c_sq = _c_sq(centers)
    if _on_kernel_device("assign_argmin", xb, centers):
        return _kernels.assign_argmin(xb, centers, c_sq, fast=fast)
    return assign_argmin_plain(xb, centers, c_sq, fast)


def accumulate_plain(
    xb: torch.Tensor, wb: torch.Tensor, assign: torch.Tensor, k: int, fast: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the accumulation kernel: (sums [k, d], counts [k])
    through the [B, k] weighted one-hot matrix."""
    oh = torch.nn.functional.one_hot(assign.long(), k).to(xb.dtype) * wb[:, None]
    return _mm(oh.T, xb, fast), torch.sum(oh, dim=0)


def accumulate(
    xb: torch.Tensor, wb: torch.Tensor, assign: torch.Tensor, k: int, *, fast: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted one-hot accumulation of one row tile: (sums [k, d], counts [k]).
    Rows with zero weight contribute nothing."""
    if _on_kernel_device("accumulate", xb, wb, assign):
        return _kernels.assign_accumulate(xb, wb, assign, k, fast=fast)
    return accumulate_plain(xb, wb, assign, k, fast)


def assign_accumulate(
    xb: torch.Tensor,  # [B, d] one row tile
    wb: torch.Tensor,  # [B] weights (0 -> the row contributes nothing)
    centers: torch.Tensor,  # [k, d]
    *,
    fast: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One row tile's fused Lloyd contribution: (sums [k, d], counts [k],
    inertia scalar). The KMeans inner loop: assignment plus the weighted
    one-hot accumulation; on the card neither kernel stores a [B, k] matrix."""
    mind, best = assign_argmin(xb, centers, fast=fast)
    sums, counts = accumulate(xb, wb, best, centers.shape[0], fast=fast)
    inertia = torch.sum(torch.clamp_min(mind + row_sq(xb), 0.0) * wb)
    return sums, counts, inertia


def tile_assign_accumulate(
    X: torch.Tensor, w: torch.Tensor, centers: torch.Tensor, batch_rows: int,
    fast: bool = False, acc: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scan the rows in tiles of `batch_rows`, the ragged tail last; returns
    (sums [k, d], counts [k], inertia), summed over the tiles in row order
    into `acc` (zeros when None), in place. The streamed Lloyd loop passes
    one `acc` through its chunks, which are whole tiles, so its sums are
    the resident loop's additions in the same order. Tiles are views of X,
    so no copy of X is made."""
    n, d = X.shape
    k = centers.shape[0]
    if acc is None:
        acc = (
            torch.zeros((k, d), dtype=X.dtype, device=X.device),
            torch.zeros((k,), dtype=X.dtype, device=X.device),
            torch.zeros((), dtype=X.dtype, device=X.device),
        )
    sums, counts, inertia = acc
    batch_rows = max(1, min(batch_rows, n))
    for start in range(0, n, batch_rows):
        s, c, i = assign_accumulate(
            X[start:start + batch_rows], w[start:start + batch_rows], centers, fast=fast
        )
        sums += s
        counts += c
        inertia += i
    return sums, counts, inertia


# ---------------------------------------------------- row-tiled assignment --


def argmin_assign(
    X: torch.Tensor, centers: torch.Tensor, *, batch_rows: Optional[int] = None,
    fast: bool = False,
) -> torch.Tensor:
    """Nearest-center assignment over ALL rows, in row tiles of `batch_rows`
    (default `config["distance_tile_rows"]`): int32 [n]. The predict-side
    entry (kmeans transform, k-means|| candidate weighting); the full [n, k]
    distance matrix never exists."""
    n = X.shape[0]
    tr = min(batch_rows or tile_rows(), max(n, 1))
    if n <= tr:
        return assign_argmin(X, centers, fast=fast)[1]
    out = torch.empty((n,), dtype=torch.int32, device=X.device)
    for start in range(0, n, tr):
        out[start:start + tr] = assign_argmin(X[start:start + tr], centers, fast=fast)[1]
    return out


# ------------------------------------------------------ distance tiles ------


def pairwise_d2(q: torch.Tensor, x: torch.Tensor, metric: str = "euclidean") -> torch.Tensor:
    """One dense distance tile [tq, n]: squared euclidean, or cosine
    distance. The tile IS the output here (DBSCAN's threshold passes, the
    k-means|| running min), so it stays one matmul.

    For "cosine" the caller has scaled the rows to unit norm, so the
    distance is 1 - q.x^T. For "precomputed" the rows ARE distances
    already (DBSCAN hands each pass the matching column slice of the
    user's distance matrix), so the tile is `q` itself."""
    if metric == "precomputed":
        return q
    if metric == "cosine":
        return 1.0 - q @ x.T
    return row_sq(q)[:, None] - 2.0 * (q @ x.T) + row_sq(x)[None, :]


@contextlib.contextmanager
def ieee_f32_products():
    """float32 matmuls at full precision inside the block: a caller's
    `torch.backends.cuda.matmul.allow_tf32 = True` (TF32 inputs, 10-bit
    mantissas) would move products by ~1e-3 relative, enough to flip a
    pair at DBSCAN's eps or a spectral layout. The setting is the
    process's, restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def min_d2_update(x: torch.Tensor, cand: torch.Tensor, min_d2: torch.Tensor) -> torch.Tensor:
    """min(min_d2, min distance^2 to the NEW candidate block) — the k-means||
    seeding round's incremental matmul (one tile, running min)."""
    d2 = pairwise_d2(x, cand)
    return torch.minimum(min_d2, torch.clamp_min(torch.min(d2, dim=1).values, 0.0))


# ----------------------------------------------------------- top-k (kNN) ----


def d2_block_plain(
    q: torch.Tensor, xt: torch.Tensor, xt_sq: torch.Tensor, fast: bool = False
) -> torch.Tensor:
    """Plain version of the d2-block kernel: the [B, kt] block
    xt_sq - 2 q.xt^T WITHOUT the ||q||^2 term, in the inputs' dtype; `fast`
    takes the product at bf16 with float32 accumulation."""
    return xt_sq[None, :] - 2.0 * _mm(q, xt.T, fast)


def d2_block(
    q: torch.Tensor, xt: torch.Tensor, xt_sq: torch.Tensor, *, fast: bool = False
) -> torch.Tensor:
    """One [B, kt] distance block of the top-k merge (no ||q||^2 term)."""
    if _on_kernel_device("d2_block", q, xt, xt_sq):
        return _kernels.d2_block(q, xt, xt_sq, fast=fast)
    return d2_block_plain(q, xt, xt_sq, fast)


def _smallest_columns(d2: torch.Tensor, kk: int) -> torch.Tensor:
    """Columns of the kk smallest entries of each row of d2, the lower column
    first among equal values, in ascending column order.

    `torch.topk` finds the kk smallest values but may take any of the
    entries equal to the kk-th one. The rows where it had such a choice (more
    entries equal to its largest pick than it picked) are selected again
    with a stable sort, so the result is the lexicographic (value, column)
    minimum, as `jax.lax.top_k` gives. NaN ranks after +inf in both sorts;
    a row whose kk-th pick is NaN chose among NaNs, which `==` cannot count,
    so it is selected again too."""
    B, kt = d2.shape
    if kk >= kt:
        return torch.arange(kt, device=d2.device).expand(B, kt)
    vals, cols = torch.topk(d2, kk, dim=1, largest=False, sorted=False)
    kth = vals.amax(dim=1, keepdim=True)
    choice = ((d2 == kth).sum(dim=1) > (vals == kth).sum(dim=1)) | kth.isnan().squeeze(1)
    rows = torch.nonzero(choice).squeeze(1)
    if rows.numel():
        cols[rows] = torch.sort(d2[rows], dim=1, stable=True).indices[:, :kk]
    return torch.sort(cols, dim=1).values


def _topk_lex(d2: torch.Tensor, kk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, columns) [B, kk] of the kk smallest entries of each row,
    ascending, the lower column first among equal values: the order of
    `jax.lax.top_k(-d2, kk)`, and of an exact `jax.lax.approx_min_k`
    (whose CPU form breaks ties in an order of its own)."""
    cols = _smallest_columns(d2, kk)
    vals = d2.gather(1, cols)
    order = torch.sort(vals, dim=1, stable=True).indices
    return vals.gather(1, order), cols.gather(1, order)


def _merge(best_d2, best_i, d2, first_id: int, kk: int):
    """The kk smallest of the concatenation [best | block], lower position
    first on ties, as `jax.lax.top_k` over it. Blocks are scanned in
    ascending order, so every finite carried entry has a lower id than the
    block's finite entries, and ties go to the lower id."""
    cols = _smallest_columns(d2, kk)
    cat_d = torch.cat([best_d2, d2.gather(1, cols)], dim=1)
    cat_i = torch.cat([best_i, (cols + first_id).to(torch.int32)], dim=1)
    order = torch.sort(cat_d, dim=1, stable=True).indices[:, :kk]
    return cat_d.gather(1, order), cat_i.gather(1, order)


def topk_tile(
    q: torch.Tensor,  # [B, d] one query tile
    items: torch.Tensor,  # [n, d]
    valid: Optional[torch.Tensor],  # [n] bool, or None for all-valid
    kk: int,
    *,
    item_sq: Optional[torch.Tensor] = None,
    fast: bool = False,
    k_tile: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-kk of one query tile against ALL items: (d2 [B, kk]
    WITHOUT the ||q||^2 term, item index [B, kk] int32), ascending by
    distance, lower index first on ties (`jax.lax.top_k`'s order).

    The item axis is scanned in blocks of `k_tile` items (default
    `_DEFAULT_K_TILE`) with the [B, kk] best list carried from block to
    block, so the [B, n] distance matrix never exists; the last block is
    clamped back and its overlap columns (already merged) are masked to
    +inf, as are items with `valid` False. Each block is a view of `items`
    and its distances come from `d2_block` (at bf16 with float32
    accumulation when `fast`; `item_sq` stays the norms of the unrounded
    items, as in the JAX package)."""
    n = items.shape[0]
    kk = min(kk, n)
    if item_sq is None:
        item_sq = row_sq(items)
    kt = min(k_tile or _DEFAULT_K_TILE, n)
    B = q.shape[0]
    if kt >= n:  # one block: the top-kk of it alone, as the reference does
        best_d2 = q.new_empty((B, 0))
        best_i = torch.empty((B, 0), dtype=torch.int32, device=q.device)
    else:
        best_d2 = torch.full((B, kk), float("inf"), dtype=items.dtype, device=q.device)
        best_i = torch.zeros((B, kk), dtype=torch.int32, device=q.device)
    for start in range(0, n, kt):
        s0 = min(start, n - kt)
        d2 = d2_block(q, items[s0:s0 + kt], item_sq[s0:s0 + kt], fast=fast)
        keep = None
        if s0 < start:  # clamp-back overlap: already merged columns
            keep = torch.arange(s0, s0 + kt, device=q.device) >= start
        if valid is not None:
            vb = valid[s0:s0 + kt]
            keep = vb if keep is None else keep & vb
        if keep is not None:
            d2.masked_fill_(~keep[None, :], float("inf"))
        best_d2, best_i = _merge(best_d2, best_i, d2, s0, kk)
    return best_d2, best_i


# ------------------------------------------- gathered candidates (ANN) ----


def score_candidates(
    q_rows: torch.Tensor, cand: torch.Tensor, x: torch.Tensor, x_sq: torch.Tensor, fast: bool = False
) -> torch.Tensor:
    """d2[t, c] = ||q_rows[t] - x[cand[t, c]]||^2, clamped at 0: the
    [T, C, d] gather of the candidates and one batched product (cuBLAS; no
    kernel of the JAX package carries it). `fast` rounds both sides to bf16
    and sums their products in float32 (the rule of `_mm`), as CAGRA's
    descent ranks candidate edges; the search scores at float32."""
    xc = x[cand]  # [T, C, d]
    if fast:
        dots = torch.bmm(_bf16(xc), _bf16(q_rows)[:, :, None])[:, :, 0]
    else:
        dots = torch.bmm(xc, q_rows[:, :, None])[:, :, 0]
    d2 = row_sq(q_rows)[:, None] + x_sq[cand] - 2.0 * dots
    return torch.clamp_min(d2, 0.0)


def batched_self_topk(xb: torch.Tensor, ids_b: torch.Tensor, *, kk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN inside padded buckets: xb [Cb, L, d], ids_b [Cb, L]
    global ids (-1 pad). One batched [Cb, L, L] product and a top-kk per
    row, the lower column first on ties; a row's own column and the pad
    columns are +inf. Returns (d2 [Cb, L, kk], neighbor ids [Cb, L, kk]).
    A pad row is all +inf, so its result is its first kk columns, filled
    here without sorting the row."""
    Cb, L, _ = xb.shape
    sq = torch.sum(xb * xb, dim=2)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(xb, xb.transpose(1, 2))
    valid = ids_b >= 0
    mask = valid[:, None, :] & valid[:, :, None]
    mask &= ~torch.eye(L, dtype=torch.bool, device=xb.device)[None]
    d2 = torch.where(mask, torch.clamp_min(d2, 0.0), float("inf")).reshape(Cb * L, L)
    rows = torch.nonzero(valid.reshape(-1)).squeeze(1)
    nd2 = torch.full((Cb * L, kk), float("inf"), dtype=d2.dtype, device=d2.device)
    pos = torch.arange(kk, device=d2.device).repeat(Cb * L, 1)
    if rows.numel():
        nd2[rows], pos[rows] = _topk_lex(d2[rows], kk)
    pos = pos.reshape(Cb, L, kk)
    nid = torch.gather(ids_b[:, None, :].expand(Cb, L, L), 2, pos)
    return nd2.reshape(Cb, L, kk), nid
