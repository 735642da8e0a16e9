#
# Sparse input for the solvers: CSR -> padded ELL on the host, and the ELL
# products on the device. The PyTorch counterpart of
# spark_rapids_ml_tpu/ops/sparse.py.
#
# Padded ELL stores every row as exactly `k_max` (column index, value)
# cells, short rows padded with (0, 0.0), so every product has a static
# shape. A padding cell gathers B[0] and multiplies it by 0: it adds
# nothing, and gives NaN where B[0] is inf or NaN, as in the JAX package.
#
#   X·b    gather b by index and sum each row's k_max products
#          (`ell_matvec`; `ell_matmul` is it column by column, so a column's
#          product is the same bits whatever columns ride beside it, the
#          contract the batched grids stand on);
#   Xᵀ·r   per-column sums of the cells (`ell_rmatvec`, `ell_col_moments`).
#
# The JAX package makes the per-column sums one scatter-add. On the card a
# float scatter-add (`index_add_`, `scatter_add_`, `index_put_` with
# accumulate) adds in the order the threads arrive, and the port promises
# fits that repeat bit for bit. So the sums go through `EllColumns`: the
# cells sorted by column once per placement (a stable sort, so a column's
# cells stay in row order), then reduced per column in fixed chunks of
# `SEGMENT_CHUNK` with dense `torch.sum`s, level by level until one value
# per column is left. The order of every addition is fixed by the data's
# layout alone. The (0, 0.0) cells are left out of the sorted copy; what
# they would add into column 0 (0·r: zero, or NaN where r is not finite)
# is added back as 0·max|r| over their rows.
#
# `ell_densify` writes row tiles of the dense matrix on the device, one ELL
# slot at a time: a slot holds one cell per row, so no two cells of one
# step share a target, and duplicate columns of a row add in slot order
# (scipy's `todense` order). The linear fit's gram and the sparse kNN's
# item tiles are products of such tiles.
#
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import telemetry

# values summed by one dense `torch.sum` of the column reduction
SEGMENT_CHUNK = 32
# gathered cells per row tile of `ell_matvec` (bounds its [rows, k_max]
# temporaries)
MATVEC_TILE_CELLS = 1 << 25


def csr_to_ell(csr, k_max: Optional[int] = None, dtype=None) -> Tuple[np.ndarray, np.ndarray, int]:
    """A scipy CSR matrix as padded-ELL host arrays: (indices [n, k_max]
    int32, values [n, k_max] at `dtype`, k_max). Rows with fewer than k_max
    nonzeros are padded with index 0 and value 0; duplicate column entries
    stay separate cells. A given `k_max` must cover the widest row. The
    fill runs in row chunks of ``config["ingest_chunk_bytes"]``, so its
    index temporaries never scale with the dataset."""
    from ..data import ingest_chunk_rows

    csr = csr.tocsr()
    n, _ = csr.shape
    row_nnz = np.diff(csr.indptr)
    local_max = int(row_nnz.max()) if n else 0
    if k_max is None:
        k_max = local_max
    elif local_max > k_max:
        raise ValueError(f"k_max={k_max} < widest row nnz {local_max}")
    dtype = dtype or csr.dtype
    width = max(k_max, 1)
    indices = np.zeros((n, width), dtype=np.int32)
    values = np.zeros((n, width), dtype=dtype)
    if csr.nnz:
        step = ingest_chunk_rows(width * (4 + np.dtype(dtype).itemsize))
        indptr = csr.indptr
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            nnz_lo, nnz_hi = int(indptr[lo]), int(indptr[hi])
            if nnz_hi == nnz_lo:
                continue
            cnt = row_nnz[lo:hi]
            rows = np.repeat(np.arange(hi - lo), cnt)
            offsets = np.arange(nnz_hi - nnz_lo) - np.repeat(indptr[lo:hi] - nnz_lo, cnt)
            indices[lo:hi][rows, offsets] = csr.indices[nnz_lo:nnz_hi].astype(np.int32)
            values[lo:hi][rows, offsets] = csr.data[nnz_lo:nnz_hi].astype(dtype, copy=False)
    if telemetry.enabled():
        reg = telemetry.registry()
        reg.inc("sparse.csr_to_ell_calls")
        reg.inc("sparse.ell_rows", n)
        reg.inc("sparse.ell_bytes", values.nbytes + indices.nbytes)
        # the padding cells (value 0) among the ELL cells
        reg.inc("sparse.ell_pad_cells", n * width - int(csr.nnz))
        reg.gauge("sparse.k_max", width)
    return indices, values, width


def _row_tiles(n: int, k_max: int, tile_cells: int = MATVEC_TILE_CELLS) -> List[slice]:
    step = max(1, tile_cells // max(1, k_max))
    return [slice(lo, min(lo + step, n)) for lo in range(0, n, step)]


def ell_matvec(values: torch.Tensor, indices: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X·b for ELL X: [n, k_max] x [d] -> [n], each row's k_max products
    summed by one dense reduction, in row tiles."""
    n, k_max = values.shape
    out = values.new_empty((n,))
    for rows in _row_tiles(n, k_max):
        # index_select takes the int32 indices as they are (b[indices] would
        # widen them to int64 first)
        gathered = b.index_select(0, indices[rows].reshape(-1)).view(-1, k_max)
        out[rows] = torch.sum(values[rows] * gathered, dim=1)
    return out


def ell_matmul(values: torch.Tensor, indices: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X·B for ELL X: [n, k_max] x [d, c] -> [n, c], column by column
    (`ell_matvec`), so a column's product does not depend on the others."""
    if B.shape[1] == 0:
        return values.new_zeros((values.shape[0], 0))
    Bt = B.T.contiguous()
    return torch.stack([ell_matvec(values, indices, Bt[j]) for j in range(Bt.shape[0])], dim=1)


def _segment_levels(counts: torch.Tensor, chunk: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The gathers that reduce contiguous segments of `counts[j]` values
    (segment j after segment j-1) to one value each: per level, an index
    [n_chunks * chunk] into the level's values with one appended zero (the
    index equal to their count points at it), every segment's values cut
    into chunks of `chunk` that no other segment shares; then `final` [S],
    each segment's one value or the zero."""
    device = counts.device
    levels = []
    while counts.numel() and int(counts.max()) > 1:
        n_src = int(counts.sum())
        chunks = (counts + chunk - 1) // chunk
        src_off = torch.cumsum(counts, 0) - counts
        first = torch.cumsum(chunks, 0) - chunks
        seg = torch.repeat_interleave(torch.arange(counts.numel(), device=device), chunks)
        k_in_seg = torch.arange(seg.numel(), device=device) - first[seg]
        lane = torch.arange(chunk, device=device)
        slot = k_in_seg[:, None] * chunk + lane[None, :]
        gather = torch.where(slot < counts[seg][:, None], src_off[seg][:, None] + slot, n_src)
        levels.append(gather.reshape(-1))
        counts = chunks
    n_src = int(counts.sum())
    final = torch.where(counts > 0, torch.cumsum(counts, 0) - counts, n_src)
    return levels, final


def _reduce_segments(p: torch.Tensor, levels: List[torch.Tensor], final: torch.Tensor, chunk: int) -> torch.Tensor:
    """One value per segment from values laid out segment after segment
    (`_segment_levels`' gathers), in chunks of `chunk`, level by level."""
    for gather in levels:
        p = F.pad(p, (0, 1))[gather].view(-1, chunk).sum(dim=1)
    return F.pad(p, (0, 1))[final]


def segment_sums(values: torch.Tensor, keys: torch.Tensor, n_segments: int, chunk: int = SEGMENT_CHUNK) -> torch.Tensor:
    """out[s] = Σ values[i] over keys[i] == s [n_segments], in an order the
    keys alone fix: the values stably sorted by key (each segment's in
    index order), then reduced as `EllColumns` reduces a column. A float
    `index_add_` gives the same sums in the order the card's threads
    arrive, so not the same bits twice."""
    keys = keys.to(torch.int64)
    order = torch.sort(keys, stable=True).indices
    levels, final = _segment_levels(torch.bincount(keys, minlength=n_segments), chunk)
    return _reduce_segments(values[order], levels, final, chunk)


class EllColumns:
    """The cells of a placed ELL block grouped by column, for sums over
    columns whose order the layout fixes (the module note). Built once per
    placement (`core.FitInputs.ell_columns`) or once per streamed chunk
    and pass; holds the flat positions of the cells sorted by column (in
    row order within a column), the reduction's level gathers, and the rows
    holding a (0, 0.0) cell."""

    def __init__(self, values: torch.Tensor, indices: torch.Tensor, d: int, chunk: int = SEGMENT_CHUNK) -> None:
        n, k_max = values.shape
        flat_idx = indices.reshape(-1)
        flat_val = values.reshape(-1)
        real = (flat_idx != 0) | (flat_val != 0)
        cells = torch.nonzero(real).squeeze(1)
        cols = flat_idx[cells].to(torch.int64)
        order = torch.sort(cols, stable=True).indices
        self.cells = cells[order]
        self.k_max = int(k_max)
        self.n_rows = int(n)
        self.d = int(d)
        self.chunk = int(chunk)
        self.levels, self.final = _segment_levels(torch.bincount(cols, minlength=self.d), self.chunk)
        self.pad_rows = (~real).reshape(n, k_max).any(dim=1)

    def nbytes(self) -> int:
        """Device bytes the grouping holds."""
        held = [self.cells, self.final, self.pad_rows] + list(self.levels)
        return int(sum(t.numel() * t.element_size() for t in held))

    def col_sums(self, values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Σ over the cells of column j of value·x[row], for every column j
        [d], in the fixed order; `values` is the block the grouping was made
        of, or a copy of it with equal zeros (the `fast` rounding)."""
        p = values.reshape(-1)[self.cells] * x[torch.div(self.cells, self.k_max, rounding_mode="floor")]
        out = _reduce_segments(p, self.levels, self.final, self.chunk)
        if self.n_rows:
            # the (0, 0.0) cells' 0·x into column 0: NaN where x is not finite
            pad_max = torch.amax(torch.where(self.pad_rows, torch.abs(x), torch.zeros_like(x)))
            out[0] = out[0] + 0.0 * pad_max
        return out


def ell_rmatvec(
    values: torch.Tensor, indices: torch.Tensor, r: torch.Tensor, d: int, columns: Optional[EllColumns] = None
) -> torch.Tensor:
    """Xᵀ·r for ELL X: [n, k_max] x [n] -> [d], the per-column sums of
    value·r[row] in the layout's fixed order (`EllColumns`, made here when
    none is given)."""
    if columns is None:
        columns = EllColumns(values, indices, d)
    return columns.col_sums(values, r)


def ell_col_moments(
    values: torch.Tensor, indices: torch.Tensor, w: torch.Tensor, d: int, columns: Optional[EllColumns] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted per-column moments of ELL X, without densifying: (Σw,
    mean [d], var [d]) with var = E[x²] − mean² (population, unclamped).
    The implicit zeros count, since the divisor is the whole Σw. In a
    multi-process fit the raw sums are those of every rank's rows
    (`parallel.context.allreduce_fixed`)."""
    from ..parallel.context import allreduce_fixed

    if columns is None:
        columns = EllColumns(values, indices, d)
    total_w, s1, s2 = allreduce_fixed(
        torch.sum(w), columns.col_sums(values, w), columns.col_sums(values * values, w)
    )
    mean = s1 / total_w
    var = s2 / total_w - mean * mean
    return total_w, mean, var


def ell_densify(values: torch.Tensor, indices: torch.Tensor, d: int) -> torch.Tensor:
    """The dense [n, d] rows of an ELL block, on its device: one
    `scatter_add_` per slot, each with one cell per row, so duplicate
    columns of a row add in slot order and no two cells race."""
    n, k_max = values.shape
    out = values.new_zeros((n, d))
    idx = indices.to(torch.int64)
    for s in range(k_max):
        out.scatter_add_(1, idx[:, s:s + 1], values[:, s:s + 1])
    return out


def round_bf16(values: torch.Tensor) -> torch.Tensor:
    """The `fast` (solver_precision="bf16") ELL values: rounded through
    bf16 once, back at their dtype; the sums stay at full precision."""
    return values.to(torch.bfloat16).to(values.dtype)
