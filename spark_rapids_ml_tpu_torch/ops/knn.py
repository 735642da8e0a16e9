#
# Exact k-nearest-neighbors on one device: the PyTorch counterpart of the
# single-device path of spark_rapids_ml_tpu/ops/knn.py (`exact_knn` ->
# `_exact_knn_1dev`). Query tiles of `batch_queries` rows run the shared
# distance core's running top-k (ops/distance.py topk_tile), whose distance
# blocks come from the d2-block kernel on the card.
#
# Sparse item sets (`exact_knn_sparse`) are ROADMAP item A11, the sharded
# search over several cards (`_exact_knn_sharded`, `tile_topk`) item A10.
#
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .distance import row_sq, tile_rows, topk_tile


def exact_knn(
    items: torch.Tensor,  # [n, d] on the device
    valid: Optional[torch.Tensor],  # [n] bool, or None for all-valid
    queries: torch.Tensor,  # [nq, d] on the same device
    *,
    k: int,
    batch_queries: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN of every query against all items: host arrays (euclidean
    distances [nq, k], item row indices [nq, k] int32), ascending by
    distance, lower index first on ties. `batch_queries` defaults to
    ``config["distance_tile_rows"]``. With fewer than k items the missing
    columns hold +inf and index 0.

    Item norms are computed once; each query tile is a view of `queries`
    and every item block a view of `items`, so no copy of either is made.
    The last query tile is clamped back to full size and its overlap rows
    dropped, as the reference does to compile one tile program."""
    nq = queries.shape[0]
    if nq == 0:
        return (
            queries.new_zeros((0, k)).cpu().numpy(),
            np.zeros((0, k), dtype=np.int32),
        )
    kk = min(k, items.shape[0])
    batch_queries = min(batch_queries or tile_rows(), nq)
    item_sq = row_sq(items)
    d_parts, i_parts = [], []
    for start in range(0, nq, batch_queries):
        s0 = min(start, nq - batch_queries)
        q = queries[s0:s0 + batch_queries]
        d2, idx = topk_tile(q, items, valid, kk, item_sq=item_sq)
        fresh = start - s0
        d_parts.append((d2 + row_sq(q)[:, None])[fresh:].cpu().numpy())
        i_parts.append(idx[fresh:].cpu().numpy())
    d2 = np.concatenate(d_parts, axis=0)
    idx = np.concatenate(i_parts, axis=0)
    if kk < k:
        d2 = np.pad(d2, ((0, 0), (0, k - kk)), constant_values=np.inf)
        idx = np.pad(idx, ((0, 0), (0, k - kk)))
    return np.sqrt(np.maximum(d2, 0.0)), idx
