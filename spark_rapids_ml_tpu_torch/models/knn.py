#
# Exact and approximate nearest-neighbor estimators and models, drop-in for
# the JAX package's spark_rapids_ml_tpu/models/knn.py (NearestNeighbors,
# NearestNeighborsModel, ApproximateNearestNeighbors,
# ApproximateNearestNeighborsModel), on one device: fit binds the item set
# (and for ANN builds an IVFFlat, IVFPQ or CAGRA index over it, on the
# card), `kneighbors(query_df)` returns (item_df, query_df, knn_df) with
# knn_df = (query_id, indices, distances), and `exactNearestNeighborsJoin` /
# `approxSimilarityJoin` explode the pairs. None supports persistence, as
# in the reference.
#
# A CSR item set stays CSR: kneighbors searches it tile by tile
# (ops/knn.exact_knn_sparse), each item tile densified on the card and its
# distances taken by the d2-block kernel. CSR queries, and CSR items
# everywhere else (the join's item side, serving, the ANN estimator), are
# densified, as in the JAX package.
#
# The serving hooks keep the item block, its norms and its id map resident
# on the card and answer each query batch through the running top-k
# (`topk_tile`), at the items' dtype or, with serve_dtype="bf16", through the
# d2-block kernel's bf16 tensor-core form.
#
# An ANN model serves as the JAX package's does: it inherits the exact
# model's serving hooks, so the serving plane answers it by exact kNN over
# its item set, not through its index.
#
# Multi-process search (a TpuContext with nranks > 1; the JAX package's
# SPMD branches of kneighbors): the items stay rank-local, their default
# ids offset by the rows of the lower ranks; the queries are gathered from
# every rank (the process group, in rank order); each rank searches its own
# items for every query (`exact_knn` or, for CSR items, `exact_knn_sparse`
# on the d2-block kernel; an ANN model its own index, built at fit over the
# rank's items); the per-rank candidates (distance, item id) are gathered
# and merged into the global top-k (`ops/knn.merge_topk`, the order of one
# `exact_knn` over the global rows), and each rank returns its own queries'
# rows. The joins are refused under a multi-process context (the item
# table lives on every rank, as in the JAX package).
#
# One process driving several chips (num_workers past one over a device
# pool of several; `parallel.fan_out_width`) runs that same search, one
# thread a chip (`parallel.run_on_chips`): chip r holds block r of the
# items (`parallel.shard_row_ranges`) and of the queries, the ANN its own
# index built at fit over its block on its chip, and the chips' query rows
# come back in order.
#
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import _TpuEstimator, _TpuModel, alias
from ..data import ExtractedData, as_dense, as_pandas
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasIDCol,
    HasInputCol,
    HasInputCols,
    HasLabelCol,
    Param,
    TypeConverters,
)


class _KNNParams(HasInputCol, HasInputCols, HasFeaturesCol, HasFeaturesCols, HasIDCol, HasLabelCol):
    k = Param("k", "the number of nearest neighbors to retrieve", TypeConverters.toInt)

    def getK(self) -> int:
        return self.getOrDefault("k")

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"k": "n_neighbors"}

    def _get_solver_params_default(self) -> Dict[str, Any]:
        # batch_queries 0 = config["distance_tile_rows"] (the query tile of
        # the distance core); a nonzero value overrides it per estimator
        return {"n_neighbors": 5, "batch_queries": 0, "verbose": False}


class NearestNeighbors(_KNNParams, _TpuEstimator):
    """Exact kNN estimator.

    >>> nn = NearestNeighbors(k=2).setInputCol("features").setIdCol("id")
    >>> model = nn.fit(item_df)
    >>> item_out, query_out, knn_df = model.kneighbors(query_df)

    On the card, each query tile scans the items in blocks through the
    d2-block kernel and keeps a running top-k (ops/knn.py). A CSR item set
    is kept CSR and searched tile by tile (`exact_knn_sparse`)."""

    # CSR items are searched as CSR (ops/knn.exact_knn_sparse)
    _supports_sparse_input = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(k=5)
        self._set_params(**kwargs)

    def setK(self, value: int) -> "NearestNeighbors":
        return self._set_params(k=value)

    def setInputCol(self, value) -> "NearestNeighbors":
        return self._set_params(inputCol=value) if isinstance(value, str) else self._set_params(inputCols=value)

    def setIdCol(self, value: str) -> "NearestNeighbors":
        return self._set_params(idCol=value)

    def _fit_internal(self, dataset: Any, paramMaps=None, row_mask=None) -> List["NearestNeighborsModel"]:
        # kNN fits no parameters: the model is the item set, bound here (in
        # a multi-process fit, this rank's items); the search runs in
        # kneighbors, over the chips of the pool when num_workers spans them
        from ..parallel import refuse_devices_per_rank

        refuse_devices_per_rank(self.num_workers, "NearestNeighbors")
        pdf = as_pandas(dataset)
        extracted = self._pre_process_data(dataset, for_fit=True)
        model = NearestNeighborsModel(
            n_cols=extracted.n_cols, dtype="float32" if self._float32_inputs else "float64"
        )
        self._copyValues(model)
        self._copy_solver_params(model)
        model._item_pdf = pdf
        model._item_extracted = extracted
        return [model]

    # _TpuCaller's solver hooks: never reached, _fit_internal binds the items
    def _get_tpu_fit_func(self, extracted: ExtractedData):
        raise NotImplementedError("NearestNeighbors fits no parameters")

    def _create_model(self, attrs: Dict[str, Any]) -> "NearestNeighborsModel":
        raise NotImplementedError("NearestNeighbors fits no parameters")

    def write(self):
        raise NotImplementedError("NearestNeighbors does not support saving (reference parity)")


class NearestNeighborsModel(_KNNParams, _TpuModel):
    # its queries are extracted as the estimator's items are; CSR queries
    # are then densified
    _supports_sparse_input = True

    def __init__(self, n_cols: int = 0, dtype: str = "float32", **kwargs: Any) -> None:
        super().__init__(n_cols=n_cols, dtype=dtype)
        self.n_cols = int(n_cols)
        self.dtype = dtype
        self._item_pdf = None
        self._item_extracted: Optional[ExtractedData] = None

    def _id_col(self) -> str:
        return self.getOrDefault("idCol") if self.isDefined("idCol") else alias.row_number

    @staticmethod
    def _ensure_id(pdf, extracted) -> np.ndarray:
        if extracted.row_id is not None:
            return extracted.row_id
        return np.arange(len(pdf), dtype=np.int64)

    def _with_ids(self, pdf, ids: np.ndarray):
        out = pdf.copy(deep=False)
        if self._id_col() not in out.columns:
            out[self._id_col()] = ids
        return out

    def kneighbors(self, query_df: Any) -> Tuple[Any, Any, Any]:
        """Returns (item_df, query_df, knn_df): the two frames with their id
        column (added as `unique_id` row numbers when no idCol is set), and
        knn_df with columns (query_id, indices, distances), `indices` being
        item id values and `distances` euclidean, float64."""
        import pandas as pd

        from ..ops.knn import exact_knn, exact_knn_sparse
        from ..parallel import default_device, host_tensor, place_rows

        if self._item_pdf is None:
            raise ValueError("NearestNeighborsModel is not bound to an item dataframe; fit it first")
        k = int(self._solver_params["n_neighbors"])
        item_ex = self._item_extracted
        item_ids = self._ensure_id(self._item_pdf, item_ex)
        query_pdf = as_pandas(query_df)
        if len(query_pdf) == 0:
            # nothing to search (ingest can't infer a width from an empty column)
            knn_df = pd.DataFrame(
                {"query_id": np.zeros(0, dtype=np.int64), "indices": [], "distances": []}
            )
            return (self._with_ids(self._item_pdf, item_ids),
                    self._with_ids(query_pdf, np.zeros(0, dtype=np.int64)), knn_df)
        query_ex = self._pre_process_data(query_df, for_fit=False)
        query_ids = self._ensure_id(query_pdf, query_ex)
        device = default_device()
        np_dtype = np.float32 if self._float32_inputs else np.float64
        Q = host_tensor(np.asarray(as_dense(query_ex.features), dtype=np_dtype)).to(device)
        # 0 -> None: resolves config["distance_tile_rows"]
        batch_queries = int(self._solver_params["batch_queries"]) or None
        from ..parallel import fan_out_width, spmd_context

        ctx = spmd_context()
        width = fan_out_width(self.num_workers)
        if ctx is not None or width > 1:
            if ctx is not None:
                dist, indices, item_ids, query_ids = self._kneighbors_spmd(
                    ctx, item_ex, item_ids, Q, query_ex, query_ids, k, batch_queries, np_dtype,
                )
            else:
                dist, indices, item_ids, query_ids = self._kneighbors_fanned(
                    width, item_ex, query_ex, k, batch_queries, np_dtype,
                )
            knn_df = pd.DataFrame({"query_id": query_ids, "indices": list(indices), "distances": list(dist)})
            return self._with_ids(self._item_pdf, item_ids), self._with_ids(query_pdf, query_ids), knn_df
        if k > item_ex.n_rows:
            raise ValueError(f"k={k} exceeds the number of item rows {item_ex.n_rows}")
        if item_ex.is_sparse:
            # the CSR item set, tile by tile: never densified whole
            dist, gidx = exact_knn_sparse(item_ex.features, Q, k=k, batch_queries=batch_queries)
            gidx = np.maximum(gidx, 0)
        else:
            # the items are placed once per call, as the reference's
            # make_global_rows does; one device has no padding rows
            X, w = place_rows(item_ex.features.astype(np_dtype, copy=False), device=device)
            dist, gidx = exact_knn(X, w > 0, Q, k=k, batch_queries=batch_queries)
        knn_df = pd.DataFrame(
            {
                "query_id": query_ids,
                "indices": list(item_ids[gidx]),  # row position -> user item id
                "distances": list(np.asarray(dist, dtype=np.float64)),
            }
        )
        return self._with_ids(self._item_pdf, item_ids), self._with_ids(query_pdf, query_ids), knn_df

    def _kneighbors_spmd(self, ctx, item_ex, item_ids, Q, query_ex, query_ids, k, batch_queries, np_dtype):
        """The multi-process search: (distances [nq, k] float64, item ids
        [nq, k], this rank's item ids, its query ids), its queries' rows of
        the global top-k. Each rank searches its own items for every query:
        dense rows with `exact_knn`, CSR rows with `exact_knn_sparse` (both
        on the d2-block kernel); the candidates merge in `ops/knn.merge_topk`
        (`spmd_search`)."""
        from ..ops.knn import exact_knn, exact_knn_sparse
        from ..parallel import place_rows

        counts = rank_counts(ctx, item_ex.n_rows)
        if k > sum(counts):
            raise ValueError(f"k={k} exceeds the number of item rows {sum(counts)}")
        if item_ex.row_id is None:
            # row-number ids are rank-local: offset by the lower ranks' rows
            item_ids = item_ids + sum(counts[: ctx.rank])
        n_loc = int(item_ex.n_rows)

        def search(queries):
            if n_loc == 0:
                pad = np.full((queries.shape[0], k), np.inf)
                return pad, np.full((queries.shape[0], k), -1, np.int64), pad
            if item_ex.is_sparse:
                dist, lidx, key = exact_knn_sparse(item_ex.features, queries, k=k, batch_queries=batch_queries,
                                                   keys=True)
            else:
                X, w = place_rows(item_ex.features.astype(np_dtype, copy=False), device=queries.device)
                dist, lidx, key = exact_knn(X, w > 0, queries, k=k, batch_queries=batch_queries, keys=True)
                lidx[:, min(k, n_loc):] = -1  # exact_knn's pad columns
            return dist, np.where(lidx >= 0, item_ids[np.maximum(lidx, 0)], -1), key

        dist, indices, q_offset = spmd_search(ctx, Q, search, k)
        if query_ex.row_id is None:
            query_ids = query_ids + q_offset
        return dist, indices, item_ids, query_ids

    def _kneighbors_fanned(self, width, item_ex, query_ex, k, batch_queries, np_dtype):
        """The search over `width` chips of the pool: chip r runs
        `_kneighbors_spmd` on item block r and query block r; the results
        (this search's four arrays) come back in chip order."""
        from ..parallel import default_device, host_tensor, run_on_chips, shard_row_ranges

        i_ranges = shard_row_ranges(item_ex.n_rows, width)
        q_ranges = shard_row_ranges(query_ex.n_rows, width)

        def chip(r: int):
            from ..parallel import TpuContext

            items = item_ex.row_block(*i_ranges[r])
            queries = query_ex.row_block(*q_ranges[r])
            Q = host_tensor(np.asarray(as_dense(queries.features), dtype=np_dtype)).to(default_device())
            return self._kneighbors_spmd(
                TpuContext.current(), items, self._ensure_id(range(items.n_rows), items), Q, queries,
                self._ensure_id(range(queries.n_rows), queries), k, batch_queries, np_dtype,
            )

        parts, _ = run_on_chips(width, chip, name="srml-knn")
        return tuple(np.concatenate([p[i] for p in parts], axis=0) for i in range(4))

    def exactNearestNeighborsJoin(self, query_df: Any, distCol: str = "distCol") -> Any:
        """Exploded (item, query, distance) join: one row per (query,
        neighbor) pair, the item's columns prefixed `item_`, the query's
        `query_`, and the euclidean distance in `distCol`. One process only:
        under a multi-process context the neighbors' rows live on other
        ranks (join `kneighbors`' ids against the distributed item table)."""
        import pandas as pd

        from ..parallel import refuse_spmd

        refuse_spmd("exactNearestNeighborsJoin/approxSimilarityJoin (the item table on one rank)")
        item_out, query_out, knn_df = self.kneighbors(query_df)
        id_col = self._id_col()
        item_by_id = item_out.set_index(id_col)
        query_by_id = query_out.set_index(id_col)
        if len(knn_df):
            indices = np.stack(knn_df["indices"].to_numpy())
            dists = np.stack(knn_df["distances"].to_numpy())
        else:  # 0-row query frame: np.stack rejects an empty list
            indices = np.zeros((0, 1), dtype=np.int64)
            dists = np.zeros((0, 1), dtype=np.float64)
        k = indices.shape[1]
        flat_q = np.repeat(knn_df["query_id"].to_numpy(), k)
        flat_i = indices.ravel()
        flat_d = dists.ravel()
        # a real neighbor always has a finite distance
        finite = np.isfinite(flat_d)
        pairs = pd.DataFrame(
            {"_query_id": flat_q[finite], "_item_id": flat_i[finite], distCol: flat_d[finite]}
        )
        item_side = item_by_id.loc[pairs["_item_id"]].reset_index()
        item_side.columns = [f"item_{c}" for c in item_side.columns]
        query_side = query_by_id.loc[pairs["_query_id"]].reset_index()
        query_side.columns = [f"query_{c}" for c in query_side.columns]
        return pd.concat(
            [item_side.reset_index(drop=True), query_side.reset_index(drop=True), pairs[[distCol]]],
            axis=1,
        )

    def transform(self, dataset: Any):
        raise NotImplementedError("use kneighbors()/exactNearestNeighborsJoin() (reference parity)")

    # serving hooks -------------------------------------------------------

    _serve_dtypes = (None, "float32", "float64", "bf16")

    def _n_items(self) -> int:
        return int(self._item_extracted.n_rows) if self._item_extracted is not None else 0

    def _serve_n_cols(self) -> int:
        if self._item_extracted is None:
            raise ValueError(
                "NearestNeighborsModel is not bound to an item dataframe; "
                "fit it before loading into the serving plane"
            )
        return int(self._item_extracted.n_cols)

    def _serve_placement_terms(self) -> Dict[str, int]:
        # the resident state is the item block, its row norms and the int64
        # id map
        itemsize = 4 if self._float32_inputs else 8
        n = self._n_items()
        return {
            "items": n * self._serve_n_cols() * itemsize,
            "item_sq": n * itemsize,
            "item_ids": n * 8,
        }

    def _serve_workspace_terms(self, bucket_rows_count, itemsize) -> Dict[str, int]:
        # the running top-k's live blocks per dispatched bucket: one
        # [bucket, item block] distance block (the port's item block,
        # ops/distance._DEFAULT_K_TILE, on the CPU and the card alike) plus
        # the [bucket, k] best list x2 (distances and indices); no
        # [bucket, n_items] block exists
        from ..ops.distance import _DEFAULT_K_TILE

        n_items = max(1, self._n_items())
        k = int(self._solver_params["n_neighbors"])
        b = max(1, int(bucket_rows_count))
        return {
            "topk_block": b * min(_DEFAULT_K_TILE, n_items) * itemsize,
            "topk_carry": 2 * b * min(k, n_items) * itemsize,
        }

    def _serve_dtype_workspace_terms(self, bucket_rows_count, itemsize, serve_dtype) -> Dict[str, int]:
        # serve_dtype="bf16": the d2-block kernel's fast form stages both of
        # its operands to bf16 on every dispatch (ops/_kernels.stage_bf16):
        # the item block, rows rounded up to its item tile, and the query
        # bucket, rows rounded up to its query tile, depth rounded up to
        # STAGE_DEPTH (at 16,384 items x 3000: 98.6 MB; a 4096-row bucket:
        # 24.6 MB)
        if serve_dtype != "bf16":
            return {}
        from ..ops._kernels import D2_TILE, STAGE_DEPTH
        from ..ops.distance import _DEFAULT_K_TILE

        rows, cols = D2_TILE["f32-fast" if itemsize == 4 else "f64-fast"]
        depth = -(-self._serve_n_cols() // STAGE_DEPTH) * STAGE_DEPTH
        kt = min(_DEFAULT_K_TILE, max(1, self._n_items()))
        b = max(1, int(bucket_rows_count))
        return {
            "fast_staging_items": -(-kt // cols) * cols * depth * 2,
            "fast_staging_q": -(-b // rows) * rows * depth * 2,
        }

    def _serve_flop_estimate(self, n_rows, n_cols):
        # the full [queries, items] squared-distance sweep (~3*n*m*d); the
        # top-k selection left out
        return 3.0 * n_rows * max(1, self._n_items()) * n_cols

    def _serve_program(self, serve_dtype=None, *, cap=None):
        """kNN serving hook: per query row (euclidean distances [B, k], user
        item ids [B, k]), the values `kneighbors`' knn_df carries. The item
        block, its norms and its id map are placed once, at `construct`;
        `serve_dtype="bf16"` scores through the fast (bf16, float32
        accumulation) d2-block kernel, against the norms of the unrounded
        items. The query norms are summed in a fixed order
        (`row_sq_fixed`), so a query's distances do not depend on the batch
        it is served in."""
        import torch

        from ..core import PredictProgram
        from ..ops import distance as dist
        from ..parallel import default_device, host_tensor

        self._serve_check(serve_dtype)  # dtype surface + bound item set
        fast = serve_dtype == "bf16"
        dtype = np.float32 if self._float32_inputs else np.float64
        items_np = np.ascontiguousarray(np.asarray(as_dense(self._item_extracted.features), dtype=dtype))
        ids_np = np.asarray(self._ensure_id(self._item_pdf, self._item_extracted), dtype=np.int64)
        k = min(int(self._solver_params["n_neighbors"]), items_np.shape[0])

        def construct():
            dev = default_device()
            it = host_tensor(items_np).to(dev)
            return it, dist.row_sq(it), host_tensor(ids_np).to(dev)

        def predict(state, q):
            it, it_sq, ids = state
            d2, idx = dist.topk_tile(q, it, None, k, item_sq=it_sq, fast=fast)
            d = torch.sqrt(torch.clamp_min(d2 + dist.row_sq_fixed(q)[:, None], 0.0))
            return d, ids[idx.long()]

        return PredictProgram(self, construct=construct, predict=predict, cap=cap)

    def write(self):
        raise NotImplementedError("NearestNeighborsModel does not support saving (reference parity)")


def rank_counts(ctx, n: int) -> List[int]:
    """Every rank's count `n`, in rank order."""
    return [int(c) for c in np.concatenate(ctx.group.allgather_arrays(np.array([n], dtype=np.int64)))]


def spmd_search(ctx, Q: torch.Tensor, search, k: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """A multi-process top-k search: the query blocks gathered in rank
    order, `search(queries) -> (distances [nq, k], global item ids [nq, k],
    -1 on a pad slot[, the keys the search ordered on])` over this rank's
    items, the ranks' candidates gathered and merged (`ops/knn.merge_topk`,
    the order of one search over the global rows). Returns this rank's
    queries' rows (distances float64, ids int64) and the offset of its
    first query."""
    from ..ops.knn import merge_topk

    group = ctx.group
    q_blocks = group.allgather_rows(Q)
    q_offset = sum(int(b.shape[0]) for b in q_blocks[: ctx.rank])
    found = search(torch.cat(q_blocks))
    dtypes = (np.float64, np.int64, np.float64)
    d_all, i_all, *key = (np.concatenate(group.allgather_arrays(np.asarray(a, dtype=t)), axis=1)
                          for a, t in zip(found, dtypes))
    dist, ids = merge_topk(d_all, i_all, k, *key)
    rows = slice(q_offset, q_offset + int(Q.shape[0]))
    return dist[rows], ids[rows], q_offset


# ------------------------------------------------------------------- ANN ----


class _ANNParams(_KNNParams):
    algorithm = Param("algorithm", "ANN algorithm: 'ivfflat', 'ivfpq' or 'cagra'", TypeConverters.toString)
    algoParams = Param("algoParams", "algorithm-specific parameters dict", TypeConverters.identity)
    metric = Param("metric", "distance metric: euclidean | sqeuclidean | cosine", TypeConverters.toString)

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"k": "n_neighbors", "metric": "metric"}

    def _get_solver_params_default(self) -> Dict[str, Any]:
        return {
            "metric": "euclidean",
            "n_neighbors": 5,
            "batch_queries": 1024,
            "n_lists": 64,
            "n_probes": 8,
            "pq_m": 8,  # cuML algoParams key "M": subquantizer count
            "pq_n_bits": 8,  # cuML algoParams key "n_bits": bits per PQ code
            # ivfpq takes k * refine_ratio ADC candidates and re-ranks them by
            # exact distance (the cuVS refine)
            "refine_ratio": 4,
            # cagra index params (cuVS IndexParams)
            "build_algo": "ivf_pq",
            "graph_degree": 64,
            "intermediate_graph_degree": 128,
            # cagra build knobs (ops/cagra.py build_cagra): seeding reps, max
            # descent rounds, update-rate termination, bf16 candidate scoring
            "cluster_reps": 8,
            "nn_descent_niter": 0,
            "termination_threshold": 0.003,
            "fast_score": True,
            # cagra search params (cuVS SearchParams)
            "itopk_size": 64,
            "search_width": 1,
            "max_iterations": 0,
            "min_iterations": 0,
            "num_random_samplings": 1,
            "verbose": False,
        }


class ApproximateNearestNeighbors(_ANNParams, _TpuEstimator):
    """Approximate kNN by IVFFlat, IVFPQ or CAGRA.

    >>> ann = ApproximateNearestNeighbors(k=64, algoParams={"nlist": 256, "nprobe": 16})
    >>> model = ann.setInputCol("features").fit(item_df)
    >>> item_out, query_out, knn_df = model.kneighbors(query_df)

    `algoParams` takes the cuML/cuVS keys {"nlist", "nprobe", "M",
    "n_bits", "refine_ratio"}, the cagra keys {"build_algo",
    "graph_degree", "intermediate_graph_degree", "itopk_size",
    "search_width", "max_iterations", "min_iterations",
    "num_random_samplings"} and the build knobs {"cluster_reps",
    "nn_descent_niter", "termination_threshold", "fast_score"}; each call
    replaces the keys of the one before. Fit places the rows on the card
    once (unit rows for metric="cosine") and builds the index there with
    seed 0 (ops/knn.py, ops/cagra.py)."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(k=5, algorithm="ivfflat")
        self._set_params(**kwargs)

    def _set_params(self, **kwargs):
        if "algorithm" in kwargs and kwargs["algorithm"] not in ("ivfflat", "ivfpq", "cagra"):
            raise ValueError(f"algorithm {kwargs['algorithm']!r} not supported (ivfflat | ivfpq | cagra)")
        if "metric" in kwargs and kwargs["metric"] not in ("euclidean", "sqeuclidean", "cosine"):
            raise ValueError(f"metric {kwargs['metric']!r} not supported (euclidean | sqeuclidean | cosine)")
        if "algoParams" in kwargs:
            ap = kwargs.pop("algoParams") or {}
            if "compression" in ap:
                raise ValueError("cagra 'compression' is not supported by the PyTorch port, as by the JAX package")
            mapped = {"nlist": "n_lists", "nprobe": "n_probes", "M": "pq_m", "n_bits": "pq_n_bits",
                      "refine_ratio": "refine_ratio"}
            # REPLACE semantics: keys an earlier algoParams set go back to
            # their defaults first
            defaults = self._get_solver_params_default()
            for prev in getattr(self, "_algo_params_keys", ()):
                if prev in defaults:
                    self._solver_params[prev] = defaults[prev]
                else:
                    self._solver_params.pop(prev, None)
            applied = set()
            for key, v in ap.items():
                solver_key = mapped.get(key, key)
                self._solver_params[solver_key] = v
                applied.add(solver_key)
            self._algo_params_keys = applied
        return super()._set_params(**kwargs)

    def setK(self, value: int) -> "ApproximateNearestNeighbors":
        return self._set_params(k=value)

    def setInputCol(self, value) -> "ApproximateNearestNeighbors":
        return self._set_params(inputCol=value) if isinstance(value, str) else self._set_params(inputCols=value)

    def setIdCol(self, value: str) -> "ApproximateNearestNeighbors":
        return self._set_params(idCol=value)

    def setAlgorithm(self, value: str) -> "ApproximateNearestNeighbors":
        return self._set_params(algorithm=value)

    def getAlgorithm(self) -> str:
        return self.getOrDefault("algorithm")

    def setAlgoParams(self, value: Dict[str, Any]) -> "ApproximateNearestNeighbors":
        return self._set_params(algoParams=value)

    def setMetric(self, value: str) -> "ApproximateNearestNeighbors":
        return self._set_params(metric=value)

    def getMetric(self) -> str:
        return str(self._solver_params["metric"])

    def _fit_internal(self, dataset: Any, paramMaps=None, row_mask=None) -> List["ApproximateNearestNeighborsModel"]:
        from ..parallel import fan_out_width, refuse_devices_per_rank, run_on_chips, shard_row_ranges

        # in a multi-process fit each rank builds its index over its own
        # items; the search merges the ranks' candidates (kneighbors). Over
        # several chips of one process, each chip builds its block's
        # index in its own thread, as a rank would
        refuse_devices_per_rank(self.num_workers, "ApproximateNearestNeighbors")
        sp = self._solver_params
        pdf = as_pandas(dataset)
        extracted = self._pre_process_data(dataset, for_fit=True)
        algo = self.getOrDefault("algorithm")
        if algo == "cagra":
            # cuVS checks itopk_size >= k at first use; fail at fit, as the
            # JAX package does
            internal = -(-int(sp.get("itopk_size", 64)) // 32) * 32
            if internal < int(sp["n_neighbors"]):
                raise ValueError(
                    f"cagra rounds itopk_size up to a multiple of 32 ({internal}) and requires it"
                    f" >= k ({int(sp['n_neighbors'])})"
                )
        width = fan_out_width(self.num_workers)
        chips = None
        if width > 1:
            ranges = shard_row_ranges(extracted.n_rows, width)
            built, _ = run_on_chips(width, lambda r: self._build_index(extracted.row_block(*ranges[r])), name="srml-ann")
            chips = [(index, refine_x, lo, hi) for (index, refine_x), (lo, hi) in zip(built, ranges)]
            index, refine_x = built[0]
        else:
            index, refine_x = self._build_index(extracted)
        model = ApproximateNearestNeighborsModel(
            n_cols=extracted.n_cols, dtype="float32" if self._float32_inputs else "float64"
        )
        self._copyValues(model)
        self._copy_solver_params(model)
        model._item_pdf = pdf
        model._item_extracted = extracted
        model._index = index
        model._algorithm = algo
        model._refine_x = refine_x
        model._chip_indexes = chips
        return [model]

    def _build_index(self, extracted: ExtractedData):
        """(the index over `extracted`'s rows on `default_device()`, the
        rows IVFPQ's refine scores or None)."""
        from ..ops.cagra import build_cagra
        from ..ops.knn import build_ivfflat, build_ivfpq
        from ..parallel import default_device, host_tensor
        from ..utils import unit_rows

        sp = self._solver_params
        feats = as_dense(extracted.features)
        if str(sp["metric"]) == "cosine":
            # cosine rides the euclidean index on unit vectors (the same
            # ranking); queries are normalized the same way in kneighbors
            feats = unit_rows(feats)
        algo = self.getOrDefault("algorithm")
        device = default_device()
        xd = host_tensor(np.asarray(feats, dtype=np.float32)).to(device)  # the rows, placed once
        refine_x = None
        if algo == "ivfpq":
            index = build_ivfpq(xd, int(sp["n_lists"]), M=int(sp["pq_m"]), n_bits=int(sp["pq_n_bits"]), seed=0)
            # the refine scores the rows the JAX package scores: the build's
            # float32 rows, or the float64 items themselves
            refine_x = xd if feats.dtype == np.float32 else host_tensor(feats).to(device)
        elif algo == "cagra":
            index = build_cagra(
                xd,
                graph_degree=int(sp["graph_degree"]),
                intermediate_graph_degree=int(sp["intermediate_graph_degree"]),
                build_algo=str(sp["build_algo"]),
                nn_descent_niter=int(sp["nn_descent_niter"]),
                cluster_reps=int(sp["cluster_reps"]),
                termination_threshold=float(sp["termination_threshold"]),
                fast_score=bool(sp["fast_score"]),
                seed=0,
            )
        else:
            index = build_ivfflat(xd, int(sp["n_lists"]), seed=0)
        return index, refine_x

    # _TpuCaller's solver hooks: never reached, _fit_internal builds the index
    def _get_tpu_fit_func(self, extracted: ExtractedData):
        raise NotImplementedError("ApproximateNearestNeighbors builds its index in _fit_internal")

    def _create_model(self, attrs: Dict[str, Any]) -> "ApproximateNearestNeighborsModel":
        raise NotImplementedError("ApproximateNearestNeighbors builds its index in _fit_internal")

    def write(self):
        raise NotImplementedError("ApproximateNearestNeighbors does not support saving")


class ApproximateNearestNeighborsModel(NearestNeighborsModel):
    """The ANN index bound to its item set. `kneighbors` searches the index
    on the card; distances are euclidean, squared for
    metric="sqeuclidean", and 1 - cos (d²/2 on unit rows) for "cosine";
    a query short of k candidates gets id -1 at +inf."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._index: Optional[Dict[str, Any]] = None
        self._algorithm = "ivfflat"
        self._refine_x = None  # ivfpq: the rows the refine scores, on the device
        # a fit over several chips of the pool: per chip (index, refine
        # rows, first item row, end row), each on its chip
        self._chip_indexes: Optional[List[Tuple[Any, Any, int, int]]] = None

    def _get_solver_params_default(self) -> Dict[str, Any]:
        return _ANNParams._get_solver_params_default(self)

    def getAlgorithm(self) -> str:
        return self._algorithm

    def getMetric(self) -> str:
        return str(self._solver_params["metric"])

    def kneighbors(self, query_df: Any) -> Tuple[Any, Any, Any]:
        """Returns (item_df, query_df, knn_df) as `NearestNeighborsModel`
        does, searched through the index: IVFFlat's probed lists; IVFPQ's
        k·refine_ratio ADC candidates re-ranked exactly in float64
        (`ops/knn.refine_exact`); CAGRA's greedy graph search. Under a
        multi-process context each rank searches its own index (built at
        fit over its items) for every rank's queries, and the candidates
        merge as `NearestNeighborsModel`'s do (`spmd_search`)."""
        import pandas as pd

        from ..ops.cagra import cagra_search
        from ..ops.knn import ivfflat_search, ivfpq_search, refine_exact
        from ..parallel import default_device, host_tensor
        from ..utils import unit_rows

        if self._index is None or self._item_pdf is None:
            raise ValueError("ApproximateNearestNeighborsModel has no index; fit it first")
        from ..parallel import spmd_context

        sp = self._solver_params
        k = int(sp["n_neighbors"])
        item_ex = self._item_extracted
        item_ids = self._ensure_id(self._item_pdf, item_ex)
        query_pdf = as_pandas(query_df)
        if len(query_pdf) == 0:
            knn_df = pd.DataFrame({"query_id": np.zeros(0, dtype=np.int64), "indices": [], "distances": []})
            return (self._with_ids(self._item_pdf, item_ids),
                    self._with_ids(query_pdf, np.zeros(0, dtype=np.int64)), knn_df)
        query_ex = self._pre_process_data(query_df, for_fit=False)
        query_ids = self._ensure_id(query_pdf, query_ex)
        metric = str(sp["metric"])
        queries = as_dense(query_ex.features)
        if metric == "cosine":
            queries = unit_rows(queries)
        device = default_device()
        batch = int(sp["batch_queries"])

        def search(q, q_ref=None, index=self._index, refine_x=self._refine_x, n_items=item_ex.n_rows,
                   item_ids=item_ids):
            """(distances [nq, k] float64 in the metric, item ids [nq, k],
            -1 at +inf where a query is short) from `index` over `n_items`
            items; IVFPQ's refine scores `q_ref` (None: the queries at
            their own dtype)."""
            if self._algorithm == "ivfpq":
                k_adc = min(k * max(1, int(sp.get("refine_ratio", 4))), n_items)
                dist, idx = ivfpq_search(q, index, k=k_adc, n_probes=int(sp["n_probes"]), batch_queries=batch)
                if k_adc > k:
                    if q_ref is None:
                        q_ref = q if queries.dtype == np.float32 else host_tensor(queries).to(q.device)
                    dist, idx = refine_exact(refine_x, q_ref, torch.from_numpy(idx).to(q.device), k)
            elif self._algorithm == "cagra":
                idx, d2 = cagra_search(
                    q, index, k=min(k, n_items), itopk_size=int(sp["itopk_size"]),
                    search_width=int(sp["search_width"]), max_iterations=int(sp["max_iterations"]),
                    min_iterations=int(sp["min_iterations"]), num_random_samplings=int(sp["num_random_samplings"]),
                    batch_queries=batch,
                )
                # euclidean, as every path of the package reports (cuVS gives d²)
                dist = np.sqrt(np.maximum(d2, 0.0))
                if k > n_items:  # pad as the IVF paths do
                    padw = k - n_items
                    idx = np.concatenate([idx, np.full((len(idx), padw), -1, idx.dtype)], axis=1)
                    dist = np.concatenate([dist, np.full((len(dist), padw), np.inf, dist.dtype)], axis=1)
            else:
                dist, idx = ivfflat_search(q, index, k=k, n_probes=int(sp["n_probes"]), batch_queries=batch)
            dist = np.asarray(dist, dtype=np.float64)
            # the metric's conversion is monotone, so it may precede a merge
            if metric == "sqeuclidean":
                dist = dist * dist
            elif metric == "cosine":
                dist = (dist * dist) / 2.0  # unit rows: 1 - cos; +inf pads stay +inf
            return dist, np.where(idx >= 0, item_ids[np.maximum(idx, 0)], -1)

        ctx = spmd_context()
        if ctx is not None:
            # each rank searches its own index for every rank's queries; the
            # queries travel at float32, and IVFPQ's float64 refine scores
            # them so, as the JAX package's SPMD branch does
            if item_ex.row_id is None:
                item_ids = item_ids + sum(rank_counts(ctx, item_ex.n_rows)[: ctx.rank])
            q = host_tensor(np.asarray(queries, dtype=np.float32)).to(device)
            dist, indices, q_offset = spmd_search(
                ctx, q, lambda qa: search(qa, qa, item_ids=item_ids), k,
            )
            if query_ex.row_id is None:
                query_ids = query_ids + q_offset
        elif self._chip_indexes is not None:
            # chip r searches its own index (its items [lo, hi)) for every
            # chip's queries, as a rank does; the queries come back in order
            from ..parallel import run_on_chips, shard_row_ranges

            chips = self._chip_indexes
            q_ranges = shard_row_ranges(len(queries), len(chips))

            def chip(r: int):
                index, refine_x, lo, hi = chips[r]
                qr = host_tensor(np.asarray(queries[q_ranges[r][0]:q_ranges[r][1]], dtype=np.float32)).to(
                    default_device())
                return spmd_search(
                    TpuContext.current(), qr,
                    lambda qa: search(qa, qa, index=index, refine_x=refine_x, n_items=hi - lo,
                                      item_ids=item_ids[lo:hi]), k,
                )[:2]

            from ..parallel import TpuContext

            parts, _ = run_on_chips(len(chips), chip, name="srml-ann")
            dist = np.concatenate([p[0] for p in parts], axis=0)
            indices = np.concatenate([p[1] for p in parts], axis=0)
        else:
            q = host_tensor(np.asarray(queries, dtype=np.float32)).to(device)
            dist, indices = search(q)
        knn_df = pd.DataFrame({"query_id": query_ids, "indices": list(indices), "distances": list(dist)})
        return self._with_ids(self._item_pdf, item_ids), self._with_ids(query_pdf, query_ids), knn_df

    def approxSimilarityJoin(self, query_df: Any, distCol: str = "distCol") -> Any:
        """The exploded join of `exactNearestNeighborsJoin` over the ANN
        result; padded ids (-1, at +inf) are dropped."""
        return self.exactNearestNeighborsJoin(query_df, distCol)
