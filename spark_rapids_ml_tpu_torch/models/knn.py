#
# Exact nearest-neighbor estimator and model, drop-in for the JAX package's
# spark_rapids_ml_tpu/models/knn.py (NearestNeighbors,
# NearestNeighborsModel), on one device: fit binds the item set,
# `kneighbors(query_df)` returns (item_df, query_df, knn_df) with knn_df =
# (query_id, indices, distances), and `exactNearestNeighborsJoin` explodes
# the pairs. Neither supports persistence, as in the reference.
#
# The serving hooks keep the item block, its norms and its id map resident
# on the card and answer each query batch through the running top-k
# (`topk_tile`), at the items' dtype or, with serve_dtype="bf16", through the
# d2-block kernel's bf16 tensor-core form.
#
# Left out, each a later ROADMAP item: the multi-device and multi-process
# search (A10; num_workers > 1 is refused) and sparse item sets (A11; ingest
# raises).
#
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core import _TpuEstimator, _TpuModel, alias
from ..data import ExtractedData, as_pandas
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
    d2-block kernel and keeps a running top-k (ops/knn.py)."""

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

    def _fit_internal(self, dataset: Any) -> "NearestNeighborsModel":
        # kNN fits no parameters: the model is the item set, bound here; the
        # search runs in kneighbors
        if self.num_workers > 1:
            raise NotImplementedError(
                f"num_workers={self.num_workers}: the PyTorch port searches on one "
                "device (multi-GPU is ROADMAP item A10)"
            )
        pdf = as_pandas(dataset)
        extracted = self._pre_process_data(dataset, for_fit=True)
        model = NearestNeighborsModel(
            n_cols=extracted.n_cols, dtype="float32" if self._float32_inputs else "float64"
        )
        self._copyValues(model)
        self._copy_solver_params(model)
        model._item_pdf = pdf
        model._item_extracted = extracted
        return model

    # _TpuCaller's solver hooks: never reached, _fit_internal binds the items
    def _get_tpu_fit_func(self, extracted: ExtractedData):
        raise NotImplementedError("NearestNeighbors fits no parameters")

    def _create_model(self, attrs: Dict[str, Any]) -> "NearestNeighborsModel":
        raise NotImplementedError("NearestNeighbors fits no parameters")

    def write(self):
        raise NotImplementedError("NearestNeighbors does not support saving (reference parity)")


class NearestNeighborsModel(_KNNParams, _TpuModel):
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

        from ..ops.knn import exact_knn
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
        if k > item_ex.n_rows:
            raise ValueError(f"k={k} exceeds the number of item rows {item_ex.n_rows}")

        device = default_device()
        np_dtype = np.float32 if self._float32_inputs else np.float64
        # the items are placed once per call, as the reference's
        # make_global_rows does; one device has no padding rows
        X, w = place_rows(item_ex.features.astype(np_dtype, copy=False), device=device)
        Q = host_tensor(query_ex.features.astype(np_dtype, copy=False)).to(device)
        dist, gidx = exact_knn(
            X, w > 0, Q, k=k,
            # 0 -> None: resolves config["distance_tile_rows"]
            batch_queries=int(self._solver_params["batch_queries"]) or None,
        )
        knn_df = pd.DataFrame(
            {
                "query_id": query_ids,
                "indices": list(item_ids[gidx]),  # row position -> user item id
                "distances": list(np.asarray(dist, dtype=np.float64)),
            }
        )
        return self._with_ids(self._item_pdf, item_ids), self._with_ids(query_pdf, query_ids), knn_df

    def exactNearestNeighborsJoin(self, query_df: Any, distCol: str = "distCol") -> Any:
        """Exploded (item, query, distance) join: one row per (query,
        neighbor) pair, the item's columns prefixed `item_`, the query's
        `query_`, and the euclidean distance in `distCol`."""
        import pandas as pd

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
        items_np = np.ascontiguousarray(np.asarray(self._item_extracted.features, dtype=dtype))
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
