#
# Exact nearest-neighbor estimator and model, drop-in for the JAX package's
# spark_rapids_ml_tpu/models/knn.py (NearestNeighbors,
# NearestNeighborsModel), on one device: fit binds the item set,
# `kneighbors(query_df)` returns (item_df, query_df, knn_df) with knn_df =
# (query_id, indices, distances), and `exactNearestNeighborsJoin` explodes
# the pairs. Neither supports persistence, as in the reference.
#
# Left out, each a later ROADMAP item: the multi-device and multi-process
# search (A10; num_workers > 1 is refused), sparse item sets (A11; ingest
# raises), and the serving hooks (A13).
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

    def write(self):
        raise NotImplementedError("NearestNeighborsModel does not support saving (reference parity)")
