#
# UMAP estimator and model: the PyTorch counterpart of
# spark_rapids_ml_tpu/models/umap.py, on one device. The fit runs on the
# card (ops/umap.py: the kNN graph through the d2-block kernel, the fuzzy
# set, the spectral init, the SGD layout); the model keeps the training
# rows and their embedding, and transform embeds new rows against them.
# The model saves its arrays as .npy files beside the metadata, the JAX
# package's layout, so a directory either package saved loads in the other.
#
# Under a multi-process TpuContext (the JAX package's SPMD fit) every rank
# draws its sampleFraction from default_rng(seed + rank), the sampled
# blocks (and labels) are gathered in rank order over the process group,
# and every rank runs the same seeded fit on that union, so the ranks'
# models are equal bit for bit; transform embeds each rank's own rows.
# One process over several chips of its pool fits once, on its first chip,
# over every row (the JAX package's single-controller fit); its transform
# runs on the first chip too. Sparse input is densified, as in the JAX
# package.
#
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..core import _TpuEstimator, _TpuModel, _TpuReader, _TpuWriter, _np_default
from ..data import ExtractedData, as_dense
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasOutputCol,
    Param,
    TypeConverters,
)


class _UMAPParams(HasFeaturesCol, HasFeaturesCols, HasLabelCol, HasOutputCol):
    """UMAP's Param surface: cuML's UMAP knobs as Params of their own,
    identity-mapped to the solver params."""

    n_neighbors = Param("n_neighbors", "size of the local neighborhood", TypeConverters.toFloat)
    n_components = Param("n_components", "embedding dimension", TypeConverters.toInt)
    metric = Param("metric", "distance metric: 'euclidean' or 'cosine'", TypeConverters.toString)
    n_epochs = Param("n_epochs", "number of optimization epochs", TypeConverters.identity)
    learning_rate = Param("learning_rate", "initial embedding learning rate", TypeConverters.toFloat)
    init = Param("init", "embedding initialization: 'spectral' or 'random'", TypeConverters.toString)
    min_dist = Param("min_dist", "minimum embedded distance between points", TypeConverters.toFloat)
    spread = Param("spread", "effective scale of embedded points", TypeConverters.toFloat)
    set_op_mix_ratio = Param("set_op_mix_ratio", "fuzzy union vs intersection mix", TypeConverters.toFloat)
    local_connectivity = Param("local_connectivity", "assumed local connectivity", TypeConverters.toFloat)
    repulsion_strength = Param("repulsion_strength", "negative-sample repulsion weight", TypeConverters.toFloat)
    negative_sample_rate = Param("negative_sample_rate", "negative samples per edge", TypeConverters.toInt)
    transform_queue_size = Param("transform_queue_size", "accepted, ignored (no analog)", TypeConverters.toFloat)
    a = Param("a", "embedding curve parameter a (derived from min_dist/spread if unset)", TypeConverters.identity)
    b = Param("b", "embedding curve parameter b (derived from min_dist/spread if unset)", TypeConverters.identity)
    precomputed_knn = Param("precomputed_knn", "precomputed (knn_indices, knn_dists) pair", TypeConverters.identity)
    random_state = Param("random_state", "random seed", TypeConverters.identity)
    sample_fraction = Param("sample_fraction", "fraction of rows used for fit", TypeConverters.toFloat)

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {name: name for name in (
            "n_neighbors", "n_components", "metric", "n_epochs", "learning_rate",
            "init", "min_dist", "spread", "set_op_mix_ratio", "local_connectivity",
            "repulsion_strength", "negative_sample_rate", "transform_queue_size",
            "a", "b", "precomputed_knn", "random_state",
        )}

    def _get_solver_params_default(self) -> Dict[str, Any]:
        return {
            "n_neighbors": 15.0,
            "n_components": 2,
            "metric": "euclidean",
            "n_epochs": None,
            "learning_rate": 1.0,
            "init": "spectral",
            "min_dist": 0.1,
            "spread": 1.0,
            "set_op_mix_ratio": 1.0,
            "local_connectivity": 1.0,
            "repulsion_strength": 1.0,
            "negative_sample_rate": 5,
            "transform_queue_size": 4.0,
            "a": None,
            "b": None,
            "precomputed_knn": None,
            "random_state": None,
            "verbose": False,
        }

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(
            n_neighbors=15.0, n_components=2, metric="euclidean", n_epochs=None,
            learning_rate=1.0, init="spectral", min_dist=0.1, spread=1.0,
            set_op_mix_ratio=1.0, local_connectivity=1.0, repulsion_strength=1.0,
            negative_sample_rate=5, transform_queue_size=4.0, a=None, b=None,
            precomputed_knn=None, random_state=None, sample_fraction=1.0,
            outputCol="embedding",
        )

    def getNNeighbors(self) -> float:
        return self.getOrDefault("n_neighbors")

    def setNNeighbors(self, value: float):
        return self._set_params(n_neighbors=value)

    def getNComponents(self) -> int:
        return self.getOrDefault("n_components")

    def setNComponents(self, value: int):
        return self._set_params(n_components=value)

    def getNEpochs(self):
        return self.getOrDefault("n_epochs")

    def setNEpochs(self, value):
        return self._set_params(n_epochs=value)

    def getMinDist(self) -> float:
        return self.getOrDefault("min_dist")

    def setMinDist(self, value: float):
        return self._set_params(min_dist=value)

    def getInit(self) -> str:
        return self.getOrDefault("init")

    def setInit(self, value: str):
        return self._set_params(init=value)

    def getRandomState(self):
        return self.getOrDefault("random_state")

    def setRandomState(self, value):
        return self._set_params(random_state=value)

    def getSampleFraction(self) -> float:
        return self.getOrDefault("sample_fraction")

    def setSampleFraction(self, value: float):
        return self._set_params(sample_fraction=value)

    def setFeaturesCol(self, value):
        return self._set_params(featuresCol=value) if isinstance(value, str) else self._set_params(featuresCols=value)

    def setLabelCol(self, value: str):
        return self._set_params(labelCol=value)

    def setOutputCol(self, value: str):
        return self._set_params(outputCol=value)

    def getOutputCol(self) -> str:
        return self.getOrDefault("outputCol")


class UMAP(_UMAPParams, _TpuEstimator):
    """UMAP estimator.

    >>> model = UMAP(n_components=2).setFeaturesCol("features").fit(df)
    >>> out = model.transform(df)   # (features, embedding) columns

    The fit runs on one device (ops/umap.py). Setting `labelCol` explicitly
    makes the fit supervised (the fuzzy set intersected with the labels);
    `sample_fraction` < 1 fits on a seeded subsample of the rows."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_params(**kwargs)

    def _set_params(self, **kwargs):
        if kwargs.get("metric") not in (None, "euclidean", "cosine"):
            raise ValueError(f"metric must be 'euclidean' or 'cosine', got {kwargs['metric']!r}")
        pre = kwargs.get("precomputed_knn")
        if pre is not None and not (isinstance(pre, (tuple, list)) and len(pre) == 2):
            raise ValueError(
                "precomputed_knn must be a (knn_indices, knn_dists) pair of [n, k] arrays "
                "(cuML/umap-learn convention)"
            )
        if "init" in kwargs and kwargs["init"] not in ("spectral", "random"):
            raise ValueError(f"init must be 'spectral' or 'random', got {kwargs['init']!r}")
        return super()._set_params(**kwargs)

    def _get_tpu_fit_func(self, extracted: ExtractedData):  # pragma: no cover
        raise NotImplementedError  # _fit_internal overridden

    def _fit_internal(self, dataset: Any, paramMaps, row_mask=None):
        from ..ops.umap import umap_fit
        from ..parallel import default_device, fan_out_width, refuse_devices_per_rank, spmd_context

        if paramMaps:
            raise NotImplementedError("UMAP does not support fitMultiple param maps")
        refuse_devices_per_rank(self.num_workers, "UMAP fit")
        ctx = spmd_context()
        extracted = self._pre_process_data(dataset, for_fit=True)
        # one process over several chips fits once, on its first chip, over
        # every row, as the JAX package's single-controller fit does (its
        # sampleFraction draw and precomputed_knn included); the width is
        # still checked against the pool
        fan_out_width(self.num_workers)
        feats = np.asarray(as_dense(extracted.features), dtype=np.float32)
        labels = extracted.label

        frac = float(self.getSampleFraction())
        if frac < 1.0:
            seed = self.getRandomState()
            # a rank's own stream; the union is gathered below
            rng = np.random.default_rng((int(seed) if seed is not None else 0) + (ctx.rank if ctx else 0))
            keep = rng.random(feats.shape[0]) < frac
            feats = feats[keep]
            labels = labels[keep] if labels is not None else None
        if ctx is not None:
            # every rank fits the same seeded program on the same union
            feats = np.concatenate(ctx.group.allgather_arrays(feats), axis=0)
            if labels is not None:
                labels = np.concatenate(ctx.group.allgather_arrays(np.asarray(labels)), axis=0)

        sp = self._solver_params
        pre_knn = sp.get("precomputed_knn")
        if pre_knn is not None and (frac < 1.0 or ctx is not None):
            # the pair indexes the caller's rows; a subsample or the
            # multi-process gather reorders them
            raise ValueError(
                "precomputed_knn cannot be combined with sample_fraction < 1 or a multi-process SPMD fit"
            )
        state = umap_fit(
            feats,
            labels,
            device=default_device(),
            n_neighbors=int(float(sp["n_neighbors"])),
            n_components=int(sp["n_components"]),
            n_epochs=sp["n_epochs"],
            learning_rate=float(sp["learning_rate"]),
            init=sp["init"],
            min_dist=float(sp["min_dist"]),
            spread=float(sp["spread"]),
            set_op_mix_ratio=float(sp["set_op_mix_ratio"]),
            local_connectivity=float(sp["local_connectivity"]),
            repulsion_strength=float(sp["repulsion_strength"]),
            negative_sample_rate=int(sp["negative_sample_rate"]),
            a=sp["a"],
            b=sp["b"],
            random_state=sp["random_state"],
            precomputed_knn=pre_knn,
            metric=str(sp["metric"]),
        )
        model = UMAPModel(
            embedding_=state["embedding_"],
            raw_data_=feats,
            a_=float(state["a_"]),
            b_=float(state["b_"]),
            n_cols=extracted.n_cols,
            dtype="float32",
        )
        self._copyValues(model)
        self._copy_solver_params(model)
        return [model]

    def _create_model(self, attrs):  # pragma: no cover - _fit_internal overridden
        return UMAPModel(**attrs)

    def _pre_process_data(self, dataset: Any, for_fit: bool = True) -> ExtractedData:
        # the label is optional: supervised only when labelCol is set
        # explicitly (its default 'label' must not make the fit supervised)
        self._supervised = for_fit and self.hasParam("labelCol") and self.isSet("labelCol")
        try:
            return super()._pre_process_data(dataset, for_fit=for_fit)
        finally:
            self._supervised = False


class UMAPModel(_UMAPParams, _TpuModel):
    """Fitted UMAP model: the training rows (`raw_data_`) and their
    embedding (`embedding_`), with the curve's `a_` and `b_`."""

    def __init__(
        self,
        embedding_: Optional[np.ndarray] = None,
        raw_data_: Optional[np.ndarray] = None,
        a_: float = 1.577,
        b_: float = 0.895,
        n_cols: int = 0,
        dtype: str = "float32",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            embedding_=embedding_, raw_data_=raw_data_, a_=a_, b_=b_,
            n_cols=n_cols, dtype=dtype,
        )
        self.embedding_ = np.asarray(embedding_, dtype=np.float32)
        self.raw_data_ = np.asarray(raw_data_, dtype=np.float32)
        self.a_ = float(a_)
        self.b_ = float(b_)
        self.n_cols = int(n_cols)
        self.dtype = dtype

    @property
    def embedding(self) -> List[List[float]]:
        return self.embedding_.tolist()

    @property
    def raw_data(self) -> List[List[float]]:
        return self.raw_data_.tolist()

    def transform(self, dataset: Any):
        """Embed new rows against the trained embedding: a frame of the
        `features` and the output column."""
        import pandas as pd

        from ..ops.umap import umap_transform
        from ..parallel import default_device, refuse_devices_per_rank

        # a multi-process transform embeds each rank's own rows; one process
        # embeds its rows on its first chip (the negative draws are
        # positional, so a split would change a row's embedding)
        refuse_devices_per_rank(self.num_workers, "UMAP transform")
        feats = np.asarray(as_dense(self._pre_process_data(dataset, for_fit=False).features), dtype=np.float32)
        sp = self._solver_params
        emb = umap_transform(
            feats,
            self.raw_data_,
            self.embedding_,
            device=default_device(),
            n_neighbors=int(float(sp["n_neighbors"])),
            n_epochs=sp["n_epochs"],
            learning_rate=float(sp["learning_rate"]),
            local_connectivity=float(sp["local_connectivity"]),
            repulsion_strength=float(sp["repulsion_strength"]),
            negative_sample_rate=int(sp["negative_sample_rate"]),
            a=self.a_,
            b=self.b_,
            random_state=sp["random_state"],
            metric=str(sp["metric"]),
        )
        return pd.DataFrame({"features": list(feats), self.getOutputCol(): list(emb)})

    def _pre_process_data(self, dataset: Any, for_fit: bool = True) -> ExtractedData:
        self._supervised = False
        return super()._pre_process_data(dataset, for_fit=for_fit)

    # .npy-sidecar persistence --------------------------------------------
    def write(self) -> "_UMAPWriterNumpy":
        return _UMAPWriterNumpy(self)

    @classmethod
    def read(cls) -> "_UMAPReaderNumpy":
        return _UMAPReaderNumpy(cls)


class _UMAPWriterNumpy(_TpuWriter):
    """`_TpuWriter`'s metadata; the arrays go to .npy files under data/
    instead of the npz bundle."""

    def _write_model_attributes(self, inst: Any, path: str) -> None:
        data_path = os.path.join(path, "data")
        os.makedirs(data_path, exist_ok=True)
        attrs: Dict[str, Any] = {}
        for key, value in inst._model_attributes.items():
            if isinstance(value, np.ndarray):
                np.save(os.path.join(data_path, f"{key}.npy"), value)
                attrs[key] = {"__npy__": f"{key}.npy"}
            else:
                attrs[key] = value
        with open(os.path.join(data_path, "attributes.json"), "w") as f:
            json.dump(attrs, f, default=_np_default)


class _UMAPReaderNumpy(_TpuReader):
    def _read_model_attributes(self, path: str) -> Dict[str, Any]:
        data_path = os.path.join(path, "data")
        with open(os.path.join(data_path, "attributes.json")) as f:
            attrs = json.load(f)
        for key, value in list(attrs.items()):
            if isinstance(value, dict) and "__npy__" in value:
                attrs[key] = np.load(os.path.join(data_path, value["__npy__"]))
        return attrs
