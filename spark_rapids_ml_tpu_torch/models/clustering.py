#
# KMeans estimator and model, drop-in for `pyspark.ml.clustering.KMeans`,
# and DBSCAN: the PyTorch counterpart of
# spark_rapids_ml_tpu/models/clustering.py (KMeans, KMeansModel, with
# KMeansModel's serving hooks; DBSCAN, DBSCANModel), on one device. An
# over-budget KMeans fit streams its rows from the host
# (ops/streaming.kmeans_fit_streaming). Warm start takes a fitted model or a
# `SolverCheckpoint` with a `centers` payload. KMeans fits across processes
# too (a TpuContext with nranks > 1): every rank draws a bounded sample of
# its own rows, the samples are gathered in rank order, and every rank
# seeds on that same union, so all enter the Lloyd loop (whose step sums
# across ranks, ops/kmeans.py) with the same centers. DBSCAN under a
# multi-process context gathers every rank's rows, splits its passes'
# row tiles between the ranks (ops/dbscan.py), and each rank keeps its own
# rows' labels. Sparse input is densified, as in the JAX package.
#
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core import FitInputs, _TpuEstimator, _TpuModel, _TpuModelWithColumns
from ..data import ExtractedData, as_dense
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasIDCol,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
    HasTol,
    HasWeightCol,
    Param,
    TypeConverters,
)


class _KMeansParams(
    HasFeaturesCol, HasFeaturesCols, HasPredictionCol, HasSeed, HasTol, HasMaxIter, HasWeightCol
):
    k = Param("k", "the number of clusters to create", TypeConverters.toInt)
    initMode = Param(
        "initMode", "the initialization algorithm: 'k-means||' or 'random'", TypeConverters.toString
    )
    initSteps = Param("initSteps", "the number of steps for k-means|| initialization", TypeConverters.toInt)
    distanceMeasure = Param("distanceMeasure", "the distance measure (euclidean only)", TypeConverters.toString)

    def getK(self) -> int:
        return self.getOrDefault("k")

    def getInitMode(self) -> str:
        return self.getOrDefault("initMode")

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        # Spark param -> solver kwarg (the reference's cuML names)
        return {
            "k": "n_clusters",
            "maxIter": "max_iter",
            "tol": "tol",
            "seed": "random_state",
            "initMode": "init",
            "initSteps": "",  # accepted, ignored (cuML has no analog)
            "distanceMeasure": None,  # only 'euclidean'; validated in _set_params
            "weightCol": "",
        }

    @classmethod
    def _param_value_mapping(cls):
        return {"tol": lambda v: 1e-16 if v == 0 else v}  # tol=0 remap, as the reference does

    def _get_solver_params_default(self) -> Dict[str, Any]:
        return {
            "n_clusters": 8,
            "max_iter": 300,
            "tol": 1e-4,
            "random_state": 1,
            "init": "scalable-k-means++",
            "max_samples_per_batch": 32768,
            "oversampling_factor": 2.0,
            "verbose": False,
            # "fast" = bf16 in-loop products with float32 accumulation; the
            # reported inertia is always re-evaluated at high precision.
            # "high" keeps the input precision in the loop.
            "distance_precision": "fast",
            # per-estimator override of config["solver_precision"]; "bf16"
            # forces the fast in-loop path
            "solver_precision": None,
        }


class KMeans(_KMeansParams, _TpuEstimator):
    """KMeans estimator, drop-in for ``pyspark.ml.clustering.KMeans``.

    Fit is a host loop of Lloyd iterations on one device, each iteration
    scanning row tiles of ``max_samples_per_batch`` rows through the argmin
    and accumulation kernels (ops/kmeans.py)."""

    # per-chunk assignment and center accumulation: an over-budget dataset
    # demotes to ops/streaming.kmeans_fit_streaming
    _supports_streaming_fit = True
    # the init sample gathered across ranks, the Lloyd sums reduced
    _supports_multiprocess = True

    def _solver_workspace_terms(
        self, rows_per_device: int, n_cols: int, params: Dict[str, Any], itemsize: int
    ) -> Dict[str, int]:
        # the JAX package's terms: the [b, k] distance and one-hot blocks of
        # a batch_rows-row tile, the (k, d) centers and sums, and the
        # predict-side [tile, k] block at config["distance_tile_rows"]
        # rows. The port's own: the `fast` form of the argmin kernel stages
        # the Lloyd tile as bf16, rows rounded up to its row tile and depth
        # to STAGE_DEPTH (ops/_kernels.stage_bf16: 197 MB at 32768 x 3000)
        from ..core import resolve_solver_precision
        from ..ops._kernels import ARGMIN_TILE, STAGE_DEPTH
        from ..ops.distance import tile_rows

        k = int(params.get("n_clusters", 8))
        b = min(int(params.get("max_samples_per_batch", 32768)), max(1, rows_per_device))
        predict_rows = min(tile_rows(), max(1, rows_per_device))
        terms = {
            "tile_buffers": 2 * b * k * itemsize,
            "centers": 2 * k * n_cols * itemsize,
            "predict_tile": predict_rows * k * itemsize,
        }
        fast = resolve_solver_precision(params) == "bf16" or params.get("distance_precision") == "fast"
        if fast and itemsize == 4:
            rows = -(-b // ARGMIN_TILE["f32-fast"][0]) * ARGMIN_TILE["f32-fast"][0]
            terms["fast_staging"] = rows * (-(-n_cols // STAGE_DEPTH) * STAGE_DEPTH) * 2
        return terms

    def _extraction_workspace_terms(self, terms, rows_dev, extracted, params, itemsize):
        """The port's own term of a k-means|| seeding (k >= 64, no warm
        start; memory.workspace_estimate): `ops/kmeans.scalable_kmeans_init`
        places its row subsample (at most `_INIT_SAMPLE_CAP` rows of the
        whole dataset, float32, whether or not the fit streams) with its
        running min-d², the [subsample, 2k] distance block of each round,
        and the candidate set of its rounds + 1 blocks of 2k rows."""
        from ..ops.kmeans import _INIT_SAMPLE_CAP, INIT_ROUNDS

        k = int(params.get("n_clusters", 8))
        if (self._warm_start is not None or params.get("init", "scalable-k-means++") == "random"
                or k < 64):
            return terms
        n_sub = min(int(extracted.n_rows), _INIT_SAMPLE_CAP)
        d = int(extracted.n_cols)
        l = 2 * k
        return dict(terms, init_subsample=n_sub * (d + 1) * 4 + n_sub * l * 4 + (INIT_ROUNDS + 1) * l * d * 4)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(k=2, initMode="k-means||", initSteps=2, maxIter=20, tol=1e-4, seed=1,
                         distanceMeasure="euclidean")
        self._set_params(**kwargs)

    def _set_params(self, **kwargs):
        if "distanceMeasure" in kwargs and kwargs["distanceMeasure"] != "euclidean":
            raise ValueError("Only distanceMeasure='euclidean' is supported")
        kwargs.pop("distanceMeasure", None)
        return super()._set_params(**kwargs)

    def setK(self, value: int) -> "KMeans":
        return self._set_params(k=value)

    def setMaxIter(self, value: int) -> "KMeans":
        return self._set_params(maxIter=value)

    def setTol(self, value: float) -> "KMeans":
        return self._set_params(tol=value)

    def setSeed(self, value: int) -> "KMeans":
        return self._set_params(seed=value)

    def setInitMode(self, value: str) -> "KMeans":
        return self._set_params(initMode=value)

    def setFeaturesCol(self, value) -> "KMeans":
        return self._set_params(featuresCol=value) if isinstance(value, str) else self._set_params(featuresCols=value)

    def setPredictionCol(self, value: str) -> "KMeans":
        return self._set_params(predictionCol=value)

    def setWeightCol(self, value: str) -> "KMeans":
        return self._set_params(weightCol=value)

    def _resolve_warm_start(self, source: Any) -> Dict[str, Any]:
        """Warm-start payload for `fit(..., warm_start_from=...)`: a fitted
        `KMeansModel`'s centers, or a `SolverCheckpoint`'s (of either
        package, known by its class name) portable center subset, as k-means
        checkpoints carry it."""
        if type(source).__name__ == "SolverCheckpoint":
            centers = (source.portable or {}).get("centers", (source.state or {}).get("centers"))
            if centers is None:
                raise ValueError(
                    "SolverCheckpoint warm start for KMeans needs a "
                    "'centers' payload (k-means checkpoints carry one)"
                )
            return {"cluster_centers_": np.asarray(centers), "n_iter_": int(source.iteration)}
        centers = getattr(source, "cluster_centers_", None)
        if centers is None:
            raise TypeError(
                f"cannot warm-start KMeans from {type(source).__name__}: "
                "expected a fitted KMeansModel or a SolverCheckpoint"
            )
        return {
            "cluster_centers_": np.asarray(centers),
            "n_iter_": int(getattr(source, "n_iter_", 0) or 0),
        }

    def _get_tpu_fit_func(self, extracted: ExtractedData):
        from ..core import resolve_solver_precision
        from ..ops.kmeans import kmeans_fit, kmeans_plus_plus_init, scalable_kmeans_init

        x_host = extracted.features
        w_host = extracted.weight

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            k = int(params["n_clusters"])
            if k > inputs.n_valid:
                raise ValueError(f"k={k} exceeds number of rows {inputs.n_valid}")
            init_mode = params.get("init", "scalable-k-means++")
            seed = int(params.get("random_state", 1) or 1)
            # warm start: the donor's centers ARE the init, and the seeding
            # below is skipped
            warm = self._warm_start
            if warm is not None:
                centers0 = np.asarray(warm["cluster_centers_"])
                if tuple(centers0.shape) != (k, int(inputs.n_cols)):
                    raise ValueError(
                        f"warm-start centers shape {tuple(centers0.shape)} does not "
                        f"match this fit (k={k}, d={inputs.n_cols})"
                    )
                from .. import telemetry

                reg = telemetry.registry()
                reg.inc("fit.warm_starts")
                reg.inc("fit.warm_start_iterations_saved", int(warm.get("n_iter_", 0) or 0))
            else:

                def seed_centers():
                    if init_mode == "random":
                        return _random_init(inputs, x_host, k, seed)
                    x_init, w_init = _init_rows(inputs, x_host, w_host, k, seed)
                    if k >= 64:
                        # true k-means|| for large k: O(rounds) device passes
                        # instead of k sequential host passes
                        return scalable_kmeans_init(x_init, k, seed, w_init, device=inputs.device)
                    return kmeans_plus_plus_init(x_init, k, seed, w_init)  # small k: k-means++ on the host

                centers0 = _retained_init(inputs, f"kmeans_init:{init_mode}:{k}:{seed}", seed_centers)
            centers0 = centers0.astype(inputs.dtype)
            # solver_precision="bf16" forces the fast in-loop path; otherwise
            # distance_precision governs the resident loop, and the streamed
            # one runs at full precision (the JAX package's rule)
            solver_precision = resolve_solver_precision(params)
            batch_rows = int(params.get("max_samples_per_batch", 32768))
            if inputs.stream is not None:
                from ..ops.streaming import kmeans_fit_streaming

                # whole Lloyd tiles per chunk, so the kernels see the resident
                # loop's tiles (a smaller chunk only shrinks the admitted set)
                if inputs.stream.chunk_rows > batch_rows:
                    inputs.stream.chunk_rows = inputs.stream.chunk_rows // batch_rows * batch_rows
                state = kmeans_fit_streaming(
                    inputs,
                    centers0,
                    max_iter=int(params["max_iter"]),
                    tol=float(params["tol"]),
                    batch_rows=batch_rows,
                    precision_mode="fast" if solver_precision == "bf16" else "high",
                )
            else:
                state = kmeans_fit(
                    inputs.X,
                    inputs.w,
                    centers0,
                    max_iter=int(params["max_iter"]),
                    tol=float(params["tol"]),
                    batch_rows=batch_rows,
                    precision_mode=(
                        "fast"
                        if solver_precision == "bf16"
                        else str(params.get("distance_precision", "fast"))
                    ),
                )
            return {
                "cluster_centers_": state["cluster_centers_"].cpu().numpy(),
                "inertia_": float(state["inertia_"]),
                "n_iter_": int(state["n_iter_"]),
                "n_cols": inputs.n_cols,
                "dtype": np.dtype(inputs.dtype).name,
            }

        return _fit

    def _create_model(self, attrs: Dict[str, Any]) -> "KMeansModel":
        return KMeansModel(**attrs)


def _retained_init(inputs: FitInputs, key: str, seed_centers) -> np.ndarray:
    """The init centers of a fit: `seed_centers()`, or, in a checkpointed
    fit under a multi-process context, the centers its first attempt seeded, kept in the
    stage's checkpoint store. A recovery epoch re-enters the fit over the
    survivors' rows, whose seeding would draw other centers; the retained
    ones keep the trajectory's checkpoint key (`ops.kmeans.kmeans_ckpt_key`
    digests the init), so the Lloyd loop resumes from its last checkpoint
    instead of starting again. Every rank seeds in the same collective
    rounds, so the survivors hold the entry alike."""
    from .. import checkpoint as _ckpt

    # `ctx`, not `spmd`: a lone survivor of a recovery epoch fits in a
    # one-rank group, which is no longer SPMD but resumes all the same
    if inputs.ctx is None or not _ckpt.solver_checkpoints_active():
        return seed_centers()
    store = _ckpt.active_store()
    held = store.peek(key)
    if held is not None:
        return np.array(held.state["centers"])
    centers = seed_centers()
    store.save(key, _ckpt.SolverCheckpoint(solver="kmeans_init", iteration=0, state={"centers": np.array(centers)}))
    return centers


def _init_sample(inputs: FitInputs, n_loc: int, k: int, seed: int) -> np.ndarray:
    """This rank's share of the init union in a multi-process fit: the
    positions of its rows, all of them, or, past ``max(4k, 262144 //
    nranks)``, that many drawn without replacement and sorted, from
    ``np.random.default_rng(seed * 100003 + rank)`` (the JAX package's
    draw)."""
    cap = max(4 * k, 262_144 // inputs.ctx.nranks)
    if n_loc <= cap:
        return np.arange(n_loc)
    rs = np.random.default_rng(seed * 100_003 + inputs.ctx.rank)
    return np.sort(rs.choice(n_loc, cap, replace=False))


def _init_rows(inputs: FitInputs, x_host, w_host, k: int, seed: int):
    """The (rows, weights) a fit seeds on: its own rows on one process; in
    a multi-process fit the union of every rank's sample (`_init_sample`),
    gathered in rank order, the same on every rank. The sample travels at
    the rows' dtype and is widened to float64 after the gather: the JAX
    package's union (which widens first), in half the bytes for float32
    rows."""
    if not inputs.spmd:
        return x_host, w_host
    sel = _init_sample(inputs, x_host.shape[0], k, seed)
    x_init = inputs.allgather_array(np.asarray(x_host[sel])).astype(np.float64)
    # the weight column is set on every rank or on none (one estimator)
    w_init = None if w_host is None else inputs.allgather_array(np.asarray(w_host[sel])).astype(np.float64)
    return x_init, w_init


def _random_init(inputs: FitInputs, x_host, k: int, seed: int) -> np.ndarray:
    """`ops.kmeans.random_init` on the rows a fit seeds on. In a
    multi-process fit that union is never gathered whole: random_init
    draws k of its positions (``default_rng(seed).choice(n_union, k)``),
    so every rank makes the same draw once the ranks' sample sizes are
    known (one rendezvous round), and the k drawn rows are gathered from
    their owners; the centers equal random_init of the gathered union bit
    for bit, at k rows of traffic instead of the union's."""
    from ..ops.kmeans import random_init

    if not inputs.spmd:
        return random_init(x_host, k, seed)
    rank = inputs.ctx.rank
    sel = _init_sample(inputs, x_host.shape[0], k, seed)
    sizes = [int(v) for v in inputs.allgather_host(str(len(sel)))]
    n_union, lo = sum(sizes), sum(sizes[:rank])
    if k > n_union:
        raise ValueError(f"k={k} exceeds number of rows {n_union}")
    idx = np.random.default_rng(seed).choice(n_union, k, replace=False)
    owner = np.searchsorted(np.cumsum(sizes), idx, side="right")
    mine = idx[owner == rank] - lo
    rows = inputs.allgather_array(np.asarray(x_host[sel[mine]]))  # rank order, then draw order
    centers = np.empty((k, x_host.shape[1]), dtype=np.float64)
    centers[np.argsort(owner, kind="stable")] = rows
    return centers


class KMeansModel(_KMeansParams, _TpuModelWithColumns):
    """Fitted KMeans model."""

    def __init__(
        self,
        cluster_centers_: Optional[np.ndarray] = None,
        inertia_: float = 0.0,
        n_iter_: int = 0,
        n_cols: int = 0,
        dtype: str = "float32",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            cluster_centers_=cluster_centers_,
            inertia_=inertia_,
            n_iter_=n_iter_,
            n_cols=n_cols,
            dtype=dtype,
        )
        self.cluster_centers_ = np.asarray(cluster_centers_)
        self.inertia_ = float(inertia_)
        self.n_iter_ = int(n_iter_)
        self.n_cols = int(n_cols)
        self.dtype = dtype
        self._setDefault(k=int(self.cluster_centers_.shape[0]) if cluster_centers_ is not None else 2)

    def clusterCenters(self) -> List[np.ndarray]:
        """Spark ML surface: list of center vectors."""
        return [c for c in self.cluster_centers_]

    @property
    def numClusters(self) -> int:
        return self.cluster_centers_.shape[0]

    def predict(self, value) -> int:
        """Single-vector predict (Spark ML model surface), on the host."""
        from ..linalg import Vector

        v = value.toArray() if isinstance(value, Vector) else np.asarray(value)
        d2 = np.sum((self.cluster_centers_ - v[None, :]) ** 2, axis=1)
        return int(np.argmin(d2))

    def setFeaturesCol(self, value) -> "KMeansModel":
        return self._set_params(featuresCol=value) if isinstance(value, str) else self._set_params(featuresCols=value)

    def setPredictionCol(self, value: str) -> "KMeansModel":
        return self._set_params(predictionCol=value)

    def _out_column_names(self) -> List[str]:
        return [self.getOrDefault("predictionCol")]

    def _centers_on_device(self):
        from ..parallel import default_device, host_tensor

        dtype = np.float32 if self._float32_inputs else np.float64
        return host_tensor(self.cluster_centers_.astype(dtype, copy=False)).to(default_device())

    def _get_transform_func(self):
        from ..ops.kmeans import kmeans_predict

        return self._centers_on_device, lambda state, xb: kmeans_predict(xb, state)

    # serving hooks -------------------------------------------------------

    _serve_dtypes = (None, "float32", "float64", "bf16")

    def _serve_program(self, serve_dtype=None, *, cap=None):
        """KMeans serving hook: `serve_dtype="bf16"` routes assignment
        through the distance core's fast mode (bf16 products, float32
        accumulation; assignments flip only for near-tied rows)."""
        if serve_dtype != "bf16":
            return super()._serve_program(serve_dtype, cap=cap)
        self._serve_check(serve_dtype)
        from ..core import PredictProgram
        from ..ops.distance import argmin_assign

        return PredictProgram(
            self,
            construct=self._centers_on_device,
            predict=lambda state, xb: argmin_assign(xb, state, fast=True),
            cap=cap,
        )

    def _serve_workspace_terms(self, bucket_rows_count, itemsize):
        # the assignment runs in row tiles of config["distance_tile_rows"]
        # through the argmin kernel, which keeps no [tile, k] block; the plain
        # version (the CPU) holds one, the reference's term. The kernel's
        # `fast` form (a bf16 load) stages the tile as bf16 instead: rows
        # rounded up to its row tile, depth to STAGE_DEPTH, 2 bytes each
        # (24.6 MB at 4096 x 3000, against the reference's 16 MB at k =
        # 1000). The term prices the larger of the two
        from ..ops._kernels import ARGMIN_TILE, STAGE_DEPTH
        from ..ops.distance import tile_rows

        k = int(self.cluster_centers_.shape[0])
        d = int(self.cluster_centers_.shape[1])
        tile = min(tile_rows(), max(1, int(bucket_rows_count)))
        row_tile = ARGMIN_TILE["f32-fast"][0]
        staging = -(-tile // row_tile) * row_tile * (-(-d // STAGE_DEPTH) * STAGE_DEPTH) * 2
        return {"predict_tile": max(tile * k * itemsize, staging)}

    def _serve_flop_estimate(self, n_rows, n_cols):
        # the [n, k] squared-distance block (~3*n*k*d for the expanded
        # |x|^2 - 2 x.c + |c|^2 form); the argmin epilogue left out
        k = max(1, int(self.cluster_centers_.shape[0]))
        return 3.0 * n_rows * k * n_cols


class _DBSCANParams(HasFeaturesCol, HasFeaturesCols, HasPredictionCol, HasIDCol):
    """DBSCAN's Param surface: the solver's knobs are Params of their own
    (no pyspark DBSCAN exists to map from), identity-mapped to the solver
    params."""

    eps = Param(
        "eps",
        "maximum distance between 2 points such they reside in the same neighborhood",
        TypeConverters.toFloat,
    )
    min_samples = Param(
        "min_samples",
        "number of samples in a neighborhood for a point to be a core point (incl. itself)",
        TypeConverters.toInt,
    )
    metric = Param("metric", "distance metric: 'euclidean' or 'cosine'", TypeConverters.toString)
    algorithm = Param("algorithm", "neighbor computation algorithm: 'brute' or 'rbc'", TypeConverters.toString)
    max_mbytes_per_batch = Param(
        "max_mbytes_per_batch",
        "memory budget (MB) for each pairwise-distance tile — trades runtime for memory "
        "on the N^2 distance computation",
        TypeConverters.identity,
    )
    calc_core_sample_indices = Param(
        "calc_core_sample_indices", "whether to compute core sample indices", TypeConverters.toBoolean
    )

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {name: name for name in (
            "eps", "min_samples", "metric", "algorithm", "max_mbytes_per_batch", "calc_core_sample_indices",
        )}

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        # the Param-tier defaults, here so a model built directly resolves
        # them too; calc_core_sample_indices is True at this tier (the
        # solver tier below says False, and the Param tier wins)
        self._setDefault(
            eps=0.5, min_samples=5, metric="euclidean", algorithm="brute",
            max_mbytes_per_batch=None, calc_core_sample_indices=True,
        )

    def _get_solver_params_default(self) -> Dict[str, Any]:
        return {
            "eps": 0.5,
            "min_samples": 5,
            "metric": "euclidean",
            "algorithm": "brute",
            "verbose": False,
            "max_mbytes_per_batch": None,
            "calc_core_sample_indices": False,
        }

    def getEps(self) -> float:
        return self.getOrDefault("eps")

    def setEps(self, value: float):
        return self._set_params(eps=value)

    def getMinSamples(self) -> int:
        return self.getOrDefault("min_samples")

    def setMinSamples(self, value: int):
        return self._set_params(min_samples=value)

    def getMetric(self) -> str:
        return self.getOrDefault("metric")

    def setMetric(self, value: str):
        return self._set_params(metric=value)

    def setMaxMbytesPerBatch(self, value):
        return self._set_params(max_mbytes_per_batch=value)

    def getMaxMbytesPerBatch(self):
        return self.getOrDefault("max_mbytes_per_batch")

    def getAlgorithm(self) -> str:
        return self.getOrDefault("algorithm")

    def setAlgorithm(self, value: str):
        return self._set_params(algorithm=value)

    def getCalcCoreSampleIndices(self) -> bool:
        return self.getOrDefault("calc_core_sample_indices")

    def setCalcCoreSampleIndices(self, value: bool):
        return self._set_params(calc_core_sample_indices=value)

    def setFeaturesCol(self, value):
        return self._set_params(featuresCol=value) if isinstance(value, str) else self._set_params(featuresCols=value)

    def setPredictionCol(self, value: str):
        return self._set_params(predictionCol=value)

    def setIdCol(self, value: str):
        return self._set_params(idCol=value)


class DBSCAN(_DBSCANParams, _TpuEstimator):
    """DBSCAN estimator. ``fit`` touches no data: it returns a copy of the
    parameters as a model, and the clustering runs in ``model.transform``
    (DBSCAN has no train/inference split).

    >>> model = DBSCAN(eps=0.5, min_samples=5).setFeaturesCol("features").fit(df)
    >>> out = model.transform(df)   # df + prediction column, noise = -1

    The rows go to the device whole, and the N^2 distance work runs in three
    tiled passes (ops/dbscan.py): core mask, components of the core graph,
    border adoption. `max_mbytes_per_batch` bounds each distance tile."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_params(**kwargs)

    def _set_params(self, **kwargs):
        if "metric" in kwargs and kwargs["metric"] not in ("euclidean", "cosine", "precomputed"):
            raise ValueError(
                f"metric must be 'euclidean', 'cosine' or 'precomputed', got {kwargs['metric']!r}"
            )
        if "algorithm" in kwargs and kwargs["algorithm"] not in ("brute", "rbc"):
            raise ValueError(f"algorithm must be 'brute' or 'rbc', got {kwargs['algorithm']!r}")
        return super()._set_params(**kwargs)

    def _get_tpu_fit_func(self, extracted: ExtractedData):  # pragma: no cover
        raise NotImplementedError("DBSCAN does not fit and generate model")

    def _fit_internal(self, dataset: Any, paramMaps, row_mask=None):
        # parameter-copied models, no data touched; one per param map
        sources = [self.copy(pm) for pm in paramMaps] if paramMaps else [self]
        models = []
        for src in sources:
            model = DBSCANModel(n_cols=0, dtype="")
            src._copyValues(model)
            src._copy_solver_params(model)
            models.append(model)
        return models

    def _create_model(self, attrs):  # pragma: no cover - _fit_internal overridden
        return DBSCANModel(**attrs)


class DBSCANModel(_DBSCANParams, _TpuModel):
    """DBSCAN's model: the clustering runs inside transform, which appends
    the int64 label column (noise -1).

    `idCol` is accepted: the labels attach to the rows by position, and an
    id column is left as it is."""

    def __init__(self, n_cols: int = 0, dtype: str = "", **kwargs: Any) -> None:
        super().__init__(n_cols=n_cols, dtype=dtype)
        self.n_cols = int(n_cols)
        self.dtype = dtype
        self.core_sample_indices_: Optional[np.ndarray] = None

    def transform(self, dataset: Any):
        from ..data import as_pandas
        from ..parallel import fan_out_width, refuse_devices_per_rank, run_on_chips, shard_row_ranges

        refuse_devices_per_rank(self.num_workers, "DBSCAN")
        pdf = as_pandas(dataset)
        feats = np.asarray(as_dense(self._pre_process_data(dataset, for_fit=False).features), dtype=np.float32)
        width = fan_out_width(self.num_workers)
        if width > 1:
            # over several chips of one process: chip r holds row block r
            # and runs the multi-process transform, as a rank would; its
            # rows' labels come back in order
            ranges = shard_row_ranges(feats.shape[0], width)
            parts, _ = run_on_chips(width, lambda r: self._cluster(feats[ranges[r][0]:ranges[r][1]]),
                                    name="srml-dbscan")
            labels, core_idx = np.concatenate([p[0] for p in parts]), parts[0][1]
        else:
            labels, core_idx = self._cluster(feats)
        if len(labels) != len(pdf):
            raise RuntimeError(f"row count mismatch: {len(labels)} labels vs {len(pdf)} input rows")
        # the latest transform's state, as cuML's fit_predict keeps it;
        # concurrent transforms of one model should each use a copy()
        self.core_sample_indices_ = core_idx
        out = pdf.copy(deep=False)
        out[self.getOrDefault("predictionCol")] = labels.astype(np.int64)
        return out

    def _cluster(self, feats: np.ndarray):
        """(this process's rows' labels, the global core sample indices):
        under a multi-process context every rank's rows are gathered in rank
        order over the process group and the passes split their row tiles
        between the ranks."""
        from ..ops.dbscan import dbscan_fit
        from ..parallel import default_device, spmd_context

        ctx = spmd_context()
        row_offset, n_local = 0, feats.shape[0]
        if ctx is not None:
            blocks = ctx.group.allgather_arrays(feats)
            row_offset = sum(b.shape[0] for b in blocks[: ctx.rank])
            feats = np.concatenate(blocks, axis=0)
        labels, core_idx = dbscan_fit(
            feats,
            device=default_device(),
            eps=float(self.getOrDefault("eps")),
            min_samples=int(self.getOrDefault("min_samples")),
            metric=self.getOrDefault("metric"),
            max_mbytes_per_batch=self.getOrDefault("max_mbytes_per_batch"),
            calc_core_sample_indices=bool(self.getOrDefault("calc_core_sample_indices")),
            group=None if ctx is None else ctx.group,
        )
        # a multi-process transform keeps its own rows' labels;
        # core_sample_indices_ stay global row positions
        return labels[row_offset:row_offset + n_local], core_idx
