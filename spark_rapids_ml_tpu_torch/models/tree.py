#
# Shared random-forest machinery: the params common to the classifier and
# the regressor, the fit closure and the array-forest model base. The
# PyTorch counterpart of spark_rapids_ml_tpu/models/tree.py, on one
# device; the two classes live in classification.py and regression.py.
#
# The fit: the class set from np.unique, quantile edges from a host sample
# (ops/trees.quantile_bins), the rows binned on the device, one forest_fit
# (ops/trees.py), the split bins turned into thresholds, empty nodes filled
# from their parents. The model keeps feature [T, M], threshold [T, M] and
# node_stats [T, M, S] and predicts by a fixed-depth descent of every tree
# (ops/trees.forest_raw_predict), which also serves through the default
# PredictProgram hook.
#
# A multi-process fit (a TpuContext with nranks > 1; the JAX package's SPMD
# fit) gathers the class set and a bounded sketch sample of every rank, so
# every rank bins with the same edges; rank r grows trees r·tpd ..
# r·tpd + tpd − 1 (tpd = ceil(numTrees / nranks)) on its own rows, drawing
# over the largest rank's block as JAX's padded layout does, and the trees
# are gathered and laid out round-major, the JAX package's forest order,
# cut at numTrees (a rank skips the trees the cut drops).
#
# Left out, each raising NotImplementedError naming its ROADMAP item:
# `.cpu()` (the conversion to Spark's forests), `predictLeaf` and
# `evaluate`, which go through it (A16). One process driving several chips
# runs the multi-process fit, one thread a chip (`core._TpuCaller.
# _call_fit_func_fanned`). The JAX solver param `node_chunk`
# (its TPU chunk cap) is not here: the port sizes its node chunks by
# memory (ops/trees.HIST_BUDGET).
#
from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List, Optional

import numpy as np

from ..core import FitInputs, _TpuEstimatorSupervised, _TpuModelWithColumns
from ..data import ExtractedData
from ..linalg import DenseVector, Vector
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasSeed,
    HasWeightCol,
    Param,
    TypeConverters,
)


def resolve_max_features(strategy: str, d: int, is_classification: bool) -> int:
    """featureSubsetStrategy -> number of features per split (Spark semantics)."""
    s = str(strategy).lower()
    if s == "auto":
        return max(1, int(math.sqrt(d))) if is_classification else max(1, d // 3)
    if s == "all":
        return d
    if s == "sqrt":
        return max(1, int(math.sqrt(d)))
    if s == "log2":
        return max(1, int(math.log2(d)))
    if s == "onethird":
        return max(1, d // 3)
    # Spark's grammar: "^[1-9]\d*$" is a feature COUNT; "(0.0, 1.0]" decimals
    # are a fraction — so "1.0" means ALL features, "1" means one feature
    if re.fullmatch(r"[1-9]\d*", s):
        return min(d, int(s))
    try:
        v = float(s)
        if 0 < v <= 1:
            return max(1, int(v * d))
    except ValueError:
        pass
    raise ValueError(f"Unsupported featureSubsetStrategy: {strategy!r}")


class _RandomForestParams(
    HasFeaturesCol, HasFeaturesCols, HasLabelCol, HasPredictionCol, HasSeed, HasWeightCol
):
    numTrees = Param("numTrees", "number of trees in the forest", TypeConverters.toInt)
    maxDepth = Param("maxDepth", "maximum tree depth", TypeConverters.toInt)
    maxBins = Param("maxBins", "maximum number of feature histogram bins", TypeConverters.toInt)
    minInstancesPerNode = Param(
        "minInstancesPerNode", "minimum number of instances each child must have", TypeConverters.toInt
    )
    minInfoGain = Param("minInfoGain", "minimum information gain for a split", TypeConverters.toFloat)
    featureSubsetStrategy = Param(
        "featureSubsetStrategy",
        "number of features per split: auto|all|sqrt|log2|onethird|n|fraction",
        TypeConverters.toString,
    )
    subsamplingRate = Param("subsamplingRate", "fraction of rows sampled per tree", TypeConverters.toFloat)
    bootstrap = Param("bootstrap", "whether bootstrap samples are used", TypeConverters.toBoolean)
    impurity = Param("impurity", "split criterion", TypeConverters.toString)
    # accepted-and-ignored Spark knobs
    checkpointInterval = Param("checkpointInterval", "ignored", TypeConverters.toInt)
    cacheNodeIds = Param("cacheNodeIds", "ignored", TypeConverters.toBoolean)
    maxMemoryInMB = Param("maxMemoryInMB", "ignored", TypeConverters.toInt)

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "numTrees": "n_estimators",
            "maxDepth": "max_depth",
            "maxBins": "n_bins",
            "minInstancesPerNode": "min_samples_leaf",
            "minInfoGain": "min_impurity_decrease",
            "featureSubsetStrategy": "max_features",
            "subsamplingRate": "max_samples",
            "bootstrap": "bootstrap",
            "impurity": "split_criterion",
            "seed": "random_state",
            "checkpointInterval": "",
            "cacheNodeIds": "",
            "maxMemoryInMB": "",
            "weightCol": "",
        }

    def _get_solver_params_default(self) -> Dict[str, Any]:
        return {
            "n_estimators": 20,
            "max_depth": 5,
            "n_bins": 32,
            "min_samples_leaf": 1,
            "min_impurity_decrease": 0.0,
            "max_features": "auto",
            "max_samples": 1.0,
            "bootstrap": True,
            "split_criterion": None,  # set by subclass default
            "random_state": 0,
            "verbose": False,
        }

    def getNumTrees(self) -> int:
        return self.getOrDefault("numTrees")

    def getMaxDepth(self) -> int:
        return self.getOrDefault("maxDepth")


class _RandomForestEstimator(_RandomForestParams, _TpuEstimatorSupervised):
    """Shared fit orchestration."""

    _is_classification: bool = False
    # the global class set and sketch, each rank's share of the trees
    _supports_multiprocess = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(
            numTrees=20, maxDepth=5, maxBins=32, minInstancesPerNode=1, minInfoGain=0.0,
            featureSubsetStrategy="auto", subsamplingRate=1.0, bootstrap=True, seed=0,
        )
        self._set_params(**kwargs)

    def setNumTrees(self, value: int):
        return self._set_params(numTrees=value)

    def setMaxDepth(self, value: int):
        return self._set_params(maxDepth=value)

    def setMaxBins(self, value: int):
        return self._set_params(maxBins=value)

    def setFeatureSubsetStrategy(self, value: str):
        return self._set_params(featureSubsetStrategy=value)

    def setImpurity(self, value: str):
        return self._set_params(impurity=value)

    def setSeed(self, value: int):
        return self._set_params(seed=value)

    def setFeaturesCol(self, value):
        return self._set_params(featuresCol=value) if isinstance(value, str) else self._set_params(featuresCols=value)

    def setLabelCol(self, value: str):
        return self._set_params(labelCol=value)

    def setPredictionCol(self, value: str):
        return self._set_params(predictionCol=value)

    def setWeightCol(self, value: str):
        return self._set_params(weightCol=value)

    def _row_stats(self, labels: np.ndarray, classes: np.ndarray) -> np.ndarray:
        """Per-row stat contributions: class one-hot (clf) or (1, y, y²) (reg)."""
        if self._is_classification:
            idx = np.searchsorted(classes, labels)
            stats = np.zeros((len(labels), len(classes)), np.float32)
            stats[np.arange(len(labels)), idx] = 1.0
            return stats
        y = labels.astype(np.float64)
        return np.stack([np.ones_like(y), y, y * y], axis=1).astype(np.float32)

    def _get_tpu_fit_func(self, extracted: ExtractedData):
        from ..ops.trees import bin_features, forest_fit, quantile_bins, split_bins_to_thresholds
        from ..parallel import host_tensor

        x_host = extracted.features
        labels_host = extracted.label

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            d = inputs.n_cols
            max_bins = int(params["n_bins"])
            max_depth = int(params["max_depth"])
            seed = int(params["random_state"] or 0)
            n_trees = int(params["n_estimators"])
            classes = np.unique(labels_host).astype(np.float64) if self._is_classification else np.zeros(0)
            x_sketch, tree_ids, draw_rows = x_host, None, None
            if inputs.spmd:
                # the class set and the sketch rows are global (a rank may
                # hold one class), so every rank derives the same classes and
                # bit-identical edges; each rank grows its share of the trees
                # on its own rows, drawing over the largest rank's block
                classes, x_sketch = _spmd_class_set_and_sketch(inputs, classes, x_host, seed)
                ctx = inputs.ctx
                tree_ids = spmd_tree_ids(n_trees, ctx.nranks, ctx.rank)
                draw_rows = max(inputs.desc.rows_of(r) for r in range(ctx.nranks))
            edges_host = quantile_bins(x_sketch, max_bins, seed=seed)
            del x_sketch
            stats = host_tensor(self._row_stats(labels_host, classes)).to(inputs.device)
            Xb = bin_features(inputs.X, host_tensor(edges_host.astype(np.float32)))
            state = forest_fit(
                Xb,
                stats * inputs.w[:, None],
                inputs.w,
                seed,
                n_trees=n_trees,
                max_depth=max_depth,
                max_bins=max_bins,
                max_features=resolve_max_features(params["max_features"], d, self._is_classification),
                impurity=params["split_criterion"],
                bootstrap=bool(params["bootstrap"]),
                subsample_rate=float(params["max_samples"]),
                min_instances=float(params["min_samples_leaf"]),
                min_info_gain=float(params["min_impurity_decrease"]),
                tree_ids=tree_ids,
                draw_rows=draw_rows,
            )
            del Xb
            if inputs.spmd:
                state = _gather_trees(inputs.ctx, state, n_trees)
            feature = state["feature"]
            threshold = split_bins_to_thresholds(feature, state["split_bin"], edges_host)
            node_stats = _fill_empty_nodes(feature, state["node_stats"].astype(np.float64))
            return {
                "feature": feature,
                "threshold": threshold,
                "node_stats": node_stats,
                "classes_": classes,
                "num_trees": n_trees,
                "max_depth": max_depth,
                "n_cols": d,
                "dtype": np.dtype(inputs.dtype).name,
            }

        return _fit


def spmd_tree_ids(n_trees: int, nranks: int, rank: int) -> List[int]:
    """The trees rank `rank` grows in a multi-process fit: with tpd =
    ceil(n_trees / nranks), tree r·tpd + t of round t, for the rounds t
    whose place t·nranks + rank in the JAX package's round-major forest
    (round 0 of every rank, then round 1, ...) falls within n_trees."""
    tpd = -(-n_trees // nranks)
    return [rank * tpd + t for t in range(tpd) if t * nranks + rank < n_trees]


def _gather_trees(ctx, state: Dict[str, np.ndarray], n_trees: int) -> Dict[str, np.ndarray]:
    """Every rank's trees (`spmd_tree_ids`), gathered over the process
    group and laid out round-major as the JAX package's forest is: round t
    holds the t-th tree of rank 0, 1, ..., cut at n_trees."""
    out = {}
    for name, v in state.items():
        parts = ctx.group.allgather_arrays(v)
        out[name] = np.stack([parts[r][t] for t in range(-(-n_trees // ctx.nranks)) for r in range(ctx.nranks)
                              if t * ctx.nranks + r < n_trees])
    return out


def _spmd_class_set_and_sketch(inputs: FitInputs, local_classes: np.ndarray, x_host: np.ndarray, seed: int):
    """A multi-process forest's (class set, sketch rows): a classifier's
    union of the ranks' sorted class sets (`allgather_host`), and every
    rank's sketch sample gathered in rank order as float64. A rank with
    more than ``100_000 // nranks`` rows sends that many, drawn (sorted)
    from ``default_rng(seed * 99_991 + rank)``; the others send all of
    theirs, as the JAX package does."""
    ctx = inputs.ctx
    classes = local_classes
    if local_classes.size:  # a classifier's (a regressor has none)
        gathered = inputs.allgather_host(json.dumps(local_classes.tolist()))
        classes = np.unique(np.concatenate([np.asarray(json.loads(g), dtype=np.float64) for g in gathered]))
    cap = 100_000 // ctx.nranks
    n_loc = x_host.shape[0]
    if n_loc > cap:
        sel = np.sort(np.random.default_rng(seed * 99_991 + ctx.rank).choice(n_loc, cap, replace=False))
        part = np.asarray(x_host[sel], dtype=np.float64)
    else:
        part = np.asarray(x_host, dtype=np.float64)
    return classes, inputs.allgather_array(part)


def _fill_empty_nodes(feature: np.ndarray, node_stats: np.ndarray) -> np.ndarray:
    """Propagate parent stats into empty nodes so predict-time rows landing in a
    training-empty branch fall back to the parent distribution."""
    T, M, S = node_stats.shape
    out = node_stats.copy()
    for i in range(1, M):
        parent = (i - 1) // 2
        empty = out[:, i, :].sum(axis=1) == 0
        out[empty, i, :] = out[empty, parent, :]
    return out


def _as_row(value) -> np.ndarray:
    """One feature vector (a Vector or array-like) as a [1, d] host block."""
    v = value.toArray() if isinstance(value, Vector) else np.asarray(value)
    return v[None, :]


class _RandomForestModel(_RandomForestParams, _TpuModelWithColumns):
    """Array-forest model base."""

    _is_classification: bool = False

    def __init__(
        self,
        feature: Optional[np.ndarray] = None,
        threshold: Optional[np.ndarray] = None,
        node_stats: Optional[np.ndarray] = None,
        classes_: Optional[np.ndarray] = None,
        num_trees: int = 0,
        max_depth: int = 0,
        n_cols: int = 0,
        dtype: str = "float32",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            feature=feature, threshold=threshold, node_stats=node_stats, classes_=classes_,
            num_trees=num_trees, max_depth=max_depth, n_cols=n_cols, dtype=dtype,
        )
        self.feature = np.asarray(feature)
        self.threshold = np.asarray(threshold)
        self.node_stats = np.asarray(node_stats)
        self.classes_ = np.asarray(classes_)
        self.num_trees = int(num_trees)
        self.max_depth = int(max_depth)
        self.n_cols = int(n_cols)
        self.dtype = dtype

    @property
    def getNumTrees(self) -> int:  # Spark model exposes this as a property
        return self.num_trees

    @property
    def numFeatures(self) -> int:
        return self.n_cols

    @property
    def totalNumNodes(self) -> int:
        return int(np.sum(self.feature >= 0) * 2 + self.num_trees)

    def setFeaturesCol(self, value):
        return self._set_params(featuresCol=value) if isinstance(value, str) else self._set_params(featuresCols=value)

    def setPredictionCol(self, value: str):
        return self._set_params(predictionCol=value)

    def _leaf_values(self) -> np.ndarray:
        """Per-node output values fed to the traversal (subclass defines)."""
        raise NotImplementedError

    # -- Spark-interop surface: featureImportances, per-tree JSON, debug dump

    def _node_impurity_weight(self, stats: np.ndarray):
        """(impurity [..., M], weight [..., M]) from node stats.

        Classification stats are per-class counts (gini/entropy from the
        distribution); regression stats are (n, Σy, Σy²) (variance)."""
        if self._is_classification:
            tot = stats.sum(axis=-1)
            p = stats / np.maximum(tot[..., None], 1e-30)
            if str(self._solver_params.get("split_criterion")) == "entropy":
                with np.errstate(divide="ignore", invalid="ignore"):
                    plogp = np.where(p > 0, p * np.log2(np.maximum(p, 1e-30)), 0.0)
                imp = -plogp.sum(axis=-1)
            else:  # gini
                imp = 1.0 - (p * p).sum(axis=-1)
            return imp, tot
        n = stats[..., 0]
        mean = stats[..., 1] / np.maximum(n, 1e-30)
        var = stats[..., 2] / np.maximum(n, 1e-30) - mean * mean
        return np.maximum(var, 0.0), n

    @property
    def featureImportances(self) -> DenseVector:
        """Impurity-gain feature importances, Spark semantics: per-node gain
        = w·imp − w_l·imp_l − w_r·imp_r accumulated by split feature,
        normalized per tree, averaged over trees, normalized again."""
        T, M = self.feature.shape
        imp, w = self._node_impurity_weight(self.node_stats.astype(np.float64))
        total = np.zeros(self.n_cols, dtype=np.float64)
        for t in range(T):
            per_tree = np.zeros(self.n_cols, dtype=np.float64)
            for i in range(M):
                f = int(self.feature[t, i])
                l, r = 2 * i + 1, 2 * i + 2
                if f < 0 or r >= M:
                    continue
                gain = w[t, i] * imp[t, i] - w[t, l] * imp[t, l] - w[t, r] * imp[t, r]
                per_tree[f] += max(gain, 0.0)
            s = per_tree.sum()
            if s > 0:
                total += per_tree / s
        s = total.sum()
        return DenseVector(total / s if s > 0 else total)

    def _tree_to_dict(self, t: int, i: int = 0, leaves: Optional[np.ndarray] = None):
        """Nested-dict form of tree `t`. `leaves` is computed once per
        forest and threaded through the recursion."""
        if leaves is None:
            leaves = self._leaf_values()
        M = self.feature.shape[1]
        f = int(self.feature[t, i])
        if f < 0 or 2 * i + 2 >= M:
            value = leaves[t, i]
            return {"leaf_value": [float(v) for v in np.atleast_1d(value)]}
        return {
            "split_feature": f,
            "threshold": float(self.threshold[t, i]),
            "yes": self._tree_to_dict(t, 2 * i + 1, leaves),  # feature <= threshold
            "no": self._tree_to_dict(t, 2 * i + 2, leaves),
        }

    @property
    def trees(self):
        """List of per-tree nested dicts (portable serialization surface)."""
        leaves = self._leaf_values()
        return [self._tree_to_dict(t, 0, leaves) for t in range(self.num_trees)]

    def treesToJson(self) -> List[str]:
        return [json.dumps(t) for t in self.trees]

    def cpu(self):
        raise NotImplementedError(
            f"{type(self).__name__}.cpu() (conversion to a Spark ML forest) is not "
            "in the PyTorch port yet (ROADMAP item A16)"
        )

    def predictLeaf(self, value) -> float:
        raise NotImplementedError(
            f"{type(self).__name__}.predictLeaf (through the converted Spark ML "
            "forest) is not in the PyTorch port yet (ROADMAP item A16)"
        )

    def evaluate(self, dataset):
        raise NotImplementedError(
            f"{type(self).__name__}.evaluate (through the converted Spark ML "
            "forest) is not in the PyTorch port yet (ROADMAP item A16)"
        )

    def toDebugString(self) -> str:
        """Spark-style textual dump of the forest."""
        lines = [
            f"{type(self).__name__}: numTrees={self.num_trees}, "
            f"numFeatures={self.n_cols}, totalNumNodes={self.totalNumNodes}"
        ]

        def walk(node, indent):
            pad = " " * indent
            if "leaf_value" in node:
                vals = node["leaf_value"]
                pretty = vals[0] if len(vals) == 1 else vals
                lines.append(f"{pad}Predict: {pretty}")
                return
            f, thr = node["split_feature"], node["threshold"]
            lines.append(f"{pad}If (feature {f} <= {thr})")
            walk(node["yes"], indent + 1)
            lines.append(f"{pad}Else (feature {f} > {thr})")
            walk(node["no"], indent + 1)

        for t, tree in enumerate(self.trees):
            lines.append(f"  Tree {t} (weight 1.0):")
            walk(tree, 4)
        return "\n".join(lines)

    def _raw_forest_output(self, features) -> np.ndarray:
        """Batched mean-of-leaf-values [n, S] through the shared batching."""
        return self._transform_arrays(features)

    def _get_transform_func(self):
        import torch

        from ..ops.trees import forest_raw_predict
        from ..parallel import default_device, host_tensor

        feature = self.feature.astype(np.int64)
        threshold = self.threshold
        leaves = self._leaf_values()
        max_depth = self.max_depth
        dtype = np.float32 if self._float32_inputs else np.float64

        def construct():
            dev = default_device()
            return (
                host_tensor(feature).to(dev),
                host_tensor(threshold.astype(dtype)).to(dev),
                host_tensor(leaves.astype(dtype)).to(dev),
            )

        def predict(state, xb: torch.Tensor) -> torch.Tensor:
            f, t, lv = state
            return forest_raw_predict(xb, f, t, lv, max_depth=max_depth)

        return construct, predict

    def _serve_workspace_terms(self, bucket_rows_count, itemsize):
        # the descent's [T, rows] node ids, feature ids, gathered values and
        # thresholds, and the [rows, S] running sum of the leaf values
        rows = int(bucket_rows_count)
        T = max(1, self.num_trees)
        S = int(self.node_stats.shape[-1]) if self.node_stats.ndim == 3 else 1
        return {"descent": T * rows * (8 + 8 + 2 * itemsize), "leaf_sum": 2 * rows * S * itemsize}
