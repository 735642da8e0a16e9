#
# Hyperparameter tuning: ParamGridBuilder, CrossValidator and
# TrainValidationSplit with their models, drop-in for `pyspark.ml.tuning`.
# The port's own copy of spark_rapids_ml_tpu/tuning.py, on one device.
#
# Two paths:
#
#   * the multi-fit engine (any `_TpuEstimator` whose models score the
#     evaluator's metric themselves, `_supportsTransformEvaluate`): the whole
#     dataset is ingested and placed once inside a
#     `core.device_dataset_scope`; each fold is a row-weight mask over that
#     placement (w -> w·mask), every fold's param maps solve through
#     `_fit_internal` (one batched grid where the estimator batches), the
#     held-out rows are scored on the device straight from the placement
#     (`_combine` + `_transform_evaluate_arrays`), and the best map's refit
#     reuses the placement once more: numFolds x paramMaps fits, one ingest,
#     one placement;
#   * the per-model fallback (the forests, a Pipeline, a weighted
#     evaluator): one fit and one `evaluator.evaluate(transform)` per (fold,
#     paramMap).
#
# The JAX package has a third, fused per-fold path, for what scores through
# `_combine` but cannot take the engine under multi-process SPMD (sparse
# sweeps, estimators without multi-process fits); on one card every such
# estimator takes the engine, so the port has none (multi-GPU fits are
# ROADMAP A10). Nor has it the sweep's completion
# ledger and its resume after a control-plane failure: nothing on one card
# raises one (A10, A15).
#
# The folds are drawn as the JAX package draws them
# (`np.random.default_rng(seed).permutation(n) % numFolds`, or `foldCol`),
# so both packages train and score the same rows. The multi-process scoring
# gather (`_gather_validation`) and the sweep ledger are later ROADMAP A10
# items: under a multi-process TpuContext both validators refuse, naming
# it; on one card every held-out row is local.
#
from __future__ import annotations

from multiprocessing.pool import ThreadPool
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .core import _TpuEstimator, device_dataset_scope, evaluator_label_column
from .params import Param, Params, TypeConverters


def _rows_of(dataset: Any):
    """The dataset as the engine reads it: a dict as it is (its 2-D feature
    block is placed without a per-row pandas column), anything else as a
    pandas frame. The same object serves every fold, so the placement's
    identity key matches across them."""
    from .data import as_pandas

    return dataset if isinstance(dataset, dict) else as_pandas(dataset)


def _n_rows(data: Any) -> int:
    if isinstance(data, dict):
        first = next(iter(data.values()))
        return int(first.shape[0]) if hasattr(first, "shape") else len(first)
    return len(data)


def _column(data: Any, name: str) -> np.ndarray:
    return np.asarray(data[name].to_numpy() if hasattr(data[name], "to_numpy") else data[name])


def _take_rows(data: Any, idx: np.ndarray) -> Any:
    """The rows `idx` of a dict (each entry indexed: an array or a scipy
    sparse matrix by rows) or a pandas frame."""
    from .data import _is_scipy_sparse

    if isinstance(data, dict):
        return {k: (v[idx] if isinstance(v, np.ndarray) or _is_scipy_sparse(v) else [v[i] for i in idx])
                for k, v in data.items()}
    return data.iloc[idx].reset_index(drop=True)


def _scoring_labels(data, est, eva) -> np.ndarray:
    """Held-out labels for fold scoring; the evaluator's labelCol governs
    (it may differ from the estimator's)."""
    return _column(data, evaluator_label_column(est, eva)).astype(np.float64)


def _held_out_rows(scope, valid_idx: np.ndarray):
    """The held-out rows of a fold, gathered on the device from the
    placement the fold's fit used; a streamed fit placed none, and its
    held-out rows go to the device from the host blocks; CSR rows are
    handed over as their CSR slice."""
    import torch

    from .parallel import host_tensor

    inputs = scope.last.inputs
    feats = scope.last.extracted.features
    if scope.last.extracted.is_sparse:
        # CSR rows stay on the host: the model's scoring densifies them in
        # batches (or multiplies them there, LinearRegression)
        return feats[np.asarray(valid_idx)]
    if inputs.X is None:
        return host_tensor(feats[np.asarray(valid_idx)]).to(inputs.device)
    X = inputs.X
    return X.index_select(0, torch.from_numpy(np.asarray(valid_idx, dtype=np.int64)).to(X.device))


class ParamGridBuilder:
    """Builder for a param grid used in grid search (pyspark.ml.tuning parity)."""

    def __init__(self) -> None:
        self._param_grid: Dict[Param, List[Any]] = {}

    def addGrid(self, param: Param, values: List[Any]) -> "ParamGridBuilder":
        if not isinstance(param, Param):
            raise TypeError("param must be an instance of Param")
        self._param_grid[param] = list(values)
        return self

    def baseOn(self, *args) -> "ParamGridBuilder":
        if isinstance(args[0], dict):
            args = tuple(args[0].items())
        for param, value in args:
            self.addGrid(param, [value])
        return self

    def build(self) -> List[Dict[Param, Any]]:
        grids: List[Dict[Param, Any]] = [{}]
        for key in list(self._param_grid):
            grids = [{**g, key: v} for g in grids for v in self._param_grid[key]]
        return grids


class _ValidatorParams(Params):
    numFolds = Param("numFolds", "number of folds for cross validation (>= 2)", TypeConverters.toInt)
    seed = Param("seed", "random seed for fold assignment", TypeConverters.toInt)
    parallelism = Param("parallelism", "number of threads evaluating folds in parallel", TypeConverters.toInt)
    collectSubModels = Param("collectSubModels", "whether to keep all sub-models", TypeConverters.toBoolean)
    foldCol = Param("foldCol", "optional column with user-specified fold ids", TypeConverters.toString)

    def __init__(self) -> None:
        super().__init__()
        self._estimator: Optional[Any] = None
        self._estimatorParamMaps: Optional[List[Dict[Param, Any]]] = None
        self._evaluator: Optional[Any] = None
        self._setDefault(numFolds=3, seed=0, parallelism=1, collectSubModels=False, foldCol="")

    def _set_init(self, kwargs: Dict[str, Any]) -> None:
        for name in ("estimator", "estimatorParamMaps", "evaluator"):
            if name in kwargs:
                getattr(self, f"set{name[0].upper()}{name[1:]}")(kwargs.pop(name))
        self._set(**kwargs)

    def getEstimator(self):
        return self._estimator

    def setEstimator(self, value):
        self._estimator = value
        return self

    def getEstimatorParamMaps(self):
        return self._estimatorParamMaps

    def setEstimatorParamMaps(self, value):
        self._estimatorParamMaps = value
        return self

    def getEvaluator(self):
        return self._evaluator

    def setEvaluator(self, value):
        self._evaluator = value
        return self

    def getNumFolds(self) -> int:
        return self.getOrDefault("numFolds")

    def setNumFolds(self, value: int):
        return self._set(numFolds=value)

    def setSeed(self, value: int):
        return self._set(seed=value)

    def setParallelism(self, value: int):
        return self._set(parallelism=value)

    def _parts(self):
        est, epm, eva = self.getEstimator(), self.getEstimatorParamMaps(), self.getEvaluator()
        if est is None or epm is None or eva is None:
            raise ValueError("estimator, estimatorParamMaps and evaluator must all be set")
        engine = isinstance(est, _TpuEstimator) and est._supportsTransformEvaluate(eva)
        return est, list(epm), eva, engine


def _best_index(metrics: np.ndarray, eva) -> int:
    return int(np.argmax(metrics) if eva.isLargerBetter() else np.argmin(metrics))


class CrossValidator(_ValidatorParams):
    """K-fold cross validation over a param grid.

    >>> cv = CrossValidator(estimator=lr, estimatorParamMaps=grid, evaluator=ev)
    >>> cv_model = cv.fit(df)
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._set_init(kwargs)

    def _kfold_indices(self, n: int, data) -> List[Tuple[np.ndarray, np.ndarray]]:
        num_folds = self.getNumFolds()
        fold_col = self.getOrDefault("foldCol")
        if fold_col:
            fold_ids = _column(data, fold_col).astype(int)
            if (fold_ids < 0).any() or (fold_ids >= num_folds).any():
                raise ValueError(f"foldCol values must be in [0, {num_folds})")
        else:
            # balanced permutation split: every fold is non-empty for n >=
            # numFolds (a uniform random draw is not)
            if n < num_folds:
                raise ValueError(f"dataset has {n} rows but numFolds={num_folds}")
            fold_ids = np.random.default_rng(self.getOrDefault("seed")).permutation(n) % num_folds
        out = []
        for f in range(num_folds):
            mask = fold_ids == f
            train_idx, valid_idx = np.nonzero(~mask)[0], np.nonzero(mask)[0]
            if len(train_idx) == 0 or len(valid_idx) == 0:
                raise ValueError(f"fold {f} is empty; check foldCol values")
            out.append((train_idx, valid_idx))
        return out

    def fit(self, dataset: Any) -> "CrossValidatorModel":
        from .parallel import refuse_spmd

        refuse_spmd("CrossValidator (the held-out scoring gather and the sweep ledger)")
        est, epm, eva, engine = self._parts()
        data = _rows_of(dataset)
        n = _n_rows(data)
        folds = self._kfold_indices(n, data)
        metrics = np.zeros((len(folds), len(epm)))
        collect_sub = bool(self.getOrDefault("collectSubModels"))
        sub_models: Optional[List[Any]] = [None] * len(folds) if collect_sub else None

        def best_refit():
            return est.copy(epm[_best_index(metrics.mean(axis=0), eva)]).fit(data)

        if engine:
            # every fold solves on the same device, over the same placement:
            # folds run one after another
            labels = _scoring_labels(data, est, eva)
            with device_dataset_scope() as scope:
                for i, (train_idx, valid_idx) in enumerate(folds):
                    mask = np.zeros(n)
                    mask[train_idx] = 1.0
                    models = est._fit_internal(data, epm, row_mask=mask)
                    if collect_sub:
                        sub_models[i] = models
                    metrics[i] = models[0]._combine(models)._transform_evaluate_arrays(
                        _held_out_rows(scope, valid_idx), labels[valid_idx], eva
                    )
                best_model = best_refit()
        else:

            def run_fold(i: int) -> np.ndarray:
                train_idx, valid_idx = folds[i]
                train, valid = _take_rows(data, train_idx), _take_rows(data, valid_idx)
                scores, fold_models = [], []
                for pm in epm:
                    model = est.copy(pm).fit(train)
                    scores.append(float(eva.evaluate(model.transform(valid))))
                    if collect_sub:
                        fold_models.append(model)
                if collect_sub:
                    sub_models[i] = fold_models
                return np.asarray(scores)

            parallelism = min(self.getOrDefault("parallelism"), len(folds))
            if parallelism > 1:
                with ThreadPool(parallelism) as pool:
                    metrics[:] = pool.map(run_fold, range(len(folds)))
            else:
                for i in range(len(folds)):
                    metrics[i] = run_fold(i)
            best_model = best_refit()
        return CrossValidatorModel(
            bestModel=best_model, avgMetrics=list(metrics.mean(axis=0)),
            stdMetrics=list(metrics.std(axis=0)), subModels=sub_models,
        )


class CrossValidatorModel(Params):
    def __init__(self, bestModel=None, avgMetrics=None, stdMetrics=None, subModels=None) -> None:
        super().__init__()
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics or []
        self.stdMetrics = stdMetrics or []
        self.subModels = subModels

    def transform(self, dataset: Any):
        return self.bestModel.transform(dataset)

    # persistence: a composite directory, the metrics in its metadata and
    # one sub-save per model in the model's own format
    def write(self):
        from .core import CompositeWriter

        if self.bestModel is None:
            raise ValueError("CrossValidatorModel has no bestModel to save")

        def children(inst):
            yield "bestModel", inst.bestModel
            for i, fold_models in enumerate(inst.subModels or ()):
                for j, m in enumerate(fold_models):
                    yield f"subModels/fold{i}/model{j}", m

        return CompositeWriter(
            self,
            build_meta=lambda inst: {
                "avgMetrics": [float(v) for v in inst.avgMetrics],
                "stdMetrics": [float(v) for v in inst.stdMetrics],
                "numSubModelFolds": len(inst.subModels) if inst.subModels else 0,
                "numSubModelsPerFold": len(inst.subModels[0]) if inst.subModels else 0,
            },
            iter_children=children,
        )

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def load(cls, path: str) -> "CrossValidatorModel":
        import json
        import os

        from .core import load_instance

        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        sub = None
        if meta.get("numSubModelFolds"):
            sub = [
                [
                    load_instance(os.path.join(path, "subModels", f"fold{i}", f"model{j}"))
                    for j in range(meta["numSubModelsPerFold"])
                ]
                for i in range(meta["numSubModelFolds"])
            ]
        return cls(
            bestModel=load_instance(os.path.join(path, "bestModel")),
            avgMetrics=meta["avgMetrics"], stdMetrics=meta["stdMetrics"], subModels=sub,
        )


class TrainValidationSplit(_ValidatorParams):
    """Single train/validation split over a param grid, with the same two
    paths as CrossValidator (one "fold").

    >>> tvs = TrainValidationSplit(estimator=lr, estimatorParamMaps=grid,
    ...                            evaluator=ev, trainRatio=0.75)
    >>> model = tvs.fit(df)
    """

    trainRatio = Param("trainRatio", "fraction of rows used for training (rest validates)", TypeConverters.toFloat)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(trainRatio=0.75)
        # the fold params mean nothing for a single split
        for dead in ("numFolds", "foldCol"):
            self._defaultParamMap.pop(self.getParam(dead), None)
        self._set_init(kwargs)

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params if p.name not in ("numFolds", "foldCol"))

    def setTrainRatio(self, value: float) -> "TrainValidationSplit":
        return self._set(trainRatio=value)

    def getTrainRatio(self) -> float:
        return self.getOrDefault("trainRatio")

    def fit(self, dataset: Any) -> "TrainValidationSplitModel":
        from .parallel import refuse_spmd

        refuse_spmd("TrainValidationSplit (the held-out scoring gather and the sweep ledger)")
        est, epm, eva, engine = self._parts()
        ratio = float(self.getOrDefault("trainRatio"))
        if not 0.0 < ratio < 1.0:
            raise ValueError(f"trainRatio must be in (0, 1), got {ratio}")
        data = _rows_of(dataset)
        n = _n_rows(data)
        perm = np.random.default_rng(self.getOrDefault("seed")).permutation(n)
        n_train = int(round(ratio * n))
        if n_train == 0 or n_train == n:
            raise ValueError(f"trainRatio={ratio} leaves an empty split for {n} rows")
        if engine:
            # one fold: one placement serves the masked grid fit, the
            # held-out scoring and the final full-data refit
            mask = np.zeros(n)
            mask[perm[:n_train]] = 1.0
            labels = _scoring_labels(data, est, eva)
            valid_idx = perm[n_train:]
            with device_dataset_scope() as scope:
                models = est._fit_internal(data, epm, row_mask=mask)
                metrics = np.asarray(models[0]._combine(models)._transform_evaluate_arrays(
                    _held_out_rows(scope, valid_idx), labels[valid_idx], eva
                ))
                best_model = est.copy(epm[_best_index(metrics, eva)]).fit(data)
        else:
            # parallelism spans param maps here (pyspark TVS semantics)
            train, valid = _take_rows(data, perm[:n_train]), _take_rows(data, perm[n_train:])
            par = min(int(self.getOrDefault("parallelism")), len(epm))

            def fit_score_one(pm):
                model = est.copy(pm).fit(train)
                return float(eva.evaluate(model.transform(valid))), model

            if par > 1:
                with ThreadPool(par) as pool:
                    out = pool.map(fit_score_one, epm)
            else:
                out = [fit_score_one(pm) for pm in epm]
            metrics, models = np.asarray([s for s, _ in out]), [m for _, m in out]
            best_model = est.copy(epm[_best_index(metrics, eva)]).fit(data)
        return TrainValidationSplitModel(
            bestModel=best_model, validationMetrics=list(metrics),
            subModels=list(models) if self.getOrDefault("collectSubModels") else None,
        )


class TrainValidationSplitModel(Params):
    def __init__(self, bestModel=None, validationMetrics=None, subModels=None) -> None:
        super().__init__()
        self.bestModel = bestModel
        self.validationMetrics = validationMetrics or []
        self.subModels = subModels

    def transform(self, dataset: Any):
        return self.bestModel.transform(dataset)

    def write(self):
        from .core import CompositeWriter

        if self.bestModel is None:
            raise ValueError("TrainValidationSplitModel has no bestModel to save")

        def children(inst):
            yield "bestModel", inst.bestModel
            for j, m in enumerate(inst.subModels or ()):
                yield f"subModels/model{j}", m

        return CompositeWriter(
            self,
            build_meta=lambda inst: {
                "validationMetrics": [float(v) for v in inst.validationMetrics],
                "numSubModels": len(inst.subModels) if inst.subModels else 0,
            },
            iter_children=children,
        )

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def load(cls, path: str) -> "TrainValidationSplitModel":
        import json
        import os

        from .core import load_instance

        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        sub = None
        if meta.get("numSubModels"):
            sub = [load_instance(os.path.join(path, "subModels", f"model{j}")) for j in range(meta["numSubModels"])]
        return cls(
            bestModel=load_instance(os.path.join(path, "bestModel")),
            validationMetrics=meta["validationMetrics"], subModels=sub,
        )
