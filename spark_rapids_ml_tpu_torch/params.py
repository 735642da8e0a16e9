#
# Parameter system: a Spark-ML-compatible `Param`/`Params` surface, the `Has*`
# shared-param mixins KMeans, NearestNeighbors, PCA, LinearRegression and
# LogisticRegression use, and the declarative Spark-param -> solver-kwarg
# mapping (`_TpuClass` / `_TpuParams`). A copy of the JAX
# package's spark_rapids_ml_tpu/params.py, cut to what this package runs.
# `num_workers` counts devices; this package runs on one.
#
from __future__ import annotations

import uuid
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Mapping, Optional, TypeVar, Union

__all__ = [
    "Param",
    "Params",
    "P",
    "HasInputCol",
    "HasInputCols",
    "HasOutputCol",
    "HasFeaturesCol",
    "HasFeaturesCols",
    "HasLabelCol",
    "HasIDCol",
    "HasPredictionCol",
    "HasProbabilityCol",
    "HasRawPredictionCol",
    "HasWeightCol",
    "HasTol",
    "HasMaxIter",
    "HasRegParam",
    "HasElasticNetParam",
    "HasFitIntercept",
    "HasStandardization",
    "HasSeed",
    "HasEnableSparseDataOptim",
    "_TpuClass",
    "_TpuParams",
]

P = TypeVar("P", bound="Params")


class Param:
    """A named parameter with documentation and an optional type converter.

    Unlike pyspark, `Param` objects here are class attributes declared once per
    mixin/class; the owning instance is resolved at access time, which keeps
    `copy()` trivial (no per-instance param rebinding needed).
    """

    def __init__(self, name: str, doc: str, typeConverter: Optional[Callable[[Any], Any]] = None):
        self.name = name
        self.doc = doc
        self.typeConverter = typeConverter

    def __repr__(self) -> str:
        return f"Param(name={self.name!r}, doc={self.doc!r})"

    def __hash__(self) -> int:
        return hash(self.name)

    def __eq__(self, other) -> bool:
        return isinstance(other, Param) and self.name == other.name


class TypeConverters:
    """Subset of pyspark.ml.param.TypeConverters used by this framework."""

    @staticmethod
    def toInt(v) -> int:
        return int(v)

    @staticmethod
    def toFloat(v) -> float:
        return float(v)

    @staticmethod
    def toBoolean(v) -> bool:
        if isinstance(v, bool):
            return v
        raise TypeError(f"Boolean Param requires value of type bool, got {type(v)}")

    @staticmethod
    def toString(v) -> str:
        return str(v)

    @staticmethod
    def toListString(v) -> List[str]:
        return [str(x) for x in v]

    @staticmethod
    def toListFloat(v) -> List[float]:
        return [float(x) for x in v]

    @staticmethod
    def identity(v):
        return v


class Params:
    """Base class holding user-set and default parameter maps.

    Implements the pyspark `Params` surface consumed by the reference framework
    and its tests: ``hasParam``, ``getParam``, ``isSet``, ``isDefined``,
    ``getOrDefault``, ``set``, ``extractParamMap``, ``copy``, ``explainParams``.
    """

    def __init__(self) -> None:
        self._paramMap: Dict[Param, Any] = {}
        self._defaultParamMap: Dict[Param, Any] = {}
        self.uid = f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"

    # -- param discovery -------------------------------------------------
    @property
    def params(self) -> List[Param]:
        """All Param class attributes of this instance, sorted by name."""
        seen: Dict[str, Param] = {}
        for klass in type(self).__mro__:
            for name, attr in vars(klass).items():
                if isinstance(attr, Param) and attr.name not in seen:
                    seen[attr.name] = attr
        return [seen[k] for k in sorted(seen)]

    def hasParam(self, paramName: str) -> bool:
        return any(p.name == paramName for p in self.params)

    def getParam(self, paramName: str) -> Param:
        for p in self.params:
            if p.name == paramName:
                return p
        raise AttributeError(f"{type(self).__name__} has no param {paramName!r}")

    def _resolveParam(self, param: Union[str, Param]) -> Param:
        return self.getParam(param) if isinstance(param, str) else self.getParam(param.name)

    # -- get/set ---------------------------------------------------------
    def isSet(self, param: Union[str, Param]) -> bool:
        return self._resolveParam(param) in self._paramMap

    def hasDefault(self, param: Union[str, Param]) -> bool:
        return self._resolveParam(param) in self._defaultParamMap

    def isDefined(self, param: Union[str, Param]) -> bool:
        return self.isSet(param) or self.hasDefault(param)

    def getOrDefault(self, param: Union[str, Param]):
        param = self._resolveParam(param)
        if param in self._paramMap:
            return self._paramMap[param]
        return self._defaultParamMap[param]

    def set(self: P, param: Union[str, Param], value: Any) -> P:
        param = self._resolveParam(param)
        if param.typeConverter is not None and value is not None:
            value = param.typeConverter(value)
        self._paramMap[param] = value
        return self

    def _set(self: P, **kwargs: Any) -> P:
        for name, value in kwargs.items():
            self.set(name, value)
        return self

    def _setDefault(self: P, **kwargs: Any) -> P:
        for name, value in kwargs.items():
            self._defaultParamMap[self.getParam(name)] = value
        return self

    def clear(self, param: Union[str, Param]) -> None:
        self._paramMap.pop(self._resolveParam(param), None)

    def extractParamMap(self, extra: Optional[Mapping[Param, Any]] = None) -> Dict[Param, Any]:
        paramMap = dict(self._defaultParamMap)
        paramMap.update(self._paramMap)
        if extra:
            paramMap.update(extra)
        return paramMap

    def explainParam(self, param: Union[str, Param]) -> str:
        param = self._resolveParam(param)
        values = []
        if self.hasDefault(param):
            values.append(f"default: {self._defaultParamMap[param]}")
        if self.isSet(param):
            values.append(f"current: {self._paramMap[param]}")
        return f"{param.name}: {param.doc} ({', '.join(values) if values else 'undefined'})"

    def explainParams(self) -> str:
        return "\n".join(self.explainParam(p) for p in self.params)

    # -- copy ------------------------------------------------------------
    def copy(self: P, extra: Optional[Mapping[Param, Any]] = None) -> P:
        import copy as _copy

        that = _copy.copy(self)
        that._paramMap = dict(self._paramMap)
        that._defaultParamMap = dict(self._defaultParamMap)
        if extra:
            for param, value in extra.items():
                that.set(param, value)
        return that

    def _copyValues(self, to: "Params", extra: Optional[Mapping[Param, Any]] = None) -> "Params":
        paramMap = dict(self._paramMap)
        if extra:
            paramMap.update(extra)
        for param, value in self._defaultParamMap.items():
            if to.hasParam(param.name):
                to._defaultParamMap[to.getParam(param.name)] = value
        for param, value in paramMap.items():
            if to.hasParam(param.name):
                to._paramMap[to.getParam(param.name)] = value
        return to


# ---------------------------------------------------------------------------
# Shared-param mixins (pyspark.ml.param.shared equivalents + reference extras)
# ---------------------------------------------------------------------------


def _mixin(name: str, doc: str, conv, default=None, has_default: bool = True):
    """Build a HasX mixin class with a getX getter (setters live on estimators)."""
    param = Param(name, doc, conv)
    cap = name[0].upper() + name[1:]

    def getter(self):
        return self.getOrDefault(name)

    body: Dict[str, Any] = {name: param, f"get{cap}": getter}

    def __init__(self, *args, **kwargs):  # noqa: N807  (cooperative MRO chain)
        super(cls, self).__init__(*args, **kwargs)
        if has_default:
            self._setDefault(**{name: default})

    body["__init__"] = __init__
    cls = type(f"Has{cap}", (Params,), body)
    return cls


HasInputCol = _mixin("inputCol", "input column name", TypeConverters.toString, has_default=False)
HasInputCols = _mixin("inputCols", "input column names", TypeConverters.toListString, has_default=False)
HasOutputCol = _mixin("outputCol", "output column name", TypeConverters.toString, has_default=False)
HasFeaturesCol = _mixin("featuresCol", "features column name", TypeConverters.toString, default="features")
HasLabelCol = _mixin("labelCol", "label column name", TypeConverters.toString, default="label")
HasPredictionCol = _mixin("predictionCol", "prediction column name", TypeConverters.toString, default="prediction")
HasProbabilityCol = _mixin(
    "probabilityCol", "column for predicted class conditional probabilities", TypeConverters.toString,
    default="probability",
)
HasRawPredictionCol = _mixin(
    "rawPredictionCol", "raw prediction (confidence) column name", TypeConverters.toString,
    default="rawPrediction",
)
HasWeightCol = _mixin("weightCol", "weight column name", TypeConverters.toString, has_default=False)
HasTol = _mixin("tol", "convergence tolerance for iterative algorithms", TypeConverters.toFloat, default=1e-6)
HasMaxIter = _mixin("maxIter", "max number of iterations (>= 0)", TypeConverters.toInt, default=100)
HasRegParam = _mixin("regParam", "regularization parameter (>= 0)", TypeConverters.toFloat, default=0.0)
HasElasticNetParam = _mixin(
    "elasticNetParam", "ElasticNet mixing parameter in [0, 1]; 0=L2, 1=L1", TypeConverters.toFloat, default=0.0
)
HasFitIntercept = _mixin("fitIntercept", "whether to fit an intercept term", TypeConverters.toBoolean, default=True)
HasStandardization = _mixin(
    "standardization", "whether to standardize the training features before fitting", TypeConverters.toBoolean,
    default=True,
)
HasSeed = _mixin("seed", "random seed", TypeConverters.toInt, default=0)


class HasFeaturesCols(Params):
    """Param for a *list* of scalar feature columns (reference params.py:68-88)."""

    featuresCols = Param(
        "featuresCols",
        "features column names for multi-column scalar input",
        TypeConverters.toListString,
    )

    def getFeaturesCols(self) -> List[str]:
        return self.getOrDefault("featuresCols")

    def setFeaturesCols(self: P, value: List[str]) -> P:
        return self._set_params(featuresCols=value)


class HasEnableSparseDataOptim(Params):
    """The CSR ingest switch (reference params.py:44-65): None (default)
    keeps sparse input as CSR where the estimator has a CSR path and
    densifies it elsewhere; True requires sparse input (dense input raises
    ValueError); False densifies it."""

    enable_sparse_data_optim = Param(
        "enable_sparse_data_optim",
        "If None (default) autodetect sparse input; True forces CSR ingest; False forces dense.",
        TypeConverters.identity,
    )

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(enable_sparse_data_optim=None)


class HasIDCol(Params):
    """Param for a row-id column used to join results back (reference params.py:90-110)."""

    idCol = Param("idCol", "id column name for joining results back to input rows", TypeConverters.toString)

    def getIdCol(self) -> str:
        return self.getOrDefault("idCol")

    def setIdCol(self: P, value: str) -> P:
        return self._set_params(idCol=value)


# ---------------------------------------------------------------------------
# Spark-param <-> solver-kwarg translation (reference _CumlClass/_CumlParams)
# ---------------------------------------------------------------------------


class _TpuClass(ABC):
    """Declarative mapping from Spark ML param names/values to solver kwargs.

    Mirrors ``_CumlClass`` (reference params.py:131-212): subclasses declare a
    mapping table instead of writing translation code. A value of ``None`` marks
    the Spark param unsupported (raises when set); ``""`` marks it accepted but
    ignored (not forwarded to the solver).
    """

    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {}

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Union[None, Any]]]:
        """Per-solver-kwarg value translators, e.g. Spark 'euclidean' -> 'l2'."""
        return {}

    @abstractmethod
    def _get_solver_params_default(self) -> Dict[str, Any]:
        """Default solver kwargs (and the set of allowed direct solver params)."""
        raise NotImplementedError


class _TpuParams(_TpuClass, Params):
    """Param-sync layer: keeps `solver_params` consistent with Spark Params.

    Mirrors ``_CumlParams`` (reference params.py:215-361). Constructor-only
    extras carried over from the reference: ``num_workers`` (the number of
    devices a fit uses) and ``float32_inputs``.
    """

    _float32_inputs: bool = True

    def __init__(self) -> None:
        super().__init__()
        self._solver_params: Dict[str, Any] = self._get_solver_params_default()
        self._num_workers: Optional[int] = None
        self._float32_inputs = True

    # -- solver params ----------------------------------------------------
    @property
    def solver_params(self) -> Dict[str, Any]:
        return self._solver_params

    def _set_solver_param(self, name: str, value: Any, silent: bool = False) -> None:
        value_mapping = self._param_value_mapping()
        if name in value_mapping:
            mapped = value_mapping[name](value)
            if mapped is None and value is not None:
                raise ValueError(f"Value {value!r} for parameter {name!r} is not supported by the solver")
            value = mapped
        if name not in self._solver_params and not silent:
            raise ValueError(f"Unknown solver parameter {name!r} for {type(self).__name__}")
        self._solver_params[name] = value

    # -- num_workers ------------------------------------------------------
    @property
    def num_workers(self) -> int:
        return self._num_workers if self._num_workers is not None else self._infer_num_workers()

    @num_workers.setter
    def num_workers(self, value: int) -> None:
        if value is not None and value < 1:
            raise ValueError("num_workers must be >= 1")
        self._num_workers = value

    def _infer_num_workers(self) -> int:
        """One worker per chip of the device pool (`parallel.default_devices`),
        as the JAX package infers it; one under a multi-process TpuContext,
        where each rank drives its own card."""
        from .parallel import spmd_context, visible_device_count

        return 1 if spmd_context() is not None else max(1, visible_device_count())

    @property
    def float32_inputs(self) -> bool:
        return self._float32_inputs

    def _setDefault(self: P, **kwargs: Any) -> P:
        """Also push mapped Spark-param defaults into solver params so the two
        tiers never disagree (a Spark default of regParam=0.0 must beat a
        solver-kwarg default of alpha=1e-4)."""
        super()._setDefault(**kwargs)
        param_map = self._param_mapping()
        for name, value in kwargs.items():
            mapped = param_map.get(name)
            if mapped:  # skip None (unsupported) and "" (dropped)
                try:
                    self._set_solver_param(mapped, value, silent=True)
                except ValueError:
                    pass  # a default value outside the solver's domain stays solver-side
        return self

    # -- the single entry point every setter funnels through --------------
    def _set_params(self: P, **kwargs: Any) -> P:
        """Route kwargs to Spark Params and/or solver params (reference params.py:304-358)."""
        param_map = self._param_mapping()
        for name, value in kwargs.items():
            if name == "num_workers":
                self.num_workers = value
                continue
            if name == "float32_inputs":
                self._float32_inputs = bool(value)
                continue
            if self.hasParam(name):
                self.set(name, value)
                if name in param_map:
                    mapped = param_map[name]
                    if mapped is None:
                        raise ValueError(
                            f"Spark ML param {name!r} is not supported by {type(self).__name__}"
                        )
                    if mapped != "":
                        self._set_solver_param(mapped, value, silent=True)
            elif name in self._solver_params:
                self._set_solver_param(name, value)
            else:
                raise ValueError(f"Unknown parameter {name!r} for {type(self).__name__}")
        return self

    def copy(self: P, extra: Optional[Mapping[Param, Any]] = None) -> P:
        that = super().copy(extra)
        that._solver_params = dict(self._solver_params)
        # re-sync mapped spark-param overrides into the copied solver params
        if extra:
            mapping = self._param_mapping()
            for param, value in extra.items():
                name = param.name if isinstance(param, Param) else param
                mapped = mapping.get(name)
                if mapped:
                    that._set_solver_param(mapped, value, silent=True)
        return that

    def _copy_solver_params(self: P, to: "_TpuParams") -> "_TpuParams":
        to._solver_params = dict(self._solver_params)
        to._num_workers = self._num_workers
        to._float32_inputs = self._float32_inputs
        return to

    # -- input-column resolution (reference params.py:395-428) -------------
    def _get_input_columns(self) -> tuple:
        """Returns (single_col_name, multi_col_names) — exactly one is non-None."""
        input_col, input_cols = None, None
        if self.hasParam("inputCol") and self.isDefined("inputCol"):
            input_col = self.getOrDefault("inputCol")
        elif self.hasParam("inputCols") and self.isDefined("inputCols"):
            input_cols = self.getOrDefault("inputCols")
        elif self.hasParam("featuresCol") and self.isSet("featuresCol"):
            input_col = self.getOrDefault("featuresCol")
        elif self.hasParam("featuresCols") and self.isDefined("featuresCols"):
            input_cols = self.getOrDefault("featuresCols")
        elif self.hasParam("featuresCol") and self.hasDefault("featuresCol"):
            input_col = self.getOrDefault("featuresCol")
        if input_col is None and input_cols is None:
            raise ValueError("Input column(s) must be set via setInputCol(s)/setFeaturesCol(s)")
        return input_col, input_cols
