#
# Core execution framework on one device: the estimator and model bases, the
# fit driver, batched transform, the resident predict handle the serving
# plane keeps per model (`PredictProgram`), and persistence. The PyTorch
# counterpart of the parts of spark_rapids_ml_tpu/core.py that the KMeans,
# kNN, PCA, LinearRegression and LogisticRegression fits, their transforms,
# save/load and the serving plane run.
#
# Call stack (the JAX package's, without telemetry, admission, recovery,
# streaming and the mesh): fit(dataset) -> _fit_internal -> _call_fit_func ->
# [extract columns (data.py) -> place rows on the device (parallel) ->
# per-algorithm fit closure] -> _create_model.
#
# Persistence keeps the JAX package's on-disk layout exactly:
# metadata.json + arrays.npz + attributes.json, so a directory saved by
# either package loads in the other.
#
from __future__ import annotations

import json
import os
import shutil
from abc import abstractmethod
from collections import namedtuple
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .data import ExtractedData, as_pandas, extract_dataset
from .linalg import DenseVector
from .params import _TpuParams

# Framework configuration: the keys this package reads (the JAX package's
# `config` holds many more; they arrive with the layers that read them).
config: Dict[str, Any] = {
    # rows per transform batch copied to the device at once
    "max_records_per_batch": 1 << 16,
    # rows per tile of the predict-side argmin scan (ops/distance.py)
    "distance_tile_rows": 4096,
    # default precision of the solvers' hot products: "f32" keeps the input
    # precision, "bf16" runs bf16 inputs with float32 accumulation; the
    # per-estimator `solver_precision` solver param overrides it.
    # Seeded from SRML_SOLVER_PRECISION.
    "solver_precision": os.environ.get("SRML_SOLVER_PRECISION") or "f32",
    # --- memory admission (memory.py) -------------------------------------
    # per-device memory override for the admission budgeter; None = the
    # card's total memory (a CPU device has none: loads go unbudgeted)
    "hbm_budget_bytes": None,
    # fraction of the capacity kept out of the budget, for allocator
    # fragmentation and transient buffers: budget = capacity * (1 - this)
    "hbm_headroom_fraction": 0.1,
    # smallest rung of the bucket ladder: serving and transform batches pad
    # up a geometric (x2) ladder of row counts starting here
    "transform_bucket_min_rows": 256,
    # --- serving plane (serving/) -------------------------------------------
    # how long the ScoringEngine holds a dispatched request open for
    # same-model coalescing: the latency/throughput knob; 0 disables
    # coalescing entirely
    "serve_coalesce_window_ms": 2.0,
    # row cap of one coalesced serving batch (and of a resident model's
    # bucket ladder); larger requests split across dispatches
    "serve_max_batch_rows": 8192,
    # load-time prewarm: every ladder rung up to this many rows is dispatched
    # once at load (state placed, every kernel built and launched), so a
    # resident model's first query pays neither; 0 disables prewarm
    "serve_prewarm_rows": 4096,
    # server-side deadline of every submit() that passes none: an expired
    # request never dispatches (RequestTimeoutError), and admission refuses a
    # request whose deadline the live queue-wait p99 predicts unmeetable
    # (ServeOverloadError). Monotonic clock. 0 disables the default deadline.
    "serve_default_deadline_ms": 30000.0,
    # bounded request queue: total rows queued in the ScoringEngine at most
    "serve_max_queue_rows": 262144,
    # adaptive micro-batching: under congestion (queue-wait p99 above the
    # static window) the coalesce window and row target follow the arrival
    # rate, between the floor and the ceiling; uncongested traffic keeps the
    # static window exactly
    "serve_adaptive_batching": True,
    "serve_coalesce_window_floor_ms": 0.5,
    "serve_coalesce_window_ceiling_ms": 20.0,
    # the degraded serving rung of the backpressure ladder: not in the port
    # yet (ROADMAP A13); a value other than None is refused at load
    "serve_degraded_dtype": None,
    # rolling-window geometry of the telemetry registry (rates and windowed
    # quantiles the overload controller reads)
    "metrics_bucket_seconds": 10.0,
    "metrics_bucket_count": 18,
}


def resolve_solver_precision(params: Optional[Dict[str, Any]] = None) -> str:
    """Effective solver precision for ONE fit: the estimator's
    ``solver_precision`` solver-param when set (per-estimator override),
    else ``config["solver_precision"]``. Returns "f32" or "bf16"; anything
    else raises ValueError naming the knob."""
    value = params.get("solver_precision") if params else None
    if value is None:
        value = config.get("solver_precision") or "f32"
    value = str(value).lower()
    if value not in ("f32", "bf16"):
        raise ValueError(
            f"solver_precision must be 'f32' or 'bf16', got {value!r}"
        )
    return value


# Internal column aliases (reference core.py:333): `row_number` names the id
# column kNN adds when the caller set no idCol.
alias = namedtuple("alias", ("row_number",))("unique_id")


@dataclass
class FitInputs:
    """Device-resident inputs handed to every algorithm's fit function: the
    rows as one tensor on one device, their weights, and their labels for
    a supervised estimator."""

    X: torch.Tensor  # [n, d]
    w: torch.Tensor  # [n]
    n_valid: int
    n_cols: int
    dtype: Any  # numpy dtype of X
    device: torch.device
    y: Optional[torch.Tensor] = None  # [n] at X's dtype; None = unsupervised


FitFunc = Callable[[FitInputs, Dict[str, Any]], Dict[str, Any]]
# (construct() -> device state, predict(state, device batch) -> device
# tensor, or a tuple of them)
TransformFuncs = Tuple[Callable[[], Any], Callable[[Any, torch.Tensor], Any]]


class _TpuCommon(_TpuParams):
    """Input pre-processing shared by estimators (fit side) and models
    (transform side)."""

    # a supervised estimator's fit reads its labelCol
    _supervised: bool = False

    def _pre_process_data(self, dataset: Any, for_fit: bool = True) -> ExtractedData:
        """Column selection + dense extraction (features; labels and weights
        on the fit side; row ids wherever the estimator has an idCol)."""
        if self.hasParam("enable_sparse_data_optim") and self.getOrDefault("enable_sparse_data_optim") is True:
            raise NotImplementedError(
                "enable_sparse_data_optim=True (the CSR ingest path) is not in the "
                "PyTorch port yet (ROADMAP item A11: memory admission, out-of-core, sparse)"
            )
        input_col, input_cols = self._get_input_columns()
        label_col = None
        if for_fit and self._supervised:
            label_col = self.getOrDefault("labelCol")
        weight_col = None
        if (
            for_fit
            and self.hasParam("weightCol")
            and self.isDefined("weightCol")
        ):
            weight_col = self.getOrDefault("weightCol")
        id_col = None
        if self.hasParam("idCol") and self.isDefined("idCol"):
            id_col = self.getOrDefault("idCol")
        extracted = extract_dataset(
            dataset,
            input_col=input_col,
            input_cols=input_cols,
            label_col=label_col,
            weight_col=weight_col,
            id_col=id_col,
            float32_inputs=self._float32_inputs,
        )
        if for_fit and extracted.n_rows == 0:
            raise RuntimeError("Dataset is empty — cannot fit")
        return extracted


class _TpuCaller(_TpuCommon):
    """Fit orchestration: extraction, placement, one solver call."""

    # portable warm-start payload for the NEXT fit call (set by
    # _TpuEstimator.fit(..., warm_start_from=...), consumed by the
    # per-estimator fit closures, cleared in fit's finally)
    _warm_start: Any = None

    def _build_fit_inputs(self, extracted: ExtractedData, device: torch.device) -> FitInputs:
        """Place the host rows, their weights and their labels on `device` as
        one tensor each."""
        from .parallel import host_tensor, place_rows

        dtype = np.float32 if self._float32_inputs else np.float64
        X, w = place_rows(
            extracted.features.astype(dtype, copy=False), extracted.weight, device=device
        )
        y = None
        if extracted.label is not None:
            y = host_tensor(extracted.label.astype(dtype, copy=False)).to(device)
        return FitInputs(
            X=X, w=w, n_valid=extracted.n_rows, n_cols=extracted.n_cols,
            dtype=dtype, device=device, y=y,
        )

    @abstractmethod
    def _get_tpu_fit_func(self, extracted: ExtractedData) -> FitFunc:
        """Per-algorithm fit closure factory."""
        raise NotImplementedError

    def _call_fit_func(self, dataset: Any) -> Dict[str, Any]:
        """Extract, place, solve: returns the model-attribute dict."""
        from .parallel import default_device

        if self.num_workers > 1:
            raise NotImplementedError(
                f"num_workers={self.num_workers}: the PyTorch port fits on one "
                "device (multi-GPU is ROADMAP item A10)"
            )
        device = default_device()
        extracted = self._pre_process_data(dataset)
        inputs = self._build_fit_inputs(extracted, device)
        fit_func = self._get_tpu_fit_func(extracted)
        return fit_func(inputs, dict(self._solver_params))


class _TpuEstimator(_TpuCaller):
    """Estimator base."""

    def fit(self, dataset: Any, params: Optional[Dict] = None, warm_start_from: Any = None):
        """Fit on `dataset`. `params` is one param map applied to a copy of
        this estimator. `warm_start_from` seeds the solver from a previous
        result's iterate (a fitted model of the same family) instead of a
        cold init."""
        if isinstance(params, (list, tuple)):
            raise NotImplementedError(
                "fit with a list of param maps (fitMultiple) is not in the "
                "PyTorch port yet (ROADMAP item A9)"
            )
        if isinstance(params, dict) and params:
            return self.copy(params).fit(dataset, warm_start_from=warm_start_from)
        if warm_start_from is not None:
            self._warm_start = self._resolve_warm_start(warm_start_from)
        try:
            return self._fit_internal(dataset)
        finally:
            self._warm_start = None

    def _resolve_warm_start(self, source: Any) -> Dict[str, Any]:
        """Per-estimator hook: the portable warm-start payload of `source`."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support warm_start_from"
        )

    def _fit_internal(self, dataset: Any) -> "_TpuModel":
        attrs = self._call_fit_func(dataset)
        model = self._create_model(attrs)
        model._model_attributes = attrs
        self._copyValues(model)
        self._copy_solver_params(model)
        return model

    @abstractmethod
    def _create_model(self, attrs: Dict[str, Any]) -> "_TpuModel":
        raise NotImplementedError

    # persistence ---------------------------------------------------------
    def write(self) -> "_TpuWriter":
        return _TpuWriter(self)

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def read(cls) -> "_TpuReader":
        return _TpuReader(cls)

    @classmethod
    def load(cls, path: str):
        return cls.read().load(path)


class _TpuEstimatorSupervised(_TpuEstimator):
    """Estimator base of the supervised estimators: the fit extracts the
    labelCol beside the features and places it as `FitInputs.y`."""

    _supervised = True


class _TpuModel(_TpuCommon):
    """Model base."""

    def __init__(self, **model_attrs: Any) -> None:
        super().__init__()
        self._model_attributes: Dict[str, Any] = model_attrs
        # the serving plane's stamps: why the model is (or is no longer)
        # resident, set by serving.ModelRegistry
        self._serve_metrics: Dict[str, Any] = {}

    def transform(self, dataset: Any):
        raise NotImplementedError

    # serving hooks -------------------------------------------------------
    # The per-model surface the serving plane composes: a resident
    # PredictProgram factory, plus the placement / per-bucket workspace byte
    # terms the admission budgeter (memory.admit_model_load) charges.

    # serving dtypes this model accepts; the distance-core models extend
    # with "bf16"
    _serve_dtypes: tuple = (None, "float32", "float64")

    def _serve_program(
        self, serve_dtype: Optional[str] = None, *, cap: Optional[int] = None
    ) -> "PredictProgram":
        """Resident predict handle for the serving plane. Models without a
        batched predict surface have nothing to keep resident."""
        raise NotImplementedError(
            f"{type(self).__name__} has no serving hook (no batched predict "
            "surface to keep resident)"
        )

    def _serve_check(self, serve_dtype: Optional[str] = None) -> None:
        """Cheap serveability preflight: raises exactly what `_serve_program`
        would, WITHOUT placing anything on the device. The registry runs it
        before its admission/eviction loop, so a load that can never succeed
        cannot evict resident models as a side effect."""
        if type(self)._serve_program is _TpuModel._serve_program:
            self._serve_program(serve_dtype)  # the standard NotImplementedError
        if serve_dtype not in self._serve_dtypes:
            raise ValueError(
                f"{type(self).__name__} serves at its fit dtype; "
                f"serve_dtype={serve_dtype!r} is only available on the "
                "distance-core models"
            )
        self._serve_n_cols()

    def _serve_n_cols(self) -> int:
        """Feature width the serving plane prewarms and validates against."""
        n = int(getattr(self, "n_cols", 0) or 0)
        if n <= 0:
            raise ValueError(
                f"{type(self).__name__} does not know its feature width; "
                "cannot prewarm the serving ladder"
            )
        return n

    def _serve_placement_terms(self) -> Dict[str, int]:
        """Per-device bytes of this model's RESIDENT state (what
        `construct()` places), as named terms for the admission budgeter.
        Default: every array model attribute at the working dtype."""
        itemsize = 4 if self._float32_inputs else 8
        total = 0
        for v in self._model_attributes.values():
            if isinstance(v, np.ndarray):
                total += int(v.size) * itemsize
            elif isinstance(v, (list, tuple)) and v and isinstance(v[0], np.ndarray):
                total += sum(int(a.size) for a in v) * itemsize
        return {"placement.params": total}

    def _serve_workspace_terms(
        self, bucket_rows_count: int, itemsize: int
    ) -> Dict[str, int]:
        """Bytes live during ONE dispatched batch of `bucket_rows_count` rows
        beyond the model state and the batch itself. {} = none modeled."""
        return {}

    # persistence ---------------------------------------------------------
    def write(self) -> "_TpuWriter":
        return _TpuWriter(self)

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def read(cls) -> "_TpuReader":
        return _TpuReader(cls)

    @classmethod
    def load(cls, path: str):
        return cls.read().load(path)


class PredictProgram:
    """Resident, reusable predict handle: construct the device state once,
    pad every host batch up the geometric bucket ladder, run `predict` on the
    device, slice the outputs back.

    Two consumers share it so they cannot drift: `_transform_arrays` builds a
    short-lived one per transform call, and the serving plane
    (`serving/`) holds one per RESIDENT model for its registry lifetime.

      * `dispatch(xb)` pads a host batch UP its ladder rung
        (`parallel.bucket_rows`), copies it to the device and runs `predict`;
        it fetches nothing back, and returns the device outputs;
      * `fetch(result, n_valid)` is the one device-to-host copy, slicing
        every output back to the valid rows;
      * `prewarm(...)` dispatches zeros through every ladder rung, so every
        kernel of every rung is built and launched at load time, not at the
        first query.

    `predict` is row-parallel: padding rows cannot change the valid rows'
    outputs, so a request's answer does not depend on the rung it lands on.
    The top-k merge of the kNN models reads a count back from the device
    once per item block (ops/distance.py `_smallest_columns`), so their
    `dispatch` returns with the last block's work still in flight, not all
    of it."""

    def __init__(
        self,
        model: "_TpuModel",
        *,
        construct: Optional[Callable[[], Any]] = None,
        predict: Optional[Callable[[Any, torch.Tensor], Any]] = None,
        cap: Optional[int] = None,
    ) -> None:
        from .parallel import default_device

        if construct is None or predict is None:
            c0, p0 = model._get_transform_func()
            construct = construct or c0
            predict = predict or p0
        self.model = model
        self.predict_fn = predict
        self.device = default_device()
        self.cap = int(cap) if cap else int(config["max_records_per_batch"])
        self.bucket_min = int(config["transform_bucket_min_rows"])
        self.dtype = np.float32 if model._float32_inputs else np.float64
        self.state = construct()
        # bucketed shapes already dispatched: what the engine's
        # `serve.bucket_hits` counter reads
        self._shapes_seen: set = set()
        self.last_dispatch_new_shape: bool = False

    def ladder(self, max_rows: Optional[int] = None) -> List[int]:
        """The rungs batches of 1..max_rows pad up to: what `prewarm`
        dispatches."""
        from .parallel import bucket_ladder

        return bucket_ladder(
            min(int(max_rows), self.cap) if max_rows else self.cap,
            min_rows=self.bucket_min,
            cap=self.cap,
        )

    def dispatch(self, xb: np.ndarray) -> Tuple[Any, int]:
        """Pad one host batch up its rung, place it and run `predict`; no
        device-to-host copy. Returns (device outputs, valid row count). A
        zero-row batch still dispatches one rung, so multi-output models
        yield one correctly shaped empty array per output at `fetch`."""
        from .parallel import bucket_rows, host_tensor

        xp, n_valid = bucket_rows(
            np.asarray(xb, dtype=self.dtype), min_rows=self.bucket_min, cap=self.cap
        )
        sig = tuple(xp.shape)
        self.last_dispatch_new_shape = sig not in self._shapes_seen
        self._shapes_seen.add(sig)
        return self.predict_fn(self.state, host_tensor(xp).to(self.device)), n_valid

    def fetch(self, result: Any, n_valid: int) -> Any:
        """THE device-to-host copy: every output sliced to the valid rows,
        as numpy arrays."""
        from . import telemetry

        with telemetry.device_wait("predict_fetch", self.device):
            if isinstance(result, tuple):
                return tuple(r[:n_valid].cpu().numpy() for r in result)
            return result[:n_valid].cpu().numpy()

    def prewarm(self, n_cols: int, *, max_rows: Optional[int] = None) -> int:
        """Dispatch a zeros batch through every ladder rung up to `max_rows`
        rows and wait for it, so the kernels are built and every rung's
        buffers have been allocated once before the first query. Returns the
        rung count."""
        rungs = self.ladder(max_rows)
        for r in rungs:
            result, _ = self.dispatch(np.zeros((r, int(n_cols)), dtype=self.dtype))
            self.fetch(result, 0)
        return len(rungs)


class _TpuModelWithColumns(_TpuModel):
    """Transform = append prediction column(s), batched over rows.

    `construct` runs once per transform (model attributes -> device state);
    `predict` runs per batch of at most ``config["max_records_per_batch"]``
    rows, each copied to the device in turn, so device memory holds one
    batch at a time whatever the dataset's size."""

    @abstractmethod
    def _get_transform_func(self) -> TransformFuncs:
        raise NotImplementedError

    def _serve_program(
        self, serve_dtype: Optional[str] = None, *, cap: Optional[int] = None
    ) -> PredictProgram:
        """Default serving hook: the model's own (construct, predict) pair as
        a resident PredictProgram."""
        self._serve_check(serve_dtype)
        return PredictProgram(self, cap=cap)

    @abstractmethod
    def _out_column_names(self) -> List[str]:
        """Names of the appended columns."""
        raise NotImplementedError

    def _transform_arrays(self, features: np.ndarray) -> Any:
        """Batched predict over a host feature block, through a short-lived
        PredictProgram: each batch is padded up the bucket ladder,
        dispatched, fetched and sliced back, as the serving plane does. The
        outputs of the batches are concatenated (per output, for a tuple). A
        zero-row block still runs one batch, so the output keeps the type
        and arity `predict` gives it."""
        n = features.shape[0]
        batch = int(config["max_records_per_batch"])
        program = PredictProgram(self, cap=batch)
        outs = []
        for start in range(0, n, batch) if n else (0,):
            result, n_valid = program.dispatch(features[start:min(start + batch, n)])
            outs.append(program.fetch(result, n_valid))
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate(parts, axis=0) for parts in zip(*outs))
        return np.concatenate(outs, axis=0)

    def transform(self, dataset: Any):
        pdf = as_pandas(dataset)
        extracted = self._pre_process_data(dataset, for_fit=False)
        result = self._transform_arrays(extracted.features)
        out = pdf.copy(deep=False)
        names = self._out_column_names()
        for name, vals in self._split_output(result, names, extracted).items():
            out[name] = vals
        return out

    def _split_output(
        self, result: np.ndarray, names: List[str], extracted: ExtractedData
    ) -> Dict[str, Any]:
        """Map raw predict output to output columns: a 1-D result is one
        scalar column; a 2-D result is one vector column, of DenseVectors
        when the input features were vectors, else of per-row arrays."""
        name = names[0]
        if result.ndim > 1:
            if extracted.feature_kind == "vector":
                return {name: [DenseVector(row) for row in result]}
            return {name: list(result)}
        return {name: result}


# ---------------------------------------------------------------------------
# Persistence: metadata JSON + npz array sidecar (the JAX package's layout).
# ---------------------------------------------------------------------------


def _prepare_save_path(path: str, overwrite: bool) -> None:
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(f"Path {path} already exists; use write().overwrite().save()")
        shutil.rmtree(path)
    os.makedirs(path)


class _TpuWriter:
    def __init__(self, instance: Union[_TpuEstimator, _TpuModel]):
        self.instance = instance
        self._overwrite = False

    def overwrite(self) -> "_TpuWriter":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        inst = self.instance
        _prepare_save_path(path, self._overwrite)
        metadata = {
            "class": f"{type(inst).__module__}.{type(inst).__qualname__}",
            "uid": inst.uid,
            "paramMap": {p.name: v for p, v in inst._paramMap.items() if _jsonable(v)},
            "defaultParamMap": {p.name: v for p, v in inst._defaultParamMap.items() if _jsonable(v)},
            "solver_params": {k: v for k, v in inst._solver_params.items() if _jsonable(v)},
            "num_workers": inst._num_workers,
            "float32_inputs": inst._float32_inputs,
            "is_model": isinstance(inst, _TpuModel),
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2)
        if isinstance(inst, _TpuModel):
            self._write_model_attributes(inst, path)

    def _write_model_attributes(self, inst: "_TpuModel", path: str) -> None:
        """npz bundle of the array attributes + JSON of the scalars."""
        arrays = {}
        scalars = {}
        for k, v in inst._model_attributes.items():
            if isinstance(v, np.ndarray):
                arrays[k] = v
            elif isinstance(v, (list, tuple)) and len(v) and isinstance(v[0], np.ndarray):
                for i, a in enumerate(v):
                    arrays[f"{k}__list{i}"] = a
                scalars[f"{k}__listlen"] = len(v)
            else:
                scalars[k] = v
        np.savez(os.path.join(path, "arrays.npz"), **arrays)
        with open(os.path.join(path, "attributes.json"), "w") as f:
            json.dump(scalars, f, default=_np_default)


class _TpuReader:
    def __init__(self, cls: type):
        self.cls = cls

    def load(self, path: str):
        with open(os.path.join(path, "metadata.json")) as f:
            metadata = json.load(f)
        cls = self.cls
        if metadata["is_model"]:
            attrs = self._read_model_attributes(path)
            inst = cls(**attrs)
            inst._model_attributes = attrs
        else:
            inst = cls()
        self._restore_params(inst, metadata)
        return inst

    def _read_model_attributes(self, path: str) -> Dict[str, Any]:
        """Inverse of `_TpuWriter._write_model_attributes`."""
        scalars: Dict[str, Any] = {}
        attrs_path = os.path.join(path, "attributes.json")
        if os.path.exists(attrs_path):
            with open(attrs_path) as f:
                scalars = json.load(f)
        arrays_path = os.path.join(path, "arrays.npz")
        attrs: Dict[str, Any] = {}
        if os.path.exists(arrays_path):
            with np.load(arrays_path, allow_pickle=False) as npz:
                attrs.update({k: npz[k] for k in npz.files})
        # reassemble list-of-array attributes
        list_lens = {k[: -len("__listlen")]: v for k, v in scalars.items() if k.endswith("__listlen")}
        for base, ln in list_lens.items():
            attrs[base] = [attrs.pop(f"{base}__list{i}") for i in range(ln)]
            scalars.pop(f"{base}__listlen")
        attrs.update(scalars)
        return attrs

    def _restore_params(self, inst: Any, metadata: Dict[str, Any]) -> None:
        for name, v in metadata["defaultParamMap"].items():
            if inst.hasParam(name):
                inst._defaultParamMap[inst.getParam(name)] = v
        for name, v in metadata["paramMap"].items():
            if inst.hasParam(name):
                inst._paramMap[inst.getParam(name)] = v
        inst._solver_params.update(metadata["solver_params"])
        inst._num_workers = metadata["num_workers"]
        inst._float32_inputs = metadata["float32_inputs"]
        inst.uid = metadata["uid"]
        return inst


def _jsonable(v: Any) -> bool:
    try:
        json.dumps(v, default=_np_default)
        return True
    except (TypeError, ValueError):
        return False


def _np_default(o: Any):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
