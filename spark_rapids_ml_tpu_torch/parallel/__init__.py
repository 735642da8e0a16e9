#
# The one-device layer: which device the package runs on, and the placement
# of host rows on it.
#
# Counterparts in the JAX package: `set_devices` / `default_devices`
# (spark_rapids_ml_tpu/parallel/mesh.py:52), `make_global_rows`
# (parallel/mesh.py:683), the single-controller part of `TpuContext`
# (parallel/context.py:1073), the serving bucket ladder (`bucket_size`,
# `bucket_ladder`, `bucket_rows`, parallel/mesh.py:466-528) and the device
# capacity the admission budgeter reads (memory.py `device_capacity_bytes`).
# Multi-GPU meshes and process groups are ROADMAP item A10.
#
# Entry points run on the CUDA card. The CPU runs only when the caller asks
# for it with `set_devices("cpu")` (the tests do): with no card and no such
# call, `default_device()` raises instead of carrying on quietly on the CPU.
#
from __future__ import annotations

import warnings
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "set_devices", "default_device", "host_tensor", "place_rows", "bucket_size",
    "bucket_ladder", "bucket_rows", "device_capacity_bytes",
]

_DEVICE_OVERRIDE: Optional[torch.device] = None


def set_devices(device: Union[str, torch.device, None]) -> None:
    """Pin the device every entry point runs on: "cpu", "cuda", "cuda:1", a
    `torch.device`, or None to go back to the default (the first CUDA
    card)."""
    global _DEVICE_OVERRIDE
    _DEVICE_OVERRIDE = None if device is None else torch.device(device)


def default_device() -> torch.device:
    """The device a fit or transform runs on: the `set_devices` pin, else the
    first CUDA card. Raises RuntimeError when neither exists."""
    if _DEVICE_OVERRIDE is not None:
        return _DEVICE_OVERRIDE
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError(
        "no CUDA device is visible, and spark_rapids_ml_tpu_torch runs on "
        "the card unless asked otherwise; call "
        'spark_rapids_ml_tpu_torch.parallel.set_devices("cpu") to run on the CPU'
    )


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a contiguous host array, without a copy. Read-only
    arrays (views of another framework's buffers, broadcasts) are wrapped too:
    this package never writes to its inputs."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(np.ascontiguousarray(a))


def place_rows(
    x: np.ndarray, weights: Optional[np.ndarray] = None, *, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Place a host row block on `device` as one contiguous tensor, with its
    row-weight vector (ones when `weights` is None). One device needs no
    padding, so every row is valid."""
    x = np.ascontiguousarray(x)
    w = np.ones(x.shape[0], dtype=x.dtype) if weights is None else np.asarray(weights, dtype=x.dtype)
    return host_tensor(x).to(device), host_tensor(w).to(device)


# ------------------------------------------------------ the bucket ladder ----


def bucket_size(n: int, *, multiple: int = 1, min_rows: int = 256, cap: Optional[int] = None) -> int:
    """Row count of the bucket that batch size `n` pads up to.

    Serving pads every batch to a small GEOMETRIC ladder of row buckets
    (min_rows, 2*min_rows, 4*min_rows, ...) instead of running the exact
    batch shape, so a model sees a few batch shapes whatever the traffic:
    load-time prewarm can launch every kernel of every rung once, and the
    kernels' work per batch is bounded by the rung. Every rung is rounded up
    to `multiple`, and the ladder is capped at `cap` (aligned up) so a
    near-full tail batch reuses the full-batch rung instead of minting one
    more."""
    if multiple < 1:
        multiple = 1
    b = max(min_rows, multiple)
    b = -(-b // multiple) * multiple
    cap_aligned = None
    if cap is not None:
        cap_aligned = -(-max(cap, multiple) // multiple) * multiple
        if n >= cap_aligned:
            return cap_aligned
    while b < n:
        b = -(-(b * 2) // multiple) * multiple
    if cap_aligned is not None:
        b = min(b, cap_aligned)
    return b


def bucket_ladder(
    max_rows: int, *, multiple: int = 1, min_rows: int = 256, cap: Optional[int] = None
) -> List[int]:
    """Every distinct rung `bucket_size` can return for batch sizes
    1..max_rows: exactly what the serving plane's load-time prewarm
    dispatches. Derived by walking `bucket_size` itself (next probe =
    previous rung + 1), so the ladder cannot drift from the padding."""
    max_rows = max(1, int(max_rows))
    rungs: List[int] = []
    n = 1
    while True:
        b = bucket_size(n, multiple=multiple, min_rows=min_rows, cap=cap)
        if rungs and b <= rungs[-1]:
            break  # the cap rung repeats for every larger n
        rungs.append(b)
        if b >= max_rows:
            break
        n = b + 1
    return rungs


def bucket_rows(
    x: np.ndarray, *, multiple: int = 1, min_rows: int = 256, cap: Optional[int] = None
) -> Tuple[np.ndarray, int]:
    """Zero-pad axis 0 of `x` up to its `bucket_size` rung; returns (padded,
    n_valid). Callers slice every output back to `n_valid` rows."""
    b = bucket_size(x.shape[0], multiple=multiple, min_rows=min_rows, cap=cap)
    n = x.shape[0]
    if b == n:
        return x, n
    pad_widths = [(0, b - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_widths), n


# --------------------------------------------------------- device memory ----


def device_capacity_bytes(device: Optional[torch.device] = None) -> Optional[int]:
    """Per-device memory the admission budgeter charges against:
    ``config["hbm_budget_bytes"]`` when set, else the card's TOTAL memory
    (`torch.cuda.get_device_properties(device).total_memory`), else None
    (a CPU device: no budgeting).

    Never the card's free memory: PyTorch's caching allocator keeps freed
    blocks as used, so free memory undercounts what a load can have. What
    other residents hold is subtracted by the admission itself, from the
    shared ledger's reservations (scheduler/ledger.py), as the JAX package
    budgets against its device limit minus the ledger."""
    from ..core import config

    override = config.get("hbm_budget_bytes")
    if override:
        return int(override)
    if device is None or device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)
