#
# The device pool of one process, and its row layouts: the port's
# counterpart of the device-pool and row-shard half of
# spark_rapids_ml_tpu/parallel/mesh.py (`set_devices`, `default_devices`,
# `chip_scope`, `get_mesh`, `build_mesh`, `submesh`, `survivor_mesh`,
# `shard_row_slices`). The JAX package's compilation cache, `pcast_varying`
# and `dtype_scope` have no counterpart here: torch compiles nothing ahead
# of a call, and the dtype rides each tensor.
#
# The pool is a list of torch devices; each ENTRY is one chip, and a chip's
# id is its position in the pool, so one device may be named more than once
# (`set_devices(["cpu"] * 8)` is eight chips on the host, the counterpart of
# the JAX tests' eight virtual XLA devices; `["cuda:0", "cuda:0"]` two chips
# on one card). Resolution order, as in the JAX package: the context-local
# `chip_scope` pin, then the `set_devices` pool, then every visible CUDA
# card. Without a card and without a pin, `default_devices()` raises: the
# package runs on the CPU only when asked.
#
# A `Mesh` here is a description, not a sharding: the devices in mesh
# order, their chip ids, the grid's shape and its axis names. One process
# drives a mesh of n chips by running the rank-sharded (SPMD) fit on one
# thread per chip over an in-process group (core.py, parallel/context.py);
# each chip holds its block of `shard_row_slices`, unpadded.
#
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..errors import MeshTopologyError

__all__ = [
    "ROWS_AXIS", "DCN_AXIS", "Mesh", "set_devices", "default_devices", "default_local_device",
    "chip_scope", "current_chip_scope", "current_chip_ids", "get_mesh", "build_mesh", "submesh",
    "survivor_mesh", "shard_row_ranges", "shard_row_slices", "card_groups", "chips_per_card",
]

ROWS_AXIS = "rows"
# the outer axis of a hierarchical mesh: one step per process group
DCN_AXIS = "dcn"

# the `set_devices` pool (None: every visible CUDA card)
_POOL: Optional[List[torch.device]] = None

# the context-local pin: (devices, chip ids), or None. Co-admitted scheduler
# jobs and the chips of one fan-out run on disjoint sets at once, so the pin
# is per thread and task; `set_devices` is process-global.
_CHIP_SCOPE: "contextvars.ContextVar[Optional[Tuple[Tuple[torch.device, ...], Tuple[int, ...]]]]" = (
    contextvars.ContextVar("srml_torch_chip_scope", default=None)
)


@dataclass(frozen=True)
class Mesh:
    """A device layout: `devices` and `chip_ids` flat in mesh order (row
    major over `shape`), and the names of the axes."""

    devices: Tuple[torch.device, ...]
    chip_ids: Tuple[int, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def ids_grid(self) -> np.ndarray:
        """The chip ids as an int array of the mesh's shape."""
        return np.asarray(self.chip_ids, dtype=np.int64).reshape(self.shape)


def set_devices(devices_or_platform: Union[str, torch.device, Sequence, None]) -> None:
    """Set the process's device pool: "cpu", "cuda", "cuda:1" or a
    `torch.device` (a pool of that one device), a list of them (one chip per
    entry; an entry may repeat), or None to go back to every visible card."""
    global _POOL
    if devices_or_platform is None:
        _POOL = None
    elif isinstance(devices_or_platform, (str, torch.device)):
        _POOL = [torch.device(devices_or_platform)]
    else:
        pool = [torch.device(d) for d in devices_or_platform]
        if not pool:
            raise MeshTopologyError("set_devices: an empty device pool", requested=0, available=0)
        _POOL = pool


def _no_device() -> RuntimeError:
    return RuntimeError(
        "no CUDA device is visible, and spark_rapids_ml_tpu_torch runs on "
        "the card unless asked otherwise; call "
        'spark_rapids_ml_tpu_torch.parallel.set_devices("cpu") to run on the CPU'
    )


def _pool_or_cards() -> Optional[List[torch.device]]:
    if _POOL is not None:
        return list(_POOL)
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return None


def default_devices() -> List[torch.device]:
    """The chips a fit may use: the `chip_scope` pin, else the `set_devices`
    pool, else every visible CUDA card. Raises RuntimeError when none
    exists."""
    scoped = _CHIP_SCOPE.get()
    if scoped is not None:
        return list(scoped[0])
    pool = _pool_or_cards()
    if pool is None:
        raise _no_device()
    return pool


def current_chip_ids() -> Tuple[int, ...]:
    """The chip ids of `default_devices()`: the pin's, else the pool's
    positions."""
    scoped = _CHIP_SCOPE.get()
    if scoped is not None:
        return tuple(scoped[1])
    return tuple(range(len(default_devices())))


def card_groups() -> List[Tuple[int, ...]]:
    """The pool's chip ids grouped by the memory they share: the entries
    that name one CUDA card share its memory (``["cuda:0", "cuda:0"]`` is
    one group of two chips); every other entry is a group of its own (the
    CPU entries of a virtual pool are budgeted each on its own, as the JAX
    package's virtual XLA devices are). Empty without a pool and a card."""
    pool = _pool_or_cards()
    groups: Dict[tuple, List[int]] = {}
    for i, d in enumerate(pool or ()):
        key = ("cuda", d.index or 0) if d.type == "cuda" else ("chip", i)
        groups.setdefault(key, []).append(i)
    return [tuple(g) for g in groups.values()]


def chips_per_card(chip_ids: Sequence[int]) -> int:
    """The most of `chip_ids` that share one card's memory (at least 1):
    the number of blocks a fit over those chips puts on one card."""
    want = {int(c) for c in chip_ids}
    return max([len(want.intersection(g)) for g in card_groups()] + [1])


def current_chip_scope() -> Optional[Tuple[torch.device, ...]]:
    """The enclosing `chip_scope` pin's devices, or None (the whole pool)."""
    scoped = _CHIP_SCOPE.get()
    return None if scoped is None else tuple(scoped[0])


def _resolve_ids(devices: Sequence, chip_ids: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """Chip ids of `devices`: the given ones, else each device's position in
    the enclosing pool, matched by identity (a slice of `default_devices()`
    keeps its ids; pool entries may be equal devices), else 0..n-1."""
    if chip_ids is not None:
        ids = tuple(int(c) for c in chip_ids)
        if len(ids) != len(devices):
            raise MeshTopologyError(
                f"chip_scope: {len(ids)} chip ids for {len(devices)} devices",
                requested=len(ids), available=len(devices),
            )
        return ids
    try:
        pool, pool_ids = default_devices(), current_chip_ids()
    except RuntimeError:
        return tuple(range(len(devices)))
    out = []
    for d in devices:
        hit = next((pool_ids[i] for i, p in enumerate(pool) if p is d), None)
        if hit is None:
            return tuple(range(len(devices)))
        out.append(hit)
    return tuple(out)


@contextlib.contextmanager
def chip_scope(devices: Union[Sequence, Mesh], chip_ids: Optional[Sequence[int]] = None) -> Iterator[None]:
    """Pin `default_devices()` to an explicit chip set for the with-block,
    context-locally (each thread and task sees its own pin). `devices` is a
    device list or a `Mesh`; `chip_ids` names the chips (default: the mesh's,
    or each device's position in the enclosing pool)."""
    if isinstance(devices, Mesh):
        devs, ids = tuple(devices.devices), tuple(devices.chip_ids) if chip_ids is None else tuple(chip_ids)
    else:
        devs = tuple(torch.device(d) if not isinstance(d, torch.device) else d for d in devices)
        ids = _resolve_ids(list(devices), chip_ids)
    if not devs:
        raise MeshTopologyError("chip_scope: an empty chip set", requested=0, available=0)
    token = _CHIP_SCOPE.set((devs, ids))
    try:
        yield
    finally:
        _CHIP_SCOPE.reset(token)


def default_local_device() -> torch.device:
    """The first device of `default_devices()`: where a process-local batch
    (a transform, a query block) goes."""
    return default_devices()[0]


def _pool_ids_for(devices: Optional[Sequence]) -> Tuple[List[torch.device], Tuple[int, ...]]:
    if devices is None:
        return default_devices(), current_chip_ids()
    if isinstance(devices, Mesh):
        return list(devices.devices), tuple(devices.chip_ids)
    devs = list(devices)
    return devs, _resolve_ids(devs, None)


def get_mesh(num_workers: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D `rows` mesh over the first `num_workers` devices of `devices`
    (default: `default_devices()`). Refused typed when the count is not
    positive, exceeds the pool, or does not divide it."""
    devs, ids = _pool_ids_for(devices)
    if num_workers is None:
        num_workers = len(devs)
    num_workers = int(num_workers)
    if num_workers <= 0:
        raise MeshTopologyError(
            f"num_workers={num_workers} must be positive", requested=num_workers, available=len(devs),
        )
    if num_workers > len(devs):
        raise MeshTopologyError(
            f"num_workers={num_workers} exceeds visible devices ({len(devs)}); "
            "set num_workers or start more processes",
            requested=num_workers, available=len(devs),
        )
    if len(devs) % num_workers != 0:
        raise MeshTopologyError(
            f"num_workers={num_workers} does not divide the {len(devs)}-device pool evenly; pick a "
            "worker count that divides the device count (or carve an explicit sub-mesh with "
            "submesh()/chip_scope())",
            requested=num_workers, available=len(devs),
        )
    return Mesh(tuple(devs[:num_workers]), tuple(ids[:num_workers]), (num_workers,), (ROWS_AXIS,))


def build_mesh(topology: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """The framework mesh: flat (`get_mesh` over every device) when
    `topology` is empty, else a 2-D ``(dcn, rows)`` mesh for
    ``{"dcn": D, "rows": R}``, either axis 0 or absent meaning "the rest".
    The devices are grouped stably by process (every device of this port is
    its process's, so there is one group). The axis product must cover the
    pool exactly. The topology is the caller's: the port has no config
    knob for it (the JAX package's ``config["mesh_topology"]``), since its
    fan-out runs flat ranks whatever the grid."""
    devs, ids = _pool_ids_for(devices)
    if not topology:
        return get_mesh(len(devs), Mesh(tuple(devs), tuple(ids), (len(devs),), (ROWS_AXIS,)))
    unknown = set(topology) - {DCN_AXIS, ROWS_AXIS}
    if unknown:
        raise MeshTopologyError(
            f"unknown topology axes {sorted(unknown)}; expected {DCN_AXIS!r} and/or {ROWS_AXIS!r}",
            topology={k: int(v) for k, v in topology.items()},
        )
    n_groups = 1  # a torch device belongs to the process that names it
    dcn = int(topology.get(DCN_AXIS) or 0)
    rows = int(topology.get(ROWS_AXIS) or 0)
    if dcn <= 0 and rows <= 0:
        dcn = n_groups
    if dcn <= 0:
        dcn = len(devs) // rows if rows and len(devs) % rows == 0 else 0
    if rows <= 0:
        rows = len(devs) // dcn if dcn and len(devs) % dcn == 0 else 0
    if dcn <= 0 or rows <= 0 or dcn * rows != len(devs):
        raise MeshTopologyError(
            "topology axis product must cover the device pool exactly",
            requested=(dcn * rows) if dcn > 0 and rows > 0 else None,
            available=len(devs),
            topology={DCN_AXIS: dcn, ROWS_AXIS: rows},
        )
    from .. import telemetry

    if telemetry.enabled():
        telemetry.registry().inc("mesh.hierarchical_builds")
    return Mesh(tuple(devs), tuple(ids), (dcn, rows), (DCN_AXIS, ROWS_AXIS))


def submesh(mesh: Mesh, chips: Union[int, Sequence]) -> Mesh:
    """A CONTIGUOUS run of `mesh`'s chips as a 1-D `rows` mesh: the first
    `chips` when an int, else the given mesh-order indices or devices
    (matched by identity). A gapped, empty or out-of-range set is refused
    typed."""
    flat = list(mesh.devices)
    if isinstance(chips, (int, np.integer)):
        n = int(chips)
        if n <= 0 or n > len(flat):
            raise MeshTopologyError(
                f"submesh: cannot carve {n} chips from a {len(flat)}-chip mesh", requested=n, available=len(flat),
            )
        idx = list(range(n))
    else:
        idx = []
        for c in chips:
            if isinstance(c, (int, np.integer)):
                i = int(c)
                if i < 0 or i >= len(flat):
                    raise MeshTopologyError(
                        f"submesh: chip index {i} out of range", requested=i, available=len(flat),
                    )
            else:
                i = next((j for j, d in enumerate(flat) if d is c), None)
                if i is None:
                    raise MeshTopologyError(f"submesh: device {c} is not part of the parent mesh", available=len(flat))
            idx.append(i)
        if not idx:
            raise MeshTopologyError("submesh: empty chip set", requested=0, available=len(flat))
        idx.sort()
        if len(set(idx)) != len(idx) or idx[-1] - idx[0] + 1 != len(idx):
            raise MeshTopologyError(
                f"submesh: chip set {idx} is not a contiguous run in the parent mesh order",
                requested=len(idx), available=len(flat),
            )
    from .. import telemetry

    if telemetry.enabled():
        telemetry.registry().inc("mesh.submesh_carves")
    return Mesh(tuple(flat[i] for i in idx), tuple(mesh.chip_ids[i] for i in idx), (len(idx),), (ROWS_AXIS,))


def survivor_mesh(mesh: Mesh, dead_process_indices) -> Mesh:
    """The mesh over the chips NOT owned by the dead processes. Every chip
    of this port belongs to process 0, so excluding any other process keeps
    the mesh whole (a 2-D mesh keeps its shape) and excluding process 0
    leaves nothing, which raises."""
    dead = {int(p) for p in dead_process_indices}
    if 0 in dead:
        raise MeshTopologyError(
            f"survivor_mesh: no devices remain after excluding processes {sorted(dead)}",
            requested=0, available=0,
        )
    from .. import telemetry

    if telemetry.enabled():
        telemetry.registry().inc("recovery.mesh_rebuilds")
    return mesh


def shard_row_ranges(n: int, n_dev: int) -> List[Tuple[int, int]]:
    """The JAX package's row ranges of `n` rows over `n_dev` chips: equal
    ceil-div blocks ``[i*per, min((i+1)*per, n))``, the last shorter (or
    empty) where JAX pads."""
    n, n_dev = int(n), max(1, int(n_dev))
    per = -(-n // n_dev)
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(n_dev)]


def shard_row_slices(x, n_dev: int) -> Tuple[list, int]:
    """Cut a host row block into `n_dev` pieces over `shard_row_ranges`:
    ``(pieces, n_pad)``, every piece a view of `x` (a dense array, or a
    scipy CSR matrix row slice), the last shorter where the JAX package pads
    it; `n_pad` is the padded row count JAX would place. The port places no
    padding rows."""
    n = int(x.shape[0])
    ranges = shard_row_ranges(n, n_dev)
    n_pad = -(-n // max(1, int(n_dev))) * max(1, int(n_dev))
    return [x[lo:hi] for lo, hi in ranges], n_pad
