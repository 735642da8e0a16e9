#
# The device layer: which devices the package runs on, and the placement of
# host rows on them.
#
# Counterparts in the JAX package: the device pool and its row layouts
# (`set_devices`, `default_devices`, `chip_scope`, `get_mesh`,
# `build_mesh`, `submesh`, `survivor_mesh`, `shard_row_slices`;
# spark_rapids_ml_tpu/parallel/mesh.py, here in mesh.py), `make_global_rows`
# (parallel/mesh.py:683), the out-of-core fits' double-buffered pipeline
# (`stream_place_blocks`, parallel/mesh.py:618), the single-controller part
# of `TpuContext` (parallel/context.py:1073), the serving bucket ladder
# (`bucket_size`, `bucket_ladder`, `bucket_rows`, parallel/mesh.py:466-528)
# and the device capacity the admission budgeter reads (memory.py
# `device_capacity_bytes`). The multi-process control plane, the process
# group and the in-process group one process drives several chips with
# (`TpuContext`, the rendezvous substrates, `LocalGroup`,
# `PartitionDescriptor`) are in context.py and partition.py; the fan-out of
# a fit or transform over the chips is core.py's.
#
# Entry points run on the CUDA card. The CPU runs only when the caller asks
# for it with `set_devices("cpu")` (or a pool of CPU entries, the tests'
# `set_devices(["cpu"] * 8)`): with no card and no such call,
# `default_device()` raises instead of carrying on quietly on the CPU.
#
from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "set_devices", "default_device", "host_tensor", "place_rows", "StreamStaging",
    "stream_place_blocks", "bucket_size", "bucket_ladder", "bucket_rows", "device_capacity_bytes",
    "device_allocatable_bytes", "PartitionDescriptor", "TpuContext", "Rendezvous", "LocalRendezvous",
    "FileRendezvous", "BarrierRendezvous", "ChaosRendezvous", "allgather_ndarray", "visible_device_count",
    "refuse_devices_per_rank", "refuse_spmd", "spmd_context", "LocalGroup", "Mesh", "default_devices",
    "default_local_device", "chip_scope", "current_chip_scope", "current_chip_ids", "get_mesh", "build_mesh",
    "submesh", "survivor_mesh", "shard_row_ranges", "shard_row_slices", "fan_out_width", "run_on_chips",
    "InProcessRendezvous", "card_groups",
]

from .chaos import ChaosRendezvous  # noqa: E402
from .context import (  # noqa: E402
    BarrierRendezvous,
    FileRendezvous,
    InProcessRendezvous,
    LocalGroup,
    LocalRendezvous,
    Rendezvous,
    TpuContext,
    allgather_ndarray,
)
from .mesh import (  # noqa: E402
    Mesh,
    build_mesh,
    card_groups,
    chip_scope,
    current_chip_ids,
    current_chip_scope,
    default_devices,
    default_local_device,
    get_mesh,
    set_devices,
    shard_row_ranges,
    shard_row_slices,
    submesh,
    survivor_mesh,
)
from .partition import PartitionDescriptor  # noqa: E402

def default_device() -> torch.device:
    """The device a fit or transform runs on: the first chip of the
    `chip_scope` pin or the `set_devices` pool, else the current CUDA card.
    Raises RuntimeError when none exists."""
    from . import mesh

    if mesh.current_chip_scope() is not None or mesh._POOL is not None:
        return mesh.default_local_device()
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise mesh._no_device()


def visible_device_count() -> int:
    """The chips one process could drive: the pin's, else the pool's, else
    the visible CUDA cards' (1 with none of them)."""
    try:
        return len(default_devices())
    except RuntimeError:
        return 1


def fan_out_width(num_workers: int) -> int:
    """The chips a fit or transform with `num_workers` fans out over in
    this process, as the JAX package sizes its mesh
    (``min(num_workers, len(default_devices()))``, core.py:1442): 1 under a
    multi-process TpuContext (each rank drives its own card) and inside a
    chip's own thread (its pin holds one chip). The count must divide the
    pool (`get_mesh`'s typed refusal)."""
    if spmd_context() is not None:
        return 1
    n = min(int(num_workers), visible_device_count())
    if n > 1:
        get_mesh(n)  # refuses a count that does not divide the pool
    return max(1, n)


def refuse_devices_per_rank(num_workers: int, what: str) -> None:
    """Under a multi-process TpuContext each rank drives one card:
    `num_workers` past one, with more than one chip in this process's pool,
    is ROADMAP item A10i, second half. Outside such a context (and inside a
    chip's thread of a fan-out, whose pin holds one chip) nothing is
    refused."""
    ctx = spmd_context()
    if ctx is None or getattr(ctx, "backend", None) == "local":
        return
    n = min(int(num_workers), visible_device_count())
    if n > 1:
        raise NotImplementedError(
            f"{what}: num_workers={num_workers} would drive {n} devices from each rank of a multi-process "
            "TpuContext, which is ROADMAP item A10i, second half; run one process per card"
        )


def run_on_chips(n: int, fn, *, name: str = "srml-chip") -> Tuple[List[Any], List[Dict[str, Any]]]:
    """Run ``fn(rank)`` for ranks 0..n-1 of the first `n` chips of
    `default_devices()`, one thread a chip, and return (the results in rank
    order, each chip's stats). Each thread runs in a copy of the caller's
    context (so its job, checkpoint, device-dataset and telemetry scopes
    carry over), pinned to its chip (`chip_scope`, its card current), inside
    a `TpuContext(rank, n)` over an in-process rendezvous and `LocalGroup`:
    the rank-sharded code of the multi-process fits runs unchanged. A thread
    that fails publishes its failure, so its peers unwind with
    RankFailedError; the first failure that is not such a relay is raised
    here once every thread has ended. Stats per chip: chip id, device,
    wall seconds, the group's collective seconds and calls."""
    import contextlib
    import contextvars
    import threading
    import time

    from ..errors import RankFailedError

    devices = default_devices()[:n]
    ids = current_chip_ids()[:n]
    if len(devices) < n:
        from ..errors import MeshTopologyError

        raise MeshTopologyError(f"{n} chips asked of a {len(devices)}-chip pool", requested=n, available=len(devices))
    rdvs = InProcessRendezvous.create(n)
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    stats: List[Dict[str, Any]] = [{} for _ in range(n)]

    def body(r: int) -> None:
        dev = devices[r]
        group = LocalGroup(r, n, dev, rdvs[r])
        t0 = time.perf_counter()
        try:
            with contextlib.ExitStack() as stack:
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                stack.enter_context(chip_scope((dev,), chip_ids=(ids[r],)))
                stack.enter_context(TpuContext(r, n, rdvs[r], group=group))
                results[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - raised below, after every chip ended
            errors[r] = e
        finally:
            stats[r] = {
                "chip_id": int(ids[r]), "device": str(dev), "wall_s": time.perf_counter() - t0,
                "collective_s": group.collective_s, "collective_calls": group.calls,
            }

    threads = [
        threading.Thread(target=contextvars.copy_context().run, args=(body, r), name=f"{name}-{ids[r]}", daemon=True)
        for r in range(n)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        raise next((e for e in failed if not isinstance(e, RankFailedError)), failed[0])
    return results, stats


def spmd_context() -> Optional[TpuContext]:
    """The multi-process TpuContext the caller entered (nranks > 1), or
    None."""
    ctx = TpuContext.current()
    return ctx if ctx is not None and ctx.is_spmd else None


def refuse_spmd(what: str, item: str = "A10") -> None:
    """Raise naming ROADMAP `item` when a multi-process TpuContext is
    active: `what` has no multi-process form in the port yet."""
    if spmd_context() is not None:
        raise NotImplementedError(f"{what} under a multi-process TpuContext is ROADMAP item {item}")


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


# ------------------------------------------------ the streaming pipeline ----


class StreamStaging:
    """The state of `stream_place_blocks` on a card, kept across passes: two
    slots, each holding per column one page-locked host buffer and one
    device buffer of the largest chunk seen, the events of the last copy out
    of each slot and of the compute stream's last use of it, and the side
    stream the copies run on. A streamed fit keeps one in its
    `core.StreamPlan`, so a pass allocates nothing after the first and a
    slot is refilled only after the previous pass is done with it."""

    def __init__(self) -> None:
        self.slots: List[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = [{}, {}]
        self.copied: List[Any] = [None, None]  # torch.cuda.Event per slot
        self.consumed: List[Any] = [None, None]
        self.copy_stream: Any = None

    def buffers(self, slot: int, name: str, arr: np.ndarray, device: torch.device):
        """(page-locked host, device) buffers of column `name` in `slot`
        that hold `arr`; made anew when none does."""
        held = self.slots[slot].get(name)
        shape, dtype = tuple(arr.shape), torch.from_numpy(arr[:0]).dtype
        if held is None or held[0].dtype != dtype or tuple(held[0].shape[1:]) != shape[1:] \
                or held[0].shape[0] < shape[0]:
            self.slots[slot].pop(name, None)
            held = (
                torch.empty(shape, dtype=dtype, pin_memory=True),
                torch.empty(shape, dtype=dtype, device=device),
            )
            self.slots[slot][name] = held
        return held


def stream_place_blocks(
    host_blocks: Iterable[Dict[str, np.ndarray]],
    *,
    device: torch.device,
    staging: Optional[StreamStaging] = None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """The double-buffered host-to-card pipeline of the out-of-core fits.

    `host_blocks` yields dicts of host arrays with the same row count (one
    streaming chunk: features, weights, labels, ...); each comes back as the
    same-keyed dict of tensors on `device`, equal bit for bit to
    `place_rows` of the same rows. Chunk N+1's copy is in flight while the
    caller computes on chunk N, and exactly two device chunks live at a
    time: a yielded chunk is valid until the next one is asked for.

    On a card, a worker thread stages each chunk into one of two reused
    page-locked host buffers (an overlapped copy needs page-locked memory)
    and issues its copy `non_blocking` on a side stream; the compute stream
    waits on the copy's event before the chunk is handed over. A staging
    buffer is refilled only after the event of its last copy completed, and
    a device buffer only after the compute stream's work on its last chunk
    (the copy stream waits on an event recorded when the caller asked for
    the next chunk). On the CPU it yields the same dicts over the host
    arrays, with no streams.

    Telemetry per drained pass: the `ingest.stream_chunks` and
    `ingest.stream_rows` counters, a device-memory watermark sample at every
    chunk boundary (`telemetry.record_device_memory`), and the
    `ingest.overlap_fraction` gauge: the share of chunks whose copy had
    completed (`event.query()`) when the caller asked for them, (n-1)/n at
    best (the first chunk is never prefetched). Near 0 on a multi-chunk
    pass means the copies take longer than the caller's work on a chunk."""
    from .. import telemetry

    if device.type != "cuda":
        gen = _stream_on_host(host_blocks)
    else:
        gen = _stream_to_card(host_blocks, device, staging or StreamStaging())
    total = overlapped = rows = 0
    for out, n_rows, ready in gen:
        total += 1
        rows += n_rows
        overlapped += int(ready)
        telemetry.record_device_memory(device)  # the out-of-core watermark
        yield out
    if total and telemetry.enabled():
        reg = telemetry.registry()
        reg.inc("ingest.stream_chunks", total)
        reg.inc("ingest.stream_rows", rows)
        reg.gauge("ingest.overlap_fraction", overlapped / total)


def _n_rows(blk: Dict[str, np.ndarray]) -> int:
    return int(next(iter(blk.values())).shape[0])


def _stream_on_host(host_blocks):
    """The CPU form: (tensors over the host arrays, rows, copy done) per
    chunk. The next chunk is made before the current one is handed over,
    and on the CPU its "copy" is done by then."""
    it = iter(host_blocks)
    cur = next(it, None)
    ready = False
    while cur is not None:
        placed = {k: host_tensor(v) for k, v in cur.items()}
        nxt = next(it, None)
        yield placed, _n_rows(cur), ready
        ready = True
        cur = nxt


def _stream_to_card(host_blocks, device: torch.device, staging: StreamStaging):
    """The card form of `stream_place_blocks`: (device tensors, rows, copy
    completed when asked for) per chunk."""
    compute = torch.cuda.current_stream(device)
    if staging.copy_stream is None:
        staging.copy_stream = torch.cuda.Stream(device)
        staging.copied = [torch.cuda.Event(), torch.cuda.Event()]
    copy_stream, copied, consumed = staging.copy_stream, staging.copied, staging.consumed

    def stage(i: int, blk: Dict[str, np.ndarray]):
        s = i % 2
        copied[s].synchronize()  # the slot's last copy out of its host buffers is done
        with torch.cuda.device(device), torch.cuda.stream(compute):
            held = {k: staging.buffers(s, k, np.asarray(v), device) for k, v in blk.items()}
        for k, v in blk.items():
            held[k][0][:v.shape[0]].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        out = {}
        with torch.cuda.stream(copy_stream):
            if consumed[s] is not None:
                copy_stream.wait_event(consumed[s])  # the compute stream is done with the slot
            for k, v in blk.items():
                dev = held[k][1][:v.shape[0]]
                dev.copy_(held[k][0][:v.shape[0]], non_blocking=True)
                out[k] = dev
            copied[s].record(copy_stream)
        return out

    it = iter(host_blocks)
    cur = next(it, None)
    if cur is None:
        return
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(stage, 0, cur)
        i, ready = 0, False
        while cur is not None:
            out = fut.result()
            nxt = next(it, None)
            # the next chunk's staging and copy start before this one is
            # handed over
            nfut = pool.submit(stage, i + 1, nxt) if nxt is not None else None
            compute.wait_event(copied[i % 2])
            yield out, _n_rows(cur), ready
            ev = torch.cuda.Event()
            ev.record(compute)
            consumed[i % 2] = ev
            if nfut is not None:
                ready = nfut.done() and copied[(i + 1) % 2].query()
            cur, fut, i = nxt, nfut, i + 1


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


def device_capacity_bytes(device: Optional[torch.device] = None, *, consume_chaos: bool = True) -> Optional[int]:
    """Per-device memory the admission budgeter charges against: a budget
    injected by an `oom:budget=` fault (parallel/chaos.py; reading it spends
    one firing, unless ``consume_chaos=False``: the fit scheduler's passes
    read the capacity often, and each such entry must demote exactly its
    count of fit admissions), else ``config["hbm_budget_bytes"]`` when set,
    else the card's TOTAL memory
    (`torch.cuda.get_device_properties(device).total_memory`), else None (a
    CPU device: no budgeting).

    Not the card's free memory: PyTorch's caching allocator keeps freed
    blocks as used, so free memory undercounts what a load can have. What
    other residents hold is subtracted by the admission itself, from the
    shared ledger's reservations (scheduler/ledger.py), as the JAX package
    budgets against its device limit minus the ledger."""
    from ..core import config
    from . import chaos

    injected = chaos.injected_hbm_budget() if consume_chaos else None
    if injected is not None:
        return int(injected)
    override = config.get("hbm_budget_bytes")
    if override:
        return int(override)
    if device is None or device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def device_allocatable_bytes(device: Optional[torch.device] = None) -> Optional[int]:
    """What PyTorch's caching allocator could hand out on `device` now: the
    driver's free bytes, within the process's memory fraction
    (`torch.cuda.set_per_process_memory_fraction`), plus the blocks it
    holds reserved and unused. None off a card. The OOM retry of a fit
    sizes its chunk against it (memory.admit_fit)."""
    if device is None or device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    reserved = torch.cuda.memory_reserved(device)
    allocated = torch.cuda.memory_allocated(device)
    cap = int(torch.cuda.get_per_process_memory_fraction(device) * total)
    return max(0, min(int(free), cap - reserved)) + max(0, reserved - allocated)
