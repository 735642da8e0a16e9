#
# The one-device layer: which device the package runs on, and the placement
# of host rows on it.
#
# Counterparts in the JAX package: `set_devices` / `default_devices`
# (spark_rapids_ml_tpu/parallel/mesh.py:52), `make_global_rows`
# (parallel/mesh.py:683), the out-of-core fits' double-buffered pipeline
# (`stream_place_blocks`, parallel/mesh.py:618), the single-controller part
# of `TpuContext` (parallel/context.py:1073), the serving bucket ladder
# (`bucket_size`, `bucket_ladder`, `bucket_rows`, parallel/mesh.py:466-528)
# and the device capacity the admission budgeter reads (memory.py
# `device_capacity_bytes`). The multi-process control plane and process
# group (`TpuContext`, the rendezvous substrates, `PartitionDescriptor`) are
# in context.py and partition.py; one process driving several cards is a
# later ROADMAP A10 item.
#
# Entry points run on the CUDA card. The CPU runs only when the caller asks
# for it with `set_devices("cpu")` (the tests do): with no card and no such
# call, `default_device()` raises instead of carrying on quietly on the CPU.
#
from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "set_devices", "default_device", "host_tensor", "place_rows", "StreamStaging",
    "stream_place_blocks", "bucket_size", "bucket_ladder", "bucket_rows", "device_capacity_bytes",
    "device_allocatable_bytes", "PartitionDescriptor", "TpuContext", "Rendezvous", "LocalRendezvous",
    "FileRendezvous", "BarrierRendezvous", "ChaosRendezvous", "allgather_ndarray", "visible_device_count",
    "refuse_multi_device", "refuse_spmd", "spmd_context",
]

from .chaos import ChaosRendezvous  # noqa: E402
from .context import (  # noqa: E402
    BarrierRendezvous,
    FileRendezvous,
    LocalRendezvous,
    Rendezvous,
    TpuContext,
    allgather_ndarray,
)
from .partition import PartitionDescriptor  # noqa: E402

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


def visible_device_count() -> int:
    """Devices one process could drive: 1 under a `set_devices` pin (or
    with no card), else the CUDA cards torch sees."""
    if _DEVICE_OVERRIDE is not None or not torch.cuda.is_available():
        return 1
    return torch.cuda.device_count()


def refuse_multi_device(num_workers: int, what: str) -> None:
    """`num_workers` is clamped to the visible devices, as the JAX package
    clamps it (``min(num_workers, len(default_devices()))``): on one device
    any count fits there. One process driving more than one card is a later
    ROADMAP A10 item, refused when more than one is visible."""
    n = min(int(num_workers), visible_device_count())
    if n > 1:
        raise NotImplementedError(
            f"{what}: num_workers={num_workers} would drive {n} devices from one process, "
            "which is ROADMAP item A10; run one process per card under a TpuContext"
        )


def spmd_context() -> Optional[TpuContext]:
    """The multi-process TpuContext the caller entered (nranks > 1), or
    None."""
    ctx = TpuContext.current()
    return ctx if ctx is not None and ctx.is_spmd else None


def refuse_spmd(what: str) -> None:
    """Raise naming A10 when a multi-process TpuContext is active: `what`
    has no multi-process form in the port yet."""
    if spmd_context() is not None:
        raise NotImplementedError(f"{what} under a multi-process TpuContext is ROADMAP item A10")


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
