#
# The hand-written CUDA kernels of the distance core: their build, their
# ctypes binding, and their wrappers.
#
#   assign_argmin      csrc/assign_argmin.cu      replaces _pl_argmin
#   assign_accumulate  csrc/assign_accumulate.cu  replaces _pl_accumulate
#   d2_block           csrc/d2_block.cu           replaces _pl_d2_block
#
# (the TPU kernels live in spark_rapids_ml_tpu/ops/distance.py). The float32
# forms of assign_argmin and d2_block share the CUDA-core tile of
# csrc/f32_tile.cuh, their `fast` forms the bf16 TMA + wgmma tile of
# csrc/wgmma_bf16.cuh, and their float64 forms the tile of csrc/tile_dot.cuh.
#
# Build: on the first kernel call, each csrc/*.cu is compiled by `nvcc` for
# sm_90a into a shared library with a plain C interface under `build/` at the
# repository root (one nvcc per source, all started together). The library
# name carries a hash of its source and of every header in csrc/ (the
# shared tiles above), so an edited source or header never loads a stale
# library. nvcc's report (-Xptxas -v:
# registers, spills, shared memory of each kernel) is kept beside the
# library (`ptxas_report`). A missing nvcc or a failed build raises; nothing
# falls back to the plain PyTorch versions (ops/distance.py). At load, the
# tiles each library was built with are checked against the ones its wrapper
# sizes scratch and staging for.
#
# `fast` assign_argmin and d2_block read operands staged as bf16
# (`stage_bf16`), rows padded to whole tiles, so their tensor-core loop
# meets neither a ragged edge nor a float-to-bf16 conversion; the TMA
# descriptors they need are encoded per call inside the library, by
# libcuda's cuTensorMapEncodeTiled found through the CUDA runtime's
# entry-point query (no link against libcuda).
#
# Wrappers take CUDA tensors only, check device, dtype, shape and
# contiguity, allocate the outputs with torch.empty, launch on PyTorch's
# current stream, raise when the launch reports an error, and count their
# launches in `launches`: a plain integer per kernel and each variant it has
# (VARIANTS: "assign_argmin/f32-fast", "d2_block/f64", ...), so a run shows
# by reading them that its path went through the kernels: one count per
# wrapper call, however many CUDA launches the call makes. Only the thread
# that launches a kernel writes its counter (the serving engine launches from
# its one dispatch thread).
#
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import torch

__all__ = [
    "launches", "reset_launches", "launch_total", "build", "ptxas_report", "stage_bf16",
    "assign_argmin", "assign_accumulate", "d2_block",
]

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
SOURCES = ("assign_argmin", "assign_accumulate", "d2_block")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the variants each kernel has: the input dtype, and `fast` (bf16-rounded
# loads, float32 sums, the result in the input dtype) for either dtype, as
# the TPU kernels have it
VARIANTS: Dict[str, Tuple[str, ...]] = {
    name: ("f32", "f32-fast", "f64", "f64-fast") for name in SOURCES
}

launches: Dict[str, int] = {f"{name}/{v}": 0 for name in SOURCES for v in VARIANTS[name]}

# assign_argmin's tiles, (rows, centers), per variant (csrc/assign_argmin.cu):
# one CTA per (row tile, center tile) writes each row's minimum over its
# centers, and a second pass merges the center tiles. The same for every
# batch size, so a row's result never depends on the batch.
ARGMIN_TILE: Dict[str, Tuple[int, int]] = {
    "f32": (128, 128), "f32-fast": (128, 256), "f64": (64, 64), "f64-fast": (128, 256),
}
# d2_block's output tiles, (queries, items), per variant (csrc/d2_block.cu):
# one CTA each, the same for every batch size
D2_TILE: Dict[str, Tuple[int, int]] = {
    "f32": (128, 128), "f32-fast": (128, 256), "f64": (64, 64), "f64-fast": (128, 256),
}
# the depth of the `fast` operands is padded with zeros to a multiple of this
STAGE_DEPTH = 64
# assign_accumulate's pieces (csrc/assign_accumulate.cu): each center's
# segment of the rows sorted by assignment is cut into pieces of at most this
# many rows, one CTA per (piece, column slice), so B rows against k centers
# make at most k + ceil(B / PIECE_ROWS) pieces, and at most
# B // (PIECE_ROWS + 1) centers have more than one
PIECE_ROWS = 128
# its index preparation: a counting sort in the library for up to
# COUNT_CENTERS centers (one 48 KB shared-memory counter each), counting
# chunks of COUNT_ROWS rows; past that, torch.sort
COUNT_CENTERS = 12288
COUNT_ROWS = 512

_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


def launch_total(name: str) -> int:
    """Launches of kernel `name` over all its variants."""
    return sum(n for key, n in launches.items() if key.split("/")[0] == name)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the CUDA "
        "kernels of spark_rapids_ml_tpu_torch cannot be built"
    )


def _lib_path(name: str) -> Path:
    """The library built from csrc/<name>.cu, named by a hash of that source
    and of every header in csrc/, the files nvcc may read for it."""
    h = hashlib.sha1()
    for src in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _report_path(name: str) -> Path:
    lib = _lib_path(name)
    return lib.with_name(lib.name + ".ptxas.txt")


def ptxas_report(name: str) -> str:
    """nvcc's -Xptxas -v report for the library of kernel `name` (the one
    the current sources build), or "" when it has not been built."""
    path = _report_path(name)
    return path.read_text() if path.exists() else ""


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
        ("srml_argmin_tiles_f32", [p, p, p, p, p, i, i, i, i, p]),
        ("srml_argmin_tiles_f64", [p, p, p, p, p, i, i, i, p]),
        ("srml_argmin_tiles_fast_f32", [p, p, p, p, p, i, i, i, i, i, p]),
        ("srml_argmin_tiles_fast_f64", [p, p, p, p, p, i, i, i, i, i, p]),
        ("srml_argmin_merge_f32", [p, p, p, p, i, i, p]),
        ("srml_argmin_merge_f64", [p, p, p, p, i, i, p]),
        ("srml_argmin_config", [i]),
        ("srml_accumulate_config", [i]),
        ("srml_accumulate_prep", [p, i, i, p, p, p, p, p, p, p]),
        ("srml_accumulate_plan_sorted", [p, i, i, p, p, p, p, p]),
        ("srml_accumulate_sums_f32", [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]),
        ("srml_accumulate_sums_f64", [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]),
        ("srml_accumulate_fold_f32", [p, p, p, p, p, p, p, i, i, i, i, p]),
        ("srml_accumulate_fold_f64", [p, p, p, p, p, p, p, i, i, i, i, p]),
        ("srml_d2_block_f32", [p, p, p, p, i, i, i, i, p]),
        ("srml_d2_block_f64", [p, p, p, p, i, i, i, p]),
        ("srml_d2_block_fast_f32", [p, p, p, p, i, i, i, i, i, p]),
        ("srml_d2_block_fast_f64", [p, p, p, p, i, i, i, i, i, p]),
        ("srml_d2_config", [i]),
    ):
        if hasattr(lib, fn):
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_int


def build() -> Dict[str, str]:
    """Compile every kernel source that has no library yet and load them all.
    Returns {name: nvcc's report} for the sources compiled by this call (the
    -Xptxas -v register and shared-memory lines). Raises RuntimeError naming
    the source and nvcc's output when a build fails."""
    with _BUILD_LOCK:
        missing = [n for n in SOURCES if n not in _LIBS]
        if not missing:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        to_build = [n for n in missing if not _lib_path(n).exists()]
        reports: Dict[str, str] = {}
        if to_build:
            nvcc = _nvcc()
            procs = {}
            for name in to_build:
                tmp = BUILD_DIR / f"{_lib_path(name).name}.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
                procs[name] = (
                    tmp,
                    subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                    ),
                )
            failed = []
            for name, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                reports[name] = out
                if proc.returncode != 0:
                    failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
                else:
                    _report_path(name).write_text(out)
                    os.replace(tmp, _lib_path(name))  # atomic: concurrent builds race safely
            if failed:
                raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for name in missing:
            lib = ctypes.CDLL(str(_lib_path(name)))
            _bind(lib)
            if name == "assign_argmin":
                _check_config(name, lib.srml_argmin_config, ARGMIN_TILE)
            elif name == "d2_block":
                _check_config(name, lib.srml_d2_config, D2_TILE)
            else:
                _check_accumulate_config(lib.srml_accumulate_config)
            _LIBS[name] = lib
        return reports


def library_tiles(config) -> Tuple[Dict[str, Tuple[int, int]], int]:
    """The tiles a library was built with, per variant, and the depth its
    `fast` operands must be padded to, from its config function (codes 0-6:
    the float32, float64 and `fast` tile shapes, then the `fast` depth)."""
    f32, f64, fast = ((config(2 * v), config(2 * v + 1)) for v in range(3))
    return {"f32": f32, "f32-fast": fast, "f64": f64, "f64-fast": fast}, config(6)


def _check_config(name: str, config, expected: Dict[str, Tuple[int, int]]) -> None:
    """The library's tiles must be the ones the wrapper sizes its scratch
    and its staging for."""
    built, depth = library_tiles(config)
    if built != expected or depth != STAGE_DEPTH:
        raise RuntimeError(
            f"{name} library tiles {built}, depth {depth} disagree with the wrapper's "
            f"{expected}, {STAGE_DEPTH}"
        )


def _check_accumulate_config(config) -> None:
    """assign_accumulate's library must cut segments into the pieces, and
    count in the chunks and up to the centers, that the wrapper sizes its
    plan and scratch for and picks the index preparation by."""
    built = (config(0), config(1), config(2))
    if built != (PIECE_ROWS, COUNT_CENTERS, COUNT_ROWS):
        raise RuntimeError(
            f"assign_accumulate library (piece rows, counting-sort centers, chunk rows) "
            f"{built} disagree with the wrapper's {(PIECE_ROWS, COUNT_CENTERS, COUNT_ROWS)}"
        )


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build()
    return _LIBS[name]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        _check(t.is_cuda, f"{name}: every input must be a CUDA tensor, got {t.device}")
        _check(t.device == dev, f"{name}: inputs on different devices ({dev}, {t.device})")
        _check(t.is_contiguous(), f"{name}: inputs must be contiguous")


def _raise_on(name: str, status: int) -> None:
    if status < 0:
        raise RuntimeError(f"{name}: encoding a TMA descriptor failed: CUresult {-status}")
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")


def _variant(name: str, dtype: torch.dtype, fast: bool = False) -> str:
    bits = {torch.float32: "f32", torch.float64: "f64"}.get(dtype)
    if bits is None:
        raise ValueError(f"{name}: float32 or float64 inputs only, got {dtype}")
    return f"{bits}-fast" if fast else bits


def stage_bf16(a: torch.Tensor, row_multiple: int = 1) -> torch.Tensor:
    """The `fast` operand layout: `a` [n, d] rounded to bf16 (round to
    nearest even; float64 through float32, as torch's and JAX's casts do)
    into a new row-major [np, dp] buffer, np = n rounded up to a multiple of
    `row_multiple` and dp = d rounded up to a multiple of STAGE_DEPTH, zeros
    past n and past d (they add nothing to a dot product). On the card this
    reads `a` once and writes the buffer once (at the Lloyd tile, 32768 x
    3000 float32: 393 MB read, 197 MB written)."""
    n, d = a.shape
    np_ = -(-n // row_multiple) * row_multiple
    dp = -(-d // STAGE_DEPTH) * STAGE_DEPTH
    out = torch.empty((np_, dp), dtype=torch.bfloat16, device=a.device)
    out[:n, :d].copy_(a.to(torch.float32) if a.dtype == torch.float64 else a)
    out[:n, d:].zero_()
    out[n:].zero_()
    return out


def _argmin_operands(x: torch.Tensor, c: torch.Tensor, variant: str):
    """What pass 1 of `variant` reads: x and c themselves, or for `fast`
    their bf16 stagings, rows padded to whole row and center tiles."""
    if variant.endswith("fast"):
        rows, cols = ARGMIN_TILE[variant]
        return stage_bf16(x, rows), stage_bf16(c, cols)
    return x, c


def _argmin_tiles(xo: torch.Tensor, co: torch.Tensor, c_sq: torch.Tensor, B: int, k: int, d: int,
                  variant: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of assign_argmin on the current device and stream: each row's
    (minimum, first index) over each center tile, as partials [n_ct, B] in
    c_sq's dtype and int32."""
    name = "assign_argmin"
    lib = _lib(name)
    n_ct = -(-k // ARGMIN_TILE[variant][1])
    pv = torch.empty((n_ct, B), dtype=c_sq.dtype, device=c_sq.device)
    pj = torch.empty((n_ct, B), dtype=torch.int32, device=c_sq.device)
    stream = torch.cuda.current_stream(c_sq.device).cuda_stream
    ptrs = [xo.data_ptr(), co.data_ptr(), c_sq.data_ptr(), pv.data_ptr(), pj.data_ptr()]
    if variant == "f32":
        vec = d % 4 == 0 and xo.data_ptr() % 16 == 0 and co.data_ptr() % 16 == 0
        status = lib.srml_argmin_tiles_f32(*ptrs, B, k, d, int(vec), stream)
    elif variant == "f64":
        status = lib.srml_argmin_tiles_f64(*ptrs, B, k, d, stream)
    else:
        fn = lib.srml_argmin_tiles_fast_f64 if variant == "f64-fast" else lib.srml_argmin_tiles_fast_f32
        status = fn(*ptrs, B, xo.shape[0], k, co.shape[0], xo.shape[1], stream)
    _raise_on(name, status)
    return pv, pj


def _argmin_merge(pv: torch.Tensor, pj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 of assign_argmin: (mind, best) [B] from the partials, the
    center tiles merged in ascending order."""
    name = "assign_argmin"
    lib = _lib(name)
    n_ct, B = pv.shape
    mind = torch.empty((B,), dtype=pv.dtype, device=pv.device)
    best = torch.empty((B,), dtype=torch.int32, device=pv.device)
    stream = torch.cuda.current_stream(pv.device).cuda_stream
    fn = lib.srml_argmin_merge_f64 if pv.dtype == torch.float64 else lib.srml_argmin_merge_f32
    _raise_on(name, fn(pv.data_ptr(), pj.data_ptr(), mind.data_ptr(), best.data_ptr(), B, n_ct, stream))
    return mind, best


def assign_argmin(
    x: torch.Tensor, c: torch.Tensor, c_sq: torch.Tensor, *, fast: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel form of `distance.assign_argmin_plain`: (min over centers of
    c_sq - 2 x.c [B] in x's dtype, first argmin [B] int32) for x [B, d],
    c [k, d], c_sq [k]. `fast` stages x and c as bf16 and takes the product
    on the tensor cores with float32 sums. One launch count per call: the
    staging (`fast`), the tile pass and the merge pass."""
    name = "assign_argmin"
    variant = _variant(name, x.dtype, fast)
    _check(c.dtype == x.dtype and c_sq.dtype == x.dtype, f"{name}: x, c and c_sq must share a dtype")
    _check(x.dim() == 2 and c.dim() == 2 and c_sq.dim() == 1, f"{name}: x [B,d], c [k,d], c_sq [k]")
    B, d = x.shape
    k = c.shape[0]
    _check(c.shape[1] == d and c_sq.shape[0] == k, f"{name}: shapes {tuple(x.shape)}, {tuple(c.shape)}, {tuple(c_sq.shape)} disagree")
    _check(k > 0 and d > 0, f"{name}: needs k > 0 centers and d > 0 features")
    rows, cols = ARGMIN_TILE[variant]
    # the padded shapes and the grid (row tiles x center tiles) must fit int32
    _check(max(B, k, d) < 2**31 - 512 and -(-B // rows) * -(-k // cols) < 2**31,
           f"{name}: dimensions must fit int32")
    _check_cuda(name, x, c, c_sq)
    if B == 0:
        return (torch.empty((0,), dtype=x.dtype, device=x.device),
                torch.empty((0,), dtype=torch.int32, device=x.device))
    with torch.cuda.device(x.device):
        xo, co = _argmin_operands(x, c, variant)
        pv, pj = _argmin_tiles(xo, co, c_sq, B, k, d, variant)
        mind, best = _argmin_merge(pv, pj)
    launches[f"{name}/{variant}"] += 1
    return mind, best


class AccumulatePlan(NamedTuple):
    """assign_accumulate's index preparation for one assignment, views of
    one int32 buffer: the rows of [0, k) stable-sorted by center `order`
    [B], the piece table `pieces` [n_pieces, 4] (center, first, end, alone),
    each center's first piece `first` [k + 1], the centers of several
    pieces `multi` [n_multi] and `totals` [2] (pieces, centers of several
    pieces), sized by their bounds (`plan_bounds`)."""

    order: torch.Tensor
    pieces: torch.Tensor
    first: torch.Tensor
    multi: torch.Tensor
    totals: torch.Tensor


def plan_bounds(B: int, k: int) -> Tuple[int, int]:
    """(pieces, centers of several pieces) at most, for B rows and k centers."""
    return k + -(-B // PIECE_ROWS), B // (PIECE_ROWS + 1)


def _plan_buffer(B: int, k: int, device, counting: bool) -> Tuple[AccumulatePlan, torch.Tensor]:
    """An AccumulatePlan of views of one new buffer (the piece table first,
    16-byte aligned), and the counting sort's chunk counts [chunks, k]
    (empty when not `counting`)."""
    n_pieces, n_multi = plan_bounds(B, k)
    chunks = -(-B // COUNT_ROWS) if counting else 0
    sizes = [4 * n_pieces, k + 1, n_multi, 2, B, chunks * k]
    buf = torch.empty((sum(sizes),), dtype=torch.int32, device=device)
    pieces, first, multi, totals, order, hist = torch.split(buf, sizes)
    return AccumulatePlan(order, pieces.view(n_pieces, 4), first, multi, totals), hist


def _accumulate_prep(assign: torch.Tensor, k: int) -> AccumulatePlan:
    """Index preparation of assign_accumulate on the current device and
    stream: the rows stable-sorted by center (so in ascending row order
    inside each center) and each center's segment cut into pieces. Up to
    COUNT_CENTERS centers, the library's counting sort (count, plan,
    scatter); past that, torch.sort and the library's plan."""
    name = "assign_accumulate"
    lib = _lib(name)
    B = assign.shape[0]
    counting = k <= COUNT_CENTERS
    plan, hist = _plan_buffer(B, k, assign.device, counting)
    stream = torch.cuda.current_stream(assign.device).cuda_stream
    tail = [plan.pieces.data_ptr(), plan.first.data_ptr(), plan.multi.data_ptr(),
            plan.totals.data_ptr(), stream]
    if counting:
        status = lib.srml_accumulate_prep(assign.data_ptr(), B, k, plan.order.data_ptr(),
                                          hist.data_ptr(), *tail)
    else:
        sorted_assign, order = torch.sort(assign, stable=True)
        plan.order.copy_(order)
        status = lib.srml_accumulate_plan_sorted(sorted_assign.data_ptr(), B, k, *tail)
    _raise_on(name, status)
    return plan


def _accumulate_vec(x: torch.Tensor) -> bool:
    """Whether x's rows can be read 16 bytes at a time."""
    return (x.shape[1] * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0


def _accumulate_sums(x: torch.Tensor, w: torch.Tensor, plan: AccumulatePlan, fast: bool):
    """The sum pass: (sums [k, d], counts [k], partials [n_pieces, d],
    partial counts [n_pieces]); the rows of sums and counts of centers of
    several pieces are left for the fold."""
    name = "assign_accumulate"
    lib = _lib(name)
    B, d = x.shape
    k = plan.first.shape[0] - 1
    n_pieces = plan.pieces.shape[0]
    sums = torch.empty((k, d), dtype=x.dtype, device=x.device)
    counts = torch.empty((k,), dtype=x.dtype, device=x.device)
    part = torch.empty((n_pieces, d), dtype=torch.float32 if fast else x.dtype, device=x.device)
    part_counts = torch.empty((n_pieces,), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = lib.srml_accumulate_sums_f64 if x.dtype == torch.float64 else lib.srml_accumulate_sums_f32
    _raise_on(name, fn(x.data_ptr(), w.data_ptr(), plan.order.data_ptr(), plan.pieces.data_ptr(),
                       plan.totals.data_ptr(), sums.data_ptr(), counts.data_ptr(), part.data_ptr(),
                       part_counts.data_ptr(), B, k, d, int(fast), int(_accumulate_vec(x)), stream))
    return sums, counts, part, part_counts


def _accumulate_fold(sums: torch.Tensor, counts: torch.Tensor, part: torch.Tensor,
                     part_counts: torch.Tensor, plan: AccumulatePlan, fast: bool) -> None:
    """The fold pass, in place: each center of several pieces gets the sum
    of its partials (and partial counts) in piece order. Its rows are new
    allocations, so their width alone picks the load width."""
    name = "assign_accumulate"
    lib = _lib(name)
    stream = torch.cuda.current_stream(sums.device).cuda_stream
    fn = lib.srml_accumulate_fold_f64 if sums.dtype == torch.float64 else lib.srml_accumulate_fold_f32
    _raise_on(name, fn(part.data_ptr(), part_counts.data_ptr(), plan.first.data_ptr(),
                       plan.multi.data_ptr(), plan.totals.data_ptr(), sums.data_ptr(),
                       counts.data_ptr(), plan.order.shape[0], sums.shape[1], int(fast),
                       int(_accumulate_vec(sums)), stream))


def assign_accumulate(
    x: torch.Tensor, w: torch.Tensor, assign: torch.Tensor, k: int, *, fast: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel form of `distance.accumulate_plain`: (sums [k, d], counts [k]) in
    x's dtype for x [B, d], w [B], assign [B] int32. Rows whose assignment
    lies outside [0, k) add nothing. One launch count per call: the index
    preparation (counting sort and plan), the sum pass and the fold pass."""
    name = "assign_accumulate"
    variant = _variant(name, x.dtype, fast)
    _check(w.dtype == x.dtype, f"{name}: w must have x's dtype")
    _check(assign.dtype == torch.int32, f"{name}: assign must be int32")
    _check(x.dim() == 2 and w.dim() == 1 and assign.dim() == 1, f"{name}: x [B,d], w [B], assign [B]")
    B, d = x.shape
    _check(w.shape[0] == B and assign.shape[0] == B, f"{name}: x, w and assign disagree on rows")
    _check(k > 0 and d > 0, f"{name}: needs k > 0 centers and d > 0 features")
    # the pieces' row bounds, and the grid (pieces x column slices of 256
    # elements at the narrowest) must fit int32
    _check(max(B, d) < 2**31 - PIECE_ROWS and (k + -(-B // PIECE_ROWS)) * -(-d // 256) < 2**31,
           f"{name}: dimensions must fit int32")
    _check_cuda(name, x, w, assign)
    with torch.cuda.device(x.device):
        plan = _accumulate_prep(assign, k)
        sums, counts, part, part_counts = _accumulate_sums(x, w, plan, fast)
        _accumulate_fold(sums, counts, part, part_counts, plan, fast)
    launches[f"{name}/{variant}"] += 1
    return sums, counts


def _d2_operands(q: torch.Tensor, xt: torch.Tensor, variant: str):
    """What the d2_block kernel of `variant` reads: q and xt themselves, or
    for `fast` their bf16 stagings, rows padded to whole query and item
    tiles."""
    if variant.endswith("fast"):
        rows, cols = D2_TILE[variant]
        return stage_bf16(q, rows), stage_bf16(xt, cols)
    return q, xt


def _d2_tiles(qo: torch.Tensor, xo: torch.Tensor, xt_sq: torch.Tensor, B: int, d: int,
              variant: str) -> torch.Tensor:
    """The d2_block kernel of `variant` on the current device and stream,
    on the operands `_d2_operands` gives: the [B, kt] block in xt_sq's
    dtype."""
    name = "d2_block"
    lib = _lib(name)
    kt = xt_sq.shape[0]
    out = torch.empty((B, kt), dtype=xt_sq.dtype, device=xt_sq.device)
    stream = torch.cuda.current_stream(xt_sq.device).cuda_stream
    ptrs = [qo.data_ptr(), xo.data_ptr(), xt_sq.data_ptr(), out.data_ptr()]
    if variant == "f32":
        vec = d % 4 == 0 and qo.data_ptr() % 16 == 0 and xo.data_ptr() % 16 == 0
        status = lib.srml_d2_block_f32(*ptrs, B, kt, d, int(vec), stream)
    elif variant == "f64":
        status = lib.srml_d2_block_f64(*ptrs, B, kt, d, stream)
    else:
        fn = lib.srml_d2_block_fast_f64 if variant == "f64-fast" else lib.srml_d2_block_fast_f32
        status = fn(*ptrs, B, qo.shape[0], kt, xo.shape[0], qo.shape[1], stream)
    _raise_on(name, status)
    return out


def d2_block(
    q: torch.Tensor, xt: torch.Tensor, xt_sq: torch.Tensor, *, fast: bool = False
) -> torch.Tensor:
    """Kernel form of `distance.d2_block_plain`: the [B, kt] block
    xt_sq[None, :] - 2 q.xt^T in q's dtype (no ||q||^2 term) for q [B, d],
    xt [kt, d], xt_sq [kt]; `fast` stages q and xt as bf16 and takes the
    product on the tensor cores with float32 sums. One launch count per
    call: the staging (`fast`) and the kernel."""
    name = "d2_block"
    variant = _variant(name, q.dtype, fast)
    _check(xt.dtype == q.dtype and xt_sq.dtype == q.dtype, f"{name}: q, xt and xt_sq must share a dtype")
    _check(q.dim() == 2 and xt.dim() == 2 and xt_sq.dim() == 1, f"{name}: q [B,d], xt [kt,d], xt_sq [kt]")
    B, d = q.shape
    kt = xt.shape[0]
    _check(xt.shape[1] == d and xt_sq.shape[0] == kt, f"{name}: shapes {tuple(q.shape)}, {tuple(xt.shape)}, {tuple(xt_sq.shape)} disagree")
    _check(kt > 0 and d > 0, f"{name}: needs kt > 0 items and d > 0 features")
    rows, cols = D2_TILE[variant]
    # the padded shapes and the grid (query tiles x item tiles) must fit int32
    _check(max(B, kt, d) < 2**31 - 512 and -(-B // rows) * -(-kt // cols) < 2**31,
           f"{name}: dimensions must fit int32")
    _check_cuda(name, q, xt, xt_sq)
    if B == 0:
        return torch.empty((0, kt), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        qo, xo = _d2_operands(q, xt, variant)
        out = _d2_tiles(qo, xo, xt_sq, B, d, variant)
    launches[f"{name}/{variant}"] += 1
    return out
