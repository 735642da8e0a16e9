#!/usr/bin/env python3
#
# Drives the PyTorch port (spark_rapids_ml_tpu_torch) on one NVIDIA card:
#
#   1. card and setup: the card's name and power limit, TF32 off, the CUDA
#      kernels built from csrc/*.cu with nvcc;
#   2. every kernel against its plain PyTorch version on the card, at its
#      main path's tile (KMeans: 32768 x 3000 rows against k = 1000 centers;
#      kNN: 4096 queries against a 16,384-item block, d = 3000) and at
#      ragged shapes, in every variant (f32, f32 fast, f64, f64 fast; fast =
#      bf16 products with float32 sums): integer-valued data must agree
#      exactly (ties included), Gaussian data to the stated tolerances, and
#      the accumulation must be bitwise deterministic; for assign_argmin also
#      a tie across a boundary of its center tiles (the first copy of a
#      repeated center must win) and batch independence (rows sent in
#      batches of 1 to 16,960 equal the same rows of the 32768-row tile bit
#      for bit); for d2_block also every rung of the serving ladder (256 to
#      8192 rows), batch independence (batches of 1 to 8192 rows equal the
#      same rows of one 8192-row call bit for bit) and a NaN query row in
#      the top-k merge on the card (the CPU's indices); for
#      assign_accumulate also skewed assignments (every row on one center,
#      a Zipf(1.1) law over the centers, and edges: empty centers, zero
#      weights, assignments outside [0, k)), past the counting sort's
#      centers too; then each kernel timed against its plain version and
#      one PyTorch call, with its build figures (ptxas registers, spills,
#      static and dynamic shared memory), its `fast` staging timed apart
#      from its tiles, and assign_accumulate's passes (preparation, sums
#      with their rate, fold) timed apart, on the card alone too
#      (device_ms), on the nearest-center and the skewed assignments;
#   3. the KMeans path at full width: KMeans(k=1000) fit on 1,000,000 x
#      3,000 float32 rows through the public API, transform of every row,
#      save and load, and a fit with the default k-means|| seeding, with the
#      launch counters showing that both of its kernels ran; plus the whole
#      path on a small input held against the plain PyTorch path on the CPU;
#   4. the exact kNN path at full width: NearestNeighbors(k=64) fit on the
#      same 1,000,000 rows and kneighbors of the first 4096 of them through
#      the public API, with the launch counter showing that every item block
#      went through the d2-block kernel; the first neighbor of every query is
#      itself; the kernel route against the plain route on the same resident
#      rows; an integer-data run with duplicated rows across an item-block
#      boundary that must agree exactly (lower index first); and
#      exactNearestNeighborsJoin;
#   5. the serving plane at full width: the phase-3 KMeansModel loaded twice
#      (float32 and bf16 scoring) and NearestNeighbors(k=64) over the same
#      1,000,000 rows loaded for bf16 scoring, in one ModelRegistry with the
#      default config (prewarm on); 4 client threads send each model 6
#      requests of 1 to 4096 rows through one ScoringEngine. Every response
#      must equal the same request served alone bit for bit; the float32
#      KMeans answers must equal KMeansModel.transform; every kNN query must
#      find itself first; the launch counter must show 62 bf16 d2-block
#      launches per dispatched kNN bucket and no float32 one; the bf16 top-k
#      against its plain version on the resident items; an integer-data bf16
#      run across item blocks must agree exactly;
#   6. a {"kernels": [...]} line, the nvidia-smi line, and as the last line
#      {"ok": true, "device": {...}}.
#
# Every phase raises on failure; the script prints no result then. It needs
# the repository around it and one CUDA card, and exits non-zero without
# either. Run from the repository root:
#
#     python3 chip_smoke.py
#
# The kernels are built into build/ (listed in .gitignore), and a copy of
# everything printed goes to build/chip_smoke.log.
#
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
LOG_DIR = ROOT / "build"

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over the memory rate and its operations over the rate of
# its type. float64 uses the FP64 tensor-core peak, the card's fastest rate
# for that type.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f32-fast": 989e12, "f64": 67e12, "f64-fast": 989e12}
VARIANTS = ("f32", "f32-fast", "f64", "f64-fast")

# the main path's shapes (BASELINE.md protocol: 1M x 3k float32, k = 1000)
N_ROWS, N_COLS, K = 1_000_000, 3000, 1000
TILE_ROWS = 32768  # KMeans max_samples_per_batch: one Lloyd tile
# the exact kNN lane of bench.py: 4096 queries against the same rows, k = 64
KNN_QUERIES, KNN_K = 4096, 64
# the serving traffic: client threads, requests per thread and model, and the
# request sizes they cycle through
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_SIZES = 4, 6, (1, 7, 64, 255, 1000, 4096)
# assign_argmin's batch independence: (rows, first row) slices of one
# 32768-row tile, from a single row to the Lloyd loop's ragged tail
BATCH_SLICES = ((1, 5), (7, 130), (255, 1), (4096, 12345), (16960, 15808))
# the serving bucket ladder (transform_bucket_min_rows to serve_max_batch_rows),
# and d2_block's batch independence: (rows, first row) slices of one call at
# its top rung
SERVE_RUNGS = (256, 512, 1024, 2048, 4096, 8192)
D2_BATCH_SLICES = ((1, 5), (7, 130), (255, 1), (256, 7000), (1000, 333), (2048, 4096), (4096, 2345),
                   (8192, 0))


def _variant_dtype(variant):
    return (np.float64 if variant.startswith("f64") else np.float32), variant.endswith("fast")

_log_lines = []


def say(*parts):
    line = " ".join(str(p) for p in parts)
    print(line, flush=True)
    _log_lines.append(line)


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(fn, reps=5):
    """Mean ms of one call of `fn` on the card: CUDA events around `reps`
    calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


_spin = {"cycles": 20_000_000}


def device_ms(fn, reps=20):
    """Mean ms of one call of `fn` on the card alone: the calls are queued
    behind a spin of the card (torch.cuda._sleep) that lasts longer than the
    host takes to enqueue them, so the events time the card's work back to
    back without the host's launch time between calls (which cuda_ms
    includes where a call's launches take the host longer than the card
    takes to run them). The reps' launches must fit the card's launch queue
    (a few hundred): past it the host waits for the spin, which no spin
    outlasts, and this raises."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_end = torch.cuda.Event(enable_timing=True)
    while True:
        spin_start = torch.cuda.Event(enable_timing=True)
        spin_start.record()
        torch.cuda._sleep(_spin["cycles"])
        spin_end.record()
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        spin_ms = spin_start.elapsed_time(spin_end)
        if spin_ms > host_ms:
            return start.elapsed_time(end) / reps
        if spin_ms > 2000:
            fail(f"device_ms: the host took {host_ms:.0f} ms to enqueue {reps} calls behind a "
                 f"{spin_ms:.0f} ms spin: too many launches to queue")
        _spin["cycles"] *= 2


def bound_ms(nbytes, flops, variant):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[variant]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ phase 1 ----


def phase_setup():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    say("torch.backends.cuda.matmul.allow_tf32 = False; torch.backends.cudnn.allow_tf32 = False")
    from spark_rapids_ml_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build()
    say(f"kernels built in {time.perf_counter() - t0:.1f} s into {_kernels.BUILD_DIR}")
    for name in _kernels.SOURCES:
        for fn, info in ptxas_table(_kernels.ptxas_report(name)).items():
            say(f"  {name}: {fn}: {info}")
    return smi


def ptxas_table(report):
    """{kernel function: {"registers", "spill_stores", "spill_loads",
    "smem_static"}} from nvcc's -Xptxas -v report (bytes for the last three)."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                out[fn].update(registers=int(m.group(1)), smem_static=int(smem.group(1)) if smem else 0)
    return out


# the kernel function of each variant's main pass, per kernel, as its name
# appears in nvcc's report
PTXAS_KERNELS = {
    "assign_argmin": {"f32": r"argmin_f32_tiles", "f64": r"argmin_f64_tiles",
                      "f32-fast": r"argmin_fast_tilesIf", "f64-fast": r"argmin_fast_tilesId"},
    "d2_block": {"f32": r"d2_block_f32", "f64": r"d2_block_f64",
                 "f32-fast": r"d2_block_fastIf", "f64-fast": r"d2_block_fastId"},
    "assign_accumulate": {"f32": r"accumulate_sumsIfLb0E", "f64": r"accumulate_sumsIdLb0E",
                          "f32-fast": r"accumulate_sumsIfLb1E", "f64-fast": r"accumulate_sumsIdLb1E"},
}


def kernel_ptxas(name, variant):
    """The build figures of one variant of kernel `name`: its main pass
    (both load widths for f32; for assign_accumulate, the sum and fold
    passes in both load widths and the counting sort's passes) and, for
    assign_argmin, its
    merge pass; a `fast` pass of assign_argmin or d2_block adds its dynamic
    shared memory (the TMA ring)."""
    from spark_rapids_ml_tpu_torch.ops import _kernels

    dtype_code = "d" if variant.startswith("f64") else "f"
    out = {}
    if name == "assign_accumulate":
        fold = PTXAS_KERNELS[name][variant].replace("sums", "fold")
        for fn, info in ptxas_table(_kernels.ptxas_report(name)).items():
            width = "scalar" if "ELi1E" in fn else "vec"
            if re.search(PTXAS_KERNELS[name][variant], fn):
                out[f"sums_{width}"] = dict(info)
            elif re.search(fold, fn):
                out[f"fold_{width}"] = dict(info)
            else:
                m = re.search(r"accumulate_(plan|count|scatter)E", fn)
                if m:
                    out[m.group(1)] = dict(info)
        return out
    config = (_kernels._lib(name).srml_argmin_config if name == "assign_argmin"
              else _kernels._lib(name).srml_d2_config)
    for fn, info in ptxas_table(_kernels.ptxas_report(name)).items():
        if re.search(PTXAS_KERNELS[name][variant], fn):
            key = "tiles" if variant != "f32" else ("tiles_vec" if "ILb1" in fn else "tiles_scalar")
            out[key] = dict(info)
            out[key]["smem_dynamic"] = config(7) if variant.endswith("fast") else 0
        elif name == "assign_argmin" and re.search(r"argmin_mergeI" + dtype_code, fn):
            out["merge"] = dict(info)
    return out


# ------------------------------------------------------------ phase 2 ----


def _inputs(n, k, d, dtype, integer, seed, dev, tie_at=None):
    """Rows, centers and weights. With `tie_at`, centers tie_at - 9 to
    tie_at + 6 repeat one row and the first 64 rows lie on it, so the copies
    straddle the center-tile boundary at tie_at and the first copy,
    tie_at - 9, must win those rows."""
    import torch

    rng = np.random.default_rng(seed)
    if integer:  # exact in bf16/f32/f64, duplicated centers force ties
        X = rng.integers(-4, 5, size=(n, d)).astype(dtype)
        C = rng.integers(-4, 5, size=(k, d)).astype(dtype)
        C[k // 2:k // 2 + 3] = C[0]
        C[k - 1] = C[1]
        w = rng.integers(1, 4, size=n).astype(dtype)
    else:
        X = rng.standard_normal(size=(n, d), dtype=np.float64).astype(dtype)
        C = rng.standard_normal(size=(k, d), dtype=np.float64).astype(dtype)
        w = rng.uniform(0.5, 2.0, size=n).astype(dtype)
    if k >= 64:  # a trailing block repeating one row, as k-means|| pads its candidates
        C[k - k // 8:k - 1] = C[k - k // 8 - 1]
    if tie_at is not None:
        C[tie_at - 8:tie_at + 7] = C[tie_at - 9]
        X[:64] = C[tie_at - 9]
        if not integer:
            X[:64] += 0.01 * rng.standard_normal(size=(64, d)).astype(dtype)
    return tuple(torch.from_numpy(a).to(dev) for a in (X, C, w))


def check_kernels(n, k, d, dtype, fast, integer, seed, dev, case="", tie_at=None):
    """One shape and variant, kernel against plain version; returns
    (max |mind err|, max |sums err|). `case` names the shape in the log;
    `tie_at` builds a tie across that center-tile boundary (_inputs)."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    x, c, w = _inputs(n, k, d, dtype, integer, seed, dev, tie_at)
    # first index of each center's value: a repeated center must lose every
    # tie to its first copy, on either kind of data
    _, first, inverse = np.unique(c.cpu().numpy(), axis=0, return_index=True, return_inverse=True)
    first_copy = torch.from_numpy(first[inverse.reshape(-1)]).to(dev)
    c_sq = D._c_sq(c)
    m1, b1 = _kernels.assign_argmin(x, c, c_sq, fast=fast)
    torch.cuda.synchronize()
    m0, b0 = D.assign_argmin_plain(x, c, c_sq, fast)
    s1, n1 = _kernels.assign_accumulate(x, w, b0, k, fast=fast)
    s2, n2 = _kernels.assign_accumulate(x, w, b0, k, fast=fast)
    torch.cuda.synchronize()
    s0, n0 = D.accumulate_plain(x, w, b0, k, fast)
    tag = f"{n}x{d} k={k} {np.dtype(dtype).name}{' fast' if fast else ''} {'integer' if integer else 'gaussian'}"
    if case:
        tag += f" [{case}]"
    if not (torch.equal(s1, s2) and torch.equal(n1, n2)):
        fail(f"assign_accumulate is not deterministic: {tag}")
    if not torch.equal(first_copy[b1.long()], b1.long()):
        fail(f"assign_argmin picked a later copy of a repeated center: {tag}")
    if tie_at is not None:
        for route, b in (("kernel", b1), ("plain", b0)):
            if not bool((b[:64] == tie_at - 9).all()):
                fail(f"assign_argmin ({route}) did not give the tied rows the first copy "
                     f"{tie_at - 9}: {sorted(set(b[:64].tolist()))}: {tag}")
    mind_err = (m1 - m0).abs().max().item()
    sums_err = (s1 - s0).abs().max().item()
    if integer:
        if not torch.equal(b1, b0):
            fail(f"assign_argmin best differs on integer data ({int((b1 != b0).sum())} rows): {tag}")
        if not torch.equal(m1, m0):
            fail(f"assign_argmin mind differs on integer data (max {mind_err}): {tag}")
        if not (torch.equal(s1, s0) and torch.equal(n1, n0)):
            fail(f"assign_accumulate differs on integer data (max {sums_err}): {tag}")
    else:
        # best must agree wherever the two smallest plain distances are more
        # than 1e-4 of the distance scale apart (summation order moves d2 by
        # far less); mind, sums and counts to rtol 1e-5 of their scale
        d2 = c_sq[None, :] - 2.0 * D._mm(x, c.T, fast)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        scale = d2.abs().max().item()
        clear = (two[:, 1] - two[:, 0]) > 1e-4 * scale
        bad = int(((b1 != b0) & clear).sum())
        if bad:
            fail(f"assign_argmin best differs on {bad} clearly separated rows: {tag}")
        rows = slice(64 if tie_at is not None else 0, None)
        err = (m1[rows] - m0[rows]).abs().max().item() if n > rows.start else 0.0
        if err > 1e-5 * scale:
            fail(f"assign_argmin mind error {err} > 1e-5 x {scale}: {tag}")
        if tie_at is not None:
            # the 64 rows lying on a center: their dot product with it is a
            # sum of d terms of one sign, as large as the scale itself. Each
            # route's float32 sum of the same (bf16 for `fast`) products lies
            # within d * 2^-24 * ||x|| ||c|| of the exact sum (the tensor
            # cores' float32 accumulation is no chain of round-to-nearest
            # additions), so c_sq - 2 dot may differ by 4 d 2^-24 ||x|| ||c||
            xq, cq = (D._bf16(x), D._bf16(c)) if fast else (x, c)
            tol = 4 * d * 2.0 ** -24 * float(D.row_sq(xq[:64].double()).max().sqrt()
                                              * D.row_sq(cq.double()).max().sqrt())
            on = (m1[:64] - m0[:64]).abs().max().item()
            if on > tol:
                fail(f"assign_argmin mind error {on} on the rows lying on a center > the float32 "
                     f"summation bound {tol}: {tag}")
            say(f"    rows lying on the tied center: max|mind err| {on:.3g} (summation bound {tol:.3g}); "
                f"other rows {err:.3g} (1e-5 x scale {1e-5 * scale:.3g})")
        if sums_err > 1e-5 * s0.abs().max().item():
            fail(f"assign_accumulate sums error {sums_err}: {tag}")
        if (n1 - n0).abs().max().item() > 1e-5 * n0.abs().max().item():
            fail(f"assign_accumulate counts differ: {tag}")
    say(f"  ok {tag}: best equal on {float((b1 == b0).float().mean()):.6f} of rows, "
        f"max|mind err| {mind_err:.3g}, max|sums err| {sums_err:.3g}")
    return mind_err, sums_err


# assign_accumulate's assignments besides the nearest-center one: every
# row on one center (a center of many pieces), a Zipf(1.1) law over the
# centers (the early Lloyd iterations of a random init, a dominant cluster),
# and edges: empty centers, zero weights, assignments outside [0, k)
SKEWS = ("one center", "zipf", "edges")


def _skewed(n, k, kind, seed):
    """(assignment int32 [n], rows whose weight is set to 0) for one SKEWS kind."""
    rng = np.random.default_rng(seed)
    zero = np.zeros(n, dtype=bool)
    if kind == "one center":
        a = np.full(n, 17 % k)
    elif kind == "zipf":
        p = np.arange(1, k + 1, dtype=np.float64) ** -1.1
        a = rng.permutation(k)[rng.choice(k, size=n, p=p / p.sum())]
    else:
        a = rng.integers(0, k, size=n)
        a[(a >= k // 3) & (a < k // 2)] = 0  # empty centers
        out = rng.random(n) < 0.125
        a[out] = rng.choice([-7, -1, k, k + 3], size=int(out.sum()))
        zero = rng.random(n) < 0.125
    return a.astype(np.int32), zero


def check_accumulate(n, k, d, dtype, fast, integer, seed, dev, kind):
    """assign_accumulate on a SKEWS assignment against accumulate_plain on
    the rows inside [0, k); two launches bitwise equal; returns max
    |sums err|."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    x, _, w = _inputs(n, k, d, dtype, integer, seed, dev)
    a, zero = _skewed(n, k, kind, seed)
    w[torch.from_numpy(zero).to(dev)] = 0
    assign = torch.from_numpy(a).to(dev)
    s1, n1 = _kernels.assign_accumulate(x, w, assign, k, fast=fast)
    s2, n2 = _kernels.assign_accumulate(x, w, assign, k, fast=fast)
    torch.cuda.synchronize()
    valid = (assign >= 0) & (assign < k)
    s0, n0 = D.accumulate_plain(x[valid], w[valid], assign[valid], k, fast)
    tag = (f"assign_accumulate {n}x{d} k={k} {np.dtype(dtype).name}{' fast' if fast else ''} "
           f"{'integer' if integer else 'gaussian'} [{kind}: most rows on one center "
           f"{int(np.bincount(a[(a >= 0) & (a < k)], minlength=k).max())}]")
    if not (torch.equal(s1, s2) and torch.equal(n1, n2)):
        fail(f"not deterministic: {tag}")
    err = (s1 - s0).abs().max().item()
    if integer:
        if not (torch.equal(s1, s0) and torch.equal(n1, n0)):
            fail(f"differs on integer data (max {err}): {tag}")
    else:
        if err > 1e-5 * s0.abs().max().item():
            fail(f"sums error {err} > 1e-5 x {s0.abs().max().item()}: {tag}")
        if (n1 - n0).abs().max().item() > 1e-5 * n0.abs().max().item():
            fail(f"counts differ: {tag}")
    say(f"  ok {tag}: max|sums err| {err:.3g}")
    return err


def time_kernels(variant, dev, errs):
    """Kernel, plain-version and library times at the main path's tile."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    dtype, fast = _variant_dtype(variant)
    x, c, w = _inputs(TILE_ROWS, K, N_COLS, dtype, False, 7, dev)
    c_sq = D._c_sq(c)
    _, best = _kernels.assign_argmin(x, c, c_sq, fast=fast)
    B, d, k, s = TILE_ROWS, N_COLS, K, x.element_size()
    out = []

    xm, cm = (x.bfloat16(), c.bfloat16()) if fast else (x, c)
    nbytes = (B * d + k * d + k) * s + B * (s + 4)
    flops = 2.0 * B * k * d
    bnd, by = bound_ms(nbytes, flops, variant)
    # the passes apart: the bf16 staging (`fast`), the tile pass, the merge
    xo, co = _kernels._argmin_operands(x, c, variant)
    pv, pj = _kernels._argmin_tiles(xo, co, c_sq, B, k, d, variant)
    split = {
        "stage_ms": cuda_ms(lambda: _kernels._argmin_operands(x, c, variant)) if fast else 0.0,
        "tiles_ms": cuda_ms(lambda: _kernels._argmin_tiles(xo, co, c_sq, B, k, d, variant)),
        "merge_ms": cuda_ms(lambda: _kernels._argmin_merge(pv, pj)),
    }
    # staging reads x and c once and writes their padded bf16 copies once
    stage_bytes = (B * d + k * d) * s + (xo.numel() + co.numel()) * 2 if fast else 0
    split["stage_bound_ms"] = stage_bytes / PEAK_BYTES_S * 1e3
    split["tiles_tflops"] = flops / split["tiles_ms"] / 1e9
    del xo, co, pv, pj
    out.append({
        "name": f"assign_argmin/{variant}",
        "route": "cuda",
        "source": "spark_rapids_ml_tpu_torch/csrc/assign_argmin.cu",
        "replaces": "spark_rapids_ml_tpu/ops/distance.py:224",
        "max_abs_err": errs[("assign_argmin", variant)],
        "ms": cuda_ms(lambda: _kernels.assign_argmin(x, c, c_sq, fast=fast)),
        "plain_ms": cuda_ms(lambda: D.assign_argmin_plain(x, c, c_sq, fast)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.matmul(xm, cm.T)),
        "split_ms": split,
        "ptxas": kernel_ptxas("assign_argmin", variant),
    })

    xw = x * w[:, None]

    def library_accumulate():
        sums = torch.zeros((k, d), dtype=x.dtype, device=dev)
        sums.index_add_(0, best.long(), xw)
        return sums

    nbytes = (B * d + B + k * d + k) * s + B * 4
    bnd, by = bound_ms(nbytes, 2.0 * B * d, variant)
    e = {
        "name": f"assign_accumulate/{variant}",
        "route": "cuda",
        "source": "spark_rapids_ml_tpu_torch/csrc/assign_accumulate.cu",
        "replaces": "spark_rapids_ml_tpu/ops/distance.py:297",
        "max_abs_err": errs[("assign_accumulate", variant)],
        "ms": cuda_ms(lambda: _kernels.assign_accumulate(x, w, best, k, fast=fast)),
        "plain_ms": cuda_ms(lambda: D.accumulate_plain(x, w, best, k, fast)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": cuda_ms(library_accumulate),
        "split_ms": accumulate_split(x, w, best, k, fast),
        "ptxas": kernel_ptxas("assign_accumulate", variant),
    }
    # the skewed assignments at the same tile: the whole call, and its passes
    for kind in ("one center", "zipf"):
        a, _ = _skewed(B, k, kind, 7)
        skew = torch.from_numpy(a).to(dev)
        e["split_ms"][kind] = dict(
            ms=cuda_ms(lambda: _kernels.assign_accumulate(x, w, skew, k, fast=fast)),
            **accumulate_split(x, w, skew, k, fast))
    e["device_ms"] = e["split_ms"]["device_ms"]["call"]
    out.append(e)
    for e in out:
        say(f"  {e['name']}: {e['ms']:.3f} ms (plain {e['plain_ms']:.3f}, library "
            f"{e['library_ms']:.3f}, bound {e['bound_ms']:.3f} by {e['bound_by']})")
    a = out[0]
    say(f"    passes: staging {a['split_ms']['stage_ms']:.3f} ms (its bytes at the memory rate "
        f"{a['split_ms']['stage_bound_ms']:.3f}), tiles {a['split_ms']['tiles_ms']:.3f} ms "
        f"({a['split_ms']['tiles_tflops']:.1f} TFLOP/s), merge {a['split_ms']['merge_ms']:.3f} ms; "
        f"ptxas {a['ptxas']}")
    sp = out[1]["split_ms"]
    dv = sp["device_ms"]
    say(f"    accumulate passes: preparation {sp['prep_ms']:.3f} ms, sums {sp['sums_ms']:.3f} ms, fold "
        f"{sp['fold_ms']:.3f} ms; on the card alone: call {dv['call']:.3f}, preparation "
        f"{dv['prep']:.3f}, sums {dv['sums']:.3f} ({sp['sums_tbs']:.2f} TB/s of 3.35), fold "
        f"{dv['fold']:.3f}; one center {sp['one center']['ms']:.3f} ms (alone "
        f"{sp['one center']['device_ms']['call']:.3f}), zipf {sp['zipf']['ms']:.3f} ms (alone "
        f"{sp['zipf']['device_ms']['call']:.3f}); ptxas {out[1]['ptxas']}")
    return out


def accumulate_split(x, w, assign, k, fast):
    """assign_accumulate's passes timed apart on one assignment: index
    preparation (counting sort and plan), the sum pass with its rate on the
    card (the bytes it must move: x, w and the row order read once, sums,
    counts and partials written once), and the fold; each with cuda_ms and,
    with the whole call, with device_ms."""
    from spark_rapids_ml_tpu_torch.ops import _kernels

    B, d = x.shape
    s = x.element_size()
    plan = _kernels._accumulate_prep(assign, k)
    sums, counts, part, part_counts = _kernels._accumulate_sums(x, w, plan, fast)
    passes = {
        "prep": lambda: _kernels._accumulate_prep(assign, k),
        "sums": lambda: _kernels._accumulate_sums(x, w, plan, fast),
        "fold": lambda: _kernels._accumulate_fold(sums, counts, part, part_counts, plan, fast),
    }
    out = {f"{name}_ms": cuda_ms(fn) for name, fn in passes.items()}
    out["device_ms"] = {name: device_ms(fn) for name, fn in passes.items()}
    out["device_ms"]["call"] = device_ms(lambda: _kernels.assign_accumulate(x, w, assign, k, fast=fast))
    n_pieces, n_multi = plan.totals.tolist()
    part_rows = int((plan.pieces[:n_pieces, 3] == 0).sum())
    out["pieces"], out["centers_of_several_pieces"] = n_pieces, n_multi
    sums_bytes = (B * d + B) * s + B * 4 + (k * d + k) * s + part_rows * (d * part.element_size() + s)
    out["sums_tbs"] = sums_bytes / out["device_ms"]["sums"] / 1e9
    return out


def check_batch_independence(dev):
    """assign_argmin on rows x[a:a+B] equals its result on the whole
    32768-row tile at the same rows, bit for bit (f32 and f32-fast, Gaussian
    data): one tiling and one split serve every batch size."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    x, c, _ = _inputs(TILE_ROWS, K, N_COLS, np.float32, False, 5, dev)
    c_sq = D._c_sq(c)
    for fast in (False, True):
        m_full, b_full = _kernels.assign_argmin(x, c, c_sq, fast=fast)
        for B, a in BATCH_SLICES:
            m, b = _kernels.assign_argmin(x[a:a + B], c, c_sq, fast=fast)
            if not (torch.equal(m, m_full[a:a + B]) and torch.equal(b, b_full[a:a + B])):
                fail(f"assign_argmin{' fast' if fast else ''}: rows {a}..{a + B} sent alone differ "
                     f"from the same rows of the {TILE_ROWS}-row tile")
        say(f"  ok batch independence, float32{' fast' if fast else ''}: rows sent as batches of "
            f"{', '.join(str(B) for B, _ in BATCH_SLICES)} equal the same rows of the {TILE_ROWS}-row "
            "tile bit for bit")


def _d2_inputs(B, kt, d, dtype, integer, seed, dev):
    import torch

    rng = np.random.default_rng(seed)
    if integer:  # every dot product and norm is exact in f32 and f64
        q = rng.integers(-4, 5, size=(B, d)).astype(dtype)
        xt = rng.integers(-4, 5, size=(kt, d)).astype(dtype)
    else:
        q = rng.standard_normal(size=(B, d), dtype=np.float64).astype(dtype)
        xt = rng.standard_normal(size=(kt, d), dtype=np.float64).astype(dtype)
    return torch.from_numpy(q).to(dev), torch.from_numpy(xt).to(dev)


def check_d2_block(B, kt, d, dtype, fast, integer, seed, dev):
    """d2_block against d2_block_plain at one shape; returns max |err|. The
    tolerance, 1e-5 of the block's scale, covers dot products summed in
    another order: in the input dtype, or in float32 for `fast`."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    q, xt = _d2_inputs(B, kt, d, dtype, integer, seed, dev)
    xt_sq = D.row_sq(xt)
    out = _kernels.d2_block(q, xt, xt_sq, fast=fast)
    torch.cuda.synchronize()
    ref = D.d2_block_plain(q, xt, xt_sq, fast)
    tag = (f"d2_block {B}x{kt}x{d} {np.dtype(dtype).name}{' fast' if fast else ''} "
           f"{'integer' if integer else 'gaussian'}")
    if out.shape != ref.shape or out.dtype != ref.dtype:
        fail(f"{tag}: output {tuple(out.shape)} {out.dtype}, plain {tuple(ref.shape)} {ref.dtype}")
    err = (out - ref).abs().max().item()
    if integer and not torch.equal(out, ref):
        fail(f"{tag}: differs on integer data (max {err})")
    scale = ref.abs().max().item()
    if err > 1e-5 * scale:  # dot products summed in another order
        fail(f"{tag}: max |err| {err} > 1e-5 x {scale}")
    say(f"  ok {tag}: max|err| {err:.3g} (scale {scale:.4g})")
    return err


def time_d2_block(variant, dev, err):
    """d2_block, its plain version and one library call at the kNN tile: for
    f32 and f64 one torch.addmm computing the same block (the bare
    torch.matmul product is timed beside it); for `fast`, torch.matmul on
    the two operands cast to bf16 beforehand (the casts not timed). The
    `fast` staging and the kernel are also timed apart."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    dtype, fast = _variant_dtype(variant)
    B, kt, d = KNN_QUERIES, D._DEFAULT_K_TILE, N_COLS
    q, xt = _d2_inputs(B, kt, d, dtype, False, 9, dev)
    xt_sq = D.row_sq(xt)
    s = q.element_size()
    flops = 2.0 * B * kt * d
    bnd, by = bound_ms((B * d + kt * d + kt + B * kt) * s, flops, variant)
    qo, xo = _kernels._d2_operands(q, xt, variant)
    split = {
        "stage_ms": cuda_ms(lambda: _kernels._d2_operands(q, xt, variant)) if fast else 0.0,
        "tiles_ms": cuda_ms(lambda: _kernels._d2_tiles(qo, xo, xt_sq, B, d, variant)),
    }
    # staging reads q and xt once and writes their padded bf16 copies once
    stage_bytes = (B * d + kt * d) * s + (qo.numel() + xo.numel()) * 2 if fast else 0
    split["stage_bound_ms"] = stage_bytes / PEAK_BYTES_S * 1e3
    split["tiles_tflops"] = flops / split["tiles_ms"] / 1e9
    del qo, xo
    e = {
        "name": f"d2_block/{variant}",
        "route": "cuda",
        "source": "spark_rapids_ml_tpu_torch/csrc/d2_block.cu",
        "replaces": "spark_rapids_ml_tpu/ops/distance.py:366",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: _kernels.d2_block(q, xt, xt_sq, fast=fast)),
        "plain_ms": cuda_ms(lambda: D.d2_block_plain(q, xt, xt_sq, fast)),
        "bound_ms": bnd, "bound_by": by,
    }
    if fast:
        qb, xb = q.bfloat16(), xt.bfloat16()
        e["library_ms"] = cuda_ms(lambda: torch.matmul(qb, xb.T))
        lib = f"torch.matmul bf16 {e['library_ms']:.3f}"
    else:
        e["library_ms"] = cuda_ms(lambda: torch.addmm(xt_sq[None, :], q, xt.T, alpha=-2.0))
        e["matmul_ms"] = cuda_ms(lambda: torch.matmul(q, xt.T))
        lib = f"torch.addmm {e['library_ms']:.3f}, torch.matmul {e['matmul_ms']:.3f}"
    split["tflops"] = flops / e["ms"] / 1e9
    split["bound_share"] = bnd / e["ms"]
    e["split_ms"] = split
    e["ptxas"] = kernel_ptxas("d2_block", variant)
    say(f"  {e['name']}: {e['ms']:.3f} ms ({split['tflops']:.1f} TFLOP/s, {split['bound_share']:.1%} of "
        f"the bound {e['bound_ms']:.3f} by {e['bound_by']}; plain {e['plain_ms']:.3f}, {lib})")
    say(f"    staging {split['stage_ms']:.3f} ms (its bytes at the memory rate "
        f"{split['stage_bound_ms']:.3f}), tiles {split['tiles_ms']:.3f} ms "
        f"({split['tiles_tflops']:.1f} TFLOP/s); ptxas {e['ptxas']}")
    return e


def check_d2_batch_independence(dev):
    """d2_block on rows q[a:a+B] equals its result on one 8192-row call at the
    same rows, bit for bit (f32 and f32-fast, Gaussian data, the kNN item
    block): one grid and tile serve every batch of the serving ladder."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    rows = max(SERVE_RUNGS)
    q, xt = _d2_inputs(rows, D._DEFAULT_K_TILE, N_COLS, np.float32, False, 13, dev)
    xt_sq = D.row_sq(xt)
    for fast in (False, True):
        full = _kernels.d2_block(q, xt, xt_sq, fast=fast)
        for B, a in D2_BATCH_SLICES:
            if not torch.equal(_kernels.d2_block(q[a:a + B], xt, xt_sq, fast=fast), full[a:a + B]):
                fail(f"d2_block{' fast' if fast else ''}: rows {a}..{a + B} sent alone differ from the "
                     f"same rows of the {rows}-row call")
        del full
        say(f"  ok d2_block batch independence, float32{' fast' if fast else ''}: rows sent as batches "
            f"of {', '.join(str(B) for B, _ in D2_BATCH_SLICES)} equal the same rows of one {rows}-row "
            "call bit for bit")


def check_nan_query_rows(dev):
    """A query row of NaN through topk_tile on the card, in one item block
    and in several, f32 and f32-fast: the same indices as the plain route on
    the CPU, and in one block the row's first columns in order at NaN
    distance, as jax.lax.top_k ranks them; then a NaN row among 64 queries
    against one 16,384-item block at d = 3000."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import distance as D

    rng = np.random.default_rng(1)
    items = rng.standard_normal((300, 8)).astype(np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    q[1] = np.nan
    tq, ti = torch.from_numpy(q), torch.from_numpy(items)
    for fast in (False, True):
        for k_tile in (300, 64):
            cd, ci = D.topk_tile(tq, ti, None, 10, k_tile=k_tile, fast=fast)
            gd, gi = D.topk_tile(tq.to(dev), ti.to(dev), None, 10, k_tile=k_tile, fast=fast)
            gd, gi = gd.cpu(), gi.cpu()
            tag = f"NaN query row, {-(-300 // k_tile)} item block(s){' fast' if fast else ''}"
            if not torch.equal(gi, ci):
                fail(f"{tag}: the card's indices differ from the CPU's at {int((gi != ci).sum())} places")
            if not torch.equal(torch.isnan(gd), torch.isnan(cd)):
                fail(f"{tag}: NaN distances differ between the card and the CPU")
            want = torch.arange(10, dtype=torch.int32) if k_tile == 300 else torch.zeros(10, dtype=torch.int32)
            if not torch.equal(gi[1], want):
                fail(f"{tag}: the NaN row got indices {gi[1].tolist()}, expected {want.tolist()}")
    big_q, big_x = _d2_inputs(64, D._DEFAULT_K_TILE, N_COLS, np.float32, False, 17, dev)
    big_q[3] = float("nan")
    for fast in (False, True):
        d2, idx = D.topk_tile(big_q, big_x, None, KNN_K, fast=fast)
        if not (torch.equal(idx[3].cpu(), torch.arange(KNN_K, dtype=torch.int32))
                and bool(torch.isnan(d2[3]).all())):
            fail(f"NaN query row among {len(big_q)} x {D._DEFAULT_K_TILE} x {N_COLS}"
                 f"{' fast' if fast else ''}: indices {idx[3, :8].tolist()}...")
        others = torch.cat([d2[:3], d2[4:]])
        if not bool(torch.isfinite(others).all()):
            fail("a finite query row got a non-finite distance beside the NaN row")
    say("  ok NaN query rows on the card: one item block and five, f32 and f32-fast, the CPU's indices; "
        f"one block of {D._DEFAULT_K_TILE} x {N_COLS}: the NaN row's neighbours are items 0..{KNN_K - 1}")


def phase_d2_block(dev):
    from spark_rapids_ml_tpu_torch.ops import distance as D

    say("phase 2: d2_block against its plain version on the card")
    errs = {}
    kt = D._DEFAULT_K_TILE
    for variant in VARIANTS:
        dtype, fast = _variant_dtype(variant)
        # the kNN tile, a ragged one (B and kt not multiples of the tiles),
        # tiny ones, and the serving ladder's rungs (256 to 8192 rows) against
        # the kNN block and an odd one
        shapes = [(KNN_QUERIES, kt, N_COLS), (KNN_QUERIES - 1, kt - 1, N_COLS),
                  (37, 5, 3), (1, 1, 1), (65, 63, 17), (200, 1000, 77), (129, 130, 16)]
        if variant == "f32-fast":
            shapes += [(b, kt, N_COLS) for b in SERVE_RUNGS if b != KNN_QUERIES]
            shapes += [(b, 1001, N_COLS) for b in SERVE_RUNGS]
        for (B, kt_, d) in shapes:
            check_d2_block(B, kt_, d, dtype, fast, True, B + kt_ + d, dev)
            e = check_d2_block(B, kt_, d, dtype, fast, False, B + kt_ + d, dev)
            if (B, kt_) == (KNN_QUERIES, kt):
                errs[variant] = e
    check_d2_batch_independence(dev)
    check_nan_query_rows(dev)
    say("phase 2: d2_block timing at the kNN tile (CUDA events, mean of 5 after a warm-up)")
    return [time_d2_block(variant, dev, errs[variant]) for variant in VARIANTS]


def phase_kernels(dev):
    from spark_rapids_ml_tpu_torch.ops import _kernels

    say("phase 2: kernels against their plain versions on the card")
    errs = {}
    for variant in VARIANTS:
        dtype, fast = _variant_dtype(variant)
        nt = _kernels.ARGMIN_TILE[variant][1]  # centers per tile of assign_argmin
        for integer in (True, False):
            # ragged shapes, then the main path's other tiles: the transform
            # tile, the ragged tail of a Lloyd iteration (1M = 30 x 32768 +
            # 16960) and the k-means|| candidate weighting (6 rounds x 2k
            # candidates, padded with repeated rows)
            for (n, k, d) in ((1000, 1001, 77), (37, 5, 3), (333, 64, 1000),
                              (4096, K, N_COLS), (N_ROWS % TILE_ROWS, K, N_COLS),
                              (4096, 12 * K, N_COLS)):
                case = ""
                if k < nt:
                    case = f"k < {nt}: one partial center tile"
                elif k == 12 * K:
                    case = f"k-means|| weighting: {-(-k // nt)} center tiles of {nt}"
                check_kernels(n, k, d, dtype, fast, integer, 11 + n + k, dev, case)
            # a repeated center straddling the boundary of center tiles 0 and 1
            check_kernels(4096, 2 * nt + 37, N_COLS, dtype, fast, integer, 17 + nt, dev,
                          f"tie across the center-tile boundary at {nt}", tie_at=nt)
            m, s = check_kernels(TILE_ROWS, K, N_COLS, dtype, fast, integer, 3, dev)
            if not integer:
                errs[("assign_argmin", variant)] = m
                errs[("assign_accumulate", variant)] = s
            # assign_accumulate on skewed assignments: at the main tile,
            # small and ragged (several pieces, d not a multiple of 4), and
            # past the counting sort's centers (torch.sort prepares)
            for kind in SKEWS:
                for (n, k, d) in ((TILE_ROWS, K, N_COLS), (1000, 7, 77), (5000, 3, 130),
                                  (5000, 20000, 64)):
                    check_accumulate(n, k, d, dtype, fast, integer, 23 + n + k, dev, kind)
    check_batch_independence(dev)
    say("phase 2: timing at the main path's tile (CUDA events, mean of 5 after a warm-up)")
    entries = []
    for variant in VARIANTS:
        entries += time_kernels(variant, dev, errs)
    return entries


# ------------------------------------------------------------ phase 3 ----


def _protocol_rows():
    """1M x 3000 float32 rows around 1000 Gaussian centers, from a seed. Row
    chunks are filled by threads, each with its own generator spawned from
    the seed, so the data is the same on every run and every machine."""
    from concurrent.futures import ThreadPoolExecutor

    seq = np.random.SeedSequence(2024)
    rng = np.random.default_rng(seq)
    true_centers = rng.standard_normal((K, N_COLS), dtype=np.float32) * 4.0
    labels = rng.integers(0, K, size=N_ROWS)
    X = np.empty((N_ROWS, N_COLS), dtype=np.float32)
    step = 65536
    starts = list(range(0, N_ROWS, step))
    chunk_seeds = seq.spawn(len(starts))

    def fill(i):
        lo, hi = starts[i], min(starts[i] + step, N_ROWS)
        np.random.default_rng(chunk_seeds[i]).standard_normal(dtype=np.float32, out=X[lo:hi])
        X[lo:hi] += true_centers[labels[lo:hi]]

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(len(starts))))
    return X


def _small_path_reference():
    """The whole KMeans path on a small input, on the card and on the CPU
    (the plain PyTorch versions): same n_iter_, centers to rtol 1e-5,
    identical predictions."""
    from spark_rapids_ml_tpu_torch import KMeans, set_devices

    rng = np.random.default_rng(5)
    centers = rng.standard_normal((8, 40)).astype(np.float32) * 5.0
    x = (centers[rng.integers(0, 8, 5000)] + rng.standard_normal((5000, 40))).astype(np.float32)
    results = {}
    for device in ("cpu", "cuda"):
        set_devices(device)
        m = KMeans(k=8, maxIter=20, tol=1e-10, initMode="random", seed=3,
                   distance_precision="high").fit({"features": x})
        results[device] = (m, np.asarray(m.transform({"features": x})["prediction"]))
    set_devices(None)
    (mc, pc), (mg, pg) = results["cpu"], results["cuda"]
    if mc.n_iter_ != mg.n_iter_:
        fail(f"small path: n_iter_ {mg.n_iter_} on the card, {mc.n_iter_} on the CPU")
    if not np.allclose(mg.cluster_centers_, mc.cluster_centers_, rtol=1e-5, atol=1e-5):
        fail("small path: centers differ between the card and the CPU")
    if not np.array_equal(pg, pc):
        fail("small path: predictions differ between the card and the CPU")
    say(f"  small path (5000 x 40, k=8): card and CPU agree, n_iter_ {mg.n_iter_}, "
        f"inertia {mg.inertia_} vs {mc.inertia_}")


def phase_main_path(dev, X):
    import torch

    from spark_rapids_ml_tpu_torch import KMeans, KMeansModel
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    say("phase 3: the KMeans path")
    _small_path_reference()
    data = {"features": X}
    counts = {}
    timings = {}

    # one reset, then a snapshot of the counters after each run: the per-run
    # counts are differences, and their sum is the whole main path's
    def run_counts(before):
        return {key: n - before.get(key, 0) for key, n in _kernels.launches.items()}

    _kernels.reset_launches()
    torch.cuda.synchronize()

    # fit, initMode="random"
    t0 = time.perf_counter()
    model = KMeans(k=K, maxIter=3, tol=1e-20, initMode="random", seed=1).setFeaturesCol("features").fit(data)
    timings["fit_s"] = time.perf_counter() - t0
    counts["fit"] = run_counts({})
    if model.cluster_centers_.shape != (K, N_COLS) or not np.isfinite(model.cluster_centers_).all():
        fail("fit: centers are not finite of shape (1000, 3000)")
    if not np.isfinite(model.inertia_):
        fail(f"fit: inertia {model.inertia_} is not finite")
    passes = model.n_iter_ + 1  # Lloyd iterations + the final high-precision inertia pass
    say(f"  fit (random init): {timings['fit_s']:.2f} s wall, n_iter_ {model.n_iter_}, "
        f"inertia {model.inertia_:.6e}, {N_ROWS * passes / timings['fit_s']:.4g} rows/s over "
        f"{passes} passes (placement and init included)")

    # transform
    snap = dict(_kernels.launches)
    t0 = time.perf_counter()
    pred = np.asarray(model.transform(data)["prediction"])
    timings["transform_s"] = time.perf_counter() - t0
    counts["transform"] = run_counts(snap)
    if pred.shape != (N_ROWS,) or pred.min() < 0 or pred.max() >= K:
        fail("transform: predictions out of range")
    say(f"  transform of {N_ROWS} rows: {timings['transform_s']:.2f} s wall")

    # save / load: the loaded model predicts the same
    path = ROOT / "build" / "chip_smoke_model"
    model.write().overwrite().save(str(path))
    loaded = KMeansModel.load(str(path))
    snap = dict(_kernels.launches)
    pred2 = np.asarray(loaded.transform(data)["prediction"])
    counts["loaded_transform"] = run_counts(snap)
    if not np.array_equal(pred, pred2):
        fail("save/load: the loaded model predicts differently")
    say("  save/load: the loaded model's transform equals the original's")

    # fit with the default k-means|| seeding (argmin kernel in the seeding)
    snap = dict(_kernels.launches)
    t0 = time.perf_counter()
    model2 = KMeans(k=K, maxIter=2, tol=1e-20, seed=1).fit(data)
    timings["fit_kmeans_parallel_s"] = time.perf_counter() - t0
    counts["fit_kmeans_parallel"] = run_counts(snap)
    if not np.isfinite(model2.inertia_) or not np.isfinite(model2.cluster_centers_).all():
        fail("k-means|| fit: non-finite result")
    say(f"  fit (k-means|| init): {timings['fit_kmeans_parallel_s']:.2f} s wall, "
        f"n_iter_ {model2.n_iter_}, inertia {model2.inertia_:.6e}")
    counts["main_path"] = dict(_kernels.launches)  # read just after the main path

    for run, c in counts.items():
        say(f"  launches in {run}: " + ", ".join(f"{k_}={v}" for k_, v in c.items() if v))

    def total(run, kernel):
        return sum(v for k_, v in counts[run].items() if k_.split("/")[0] == kernel)

    for run in ("fit", "fit_kmeans_parallel"):
        for kernel in ("assign_argmin", "assign_accumulate"):
            if total(run, kernel) == 0:
                fail(f"{run}: kernel {kernel} was never launched")
    for run in ("transform", "loaded_transform"):
        if total(run, "assign_argmin") == 0:
            fail(f"{run}: kernel assign_argmin was never launched")

    # after the counted runs: the host-to-device placement of X alone, the
    # fit's inertia against a plain reference on the card (the final
    # centers' nearest-center distances through the plain version, tile by
    # tile), one Lloyd iteration alone, and the transform's kernels alone on
    # device-resident rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xd = torch.from_numpy(X).to(dev)
    torch.cuda.synchronize()
    timings["place_rows_s"] = time.perf_counter() - t0
    say(f"  placing X on the card (host to device, {X.nbytes / 1e9:.1f} GB): "
        f"{timings['place_rows_s']:.2f} s")
    cd = torch.from_numpy(model.cluster_centers_).to(dev)
    c_sq = D._c_sq(cd)
    pred_d = torch.from_numpy(pred.astype(np.int64)).to(dev)
    ref = 0.0
    differ = differ_clear = 0
    for lo in range(0, N_ROWS, TILE_ROWS):
        xb = Xd[lo:lo + TILE_ROWS]
        mind, best = D.assign_argmin_plain(xb, cd, c_sq, False)
        ref += float(torch.sum(torch.clamp_min(mind + D.row_sq(xb), 0.0)))
        # the transform's predictions must equal the plain version's wherever
        # the two smallest plain distances are more than 1e-4 of the tile's
        # distance scale apart (the rule of phase 2)
        d2 = c_sq[None, :] - 2.0 * (xb @ cd.T)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 1e-4 * d2.abs().max()
        wrong = best.long() != pred_d[lo:lo + TILE_ROWS]
        differ += int(wrong.sum())
        differ_clear += int((wrong & clear).sum())
    if differ_clear:
        fail(f"transform: {differ_clear} clearly separated rows differ from the plain version")
    say(f"  transform predictions equal the plain version's on every clearly separated row "
        f"({differ} of {N_ROWS} rows differ in all)")
    if abs(ref - model.inertia_) > 1e-4 * abs(ref):
        fail(f"fit: inertia {model.inertia_} disagrees with the plain reference {ref}")
    say(f"  inertia matches the plain reference {ref:.6e} (rtol 1e-4)")

    from spark_rapids_ml_tpu_torch.ops.kmeans import _finish_centers, _lloyd_step

    wd = torch.ones(N_ROWS, device=dev)

    def plain_lloyd_step(X, w, centers, batch_rows, fast):
        # the same iteration through the plain versions: the path a port
        # without its kernels would take on the card
        cs = D._c_sq(centers)
        sums = torch.zeros_like(centers)
        counts = torch.zeros((K,), dtype=X.dtype, device=dev)
        inertia = torch.zeros((), dtype=X.dtype, device=dev)
        for lo in range(0, N_ROWS, batch_rows):
            xb, wb = X[lo:lo + batch_rows], w[lo:lo + batch_rows]
            mind, best = D.assign_argmin_plain(xb, centers, cs, fast)
            s, c = D.accumulate_plain(xb, wb, best, K, fast)
            sums += s
            counts += c
            inertia += torch.sum(torch.clamp_min(mind + D.row_sq(xb), 0.0) * wb)
        return _finish_centers(sums, counts, inertia, centers)

    for route, step in (("kernels", _lloyd_step), ("plain", plain_lloyd_step)):
        for fast in (True, False):
            step(Xd, wd, cd, TILE_ROWS, fast)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, shift = step(Xd, wd, cd, TILE_ROWS, fast)
            float(shift)
            dt = time.perf_counter() - t0
            mode = "fast" if fast else "high"
            timings[f"lloyd_iter_{mode}_s" if route == "kernels" else f"plain_lloyd_iter_{mode}_s"] = dt
            say(f"  one Lloyd iteration ({mode}, {route}): {dt * 1e3:.1f} ms, "
                f"{N_ROWS / dt:.4g} rows/s")
    from spark_rapids_ml_tpu_torch.ops.kmeans import kmeans_predict

    snap = dict(_kernels.launches)
    timings["predict_resident_s"] = cuda_ms(lambda: kmeans_predict(Xd, cd), reps=2) / 1e3
    per_call = (_kernels.launches["assign_argmin/f32"] - snap["assign_argmin/f32"]) // 3
    say(f"  the transform's argmin over all rows already on the card: "
        f"{timings['predict_resident_s']:.4f} s ({per_call} assign_argmin/f32 launches of "
        f"{D.tile_rows()} rows)")
    for mode in ("fast", "high"):
        k_s, p_s = timings[f"lloyd_iter_{mode}_s"], timings[f"plain_lloyd_iter_{mode}_s"]
        say(f"  Lloyd iteration ({mode}): kernels {k_s * 1e3:.1f} ms, plain {p_s * 1e3:.1f} ms: "
            f"the kernel path is {'faster' if k_s < p_s else 'SLOWER'} ({p_s / k_s:.2f}x)")
    return counts, timings, model


# ------------------------------------------------------------ phase 4 ----


def _knn_routes(items, valid, queries, k):
    """exact_knn on resident tensors through the kernel and through the plain
    d2-block version (the same merge fed by d2_block_plain), in turns
    kernel, plain, plain, kernel; returns ({route: (dist, idx)}, {route:
    [seconds]})."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.ops.knn import exact_knn

    kernel_block = D.d2_block
    results, secs = {}, {"kernel": [], "plain": []}
    for route in ("kernel", "plain", "plain", "kernel"):
        D.d2_block = kernel_block if route == "kernel" else D.d2_block_plain
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[route] = exact_knn(items, valid, queries, k=k)
            secs[route].append(time.perf_counter() - t0)
        finally:
            D.d2_block = kernel_block
    return results, secs


def phase_knn(dev, X, d2_ms):
    import torch

    from spark_rapids_ml_tpu_torch import NearestNeighbors
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.parallel import place_rows

    say(f"phase 4: exact kNN, {KNN_QUERIES} queries x {N_ROWS} x {N_COLS} float32, k = {KNN_K}")
    kt = D._DEFAULT_K_TILE
    blocks = -(-N_ROWS // kt)
    expected = blocks * -(-KNN_QUERIES // D.tile_rows())
    timings = {}

    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = NearestNeighbors(k=KNN_K).setInputCol("features").fit({"features": X})
    timings["knn_fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, knn_df = model.kneighbors({"features": X[:KNN_QUERIES]})
    timings["kneighbors_s"] = time.perf_counter() - t0
    counts = dict(_kernels.launches)  # read just after the path
    say("  launches in kneighbors: " + ", ".join(f"{k_}={v}" for k_, v in counts.items() if v))
    if counts["d2_block/f32"] != expected:
        fail(f"kneighbors: d2_block/f32 launched {counts['d2_block/f32']} times, expected "
             f"{expected} ({blocks} item blocks of {kt} x 1 query tile): a block took another route")
    if any(v for k_, v in counts.items() if k_ != "d2_block/f32"):
        fail(f"kneighbors: other kernels launched: {counts}")
    say(f"  fit {timings['knn_fit_s']:.2f} s (binds the item frame); kneighbors "
        f"{timings['kneighbors_s']:.2f} s wall through the API (placement of the items included)")

    idx = np.stack(knn_df["indices"].to_numpy())
    dist = np.stack(knn_df["distances"].to_numpy())
    if idx.shape != (KNN_QUERIES, KNN_K) or dist.shape != (KNN_QUERIES, KNN_K) or dist.dtype != np.float64:
        fail(f"kneighbors: indices {idx.shape}, distances {dist.shape} {dist.dtype}")
    if not np.isfinite(dist).all() or (np.diff(dist, axis=1) < 0).any():
        fail("kneighbors: distances not finite or not ascending")
    if not np.array_equal(knn_df["query_id"].to_numpy(), np.arange(KNN_QUERIES)):
        fail("kneighbors: query ids are not the row numbers")
    if not np.array_equal(idx[:, 0], np.arange(KNN_QUERIES)):
        fail(f"kneighbors: {int((idx[:, 0] != np.arange(KNN_QUERIES)).sum())} queries do not find themselves first")
    # ||q||^2 - 2 q.q + ||q||^2 in float32 is 0 up to ulps of ||q||^2
    q_sq = np.sum(X[:KNN_QUERIES].astype(np.float64) ** 2, axis=1)
    if (dist[:, 0] > np.sqrt(1e-5 * q_sq)).any():
        fail(f"kneighbors: a self-distance exceeds sqrt(1e-5 ||q||^2): max {dist[:, 0].max()}")
    say(f"  every query finds itself first (self-distance max {dist[:, 0].max():.4g}, "
        f"||q|| about {np.sqrt(q_sq.mean()):.4g}); nearest other row at {dist[:, 1].min():.4g}")

    # the kernel route against the plain route, on the same resident rows
    Xd, wd = place_rows(X, device=dev)
    Q = Xd[:KNN_QUERIES]
    valid = wd > 0
    res, secs = _knn_routes(Xd, valid, Q, KNN_K)
    (dk, ik), (dp, ip) = res["kernel"], res["plain"]
    d2k, d2p = dk.astype(np.float64) ** 2, dp.astype(np.float64) ** 2
    tol = 1e-5 * d2p.max()
    err = np.abs(d2k - d2p).max()
    if err > tol:
        fail(f"exact_knn: kernel and plain squared distances differ by {err} > 1e-5 x {d2p.max()}")
    swapped = np.argwhere(ik != ip)
    if len(swapped):
        # a swapped entry must be a near-tie: the kernel's item lies within
        # the tolerance of the plain route's distance at that position
        r, j = swapped[:, 0], swapped[:, 1]
        qd = Q[torch.from_numpy(r).to(dev)].double()
        xd = Xd[torch.from_numpy(ik[r, j].astype(np.int64)).to(dev)].double()
        exact = ((qd - xd) ** 2).sum(1).cpu().numpy()
        if (np.abs(exact - d2p[r, j]) > tol).any():
            fail(f"exact_knn: {int((np.abs(exact - d2p[r, j]) > tol).sum())} index swaps are not near-ties")
    timings["exact_knn_kernel_s"] = secs["kernel"]
    timings["exact_knn_plain_s"] = secs["plain"]
    say(f"  kernel route vs plain route: squared distances within {err:.4g} (tol {tol:.4g}); "
        f"{len(swapped)} of {ik.size} index positions differ, all near-ties")
    say(f"  exact_knn on resident items: kernel route {', '.join(f'{t:.3f}' for t in secs['kernel'])} s; "
        f"plain route {', '.join(f'{t:.3f}' for t in secs['plain'])} s")

    # the merge's share: one merge timed alone at the kNN tile, and the
    # kernel route's time less its blocks at the phase-2 kernel time
    item_sq = D.row_sq(Xd)
    block = D.d2_block(Q, Xd[:kt], item_sq[:kt])
    best_d2 = torch.full((KNN_QUERIES, KNN_K), float("inf"), device=dev)
    best_i = torch.zeros((KNN_QUERIES, KNN_K), dtype=torch.int32, device=dev)
    merge_ms = cuda_ms(lambda: D._merge(best_d2, best_i, block, 0, KNN_K))
    knn_s = min(secs["kernel"])
    timings["merge_ms"] = merge_ms
    timings["merge_share_timed"] = blocks * merge_ms / 1e3 / knn_s
    timings["merge_share_by_difference"] = (knn_s - blocks * d2_ms / 1e3) / knn_s
    say(f"  one merge at the kNN tile: {merge_ms:.3f} ms; merges {timings['merge_share_timed']:.1%} of "
        f"exact_knn ({blocks} x {merge_ms:.3f} ms), everything but d2_block "
        f"{timings['merge_share_by_difference']:.1%} ({blocks} x {d2_ms:.3f} ms of kernel)")
    del Xd, wd, Q, valid, item_sq, block

    # integer rows: exact in every sum, so the two routes must agree exactly;
    # rows repeated across item-block boundaries pin lower-index-first
    n_int = 8 * kt
    gen = torch.Generator(device=dev).manual_seed(31)
    items = torch.randint(-4, 5, (n_int, N_COLS), generator=gen, device=dev, dtype=torch.float32)
    for b in (kt, 4 * kt):
        items[b:b + 64] = items[b - 64:b]
    lo = kt - KNN_QUERIES // 2
    queries = items[lo:lo + KNN_QUERIES]
    res, _ = _knn_routes(items, None, queries, KNN_K)
    (dk, ik), (dp, ip) = res["kernel"], res["plain"]
    if not (np.array_equal(ik, ip) and np.array_equal(dk, dp)):
        fail(f"integer kNN: kernel and plain routes differ at {int((ik != ip).sum())} indices")
    orig = np.arange(kt - 64, kt)
    for rows in (orig - lo, orig + 64 - lo):  # the originals and their copies as queries
        if not (np.array_equal(ik[rows, 0], orig) and np.array_equal(ik[rows, 1], orig + 64)):
            fail("integer kNN: a repeated row does not come lower index first across the block boundary")
    say(f"  integer data, {KNN_QUERIES} x {n_int} x {N_COLS}, rows repeated across item blocks: kernel and "
        f"plain routes equal exactly; each repeated row ranks (lower copy, upper copy) first")
    del items, queries

    joined = model.exactNearestNeighborsJoin({"features": X[:5]})
    if len(joined) != 5 * KNN_K or "distCol" not in joined.columns:
        fail(f"exactNearestNeighborsJoin: {len(joined)} rows, columns {list(joined.columns)}")
    say(f"  exactNearestNeighborsJoin of 5 queries: {len(joined)} rows, columns {list(joined.columns)}")
    return counts, timings


# ------------------------------------------------------------ phase 5 ----


def _serve_traffic(seed):
    """Per client thread, its requests as (first row, rows) of X: the sizes
    cycle through SERVE_SIZES (each thread starting elsewhere in the cycle,
    so concurrent requests differ in size), the first rows are seeded."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(SERVE_CLIENTS):
        reqs = []
        for i in range(SERVE_REQUESTS):
            n = SERVE_SIZES[(t + i) % len(SERVE_SIZES)]
            reqs.append((int(rng.integers(0, N_ROWS - n)), n))
        out.append(reqs)
    return out


def _fast_topk_routes(q, items, item_sq, k):
    """topk_tile(fast=True) through the kernel and through the plain fast
    d2-block version, on the same resident tensors."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import distance as D

    kernel_block = D.d2_block
    out = {}
    for route in ("kernel", "plain"):
        D.d2_block = kernel_block if route == "kernel" else D.d2_block_plain
        try:
            d2, idx = D.topk_tile(q, items, None, k, item_sq=item_sq, fast=True)
            torch.cuda.synchronize()
            out[route] = (d2.cpu().numpy(), idx.cpu().numpy())
        finally:
            D.d2_block = kernel_block
    return out


def phase_serving(dev, X, kmeans_model):
    import threading

    import torch

    from spark_rapids_ml_tpu_torch import ModelRegistry, NearestNeighbors, ScoringEngine, telemetry
    from spark_rapids_ml_tpu_torch.core import PredictProgram, config
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.ops.knn import exact_knn

    say(f"phase 5: serving, {SERVE_CLIENTS} clients x {SERVE_REQUESTS} requests of "
        f"{SERVE_SIZES} rows to each of kmeans_f32, kmeans_bf16, knn_bf16 (k = {KNN_K} over "
        f"{N_ROWS} x {N_COLS}); config: bucket ladder from {config['transform_bucket_min_rows']} to "
        f"{config['serve_max_batch_rows']} rows, prewarm to {config['serve_prewarm_rows']}, coalesce "
        f"window {config['serve_coalesce_window_ms']} ms (adaptive {config['serve_adaptive_batching']})")
    torch.cuda.empty_cache()  # the earlier phases' freed blocks back to the card
    kt = D._DEFAULT_K_TILE
    blocks = -(-N_ROWS // kt)
    timings = {}
    ids = np.random.default_rng(77).permutation(N_ROWS).astype(np.int64) * 3 + 1000
    t0 = time.perf_counter()
    knn_model = NearestNeighbors(k=KNN_K).setInputCol("features").setIdCol("id").fit(
        {"features": X, "id": ids})
    timings["knn_fit_s"] = time.perf_counter() - t0

    telemetry.registry().reset()
    telemetry.enable()
    _kernels.reset_launches()
    torch.cuda.synchronize()
    registry = ModelRegistry()
    loads = (("kmeans_f32", kmeans_model, None), ("kmeans_bf16", kmeans_model, "bf16"),
             ("knn_bf16", knn_model, "bf16"))
    dispatches = {}
    # the prewarm inside each load timed on its own (it ends in a fetch,
    # which waits for the card); the rest of the load is admission and
    # placement
    real_prewarm = PredictProgram.prewarm
    prewarm_s = []

    def timed_prewarm(self, n_cols, *, max_rows=None):
        t = time.perf_counter()
        rungs = real_prewarm(self, n_cols, max_rows=max_rows)
        prewarm_s.append(time.perf_counter() - t)
        return rungs

    PredictProgram.prewarm = timed_prewarm
    try:
        entries = {}
        for name, model, serve_dtype in loads:
            t0 = time.perf_counter()
            entries[name] = registry.load(name, model, serve_dtype=serve_dtype)
            torch.cuda.synchronize()
            timings[f"load_{name}_s"] = time.perf_counter() - t0
            timings[f"prewarm_{name}_s"] = prewarm_s[-1]
    finally:
        PredictProgram.prewarm = real_prewarm
    for name, model, serve_dtype in loads:
        entry = entries[name]
        program = entry.program
        dispatches[name] = 0
        real = program.dispatch

        def counted(xb, _real=real, _name=name):
            dispatches[_name] += 1
            return _real(xb)

        program.dispatch = counted
        say(f"  load {name}: {timings[f'load_{name}_s']:.2f} s, of which prewarm of "
            f"{entry.prewarmed_rungs} rungs {timings[f'prewarm_{name}_s']:.2f} s; "
            f"{entry.resident_bytes / 1e9:.3f} GB admitted, largest term "
            f"{model._serve_metrics['admission']['largest_term']}")
    knn_rungs = registry.get("knn_bf16").prewarmed_rungs
    load_counts = dict(_kernels.launches)

    traffic = _serve_traffic(2026)
    futures = [[] for _ in range(SERVE_CLIENTS)]
    engine = ScoringEngine(registry).start()

    def client(t):
        for lo, n in traffic[t]:
            rows = X[lo:lo + n]
            futures[t].append([engine.submit(name, rows, tenant=name) for name, _, _ in loads])

    threads = [threading.Thread(target=client, args=(t,)) for t in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    results = [[[f.result(timeout=600) for f in per_req] for per_req in fut_t] for fut_t in futures]
    timings["traffic_s"] = time.perf_counter() - t0
    stats = engine.stats()
    engine.stop()
    counts = dict(_kernels.launches)  # read just after the serving path
    served_rows = sum(n for reqs in traffic for _, n in reqs)
    say("  launches in loads and traffic: " + ", ".join(f"{k_}={v}" for k_, v in counts.items() if v))
    say(f"  dispatches after load: {dispatches}; kNN prewarmed rungs {knn_rungs}")
    expected = blocks * (knn_rungs + dispatches["knn_bf16"])
    if counts["d2_block/f32-fast"] != expected:
        fail(f"serving: d2_block/f32-fast launched {counts['d2_block/f32-fast']} times, expected "
             f"{expected} ({blocks} item blocks x {knn_rungs + dispatches['knn_bf16']} kNN dispatches)")
    if counts["d2_block/f32"] or counts["d2_block/f64"] or counts["d2_block/f64-fast"]:
        fail(f"serving: a d2_block variant other than f32-fast launched: {counts}")
    for variant in ("f32", "f32-fast"):
        if not counts[f"assign_argmin/{variant}"] > load_counts[f"assign_argmin/{variant}"]:
            fail(f"serving: assign_argmin/{variant} did not launch for the KMeans requests")
    timings.update({
        "rows_per_model": served_rows,
        "rows_per_s": 3 * served_rows / timings["traffic_s"],
        "e2e_p50_s": stats["e2e_p50_s"], "e2e_p99_s": stats["e2e_p99_s"],
        "batches": stats["batches"], "coalesced_batches": stats["coalesced_batches"],
        "requests": stats["requests"],
        "per_model": {name: stats["tenants"][name] for name, _, _ in loads},
        "dispatches": dict(dispatches),
    })
    say(f"  traffic: {3 * SERVE_CLIENTS * SERVE_REQUESTS} requests, {served_rows} rows per model, "
        f"{timings['traffic_s']:.2f} s wall, {timings['rows_per_s']:.4g} rows/s over the three models; "
        f"{stats['batches']} batches, {stats['coalesced_batches']} of them coalesced; e2e p50 "
        f"{stats['e2e_p50_s'] * 1e3:.1f} ms, p99 {stats['e2e_p99_s'] * 1e3:.1f} ms")
    for name, _, _ in loads:
        v = stats["tenants"][name]
        say(f"    {name}: e2e p50 {v['e2e_p50_s'] * 1e3:.1f} ms, p99 {v['e2e_p99_s'] * 1e3:.1f} ms; "
            f"queue wait p50 {v['queue_wait_p50_s'] * 1e3:.1f} ms, p99 {v['queue_wait_p99_s'] * 1e3:.1f} ms")

    # every response equals the same request served alone, bit for bit
    solo_engine = ScoringEngine(registry, coalesce_window_s=0.0).start()
    t0 = time.perf_counter()
    try:
        for t in range(SERVE_CLIENTS):
            for (lo, n), got in zip(traffic[t], results[t]):
                for (name, _, _), g in zip(loads, got):
                    ref = solo_engine.score(name, X[lo:lo + n], timeout=600)
                    pairs = zip(g, ref) if isinstance(g, tuple) else [(g, ref)]
                    if not all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in pairs):
                        fail(f"serving: {name} response to rows {lo}..{lo + n} differs from the "
                             "same request served alone")
    finally:
        solo_engine.stop()
    timings["solo_s"] = time.perf_counter() - t0
    say(f"  every response equals the same request served alone, bit for bit "
        f"({timings['solo_s']:.2f} s to serve them one by one)")

    flips = total = 0
    knn_idx = {}
    for t in range(SERVE_CLIENTS):
        for (lo, n), (km32, km16, (kd, ki)) in zip(traffic[t], results[t]):
            rows = X[lo:lo + n]
            pred = np.asarray(kmeans_model.transform({"features": rows})["prediction"])
            if not np.array_equal(km32, pred):
                fail(f"serving: kmeans_f32 differs from KMeansModel.transform on rows {lo}..{lo + n}")
            flips += int((km16 != km32).sum())
            total += n
            if ki.shape != (n, KNN_K) or not np.array_equal(ki[:, 0], ids[lo:lo + n]):
                fail(f"serving: a knn_bf16 query among rows {lo}..{lo + n} does not find itself first")
            if not (np.isfinite(kd).all() and (np.diff(kd, axis=1) >= 0).all()):
                fail("serving: knn_bf16 distances not finite or not ascending")
            if t == 0:
                knn_idx[lo] = ki
    timings["kmeans_bf16_flips"] = flips
    say(f"  kmeans_f32 equals KMeansModel.transform on all {total} rows; kmeans_bf16 assigns "
        f"{flips} of them differently")
    say("  every knn_bf16 query finds its own id first")

    # the bf16 route's recall@64 against the float32 route on the resident
    # items, for client 0's query rows
    items, item_sq, _ = registry.get("knn_bf16").program.state
    lo_n = traffic[0]
    Q = torch.cat([items[lo:lo + n] for lo, n in lo_n])
    t0 = time.perf_counter()
    _, f32_idx = exact_knn(items, None, Q, k=KNN_K)
    timings["exact_knn_f32_s"] = time.perf_counter() - t0
    f32_ids = ids[f32_idx]
    bf16_ids = np.concatenate([knn_idx[lo] for lo, _ in lo_n])
    hits = sum(len(np.intersect1d(a, b)) for a, b in zip(bf16_ids, f32_ids))
    timings["recall_at_64"] = hits / f32_ids.size
    say(f"  recall@{KNN_K} of knn_bf16 against the float32 route, {len(Q)} queries: "
        f"{timings['recall_at_64']:.6f}")

    # on one 4096-row bucket, the kernel route of topk_tile(fast=True)
    # against the plain fast route on the same resident items
    lo = next(lo for lo, n in lo_n if n == KNN_QUERIES)
    q = items[lo:lo + KNN_QUERIES]
    routes = _fast_topk_routes(q, items, item_sq, KNN_K)
    (d2k, ik), (d2p, ip) = routes["kernel"], routes["plain"]
    # each route's dot product is a float32 sum of N_COLS exact bf16
    # products, in another order (tensor-core steps against cuBLAS); the
    # summation bound puts each within N_COLS * 2^-24 * ||q|| ||x|| of the
    # exact sum, so the two routes' squared distances (-2 dot) may differ by
    # up to 4 * N_COLS * 2^-24 * max ||q|| * max ||x||
    tol = 4 * N_COLS * 2.0 ** -24 * float(D.row_sq(q).max().sqrt() * item_sq.max().sqrt())
    err = float(np.abs(d2k.astype(np.float64) - d2p).max())
    if err > tol:
        fail(f"serving: kernel and plain fast squared distances differ by {err} > {tol} "
             "(the float32 summation bound)")
    swapped = np.argwhere(ik != ip)
    if len(swapped):
        r, j = swapped[:, 0], swapped[:, 1]
        qb = D._bf16(q[torch.from_numpy(r).to(dev)]).double()
        xs = items[torch.from_numpy(ik[r, j].astype(np.int64)).to(dev)]
        exact = (item_sq[torch.from_numpy(ik[r, j].astype(np.int64)).to(dev)].double()
                 - 2.0 * (qb * D._bf16(xs).double()).sum(1)).cpu().numpy()
        if (np.abs(exact - d2p[r, j]) > tol).any():
            fail(f"serving: {int((np.abs(exact - d2p[r, j]) > tol).sum())} fast index swaps are not near-ties")
    timings["fast_route_swaps"] = len(swapped)
    say(f"  fast top-k at a {KNN_QUERIES}-row bucket, kernel vs plain route: squared distances within "
        f"{err:.4g} (tol {tol:.4g}); {len(swapped)} of {ik.size} index positions differ, all near-ties")
    # where a kNN dispatch's time goes: the whole dispatch (host clock,
    # ending in a sync) against its 62 kernels and 62 merges timed alone
    program = registry.get("knn_bf16").program
    for B in (KNN_QUERIES, config["serve_max_batch_rows"]):
        rows = X[:B]
        program.dispatch(rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.dispatch(rows)
        torch.cuda.synchronize()
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        qb = items[:B]
        block = D.d2_block(qb, items[:kt], item_sq[:kt], fast=True)
        best_d2 = torch.full((B, KNN_K), float("inf"), device=dev)
        best_i = torch.zeros((B, KNN_K), dtype=torch.int32, device=dev)
        kernel_ms = cuda_ms(lambda: D.d2_block(qb, items[:kt], item_sq[:kt], fast=True))
        merge_ms = cuda_ms(lambda: D._merge(best_d2, best_i, block, 0, KNN_K))
        timings[f"dispatch_{B}"] = {"dispatch_ms": dispatch_ms, "kernel_ms": kernel_ms,
                                    "merge_ms": merge_ms}
        say(f"  one knn_bf16 dispatch at the {B}-row rung: {dispatch_ms:.1f} ms wall; {blocks} x "
            f"d2_block fast {kernel_ms:.3f} ms = {blocks * kernel_ms:.1f} ms, {blocks} x merge "
            f"{merge_ms:.3f} ms = {blocks * merge_ms:.1f} ms")
        del block, best_d2, best_i
    timings["serve_analytic_tflop"] = telemetry.registry().snapshot()["counters"].get("serve.flops", 0) / 1e12
    say(f"  analytic distance work of the traffic (the models' _serve_flop_estimate): "
        f"{timings['serve_analytic_tflop']:.2f} TFLOP, {timings['serve_analytic_tflop'] / timings['traffic_s']:.1f} "
        "TFLOP/s over its wall")
    del items, item_sq, Q, q, program
    registry.clear()

    # integer rows (exact in bf16, every sum exact in float32): the fast
    # kernel and plain routes agree exactly across item blocks, lower copy first
    n_int = 8 * kt
    gen = torch.Generator(device=dev).manual_seed(41)
    it = torch.randint(-4, 5, (n_int, N_COLS), generator=gen, device=dev, dtype=torch.float32)
    for b in (kt, 4 * kt):
        it[b:b + 64] = it[b - 64:b]
    lo = kt - KNN_QUERIES // 2
    routes = _fast_topk_routes(it[lo:lo + KNN_QUERIES], it, D.row_sq(it), KNN_K)
    (d2k, ik), (d2p, ip) = routes["kernel"], routes["plain"]
    if not (np.array_equal(ik, ip) and np.array_equal(d2k, d2p)):
        fail(f"serving: integer fast top-k differs between kernel and plain at {int((ik != ip).sum())} indices")
    orig = np.arange(kt - 64, kt)
    for rows in (orig - lo, orig + 64 - lo):
        if not (np.array_equal(ik[rows, 0], orig) and np.array_equal(ik[rows, 1], orig + 64)):
            fail("serving: a repeated row does not come lower index first in the fast top-k")
    say(f"  integer data, {KNN_QUERIES} x {n_int} x {N_COLS}, fast: kernel and plain routes equal exactly, "
        "repeated rows lower copy first across item blocks")
    del it
    telemetry.disable()
    return counts, timings


# ------------------------------------------------------------------ main --


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script needs one card", file=sys.stderr)
        return 2
    if not (ROOT / "spark_rapids_ml_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = phase_setup()
    entries = phase_kernels(dev)
    d2_entries = phase_d2_block(dev)
    t0 = time.perf_counter()
    X = _protocol_rows()
    say(f"data {X.shape} float32 made in {time.perf_counter() - t0:.1f} s")
    counts, timings, kmeans_model = phase_main_path(dev, X)
    knn_counts, knn_timings = phase_knn(dev, X, d2_entries[0]["ms"])
    serve_counts, serve_timings = phase_serving(dev, X, kmeans_model)
    for e in entries:
        e["launches"] = counts["main_path"][e["name"]]
        e["launches_by_run"] = {
            run: c[e["name"]] for run, c in counts.items() if run != "main_path"
        }
        e["launches_by_run"]["serving"] = serve_counts[e["name"]]
    for e in d2_entries:
        # each d2_block variant's own path: kneighbors runs f32, serving f32-fast
        e["launches"] = serve_counts[e["name"]] if e["name"].endswith("-fast") else knn_counts[e["name"]]
        e["launches_by_run"] = {"kneighbors": knn_counts[e["name"]], "serving": serve_counts[e["name"]]}
    entries += d2_entries
    # the kernels line lists the variants the main paths run (float32 inputs:
    # f32 and f32-fast); the f64 variants were checked and timed above
    say("KMeans path timings: " + json.dumps(timings))
    say("kNN path timings: " + json.dumps(knn_timings))
    say("serving timings: " + json.dumps(serve_timings))
    say("f64 variants (not on the float32 main path): " + json.dumps(
        [e for e in entries if "/f64" in e["name"]]))
    kernels_line = json.dumps({"kernels": [e for e in entries if "/f64" not in e["name"]]})
    say(f"total {time.perf_counter() - t_start:.1f} s")
    LOG_DIR.mkdir(exist_ok=True)
    (LOG_DIR / "chip_smoke.log").write_text("\n".join(_log_lines + [kernels_line, smi]) + "\n")
    print(kernels_line)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
