#!/usr/bin/env python3
#
# One-off comparisons of the d2_block kernel (spark_rapids_ml_tpu_torch/
# csrc/d2_block.cu) on one NVIDIA card, beside chip_smoke.py:
#
#   1. against an earlier d2_block.cu: a directory holding that source and
#      the headers it includes, for example unpacked from git with
#          git archive <commit> spark_rapids_ml_tpu_torch/csrc | tar -x -C build/earlier
#      The float32 outputs of the two must be equal bit for bit at the kNN
#      tile (4096 x 16,384 x 3000), at ragged shapes and at the serving
#      rungs; then the float32 and `fast` forms of both are timed in turns
#      (earlier, current, current, earlier) at the kNN tile;
#   2. the float32 form's launch order: the shipped order (item tiles or
#      query tiles fastest) against the other one, built from a copy of the
#      source with the order swapped, equal bit for bit and timed in turns.
#
# Everything is built with the flags of ops/_kernels.py into
# build/variants/. Run from the repository root, on a machine with the card
# and nvcc:
#
#     python3 tools/d2_block_variants.py --earlier build/earlier/spark_rapids_ml_tpu_torch/csrc
#
# It prints each result and, last, one JSON object of all of them.
#
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repository's timing and data helpers)

OUT = ROOT / "build" / "variants"

# the two launch orders of the float32 kernel, as its source writes them
ORDERS = {
    "item tiles fastest": (
        "  const int n0 = (blockIdx.x % n_it) * f32core::BN;  // items: the fastest\n"
        "  const int m0 = (blockIdx.x / n_it) * f32core::BM;  // queries\n",
        "  const int n_it = tiles(kt, f32core::BN);\n"
        "  const dim3 grid(tiles(B, f32core::BM) * n_it);\n",
    ),
    "query tiles fastest": (
        "  const int m0 = (blockIdx.x % n_it) * f32core::BM;  // queries: the fastest\n"
        "  const int n0 = (blockIdx.x / n_it) * f32core::BN;  // items\n",
        "  const int n_it = tiles(B, f32core::BM);\n"
        "  const dim3 grid(tiles(kt, f32core::BN) * n_it);\n",
    ),
}


def nvcc_build(src, include, name):
    from spark_rapids_ml_tpu_torch.ops import _kernels

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(include), "-o", str(lib), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib))


def bind(lib, current):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.srml_d2_block_f32.argtypes = [p, p, p, p, i, i, i, i, p] if current else [p, p, p, p, i, i, i, p]
    lib.srml_d2_block_f32.restype = i
    if not current:
        lib.srml_d2_block_fast_f32.argtypes = [p, p, p, p, i, i, i, p]
        lib.srml_d2_block_fast_f32.restype = i
    return lib


def order_variant():
    """The shipped source with the float32 launch order swapped; returns
    (the shipped order's name, the other's name, the built library)."""
    from spark_rapids_ml_tpu_torch.ops import _kernels

    text = (_kernels._CSRC / "d2_block.cu").read_text()
    shipped = [k for k, (kernel, host) in ORDERS.items() if kernel in text and host in text]
    if len(shipped) != 1:
        raise RuntimeError("d2_block.cu does not write its float32 launch order as this script expects")
    other = next(k for k in ORDERS if k != shipped[0])
    for a, b in zip(ORDERS[shipped[0]], ORDERS[other]):
        text = text.replace(a, b)
    src = OUT / "d2_block_order.cu"
    OUT.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    return shipped[0], other, bind(nvcc_build(src, _kernels._CSRC, "d2_block_order"), True)


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--earlier", required=True, help="directory holding the earlier d2_block.cu and its headers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("d2_block_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    dev = torch.device("cuda", 0)
    smi = cs.phase_setup()
    earlier_dir = Path(args.earlier).resolve()
    earlier = bind(nvcc_build(earlier_dir / "d2_block.cu", earlier_dir, "d2_block_earlier"), False)
    shipped, other, variant = order_variant()
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def run_earlier(q, xt, xt_sq, fast=False):
        B, d = q.shape
        kt = xt.shape[0]
        out = torch.empty((B, kt), dtype=q.dtype, device=dev)
        fn = earlier.srml_d2_block_fast_f32 if fast else earlier.srml_d2_block_f32
        _kernels._raise_on("earlier d2_block", fn(q.data_ptr(), xt.data_ptr(), xt_sq.data_ptr(),
                                                  out.data_ptr(), B, kt, d, stream()))
        return out

    def run_variant(q, xt, xt_sq):
        B, d = q.shape
        kt = xt.shape[0]
        out = torch.empty((B, kt), dtype=q.dtype, device=dev)
        vec = d % 4 == 0 and q.data_ptr() % 16 == 0 and xt.data_ptr() % 16 == 0
        _kernels._raise_on("d2_block order variant", variant.srml_d2_block_f32(
            q.data_ptr(), xt.data_ptr(), xt_sq.data_ptr(), out.data_ptr(), B, kt, d, int(vec), stream()))
        return out

    result = {"card": smi, "shipped_order": shipped, "other_order": other, "bit_for_bit": []}
    kt = D._DEFAULT_K_TILE
    shapes = [(cs.KNN_QUERIES, kt, cs.N_COLS), (cs.KNN_QUERIES - 1, kt - 1, cs.N_COLS), (37, 5, 3),
              (1000, 1001, 77), (129, 130, 16)] + [(b, 1001, cs.N_COLS) for b in cs.SERVE_RUNGS]
    for B, kt_, d in shapes:
        q, xt = cs._d2_inputs(B, kt_, d, np.float32, False, B + kt_ + d, dev)
        xt_sq = D.row_sq(xt)
        cur = _kernels.d2_block(q, xt, xt_sq)
        same_earlier = torch.equal(cur, run_earlier(q, xt, xt_sq))
        same_order = torch.equal(cur, run_variant(q, xt, xt_sq))
        result["bit_for_bit"].append({"shape": [B, kt_, d], "earlier": same_earlier, "other_order": same_order})
        cs.say(f"  float32 {B}x{kt_}x{d} Gaussian: equal to the earlier kernel bit for bit: {same_earlier}; "
               f"to the {other} build: {same_order}")
        del q, xt, xt_sq, cur

    q, xt = cs._d2_inputs(cs.KNN_QUERIES, kt, cs.N_COLS, np.float32, False, 9, dev)
    xt_sq = D.row_sq(xt)
    flops = 2.0 * cs.KNN_QUERIES * kt * cs.N_COLS
    timed = {}
    pairs = {
        "f32": (lambda: run_earlier(q, xt, xt_sq), lambda: _kernels.d2_block(q, xt, xt_sq)),
        "f32-fast": (lambda: run_earlier(q, xt, xt_sq, fast=True),
                     lambda: _kernels.d2_block(q, xt, xt_sq, fast=True)),
        "f32 order": (lambda: run_variant(q, xt, xt_sq), lambda: _kernels.d2_block(q, xt, xt_sq)),
    }
    for form, (first, second) in pairs.items():
        names = (other, shipped) if form == "f32 order" else ("earlier", "current")
        ms = {names[0]: [], names[1]: []}
        for who in (0, 1, 1, 0):
            ms[names[who]].append(cs.cuda_ms(first if who == 0 else second))
        timed[form] = {k: {"ms": v, "tflops": [flops / t / 1e9 for t in v]} for k, v in ms.items()}
        cs.say(f"  {form} at {cs.KNN_QUERIES}x{kt}x{cs.N_COLS}, in turns: " + "; ".join(
            f"{k} {', '.join(f'{t:.3f}' for t in v)} ms" for k, v in ms.items()))
    result["timed"] = timed
    print(json.dumps(result))
    return 0 if all(r["earlier"] and r["other_order"] for r in result["bit_for_bit"]) else 1


if __name__ == "__main__":
    sys.exit(main())
