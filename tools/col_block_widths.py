#!/usr/bin/env python3
#
# The GLM solvers' two products over chip_smoke.py's protocol rows (1M x
# 3000 float32, from its seed) on one NVIDIA card, TF32 off, each timed
# with CUDA events (chip_smoke.cuda_ms, mean of 5 after a warm-up) beside
# the bound of one read of X at 3.35 TB/s:
#
#   * at each column count a block of ops/logistic.py `_col_blocks` may
#     have: X·B ([n, d] x [d, w]) and Xᵀ·R ([d, n] x [n, w]) through
#     torch.mm (cuBLAS) for w in 1, 2, 4, 8 and 16, and the GEMVs
#     (torch.mv) of one column. A block of w columns serves w / k_out grid
#     points of one pass over X;
#   * other fixed-shape forms of the 8-column block, in float32, with bf16
#     operands (`linalg.mm_bf16`) and in float64 (X cast on the card): the
#     transposed GEMM (Bᵀ·Xᵀ, Rᵀ·X), which `_col_blocks` runs, and, but for
#     bf16, Xᵀ·R summed over 8 or 32 fixed row chunks (one batched GEMM,
#     then the chunks added in order). For each form it checks that a
#     column's product is the same bits at position 0 of a block (a single
#     fit) as at position 5 beside seven others (a grid), which any form of
#     the solvers must keep.
#
# Run from the repository root on a machine with the card:
#     python3 tools/col_block_widths.py
#
# It prints one line per width and per form and, last, one JSON object of
# all of them.
#
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = (1, 2, 4, 8, 16)
BLOCK = 8


def _forms(torch, mm):
    """name -> (X·B, Xᵀ·R) of one 8-column block, each returning a
    contiguous [rows, 8] result."""

    def chunked(c):
        def rmat(X, R):
            n, d = X.shape
            return torch.bmm(X.view(c, n // c, d).transpose(1, 2), R.view(c, n // c, BLOCK)).sum(0)

        return rmat

    return {
        "mm": (lambda X, B: mm(X, B), lambda X, R: mm(X.T, R)),
        "mm_transposed": (lambda X, B: mm(B.T, X.T).T.contiguous(), lambda X, R: mm(R.T, X).T.contiguous()),
        "rmat_chunks_8": (None, chunked(8)),
        "rmat_chunks_32": (None, chunked(32)),
    }


def main():
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("col_block_widths: no CUDA device is visible", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    X = torch.from_numpy(cs._protocol_rows()).to(dev)
    n, d = X.shape
    bound_ms = n * d * 4 / cs.PEAK_BYTES_S * 1e3
    out = {"card": smi, "bound_ms": bound_ms, "widths": {}, "forms": {}}
    b1, r1 = torch.randn(d, device=dev), torch.randn(n, device=dev)
    out["gemv"] = {"matvec_ms": cs.cuda_ms(lambda: torch.mv(X, b1)), "rmat_ms": cs.cuda_ms(lambda: torch.mv(X.T, r1))}
    print(f"  GEMV: X·b {out['gemv']['matvec_ms']:.3f} ms, Xᵀ·r {out['gemv']['rmat_ms']:.3f} ms "
          f"(bound {bound_ms:.3f} ms each)", flush=True)
    for w in WIDTHS:
        B = torch.randn((d, w), device=dev)
        R = torch.randn((n, w), device=dev)
        mm = cs.cuda_ms(lambda: torch.mm(X, B))
        rm = cs.cuda_ms(lambda: torch.mm(X.T, R))
        out["widths"][w] = {"matvec_ms": mm, "rmat_ms": rm}
        print(f"  w={w}: X·B {mm:.3f} ms, Xᵀ·R {rm:.3f} ms (bound {bound_ms:.3f} ms each)", flush=True)
    from spark_rapids_ml_tpu_torch.ops.linalg import mm_bf16

    bX = X.to(torch.bfloat16)
    B = torch.randn((d, BLOCK), device=dev)
    R = torch.randn((n, BLOCK), device=dev)
    alone_B, alone_R = torch.zeros_like(B), torch.zeros_like(R)
    alone_B[:, 0], alone_R[:, 0] = B[:, 5], R[:, 5]
    X64 = X.double()
    B64, R64 = B.double(), R.double()
    alone_B64, alone_R64 = alone_B.double(), alone_R.double()
    for prec, A, mm in (("f32", X, torch.mm), ("bf16", bX, mm_bf16), ("f64", X64, torch.mm)):
        if prec == "f64":
            B, R, alone_B, alone_R = B64, R64, alone_B64, alone_R64
        for name, (matvec, rmat) in _forms(torch, mm).items():
            if prec == "bf16" and name.startswith("rmat_chunks"):
                continue  # torch.bmm has no bf16-operand, float32-sum form
            row = {}
            for op, fn, Y, Y1 in (("matvec", matvec, B, alone_B), ("rmat", rmat, R, alone_R)):
                if fn is None:
                    continue
                row[f"{op}_ms"] = cs.cuda_ms(lambda: fn(A, Y))
                row[f"{op}_position_free"] = bool(torch.equal(fn(A, Y)[:, 5], fn(A, Y1)[:, 0]))
            out["forms"][f"{prec}/{name}"] = row
            print(f"  {prec} {name}: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                               for k, v in row.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
