#!/usr/bin/env python3
#
# LinearRegression's coordinate descent (ops/linear.py) of two trees of the
# port on one NVIDIA card, in turns (earlier, current, current, earlier),
# each turn a process of its own: the statistics of 20,000 x 3000 float32
# rows from a seed (a sweep's cost depends on d alone), then 10 sweeps
# (tol 1e-30, regParam 1e-5, elasticNetParam 0.5, standardization on)
# through `_solve_from_stats`, timed on the host clock after the card is
# synchronized: the sweep is launch-bound, 3000 coordinates of ~15 small
# launches each. A tree with the batched grid (`_solve_grid_from_stats`)
# also times grids of 2 and 4 points, regParam 1e-5 to 1e-3.
#
# Run from the repository root on a machine with the card, after unpacking
# the earlier tree, for example with
#     git archive <commit> | tar -x -C build/parent
# then
#     python3 tools/cd_turns.py --earlier build/parent
#
# It prints each turn and, last, one JSON object of all of them.
#
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N, D, SWEEPS = 20_000, 3000, 10


def one_turn(tree: Path) -> dict:
    """Time the coordinate descent of the port in `tree` (module note)."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from spark_rapids_ml_tpu_torch.ops import linear as LR

    assert Path(LR.__file__).resolve().is_relative_to(tree.resolve()), LR.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32)).to(dev)
    y = x @ torch.from_numpy((rng.standard_normal(D) / np.sqrt(D)).astype(np.float32)).to(dev)
    stats = LR._sufficient_stats(x, y, torch.ones(N, device=dev))
    kw = dict(fit_intercept=True, standardize=True, use_cd=True, max_iter=SWEEPS, tol=1e-30)

    def sweep_ms(fn):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / SWEEPS

    out = {"tree": str(tree), "card": torch.cuda.get_device_name(0),
           "single_sweep_ms": sweep_ms(lambda: LR._solve_from_stats(stats, x.dtype, alpha=1e-5, l1_ratio=0.5, **kw))}
    if hasattr(LR, "_solve_grid_from_stats"):
        for s in (2, 4):
            regs = list(np.logspace(-5, -3, s))
            out[f"grid{s}_sweep_ms"] = sweep_ms(
                lambda: LR._solve_grid_from_stats(stats, x.dtype, regs, [0.5] * s, **kw))
    print(f"  {tree.name or tree}: " + ", ".join(f"{k} {v:.1f}" for k, v in out.items() if k.endswith("_ms")),
          flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--earlier", help="root of the earlier tree (holding spark_rapids_ml_tpu_torch/)")
    ap.add_argument("--one", help="time one tree in this process and print its JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("cd_turns: no CUDA device is visible", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one_turn(Path(args.one))))
        return 0
    if not args.earlier:
        ap.error("--earlier is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    turns = []
    for name, tree in (("earlier", args.earlier), ("current", ROOT), ("current", ROOT),
                       ("earlier", args.earlier)):
        done = subprocess.run([sys.executable, __file__, "--one", str(Path(tree).resolve())],
                              capture_output=True, text=True, timeout=300)
        lines = done.stdout.splitlines()
        print("\n".join(lines[:-1]), flush=True)
        if done.returncode != 0:
            sys.stderr.write(done.stderr)
            return done.returncode
        turns.append({"who": name, **json.loads(lines[-1])})
    print(json.dumps({"card": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
