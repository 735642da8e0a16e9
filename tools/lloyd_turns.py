#!/usr/bin/env python3
#
# The KMeans Lloyd iteration of two trees of the port on one NVIDIA card, in
# turns (earlier, current, current, earlier), each turn a process of its own
# on the same data: chip_smoke.py's protocol rows (1M x 3000 float32 around
# 1000 Gaussian centers, from its seed), placed on the card once per turn,
# and centers after three `high` iterations from 1000 seeded rows.
#
# Each turn prints, for `fast` and `high`:
#   * the iteration's wall time (host clock from the call to the read of its
#     shift, which waits for the card), over several iterations;
#   * the host's time to enqueue one iteration (the call's return, before
#     that read): where it is close to the wall time, the host holds the
#     card back;
#   * one Lloyd tile (the first 32768 rows) taken apart on the card alone
#     (chip_smoke.device_ms: queued behind a spin of the card, so the host's
#     launch time is not in it): the whole tile step
#     (distance.assign_accumulate), the argmin, the accumulation, and the
#     inertia term (row norms, clamp, weighted sum). An iteration is about
#     30.5 such tiles.
#
# Run from the repository root on a machine with the card and nvcc, after
# unpacking the earlier tree, for example with
#     git archive <commit> | tar -x -C build/parent
# then
#     python3 tools/lloyd_turns.py --earlier build/parent
#
# It prints each turn and, last, one JSON object of all of them.
#
import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    """This tree's chip_smoke.py (data and timing helpers), loaded by path,
    so an earlier tree first on sys.path does not shadow it."""
    spec = importlib.util.spec_from_file_location("chip_smoke_current", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def one_turn(tree: Path) -> dict:
    """Time the Lloyd iteration of the port in `tree` (module note)."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    cs = _chip_smoke()
    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.ops import kmeans as KM

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    assert Path(D.__file__).resolve().is_relative_to(tree.resolve()), D.__file__
    X = cs._protocol_rows()
    Xd = torch.from_numpy(X).to(dev)
    del X
    wd = torch.ones(Xd.shape[0], device=dev)
    rows = np.random.default_rng(1).choice(Xd.shape[0], cs.K, replace=False)
    centers = Xd[torch.from_numpy(rows).to(dev)].clone()
    for _ in range(3):
        centers, _, shift = KM._lloyd_step(Xd, wd, centers, cs.TILE_ROWS, False)
    float(shift)
    out = {"tree": str(tree), "card": torch.cuda.get_device_name(0)}
    xb, wb = Xd[:cs.TILE_ROWS], wd[:cs.TILE_ROWS]
    for fast in (True, False):
        mode = "fast" if fast else "high"

        def step():
            return KM._lloyd_step(Xd, wd, centers, cs.TILE_ROWS, fast)

        float(step()[2])
        wall, enqueue = [], []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            shift = step()[2]
            enqueue.append((time.perf_counter() - t0) * 1e3)
            float(shift)
            wall.append((time.perf_counter() - t0) * 1e3)
        mind, best = D.assign_argmin(xb, centers, fast=fast)
        tile = {
            "tile_step": cs.device_ms(lambda: D.assign_accumulate(xb, wb, centers, fast=fast), reps=5),
            "argmin": cs.device_ms(lambda: D.assign_argmin(xb, centers, fast=fast), reps=5),
            "accumulate": cs.device_ms(lambda: D.accumulate(xb, wb, best, cs.K, fast=fast), reps=5),
            "inertia_term": cs.device_ms(
                lambda: torch.sum(torch.clamp_min(mind + D.row_sq(xb), 0.0) * wb), reps=5),
        }
        out[mode] = {"wall_ms": wall, "enqueue_ms": enqueue, "tile_device_ms": tile}
        print(f"  {tree.name or tree} {mode}: wall {', '.join(f'{t:.1f}' for t in wall)} ms; host enqueue "
              f"{', '.join(f'{t:.1f}' for t in enqueue)} ms; one tile on the card alone: "
              + ", ".join(f"{k} {v:.3f}" for k, v in tile.items()), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--earlier", help="root of the earlier tree (holding spark_rapids_ml_tpu_torch/)")
    ap.add_argument("--one", help="time one tree in this process and print its JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lloyd_turns: no CUDA device is visible", file=sys.stderr)
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
