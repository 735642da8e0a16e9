#!/usr/bin/env python3
#
# Where the k-means|| seeding of a small scheduler job goes, on one NVIDIA
# card: chip_smoke.py's phase-17 small job, KMeans(k=100, maxIter=10,
# seed=3) on the first 100,000 of the protocol rows (x 3000 float32, the
# same rows as chip_smoke._protocol_rows()[:100000], made without the other
# 900,000).
#
# It prints:
#   * the whole fit with the default k-means|| seeding and with random init
#     (each after one unmeasured fit of its own, so no build or first-call
#     cost is in either);
#   * the seeding call alone (ops/kmeans.scalable_kmeans_init, as the
#     estimator calls it), wall seconds, and the card's busy time in it from
#     torch.profiler (the sum of the device time of every kernel and copy;
#     "not measured" when the profiler sees no device time); the rest of the
#     wall time is the host's, since every round waits for the card;
#   * the host steps of the seeding timed alone: the subsample's float64
#     conversion and the cast back to float32, one round's weighted draw
#     without replacement (numpy), and the copy of the rows to the card.
#
# Run from the repository root on a machine with the card and nvcc:
#     python3 tools/kmeans_seeding_split.py
# It prints one JSON object last.
#
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ROWS, K_SMALL, SEED = 100_000, 100, 3


def protocol_head(n_take, n_rows=1_000_000, n_cols=3000, k=1000, step=65536):
    """The first `n_take` rows of chip_smoke._protocol_rows(), generated
    chunk by chunk from the same seed sequence."""
    seq = np.random.SeedSequence(2024)
    rng = np.random.default_rng(seq)
    true_centers = rng.standard_normal((k, n_cols), dtype=np.float32) * 4.0
    labels = rng.integers(0, k, size=n_rows)
    starts = list(range(0, n_rows, step))
    chunk_seeds = seq.spawn(len(starts))
    hi_all = min(n_take, n_rows)
    X = np.empty((-(-hi_all // step) * step, n_cols), dtype=np.float32)
    for i, lo in enumerate(starts):
        if lo >= hi_all:
            break
        hi = min(lo + step, n_rows)
        np.random.default_rng(chunk_seeds[i]).standard_normal(dtype=np.float32, out=X[lo:hi])
        X[lo:hi] += true_centers[labels[lo:hi]]
    return X[:hi_all]


def _wall(fn, sync):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _device_seconds(fn):
    """(the call's result, seconds of device time in it) from torch.profiler,
    or None for the seconds when the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        total_us += float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) or 0.0)
    return out, (total_us / 1e6 if total_us > 0 else None)


def main():
    import torch

    if not torch.cuda.is_available():
        print("kmeans_seeding_split: no CUDA device is visible", file=sys.stderr)
        return 2
    from spark_rapids_ml_tpu_torch import KMeans
    from spark_rapids_ml_tpu_torch.ops import kmeans as KM

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    x = protocol_head(ROWS)
    data = {"features": x}
    out = {"card": smi, "rows": ROWS, "cols": int(x.shape[1]), "k": K_SMALL}
    for mode in ("k-means||", "random"):
        est = KMeans(k=K_SMALL, maxIter=10, seed=SEED, initMode=mode)
        est.fit(data)  # unmeasured: kernels built, first calls made
        _, out[f"fit_{mode}_s"] = _wall(lambda: KMeans(k=K_SMALL, maxIter=10, seed=SEED, initMode=mode).fit(data),
                                        sync)

    def seed_once():
        return KM.scalable_kmeans_init(x, K_SMALL, SEED, None, device=dev)

    seed_once()
    _, out["seeding_s"] = _wall(seed_once, sync)
    _, dev_s = _device_seconds(seed_once)
    out["seeding_device_s"] = dev_s
    out["seeding_host_s"] = None if dev_s is None else out["seeding_s"] - dev_s
    rng = np.random.default_rng(SEED)
    (sub, _), out["host_subsample_f64_s"] = _wall(lambda: KM._init_subsample(x, None, rng), lambda: None)
    sub32, out["host_cast_f32_s"] = _wall(lambda: sub.astype(np.float32), lambda: None)
    p = np.abs(np.random.default_rng(1).standard_normal(sub32.shape[0]))
    _, out["host_one_round_draw_s"] = _wall(
        lambda: rng.choice(sub32.shape[0], size=2 * K_SMALL, replace=False, p=p / p.sum()), lambda: None)
    _, out["rows_to_card_s"] = _wall(lambda: torch.from_numpy(sub32).to(dev), sync)
    print(f"  {ROWS} x {x.shape[1]} float32, k = {K_SMALL}: fit with k-means|| {out['fit_k-means||_s']:.4f} s, "
          f"with random init {out['fit_random_s']:.4f} s; the seeding alone {out['seeding_s']:.4f} s, of it on "
          f"the card {'not measured' if dev_s is None else f'{dev_s:.4f} s'}; host steps alone: subsample "
          f"to float64 {out['host_subsample_f64_s']:.4f} s, cast to float32 {out['host_cast_f32_s']:.4f} s, one "
          f"round's draw {out['host_one_round_draw_s']:.4f} s; rows to the card {out['rows_to_card_s']:.4f} s",
          flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
