#!/usr/bin/env python3
#
# How exact a float32 LogisticRegression objective is when the solver's
# vector algebra runs on the CPU: one resident fit and one streamed fit
# (demoted by `hbm_budget_bytes`) of the port on the CPU, on 300,000 x 16
# float32 rows in 16 blobs from a seed with chip_smoke.py's two-class
# labels (regParam 1e-5, maxIter 10), each reported objective against the
# objective recomputed in float64 from the fit's own coefficients. The
# resident fit sums its step candidates' losses with a float32 GEMV over all
# the rows; the streamed fit runs that algebra in float64 on the host.
#
# Run from the repository root:
#     python3 tools/glm_host_objective.py
#
import sys

import numpy as np

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402
from spark_rapids_ml_tpu_torch import LogisticRegression, set_devices  # noqa: E402
from spark_rapids_ml_tpu_torch.core import config  # noqa: E402

N, D, K = 300_000, 16, 16
PARAMS = {"regParam": 1e-5, "elasticNetParam": 0.0, "maxIter": 10, "tol": 1e-30}
BUDGET = 17_000_000  # demotes the 19.2 MB rows; a few chunks a pass


def objective64(model, X, y):
    z = X @ model.coef_.astype(np.float64)[0] + float(model.intercept_[0])
    B = model.coef_.astype(np.float64)[0] * X.std(axis=0, ddof=1)
    return np.mean(np.logaddexp(0.0, z) - y * z) + 0.5 * PARAMS["regParam"] * np.sum(B * B)


def main():
    set_devices("cpu")
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((N, D)) + 4 * rng.standard_normal((K, D))[rng.integers(0, K, N)]).astype(np.float32)
    y = cs._class_labels(X, 2)
    data = {"features": X, "label": y}
    fits = {"resident": LogisticRegression(**PARAMS).fit(data)}
    config["hbm_budget_bytes"] = BUDGET
    try:
        fits["streamed"] = LogisticRegression(**PARAMS).fit(data)
    finally:
        config["hbm_budget_bytes"] = None
    X64 = X.astype(np.float64)
    for name, m in fits.items():
        f64 = objective64(m, X64, y)
        print(f"{name}: reported {float(m.objective_)!r}, float64 {float(f64)!r}, "
              f"relative {abs(float(m.objective_) - f64) / f64:.3g}")


if __name__ == "__main__":
    main()
