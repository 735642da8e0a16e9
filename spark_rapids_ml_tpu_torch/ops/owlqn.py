#
# The solver family's shared divergence guard, the part of
# spark_rapids_ml_tpu/ops/owlqn.py that PCA (ops/pca.py) needs now. The
# OWL-QN minimizer itself arrives with LogisticRegression (ROADMAP A7), and
# `freeze_when_done` with the batched sweeps it makes vmap-safe (A9).
#
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import telemetry


def check_solver_state(
    solver: str,
    state: dict,
    *,
    scalars: Tuple[str, ...] = ("objective_",),
    arrays: Tuple[str, ...] = ("coef_", "intercept_"),
) -> dict:
    """Host-side divergence guard on the values the model layer fetches
    anyway (no extra device sync): non-finite state raises
    `SolverDivergedError` carrying the iteration count and whatever parts
    of the state are still finite as the last-good iterate. Returns `state`
    unchanged so call sites can wrap."""
    from ..errors import SolverDivergedError

    bad = []
    for key in scalars:
        if key in state and not np.isfinite(_host(state[key])).all():
            bad.append(key)
    for key in arrays:
        if key in state and not np.isfinite(_host(state[key])).all():
            bad.append(key)
    if not bad:
        return state
    n_iter = int(_host(state.get("n_iter_", 0)))
    last_good = {
        k: _host(v)
        for k, v in state.items()
        if k not in bad and isinstance(v, (np.ndarray, torch.Tensor))
        and np.isfinite(_host(v)).all()
    }
    telemetry.registry().inc("solver.divergence")
    telemetry.registry().inc(f"{solver}.divergence")
    raise SolverDivergedError(
        solver, n_iter, last_good=last_good, detail=f"non-finite {', '.join(bad)}"
    )


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
