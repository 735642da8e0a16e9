#
# PCA solver on one device: the PyTorch counterpart of
# spark_rapids_ml_tpu/ops/pca.py (`pca_fit`, `_pca_finish`, `pca_transform`,
# `check_pca_state`, `record_pca_fit`).
#
# One pass over the rows for the weighted mean and covariance
# (ops/linalg.weighted_cov: the mean, then the centered contraction over row
# tiles), then the d x d symmetric eigendecomposition, top-k descending, and
# the sign canonicalization. The streamed fit is
# ops/streaming.pca_fit_streaming. The checkpointed fit
# (`pca_fit_checkpointed`) retains (total_w, mean, covariance) on the host
# in the fit stage's checkpoint store (checkpoint.py) under the JAX
# package's key "pca_stats" (":bf16" apart), so a retry re-runs only the
# d x d eigendecomposition.
#
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import telemetry
from .linalg import rows_dot_fixed, sign_flip, topk_eigh_desc, weighted_cov


def check_pca_state(state: Dict, *, k: int) -> Dict:
    """Divergence guard on a host-fetched PCA state: a non-finite input row
    makes the covariance, and so the components and variances, NaN. Raises
    SolverDivergedError (iteration 0: a one-shot solver has no n_iter_)
    keeping the finite attributes as the last-good payload; returns `state`
    untouched otherwise."""
    from .owlqn import check_solver_state

    return check_solver_state(
        "pca", state,
        scalars=(),
        arrays=("components_", "explained_variance_", "mean_"),
    )


def record_pca_fit(state: Dict, *, k: int) -> None:
    """Telemetry for a completed `pca_fit`, on the host-fetched state: the
    fit counter, the component count and the captured variance ratio."""
    if not telemetry.enabled():
        return
    reg = telemetry.registry()
    reg.inc("pca.fits")
    reg.gauge("pca.n_components", k)
    reg.gauge(
        "pca.explained_variance_ratio_sum",
        float(np.sum(np.asarray(state["explained_variance_ratio_"]))),
    )


def pca_fit(X: torch.Tensor, w: torch.Tensor, *, k: int, fast: bool = False) -> Dict[str, torch.Tensor]:
    """Fit PCA on rows X [n, d] with weights w [n], on X's device. Returns
    mean_, components_ (unit rows), explained_variance_,
    explained_variance_ratio_ and singular_values_. `fast` runs the
    covariance contraction bf16-in / float32-accumulate; the
    eigendecomposition and every reported variance stay full precision."""
    total_w, mean, cov = weighted_cov(X, w, ddof=1, fast=fast)
    return _pca_finish(total_w, mean, cov, k=k)


def pca_fit_checkpointed(
    X: torch.Tensor, w: torch.Tensor, *, k: int, fast: bool = False, ckpt_key: str = "pca_stats", placement_key=None,
) -> Dict[str, torch.Tensor]:
    """`pca_fit` with the statistics of its one pass, (total_w, mean,
    covariance), retained on the host in the active checkpoint store: a
    transient retry, or a k sweep of the stage, re-runs only the d x d
    eigendecomposition (``checkpoint.stats_reuses``). The same statistics
    and finish as `pca_fit`; a `fast` pass is keyed apart."""
    from ..checkpoint import retained

    def compute():
        total_w, mean, cov = weighted_cov(X, w, ddof=1, fast=fast)
        flat = torch.cat([total_w.reshape(1), mean, cov.reshape(-1)]).cpu().numpy()  # one copy
        d = mean.shape[0]
        return {"total_w": flat[0].copy(), "mean": flat[1:1 + d], "cov": flat[1 + d:].reshape(d, d)}

    state = retained(ckpt_key + (":bf16" if fast else ""), compute, solver="pca", placement_key=placement_key)
    total_w, mean, cov = (
        torch.from_numpy(np.array(state[n])).to(device=X.device, dtype=X.dtype) for n in ("total_w", "mean", "cov")
    )
    return _pca_finish(total_w, mean, cov, k=k)


def _pca_finish(total_w, mean, cov, *, k: int) -> Dict[str, torch.Tensor]:
    if bool(torch.isfinite(cov).all()):
        evals, comps = topk_eigh_desc(cov, k)
    else:
        # a non-finite covariance gives NaN components and variances, as
        # the JAX package's eigh does, whatever the device's eigensolver
        # would do with it; check_pca_state then raises
        evals = torch.full((k,), float("nan"), dtype=cov.dtype, device=cov.device)
        comps = torch.full((k, cov.shape[0]), float("nan"), dtype=cov.dtype, device=cov.device)
    evals = torch.clamp_min(evals, 0.0)
    comps = sign_flip(comps)
    total_var = torch.trace(cov)
    return {
        "mean_": mean,
        "components_": comps,
        "explained_variance_": evals,
        "explained_variance_ratio_": evals / total_var,
        "singular_values_": torch.sqrt(evals * (total_w - 1.0)),
    }


def pca_transform(
    X: torch.Tensor, components: torch.Tensor, explained_variance: torch.Tensor, *, whiten: bool = False
) -> torch.Tensor:
    """Project rows onto the principal axes without mean-centering, as Spark
    ML's PCA.transform does: ``X @ componentsᵀ``, scaled by 1/√eigenvalue
    when whitening. Each row's projection is summed in a fixed order
    (`linalg.rows_dot_fixed`), so it does not depend on its batch."""
    T = rows_dot_fixed(X, components)
    if whiten:
        T = T * torch.rsqrt(torch.clamp_min(explained_variance, 1e-30))
    return T
