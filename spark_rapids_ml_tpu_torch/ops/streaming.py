#
# Out-of-core solvers: the fits of datasets whose resident placement
# does not fit the card. The PyTorch counterpart of the dense forms of
# spark_rapids_ml_tpu/ops/streaming.py.
#
# Every solver here reads a `FitInputs` whose `stream` carries a `core.StreamPlan`
# (the host blocks and the admitted chunk rows) and feeds row chunks through
# the double-buffered pipeline (`parallel.stream_place_blocks`: chunk N+1's
# copy in flight while chunk N computes). The solvers are written around
# state that accumulates over chunks, so only two chunks are ever on the
# card:
#
#   linear / PCA   sufficient statistics (XᵀWX, XᵀWy / mean and centered
#                  covariance) summed over the chunks, then the SAME d x d
#                  solve as the resident fit (ops/linear._solve_from_stats,
#                  ops/pca._pca_finish);
#   logistic       the resident GLM solver (ops/logistic._fit_common) with
#                  its two products served chunk by chunk: X·B the chunks'
#                  products concatenated, Xᵀ·R the chunks' products summed,
#                  so an iteration reads X twice, as the resident loop
#                  does; the per-row state (logits, labels, weights: n x
#                  k_out) and the solver's vector algebra (in float64)
#                  stay on the host, as in the JAX package;
#   k-means        the resident Lloyd loop (ops/kmeans.lloyd_loop) with a
#                  step that runs each chunk through
#                  `distance.tile_assign_accumulate` at the fit's
#                  `batch_rows` (B1 and B2 on the card) into ONE set of
#                  device accumulators: the chunks are whole tiles, so the
#                  sums are the resident loop's additions in its order.
#
# Linear and PCA fetch each chunk's partials to the host and sum them there
# in chunk order, as the JAX package does; their formulas are the resident
# ones, only the summation order differs, so a streamed fit equals the
# resident one to accumulation rounding (tests/test_torch_oocore.py: rtol
# 1e-9 in float64). `fast` (bf16 products with float32 sums) rounds each
# chunk on the card and keeps no bf16 copy of X.
#
# CSR fits stream padded-ELL blocks (values and int32 indices at the
# global k_max) through the same pipeline and the same solvers: linear's
# statistics per chunk are ops/linear._ell_sufficient_stats, converted
# chunk by chunk and kept nowhere (`_ell_block_iter(cache=False)`); the GLM
# converts once per fit and keeps the host blocks on the plan
# (`_ell_host_blocks`), since it passes over them twice an iteration. Its
# chunk products are ops/logistic._ell_ops' (the JAX package's
# `_glm_search_block_ell` is the chunk's X·B, `_glm_grad_block_ell` its
# Xᵀ·R; its `_glm_eval_block_ell`, logits, loss and gradient at one point,
# has no counterpart, since `_fit_common` asks for the products alone),
# each chunk's column grouping made anew per pass; its scaling is
# scale-only (`_ell_moments_block`).
#
# Under SRML_NUMCHECK=1 (utils/numcheck.py) the host values are swept for
# NaN/Inf where they already are on the host: linear's and PCA's per-chunk
# partials (`linear_stream.chunk`, `pca_stream.chunk`, `pca_stream.stats`),
# the streamed Lloyd loop's shift read (`kmeans_stream.iterate`; its chunk
# partials stay on the card, so the JAX package's `kmeans_stream.chunk` has
# no counterpart) and the streamed GLM's outer iterations
# (`glm_stream.iterate`, ops/logistic._glm_qn_steps).
#
# Not here, named in ROADMAP: the checkpoint store and its keys (A12).
#
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..parallel import stream_place_blocks
from ..utils import numcheck

# the names of ops/linear._sufficient_stats' outputs, in order (the JAX
# package's `_STATS_NAMES`)
_STATS_NAMES = ("sw", "sx", "sy", "G", "c", "syy")


def _ranges(n: int, chunk_rows: int) -> List[Tuple[int, int]]:
    step = max(1, int(chunk_rows))
    return [(lo, min(lo + step, n)) for lo in range(0, max(0, int(n)), step)]


def _maybe_validate(plan: Any, lo: int, hi: int) -> None:
    """The NaN/Inf scan of one row block (``config["validate_ingest"]``) as
    it enters the stream: the dataset is never read a second time just to
    validate it, and later passes over scanned rows cost nothing."""
    if not getattr(plan, "validate", False) or lo < plan.validated_rows:
        return
    from ..data import run_deferred_validation

    run_deferred_validation(plan.extracted, lo=lo, hi=hi)
    plan.validated_rows = hi


def _dense_block_iter(inputs: Any, extras: Dict[str, np.ndarray], per_block=None):
    """Host dicts of one pass: the features' row slice, the aligned slices
    of `extras`, and the per-block arrays of `per_block` (the logits the
    host keeps between passes)."""
    plan = inputs.stream
    feats = plan.extracted.features
    for bi, (lo, hi) in enumerate(_ranges(inputs.n_valid, plan.chunk_rows)):
        _maybe_validate(plan, lo, hi)
        blk = {"X": np.asarray(feats[lo:hi], dtype=inputs.dtype)}
        for name, arr in extras.items():
            blk[name] = arr[lo:hi]
        if per_block is not None:
            for name, arrs in per_block.items():
                blk[name] = arrs[bi]
        yield blk


def _ell_k_max(inputs: Any) -> int:
    """The global padded-ELL width of a CSR fit, kept on the plan."""
    from ..memory import ell_k_max

    plan = inputs.stream
    if not plan.ell_k_max:
        plan.ell_k_max = ell_k_max(inputs.X_sparse)
    return plan.ell_k_max


def _ell_host_blocks(inputs: Any) -> List[Tuple[int, int, np.ndarray, np.ndarray]]:
    """The CSR rows as padded-ELL host blocks (lo, hi, values, indices) at
    the global k_max, converted ONCE per fit and kept on the plan, each row
    block scanned as it is converted. The GLM passes over them twice an
    iteration; a single-pass consumer uses `_ell_block_iter(cache=False)`
    and keeps nothing."""
    plan = inputs.stream
    if plan.ell_blocks is None:
        from .sparse import csr_to_ell

        k_max = _ell_k_max(inputs)
        blocks = []
        for lo, hi in _ranges(inputs.n_valid, plan.chunk_rows):
            _maybe_validate(plan, lo, hi)
            idx, val, _ = csr_to_ell(inputs.X_sparse[lo:hi], k_max=k_max, dtype=inputs.dtype)
            blocks.append((lo, hi, val, idx))
        plan.ell_blocks = blocks
    return plan.ell_blocks


def _ell_block_iter(inputs: Any, extras: Dict[str, np.ndarray], per_block=None, cache: bool = True):
    """Host dicts of one padded-ELL pass ("val", "idx" and the aligned
    slices of `extras`): from the plan's cached blocks, or with
    ``cache=False`` (and no cache yet) converted chunk by chunk and kept
    nowhere, so a dataset streamed for want of device memory grows no
    second host copy just to be read once."""
    plan = inputs.stream
    if cache or plan.ell_blocks is not None:
        blocks = _ell_host_blocks(inputs)
    else:
        from .sparse import csr_to_ell

        def convert():
            for lo, hi in _ranges(inputs.n_valid, plan.chunk_rows):
                _maybe_validate(plan, lo, hi)
                idx, val, _ = csr_to_ell(inputs.X_sparse[lo:hi], k_max=_ell_k_max(inputs), dtype=inputs.dtype)
                yield lo, hi, val, idx

        blocks = convert()
    for bi, (lo, hi, val, idx) in enumerate(blocks):
        blk = {"val": val, "idx": idx}
        for name, arr in extras.items():
            blk[name] = arr[lo:hi]
        if per_block is not None:
            for name, arrs in per_block.items():
                blk[name] = arrs[bi]
        yield blk


def _chunks(inputs: Any, extras: Dict[str, np.ndarray], per_block=None, cache: bool = True):
    """One streamed pass: the placed chunks, in row order (dense rows as
    "X", CSR rows as padded-ELL "val" and "idx")."""
    if inputs.X_sparse is not None:
        blocks = _ell_block_iter(inputs, extras, per_block, cache=cache)
    else:
        blocks = _dense_block_iter(inputs, extras, per_block)
    return stream_place_blocks(blocks, device=inputs.device, staging=inputs.stream.staging)


def _fetch(device: torch.device, *parts: torch.Tensor) -> List[np.ndarray]:
    """One chunk's partials on the host in ONE device-to-host copy (the
    pipeline's one wait per chunk, timed as device_wait.stream_chunk_s)."""
    with telemetry.device_wait("stream_chunk", device):
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
    out, lo = [], 0
    for p in parts:
        out.append(flat[lo:lo + p.numel()].reshape(tuple(p.shape)))
        lo += p.numel()
    return out


def _on_device(inputs: Any, *arrays: np.ndarray) -> List[torch.Tensor]:
    return [torch.as_tensor(np.asarray(a, dtype=inputs.dtype)).to(inputs.device) for a in arrays]


# ------------------------------------------------------- linear / PCA -------


def linear_streaming_stats(inputs: Any, fast: bool = False) -> Tuple[np.ndarray, ...]:
    """One streamed pass summing the normal-equation sufficient statistics
    (ops/linear._sufficient_stats: Σw, Σwx, Σwy, XᵀWX, XᵀWy, Σwy²; of a
    CSR fit's ELL chunks, `_ell_sufficient_stats`) over the chunks. `fast`
    runs each chunk's contractions bf16-in / float32-sum (ELL: its values
    rounded through bf16); the sum over chunks stays at full precision."""
    from .linear import _ell_sufficient_stats, _sufficient_stats

    y = np.asarray(inputs.y, dtype=inputs.dtype)
    w = np.asarray(inputs.w, dtype=inputs.dtype)
    acc: Optional[List[np.ndarray]] = None
    _nc = numcheck.hook()  # SRML_NUMCHECK=1: sweep the per-chunk host partials
    for blk in _chunks(inputs, {"y": y, "w": w}, cache=False):
        if "val" in blk:
            stats = _ell_sufficient_stats(blk["val"], blk["idx"], blk["y"], blk["w"], int(inputs.n_cols), fast=fast)
        else:
            stats = _sufficient_stats(blk["X"], blk["y"], blk["w"], fast)
        part = _fetch(inputs.device, *stats)
        if _nc is not None:
            _nc("linear_stream.chunk", solver="linear_stream", **dict(zip(_STATS_NAMES, part)))
        acc = part if acc is None else [a + b for a, b in zip(acc, part)]
    assert acc is not None, "streaming statistics over an empty dataset"
    return tuple(acc)


def linear_fit_streaming(
    inputs: Any,
    *,
    alpha: float,
    l1_ratio: float,
    fit_intercept: bool = True,
    standardize: bool = True,
    use_cd: bool = False,
    max_iter: int = 1000,
    tol: float = 1e-6,
    fast: bool = False,
) -> Dict[str, torch.Tensor]:
    """Out-of-core linear regression: one streamed statistics pass, then the
    resident fit's d x d solve on the card."""
    from .linear import _solve_from_stats

    stats = _on_device(inputs, *linear_streaming_stats(inputs, fast))
    return _solve_from_stats(
        tuple(stats), stats[0].dtype, alpha=alpha, l1_ratio=l1_ratio, fit_intercept=fit_intercept,
        standardize=standardize, use_cd=use_cd, max_iter=int(max_iter), tol=tol,
    )


def pca_fit_streaming(inputs: Any, *, k: int, fast: bool = False) -> Dict[str, torch.Tensor]:
    """Out-of-core PCA: two streamed passes, the weighted mean, then the
    CENTERED covariance Σw(x-μ)(x-μ)ᵀ/(Σw-1) (never the uncentered form,
    which cancels), and the resident fit's finish. `fast` is the
    covariance contraction's only; the mean and the eigendecomposition stay
    at full precision."""
    from .linalg import centered_gram
    from .pca import _pca_finish

    w = np.asarray(inputs.w, dtype=inputs.dtype)
    sw = sx = None
    _nc = numcheck.hook()  # SRML_NUMCHECK=1: sweep the per-chunk host partials
    for blk in _chunks(inputs, {"w": w}):
        b_sw, b_sx = _fetch(inputs.device, torch.sum(blk["w"]), blk["w"] @ blk["X"])
        if _nc is not None:
            _nc("pca_stream.chunk", solver="pca_stream", sum_w=b_sw, sum_x=b_sx)
        sw = b_sw if sw is None else sw + b_sw
        sx = b_sx if sx is None else sx + b_sx
    assert sw is not None, "streaming moments over an empty dataset"
    mean = sx / sw
    (mean_dev,) = _on_device(inputs, mean)
    cov_sum = None
    for blk in _chunks(inputs, {"w": w}):
        (part,) = _fetch(inputs.device, centered_gram(blk["X"], blk["w"], mean_dev, fast).to(mean_dev.dtype))
        if _nc is not None:
            _nc("pca_stream.chunk", solver="pca_stream", cov_partial=part)
        cov_sum = part if cov_sum is None else cov_sum + part
    cov = cov_sum / (sw - 1.0)
    if _nc is not None:
        _nc("pca_stream.stats", solver="pca_stream", mean=mean, cov=cov)
    total_w, mean_t, cov_t = _on_device(inputs, sw, mean, cov)
    return _pca_finish(total_w, mean_t, cov_t, k=k)


# ------------------------------------------------------------- k-means ------


def kmeans_fit_streaming(
    inputs: Any,
    init_centers: np.ndarray,
    *,
    max_iter: int = 20,
    tol: float = 1e-4,
    batch_rows: int = 32768,
    precision_mode: str = "high",
) -> Dict[str, torch.Tensor]:
    """Out-of-core Lloyd: `kmeans.lloyd_loop` with a step that streams the
    chunks through `distance.tile_assign_accumulate` in tiles of
    `batch_rows` rows, every chunk summed into the same device accumulators
    in row order. With chunks of whole tiles (the model rounds them) the
    fit equals the resident `kmeans_fit` bit for bit. precision_mode "fast"
    (float32 only) runs the in-loop products in bf16 with float32 sums;
    "high" keeps the inputs' precision."""
    from .distance import tile_assign_accumulate
    from .kmeans import _finish_centers, lloyd_loop

    w = np.asarray(inputs.w, dtype=inputs.dtype)
    (centers,) = _on_device(inputs, init_centers)

    def step(c, fast):
        acc = None
        for blk in _chunks(inputs, {"w": w}):
            acc = tile_assign_accumulate(blk["X"], blk["w"], c, batch_rows, fast, acc=acc)
        return _finish_centers(*acc, c)

    return lloyd_loop(
        step, centers, max_iter=max_iter, tol=tol,
        fast=precision_mode == "fast" and np.dtype(inputs.dtype) == np.float32, solver="kmeans_stream",
    )


# ------------------------------------------------------------ logistic ------


def _streaming_scaling(inputs: Any, w_host: np.ndarray, w: torch.Tensor, standardize: bool, fit_intercept: bool):
    """(mu, d_scale, total_w) of ops/logistic._make_scaling on the host at
    w's dtype, the raw moments summed over one streamed pass on the card
    (none without standardization, which needs only Σw)."""
    from .linalg import moments_from_sums, weighted_sums
    from .logistic import scaling_from_moments

    if not standardize:
        zero = w.new_zeros((int(inputs.n_cols),))
        return scaling_from_moments(torch.sum(w), zero, zero, False, fit_intercept)
    if inputs.X_sparse is not None:
        return _ell_streaming_scaling(inputs, w_host, w)
    sums = None
    for blk in _chunks(inputs, {"w": w_host}):
        part = weighted_sums(blk["X"], blk["w"])
        sums = part if sums is None else tuple(a + b for a, b in zip(sums, part))
    sums = [torch.from_numpy(a).to(w.dtype) for a in _fetch(inputs.device, *sums)]
    return scaling_from_moments(*moments_from_sums(*sums), True, fit_intercept)


def _ell_moments_block(val: torch.Tensor, idx: torch.Tensor, wb: torch.Tensor, d: int):
    """One ELL chunk's scale-only standardization partials: (Σw, Σw·x [d],
    Σw·x² [d]), the column sums in the chunk's fixed order
    (`sparse.EllColumns`)."""
    from .sparse import EllColumns

    cols = EllColumns(val, idx, d)
    return torch.sum(wb), cols.col_sums(val, wb), cols.col_sums(val * val, wb)


def _ell_streaming_scaling(inputs: Any, w_host: np.ndarray, w: torch.Tensor):
    """ops/logistic._ell_scaling over the streamed ELL chunks: the moments
    summed on the host in chunk order, then mean, the population variance
    (unclamped) and the unbiased std, at w's dtype; mu is 0 (sparse data is
    never centered)."""
    d = int(inputs.n_cols)
    sums = None
    for blk in _chunks(inputs, {"w": w_host}):
        part = _fetch(inputs.device, *_ell_moments_block(blk["val"], blk["idx"], blk["w"], d))
        sums = part if sums is None else [a + b for a, b in zip(sums, part)]
    sw, s1, s2 = (torch.from_numpy(np.asarray(a)).to(w.dtype) for a in sums)
    mean = s1 / sw
    var = s2 / sw - mean * mean
    sigma = torch.sqrt(var * (sw / torch.clamp_min(sw - 1.0, 1.0)))
    d_scale = torch.where(sigma > 0, 1.0 / torch.clamp_min(sigma, 1e-30), torch.zeros_like(sigma))
    return torch.zeros_like(mean), d_scale, sw


def _streamed_ops(inputs: Any, fast: bool):
    """(matvec, rmat) of ops/logistic._dense_ops (CSR: `_ell_ops`) over the
    streamed chunks,
    taking and returning host tensors (the products at X's dtype on the
    card, cast back to the operand's dtype on the host): X·B the chunks'
    products fetched chunk by chunk and concatenated in row order, Xᵀ·R the
    chunks' products summed on the card in chunk order and fetched once.
    Each is one pass over the rows."""
    from .logistic import _dense_ops, _ell_ops

    device = inputs.device
    x_dtype = torch.from_numpy(np.zeros(0, dtype=inputs.dtype)).dtype
    ranges = _ranges(inputs.n_valid, inputs.stream.chunk_rows)
    d = int(inputs.n_cols)

    def block_ops(blk):
        if "val" in blk:
            return _ell_ops(blk["val"], blk["idx"], d, fast)
        return _dense_ops(blk["X"], fast)

    def matvec(B):
        Bd = B.to(device=device, dtype=x_dtype)
        return torch.cat([torch.from_numpy(_fetch(device, block_ops(blk)[0](Bd))[0])
                          for blk in _chunks(inputs, {})], dim=0).to(B.dtype)

    def rmat(R):
        out = None
        for (lo, hi), blk in zip(ranges, _chunks(inputs, {})):
            part = block_ops(blk)[1](R[lo:hi].to(device=device, dtype=x_dtype))
            out = part if out is None else out + part
        return torch.from_numpy(_fetch(device, out)[0]).to(R.dtype)

    return matvec, rmat


def logistic_fit_streaming(
    inputs: Any,
    y_idx_host: np.ndarray,
    *,
    k: int,
    multinomial: bool,
    lam_l2: float,
    fit_intercept: bool = True,
    standardize: bool = True,
    max_iter: int = 100,
    tol: float = 1e-6,
    lbfgs_memory: int = 10,
    fast: bool = False,
) -> Dict[str, Any]:
    """Out-of-core logistic regression, the smooth L2 path (the model layer
    refuses a demoted L1 fit, as the JAX package does): the resident GLM
    quasi-Newton (`logistic._fit_common`) over `_streamed_ops`, so each
    iteration streams X twice, once for the direction's logits and once for
    the gradient. As in the JAX package, the per-row state (labels,
    weights, logits: n x k_out) stays on the host, where the solver's
    vector algebra runs, in float64: its sums over all the rows (the step
    candidates' losses are one GEMV) would be less exact in float32 on the
    CPU than on the card. The card holds the chunks and their products.
    Returns `logistic_fit`'s state as host tensors at X's dtype."""
    from ..parallel import host_tensor
    from .logistic import _fit_common

    w_host = np.asarray(inputs.w, dtype=inputs.dtype)
    w = host_tensor(w_host.astype(np.float64))
    y_idx = host_tensor(np.asarray(y_idx_host, dtype=np.int64))
    mu, d_scale, total_w = _streaming_scaling(inputs, w_host, w, standardize, fit_intercept)
    matvec, rmat = _streamed_ops(inputs, fast)
    state = _fit_common(
        matvec, rmat, inputs.n_valid, torch.float64, int(inputs.n_cols), y_idx, w, mu, d_scale, total_w,
        k=k, multinomial=multinomial, lam_l2=lam_l2, lam_l1=0.0, use_l1=False,
        fit_intercept=fit_intercept, max_iter=max_iter, tol=tol, lbfgs_memory=lbfgs_memory,
        numcheck_stage="glm_stream",  # its iterate, objective and gradient live on the host
    )
    x_dtype = torch.from_numpy(w_host[:0]).dtype
    return {key: v.to(x_dtype) if key in ("coef_", "intercept_", "objective_") else v
            for key, v in state.items()}
