#
# The PyTorch port's LogisticRegression slice (spark_rapids_ml_tpu_torch/
# ops/owlqn.py, ops/logistic.py, models/classification.py, the new param
# mixins, telemetry's solver record, convert.py, and its serving) against
# the JAX package's on the same inputs, made with numpy from a seed. The
# port runs on the CPU (set_devices("cpu")); the JAX side on its CPU
# devices, float64 with jax_enable_x64 (tests/conftest.py). No Pallas
# kernel is on this path in the JAX package.
#
# Tolerances, and why:
#   * float64 pieces (scaling, the objective closures, the two-loop): rtol
#     1e-12, the same float64 arithmetic in another summation order;
#   * float64 iterates, iterate by iterate (tol = 0, so maxIter alone stops
#     both): 1e-10 of the largest coefficient. Each iteration repeats the
#     same arithmetic; its rounding (~1e-16) is carried into the next
#     direction and step, which may amplify it but not by 1e6 in 5 steps;
#     objectives rtol 1e-12;
#   * converged float64 fits (tol 1e-10): n_iter_ equal, coefficients 1e-8
#     of the largest (the stopping point moves only by rounding);
#   * converged float32 fits (tol 1e-6, far above the objective's float32
#     noise of ~1e-7 relative, so both stop on convergence, not on noise):
#     n_iter_ within 2 of JAX's (an objective change that crosses tol on
#     one side of the rounding may cross it one or two iterations later
#     on the other), coefficients 2e-3 of the largest (at a stopping point
#     where the relative objective change is 1e-6, the coefficients can
#     still move by sqrt(1e-6 · 2f/λ_min) ≈ 1e-3 of their size);
#     objectives rtol 1e-5;
#   * `fast` (bf16 products, float32 sums), against JAX `fast` and against
#     the port's float32 fit: the JAX package's own parity bounds
#     (tests/test_precision.py::test_logistic_dense_bf16_parity:
#     coefficients rtol 5e-2, atol 5e-3; objective rtol 1e-3), and n_iter_
#     within a quarter of JAX's. Rounding the coefficients to bf16 is not
#     continuous: a 1-ulp float32 difference in an iterate can move a
#     rounded coefficient by 2^-8 of itself, so two bf16 routes part at the
#     bf16 level, not the float32 one. The L1 fits (OWL-QN) get wider
#     bounds: coefficients within 2e-2 of the largest, objective rtol 2e-3
#     against float32 (1e-3 against JAX fast). The fast objective is
#     evaluated on bf16-rounded rows, 2^-9 off per entry, and the orthant
#     projection turns coordinates near 0 on or off, which moves the others
#     by the same order; the JAX package's own fast OWL-QN lies 1.3e-3 from
#     its float32 objective on these data. JAX's OWL-QN gradient is
#     autodiff's, rounded to bf16; the port's comes from the logits in
#     float32 (ops/owlqn.py);
#   * the public API: float64 fits (n_iter_ equal, coefficients 1e-8), so
#     that one estimator surface is held tightly; probabilities 10x the
#     coefficients' bound (absolute), predictions equal on rows whose
#     probability is not within 1e-2 of the threshold;
#   * serving: a coalesced response equals the same request served alone,
#     and the transform, bit for bit;
#   * fault C3, a binomial margin of +inf (ROADMAP §C's inputs): the
#     port's rawPrediction, probability [0, 1] and prediction 1.0 equal
#     JAX's exactly, from transform, predict, predictProbability and a
#     served response; finite and −inf margins keep the bits of
#     softmax([0, m]).
#
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu import checkpoint as jckpt
from spark_rapids_ml_tpu import params as jparams
from spark_rapids_ml_tpu.errors import SolverDivergedError as JaxSolverDivergedError
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.models.classification import LogisticRegressionModel as JaxLogisticRegressionModel
from spark_rapids_ml_tpu.ops import logistic as jlog
from spark_rapids_ml_tpu.ops import owlqn as jowl
from spark_rapids_ml_tpu_torch import (
    LogisticRegression,
    LogisticRegressionModel,
    ModelRegistry,
    ScoringEngine,
    Vectors,
    params as tparams,
    set_devices,
    telemetry,
)
from spark_rapids_ml_tpu_torch.convert import logistic_regression_model_from_jax
from spark_rapids_ml_tpu_torch.core import config
from spark_rapids_ml_tpu_torch.errors import SolverDivergedError
from spark_rapids_ml_tpu_torch.ops import logistic as tlog
from spark_rapids_ml_tpu_torch.ops import owlqn as towl

F64 = 1e-12


@pytest.fixture(autouse=True)
def port_on_cpu():
    set_devices("cpu")
    yield
    set_devices(None)


def _cls(n=400, d=6, k=2, seed=0, dtype=np.float64, noise=0.5):
    """Features of different scales and offsets; labels
    argmax([0, z·β + noise·ε]) over the unscaled z (benchmark/gen_data.py's
    construction), β ~ N(0, 1) with k − 1 columns."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, d))
    x = z * np.array([1.0, 2.0, 0.5, 3.0, 1.5, 0.8, 1.2, 2.5][:d]) + np.array([1.0, -2.0, 0.0, 0.5, 3.0, -1.0, 0.3, 0.0][:d])
    beta = rng.normal(size=(d, k - 1))
    s = np.concatenate([np.zeros((n, 1)), z @ beta + noise * rng.normal(size=(n, k - 1))], axis=1)
    return x.astype(dtype), np.argmax(s, axis=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol, scale=None):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * scale, (err, rtol * scale)


def _both_inputs(x, y, w=None):
    w = np.ones(len(x), x.dtype) if w is None else w.astype(x.dtype)
    return (
        (jnp.asarray(x), jnp.asarray(y.astype(np.int32)), jnp.asarray(w)),
        (_t(x), _t(y.astype(np.int64)), _t(w)),
    )


# ------------------------------------------------------- the solver parts ----


@pytest.mark.parametrize("count,pos", [(0, 0), (3, 3), (7, 2), (10, 4), (10, 0)])
def test_lbfgs_two_loop_matches_jax(count, pos):
    # count below the memory, and after the ring wrapped (count = m, pos
    # anywhere); slots past `count` hold stale values the JAX loop masks
    m, n = 10, 13
    rng = np.random.default_rng(count * 31 + pos)
    S, Y = rng.normal(size=(m, n)), rng.normal(size=(m, n))
    Y = Y + 3.0 * S  # sᵀy > 0, as kept pairs have
    rho = 1.0 / np.einsum("ij,ij->i", S, Y)
    pg = rng.normal(size=n)
    want = jowl.lbfgs_two_loop(jnp.asarray(pg), jnp.asarray(S), jnp.asarray(Y), jnp.asarray(rho),
                               jnp.asarray(count), jnp.asarray(pos), m)
    got = towl.lbfgs_two_loop(_t(pg), _t(S), _t(Y), _t(rho), count, pos, m)
    _close(got.numpy(), np.asarray(want), F64)
    if count == 0:
        np.testing.assert_array_equal(got.numpy(), -pg)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("standardize,fit_intercept", [(True, True), (True, False), (False, True)])
def test_make_scaling_matches_jax(dtype, standardize, fit_intercept):
    x, _ = _cls(dtype=dtype, seed=1)
    x[:, 2] = 1.5  # a constant column: d_scale exactly 0
    w = np.random.default_rng(2).uniform(0.5, 2.0, size=len(x)).astype(dtype)
    w[::7] = 0.0
    jm, jd, jt = jlog._make_scaling(jnp.asarray(x), jnp.asarray(w), standardize, fit_intercept)
    tm, td, tt = tlog._make_scaling(_t(x), _t(w), standardize, fit_intercept)
    rtol = 1e-5 if dtype == np.float32 else F64
    for got, want in ((tm, jm), (td, jd), (tt, jt)):
        assert got.dtype == _t(x).dtype
        _close(got.numpy(), np.asarray(want), rtol)
    if standardize:
        assert td[2] == 0.0 and float(jd[2]) == 0.0


def _problems(multinomial, fit_intercept, standardize, seed=3, dtype=np.float64, fast=False):
    """The same GLM problem built by both packages: (jax closures, port
    closures, flat size, data)."""
    k = 3 if multinomial else 2
    x, y = _cls(k=k, seed=seed, dtype=dtype)
    w = np.random.default_rng(seed + 1).uniform(0.5, 2.0, size=len(x)).astype(dtype)
    (jx, jy, jw), (tx, ty, tw) = _both_inputs(x, y, w)
    common = dict(k=k, multinomial=multinomial, lam_l2=0.03, fit_intercept=fit_intercept)
    jmu, jds, jtw = jlog._make_scaling(jx, jw, standardize, fit_intercept)
    tmu, tds, ttw = tlog._make_scaling(tx, tw, standardize, fit_intercept)
    jp = jlog._build_glm_problem(*jlog._dense_ops(jx, fast), jx.dtype, x.shape[1], jy, jw, jmu, jds, jtw, **common)
    tp = tlog._build_glm_problem(tx.dtype, x.shape[1], ty, tw, tmu, tds, ttw, **common)
    # the port's passes over the rows are solves of run_lockstep: served here
    # one at a time, under the names of JAX's closures
    ops = tlog._dense_ops(tx, fast)
    tp["z_of"] = lambda xf: _served(tp["z_solve"](xf), ops)
    tp["grad_from_z"] = lambda xf, z: _served(tp["grad_solve"](xf, z), ops)
    return jp, tp, tp["n_flat"], (x, y, w)


def _served(solve, ops):
    """What `solve` returns, its product requests served by `ops`."""
    (out,), _ = towl.run_lockstep([solve], *ops)
    return out


@pytest.mark.parametrize("multinomial", [False, True], ids=["binomial", "multinomial"])
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("standardize", [True, False])
def test_glm_problem_closures_match_jax(multinomial, fit_intercept, standardize):
    jp, tp, n_flat, _ = _problems(multinomial, fit_intercept, standardize)
    rng = np.random.default_rng(4)
    xf, df = rng.normal(size=n_flat) * 0.3, rng.normal(size=n_flat) * 0.3
    a = np.asarray([2.0] + [0.5 ** i for i in range(11)])
    jz, tz = jp["z_of"](jnp.asarray(xf)), tp["z_of"](_t(xf))
    _close(tz.numpy(), np.asarray(jz), F64)
    jzd, tzd = jp["z_of"](jnp.asarray(df)), tp["z_of"](_t(df))
    _close(tp["rowloss"](tz).numpy(), np.asarray(jp["rowloss"](jz)), F64)
    _close(tp["rowloss_alphas"](tz, tzd, _t(a)).numpy(), np.asarray(jp["rowloss_alphas"](jz, jzd, jnp.asarray(a))), F64)
    for got, want in zip(tp["penalty_terms"](_t(xf), _t(df)), jp["penalty_terms"](jnp.asarray(xf), jnp.asarray(df))):
        _close(got.numpy(), np.asarray(want), F64)
    _close(tp["grad_from_z"](_t(xf), tz).numpy(), np.asarray(jp["grad_from_z"](jnp.asarray(xf), jz)), F64)


@pytest.mark.parametrize("multinomial", [False, True], ids=["binomial", "multinomial"])
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("standardize", [True, False])
def test_grad_from_z_is_the_gradient_of_the_loss(multinomial, fit_intercept, standardize):
    # the analytic gradient against autograd of rowloss(z_of(x)) + p0
    _, tp, n_flat, _ = _problems(multinomial, fit_intercept, standardize, seed=5)
    xf = torch.from_numpy(np.random.default_rng(6).normal(size=n_flat) * 0.3).requires_grad_(True)
    loss = tp["rowloss"](tp["z_of"](xf)) + tp["penalty_terms"](xf, torch.zeros_like(xf))[0]
    (auto,) = torch.autograd.grad(loss, xf)
    with torch.no_grad():
        analytic = tp["grad_from_z"](xf, tp["z_of"](xf))
    if not fit_intercept:  # b0 is not in the logits: its gradient is 0 on both sides
        k_out = 3 if multinomial else 1
        assert (analytic[-k_out:] == 0).all() and (auto[-k_out:] == 0).all()
    _close(analytic.numpy(), auto.numpy(), 1e-12)


def test_softplus_above_20_matches_jax():
    # F.softplus returns z itself above its threshold of 20 (off by 1.25e-9
    # at 20.5); the port's softplus is jax.nn.softplus's logaddexp(z, 0)
    z = np.asarray([-30.0, -1.0, 0.0, 19.9, 20.0, 20.5, 25.0, 40.0, 800.0])
    got = tlog.softplus(_t(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(z))), rtol=2.0 ** -52, atol=0)  # 1 ulp
    assert abs(float(torch.nn.functional.softplus(_t(z))[5]) - got[5]) > 1e-9
    # and in the loss, on logits above 20 (a well-separated row scored at
    # the growth step)
    jp, tp, n_flat, _ = _problems(False, True, True, seed=7)
    xf = np.random.default_rng(8).normal(size=n_flat) * 12.0
    tz, jz = tp["z_of"](_t(xf)), jp["z_of"](jnp.asarray(xf))
    assert float(tz.abs().max()) > 20.0
    _close(tp["rowloss"](tz).numpy(), np.asarray(jp["rowloss"](jz)), F64)


def test_armijo_pick_takes_the_largest_passing_step():
    a = torch.tensor([2.0] + [0.5 ** i for i in range(11)], dtype=torch.float64)
    assert tlog.N_ALPHAS == 12
    f_cur, gd = torch.tensor(1.0, dtype=torch.float64), torch.tensor(-1.0, dtype=torch.float64)
    f_cand = torch.full((12,), 5.0, dtype=torch.float64)
    f_cand[[2, 3, 7]] = 0.5  # candidates 0.5, 0.25 and 2^-6 pass; 0.5 is the largest
    a_sel, f_new, ok = tlog.armijo_pick(f_cand, f_cur, a, gd)
    assert bool(ok) and float(a_sel) == 0.5 and float(f_new) == 0.5
    a_sel, f_new, ok = tlog.armijo_pick(torch.full((12,), 5.0, dtype=torch.float64), f_cur, a, gd)
    assert not bool(ok) and float(a_sel) == 2.0


# -------------------------------------------------- iterate by iterate ----


def _jax_iterates(jp, n_flat, x_dtype, n_rows, use_l1, lam_l1, steps):
    """JAX's flat iterate after each of the first `steps` iterations of its
    own loop body (cond checked before each, as its while_loop does)."""
    if use_l1:
        def flat_loss(xf):
            return jp["rowloss"](jp["z_of"](xf)) + jp["penalty_terms"](xf, jnp.zeros_like(xf))[0]

        k_out = jp["k_out"]
        mask = jnp.concatenate([jnp.ones((n_flat - k_out,)), jnp.zeros((k_out,))])
        cond, body, state = jowl._owlqn_setup(flat_loss, jnp.zeros((n_flat,)), mask, lam_l1, max_iter=steps, tol=0.0)
        x_at, f_at = 0, 7
    else:
        cond, body, state = jlog._glm_qn_setup(
            jp["z_of"], jp["rowloss"], jp["rowloss_alphas"], jp["grad_from_z"], (n_rows, jp["k_out"]), n_flat,
            x_dtype, jp["penalty_terms"], max_iter=steps, tol=0.0,
        )
        x_at, f_at = 0, 8
    body = jax.jit(body)
    out = []
    while bool(cond(state)):
        state = body(state)
        out.append((np.asarray(state[x_at]), float(state[f_at])))
    return out


@pytest.mark.parametrize("multinomial", [False, True], ids=["binomial", "multinomial"])
@pytest.mark.parametrize("use_l1", [False, True], ids=["glm_qn", "owlqn"])
@pytest.mark.parametrize("separable", [False, True])
def test_first_iterates_match_jax_in_float64(multinomial, use_l1, separable):
    # separable: labels with no noise, so the growth step (a = 2) reaches
    # logits above 20, where F.softplus would differ
    k = 3 if multinomial else 2
    x, y = _cls(k=k, seed=9, noise=0.0 if separable else 0.5)
    (jx, jy, jw), (tx, ty, tw) = _both_inputs(x, y)
    lam_l2, lam_l1 = (0.01, 0.02) if use_l1 else (0.02, 0.0)
    if separable:  # weak penalties: the logits pass 20 by the 4th iterate
        lam_l2, lam_l1 = (1e-4, 1e-4) if use_l1 else (1e-4, 0.0)
    common = dict(k=k, multinomial=multinomial, lam_l2=lam_l2, fit_intercept=True)
    jmu, jds, jtw = jlog._make_scaling(jx, jw, True, True)
    jp = jlog._build_glm_problem(*jlog._dense_ops(jx), jx.dtype, x.shape[1], jy, jw, jmu, jds, jtw, **common)
    steps = 5
    want = _jax_iterates(jp, jp["n_flat"], jx.dtype, len(x), use_l1, lam_l1, steps)
    assert len(want) == steps
    for t, (xf, f) in enumerate(want, start=1):
        got = tlog.logistic_fit(tx, ty, tw, lam_l1=lam_l1, use_l1=use_l1, max_iter=t, tol=0.0,
                                **{kk: v for kk, v in common.items()})
        wfin = jlog._finish_glm(jnp.asarray(xf), f, t, False, jp["unflatten"], jds, jmu,
                                fit_intercept=True, multinomial=multinomial)
        assert got["n_iter_"] == t
        scale = float(np.abs(np.asarray(wfin["coef_"])).max())
        _close(got["coef_"].numpy(), np.asarray(wfin["coef_"]), 1e-10, scale)
        _close(got["intercept_"].numpy(), np.asarray(wfin["intercept_"]), 1e-10, max(scale, 1.0))
        _close(got["objective_"].numpy(), f, F64)
        if separable and t == steps and not multinomial and not use_l1:
            z = tx @ got["coef_"][0] + got["intercept_"][0]
            assert float(z.abs().max()) > 20.0


# ------------------------------------------------------ converged fits ----


_FITS = {
    "binomial_l2": dict(k=2, multinomial=False, lam_l2=0.01),
    "multinomial_l2": dict(k=3, multinomial=True, lam_l2=0.01),
    "binomial_l1": dict(k=2, multinomial=False, lam_l2=0.005, lam_l1=0.01, use_l1=True),
    "multinomial_l1": dict(k=3, multinomial=True, lam_l2=0.005, lam_l1=0.01, use_l1=True),
}


@pytest.mark.parametrize("name", list(_FITS))
@pytest.mark.parametrize("route", ["f64", "f32", "fast"])
def test_converged_fits_match_jax(name, route):
    kw = dict(_FITS[name])
    dtype = np.float64 if route == "f64" else np.float32
    x, y = _cls(n=600, k=kw["k"], seed=10, dtype=dtype)
    w = np.random.default_rng(11).uniform(0.5, 2.0, size=len(x))
    (jx, jy, jw), (tx, ty, tw) = _both_inputs(x, y, w)
    kw.update(max_iter=200, tol=1e-10 if route == "f64" else 1e-6, fast=route == "fast")
    js = jlog.logistic_fit(jx, jy, jw, **kw)
    ts = tlog.logistic_fit(tx, ty, tw, **kw)
    assert ts["coef_"].dtype == tx.dtype and ts["objective_"].dtype == tx.dtype
    use_l1 = kw.get("use_l1", False)
    if route == "fast":
        assert abs(ts["n_iter_"] - int(js["n_iter_"])) <= max(2, int(js["n_iter_"]) // 4)
        _fast_close(ts, js, use_l1, f_rtol=1e-3)
    else:
        if route == "f64":
            assert ts["n_iter_"] == int(js["n_iter_"])
            rtol, f_rtol = 1e-8, F64
        else:
            assert abs(ts["n_iter_"] - int(js["n_iter_"])) <= 2, (ts["n_iter_"], int(js["n_iter_"]))
            rtol, f_rtol = 2e-3, 1e-5
        scale = float(np.abs(np.asarray(js["coef_"])).max())
        _close(ts["coef_"].numpy(), np.asarray(js["coef_"]), rtol, scale)
        _close(ts["intercept_"].numpy(), np.asarray(js["intercept_"]), rtol, max(scale, 1.0))
        _close(ts["objective_"].numpy(), np.asarray(js["objective_"]), f_rtol)
        assert ts["stalled_"] == bool(js["stalled_"])
    if route == "fast":
        # the JAX package's own bf16 parity bound, against the port's float32
        full = tlog.logistic_fit(tx, ty, tw, **dict(kw, fast=False))
        _fast_close(ts, full, use_l1, f_rtol=2e-3 if use_l1 else 1e-3)


def _fast_close(fast, ref, use_l1, f_rtol):
    got, want = np.asarray(fast["coef_"]), np.asarray(ref["coef_"])
    if use_l1:
        _close(got, want, 2e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-3)
    np.testing.assert_allclose(float(fast["objective_"]), float(ref["objective_"]), rtol=f_rtol)


def test_fast_stages_x_once_per_fit(monkeypatch):
    # solver_precision="bf16" rounds X to bf16 once, not once per product
    x, y = _cls(seed=12, dtype=np.float32)
    casts = []
    real = torch.Tensor.to

    def counting_to(self, *args, **kwargs):
        to_bf16 = torch.bfloat16 in args or kwargs.get("dtype") is torch.bfloat16
        if self.shape == x.shape and self.dtype != torch.bfloat16 and to_bf16:
            casts.append(1)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", counting_to)
    state = tlog.logistic_fit(_t(x), _t(y.astype(np.int64)), torch.ones(len(x)), k=2, multinomial=False,
                              lam_l2=0.01, max_iter=20, tol=1e-9, fast=True)
    assert state["n_iter_"] > 3 and len(casts) == 1


@pytest.mark.parametrize("use_l1", [False, True], ids=["glm_qn", "owlqn"])
def test_host_reads_per_iteration(use_l1):
    # the GLM loop reads the device once per iteration; OWL-QN once per
    # line-search trial and once per iteration whose search passed
    x, y = _cls(seed=13)
    kw = dict(k=2, multinomial=False, lam_l2=0.01, lam_l1=0.02 if use_l1 else 0.0, use_l1=use_l1,
              max_iter=30, tol=1e-12)
    state = tlog.logistic_fit(_t(x), _t(y.astype(np.int64)), torch.ones(len(x), dtype=torch.float64), **kw)
    if use_l1:
        assert 2 * state["n_iter_"] <= state["host_reads_"] <= (1 + 25) * state["n_iter_"]
    else:
        assert state["host_reads_"] == state["n_iter_"] > 3


def _lasso(seed=42):
    rng = np.random.default_rng(seed)
    n, d = 120, 10
    A = rng.normal(size=(n, d))
    x_true = np.zeros(d)
    x_true[:3] = [2.0, -1.5, 1.0]
    b = A @ x_true + 0.01 * rng.normal(size=n)
    return A, b


def test_owlqn_lasso_zero_pattern_matches_jax():
    # tests/test_ops.py::test_owlqn_lasso_zeros's problem through both
    # OWL-QNs: the same exact zeros, the same minimizer
    A, b = _lasso()
    n, d = A.shape
    lam = 0.08

    def smooth(x):
        r = jnp.asarray(A) @ x - jnp.asarray(b)
        return 0.5 * jnp.sum(r * r) / n

    want, f_want, it_want = jowl.owlqn_minimize(smooth, jnp.zeros(d), jnp.ones(d), lam, max_iter=300, tol=1e-14)
    At, bt = _t(A), _t(b)

    def value_fn(x):
        r = (yield ("mm", x[:, None]))[:, 0] - bt
        return 0.5 * torch.sum(r * r) / n, r

    def grad_fn(x, r):
        return (yield ("rmat", r[:, None]))[:, 0] / n

    solve = towl.owlqn_steps(value_fn, grad_fn, torch.zeros(d, dtype=torch.float64),
                             torch.ones(d, dtype=torch.float64), lam, max_iter=300, tol=1e-14)
    ((got, f_got, it_got, _),), _ = towl.run_lockstep([solve], lambda B: At @ B, lambda R: At.T @ R)
    np.testing.assert_array_equal(got.numpy() == 0.0, np.asarray(want) == 0.0)
    assert (got.numpy() == 0.0).sum() >= 5
    _close(got.numpy(), np.asarray(want), 1e-6)
    _close(f_got.numpy(), float(f_want), 1e-12)


# ----------------------------------------------- the public API vs JAX ----


def _fit_both(data, **params):
    return LogisticRegression(**params).fit(data), JaxLogisticRegression(num_workers=1, **params).fit(data)


def _cols(model, data):
    out = model.transform(data)
    names = ("rawPrediction", "probability", "prediction")
    raw, prob = (np.stack([np.asarray(getattr(c, "toArray", lambda: c)()) for c in out[n]]) for n in names[:2])
    return raw, prob, np.asarray(out["prediction"], dtype=np.float64)


def _same_model(tm, jm, data, jax_data=None, rtol=1e-8, threshold=0.5):
    scale = float(np.abs(jm.coef_).max())
    _close(tm.coef_, jm.coef_, rtol, scale)
    _close(tm.intercept_, jm.intercept_, rtol, max(scale, 1.0))
    np.testing.assert_array_equal(tm.classes_, jm.classes_)
    assert tm.numClasses == jm.numClasses and tm.numFeatures == jm.numFeatures and tm.dtype == jm.dtype
    traw, tprob, tpred = _cols(tm, data)
    jraw, jprob, jpred = _cols(jm, data if jax_data is None else jax_data)
    _close(tprob, jprob, 10 * rtol, 1.0)
    clear = np.abs(jprob - threshold).min(axis=1) > 1e-2
    np.testing.assert_array_equal(tpred[clear], jpred[clear])


@pytest.mark.parametrize("kind", ["dict", "pandas", "vector"])
@pytest.mark.parametrize("params", [
    {}, {"regParam": 0.05, "elasticNetParam": 0.5}, {"regParam": 0.02, "standardization": False},
    {"fitIntercept": False, "regParam": 0.01},
], ids=["default", "elastic_net", "unstandardized", "no_intercept"])
def test_estimator_matches_jax_through_the_public_api(kind, params):
    x, y = _cls(n=300, seed=14)
    y = y.astype(np.float64)
    w = np.random.default_rng(15).uniform(0.5, 2.0, size=len(x))
    params = dict(params, float32_inputs=False)
    if kind == "dict":
        port_data = jax_data = {"features": x, "label": y, "w": w}
    elif kind == "pandas":
        port_data = jax_data = pd.DataFrame({"features": list(x), "label": y, "w": w})
    else:
        from spark_rapids_ml_tpu.linalg import Vectors as JaxVectors

        port_data = pd.DataFrame({"features": [Vectors.dense(v) for v in x], "label": y, "w": w})
        jax_data = pd.DataFrame({"features": [JaxVectors.dense(v) for v in x], "label": y, "w": w})
    tm = LogisticRegression(**params).setWeightCol("w").fit(port_data)
    jm = JaxLogisticRegression(num_workers=1, **params).setWeightCol("w").fit(jax_data)
    assert tm.n_iter_ == jm.n_iter_ and tm.dtype == "float64"
    _close(tm.objective_, jm.objective_, F64)
    _same_model(tm, jm, port_data, jax_data)
    if kind == "vector":
        out = tm.transform(port_data)
        assert type(out["probability"].iloc[0]).__name__ == "DenseVector"


@pytest.mark.parametrize("family", ["auto", "multinomial"])
def test_multinomial_and_non_integer_labels_match_jax(family):
    x, y = _cls(n=400, k=3 if family == "auto" else 2, seed=16, dtype=np.float64)
    labels = np.asarray([-1.5, 0.25, 3.0])[y]
    data = {"features": x, "label": labels}
    tm, jm = _fit_both(data, regParam=0.01, family=family, float32_inputs=False)
    assert tm.n_iter_ == jm.n_iter_ and tm.coef_.shape == jm.coef_.shape
    _same_model(tm, jm, data)
    assert abs(tm.intercept_.sum()) < 1e-12  # centered intercepts
    assert set(np.unique(_cols(tm, data)[2])) <= set(labels)
    _, prob, _ = _cols(tm, data)
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=1e-12)


def test_thresholds_match_jax():
    x, y = _cls(n=300, seed=17)
    data = {"features": x, "label": y.astype(np.float64)}
    tm, jm = _fit_both(data, regParam=0.01, float32_inputs=False)
    for setter, value in (("setThreshold", 0.3), ("setThreshold", 0.8)):
        getattr(tm, setter)(value)
        getattr(jm, setter)(value)
        _, prob, pred = _cols(tm, data)
        np.testing.assert_array_equal(pred, (prob[:, 1] > value).astype(float))
        np.testing.assert_array_equal(pred, _cols(jm, data)[2])
    x3, y3 = _cls(n=300, k=3, seed=18)
    data3 = {"features": x3, "label": y3.astype(np.float64)}
    tm3, jm3 = _fit_both(data3, regParam=0.01, float32_inputs=False)
    tm3._set_params(thresholds=[0.5, 1.0, 2.0])
    jm3._set_params(thresholds=[0.5, 1.0, 2.0])
    _, prob, pred = _cols(tm3, data3)
    np.testing.assert_array_equal(pred, np.argmax(prob / np.asarray([0.5, 1.0, 2.0]), axis=1).astype(float))
    np.testing.assert_array_equal(pred, _cols(jm3, data3)[2])


@pytest.mark.parametrize("label", [1.0, 0.0, 2.5])
def test_single_class_model_matches_jax(label):
    x, _ = _cls(n=50, seed=19, dtype=np.float32)
    data = {"features": x, "label": np.full(len(x), label, np.float32)}
    tm, jm = _fit_both(data)
    np.testing.assert_array_equal(tm.intercept_, jm.intercept_)
    assert np.isinf(tm.intercept_[0]) and tm.n_iter_ == 0 and tm.numClasses == 1
    for got, want in zip(_cols(tm, data), _cols(jm, data)):
        np.testing.assert_array_equal(got, want)
    assert tm.predict(x[0]) == label


def test_family_validation_and_binomial_with_three_classes():
    for cls in (LogisticRegression, JaxLogisticRegression):
        with pytest.raises(ValueError, match="family must be"):
            cls(family="poisson")
    x, y = _cls(n=200, k=3, seed=20)
    data = {"features": x, "label": y.astype(np.float64)}
    with pytest.raises(ValueError, match="family='binomial' but found 3 classes"):
        LogisticRegression(family="binomial").fit(data)
    with pytest.raises(ValueError, match="family='binomial' but found 3 classes"):
        JaxLogisticRegression(num_workers=1, family="binomial").fit(data)


@pytest.mark.parametrize("params", [{}, {"regParam": 0.05, "elasticNetParam": 0.5}, {"standardization": False}])
def test_constant_column_gets_coefficient_zero_as_jax(params):
    x, y = _cls(n=300, seed=21)
    x[:, 3] = 2.5
    data = {"features": x, "label": y.astype(np.float64)}
    tm, jm = _fit_both(data, float32_inputs=False, **params)
    if params.get("standardization", True):
        assert tm.coef_[0, 3] == 0.0 and jm.coef_[0, 3] == 0.0
    _close(tm.coef_, jm.coef_, 1e-6)


@pytest.mark.parametrize("case", ["nan_row", "zero_weights"])
def test_divergence_raises_as_in_jax(case):
    x, y = _cls(n=200, seed=22, dtype=np.float32)
    w = np.ones(len(x), np.float32)
    if case == "nan_row":
        x[17, 2] = np.nan
    else:
        w[:] = 0.0  # an all-zero-weight fold: Σw = 0
    data = {"features": x, "label": y.astype(np.float32), "w": w}
    with pytest.raises(SolverDivergedError) as port_err:
        LogisticRegression().setWeightCol("w").fit(data)
    with pytest.raises(JaxSolverDivergedError) as jax_err:
        JaxLogisticRegression(num_workers=1).setWeightCol("w").fit(data)
    assert port_err.value.iteration == jax_err.value.iteration
    assert port_err.value.solver == jax_err.value.solver == "logistic"


def test_warm_start_from_a_fitted_model():
    x, y = _cls(n=400, seed=23, dtype=np.float32)
    data = {"features": x, "label": y.astype(np.float32)}
    telemetry.registry().reset()
    telemetry.enable()
    try:
        cold = LogisticRegression(maxIter=50, regParam=1e-3).fit(data)
        assert cold.n_iter_ > 3
        warm = LogisticRegression(maxIter=50, regParam=1e-3).fit(data, warm_start_from=cold)
        snap = telemetry.registry().snapshot()
    finally:
        telemetry.disable()
    assert warm.n_iter_ < cold.n_iter_ and warm.n_iter_ <= 3
    np.testing.assert_allclose(warm.coef_, cold.coef_, rtol=2e-2, atol=1e-4)
    assert snap["counters"]["fit.warm_starts"] == 1
    assert snap["counters"]["fit.warm_start_iterations_saved"] == cold.n_iter_
    assert snap["counters"]["logistic.fits"] == 2
    enet = LogisticRegression(maxIter=40, regParam=0.05, elasticNetParam=0.5)
    ecold = enet.fit(data)
    assert enet.fit(data, warm_start_from=ecold).n_iter_ <= ecold.n_iter_
    # the JAX package's warm start seeds its solver the same way
    jwarm = JaxLogisticRegression(num_workers=1, maxIter=50, regParam=1e-3).fit(data, warm_start_from=cold)
    assert abs(jwarm.n_iter_ - warm.n_iter_) <= 1


def test_warm_start_refusals():
    x, y = _cls(n=200, seed=24, dtype=np.float32)
    data = {"features": x, "label": y.astype(np.float32)}
    cold = LogisticRegression(maxIter=10).fit(data)
    with pytest.raises(ValueError, match="warm-start coef shape"):
        LogisticRegression(maxIter=10).fit({"features": x[:, :4], "label": data["label"]}, warm_start_from=cold)
    with pytest.raises(TypeError, match="cannot warm-start"):
        LogisticRegression().fit(data, warm_start_from=object())
    # a GLM loop checkpoint carries the STANDARDIZED iterate, not portable
    # across fits: both packages refuse it with the same pointer
    snap = jckpt.SolverCheckpoint(solver="glm_qn", iteration=7, state={}, portable={"x": np.zeros(7)})
    with pytest.raises(ValueError, match="warm-start from the fitted model") as port_err:
        LogisticRegression(maxIter=10).fit(data, warm_start_from=snap)
    with pytest.raises(ValueError, match="warm-start from the fitted model") as jax_err:
        JaxLogisticRegression(num_workers=1, maxIter=10).fit(data, warm_start_from=snap)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("ckpt_package", ["jax", "torch"])
def test_warm_start_from_a_checkpoint_with_a_coef_payload(ckpt_package):
    # tests/test_warm_start.py's seed through a SolverCheckpoint of either
    # package carrying the original-space coef_ (and intercept_): the same
    # seed as the fitted model, so the same fit, and as JAX's
    from spark_rapids_ml_tpu_torch import checkpoint as tckpt

    x, y = _cls(n=300, seed=26, dtype=np.float64)
    data = {"features": x, "label": y.astype(np.float64)}

    def make():
        return LogisticRegression(maxIter=50, regParam=1e-3, float32_inputs=False)

    cold = make().fit(data)
    payload = dict(solver="glm_qn", iteration=int(cold.n_iter_), state={},
                   portable={"coef_": cold.coef_, "intercept_": cold.intercept_})
    snap = (jckpt if ckpt_package == "jax" else tckpt).SolverCheckpoint(**payload)
    from_model = make().fit(data, warm_start_from=cold)
    from_ckpt = make().fit(data, warm_start_from=snap)
    np.testing.assert_array_equal(from_ckpt.coef_, from_model.coef_)
    assert from_ckpt.n_iter_ == from_model.n_iter_ <= cold.n_iter_
    # the JAX package takes only its own class
    jwarm = JaxLogisticRegression(num_workers=1, maxIter=50, regParam=1e-3, float32_inputs=False).fit(
        data, warm_start_from=jckpt.SolverCheckpoint(**payload))
    assert abs(jwarm.n_iter_ - from_ckpt.n_iter_) <= 1
    # the converged float64 fits' bound (the header): 1e-8 of the largest
    assert np.abs(jwarm.coef_ - from_ckpt.coef_).max() <= 1e-8 * np.abs(from_ckpt.coef_).max() + 1e-12


def test_sparse_switch_and_input_name_their_roadmap_item():
    # (named when both raised for ROADMAP A11b) the switch and sparse input
    # behave as in the JAX package: True on dense input raises JAX's
    # ValueError; sparse input fits on the padded-ELL layout (scale-only
    # standardization), equal to JAX's fit; False densifies it, and then
    # the fit is the dense fit
    import scipy.sparse as sp

    x, y = _cls(n=50, seed=25, dtype=np.float32)
    data = {"features": x, "label": y.astype(np.float32)}
    with pytest.raises(ValueError, match="requires sparse input"):
        LogisticRegression(enable_sparse_data_optim=True).fit(data)
    with pytest.raises(ValueError, match="requires sparse input"):
        JaxLogisticRegression(enable_sparse_data_optim=True, num_workers=1).fit(data)
    xs = np.where(np.abs(x) > 0.5, x, 0.0).astype(np.float64)
    sparse = {"features": sp.csr_matrix(xs), "label": y.astype(np.float64)}
    tm = LogisticRegression(maxIter=30, float32_inputs=False).fit(sparse)
    jm = JaxLogisticRegression(maxIter=30, float32_inputs=False, num_workers=1).fit(sparse)
    assert tm.n_iter_ == jm.n_iter_
    np.testing.assert_allclose(tm.coef_, jm.coef_, rtol=1e-8, atol=1e-10)
    dense = LogisticRegression(maxIter=30, float32_inputs=False).fit({"features": xs, "label": sparse["label"]})
    off = LogisticRegression(maxIter=30, float32_inputs=False, enable_sparse_data_optim=False).fit(sparse)
    np.testing.assert_array_equal(off.coef_, dense.coef_)
    m = LogisticRegression(enable_sparse_data_optim=False).fit(data)
    assert m.n_iter_ > 0


def test_params_mirror_the_jax_estimator():
    kw = dict(regParam=0.3, elasticNetParam=0.2, maxIter=7, tol=1e-5, fitIntercept=False,
              standardization=False, family="multinomial", threshold=0.4)
    assert LogisticRegression(**kw).solver_params == JaxLogisticRegression(**kw).solver_params
    est = LogisticRegression().setProbabilityCol("p").setRawPredictionCol("r").setThresholds([0.2, 0.8])
    assert est.getOrDefault("probabilityCol") == "p" and est.getOrDefault("rawPredictionCol") == "r"
    assert est.getOrDefault("thresholds") == [0.2, 0.8] and est.getThreshold() == 0.5
    jest = JaxLogisticRegression()
    for name in ("maxIter", "regParam", "tol", "family", "threshold", "standardization", "fitIntercept"):
        assert est.getOrDefault(name) == jest.getOrDefault(name), name
    assert sorted(p.name for p in est.params) == sorted(p.name for p in jest.params)


@pytest.mark.parametrize("mixin,name,default", [
    ("HasProbabilityCol", "probabilityCol", "probability"),
    ("HasRawPredictionCol", "rawPredictionCol", "rawPrediction"),
    ("HasEnableSparseDataOptim", "enable_sparse_data_optim", None),
])
def test_new_param_mixins_mirror_jax(mixin, name, default):
    port, jax_ = getattr(tparams, mixin)(), getattr(jparams, mixin)()
    assert port.hasParam(name) and jax_.hasParam(name)
    assert port.getOrDefault(name) == jax_.getOrDefault(name) == default


def test_model_surface_and_single_vector_predict():
    x, y = _cls(n=200, seed=26, dtype=np.float32)
    data = {"features": x, "label": y.astype(np.float32)}
    tm = LogisticRegression(regParam=0.01).fit(data)
    assert tm.coefficients.toArray().tolist() == tm.coef_[0].tolist()
    assert tm.intercept == tm.intercept_[0] and tm.coefficientMatrix is tm.coef_
    assert tm.interceptVector.toArray().tolist() == tm.intercept_.tolist()
    raw, prob, pred = _cols(tm, data)
    np.testing.assert_allclose(raw[:, 1], -raw[:, 0])
    for i in range(5):
        assert tm.predict(x[i]) == pred[i]
        np.testing.assert_array_equal(tm.predictProbability(Vectors.dense(x[i])).toArray(), prob[i])
        np.testing.assert_array_equal(tm.predictRaw(x[i]).toArray(), raw[i])
    with pytest.raises(RuntimeError, match="No training summary"):
        tm.summary
    x3, y3 = _cls(n=200, k=3, seed=27, dtype=np.float32)
    tm3 = LogisticRegression().fit({"features": x3, "label": y3.astype(np.float32)})
    with pytest.raises(Exception, match="coefficientMatrix"):
        tm3.coefficients
    with pytest.raises(Exception, match="interceptVector"):
        tm3.intercept


@pytest.mark.parametrize("call,item", [
    (lambda m: m.evaluate({"features": np.zeros((1, 6), np.float32)}), "A16"),
    (lambda m: m.cpu(), "A16"),
])
def test_left_out_surface_names_its_roadmap_item(call, item):
    x, y = _cls(n=100, seed=28, dtype=np.float32)
    tm = LogisticRegression(maxIter=5).fit({"features": x, "label": y.astype(np.float32)})
    with pytest.raises(NotImplementedError, match=item):
        call(tm)


@pytest.mark.parametrize("entry", ["arrays", "dataset"])
def test_combine_and_transform_evaluate_score_like_jax(entry):
    # the fused CV path: the JAX models packed by `_combine` and scored by
    # `_transform_evaluate(_arrays)` in both packages give the same metrics
    # (accuracy and f1 exactly; logLoss to the float64 bound, with a label
    # the models never saw getting probability eps)
    from spark_rapids_ml_tpu.evaluation import MulticlassClassificationEvaluator as JaxEvaluator
    from spark_rapids_ml_tpu_torch import MulticlassClassificationEvaluator

    x, y = _cls(n=200, k=3, seed=28)
    data = {"features": x, "label": y.astype(np.float64)}
    jms = [JaxLogisticRegression(num_workers=1, float32_inputs=False, maxIter=30, regParam=r).fit(data)
           for r in (1e-3, 0.1)]
    tms = [logistic_regression_model_from_jax(dict(m._model_attributes)) for m in jms]
    tc, jc = tms[0]._combine(tms), jms[0]._combine(jms)
    assert tc._sub_models == tms
    label = y.astype(np.float64).copy()
    label[:3] = 7.0  # a class no model saw
    for metric in ("accuracy", "f1", "logLoss"):
        tev, jev = MulticlassClassificationEvaluator(metricName=metric), JaxEvaluator(metricName=metric)
        if entry == "arrays":
            got, want = tc._transform_evaluate_arrays(x, label, tev), jc._transform_evaluate_arrays(x, label, jev)
            # and from rows on the device
            np.testing.assert_array_equal(tc._transform_evaluate_arrays(torch.from_numpy(x), label, tev), got)
        else:
            got, want = tc._transform_evaluate(data, tev), jc._transform_evaluate(data, jev)
        if metric == "logLoss":
            np.testing.assert_allclose(got, want, rtol=F64)
        else:
            np.testing.assert_array_equal(got, want)


def test_unstandardized_stall_warns(caplog):
    state = {"stalled_": True, "n_iter_": 3}
    with caplog.at_level("WARNING"):
        assert tlog.warn_if_early_stall(state, standardize=False, max_iter=100)
    assert "stalled after 3/100" in caplog.text
    assert not tlog.warn_if_early_stall(state, standardize=True, max_iter=100)
    assert not tlog.warn_if_early_stall(dict(state, stalled_=False), standardize=False, max_iter=100)


# ------------------------------------------------------- persistence ----


@pytest.mark.parametrize("float32_inputs", [True, False])
@pytest.mark.parametrize("k", [2, 3])
def test_jax_saved_model_loads_and_predicts_the_same(tmp_path, float32_inputs, k):
    dtype = np.float32 if float32_inputs else np.float64
    x, y = _cls(n=200, k=k, seed=29, dtype=dtype)
    data = {"features": x, "label": y.astype(dtype)}
    jm = JaxLogisticRegression(num_workers=1, regParam=0.01, float32_inputs=float32_inputs) \
        .setProbabilityCol("p").fit(data)
    path = str(tmp_path / "jax_logreg")
    jm.write().overwrite().save(path)
    tm = LogisticRegressionModel.load(path)
    np.testing.assert_array_equal(tm.coef_, jm.coef_)
    np.testing.assert_array_equal(tm.classes_, jm.classes_)
    assert tm.n_iter_ == jm.n_iter_ and tm.objective_ == jm.objective_
    assert tm.float32_inputs == float32_inputs and tm.getOrDefault("probabilityCol") == "p"
    want = np.stack(jm.transform(data)["p"].to_numpy())
    rtol = 1e-6 if float32_inputs else F64
    _close(np.stack(tm.transform(data)["p"].to_numpy()), want, rtol, 1.0)
    conv = logistic_regression_model_from_jax(jm._model_attributes)
    assert conv.float32_inputs == float32_inputs and conv.getThreshold() == 0.5
    _close(_cols(conv, data)[1], want, rtol, 1.0)


def test_port_saved_model_loads_in_jax_and_back(tmp_path):
    x, y = _cls(n=200, k=3, seed=30, dtype=np.float32)
    data = {"features": x, "label": y.astype(np.float32)}
    tm = LogisticRegression(regParam=0.05, elasticNetParam=0.5).setThresholds([1.0, 2.0, 1.0]).fit(data)
    path = str(tmp_path / "port_logreg")
    tm.write().overwrite().save(path)
    assert sorted(os.listdir(path)) == ["arrays.npz", "attributes.json", "metadata.json"]
    jm = JaxLogisticRegressionModel.load(path)
    back = LogisticRegressionModel.load(path)
    want = _cols(tm, data)
    for got, w in zip(_cols(back, data), want):
        np.testing.assert_array_equal(got, w)
    _close(_cols(jm, data)[1], want[1], 1e-6, 1.0)
    np.testing.assert_array_equal(_cols(jm, data)[2], want[2])
    assert back.uid == tm.uid and back.n_iter_ == tm.n_iter_ and back.getOrDefault("thresholds") == [1.0, 2.0, 1.0]


def test_convert_refuses_incomplete_attributes():
    with pytest.raises(ValueError, match="lack"):
        logistic_regression_model_from_jax({"coef_": np.zeros((1, 3))})
    with pytest.raises(ValueError, match="coef_ must be 2-D"):
        logistic_regression_model_from_jax({
            "coef_": np.zeros(3), "intercept_": np.zeros(1), "classes_": np.asarray([0.0, 1.0]),
            "n_iter_": 1, "objective_": 0.5, "n_cols": 3, "dtype": "float32",
        })


# ----------------------------------------------------------- serving ----


_SERVE_KEYS = ("transform_bucket_min_rows", "serve_prewarm_rows", "serve_max_batch_rows", "serve_coalesce_window_ms")


@pytest.fixture
def small_ladder():
    saved = {k: config[k] for k in _SERVE_KEYS}
    config.update({"transform_bucket_min_rows": 8, "serve_prewarm_rows": 64, "serve_max_batch_rows": 256,
                   "serve_coalesce_window_ms": 25.0})
    yield
    config.update(saved)


@pytest.mark.parametrize("float32_inputs", [True, False])
def test_logistic_serving_coalesced_equals_solo_and_transform(small_ladder, float32_inputs):
    dtype = np.float32 if float32_inputs else np.float64
    x, y = _cls(n=600, seed=31, dtype=dtype)
    x3, y3 = _cls(n=600, k=4, seed=32, dtype=dtype)
    models = {
        "bin": LogisticRegression(float32_inputs=float32_inputs).fit({"features": x, "label": y.astype(dtype)}),
        "multi": LogisticRegression(float32_inputs=float32_inputs).fit({"features": x3, "label": y3.astype(dtype)}),
    }
    rows = {"bin": x, "multi": x3}
    registry = ModelRegistry()
    for name, m in models.items():
        registry.load(name, m)
    requests = [(0, 1), (3, 7), (10, 64), (80, 200), (300, 255), (7, 33)]
    with ScoringEngine(registry, coalesce_window_s=0.0) as engine:
        solo = {name: [engine.score(name, rows[name][lo:lo + n]) for lo, n in requests] for name in models}
    with ScoringEngine(registry) as engine:
        futs = {name: [None] * len(requests) for name in models}

        def submit(name, i):
            lo, n = requests[i]
            futs[name][i] = engine.submit(name, rows[name][lo:lo + n])

        ts = [threading.Thread(target=submit, args=(name, i)) for name in futs for i in range(len(requests))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        coalesced = {name: [f.result(timeout=120) for f in fs] for name, fs in futs.items()}
    for name, m in models.items():
        raw_all, prob_all, _ = _cols(m, {"features": rows[name]})
        for i, (lo, n) in enumerate(requests):
            raw, prob = coalesced[name][i]
            assert raw.dtype == prob.dtype == dtype and raw.shape == (n, 2 if name == "bin" else 4)
            for got, alone, whole in ((raw, solo[name][i][0], raw_all), (prob, solo[name][i][1], prob_all)):
                np.testing.assert_array_equal(got, alone)
                np.testing.assert_array_equal(got.astype(np.float64), whole[lo:lo + n])
    registry.clear()


def test_binomial_margin_of_plus_inf_matches_jax(small_ladder):
    # fault C3 (ROADMAP §C): a query row 3e38·sign(coef) is finite in float32
    # but its margin overflows to +inf; JAX gives probability [0, 1] and
    # prediction 1.0, and so must the port from every surface; beside it a
    # row at −inf. Tolerance: equality. (A row of the training data rides
    # along for the served response, held to the port's own transform.)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 6))
    y = (x @ rng.normal(size=6) + 0.5 * rng.normal(size=300) > 0).astype(np.float64)
    data = {"features": x.astype(np.float32), "label": y}
    tm = LogisticRegression(regParam=0.01).fit(data)
    jm = JaxLogisticRegression(num_workers=1, regParam=0.01).fit(data)
    s = np.sign(tm.coef_[0])
    q = np.stack([3e38 * s, -3e38 * s, x[0]]).astype(np.float32)
    got, want = _cols(tm, {"features": q}), _cols(jm, {"features": q[:2]})
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g[:2], w_)
    np.testing.assert_array_equal(got[1][0], [0.0, 1.0])
    assert got[2][0] == 1.0 and got[2][1] == 0.0
    for i in range(2):
        assert tm.predict(q[i]) == jm.predict(q[i])
        np.testing.assert_array_equal(tm.predictProbability(q[i]).toArray(), jm.predictProbability(q[i]).toArray())
    registry = ModelRegistry()
    registry.load("lr", tm)
    with ScoringEngine(registry) as engine:
        raw, prob = engine.score("lr", q)
    registry.clear()
    np.testing.assert_array_equal(prob[:2].astype(np.float64), want[1])
    np.testing.assert_array_equal(raw[:2].astype(np.float64), want[0])
    np.testing.assert_array_equal(prob.astype(np.float64), got[1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_binomial_link_is_unchanged_away_from_plus_inf(dtype):
    # the C3 repair touches m = +inf only: finite margins and −inf keep the
    # bits of softmax([0, m])
    m = np.concatenate([np.random.default_rng(2).normal(size=50) * 30, [-np.inf, 0.0, 88.0, -700.0]]).astype(dtype)
    x = _t(m[:, None])
    raw, prob = tlog.logistic_predict(x, _t(np.ones((1, 1), dtype)), _t(np.zeros(1, dtype)), multinomial=False)
    want = torch.softmax(torch.cat([torch.zeros_like(x), x], dim=1), dim=1)
    np.testing.assert_array_equal(prob.numpy(), want.numpy())
    np.testing.assert_array_equal(prob.numpy()[-4], [1.0, 0.0])


def test_serving_workspace_terms_price_the_margins():
    x, y = _cls(n=100, k=3, seed=33, dtype=np.float32)
    m = LogisticRegression().fit({"features": x, "label": y.astype(np.float32)})
    terms = m._serve_workspace_terms(256, 4)
    assert terms["logits"] == 2 * 256 * 3 * 4 and terms["dot_block"] == 256 * 3 * 6 * 4 * 3 // 2
    assert m._serve_flop_estimate(10, 6) == 2.0 * 10 * 6 * 3


# -------------------------------------------------------------- the card ----


@pytest.fixture
def card():
    """A CUDA device for the card tests; skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: LogisticRegression on the card runs on an NVIDIA GPU only (chip_smoke.py phase 8)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_FITS))
def test_logistic_fit_on_card_matches_cpu(card, name):
    kw = dict(_FITS[name])
    x, y = _cls(n=2000, k=kw["k"], seed=34)
    (_, _, _), (tx, ty, tw) = _both_inputs(x, y)
    kw.update(max_iter=100, tol=1e-10)
    cpu = tlog.logistic_fit(tx, ty, tw, **kw)
    gpu = tlog.logistic_fit(tx.to(card), ty.to(card), tw.to(card), **kw)
    _close(gpu["coef_"].cpu().numpy(), cpu["coef_"].numpy(), 1e-8)
    _close(gpu["objective_"].cpu().numpy(), cpu["objective_"].numpy(), F64)


# ---------------------------------------------------- import boundary ----


_GUARD = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
from spark_rapids_ml_tpu_torch import LogisticRegression, ModelRegistry, ScoringEngine, set_devices
set_devices("cpu")
rng = np.random.default_rng(0)
x = rng.normal(size=(200, 4)).astype(np.float32)
y = (x @ rng.normal(size=4) > 0).astype(np.float32)
m = LogisticRegression(regParam=0.01).fit({"features": x, "label": y})
m.transform({"features": x})
LogisticRegression(regParam=0.01, elasticNetParam=0.5).fit({"features": x, "label": y})
LogisticRegression(solver_precision="bf16").fit({"features": x, "label": y})
registry = ModelRegistry()
registry.load("lr", m)
with ScoringEngine(registry) as engine:
    raw, prob = engine.score("lr", x[:3])
    assert raw.shape == prob.shape == (3, 2)
bad = sorted(n for n in sys.modules
             if n == "spark_rapids_ml_tpu" or n.startswith("spark_rapids_ml_tpu."))
assert not bad, bad
assert sys.modules["jax"] is None
print("GUARD-OK")
"""


def test_logistic_regression_runs_without_jax_or_the_jax_package():
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD], cwd=str(root), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "GUARD-OK" in proc.stdout
