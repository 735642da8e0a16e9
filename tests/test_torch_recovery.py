#
# The PyTorch port's recovery (spark_rapids_ml_tpu_torch/checkpoint.py,
# core.retryable_stage / recoverable_stage, the solver checkpoints of
# ops/kmeans.py, ops/logistic.py, ops/owlqn.py, ops/linear.py, ops/pca.py and
# ops/streaming.py, chaos `fail:` and `oom:stage=solve:round=`) on the CPU,
# case for case with tests/test_recovery.py's store and solver cases and
# tests/test_chaos.py's retryable_stage cases, against the JAX package on
# the same seeded numpy inputs.
#
# Tolerances, and why:
#   * the port against itself: bit for bit. A resumed fit equals the
#     uninterrupted checkpointed fit and the unchecked fit exactly (the
#     checkpoint round-trips the loop's whole state losslessly, and the
#     port's checkpointed loops run the same operations as its unchecked
#     ones: a checkpoint only adds a host copy);
#   * the port's checkpointed fits against JAX's checkpointed fits, float64,
#     at the existing parity bounds: KMeans rtol 1e-9 with n_iter_ equal
#     (tests/test_torch_kmeans.py's float64 fit), LogisticRegression n_iter_
#     equal and coefficients within 1e-8 of the largest
#     (tests/test_torch_logistic.py's converged float64 fits), PCA and
#     LinearRegression rtol 1e-9 (tests/test_torch_oocore.py's float64
#     bound for the same statistics summed in another order);
#   * counters exactly: fit.retries, checkpoint.saves / restores /
#     stats_reuses, memory.oom_caught, fit.demotions.
#
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_tpu import checkpoint as jckpt
from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu import errors as jerrors
from spark_rapids_ml_tpu import telemetry as jtele
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.models.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.models.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.models.regression import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu.ops import kmeans as jkm
from spark_rapids_ml_tpu.parallel import chaos as jchaos
from spark_rapids_ml_tpu_torch import (
    KMeans,
    LinearRegression,
    LogisticRegression,
    PCA,
    checkpoint as tckpt,
    core as tcore,
    errors as terrors,
    parallel,
    telemetry as ttele,
)
from spark_rapids_ml_tpu_torch.ops import kmeans as tkm
from spark_rapids_ml_tpu_torch.ops import logistic as tlog
from spark_rapids_ml_tpu_torch.ops import owlqn as towlqn
from spark_rapids_ml_tpu_torch.parallel import chaos as tchaos
from spark_rapids_ml_tpu_torch.utils import numcheck as tnumcheck

_KEYS = ("checkpoint_every_iters", "fit_retry_backoff_s", "fit_max_retries",
         "hbm_budget_bytes", "stream_chunk_rows")

# one bundle per package, for the cases both run alike
SIDES = {
    "torch": dict(ckpt=tckpt, core=tcore, tele=ttele, chaos=tchaos, errors=terrors),
    "jax": dict(ckpt=jckpt, core=jcore, tele=jtele, chaos=jchaos, errors=jerrors),
}


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """The port on the CPU; both packages with no fault plan, a 10 ms
    backoff, telemetry on with fresh registries; their config restored."""
    from spark_rapids_ml_tpu_torch.scheduler import ledger as tledger

    parallel.set_devices("cpu")
    monkeypatch.setattr(tledger, "_GLOBAL", tledger.HbmLedger())
    saved = {k: tcore.config[k] for k in _KEYS}
    jsaved = {k: jcore.config[k] for k in _KEYS if k in jcore.config}
    for side in SIDES.values():
        side["chaos"].clear_fault_plan()
        side["core"].config["fit_retry_backoff_s"] = 0.01
        side["tele"].enable()
        side["tele"].registry().reset()
    yield
    for side in SIDES.values():
        side["chaos"].clear_fault_plan()
        side["tele"].disable()
        side["tele"].registry().reset()
    tcore.config.update(saved)
    jcore.config.update(jsaved)
    parallel.set_devices(None)


def _counters(side="torch"):
    return SIDES[side]["tele"].registry().snapshot()["counters"]


def _cadence(n):
    tcore.config["checkpoint_every_iters"] = n
    jcore.config["checkpoint_every_iters"] = n


def _blobs(rng, n=600, d=5, dtype=np.float32):
    return rng.normal(size=(n, d)).astype(dtype)


def _cls_data(rng, n=600, d=5, dtype=np.float32):
    x = _blobs(rng, n, d, dtype)
    # noisy labels keep the minimizer finite and the fit well conditioned
    y = ((x @ rng.normal(size=d) + rng.normal(size=n)) > 0).astype(np.float64)
    return {"features": x, "label": y}


# ------------------------------------------------------------ store basics --


@pytest.mark.parametrize("side", list(SIDES))
def test_checkpoint_scope_isolation_and_adoption(side):
    ckpt = SIDES[side]["ckpt"]
    assert ckpt.active_store() is None
    with ckpt.checkpoint_scope() as outer:
        assert ckpt.active_store() is outer
        outer.save("k", ckpt.SolverCheckpoint(solver="s", iteration=1, state={}))
        with ckpt.ensure_scope() as inner:  # adopts, does not shadow
            assert inner is outer
            assert len(inner) == 1
        assert len(outer) == 1  # the nested exit did NOT clear the store
    assert ckpt.active_store() is None


@pytest.mark.parametrize("side", list(SIDES))
def test_checkpoint_scope_clears_on_exit(side):
    ckpt = SIDES[side]["ckpt"]
    with ckpt.checkpoint_scope() as store:
        store.save("k", ckpt.SolverCheckpoint(solver="s", iteration=3, state={}))
    assert len(store) == 0  # per stage: checkpoints never leak across fits


@pytest.mark.parametrize("side", list(SIDES))
def test_get_or_compute_is_placement_keyed(side):
    ckpt = SIDES[side]["ckpt"]
    calls = []

    def compute():
        calls.append(1)
        return {"G": np.eye(2)}

    with ckpt.checkpoint_scope() as store:
        a = store.get_or_compute("stats", compute, solver="linear", placement_key=("m1",))
        b = store.get_or_compute("stats", compute, solver="linear", placement_key=("m1",))
        assert a is b and len(calls) == 1
        assert _counters(side)["checkpoint.stats_reuses"] == 1
        # another placement must recompute, not reuse
        store.get_or_compute("stats", compute, solver="linear", placement_key=("m2",))
        assert len(calls) == 2
        assert _counters(side)["checkpoint.saves"] == 2


@pytest.mark.parametrize("side", list(SIDES))
def test_solver_checkpoints_active_requires_cadence_and_store(side):
    ckpt, core = SIDES[side]["ckpt"], SIDES[side]["core"]
    core.config["checkpoint_every_iters"] = 0
    with ckpt.checkpoint_scope():
        assert not ckpt.solver_checkpoints_active()
    core.config["checkpoint_every_iters"] = 2
    assert not ckpt.solver_checkpoints_active()  # no store installed
    with ckpt.checkpoint_scope():
        assert ckpt.solver_checkpoints_active()
        assert ckpt.every_iters() == 2


def test_the_config_defaults_are_the_jax_packages():
    for key in ("fit_max_retries", "fit_retry_backoff_max_s"):
        assert tcore.config[key] == jcore.config[key]
    assert tcore.config["checkpoint_every_iters"] == jcore.config["checkpoint_every_iters"] == 0


def test_placement_key_of_a_resident_fit():
    inputs = tcore.FitInputs(X=None, w=None, n_valid=10, n_cols=3, dtype=np.float32, device=torch.device("cpu"))
    assert tckpt.placement_key_of(inputs) == ((0,), 10, 3, "float32")


# ------------------------------------------------------- retryable_stage ----


@pytest.mark.parametrize("side", list(SIDES))
def test_retryable_stage_retries_transient_and_counts(side):
    s = SIDES[side]
    calls = []

    def fn(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise s["errors"].RendezvousTimeoutError("flaky round")
        return "ok"

    assert s["core"].retryable_stage(fn, stage="t", max_retries=3) == "ok"
    assert calls == [0, 1, 2]
    assert _counters(side)["fit.retries"] == 2


@pytest.mark.parametrize("side", list(SIDES))
def test_retryable_stage_permanent_errors_propagate_immediately(side):
    s = SIDES[side]
    calls = []

    def fn(attempt):
        calls.append(attempt)
        raise s["errors"].RankFailedError(1, "dead peer")

    with pytest.raises(s["errors"].RankFailedError, match="rank 1 failed: dead peer"):
        s["core"].retryable_stage(fn, stage="t", max_retries=3)
    assert calls == [0]  # permanent: no second attempt
    assert "fit.retries" not in _counters(side)


@pytest.mark.parametrize("side", list(SIDES))
def test_retryable_stage_bounded_exhaustion(side):
    s = SIDES[side]
    calls = []

    def fn(attempt):
        calls.append(attempt)
        raise s["errors"].RendezvousTimeoutError("always down")

    with pytest.raises(s["errors"].RendezvousTimeoutError):
        s["core"].retryable_stage(fn, stage="t", max_retries=2)
    assert calls == [0, 1, 2]  # the first try + 2 retries, then it gives up


@pytest.mark.parametrize("side", list(SIDES))
def test_retryable_stage_chaos_injection(side):
    s = SIDES[side]
    s["chaos"].set_fault_plan("fail:stage=probe:times=1")
    calls = []
    result = s["core"].retryable_stage(lambda attempt: calls.append(attempt) or attempt, stage="probe", max_retries=2)
    assert result == 1 and calls == [1]  # attempt 0 was injected away


def test_retryable_stage_backoff_is_capped_exponential(monkeypatch):
    import time

    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    tcore.config.update(fit_retry_backoff_s=0.5, fit_retry_backoff_max_s=1.5)
    try:
        with pytest.raises(terrors.RendezvousTimeoutError):
            tcore.retryable_stage(lambda a: (_ for _ in ()).throw(terrors.RendezvousTimeoutError("down")),
                                  stage="t", max_retries=4)
    finally:
        tcore.config["fit_retry_backoff_max_s"] = jcore.config["fit_retry_backoff_max_s"]
    assert sleeps == [0.5, 1.0, 1.5, 1.5]


def test_is_transient_classifies_as_jax_does():
    cases = [
        lambda e: e.RendezvousTimeoutError("t"),
        lambda e: e.RankFailedError(0, "x"),
        lambda e: RuntimeError("torch.distributed: process group already initialized"),
        lambda e: RuntimeError("cannot initialize"),
        lambda e: ValueError("bad"),
    ]
    for make in cases:
        assert terrors.is_transient(make(terrors)) == jerrors.is_transient(make(jerrors))
    assert [terrors.is_transient(make(terrors)) for make in cases] == [True, False, True, False, False]


def test_fit_retry_is_bit_identical_and_counted():
    # tests/test_chaos.py's acceptance case: a transient fault at the top of
    # the fit stage retries once, and the model is the clean one bit for bit
    rng = np.random.default_rng(3)
    data = _cls_data(rng, n=400, d=4, dtype=np.float64)

    def make():
        return LogisticRegression(maxIter=25, float32_inputs=False)

    clean = make().fit(data)
    tchaos.set_fault_plan("fail:stage=fit:times=1")
    ttele.registry().reset()
    retried = make().fit(data)
    np.testing.assert_array_equal(retried.coef_, clean.coef_)
    np.testing.assert_array_equal(retried.intercept_, clean.intercept_)
    assert retried.n_iter_ == clean.n_iter_
    assert _counters()["fit.retries"] == 1


# ---------------------------------------------- recoverable_stage (unit) --


@pytest.mark.parametrize("side", list(SIDES))
def test_recoverable_stage_without_a_rendezvous_degrades_to_typed_failure(side):
    # no substrate to reform on: the RankFailedError propagates, stamped
    # with how far recovery got (never opened)
    s = SIDES[side]

    def fit(attempt):
        raise s["errors"].RankFailedError(0, "peer gone")

    with pytest.raises(s["errors"].RankFailedError) as ei:
        s["core"].recoverable_stage(fit, stage="fit")
    assert ei.value.recovery_exhausted is False
    assert ei.value.recovery_generations == 0


@pytest.mark.parametrize("side", list(SIDES))
def test_recoverable_stage_timeouts(side):
    # a timeout naming missing ranks outlives the retries and degrades
    # typed; one naming none (a chaos `fail`) is retryable_stage's alone
    s = SIDES[side]
    s["core"].config["fit_max_retries"] = 1
    calls = []

    def fit(attempt):
        calls.append(attempt)
        raise s["errors"].RendezvousTimeoutError("round 3", missing_ranks=[1])

    with pytest.raises(s["errors"].RendezvousTimeoutError) as ei:
        s["core"].recoverable_stage(fit, stage="fit")
    assert calls == [0, 1]
    assert ei.value.recovery_exhausted is False and ei.value.recovery_generations == 0
    s["chaos"].set_fault_plan("fail:stage=fit:times=5")
    with pytest.raises(s["errors"].RendezvousTimeoutError) as ei:
        s["core"].recoverable_stage(lambda a: "never", stage="fit")
    assert "recovery_generations" not in vars(ei.value)  # not stamped


@pytest.mark.parametrize("side", list(SIDES))
def test_recoverable_stage_store_spans_the_attempts(side):
    # the attempts of one stage share ONE store, cleared when it exits
    s = SIDES[side]
    seen = []

    def fit(attempt):
        store = s["ckpt"].active_store()
        seen.append((store, len(store)))
        store.save("it", s["ckpt"].SolverCheckpoint(solver="unit", iteration=attempt + 1, state={}))
        if attempt == 0:
            raise s["errors"].RendezvousTimeoutError("once")
        return store

    store = s["core"].recoverable_stage(fit, stage="fit")
    assert [n for _, n in seen] == [0, 1] and seen[0][0] is seen[1][0] is store
    assert len(store) == 0 and s["ckpt"].active_store() is None


# ----------------------------------------------- the solvers' checkpoints --


@pytest.mark.parametrize("shape, dtype", [((8, 5), np.float32), ((4, 3), np.float64), ((1000, 3000), np.float32)])
def test_kmeans_ckpt_key_is_the_jax_packages_string(shape, dtype):
    init = np.random.default_rng(1).normal(size=shape).astype(dtype)
    for max_iter, tol in ((10, 0.0), (20, 1e-4)):
        key = tkm.kmeans_ckpt_key(init, max_iter, tol)
        assert key == jkm.kmeans_ckpt_key(init, max_iter, tol)
        assert key == tkm.kmeans_ckpt_key(torch.from_numpy(init), max_iter, tol)
        assert key.startswith(f"kmeans:{shape}:")


@pytest.mark.parametrize("precision", ["fast", "high"])
def test_kmeans_interrupted_fit_resumes_bit_identical(precision):
    # a fit interrupted mid-solve (a transient fault at a checkpoint
    # boundary) retries, RESUMES from the checkpoint (counted), and equals
    # the uninterrupted checkpointed fit and the unchecked fit bit for bit
    x = _blobs(np.random.default_rng(11))

    def fit():
        return KMeans(k=8, maxIter=10, tol=0.0, seed=7, distance_precision=precision).fit({"features": x})

    plain = fit()
    _cadence(3)
    clean = fit()
    assert _counters()["checkpoint.saves"] == 3  # iterations 3, 6, 9
    tchaos.set_fault_plan("fail:stage=solve:times=1")
    ttele.registry().reset()
    resumed = fit()
    snap = _counters()
    for m in (clean, resumed):
        np.testing.assert_array_equal(m.cluster_centers_, plain.cluster_centers_)
        assert m.n_iter_ == plain.n_iter_ == 10 and m.inertia_ == plain.inertia_
    assert snap["fit.retries"] == 1
    assert snap["checkpoint.restores"] == 1  # resumed, not restarted
    assert snap["checkpoint.saves"] == 3  # 3, then 6 and 9 after the resume


def test_kmeans_checkpoints_key_the_fast_trajectory_apart():
    x = _blobs(np.random.default_rng(12))
    _cadence(2)
    keys = []
    real = tckpt.CheckpointStore.save
    try:
        tckpt.CheckpointStore.save = lambda self, key, c: keys.append(key) or real(self, key, c)
        for precision in ("fast", "high"):
            KMeans(k=4, maxIter=2, tol=0.0, seed=3, distance_precision=precision).fit({"features": x})
    finally:
        tckpt.CheckpointStore.save = real
    assert keys[0].endswith(":bf16") and keys[1] == keys[0][: -len(":bf16")]


def test_kmeans_checkpointed_fit_matches_jax():
    x = _blobs(np.random.default_rng(13), n=400, d=6, dtype=np.float64)
    _cadence(2)
    params = dict(k=4, maxIter=12, tol=0.0, initMode="random", seed=5, float32_inputs=False)
    for chaos in (tchaos, jchaos):
        chaos.set_fault_plan("fail:stage=solve:times=1")
    tm = KMeans(**params).fit({"features": x})
    jm = JaxKMeans(num_workers=1, **params).setFeaturesCol("features").fit({"features": x})
    assert _counters()["checkpoint.restores"] == _counters("jax")["checkpoint.restores"] == 1
    assert tm.n_iter_ == jm.n_iter_
    np.testing.assert_allclose(tm.cluster_centers_, jm.cluster_centers_, rtol=1e-9)
    np.testing.assert_allclose(tm.inertia_, jm.inertia_, rtol=1e-9)


def test_checkpoint_disabled_by_default_costs_nothing():
    # cadence 0 (the default): no store traffic, no counters, the same fit
    x = _blobs(np.random.default_rng(14))
    assert tcore.config["checkpoint_every_iters"] == 0
    KMeans(k=4, maxIter=5, seed=1).fit({"features": x})
    LogisticRegression(maxIter=5).fit(_cls_data(np.random.default_rng(14)))
    snap = _counters()
    assert "checkpoint.saves" not in snap and "checkpoint.restores" not in snap


_GLM_CASES = {
    "glm_qn": dict(maxIter=20, tol=1e-30, regParam=1e-3),
    "owlqn": dict(maxIter=20, tol=1e-30, regParam=0.005, elasticNetParam=0.5),
}


@pytest.mark.parametrize("solver", list(_GLM_CASES))
def test_logistic_interrupted_fit_resumes_bit_identical(solver):
    data = _cls_data(np.random.default_rng(15), d=10)

    def fit():
        return LogisticRegression(**_GLM_CASES[solver]).fit(data)

    plain = fit()
    assert plain.n_iter_ > 6
    _cadence(3)
    clean = fit()
    saves = _counters()["checkpoint.saves"]
    assert saves == -(-plain.n_iter_ // 3)  # every 3 iterations and where the loop stopped
    # the fault at the second boundary (iteration 6): the retry resumes there
    tchaos.set_fault_plan("fail:stage=solve:round=6")
    ttele.registry().reset()
    resumed = fit()
    snap = _counters()
    for m in (clean, resumed):
        np.testing.assert_array_equal(m.coef_, plain.coef_)
        np.testing.assert_array_equal(m.intercept_, plain.intercept_)
        assert m.n_iter_ == plain.n_iter_ and m.objective_ == plain.objective_
    assert snap["fit.retries"] == 1 and snap["checkpoint.restores"] == 1
    assert snap["checkpoint.saves"] == saves  # nothing before iteration 6 ran twice


@pytest.mark.parametrize("solver", list(_GLM_CASES))
def test_glm_segment_boundaries_are_lossless(solver):
    # one segment (a cadence above maxIter) against five: the same bits
    data = _cls_data(np.random.default_rng(16))
    _cadence(100)
    one_seg = LogisticRegression(**_GLM_CASES[solver]).fit(data)
    _cadence(3)
    many_seg = LogisticRegression(**_GLM_CASES[solver]).fit(data)
    assert many_seg.n_iter_ == one_seg.n_iter_
    np.testing.assert_array_equal(many_seg.coef_, one_seg.coef_)
    np.testing.assert_array_equal(many_seg.intercept_, one_seg.intercept_)


@pytest.mark.parametrize("solver", list(_GLM_CASES))
def test_logistic_checkpointed_fit_matches_jax(solver):
    data = _cls_data(np.random.default_rng(17), dtype=np.float64)
    params = dict(_GLM_CASES[solver], tol=1e-10, maxIter=40, float32_inputs=False)
    _cadence(4)
    for chaos in (tchaos, jchaos):
        chaos.set_fault_plan("fail:stage=solve:times=1")
    tm = LogisticRegression(**params).fit(data)
    jm = JaxLogisticRegression(num_workers=1, **params).fit(data)
    assert _counters()["checkpoint.restores"] == _counters("jax")["checkpoint.restores"] == 1
    assert tm.n_iter_ == jm.n_iter_
    scale = np.abs(tm.coef_).max()
    assert np.abs(tm.coef_ - jm.coef_).max() <= 1e-8 * scale
    assert np.abs(tm.intercept_ - jm.intercept_).max() <= 1e-8 * scale


def test_glm_checkpoint_of_another_placement_warm_starts_from_x():
    # the portable resume: a checkpoint taken under another placement key
    # seeds the loop from its iterate (the logits re-derived), counted
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.normal(size=(300, 4)))
    y = torch.from_numpy((rng.normal(size=300) > 0).astype(np.int64))
    w = torch.ones(300, dtype=torch.float64)
    kw = dict(k=2, multinomial=False, lam_l2=1e-3, max_iter=30, tol=1e-12)
    _cadence(5)
    with tckpt.checkpoint_scope() as store:
        done = tlog.logistic_fit(x, y, w, ckpt_key="k", placement_key=("a",), **kw)
        ttele.registry().reset()
        again = tlog.logistic_fit(x, y, w, ckpt_key="k", placement_key=("b",), **kw)
        assert len(store) == 1
    assert _counters()["checkpoint.restores"] == 1
    assert again["n_iter_"] < done["n_iter_"]  # started at the converged iterate
    np.testing.assert_allclose(again["coef_"].numpy(), done["coef_"].numpy(), rtol=1e-6)


@pytest.mark.parametrize("use_l1", [False, True])
def test_no_saves_and_no_extra_host_reads_at_cadence_0(use_l1):
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.normal(size=(200, 4)))
    y = torch.from_numpy((rng.normal(size=200) > 0).astype(np.int64))
    w = torch.ones(200, dtype=torch.float64)
    kw = dict(k=2, multinomial=False, lam_l2=0.01, lam_l1=0.02 if use_l1 else 0.0, use_l1=use_l1,
              max_iter=30, tol=1e-12)
    with tckpt.checkpoint_scope():
        plain = tlog.logistic_fit(x, y, w, **kw)
        ckpted = tlog.logistic_fit(x, y, w, ckpt_key="logistic", placement_key=("p",), **kw)  # cadence 0: no checkpoint
        assert plain["host_reads_"] == ckpted["host_reads_"]
        _cadence(5)
        every5 = tlog.logistic_fit(x, y, w, ckpt_key="logistic", placement_key=("q",), **kw)
    assert _counters()["checkpoint.saves"] == -(-every5["n_iter_"] // 5)
    # each save is one more device-to-host copy, and nothing else changed
    assert every5["host_reads_"] == plain["host_reads_"] + _counters()["checkpoint.saves"]
    torch.testing.assert_close(every5["coef_"], plain["coef_"], rtol=0, atol=0)


# ------------------------------------------------ retained statistics -----


def _lin_data(rng, dtype=np.float64):
    x = _blobs(rng, n=500, d=6, dtype=dtype)
    return {"features": x, "label": (x @ rng.normal(size=6) + 0.1 * rng.normal(size=500)).astype(dtype)}


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_linear_retry_reuses_retained_stats(sparse, fast):
    data = _lin_data(np.random.default_rng(20), dtype=np.float32)
    if sparse:
        data["features"] = sp.csr_matrix(np.where(np.abs(data["features"]) > 0.5, data["features"], 0.0))
    extra = {"solver_precision": "bf16"} if fast else {}
    plain = LinearRegression(**extra).fit(data)
    _cadence(1)
    clean = LinearRegression(**extra).fit(data)
    tchaos.set_fault_plan("fail:stage=solve:times=1")
    ttele.registry().reset()
    keys = []
    real = tckpt.CheckpointStore.get_or_compute
    try:
        tckpt.CheckpointStore.get_or_compute = lambda self, key, *a, **k: keys.append(key) or real(self, key, *a, **k)
        resumed = LinearRegression(**extra).fit(data)
    finally:
        tckpt.CheckpointStore.get_or_compute = real
    snap = _counters()
    for m in (clean, resumed):
        np.testing.assert_array_equal(m.coef_, plain.coef_)
        assert m.intercept_ == plain.intercept_
    assert snap["checkpoint.stats_reuses"] == 1 and snap["checkpoint.saves"] == 1 and snap["fit.retries"] == 1
    assert keys == ["linear_stats" + ("_ell" if sparse else "") + (":bf16" if fast else "")] * 2


@pytest.mark.parametrize("fast", [False, True])
def test_pca_retry_reuses_retained_stats(fast):
    x = _blobs(np.random.default_rng(21))
    extra = {"solver_precision": "bf16"} if fast else {}
    plain = PCA(k=3, **extra).setInputCol("features").fit({"features": x})
    _cadence(1)
    tchaos.set_fault_plan("fail:stage=solve:times=1")
    resumed = PCA(k=3, **extra).setInputCol("features").fit({"features": x})
    np.testing.assert_array_equal(resumed.components_, plain.components_)
    np.testing.assert_array_equal(resumed.explained_variance_, plain.explained_variance_)
    assert _counters()["checkpoint.stats_reuses"] == 1


def test_retained_stats_fits_match_jax():
    data = _lin_data(np.random.default_rng(22))
    _cadence(1)
    for chaos in (tchaos, jchaos):
        chaos.set_fault_plan("fail:stage=solve:times=2")  # a linear fit, then a PCA fit
    tl = LinearRegression(float32_inputs=False).fit(data)
    jl = JaxLinearRegression(num_workers=1, float32_inputs=False).fit(data)
    tp = PCA(k=3, float32_inputs=False).setInputCol("features").fit(data)
    jp = JaxPCA(num_workers=1, k=3, float32_inputs=False).setInputCol("features").fit(data)
    assert _counters()["checkpoint.stats_reuses"] == _counters("jax")["checkpoint.stats_reuses"] == 2
    np.testing.assert_allclose(tl.coef_, jl.coef_, rtol=1e-9)
    np.testing.assert_allclose(tp.explained_variance_, jp.explained_variance_, rtol=1e-9)
    np.testing.assert_allclose(np.abs(tp.components_), np.abs(jp.components_), rtol=1e-9, atol=1e-12)


# ---------------------------------------- streamed retries and resumes ----


def _demote(budget, chunk=128):
    tcore.config.update(hbm_budget_bytes=budget, stream_chunk_rows=chunk)


def test_resident_kmeans_checkpoint_resumes_the_streamed_oom_retry():
    # the OOM ladder runs inside the fit stage: an injected allocation
    # failure at the iteration-4 boundary demotes the fit to the streaming
    # path, whose Lloyd loop resumes the resident checkpoint (the shared key)
    x = _blobs(np.random.default_rng(23), n=1000, d=6)

    def fit():
        return KMeans(k=6, maxIter=7, tol=0.0, seed=2, initMode="random", distance_precision="high").fit(
            {"features": x})

    resident = fit()
    _cadence(2)
    tchaos.set_fault_plan("oom:stage=solve:round=4")
    ttele.registry().reset()
    retried = fit()
    snap = _counters()
    assert snap["memory.oom_caught"] == 1 and snap["fit.demotions"] == 1
    assert snap["checkpoint.restores"] == 1
    assert retried._fit_metrics["admission"]["verdict"] == "stream"
    # the streamed passes: iterations 5-7 and the final inertia
    assert snap["ingest.stream_rows"] == 4 * len(x)
    np.testing.assert_array_equal(retried.cluster_centers_, resident.cluster_centers_)
    assert retried.n_iter_ == resident.n_iter_ and retried.inertia_ == resident.inertia_


def test_streamed_glm_resumes_bit_identical():
    data = _cls_data(np.random.default_rng(24), n=800, d=6, dtype=np.float64)
    params = dict(maxIter=10, tol=1e-30, regParam=1e-4, float32_inputs=False)
    _demote(40_000)
    plain = LogisticRegression(**params).fit(data)
    assert plain._fit_metrics["admission"]["verdict"] == "stream" and plain.n_iter_ == 10
    _cadence(5)
    tchaos.set_fault_plan("fail:stage=solve:round=5")
    ttele.registry().reset()
    resumed = LogisticRegression(**params).fit(data)
    snap = _counters()
    assert snap["fit.retries"] == 1 and snap["checkpoint.restores"] == 1
    np.testing.assert_array_equal(resumed.coef_, plain.coef_)
    np.testing.assert_array_equal(resumed.intercept_, plain.intercept_)
    assert resumed.objective_ == plain.objective_ and resumed.n_iter_ == plain.n_iter_


@pytest.mark.parametrize("est", ["linear", "pca"])
def test_streamed_statistics_are_retained(est):
    data = _lin_data(np.random.default_rng(25))
    _demote(30_000)

    def fit():
        if est == "linear":
            return LinearRegression(float32_inputs=False).fit(data)
        return PCA(k=2, float32_inputs=False).setInputCol("features").fit(data)

    plain = fit()
    _cadence(1)
    tchaos.set_fault_plan("fail:stage=solve:times=1")
    ttele.registry().reset()
    resumed = fit()
    snap = _counters()
    assert resumed._fit_metrics["admission"]["verdict"] == "stream"
    assert snap["checkpoint.stats_reuses"] == 1 and snap["fit.retries"] == 1
    # one streamed pass (PCA: two) and no second
    assert snap["ingest.stream_rows"] == (1 if est == "linear" else 2) * 500
    attr = "coef_" if est == "linear" else "components_"
    np.testing.assert_array_equal(getattr(resumed, attr), getattr(plain, attr))


# ---------------------------------------------------------- warm starts ---


@pytest.mark.parametrize("ckpt_package", ["jax", "torch"])
def test_kmeans_warm_start_from_solver_checkpoint(ckpt_package):
    # tests/test_warm_start.py's case: a checkpoint's centers seed the fit
    x = _blobs(np.random.default_rng(26))
    donor = KMeans(k=6, maxIter=25, tol=1e-7, seed=3).fit({"features": x})
    snap = (jckpt if ckpt_package == "jax" else tckpt).SolverCheckpoint(
        solver="kmeans", iteration=int(donor.n_iter_), state={"centers": np.asarray(donor.cluster_centers_)})
    ttele.registry().reset()
    warm = KMeans(k=6, maxIter=25, tol=1e-7, seed=3).fit({"features": x}, warm_start_from=snap)
    assert warm.n_iter_ < donor.n_iter_
    assert _counters()["fit.warm_start_iterations_saved"] == donor.n_iter_
    from_model = KMeans(k=6, maxIter=25, tol=1e-7, seed=3).fit({"features": x}, warm_start_from=donor)
    np.testing.assert_array_equal(warm.cluster_centers_, from_model.cluster_centers_)
    with pytest.raises(ValueError, match="needs a 'centers' payload"):
        KMeans(k=6).fit({"features": x}, warm_start_from=tckpt.SolverCheckpoint(solver="glm_qn", iteration=1,
                                                                                   state={}))


# ------------------------------------------------------------- numcheck ---


@pytest.fixture()
def numerics(monkeypatch):
    monkeypatch.setenv("SRML_NUMCHECK", "1")
    state = tnumcheck.snapshot()
    tnumcheck.reset()
    yield tnumcheck
    tnumcheck.restore(state)


def test_numcheck_catches_a_nan_at_the_kmeans_checkpoint(numerics):
    x = torch.from_numpy(_blobs(np.random.default_rng(27)))
    w = torch.ones(len(x))
    calls = []

    def step(c, fast):
        calls.append(1)
        new, inertia, shift = tkm._lloyd_step(x, w, c, 32768, fast)
        if len(calls) == 2:
            new = new.clone()
            new[1, 2] = float("nan")  # planted in the iterate the checkpoint fetches
        return new, inertia, shift

    _cadence(2)
    with tckpt.checkpoint_scope() as store:
        with pytest.raises(terrors.NumericsError, match="kmeans.checkpoint"):
            tkm.lloyd_loop(step, x[:4].clone(), max_iter=6, tol=0.0, fast=False)
        assert len(store) == 0  # a poisoned state is never saved
    (trip,) = numerics.trips()
    assert (trip["stage"], trip["iteration"], trip["value"], trip["nan"]) == ("kmeans.checkpoint", 2, "centers", 1)


def test_numcheck_catches_a_nan_at_the_glm_segment(numerics, monkeypatch):
    rng = np.random.default_rng(28)
    x = torch.from_numpy(rng.normal(size=(200, 4)))
    y = torch.from_numpy((rng.normal(size=200) > 0).astype(np.int64))
    real = towlqn.LbfgsMemory.push

    def push(self, s, yv, sy):
        real(self, s, yv, sy)
        self.Y[0, 0] = float("nan")  # the history the segment boundary fetches

    monkeypatch.setattr(towlqn.LbfgsMemory, "push", push)
    _cadence(1)
    with tckpt.checkpoint_scope():
        with pytest.raises(terrors.NumericsError, match="segment.glm_qn"):
            tlog.logistic_fit(x, y, torch.ones(200, dtype=torch.float64), k=2, multinomial=False,
                              lam_l2=1e-3, max_iter=10, tol=1e-12, ckpt_key="logistic")
    (trip,) = numerics.trips()
    assert (trip["stage"], trip["solver"], trip["iteration"], trip["value"]) == ("segment.glm_qn", "glm_qn", 1, "Y")
