#
# The PyTorch port's multi-tenant fit scheduler (spark_rapids_ml_tpu_torch/
# scheduler/: the 1-D HbmLedger, the job context and preemption point,
# FitScheduler/FitJob; memory.admit_fit's job branch; the solvers'
# preemption points) on the CPU, case for case with the one-dimensional
# tests of tests/test_scheduler.py, against the JAX package's scheduler on
# the same seeded numpy inputs. (Its six tests of the 2-D chip book have
# their counterparts in tests/test_torch_scheduler_2d.py.)
#
# Every scenario is ordered by events, never by sleeps: a job's fit can be
# held at its start (`_gated`) or right after its first checkpoint save
# (`_pause_after_first_save`), and every wait has a timeout. Each package
# gets a fresh ledger per test, so no claim of another test can move a
# budget or a watermark.
#
# Tolerances, and why:
#   * the port against itself: bit for bit. A preempted and resumed fit
#     equals the uninterrupted unchecked fit exactly (a checkpoint
#     round-trips the loop's whole state; tests/test_torch_recovery.py);
#     a scheduled fit equals the same fit run alone;
#   * the port against JAX, float64, at the existing parity bounds: KMeans
#     rtol 1e-9 with n_iter_ equal (tests/test_torch_kmeans.py,
#     test_torch_recovery.py), LogisticRegression n_iter_ equal and
#     coefficients within 1e-8 of the largest (test_torch_recovery.py's
#     checkpointed fits), the ELL GLM rtol 1e-9 (test_torch_sparse_fit.py),
#     the streamed GLM rtol 1e-7 (test_torch_oocore.py);
#   * scheduler observables exactly: PreemptedError's job_id, solver and
#     iteration, job states, scheduler.* counters, the audit records' (kind,
#     subsystem, verdict, tenant), the typed refusal's bytes and terms (the
#     port's own workspace terms named one by one), the ledger's bytes,
#     watermark, utilization and per-tenant usage under one clock.
#
import threading

import numpy as np
import pytest
import scipy.sparse as sp

from spark_rapids_ml_tpu import checkpoint as jckpt
from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu import errors as jerrors
from spark_rapids_ml_tpu import memory as jmemory
from spark_rapids_ml_tpu import telemetry as jtele
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.models.classification import RandomForestClassifier as JaxRandomForestClassifier
from spark_rapids_ml_tpu.models.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.ops_plane import audit as jaudit
from spark_rapids_ml_tpu.parallel import chaos as jchaos
from spark_rapids_ml_tpu.scheduler import context as jcontext
from spark_rapids_ml_tpu.scheduler import ledger as jledger
from spark_rapids_ml_tpu.scheduler import queue as jqueue
from spark_rapids_ml_tpu_torch import (
    KMeans,
    LogisticRegression,
    RandomForestClassifier,
    checkpoint as tckpt,
    core as tcore,
    errors as terrors,
    memory as tmemory,
    parallel,
    telemetry as ttele,
)
from spark_rapids_ml_tpu_torch.ops import _kernels
from spark_rapids_ml_tpu_torch.ops_plane import audit as taudit
from spark_rapids_ml_tpu_torch.parallel import chaos as tchaos
from spark_rapids_ml_tpu_torch.scheduler import context as tcontext
from spark_rapids_ml_tpu_torch.scheduler import ledger as tledger
from spark_rapids_ml_tpu_torch.scheduler import queue as tqueue

TIMEOUT = 60.0

SIDES = {
    "torch": dict(KMeans=KMeans, LogisticRegression=LogisticRegression, RF=RandomForestClassifier,
                  ckpt=tckpt, core=tcore, errors=terrors, memory=tmemory, tele=ttele, chaos=tchaos,
                  audit=taudit, ctx=tcontext, ledger=tledger, queue=tqueue),
    "jax": dict(KMeans=JaxKMeans, LogisticRegression=JaxLogisticRegression, RF=JaxRandomForestClassifier,
                ckpt=jckpt, core=jcore, errors=jerrors, memory=jmemory, tele=jtele, chaos=jchaos,
                audit=jaudit, ctx=jcontext, ledger=jledger, queue=jqueue),
}

# the JAX package's keys of the 2-D chip book: a job's chip set in
# `job.stats()`, and the occupied chips and the placement switch in
# `FitScheduler.stats()` (the port has them too)
_A10_JOB_KEYS = {"chip_ids"}
_A10_STATS_KEYS = {"ledger_occupied_chips", "chip_placement"}

_KEYS = ("hbm_budget_bytes", "checkpoint_every_iters", "sched_max_preemptions", "sched_max_concurrent",
         "fit_max_retries", "fit_retry_backoff_s", "stream_chunk_rows")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """The port on the CPU; both packages with a fresh ledger, no fault
    plan, a 10 ms retry backoff, telemetry on with fresh registries, an
    empty decision log; their config restored. Every test leaves the
    port's ledger at 0 bytes."""
    parallel.set_devices("cpu")
    monkeypatch.setattr(tledger, "_GLOBAL", tledger.HbmLedger())
    monkeypatch.setattr(jledger, "_GLOBAL", jledger.HbmLedger())
    saved = {name: {k: S["core"].config[k] for k in _KEYS} for name, S in SIDES.items()}
    for S in SIDES.values():
        S["chaos"].clear_fault_plan()
        S["core"].config["fit_retry_backoff_s"] = 0.01
        S["tele"].enable()
        S["tele"].registry().reset()
        S["audit"].clear()
    yield
    for name, S in SIDES.items():
        S["chaos"].clear_fault_plan()
        S["tele"].disable()
        S["tele"].registry().reset()
        S["core"].config.update(saved[name])
    port_held = tledger.global_ledger().reserved_bytes()
    parallel.set_devices(None)
    assert port_held == 0, f"{port_held} bytes left in the port's ledger"


# ------------------------------------------------------------- helpers ------


def _counters(side):
    return SIDES[side]["tele"].registry().snapshot()["counters"]


def _est(side, name, **params):
    est = SIDES[side][name](**params)
    if side == "jax":
        est.num_workers = 1  # both packages place on one device
    return est


def _kmeans(side, **kw):
    return _est(side, "KMeans", **{"k": 4, "maxIter": 6, "seed": 3, **kw})


def _need(side, est, data):
    ex = est._pre_process_data(data, for_fit=True, defer_validation=True)
    return SIDES[side]["memory"].resident_estimate(est, ex, 1).total()


def _set_budget(side, raw_bytes):
    """hbm_budget_bytes such that the post-headroom budget is `raw_bytes`."""
    SIDES[side]["core"].config["hbm_budget_bytes"] = int(raw_bytes / 0.9) + 16


def _both(**cfg):
    for S in SIDES.values():
        S["core"].config.update(cfg)


def _gated(est, gate):
    """`est` whose fit waits for `gate` before it starts: the job is admitted
    and running, but has done nothing yet."""
    real = est.fit

    def fit(dataset, *a, **kw):
        assert gate.wait(TIMEOUT), "gate never opened"
        return real(dataset, *a, **kw)

    est.fit = fit
    return est


def _pause_after_first_save(job):
    """Hold `job`'s fit right after its first checkpoint landed, before the
    boundary's preemption point: returns (saved, go) events."""
    saved, go = threading.Event(), threading.Event()
    real = job.store.save

    def save(key, ckpt):
        real(key, ckpt)
        if not saved.is_set():
            saved.set()
            assert go.wait(TIMEOUT), "never let go"

    job.store.save = save
    return saved, go


def _trail(side, tenant=None):
    return [(d["kind"], d["subsystem"], d["verdict"], d["tenant"])
            for d in SIDES[side]["audit"].decisions(tenant=tenant)]


def _rows(seed, n=600, d=5, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(dtype)


def _cls_data(seed, n=800, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    # noisy labels keep the minimizer finite and the fit well conditioned
    y = ((x @ rng.normal(size=d) + rng.normal(size=n)) > 0).astype(np.float64)
    return {"features": x, "label": y}


def _csr_data(seed, n=500, d=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * np.linspace(0.5, 3.0, d)
    x = sp.csr_matrix(np.where(np.abs(x) > 1.0, x + 0.3, 0.0))
    y = ((np.asarray(x @ rng.normal(size=d)).ravel() + rng.normal(size=n)) > 0).astype(np.float64)
    return {"features": x, "label": y}


def _same(a, b, attrs):
    for name in attrs:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)))


# ---------------------------------------------------------------- ledger ----


def _ledger_script(mod):
    """tests/test_scheduler.py's three ledger tests as one sequence: every
    observable value, in order."""
    out = []
    led = mod.HbmLedger()
    a = led.reserve("a", "fit", 100)
    b = led.reserve("b", "serve", 50)
    out += [led.reserved_bytes(), led.reserved_bytes(kind="serve"), led.reserved_bytes(exclude=a),
            led.high_watermark]
    led.release(a)
    led.release(a)  # idempotent: never a double credit
    led.release(None)  # None-safe for finally blocks
    out.append(led.reserved_bytes())
    led.release(b)
    out += [led.reserved_bytes(), led.high_watermark]  # the watermark survives the drain
    led = mod.HbmLedger()
    r1 = led.try_reserve("a", "job", 60, budget=100)
    out += [r1 is not None, led.try_reserve("b", "job", 50, budget=100) is None]
    r3 = led.try_reserve("c", "job", 40, budget=100)  # an exact fit admits
    out += [r3 is not None, led.reserved_bytes()]
    led.release(r3)
    out.append(led.try_reserve("d", "job", 90, budget=100, exclude=r1) is not None)
    out.append(led.try_reserve("e", "job", 10 ** 12, budget=None) is not None)  # no budget: bookkeeping
    led = mod.HbmLedger()
    out.append(led.utilization())  # no budget seen yet
    r = led.reserve("job:1", "job", 100)
    led.resize(r, 400)
    out += [led.reserved_bytes(), led.high_watermark]
    led.note_admission(800)
    out.append(led.utilization())
    seen = []
    led.admission_hooks.append(lambda reserved, budget: seen.append((reserved, budget)))
    led.note_admission(800)
    led.note_admission(None)  # a decision without capacity information
    out += [seen, led.last_budget, [(x.owner, x.nbytes) for x in led.reservations()]]
    return out


def test_ledger_reserve_try_reserve_resize_and_hooks_equal_jax():
    port, jax_ = _ledger_script(tledger), _ledger_script(jledger)
    assert port == jax_
    assert port == [150, 50, 50, 150, 50, 0, 150, True, True, True, 100, True, True, None, 400, 400, 0.5,
                    [(400, 800), (400, None)], 800, [("job:1", 400)]]


def _usage_script(mod, monkeypatch):
    """Claims of three tenants on one scripted clock: tenant_usage() at
    three points."""
    clock = iter(float(t) for t in range(100))
    monkeypatch.setattr(mod, "_now", lambda: next(clock))
    led = mod.HbmLedger()
    a = led.reserve("a", "job", 100, tenant="acme")
    b = led.reserve("b", "serve", 40, tenant="serving:km", chips=2)
    snaps = [led.tenant_usage()]
    led.resize(a, 300)
    c = led.reserve("c", "fit", 10)  # no job around: "default"
    snaps.append(led.tenant_usage())
    for r in (a, b, c):
        led.release(r)
    snaps.append(led.tenant_usage())
    return snaps


def test_ledger_tenant_usage_equals_jax_on_one_clock(monkeypatch):
    import sys

    # the JAX ledger adds the efficiency plane's per-tenant `device_time`
    # split (ROADMAP A15) once that module is loaded and has timed scopes,
    # which an earlier test of the process may have done: compare without it
    monkeypatch.delitem(sys.modules, "spark_rapids_ml_tpu.ops_plane.efficiency", raising=False)
    port = _usage_script(tledger, monkeypatch)
    jax_ = _usage_script(jledger, monkeypatch)
    assert port == jax_
    last = port[-1]
    assert set(last) == {"acme", "serving:km", "default", "_pool"}
    assert last["acme"]["byte_seconds"] > 0 and last["acme"]["reservations"] == 1.0
    assert last["_pool"]["chips_busy"] == 0.0 and port[0]["_pool"]["chips_busy"] == 2.0


def test_claims_carry_the_enclosing_job_tenant():
    for S in SIDES.values():
        led = S["ledger"].HbmLedger()
        job = S["queue"].FitJob(7, None, None, "acme", 0)
        with S["ctx"].job_scope(job):
            assert S["ctx"].current_job() is job
            r = led.reserve("fit:x", "fit", 10)
            rec = S["audit"].record_decision("admission", "fit", "resident", subject="X")
        assert S["ctx"].current_job() is None
        assert r.tenant == "acme" and rec["tenant"] == "acme"
        assert led.reserve("fit:y", "fit", 10).tenant == "default"


# ------------------------------------------------------------ basic queue ---


def test_single_job_completes_and_drains_ledger():
    x = _rows(1, dtype=np.float32)
    out = {}
    for side, S in SIDES.items():
        sched = S["queue"].FitScheduler()
        try:
            job = sched.submit(_kmeans(side), {"features": x}, tenant="a", priority=1)
            model = job.result(timeout=TIMEOUT)
        finally:
            sched.shutdown()
        assert job.state == "completed" and job.done()
        st = model._fit_metrics["scheduler"]  # per-tenant telemetry rides the result
        assert st["tenant"] == "a" and st["priority"] == 1
        assert st["preemptions"] == 0 and st["queue_wait_s"] >= 0.0
        snap = _counters(side)
        out[side] = (sorted(set(st) - _A10_JOB_KEYS), [snap.get(f"scheduler.jobs_{k}") for k in ("submitted", "admitted", "completed")],
                     _trail(side), model)
        assert S["ledger"].global_ledger().reserved_bytes() == 0
    assert out["torch"][:3] == out["jax"][:3]
    assert "chip_ids" in out["jax"][3]._fit_metrics["scheduler"]
    assert _A10_JOB_KEYS <= set(out["torch"][3]._fit_metrics["scheduler"])
    assert out["torch"][3]._fit_metrics["scheduler"]["chip_ids"] == out["jax"][3]._fit_metrics["scheduler"]["chip_ids"]
    assert out["torch"][1] == [1, 1, 1]
    assert out["torch"][2] == [("admission", "scheduler", "admitted", "a"), ("admission", "fit", "resident", "a")]
    # scheduled = run alone, bit for bit
    _same(out["torch"][3], _kmeans("torch").fit({"features": x}), ("cluster_centers_", "n_iter_"))


def _co_admission(side, x):
    S, data = SIDES[side], {"features": x}
    need = _need(side, _kmeans(side), data)
    _set_budget(side, int(2.2 * need))  # two jobs co-admit, the third queues
    violations = []
    S["ledger"].global_ledger().admission_hooks.append(
        lambda reserved, budget: violations.append(reserved) if budget is not None and reserved > budget else None)
    gate = threading.Event()
    sched = S["queue"].FitScheduler()
    try:
        jobs = [sched.submit(_gated(_kmeans(side, maxIter=12, tol=0.0), gate), data, tenant=f"t{i}")
                for i in range(3)]
        states = [j.state for j in jobs]
        gate.set()
        models = [j.result(timeout=TIMEOUT) for j in jobs]
    finally:
        gate.set()
        sched.shutdown()
    snap = _counters(side)
    led = S["ledger"].global_ledger()
    return dict(states=states, counts=[snap.get(f"scheduler.jobs_{k}") for k in ("admitted", "completed", "queued")],
                violations=violations, watermark=led.high_watermark / need, held=led.reserved_bytes(),
                models=models)


def test_co_admission_bin_packs_within_budget():
    x = _rows(2)
    port, jax_ = _co_admission("torch", x), _co_admission("jax", x)
    for r in (port, jax_):
        assert r["states"] == ["running", "running", "queued"]  # the third deferred
        assert r["counts"] == [3, 3, 1]
        assert r["violations"] == []  # never over budget, at ANY admission
        assert r["watermark"] == 2.0 and r["held"] == 0  # two claims at once, trued up to the estimate
    alone = _kmeans("torch", maxIter=12, tol=0.0).fit({"features": x})
    for tm, jm in zip(port["models"], jax_["models"]):
        _same(tm, alone, ("cluster_centers_", "n_iter_"))
        assert tm.n_iter_ == jm.n_iter_
        np.testing.assert_allclose(tm.cluster_centers_, jm.cluster_centers_, rtol=1e-9)


def _concurrency_cap(side, x):
    S = SIDES[side]
    S["core"].config["sched_max_concurrent"] = 1
    gate, seen = threading.Event(), []
    sched = S["queue"].FitScheduler()

    def observed(est):
        real = est.fit

        def fit(dataset, *a, **kw):
            with sched._lock:
                seen.append(len(sched._running))  # jobs running while this one starts
            return real(dataset, *a, **kw)

        est.fit = fit
        return est

    try:
        jobs = [sched.submit(_gated(observed(_kmeans(side)), gate), {"features": x}, tenant=f"t{i}")
                for i in range(3)]
        states = [j.state for j in jobs]
        gate.set()
        for j in jobs:
            j.result(timeout=TIMEOUT)
    finally:
        gate.set()
        sched.shutdown()
    return states, seen


def test_respects_max_concurrent_cap():
    x = _rows(3)
    port, jax_ = _concurrency_cap("torch", x), _concurrency_cap("jax", x)
    assert port == jax_ == (["running", "queued", "queued"], [1, 1, 1])


def _shutdown(side, x):
    S, data = SIDES[side], {"features": x}
    _set_budget(side, int(1.2 * _need(side, _kmeans(side), data)))  # one at a time: later submissions queue
    gate = threading.Event()
    sched = S["queue"].FitScheduler()
    jobs = [sched.submit(_gated(_kmeans(side, maxIter=30, tol=0.0), gate), data, tenant=f"t{i}") for i in range(4)]
    sched.shutdown(wait=False)  # the queued jobs fail at once, typed
    failed = [j.state for j in jobs]
    messages = []
    for j in jobs[1:]:
        with pytest.raises(RuntimeError, match="shut down") as ei:
            j.result(timeout=1)
        messages.append(str(ei.value))
    gate.set()
    jobs[0].result(timeout=TIMEOUT)  # the running job finishes
    sched.shutdown(wait=True, timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="shut down"):
        sched.submit(_kmeans(side), data)
    assert S["ledger"].global_ledger().reserved_bytes() == 0
    return failed, [j.state for j in jobs], messages


def test_shutdown_fails_queued_jobs():
    x = _rows(4)
    port, jax_ = _shutdown("torch", x), _shutdown("jax", x)
    assert port == jax_
    assert port[0] == ["running", "failed", "failed", "failed"]
    assert port[1] == ["completed", "failed", "failed", "failed"]


def test_package_level_fitscheduler_is_the_real_class():
    import spark_rapids_ml_tpu_torch as pkg
    from spark_rapids_ml_tpu_torch.scheduler import FitScheduler as real

    assert pkg.FitScheduler is real
    assert (pkg.PreemptedError, pkg.SchedulerSaturatedError) == (terrors.PreemptedError, terrors.SchedulerSaturatedError)
    with pkg.FitScheduler() as sched:
        assert isinstance(sched, pkg.FitScheduler)


def test_scheduler_config_defaults_are_the_jax_packages():
    for key in ("sched_max_preemptions", "sched_max_concurrent", "sched_chip_placement"):
        assert tcore.config[key] == jcore.config[key]


def _worker_pool(x, n_jobs=5):
    """`n_jobs` jobs through a scheduler of two workers; the thread each fit
    ran on, the workers, and whether they are alive before and after the
    shutdown."""
    tcore.config["sched_max_concurrent"] = 2
    ran_on, handles = [], []
    real = tqueue._take_library_handles

    def take():
        handles.append(threading.current_thread())
        real()

    tqueue._take_library_handles = take
    try:
        sched = tqueue.FitScheduler()
    finally:
        tqueue._take_library_handles = real
    taken_at_build = list(handles)

    def recorded(est):
        real_fit = est.fit

        def fit(dataset, *a, **kw):
            ran_on.append(threading.current_thread())
            return real_fit(dataset, *a, **kw)

        est.fit = fit
        return est

    try:
        jobs = [sched.submit(recorded(_kmeans("torch")), {"features": x}, tenant=f"t{i}") for i in range(n_jobs)]
        models = [j.result(timeout=TIMEOUT) for j in jobs]
        alive = [t.is_alive() for t in sched._workers]
    finally:
        sched.shutdown(wait=True, timeout=TIMEOUT)
    return dict(workers=list(sched._workers), taken_at_build=taken_at_build, ran_on=ran_on, models=models,
                alive=alive, alive_after=[t.is_alive() for t in sched._workers])


def test_workers_are_started_once_and_run_every_job():
    x = _rows(56, dtype=np.float32)
    r = _worker_pool(x)
    # two workers, each of which took its card handles before the
    # constructor returned, ran all five jobs, and stopped at the shutdown
    assert len(r["workers"]) == 2 and r["taken_at_build"] == r["workers"]
    assert len(r["ran_on"]) == 5 and set(r["ran_on"]) <= set(r["workers"])
    assert r["alive"] == [True, True] and r["alive_after"] == [False, False]
    alone = _kmeans("torch").fit({"features": x})
    for m in r["models"]:
        _same(m, alone, ("cluster_centers_", "n_iter_"))


def test_release_of_a_replaced_ledgers_claim_keeps_the_live_claims():
    old = tledger.global_ledger()
    stale = old.reserve("fit:old", "fit", 70)
    new = tledger.reset_global_ledger()
    live = new.reserve("fit:new", "fit", 30)
    assert (stale.rid, new is not old) == (live.rid, True)  # ids restart with the new book
    new.release(stale)  # released through whichever ledger is global now
    assert not stale.active and [(r.owner, r.nbytes) for r in new.reservations()] == [("fit:new", 30)]
    assert new.reserved_bytes() == 30
    new.release(live)
    assert new.reserved_bytes() == 0


# ------------------------------------------------- preemption bit-identity --
# Deterministic preemption, as JAX's `_preempt_then_resume`: the job's flag
# is armed BEFORE the fit, so the solver yields at its FIRST checkpoint
# boundary; the resume re-enters with the same job-owned store.


def _preempt_then_resume(side, make, data):
    S = SIDES[side]
    job = S["queue"].FitJob(99, make(), data, "t", 0)
    job.request_preempt("test preemption")
    with S["ctx"].job_scope(job), S["ckpt"].checkpoint_scope(store=job.store):
        with pytest.raises(S["errors"].PreemptedError) as ei:
            job.estimator.fit(data)
    assert len(job.store) >= 1  # the boundary checkpoint survived the unwind
    job._preempt.clear()
    with S["ctx"].job_scope(job), S["ckpt"].checkpoint_scope(store=job.store):
        resumed = make().fit(data)
    return ei.value, resumed


_KM = dict(maxIter=10, tol=0.0, seed=7, float32_inputs=False)
_LR = dict(maxIter=40, tol=1e-10, float32_inputs=False)
# case -> (estimator, params, data, cadence, streaming budget, the solver
# name at the boundary, attributes held, the JAX tolerance)
_PREEMPT_CASES = {
    "kmeans": ("KMeans", dict(_KM, k=8), lambda: {"features": _rows(31)}, 3, None, "kmeans",
               ("cluster_centers_", "inertia_", "n_iter_"), 1e-9),
    "kmeans_stream": ("KMeans", dict(_KM, k=4, maxIter=12), lambda: {"features": _rows(32, n=2000, d=6)}, 3,
                      140_000, "kmeans_stream", ("cluster_centers_", "inertia_", "n_iter_"), 1e-9),
    "glm": ("LogisticRegression", dict(_LR, regParam=1e-3), lambda: _cls_data(33), 4, None, "glm_qn",
            ("coef_", "intercept_", "n_iter_", "objective_"), 1e-8),
    "owlqn": ("LogisticRegression", dict(_LR, regParam=0.005, elasticNetParam=0.5), lambda: _cls_data(34), 4,
              None, "owlqn", ("coef_", "intercept_", "n_iter_", "objective_"), 1e-8),
    "ell_glm": ("LogisticRegression", dict(_LR, regParam=0.01, maxIter=60), lambda: _csr_data(35), 4, None,
                "glm_qn", ("coef_", "intercept_", "n_iter_", "objective_"), 1e-9),
    "stream_glm": ("LogisticRegression", dict(_LR, regParam=0.01, maxIter=12, tol=1e-30),
                   lambda: _cls_data(36, n=2000), 3, 100_000, "glm_qn_stream",
                   ("coef_", "intercept_", "n_iter_", "objective_"), 1e-7),
}


@pytest.mark.parametrize("case", list(_PREEMPT_CASES))
def test_preempted_fit_resumes_bit_identical(case):
    name, params, make_data, every, budget, solver, attrs, rtol = _PREEMPT_CASES[case]
    data = make_data()
    if budget is not None:
        _both(hbm_budget_bytes=budget, stream_chunk_rows=512)  # demotes both packages' fits
    plain = _est("torch", name, **params).fit(data)  # uninterrupted, unchecked
    _both(checkpoint_every_iters=every)
    ttele.registry().reset()
    err, resumed = _preempt_then_resume("torch", lambda: _est("torch", name, **params), data)
    assert _counters("torch")["checkpoint.restores"] >= 1  # resumed, not restarted
    _same(resumed, plain, attrs)
    jerr, jresumed = _preempt_then_resume("jax", lambda: _est("jax", name, **params), data)
    fields = (err.job_id, err.solver, err.iteration, err.reason)
    assert fields == (jerr.job_id, jerr.solver, jerr.iteration, jerr.reason) == (99, solver, every, "test preemption")
    assert str(err) == str(jerr)
    verdict = "stream" if budget is not None else "resident"
    for m in (resumed, jresumed):
        assert m._fit_metrics["admission"]["verdict"] == verdict
    assert resumed.n_iter_ == jresumed.n_iter_
    if name == "KMeans":
        np.testing.assert_allclose(resumed.cluster_centers_, jresumed.cluster_centers_, rtol=rtol)
    else:
        scale = np.abs(np.asarray(jresumed.coef_)).max()
        for a in ("coef_", "intercept_"):
            assert np.abs(np.asarray(getattr(resumed, a)) - np.asarray(getattr(jresumed, a))).max() <= rtol * scale


def test_preempted_error_is_not_transient_and_never_retried():
    for S in SIDES.values():
        e = S["errors"].PreemptedError(3, solver="kmeans", iteration=2, reason="r")
        assert not S["errors"].is_transient(e)
        calls = []

        def fn(attempt):
            calls.append(attempt)
            raise e

        with pytest.raises(S["errors"].PreemptedError):
            S["core"].retryable_stage(fn, stage="fit")
        assert calls == [0]  # propagated unretried
    assert str(terrors.PreemptedError(3, solver="kmeans", iteration=2, reason="r")) == \
        str(jerrors.PreemptedError(3, solver="kmeans", iteration=2, reason="r"))


def test_preemption_point_outside_a_job_is_a_no_op():
    tcontext.preemption_point("kmeans", 1)
    job = tqueue.FitJob(5, None, None, "t", 0)
    with tcontext.job_scope(job):
        tcontext.preemption_point("kmeans", 1)  # not flagged
        job.request_preempt("why")
        with pytest.raises(terrors.PreemptedError, match="job 5 preempted at kmeans iteration 2: why"):
            tcontext.preemption_point("kmeans", 2)


# ------------------------------------------------------ 3-tenant scenario ---


def _three_tenants(side):
    """THE acceptance scenario: a low-priority big fit running; a
    high-priority small fit preempts it at its first checkpoint boundary; a
    third tenant queues in between; all complete."""
    S = SIDES[side]
    rng = np.random.default_rng(41)
    big, small = {"features": rng.normal(size=(4000, 8))}, {"features": rng.normal(size=(300, 8))}

    def mk_big():
        return _kmeans(side, k=16, maxIter=12, tol=0.0, seed=7, float32_inputs=False)

    def mk_small():
        return _kmeans(side, k=4, maxIter=5, seed=3, float32_inputs=False)

    need_b, need_s = _need(side, mk_big(), big), _need(side, mk_small(), small)
    # the big fit fits ALONE; big + small does not: the small job can only
    # run by preempting, and two small jobs fit together
    _set_budget(side, int(need_b + 0.5 * need_s))
    S["core"].config["checkpoint_every_iters"] = 2
    violations, budgets = [], []
    S["ledger"].global_ledger().admission_hooks.append(lambda reserved, budget: (
        budgets.append(budget), violations.append(reserved) if budget is not None and reserved > budget else None))
    S["tele"].registry().reset()
    gate = threading.Event()
    sched = S["queue"].FitScheduler()
    try:
        job_big = sched.submit(_gated(mk_big(), gate), big, tenant="batch", priority=0)
        saved, go = _pause_after_first_save(job_big)
        gate.set()
        assert saved.wait(TIMEOUT)  # the big fit is mid-solve, at its first boundary
        job_hi = sched.submit(mk_small(), small, tenant="interactive", priority=10)
        job_mid = sched.submit(mk_small(), small, tenant="reporting", priority=5)
        states = (job_big.preempt_requested(), job_hi.state, job_mid.state)
        go.set()
        models = {t: j.result(timeout=TIMEOUT) for t, j in
                  (("interactive", job_hi), ("reporting", job_mid), ("batch", job_big))}
    finally:
        gate.set()
        sched.shutdown()
    snap = _counters(side)
    return dict(
        states=states, models=models, big=job_big, violations=violations, n_budgets=len(budgets),
        counts=[snap.get(k) for k in ("scheduler.jobs_preempted", "scheduler.jobs_resumed",
                                      "checkpoint.restores", "scheduler.jobs_completed")],
        trails={t: _trail(side, t) for t in models}, held=S["ledger"].global_ledger().reserved_bytes(),
        ref=mk_big, data=big)


def test_three_tenants_preempt_resume_acceptance():
    port, jax_ = _three_tenants("torch"), _three_tenants("jax")
    for r in (port, jax_):
        assert r["states"] == (True, "queued", "queued")  # requested; the burst waits for the boundary
        assert r["counts"] == [1, 1, 1, 3]
        assert r["big"].preemptions == 1 and r["big"].state == "completed"
        assert r["violations"] == [] and r["n_budgets"] >= 3  # within budget at EVERY admission
        assert r["held"] == 0
        for tenant, model in r["models"].items():
            st = model._fit_metrics["scheduler"]
            assert st["tenant"] == tenant and st["queue_wait_s"] >= 0.0 and "hbm_share" in st
        assert r["models"]["batch"]._fit_metrics["scheduler"]["preemptions"] == 1
        assert r["models"]["batch"]._fit_metrics["scheduler"]["resumes"] == 1
    assert port["trails"] == jax_["trails"]
    assert port["trails"]["batch"] == [
        ("admission", "scheduler", "admitted", "batch"), ("admission", "fit", "resident", "batch"),
        ("preemption", "scheduler", "requested", "batch"), ("preemption", "scheduler", "preempted", "batch"),
        ("admission", "scheduler", "resumed", "batch"), ("admission", "fit", "resident", "batch")]
    # the preempted fit equals an uninterrupted, unchecked fit: zero lost work
    tcore.config["checkpoint_every_iters"] = 0
    plain = port["ref"]().fit(port["data"])
    _same(port["models"]["batch"], plain, ("cluster_centers_", "inertia_", "n_iter_"))
    jm = jax_["models"]["batch"]
    assert jm.n_iter_ == plain.n_iter_
    np.testing.assert_allclose(port["models"]["batch"].cluster_centers_, jm.cluster_centers_, rtol=1e-9)


# ------------------------------------------------------------- demotion -----


def _demotion(side, data):
    """sched_max_preemptions=1: the FIRST preemption demotes the job, whose
    re-admission streams. The preemption is requested on the job handle
    once the fit saved its first checkpoint."""
    S = SIDES[side]
    S["core"].config.update(checkpoint_every_iters=2, sched_max_preemptions=1, stream_chunk_rows=512)

    def mk():
        return _est(side, "LogisticRegression", maxIter=12, tol=0.0, regParam=1e-4, float32_inputs=False)

    _set_budget(side, int(1.5 * _need(side, mk(), data)))
    gate = threading.Event()
    sched = S["queue"].FitScheduler()
    try:
        job = sched.submit(_gated(mk(), gate), data, tenant="batch", priority=0)
        saved, go = _pause_after_first_save(job)
        gate.set()
        assert saved.wait(TIMEOUT)
        job.request_preempt("higher-priority tenant needs the reservation")
        go.set()
        model = job.result(timeout=TIMEOUT)
    finally:
        gate.set()
        sched.shutdown()
    snap = _counters(side)
    return dict(model=model, job=job, trail=_trail(side, "batch"),
                counts=[snap.get(k) for k in ("scheduler.jobs_preempted", "scheduler.jobs_demoted",
                                              "scheduler.jobs_resumed")],
                held=S["ledger"].global_ledger().reserved_bytes(), mk=mk)


def test_preempted_too_often_job_demotes_to_streaming():
    data = _cls_data(42, n=2000)
    port, jax_ = _demotion("torch", data), _demotion("jax", data)
    for r in (port, jax_):
        assert r["counts"] == [1, 1, 1]
        assert r["job"].demoted and r["job"].state == "completed" and r["held"] == 0
        assert r["model"]._fit_metrics["scheduler"]["demoted"] is True
        adm = r["model"]._fit_metrics["admission"]  # the re-admission really streamed
        assert adm["verdict"] == "stream" and adm["chunk_rows"] == 512
        assert "sched_max_preemptions" in adm["reason"]
    assert port["trail"] == jax_["trail"]
    assert ("demotion", "scheduler", "stream", "batch") in port["trail"]
    assert port["trail"][-1] == ("demotion", "fit", "stream", "batch")
    assert port["model"]._fit_metrics["admission"]["reason"] == jax_["model"]._fit_metrics["admission"]["reason"]
    # the demoted job's model is the streamed fit of its data at its chunks
    tcore.config.update(checkpoint_every_iters=0, hbm_budget_bytes=100_000)
    streamed = port["mk"]().fit(data)
    assert streamed._fit_metrics["admission"]["verdict"] == "stream"
    _same(port["model"], streamed, ("coef_", "intercept_", "n_iter_", "objective_"))
    jm = jax_["model"]
    assert port["model"].n_iter_ == jm.n_iter_
    np.testing.assert_allclose(port["model"].coef_, jm.coef_, rtol=1e-7, atol=1e-10)


# ------------------------------------------------------------- refusals -----


def _refusal(side, est, data, budget):
    S = SIDES[side]
    S["core"].config["hbm_budget_bytes"] = budget
    sched = S["queue"].FitScheduler()
    try:
        with pytest.raises(S["errors"].SchedulerSaturatedError) as ei:
            sched.submit(est, data, tenant="hopeless")
        stats = sched.stats()["tenants"]["hopeless"]
    finally:
        sched.shutdown()
    e = ei.value
    assert isinstance(e, MemoryError)  # mirrors HbmBudgetError's IS-A
    assert e.tenant == "hopeless" and e.largest_term in str(e)
    return e, stats, _counters(side).get("scheduler.jobs_refused"), _trail(side)


# estimator -> (params, data, budget, the port's own workspace terms)
_REFUSALS = {
    # the streaming floor is the smallest working set: 256-row chunks
    "kmeans": ("KMeans", dict(k=4, maxIter=6, seed=3), lambda: {"features": _rows(43, n=2000, d=16,
                                                                                      dtype=np.float32)},
               2000, {"workspace.fast_staging"}),
    # no streaming path: the resident estimate, its placement the largest
    "forest": ("RF", dict(numTrees=2, maxDepth=3), lambda: _cls_data(44, n=4000, d=16), 100_000, set()),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_submit_refuses_never_fitting_job_typed(case):
    name, params, make_data, budget, own = _REFUSALS[case]
    data = make_data()
    out = {side: _refusal(side, _est(side, name, **params), data, budget) for side in SIDES}
    (e, stats, refused, trail), (je, jstats, jrefused, jtrail) = out["torch"], out["jax"]
    assert e.budget_bytes == je.budget_bytes == int(budget * 0.9)
    assert (refused, jrefused) == (1, 1) and trail == jtrail == [("admission", "scheduler", "refused", "hopeless")]
    assert stats == jstats and stats["jobs"] == 1 and stats["failed"] == 1
    # the estimate terms: JAX's under its names and values, plus the port's own
    assert set(e.terms) - set(je.terms) == own and not set(je.terms) - set(e.terms)
    assert {k: v for k, v in e.terms.items() if k not in own} == je.terms
    assert e.estimate_bytes == je.estimate_bytes + sum(e.terms[k] for k in own)
    assert e.largest_term == je.largest_term and e.largest_term_bytes == je.largest_term_bytes
    if case == "forest":
        assert e.largest_term == "placement.X"


def test_refused_jobs_appear_in_stats():
    x = _rows(45, n=2000, d=16, dtype=np.float32)
    for side, S in SIDES.items():
        S["core"].config["hbm_budget_bytes"] = 2000
        sched = S["queue"].FitScheduler()
        try:
            with pytest.raises(S["errors"].SchedulerSaturatedError):
                sched.submit(_kmeans(side), {"features": x}, tenant="hopeless")
            t = sched.stats()["tenants"]["hopeless"]
            assert t["jobs"] == 1 and t["failed"] == 1 and t["completed"] == 0
        finally:
            sched.shutdown()


# -------------------------------------------------------- dead-job chaos ----


def _dead_job(side, x):
    """A chaos-killed tenant (an injected stage fault with no retry left):
    its claim is reclaimed and the queue keeps scheduling."""
    S, data = SIDES[side], {"features": x}
    _set_budget(side, int(1.2 * _need(side, _kmeans(side), data)))  # one job at a time: the second queues
    S["core"].config["fit_max_retries"] = 0
    S["chaos"].set_fault_plan("fail:stage=fit:times=1")
    sched = S["queue"].FitScheduler()
    try:
        doomed = sched.submit(_kmeans(side), data, tenant="dead")
        survivor = sched.submit(_kmeans(side), data, tenant="alive")
        model = survivor.result(timeout=TIMEOUT)
        with pytest.raises(S["errors"].RendezvousTimeoutError):
            doomed.result(timeout=TIMEOUT)
    finally:
        sched.shutdown()
    snap = _counters(side)
    return ((doomed.state, survivor.state, snap.get("scheduler.jobs_failed"), snap.get("scheduler.jobs_completed"),
             S["ledger"].global_ledger().reserved_bytes(), _trail(side, "dead")), model)


def test_dead_tenant_job_reclaims_reservation_and_queue_drains():
    x = _rows(46)
    (port, tm), (jax_, jm) = _dead_job("torch", x), _dead_job("jax", x)
    assert port == jax_ == ("failed", "completed", 1, 1, 0, [("admission", "scheduler", "admitted", "dead")])
    np.testing.assert_allclose(tm.cluster_centers_, jm.cluster_centers_, rtol=1e-9)


# ------------------------------------------------------------- telemetry ----


def test_ledger_gauges_flow_through_registry():
    x = _rows(47, dtype=np.float32)
    gauges, stats = {}, {}
    for side, S in SIDES.items():
        _set_budget(side, int(3 * _need(side, _kmeans(side), {"features": x})))
        sched = S["queue"].FitScheduler()
        try:
            sched.submit(_kmeans(side), {"features": x}, tenant="a").result(timeout=TIMEOUT)
        finally:
            sched.shutdown()
        snap = S["tele"].registry().snapshot()
        gauges[side] = {g for g in snap["gauges"] if g.startswith("scheduler.")}
        assert snap["histograms"].get("scheduler.queue_wait_s", {}).get("count", 0) >= 1
        assert snap["histograms"].get("scheduler.hbm_share", {}).get("count", 0) >= 1
        stats[side] = sched.stats()
        assert stats[side]["tenants"]["a"]["completed"] == 1 and stats[side]["ledger_reserved_bytes"] == 0
        assert stats[side]["ledger_utilization"] == 0.0 and stats[side]["ledger_high_watermark"] > 0
    # the port's pool is its one card, so it also publishes the idle cards
    assert gauges["torch"] == gauges["jax"] | {"scheduler.chips_idle"}
    assert {"scheduler.ledger_reserved_bytes", "scheduler.ledger_utilization"} <= gauges["torch"]
    assert sorted(stats["torch"]) == sorted(stats["jax"])
    assert _A10_STATS_KEYS <= set(stats["torch"])
    assert {k: stats["torch"][k] for k in _A10_STATS_KEYS} == {k: stats["jax"][k] for k in _A10_STATS_KEYS}


def _one_at_a_time(side, x, x_wide):
    """Three tenants' jobs through a scheduler that runs one at a time, and
    a fourth tenant's that can never fit: the decision log and the stats."""
    S, data = SIDES[side], {"features": x}
    S["core"].config["sched_max_concurrent"] = 1
    _set_budget(side, int(1.5 * _need(side, _kmeans(side), data)))
    gate = threading.Event()
    sched = S["queue"].FitScheduler()
    try:
        jobs = [sched.submit(_gated(_kmeans(side), gate), data, tenant=t) for t in ("a", "b", "c")]
        with pytest.raises(S["errors"].SchedulerSaturatedError):
            sched.submit(_kmeans(side), {"features": x_wide}, tenant="hopeless")
        gate.set()
        models = [j.result(timeout=TIMEOUT) for j in jobs]
        stats = sched.stats()
    finally:
        gate.set()
        sched.shutdown()
    return _trail(side), sorted(set(models[0]._fit_metrics["scheduler"]) - _A10_JOB_KEYS), \
        sorted(set(stats) - _A10_STATS_KEYS), \
        {t: {k: v for k, v in st.items() if "wait" not in k} for t, st in stats["tenants"].items()}


def test_one_at_a_time_decisions_and_stats_equal_jax():
    x, x_wide = _rows(48), _rows(49, n=600, d=400)
    port, jax_ = _one_at_a_time("torch", x, x_wide), _one_at_a_time("jax", x, x_wide)
    assert port == jax_
    trail = port[0]
    assert trail == [
        ("admission", "scheduler", "admitted", "a"), ("admission", "scheduler", "refused", "hopeless"),
        ("admission", "fit", "resident", "a"), ("admission", "scheduler", "admitted", "b"),
        ("admission", "fit", "resident", "b"), ("admission", "scheduler", "admitted", "c"),
        ("admission", "fit", "resident", "c")]


def test_ops_report_has_the_ledger_tenants():
    from spark_rapids_ml_tpu_torch import ops_plane

    x = _rows(50, dtype=np.float32)
    sched = tqueue.FitScheduler()
    try:
        for t in ("acme", "globex"):
            sched.submit(_kmeans("torch"), {"features": x}, tenant=t).result(timeout=TIMEOUT)
    finally:
        sched.shutdown()
    tenants = ops_plane.report()["tenants"]
    assert set(tenants) == {"acme", "globex", "_pool"}
    for t in ("acme", "globex"):
        assert tenants[t]["byte_seconds"] > 0 and tenants[t]["reservations"] == 1.0
    assert tenants["_pool"]["chips_busy"] == 0.0
    assert [d["tenant"] for d in ops_plane.report(tenant="acme")["decisions"]] == ["acme", "acme"]


def test_serving_loads_are_accounted_to_their_serving_tenant():
    x = _rows(51, dtype=np.float32)
    model = KMeans(k=3, maxIter=3, seed=1).fit({"features": x})
    adm = tmemory.admit_model_load(model, tenant="serving:km")
    try:
        assert adm.reservation.tenant == "serving:km"
        assert tledger.global_ledger().tenant_usage()["serving:km"]["live_reservations"] == 1.0
    finally:
        tmemory.release_admission(adm)


# ------------------------------ retries, cadence, threads, locks, claims -----


def _transient_retry(side, x, in_job):
    """A retry re-enters admission while the failed attempt's claim is still
    held: the re-admission must not count it twice. A resident fit at ~0.9x
    the budget must not demote on its retry, and stays bit for bit."""
    S, data = SIDES[side], {"features": x}

    def mk():
        return _kmeans(side, k=8, maxIter=10, tol=0.0, seed=7, float32_inputs=False)

    _set_budget(side, int(1.1 * _need(side, mk(), data)))  # resident fits, but not twice over
    S["core"].config["checkpoint_every_iters"] = 3
    clean = mk().fit(data)
    assert clean._fit_metrics["admission"]["verdict"] == "resident"
    S["chaos"].set_fault_plan("fail:stage=solve:times=1")
    S["tele"].registry().reset()
    if in_job:
        sched = S["queue"].FitScheduler()
        try:
            retried = sched.submit(mk(), data, tenant="t").result(timeout=TIMEOUT)
        finally:
            sched.shutdown()
    else:
        retried = mk().fit(data)
    snap = _counters(side)
    assert S["ledger"].global_ledger().reserved_bytes() == 0
    _same(retried, clean, ("cluster_centers_", "n_iter_"))
    return [snap.get("fit.retries"), snap.get("fit.demotions", 0), snap.get("checkpoint.restores"),
            retried._fit_metrics["admission"]["verdict"]], retried


@pytest.mark.parametrize("in_job", [False, True], ids=["standalone", "in_a_job"])
def test_transient_retry_readmits_without_double_count(in_job):
    x = _rows(52)
    (port, tm), (jax_, jm) = _transient_retry("torch", x, in_job), _transient_retry("jax", x, in_job)
    assert port == jax_ == [1, 0, 1, "resident"]  # NOT demoted by its own ghost
    np.testing.assert_allclose(tm.cluster_centers_, jm.cluster_centers_, rtol=1e-9)


def _no_cadence(side, x):
    """Cadence 0: solvers reach no yield point, so a preemption is never
    requested; the blocked high-priority job waits for the completion."""
    S, data = SIDES[side], {"features": x}
    _set_budget(side, int(1.2 * _need(side, _kmeans(side), data)))
    S["core"].config["checkpoint_every_iters"] = 0
    gate = threading.Event()
    sched = S["queue"].FitScheduler()
    try:
        low = sched.submit(_gated(_kmeans(side, maxIter=30, tol=0.0), gate), data, tenant="low", priority=0)
        hi = sched.submit(_kmeans(side), data, tenant="hi", priority=10)
        states = (low.state, hi.state, low.preempt_requested())
        gate.set()
        hi.result(timeout=TIMEOUT)
        low.result(timeout=TIMEOUT)
    finally:
        gate.set()
        sched.shutdown()
    return states, low.preemptions, _counters(side).get("scheduler.jobs_preempted", 0), _trail(side, "low")


def test_no_preemption_request_without_checkpoint_cadence():
    x = _rows(53)
    port, jax_ = _no_cadence("torch", x), _no_cadence("jax", x)
    assert port == jax_
    assert port[:3] == (("running", "queued", False), 0, 0)


def test_launch_counts_are_exact_under_threads():
    # co-admitted fits launch from several threads: more threads than cores,
    # switching as often as the interpreter allows, lose no count
    import os
    import sys

    _kernels.reset_launches()
    key, per_thread, n_threads = "assign_argmin/f32", 2000, (os.cpu_count() or 4) + 4
    start = threading.Event()

    def bump():
        assert start.wait(TIMEOUT)
        for _ in range(per_thread):
            _kernels._count(key)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        start.set()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert _kernels.launches[key] == per_thread * n_threads
        assert _kernels.launch_total("assign_argmin") == per_thread * n_threads
    finally:
        sys.setswitchinterval(interval)
        _kernels.reset_launches()


def test_scheduler_locks_keep_the_jax_order(monkeypatch):
    from spark_rapids_ml_tpu_torch.utils import lockcheck

    monkeypatch.setenv("SRML_LOCKCHECK", "1")
    state = lockcheck.snapshot()
    lockcheck.reset()
    try:
        monkeypatch.setattr(tledger, "_GLOBAL", tledger.HbmLedger())  # its locks checked
        x = _rows(54, dtype=np.float32)
        with tqueue.FitScheduler() as sched:
            assert isinstance(sched._lock, lockcheck.CheckedLock)
            jobs = [sched.submit(_kmeans("torch"), {"features": x}, tenant=t) for t in ("a", "b")]
            for j in jobs:
                j.result(timeout=TIMEOUT)
        rep = lockcheck.report()
    finally:
        lockcheck.restore(state)
    assert rep["inversions"] == []
    names = ("scheduler.queue.FitScheduler._lock", "scheduler.ledger.HbmLedger._admission_lock",
             "scheduler.ledger.HbmLedger._lock")
    assert set(names) <= set(rep["locks"])
    edges = {tuple(e.split(" -> ")) if isinstance(e, str) else tuple(e) for e in rep["edges"]}
    assert (names[0], names[1]) in edges and (names[1], names[2]) in edges


def _oom_in_a_job(side, x):
    """A real out-of-memory at the placement of a job's fit: the OOM
    ladder's streamed retry re-admits, and resizes the job's claim (the
    ledger never holds a second one)."""
    S, data = SIDES[side], {"features": x}
    S["core"].config["stream_chunk_rows"] = 256
    seen = []
    S["ledger"].global_ledger().admission_hooks.append(lambda reserved, budget: seen.append(reserved))
    S["chaos"].set_fault_plan("oom:stage=placement:times=1")
    sched = S["queue"].FitScheduler()
    try:
        model = sched.submit(_kmeans(side, float32_inputs=False), data, tenant="t").result(timeout=TIMEOUT)
    finally:
        sched.shutdown()
    led = S["ledger"].global_ledger()
    adm = model._fit_metrics["admission"]
    assert adm["verdict"] == "stream" and led.reserved_bytes() == 0
    # the scheduler's admission, the fit's resident admission, its streamed retry: one claim, resized
    assert len(seen) == 3 and seen[2] == adm["estimate_bytes"]
    assert led.high_watermark == max(seen)
    return [_counters(side).get(k) for k in ("memory.oom_caught", "fit.demotions")], _trail(side, "t"), model


def test_oom_retry_in_a_job_resizes_the_jobs_claim():
    x = _rows(55, n=2000, d=6)
    (port, ptrail, tm), (jax_, jtrail, jm) = _oom_in_a_job("torch", x), _oom_in_a_job("jax", x)
    assert port == jax_ == [1, 1]
    assert ptrail == jtrail == [("admission", "scheduler", "admitted", "t"), ("admission", "fit", "resident", "t"),
                                ("demotion", "fit", "stream", "t")]
    assert tm.n_iter_ == jm.n_iter_
    np.testing.assert_allclose(tm.cluster_centers_, jm.cluster_centers_, rtol=1e-9)


def test_cache_hit_and_release_inside_a_job_keep_one_claim():
    for S in SIDES.values():
        led = S["ledger"].global_ledger()
        job = S["queue"].FitJob(3, None, None, "acme", 0)
        job.reservation = led.reserve("job:3:acme", "job", 100, tenant="acme")
        adm = S["memory"].AdmissionDecision(verdict="resident", estimate=S["memory"].MemoryEstimate({"placement.X": 40}))
        with S["ctx"].job_scope(job):
            assert S["memory"].rereserve_admission(adm) is None  # the job owns the claim
        assert [(r.owner, r.nbytes, r.tenant) for r in led.reservations()] == [("job:3:acme", 40, "acme")]
        S["memory"].release_admission(adm)  # a job's admission holds none: a no-op
        assert led.reserved_bytes() == 40
        assert S["memory"].rereserve_admission(adm).nbytes == 40  # outside a job: a claim of its own
        led.release(job.reservation)
        assert led.reserved_bytes() == 40
        for r in led.reservations():
            led.release(r)
