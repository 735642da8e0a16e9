#
# The PyTorch port's runtime sanitizers (spark_rapids_ml_tpu_torch/utils/
# numcheck.py and utils/lockcheck.py) and their hooks (the Lloyd loop, the
# streamed solvers, the serving response sweep; the serving, telemetry,
# audit, SLO, drift and exporter locks) against the JAX package's, on the
# same scripted misuse and the same seeded inputs, on the CPU.
#
# Tolerances: none needed. Trips (all keys but the time "t"), watermarks,
# check counts, error messages, violation kinds and the observed lock-order
# graphs equal the JAX package's exactly; a fit or a response swept under
# SRML_NUMCHECK=1 equals the same fit or response without it bit for bit.
#
import threading
import time

import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu import errors as jerrors
from spark_rapids_ml_tpu.models.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.models.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.models.regression import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.models.knn import NearestNeighbors as JaxNearestNeighbors
from spark_rapids_ml_tpu.serving import ModelRegistry as JaxModelRegistry
from spark_rapids_ml_tpu.serving import ScoringEngine as JaxScoringEngine
from spark_rapids_ml_tpu.utils import lockcheck as jlock
from spark_rapids_ml_tpu.utils import numcheck as jnum
from spark_rapids_ml_tpu_torch import (
    PCA,
    KMeans,
    LinearRegression,
    LogisticRegression,
    ModelRegistry,
    NearestNeighbors,
    ScoringEngine,
    errors,
    parallel,
)
from spark_rapids_ml_tpu_torch.core import config
from spark_rapids_ml_tpu_torch.utils import lockcheck as tlock
from spark_rapids_ml_tpu_torch.utils import numcheck as tnum

NUM = {"port": tnum, "jax": jnum}
LOCK = {"port": tlock, "jax": jlock}


@pytest.fixture(autouse=True)
def port_on_cpu():
    parallel.set_devices("cpu")
    yield
    parallel.set_devices(None)


@pytest.fixture()
def numerics(monkeypatch):
    """Both sanitizers on, each against a clean slate, their earlier state
    restored exactly afterwards (the deliberate trips stay out of it)."""
    monkeypatch.setenv("SRML_NUMCHECK", "1")
    states = {k: m.snapshot() for k, m in NUM.items()}
    for m in NUM.values():
        m.reset()
    yield NUM
    for k, m in NUM.items():
        m.restore(states[k])


@pytest.fixture()
def locks(monkeypatch):
    monkeypatch.setenv("SRML_LOCKCHECK", "1")
    states = {k: m.snapshot() for k, m in LOCK.items()}
    for m in LOCK.values():
        m.reset()
    yield LOCK
    for k, m in LOCK.items():
        m.restore(states[k])


def _trips(mod):
    return [{k: v for k, v in t.items() if k != "t"} for t in mod.trips()]


# ------------------------------------------------------------- numcheck ------


def test_disabled_hook_is_none_on_both_sides(monkeypatch):
    monkeypatch.setenv("SRML_NUMCHECK", "0")
    for m in NUM.values():
        assert m.hook() is None and m.enabled() is False


_MISUSE = [
    # (stage, kwargs, values): a NaN, an Inf, an Inf allowed as a sentinel,
    # NaN under allow_inf, integers and scalars, a watermark only
    ("s.nan", dict(solver="km", iteration=3), dict(shift=np.array([0.1, np.nan, 2.0]))),
    ("s.inf", dict(solver="lin"), dict(ok=np.ones(3, np.float32), G=np.array([[1.0, np.inf], [0.0, -np.inf]]))),
    ("s.sentinel", dict(allow_inf=True), dict(d=np.array([[0.5, np.inf]], np.float32))),
    ("s.sentinel_nan", dict(allow_inf=True), dict(d=np.array([np.nan, np.inf]))),
    ("s.ints", dict(), dict(ids=np.arange(4), scalar=2.5, flag=True)),
    ("s.mark", dict(watermark="float64"), dict()),
]


def test_numcheck_trips_on_the_same_scripted_misuse(numerics):
    out = {}
    for name, m in NUM.items():
        raised = []
        for stage, kw, values in _MISUSE:
            try:
                m.check(stage, **kw, **values)
                raised.append(None)
            except (errors.NumericsError, jerrors.NumericsError) as e:
                raised.append((str(e), e.stage, e.solver, e.iteration, e.value_name, e.detail))
        rep = m.report()
        out[name] = (raised, _trips(m), m.watermarks(), m.checks(),
                     {k: v for k, v in rep.items() if k != "trips"})
    assert out["port"] == out["jax"]
    assert [r is not None for r in out["port"][0]] == [True, True, False, True, False, False]


def test_numcheck_report_and_restore(numerics, tmp_path):
    tnum.check("a.b", x=np.ones(2))
    state = tnum.snapshot()
    with pytest.raises(errors.NumericsError):
        tnum.check("a.c", x=np.array([np.nan]))
    tnum.restore(state)
    assert tnum.trips() == [] and tnum.checks() == 1
    path = tmp_path / "numcheck.json"
    assert tnum.write_report(str(path)) == str(path)
    import json

    assert json.loads(path.read_text())["watermarks"] == {"a.b": {"float64": 1}}


def test_lloyd_loop_sweeps_clean_and_equal_without_the_sanitizer(numerics, monkeypatch):
    x = np.random.default_rng(0).normal(size=(600, 5))
    on = KMeans(k=3, maxIter=6, seed=1, float32_inputs=False).fit({"features": x})
    wm = tnum.watermarks()
    assert set(wm) == {"kmeans.iterate"} and tnum.trips() == []
    assert "float64" in wm["kmeans.iterate"]
    monkeypatch.setenv("SRML_NUMCHECK", "0")
    off = KMeans(k=3, maxIter=6, seed=1, float32_inputs=False).fit({"features": x})
    np.testing.assert_array_equal(on.cluster_centers_, off.cluster_centers_)


def test_streamed_fits_sweep_the_jax_boundaries(numerics, monkeypatch):
    from spark_rapids_ml_tpu.scheduler import ledger as jledger
    from spark_rapids_ml_tpu_torch.scheduler import ledger as tledger

    # fresh shared ledgers: what earlier tests left resident is not charged
    monkeypatch.setattr(tledger, "_GLOBAL", tledger.HbmLedger())
    monkeypatch.setattr(jledger, "_GLOBAL", jledger.HbmLedger(), raising=False)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2000, 6))
    y = x @ rng.normal(size=6) + 0.1 * rng.normal(size=2000)
    yc = (y > 0).astype(float)
    from spark_rapids_ml_tpu_torch import telemetry

    saved = {k: (config[k], jcore.config[k]) for k in ("hbm_budget_bytes", "stream_chunk_rows")}
    telemetry.enable()  # the admission stamp on _fit_metrics
    try:
        # budgets that demote a 2000 x 6 float64 fit and admit its 512-row
        # chunks in both packages (tests/test_torch_oocore.py's)
        fits = [
            (140_000, KMeans(k=4, maxIter=3, float32_inputs=False),
             JaxKMeans(k=4, maxIter=3, float32_inputs=False, num_workers=1), {"features": x}),
            (100_000, PCA(k=2, float32_inputs=False).setInputCol("features"),
             JaxPCA(k=2, float32_inputs=False, num_workers=1).setInputCol("features"), {"features": x}),
            (100_000, LinearRegression(float32_inputs=False),
             JaxLinearRegression(float32_inputs=False, num_workers=1), {"features": x, "label": y}),
            (100_000, LogisticRegression(maxIter=5, regParam=1e-3, float32_inputs=False),
             JaxLogisticRegression(maxIter=5, regParam=1e-3, float32_inputs=False, num_workers=1),
             {"features": x, "label": yc}),
        ]
        for budget, port, jax_est, data in fits:
            for cfg in (config, jcore.config):
                cfg.update(hbm_budget_bytes=budget, stream_chunk_rows=512)
            m = port.fit(data)
            assert m._fit_metrics["admission"]["verdict"] == "stream"
            jax_est.fit(data)
    finally:
        telemetry.disable()
        telemetry.registry().reset()
        for k, (a, b) in saved.items():
            config[k], jcore.config[k] = a, b
    port_stages, jax_stages = set(tnum.watermarks()), set(jnum.watermarks())
    # the port's streamed Lloyd loop keeps its chunk partials on the card:
    # the JAX package's per-chunk `kmeans_stream.chunk` has no counterpart
    assert port_stages == jax_stages - {"kmeans_stream.chunk"}, (port_stages, jax_stages)
    assert {"linear_stream.chunk", "pca_stream.chunk", "pca_stream.stats", "kmeans_stream.iterate",
            "glm_stream.iterate"} == port_stages
    assert tnum.trips() == [] and jnum.trips() == []


def test_the_response_sweep_trips_on_a_nan_query_like_jax(numerics):
    items = np.random.default_rng(2).normal(size=(30, 4))
    df = pd.DataFrame({"features": list(items)})
    q = items[:3].copy()
    q[1, 2] = np.nan
    errs = {}
    for name, est, reg_cls, eng_cls in (
        ("port", NearestNeighbors, ModelRegistry, ScoringEngine),
        ("jax", JaxNearestNeighbors, JaxModelRegistry, JaxScoringEngine),
    ):
        model = est(k=2, float32_inputs=False).setInputCol("features").fit(df)
        registry = reg_cls(prewarm=False)
        registry.load("nn", model)
        with eng_cls(registry) as engine:
            clean = engine.score("nn", items[:2])
            with pytest.raises((errors.NumericsError, jerrors.NumericsError)) as ei:
                engine.score("nn", q)
        e = ei.value
        errs[name] = (e.stage, e.solver, e.value_name, clean[1].tolist())
    assert errs["port"] == errs["jax"]
    assert errs["port"][:3] == ("serving.response", "nn", "chunk0_out0")
    assert [t["stage"] for t in tnum.trips()] == ["serving.response"]


# ------------------------------------------------------------- lockcheck -----


def _graph(mod):
    # the JAX package's flight recorder takes a lock of its own while it
    # records a violation; the port has no flight recorder yet (A15)
    rep = mod.report()
    return (
        rep["enabled"], [n for n in rep["locks"] if not n.startswith("diagnostics.")],
        [e for e in rep["edges"] if "diagnostics." not in e],
        [(v["lock"], v["held"], v["kind"]) for v in rep["inversions"]],
        [(v["lock"], v["kind"]) for v in rep["long_holds"]],
    )


def _scripted_inversions(mod):
    a, b, c = mod.make_lock("t.A"), mod.make_lock("t.B"), mod.make_lock("t.C", "rlock")
    with a:
        with b:
            with c:
                with c:  # re-entrant: no edge
                    pass
    with b:
        with a:  # inversion of A -> B
            pass
    done = threading.Event()

    def other():
        with c:
            with a:  # inversion of A -> C, from another thread
                pass
        done.set()

    t = threading.Thread(target=other, name="other")
    t.start()
    t.join(10)
    assert done.is_set()


def test_lockcheck_violations_on_the_same_scripted_misuse(locks):
    for m in LOCK.values():
        _scripted_inversions(m)
    assert _graph(tlock) == _graph(jlock)
    assert [v[:2] for v in _graph(tlock)[3]] == [("t.A", "t.B"), ("t.A", "t.C")]


def test_lockcheck_long_hold_and_condition_wait(locks, monkeypatch):
    monkeypatch.setitem(config, "lockcheck_long_hold_ms", 10.0)
    monkeypatch.setitem(jcore.config, "lockcheck_long_hold_ms", 10.0)
    for m in LOCK.values():
        slow = m.make_lock("t.slow")
        with slow:
            time.sleep(0.05)
        cond = m.make_condition("t.cond")
        with cond:
            cond.wait(0.05)  # a wait releases: not hold time
    assert _graph(tlock) == _graph(jlock)
    assert [v["lock"] for v in tlock.violations()] == ["t.slow"]
    assert tlock.report()["max_hold_s"]["t.slow"] >= 0.04


def test_lockcheck_disabled_gives_plain_primitives(monkeypatch):
    monkeypatch.setenv("SRML_LOCKCHECK", "0")
    assert type(tlock.make_lock("x")) is type(threading.Lock())
    assert type(tlock.make_lock("x", "rlock")) is type(threading.RLock())
    assert not isinstance(tlock.make_condition("x")._lock, tlock.CheckedLock)


def test_the_port_builds_its_locks_under_the_jax_names(locks):
    from spark_rapids_ml_tpu_torch import telemetry
    from spark_rapids_ml_tpu_torch.serving.overload import OverloadController

    registry = ModelRegistry()
    engine = ScoringEngine(registry)
    named = {
        "serving.registry.ModelRegistry._lock": registry._lock,
        "serving.engine.ScoringEngine._cond": engine._cond._lock,
        "serving.overload.OverloadController._lock": OverloadController()._lock,
        "telemetry.MetricsRegistry._lock": telemetry.MetricsRegistry()._lock,
    }
    for name, lock in named.items():
        assert isinstance(lock, tlock.CheckedLock) and lock.name == name
    # the module locks (built at import) carry the JAX package's names
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    for rel in ("ops_plane/audit.py", "ops_plane/slo.py", "ops_plane/export.py", "ops_plane/drift.py",
                "serving/overload.py", "serving/registry.py", "serving/engine.py", "telemetry.py",
                "scheduler/ledger.py", "scheduler/queue.py", "checkpoint.py"):
        ours = _lock_names(root / "spark_rapids_ml_tpu_torch" / rel, ast)
        theirs = _lock_names(root / "spark_rapids_ml_tpu" / rel, ast)
        assert ours and ours <= theirs, rel


def _lock_names(path, ast):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) in ("make_lock", "make_condition")
                and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
    return names


def test_a_served_request_under_lockcheck_has_no_inversion(locks):
    x = np.random.default_rng(3).normal(size=(100, 4)).astype(np.float32)
    registry = ModelRegistry(prewarm=False)
    model = KMeans(k=3, maxIter=3).fit({"features": x})
    registry.load("km", model)
    with ScoringEngine(registry) as engine:
        for i in range(4):
            engine.score("km", x[i * 5:(i + 1) * 5])
        engine.stats()
    registry.clear()
    rep = tlock.report()
    assert rep["inversions"] == []
    assert "serving.engine.ScoringEngine._cond" in rep["locks"]
