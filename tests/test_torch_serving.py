#
# The PyTorch port's serving plane (spark_rapids_ml_tpu_torch/serving/,
# core.PredictProgram, memory.py, the models' serve hooks) against the JAX
# package's (spark_rapids_ml_tpu/serving/) on the same models and requests,
# made with numpy from a seed. The port runs on the CPU (set_devices("cpu"),
# the plain PyTorch versions of its kernels); the JAX side runs its own
# ScoringEngine and ModelRegistry on the CPU.
#
# Tolerances: KMeans predictions equal exactly (f32 and bf16); kNN ids equal
# exactly and distances to rtol 1e-5 (the same float32 formula, norms summed
# in another order); bf16 kNN ids equal on items far apart; a coalesced
# response equals the same request served alone bit for bit; admission bytes
# and the batching planners equal JAX's exactly.
#
import itertools
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu import errors as jerrors
from spark_rapids_ml_tpu import memory as jmemory
from spark_rapids_ml_tpu import telemetry as jtele
from spark_rapids_ml_tpu.models.clustering import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu.models.knn import NearestNeighbors as JaxNearestNeighbors
from spark_rapids_ml_tpu.serving import ModelRegistry as JaxModelRegistry
from spark_rapids_ml_tpu.serving import ScoringEngine as JaxScoringEngine
from spark_rapids_ml_tpu.serving import overload as joverload
from spark_rapids_ml_tpu_torch import (
    KMeansModel,
    ModelRegistry,
    NearestNeighbors,
    NearestNeighborsModel,
    ScoringEngine,
    errors,
    memory,
    parallel,
    telemetry,
)
from spark_rapids_ml_tpu_torch.core import PredictProgram, config
from spark_rapids_ml_tpu_torch.ops import distance as tdist
from spark_rapids_ml_tpu_torch.scheduler import ledger as tledger
from spark_rapids_ml_tpu_torch.serving import overload as toverload

_KEYS = (
    "transform_bucket_min_rows", "serve_prewarm_rows", "serve_max_batch_rows",
    "serve_coalesce_window_ms", "hbm_budget_bytes", "serve_default_deadline_ms",
    "serve_max_queue_rows", "serve_degraded_dtype",
)
_SMALL = {
    "transform_bucket_min_rows": 8, "serve_prewarm_rows": 64, "serve_max_batch_rows": 256,
    "serve_coalesce_window_ms": 25.0,
}


@pytest.fixture(autouse=True)
def serve_env(monkeypatch):
    """The port on the CPU, a small bucket ladder on both sides, telemetry on
    with fresh registries, and a fresh shared ledger."""
    parallel.set_devices("cpu")
    saved = {k: config[k] for k in _KEYS}
    jsaved = {k: jcore.config[k] for k in _KEYS}
    config.update(_SMALL)
    jcore.config.update(_SMALL)
    monkeypatch.setattr(tledger, "_GLOBAL", tledger.HbmLedger())
    for tel in (telemetry, jtele):
        tel.registry().reset()
        tel.enable()
    yield
    for tel in (telemetry, jtele):
        tel.disable()
        tel.registry().reset()
    config.update(saved)
    jcore.config.update(jsaved)
    parallel.set_devices(None)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _centers(rng, k=6, d=10, scale=10.0):
    return (rng.standard_normal((k, d)) * scale).astype(np.float32)


def _kmeans_pair(centers):
    d = centers.shape[1]
    return (
        KMeansModel(cluster_centers_=centers, n_cols=d, dtype="float32"),
        JaxKMeansModel(cluster_centers_=centers, n_cols=d, dtype="float32"),
    )


def _knn_pair(items, k=4, float32_inputs=True):
    df = pd.DataFrame({"features": list(items), "id": np.arange(1000, 1000 + len(items))})
    models = []
    for cls in (NearestNeighbors, JaxNearestNeighbors):
        est = cls(k=k, float32_inputs=float32_inputs).setInputCol("features").setIdCol("id")
        models.append(est.fit(df))
    return models


def _serve(engine_cls, registry, name, requests, threads=True):
    """Responses to `requests`, submitted from client threads so they
    interleave inside the coalesce window."""
    with engine_cls(registry) as engine:
        futs = [None] * len(requests)

        def submit(i):
            futs[i] = engine.submit(name, requests[i])

        if threads:
            ts = [threading.Thread(target=submit, args=(i,)) for i in range(len(requests))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        else:
            for i in range(len(requests)):
                submit(i)
        return [f.result(timeout=120) for f in futs]


def _counters():
    return telemetry.registry().snapshot()["counters"]


# --------------------------------------------------- the port against JAX ----


@pytest.mark.parametrize("serve_dtype", [None, "bf16"])
@pytest.mark.parametrize("integer", [False, True])
def test_kmeans_serving_matches_jax(rng, serve_dtype, integer):
    if integer:  # exact in bf16: bf16 serving equals f32 bit for bit, ties included
        centers = rng.integers(-4, 5, size=(6, 10)).astype(np.float32)
        centers[4] = centers[1]
        requests = [rng.integers(-4, 5, size=(n, 10)).astype(np.float32) for n in (1, 5, 17, 40)]
    else:  # far-apart centers: bf16 rounding cannot flip an assignment
        centers = _centers(rng, scale=50.0)
        requests = [rng.standard_normal((n, 10)).astype(np.float32) * 20 for n in (1, 5, 17, 40)]
    port, jax_model = _kmeans_pair(centers)
    registry, jregistry = ModelRegistry(), JaxModelRegistry()
    registry.load("km", port, serve_dtype=serve_dtype)
    jregistry.load("km", jax_model, serve_dtype=serve_dtype)
    got = _serve(ScoringEngine, registry, "km", requests)
    want = _serve(JaxScoringEngine, jregistry, "km", requests)
    for g, w, q in zip(got, want, requests):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, np.asarray(port._transform_arrays(q)))


@pytest.mark.parametrize("float32_inputs", [True, False])
def test_knn_serving_matches_jax(rng, float32_inputs):
    items = rng.normal(size=(150, 5))
    port, jax_model = _knn_pair(items, float32_inputs=float32_inputs)
    registry, jregistry = ModelRegistry(), JaxModelRegistry()
    registry.load("knn", port)
    jregistry.load("knn", jax_model)
    requests = [rng.normal(size=(n, 5)) for n in (1, 3, 9, 30)]
    got = _serve(ScoringEngine, registry, "knn", requests)
    want = _serve(JaxScoringEngine, jregistry, "knn", requests)
    for (gd, gi), (wd, wi) in zip(got, want):
        assert gi.dtype == np.int64 and gi.shape == (len(gd), 4)
        np.testing.assert_array_equal(gi, np.asarray(wi))
        # the same formula, norms summed in another order: rtol 1e-5
        np.testing.assert_allclose(gd, np.asarray(wd), rtol=1e-5)
    # and the values kneighbors gives
    _, _, knn_df = port.kneighbors(
        pd.DataFrame({"features": list(requests[2]), "id": np.arange(len(requests[2]))})
    )
    np.testing.assert_array_equal(got[2][1], np.stack(knn_df["indices"].to_numpy()))
    np.testing.assert_allclose(got[2][0], np.stack(knn_df["distances"].to_numpy()), rtol=1e-5)


def test_knn_bf16_neighbor_sets_on_separated_items(rng):
    # items on a coarse lattice: neighbor gaps far above bf16 rounding
    items = (rng.integers(-4, 5, size=(80, 5)) * 10.0).astype(np.float64)
    items += rng.normal(scale=0.01, size=items.shape)
    port, jax_model = _knn_pair(items, k=3)
    q = items[:7] + 0.05
    out = {}
    for name, (reg_cls, eng_cls, model) in {
        "port16": (ModelRegistry, ScoringEngine, port),
        "jax16": (JaxModelRegistry, JaxScoringEngine, jax_model),
    }.items():
        registry = reg_cls()
        registry.load("knn16", model, serve_dtype="bf16")
        out[name] = _serve(eng_cls, registry, "knn16", [q])[0]
    f32 = ModelRegistry()
    f32.load("knn32", port)
    _, idx32 = _serve(ScoringEngine, f32, "knn32", [q])[0]
    np.testing.assert_array_equal(out["port16"][1], np.asarray(out["jax16"][1]))
    np.testing.assert_array_equal(out["port16"][1], idx32)


def test_knn_bf16_serving_runs_the_fast_d2_block(rng, monkeypatch):
    items = rng.normal(size=(40, 6)).astype(np.float32)
    port, _ = _knn_pair(items, k=3)
    seen = []
    real = tdist.d2_block
    monkeypatch.setattr(
        tdist, "d2_block", lambda *a, **kw: seen.append(kw.get("fast")) or real(*a, **kw)
    )
    for serve_dtype in (None, "bf16"):
        registry = ModelRegistry(prewarm=False)
        registry.load("knn", port, serve_dtype=serve_dtype)
        _serve(ScoringEngine, registry, "knn", [items[:3]])
    assert seen == [False, True]


# ---------------------------------------------------- coalesced == solo ----


@pytest.mark.parametrize("kind,serve_dtype", [
    ("kmeans", None), ("kmeans", "bf16"), ("knn", None), ("knn", "bf16"),
])
def test_coalesced_responses_bit_identical_to_solo(rng, kind, serve_dtype):
    if kind == "kmeans":
        model, _ = _kmeans_pair(_centers(rng))
        d = 10
    else:
        model, _ = _knn_pair(rng.normal(size=(50, 7)), k=5)
        d = 7
    registry = ModelRegistry()
    registry.load("m", model, serve_dtype=serve_dtype)
    sizes = (1, 3, 17, 40, 2, 9, 64, 5)
    requests = [rng.standard_normal((n, d)).astype(np.float32) for n in sizes]
    with ScoringEngine(registry, coalesce_window_s=0.0) as engine:
        solo = [engine.score("m", q) for q in requests]
    assert _counters().get("serve.coalesced_batches", 0) == 0
    coalesced = _serve(ScoringEngine, registry, "m", requests)
    for got, ref in zip(coalesced, solo):
        for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
            assert g.dtype == r.dtype and np.array_equal(g, r)  # BIT-identical
    counters = _counters()
    assert counters["serve.coalesced_batches"] >= 1  # micro-batching happened
    assert counters["serve.requests"] == 2 * len(requests)


# ---------------------------------------------------------- request edges ----


def test_zero_row_and_oversized_requests(rng):
    km, _ = _kmeans_pair(_centers(rng))
    nn, _ = _knn_pair(rng.normal(size=(30, 10)), k=4)
    registry = ModelRegistry()
    registry.load("km", km)
    registry.load("nn", nn)
    big = rng.standard_normal((2 * config["serve_max_batch_rows"] + 37, 10)).astype(np.float32)
    with ScoringEngine(registry) as engine:
        assert engine.score("km", np.zeros((0, 10), np.float32)).shape == (0,)
        d, i = engine.score("nn", np.zeros((0, 10), np.float32))
        assert d.shape == (0, 4) and i.shape == (0, 4)
        # rows > serve_max_batch_rows: the engine splits across dispatches
        np.testing.assert_array_equal(engine.score("km", big, timeout=120), km._transform_arrays(big))
        bd, bi = engine.score("nn", big, timeout=120)
        assert bd.shape == (len(big), 4)
        sd, si = engine.score("nn", big[-37:])
        np.testing.assert_array_equal(bi[-37:], si)
        np.testing.assert_array_equal(bd[-37:], sd)


def test_submit_validates_synchronously(rng):
    registry = ModelRegistry()
    registry.load("km", _kmeans_pair(_centers(rng))[0])
    with ScoringEngine(registry) as engine:
        with pytest.raises(KeyError):
            engine.submit("nope", np.zeros((1, 10), np.float32))
        with pytest.raises(ValueError, match="expects 10 features"):
            engine.submit("km", np.zeros((3, 4), np.float32))
        with pytest.raises(ValueError, match="block"):
            engine.submit("km", np.zeros(10, np.float32))
    with pytest.raises(RuntimeError, match="not running"):
        engine.submit("km", np.zeros((1, 10), np.float32))


def _blocked_dispatch(monkeypatch, registry, name):
    """Make `name`'s program hold its first dispatch until the returned event
    is set; returns (started, release) events."""
    program = registry.get(name).program
    started, release = threading.Event(), threading.Event()
    real = program.dispatch

    def dispatch(xb):
        if not started.is_set():
            started.set()
            release.wait(30)
        return real(xb)

    monkeypatch.setattr(program, "dispatch", dispatch)
    return started, release


def test_evicted_mid_flight_fails_typed(rng, monkeypatch):
    registry = ModelRegistry()
    registry.load("km", _kmeans_pair(_centers(rng))[0])
    registry.load("other", _kmeans_pair(_centers(rng))[0])
    started, release = _blocked_dispatch(monkeypatch, registry, "other")
    with ScoringEngine(registry, coalesce_window_s=0.0) as engine:
        blocker = engine.submit("other", rng.standard_normal((2, 10)).astype(np.float32))
        assert started.wait(30)
        queued = engine.submit("km", rng.standard_normal((4, 10)).astype(np.float32))
        registry.evict("km")  # while its request waits in the queue
        release.set()
        blocker.result(30)
        with pytest.raises(KeyError, match="not resident"):
            queued.result(30)
        with pytest.raises(KeyError):
            engine.submit("km", np.zeros((1, 10), np.float32))
    assert _counters()["serve.errors"] == 1


def test_expired_deadline_fails_fast_and_never_dispatches(rng, monkeypatch):
    registry = ModelRegistry()
    registry.load("km", _kmeans_pair(_centers(rng))[0])
    started, release = _blocked_dispatch(monkeypatch, registry, "km")
    with ScoringEngine(registry, coalesce_window_s=0.0) as engine:
        a = engine.submit("km", rng.standard_normal((4, 10)).astype(np.float32))
        assert started.wait(30)
        b = engine.submit("km", rng.standard_normal((4, 10)).astype(np.float32), deadline_ms=50.0)
        time.sleep(0.1)  # b's deadline passes while a holds the worker
        release.set()
        assert a.result(timeout=10.0).shape == (4,)
        with pytest.raises(errors.RequestTimeoutError) as ei:
            b.result(timeout=10.0)
    err = ei.value
    assert err.model == "km"
    assert err.deadline_ms == pytest.approx(50.0, rel=0.05)
    assert err.waited_ms >= err.deadline_ms
    counters = _counters()
    assert counters["serve.expired_requests"] == 1
    assert counters["serve.batches"] == 1  # only the live request dispatched


def test_deadline_defaults_and_zero_disables(rng):
    config["serve_default_deadline_ms"] = 5000.0
    registry = ModelRegistry()
    registry.load("km", _kmeans_pair(_centers(rng))[0])
    with ScoringEngine(registry) as engine:
        t0 = time.monotonic()
        fut = engine.submit("km", rng.standard_normal((2, 10)).astype(np.float32))
        assert fut.deadline - t0 == pytest.approx(5.0, abs=0.5)
        assert engine.submit("km", np.zeros((2, 10), np.float32), deadline_ms=0).deadline is None


def test_full_queue_is_refused_typed(rng):
    config["serve_max_queue_rows"] = 4
    registry = ModelRegistry()
    registry.load("km", _kmeans_pair(_centers(rng))[0])
    with ScoringEngine(registry) as engine:
        with pytest.raises(errors.ServeOverloadError, match="queue is full") as ei:
            engine.submit("km", rng.standard_normal((8, 10)).astype(np.float32))
    assert ei.value.queue_rows == 0 and ei.value.level == "healthy"
    assert _counters()["serve.rejected_requests"] == 1


def test_infeasible_deadline_is_refused_with_evidence(rng):
    registry = ModelRegistry()
    registry.load("km", _kmeans_pair(_centers(rng))[0])
    for _ in range(8):  # the windowed queue-wait p99 far above the deadline
        telemetry.registry().observe("serve.queue_wait_s", 5.0)
    with ScoringEngine(registry) as engine:
        with pytest.raises(errors.ServeOverloadError) as ei:
            engine.submit("km", rng.standard_normal((4, 10)).astype(np.float32), deadline_ms=100.0)
    assert ei.value.predicted_wait_ms > 100.0
    assert ei.value.deadline_ms == pytest.approx(100.0, rel=0.05)


def test_stop_fails_pending_futures_typed(rng, monkeypatch):
    registry = ModelRegistry()
    registry.load("km", _kmeans_pair(_centers(rng))[0])
    started, release = _blocked_dispatch(monkeypatch, registry, "km")
    engine = ScoringEngine(registry, coalesce_window_s=0.0).start()
    worker = engine._thread
    try:
        engine.submit("km", np.zeros((4, 10), np.float32))
        assert started.wait(30)
        b = engine.submit("km", np.zeros((4, 10), np.float32))
        c = engine.submit("km", np.zeros((4, 10), np.float32))
        engine.stop(timeout=0.05)  # the drain deadline elapses mid-dispatch
        for pos, fut in ((0, b), (1, c)):
            with pytest.raises(errors.ServingStoppedError) as ei:
                fut.result(timeout=1.0)
            assert ei.value.model == "km" and ei.value.queue_position == pos
    finally:
        release.set()
        worker.join(10.0)


def test_zero_window_disables_coalescing(rng):
    registry = ModelRegistry()
    registry.load("km", _kmeans_pair(_centers(rng))[0])
    requests = [rng.standard_normal((n, 10)).astype(np.float32) for n in (3, 5, 7, 9)]
    with ScoringEngine(registry, coalesce_window_s=0.0) as engine:
        futs = [engine.submit("km", q) for q in requests]
        outs = [f.result(30) for f in futs]
    assert [o.shape for o in outs] == [(3,), (5,), (7,), (9,)]
    counters = _counters()
    assert counters["serve.batches"] == len(requests)
    assert counters.get("serve.coalesced_batches", 0) == 0


def test_latency_histograms_and_stats(rng):
    registry = ModelRegistry()
    registry.load("km", _kmeans_pair(_centers(rng))[0])
    with ScoringEngine(registry) as engine:
        for _ in range(5):
            engine.score("km", rng.standard_normal((4, 10)).astype(np.float32))
        stats = engine.stats()
    hists = telemetry.registry().snapshot()["histograms"]
    assert hists["serve.queue_wait_s"]["count"] == 5
    assert hists["serve.e2e_s"]["count"] == 5
    assert hists["device_wait.serve_assembly_s"]["count"] == 5
    assert stats["e2e_p99_s"] >= stats["e2e_p50_s"] > 0
    assert stats["requests"] == 5 and stats["rows"] == 20
    assert stats["tenants"]["default"]["e2e_p50_s"] > 0
    assert _counters()["serve.flops"] == 5 * 3.0 * 4 * 6 * 10


@pytest.mark.parametrize("config_key,value", [
    ("serve_degraded_dtype", "bf16"),
    ("slo", [{"name": "p99", "kind": "latency", "histogram": "serve.e2e_s", "threshold_s": 0.1}]),
])
def test_backpressure_ladder_is_refused_by_name(rng, config_key, value):
    # (named when the port refused both settings, naming ROADMAP A13) the
    # ladder and its degraded rung are ported: each setting now builds the
    # rung or drives the ladder as the JAX package does on the same input
    saved, jsaved = dict(config), dict(jcore.config)
    config[config_key] = jcore.config[config_key] = value
    try:
        port, jax_model = _kmeans_pair(_centers(rng, scale=50.0))
        feats = rng.standard_normal((24, 10)).astype(np.float32)
        if config_key == "serve_degraded_dtype":
            config["serve_throttle_rows_per_s"] = jcore.config["serve_throttle_rows_per_s"] = 1e9
            got = {}
            for name, reg_cls, eng_cls, model in (
                ("port", ModelRegistry, ScoringEngine, port),
                ("jax", JaxModelRegistry, JaxScoringEngine, jax_model),
            ):
                registry = reg_cls()
                entry = registry.load("km", model)
                assert entry.degraded_dtype == "bf16" and entry.degraded_program is not None
                with eng_cls(registry) as engine:
                    engine._overload.force_level("default", toverload.LEVEL_DEGRADE)
                    got[name] = np.asarray(engine.score("km", feats))
            np.testing.assert_array_equal(got["port"], got["jax"])
            assert _counters()["serve.degraded_requests"] == 1
        else:
            config["serve_overload_hold_s"] = jcore.config["serve_overload_hold_s"] = 10.0
            walks = {}
            for name, mod in (("port", toverload), ("jax", joverload)):
                ctl = mod.OverloadController()
                ctl.admit(model="km", tenant="t", rows=1, deadline_s=None, now=0.0, queue_depth=0, queue_rows=0)
                ctl._tenant_burn = lambda tenant, spec: 20.0  # above the default fast burn, 14.4
                spec = value[0]
                walk = []
                for now in (0.0, 5.0, 11.0, 22.0):
                    ctl.evaluate(spec, now=now)
                    walk.append(ctl.level("t"))
                walks[name] = walk
            assert walks["port"] == walks["jax"] == [1, 1, 2, 3]
            registry = ModelRegistry()
            registry.load("km", port)
            with ScoringEngine(registry) as engine:  # starts with the spec set
                assert engine.score("km", feats).shape == (24,)
    finally:
        config.clear()
        config.update(saved)
        jcore.config.clear()
        jcore.config.update(jsaved)


# ------------------------------------------------- registry and admission ----


@pytest.mark.parametrize("kind", ["kmeans", "knn", "knn64"])
def test_admission_bytes_equal_jax(rng, kind):
    config["hbm_budget_bytes"] = jcore.config["hbm_budget_bytes"] = 10 ** 9
    if kind == "kmeans":
        port, jax_model = _kmeans_pair(_centers(rng, k=7, d=9))
    else:
        port, jax_model = _knn_pair(rng.normal(size=(120, 6)), k=5, float32_inputs=kind == "knn")
    cap = config["serve_max_batch_rows"]
    est = memory.model_serve_estimate(port, cap)
    jest = jmemory.model_serve_estimate(jax_model, cap)
    want = dict(jest.terms)
    if kind == "kmeans":
        # the port prices the argmin kernel's bf16 row tile where it is the
        # larger: [tile rows up to 128, depth up to 64] x 2 bytes (here
        # 256 x 64 x 2 = 32768 against JAX's [tile, k] block, 256 x 7 x 4)
        tile = min(config["distance_tile_rows"], cap)
        want["workspace.predict_tile"] = max(jest.terms["workspace.predict_tile"], -(-tile // 128) * 128 * 64 * 2)
    assert est.terms == want
    entry = ModelRegistry().load("m", port)
    jentry = JaxModelRegistry().load("m", jax_model)
    stamp, jstamp = port._serve_metrics["admission"], jax_model._serve_metrics["admission"]
    for key in ("estimate_bytes", "largest_term_bytes"):
        jstamp[key] += est.total() - jest.total()
    assert stamp == jstamp
    assert entry.resident_bytes == est.total()
    assert jentry.resident_bytes == jest.total()
    assert tledger.global_ledger().reserved_bytes() == est.total()


def test_eviction_under_pressure_stamps_and_frees(rng):
    m_a, m_b = _kmeans_pair(_centers(rng))[0], _kmeans_pair(_centers(rng, scale=3.0))[0]
    one = memory.model_serve_estimate(m_a, config["serve_max_batch_rows"]).total()
    config["hbm_budget_bytes"] = int(one * 1.5 / 0.9)  # fits one model, not two
    registry = ModelRegistry()
    registry.load("A", m_a)
    registry.load("B", m_b)
    assert "A" not in registry and "B" in registry
    stamp = m_a._serve_metrics["admission"]
    assert stamp["verdict"] == "evicted" and "pressure" in stamp["reason"]
    assert stamp["largest_term"] == "workspace.predict_tile"
    assert tledger.global_ledger().reserved_bytes() == one  # A's claim returned
    with pytest.raises(KeyError):
        registry.get("A")
    assert _counters()["serve.model_evictions"] == 1


def test_refused_load_is_typed_and_stamped(rng):
    config["hbm_budget_bytes"] = 2048  # below any model's working set
    model = _kmeans_pair(_centers(rng))[0]
    registry = ModelRegistry()
    with pytest.raises(errors.HbmBudgetError) as ei:
        registry.load("km", model)
    assert ei.value.largest_term == "workspace.predict_tile"
    assert ei.value.capacity_bytes == int(2048 * 0.9)
    stamp = model._serve_metrics["admission"]
    assert stamp["verdict"] == "refused"
    assert stamp["largest_term"] == ei.value.largest_term
    assert stamp["largest_term_bytes"] == ei.value.largest_term_bytes
    assert "km" not in registry and tledger.global_ledger().reserved_bytes() == 0


def test_lru_eviction_respects_serving_touch(rng):
    m_a, m_b, m_c = (_kmeans_pair(_centers(rng))[0] for _ in range(3))
    one = memory.model_serve_estimate(m_a, config["serve_max_batch_rows"]).total()
    config["hbm_budget_bytes"] = int(one * 2.5 / 0.9)  # fits two, not three
    registry = ModelRegistry()
    registry.load("A", m_a)
    registry.load("B", m_b)
    registry.get("A")  # touch: A becomes MRU, B is now the LRU victim
    registry.load("C", m_c)
    assert "A" in registry and "C" in registry and "B" not in registry


def test_reload_replaces_entry(rng):
    registry = ModelRegistry()
    m1, m2 = _kmeans_pair(_centers(rng))[0], _kmeans_pair(_centers(rng, k=4))[0]
    first = registry.load("km", m1)
    registry.load("km", m2)
    assert registry.get("km").model is m2
    assert first.program is None  # eviction nulls the program
    assert m1._serve_metrics["admission"]["verdict"] == "evicted"
    assert registry.names() == ["km"]


def test_doomed_load_evicts_nothing(rng):
    m_a = _kmeans_pair(_centers(rng))[0]
    one = memory.model_serve_estimate(m_a, config["serve_max_batch_rows"]).total()
    config["hbm_budget_bytes"] = int(one * 1.5 / 0.9)  # tight: fits one
    registry = ModelRegistry()
    registry.load("A", m_a)
    unbound = NearestNeighborsModel(n_cols=10)  # never fitted: no item set
    with pytest.raises(ValueError, match="not bound"):
        registry.load("nn", unbound)
    with pytest.raises(ValueError, match="serve_dtype='fp8'"):
        registry.load("A8", _kmeans_pair(_centers(rng))[0], serve_dtype="fp8")
    assert "A" in registry  # survived both doomed loads
    assert _counters().get("serve.model_evictions", 0) == 0


def test_load_places_on_the_card_unless_asked(rng, monkeypatch):
    parallel.set_devices(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    registry = ModelRegistry()
    with pytest.raises(RuntimeError, match=r'set_devices\("cpu"\)'):
        registry.load("km", _kmeans_pair(_centers(rng))[0])
    assert registry.names() == [] and tledger.global_ledger().reserved_bytes() == 0


def test_prewarm_dispatches_exactly_the_ladder(rng):
    model = _kmeans_pair(_centers(rng, d=11))[0]
    registry = ModelRegistry()
    entry = registry.load("km", model)
    ladder = entry.program.ladder(config["serve_prewarm_rows"])
    assert ladder == [8, 16, 32, 64] and entry.prewarmed_rungs == 4
    assert entry.program._shapes_seen == {(r, 11) for r in ladder}
    with ScoringEngine(registry) as engine:
        for n in (1, 5, 8, 13, 31, 64, 40):
            engine.score("km", rng.standard_normal((n, 11)).astype(np.float32))
    # ragged traffic inside the prewarmed range lands on prewarmed rungs only
    assert entry.program._shapes_seen == {(r, 11) for r in ladder}
    assert _counters()["serve.bucket_hits"] == 7


def test_out_of_memory_while_placing_is_typed(rng, monkeypatch):
    model = _kmeans_pair(_centers(rng))[0]

    def boom(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(PredictProgram, "prewarm", boom)
    registry = ModelRegistry()
    with pytest.raises(errors.HbmBudgetError, match="out of memory") as ei:
        registry.load("km", model)
    assert ei.value.largest_term == "workspace.predict_tile"
    assert tledger.global_ledger().reserved_bytes() == 0  # the claim returned
    assert memory.is_oom_error(torch.OutOfMemoryError("CUDA out of memory"))
    assert not memory.is_oom_error(ei.value) and not memory.is_oom_error(ValueError("x"))


# ------------------------------------------------- shared pieces against JAX ----


def test_predict_program_is_the_transform_path(rng):
    model = _kmeans_pair(_centers(rng))[0]
    q = rng.standard_normal((23, 10)).astype(np.float32)
    program = PredictProgram(model, cap=config["serve_max_batch_rows"])
    result, n_valid = program.dispatch(q)
    assert n_valid == 23 and isinstance(result, torch.Tensor) and result.shape == (32,)
    np.testing.assert_array_equal(program.fetch(result, n_valid), model._transform_arrays(q))
    np.testing.assert_array_equal(
        model._transform_arrays(q), np.asarray(_kmeans_pair(model.cluster_centers_)[1]._transform_arrays(q))
    )


_GRID = list(itertools.product(
    [0.0, 0.002], [None, 0.0, 0.002, 1.0], [None, 0.0, 100.0, 12800.0], [0, 128, 256, 10000],
))


@pytest.mark.parametrize("base,p99,rate,queue_rows", _GRID)
def test_batching_planners_equal_jax(base, p99, rate, queue_rows):
    kw = dict(floor_s=0.0005, ceiling_s=0.02, arrival_rows_per_s=rate,
              queue_rows=queue_rows, queue_wait_p99_s=p99, max_rows=256)
    assert toverload.plan_window(base, **kw) == joverload.plan_window(base, **kw)
    for congested in (False, True):
        tk = dict(min_rows=8, max_rows=256, queue_rows=queue_rows, arrival_rows_per_s=rate,
                  window_s=base, congested=congested)
        assert toverload.plan_target_rows(**tk) == joverload.plan_target_rows(**tk)


def test_errors_carry_the_jax_messages_and_attributes():
    cases = [
        ("HbmBudgetError", ("load does not fit",), dict(
            estimate_bytes=10, capacity_bytes=5, largest_term="placement.items",
            largest_term_bytes=8, terms={"placement.items": 8})),
        ("RequestTimeoutError", ("expired",), dict(
            model="km", deadline_ms=50.0, waited_ms=70.5, queue_depth=3, queue_rows=12)),
        ("ServeOverloadError", ("refused",), dict(
            model="km", tenant="t", level="healthy", queue_depth=2, queue_rows=9,
            predicted_wait_ms=120.0, deadline_ms=100.0)),
        ("ServingStoppedError", ("km",), dict(queue_position=4)),
    ]
    for name, args, kwargs in cases:
        port, ref = getattr(errors, name)(*args, **kwargs), getattr(jerrors, name)(*args, **kwargs)
        assert str(port) == str(ref)
        assert isinstance(port, errors.SrmlError)
        assert type(port).__mro__[2] is type(ref).__mro__[2]  # MemoryError, TimeoutError, ...
        for attr in kwargs:
            assert getattr(port, attr) == getattr(ref, attr)


def test_telemetry_helpers_equal_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 100):
        vals = list(rng.normal(size=n))
        for q in (0.0, 0.5, 0.99, 1.0):
            assert telemetry.quantile_of(vals, q) == jtele.quantile_of(vals, q)
    for tenant in ("default", "serving:km", "a b/c", ""):
        assert telemetry.tenant_metric("serve.e2e_s", tenant) == jtele.tenant_metric("serve.e2e_s", tenant)
    for v in (0.1, 0.3, 0.2):
        telemetry.registry().observe("x_s", v)
        jtele.registry().observe("x_s", v)
    assert telemetry.summarize_histogram("x_s") == {
        k: v for k, v in jtele.summarize_histogram("x_s").items()
    }
    assert telemetry.summarize_histogram("never_s")["p50"] is None
    telemetry.registry().inc("c", 5.0)
    assert telemetry.registry().rate("c", 10.0) == pytest.approx(0.5)
    assert telemetry.registry().rate("never") is None


def test_device_capacity_reads_total_memory_with_the_override_first(monkeypatch):
    class Props:
        total_memory = 80 * 2 ** 30

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    card = torch.device("cuda", 0)
    config["hbm_budget_bytes"] = None
    assert parallel.device_capacity_bytes(card) == 80 * 2 ** 30
    assert parallel.device_capacity_bytes(torch.device("cpu")) is None
    config["hbm_budget_bytes"] = 12345
    assert parallel.device_capacity_bytes(card) == 12345
    assert parallel.device_capacity_bytes(torch.device("cpu")) == 12345


@pytest.mark.parametrize("max_rows,min_rows,cap", [
    (1, 1, None), (64, 8, 256), (300, 8, 256), (4096, 256, 8192), (8192, 256, 8192), (10000, 7, 5000),
])
def test_bucket_ladder_equals_jax(max_rows, min_rows, cap):
    from spark_rapids_ml_tpu.parallel import mesh as jmesh

    assert parallel.bucket_ladder(max_rows, min_rows=min_rows, cap=cap) == jmesh.bucket_ladder(
        max_rows, min_rows=min_rows, cap=cap
    )
    x = np.ones((max_rows // 3 + 1, 2), np.float32)
    xp, n = parallel.bucket_rows(x, min_rows=min_rows, cap=cap)
    jxp, jn = jmesh.bucket_rows(x, min_rows=min_rows, cap=cap)
    assert n == jn and np.array_equal(xp, jxp)


def test_ledger_reserve_release_is_idempotent():
    led = tledger.HbmLedger()
    a = led.reserve("serve:A", "serve", 100)
    b = led.reserve("serve:B", "serve", 50)
    assert led.reserved_bytes() == 150 and a.active and a.rid != b.rid
    led.release(a)
    led.release(a)  # a second release credits nothing
    led.release(None)
    assert led.reserved_bytes() == 50 and not a.active and b.active
