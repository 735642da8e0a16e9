#
# The PyTorch port's serving overload control (spark_rapids_ml_tpu_torch/
# serving/overload.py, the degraded rung of serving/registry.py and
# serving/engine.py, parallel/chaos.py's serve hooks) against the JAX
# package's on the same inputs, made with numpy from a seed. Both run on the
# CPU: the port through its plain PyTorch versions (set_devices("cpu")).
#
# Tolerances: ladder walks, audit records (all keys but the time "t"),
# token-bucket verdicts, planner outputs and refusal attributes equal
# exactly; a degraded response equals the same rows served by a registry
# that loaded the model at serve_dtype="bf16" bit for bit, and the JAX
# package's degraded response exactly (KMeans ids; kNN ids, with distances
# to rtol 1e-5, on items far apart). The burst case runs at the JAX
# package's own test scale and margins (tests/test_serving_overload.py).
#
import itertools
import time

import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu import errors as jerrors
from spark_rapids_ml_tpu import telemetry as jtele
from spark_rapids_ml_tpu.models.clustering import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu.models.knn import NearestNeighbors as JaxNearestNeighbors
from spark_rapids_ml_tpu.ops_plane import audit as jaudit
from spark_rapids_ml_tpu.ops_plane import slo as jslo
from spark_rapids_ml_tpu.serving import ModelRegistry as JaxModelRegistry
from spark_rapids_ml_tpu.serving import ScoringEngine as JaxScoringEngine
from spark_rapids_ml_tpu.serving import overload as joverload
from spark_rapids_ml_tpu_torch import KMeansModel, ModelRegistry, NearestNeighbors, ScoringEngine, errors, parallel, telemetry
from spark_rapids_ml_tpu_torch.core import config
from spark_rapids_ml_tpu_torch.ops import distance as tdist
from spark_rapids_ml_tpu_torch.ops_plane import audit as taudit
from spark_rapids_ml_tpu_torch.ops_plane import slo as tslo
from spark_rapids_ml_tpu_torch.parallel import chaos
from spark_rapids_ml_tpu_torch.scheduler import ledger as tledger
from spark_rapids_ml_tpu_torch.serving import overload as toverload

_KEYS = (
    "transform_bucket_min_rows", "serve_prewarm_rows", "serve_max_batch_rows", "serve_coalesce_window_ms",
    "serve_default_deadline_ms", "serve_max_queue_rows", "serve_adaptive_batching", "serve_overload_hold_s",
    "serve_throttle_rows_per_s", "serve_degraded_dtype", "slo", "metrics_bucket_seconds",
    "metrics_bucket_count", "hbm_budget_bytes",
)
_SMALL = {
    "transform_bucket_min_rows": 8, "serve_prewarm_rows": 64, "serve_max_batch_rows": 256,
    "serve_coalesce_window_ms": 5.0, "slo": [],
}
PACKAGES = {
    "port": (toverload, taudit, telemetry),
    "jax": (joverload, jaudit, jtele),
}


@pytest.fixture(autouse=True)
def env(monkeypatch):
    """The port on the CPU, the same small ladder and overload knobs on both
    sides, telemetry on with fresh registries, empty decision logs and SLO
    state, a fresh shared ledger, no chaos plan."""
    parallel.set_devices("cpu")
    saved = {k: config[k] for k in _KEYS}
    jsaved = {k: jcore.config[k] for k in _KEYS}
    config.update(_SMALL)
    jcore.config.update(_SMALL)
    monkeypatch.setattr(tledger, "_GLOBAL", tledger.HbmLedger())
    for tel in (telemetry, jtele):
        tel.registry().reset()
        tel.enable()
    for mod in (taudit, jaudit):
        mod.clear()
    for mod in (tslo, jslo):
        mod.reset()
    yield
    chaos.clear_fault_plan()
    for tel in (telemetry, jtele):
        tel.disable()
        tel.registry().reset()
    config.update(saved)
    jcore.config.update(jsaved)
    for mod in (tslo, jslo):
        mod.reset()
    parallel.set_devices(None)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _both(key, value):
    config[key] = jcore.config[key] = value


def _spec(**over):
    spec = {
        "name": "serving_p99", "kind": "latency", "histogram": "serve.e2e_s",
        "threshold_s": 0.1, "objective": 0.5, "fast_window_s": 1.0, "fast_burn": 1.0,
    }
    spec.update(over)
    return spec


def _records(audit_mod, **query):
    return [{k: v for k, v in r.items() if k != "t"} for r in audit_mod.decisions(**query)]


def _kmeans_pair(rng, k=4, d=8, scale=50.0):
    centers = (rng.standard_normal((k, d)) * scale).astype(np.float32)
    return (
        KMeansModel(cluster_centers_=centers, n_cols=d, dtype="float32"),
        JaxKMeansModel(cluster_centers_=centers, n_cols=d, dtype="float32"),
    )


def _knn_pair(items, k=3, float32_inputs=False):
    df = pd.DataFrame({"features": list(items), "id": np.arange(500, 500 + len(items))})
    return [
        cls(k=k, float32_inputs=float32_inputs).setInputCol("features").setIdCol("id").fit(df)
        for cls in (NearestNeighbors, JaxNearestNeighbors)
    ]


# ------------------------------------------------------------- the ladder ----


_BURN_SCRIPTS = {
    # (hold, [(now, burn), ...]): burning, inside the hold, one rung a dwell,
    # clear, no flap, restore one rung a dwell
    "walk_up_and_down": (10.0, [(0, 5.0), (5, 5.0), (11, 5.0), (15, 0.0), (22, 0.0), (23, 0.0), (33, 0.0)]),
    "to_shed_and_back": (1.0, [(0, 3.0), (1, 3.0), (2, 3.0), (3, 3.0), (4, None), (5, 0.5), (6, 0.2), (7, 0.0)]),
    "idle_never_escalates": (0.0, [(1, None), (2, None), (3, 0.99)]),
    "flapping_burn": (2.0, [(0, 2.0), (0.5, 0.0), (1.0, 2.0), (2.5, 0.0), (4.6, 2.0), (5, 2.0), (7, 0.0)]),
}


@pytest.mark.parametrize("script", sorted(_BURN_SCRIPTS))
def test_scripted_burns_walk_and_audit_like_jax(script):
    hold, steps = _BURN_SCRIPTS[script]
    _both("serve_overload_hold_s", hold)
    spec = _spec()
    walks, records, stats, counters = {}, {}, {}, {}
    for name, (mod, audit_mod, tel) in PACKAGES.items():
        ctl = mod.OverloadController()
        for tenant in ("acme", "zeta"):
            ctl.admit(model="m", tenant=tenant, rows=1, deadline_s=None, now=0.0, queue_depth=0, queue_rows=0)
        burns = {"v": None}
        # the scripting seam: acme burns as scripted, zeta at half of it
        ctl._tenant_burn = lambda tenant, spec, b=burns: (
            None if b["v"] is None else (b["v"] if tenant == "acme" else b["v"] / 2)
        )
        walk = []
        for now, burn in steps:
            burns["v"] = burn
            ctl.evaluate(spec, now=float(now))
            walk.append((ctl.level("acme"), ctl.level("zeta")))
        walks[name] = walk
        records[name] = _records(audit_mod, kind="backpressure")
        stats[name] = {t: {k: v for k, v in s.items() if k != "dwell_s"} for t, s in ctl.stats().items()}
        snap = tel.registry().snapshot()
        counters[name] = (
            snap["counters"].get("serve.backpressure_transitions"),
            {k: v for k, v in snap["gauges"].items() if k.startswith("serve.overload_level")},
        )
    assert walks["port"] == walks["jax"]
    assert records["port"] == records["jax"]
    assert stats["port"] == stats["jax"]
    assert counters["port"] == counters["jax"]
    if script != "idle_never_escalates":
        assert records["port"], "the script should move the ladder"


def test_ladder_hysteresis_one_rung_per_hold_no_flap():
    # the JAX package's own walk (tests/test_serving_overload.py), on the port
    _both("serve_overload_hold_s", 10.0)
    ctl = toverload.OverloadController()
    ctl.admit(model="m", tenant="acme", rows=1, deadline_s=None, now=0.0, queue_depth=0, queue_rows=0)
    burn = {"v": 5.0}
    ctl._tenant_burn = lambda tenant, spec: burn["v"]
    expect = [(0.0, 1), (5.0, 1), (11.0, 2), (15.0, 2, 0.0), (22.0, 1), (23.0, 1), (33.0, 0)]
    for step in expect:
        if len(step) == 3:
            burn["v"] = step[2]
        ctl.evaluate(_spec(), now=step[0])
        assert ctl.level("acme") == step[1]
    assert [r["verdict"] for r in taudit.decisions(kind="backpressure", tenant="acme")] == [
        "throttle", "degrade", "restore", "restore",
    ]
    assert ctl.stats()["acme"]["transitions"] == 4


def test_global_failing_spec_escalates_every_tenant_with_traffic():
    # a fleet-wide burn (the global verdict failing) escalates a tenant
    # whose own burn is below the factor, on both sides
    walks = {}
    for name, (mod, _, _) in PACKAGES.items():
        ctl = mod.OverloadController()
        ctl.admit(model="m", tenant="t", rows=1, deadline_s=None, now=0.0, queue_depth=0, queue_rows=0)
        ctl._tenant_burn = lambda tenant, spec: 0.1
        ctl._global_failing = lambda spec: True
        ctl.evaluate(_spec(), now=0.0)
        walks[name] = ctl.level("t")
    assert walks["port"] == walks["jax"] == toverload.LEVEL_THROTTLE


@pytest.mark.parametrize("rate,seed", [(100.0, 0), (37.5, 1), (1000.0, 2)])
def test_token_bucket_accepts_and_refuses_like_jax(rate, seed):
    _both("serve_throttle_rows_per_s", rate)
    gen = np.random.default_rng(seed)
    rows = gen.integers(1, int(rate * 0.6) + 2, size=40)
    times = np.cumsum(gen.exponential(0.15, size=40))
    verdicts = {}
    for name, (mod, _, _) in PACKAGES.items():
        ctl = mod.OverloadController()
        ctl.admit(model="m", tenant="t", rows=1, deadline_s=None, now=0.0, queue_depth=0, queue_rows=0)
        ctl.force_level("t", mod.LEVEL_THROTTLE)
        out = []
        for r, now in zip(rows, times):
            try:
                ctl.admit(model="m", tenant="t", rows=int(r), deadline_s=None, now=float(now),
                          queue_depth=0, queue_rows=0)
                out.append(True)
            except (errors.ServeOverloadError, jerrors.ServeOverloadError) as e:
                assert e.level == "throttle" and e.tenant == "t"
                out.append(False)
        verdicts[name] = (out, ctl.stats()["t"]["throttled_requests"])
    assert verdicts["port"] == verdicts["jax"]
    assert 0 < verdicts["port"][1] < 40


def test_token_bucket_auto_rate_meters_nothing_without_a_rate():
    # rate 0 = auto: half the tenant's windowed row rate; none measured yet
    # means no metering (the ladder just escalated), on both sides
    _both("serve_throttle_rows_per_s", 0.0)
    for mod, _, _ in PACKAGES.values():
        ctl = mod.OverloadController()
        ctl.admit(model="m", tenant="t", rows=1, deadline_s=None, now=0.0, queue_depth=0, queue_rows=0)
        ctl.force_level("t", mod.LEVEL_THROTTLE)
        for i in range(5):
            assert ctl.admit(model="m", tenant="t", rows=10 ** 5, deadline_s=None, now=float(i),
                             queue_depth=0, queue_rows=0) is False


@pytest.mark.parametrize("base,p99,rate,queue_rows,min_rows", list(itertools.product(
    [0.0, 0.004], [None, 0.003, 2.0], [None, 50.0, 25600.0], [0, 64, 300], [4, 8],
)))
def test_batching_planners_unchanged(base, p99, rate, queue_rows, min_rows):
    kw = dict(floor_s=0.001, ceiling_s=0.05, arrival_rows_per_s=rate, queue_rows=queue_rows,
              queue_wait_p99_s=p99, max_rows=300)
    window = toverload.plan_window(base, **kw)
    assert window == joverload.plan_window(base, **kw)
    for congested in (False, True):
        tk = dict(min_rows=min_rows, max_rows=300, queue_rows=queue_rows, arrival_rows_per_s=rate,
                  window_s=window, congested=congested)
        assert toverload.plan_target_rows(**tk) == joverload.plan_target_rows(**tk)


def test_levels_and_names_equal_jax():
    assert toverload.LEVELS == joverload.LEVELS
    for name in ("LEVEL_HEALTHY", "LEVEL_THROTTLE", "LEVEL_DEGRADE", "LEVEL_SHED"):
        assert getattr(toverload, name) == getattr(joverload, name)


# ------------------------------------------------------ the degraded rung ----


def test_degraded_kmeans_equals_bf16_serving_and_jax(rng):
    _both("serve_degraded_dtype", "bf16")
    _both("serve_throttle_rows_per_s", 1e9)  # degrade sits above throttle: meter nothing
    port, jax_model = _kmeans_pair(rng)
    feats = (rng.standard_normal((40, 8)) * 20).astype(np.float32)
    ref = ModelRegistry()
    ref.load("km16", port, serve_dtype="bf16")
    with ScoringEngine(ref) as engine:
        expect = engine.score("km16", feats)
    got = {}
    for name, reg_cls, eng_cls, model in (
        ("port", ModelRegistry, ScoringEngine, port), ("jax", JaxModelRegistry, JaxScoringEngine, jax_model),
    ):
        registry = reg_cls()
        entry = registry.load("km", model)
        assert entry.degraded_dtype == "bf16" and entry.degraded_program is not None
        with eng_cls(registry) as engine:
            engine._overload.force_level("default", toverload.LEVEL_DEGRADE)
            got[name] = np.asarray(engine.score("km", feats))
    assert got["port"].dtype == expect.dtype
    np.testing.assert_array_equal(got["port"], expect)  # bit for bit
    np.testing.assert_array_equal(got["port"], got["jax"])
    counters = telemetry.registry().snapshot()["counters"]
    assert counters["serve.degraded_requests"] == 1 and counters["serve.degraded_rows"] == 40


def test_degraded_float64_knn_runs_the_fast_d2_block_and_equals_bf16_serving(rng, monkeypatch):
    _both("serve_degraded_dtype", "bf16")
    _both("serve_throttle_rows_per_s", 1e9)
    # items on a coarse lattice: neighbor gaps far above bf16 rounding
    items = (rng.integers(-4, 5, size=(90, 6)) * 10.0).astype(np.float64)
    items += rng.normal(scale=0.01, size=items.shape)
    port, jax_model = _knn_pair(items)
    q = items[:9] + 0.05
    seen = []
    real = tdist.d2_block
    monkeypatch.setattr(
        tdist, "d2_block",
        lambda qq, *a, **kw: seen.append((qq.dtype, kw.get("fast"))) or real(qq, *a, **kw),
    )
    ref = ModelRegistry(prewarm=False)
    ref.load("knn16", port, serve_dtype="bf16")
    with ScoringEngine(ref) as engine:
        expect = engine.score("knn16", q)
    seen.clear()
    got = {}
    for name, reg_cls, eng_cls, model in (
        ("port", ModelRegistry, ScoringEngine, port), ("jax", JaxModelRegistry, JaxScoringEngine, jax_model),
    ):
        registry = reg_cls(prewarm=False)
        entry = registry.load("knn", model)
        assert entry.degraded_dtype == "bf16"
        with eng_cls(registry) as engine:
            primary = engine.score("knn", q)
            engine._overload.force_level("default", toverload.LEVEL_DEGRADE)
            got[name] = engine.score("knn", q)
        if name == "port":
            import torch

            # the primary rung ran the float64 form, the degraded rung its fast one
            assert seen == [(torch.float64, False), (torch.float64, True)]
            assert primary[0].dtype == np.float64
    for g, e in zip(got["port"], expect):
        assert g.dtype == e.dtype and np.array_equal(g, e)  # bit for bit
    np.testing.assert_array_equal(got["port"][1], np.asarray(got["jax"][1]))
    # each side's cross term is a float32 sum of 6 exact bf16 products, in
    # its own order: the squared distances agree within the float32
    # summation bound, 4 * d * 2^-24 * max|q| * max|x|
    tol = 4 * 6 * 2.0 ** -24 * np.linalg.norm(q, axis=1).max() * np.linalg.norm(items, axis=1).max()
    np.testing.assert_allclose(got["port"][0] ** 2, np.asarray(got["jax"][0]) ** 2, rtol=0, atol=tol)


def test_degraded_admission_charges_the_second_copy_and_releases_it(rng):
    items = rng.normal(size=(70, 6))
    port, _ = _knn_pair(items)
    plain = ModelRegistry().load("a", port)
    primary_bytes = plain.resident_bytes
    _both("serve_degraded_dtype", "bf16")
    registry = ModelRegistry()
    entry = registry.load("knn", port)
    deg = entry.degraded_admission.estimate.terms
    assert entry.resident_bytes == primary_bytes + entry.degraded_admission.estimate.total()
    assert deg["placement.items"] == 70 * 6 * 8  # its own copy of the float64 items
    assert deg["workspace.fast_staging_items"] > 0 and deg["workspace.fast_staging_q"] > 0
    held = tledger.global_ledger().reserved_bytes()
    registry.evict("knn")
    assert tledger.global_ledger().reserved_bytes() == held - entry.resident_bytes
    assert entry.degraded_program is None and entry.program is None
    evictions = _records(taudit, kind="eviction")
    assert evictions[-1]["subject"] == "knn" and evictions[-1]["detail"]["estimate_bytes"] == entry.resident_bytes


def test_refused_degraded_admission_serves_without_the_rung_like_jax(rng, monkeypatch):
    # a budget the primary program fits and the primary + degraded copy do
    # not: the load succeeds without the rung (logged), and a tenant at the
    # degrade level is served by the primary program, counted as no
    # degraded request, on both sides
    _both("serve_degraded_dtype", "bf16")
    port, jax_model = _kmeans_pair(rng, k=64, d=32)
    probe = ModelRegistry().load("probe", port)
    need = probe.admission.estimate.total()
    monkeypatch.setattr(tledger, "_GLOBAL", tledger.HbmLedger())
    feats = (rng.standard_normal((16, 32)) * 20).astype(np.float32)
    budget = int(1.5 * need / (1.0 - config.get("hbm_headroom_fraction", 0.1)))
    out = {}
    for name, reg_cls, eng_cls, model in (
        ("port", ModelRegistry, ScoringEngine, port), ("jax", JaxModelRegistry, JaxScoringEngine, jax_model),
    ):
        _both("hbm_budget_bytes", budget)
        registry = reg_cls()
        entry = registry.load("km", model)
        assert entry.degraded_program is None and entry.degraded_dtype is None
        with eng_cls(registry) as engine:
            engine._overload.force_level("default", toverload.LEVEL_DEGRADE)
            out[name] = np.asarray(engine.score("km", feats))
        registry.clear()
    np.testing.assert_array_equal(out["port"], out["jax"])
    np.testing.assert_array_equal(out["port"], port._transform_arrays(feats))
    assert telemetry.registry().snapshot()["counters"].get("serve.degraded_requests", 0) == 0
    refusals = [r for r in _records(taudit, kind="admission") if r["verdict"] == "refused"]
    assert refusals and refusals[-1]["tenant"] == "serving:km"


def test_reloaded_model_without_the_rung_falls_back_counted(rng, monkeypatch):
    # a degraded request whose entry lost its rung (a reload without one)
    # runs on the primary program and is counted as a fallback
    _both("serve_degraded_dtype", "bf16")
    _both("serve_throttle_rows_per_s", 1e9)
    port, _ = _kmeans_pair(rng)
    registry = ModelRegistry()
    registry.load("km", port)
    feats = (rng.standard_normal((8, 8)) * 20).astype(np.float32)
    with ScoringEngine(registry, coalesce_window_s=0.0) as engine:
        engine._overload.force_level("default", toverload.LEVEL_DEGRADE)
        entry = registry.get("km")
        real = entry.program.dispatch
        started = __import__("threading").Event()
        release = __import__("threading").Event()

        def slow(xb):
            started.set()
            release.wait(30)
            return real(xb)

        monkeypatch.setattr(entry.degraded_program, "dispatch", slow)
        first = engine.submit("km", feats)
        assert started.wait(30)
        second = engine.submit("km", feats)  # queued as degraded
        assert second.degraded
        config["serve_degraded_dtype"] = None
        registry.load("km", port)  # reloaded: no rung now
        release.set()
        first.result(30)
        np.testing.assert_array_equal(second.result(30), port._transform_arrays(feats))
    counters = telemetry.registry().snapshot()["counters"]
    assert counters["serve.degraded_fallbacks"] == 1


def test_coalescing_keeps_degraded_and_primary_apart(rng):
    _both("serve_degraded_dtype", "bf16")
    _both("serve_throttle_rows_per_s", 1e9)
    port, _ = _kmeans_pair(rng)
    registry = ModelRegistry()
    registry.load("km", port)
    feats = [(rng.standard_normal((n, 8)) * 20).astype(np.float32) for n in (3, 5, 7, 9)]
    with ScoringEngine(registry, coalesce_window_s=1.0) as engine:  # a wide window: all four queue first
        engine._overload.force_level("slow", toverload.LEVEL_DEGRADE)
        futs = [engine.submit("km", f, tenant=("slow" if i % 2 else "fast")) for i, f in enumerate(feats)]
        outs = [f.result(30) for f in futs]
    assert [f.degraded for f in futs] == [False, True, False, True]
    counters = telemetry.registry().snapshot()["counters"]
    assert counters["serve.batches"] == 2 and counters["serve.degraded_requests"] == 2
    for f, o in zip(feats, outs):
        np.testing.assert_array_equal(o, port._transform_arrays(f))  # far apart: bf16 = f32 here


# ------------------------------------------------------- typed refusals ----


@pytest.mark.parametrize("level", ["shed", "throttle"])
def test_shed_and_throttle_refuse_typed_like_jax(rng, level):
    _both("serve_throttle_rows_per_s", 10.0)
    port, jax_model = _kmeans_pair(rng)
    feats = (rng.standard_normal((16, 8))).astype(np.float32)
    errs = {}
    for name, reg_cls, eng_cls, model, mod, tel in (
        ("port", ModelRegistry, ScoringEngine, port, toverload, telemetry),
        ("jax", JaxModelRegistry, JaxScoringEngine, jax_model, joverload, jtele),
    ):
        registry = reg_cls()
        registry.load("km", model)
        with eng_cls(registry) as engine:
            engine._overload.force_level("t", getattr(mod, f"LEVEL_{level.upper()}"))
            with pytest.raises((errors.ServeOverloadError, jerrors.ServeOverloadError)) as ei:
                engine.submit("km", feats, tenant="t")
        e = ei.value
        counters = tel.registry().snapshot()["counters"]
        errs[name] = (str(e), e.level, e.tenant, e.model, e.queue_depth, e.queue_rows,
                      counters.get(f"serve.{'shed' if level == 'shed' else 'throttled'}_requests"))
    assert isinstance(ei.value, jerrors.ServeOverloadError)
    assert errs["port"] == errs["jax"]
    assert errs["port"][1] == level


def test_stats_and_serving_report_have_the_jax_keys(rng):
    from spark_rapids_ml_tpu import ops_plane as jops
    from spark_rapids_ml_tpu_torch import ops_plane as tops

    port, jax_model = _kmeans_pair(rng)
    views = {}
    for name, reg_cls, eng_cls, model, ops in (
        ("port", ModelRegistry, ScoringEngine, port, tops),
        ("jax", JaxModelRegistry, JaxScoringEngine, jax_model, jops),
    ):
        registry = reg_cls()
        registry.load("km", model)
        with eng_cls(registry) as engine:
            for _ in range(3):
                engine.submit("km", rng.standard_normal((8, 8)).astype(np.float32), tenant="acme").result(30)
            stats = engine.stats()
            report = ops.report()
        views[name] = (stats, report["serving"]["tenants"]["acme"])
    (pstats, prep), (jstats, jrep) = views["port"], views["jax"]
    assert set(jstats) <= set(pstats)
    assert set(pstats["tenants"]["acme"]) == set(jstats["tenants"]["acme"])
    assert set(prep) == set(jrep)
    for key in ("level", "transitions", "shed_requests", "throttled_requests", "degraded_requests"):
        assert pstats["tenants"]["acme"][key] == jstats["tenants"]["acme"][key]
        assert prep[key] == jrep[key]
    assert pstats["tenants"]["acme"]["e2e_p50_s"] is not None


# ------------------------------------------------------------ e2e burst ----


def test_burst_escalates_audits_and_recovers(rng):
    """The saturation story at the JAX package's test scale and margins: a
    chaos-planned burst drives a healthy tenant into refusals, every ladder
    verdict lands in the audit log, no expired request ever dispatches, and
    clearing the load restores the tenant to healthy through the submit-path
    hook."""
    config["metrics_bucket_seconds"] = 0.2
    config["metrics_bucket_count"] = 20
    telemetry.registry().reset()  # the window geometry binds at first record
    config["serve_max_batch_rows"] = 16
    config["serve_coalesce_window_ms"] = 2.0
    config["serve_overload_hold_s"] = 0.25
    config["serve_default_deadline_ms"] = 600.0
    config["slo"] = [_spec(threshold_s=0.25, fast_window_s=0.6)]
    centers = (rng.standard_normal((4, 8)) * 10.0).astype(np.float32)
    model = KMeansModel(cluster_centers_=centers, n_cols=8, dtype="float32")
    registry = ModelRegistry()
    registry.load("km", model)
    chaos.set_fault_plan("delay:stage=serve:seconds=0.02:times=100000;burst:stage=serve:rows=2000:seconds=1")
    fault = chaos.maybe_burst_stage("serve")
    assert fault is not None and fault.rows == 2000
    refusals, futs = [], []
    pool = [rng.standard_normal((16, 8)).astype(np.float32) for _ in range(8)]
    with ScoringEngine(registry) as engine:
        t_next = time.monotonic()
        t_end = t_next + fault.seconds
        i = 0
        while time.monotonic() < t_end:
            try:
                futs.append(engine.submit("km", pool[i % len(pool)]))
            except errors.ServeOverloadError as e:
                refusals.append(e)
            i += 1
            t_next += 16 / fault.rows
            delay = t_next - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        outcomes = {"ok": 0, "expired": 0}
        for f in futs:
            try:
                f.result(timeout=10.0)
                outcomes["ok"] += 1
            except errors.RequestTimeoutError:
                outcomes["expired"] += 1
        chaos.clear_fault_plan()
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            try:
                engine.submit("km", pool[0][:4], deadline_ms=5000.0).result(timeout=10.0)
            except errors.ServeOverloadError as e:
                refusals.append(e)
            if engine.stats()["tenants"]["default"]["level"] == "healthy":
                break
            time.sleep(0.05)
        final = engine.stats()
    counters = telemetry.registry().snapshot()["counters"]
    transitions = int(counters["serve.backpressure_transitions"])
    assert transitions >= 2  # at least one escalation and one restore
    assert len(refusals) + outcomes["expired"] + int(counters.get("serve.rejected_requests", 0)) > 0
    assert outcomes["ok"] > 0
    assert all(e.level in toverload.LEVELS for e in refusals)
    assert counters.get("serve.overdeadline_dispatches", 0) == 0
    audited = taudit.decisions(kind="backpressure")
    assert len(audited) == transitions
    assert {a["verdict"] for a in audited} <= set(toverload.LEVELS[1:]) | {"restore"}
    assert final["tenants"]["default"]["level"] == "healthy"
