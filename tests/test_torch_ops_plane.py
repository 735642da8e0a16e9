#
# The PyTorch port's ops plane (spark_rapids_ml_tpu_torch/ops_plane/: the
# audit log, SLO monitors, the exporters, drift statistics, report(); the
# registry's rolling windows in telemetry.py; the audit records of
# memory.py's verdicts) against the JAX package's on the same inputs, made
# with numpy from a seed, on the CPU.
#
# Tolerances: audit records equal in every key but the time "t"; SLO
# verdicts, burn rates, window reads and Prometheus text equal exactly for
# the same observations; drift statistics equal exactly (the same float64
# numpy arithmetic on the same chunks); fit-admission records equal in
# kind, subsystem, verdict, subject and tenant (the port sizes its own
# chunks, so their bytes may differ by design).
#
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu import ops_plane as jops
from spark_rapids_ml_tpu import telemetry as jtele
from spark_rapids_ml_tpu.data import extract_dataset as jextract
from spark_rapids_ml_tpu.data import validate_extracted as jvalidate
from spark_rapids_ml_tpu.models.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.models.clustering import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu.ops_plane import audit as jaudit
from spark_rapids_ml_tpu.ops_plane import drift as jdrift
from spark_rapids_ml_tpu.ops_plane import export as jexport
from spark_rapids_ml_tpu.ops_plane import slo as jslo
from spark_rapids_ml_tpu.scheduler import ledger as jledger
from spark_rapids_ml_tpu.serving import ModelRegistry as JaxModelRegistry
from spark_rapids_ml_tpu_torch import KMeans, KMeansModel, ModelRegistry, diagnostics, parallel, telemetry
from spark_rapids_ml_tpu_torch import ops_plane as tops
from spark_rapids_ml_tpu_torch.core import config
from spark_rapids_ml_tpu_torch.data import extract_dataset as textract
from spark_rapids_ml_tpu_torch.data import validate_extracted as tvalidate
from spark_rapids_ml_tpu_torch.ops_plane import audit as taudit
from spark_rapids_ml_tpu_torch.ops_plane import drift as tdrift
from spark_rapids_ml_tpu_torch.ops_plane import export as texport
from spark_rapids_ml_tpu_torch.ops_plane import slo as tslo
from spark_rapids_ml_tpu_torch.scheduler import ledger as tledger

_KEYS = ("metrics_bucket_seconds", "metrics_bucket_count", "slo", "hbm_budget_bytes", "ingest_chunk_bytes",
         "validate_ingest", "stream_chunk_rows", "ops_snapshot_dir", "transform_bucket_min_rows",
         "serve_prewarm_rows", "serve_max_batch_rows")
SIDES = {
    "port": dict(tel=telemetry, audit=taudit, slo=tslo, export=texport, drift=tdrift, ops=tops,
                 extract=textract, validate=tvalidate),
    "jax": dict(tel=jtele, audit=jaudit, slo=jslo, export=jexport, drift=jdrift, ops=jops,
                extract=jextract, validate=jvalidate),
}


@pytest.fixture(autouse=True)
def env(monkeypatch):
    """Both registries fresh and on, with the same fast windows (1 s
    horizon); empty decision logs and SLO state; the port on the CPU;
    fresh shared ledgers; no drift baseline."""
    parallel.set_devices("cpu")
    saved = {k: config[k] for k in _KEYS}
    jsaved = {k: jcore.config[k] for k in _KEYS}
    for cfg in (config, jcore.config):
        cfg.update(metrics_bucket_seconds=0.5, metrics_bucket_count=4, slo=[])
    monkeypatch.setattr(tledger, "_GLOBAL", tledger.HbmLedger())
    monkeypatch.setattr(jledger, "_GLOBAL", jledger.HbmLedger(), raising=False)
    for side in SIDES.values():
        side["tel"].registry().reset()
        side["tel"].enable()
        side["audit"].clear()
        side["slo"].reset()
        side["drift"].clear_baseline()
    yield
    for side in SIDES.values():
        side["tel"].disable()
        side["tel"].registry().reset()
        side["slo"].reset()
        side["drift"].clear_baseline()
        side["audit"].clear()
    config.update(saved)
    jcore.config.update(jsaved)
    parallel.set_devices(None)


def _strip(records):
    return [{k: v for k, v in r.items() if k != "t"} for r in records]


def _observe_both(name, values):
    for side in SIDES.values():
        for v in values:
            side["tel"].registry().observe(name, float(v))


# --------------------------------------------------------------- audit ------


_DECISIONS = [
    ("admission", "fit", "resident", dict(subject="KMeans", tenant="t1", reason="fits", estimate_bytes=10)),
    ("demotion", "fit", "stream", dict(subject="PCA", reason="over", chunk_rows=256)),
    ("eviction", "serving", "evicted", dict(subject="km", tenant="serving:km", reason="explicit evict")),
    ("backpressure", "serving", "shed", dict(subject="acme", tenant="acme", from_level="degrade", to_level="shed",
                                              burn=3.5)),
    ("admission", "serving", "refused", dict(subject="KMeansModel", tenant="serving:x", largest_term="placement.items")),
]


@pytest.mark.parametrize("trace_id", [None, "run-42"])
def test_audit_records_and_queries_equal_jax(trace_id, monkeypatch):
    if trace_id is None:
        monkeypatch.delenv("SRML_TRACE_ID", raising=False)
    else:
        monkeypatch.setenv("SRML_TRACE_ID", trace_id)
    out = {}
    for name, side in SIDES.items():
        recs = [side["audit"].record_decision(k, s, v, **kw) for k, s, v, kw in _DECISIONS]
        a = side["audit"]
        out[name] = (
            _strip(recs),
            _strip(a.decisions()),
            _strip(a.decisions(tenant="acme")),
            _strip(a.decisions(kind="admission", subsystem="serving")),
            _strip(a.decisions(trace_id=trace_id or "none")),
            _strip(a.decisions(limit=2)),
            _strip(a.decisions(limit=0)),
            {k: v for k, v in a.stats().items()},
            side["tel"].registry().snapshot()["counters"].get("ops.decisions_recorded"),
        )
    assert out["port"] == out["jax"]
    assert out["port"][0][1]["tenant"] == "default"  # no tenant given: "default"


def test_audit_records_regardless_of_telemetry_and_counts_drops(monkeypatch):
    from collections import deque

    for side in SIDES.values():
        side["tel"].disable()
        monkeypatch.setattr(side["audit"], "_LOG", deque(maxlen=3))
    for name, side in SIDES.items():
        for i in range(5):
            side["audit"].record_decision("admission", "fit", "resident", subject=f"s{i}")
    assert taudit.stats() == jaudit.stats() == {"capacity": 3, "recorded": 5, "retained": 3, "dropped": 2}
    assert [r["subject"] for r in taudit.decisions()] == ["s2", "s3", "s4"]


def test_rank_and_trace_tags_equal_jax(monkeypatch):
    from spark_rapids_ml_tpu import diagnostics as jdiag

    for rank, trace in ((None, None), ("3", "abc"), ("x", "")):
        for key, val in (("SRML_RANK", rank), ("SRML_TRACE_ID", trace)):
            if val is None:
                monkeypatch.delenv(key, raising=False)
            else:
                monkeypatch.setenv(key, val)
        assert diagnostics._rank() == jdiag._rank()
        assert diagnostics.trace_tags() == jdiag.trace_tags()


def test_fit_admission_verdicts_land_in_the_audit_log_like_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2000, 6))
    out = {}
    for budget in (None, 140_000, 1_000):
        for cfg in (config, jcore.config):
            cfg.update(hbm_budget_bytes=budget, stream_chunk_rows=512)
        for name, est in (("port", KMeans(k=4, maxIter=3, float32_inputs=False)),
                          ("jax", JaxKMeans(k=4, maxIter=3, float32_inputs=False, num_workers=1))):
            try:
                est.fit({"features": x})
            except Exception as e:  # the refusal: typed in both packages
                assert type(e).__name__ == "HbmBudgetError"
    for name, side in SIDES.items():
        out[name] = [
            (r["kind"], r["subsystem"], r["verdict"], r["subject"], r["tenant"], sorted(r.get("detail", {})))
            for r in side["audit"].decisions(subsystem="fit")
        ]
    assert out["port"] == out["jax"]
    assert [v[2] for v in out["port"]] == ["resident", "stream", "refused"]
    assert out["port"][1][0] == "demotion"


def test_serving_load_and_eviction_records_equal_jax():
    # k = 64 at d = 7: the reference's [tile, k] workspace is the larger of
    # the port's two predict terms, so the estimates are equal
    centers = np.random.default_rng(4).normal(size=(64, 7)).astype(np.float32)
    for cfg in (config, jcore.config):
        cfg.update(hbm_budget_bytes=10 ** 9, transform_bucket_min_rows=8, serve_prewarm_rows=0,
                   serve_max_batch_rows=256)
    for reg_cls, model_cls in ((ModelRegistry, KMeansModel), (JaxModelRegistry, JaxKMeansModel)):
        registry = reg_cls()
        registry.load("km", model_cls(cluster_centers_=centers, n_cols=7, dtype="float32"))
        registry.evict("km")
    assert _strip(taudit.decisions(subsystem="serving")) == _strip(jaudit.decisions(subsystem="serving"))
    assert [r["kind"] for r in taudit.decisions()] == ["admission", "eviction"]


# ---------------------------------------------------------- the windows -----


def test_window_reads_equal_jax():
    vals = np.random.default_rng(6).exponential(0.2, size=50)
    _observe_both("lat_s", vals)
    for side in SIDES.values():
        side["tel"].registry().inc("reqs", 7.0)
    treg, jreg = telemetry.registry(), jtele.registry()
    assert treg.window_horizon_s() == jreg.window_horizon_s() == 2.0
    for thr in (0.0, 0.1, 0.25, 1.0, 10.0):
        assert treg.window_fraction_over("lat_s", thr, 1.0) == jreg.window_fraction_over("lat_s", thr, 1.0)
    assert treg.window_fraction_over("never_s", 0.1) is None is jreg.window_fraction_over("never_s", 0.1)
    for q in (0.5, 0.99):
        assert treg.window_quantile("lat_s", q) == jreg.window_quantile("lat_s", q)
    tw, jw = treg.windows_snapshot(), jreg.windows_snapshot()
    assert tw["quantiles"] == jw["quantiles"]
    assert tw["rates"] == jw["rates"] and set(tw) == set(jw)


def test_mark_and_delta_equal_jax():
    marks = {name: side["tel"].registry().mark() for name, side in SIDES.items()}
    for side in SIDES.values():
        reg = side["tel"].registry()
        reg.inc("a", 2.0)
        reg.inc("b")
        reg.gauge("g", 4.0)
        reg.observe("h_s", 0.5)
        reg.observe("h_s", 1.5)
    deltas = {}
    for name, side in SIDES.items():
        d = side["tel"].registry().delta(marks[name])
        deltas[name] = (d["counters"], d["histograms"], d["gauges"])
    assert deltas["port"] == deltas["jax"]
    assert deltas["port"][0] == {"a": 2.0, "b": 1.0}


# ---------------------------------------------------------------- SLOs -------


def _latency_spec(**over):
    spec = {"name": "lat", "kind": "latency", "histogram": "lat_s", "threshold_s": 0.1,
            "objective": 0.9, "fast_window_s": 1.0, "slow_window_s": 2.0}
    spec.update(over)
    return spec


_SPEC_SETS = {
    "latency": [_latency_spec()],
    "latency_min_count": [_latency_spec(min_count=100)],
    "error_rate": [{"name": "err", "kind": "error_rate", "errors": "errs", "total": "reqs", "threshold": 0.05}],
    "gauge_ceiling": [{"name": "util", "kind": "gauge_ceiling", "gauge": "util", "ceiling": 0.8}],
    "malformed_and_unknown": [{"name": "bad", "kind": "latency", "histogram": "lat_s", "threshold_s": "x"},
                              {"name": "odd", "kind": "nope"}],
    "mixed": [_latency_spec(fast_burn=2.0), {"name": "err", "kind": "error_rate", "errors": "errs",
                                             "total": "reqs", "threshold": 0.5}],
}


@pytest.mark.parametrize("specs", sorted(_SPEC_SETS))
@pytest.mark.parametrize("seed", [0, 1])
def test_slo_verdicts_and_burn_equal_jax(specs, seed):
    gen = np.random.default_rng(seed)
    vals = gen.exponential(0.1, size=40)
    _observe_both("lat_s", vals)
    errs, reqs, util = float(gen.integers(0, 6)), float(gen.integers(20, 40)), float(gen.uniform(0.5, 1.2))
    for side in SIDES.values():
        reg = side["tel"].registry()
        reg.inc("reqs", reqs)
        if errs:
            reg.inc("errs", errs)
        reg.gauge("util", util)
    out = {}
    for name, side in SIDES.items():
        cfg = config if name == "port" else jcore.config
        cfg["slo"] = _SPEC_SETS[specs]
        verdicts = side["slo"].evaluate()
        health = side["slo"].health(fresh=False)
        burn = side["slo"].burn_rate("lat_s", threshold_s=0.1, objective=0.9, window_s=1.0)
        counters = side["tel"].registry().snapshot()["counters"]
        out[name] = (verdicts, {k: health[k] for k in ("healthy", "failing", "specs")}, burn,
                     side["slo"].serving_latency_spec(), counters.get("slo.trips"),
                     side["tel"].registry().snapshot()["gauges"].get("slo.failing"))
    assert out["port"] == out["jax"]


def test_slo_trips_and_clears_and_the_serving_spec_like_jax():
    spec = _latency_spec(histogram="serve.e2e_s", fast_burn=1.0, slow_window_s=1.0)
    out = {}
    for name, side in SIDES.items():
        cfg = config if name == "port" else jcore.config
        cfg["slo"] = [{"name": "err", "kind": "error_rate"}, spec]
        reg = side["tel"].registry()
        reg.observe("serve.e2e_s", 5.0)
        first = side["slo"].evaluate()
        reg.reset()
        second = side["slo"].evaluate()
        counters = reg.snapshot()["counters"]
        out[name] = ([v["failing"] for v in first], [v["failing"] for v in second], counters,
                     side["slo"].serving_latency_spec(), side["slo"].last_verdicts())
    assert out["port"] == out["jax"]
    assert out["port"][0] == [False, True] and out["port"][1] == [False, False]
    assert out["port"][3] == spec


def test_slo_evaluate_reader_and_cluster_health_equal_jax():
    # the stateless evaluation over a merged window and over the live
    # registry: the same verdicts, and no trip recorded
    spec = {"name": "p99", "kind": "latency", "histogram": "serve.e2e_s", "threshold_s": 0.1, "fast_burn": 1.0}
    errs = {"name": "err", "kind": "error_rate", "errors": "serve.errors", "total": "serve.requests"}
    export = {"bucket_seconds": 0.5, "bucket_count": 4, "counters": {"serve.requests": [4.0, 0, 0, 0],
                                                                     "serve.errors": [1.0, 0, 0, 0]},
              "hists": {"serve.e2e_s": {"counts": [3.0, 0, 0, 0], "sums": [1.2, 0, 0, 0],
                                        "samples": [[0.05, 0.5, 0.65], [], [], []]}}}
    out = {}
    for name, side in SIDES.items():
        (config if name == "port" else jcore.config)["slo"] = [spec, errs]
        reader = side["tel"].MergedWindows(side["tel"].merge_windows([export]))
        health = side["slo"].cluster_health(reader)
        live = side["slo"].evaluate_reader(side["tel"].registry(), [spec])
        assert "slo.trips" not in side["tel"].registry().snapshot()["counters"]
        out[name] = ({k: v for k, v in health.items() if k != "t"}, live, side["slo"].evaluate_reader(reader, []))
    assert out["port"] == out["jax"]
    assert out["port"][0]["failing"] == ["p99", "err"] and out["port"][2] == []


# ------------------------------------------------------------ exporters ------


def test_prometheus_text_equal_jax(monkeypatch):
    monkeypatch.setenv("SRML_RANK", "2")
    for side in SIDES.values():
        reg = side["tel"].registry()
        reg.inc("serve.requests", 3)
        reg.inc("ops.decisions_recorded")
        reg.gauge("serve.overload_level", 2.0)
        reg.gauge("memory.capacity_bytes", 8.5e10)
        for v in (0.25, 0.5, 0.125):
            reg.observe("serve.e2e_s", v)
        reg.observe(jtele.tenant_metric("serve.e2e_s", "a b"), 1.0)
    text = texport.render_prometheus()
    assert text == jexport.render_prometheus()
    assert 'srml_serve_requests{rank="2"} 3' in text
    assert 'srml_serve_e2e_s{rank="2",quantile="0.99"} 0.5' in text


def _get(url):
    try:
        resp = urllib.request.urlopen(url, timeout=10)
        return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_routes_on_an_ephemeral_port(monkeypatch):
    monkeypatch.setenv("SRML_METRICS_PORT", "0")
    telemetry.registry().inc("serve.requests", 4)
    host, port = tops.ensure_server()
    try:
        assert texport.server_address() == (host, port) and port > 0
        assert tops.ensure_server() == (host, port)  # idempotent
        base = f"http://{host}:{port}"
        code, body = _get(base + "/metrics")
        assert code == 200 and 'srml_serve_requests{rank="0"} 4' in body.decode()
        config["slo"] = [_latency_spec(fast_burn=1.0)]
        code, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["healthy"] is True
        telemetry.registry().observe("lat_s", 1.0)  # the next scrape fails fresh
        code, body = _get(base + "/healthz")
        assert code == 503 and json.loads(body)["failing"] == ["lat"]
        code, body = _get(base + "/snapshot")
        snap = json.loads(body)
        assert code == 200 and {"health", "slo", "windows", "decisions", "serving", "drift"} <= set(snap)
        assert _get(base + "/nope")[0] == 404
    finally:
        texport.stop_server()
    assert texport.server_address() is None


def test_only_rank_zero_binds_equal_jax(monkeypatch):
    monkeypatch.setenv("SRML_METRICS_PORT", "0")
    monkeypatch.setenv("SRML_RANK", "1")
    monkeypatch.delenv("SRML_METRICS_ALL_RANKS", raising=False)
    assert jexport.ensure_server() is None and jexport.server_address() is None
    assert tops.ensure_server() is None and texport.server_address() is None


def test_snapshot_rotation_equal_jax(tmp_path, monkeypatch):
    names = {}
    for name, side in SIDES.items():
        d = tmp_path / name
        path = str(d / "ops_snapshot.json")
        for _ in range(4):
            assert side["export"].write_snapshot(path, keep=2) == path
        names[name] = sorted(os.listdir(d))
        with open(path) as f:
            rep = json.load(f)
        assert {"health", "decisions", "serving"} <= set(rep)
    assert names["port"] == names["jax"] == ["ops_snapshot.1.json", "ops_snapshot.2.json", "ops_snapshot.json"]
    # the configured directory, and none: no file
    monkeypatch.delenv("SRML_OPS_SNAPSHOT_DIR", raising=False)
    config["ops_snapshot_dir"] = None
    assert texport.write_snapshot() is None
    config["ops_snapshot_dir"] = str(tmp_path / "cfg")
    assert texport.write_snapshot() == str(tmp_path / "cfg" / "ops_snapshot.json")


def test_report_sections():
    taudit.record_decision("admission", "fit", "resident", subject="A", tenant="t1")
    taudit.record_decision("eviction", "serving", "evicted", subject="B", tenant="serving")
    rep = tops.report(tenant="t1")
    jrep = jops.report(tenant="t1")
    # the efficiency plane is A15, the autotune table A18
    assert set(rep) == set(jrep) - {"efficiency", "autotune"}
    assert rep["windows_detail"].keys() == jrep["windows_detail"].keys()
    assert set(tops.report(cluster=True)) == set(jops.report(cluster=True)) - {"efficiency", "autotune"}
    assert set(rep["meta"]) == set(jrep["meta"])
    assert [d["tenant"] for d in rep["decisions"]] == ["t1"]
    assert rep["decision_log"] == {"capacity": rep["decision_log"]["capacity"], "recorded": 2, "retained": 2,
                                   "dropped": 0}
    json.dumps(rep, default=str)


# ---------------------------------------------------------------- drift ------


def _extracted(side, x, cols=None):
    if cols is None:
        return SIDES[side]["extract"]({"features": x}, input_col="features", validate=False,
                                      float32_inputs=x.dtype == np.float32)
    df = pd.DataFrame({c: x[:, i] for i, c in enumerate(cols)})
    return SIDES[side]["extract"](df, input_cols=cols, validate=False, float32_inputs=x.dtype == np.float32)


@pytest.mark.parametrize("cols", [None, ["a", "b", "c"]])
@pytest.mark.parametrize("chunk_bytes", [128 << 20, 64 * 8])
def test_drift_stats_from_the_ingest_scan_equal_jax(cols, chunk_bytes):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((333, 3)) * np.array([1.0, 2.0, 3.0]) + 0.5
    x[rng.integers(0, 333, 5), 1] = np.nan  # counted as nulls, then the scan raises
    out = {}
    for name, side in SIDES.items():
        (config if name == "port" else jcore.config)["ingest_chunk_bytes"] = chunk_bytes
        clean = _extracted(name, np.nan_to_num(x, nan=0.25), cols)
        side["validate"](clean)
        stats = side["drift"].last_stats()
        gauges = {k: v for k, v in side["tel"].registry().snapshot()["gauges"].items() if k.startswith("ingest.")}
        with pytest.raises(Exception, match="non-finite|NaN|Inf|nan|inf"):
            side["validate"](_extracted(name, x, cols))
        out[name] = (stats, gauges, side["drift"].last_stats())
    assert out["port"] == out["jax"]
    assert out["port"][0]["rows"] == 333


def test_drift_psi_and_baseline_equal_jax():
    rng = np.random.default_rng(5)
    ref = rng.standard_normal((2000, 2))
    same, shifted = rng.standard_normal((1500, 2)), rng.standard_normal((1500, 2)) + 3.0
    out = {}
    for name, side in SIDES.items():
        base = side["drift"].build_baseline(_extracted(name, ref), bins=8, sample_rows=900)
        side["drift"].register_baseline(base)
        psis = []
        for data in (same, shifted):
            side["validate"](_extracted(name, data))
            psis.append(side["tel"].registry().snapshot()["gauges"]["ingest.feature.psi_max"])
        out[name] = (base.to_dict(), psis, side["drift"].last_stats())
        # the dict round trip
        assert side["drift"].Baseline.from_dict(base.to_dict()).to_dict() == base.to_dict()
    assert out["port"] == out["jax"]
    assert out["port"][1][0] < 0.05 < 0.5 < out["port"][1][1]


def test_drift_accumulator_on_the_same_chunks_equal_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((400, 4))
    x[3, 2] = np.inf
    chunks = np.array_split(x, 7)
    out = {}
    for name, side in SIDES.items():
        acc = side["drift"].DriftAccumulator(_extracted(name, x))
        for c in chunks:
            acc.update(c)
        out[name] = (acc.stats(), acc.publish(), acc.publish())
    assert out["port"] == out["jax"]
    assert out["port"][2] is None  # idempotent per scan


def test_drift_skips_sparse_and_disabled():
    import scipy.sparse as sp

    ex = _extracted("port", np.ones((4, 2)))
    ex.features = sp.csr_matrix(ex.features)
    assert tdrift.accumulator_for(ex) is None
    telemetry.disable()
    assert tdrift.accumulator_for(_extracted("port", np.ones((4, 2)))) is None


def test_streamed_fit_publishes_drift_at_its_last_block():
    # the out-of-core path scans each row block as it enters the stream: the
    # statistics publish once the last block was scanned, equal to the
    # resident scan's
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2000, 6))
    config.update(validate_ingest=True, hbm_budget_bytes=140_000, stream_chunk_rows=512)
    m = KMeans(k=4, maxIter=2, float32_inputs=False).fit({"features": x})
    assert m._fit_metrics["admission"]["verdict"] == "stream"
    streamed = tdrift.last_stats()
    config.update(hbm_budget_bytes=None, stream_chunk_rows=0)
    KMeans(k=4, maxIter=2, float32_inputs=False).fit({"features": x})
    assert streamed["rows"] == 2000
    resident = tdrift.last_stats()
    np.testing.assert_allclose(streamed["mean"], resident["mean"], rtol=1e-12)
    np.testing.assert_allclose(streamed["std"], resident["std"], rtol=1e-9)
