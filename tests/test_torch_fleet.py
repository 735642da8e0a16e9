#
# The PyTorch port's fleet plane (spark_rapids_ml_tpu_torch/ops_plane/
# fleet.py, the merges of telemetry.py, slo.evaluate_reader and
# cluster_health, the cluster lines of export.py) against the JAX package's
# (tests/test_fleet.py's cases) on the same inputs, on the CPU:
#
#   * the merges: the same crafted window exports give equal merged windows,
#     quantiles and rates, and equal counter, gauge and histogram merges;
#     merging is associative and order-free, one rank's merge is the
#     identity, and bucket widths that differ raise;
#   * the export: the same observations at one frozen `time.monotonic` give
#     equal `windows_export()`s;
#   * the live round: three LocalRendezvous ranks exchanging the same
#     crafted payloads give equal views (the merge time "t" aside), the
#     throttle, the piggyback on the trace round, no round with telemetry
#     off, the bare marker, a dead peer degrading without failing;
#   * cluster SLOs and stragglers: a `min_count` floor trips the cluster and
#     not the ranks, and flips rank 0's /healthz to 503; a straggler is
#     named in the flight recorder and the audit log, and none below the
#     least lag;
#   * snapshots and the exporter: missing and stale ranks named, the port
#     policy of `ensure_server`, the `rank="cluster"` lines equal JAX's;
#   * the port's own: two real processes (gloo) each holding the cluster
#     view of both ranks, and a fit fanned over chips running no ops round.
#
# Tolerances: equality throughout (the same float64 arithmetic on the same
# inputs), the straggler lag to pytest.approx's default.
#
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu import diagnostics as jdiag
from spark_rapids_ml_tpu import ops_plane as jops
from spark_rapids_ml_tpu import telemetry as jtele
from spark_rapids_ml_tpu.ops_plane import audit as jaudit
from spark_rapids_ml_tpu.ops_plane import export as jexport
from spark_rapids_ml_tpu.ops_plane import fleet as jfleet
from spark_rapids_ml_tpu.ops_plane import slo as jslo
from spark_rapids_ml_tpu.parallel import LocalRendezvous as JaxLocalRendezvous
from spark_rapids_ml_tpu.scheduler import ledger as jledger
from spark_rapids_ml_tpu_torch import diagnostics as tdiag
from spark_rapids_ml_tpu_torch import ops_plane as tops
from spark_rapids_ml_tpu_torch import parallel
from spark_rapids_ml_tpu_torch import telemetry as ttele
from spark_rapids_ml_tpu_torch.core import config as tconfig
from spark_rapids_ml_tpu_torch.ops_plane import audit as taudit
from spark_rapids_ml_tpu_torch.ops_plane import export as texport
from spark_rapids_ml_tpu_torch.ops_plane import fleet as tfleet
from spark_rapids_ml_tpu_torch.ops_plane import slo as tslo
from spark_rapids_ml_tpu_torch.parallel import LocalRendezvous
from spark_rapids_ml_tpu_torch.scheduler import ledger as tledger

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mp_worker.py")

SIDES = {
    "port": dict(tel=ttele, fleet=tfleet, slo=tslo, audit=taudit, export=texport, ops=tops, diag=tdiag,
                 local=LocalRendezvous, config=tconfig, ledger=tledger),
    "jax": dict(tel=jtele, fleet=jfleet, slo=jslo, audit=jaudit, export=jexport, ops=jops, diag=jdiag,
                local=JaxLocalRendezvous, config=jcore.config, ledger=jledger),
}
_KEYS = ("metrics_bucket_seconds", "metrics_bucket_count", "slo", "fleet_ops_round_seconds",
         "fleet_straggler_windows", "fleet_straggler_min_lag_s", "fleet_stale_snapshot_s")
HIST = "fleet_test.lat_s"

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(autouse=True)
def env():
    """Both packages' fleets, audit logs, flight recorders and SLO state
    fresh; both registries on with fast windows (0.05 s x 20, a 1 s
    horizon); the port on the CPU."""
    parallel.set_devices("cpu")
    saved = {name: {k: s["config"][k] for k in _KEYS} for name, s in SIDES.items()}
    for s in SIDES.values():
        s["config"].update(metrics_bucket_seconds=0.05, metrics_bucket_count=20, slo=[])
        s["fleet"].reset()
        s["audit"].clear()
        s["slo"].reset()
        s["diag"].flight_recorder().reset()
        s["tel"].registry().reset()
        s["tel"].enable()
    yield
    for name, s in SIDES.items():
        s["tel"].disable()
        s["tel"].registry().reset()
        s["fleet"].reset()
        s["audit"].clear()
        s["slo"].reset()
        s["config"].update(saved[name])
    parallel.set_devices(None)


def _run_ranks(side, nranks, fn, timeout_s=60.0):
    """fn(rank, rendezvous) on one thread a rank over `side`'s
    LocalRendezvous; the first thread error is raised here."""
    rdvs = SIDES[side]["local"].create(nranks, timeout_s=30.0)
    results, errors = [None] * nranks, []

    def work(rank):
        try:
            results[rank] = fn(rank, rdvs[rank])
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
            rdvs[rank].abort(f"test rank {rank}: {type(e).__name__}")

    threads = [threading.Thread(target=work, args=(r,), daemon=True) for r in range(nranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    assert not any(t.is_alive() for t in threads), "rank thread hung"
    if errors:
        raise errors[0]
    return results


def _mk_export(samples_newest_first, bucket_seconds=0.05, bucket_count=20, name=HIST, counters=None):
    """One rank's window export from per-bucket sample lists (newest first),
    in `windows_export()`'s shape (tests/test_fleet.py's helper)."""
    buckets = [sorted(float(v) for v in b) for b in samples_newest_first]
    buckets += [[] for _ in range(bucket_count - len(buckets))]
    return {
        "bucket_seconds": bucket_seconds,
        "bucket_count": bucket_count,
        "counters": {k: list(v) + [0.0] * (bucket_count - len(v)) for k, v in (counters or {}).items()},
        "hists": {name: {"counts": [float(len(b)) for b in buckets], "sums": [float(sum(b)) for b in buckets],
                         "samples": buckets}},
    }


def _payload(rank, **over):
    """A crafted rank payload: the same on both sides (fixed identity and
    time, so the views compare whole)."""
    p = {"v": 1, "rank": rank, "host": f"host{rank}", "pid": 1000 + rank, "t": 5000.0 + rank,
         "trace_id": "feedc0de", "counters": {"fleet_test.work": float(rank + 1)},
         "gauges": {"fleet_test.hbm": float(10 * rank + 2)},
         "hists": {HIST: {"count": 2.0, "sum": 0.5 + rank, "min": 0.1, "max": 0.4 + rank}},
         "windows": _mk_export([[0.01 * (rank + 1)] * 3, [0.5]], counters={"fleet_test.work": [1.0, float(rank)]}),
         "tenants": {"t1": {"byte_seconds": float(rank), "chips_busy": 1.0},
                     "_pool": {"chips_busy": 1.0, "chips_idle": float(rank)}},
         "round_exits": [[0, 3, 100.0 + 0.001 * rank, 100.5]]}
    p.update(over)
    return p


def _strip_t(view):
    """A view without its merge time (the one field two merges of the same
    payloads differ in)."""
    v = json.loads(json.dumps(view, default=str))
    v.pop("t", None)
    v.pop("age_s", None)
    (v.get("health") or {}).pop("t", None)
    return v


# ---------------------------------------------------------------- merges ----


def test_merge_counters_gauges_histograms_equal_jax():
    counters = [{"a": 1.0, "b": 2.0}, {"a": 10.0}, {"b": 0.5, "c": 4.0}]
    gauges = {0: {"g": 2.0}, 2: {"g": 8.0}, "1": {"g": 5.0, "h": -1.0}}
    hists = [{"h": {"count": 3.0, "sum": 6.0, "min": 1.0, "max": 3.0}},
             {"h": {"count": 2.0, "sum": 9.0, "min": 4.0, "max": 5.0}, "i": {"count": 1.0, "sum": 1.0}}]
    got = {name: (s["tel"].merge_counters(counters), s["tel"].merge_gauges(gauges), s["tel"].merge_histograms(hists))
           for name, s in SIDES.items()}
    assert got["port"] == got["jax"]
    c, g, h = got["port"]
    assert c == {"a": 11.0, "b": 2.5, "c": 4.0}
    assert g["g"]["by_rank"] == {0: 2.0, 1: 5.0, 2: 8.0} and (g["g"]["min"], g["g"]["max"], g["g"]["sum"]) == (
        2.0, 8.0, 15.0)
    assert h["h"] == {"count": 5.0, "sum": 15.0, "min": 1.0, "max": 5.0}


def test_merge_windows_equal_jax_exact_associative_order_free():
    a = _mk_export([[0.01, 0.02], [0.03]], counters={"w": [1.0, 2.0]})
    b = _mk_export([[1.0], []], counters={"w": [0.5]})
    c = _mk_export([[], [0.5, 0.6]])
    out = {}
    for name, s in SIDES.items():
        tel = s["tel"]
        merged = tel.merge_windows([a, b, c])
        assert tel.merge_windows([c, a, b]) == merged
        for view in (tel.merge_windows([tel.merge_windows([a, b]), c]),
                     tel.merge_windows([a, tel.merge_windows([b, c])])):
            assert view["hists"] == merged["hists"] and view["counters"] == merged["counters"]
        mw = tel.MergedWindows(merged, {"g": 3.0})
        reads = [mw.window_quantile(HIST, q, w) for q in (0.5, 0.99) for w in (None, 0.05, 0.1)]
        reads += [mw.rate("w", w) for w in (None, 0.05, 0.1, 10.0)] + [mw.rate("absent")]
        reads += [mw.window_fraction_over(HIST, 0.1, w) for w in (None, 0.05)]
        reads += [mw.window_count(HIST, w) for w in (None, 0.05)]
        reads += [mw.bucket_seconds(), mw.window_horizon_s(), mw.snapshot()]
        out[name] = (merged, reads)
    assert out["port"] == out["jax"]
    h = out["port"][0]["hists"][HIST]
    assert h["counts"][:2] == [3.0, 3.0]
    assert h["sums"][0] == pytest.approx(0.01 + 0.02 + 1.0) and h["sums"][1] == pytest.approx(0.03 + 0.5 + 0.6)


@pytest.mark.parametrize("side", list(SIDES))
def test_merged_p99_brackets_the_ranks_p99s(side):
    tel = SIDES[side]["tel"]
    fast, slow = _mk_export([[0.01] * 20]), _mk_export([[0.9] * 20])

    def q(*exports):
        return tel.MergedWindows(tel.merge_windows(list(exports))).window_quantile(HIST, 0.99)

    assert q(fast) <= q(fast, slow) <= q(slow)


@pytest.mark.parametrize("side", list(SIDES))
def test_merge_windows_bucket_mismatch_raises(side):
    with pytest.raises(ValueError, match="mismatched bucket_seconds"):
        SIDES[side]["tel"].merge_windows([_mk_export([[]], bucket_seconds=0.05), _mk_export([[]], bucket_seconds=0.1)])


def test_windows_export_equal_jax_at_a_frozen_clock(monkeypatch):
    # the same observations at the same monotonic instants: the same buckets
    clock = {"t": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    out = {}
    for name, s in SIDES.items():
        reg = s["tel"].registry()
        for i, v in enumerate((0.3, 0.1, 0.2, 0.7, 0.05)):
            clock["t"] = 1000.0 + 0.03 * i
            reg.inc("fleet_test.work", 1.0 + i)
            reg.observe(HIST, v)
        clock["t"] = 1000.2
        e = reg.windows_export()
        m = s["tel"].merge_windows([e])
        assert m["counters"] == e["counters"] and m["hists"] == e["hists"] and m["ranks"] == 1  # the identity
        out[name] = e
    assert out["port"] == out["jax"]
    assert sum(out["port"]["counters"]["fleet_test.work"]) == 15.0
    assert out["port"]["hists"][HIST]["samples"][-1] == [] and sum(out["port"]["hists"][HIST]["counts"]) == 5.0


def test_merge_tenant_usage_equal_jax():
    usages = [{"t1": {"byte_seconds": 1.0, "chips_busy": 2.0, "device_time": {"execute_s": 1.0, "idle_s": 0.5}}},
              {"t1": {"byte_seconds": 3.0, "device_time": {"execute_s": 2.0}},
               "_pool": {"chips_busy": 4.0, "chips_idle": 4.0}}]
    merged = tledger.merge_tenant_usage(usages)
    assert merged == jledger.merge_tenant_usage(usages)
    assert merged["t1"]["device_time"] == {"execute_s": 3.0, "idle_s": 0.5} and merged["_pool"]["chips_busy"] == 4.0


# ------------------------------------------------------------ live round ----


def test_three_rank_round_gives_jax_view():
    views = {}
    for name, s in SIDES.items():
        got = _run_ranks(name, 3, lambda r, rdv, s=s: s["fleet"].ops_round(rdv, force=True, payload=_payload(r)))
        assert all(v is not None for v in got)
        views[name] = _strip_t(s["fleet"].cluster_view())
        rep = s["ops"].report(cluster=True)["cluster"]
        assert rep["available"] is True and rep["ranks_reporting"] == 3
        assert s["tel"].registry().snapshot()["counters"]["fleet.ops_rounds"] == 1.0
        assert s["tel"].registry().snapshot()["gauges"]["fleet.chips_idle"] == 3.0
    assert views["port"] == views["jax"]
    v = views["port"]
    assert v["counters"]["fleet_test.work"] == 6.0 and v["missing"] == [] and v["ranks_reporting"] == 3
    assert set(v["ranks"]) == {"0", "1", "2"} and v["ranks"]["1"]["pid"] == 1001
    assert v["gauges"]["fleet_test.hbm"]["max"] == 22.0 and v["tenants"]["_pool"]["chips_idle"] == 3.0


@pytest.mark.parametrize("side", list(SIDES))
def test_ops_due_throttles_to_the_interval(side):
    f = SIDES[side]["fleet"]
    assert f.ops_due(now=100.0) is True
    assert f.ops_due(now=100.01) is False  # within one bucket width
    assert f.ops_due(now=100.06) is True
    SIDES[side]["config"]["fleet_ops_round_seconds"] = 0
    assert f.ops_due(now=100.06) is True  # 0: every round
    SIDES[side]["tel"].disable()
    assert f.ops_due(now=200.0) is False  # telemetry off: never


def _scope_rounds(side):
    s = SIDES[side]

    def fit(rank, rdv):
        ctx = types.SimpleNamespace(rank=rank, is_spmd=True, rendezvous=rdv)
        with s["diag"].trace_scope("fleet-fit", ctx) as tags:
            pass
        return rdv._round, tags["trace_id"]

    return _run_ranks(side, 2, fit)


@pytest.mark.parametrize("side", list(SIDES))
def test_trace_scope_piggybacks_the_ops_round(side):
    got = _scope_rounds(side)
    assert [r for r, _ in got] == [2, 2]  # the trace round and the ops round, on every rank
    assert got[0][1] == got[1][1]  # rank 0's trace id on every rank
    assert SIDES[side]["fleet"].cluster_view()["ranks_reporting"] == 2
    assert SIDES[side]["tel"].registry().snapshot()["counters"]["fleet.ops_rounds"] == 1.0


@pytest.mark.parametrize("side", list(SIDES))
def test_disabled_telemetry_adds_no_round_and_records_nothing(side):
    SIDES[side]["tel"].disable()
    assert [r for r, _ in _scope_rounds(side)] == [1, 1]  # the trace round alone
    assert SIDES[side]["fleet"].cluster_view() is None
    assert "fleet.ops_rounds" not in SIDES[side]["tel"].registry().snapshot()["counters"]


@pytest.mark.parametrize("side", list(SIDES))
def test_payload_failure_sends_the_bare_marker(side, monkeypatch):
    f = SIDES[side]["fleet"]
    monkeypatch.setattr(f, "local_payload", lambda rank=None: (_ for _ in ()).throw(RuntimeError("boom")))
    views = _run_ranks(side, 2, lambda r, rdv: f.ops_round(rdv, force=True))
    view = next(v for v in views if v is not None)
    assert view["ranks_reporting"] == 0 and view["missing"] == [0, 1]  # the round completed; every rank named


@pytest.mark.parametrize("side", list(SIDES))
def test_dead_peer_degrades_the_survivor_without_failing(side):
    s = SIDES[side]

    def fit(rank, rdv):
        if rank == 1:
            rdv.abort("chaos: rank 1 died mid-round")
            return "aborted"
        return s["fleet"].ops_round(rdv, force=True, payload=_payload(rank))

    assert _run_ranks(side, 2, fit) == [None, "aborted"]
    assert "ops_round_failed" in [e["kind"] for e in s["diag"].flight_recorder().events()]
    counters = s["tel"].registry().snapshot()["counters"]
    assert counters["fleet.ops_rounds_failed"] == 1.0 and "fleet.ops_rounds" not in counters


# ----------------------------------------------------- cluster health -------


def _min_count_spec():
    return {"name": "fleet_lat", "kind": "latency", "histogram": HIST, "threshold_s": 0.1, "objective": 0.9,
            "min_count": 10, "fast_burn": 1.0}


def _skewed_rank_windows():
    """3 ranks x 4 samples: each rank's slice under the floor, the merged
    12 samples 4/12 over a 10% budget."""
    return [_mk_export([[0.01] * 4]), _mk_export([[0.01] * 4]), _mk_export([[1.0] * 4])]


def test_min_count_floor_trips_the_cluster_not_the_ranks():
    out = {}
    for name, s in SIDES.items():
        s["config"]["slo"] = [_min_count_spec()]
        tel = s["tel"]
        exports = _skewed_rank_windows()
        alone = [s["slo"].cluster_health(tel.MergedWindows(tel.merge_windows([e]))) for e in exports]
        assert all(h["healthy"] for h in alone), "a thin rank slice must stay healthy"
        merged = s["slo"].cluster_health(tel.MergedWindows(tel.merge_windows(exports)))
        assert not merged["healthy"] and merged["failing"] == ["fleet_lat"]
        # stateless: no trip was recorded
        assert "slo.trips" not in tel.registry().snapshot()["counters"]
        out[name] = [{k: v for k, v in h.items() if k != "t"} for h in alone + [merged]]
    assert out["port"] == out["jax"]


def test_cluster_failure_flips_rank0_healthz_and_cluster_lines_equal_jax():
    tconfig["slo"] = jcore.config["slo"] = [_min_count_spec()]
    exports = _skewed_rank_windows()
    host, port = texport.start_server(0)
    try:
        assert urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=5).status == 200
        for name, s in SIDES.items():
            _run_ranks(name, 3, lambda r, rdv, s=s: s["fleet"].ops_round(
                rdv, force=True, payload=_payload(r, windows=exports[r])))
        assert tslo.health(fresh=True)["healthy"]  # this rank's own windows are empty
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=5)
        assert exc_info.value.code == 503
        verdict = json.loads(exc_info.value.read())
        assert verdict["cluster"] == {"healthy": False, "failing": ["fleet_lat"], "ranks_reporting": 3,
                                      "missing": []}
        text = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=5).read().decode()
        assert 'srml_cluster_healthy{rank="cluster"} 0' in text
        assert 'srml_cluster_ranks_reporting{rank="cluster"} 3' in text
    finally:
        texport.stop_server()
    lines = texport._cluster_lines()
    assert lines == jexport._cluster_lines()
    assert 'srml_fleet_test_work{rank="cluster"} 6' in lines
    assert 'srml_fleet_test_hbm{rank="cluster",agg="max"} 22' in lines


# ----------------------------------------------------------- stragglers -----


@pytest.mark.parametrize("side", list(SIDES))
def test_straggler_named_in_the_flight_recorder_and_the_audit_log(side):
    s = SIDES[side]
    s["config"].update(fleet_straggler_windows=3, fleet_straggler_min_lag_s=0.05)

    def fit(rank, rdv):
        for i in range(3):  # three ops rounds in a row, rank 2 entering 0.2 s late
            lag = 0.2 if rank == 2 else 0.0
            s["fleet"].ops_round(rdv, force=True, payload=_payload(
                rank, round_exits=[[0, i, 1000.0 + i + lag, 1000.0 + i + 0.3]]))

    _run_ranks(side, 3, fit)
    assert s["fleet"].cluster_view()["straggler"]["lags_s"][2] == pytest.approx(0.2)
    events = [e for e in s["diag"].flight_recorder().events() if e["kind"] == "straggler_detected"]
    assert len(events) == 1 and events[0]["rank"] == 2 and events[0]["rounds"] == 3
    flagged = [d for d in s["audit"].decisions() if d["kind"] == "straggler"]
    assert [(d["subject"], d["verdict"], d["subsystem"]) for d in flagged] == [("rank:2", "flagged", "fleet")]
    snap = s["tel"].registry().snapshot()
    assert snap["counters"]["fleet.stragglers_flagged"] == 1.0
    assert snap["gauges"]["rendezvous.straggler_lag_s"] == pytest.approx(0.2)


@pytest.mark.parametrize("side", list(SIDES))
def test_no_straggler_below_the_least_lag(side):
    s = SIDES[side]

    def fit(rank, rdv):
        for i in range(4):
            lag = 0.001 if rank == 1 else 0.0  # under the 50 ms floor
            s["fleet"].ops_round(rdv, force=True, payload=_payload(
                rank, round_exits=[[0, i, 1000.0 + i + lag, 1000.0 + i + 0.3]]))

    _run_ranks(side, 2, fit)
    assert [d for d in s["audit"].decisions() if d["kind"] == "straggler"] == []
    assert s["fleet"].cluster_view()["straggler"]["slowest"] is None


# ------------------------------------------------- snapshots, exporters -----


def _write_rank_snapshot(side, directory, rank, t=None):
    rep = SIDES[side]["ops"].report()
    rep["meta"] = dict(rep["meta"], rank=rank, t=t or time.time())
    name = "ops_snapshot.json" if rank == 0 else f"ops_snapshot_rank_{rank}.json"
    with open(os.path.join(directory, name), "w") as f:
        json.dump(rep, f, default=str)


def test_report_carries_the_meta_header_and_windows_detail():
    ttele.registry().observe(HIST, 0.2)
    rep = tops.report()
    assert rep["meta"]["hostname"] == socket.gethostname() and rep["meta"]["pid"] == os.getpid()
    assert rep["windows_detail"]["hists"][HIST]["counts"][0] == 1.0
    assert "cluster" not in rep and tops.report(cluster=True)["cluster"] == {"available": False}


@pytest.mark.parametrize("side", list(SIDES))
def test_read_rank_snapshots_names_missing_and_stale(side, tmp_path):
    d = tmp_path / side
    d.mkdir()
    _write_rank_snapshot(side, d, 0)
    _write_rank_snapshot(side, d, 1, t=time.time() - 10_000)  # stale
    (d / "ops_snapshot.1.json").write_text("{}")  # a rotated generation: skipped
    reports, problems = SIDES[side]["fleet"].read_rank_snapshots(str(d), nranks=3)
    assert [r["meta"]["rank"] for r in reports] == [0]
    assert (problems["stale"], problems["missing"], problems["unreadable"], problems["nranks"]) == ([1], [2], [], 3)
    view = SIDES[side]["fleet"].merge_reports(reports, expected=3)
    assert view["missing"] == [1, 2] and view["ranks_reporting"] == 1


def test_offline_merge_of_the_same_reports_equals_jax(tmp_path):
    # crafted reports (no registry of either side in them): the same view
    reports = [{"meta": {"rank": r, "hostname": "h", "pid": 1, "t": 10.0 + r, "trace_id": "x"},
                "telemetry": {"counters": {"a": 1.0 + r}, "gauges": {"g": float(r)}, "histograms": {}},
                "windows_detail": _mk_export([[0.1 * (r + 1)]]), "tenants": {"t": {"byte_seconds": 2.0}}}
               for r in range(2)]
    got = {name: _strip_t(s["fleet"].merge_reports(reports, expected=3)) for name, s in SIDES.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["missing"] == [2] and got["port"]["counters"] == {"a": 3.0}


def test_ensure_server_binds_rank0_only_by_default(monkeypatch):
    monkeypatch.setenv("SRML_METRICS_PORT", "12345")
    monkeypatch.delenv("SRML_METRICS_ALL_RANKS", raising=False)
    monkeypatch.setenv("SRML_RANK", "1")
    assert texport.ensure_server() is None  # rank 1 binds nothing: no race for one port
    assert texport.server_address() is None


def test_ensure_server_all_ranks_binds_port_plus_rank(monkeypatch):
    with socket.socket() as s:  # a free port for rank 1 to land on
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    monkeypatch.setenv("SRML_METRICS_PORT", str(free - 1))
    monkeypatch.setenv("SRML_METRICS_ALL_RANKS", "1")
    monkeypatch.setenv("SRML_RANK", "1")
    try:
        addr = texport.ensure_server()
        assert addr is not None and addr[1] == free
    finally:
        texport.stop_server()


# ------------------------------------------------------ the port's own ------


def test_two_processes_each_hold_the_cluster_view(tmp_path):
    # two gloo ranks: two KMeans fits and a CrossValidator, with the ops
    # round due on every trace round; each rank's last view names both ranks
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("SRML_FAULT_PLAN", None)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    run_id = uuid.uuid4().hex
    procs = [subprocess.Popen([sys.executable, WORKER, "fleet", str(r), "2", str(tmp_path / "rdv"), str(out_dir),
                               run_id], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    outputs = []
    try:
        outputs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outputs[r] if r < len(outputs) else ''}"
    res = [json.loads((out_dir / f"result_rank{r}.json").read_text()) for r in range(2)]
    for r in range(2):
        view = res[r]["view"]
        assert sorted(view["ranks"]) == ["0", "1"] and view["missing"] == [] and view["health"]["healthy"]
        # every top-level fit and the sweep ran one ops round; the sweep's
        # inner fits adopted its trace and ran none
        assert res[r]["ops_rounds"] == res[r]["top_level_scopes"] == 3 and res[r]["ops_rounds_failed"] == 0
        assert view["counters"]["rendezvous.rounds"] >= 2 * res[r]["ops_rounds"]
        assert len(set(res[r]["trace_ids"])) == 3
    assert res[0]["view"]["counters"] == res[1]["view"]["counters"]  # one merge of the same payloads
    assert res[0]["trace_ids"] == res[1]["trace_ids"]  # rank 0's ids on every rank


def test_fanned_fit_runs_no_ops_round_and_leaves_no_round_exits():
    from spark_rapids_ml_tpu_torch import KMeans

    tconfig["fleet_ops_round_seconds"] = 0
    x = np.random.default_rng(0).normal(size=(400, 3))
    parallel.set_devices(["cpu"] * 8)
    model = KMeans(k=3, maxIter=4, seed=1, num_workers=4).fit({"features": x})
    assert model._fit_metrics["multidevice"]["chips"] == 4
    counters = ttele.registry().snapshot()["counters"]
    assert counters["rendezvous.rounds"] > 0  # the chips met over their rendezvous
    assert "fleet.ops_rounds" not in counters and tfleet.cluster_view() is None
    assert all(tfleet.local_payload(r)["round_exits"] == [] for r in range(4))
    begins = [e for e in tdiag.flight_recorder().events() if e["kind"] == "trace_begin"]
    assert [e["label"] for e in begins] == ["KMeans"]  # one scope for the fit over four chips
