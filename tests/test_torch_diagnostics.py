#
# The PyTorch port's diagnostics (spark_rapids_ml_tpu_torch/diagnostics.py:
# the flight recorder's ring and the trace scope) against the JAX
# package's (tests/test_diagnostics.py's cases) on the same inputs, on the
# CPU: the ring's bound and drop counter, the disabled recorder, the dump
# and its read-back, a malformed capacity knob; rank 0's trace id on every
# rank, a failed exchange keeping the local id, fits with distinct trace
# ids and sequenced fit ids; the round events of a rendezvous.
#
# Tolerances: equality throughout; events compare in every key but the
# time "t" and the trace id (minted at random on each side).
#
import json
import threading

import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_tpu import diagnostics as jdiag
from spark_rapids_ml_tpu import telemetry as jtele
from spark_rapids_ml_tpu.errors import RendezvousTimeoutError as JaxRendezvousTimeoutError
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.parallel import LocalRendezvous as JaxLocalRendezvous
from spark_rapids_ml_tpu_torch import LogisticRegression, parallel
from spark_rapids_ml_tpu_torch import diagnostics as tdiag
from spark_rapids_ml_tpu_torch import telemetry as ttele
from spark_rapids_ml_tpu_torch.errors import RendezvousTimeoutError
from spark_rapids_ml_tpu_torch.parallel import LocalRendezvous

SIDES = {
    "port": dict(diag=tdiag, tel=ttele, local=LocalRendezvous, lr=LogisticRegression, timeout=RendezvousTimeoutError),
    "jax": dict(diag=jdiag, tel=jtele, local=JaxLocalRendezvous, lr=JaxLogisticRegression,
                timeout=JaxRendezvousTimeoutError),
}


@pytest.fixture(autouse=True)
def env(monkeypatch):
    """Both registries fresh and on, both process recorders empty, no
    launcher trace id, the port on the CPU."""
    monkeypatch.delenv("SRML_TRACE_ID", raising=False)
    monkeypatch.delenv("SRML_RANK", raising=False)
    parallel.set_devices("cpu")
    for s in SIDES.values():
        s["tel"].registry().reset()
        s["tel"].enable()
        s["diag"].flight_recorder().reset()
    yield
    for s in SIDES.values():
        s["tel"].disable()
        s["tel"].registry().reset()
    parallel.set_devices(None)


def _plain(events):
    return [{k: v for k, v in e.items() if k not in ("t", "trace_id", "fit_id")} for e in events]


# ------------------------------------------------------- flight recorder ----


def test_ring_bound_and_drop_counter_equal_jax():
    out = {}
    for name, s in SIDES.items():
        rec = s["diag"].FlightRecorder(capacity=4, enabled=True)
        for i in range(10):
            rec.record("tick", i=i)
        evs = rec.events()
        assert [e["i"] for e in evs] == [6, 7, 8, 9]  # the oldest overwritten first
        assert rec.tail(2) == evs[-2:] and rec.tail(0) == [] and rec.tail(99) == evs
        # the drops are never silent: the registry counter mirrors them
        assert s["tel"].registry().snapshot()["counters"]["flightrec.events_dropped"] == 6
        out[name] = (_plain(evs), rec.stats())
        rec.reset()
        assert rec.events() == [] and rec.stats()["recorded"] == 0
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"enabled": True, "capacity": 4, "recorded": 10, "retained": 4, "dropped": 6}


@pytest.mark.parametrize("side", list(SIDES))
def test_disabled_recorder_records_nothing(side, monkeypatch):
    diag = SIDES[side]["diag"]
    rec = diag.FlightRecorder(capacity=8, enabled=False)
    rec.record("tick")
    assert rec.events() == [] and rec.dump("/nonexistent/should/not/matter") is None
    monkeypatch.setenv("SRML_FLIGHTREC", "0")  # the environment's switch
    assert diag.FlightRecorder().enabled is False


def test_dump_round_trip_equal_jax(tmp_path, monkeypatch):
    out = {}
    for name, s in SIDES.items():
        rec = s["diag"].flight_recorder()
        rec.record("alpha", x=1)
        rec.record("beta", x=2)
        path = str(tmp_path / f"{name}.jsonl")
        assert rec.dump(path, reason="unit test") == path
        with open(path) as f:
            lines = [json.loads(line) for line in f]
        assert [line["kind"] for line in lines] == ["alpha", "beta", "flightrec_dump"]
        out[name] = _plain(lines)
        # the default path: flightrec_rank_<r>.jsonl under SRML_FLIGHTREC_DIR, none without it
        monkeypatch.setenv("SRML_FLIGHTREC_DIR", str(tmp_path / name))
        assert rec.dump() == str(tmp_path / name / "flightrec_rank_0.jsonl")
        monkeypatch.delenv("SRML_FLIGHTREC_DIR")
    assert out["port"] == out["jax"]
    assert out["port"][-1]["reason"] == "unit test" and out["port"][-1]["recorded"] == 2


@pytest.mark.parametrize("side", list(SIDES))
def test_malformed_capacity_knob_keeps_the_default(side, monkeypatch):
    monkeypatch.setenv("SRML_FLIGHTREC_EVENTS", "2k")
    assert SIDES[side]["diag"].FlightRecorder().capacity == 2048
    monkeypatch.setenv("SRML_FLIGHTREC_EVENTS", "16")
    assert SIDES[side]["diag"].FlightRecorder().capacity == 16


@pytest.mark.parametrize("side", list(SIDES))
def test_events_carry_the_trace_tags_and_the_rank(side, monkeypatch):
    diag = SIDES[side]["diag"]
    monkeypatch.setenv("SRML_TRACE_ID", "launcher-minted")
    monkeypatch.setenv("SRML_RANK", "3")
    diag.record_event("tick")
    assert {k: v for k, v in diag.flight_recorder().events()[-1].items() if k != "t"} == {
        "kind": "tick", "rank": 3, "trace_id": "launcher-minted"}
    with diag.trace_scope("unit") as tags:
        diag.record_event("inside")
    inside = diag.flight_recorder().events()[-2]
    assert inside["kind"] == "inside" and inside["fit_id"] == tags["fit_id"]
    assert inside["trace_id"] == "launcher-minted"  # the launcher's id is the scope's


# ------------------------------------------------------------ trace scope ----


def _spmd_scopes(side, nested=False):
    """Two thread ranks, each entering a trace scope over the LocalRendezvous
    (nested: a second scope inside); per rank its tags and its rounds."""
    s = SIDES[side]
    rvs = s["local"].create(2, timeout_s=10.0)
    seen = [None, None]

    class Ctx:
        is_spmd = True

        def __init__(self, rank):
            self.rank = rank
            self.rendezvous = rvs[rank]

    def run(r):
        with s["diag"].trace_scope("spmd", Ctx(r)) as tags:
            inner = None
            if nested:
                with s["diag"].trace_scope("inner", Ctx(r)) as inner:
                    pass
        seen[r] = (tags, inner, rvs[r]._round)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    [t.start() for t in threads]
    [t.join(timeout=30) for t in threads]
    assert not any(t.is_alive() for t in threads)
    return seen


@pytest.mark.parametrize("side", list(SIDES))
def test_rank0_trace_id_reaches_every_rank(side):
    SIDES[side]["tel"].disable()  # the trace round alone
    seen = _spmd_scopes(side, nested=True)
    (t0, i0, n0), (t1, i1, n1) = seen
    assert t0["trace_id"] == t1["trace_id"] and (n0, n1) == (1, 1)
    # a nested scope adopts the trace id and runs no round
    assert i0["trace_id"] == t0["trace_id"] and i0["fit_id"] != t0["fit_id"]


def test_trace_round_events_equal_jax():
    out = {}
    for name, s in SIDES.items():
        s["tel"].disable()
        _spmd_scopes(name)
        kinds = sorted(e["kind"] for e in s["diag"].flight_recorder().events())
        out[name] = kinds
    assert out["port"] == out["jax"]
    assert out["port"].count("rdv_enter") == out["port"].count("rdv_exit") == 2
    assert out["port"].count("trace_begin") == out["port"].count("trace_end") == 2


@pytest.mark.parametrize("side", list(SIDES))
def test_failed_trace_exchange_keeps_the_local_id(side):
    s = SIDES[side]

    class Ctx:
        is_spmd = True
        rank = 1

        class rendezvous:  # noqa: N801 - a stub namespace
            @staticmethod
            def allgather(payload):
                raise s["timeout"]("peer slow entering fit", round_index=0)

    with s["diag"].trace_scope("degraded", Ctx()) as tags:
        assert tags["trace_id"]
    failed = [e for e in s["diag"].flight_recorder().events() if e["kind"] == "trace_exchange_failed"]
    assert [(e["label"], e["error"]) for e in failed] == [("degraded", "RendezvousTimeoutError")]


def test_rendezvous_failure_records_rdv_fail_equal_jax():
    out = {}
    for name, s in SIDES.items():
        rvs = s["local"].create(2, timeout_s=5.0)
        rvs[1].abort("gone")
        with pytest.raises(Exception):
            rvs[0].allgather("x")
        # the round's own events (JAX also records the abort and its spans,
        # which the port leaves to A15)
        out[name] = [(e["kind"], e.get("round"), e.get("error")) for e in s["diag"].flight_recorder().events()
                     if e["kind"].startswith("rdv_")]
    assert out["port"] == out["jax"] == [("rdv_enter", 0, None), ("rdv_fail", 0, "RankFailedError")]
    # the port's round events all carry the epoch (JAX's rdv_exit and
    # rdv_fail carry the round alone)
    assert [e["epoch"] for e in tdiag.flight_recorder().events() if e["kind"].startswith("rdv_")] == [0, 0]


def test_fits_get_distinct_trace_ids_and_sequenced_fit_ids():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(120, 4))
    df = pd.DataFrame({"features": list(x), "label": (x @ rng.normal(size=4) > 0).astype(np.float64)})
    out = {}
    for name, s in SIDES.items():
        for _ in range(2):
            s["lr"](maxIter=5).setFeaturesCol("features").fit(df)
        begins = [e for e in s["diag"].flight_recorder().events()
                  if e["kind"] == "trace_begin" and e["label"] == "LogisticRegression"]
        assert len(begins) == 2 and begins[0]["trace_id"] != begins[1]["trace_id"]
        n0, n1 = (int(e["fit_id"].split("-")[1]) for e in begins)
        assert n1 == n0 + 1
        out[name] = [e["label"] for e in begins]
    assert out["port"] == out["jax"]
