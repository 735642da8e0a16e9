#
# The PyTorch port's 2-D scheduler book (spark_rapids_ml_tpu_torch/
# scheduler/ledger.py's chip-scoped claims, memory._claimed_chips,
# FitScheduler(chip_placement=True)) on the CPU, the port on
# `set_devices(["cpu"] * 8)`: the counterparts of the JAX package's 2-D
# tests in tests/test_scheduler.py (the four ledger tests run on both
# ledgers, call for call; the `_pool` gauges in the ops report; two
# half-pool KMeans jobs co-admitted onto disjoint halves, a third queued on
# chip overlap alone, the co-admitted occupancy integral at least 1.5x the
# time-sliced one, every model equal bit for bit to the job run alone; a
# preempted job resuming on a different chip set bit for bit) and of
# tests/test_ops_plane.py's chip multiplier (a job's claim and a fit's
# admission both charge the chips the fit spans). Scenarios are ordered by
# events; every wait has a timeout.
#
import threading
import time

import numpy as np
import pytest

from spark_rapids_ml_tpu.scheduler import ledger as jledger
from spark_rapids_ml_tpu_torch import FitScheduler, KMeans, memory, ops_plane, parallel, telemetry
from spark_rapids_ml_tpu_torch import core as tcore
from spark_rapids_ml_tpu_torch.scheduler import ledger as tledger

TIMEOUT = 60.0
_KEYS = ("hbm_budget_bytes", "checkpoint_every_iters", "sched_max_concurrent", "sched_chip_placement")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    parallel.set_devices(["cpu"] * 8)
    monkeypatch.setattr(tledger, "_GLOBAL", tledger.HbmLedger())
    saved = {k: tcore.config[k] for k in _KEYS}
    telemetry.enable()
    telemetry.registry().reset()
    yield
    tcore.config.update(saved)
    telemetry.disable()
    telemetry.registry().reset()
    held = tledger.global_ledger().reserved_bytes()
    parallel.set_devices(None)
    assert held == 0, f"{held} bytes left in the ledger"


def _both():
    return (("torch", tledger.HbmLedger()), ("jax", jledger.HbmLedger()))


# ---------------------------------------------------------------- ledger ----


def test_ledger_2d_coadmit_disjoint_refuse_overlap():
    for _, led in _both():
        led.note_chip_pool(8)
        a = led.try_reserve("a", "job", 40, budget=100, chip_ids=[0, 1, 2, 3])
        b = led.try_reserve("b", "job", 40, budget=100, chip_ids=[4, 5, 6, 7])
        assert a is not None and b is not None  # disjoint sets co-admit
        assert led.occupied_chips() == set(range(8))
        # an overlap is refused with bytes to spare on every chip
        assert led.try_reserve("c", "job", 1, budget=100, chip_ids=[3, 4]) is None
        led.release(b)
        assert led.occupied_chips() == {0, 1, 2, 3}
        assert led.try_reserve("c", "job", 1, budget=100, chip_ids=[3, 4]) is None
        c = led.try_reserve("c", "job", 1, budget=100, chip_ids=[4, 5])
        assert c is not None and c.chips == 2 and c.chip_ids == (4, 5)
        led.release(a)
        led.release(c)


def test_ledger_legacy_claims_budget_every_chip_but_do_not_occupy():
    for _, led in _both():
        led.note_chip_pool(4)
        led.reserve("resident", "serve", 70, chips=4)  # names no chips
        assert led.occupied_chips() == set()
        assert led.try_reserve("j", "job", 40, budget=100, chip_ids=[0, 1]) is None
        r = led.try_reserve("j", "job", 25, budget=100, chip_ids=[0, 1])
        assert r is not None
        assert led.reserved_bytes_on(0) == 95  # 70 everywhere + 25 placed
        assert led.reserved_bytes_on(3) == 70


def test_ledger_rebind_moves_occupancy_bytes_and_utilization():
    got = {}
    for side, led in _both():
        led.note_chip_pool(8)
        r = led.try_reserve("j", "job", 60, budget=100, chip_ids=[0, 1, 2, 3])
        assert r is not None and led.occupied_chips() == {0, 1, 2, 3}
        led.note_admission(100)
        assert led.utilization() == pytest.approx(60 * 4 / (100 * 8))
        led.rebind(r, [4, 5])
        assert led.occupied_chips() == {4, 5}
        assert r.chips == 2
        assert led.reserved_bytes_on(0) == 0 and led.reserved_bytes_on(4) == 60
        assert led.utilization() == pytest.approx(60 * 2 / (100 * 8))
        led.release(r)
        u = led.tenant_usage()["default"]
        assert u["chip_seconds"] >= 0.0 and u["reservations"] == 1.0
        got[side] = {k: v for k, v in led.tenant_usage()["_pool"].items() if k != "byte_seconds"}
    assert got["torch"].keys() == got["jax"].keys()
    assert {k: v for k, v in got["torch"].items() if "seconds" not in k} == \
        {k: v for k, v in got["jax"].items() if "seconds" not in k}


def test_pool_gauges_flow_through_ops_plane_report():
    led = tledger.global_ledger()
    led.note_chip_pool(8)
    r = led.reserve("j", "job", 10, tenant="acme", chip_ids=[0, 1, 2])
    try:
        tenants = ops_plane.report()["tenants"]
        assert tenants["_pool"]["chips_busy"] == 3.0
        assert tenants["_pool"]["chips_total"] == 8.0
        assert tenants["_pool"]["chips_idle"] == 5.0
        assert tenants["acme"]["chips_busy"] == 3.0
    finally:
        led.release(r)
    tenants = ops_plane.report()["tenants"]
    assert tenants["_pool"]["chips_busy"] == 0.0
    assert tenants["_pool"]["chips_idle"] == 8.0
    # the gauges of an admission decision
    led.note_admission(None)
    gauges = telemetry.registry().snapshot()["gauges"]
    assert gauges["scheduler.chips_busy"] == 0 and gauges["scheduler.chips_idle"] == 8


def test_merge_tenant_usage_sums_hosts_as_jax():
    a = {"t": {"byte_seconds": 1.0, "chip_seconds": 2.0, "chips_busy": 2.0},
         "_pool": {"chips_total": 8.0, "chips_idle": 6.0}}
    b = {"t": {"byte_seconds": 3.0, "device_time": {"execute": 1.5}}, "u": {"chip_seconds": 4.0},
         "_pool": {"chips_total": 8.0, "chips_idle": 8.0}}
    assert tledger.merge_tenant_usage([a, b, {}]) == jledger.merge_tenant_usage([a, b, {}])


# ------------------------------------------------------------- scheduler ----


def _blob_data(n=20000, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(8, d))
    return {"features": (centers[rng.integers(0, 8, n)] + rng.normal(size=(n, d))).astype(np.float32)}


def _mk_wide_kmeans(**kw):
    """A half-pool (4-chip) KMeans: the 2-D scheduler's placement unit."""
    est = KMeans(**{"k": 8, "maxIter": 12, "seed": 7, "tol": 0.0, **kw})
    est.num_workers = 4
    return est


def _occupancy_trace(samples):
    """Step integral of occupied chips over the busy window: (mean, peak)."""
    busy = [(t, occ) for t, occ in samples if occ > 0]
    if len(busy) < 2:
        return 0.0, max((occ for _, occ in samples), default=0)
    integral = sum(occ * (t1 - t0) for (t0, occ), (t1, _) in zip(busy, busy[1:]))
    span = busy[-1][0] - busy[0][0]
    return (integral / span if span > 0 else 0.0), max(occ for _, occ in busy)


def _sample(stop, samples):
    while not stop.is_set():
        samples.append((time.monotonic(), len(tledger.global_ledger().occupied_chips())))
        time.sleep(0.002)


def _run_schedule(df, jobs, **sched_kw):
    samples, stop = [], threading.Event()
    poller = threading.Thread(target=_sample, args=(stop, samples))
    sched = FitScheduler(chip_placement=True, **sched_kw)
    try:
        poller.start()
        submitted = [sched.submit(_mk_wide_kmeans(), df, tenant=t) for t in jobs]
        models = [j.result(TIMEOUT) for j in submitted]
    finally:
        stop.set()
        poller.join(5)
        sched.shutdown()
    return models, _occupancy_trace(samples)


def test_coadmission_occupies_both_halves_and_stays_bit_identical():
    df = _blob_data()
    ref = _mk_wide_kmeans().fit(df)  # the job alone, on the first half
    gate = threading.Event()
    sched = FitScheduler(chip_placement=True)
    try:
        def gated():
            est = _mk_wide_kmeans()
            real = est.fit
            est.fit = lambda d, *a, **k: (gate.wait(TIMEOUT), real(d, *a, **k))[1]
            return est

        ja = sched.submit(gated(), df, tenant="a")
        jb = sched.submit(gated(), df, tenant="b")
        jc = sched.submit(gated(), df, tenant="c")
        st = sched.stats()
        # the third queues on chip overlap alone: no budget is set
        assert st["running"] == 2 and st["queued"] == 1 and st["chip_placement"]
        assert st["ledger_occupied_chips"] == list(range(8))
        gate.set()
        ma, mb, mc = (j.result(TIMEOUT) for j in (ja, jb, jc))
    finally:
        gate.set()
        sched.shutdown()
    chips = [m._fit_metrics["scheduler"]["chip_ids"] for m in (ma, mb, mc)]
    assert chips[0] == [0, 1, 2, 3] and chips[1] == [4, 5, 6, 7] and len(chips[2]) == 4
    assert ma._fit_metrics["multidevice"]["chip_ids"] == [0, 1, 2, 3]
    assert mb._fit_metrics["multidevice"]["chip_ids"] == [4, 5, 6, 7]
    (mca, mcb), (avg_conc, peak_conc) = _run_schedule(df, ("a", "b"))
    (msa, msb), (avg_sliced, peak_sliced) = _run_schedule(df, ("a", "b"), max_concurrent=1)
    assert peak_conc == 8 and peak_sliced == 4
    assert avg_sliced > 0 and avg_conc / avg_sliced >= 1.5, (avg_conc, avg_sliced)
    for m in (ma, mb, mc, mca, mcb, msa, msb):
        np.testing.assert_array_equal(np.asarray(m.cluster_centers_), np.asarray(ref.cluster_centers_))


def _set_budget(raw_bytes):
    tcore.config["hbm_budget_bytes"] = int(raw_bytes / 0.9) + 16


def test_preempted_job_resumes_on_different_chip_set_bit_identically():
    df = _blob_data(n=6000, d=8, seed=1)
    tcore.config["checkpoint_every_iters"] = 2
    est_a = _mk_wide_kmeans(maxIter=40)
    extracted = est_a._pre_process_data(df, for_fit=True, defer_validation=True)
    need = memory.resident_estimate(est_a, extracted, 4).total()
    _set_budget(3 * need + 4096)
    clean = _mk_wide_kmeans(maxIter=40).fit(df)
    led = tledger.global_ledger()
    # a resident serving claim holds the left half: the job lands on the right
    serve = led.reserve("serve:pin", "serve", 1024, tenant="svc", chip_ids=[0, 1, 2, 3])
    sched = FitScheduler(chip_placement=True)
    try:
        ja = sched.submit(_mk_wide_kmeans(maxIter=40), df, tenant="low")
        saved, go = threading.Event(), threading.Event()
        real_save = ja.store.chip_store(0).save

        def save(key, ckpt):
            real_save(key, ckpt)
            if not saved.is_set():
                saved.set()
                assert go.wait(TIMEOUT)

        ja.store.chip_store(0).save = save
        assert saved.wait(TIMEOUT), "the first job never checkpointed"
        first_chips = tuple(ja.chip_ids)
        assert first_chips == (4, 5, 6, 7)
        jb = sched.submit(_mk_wide_kmeans(maxIter=4), df, tenant="high", priority=10)
        go.set()
        deadline = time.monotonic() + TIMEOUT
        while jb.chip_ids is None and not jb.done() and time.monotonic() < deadline:
            time.sleep(0.002)
        assert tuple(jb.chip_ids or ()) == (4, 5, 6, 7)  # the preemptor takes the freed run
        led.release(serve)  # the replica drains: the left half opens for the resume
        serve = None
        jb.result(TIMEOUT)
        # a pass after the release (releases do not reschedule): a filler
        filler = KMeans(k=2, maxIter=2, seed=1)
        filler.num_workers = 1
        sched.submit(filler, df, tenant="filler").result(TIMEOUT)
        resumed = ja.result(TIMEOUT)
    finally:
        go.set()
        led.release(serve)
        sched.shutdown()
    st = resumed._fit_metrics["scheduler"]
    assert st["preemptions"] == 1 and st["resumes"] == 1
    assert tuple(st["chip_ids"]) == (0, 1, 2, 3) != first_chips
    np.testing.assert_array_equal(np.asarray(resumed.cluster_centers_), np.asarray(clean.cluster_centers_))


def test_scheduler_job_and_fit_admission_charge_the_same_chips():
    rng = np.random.default_rng(1)
    df = {"features": rng.standard_normal((400, 4)).astype(np.float32)}
    est = KMeans(k=2, maxIter=2, seed=1)
    est.num_workers = 8
    sched = FitScheduler(max_concurrent=1)
    try:
        job = sched.submit(est, df, tenant="t8")
        job.result(TIMEOUT)
    finally:
        sched.shutdown(wait=True, timeout=30)
    assert job.chips == 8 and job.stats()["chip_ids"] is None  # bytes only without placement
    est2 = KMeans(k=2, maxIter=2, seed=1)
    est2.num_workers = 8
    est2.fit(df)
    assert est2._last_admission.chips == 8
    assert tledger.global_ledger().tenant_usage()["t8"]["chip_seconds"] > 0


def test_a_pinned_fit_budgets_and_claims_its_own_chips():
    led = tledger.global_ledger()
    other = led.reserve("other", "fit", 10_000, chip_ids=[0, 1])
    try:
        with parallel.chip_scope(parallel.default_devices()[4:]):
            assert memory._claimed_chips() == (4, 5, 6, 7)
            est = KMeans(k=2, maxIter=2, seed=1)
            data = {"features": np.random.default_rng(2).normal(size=(200, 3)).astype(np.float32)}
            need = memory.resident_estimate(est, est._pre_process_data(data, for_fit=True), 4).total()
            # the bytes on chips 0-1 do not count against chips 4-7
            _set_budget(need + 100)
            est.fit(data)
            assert est._last_admission.chips == 4 and est._last_admission.verdict == "resident"
    finally:
        led.release(other)


def test_chips_sharing_a_card_share_its_budget():
    """Two chips on one card (a pool naming the card twice, as phase 19 of
    chip_smoke.py runs on a one-card host) hold the card's memory between
    them: a fan-out's two blocks are admitted against one card's budget,
    and a claim on either chip counts on the other. CPU entries stay one
    chip each (the virtual pool above), so the pool here names a card; only
    the ledger and the admission run, nothing is placed."""
    import torch

    est = KMeans(k=2, maxIter=2, seed=1)
    data = {"features": np.random.default_rng(3).normal(size=(4000, 16)).astype(np.float32)}
    extracted = est._pre_process_data(data, for_fit=True)
    need = memory.resident_estimate(est, extracted, 2).total()
    _set_budget(need + need // 2)  # one block fits the budget, two do not
    card = torch.device("cuda", 0)
    parallel.set_devices(["cuda:0", "cuda:1"])
    adm = memory.admit_fit(est, extracted, card, n_devices=2)
    tledger.global_ledger().release(adm.reservation)
    assert adm.verdict == "resident"
    parallel.set_devices(["cuda:0", "cuda:0"])
    assert parallel.card_groups() == [(0, 1)]
    adm = memory.admit_fit(est, extracted, card, n_devices=2)
    tledger.global_ledger().release(adm.reservation)
    assert adm.verdict == "stream" and "2 of its chips share one card" in adm.reason
    led = tledger.HbmLedger()
    fan = led.reserve("fan", "fit", 100, chips=2)  # names no chips: a block on each
    assert led.reserved_bytes_on(0) == led.reserved_bytes_on(1) == 200
    assert led.reserved_bytes_per_card() == 200
    # a job placed on chip 1 alone is refused: chip 0's block is on its card
    assert led.try_reserve("j", "job", 60, budget=250, chip_ids=[1]) is None
    led.release(fan)
    j = led.try_reserve("j", "job", 60, budget=250, chip_ids=[1])
    assert j is not None and led.reserved_bytes_on(0) == 60
    # two chips of one card take the claim's bytes twice
    assert led.try_reserve("k", "job", 100, budget=250, chip_ids=[0]) is not None
    assert led.try_reserve("w", "job", 50, budget=250, chip_ids=[0, 1]) is None
    parallel.set_devices(["cuda:0", "cuda:1"])
    assert led.reserved_bytes_on(0) == 100 and led.reserved_bytes_on(1) == 60
