#
# The PyTorch port's out-of-core fits (spark_rapids_ml_tpu_torch/
# ops/streaming.py, core.py's admission and OOM ladder,
# parallel.stream_place_blocks) on the CPU, after tests/test_oocore.py's
# dense cases, against the port's own resident fits and the JAX package's
# streamed fits on the same numpy inputs, with `hbm_budget_bytes` and
# `stream_chunk_rows` set alike in both packages' config. Both sides place on
# one device (the JAX estimators with num_workers=1), so one budget demotes
# both; 2000 rows in 512-row chunks make four chunks per pass.
#
# Tolerances, and why:
#   * streamed against resident, float64: rtol 1e-9, the JAX package's pin
#     (the same formulas, the sums taken per chunk and then over chunks);
#   * streamed against JAX's streamed, float64: linear and PCA rtol 1e-9
#     (the same statistics, another summation order), KMeans rtol 1e-9 (the
#     same assignments), logistic rtol 1e-7 (the same iterations: a
#     rounding difference in the first iterate is amplified by the
#     quasi-Newton steps, yet stays far below the stopping tol of 1e-6);
#   * the same iteration counts wherever a loop runs.
#
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu import telemetry as jtele
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.models.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.models.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.models.regression import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu_torch import (
    CrossValidator,
    KMeans,
    LinearRegression,
    LogisticRegression,
    ParamGridBuilder,
    PCA,
    RandomForestClassifier,
    RegressionEvaluator,
    core,
    memory,
    parallel,
    set_devices,
    telemetry,
)
from spark_rapids_ml_tpu_torch.errors import HbmBudgetError, IngestValidationError
from spark_rapids_ml_tpu_torch.ops import streaming
from spark_rapids_ml_tpu_torch.parallel import chaos
from spark_rapids_ml_tpu_torch.scheduler import ledger as tledger

_KEYS = ("hbm_budget_bytes", "hbm_headroom_fraction", "stream_chunk_rows", "validate_ingest")

# per-estimator budgets that demote a 2000 x 6 float64 fit and admit its
# 512-row chunks, on one device in both packages
_BUDGETS = {"linear": 100_000, "pca": 100_000, "logistic": 100_000, "kmeans": 140_000}


@pytest.fixture
def tele(monkeypatch):
    """The port on the CPU, telemetry on with a fresh registry, a fresh
    ledger, both packages' memory config restored, no fault plan."""
    set_devices("cpu")
    telemetry.enable()
    telemetry.registry().reset()
    monkeypatch.setattr(tledger, "_GLOBAL", tledger.HbmLedger())
    saved = {k: core.config[k] for k in _KEYS}
    jsaved = {k: jcore.config[k] for k in _KEYS}
    yield telemetry
    core.config.update(saved)
    jcore.config.update(jsaved)
    chaos.clear_fault_plan()
    telemetry.disable()
    telemetry.registry().reset()
    set_devices(None)


def _budget(budget, chunk=512):
    for cfg in (core.config, jcore.config):
        cfg["hbm_budget_bytes"] = budget
        cfg["stream_chunk_rows"] = chunk if budget else 0


def _counters():
    return telemetry.registry().snapshot()["counters"]


def _data(kind, seed=0, n=2000, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    if kind == "linear":
        return {"features": x, "label": x @ rng.normal(size=d) + 0.5 + 0.05 * rng.normal(size=n)}
    if kind == "binomial":
        return {"features": x, "label": (x @ rng.normal(size=d) > 0).astype(np.float64)}
    if kind == "multinomial":
        return {"features": x, "label": rng.integers(0, 3, size=n).astype(np.float64)}
    return {"features": x}


_CASES = {
    "linear": (lambda cls: cls(regParam=0.001, float32_inputs=False), LinearRegression, JaxLinearRegression,
               "linear", ("coef_", "intercept_")),
    "pca": (lambda cls: cls(k=3, float32_inputs=False).setInputCol("features"), PCA, JaxPCA, "rows",
            ("components_", "explained_variance_", "mean_")),
    "kmeans": (lambda cls: cls(k=4, seed=7, maxIter=15, float32_inputs=False), KMeans, JaxKMeans, "rows",
               ("cluster_centers_",)),
    "binomial": (lambda cls: cls(regParam=0.01, float32_inputs=False), LogisticRegression, JaxLogisticRegression,
                 "binomial", ("coef_", "intercept_")),
    "multinomial": (lambda cls: cls(regParam=0.01, float32_inputs=False), LogisticRegression,
                    JaxLogisticRegression, "multinomial", ("coef_", "intercept_")),
}


def _budget_of(case):
    return _BUDGETS["logistic" if case in ("binomial", "multinomial") else case]


def _assert_streamed(model):
    adm = model._fit_metrics["admission"]
    assert adm["verdict"] == "stream" and adm["chunk_rows"] == 512 and adm["reason"]
    assert _counters().get("fit.demotions") == 1
    return adm


# ----------------------------------------------------- parity: dense --------


@pytest.mark.parametrize("case", list(_CASES))
def test_streamed_fit_matches_the_resident_fit(tele, case):
    make, cls, _, kind, attrs = _CASES[case]
    data = _data(kind)
    _budget(None)
    res = make(cls).fit(data)
    assert res._fit_metrics["admission"]["verdict"] == "resident"  # telemetry on: stamped
    telemetry.registry().reset()
    _budget(_budget_of(case))
    stream = make(cls).fit(data)
    _assert_streamed(stream)
    for a in attrs:
        np.testing.assert_allclose(np.asarray(getattr(stream, a)), np.asarray(getattr(res, a)), rtol=1e-9, atol=1e-12)
    if hasattr(res, "n_iter_"):
        assert stream.n_iter_ == res.n_iter_


@pytest.mark.parametrize("case", list(_CASES))
def test_streamed_fit_matches_the_jax_streamed_fit(tele, case):
    make, cls, jcls, kind, attrs = _CASES[case]
    data = _data(kind, seed=3)
    _budget(_budget_of(case))
    jtele.enable()
    try:
        jm = make(lambda **kw: jcls(num_workers=1, **kw)).fit(data)
    finally:
        jtele.disable()
    tm = make(cls).fit(data)
    assert jm._fit_metrics["admission"]["verdict"] == tm._fit_metrics["admission"]["verdict"] == "stream"
    assert jm._fit_metrics["admission"]["chunk_rows"] == tm._fit_metrics["admission"]["chunk_rows"]
    rtol = 1e-7 if case in ("binomial", "multinomial") else 1e-9
    for a in attrs:
        np.testing.assert_allclose(np.asarray(getattr(tm, a)), np.asarray(getattr(jm, a)), rtol=rtol, atol=1e-10)
    if hasattr(jm, "n_iter_"):
        assert int(np.max(tm.n_iter_)) == int(np.max(jm.n_iter_))


def test_overlap_and_stream_counters_of_a_four_chunk_pass(tele):
    _budget(_BUDGETS["linear"])
    LinearRegression(regParam=0.001, float32_inputs=False).fit(_data("linear"))
    snap = telemetry.registry().snapshot()
    # one statistics pass: four chunks, three of them prefetched while the
    # caller worked on the one before (the CPU's copies are done at once)
    assert snap["counters"]["ingest.stream_chunks"] == 4
    assert snap["counters"]["ingest.stream_rows"] == 2000
    assert snap["gauges"]["ingest.overlap_fraction"] == pytest.approx(0.75)


def test_streamed_float32_and_fast_fits_stay_near_the_resident_ones(tele):
    x = np.random.default_rng(4).normal(size=(2000, 6)).astype(np.float32)
    for params, rtol in (({}, 1e-5), ({"solver_precision": "bf16"}, 1e-5)):
        _budget(None)
        res = KMeans(k=4, seed=7, maxIter=5, distance_precision="high", **params).fit({"features": x})
        _budget(70_000)
        stream = KMeans(k=4, seed=7, maxIter=5, distance_precision="high", **params).fit({"features": x})
        assert stream._fit_metrics["admission"]["verdict"] == "stream"
        np.testing.assert_allclose(stream.cluster_centers_, res.cluster_centers_, rtol=rtol, atol=rtol)
        assert stream.n_iter_ == res.n_iter_
        np.testing.assert_allclose(stream.inertia_, res.inertia_, rtol=1e-5)


@pytest.mark.parametrize("f32,params", [(False, {}), (True, {"distance_precision": "high"}),
                                         (True, {"solver_precision": "bf16"})])
def test_streamed_kmeans_equals_the_resident_loop_bit_for_bit(tele, f32, params):
    # chunks of whole Lloyd tiles (tiles of 256 rows) summed into one
    # set of accumulators: the resident loop's additions in its order
    x = np.random.default_rng(5).normal(size=(2000, 6))
    kw = dict(k=4, seed=7, maxIter=6, tol=1e-20, float32_inputs=f32, max_samples_per_batch=256, **params)
    _budget(None)
    res = KMeans(**kw).fit({"features": x})
    _budget(70_000 if f32 else _BUDGETS["kmeans"])
    stream = KMeans(**kw).fit({"features": x})
    adm = stream._fit_metrics["admission"]
    assert adm["verdict"] == "stream" and adm["chunk_rows"] >= 256  # one tile or more a chunk
    np.testing.assert_array_equal(stream.cluster_centers_, res.cluster_centers_)
    assert stream.inertia_ == res.inertia_ and stream.n_iter_ == res.n_iter_


def test_streamed_float32_logistic_fit_runs_its_host_algebra_in_float64(tele):
    # the streamed fit's per-row algebra runs on the host in float64, so its
    # float32 objective is the float64 objective of its own coefficients to
    # float32 rounding
    rng = np.random.default_rng(6)
    x = rng.normal(size=(20000, 6)).astype(np.float32)
    y = (x @ rng.normal(size=6) + 0.3 * rng.normal(size=20000) > 0).astype(np.float32)
    _budget(400_000, chunk=0)
    m = LogisticRegression(regParam=1e-5, maxIter=10, tol=1e-30).fit({"features": x, "label": y})
    assert m._fit_metrics["admission"]["verdict"] == "stream"
    x64 = x.astype(np.float64)
    z = x64 @ m.coef_.astype(np.float64)[0] + float(m.intercept_[0])
    b = m.coef_.astype(np.float64)[0] * x64.std(axis=0, ddof=1)
    f64 = np.mean(np.logaddexp(0.0, z) - y * z) + 0.5 * 1e-5 * np.sum(b * b)
    assert abs(float(m.objective_) - f64) <= 2e-7 * f64


def test_a_streamed_kmeans_chunk_is_whole_lloyd_tiles(tele):
    # a chunk larger than max_samples_per_batch is cut to a multiple of it,
    # so the kernels see the resident loop's tiles
    _budget(_BUDGETS["kmeans"], chunk=700)
    seen = []
    from spark_rapids_ml_tpu_torch.ops import distance

    orig = distance.tile_assign_accumulate

    def spy(X, w, c, batch_rows, fast=False, acc=None):
        seen.append((X.shape[0], batch_rows))
        return orig(X, w, c, batch_rows, fast, acc=acc)

    distance.tile_assign_accumulate = spy
    try:
        m = KMeans(k=4, seed=7, maxIter=2, float32_inputs=False, max_samples_per_batch=256).fit(_data("rows"))
    finally:
        distance.tile_assign_accumulate = orig
    assert m._fit_metrics["admission"]["chunk_rows"] == 700  # the admitted chunk
    assert {rows for rows, _ in seen} == {512, 2000 - 3 * 512} and {b for _, b in seen} == {256}


# ----------------------------------------------------- typed failures -------


def test_overbudget_even_streaming_raises_typed_error(tele):
    _budget(1_000)
    with pytest.raises(HbmBudgetError) as ei:
        LinearRegression(float32_inputs=False).fit(_data("linear"))
    assert ei.value.largest_term == "stream.chunk_buffers"
    assert "stream.chunk_buffers" in str(ei.value)
    assert ei.value.estimate_bytes > ei.value.capacity_bytes


def test_l1_logistic_demotion_refuses_typed(tele):
    _budget(_BUDGETS["logistic"])
    with pytest.raises(HbmBudgetError, match="OWL-QN") as ei:
        LogisticRegression(regParam=0.01, elasticNetParam=1.0, float32_inputs=False).fit(_data("binomial"))
    assert ei.value.largest_term == "solver.owlqn"


def test_an_unstreamable_estimator_over_budget_names_its_largest_term(tele):
    _budget(50_000)
    with pytest.raises(HbmBudgetError, match="no out-of-core streaming path") as ei:
        RandomForestClassifier(numTrees=2, maxDepth=3).fit(_data("binomial"))
    assert ei.value.largest_term == "placement.X"


# ------------------------------------------------------- OOM ladder ---------


@pytest.mark.parametrize("case", list(_CASES))
def test_oom_at_placement_converts_and_streams(tele, case, monkeypatch):
    # at the defaults (no budget, no chunk override), with the allocator
    # reporting as little room as the case's budget leaves: the retry's
    # chunk comes from what the allocator can hand out
    make, cls, _, kind, attrs = _CASES[case]
    data = _data(kind)
    base = make(cls).fit(data)
    telemetry.registry().reset()
    monkeypatch.setattr(parallel, "device_allocatable_bytes", lambda device: _budget_of(case))
    chaos.set_fault_plan("oom:stage=placement")
    model = make(cls).fit(data)
    adm = model._fit_metrics["admission"]
    assert adm["verdict"] == "stream" and adm["reason"].startswith("backend OOM")
    assert adm["reason"].endswith(f"(sized against {_budget_of(case)} bytes the allocator can hand out)")
    assert 256 <= adm["chunk_rows"] < 2000 and adm["estimate_bytes"] <= 0.9 * _budget_of(case)
    assert _counters()["memory.oom_caught"] == 1
    for a in attrs:
        np.testing.assert_allclose(np.asarray(getattr(model, a)), np.asarray(getattr(base, a)), rtol=1e-9, atol=1e-12)
    assert tledger.global_ledger().reserved_bytes() == 0


def test_the_oom_retry_sizes_its_chunk_below_the_budget_by_the_allocators_room(tele, monkeypatch):
    # a fit admitted resident under a large budget fails to place; the
    # retry's chunk is sized against the smaller of the budget and the
    # allocator's room, never the budget alone (which admitted the rows)
    data = _data("linear")
    _budget(10 ** 9, chunk=0)
    room = 60_000
    monkeypatch.setattr(parallel, "device_allocatable_bytes", lambda device: room)
    chaos.set_fault_plan("oom:stage=placement")
    model = LinearRegression(regParam=0.001, float32_inputs=False).fit(data)
    adm = model._fit_metrics["admission"]
    assert adm["verdict"] == "stream" and adm["budget_bytes"] == int(10 ** 9 * 0.9)
    rb = (6 + 2) * 8
    ws = adm["estimate_bytes"] - 2 * adm["chunk_rows"] * rb
    assert adm["chunk_rows"] == (int(room * 0.9) - ws) // (2 * rb)
    assert adm["chunk_rows"] < 2000 and _counters()["ingest.stream_chunks"] >= 2  # the budget alone: one chunk


def test_a_second_oom_raises_typed(tele):
    # round-less `oom:stage=solve` fires as the solves dispatch: once on the
    # resident attempt, once more on the streamed retry
    chaos.set_fault_plan("oom:stage=solve:times=2")
    with pytest.raises(HbmBudgetError, match="backend out-of-memory") as ei:
        LinearRegression(float32_inputs=False).fit(_data("linear"))
    assert ei.value.largest_term == "stream.chunk_buffers"  # the retry's admission
    assert _counters()["memory.oom_caught"] == 1
    assert tledger.global_ledger().reserved_bytes() == 0


def test_unstreamable_estimator_oom_raises_typed(tele):
    chaos.set_fault_plan("oom:stage=placement")
    with pytest.raises(HbmBudgetError, match="backend out-of-memory") as ei:
        RandomForestClassifier(numTrees=2, maxDepth=3).fit(_data("binomial"))
    assert ei.value.largest_term == "placement.X"  # the failed placement's term
    assert isinstance(ei.value.__cause__, torch.OutOfMemoryError)


def test_an_oom_evicts_the_scopes_placements(tele):
    data = _data("linear")
    with core.device_dataset_scope() as scope:
        LinearRegression(regParam=0.001, float32_inputs=False).fit(data)
        assert len(scope.cache) == 1
        chaos.set_fault_plan("oom:stage=solve")
        m = LinearRegression(regParam=0.002, float32_inputs=False).fit(data)
        assert m._fit_metrics["admission"]["verdict"] == "stream"
        assert len(scope.cache) == 0
    c = _counters()
    assert c["fit.device_dataset_evictions"] == 1 and c["memory.oom_caught"] == 1


# ------------------------------------------------ streaming semantics -------


def test_streamed_dataset_not_cached_in_scope(tele):
    data = _data("linear")
    _budget(_BUDGETS["linear"])
    with core.device_dataset_scope() as scope:
        LinearRegression(regParam=0.001, float32_inputs=False).fit(data)
        assert _counters().get("fit.device_dataset_builds") is None
        LinearRegression(regParam=0.002, float32_inputs=False).fit(data)
        c = _counters()
        assert c.get("fit.device_dataset_reuses") is None
        assert c.get("fit.demotions") == 2 and c.get("memory.admission_stream") == 2
        assert len(scope.cache) == 0 and scope.last.inputs.stream is not None


def test_a_demotion_is_stamped_with_telemetry_off(tele):
    telemetry.disable()
    data = _data("linear")
    assert LinearRegression(float32_inputs=False).fit(data)._fit_metrics == {}
    _budget(_BUDGETS["linear"])
    assert LinearRegression(float32_inputs=False).fit(data)._fit_metrics["admission"]["verdict"] == "stream"


def test_a_fold_mask_on_streamed_inputs_is_the_weight_column_fit(tele):
    data = _data("linear")
    mask = (np.arange(2000) % 3 != 0).astype(np.float64)
    _budget(_BUDGETS["linear"])
    masked = LinearRegression(regParam=0.001, float32_inputs=False)._fit_internal(data, None, row_mask=mask)[0]
    weighted = LinearRegression(regParam=0.001, float32_inputs=False, weightCol="w").fit({**data, "w": mask})
    assert masked._fit_metrics["admission"]["verdict"] == "stream"
    np.testing.assert_allclose(masked.coef_, weighted.coef_, rtol=1e-12)


def test_cross_validation_over_a_streamed_dataset(tele):
    data = _data("linear")
    est = LinearRegression(float32_inputs=False)
    grid = ParamGridBuilder().addGrid(est.getParam("regParam"), [1e-3, 1e-1]).build()
    cv = CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=RegressionEvaluator(), numFolds=2, seed=3)
    resident = cv.fit(data).avgMetrics
    _budget(_BUDGETS["linear"])
    streamed = cv.fit(data).avgMetrics
    assert _counters()["fit.demotions"] == 3  # each fold's fit and the refit streamed
    np.testing.assert_allclose(streamed, resident, rtol=1e-9)


def test_streaming_validation_names_column_and_row(tele):
    data = _data("linear")
    data["features"] = data["features"].copy()
    data["features"][1400, 2] = np.nan
    _budget(_BUDGETS["linear"])
    core.config["validate_ingest"] = True
    scanned = []
    real = streaming._maybe_validate

    def spy(plan, lo, hi):
        real(plan, lo, hi)
        scanned.append((lo, hi))

    streaming._maybe_validate = spy
    try:
        with pytest.raises(IngestValidationError) as ei:
            LinearRegression(float32_inputs=False).fit(data)
    finally:
        streaming._maybe_validate = real
    assert ei.value.column == "features" and ei.value.row == 1400
    assert "1400" in str(ei.value)
    # block by block, as the chunks entered the stream: the first two
    # passed, the third raised
    assert scanned == [(0, 512), (512, 1024)]


def test_streaming_validation_scans_each_block_once(tele):
    _budget(_BUDGETS["kmeans"])
    core.config["validate_ingest"] = True
    scanned = []
    real = streaming._maybe_validate
    streaming._maybe_validate = lambda plan, lo, hi: (scanned.append(lo >= plan.validated_rows), real(plan, lo, hi))
    try:
        m = KMeans(k=4, seed=7, maxIter=3, tol=0.0, float32_inputs=False).fit(_data("rows"))
    finally:
        streaming._maybe_validate = real
    # every pass visits every block; only the first pass scans
    assert m.n_iter_ == 3 and scanned.count(True) == 4 and len(scanned) == 4 * (3 + 1)


def test_resident_validation_is_eager_and_before_placement(tele):
    data = _data("linear", n=300)
    data["features"] = data["features"].copy()
    data["features"][42, 0] = np.inf
    core.config["validate_ingest"] = True
    chaos.set_fault_plan("oom:stage=placement")  # would fire at placement
    with pytest.raises(IngestValidationError, match="42"):
        LinearRegression(float32_inputs=False).fit(data)
    assert chaos.active_plan()[0].fired == 0


def test_memory_watermark_sampled_at_chunk_boundaries(tele, monkeypatch):
    # stream_place_blocks samples record_device_memory once per chunk; on
    # the CPU there are no statistics, so the samples are counted, and the
    # counters every streamed pass leaves behind are checked
    calls = []
    real = telemetry.record_device_memory
    monkeypatch.setattr(telemetry, "record_device_memory", lambda device=None: (calls.append(device), real(device)))
    _budget(_BUDGETS["pca"])
    PCA(k=3, float32_inputs=False).setInputCol("features").fit(_data("rows"))
    c = _counters()
    assert c["ingest.stream_chunks"] == 8 and c["ingest.stream_rows"] == 4000  # two passes
    assert len(calls) == 8 and all(d.type == "cpu" for d in calls)
    assert "device.peak_bytes_in_use" not in telemetry.registry().snapshot()["gauges"]


# --------------------------------------------------------- the pipeline -----


def test_stream_place_blocks_on_the_cpu_equals_place_rows(tele):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1000, 5)).astype(np.float32)
    y = rng.integers(0, 3, size=1000)
    blocks = [{"X": x[lo:lo + 300], "y": y[lo:lo + 300]} for lo in range(0, 1000, 300)]
    out = list(parallel.stream_place_blocks(iter(blocks), device=torch.device("cpu")))
    assert [set(o) for o in out] == [{"X", "y"}] * 4
    for lo, o in zip(range(0, 1000, 300), out):
        X, _ = parallel.place_rows(x[lo:lo + 300], device=torch.device("cpu"))
        assert torch.equal(o["X"], X) and o["X"].dtype == torch.float32
        assert torch.equal(o["y"], torch.from_numpy(y[lo:lo + 300]))
    assert telemetry.registry().snapshot()["gauges"]["ingest.overlap_fraction"] == pytest.approx(0.75)
    assert list(parallel.stream_place_blocks(iter([]), device=torch.device("cpu"))) == []


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU: the pinned, side-stream pipeline")
def test_stream_place_blocks_on_a_card_equals_place_rows_and_overlaps():
    dev = torch.device("cuda", 0)
    x = np.random.default_rng(1).normal(size=(40000, 256)).astype(np.float32)
    blocks = [{"X": x[lo:lo + 10000]} for lo in range(0, 40000, 10000)]
    telemetry.enable()
    telemetry.registry().reset()
    staging = parallel.StreamStaging()
    for i, blk in enumerate(parallel.stream_place_blocks(iter(blocks), device=dev, staging=staging)):
        X, _ = parallel.place_rows(blocks[i]["X"], device=dev)
        assert torch.equal(blk["X"], X)
        torch.cuda._sleep(50_000_000)  # a caller that computes longer than a copy takes
        torch.cuda.synchronize()
    assert telemetry.registry().snapshot()["gauges"]["ingest.overlap_fraction"] > 0
    telemetry.disable()
