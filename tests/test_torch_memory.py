#
# The PyTorch port's fit-side memory admission (spark_rapids_ml_tpu_torch/
# memory.py, the estimators' `_solver_workspace_terms`, parallel/chaos.py's
# `oom` half, the shared ledger) against the JAX package's on the same
# numpy inputs and the same config, after tests/test_memory.py. Every
# estimate is exact arithmetic, so the tests demand equality, not a
# tolerance: the terms under the JAX package's names equal JAX's, and the
# port's own terms (LogisticRegression `fast`'s bf16 copy of X, KMeans
# `fast`'s bf16 row tile) equal analytic counts. The port places on one
# device, so JAX's admission runs against a one-device context. CPU
# throughout: no capacity, so verdicts are driven by `hbm_budget_bytes` and
# by chaos-injected budgets, in both packages alike.
#
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu import memory as jmemory
from spark_rapids_ml_tpu.data import ExtractedData as JaxExtractedData
from spark_rapids_ml_tpu.models.classification import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu.models.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.models.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.models.regression import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu.parallel import chaos as jchaos
from spark_rapids_ml_tpu.scheduler import ledger as jledger
from spark_rapids_ml_tpu_torch import memory
from spark_rapids_ml_tpu_torch.core import config
from spark_rapids_ml_tpu_torch.data import ExtractedData
from spark_rapids_ml_tpu_torch.errors import HbmBudgetError
from spark_rapids_ml_tpu_torch.models.classification import LogisticRegression, RandomForestClassifier
from spark_rapids_ml_tpu_torch.models.clustering import KMeans
from spark_rapids_ml_tpu_torch.models.feature import PCA
from spark_rapids_ml_tpu_torch.models.regression import LinearRegression
from spark_rapids_ml_tpu_torch.parallel import chaos
from spark_rapids_ml_tpu_torch.scheduler import ledger as tledger

_KEYS = ("hbm_budget_bytes", "hbm_headroom_fraction", "stream_chunk_rows", "distance_tile_rows",
         "solver_precision")


@pytest.fixture(autouse=True)
def clean_config(monkeypatch):
    """Both packages' memory config restored after each test, fresh shared
    ledgers, no fault plan."""
    saved = {k: config[k] for k in _KEYS}
    jsaved = {k: jcore.config[k] for k in _KEYS}
    monkeypatch.setattr(tledger, "_GLOBAL", tledger.HbmLedger())
    monkeypatch.setattr(jledger, "_GLOBAL", jledger.HbmLedger())
    yield config
    config.update(saved)
    jcore.config.update(jsaved)
    chaos.clear_fault_plan()
    jchaos.clear_fault_plan()


def _set(**kv):
    """The same config keys in both packages."""
    config.update(kv)
    jcore.config.update(kv)


class _OneDevice:
    """JAX's admission context on one device (the port's placement)."""

    def __init__(self):
        self.mesh = type("M", (), {"devices": np.array([0])})()
        self.is_spmd = False


def _extracted(n=1000, d=12, label=True, dtype=np.float64):
    """The same rows as the port's and the JAX package's ExtractedData."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(dtype)
    y = rng.normal(size=n).astype(dtype) if label else None
    return (ExtractedData(x, label=y, feature_names=["features"]),
            JaxExtractedData(features=x, label=y, feature_names=["features"]))


def _pair(name, **kw):
    """(port estimator, JAX estimator) with the same params."""
    ports = {"linear": LinearRegression, "pca": PCA, "kmeans": KMeans, "logistic": LogisticRegression}
    jaxes = {"linear": JaxLinearRegression, "pca": JaxPCA, "kmeans": JaxKMeans, "logistic": JaxLogisticRegression}
    return ports[name](**kw), jaxes[name](num_workers=1, **kw)


# ------------------------------------------------------------- formulas -----


@pytest.mark.parametrize("n,dev", [(1000, 8), (1001, 8), (7, 8), (0, 8), (5, 1), (12345, 1)])
def test_rows_per_device_equals_jax(n, dev):
    assert memory.rows_per_device(n, dev) == jmemory.rows_per_device(n, dev)
    assert memory.rows_per_device(n, 1) == n


@pytest.mark.parametrize("label", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dense_placement_terms_and_row_bytes_equal_jax(label, dtype):
    ex, jex = _extracted(label=label, dtype=dtype)
    terms = memory.placement_terms(ex, dtype)
    assert terms == jmemory.placement_terms(jex, dtype, 1)
    item = np.dtype(dtype).itemsize
    assert terms["placement.X"] == 1000 * 12 * item
    assert ("placement.y" in terms) == label
    assert memory.row_bytes(ex, dtype) == jmemory.row_bytes(jex, dtype) == (12 + label + 1) * item


def test_sparse_branches_equal_jax_on_a_csr_extraction():
    # the padded-ELL terms are kept for A11b: on the JAX package's sparse
    # extraction they give JAX's bytes, padding cells included
    csr = sp.random(600, 40, density=0.1, format="csr", random_state=2)
    jex = JaxExtractedData(features=csr, label=np.zeros(600), feature_names=["features"])
    k_max = int(np.diff(csr.indptr).max())
    assert memory.ell_k_max(csr) == jmemory.ell_k_max(csr) == k_max
    assert memory.placement_terms(jex, np.float64, 8) == jmemory.placement_terms(jex, np.float64, 8)
    assert memory.row_bytes(jex, np.float64) == jmemory.row_bytes(jex, np.float64) == k_max * 12 + 16


def test_memory_estimate_largest_names_dominant_term():
    est = memory.MemoryEstimate({"a": 10, "b": 300, "c": 2})
    assert est.total() == 312
    assert est.largest() == ("b", 300)
    assert memory.MemoryEstimate({}).largest() == ("", 0)


# ---------------------------------------------------- workspace hooks -------


@pytest.mark.parametrize("name,kw", [
    ("linear", {}), ("pca", {"k": 3}), ("kmeans", {"k": 5}), ("logistic", {}),
    ("logistic", {"family": "multinomial"}),
])
@pytest.mark.parametrize("f32", [True, False], ids=["float32", "float64"])
@pytest.mark.parametrize("rows", [125, 10 ** 6])
def test_workspace_terms_under_jax_names_equal_jax(name, kw, f32, rows):
    est, jest = _pair(name, float32_inputs=f32, **kw)
    item = 4 if f32 else 8
    terms = est._solver_workspace_terms(rows, 12, dict(est._solver_params), item)
    jterms = jest._solver_workspace_terms(rows, 12, dict(jest._solver_params), item)
    assert {k: v for k, v in terms.items() if k in jterms} == jterms
    # the port's own terms, and only them, beside JAX's
    extra = {k: v for k, v in terms.items() if k not in jterms}
    if name == "kmeans" and f32:  # distance_precision "fast" is KMeans's default
        b = min(32768, rows)
        assert extra == {"fast_staging": (-(-b // 128) * 128) * 64 * 2}
    else:
        assert extra == {}


def test_kmeans_terms_analytic_and_tracking_config(clean_config):
    est = KMeans(k=5, float32_inputs=False)
    assert est._solver_workspace_terms(125, 12, dict(est._solver_params), 8) == {
        "tile_buffers": 2 * 125 * 5 * 8, "centers": 2 * 5 * 12 * 8, "predict_tile": 125 * 5 * 8,
    }
    _set(distance_tile_rows=512)
    terms = est._solver_workspace_terms(10 ** 6, 12, dict(est._solver_params), 8)
    assert terms["predict_tile"] == 512 * 5 * 8
    assert terms["tile_buffers"] == 2 * 32768 * 5 * 8
    # the bf16 row tile of the argmin kernel's fast form, at the Lloyd tile:
    # 32768 x 3000 -> 32768 x 3008 bf16 = 197 MB
    f32 = KMeans(k=1000)
    terms = f32._solver_workspace_terms(10 ** 6, 3000, dict(f32._solver_params), 4)
    assert terms["fast_staging"] == 32768 * 3008 * 2
    high = KMeans(k=1000, distance_precision="high")
    assert "fast_staging" not in high._solver_workspace_terms(10 ** 6, 3000, dict(high._solver_params), 4)


def test_logistic_bf16_copy_of_x_is_priced(clean_config):
    est = LogisticRegression(solver_precision="bf16")
    jest = JaxLogisticRegression(num_workers=1, solver_precision="bf16")
    terms = est._solver_workspace_terms(10 ** 6, 3000, dict(est._solver_params), 4)
    jterms = jest._solver_workspace_terms(10 ** 6, 3000, dict(jest._solver_params), 4)
    assert terms == {**jterms, "bf16_X": 2 * 10 ** 6 * 3000}  # 6 GB at 1M x 3000
    _set(solver_precision="bf16")  # the config-wide knob prices it too
    plain = LogisticRegression()
    assert plain._solver_workspace_terms(100, 7, dict(plain._solver_params), 4)["bf16_X"] == 1400


def test_workspace_estimate_prefixes_and_streaming_rows():
    ex, jex = _extracted()
    est, jest = _pair("logistic", float32_inputs=False)
    ws = memory.workspace_estimate(est, ex)
    assert ws.terms == jmemory.workspace_estimate(jest, jex, 1).terms
    assert set(ws.terms) == {"workspace.glm_logits", "workspace.lbfgs_history"}
    stream = memory.streaming_estimate(est, ex, 1, chunk_rows=256)
    assert stream.terms == jmemory.streaming_estimate(jest, jex, 1, chunk_rows=256).terms
    assert stream.terms["stream.chunk_buffers"] == 2 * 256 * (12 + 2) * 8
    assert stream.terms["workspace.glm_logits"] == 2 * 256 * 8
    assert stream.terms["workspace.lbfgs_history"] == ws.terms["workspace.lbfgs_history"]


@pytest.mark.parametrize("name", ["linear", "pca", "kmeans", "logistic"])
def test_resident_estimate_is_placement_plus_workspace(name):
    ex, jex = _extracted(label=name in ("linear", "logistic"))
    est, jest = _pair(name, float32_inputs=False)
    res = memory.resident_estimate(est, ex)
    assert res.terms == jmemory.resident_estimate(jest, jex, 1).terms
    assert res.total() == sum(memory.placement_terms(ex, np.float64).values()) + memory.workspace_estimate(est, ex).total()


# ------------------------------------------------------------ admission -----


def _admit_both(name, budget=None, chunk=0, headroom=0.1, force_stream=False, n=1000, **kw):
    """The same fit admitted by both packages: (port decision, JAX decision),
    or the two raised errors."""
    _set(hbm_budget_bytes=budget, stream_chunk_rows=chunk, hbm_headroom_fraction=headroom)
    ex, jex = _extracted(n=n, label=name in ("linear", "logistic"))
    est, jest = _pair(name, float32_inputs=False, **kw)
    out = []
    for admit, e, x, ctx in ((memory.admit_fit, est, ex, None), (jmemory.admit_fit, jest, jex, _OneDevice())):
        try:
            out.append(admit(e, x, ctx, force_stream=force_stream))
        except HbmBudgetError as err:
            out.append(err)
        except Exception as err:  # JAX's own HbmBudgetError class
            out.append(err)
    return out


def _same_decision(dec, jdec):
    assert dec.verdict == jdec.verdict
    assert dec.chunk_rows == jdec.chunk_rows
    assert dec.reason == jdec.reason
    assert dec.demoted == jdec.demoted
    assert dec.capacity_bytes == jdec.capacity_bytes and dec.budget_bytes == jdec.budget_bytes
    assert dec.estimate.terms == jdec.estimate.terms
    assert dec.stamp() == jdec.stamp()


@pytest.mark.parametrize("name", ["linear", "pca", "kmeans", "logistic"])
def test_admit_resident_when_no_capacity_information(name):
    dec, jdec = _admit_both(name)
    _same_decision(dec, jdec)
    assert dec.verdict == memory.RESIDENT and dec.reason == "no capacity information"


@pytest.mark.parametrize("headroom", [0.1, 0.25])
def test_admit_applies_headroom_like_jax(headroom):
    ex, _ = _extracted()
    need = memory.resident_estimate(LinearRegression(float32_inputs=False), ex).total()
    for cap, verdict in ((int(need / (1 - headroom)) + 8, memory.RESIDENT), (int(need / (1 - headroom)) - 8, memory.STREAM)):
        dec, jdec = _admit_both("linear", budget=cap, headroom=headroom)
        _same_decision(dec, jdec)
        assert dec.verdict == verdict
        memory.release_admission(dec)
        jmemory.release_admission(jdec)


def _largest_fitting(est, ex, avail, top):
    """The largest chunk in [256, top] whose streaming estimate fits
    `avail`, by scanning every size (an independent check of the
    bisection)."""
    fits = [c for c in range(256, top + 1) if memory.streaming_estimate(est, ex, 1, c).total() <= avail]
    return max(fits)


@pytest.mark.parametrize("name", ["linear", "pca", "kmeans", "logistic"])
@pytest.mark.parametrize("chunk", [0, 300])
def test_admit_demotes_and_sizes_chunks_like_jax(name, chunk):
    ex, jex = _extracted(label=name in ("linear", "logistic"))
    est, jest = _pair(name, float32_inputs=False)
    need = memory.resident_estimate(est, ex).total()
    dec, jdec = _admit_both(name, budget=need, chunk=chunk)
    assert dec.verdict == jdec.verdict == memory.STREAM and dec.demoted and jdec.demoted
    assert dec.estimate.total() <= dec.budget_bytes
    avail = int(need * 0.9)
    rb = memory.row_bytes(ex, np.float64)
    ws = memory.workspace_estimate(est, ex, rows_dev=256).total()
    sized = chunk or min(1000, (avail - ws) // (2 * rb))
    if memory.streaming_estimate(est, ex, 1, sized).total() <= avail:
        # the sized chunk fits: the same decision as JAX's, to the byte
        _same_decision(dec, jdec)
        assert dec.chunk_rows == sized
    else:
        # KMeans's and LogisticRegression's workspace grows with the chunk,
        # so the sized chunk overshoots: JAX drops to the 256-row floor,
        # the port takes the largest chunk that fits
        assert name in ("kmeans", "logistic")
        assert jdec.chunk_rows == memory.MIN_STREAM_CHUNK_ROWS
        assert dec.chunk_rows == _largest_fitting(est, ex, avail, sized) > jdec.chunk_rows
        assert dec.estimate.terms == jmemory.streaming_estimate(jest, jex, 1, dec.chunk_rows).terms
        assert dec.reason == jdec.reason


def test_chunk_sizing_counts_the_ports_own_terms():
    # the bf16 copy of X is priced per chunk: the port's chunk is the
    # largest whose estimate, that term included, fits the budget
    _set(hbm_budget_bytes=10 ** 6, stream_chunk_rows=0, solver_precision="bf16")
    ex, jex = _extracted(n=20000, d=12, dtype=np.float32)
    est = LogisticRegression()
    jest = JaxLogisticRegression(num_workers=1)
    dec = memory.admit_fit(est, ex)
    jdec = jmemory.admit_fit(jest, jex, _OneDevice())
    assert dec.verdict == jdec.verdict == memory.STREAM
    avail = int(10 ** 6 * 0.9)
    ws = memory.workspace_estimate(est, ex, rows_dev=256).total()
    assert ws == memory.workspace_estimate(jest, jex, rows_dev=256).total() + 2 * 256 * 12
    c = dec.chunk_rows
    assert memory.streaming_estimate(est, ex, 1, c).total() <= avail
    assert memory.streaming_estimate(est, ex, 1, c + 1).total() > avail
    assert dec.estimate.terms["workspace.bf16_X"] == 2 * c * 12
    # without the bf16 term, one more row fits per 2 * 12 bytes it frees
    assert memory.streaming_estimate(jest, jex, 1, c + 1).total() <= avail


def test_admit_raises_typed_when_even_streaming_cannot_fit():
    err, jerr = _admit_both("linear", budget=1000)
    assert isinstance(err, HbmBudgetError)
    assert (err.largest_term, err.estimate_bytes, err.capacity_bytes, err.terms) == (
        jerr.largest_term, jerr.estimate_bytes, jerr.capacity_bytes, jerr.terms)
    assert err.largest_term == "stream.chunk_buffers"
    assert str(err) == str(jerr)


def test_admit_refuses_streaming_without_estimator_support():
    _set(hbm_budget_bytes=10_000)
    ex, jex = _extracted()
    est = RandomForestClassifier()
    with pytest.raises(HbmBudgetError, match="no out-of-core streaming path") as ei:
        memory.admit_fit(est, ex)
    assert ei.value.largest_term == "placement.X" and ei.value.largest_term_bytes == 1000 * 12 * 4


@pytest.mark.parametrize("name", ["linear", "kmeans"])
def test_force_stream_skips_resident_check(name):
    dec, jdec = _admit_both(name, force_stream=True)
    _same_decision(dec, jdec)
    assert dec.verdict == memory.STREAM and dec.demoted
    assert dec.chunk_rows == min(memory.DEFAULT_STREAM_CHUNK_ROWS, 1000)
    assert dec.reason == "backend OOM caught; retrying out-of-core"


def test_chaos_injected_budget_demotes_exactly_once_like_jax():
    chaos.set_fault_plan("oom:budget=100000")
    jchaos.set_fault_plan("oom:budget=100000")
    ex, jex = _extracted()
    est, jest = _pair("linear", float32_inputs=False)
    dec, jdec = memory.admit_fit(est, ex), jmemory.admit_fit(jest, jex, _OneDevice())
    _same_decision(dec, jdec)
    assert dec.verdict == memory.STREAM and dec.capacity_bytes == 100000
    memory.release_admission(dec)
    # the entry is spent: the next admission has no capacity again
    assert memory.admit_fit(est, ex).verdict == memory.RESIDENT


# ------------------------------------------------------------ OOM match -----


def test_is_oom_error_matches_the_cards_failure():
    assert memory.is_oom_error(torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert memory.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))
    assert memory.is_oom_error(MemoryError("boom"))
    assert not memory.is_oom_error(RuntimeError("some other failure"))
    assert not memory.is_oom_error(ValueError("out of memory"))
    assert not memory.is_oom_error(HbmBudgetError("x"))


def test_as_hbm_budget_error_wraps_and_names_the_largest_term():
    e = memory.as_hbm_budget_error(RuntimeError("CUDA out of memory: 42"))
    assert isinstance(e, HbmBudgetError) and "CUDA out of memory: 42" in str(e)
    assert str(e) == str(jmemory.as_hbm_budget_error(RuntimeError("CUDA out of memory: 42")))
    ex, _ = _extracted()
    adm = memory.admit_fit(RandomForestClassifier(), ex)
    e = memory.as_hbm_budget_error(torch.OutOfMemoryError("CUDA out of memory"), adm)
    assert e.largest_term == "placement.X" and e.estimate_bytes == adm.estimate.total()
    assert "placement.X" in str(e)


# ----------------------------------------------------------------- chaos ----


_PLANS = [
    "oom:budget=1048576", "oom:stage=placement", "oom:stage=solve:round=2:rank=1:times=3",
    "kill:rank=1:round=3:respawn=1", "abort:rank=0:round=2:reason=x", "delay:rank=0:round=2:seconds=0.5",
    "drop:rank=1:round=2", "fail:stage=fit:times=2", "burst:stage=serve:rows=4096:seconds=2",
    "delay:stage=serve:seconds=0.25", "oom:budget=10; fail:stage=fit ;",
]


@pytest.mark.parametrize("spec", _PLANS)
def test_fault_plans_parse_like_jax(spec):
    fields = ("kind", "rank", "round", "stage", "seconds", "reason", "times", "respawn", "budget", "rows")
    got = [tuple(getattr(f, k) for k in fields) for f in chaos.parse_fault_plan(spec)]
    want = [tuple(getattr(f, k) for k in fields) for f in jchaos.parse_fault_plan(spec)]
    assert got == want and got


@pytest.mark.parametrize("spec", [
    "boom:x=1", "oom", "oom:budget", "fail:times=1", "kill:rank=1", "burst:stage=serve:rows=10",
    "delay:stage=serve", "oom:colour=red",
])
def test_malformed_fault_plans_raise_like_jax(spec):
    with pytest.raises(ValueError):
        jchaos.parse_fault_plan(spec)
    with pytest.raises(ValueError):
        chaos.parse_fault_plan(spec)


def test_injected_oom_is_a_torch_out_of_memory_error_fired_times_times():
    chaos.set_fault_plan("oom:stage=placement:times=2;oom:stage=solve:round=3")
    for _ in range(2):
        with pytest.raises(torch.OutOfMemoryError) as ei:
            chaos.maybe_fail_oom("placement")
        assert memory.is_oom_error(ei.value)
    chaos.maybe_fail_oom("placement")  # spent
    chaos.maybe_fail_oom("solve", 2)  # another round
    with pytest.raises(torch.OutOfMemoryError):
        chaos.maybe_fail_oom("solve", 3)


def test_rank_restricted_faults_fire_in_their_process_only(monkeypatch):
    chaos.set_fault_plan("oom:stage=placement:rank=1;oom:budget=99:rank=1")
    chaos.maybe_fail_oom("placement")  # this process is rank 0
    assert chaos.injected_hbm_budget() is None
    monkeypatch.setenv("SRML_RANK", "1")
    assert chaos.injected_hbm_budget() == 99
    with pytest.raises(torch.OutOfMemoryError):
        chaos.maybe_fail_oom("placement")


# ------------------------------------------------- shared ledger ------------


class _FakeServeModel:
    _float32_inputs = True

    def __init__(self, nbytes):
        self._nbytes = int(nbytes)

    def _serve_placement_terms(self):
        return {"params": self._nbytes}


def _reserved(kind):
    """Bytes of the shared ledger's active reservations of one kind."""
    led = tledger.global_ledger()
    with led._lock:
        return sum(r.nbytes for r in led._by_id.values() if r.kind == kind)


def test_fit_admission_subtracts_resident_serving_bytes():
    ex, _ = _extracted()
    est = LinearRegression(float32_inputs=False)
    need = memory.resident_estimate(est, ex).total()
    _set(hbm_budget_bytes=int(2 * need / 0.9))
    dec = memory.admit_fit(est, ex)
    assert dec.verdict == memory.RESIDENT
    memory.release_admission(dec)
    load = memory.admit_model_load(_FakeServeModel(int(1.25 * need)), bucket_rows_count=0)
    assert _reserved("serve") >= 1.25 * need
    dec2 = memory.admit_fit(est, ex)
    assert dec2.verdict == memory.STREAM and dec2.demoted
    assert "already reserved" in dec2.reason
    memory.release_admission(dec2)
    memory.release_admission(load)
    dec3 = memory.admit_fit(est, ex)
    assert dec3.verdict == memory.RESIDENT
    memory.release_admission(dec3)
    assert tledger.global_ledger().reserved_bytes() == 0


def test_model_load_admission_subtracts_fit_reservations():
    ex, _ = _extracted()
    est = LinearRegression(float32_inputs=False)
    need = memory.resident_estimate(est, ex).total()
    _set(hbm_budget_bytes=int(2 * need / 0.9))
    fit_dec = memory.admit_fit(est, ex)
    assert _reserved("fit") == need
    with pytest.raises(HbmBudgetError, match="held in the shared ledger"):
        memory.admit_model_load(_FakeServeModel(int(1.5 * need)), bucket_rows_count=0)
    memory.release_admission(fit_dec)
    load = memory.admit_model_load(_FakeServeModel(int(1.5 * need)), bucket_rows_count=0)
    assert load.verdict == memory.RESIDENT
    memory.release_admission(load)


def test_a_fit_holds_its_claim_until_it_ends_and_releases_it():
    from spark_rapids_ml_tpu_torch import set_devices

    set_devices("cpu")
    held = []
    est = LinearRegression(float32_inputs=False)
    real = est._dispatch_solves

    def spy(*a, **kw):
        held.append(_reserved("fit"))
        return real(*a, **kw)

    est._dispatch_solves = spy
    try:
        ex, _ = _extracted()
        est.fit({"features": ex.features, "label": ex.label})
    finally:
        set_devices(None)
    assert held == [memory.resident_estimate(est, ex).total()]
    assert tledger.global_ledger().reserved_bytes() == 0


def test_release_admission_is_idempotent_and_none_safe():
    ex, _ = _extracted(n=200, d=4)
    dec = memory.admit_fit(LinearRegression(float32_inputs=False), ex)
    assert tledger.global_ledger().reserved_bytes() > 0
    memory.release_admission(dec)
    assert tledger.global_ledger().reserved_bytes() == 0
    memory.release_admission(dec)
    memory.release_admission(None)
    assert tledger.global_ledger().reserved_bytes() == 0
