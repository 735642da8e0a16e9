#
# The port's multi-process control plane against the JAX package's
# (tests/test_parallel.py, tests/test_chaos.py): the rendezvous substrates,
# their deadlines, the abort channel, heartbeats and epochs, the chaos
# wrapper, TpuContext's teardown, PartitionDescriptor and allgather_ndarray
# (equal to JAX's on the same inputs), and the process group on the CPU.
# Every thread and subprocess has its own timeout, so a hang fails a test.
#
import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.parallel import LocalRendezvous as JaxLocalRendezvous
from spark_rapids_ml_tpu.parallel import PartitionDescriptor as JaxPartitionDescriptor
from spark_rapids_ml_tpu.parallel.context import allgather_ndarray as jax_allgather_ndarray
from spark_rapids_ml_tpu_torch import core as core_mod
from spark_rapids_ml_tpu_torch.errors import RankFailedError, RendezvousTimeoutError, SrmlError
from spark_rapids_ml_tpu_torch.parallel import (
    BarrierRendezvous,
    ChaosRendezvous,
    FileRendezvous,
    LocalRendezvous,
    PartitionDescriptor,
    Rendezvous,
    TpuContext,
    chaos,
)
from spark_rapids_ml_tpu_torch.parallel.context import allgather_ndarray, choose_backend

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


@pytest.fixture(autouse=True)
def _clean_chaos_plan():
    chaos.clear_fault_plan()
    yield
    chaos.clear_fault_plan()


def _in_threads(fn, nranks, timeout=30):
    """fn(r) on one thread per rank; each result, or the exception raised."""
    out = [None] * nranks

    def work(r):
        try:
            out[r] = fn(r)
        except Exception as e:  # noqa: BLE001 - returned for the assertions
            out[r] = e

    threads = [threading.Thread(target=work, args=(r,)) for r in range(nranks)]
    [t.start() for t in threads]
    [t.join(timeout=timeout) for t in threads]
    assert not any(t.is_alive() for t in threads), "a rank hung"
    return out


# ----------------------------------------------------------- test_parallel --


@pytest.mark.parametrize("nranks", [1, 2, 4])
def test_local_rendezvous_allgather(nranks):
    rvs = LocalRendezvous.create(nranks, timeout_s=30.0)
    results = _in_threads(lambda r: rvs[r].allgather(f"rank{r}"), nranks)
    for r in range(nranks):
        assert results[r] == [f"rank{i}" for i in range(nranks)]


def test_partition_descriptor_via_rendezvous():
    rvs = LocalRendezvous.create(2, timeout_s=30.0)
    jrvs = JaxLocalRendezvous.create(2, timeout_s=30.0)
    out = _in_threads(lambda r: PartitionDescriptor.build([10 + r], total_cols=5, rank=r, rendezvous=rvs[r]), 2)
    want = _in_threads(lambda r: JaxPartitionDescriptor.build([10 + r], total_cols=5, rank=r, rendezvous=jrvs[r]), 2)
    for r in range(2):
        assert out[r].m == 21 and out[r].n == 5
        assert out[r].parts_rank_size == [(0, 10), (1, 11)]
        assert vars(out[r]) == vars(want[r])
    assert out[0].rows_of(1) == 11
    assert out[1].row_offset_of(1) == 10


def test_partition_descriptor_single_controller():
    d = PartitionDescriptor.build([4, 4, 5], total_cols=3)
    assert d.m == 13 and d.n == 3
    assert d.rows_of(2) == 5 and d.row_offset_of(2) == 8
    assert vars(d) == vars(JaxPartitionDescriptor.build([4, 4, 5], total_cols=3))


def test_barrier_rendezvous_adapter():
    class FakeBarrierCtx:
        def __init__(self):
            self.sent = []

        def partitionId(self):
            return 2

        def getTaskInfos(self):
            return [object()] * 4

        def allGather(self, payload):
            self.sent.append(payload)
            return [f"r{i}:{payload}" for i in range(4)]

    ctx = FakeBarrierCtx()
    rdv = BarrierRendezvous(ctx)
    assert rdv.rank == 2 and rdv.nranks == 4
    assert rdv.allgather("hello") == ["r0:hello", "r1:hello", "r2:hello", "r3:hello"]
    rdv.barrier()
    assert ctx.sent == ["hello", ""]


@pytest.mark.parametrize("rows", [[5, 17, 2], [0, 3], [4, 0, 0]])
def test_allgather_ndarray_ragged_row_counts(rows):
    # ragged counts make the round-count agreement do real work, and a
    # zero-row rank must still join every round; equal to JAX's
    nranks = len(rows)
    arrs = [(np.arange(r * 4, dtype=np.float64).reshape(r, 4) + 1000.0 * i) for i, r in enumerate(rows)]
    rvs = LocalRendezvous.create(nranks, timeout_s=30.0)
    jrvs = JaxLocalRendezvous.create(nranks, timeout_s=30.0)
    got = _in_threads(lambda r: allgather_ndarray(rvs[r], arrs[r], chunk_bytes=64), nranks, timeout=60)
    want = _in_threads(lambda r: jax_allgather_ndarray(jrvs[r], arrs[r], chunk_bytes=64), nranks, timeout=60)
    for r in range(nranks):
        assert len(got[r]) == nranks
        for i in range(nranks):
            assert got[r][i].shape == (rows[i], 4)
            np.testing.assert_array_equal(got[r][i], arrs[i])
            np.testing.assert_array_equal(got[r][i], want[r][i])
    assert [rv._round for rv in rvs] == [rv._round for rv in jrvs]


def test_allgather_ndarray_zero_row_rank_chunk_agreement():
    rvs = LocalRendezvous.create(2, timeout_s=20.0)
    arrs = [np.zeros((0, 8)), np.arange(80, dtype=np.float64).reshape(10, 8)]
    out = _in_threads(lambda r: allgather_ndarray(rvs[r], arrs[r], chunk_bytes=128), 2)
    for r in range(2):
        assert out[r][0].shape == (0, 8)
        np.testing.assert_array_equal(out[r][1], arrs[1])
    assert rvs[0]._round == rvs[1]._round == 6  # the agreement + 5 chunk rounds


def test_allgather_ndarray_chunked(tmp_path):
    rdv = FileRendezvous(0, 1, str(tmp_path), run_id=uuid.uuid4().hex)
    jdv = JaxLocalRendezvous.create(1)[0]
    arr = np.arange(1000, dtype=np.float64).reshape(100, 10)
    try:
        out = allgather_ndarray(rdv, arr, chunk_bytes=800)  # ~10 rows a round
    finally:
        rdv.close()
    assert len(out) == 1
    np.testing.assert_array_equal(out[0], arr)
    np.testing.assert_array_equal(out[0], jax_allgather_ndarray(jdv, arr, chunk_bytes=800)[0])
    assert rdv._round > 3 and rdv._round == jdv._round


def test_allgather_ndarray_scalar():
    rvs = LocalRendezvous.create(2, timeout_s=10.0)
    # a scalar travels as one row (np.ascontiguousarray makes it 1-d), as in
    # the JAX package
    out = _in_threads(lambda r: allgather_ndarray(rvs[r], np.float64(r + 0.5)), 2)
    np.testing.assert_array_equal(np.concatenate(out[0]), [0.5, 1.5])


def test_allgather_concat_matches_jax():
    from spark_rapids_ml_tpu.parallel.context import allgather_concat as jax_allgather_concat

    from spark_rapids_ml_tpu_torch.parallel.context import allgather_concat

    arrs = [np.arange(6.0).reshape(3, 2), np.arange(4.0).reshape(2, 2) + 10]
    rvs = LocalRendezvous.create(2, timeout_s=10.0)
    jrvs = JaxLocalRendezvous.create(2, timeout_s=10.0)
    got = _in_threads(lambda r: allgather_concat(rvs[r], arrs[r]), 2)
    want = _in_threads(lambda r: jax_allgather_concat(jrvs[r], arrs[r]), 2)
    for r in range(2):
        np.testing.assert_array_equal(got[r][0], want[r][0])
        assert got[r][1] == want[r][1] == (0, 3)[r]


def test_multirank_context_requires_rendezvous():
    with pytest.raises(RuntimeError, match="rendezvous"):
        with TpuContext(0, 2):
            pass


def test_single_process_context_opens_no_group():
    with TpuContext(0, 1) as ctx:
        assert ctx.group is None and not ctx.is_spmd
        assert TpuContext.current() is ctx
    assert TpuContext.current() is None


# -------------------------------------------------------------- test_chaos --


def test_local_rendezvous_round_deadline_is_typed():
    rdv = LocalRendezvous.create(2, timeout_s=0.25)[0]
    t0 = time.monotonic()
    with pytest.raises(RendezvousTimeoutError) as ei:
        rdv.allgather("hello")
    assert time.monotonic() - t0 < 5.0
    assert isinstance(ei.value, TimeoutError) and isinstance(ei.value, SrmlError)
    assert ei.value.round_index == 0


def test_local_rendezvous_abort_wakes_peers_promptly():
    rvs = LocalRendezvous.create(2, timeout_s=60.0)
    err = [None]
    started = threading.Event()

    def work():
        started.set()
        try:
            rvs[0].allgather("payload")
        except Exception as e:  # noqa: BLE001
            err[0] = e

    t = threading.Thread(target=work)
    t.start()
    started.wait(10)
    time.sleep(0.05)  # rank 0 reaches the barrier
    t0 = time.monotonic()
    rvs[1].abort("injected failure")
    t.join(timeout=10)
    assert not t.is_alive()
    assert time.monotonic() - t0 < 2.0
    assert isinstance(err[0], RankFailedError)
    assert err[0].failed_rank == 1 and "injected failure" in err[0].reason
    assert rvs[1]._shared.slots[1].startswith("ABORT:1:")
    assert rvs[0].peer_failure() == (1, "injected failure")
    t0 = time.monotonic()
    with pytest.raises(RankFailedError):
        rvs[0].allgather("again")  # later rounds fail at once
    assert time.monotonic() - t0 < 0.5


def test_local_rendezvous_begin_epoch_clears_abort():
    rvs = LocalRendezvous.create(2, timeout_s=5.0)
    rvs[1].abort("transient blip")
    with pytest.raises(RankFailedError):
        rvs[0].allgather("x")
    for r in rvs:
        r.begin_epoch(1)
    out = _in_threads(lambda r: rvs[r].allgather(f"rank{r}"), 2)
    assert out[0] == out[1] == ["rank0", "rank1"]
    assert rvs[0].peer_failure() is None


def test_local_rendezvous_round_desync_is_typed_not_silent():
    rvs = LocalRendezvous.create(2, timeout_s=10.0)
    rvs[1]._round = 5  # a straggler five rounds ahead
    out = _in_threads(lambda r: rvs[r].allgather(f"{r}"), 2)
    for r in range(2):
        assert isinstance(out[r], RendezvousTimeoutError) and "desync" in str(out[r])


def test_file_rendezvous_round_deadline_is_typed(tmp_path):
    rdv = FileRendezvous(0, 2, str(tmp_path), timeout_s=0.3, run_id="t", heartbeat_interval_s=60.0)
    try:
        with pytest.raises(RendezvousTimeoutError) as ei:
            rdv.allgather("x")
    finally:
        rdv.close()
    assert isinstance(ei.value, TimeoutError)
    assert ei.value.missing_ranks == [1] and ei.value.round_index == 0


def test_file_rendezvous_abort_file_detection(tmp_path):
    r0 = FileRendezvous(0, 2, str(tmp_path), timeout_s=60.0, run_id="t", heartbeat_interval_s=60.0)
    r1 = FileRendezvous(1, 2, str(tmp_path), timeout_s=60.0, run_id="t", heartbeat_interval_s=60.0)
    err = [None]

    def work():
        try:
            r0.allgather("payload")
        except Exception as e:  # noqa: BLE001
            err[0] = e

    t = threading.Thread(target=work)
    t.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    r1.abort("worker exception")
    t.join(timeout=10)
    r0.close()
    r1.close()
    assert not t.is_alive()
    assert time.monotonic() - t0 < 2.0
    assert isinstance(err[0], RankFailedError)
    assert err[0].failed_rank == 1 and "worker exception" in err[0].reason


def test_file_rendezvous_stale_heartbeat_detection(tmp_path):
    interval = 0.2
    r0 = FileRendezvous(0, 2, str(tmp_path), timeout_s=60.0, heartbeat_interval_s=interval)
    with open(r0._heartbeat_path(1), "w"):  # rank 1: one beat, then death
        pass
    t0 = time.monotonic()
    try:
        with pytest.raises(RankFailedError) as ei:
            r0.allgather("x")
    finally:
        r0.close()
    assert ei.value.failed_rank == 1 and "heartbeat" in ei.value.reason
    assert time.monotonic() - t0 < 2 * interval + 1.0


def test_file_rendezvous_epoch_namespacing(tmp_path):
    r0 = FileRendezvous(0, 1, str(tmp_path), timeout_s=5.0, run_id="t", heartbeat_interval_s=60.0)
    r0.abort("attempt 0 failure")
    r0.begin_epoch(1)
    try:
        assert r0.allgather("fresh") == ["fresh"]
        assert r0._round == 1
    finally:
        r0.close()
    assert os.path.exists(os.path.join(r0.root, "abort_rank_0"))


def test_file_rendezvous_reused_root_drops_own_stale_abort(tmp_path):
    with open(tmp_path / "abort_rank_1", "w") as f:
        f.write("ABORT:1:an earlier run")
    r1 = FileRendezvous(1, 2, str(tmp_path), heartbeat_interval_s=0)
    r1.close()
    assert not (tmp_path / "abort_rank_1").exists()


def test_chaos_delay_is_benign():
    inner = LocalRendezvous.create(2, timeout_s=30.0)
    plan = chaos.parse_fault_plan("delay:rank=0:round=1:seconds=0.05")
    rvs = [ChaosRendezvous(inner[0], plan), ChaosRendezvous(inner[1], [])]

    def rounds(r):
        for i in range(3):
            last = rvs[r].allgather(f"{r}:{i}")
        return last

    out = _in_threads(rounds, 2)
    assert out[0] == out[1] == ["0:2", "1:2"]
    assert plan[0].spent()


def test_chaos_abort_fault_blames_the_injected_rank():
    inner = LocalRendezvous.create(2, timeout_s=30.0)
    plan = chaos.parse_fault_plan("abort:rank=1:round=1:reason=injected")
    rvs = [ChaosRendezvous(inner[0], []), ChaosRendezvous(inner[1], plan)]

    def rounds(r):
        for i in range(3):
            rvs[r].allgather(f"{r}:{i}")

    out = _in_threads(rounds, 2)
    assert isinstance(out[0], RankFailedError) and out[0].failed_rank == 1
    assert isinstance(out[1], RuntimeError) and "chaos" in str(out[1])


def test_chaos_drop_times_out_symmetrically():
    inner = LocalRendezvous.create(2, timeout_s=0.3)
    plan = chaos.parse_fault_plan("drop:rank=1:round=0")
    rvs = [ChaosRendezvous(inner[0], []), ChaosRendezvous(inner[1], plan)]
    out = _in_threads(lambda r: rvs[r].allgather("x"), 2)
    assert isinstance(out[0], RendezvousTimeoutError) and isinstance(out[1], RendezvousTimeoutError)


def _launch_rounds(nranks, tmp_path, plan, *, rounds, heartbeat_s, timeout_s):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SRML_FAULT_PLAN"] = plan
    env["CUDA_VISIBLE_DEVICES"] = ""
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    run_id = uuid.uuid4().hex
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_mp_worker.py"), "rounds", str(r), str(nranks),
             str(tmp_path / "rdv"), str(out_dir), run_id, str(rounds), str(heartbeat_s), str(timeout_s)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(nranks)
    ]
    outputs = []
    try:
        outputs = [p.communicate(timeout=90)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    return out_dir, procs, outputs


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_killed_rank_detected_within_heartbeat_budget(tmp_path):
    # SIGKILL a rank entering round 3 (no abort file, no atexit): the others
    # raise RankFailedError blaming it within 2x the heartbeat interval, not
    # after the 60 s round deadline
    heartbeat_s, kill_round = 0.75, 3
    out_dir, procs, outputs = _launch_rounds(3, tmp_path, f"kill:rank=2:round={kill_round}",
                                             rounds=6, heartbeat_s=heartbeat_s, timeout_s=60.0)
    assert procs[2].returncode == -signal.SIGKILL
    marks = _read(out_dir / "marks_rank2.json")
    assert marks[-1]["round"] == kill_round
    for r in (0, 1):
        assert procs[r].returncode == 0, outputs[r]
        res = _read(out_dir / f"result_rank{r}.json")
        assert res["error"] == "RankFailedError" and res["failed_rank"] == 2, res
        assert res["rounds_done"] == kill_round
        assert res["detected_at"] - marks[-1]["t"] < 2 * heartbeat_s


def test_aborting_rank_detected_within_poll_tick(tmp_path):
    out_dir, procs, outputs = _launch_rounds(3, tmp_path, "abort:rank=1:round=2:reason=synthetic",
                                             rounds=5, heartbeat_s=5.0, timeout_s=60.0)
    aborter = _read(out_dir / "result_rank1.json")
    assert aborter["error"] == "RuntimeError"
    for r in (0, 2):
        assert procs[r].returncode == 0, outputs[r]
        res = _read(out_dir / f"result_rank{r}.json")
        assert res["error"] == "RankFailedError" and res["failed_rank"] == 1, res
        assert "synthetic" in res["reason"]
        assert res["detected_at"] - aborter["detected_at"] < 2.0


class _SpyRendezvous(Rendezvous):
    def __init__(self, nranks=2):
        self.rank = 0
        self.nranks = nranks
        self.aborted = []
        self.gathers = []

    def _allgather_impl(self, payload):
        self.gathers.append(payload)
        return [payload] * self.nranks

    def abort(self, reason):
        self.aborted.append(reason)


def test_tpu_context_exit_propagates_abort():
    spy = _SpyRendezvous()
    TpuContext(0, 2, spy).__exit__(RuntimeError, RuntimeError("solver blew up"), None)
    assert spy.aborted == ["RuntimeError: solver blew up"]
    assert spy.gathers == []  # no success barrier on the failure path


def test_tpu_context_exit_does_not_cascade_rank_failures():
    spy = _SpyRendezvous(nranks=3)
    TpuContext(0, 3, spy).__exit__(RankFailedError, RankFailedError(2, "root cause"), None)
    assert spy.aborted == []


def test_tpu_context_teardown_swallows_peer_failure():
    class _PeerDiedAtTeardown(_SpyRendezvous):
        def _allgather_impl(self, payload):
            raise RankFailedError(1, "died between solve and teardown")

    TpuContext(0, 2, _PeerDiedAtTeardown()).__exit__(None, None, None)  # must not raise


def test_tpu_context_exit_success_barrier_runs():
    spy = _SpyRendezvous()
    TpuContext(0, 2, spy).__exit__(None, None, None)
    assert spy.gathers == [""]


def test_tpu_context_teardown_barrier_is_bounded():
    rdv = LocalRendezvous.create(2)[0]  # rank 1 never arrives
    saved = core_mod.config["teardown_timeout_s"]
    core_mod.config["teardown_timeout_s"] = 0.3
    t0 = time.monotonic()
    try:
        TpuContext(0, 2, rdv).__exit__(None, None, None)
    finally:
        core_mod.config["teardown_timeout_s"] = saved
    assert time.monotonic() - t0 < 5.0


def test_config_keys_have_jax_defaults():
    from spark_rapids_ml_tpu.core import config as jax_config

    for key in ("rendezvous_timeout_s", "heartbeat_interval_s", "teardown_timeout_s", "broadcast_chunk_bytes"):
        assert core_mod.config[key] == jax_config[key], key


# ------------------------------------------------ retries and the group ----


def test_retryable_stage_begins_a_new_epoch_per_retry():
    class _EpochSpy(_SpyRendezvous):
        def __init__(self):
            super().__init__()
            self.epochs = []

        def begin_epoch(self, epoch):
            self.epochs.append(epoch)

    spy = _EpochSpy()
    calls = []

    def attempt(a):
        calls.append(a)
        if a < 2:
            raise RendezvousTimeoutError("transient", timeout_s=0.0)
        return "done"

    saved = core_mod.config["fit_retry_backoff_s"]
    core_mod.config["fit_retry_backoff_s"] = 0.01
    try:
        assert core_mod.retryable_stage(attempt, stage="fit", rendezvous=spy) == "done"
    finally:
        core_mod.config["fit_retry_backoff_s"] = saved
    assert calls == [0, 1, 2] and spy.epochs == [1, 2]


@pytest.mark.parametrize("topology, backend", [
    ([{"host": "a", "type": "cuda", "card": "u0"}, {"host": "a", "type": "cuda", "card": "u1"}], "nccl"),
    ([{"host": "a", "type": "cuda", "card": "u0"}, {"host": "a", "type": "cuda", "card": "u0"}], "gloo"),
    ([{"host": "a", "type": "cuda", "card": "u0"}, {"host": "b", "type": "cuda", "card": "u0"}], "nccl"),
    ([{"host": "a", "type": "cpu", "card": None}, {"host": "a", "type": "cpu", "card": None}], "gloo"),
    ([{"host": "a", "type": "cuda", "card": "u0"}, {"host": "a", "type": "cpu", "card": None}], "gloo"),
])
def test_backend_follows_the_topology(topology, backend):
    assert choose_backend(topology) == backend


def test_one_rank_group_gathers_and_reduces_on_the_cpu(tmp_path):
    # the same code that opens a rank's group: on the CPU it is gloo, and
    # its collectives return the input in rank order
    from spark_rapids_ml_tpu_torch import set_devices

    rdv = FileRendezvous(0, 1, str(tmp_path), run_id=uuid.uuid4().hex, heartbeat_interval_s=0)
    set_devices("cpu")
    try:
        with TpuContext(0, 1, rdv, require_distributed=True) as ctx:
            assert ctx.backend == "gloo" and not ctx.is_spmd
            t = torch.arange(6, dtype=torch.float64).reshape(2, 3)
            (g,) = ctx.group.allgather(t)
            assert torch.equal(g, t)
            rows = ctx.group.allgather_rows(t[:1])
            assert len(rows) == 1 and torch.equal(rows[0], t[:1])
            s, c = ctx.group.allreduce_fixed(t, torch.ones(2, dtype=torch.int64))
            assert torch.equal(s, t) and torch.equal(c, torch.ones(2, dtype=torch.int64))
            assert ctx.group.calls == 5  # one gather, two for the rows, one per dtype
    finally:
        rdv.close()
        set_devices(None)
    assert not torch.distributed.is_initialized()
