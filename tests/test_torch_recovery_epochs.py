#
# The port's recovery epochs (core.recoverable_stage over a rendezvous that
# reforms; LocalRendezvous.reform, FileRendezvous.reform / rejoin and their
# directories; ChaosRendezvous across a reform; TpuContext.adopt_reform,
# which reopens the process group; the placement key's membership) on the
# CPU, case for case with the JAX package's tests/test_recovery.py reform
# cases and tests/test_chaos.py's kill harness, against the JAX package on
# the same scripts.
#
# Tolerances, and why:
#   * the same LocalRendezvous script through both packages'
#     recoverable_stage: the counters, the live sets and the outcomes equal;
#   * the kill harness (tests/torch_chaos_worker.py, a torch-only copy of
#     the JAX package's tests/chaos_worker.py `recover` mode): the
#     survivors' centers against JAX's numpy `_lloyd_reference` at rtol
#     1e-9, its own bound (the survivors re-associate the float64 sums);
#   * the port's KMeans with a rank SIGKILLed (tests/torch_mp_worker.py
#     `recover`): the survivors' centers equal each other and a one-process
#     Lloyd loop that sums the survivors' row blocks in rank order from the
#     centers they resumed from bit for bit (what their group computes).
#
import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu import errors as jerrors
from spark_rapids_ml_tpu import telemetry as jtele
from spark_rapids_ml_tpu import checkpoint as jckpt
from spark_rapids_ml_tpu.parallel import LocalRendezvous as JaxLocalRendezvous
from spark_rapids_ml_tpu_torch import checkpoint as tckpt
from spark_rapids_ml_tpu_torch import core as tcore
from spark_rapids_ml_tpu_torch import errors as terrors
from spark_rapids_ml_tpu_torch import set_devices
from spark_rapids_ml_tpu_torch import telemetry as ttele
from spark_rapids_ml_tpu_torch.parallel import ChaosRendezvous, FileRendezvous, LocalRendezvous, TpuContext, chaos

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
_KEYS = ("recovery_max_rank_losses", "recovery_rejoin_grace_s", "fit_retry_backoff_s", "checkpoint_every_iters")

SIDES = {
    "torch": dict(core=tcore, tele=ttele, ckpt=tckpt, errors=terrors, local=LocalRendezvous),
    "jax": dict(core=jcore, tele=jtele, ckpt=jckpt, errors=jerrors, local=JaxLocalRendezvous),
}


@pytest.fixture(autouse=True)
def _clean_state():
    set_devices("cpu")
    saved = {side: {k: s["core"].config[k] for k in _KEYS} for side, s in SIDES.items()}
    chaos.clear_fault_plan()
    for s in SIDES.values():
        s["core"].config["fit_retry_backoff_s"] = 0.01
        s["tele"].enable()
        s["tele"].registry().reset()
    yield
    chaos.clear_fault_plan()
    for side, s in SIDES.items():
        s["core"].config.update(saved[side])
        s["tele"].disable()
        s["tele"].registry().reset()
    set_devices(None)


def _counters(side):
    keep = ("fit.recoveries", "recovery.epochs", "recovery.rank_losses", "rendezvous.reforms")
    snap = SIDES[side]["tele"].registry().snapshot()["counters"]
    return {k: snap.get(k) for k in keep}


def _threads(n, target):
    out = [None] * n
    threads = [threading.Thread(target=lambda r=r: out.__setitem__(r, target(r))) for r in range(n)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    assert not any(t.is_alive() for t in threads)
    return out


# ------------------------------------------------- recoverable_stage (unit) --


def _reform_and_resume(side):
    """JAX's test_recoverable_stage_reforms_and_resumes_local script: three
    thread ranks, rank 2 dies at its second iteration; per rank the
    outcome."""
    s = SIDES[side]
    s["core"].config["recovery_max_rank_losses"] = 1
    rvs = s["local"].create(3, timeout_s=15.0)

    def work(r):
        holder = {"rdv": rvs[r]}

        def fit(attempt):
            rdv = holder["rdv"]
            store = s["ckpt"].active_store()
            saved = store.load("it")
            start = 0 if saved is None else int(saved.iteration)
            for it in range(start, 4):
                if r == 2 and it == 1:
                    rdv.abort("rank 2 died")
                    raise RuntimeError("rank 2 died")
                rdv.allgather(f"{rdv.rank}:{it}")
                store.save("it", s["ckpt"].SolverCheckpoint(solver="unit", iteration=it + 1, state={}))
            return ("done", rdv.nranks, list(rdv.live_ranks), start, rdv.reform_generation)

        try:
            return s["core"].recoverable_stage(fit, stage="fit", rendezvous=rvs[r],
                                               on_recover=lambda new, gen, dead: holder.update(rdv=new))
        except Exception as e:  # noqa: BLE001 - compared below
            return type(e).__name__

    return _threads(3, work)


def test_recoverable_stage_reforms_and_resumes_local():
    got = {side: _reform_and_resume(side) for side in SIDES}
    assert got["torch"] == got["jax"]
    assert got["torch"][2] == "RuntimeError"
    for r in (0, 1):
        status, n, live, start, gen = got["torch"][r]
        assert (status, n, live, gen) == ("done", 2, [0, 1], 1)
        assert start >= 1, "a survivor started again instead of resuming"
    assert _counters("torch") == _counters("jax") == {
        "fit.recoveries": 2, "recovery.epochs": 2, "recovery.rank_losses": 2, "rendezvous.reforms": 2}


@pytest.mark.parametrize("side", list(SIDES))
def test_recoverable_stage_exhaustion_degrades_to_typed_failure(side):
    s = SIDES[side]
    s["core"].config["recovery_max_rank_losses"] = 0
    rdv = s["local"].create(1, timeout_s=5.0)[0]

    def fit(attempt):
        raise s["errors"].RankFailedError(0, "peer gone")

    with pytest.raises(s["errors"].RankFailedError) as ei:
        s["core"].recoverable_stage(fit, stage="fit", rendezvous=rdv)
    assert ei.value.recovery_exhausted is False and ei.value.recovery_generations == 0


@pytest.mark.parametrize("side", list(SIDES))
def test_recoverable_stage_unreformable_substrate_degrades(side):
    s = SIDES[side]

    class _NoReform:
        rank, nranks = 0, 2
        can_reform = False

        def begin_epoch(self, e):
            pass

    def fit(attempt):
        raise s["errors"].RankFailedError(1, "dead")

    with pytest.raises(s["errors"].RankFailedError) as ei:
        s["core"].recoverable_stage(fit, stage="fit", rendezvous=_NoReform())
    assert ei.value.recovery_exhausted is False and ei.value.recovery_generations == 0
    assert _counters(side)["fit.recoveries"] is None


def _bounded_losses(side):
    """JAX's test_recoverable_stage_bounded_losses: every epoch loses the
    highest current rank; a budget of 2 ends it."""
    s = SIDES[side]
    s["core"].config["recovery_max_rank_losses"] = 2
    rvs = s["local"].create(4, timeout_s=10.0)

    def work(r):
        holder = {"rdv": rvs[r]}

        def fit(attempt):
            rdv = holder["rdv"]
            if rdv.rank == rdv.nranks - 1:
                rdv.abort("serial failure")
                raise RuntimeError("died")
            rdv.allgather(f"{rdv.rank}")
            rdv.allgather(f"{rdv.rank}")
            raise s["errors"].RankFailedError(rdv.nranks - 1, "peer still dying")

        try:
            return s["core"].recoverable_stage(fit, stage="fit", rendezvous=rvs[r],
                                               on_recover=lambda new, gen, dead: holder.update(rdv=new))
        except s["errors"].RankFailedError as e:
            return ("RankFailedError", e.recovery_exhausted, e.recovery_generations, list(holder["rdv"].live_ranks))
        except Exception as e:  # noqa: BLE001 - compared below
            return type(e).__name__

    return _threads(4, work)


def test_recoverable_stage_bounded_losses():
    got = {side: _bounded_losses(side) for side in SIDES}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ("RankFailedError", True, 2, [0, 1])
    assert _counters("torch") == _counters("jax")


@pytest.mark.parametrize("side", list(SIDES))
def test_dead_hint_only_from_a_rank_within_the_membership(side):
    # a closed connection names rank -1: no dead hint, the reform round's
    # evidence decides (here every rank of the thread substrate survives)
    s = SIDES[side]
    rdv = s["local"].create(1, timeout_s=5.0)[0]
    seen = []

    def fit(attempt):
        if not seen:
            seen.append(attempt)
            raise s["errors"].RankFailedError(-1, "connection closed")
        return "ok"

    hints = []
    assert s["core"].recoverable_stage(fit, stage="fit", rendezvous=rdv,
                                       on_recover=lambda new, gen, dead: hints.append((gen, dead))) == "ok"
    assert hints == [(1, set())]


def test_chaos_rendezvous_rides_the_reform_and_keeps_original_ranks():
    # kill-style faults name ORIGINAL ranks: after a reform renumbers the
    # survivors, a fault for original rank 2 still fires on it alone
    plan = chaos.parse_fault_plan("abort:rank=2:round=1")
    inner = LocalRendezvous.create(3, timeout_s=10.0)
    rvs = [ChaosRendezvous(inner[r], plan if r == 2 else []) for r in range(3)]

    def reform(r):
        new = rvs[r].reform(dead_ranks={0}, generation=1)
        return new

    out = _threads(3, lambda r: reform(r) if r else None)
    survivors = out[1:]
    assert [(s.rank, s.nranks, s.orig_rank, s.live_ranks, s.can_reform, s.reform_generation) for s in survivors] == [
        (0, 2, 1, [1, 2], True, 1), (1, 2, 2, [1, 2], True, 1)]
    assert isinstance(survivors[1], ChaosRendezvous) and survivors[1].plan is plan

    def rounds(i):
        r = survivors[i]
        try:
            r.allgather("a")
            r.allgather("b")
            return "ok"
        except Exception as e:  # noqa: BLE001 - compared below
            return type(e).__name__

    res = _threads(2, rounds)
    assert res[1] == "RuntimeError" and res[0] == "RankFailedError"  # original rank 2, now rank 1, aborted


# ------------------------------------------------- FileRendezvous reform ----


def test_file_reform_survivors_agree(tmp_path):
    rvs = [FileRendezvous(r, 3, str(tmp_path), timeout_s=20.0, run_id="t", heartbeat_interval_s=0.2)
           for r in range(3)]
    out = _threads(2, lambda r: rvs[r].reform(dead_ranks={2}, generation=1))
    for r in (0, 1):
        assert (out[r].nranks, out[r].live_ranks, out[r].orig_rank, out[r].reform_generation) == (2, [0, 1], r, 1)
    assert _threads(2, lambda r: out[r].allgather(f"hello{r}")) == [["hello0", "hello1"]] * 2
    assert ttele.registry().snapshot()["counters"]["rendezvous.reforms"] == 2
    for rv in rvs + out:
        rv.close()


def test_file_reform_admits_respawned_rank(tmp_path):
    # the survivors hold the window open; a respawned incarnation of the
    # dead rank votes inside it and joins at the epoch boundary. The grace
    # is long (the window closes early once every expected rank voted), so
    # a slow respawn under a loaded test run still lands inside it
    tcore.config["recovery_rejoin_grace_s"] = 20.0
    rvs = [FileRendezvous(r, 3, str(tmp_path), timeout_s=40.0, run_id="t", heartbeat_interval_s=0.5)
           for r in range(3)]
    rvs[2].close()  # the original rank 2 dies
    out = {}

    def survivor(r):
        out[r] = rvs[r].reform(dead_ranks={2}, generation=1)

    def respawn():
        time.sleep(0.3)  # after the window opened
        out[2] = FileRendezvous(2, 3, str(tmp_path), timeout_s=40.0, run_id="t", heartbeat_interval_s=0.5).rejoin()

    threads = [threading.Thread(target=survivor, args=(r,)) for r in (0, 1)] + [threading.Thread(target=respawn)]
    t0 = time.monotonic()
    [t.start() for t in threads]
    [t.join(timeout=90) for t in threads]
    assert not any(t.is_alive() for t in threads)
    for r in range(3):
        assert (out[r].nranks, out[r].live_ranks, out[r].orig_rank) == (3, [0, 1, 2], r)
    assert time.monotonic() - t0 < 20.0  # the full vote closed the window before the grace
    assert not os.path.exists(out[2]._rejoin_wait_path(2))  # removed on admission
    for rv in list(out.values()) + rvs:
        rv.close()


def test_file_reform_declares_silent_rank_dead(tmp_path):
    r0 = FileRendezvous(0, 2, str(tmp_path), timeout_s=5.0, run_id="t", heartbeat_interval_s=0.2)
    try:
        new = r0.reform(dead_ranks=(), generation=1)  # no hint: the stale heartbeat decides
        assert (new.live_ranks, new.nranks) == ([0], 1)
        new.close()
    finally:
        r0.close()


def test_file_reform_times_out_typed_when_a_rank_neither_votes_nor_dies(tmp_path):
    rvs = [FileRendezvous(r, 2, str(tmp_path), timeout_s=1.0, run_id="t", heartbeat_interval_s=0.1)
           for r in range(2)]
    try:
        with pytest.raises(terrors.RendezvousTimeoutError) as ei:
            rvs[0].reform(dead_ranks=(), generation=1)  # rank 1 heartbeats on and never votes
        assert ei.value.missing_ranks == [1]
    finally:
        for rv in rvs:
            rv.close()


def test_file_reform_dirs_anchor_at_original_root(tmp_path):
    r = FileRendezvous(0, 1, str(tmp_path), timeout_s=10.0, run_id="t", heartbeat_interval_s=0.2)
    anchor = r.root
    g1 = r.reform(dead_ranks=(), generation=1)
    assert g1.root == os.path.join(anchor, "reform_g1", "plane")
    g2 = g1.reform(dead_ranks=(), generation=2)
    assert g2.root == os.path.join(anchor, "reform_g2", "plane")
    respawn = FileRendezvous(0, 1, str(tmp_path), timeout_s=5.0, run_id="t", heartbeat_interval_s=0)
    assert respawn.latest_generation() == 2
    assert respawn._rejoin_wait_path(0) == g2._rejoin_wait_path(0)
    for rv in (r, g1, g2, respawn):
        rv.close()


def test_rejoin_marker_raises_current_index(tmp_path):
    rv = FileRendezvous(0, 2, str(tmp_path), timeout_s=5.0, heartbeat_interval_s=0, live_ranks=[0, 2])
    with open(rv._rejoin_wait_path(2), "w") as f:
        f.write("{}")
    with pytest.raises(terrors.RankFailedError) as ei:
        rv._check_failures({1}, round_index=0)
    assert ei.value.failed_rank == 1 and "original rank 2" in ei.value.reason
    rv.close()


def test_stale_reform_dirs_cleaned_on_run_id_less_reuse(tmp_path):
    stale = tmp_path / "reform_g1"
    (stale / "plane" / "round_0").mkdir(parents=True)
    (stale / "member_rank_0").write_text("{}")
    (stale / "plane" / "round_0" / "rank_0").write_text("old")
    old = time.time() - 7200
    for dirpath, _, filenames in os.walk(stale, topdown=False):
        for name in filenames:
            os.utime(os.path.join(dirpath, name), (old, old))
        os.utime(dirpath, (old, old))
    fresh = tmp_path / "reform_g2"
    fresh.mkdir()
    (fresh / "member_rank_1").write_text("{}")
    rv = FileRendezvous(0, 2, str(tmp_path), timeout_s=5.0, heartbeat_interval_s=0)
    assert not stale.exists() and fresh.exists()
    rv.close()


def test_file_rendezvous_rejoin_marker_outranks_heartbeat(tmp_path):
    # the respawn heartbeats the dead rank's liveness file from construction;
    # its rejoin marker must still fail a survivor's round within a scan
    r0 = FileRendezvous(0, 2, str(tmp_path), timeout_s=60.0, run_id="t", heartbeat_interval_s=0.1)
    r1_respawn = FileRendezvous(1, 2, str(tmp_path), timeout_s=60.0, run_id="t", heartbeat_interval_s=0.1)
    err = [None]

    def work():
        try:
            r0.allgather("payload")
        except Exception as e:  # noqa: BLE001 - asserted below
            err[0] = e

    t = threading.Thread(target=work)
    t.start()
    time.sleep(0.3)  # heartbeat touches land: rank 1 looks alive
    t0 = time.monotonic()
    with open(r1_respawn._rejoin_wait_path(1), "w") as f:
        f.write("{}")
    t.join(timeout=10)
    r0.close()
    r1_respawn.close()
    assert not t.is_alive() and time.monotonic() - t0 < 2.0
    assert isinstance(err[0], terrors.RankFailedError)
    assert err[0].failed_rank == 1 and "rejoin" in err[0].reason


def test_rendezvous_without_reform_refuses():
    from spark_rapids_ml_tpu_torch.parallel import BarrierRendezvous

    b = BarrierRendezvous(SimpleNamespace(allGather=lambda p: [p], partitionId=lambda: 0, getTaskInfos=lambda: [0]))
    assert b.can_reform is False and b.live_ranks == [0] and b.orig_rank == 0
    with pytest.raises(NotImplementedError, match="reform"):
        b.reform(dead_ranks={1})


# --------------------------------------------------- the placement key ----


def test_placement_key_names_the_membership():
    # a checkpoint taken under one membership resumes only its portable
    # subset under another: ranks sharing a card have one device index
    from spark_rapids_ml_tpu_torch.ops.owlqn import LoopCheckpoint

    def inputs(live):
        ctx = SimpleNamespace(is_spmd=len(live) > 1, live_ranks_hint=lambda: list(live))
        return tcore.FitInputs(X=None, w=None, n_valid=9, n_cols=3, dtype=np.float64, device=torch.device("cpu"),
                               ctx=ctx)

    before, after = tckpt.placement_key_of(inputs([0, 1, 2])), tckpt.placement_key_of(inputs([1, 2]))
    assert before == ((0, 0, 1, 2), 9, 3, "float64") and after == ((0, 1, 2), 9, 3, "float64")
    tcore.config["checkpoint_every_iters"] = 1
    with tckpt.checkpoint_scope():
        saver = LoopCheckpoint.active("glm", "glm", placement_key=before)
        saver.save(3, {"x": torch.arange(3.0, dtype=torch.float64)}, {})
        exact, portable = LoopCheckpoint.active("glm", "glm", placement_key=before).restore()
        assert exact is not None and portable is None
        exact, portable = LoopCheckpoint.active("glm", "glm", placement_key=after).restore()
        assert exact is None
        np.testing.assert_array_equal(portable, [0.0, 1.0, 2.0])


def test_adopt_reform_without_a_group_renumbers():
    rvs = LocalRendezvous.create(2, timeout_s=5.0)
    ctx = TpuContext(1, 2, rvs[1])
    new = _threads(2, lambda r: rvs[r].reform(dead_ranks={0}, generation=1) if r else None)[1]
    ctx.adopt_reform(new)
    assert (ctx.rank, ctx.nranks, ctx.recovery_generation, ctx.live_ranks_hint()) == (0, 1, 1, [1])


def test_what_stays_refused_names_its_item(monkeypatch):
    # a program over several devices (A10h); under SPMD, a rank driving
    # several cards and the scheduler (A10i, second half)
    from spark_rapids_ml_tpu_torch import FitScheduler, KMeans, parallel
    from spark_rapids_ml_tpu_torch.core import PredictProgram

    model = KMeans(k=2, maxIter=2).setFeaturesCol("features").fit({"features": np.arange(12.0).reshape(6, 2)})
    with pytest.raises(NotImplementedError, match="A10h"):
        PredictProgram(model, mesh=object())
    monkeypatch.setattr(parallel, "visible_device_count", lambda: 2)
    with FitScheduler() as sched:
        monkeypatch.setattr(TpuContext, "current", classmethod(lambda cls: SimpleNamespace(is_spmd=True)))
        with pytest.raises(NotImplementedError, match="A10i, second half"):
            parallel.refuse_devices_per_rank(2, "KMeans fit")
        with pytest.raises(NotImplementedError, match="A10i, second half"):
            sched.submit(KMeans(k=2), {"features": np.arange(12.0).reshape(6, 2)})


# ------------------------------------------ processes, killed mid-fit ----

_RUNS = {}


def _launch(name, script, argv_of, nranks, tmp, plan="", env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"  # twelve small interpreters at once: no thread pools of their own
    env["SRML_FAULT_PLAN"] = plan
    env.update(env_extra or {})
    out_dir = os.path.join(tmp, "out")
    os.makedirs(out_dir)
    run_id = uuid.uuid4().hex

    def spawn(rank, mode="recover", **env_overrides):
        """One rank; `mode` "rejoin" respawns a killed one (the chaos worker)."""
        return subprocess.Popen(
            [sys.executable, os.path.join(HERE, script),
             *argv_of(rank, os.path.join(tmp, "rdv"), out_dir, run_id, mode)],
            env=dict(env, **env_overrides), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    _RUNS[name] = ([spawn(r) for r in range(nranks)], out_dir, spawn)


def _chaos_argv(nranks, iters, heartbeat_s, timeout_s):
    return lambda r, rdv, out, run_id, mode: [str(r), str(nranks), rdv, out, run_id, str(iters), str(heartbeat_s),
                                              str(timeout_s), mode]


def _kmeans_argv(victim):
    return lambda r, rdv, out, run_id, mode: ["recover", str(r), "3", rdv, out, run_id, str(victim)]


@pytest.fixture
def runs():
    """The killed-rank runs a test starts (one at a time: each is three
    interpreters, and a loaded host starves heartbeats); stopped after it."""
    yield _RUNS
    for procs, _, _ in _RUNS.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    _RUNS.clear()


def _wait(procs, timeout=180):
    outputs = []
    for p in procs:
        try:
            outputs.append(p.communicate(timeout=timeout)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return outputs


def _read(out_dir, r):
    with open(os.path.join(out_dir, f"result_rank{r}.json")) as f:
        return json.load(f)


def _jax_lloyd_reference(iters):
    from tests.test_chaos import _lloyd_reference

    return _lloyd_reference(iters)


def _check_harness(name, victim, survivors, iters, runs):
    procs, out_dir, _ = runs[name]
    outputs = _wait(procs)
    assert procs[victim].returncode == -signal.SIGKILL
    ref = _jax_lloyd_reference(iters)
    results = []
    for r in survivors:
        assert procs[r].returncode == 0, f"rank {r}:\n{outputs[r]}"
        res = _read(out_dir, r)
        assert res["error"] is None, res
        assert res["live_final"] == list(survivors) and res["generation"] == 1 and res["orig_rank"] == r
        np.testing.assert_allclose(res["centers"], ref, rtol=1e-9)
        results.append(res)
    return results


def test_sigkill_mid_solve_recovers_on_survivors(runs, tmp_path):
    # the JAX package's acceptance scenario: rank 2 SIGKILLed at round 8,
    # after the iteration-2 checkpoint; the survivors reform and RESUME
    _launch("sigkill_mid_solve", "torch_chaos_worker.py", _chaos_argv(3, 6, 2.0, 45.0), 3, str(tmp_path),
            plan="kill:rank=2:round=8")
    for res in _check_harness("sigkill_mid_solve", 2, (0, 1), 6, runs):
        c = res["counters"]
        assert (c["fit.recoveries"], c["recovery.epochs"], c["recovery.rank_losses"], c["rendezvous.reforms"]) \
            == (1, 1, 1, 1)
        assert c["checkpoint.saves"] >= 1 and c["checkpoint.restores"] >= 1


@pytest.mark.parametrize("kill_round", [0, pytest.param(1, marks=pytest.mark.slow),
                                        pytest.param(2, marks=pytest.mark.slow),
                                        pytest.param(7, marks=pytest.mark.slow),
                                        pytest.param(11, marks=pytest.mark.slow)])
def test_kill_at_every_round_recovers_or_types(kill_round, runs, tmp_path):
    name = f"kill_round_{kill_round}"
    _launch(name, "torch_chaos_worker.py", _chaos_argv(3, 5, 2.0, 45.0), 3, str(tmp_path),
            plan=f"kill:rank=1:round={kill_round}")
    for res in _check_harness(name, 1, (0, 2), 5, runs):
        assert res["counters"]["fit.recoveries"] == 1


@pytest.mark.slow
def test_sigkill_then_rejoin_restores_full_strength(runs, tmp_path):
    # the victim is respawned after its death and rejoins at the epoch
    # boundary (the window held open by the rejoin grace): the fit ends at
    # full strength, the fresh rank catching up from the first round
    _launch("rejoin", "torch_chaos_worker.py", _chaos_argv(3, 6, 3.0, 90.0), 3, str(tmp_path),
            plan="kill:rank=2:round=8:respawn=1", env_extra={"SRML_TEST_REJOIN_GRACE": "60"})
    procs, out_dir, spawn = runs["rejoin"]
    assert procs[2].wait(timeout=120) == -signal.SIGKILL
    # the respawn must not inherit the plan that killed its predecessor
    respawned = spawn(2, "rejoin", SRML_FAULT_PLAN="")
    outputs = _wait(procs[:2]) + _wait([respawned])
    ref = _jax_lloyd_reference(6)
    for r, (rc, out) in enumerate([(procs[0].returncode, outputs[0]), (procs[1].returncode, outputs[1]),
                                   (respawned.returncode, outputs[2])]):
        assert rc == 0, f"rank {r}:\n{out}"
        res = _read(out_dir, r)
        assert res["error"] is None and res["live_final"] == [0, 1, 2] and res["orig_rank"] == r, res
        np.testing.assert_allclose(res["centers"], ref, rtol=1e-9)


def _ranked_lloyd(blocks, centers, iters):
    """A one-process Lloyd loop whose step sums the row blocks in rank
    order, as the survivors' group sums them (`allreduce_fixed`)."""
    from spark_rapids_ml_tpu_torch.ops.distance import tile_assign_accumulate
    from spark_rapids_ml_tpu_torch.ops.kmeans import _finish_centers, lloyd_loop

    parts = [(torch.from_numpy(b), torch.ones(len(b), dtype=torch.float64)) for b in blocks]

    def step(c, fast):
        acc = None
        for x, w in parts:
            part = tile_assign_accumulate(x, w, c, 32768, fast)
            acc = part if acc is None else tuple(a + b for a, b in zip(acc, part))
        return _finish_centers(*acc, c)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' setting (OMP_NUM_THREADS=1)
    try:
        return lloyd_loop(step, torch.from_numpy(np.asarray(centers)), max_iter=iters, tol=0.0, fast=False)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("victim", [0, 2])
def test_kmeans_rank_killed_mid_solve_resumes_on_a_new_group(victim, runs, tmp_path):
    # a real KMeans fit over three gloo ranks; rank `victim` (rank 0 hosts
    # the group's store) is SIGKILLed after its iteration-2 checkpoint. The
    # survivors reform, reopen the process group, lay their rows out again
    # from the host blocks and resume from the portable centers, ending
    # equal to each other and to the survivors' two-rank Lloyd run
    sys.path.insert(0, HERE)
    try:
        from torch_mp_worker import RECOVER_BOUNDS, RECOVER_KMEANS, recover_rows
    finally:
        sys.path.remove(HERE)
    _launch(f"kmeans_{victim}", "torch_mp_worker.py", _kmeans_argv(victim), 3, str(tmp_path))
    procs, out_dir, _ = runs[f"kmeans_{victim}"]
    outputs = _wait(procs)
    assert procs[victim].returncode == -signal.SIGKILL, outputs[victim]
    survivors = [r for r in range(3) if r != victim]
    res = []
    for new_rank, r in enumerate(survivors):
        assert procs[r].returncode == 0, f"rank {r}:\n{outputs[r]}"
        got = _read(out_dir, r)
        assert got["error"] is None, got
        assert (got["live"], got["rank_now"], got["nranks_now"], got["generation"], got["backend"]) == (
            survivors, new_rank, 2, 1, "gloo")
        assert got["spmd"] == {"rank": new_rank, "nranks": 2, "backend": "gloo"}
        c = got["counters"]
        assert (c["fit.recoveries"], c["recovery.epochs"], c["recovery.rank_losses"], c["rendezvous.reforms"]) == (
            1, 1, 1, 1)
        assert c["checkpoint.restores"] >= 1  # resumed, not started again
        assert c["ingest.datasets"] == 1 and c["fit.device_dataset_builds"] == 1
        lo, hi = RECOVER_BOUNDS[r], RECOVER_BOUNDS[r + 1]
        assert c["recovery.replacements"] == 1 and c["recovery.rows_replaced"] == hi - lo
        assert got["n_iter"] == RECOVER_KMEANS["maxIter"]
        assert [e["iteration"] for e in got["resumed"]] == [2]
        res.append(got)
    np.testing.assert_array_equal(res[0]["centers"], res[1]["centers"])
    np.testing.assert_array_equal(res[0]["resumed"][0]["centers"], res[1]["resumed"][0]["centers"])
    X = recover_rows()
    blocks = [X[RECOVER_BOUNDS[r]:RECOVER_BOUNDS[r + 1]] for r in survivors]
    ref = _ranked_lloyd(blocks, res[0]["resumed"][0]["centers"], RECOVER_KMEANS["maxIter"] - 2)
    np.testing.assert_array_equal(np.asarray(res[0]["centers"]), ref["cluster_centers_"].numpy())
