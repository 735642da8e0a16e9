#
# Fault injection: the port's copy of the plan parser, the `oom` and `fail`
# halves and the serving stage hooks of spark_rapids_ml_tpu/parallel/chaos.py,
# the test substrate of the fit-side memory ladder (memory.admit_fit,
# core._TpuCaller's OOM retry), of recovery (core.retryable_stage and the
# solver checkpoints) and of the serving overload ladder.
#
# A fault plan is a spec string (the `SRML_FAULT_PLAN` environment variable,
# or `set_fault_plan()` in process): semicolon-separated entries, each
# `kind:key=value:key=value...`. Every kind of the JAX package parses, with
# its checks:
#
#   oom:budget=1048576             SHRINK the device budget: the next
#                                  admission (`parallel.device_capacity_bytes`
#                                  consults `injected_hbm_budget()` ahead of
#                                  every other source) budgets against this
#                                  many bytes, so RESIDENT -> STREAM ->
#                                  HbmBudgetError runs without a full card
#   oom:stage=placement            a simulated ALLOCATION FAILURE: a
#                                  torch.OutOfMemoryError raised just before
#                                  a resident fit places its rows
#                                  (`maybe_fail_oom`, `round=` matching the
#                                  fit stage's attempt), which takes the
#                                  same path as a real one
#   oom:stage=solve:round=4        the same, raised as a fit dispatches its
#                                  solves (index 0) and at every solver
#                                  checkpoint boundary (index = the
#                                  iteration), AFTER the boundary's
#                                  checkpoint landed: the OOM ladder's
#                                  streamed retry resumes from it
#   fail:stage=fit                 a TRANSIENT failure: `maybe_fail_stage`
#   fail:stage=solve:round=20      raises RendezvousTimeoutError at the top
#                                  of every `core.retryable_stage` attempt
#                                  (stage=fit, index = the attempt) and at
#                                  every solver checkpoint boundary
#                                  (stage=solve, index = the iteration; the
#                                  retained statistics' solve, index 0), so
#                                  the bounded retry resumes from the
#                                  checkpoint. Without `round=` it fires at
#                                  the first consult, as in the JAX package;
#                                  the JAX package ignores a `fail` entry's
#                                  `round=`, the port matches it as `oom`'s
#   delay:stage=serve:seconds=0.02 latency injection: the serving engine
#                                  sleeps this long before each dispatch
#                                  while the entry has firings left
#                                  (`maybe_delay_stage`), pinning the service
#                                  time of an overload drill
#   burst:stage=serve:rows=4096:seconds=2   an offered-load burst: the
#                                  harness driving the stage (chip_smoke.py's
#                                  saturation protocol, the tests) consults
#                                  `maybe_burst_stage` and ramps its offered
#                                  load to `rows` rows/s for `seconds`
#
#   kill:rank=1:round=3            the rendezvous faults, applied by a
#   abort:rank=1:round=3           `ChaosRendezvous` around a rank's
#   delay:rank=0:round=2:seconds=0.5   rendezvous at its Nth round of the
#   drop:rank=1:round=2            attempt: SIGKILL the process (no abort
#                                  file, no atexit: what heartbeats are
#                                  for), publish the abort and raise, sleep
#                                  before joining, or never join (every
#                                  rank, the dropper too, raises the
#                                  symmetric RendezvousTimeoutError)
#
# Every entry fires at most `times` times (default 1), so the retry runs
# clean. `rank=` restricts an entry to the process of that rank: the
# active TpuContext's rank, else `SRML_RANK` (0 when unset).
#
from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .context import Rendezvous

__all__ = [
    "Fault", "parse_fault_plan", "set_fault_plan", "clear_fault_plan", "active_plan",
    "maybe_fail_oom", "maybe_fail_stage", "injected_hbm_budget", "maybe_delay_stage", "maybe_burst_stage",
    "ChaosRendezvous",
]

_KINDS = {"kill", "abort", "delay", "drop", "fail", "oom", "burst"}


@dataclass
class Fault:
    kind: str  # kill | abort | delay | drop | fail | oom | burst
    rank: Optional[int] = None  # which rank misbehaves
    round: Optional[int] = None  # at which round (oom: which attempt or iteration)
    stage: Optional[str] = None  # `fail`/`oom`/`burst`/`delay`: which stage
    seconds: float = 0.0  # `delay`/`burst`: how long
    reason: str = "chaos"  # `abort`: the published reason
    times: int = 1  # how many firings remain
    respawn: int = 0  # `kill`: the victim rejoins (informational)
    # `oom`: the injected per-device budget in bytes (0 = this entry is a
    # simulated allocation failure at stage/round instead)
    budget: int = 0
    rows: int = 0  # `burst`: offered load in rows/second
    fired: int = field(default=0)

    def spent(self) -> bool:
        return self.fired >= self.times


def parse_fault_plan(spec: str) -> List[Fault]:
    """Parse a plan spec; raises ValueError on a malformed entry, so a
    mistyped `SRML_FAULT_PLAN` fails loudly instead of injecting nothing."""
    faults: List[Fault] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        kind = parts[0].strip()
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in plan entry {entry!r}")
        kwargs: Dict[str, str] = {}
        for kv in parts[1:]:
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"malformed fault field {kv!r} in plan entry {entry!r}")
            kwargs[k.strip()] = v.strip()
        fault = Fault(kind=kind)
        for k, v in kwargs.items():
            if k in ("rank", "round", "times", "respawn", "budget", "rows"):
                setattr(fault, k, int(v))
            elif k == "seconds":
                fault.seconds = float(v)
            elif k in ("stage", "reason"):
                setattr(fault, k, v)
            else:
                raise ValueError(f"unknown fault field {k!r} in plan entry {entry!r}")
        if fault.kind == "fail":
            if fault.stage is None:
                raise ValueError(f"fail fault needs stage=<name>: {entry!r}")
        elif fault.kind == "oom":
            if fault.budget <= 0 and fault.stage is None:
                raise ValueError(f"oom fault needs budget=<bytes> or stage=<name>: {entry!r}")
        elif fault.kind == "burst":
            if fault.stage is None or fault.rows <= 0 or fault.seconds <= 0:
                raise ValueError(
                    f"burst fault needs stage=<name>, rows=<rows/s> and seconds=<s>: {entry!r}"
                )
        elif fault.kind == "delay" and fault.stage is not None:
            if fault.seconds <= 0:
                raise ValueError(f"delay:stage= fault needs seconds=<s>: {entry!r}")
        elif fault.rank is None or fault.round is None:
            raise ValueError(f"{fault.kind} fault needs rank= and round=: {entry!r}")
        faults.append(fault)
    return faults


# The process's plan: loaded once from SRML_FAULT_PLAN (so subprocesses
# inherit it through the environment), replaceable in process for tests.
# The firing state lives on the Fault objects.
_PLAN: Optional[List[Fault]] = None
_PLAN_LOADED = False


def active_plan() -> List[Fault]:
    global _PLAN, _PLAN_LOADED
    if not _PLAN_LOADED:
        spec = os.environ.get("SRML_FAULT_PLAN", "")
        _PLAN = parse_fault_plan(spec) if spec else []
        _PLAN_LOADED = True
    return _PLAN or []


def set_fault_plan(spec: str) -> List[Fault]:
    """Install a plan in process (tests); returns the parsed faults."""
    global _PLAN, _PLAN_LOADED
    _PLAN = parse_fault_plan(spec)
    _PLAN_LOADED = True
    return _PLAN


def clear_fault_plan() -> None:
    global _PLAN, _PLAN_LOADED
    _PLAN = []
    _PLAN_LOADED = True


def _rank_matches(f: Fault) -> bool:
    """A `rank=`-restricted entry fires only in the process of that rank
    (`diagnostics._rank()`: the active TpuContext's, else `SRML_RANK`)."""
    if f.rank is None:
        return True
    from .. import diagnostics

    return diagnostics._rank() == f.rank


def injected_hbm_budget() -> Optional[int]:
    """The shrunken per-device budget of an unspent `oom:budget=<bytes>`
    entry, spending one firing, or None."""
    for f in active_plan():
        if f.kind == "oom" and f.budget > 0 and not f.spent() and _rank_matches(f):
            f.fired += 1
            return f.budget
    return None


def maybe_fail_oom(stage: str, index: int = 0) -> None:
    """A simulated allocation failure: an unspent `oom:stage=<stage>` entry
    whose `round=` (when set) matches `index` raises torch.OutOfMemoryError,
    which `memory.is_oom_error` cannot tell from a real one, so the whole
    catch-convert-retry ladder runs."""
    for f in active_plan():
        if (
            f.kind != "oom"
            or f.budget > 0
            or f.stage != stage
            or f.spent()
            or (f.round is not None and f.round != index)
            or not _rank_matches(f)
        ):
            continue
        f.fired += 1
        import torch

        raise torch.OutOfMemoryError(
            f"CUDA out of memory (chaos: injected oom at stage={stage} index={index})"
        )


def maybe_fail_stage(stage: str, index: int) -> None:
    """A simulated transient failure: an unspent `fail:stage=<stage>` entry
    whose `round=` (when set) matches `index` raises
    `errors.RendezvousTimeoutError`, the retryable class, spending one
    firing. Consulted by `core.retryable_stage` at the top of every attempt
    (index = the attempt) and by the solvers after each checkpoint landed
    (index = the iteration)."""
    for f in active_plan():
        if (
            f.kind != "fail"
            or f.stage != stage
            or f.spent()
            or (f.round is not None and f.round != index)
            or not _rank_matches(f)
        ):
            continue
        f.fired += 1
        # the flight-recorder event of the firing (`chaos_injection`) arrives with A15
        from ..errors import RendezvousTimeoutError

        raise RendezvousTimeoutError(
            f"chaos: injected transient failure at stage {stage!r} attempt {index}",
            timeout_s=0.0,
        )


def maybe_delay_stage(stage: str) -> None:
    """Stage-scoped latency injection: an unspent `delay:stage=<stage>`
    entry sleeps `seconds` before the stage runs, spending one firing."""
    for f in active_plan():
        if f.kind != "delay" or f.stage != stage or f.spent() or not _rank_matches(f):
            continue
        f.fired += 1
        # the flight-recorder event of the firing (`chaos_injection`) arrives with A15
        time.sleep(f.seconds)  # the plan-bounded injected stage delay


def maybe_burst_stage(stage: str) -> Optional[Fault]:
    """Offered-load burst: an unspent `burst:stage=<stage>` entry is spent
    (one firing) and returned; the consulting harness then ramps its offered
    load to `fault.rows` rows/s for `fault.seconds`. None when no entry
    matches. The burst is traffic the caller generates, so the entry is the
    load's shape, and the plan stays the one place a drill's faults are
    declared."""
    for f in active_plan():
        if f.kind != "burst" or f.stage != stage or f.spent() or not _rank_matches(f):
            continue
        f.fired += 1
        # the flight-recorder event of the firing (`chaos_injection`) arrives with A15
        return f
    return None


class ChaosRendezvous(Rendezvous):
    """A rendezvous wrapper that applies the plan's rendezvous faults
    (`kill`, `abort`, `delay`, `drop`) to an inner rendezvous. It counts its
    own rounds (reset by `begin_epoch`, as the inner's are), so a fault fires
    at "the Nth control-plane round of this attempt" of the rank it names."""

    def __init__(self, inner, plan: Optional[List[Fault]] = None):
        self.inner = inner
        self.rank = inner.rank
        self.nranks = inner.nranks
        self.plan = plan if plan is not None else active_plan()
        self._round = 0
        self._epoch = 0

    def _apply_faults(self, round_index: int) -> None:
        for f in self.plan:
            if (
                f.kind in ("fail", "oom", "burst")  # stage and budget hooks, not rounds
                or (f.kind == "delay" and f.stage is not None)
                or f.spent()
                or f.rank != self.rank
                or f.round != round_index
            ):
                continue
            f.fired += 1
            # the flight-recorder event of the firing (`chaos_injection`) arrives with A15
            if f.kind == "delay":
                time.sleep(f.seconds)  # the plan-bounded injected delay
            elif f.kind == "abort":
                self.inner.abort(f.reason)
                raise RuntimeError(f"chaos: rank {self.rank} aborted at round {round_index} ({f.reason})")
            elif f.kind == "drop":
                # the message is lost: never join the round, and wait out
                # this rank's own deadline, so its failure is the same
                # symmetric timeout its peers raise
                timeout_s = self.inner._round_timeout_s()
                time.sleep(timeout_s)
                self._raise_timeout(round_index, None, timeout_s)
            elif f.kind == "kill":
                # the hard death: no abort file, no atexit, no flush
                os.kill(os.getpid(), signal.SIGKILL)
                time.sleep(60)  # pragma: no cover - the signal is on its way

    def _allgather_impl(self, payload: str) -> List[str]:
        round_index = self._round
        self._round += 1
        self._apply_faults(round_index)
        return self.inner._allgather_impl(payload)

    def abort(self, reason: str) -> None:
        self.inner.abort(reason)

    def peer_failure(self):
        return self.inner.peer_failure()

    def begin_epoch(self, epoch: int) -> None:
        self.inner.begin_epoch(epoch)
        self._round = 0
        self._epoch = int(epoch)

    def close(self) -> None:
        self.inner.close()

    # the one-round override must land on the INNER instance, whose
    # _allgather_impl reads it
    def _get_timeout_override(self) -> Optional[float]:
        return self.inner._get_timeout_override()

    def _set_timeout_override(self, value: Optional[float]) -> None:
        self.inner._set_timeout_override(value)

    def _round_timeout_s(self) -> float:
        return self.inner._round_timeout_s()
