#
# Fault injection: the port's copy of the plan parser, the `oom` half and
# the serving stage hooks of spark_rapids_ml_tpu/parallel/chaos.py, the test
# substrate of the fit-side memory ladder (memory.admit_fit,
# core._TpuCaller's OOM retry) and of the serving overload ladder.
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
#                                  (`maybe_fail_oom`), which takes the same
#                                  path as a real one
#   oom:stage=solve                the same, raised as a fit dispatches its
#                                  solves (round-less plans)
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
# Every entry fires at most `times` times (default 1), so the retry runs
# clean. `rank=` restricts an entry to the process whose rank is
# `SRML_RANK` (0 when unset). Not wired yet, each named in ROADMAP: the
# `oom:stage=solve:round=` firings at solver checkpoint boundaries (A12);
# `kill`/`abort`/`drop` and the round-scoped `delay` (the rendezvous, A10),
# `fail` (the retryable stages, A12). They parse, and nothing consults
# them.
#
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = [
    "Fault", "parse_fault_plan", "set_fault_plan", "clear_fault_plan", "active_plan",
    "maybe_fail_oom", "injected_hbm_budget", "maybe_delay_stage", "maybe_burst_stage",
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
    (`SRML_RANK`, 0 when unset: the port runs one process per card)."""
    return f.rank is None or int(os.environ.get("SRML_RANK", "0") or 0) == f.rank


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
