#
# Record tags, the trace scope and the flight recorder: the pieces of
# spark_rapids_ml_tpu/diagnostics.py that the ops plane's records carry (the
# audit log, the Prometheus rank label, the report's `meta` header), that
# the tuning layer keys its sweep ledger by, and that the fleet plane's
# events land in.
#
#   `_rank()`         this process's rank: the active TpuContext's, else
#                     `SRML_RANK`, else 0;
#   `trace_scope()`   the trace identity of a fit or a sweep for its extent:
#                     a minted (or launcher-given `SRML_TRACE_ID`) trace id
#                     and a fit id; under a multi-process TpuContext rank
#                     0's id, shared through one rendezvous round, on which
#                     rank 0 also schedules the fleet plane's ops round; a
#                     nested scope adopts the enclosing trace id;
#   `current_trace()` the active scope's ids, or None;
#   `trace_tags()`    the active scope's ids, else ``{"trace_id":
#                     SRML_TRACE_ID}`` when a launcher minted one, else
#                     ``{}``;
#   `FlightRecorder`  a bounded, always-on ring of structured events
#                     (`record_event`: the rendezvous rounds, the trace
#                     scopes, the fleet's ops rounds and stragglers), each
#                     tagged with the rank and `trace_tags()`. Sized by
#                     `SRML_FLIGHTREC_EVENTS`, off with `SRML_FLIGHTREC=0`;
#                     an overwritten event is counted (`stats()["dropped"]`,
#                     the `flightrec.events_dropped` counter). `dump()`
#                     writes the ring as JSONL.
#
# Not here, each named in ROADMAP A15: the dump on an SrmlError
# (`on_srml_error`), the post-mortem assembled from the ranks' dumps, and
# the merge of the ranks' Chrome traces with the JSONL sinks it reads. The
# JAX package's other call sites of `record_event` on the ported paths
# carry a comment naming A15 in their place.
#
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import sys
import time
import uuid
from typing import Any, Dict, List, Optional

from .utils import lockcheck

__all__ = [
    "trace_tags", "trace_scope", "current_trace", "FlightRecorder", "flight_recorder", "record_event",
    "flightrec_dir", "flightrec_dump_path",
]

FLIGHTREC_FILE_PREFIX = "flightrec_rank_"
# the ring's default capacity and tail length
_DEFAULT_CAPACITY = 2048
_DEFAULT_TAIL = 25

_TRACE: "contextvars.ContextVar[Optional[Dict[str, Any]]]" = contextvars.ContextVar(
    "srml_torch_trace", default=None
)
_FIT_SEQ = itertools.count(1)
# the payload prefix of the trace-id round, versioned as the JAX package's
_TRACE_ROUND_PREFIX = "TRACE1:"


def _rank() -> int:
    """This process's rank for record tagging: the active TpuContext's
    rank, else `SRML_RANK`, else 0 (a malformed value counts as unset).
    Never raises: every flight-recorder event asks."""
    from .parallel.context import TpuContext

    rank = getattr(TpuContext.current(), "rank", None)
    if rank is not None:
        return rank
    env = os.environ.get("SRML_RANK")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    return 0


def current_trace() -> Optional[Dict[str, Any]]:
    """The active trace ``{"trace_id", "fit_id"}``, or None."""
    return _TRACE.get()


def trace_tags() -> Dict[str, Any]:
    """Tags every decision record carries: the active trace scope's ids, a
    launcher-minted ``SRML_TRACE_ID``, or nothing."""
    t = _TRACE.get()
    if t is not None:
        return dict(t)
    env_id = os.environ.get("SRML_TRACE_ID")
    if env_id:
        return {"trace_id": env_id}
    return {}


@contextlib.contextmanager
def trace_scope(label: str, ctx: Any = None):
    """The trace identity for the dynamic extent: ``fit_id`` a process-local
    sequence ("fit-<n>", equal across ranks that run in lockstep),
    ``trace_id`` the enclosing scope's, else ``SRML_TRACE_ID``, else a
    minted one. Under a multi-process context (`ctx.is_spmd`) rank 0's id
    is shared through one rendezvous round, so every rank's fit has the same
    id. On that round rank 0 alone decides whether the fleet plane's ops
    round follows (`fleet.ops_due()`, sent as a ``|ops`` suffix: a clock
    on every rank would desync the lockstep rounds), and every rank that
    sees the flag runs `fleet.ops_round` next. The exchange is not fatal: a
    failure records `trace_exchange_failed` and keeps the local id, and a
    broken control plane surfaces at the fit's own next round, inside its
    retries. `trace_begin` and `trace_end` carry `label`."""
    fit_id = f"fit-{next(_FIT_SEQ)}"
    outer = _TRACE.get()
    if outer is not None:
        trace_id = outer["trace_id"]
    else:
        trace_id = os.environ.get("SRML_TRACE_ID") or uuid.uuid4().hex[:16]
        rendezvous = getattr(ctx, "rendezvous", None)
        if ctx is not None and getattr(ctx, "is_spmd", False) and rendezvous is not None:
            try:
                # sys.modules probe: the trace round does not pay the ops
                # plane's imports, and a rank 0 that never loaded the fleet
                # plane schedules no ops round. Trace ids are hex, so "|"
                # cannot collide
                fleet = sys.modules.get(__package__ + ".ops_plane.fleet")
                flag = "|" + fleet.OPS_ROUND_FLAG if fleet is not None and ctx.rank == 0 and fleet.ops_due() else ""
                root = rendezvous.allgather(_TRACE_ROUND_PREFIX + (trace_id if ctx.rank == 0 else "") + flag)[0]
                ops_follows = False
                if root.startswith(_TRACE_ROUND_PREFIX):
                    rid, sep, tail = root[len(_TRACE_ROUND_PREFIX):].partition("|")
                    if rid:
                        trace_id = rid
                    if sep and "ops" in tail.split("|"):
                        if fleet is None:
                            # rank 0 runs the fleet plane and this process has
                            # not loaded it: load it rather than desync the
                            # round rank 0 enters next
                            from .ops_plane import fleet  # noqa: PLC0415
                        ops_follows = True
                if ops_follows:
                    # every rank saw the same root payload, so every rank
                    # enters the ops round (one with telemetry off sends the
                    # bare marker); ops_round never raises
                    fleet.ops_round(rendezvous)
            except Exception as e:
                record_event("trace_exchange_failed", label=label, error=type(e).__name__)
    tags = {"trace_id": trace_id, "fit_id": fit_id}
    token = _TRACE.set(tags)
    record_event("trace_begin", label=label)
    try:
        yield dict(tags)
    finally:
        record_event("trace_end", label=label)
        _TRACE.reset(token)


# --------------------------------------------------------- flight recorder --


class FlightRecorder:
    """A bounded, always-on ring of structured events. `record` is one
    clock read, one small dict and one slot write under a lock; at capacity
    the oldest event is overwritten, and every overwrite is counted
    (`stats()["dropped"]` and the `flightrec.events_dropped` counter)."""

    def __init__(self, capacity: Optional[int] = None, enabled: Optional[bool] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("SRML_FLIGHTREC_EVENTS", _DEFAULT_CAPACITY))
            except ValueError:  # a malformed knob keeps the default
                capacity = _DEFAULT_CAPACITY
        if enabled is None:
            enabled = os.environ.get("SRML_FLIGHTREC", "1") not in ("0", "false", "off")
        self.capacity = max(1, int(capacity))
        self.enabled = bool(enabled)
        self._lock = lockcheck.make_lock("diagnostics.FlightRecorder._lock")
        self._buf: List[Optional[Dict[str, Any]]] = [None] * self.capacity  # guarded-by: _lock
        self._next = 0  # the next slot to write  # guarded-by: _lock
        self._total = 0  # events ever recorded  # guarded-by: _lock
        self._dropped = 0  # events overwritten  # guarded-by: _lock

    def record(self, kind: str, **fields: Any) -> None:
        if not self.enabled:
            return
        ev = {"t": time.time(), "kind": kind, "rank": _rank(), **trace_tags(), **fields}
        with self._lock:
            dropped = self._buf[self._next] is not None
            self._buf[self._next] = ev
            self._next = (self._next + 1) % self.capacity
            self._total += 1
            if dropped:
                self._dropped += 1
        if dropped:
            from . import telemetry

            telemetry.registry().inc("flightrec.events_dropped")

    def events(self) -> List[Dict[str, Any]]:
        """Every retained event, oldest first."""
        with self._lock:
            ordered = self._buf[self._next:] + self._buf[: self._next]
        return [dict(e) for e in ordered if e is not None]

    def tail(self, k: int = _DEFAULT_TAIL) -> List[Dict[str, Any]]:
        """The newest `k` retained events, oldest first (none for k <= 0)."""
        if k <= 0:
            return []
        evs = self.events()
        return evs[-k:] if k < len(evs) else evs

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "recorded": self._total,
                "retained": min(self._total, self.capacity) if self.enabled else 0,
                "dropped": self._dropped,
            }

    def reset(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._next = 0
            self._total = 0
            self._dropped = 0

    def dump(self, path: Optional[str] = None, reason: str = "") -> Optional[str]:
        """Write the retained ring as JSONL, one event a line and a closing
        ``{"kind": "flightrec_dump"}`` line with the stats and `reason`.
        `path` defaults to ``flightrec_rank_<r>.jsonl`` under
        `flightrec_dir()`; with no directory (or the recorder off) nothing
        is written and None returned. Written to a temporary file and
        renamed, so a reader never sees a torn file."""
        if not self.enabled:
            return None
        if path is None:
            path = flightrec_dump_path()
            if path is None:
                return None
        footer = {"kind": "flightrec_dump", "t": time.time(), "rank": _rank(), "reason": reason, **trace_tags(),
                  **self.stats()}
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(tmp, "w") as f:
                for ev in self.events():
                    f.write(json.dumps(ev, default=str) + "\n")
                f.write(json.dumps(footer, default=str) + "\n")
            os.replace(tmp, path)
        except OSError:  # a dump is best-effort
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            return None
        return path


_RECORDER = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return _RECORDER


def record_event(kind: str, **fields: Any) -> None:
    """Record one event in the process's flight recorder."""
    _RECORDER.record(kind, **fields)


def flightrec_dir() -> Optional[str]:
    """The dump directory, ``SRML_FLIGHTREC_DIR``, or None."""
    return os.environ.get("SRML_FLIGHTREC_DIR") or None


def flightrec_dump_path(rank: Optional[int] = None) -> Optional[str]:
    d = flightrec_dir()
    if not d:
        return None
    return os.path.join(d, f"{FLIGHTREC_FILE_PREFIX}{_rank() if rank is None else rank}.jsonl")
