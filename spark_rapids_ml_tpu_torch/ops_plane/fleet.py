#
# The fleet plane: the cluster's view over the ranks' ops planes. The
# port's copy of spark_rapids_ml_tpu/ops_plane/fleet.py.
#
# Each rank's ops plane sees only its own process: its SLO verdicts, its
# /metrics, its snapshot. This module answers for the cluster (is the fleet
# healthy, which rank is the straggler, how busy are the chips per tenant)
# through two transports that share one set of merge definitions
# (telemetry.py's merge_counters / merge_gauges / merge_histograms /
# merge_windows):
#
#   * the LIVE ops round, an exchange of each rank's compact window
#     snapshot on the rendezvous control plane. Rank 0 alone decides when a
#     round is due (`ops_due`: at most one per
#     `config["fleet_ops_round_seconds"]`, default one metrics bucket
#     width) and sends the decision as a `|ops` suffix on the trace round
#     every fit already runs (diagnostics.trace_scope): a clock on every
#     rank would desync the lockstep rounds, one decider cannot. The round
#     is not fatal at two layers: a rank that cannot build its payload sends
#     the bare marker, so the round still completes in lockstep, and a
#     failed allgather (a dead peer, a timeout) records `ops_round_failed`,
#     counts `fleet.ops_rounds_failed` and leaves the survivors with their
#     local views; the fit's own next round then raises the real failure
#     inside its retries. With telemetry off nothing is sent but the marker
#     and nothing is recorded.
#
#   * the OFFLINE merge, `read_rank_snapshots()` over the ranks'
#     `ops_snapshot*.json` files (export.write_snapshot), after the fact and
#     with dead ranks: each snapshot's `meta` header (rank, host, pid, t)
#     lets the merge drop a dead rank's stale data
#     (`config["fleet_stale_snapshot_s"]`) and name the missing ranks
#     rather than average them in.
#
# On the merged view: cluster SLO verdicts over the merged windows
# (slo.cluster_health over telemetry.MergedWindows: a `min_count` floor
# lets the fleet's burn trip while each rank's thin slice stays healthy);
# stragglers from the ranks' round-entry stamps (a rank the slowest by
# `fleet_straggler_min_lag_s` for `fleet_straggler_windows` ops rounds in a
# row gets a flight-recorder event and an audit entry naming it); and the
# 2-D ledger's chip occupancy rolled up (`fleet.chips_busy`,
# `fleet.chips_idle`, per-tenant sums through ledger.merge_tenant_usage).
#
# The chips of one process's fan-out (core.py, `InProcessRendezvous`) are
# not ranks here: their rounds leave no stamps and run no ops round.
#
from __future__ import annotations

import json
import os
import re
import socket
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..utils import lockcheck

__all__ = [
    "ops_due",
    "ops_round",
    "note_round_exit",
    "cluster_view",
    "cluster_report",
    "local_payload",
    "merge_payloads",
    "merge_reports",
    "read_rank_snapshots",
    "reset",
    "OPS_ROUND_PREFIX",
    "OPS_ROUND_FLAG",
]

# the payload's versioned prefix (as the trace round's); the prefix alone is
# the "no payload" marker that keeps the round lockstep and is skipped at
# the merge
OPS_ROUND_PREFIX = "OPS1:"
# the flag rank 0 appends to its trace-round payload to schedule a round
OPS_ROUND_FLAG = "ops"

# (epoch, round, t_enter, t_exit) stamps kept per rank for the straggler
# attribution: enough for the rounds between two ops rounds
_MAX_ROUND_EXITS = 64

_SNAPSHOT_NAME_RE = re.compile(r"^ops_snapshot(?:_rank_(\d+))?\.json$")

_LOCK = lockcheck.make_lock("ops_plane.fleet._LOCK")
_LAST_ROUND_T: Optional[float] = None  # rank 0's throttle clock  # guarded-by: _LOCK
_LAST_INGEST_KEY: Optional[Tuple[Any, Any]] = None  # guarded-by: _LOCK
_CLUSTER: Optional[Dict[str, Any]] = None  # the last merged live view  # guarded-by: _LOCK
# rank -> deque of [epoch, round, t_enter, t_exit]; a process holds its own
# rank's, except in the threaded LocalRendezvous harness, where the ranks'
# threads share this dict (keyed apart by rank)
_ROUND_EXITS: Dict[int, "deque[List[Any]]"] = {}  # guarded-by: _LOCK
_STRAGGLER_STREAKS: Dict[int, int] = {}  # guarded-by: _LOCK


def _cfg(key: str, default: Any) -> Any:
    from ..core import config

    v = config.get(key)
    return default if v is None else v


def _interval_s() -> float:
    from .. import telemetry

    v = _cfg("fleet_ops_round_seconds", None)
    if v is None:
        return float(telemetry.registry().bucket_seconds())
    return max(0.0, float(v))


# ------------------------------------------------------------- live round --


def ops_due(now: Optional[float] = None) -> bool:
    """Rank 0's throttle: True at most once per `fleet_ops_round_seconds`
    (default one metrics bucket width), never with telemetry off. Only rank
    0 asks; the others follow the `|ops` flag it sends, so the fleet agrees
    on a round without agreeing on a clock."""
    from .. import telemetry

    if not telemetry.enabled():
        return False
    global _LAST_ROUND_T
    t = time.monotonic() if now is None else float(now)
    interval = _interval_s()
    with _LOCK:
        if _LAST_ROUND_T is None or t - _LAST_ROUND_T >= interval:
            _LAST_ROUND_T = t
            return True
    return False


def note_round_exit(rank: int, round_index: Any, epoch: Any, t_enter: float, t_exit: float) -> None:
    """Stamp one rendezvous round's entry and exit (wall clock) for `rank`;
    the base allgather calls it with telemetry on. The stamps ride the next
    ops round's payload, where the merge turns the ranks' differences into
    straggler lags. Bounded per rank."""
    with _LOCK:
        dq = _ROUND_EXITS.get(int(rank))
        if dq is None:
            dq = _ROUND_EXITS[int(rank)] = deque(maxlen=_MAX_ROUND_EXITS)
        dq.append([epoch, round_index, float(t_enter), float(t_exit)])


def local_payload(rank: Optional[int] = None) -> Dict[str, Any]:
    """This rank's ops-round payload: its identity, cumulative counters,
    gauges and histograms, the windows by bucket age, the ledger's
    per-tenant usage and its recent round stamps."""
    from .. import diagnostics, telemetry
    from ..scheduler.ledger import global_ledger

    reg = telemetry.registry()
    snap = reg.snapshot()
    r = diagnostics._rank() if rank is None else int(rank)
    with _LOCK:
        exits = [list(e) for e in _ROUND_EXITS.get(r, ())]
    return {
        "v": 1,
        "rank": r,
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "t": time.time(),
        "trace_id": diagnostics.trace_tags().get("trace_id"),
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "hists": snap["histograms"],
        "windows": reg.windows_export(),
        "tenants": global_ledger().tenant_usage(),
        "round_exits": exits,
    }


def ops_round(
    rendezvous: Any,
    *,
    force: bool = False,
    payload: Optional[Dict[str, Any]] = None,
) -> Optional[Dict[str, Any]]:
    """Run one ops round over `rendezvous`; every rank calls it in lockstep
    (the trace round's flag sees to that; a harness calls it with
    `force=True`). Returns the merged cluster view, or None when this rank
    is left with its local view (a failed round, telemetry off). No
    exception escapes.

    `payload` replaces `local_payload()` (for harnesses: the threaded
    LocalRendezvous ranks share one registry, so distinct ranks need crafted
    payloads)."""
    from .. import diagnostics, telemetry

    body = ""
    try:
        if payload is not None:
            body = json.dumps(payload)
        elif telemetry.enabled():
            body = json.dumps(local_payload(getattr(rendezvous, "rank", None)))
    except Exception:
        # the bare marker keeps the round lockstep; the peers merge without
        # this rank and name it missing
        body = ""
    try:
        gathered = rendezvous.allgather(OPS_ROUND_PREFIX + body)
    except Exception as e:
        # a dead peer or a timeout leaves this rank its local view; the
        # fit's own next round raises the failure inside its retries
        diagnostics.record_event("ops_round_failed", error=type(e).__name__)
        telemetry.registry().inc("fleet.ops_rounds_failed")
        return None
    if not telemetry.enabled() and payload is None:
        return None  # in the round for lockstep only; nothing recorded
    try:
        return _ingest_round(
            gathered,
            epoch=getattr(rendezvous, "_epoch", None),
            round_index=getattr(rendezvous, "_round", None),
            nranks=int(getattr(rendezvous, "nranks", len(gathered))),
        )
    except Exception as e:  # pragma: no cover - a merge never fails a fit
        diagnostics.record_event("ops_round_failed", error=type(e).__name__)
        telemetry.registry().inc("fleet.ops_rounds_failed")
        return None


def _parse_gathered(gathered: List[str]) -> List[Dict[str, Any]]:
    payloads: List[Dict[str, Any]] = []
    for item in gathered:
        if not isinstance(item, str) or not item.startswith(OPS_ROUND_PREFIX):
            continue
        raw = item[len(OPS_ROUND_PREFIX):]
        if not raw:
            continue  # the bare marker
        try:
            p = json.loads(raw)
        except (ValueError, TypeError):
            continue  # an unreadable peer is merged around
        if isinstance(p, dict):
            payloads.append(p)
    return payloads


def _ingest_round(gathered: List[str], *, epoch: Any, round_index: Any, nranks: int) -> Optional[Dict[str, Any]]:
    """Merge one gathered round into the cluster view, once per (epoch,
    round): in the threaded LocalRendezvous harness every rank's thread
    arrives with the same list, the first merges and fires the events, the
    others get its view (processes of a real fleet each hold their own
    plane and never meet here)."""
    from .. import telemetry

    global _LAST_INGEST_KEY, _CLUSTER
    key = (epoch, round_index) if round_index is not None else None
    with _LOCK:
        if key is not None and _LAST_INGEST_KEY == key:
            # another rank thread claimed this round's merge: its view (None
            # while it still merges); a second merge would advance the
            # straggler streaks twice
            return dict(_CLUSTER) if _CLUSTER is not None else None
        _LAST_INGEST_KEY = key
    payloads = _parse_gathered(gathered)
    view = merge_payloads(payloads, expected=nranks)
    events = _update_stragglers(view)
    with _LOCK:
        _CLUSTER = view
    reg = telemetry.registry()
    reg.inc("fleet.ops_rounds")
    reg.gauge("fleet.ranks_reporting", float(len(payloads)))
    lags = (view.get("straggler") or {}).get("lags_s") or {}
    if lags:
        reg.gauge("rendezvous.straggler_lag_s", max(lags.values()))
    pool = (view.get("tenants") or {}).get("_pool") or {}
    if "chips_busy" in pool:
        reg.gauge("fleet.chips_busy", float(pool["chips_busy"]))
    if "chips_idle" in pool:
        reg.gauge("fleet.chips_idle", float(pool["chips_idle"]))
    _fire_straggler_events(events)
    return view


# ------------------------------------------------------------------ merge --


def merge_payloads(payloads: List[Dict[str, Any]], *, expected: Optional[int] = None) -> Dict[str, Any]:
    """Merge per-rank payloads (a live round's or the snapshots') into the
    cluster view through telemetry.py's merge definitions. A rank that sent
    nothing usable is named in `missing`, never averaged in."""
    from .. import telemetry
    from ..scheduler import ledger as _ledger
    from . import slo as _slo

    by_rank: Dict[int, Dict[str, Any]] = {}
    for p in payloads:
        try:
            by_rank[int(p.get("rank", 0))] = p
        except (TypeError, ValueError):
            continue
    ranks_meta = {
        r: {"host": p.get("host"), "pid": p.get("pid"), "t": p.get("t"), "trace_id": p.get("trace_id")}
        for r, p in by_rank.items()
    }
    n = int(expected) if expected else (max(by_rank) + 1 if by_rank else 0)
    missing = sorted(set(range(n)) - set(by_rank))
    ordered = [by_rank[r] for r in sorted(by_rank)]
    counters = telemetry.merge_counters([p.get("counters") or {} for p in ordered])
    gauges = telemetry.merge_gauges({r: (by_rank[r].get("gauges") or {}) for r in by_rank})
    hists = telemetry.merge_histograms([p.get("hists") or {} for p in ordered])
    windows: Optional[Dict[str, Any]] = None
    windows_error: Optional[str] = None
    try:
        windows = telemetry.merge_windows([p["windows"] for p in ordered if p.get("windows")])
    except ValueError as e:
        windows_error = str(e)
    tenants = _ledger.merge_tenant_usage([p.get("tenants") or {} for p in ordered])
    view: Dict[str, Any] = {
        "t": time.time(),
        "nranks": n,
        "ranks_reporting": len(by_rank),
        "ranks": ranks_meta,
        "missing": missing,
        "counters": counters,
        "gauges": gauges,
        "histograms": hists,
        "windows": windows,
        "tenants": tenants,
        "straggler": {"lags_s": _round_lags(ordered)},
    }
    if windows_error:
        view["windows_error"] = windows_error
    # the cluster SLO verdict over the merged window; a gauge ceiling judges
    # the ranks' max (breached anywhere is breached)
    reader = telemetry.MergedWindows(windows, {name: e["max"] for name, e in gauges.items()})
    try:
        view["health"] = _slo.cluster_health(reader)
    except Exception:  # pragma: no cover - a bad spec never fails the merge
        view["health"] = {"healthy": True, "failing": [], "specs": 0, "verdicts": []}
    return view


def _round_lags(payloads: List[Dict[str, Any]]) -> Dict[int, float]:
    """Each rank's straggler lag from the exchanged stamps: for every
    (epoch, round) that two or more ranks stamped, how long after the first
    rank it entered the round (the exits are flattened by the barrier: all
    leave when the last arrives). A rank's lag is its worst over the
    stamped rounds."""
    by_round: Dict[Tuple[Any, Any], Dict[int, float]] = {}
    for p in payloads:
        try:
            r = int(p.get("rank", 0))
        except (TypeError, ValueError):
            continue
        for stamp in p.get("round_exits") or []:
            try:
                e, rnd, t_enter = stamp[0], stamp[1], float(stamp[2])
            except (TypeError, ValueError, IndexError):
                continue
            by_round.setdefault((e, rnd), {})[r] = t_enter
    lags: Dict[int, float] = {}
    for times in by_round.values():
        if len(times) < 2:
            continue
        t0 = min(times.values())
        for r, t in times.items():
            lags[r] = max(lags.get(r, 0.0), t - t0)
    return lags


def _update_stragglers(view: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Advance the slowest rank's streak from one merged view and return
    the events to fire (outside the lock). A rank must be the slowest by at
    least `fleet_straggler_min_lag_s` for `fleet_straggler_windows` ops
    rounds in a row; firing resets its streak, so a sustained straggle is
    named once every K rounds."""
    lags: Dict[int, float] = (view.get("straggler") or {}).get("lags_s") or {}
    min_lag = float(_cfg("fleet_straggler_min_lag_s", 0.05))
    k = max(1, int(_cfg("fleet_straggler_windows", 3)))
    slowest: Optional[int] = None
    if lags:
        slowest = max(lags, key=lambda r: lags[r])
        if lags[slowest] < min_lag:
            slowest = None
    events: List[Dict[str, Any]] = []
    with _LOCK:
        for r in list(_STRAGGLER_STREAKS):
            if r != slowest:
                _STRAGGLER_STREAKS.pop(r)
        if slowest is not None:
            streak = _STRAGGLER_STREAKS.get(slowest, 0) + 1
            if streak >= k:
                events.append({"rank": slowest, "lag_s": lags[slowest], "rounds": streak})
                streak = 0
            _STRAGGLER_STREAKS[slowest] = streak
        streaks = dict(_STRAGGLER_STREAKS)
    view["straggler"]["slowest"] = slowest
    view["straggler"]["streaks"] = streaks
    return events


def _fire_straggler_events(events: List[Dict[str, Any]]) -> None:
    from .. import diagnostics, telemetry
    from . import audit

    for ev in events:
        diagnostics.record_event("straggler_detected", rank=ev["rank"], lag_s=ev["lag_s"], rounds=ev["rounds"])
        audit.record_decision(
            "straggler",
            "fleet",
            "flagged",
            subject=f"rank:{ev['rank']}",
            reason=f"slowest rank for {ev['rounds']} consecutive ops rounds (lag {ev['lag_s']:.3f}s)",
            lag_s=ev["lag_s"],
        )
        telemetry.registry().inc("fleet.stragglers_flagged")


# ---------------------------------------------------------------- offline --


def _report_to_payload(rep: Dict[str, Any]) -> Dict[str, Any]:
    """One rank's `ops_plane.report()` snapshot in a live payload's shape,
    so both transports share merge_payloads."""
    meta = rep.get("meta") or {}
    tel = rep.get("telemetry") or {}
    return {
        "rank": meta.get("rank", 0),
        "host": meta.get("hostname"),
        "pid": meta.get("pid"),
        "t": meta.get("t"),
        "trace_id": meta.get("trace_id"),
        "counters": tel.get("counters") or {},
        "gauges": tel.get("gauges") or {},
        "hists": tel.get("histograms") or {},
        "windows": rep.get("windows_detail"),
        "tenants": rep.get("tenants") or {},
        "round_exits": meta.get("round_exits") or [],
    }


def merge_reports(reports: List[Dict[str, Any]], *, expected: Optional[int] = None) -> Dict[str, Any]:
    """The offline transport: merge the ranks' `ops_plane.report()`
    snapshots into the cluster view. No event fires (an analysis after the
    fact does not write to the audit trail of the run it reads)."""
    return merge_payloads([_report_to_payload(r) for r in reports], expected=expected)


def read_rank_snapshots(
    directory: str,
    *,
    nranks: Optional[int] = None,
    stale_s: Optional[float] = None,
    now: Optional[float] = None,
) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """The current generation of each rank's snapshot in `directory`
    (`ops_snapshot.json` for rank 0, `ops_snapshot_rank_<r>.json` for the
    others; the rotated `.1`... generations are skipped), as `(reports,
    problems)`. `problems` names every rank `missing` (expected, no file),
    `stale` (its meta.t older than `stale_s`, default
    `config["fleet_stale_snapshot_s"]`; left out of `reports`) and every
    `unreadable` file."""
    if stale_s is None:
        stale_s = float(_cfg("fleet_stale_snapshot_s", 600.0))
    t_now = time.time() if now is None else float(now)
    reports: List[Dict[str, Any]] = []
    seen: Dict[int, str] = {}
    problems: Dict[str, Any] = {"missing": [], "stale": [], "unreadable": []}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return [], {"missing": [], "stale": [], "unreadable": [str(directory)]}
    for name in names:
        m = _SNAPSHOT_NAME_RE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                rep = json.load(f)
        except (OSError, ValueError):
            problems["unreadable"].append(name)
            continue
        meta = rep.get("meta") or {}
        rank = int(meta.get("rank", int(m.group(1) or 0)))
        t = meta.get("t") or rep.get("t")
        # meta.t is another process's wall clock: a monotonic clock does not
        # cross processes
        if stale_s and t is not None and t_now - float(t) > stale_s:
            problems["stale"].append(rank)
            seen.setdefault(rank, name)
            continue
        if rank in seen and rank not in problems["stale"]:
            continue  # the first (canonical) file of a rank wins
        seen[rank] = name
        reports.append(rep)
    have = {int((r.get("meta") or {}).get("rank", 0)) for r in reports}
    n = int(nranks) if nranks else (max(seen) + 1 if seen else 0)
    problems["missing"] = sorted(set(range(n)) - have - set(problems["stale"]))
    problems["nranks"] = n
    return reports, problems


# ------------------------------------------------------------------- views --


def cluster_view() -> Optional[Dict[str, Any]]:
    """The last merged live view (None before any ops round)."""
    with _LOCK:
        return dict(_CLUSTER) if _CLUSTER is not None else None


def cluster_report() -> Dict[str, Any]:
    """`report(cluster=True)`'s section: the last live view and its age, or
    `available: False` before any round."""
    view = cluster_view()
    if view is None:
        return {"available": False}
    return {"available": True, "age_s": max(0.0, time.time() - view["t"]), **view}


def reset() -> None:
    """Forget the throttle, the streaks, the stamps and the view."""
    global _LAST_ROUND_T, _LAST_INGEST_KEY, _CLUSTER
    with _LOCK:
        _LAST_ROUND_T = None
        _LAST_INGEST_KEY = None
        _CLUSTER = None
        _ROUND_EXITS.clear()
        _STRAGGLER_STREAKS.clear()
