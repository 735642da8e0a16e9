#
# Ops plane: the live operability layer over the telemetry registry. The
# port's copy of the single-process part of spark_rapids_ml_tpu/ops_plane/.
#
#   * rolling windows  telemetry.MetricsRegistry's time-bucketed rings
#                      (rate() / window_quantile() / window_fraction_over();
#                      `config["metrics_bucket_seconds"]` x
#                      `config["metrics_bucket_count"]`);
#   * export           Prometheus / JSON scrape surface and /healthz on an
#                      opt-in `SRML_METRICS_PORT` HTTP thread, and rotating
#                      on-disk snapshots for headless runs;
#   * slo              declarative `config["slo"]` specs evaluated by
#                      multi-window burn rate, feeding /healthz and the
#                      serving backpressure ladder;
#   * audit            the bounded per-tenant decision log (every fit and
#                      load admission, demotion, refusal, eviction, ladder
#                      step and scheduler admission, preemption and
#                      demotion);
#   * drift            per-column ingest feature statistics and PSI against
#                      a registered baseline;
#   * fleet            the cluster's view over the ranks: the live ops round
#                      on the fits' trace rounds and the offline merge of
#                      the ranks' snapshots, cluster SLO verdicts and
#                      stragglers.
#
# `report()` is the one-call roll-up: live (`ops_plane.report()`), scraped
# (`GET /snapshot`) or archived (`export.write_snapshot()`).
#
# Not here, each named in ROADMAP: the efficiency plane
# (`ops_plane/efficiency.py`, A15) and the autotune table's section (A18).
#
from __future__ import annotations

import os
import socket
import time
from typing import Any, Dict, Optional

from . import audit, drift, export, fleet, slo
from .export import ensure_server, start_server, stop_server, write_snapshot

__all__ = [
    "audit",
    "drift",
    "export",
    "fleet",
    "slo",
    "report",
    "ensure_server",
    "start_server",
    "stop_server",
    "write_snapshot",
]


def _serving_section() -> Dict[str, Any]:
    """The serving plane's per-tenant overload view (ladder levels, refusal
    counters, tenant latency summaries) of every live ScoringEngine's
    controller, through `serving.overload.serving_report`."""
    try:
        from ..serving.overload import serving_report

        return serving_report()
    except Exception:  # pragma: no cover - the report never fails a scrape
        return {"tenants": {}}


def report(
    *,
    tenant: Optional[str] = None,
    trace_id: Optional[str] = None,
    decision_limit: int = 256,
    cluster: bool = False,
) -> Dict[str, Any]:
    """The ops-plane state as one JSON-able dict: health and SLO verdicts
    (evaluated fresh), rolling-window rates and quantiles, the decision log
    (optionally filtered to one tenant or trace), the shared ledger's
    per-tenant usage (`tenants`), drift statistics, the serving ladder, and
    the registry snapshot, under a `meta` header (rank, host, pid, time,
    trace id). The header and `windows_detail` (the windows by bucket age)
    are what the fleet plane's offline merge reads: staleness, missing
    ranks, the windows' alignment. `cluster=True` adds the last merged live
    cluster view (`fleet.cluster_report()`)."""
    from .. import diagnostics, telemetry
    from ..scheduler.ledger import global_ledger

    reg = telemetry.registry()
    health = slo.health(fresh=True)
    now = time.time()
    rep = {
        "t": now,
        "meta": {
            "rank": diagnostics._rank(),
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            "t": now,
            "trace_id": diagnostics.trace_tags().get("trace_id"),
        },
        "health": {k: health[k] for k in ("healthy", "failing", "specs")},
        "slo": health["verdicts"],
        "windows": reg.windows_snapshot(),
        "windows_detail": reg.windows_export(),
        "decisions": audit.decisions(tenant=tenant, trace_id=trace_id, limit=decision_limit),
        "decision_log": audit.stats(),
        # the shared ledger's per-tenant byte- and chip-seconds; the
        # efficiency section comes with A15, the autotune table's with A18
        "tenants": global_ledger().tenant_usage(),
        "drift": drift.last_stats(),
        "serving": _serving_section(),
        "telemetry": reg.snapshot(),
    }
    if cluster:
        rep["cluster"] = fleet.cluster_report()
    return rep
