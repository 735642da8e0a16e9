#
# Exporters: the live scrape surface and the headless snapshot. The port's
# copy of spark_rapids_ml_tpu/ops_plane/export.py.
#
# Three ways out of the process:
#
#   * Prometheus text exposition (`render_prometheus()`, served at
#     `/metrics`): every cumulative counter and gauge plus a summary per
#     histogram (count/sum and windowed p50/p99 as `quantile` labels).
#     Names are sanitized `srml_<subsystem>_<name>` and every sample carries
#     a `rank` label; after an ops round, the fleet's merged view follows as
#     `rank="cluster"` samples (counters summed, gauges as `agg`-labelled
#     min/max/sum, the cluster's health and ranks reporting);
#   * JSON snapshot (`/snapshot`): the full `ops_plane.report()` dict;
#   * `/healthz`: the SLO health verdict, HTTP 200 while healthy and 503
#     while any configured SLO is failing, evaluated fresh per scrape; with
#     a merged fleet view, the cluster's verdict too (in the body's
#     `cluster`), and a failing cluster answers 503.
#
# The HTTP thread is OPT-IN (`SRML_METRICS_PORT`, or an explicit
# `start_server(port)`): a stdlib `http.server.ThreadingHTTPServer` daemon
# thread, bound to 127.0.0.1 unless `SRML_METRICS_HOST` says otherwise.
# Port 0 binds an ephemeral port (`server_address()` reads it back). Of
# several ranks, only rank 0 binds, unless `SRML_METRICS_ALL_RANKS=1` puts
# rank r at `port + r`.
#
# Headless runs write ROTATING on-disk snapshots instead: `write_snapshot()`
# renames the previous `ops_snapshot.json` down a bounded `.1`/`.2`/...
# chain under `config["ops_snapshot_dir"]` (seeded from
# SRML_OPS_SNAPSHOT_DIR), so a wedged process's last report survives
# without unbounded disk growth.
#
from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, List, Optional, Tuple

from ..utils import lockcheck

__all__ = [
    "render_prometheus",
    "start_server",
    "stop_server",
    "ensure_server",
    "server_address",
    "write_snapshot",
    "SNAPSHOT_KEEP",
]

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")
SNAPSHOT_KEEP = 5  # rotated generations kept on disk


def _prom_name(name: str) -> str:
    return "srml_" + _NAME_SANITIZE.sub("_", name)


def render_prometheus() -> str:
    """The registry's cumulative + windowed state in Prometheus text format
    (exposition format 0.0.4)."""
    from .. import diagnostics, telemetry

    reg = telemetry.registry()
    snap = reg.snapshot()
    rank = diagnostics._rank()
    lines: List[str] = []

    def sample(name: str, value: Any, extra_labels: str = "") -> None:
        if value is None:
            return
        lines.append(f'{name}{{rank="{rank}"{extra_labels}}} {float(value):g}')

    for name, v in sorted(snap["counters"].items()):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} counter")
        sample(pname, v)
    for name, v in sorted(snap["gauges"].items()):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} gauge")
        sample(pname, v)
    for name, h in sorted(snap["histograms"].items()):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} summary")
        sample(pname, reg.window_quantile(name, 0.5), ',quantile="0.5"')
        sample(pname, reg.window_quantile(name, 0.99), ',quantile="0.99"')
        sample(f"{pname}_count", h.get("count"))
        sample(f"{pname}_sum", h.get("sum"))
    lines.extend(_cluster_lines())
    return "\n".join(lines) + "\n"


def _cluster_lines() -> List[str]:
    """The `rank="cluster"` samples of the last merged fleet view (none
    before an ops round): counters are the cluster's sums; a gauge gives its
    ranks' min, max and sum as `agg`-labelled samples (a watermark's sum is
    no rank's value)."""
    from . import fleet as _fleet

    view = _fleet.cluster_view()
    if not view:
        return []
    lines: List[str] = []

    def sample(name: str, value: Any, extra_labels: str = "") -> None:
        if value is None:
            return
        lines.append(f'{name}{{rank="cluster"{extra_labels}}} {float(value):g}')

    for name, v in sorted((view.get("counters") or {}).items()):
        sample(_prom_name(name), v)
    for name, g in sorted((view.get("gauges") or {}).items()):
        pname = _prom_name(name)
        for agg in ("min", "max", "sum"):
            sample(pname, g.get(agg), f',agg="{agg}"')
    for name, h in sorted((view.get("histograms") or {}).items()):
        pname = _prom_name(name)
        sample(f"{pname}_count", h.get("count"))
        sample(f"{pname}_sum", h.get("sum"))
    health = view.get("health") or {}
    if "healthy" in health:
        sample("srml_cluster_healthy", 1.0 if health["healthy"] else 0.0)
    sample("srml_cluster_ranks_reporting", view.get("ranks_reporting"))
    return lines


# ------------------------------------------------------------- HTTP server --

_SERVER_LOCK = lockcheck.make_lock("ops_plane.export._SERVER_LOCK")
_SERVER: Any = None  # guarded-by: _SERVER_LOCK
_SERVER_THREAD: Optional[threading.Thread] = None  # guarded-by: _SERVER_LOCK


def _make_handler():
    from http.server import BaseHTTPRequestHandler

    class _Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 - http.server API
            from .. import ops_plane as _ops  # the package is fully built by serve time
            from . import slo as _slo

            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    self._send(200, render_prometheus().encode(), "text/plain; version=0.0.4")
                elif path == "/healthz":
                    from . import fleet as _fleet

                    verdict = _slo.health(fresh=True)
                    # the last merged fleet view answers for the cluster: its
                    # verdict rides the body, and a failing cluster answers
                    # 503 while this rank's own windows look healthy
                    cview = _fleet.cluster_view()
                    healthy = bool(verdict["healthy"])
                    if cview is not None:
                        chealth = cview.get("health") or {}
                        verdict["cluster"] = {
                            "healthy": chealth.get("healthy", True),
                            "failing": chealth.get("failing", []),
                            "ranks_reporting": cview.get("ranks_reporting"),
                            "missing": cview.get("missing", []),
                        }
                        healthy = healthy and bool(chealth.get("healthy", True))
                    body = json.dumps(verdict, default=str).encode()
                    self._send(200 if healthy else 503, body, "application/json")
                elif path in ("/snapshot", "/snapshot.json"):
                    body = json.dumps(_ops.report(), default=str).encode()
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found\n", "text/plain")
            except Exception as e:  # pragma: no cover - a scrape must never kill the thread
                self._send(500, f"{type(e).__name__}: {e}\n".encode(), "text/plain")

        def log_message(self, *args: Any) -> None:  # silence per-request stderr
            pass

    return _Handler


def start_server(port: Optional[int] = None, host: Optional[str] = None) -> Tuple[str, int]:
    """Start (or return) the exporter thread; returns the bound (host, port)
    — port 0 binds an ephemeral port (tests read the returned one)."""
    global _SERVER, _SERVER_THREAD
    from http.server import ThreadingHTTPServer

    if port is None:
        port = int(os.environ.get("SRML_METRICS_PORT", "0") or 0)
    if host is None:
        host = os.environ.get("SRML_METRICS_HOST") or "127.0.0.1"
    with _SERVER_LOCK:
        if _SERVER is not None:
            return _SERVER.server_address[0], int(_SERVER.server_address[1])
        server = ThreadingHTTPServer((host, int(port)), _make_handler())
        server.daemon_threads = True
        thread = threading.Thread(
            target=server.serve_forever, name="srml-ops-exporter", daemon=True
        )
        thread.start()
        _SERVER, _SERVER_THREAD = server, thread
        return server.server_address[0], int(server.server_address[1])


def stop_server() -> None:
    global _SERVER, _SERVER_THREAD
    with _SERVER_LOCK:
        server, thread = _SERVER, _SERVER_THREAD
        _SERVER = _SERVER_THREAD = None
    if server is not None:
        server.shutdown()
        server.server_close()
    if thread is not None:
        thread.join(5.0)


def server_address() -> Optional[Tuple[str, int]]:
    with _SERVER_LOCK:
        if _SERVER is None:
            return None
        return _SERVER.server_address[0], int(_SERVER.server_address[1])


def ensure_server() -> Optional[Tuple[str, int]]:
    """Start the exporter iff `SRML_METRICS_PORT` is set and no server runs
    yet: the opt-in entry the serving engine and `telemetry.enable()` call.
    Best-effort: a busy port returns None (the exporter must never fail the
    plane it observes). Only rank 0 binds by default, so ranks sharing a
    host do not race for one port; `SRML_METRICS_ALL_RANKS=1` binds rank r
    at `port + r`. Returns the bound (host, port), or the running server's,
    or None."""
    from .. import diagnostics

    port = os.environ.get("SRML_METRICS_PORT")
    if not port:
        return server_address()
    try:
        rank = diagnostics._rank()
        if rank:
            if os.environ.get("SRML_METRICS_ALL_RANKS", "") not in ("1", "true", "on"):
                return server_address()
            return start_server(int(port) + rank)
        return start_server(int(port))
    except (OSError, ValueError):
        return None


# ----------------------------------------------------------- disk snapshot --


def _rotate(path: str, keep: int) -> None:
    base, ext = os.path.splitext(path)
    oldest = f"{base}.{keep}{ext}"
    if os.path.exists(oldest):
        os.unlink(oldest)
    for i in range(keep - 1, 0, -1):
        src = f"{base}.{i}{ext}"
        if os.path.exists(src):
            os.replace(src, f"{base}.{i + 1}{ext}")
    if os.path.exists(path):
        os.replace(path, f"{base}.1{ext}")


def write_snapshot(
    path: Optional[str] = None, *, keep: int = SNAPSHOT_KEEP
) -> Optional[str]:
    """Write one `ops_plane.report()` JSON snapshot, rotating previous
    generations down a bounded `.1`..`.keep` chain. `path` defaults to
    ``ops_snapshot.json`` under ``config["ops_snapshot_dir"]`` (seeded from
    `SRML_OPS_SNAPSHOT_DIR`); no directory configured -> no file, returns
    None. Write-then-rename, so a concurrent reader never sees a torn
    file."""
    from .. import ops_plane as _ops

    if path is None:
        d = _snapshot_dir()
        if not d:
            return None
        # rank 0 keeps the canonical name, other ranks write
        # `ops_snapshot_rank_<r>.json`, so co-located ranks do not
        # overwrite one file
        from .. import diagnostics

        rank = diagnostics._rank()
        name = "ops_snapshot.json" if not rank else f"ops_snapshot_rank_{rank}.json"
        path = os.path.join(d, name)
    rep = _ops.report()
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # write FIRST, rotate only once the new snapshot exists: a failed
        # write (ENOSPC, permissions) must leave the previous generation at
        # the canonical path — "the last report survives" is the contract
        with open(tmp, "w") as f:
            json.dump(rep, f, default=str)
        _rotate(path, max(0, int(keep)))
        os.replace(tmp, path)
    except OSError:  # pragma: no cover - snapshots are best-effort by design
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return path


def _snapshot_dir() -> Optional[str]:
    import sys

    d = os.environ.get("SRML_OPS_SNAPSHOT_DIR")
    if d:
        return d
    # sys.modules probe, not an import: this may run from error paths where
    # paying core's import chain is wrong
    core = sys.modules.get(__name__.rsplit(".", 2)[0] + ".core")
    if core is not None:
        try:
            return core.config.get("ops_snapshot_dir") or None
        except Exception:  # pragma: no cover
            return None
    return None
