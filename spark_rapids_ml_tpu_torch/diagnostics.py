#
# Record tags: the two pieces of spark_rapids_ml_tpu/diagnostics.py that the
# ops plane's records carry (the audit log, the Prometheus rank label, the
# report's `meta` header).
#
#   `_rank()`       this process's rank: the active TpuContext's, else
#                   `SRML_RANK`, else 0;
#   `trace_tags()`  ``{"trace_id": SRML_TRACE_ID}`` when a launcher minted
#                   one, else ``{}``.
#
# Not here, each named in ROADMAP: the flight recorder (`record_event`,
# `FlightRecorder`, the dump on SrmlError; A15) and the per-fit trace scope
# with its cross-rank id exchange (`trace_scope`; A10). The JAX package's
# call sites of `record_event` on the ported paths carry a comment naming
# A15 in their place.
#
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["trace_tags"]


def _rank() -> int:
    """This process's rank for record tagging: the active TpuContext's
    rank, else `SRML_RANK`, else 0 (a malformed value counts as unset)."""
    from .parallel.context import TpuContext

    ctx = TpuContext.current()
    if ctx is not None:
        return ctx.rank
    env = os.environ.get("SRML_RANK")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    return 0


def trace_tags() -> Dict[str, Any]:
    """Tags every decision record carries: a launcher-minted
    ``SRML_TRACE_ID``, or nothing."""
    env_id = os.environ.get("SRML_TRACE_ID")
    if env_id:
        return {"trace_id": env_id}
    return {}
