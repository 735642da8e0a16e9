#
# The serving plane: fitted models resident on the card, scored by
# concurrent requests.
#
#   * `ModelRegistry` — many fitted models RESIDENT at once, each loaded
#     under a `memory.admit_model_load` verdict (placement + one bucket's
#     predict workspace against the device budget; over-budget loads evict
#     least-recently-used residents or refuse typed with `HbmBudgetError`),
#     with every bucket-ladder rung prewarmed at load (and, with
#     `config["serve_degraded_dtype"]`, a second degraded program beside
#     it);
#   * `ScoringEngine` — concurrent predict requests, coalesced up the
#     geometric bucket ladder inside a bounded window, dispatched, and
#     sliced back out per request, bit-identical to serving each one solo;
#   * `OverloadController` — the engine's admission and the per-tenant
#     backpressure ladder: the bounded queue, the deadline-feasibility check
#     and the ladder's throttle and shed refusing typed
#     (`ServeOverloadError`), its degrade rung routing a burning tenant to
#     the registry's `serve_degraded_dtype` program.
#
from .engine import ScoreFuture, ScoringEngine  # noqa: F401
from .overload import OverloadController  # noqa: F401
from .registry import ModelRegistry, ResidentModel  # noqa: F401

__all__ = [
    "ModelRegistry",
    "ResidentModel",
    "ScoringEngine",
    "ScoreFuture",
    "OverloadController",
]
