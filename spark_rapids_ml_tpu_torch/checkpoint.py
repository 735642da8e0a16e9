#
# Solver checkpoints: periodically host-fetched solver state, so a fit
# interrupted by a transient fault resumes from the last checkpoint instead
# of from scratch. The port's copy of spark_rapids_ml_tpu/checkpoint.py.
#
# Design, as in the JAX package:
#   * A `CheckpointStore` lives for the dynamic extent of ONE fit stage
#     (`core.recoverable_stage` / `core.retryable_stage` install it through
#     `ensure_scope`). The attempts within the stage (bounded transient
#     retries, and the OOM ladder's streamed retry inside one attempt) share
#     the store; the stage's exit clears it, so checkpoints never leak
#     across fits.
#   * Checkpoints are HOST numpy state carrying a `placement_key` that
#     names the device and data layout they were taken on:
#       - the same placement -> an EXACT resume (bit for bit with an
#         uninterrupted fit: the state round-trips device -> host -> device
#         losslessly, and the loops run the same operations after it);
#       - another placement -> the solver falls back to its PORTABLE subset
#         (the k-means centers, the GLM iterate, sufficient statistics).
#   * The cadence is `config["checkpoint_every_iters"]`; 0 (the default)
#     disables it, and no host read is added to a fit then.
#
# Where the JAX package segments a `lax.while_loop` into host segments
# (`run_segmented_while`), the port's solver loops already run on the host,
# so a segment boundary is a place in the Python loop: the Lloyd loop
# (ops/kmeans.lloyd_loop), the GLM quasi-Newton and OWL-QN
# (ops/logistic._glm_qn_steps, ops/owlqn.owlqn_steps), each saving its
# whole state in one device-to-host copy. The linear/PCA family retains
# its one-pass sufficient statistics through `CheckpointStore.get_or_compute`.
#
# Not here, named in ROADMAP: the flight-recorder events of each save and
# restore (A15).
#
from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from .utils import lockcheck

__all__ = [
    "SolverCheckpoint",
    "CheckpointStore",
    "checkpoint_scope",
    "ensure_scope",
    "active_store",
    "every_iters",
    "solver_checkpoints_active",
    "placement_key_of",
    "retained",
]


@dataclass
class SolverCheckpoint:
    """One host-fetched solver snapshot.

    `state` maps names to host numpy arrays / scalars. `placement_key`
    identifies the device + data layout the snapshot was taken on (exact-
    resume eligibility); `portable` optionally carries the layout-
    independent subset a resume on another placement may warm-start from."""

    solver: str
    iteration: int
    state: Dict[str, Any]
    placement_key: Optional[tuple] = None
    portable: Dict[str, Any] = field(default_factory=dict)
    wall_t: float = field(default_factory=time.time)


class CheckpointStore:
    """Keyed checkpoint container for one fit stage.

    Thread-safe (fold fits may run on pool threads inside one scope). Saves
    and restores are counted through the telemetry registry
    (``checkpoint.saves`` / ``checkpoint.restores`` /
    ``checkpoint.stats_reuses``), so a test can tell a resume from a
    re-solve."""

    def __init__(self) -> None:
        self._entries: Dict[str, SolverCheckpoint] = {}  # guarded-by: _lock
        # the stores of the chips of a fit fanned out over the device pool
        # (core.py), by rank: each chip's solver checkpoints its own state
        # between the same collectives, and they outlive the fit's attempts
        self._chips: Dict[int, "CheckpointStore"] = {}  # guarded-by: _lock
        self._lock = lockcheck.make_lock("checkpoint.CheckpointStore._lock")

    def chip_store(self, rank: int) -> "CheckpointStore":
        """The store of chip `rank` of a fanned-out fit of this stage."""
        with self._lock:
            return self._chips.setdefault(int(rank), CheckpointStore())

    def save(self, key: str, ckpt: SolverCheckpoint) -> None:
        from . import telemetry

        with self._lock:
            self._entries[key] = ckpt
        telemetry.registry().inc("checkpoint.saves")
        # the flight-recorder event (`checkpoint_saved`) arrives with A15

    def load(self, key: str) -> Optional[SolverCheckpoint]:
        with self._lock:
            ckpt = self._entries.get(key)
        if ckpt is not None:
            from . import telemetry

            telemetry.registry().inc("checkpoint.restores")
            # the flight-recorder event (`checkpoint_restored`) arrives with A15
        return ckpt

    def peek(self, key: str) -> Optional[SolverCheckpoint]:
        """`load` without counting a restore (cadence bookkeeping)."""
        with self._lock:
            return self._entries.get(key)

    def get_or_compute(self, key: str, fn: Callable[[], Dict[str, Any]],
                       *, solver: str, placement_key: Optional[tuple] = None) -> Dict[str, Any]:
        """Host-retained sufficient statistics: the stored state when the
        key AND placement match (a transient retry or a further solve of the
        stage skips the data pass entirely), else compute, retain, and
        return."""
        from . import telemetry

        with self._lock:
            ckpt = self._entries.get(key)
        if ckpt is not None and ckpt.placement_key == placement_key:
            telemetry.registry().inc("checkpoint.stats_reuses")
            return ckpt.state
        state = fn()
        self.save(key, SolverCheckpoint(
            solver=solver, iteration=0, state=state, placement_key=placement_key
        ))
        return state

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            chips, self._chips = list(self._chips.values()), {}
        for c in chips:
            c.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# Context-local, as core's device_dataset_scope: concurrent fits on
# different threads must not share checkpoint state.
_STORE: "contextvars.ContextVar[Optional[CheckpointStore]]" = contextvars.ContextVar(
    "srml_torch_checkpoint_store", default=None
)


def active_store() -> Optional[CheckpointStore]:
    """The store installed by the enclosing fit stage, or None (solvers
    then skip all checkpoint work)."""
    return _STORE.get()


@contextlib.contextmanager
def checkpoint_scope(store: Optional[CheckpointStore] = None):
    """Install a fresh (or given) CheckpointStore for the dynamic extent;
    clears it on exit (checkpoints are per stage, never across fits)."""
    own = store is None
    scope = CheckpointStore() if own else store
    token = _STORE.set(scope)
    try:
        yield scope
    finally:
        _STORE.reset(token)
        if own:
            scope.clear()


@contextlib.contextmanager
def ensure_scope():
    """`checkpoint_scope` that ADOPTS an already-active store (the outer
    stage owns clearing it) instead of shadowing it, so
    `recoverable_stage`'s store survives the nested `retryable_stage`."""
    existing = _STORE.get()
    if existing is not None:
        yield existing
        return
    with checkpoint_scope() as scope:
        yield scope


def every_iters() -> int:
    """``config["checkpoint_every_iters"]``: the solver-checkpoint cadence
    in inner iterations; 0 disables (the default)."""
    from .core import config

    try:
        return max(0, int(config.get("checkpoint_every_iters", 0)))
    except (TypeError, ValueError):
        return 0


def solver_checkpoints_active() -> bool:
    """Whether solvers should checkpoint: a cadence is configured AND a
    store is installed by the enclosing stage."""
    return every_iters() > 0 and _STORE.get() is not None


def placement_key_of(inputs: Any) -> tuple:
    """Placement identity of a resident `core.FitInputs`: ((device index,
    [the original ranks of the group's live set]), valid rows, columns,
    dtype name). A checkpoint resumes exactly only under an EQUAL key: in a
    multi-process fit the membership is part of it, as the JAX package's
    key holds the mesh's devices, so after a recovery epoch a survivor
    takes the portable subset and never an exact resume of another layout
    (ranks sharing a card have one device index). The streamed solvers key
    their own state ("stream", rows, columns, dtype name)."""
    import numpy as np

    device = getattr(inputs, "device", None)
    index = getattr(device, "index", None)
    where: tuple = (int(index or 0),)
    ctx = getattr(inputs, "ctx", None)
    if ctx is not None:  # a fit under a multi-process context (its survivors too)
        where += tuple(int(r) for r in ctx.live_ranks_hint())
    return (
        where,
        int(getattr(inputs, "n_valid", 0)),
        int(getattr(inputs, "n_cols", 0)),
        np.dtype(getattr(inputs, "dtype", "float32")).name,
    )


def retained(key: str, compute: Callable[[], Dict[str, Any]], *, solver: str,
             placement_key: Optional[tuple] = None) -> Dict[str, Any]:
    """One-pass sufficient statistics through the active store: retained
    under `key` when a store is installed (`get_or_compute`), else just
    computed. Then the mid-solve fault hook `maybe_fail_stage("solve", 0)`
    fires, AFTER the retention, so a retried fit provably reuses them (the
    JAX package's `_fit_from_retained_stats` and `pca_fit_checkpointed`)."""
    from .parallel import chaos

    store = active_store()
    state = (
        store.get_or_compute(key, compute, solver=solver, placement_key=placement_key)
        if store is not None else compute()
    )
    chaos.maybe_fail_stage("solve", 0)
    return state
