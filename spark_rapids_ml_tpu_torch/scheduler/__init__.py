#
# The multi-tenant fit scheduler: priority queues, bin-packed co-admission
# and checkpoint preemption over one shared device-memory ledger. The port's
# copy of spark_rapids_ml_tpu/scheduler/, on one card (1-D book):
#
#   ledger.py   `HbmLedger`: the one byte book every device-memory consumer
#               charges (fit admissions, serving loads, scheduler jobs),
#               with per-tenant byte- and chip-seconds;
#   context.py  the job context and the cooperative `preemption_point` the
#               solvers check at their checkpoint boundaries;
#   queue.py    `FitScheduler` / `FitJob`: submit(estimator, dataset,
#               tenant=, priority=) returning a future; co-admission,
#               preemption, resume and demotion to streaming.
#
from __future__ import annotations

from .context import current_job, job_scope, preemption_point  # noqa: F401
from .ledger import HbmLedger, HbmReservation, global_ledger, reset_global_ledger  # noqa: F401
from .queue import FitJob, FitScheduler  # noqa: F401

__all__ = [
    "HbmLedger", "HbmReservation", "global_ledger", "reset_global_ledger", "current_job", "job_scope",
    "preemption_point", "FitJob", "FitScheduler",
]
