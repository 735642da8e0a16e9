#
# Device-memory bookkeeping shared by every consumer in the process: the
# serving plane's admission reserves here (ledger.py). The fit scheduler of
# the JAX package (queue, co-admission, preemption) is not ported.
#
from .ledger import HbmLedger, HbmReservation, global_ledger  # noqa: F401

__all__ = ["HbmLedger", "HbmReservation", "global_ledger"]
