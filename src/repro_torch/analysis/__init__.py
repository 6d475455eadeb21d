"""Runtime invariant checks and sync-point labels of the concurrent
protocols (copies of ``repro/analysis/{sync,race,invariants}.py``).

``REPRO_CHECK_INVARIANTS=1`` turns on the claim ledger, the phase-order and
group-settled checks and the vector-clock race tracker in the port's work
stealing and worker pool, as in the reference.  The lint, lockset and
schedule-explorer modules are not ported yet.
"""

from .invariants import InvariantViolation
from .sync import (
    get_race_tracker,
    invariants_enabled,
    reset_race_tracker,
    set_checking,
    sync_point,
)

__all__ = [
    "InvariantViolation",
    "get_race_tracker",
    "invariants_enabled",
    "reset_race_tracker",
    "set_checking",
    "sync_point",
]
