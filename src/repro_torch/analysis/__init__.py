"""Correctness tooling for the concurrent protocols (port of
``repro/analysis``): static invariant lint (THR/OPC/KRN + LCK lockset
inference), a vector-clock happens-before sanitizer, and a deterministic
schedule explorer.

``REPRO_CHECK_INVARIANTS=1`` turns on the claim ledger, the phase-order and
group-settled checks and the vector-clock race tracker in the port's work
stealing, worker pool and serving front end, as in the reference.

Kept import-light on purpose: ``repro_torch.analysis.sync`` is imported by
the hot paths (``core/work_stealing.py``, ``runtime/scheduler.py``,
``serving/frontend.py``, ``kernels/lookback_scan.py``) at module load, so
this package must never eagerly import them back (or torch).  Pull the
engines explicitly::

    from repro_torch.analysis.lint import run_lint
    from repro_torch.analysis.lockset import lockset_findings
    from repro_torch.analysis.race import RaceTracker
    from repro_torch.analysis.schedule import explore, standard_suite
    from repro_torch.analysis.invariants import InvariantViolation

or run everything from the CLI: ``python -m repro_torch.analysis``
(``--fast`` for the explorer's smoke subset).
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
