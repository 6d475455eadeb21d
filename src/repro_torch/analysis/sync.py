"""Sync-point labels + the runtime invariant gate (dependency-free).

The concurrent protocols this repo hand-maintains — the shared-gap claim
protocol (``core/work_stealing.py``), the WorkerPool task-group scheduler
(``runtime/scheduler.py``) and the tile-status lookback board
(``kernels/lookback_scan.py``) — mark their protocol-relevant steps with
:func:`sync_point` labels.  The labels serve two purposes:

* **model anchoring** — the deterministic schedule explorer
  (``analysis/schedule.py``) permutes cooperative yields at *the same
  labels*; ``tests/test_analysis.py`` asserts every label a model branches
  on is actually hit by the real protocol, so the explored model and the
  shipped code cannot silently drift apart;
* **runtime invariant gating** — ``REPRO_CHECK_INVARIANTS=1`` turns on the
  (otherwise zero-cost) invariant hooks the hot paths call after each
  protocol round (:mod:`repro_torch.analysis.invariants`);
* **happens-before sanitizing** — a label may carry an event *kind*
  (``read``/``write`` on a shared variable, ``acquire``/``release`` on a
  lock).  While checking is on, those events feed the process-wide
  vector-clock :class:`~repro_torch.analysis.race.RaceTracker`, which reports
  unordered conflicting accesses even when the observed interleaving
  happened to be benign.

This module must stay import-cheap and free of any ``repro_torch`` imports: the
hot paths import it at module load, and ``sync_point`` sits inside claim
loops — when checking is off it is one global-bool test (the kind/var/lock
arguments are never even inspected).
"""

from __future__ import annotations

import os
import threading
from collections import Counter
from typing import Dict, Optional

__all__ = [
    "sync_point",
    "invariants_enabled",
    "set_checking",
    "observed_labels",
    "reset_observed",
    "get_race_tracker",
    "reset_race_tracker",
]

_ENV_FLAG = "REPRO_CHECK_INVARIANTS"

#: Process-wide gate.  Read once at import; flip at runtime via
#: :func:`set_checking` (tests, debug sessions).
_checking: bool = os.environ.get(_ENV_FLAG, "").strip() not in ("", "0", "false")

_observed: Counter = Counter()
_observed_lock = threading.Lock()


def invariants_enabled() -> bool:
    """True when runtime invariant checks (and label recording) are on."""
    return _checking


def set_checking(enabled: bool) -> None:
    """Flip the runtime invariant gate (overrides the env var)."""
    global _checking
    _checking = bool(enabled)


_tracker = None
_tracker_lock = threading.Lock()


def get_race_tracker():
    """The process-wide :class:`~repro_torch.analysis.race.RaceTracker`,
    created on first use (so importing this module never pulls race.py)."""
    global _tracker
    if _tracker is None:
        with _tracker_lock:
            if _tracker is None:
                from .race import RaceTracker

                _tracker = RaceTracker()
    return _tracker


def reset_race_tracker() -> None:
    """Clear the tracker's clocks and reports (tests)."""
    if _tracker is not None:
        _tracker.reset()


def sync_point(
    label: str,
    kind: Optional[str] = None,
    *,
    var: Optional[str] = None,
    lock: Optional[str] = None,
) -> None:
    """Mark one labeled protocol step.

    A no-op (single global-bool test) unless checking is enabled, in which
    case the label hit is counted so tests can assert the explorer's model
    labels correspond to real execution points.

    ``kind`` optionally classifies the step for the happens-before
    sanitizer: ``"read"``/``"write"`` of shared state ``var`` (with
    ``lock=`` naming the critical section the access sits in, if any), or
    ``"acquire"``/``"release"`` of ``lock``.  Kinded events feed the
    vector-clock :class:`~repro_torch.analysis.race.RaceTracker`.
    """
    if not _checking:
        return
    with _observed_lock:
        _observed[label] += 1
    if kind is None:
        return
    tracker = get_race_tracker()
    tid = threading.get_ident()
    if kind in ("read", "write"):
        if var is None:
            raise ValueError(f"sync_point({label!r}, {kind!r}) requires var=")
        tracker.access(tid, var, kind, lock=lock, label=label)
    elif kind == "acquire":
        if lock is None:
            raise ValueError(f"sync_point({label!r}, 'acquire') requires lock=")
        tracker.acquire(tid, lock)
    elif kind == "release":
        if lock is None:
            raise ValueError(f"sync_point({label!r}, 'release') requires lock=")
        tracker.release(tid, lock)
    else:
        raise ValueError(
            f"unknown sync_point kind {kind!r} "
            "(expected read/write/acquire/release)"
        )


def observed_labels() -> Dict[str, int]:
    """Labels hit since the last reset (only populated while checking)."""
    with _observed_lock:
        return dict(_observed)


def reset_observed() -> None:
    with _observed_lock:
        _observed.clear()
