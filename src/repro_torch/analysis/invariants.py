"""Shared safety invariants of the stealing and lookback protocols.

One module, two consumers:

* the **deterministic schedule explorer** (``analysis/schedule.py``) calls
  these checks at every explored interleaving — a violation is a real
  protocol bug reachable under some thread/tile schedule;
* the **runtime hooks** in ``core/work_stealing.py``,
  ``runtime/scheduler.py`` and ``kernels/lookback_scan.py`` call them after
  each protocol round when ``REPRO_CHECK_INVARIANTS=1``
  (:func:`repro_torch.analysis.sync.invariants_enabled`) — debug runs then verify
  the *actual* execution, not a model of it.

Every check raises :class:`InvariantViolation` with a message naming the
invariant; checks are pure functions of plain-Python state so both
consumers share one definition and the enforcement cannot drift from the
specification.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "InvariantViolation",
    "check_unique_claims",
    "check_interval_partition",
    "check_segment_intervals",
    "check_group_settled",
    "check_lookback_step",
    "check_board_published",
    "check_phase_order",
    "check_admission_bound",
    "check_dispatch_lane",
    "check_session_exclusive",
    "check_session_fifo",
    "check_all_dispatched",
]


class InvariantViolation(AssertionError):
    """A machine-checked protocol invariant does not hold."""

    def __init__(self, invariant: str, detail: str):
        self.invariant = invariant
        self.detail = detail
        super().__init__(f"[{invariant}] {detail}")


# ---------------------------------------------------------------------------
# Gap claim protocol (work_stealing._Gap / Algorithm 1)
# ---------------------------------------------------------------------------


def check_unique_claims(n: int, claims: Dict[int, object]) -> None:
    """No double-claimed or lost element: the claim map covers [0, n) with
    every element claimed by exactly one owner.

    ``claims`` maps element index -> owner; callers record each successful
    ``take`` (double claims surface earlier, at record time, as a key
    collision the caller reports through this same exception type).
    """
    missing = [i for i in range(n) if i not in claims]
    if missing:
        raise InvariantViolation(
            "no-lost-element",
            f"elements never claimed by any worker: {missing[:8]}"
            f"{'...' if len(missing) > 8 else ''}",
        )
    stray = [i for i in claims if not 0 <= i < n]
    if stray:
        raise InvariantViolation(
            "claim-in-range", f"claims outside [0, {n}): {sorted(stray)[:8]}"
        )


def check_interval_partition(n: int, intervals: Sequence[Tuple[int, int]]) -> None:
    """Final per-worker inclusive intervals partition [0, n) contiguously.

    This is the gap protocol's terminal safety property: every element was
    claimed exactly once, and each worker owns one contiguous stretch
    (folding order preserved associativity-only correctness).
    """
    check_segment_intervals(intervals, lo=0, hi=n - 1)


def check_segment_intervals(
    intervals: Sequence[Tuple[int, int]],
    *,
    lo: Optional[int] = None,
    hi: Optional[int] = None,
) -> None:
    """Adjacent worker intervals are contiguous: worker i+1 starts exactly
    one past worker i's end (their shared gap fully drained, no element
    claimed twice or dropped at a boundary).  ``lo``/``hi`` additionally pin
    the outer edges (standalone reduce: 0 and n-1; one segment of a
    cross-segment phase leaves them free — the shared outer gaps move them).
    """
    if not intervals:
        raise InvariantViolation("interval-partition", "no worker intervals")
    for a, b in intervals:
        if a > b:
            raise InvariantViolation(
                "interval-nonempty", f"inverted interval ({a}, {b})"
            )
    for (a0, b0), (a1, b1) in zip(intervals, intervals[1:]):
        if a1 != b0 + 1:
            raise InvariantViolation(
                "interval-contiguity",
                f"interval ({a1}, {b1}) does not start at {b0 + 1} "
                f"(previous interval ended at {b0})",
            )
    if lo is not None and intervals[0][0] != lo:
        raise InvariantViolation(
            "interval-cover-lo", f"first interval starts at {intervals[0][0]}, not {lo}"
        )
    if hi is not None and intervals[-1][1] != hi:
        raise InvariantViolation(
            "interval-cover-hi", f"last interval ends at {intervals[-1][1]}, not {hi}"
        )


# ---------------------------------------------------------------------------
# WorkerPool task groups (runtime/scheduler.py)
# ---------------------------------------------------------------------------


def check_group_settled(total: int, claimed: int, completed: int) -> None:
    """A task group a caller returned from is fully settled: every task was
    claimed exactly once and every claim completed — no task ran twice, none
    was stranded mid-flight."""
    if claimed != total:
        raise InvariantViolation(
            "group-claims",
            f"group settled with {claimed}/{total} tasks claimed",
        )
    if completed != total:
        raise InvariantViolation(
            "group-completion",
            f"group settled with {completed}/{total} tasks completed",
        )


# ---------------------------------------------------------------------------
# Lookback tile-status board (kernels/lookback_scan.py)
# ---------------------------------------------------------------------------

# Flag values mirrored here (not imported) so this module stays free of
# kernel/jax imports; tests pin the equality against kernels.lookback_scan.
FLAG_EMPTY = 0
FLAG_AGG = 1
FLAG_PREFIX = 2


def check_lookback_step(tile: int, j: int, status: int, *, stopped: bool) -> None:
    """One lookback read of predecessor ``j`` by ``tile``.

    * the walk never observes an unpublished (EMPTY) predecessor — the
      protocol guarantees every predecessor published at least its
      aggregate before this tile's walk begins;
    * the walk never continues past a published PREFIX (``stopped`` must be
      True when ``status`` reads PREFIX) — walking past one both wastes
      O(tile) reads and double-counts the prefix's elements;
    * the walk never runs off the left edge of the board.
    """
    if j < 0:
        raise InvariantViolation(
            "lookback-left-edge",
            f"tile {tile} walked past tile 0 without finding a PREFIX",
        )
    if status == FLAG_EMPTY:
        raise InvariantViolation(
            "lookback-no-empty-read",
            f"tile {tile} read EMPTY status at predecessor {j}",
        )
    if status == FLAG_PREFIX and not stopped:
        raise InvariantViolation(
            "lookback-stop-at-prefix",
            f"tile {tile} walked past a published PREFIX at tile {j}",
        )


def check_board_published(statuses: Iterable[int]) -> None:
    """Terminal board state: every tile published its inclusive PREFIX."""
    for j, st in enumerate(statuses):
        if int(st) != FLAG_PREFIX:
            raise InvariantViolation(
                "board-terminal-prefix",
                f"tile {j} ended with status {int(st)}, expected PREFIX "
                f"({FLAG_PREFIX})",
            )


# ---------------------------------------------------------------------------
# Phase ordering (reduce-then-scan pipeline)
# ---------------------------------------------------------------------------


def check_phase_order(events: Sequence[Tuple[str, int]]) -> None:
    """Phase-3 never starts before its segment's phase-1 ended (and never
    before the cross-segment phase-2 scan that produces its seed).

    ``events`` is an ordered log of ``(kind, segment)`` entries with kinds
    ``p1_done`` (segment's last reduce worker finished), ``p2_done``
    (cross-segment scan over the partials completed; segment = -1) and
    ``p3_start`` (a seeded apply task for the segment began).
    """
    p1_done = set()
    p2_done = False
    for kind, seg in events:
        if kind == "p1_done":
            p1_done.add(seg)
        elif kind == "p2_done":
            p2_done = True
        elif kind == "p3_start":
            if seg not in p1_done:
                raise InvariantViolation(
                    "phase3-after-phase1",
                    f"phase-3 apply for segment {seg} started before the "
                    f"segment's phase-1 reduction finished",
                )
            if not p2_done:
                raise InvariantViolation(
                    "phase3-after-phase2",
                    f"phase-3 apply for segment {seg} started before the "
                    f"cross-segment phase-2 scan published its seed",
                )
        else:
            raise InvariantViolation("phase-event", f"unknown event kind {kind!r}")


def claim_once(claims: Dict[int, object], idx: int, owner: object) -> None:
    """Record a successful take; raises on a double claim.

    Shared by the explorer models and (under ``REPRO_CHECK_INVARIANTS=1``)
    the host executors' debug bookkeeping.
    """
    prev = claims.get(idx)
    if prev is not None:
        raise InvariantViolation(
            "no-double-claim",
            f"element {idx} claimed by {owner!r} but already owned by {prev!r}",
        )
    claims[idx] = owner


def record_events(log: List[Tuple[str, int]], kind: str, seg: int) -> None:
    """Append one phase event (tiny helper so models and hooks share the
    event vocabulary used by :func:`check_phase_order`)."""
    log.append((kind, seg))


# ---------------------------------------------------------------------------
# Serving front-end protocol (serving/frontend.py)
# ---------------------------------------------------------------------------


def check_admission_bound(tenant: str, queued: int, depth: int) -> None:
    """Reject-never-blocks: a tenant's queue never exceeds its admission
    depth — an over-full queue means a submit slipped past the full-check
    (the lock around check+append removed)."""
    if queued > depth:
        raise InvariantViolation(
            "admission-bound",
            f"tenant {tenant!r} holds {queued} queued requests, depth is "
            f"{depth} — admission raced past the full-check",
        )


def check_dispatch_lane(chosen_priority: int, top_priority: int) -> None:
    """Priority-lane preemption at dispatch boundaries: the dispatcher
    never picks from a lane below the highest non-empty one."""
    if chosen_priority < top_priority:
        raise InvariantViolation(
            "lane-priority",
            f"dispatched a priority-{chosen_priority} request while a "
            f"priority-{top_priority} lane had runnable work",
        )


def check_session_exclusive(session: str, in_flight: Iterable[str]) -> None:
    """Busy-set discipline: at most one request per session executes at a
    time (dispatching into a busy session breaks per-session ordering)."""
    if session in set(in_flight):
        raise InvariantViolation(
            "session-exclusive",
            f"session {session!r} dispatched while an earlier request for "
            "it was still executing",
        )


def check_session_fifo(session: str, seq: int, last_seq: Optional[int]) -> None:
    """Per-session order preserved: a session's requests are dispatched in
    strictly increasing submission order."""
    if last_seq is not None and seq <= last_seq:
        raise InvariantViolation(
            "session-fifo",
            f"session {session!r} dispatched seq {seq} after seq {last_seq}",
        )


def check_all_dispatched(admitted: int, completed: int) -> None:
    """No lost wakeup: once submitters stop and dispatchers drain, every
    admitted request has completed — a shortfall means a notify was missed
    and a queued request was stranded."""
    if completed != admitted:
        raise InvariantViolation(
            "lost-wakeup",
            f"{completed}/{admitted} admitted requests completed — queued "
            "work stranded after the dispatchers drained",
        )
