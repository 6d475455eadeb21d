"""Deterministic schedule explorer (DPOR-lite) for the concurrent protocols.

The three hand-maintained protocols — the shared-gap claim protocol
(``core/work_stealing.py``), the reduce/scan/apply phase ordering
(``work_stealing_scan`` / ``engine/hierarchical.py``) and the tile-status
lookback board (``kernels/lookback_scan.py``) — are modelled as
**cooperative protocol twins**: plain-Python generators that yield at the
same labeled sync points the real code marks with
:func:`repro_torch.analysis.sync.sync_point`.  The explorer replays every twin
under *all* interleavings of those yields (replay-based DFS — rebuild the
model per schedule prefix, no state snapshots), asserting the shared
safety invariants from :mod:`repro_torch.analysis.invariants` at every step and
at termination:

* no double-claimed or lost element, final worker intervals partition the
  range (gap protocol);
* lookback never reads an EMPTY predecessor and never walks past a
  published PREFIX; the terminal board is fully published;
* phase-3 never starts before its segment's phase-1 (or the global
  phase-2) completed;
* deadlock freedom — a reachable state where live tasks all block is
  reported as a violation.

The twins stay anchored to the shipped code three ways: direction choice
and seating geometry are the *real* ``_steal_direction`` /
``_start_positions`` / ``cross_start_positions``; the lookback model's
terminal board must be resolvable by the *real* ``lookback_resolve`` to
the same prefixes; and ``tests/test_analysis.py`` asserts the model's
sync-point labels are hit by the real executors under
``REPRO_CHECK_INVARIANTS=1``.

The serving front end (``serving/frontend.py``) gets its own twin:
:class:`FrontendModel` models admission against bounded per-tenant queues
(reject-never-blocks), dispatcher claims with priority-lane preemption at
claim boundaries, and the busy-set per-session FIFO, checked against the
serving invariants (``admission-bound``, ``lane-priority``,
``session-exclusive``, ``session-fifo``, ``no-double-claim``,
``lost-wakeup``).

Mutation seeding (``bugs=``) re-introduces known protocol races —
``drop_claim_cas`` (gap take's emptiness check and claim-counter update
split, i.e. the lock removed), ``early_phase3``, ``unordered_publish``
(lookback reads without waiting for a published predecessor),
``ignore_prefix_stop``, and for the serving twin ``dispatch_while_full``
(the admission full-check unguarded), ``drop_busy_set``,
``lane_inversion`` and ``double_dispatch`` (queue pop deferred past the
claim boundary) plus ``lost_wakeup`` — so tests can prove the explorer
actually detects each class of bug within a bounded schedule budget.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

from .invariants import (
    InvariantViolation,
    check_admission_bound,
    check_all_dispatched,
    check_board_published,
    check_dispatch_lane,
    check_interval_partition,
    check_lookback_step,
    check_phase_order,
    check_session_exclusive,
    check_session_fifo,
    check_unique_claims,
    claim_once,
    record_events,
    FLAG_AGG,
    FLAG_EMPTY,
    FLAG_PREFIX,
)

__all__ = [
    "ExploreResult",
    "Violation",
    "explore",
    "frontend_model",
    "gap_model",
    "lookback_model",
    "phase_model",
    "verify_simulator_twin",
    "standard_suite",
    "SUITE_LABELS",
    "SERVING_LABELS",
]


# ---------------------------------------------------------------------------
# explorer core
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Violation:
    invariant: str
    detail: str
    schedule: Tuple[int, ...]


@dataclasses.dataclass
class ExploreResult:
    """Outcome of exploring one model's schedule space."""

    schedules: int = 0
    exhausted: bool = False       #: full space covered within max_schedules
    violations: List[Violation] = dataclasses.field(default_factory=list)
    deadlocks: int = 0
    labels: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations and self.deadlocks == 0


class _Task:
    __slots__ = ("name", "gen", "alive", "pred")

    def __init__(self, name: str, gen):
        self.name = name
        self.gen = gen
        self.alive = True
        self.pred: Optional[Callable[[], bool]] = None


def _run_once(factory, prefix: Sequence[int], max_steps: int, labels: Dict[str, int]):
    """Replay one schedule: follow ``prefix`` choices, then first-enabled.

    Returns ``(trace, violation, deadlocked)`` where trace is the list of
    ``(num_enabled, chosen)`` decisions actually taken.
    """
    model = factory()
    tasks = [_Task(name, gen) for name, gen in model.tasks()]
    trace: List[Tuple[int, int]] = []
    violation: Optional[InvariantViolation] = None
    deadlocked = False
    steps = 0
    while True:
        enabled = [
            i for i, t in enumerate(tasks)
            if t.alive and (t.pred is None or t.pred())
        ]
        if not enabled:
            if any(t.alive for t in tasks):
                deadlocked = True
            break
        k = len(trace)
        choice = prefix[k] if k < len(prefix) else 0
        if choice >= len(enabled):
            # DFS replay never overflows; sample mode feeds raw random
            # ints and relies on this fold into the enabled range.
            choice %= len(enabled)
        trace.append((len(enabled), choice))
        task = tasks[enabled[choice]]
        task.pred = None
        try:
            label = next(task.gen)
            if isinstance(label, tuple) and label and label[0] == "wait":
                task.pred = label[1]
            elif isinstance(label, str):
                labels[label] = labels.get(label, 0) + 1
        except StopIteration:
            task.alive = False
        except InvariantViolation as e:
            violation = e
            break
        steps += 1
        if steps > max_steps:
            violation = InvariantViolation(
                "explorer-steps",
                f"schedule exceeded {max_steps} steps (livelock?)",
            )
            break
    if violation is None and not deadlocked:
        try:
            model.finalize()
        except InvariantViolation as e:
            violation = e
    return trace, violation, deadlocked


def explore(
    factory,
    *,
    max_schedules: int = 60000,
    max_steps: int = 2000,
    stop_on_violation: bool = True,
    mode: str = "dfs",
    seed: int = 0,
    samples: int = 2000,
) -> ExploreResult:
    """Explore a model's schedule space.

    ``factory`` builds a fresh model; a model exposes ``tasks()`` (list of
    ``(name, generator)``) and ``finalize()`` (terminal invariant checks).
    Generators yield a sync label (string) or ``("wait", predicate)`` to
    block until the predicate holds.

    ``mode="dfs"`` is exhaustive replay-DFS over interleavings (bounded by
    ``max_schedules`` — ``exhausted`` reports whether the bound was hit);
    ``mode="sample"`` runs ``samples`` seeded random schedules (for
    configs whose full space is out of budget).
    """
    res = ExploreResult()

    def record(trace, violation, deadlocked):
        res.schedules += 1
        sched = tuple(c for _, c in trace)
        if violation is not None:
            res.violations.append(
                Violation(
                    getattr(violation, "invariant", "exception"),
                    getattr(violation, "detail", str(violation)),
                    sched,
                )
            )
        if deadlocked:
            res.deadlocks += 1
            res.violations.append(
                Violation("deadlock", "live tasks all blocked", sched)
            )

    if mode == "sample":
        rng = random.Random(seed)
        for _ in range(samples):
            # A random schedule = a long random prefix; _run_once folds
            # each entry into the enabled range at that step.
            prefix = [rng.randrange(1 << 30) for _ in range(max_steps)]
            trace, violation, deadlocked = _run_once(
                factory, prefix, max_steps, res.labels
            )
            record(trace, violation, deadlocked)
            if stop_on_violation and res.violations:
                return res
        res.exhausted = False
        return res

    prefix: List[int] = []
    while True:
        trace, violation, deadlocked = _run_once(
            factory, prefix, max_steps, res.labels
        )
        record(trace, violation, deadlocked)
        if stop_on_violation and res.violations:
            return res
        if res.schedules >= max_schedules:
            res.exhausted = False
            return res
        # Backtrack: deepest decision with an untried alternative.
        i = len(trace) - 1
        while i >= 0:
            n_enabled, chosen = trace[i]
            if chosen + 1 < n_enabled:
                prefix = [c for _, c in trace[:i]] + [chosen + 1]
                break
            i -= 1
        else:
            res.exhausted = True
            return res


# ---------------------------------------------------------------------------
# protocol twin: shared-gap claim protocol (Algorithm 1)
# ---------------------------------------------------------------------------


class _GapState:
    """Inclusive untaken range of one shared gap (twin of ``_Gap``)."""

    __slots__ = ("glo", "ghi")

    def __init__(self, glo: int, ghi: int):
        self.glo = glo
        self.ghi = ghi

    def size(self) -> int:
        return max(0, self.ghi - self.glo + 1)


class _EmptyGap:
    def size(self) -> int:
        return 0


_NO_GAP = _EmptyGap()


class GapModel:
    """Cooperative twin of ``stealing_reduce``'s claim loop.

    Workers are seated at the real protocol's start positions; between
    seats lie shared gaps.  Each worker loops: observe adjacent gap sizes
    (``gap.observe``), pick a side with the real ``_steal_direction``, and
    take the element adjacent to its own interval (``gap.take`` — atomic,
    matching the lock around ``_Gap.take_*``; re-checked at take time, so
    a racing drain is a failed take, not a double claim).

    ``granularity="fine"`` yields both before the observation and between
    observe and take (the stale-size window); ``"coarse"`` fuses each loop
    iteration into one yield (for configs whose fine-grained space is out
    of budget).

    ``bugs={"drop_claim_cas"}`` splits the take's emptiness check from its
    claim-counter update with a yield — exactly what removing the lock (or
    the CAS on ``taken_*``) would allow — making a double claim reachable.

    Oracle: elements are singleton tuples folded with tuple concatenation
    (non-commutative), so any claim-order or fold-side mistake shows up in
    the final values, not just the claim sets.
    """

    def __init__(
        self,
        n: int,
        starts: Sequence[int],
        *,
        granularity: str = "fine",
        bugs: FrozenSet[str] = frozenset(),
        borders: Sequence[int] = (),
    ):
        self.n = n
        self.starts = list(starts)
        self.w = len(self.starts)
        self.fine = granularity == "fine"
        self.bug_cas = "drop_claim_cas" in bugs
        self.borders = set(borders)
        self.gaps: List[_GapState] = [
            _GapState(self.starts[i] + 1, self.starts[i + 1] - 1)
            for i in range(self.w - 1)
        ]
        self.claims: Dict[int, object] = {}
        self.intervals: Dict[int, Tuple[int, int]] = {}
        self.values: Dict[int, Tuple[int, ...]] = {}
        self.failed_takes = 0
        self.cross_claims = 0

    def tasks(self):
        return [(f"w{i}", self._worker(i)) for i in range(self.w)]

    def _take(self, gap: _GapState, side: str, owner: int):
        """One take attempt; atomic unless the CAS bug is seeded."""
        if gap.glo > gap.ghi:
            return None
        v = gap.glo if side == "left" else gap.ghi
        if self.bug_cas:
            # The seeded bug: the emptiness check above and the counter
            # update below are no longer one critical section.
            yield "gap.take.window"
        if side == "left":
            gap.glo = v + 1
        else:
            gap.ghi = v - 1
        claim_once(self.claims, v, owner)
        if v in self.borders:
            self.cross_claims += 1
        return v

    def _worker(self, i: int):
        from repro_torch.core.work_stealing import _steal_direction

        seat = self.starts[i]
        yield "gap.seat"
        claim_once(self.claims, seat, i)
        pl = pr = seat
        value: Tuple[int, ...] = (seat,)
        left = self.gaps[i - 1] if i > 0 else _NO_GAP
        right = self.gaps[i] if i < self.w - 1 else _NO_GAP
        while True:
            if self.fine:
                yield "gap.observe"
            gl, gr = left.size(), right.size()
            if gl == 0 and gr == 0:
                break
            # Real greedy choice; rates unobserved -> larger-gap tie-break.
            d = _steal_direction(0.0, 0.0, gl, gr)
            yield "gap.take"
            if d == "L":
                v = yield from self._take(left, "right", i)
                if v is None:
                    self.failed_takes += 1
                    continue
                pl = v
                value = (v,) + value
            else:
                v = yield from self._take(right, "left", i)
                if v is None:
                    self.failed_takes += 1
                    continue
                pr = v
                value = value + (v,)
        self.intervals[i] = (pl, pr)
        self.values[i] = value

    def finalize(self):
        check_unique_claims(self.n, self.claims)
        ordered = [self.intervals[i] for i in sorted(self.intervals)]
        if len(ordered) != self.w:
            raise InvariantViolation(
                "worker-terminated", f"only {len(ordered)}/{self.w} workers finished"
            )
        ordered.sort()
        check_interval_partition(self.n, ordered)
        for i, (pl, pr) in self.intervals.items():
            expect = tuple(range(pl, pr + 1))
            if self.values[i] != expect:
                raise InvariantViolation(
                    "fold-order",
                    f"worker {i} folded {self.values[i]}, interval says {expect}",
                )


def gap_model(
    n: int,
    workers: int,
    *,
    granularity: str = "fine",
    bugs: FrozenSet[str] = frozenset(),
    cross: Optional[Tuple[Sequence[Tuple[int, int]], Sequence[int]]] = None,
) -> Callable[[], GapModel]:
    """Model factory.  ``cross=(bounds, tcounts)`` seats workers with the
    real cross-segment geometry (shared boundary gaps span the segment
    borders); otherwise the standalone ``_start_positions`` seating."""

    def factory() -> GapModel:
        from repro_torch.core.work_stealing import _start_positions, cross_start_positions

        if cross is not None:
            bounds, tcounts = cross
            starts = cross_start_positions(bounds, tcounts, n)
            if starts is None:
                raise ValueError("infeasible cross seating for model config")
            borders = [hi for _, hi in bounds[:-1]]
        else:
            starts = _start_positions(n, workers)
            borders = []
        return GapModel(
            n, starts, granularity=granularity, bugs=bugs, borders=borders
        )

    return factory


# ---------------------------------------------------------------------------
# protocol twin: reduce -> scan -> apply phase ordering
# ---------------------------------------------------------------------------


class PhaseModel:
    """Twin of ``work_stealing_scan`` / hierarchical phase ordering: S
    segment reducers (phase 1), one cross-segment scan (phase 2) gated on
    *all* phase-1 completions, and S seeded apply tasks (phase 3) each
    gated on its own segment's phase 1 *and* phase 2.

    ``bugs={"early_phase3"}`` removes the apply tasks' gates — the bug an
    earlier simulator twin had (a rank's phase 3 starting before its own
    phase 1 ended).
    """

    def __init__(self, segments: int, bugs: FrozenSet[str] = frozenset()):
        self.s = segments
        self.bug_early = "early_phase3" in bugs
        self.events: List[Tuple[str, int]] = []
        self.p1_done: set = set()
        self.p2_done = False

    def tasks(self):
        out = [(f"reduce{s}", self._reduce(s)) for s in range(self.s)]
        out.append(("scan", self._scan()))
        out += [(f"apply{s}", self._apply(s)) for s in range(self.s)]
        return out

    def _reduce(self, s: int):
        yield "phase1.reduce"
        record_events(self.events, "p1_done", s)
        self.p1_done.add(s)

    def _scan(self):
        yield ("wait", lambda: len(self.p1_done) == self.s)
        yield "phase2.scan"
        record_events(self.events, "p2_done", -1)
        self.p2_done = True

    def _apply(self, s: int):
        if not self.bug_early:
            yield ("wait", lambda: s in self.p1_done and self.p2_done)
        yield "phase3.apply"
        record_events(self.events, "p3_start", s)

    def finalize(self):
        check_phase_order(self.events)
        if len([e for e in self.events if e[0] == "p3_start"]) != self.s:
            raise InvariantViolation(
                "phase3-complete", "not every segment's apply ran"
            )


def phase_model(
    segments: int, bugs: FrozenSet[str] = frozenset()
) -> Callable[[], PhaseModel]:
    return lambda: PhaseModel(segments, bugs)


# ---------------------------------------------------------------------------
# protocol twin: decoupled-lookback tile board
# ---------------------------------------------------------------------------


class LookbackModel:
    """Cooperative twin of the tile-status board protocol
    (``kernels/lookback_scan.py``).

    Each tile task publishes its aggregate (``lookback.publish_agg``; tile
    0 publishes its PREFIX directly), then walks backwards reading
    predecessor statuses (``lookback.read`` — waiting for a publication
    first, which is what the kernel's spin loop does), folding AGGs until
    a PREFIX stops the walk, then publishes its own inclusive PREFIX.
    Every read goes through :func:`check_lookback_step`.

    ``granularity="coarse"`` fuses the whole walk + prefix publication
    into one atomic step (publish orderings still explored).

    Bugs: ``unordered_publish`` skips the wait — the walk can read an
    EMPTY predecessor; ``ignore_prefix_stop`` keeps walking past a
    published PREFIX (and off the board's left edge).

    Finalize re-resolves every tile's prefix on the terminal board with
    the *real* ``lookback_resolve`` — the model and the shipped twin must
    agree element-for-element.
    """

    def __init__(
        self,
        tiles: int,
        *,
        granularity: str = "fine",
        bugs: FrozenSet[str] = frozenset(),
    ):
        self.t = tiles
        self.fine = granularity == "fine"
        self.bug_unordered = "unordered_publish" in bugs
        self.bug_nostop = "ignore_prefix_stop" in bugs
        self.statuses = [FLAG_EMPTY] * tiles
        self.aggs: List[Optional[Tuple[int, ...]]] = [None] * tiles
        self.prefs: List[Optional[Tuple[int, ...]]] = [None] * tiles

    def tasks(self):
        return [(f"tile{i}", self._tile(i)) for i in range(self.t)]

    def _walk(self, i: int) -> Iterable:
        acc: Tuple[int, ...] = ()
        j = i - 1
        while True:
            check_lookback_step(i, j, FLAG_AGG, stopped=False)  # left edge
            if not self.bug_unordered:
                yield ("wait", lambda j=j: self.statuses[j] != FLAG_EMPTY)
            if self.fine:
                yield "lookback.read"
            st = self.statuses[j]
            stop = st == FLAG_PREFIX and not self.bug_nostop
            check_lookback_step(i, j, st, stopped=stop)
            if stop:
                acc = self.prefs[j] + acc
                break
            acc = (self.aggs[j] or ()) + acc
            j -= 1
        self.prefs[i] = acc + (self.aggs[i] or ())
        self.statuses[i] = FLAG_PREFIX

    def _tile(self, i: int):
        agg = (i,)
        self.aggs[i] = agg
        if i == 0:
            yield "lookback.publish_prefix"
            self.prefs[0] = agg
            self.statuses[0] = FLAG_PREFIX
            return
        yield "lookback.publish_agg"
        self.statuses[i] = FLAG_AGG
        if self.fine:
            yield from self._walk(i)
            yield "lookback.publish_prefix"
        else:
            # Coarse: the walk and prefix publication are one atomic step,
            # but only runnable once the walk cannot block (waits stay).
            yield ("wait", lambda: all(
                s != FLAG_EMPTY for s in self.statuses[:i]
            )) if not self.bug_unordered else "lookback.walk"
            for step in self._walk(i):
                pass  # waits already satisfied; inner yields not possible

    def finalize(self):
        check_board_published(self.statuses)
        from repro_torch.kernels.lookback_scan import lookback_resolve

        op = lambda a, b: a + b
        for i in range(1, self.t):
            excl, _steps = lookback_resolve(
                op, i, self.statuses, self.aggs, self.prefs
            )
            expect_excl = tuple(range(i))
            if excl != expect_excl:
                raise InvariantViolation(
                    "lookback-resolve-agree",
                    f"real lookback_resolve got {excl} for tile {i}, "
                    f"expected {expect_excl}",
                )
            if self.prefs[i] != expect_excl + (i,):
                raise InvariantViolation(
                    "lookback-prefix-value",
                    f"tile {i} published {self.prefs[i]}, expected "
                    f"{expect_excl + (i,)}",
                )


def lookback_model(
    tiles: int,
    *,
    granularity: str = "fine",
    bugs: FrozenSet[str] = frozenset(),
) -> Callable[[], LookbackModel]:
    return lambda: LookbackModel(tiles, granularity=granularity, bugs=bugs)


# ---------------------------------------------------------------------------
# protocol twin: serving front end (admission / dispatch / busy set)
# ---------------------------------------------------------------------------


class _FeTenant:
    __slots__ = ("name", "priority", "depth", "requests", "queue", "rejected")

    def __init__(self, name, priority, depth, requests):
        self.name = name
        self.priority = priority
        self.depth = depth
        self.requests = list(requests)
        self.queue: List[Tuple[int, Optional[str]]] = []
        self.rejected = 0


class FrontendModel:
    """Cooperative twin of ``RegistrationFrontend``'s serving protocol.

    Submitter tasks (one per tenant) submit that tenant's requests in
    order; the admission check + append is one atomic step, mirroring the
    real ``_submit`` under ``_cond`` (``serve.submit``; a full queue
    rejects without blocking, ``serve.reject``).  Dispatcher tasks loop:
    wait until some head is runnable, pick from the *highest* non-empty
    priority lane (lowest submission seq within the lane — the fifo
    policy), pop and mark the session busy atomically (``serve.pick`` is
    the claim boundary), execute (the window between ``serve.pick`` and
    ``serve.complete``), then complete — clearing the busy set and
    notifying.  A head whose session is busy is not runnable: a tenant's
    queue is strictly FIFO behind it.

    Ground-truth checks, active in every schedule: the admission bound
    (queue never exceeds depth), ``claim_once`` on every dispatched seq
    (no ticket dispatched twice), lane priority at every pick, per-session
    dispatch order, session exclusivity during execution, and at finalize
    every admitted request completed (no lost wakeup).

    Bugs: ``dispatch_while_full`` drops the admission full-check (the lock
    around check+append removed); ``drop_busy_set`` never marks sessions
    busy; ``lane_inversion`` picks the globally oldest head ignoring
    lanes; ``double_dispatch`` defers the queue pop past the claim
    boundary (two dispatchers can claim one ticket); ``lost_wakeup``
    makes dispatchers exit once submitters finish, ignoring queued work.
    """

    def __init__(
        self,
        tenants: Sequence[Tuple[str, int, int, Sequence[Optional[str]]]],
        *,
        dispatchers: int = 1,
        bugs: FrozenSet[str] = frozenset(),
    ):
        self.tenants = [_FeTenant(*spec) for spec in tenants]
        self.n_dispatchers = dispatchers
        self.bug_full = "dispatch_while_full" in bugs
        self.bug_busy = "drop_busy_set" in bugs
        self.bug_lane = "lane_inversion" in bugs
        self.bug_double = "double_dispatch" in bugs
        self.bug_lost = "lost_wakeup" in bugs
        self._seq = 0
        self.admitted = 0
        self.rejected = 0
        self.completed = 0
        self.in_flight = 0
        self.busy: set = set()
        self.exec_sessions: set = set()
        self.dispatch_claims: Dict[int, object] = {}
        self.last_seq: Dict[str, int] = {}
        self._submitters_done = 0

    def tasks(self):
        out = [(f"sub:{t.name}", self._submitter(t)) for t in self.tenants]
        out += [(f"disp{d}", self._dispatcher(d))
                for d in range(self.n_dispatchers)]
        return out

    # ------------------------------------------------------------- helpers

    def _submit_done(self) -> bool:
        return self._submitters_done == len(self.tenants)

    def _pending(self) -> bool:
        return (
            not self._submit_done()
            or any(t.queue for t in self.tenants)
            or self.in_flight > 0
        )

    def _finished(self) -> bool:
        if self.bug_lost:
            # The seeded bug: the exit condition forgets queued work — the
            # dispatcher that consumed the last notify leaves requests
            # stranded.
            return self._submit_done()
        return not self._pending()

    def _runnable(self) -> List[Tuple[_FeTenant, int, Optional[str]]]:
        views = []
        for t in self.tenants:
            if not t.queue:
                continue
            seq, session = t.queue[0]
            if session is not None and session in self.busy:
                continue
            views.append((t, seq, session))
        return views

    # --------------------------------------------------------------- tasks

    def _submitter(self, t: _FeTenant):
        for session in t.requests:
            yield "serve.submit"
            # Admission is one atomic step (the real _submit holds _cond
            # across check + append) — unless the full-check bug is seeded.
            if not self.bug_full and len(t.queue) >= t.depth:
                t.rejected += 1
                self.rejected += 1
                yield "serve.reject"
                continue
            t.queue.append((self._seq, session))
            self._seq += 1
            self.admitted += 1
            check_admission_bound(t.name, len(t.queue), t.depth)
        self._submitters_done += 1

    def _dispatcher(self, d: int):
        while True:
            yield ("wait", lambda: bool(self._runnable()) or self._finished())
            if self._finished():
                return
            views = self._runnable()
            if not views:
                continue
            top = max(t.priority for t, _, _ in views)
            if self.bug_lane:
                # The seeded bug: the lane filter removed — the policy sees
                # every runnable head and fifo picks the globally oldest.
                t, seq, session = min(views, key=lambda v: v[1])
            else:
                lane = [v for v in views if v[0].priority == top]
                t, seq, session = min(lane, key=lambda v: v[1])
            check_dispatch_lane(t.priority, top)
            claim_once(self.dispatch_claims, seq, f"disp{d}")
            if session is not None:
                check_session_fifo(session, seq, self.last_seq.get(session))
                self.last_seq[session] = seq
            if not self.bug_double:
                t.queue.pop(0)
            if session is not None and not self.bug_busy:
                self.busy.add(session)
            self.in_flight += 1
            yield "serve.pick"
            # --- execution window (between pick and complete) ---
            if session is not None:
                check_session_exclusive(session, self.exec_sessions)
                self.exec_sessions.add(session)
            yield "serve.complete"
            if self.bug_double and t.queue and t.queue[0][0] == seq:
                t.queue.pop(0)  # the deferred pop the bug moved here
            if session is not None:
                self.exec_sessions.discard(session)
                self.busy.discard(session)
            self.in_flight -= 1
            self.completed += 1

    def finalize(self):
        check_all_dispatched(self.admitted, self.completed)


def frontend_model(
    tenants: Sequence[Tuple[str, int, int, Sequence[Optional[str]]]],
    *,
    dispatchers: int = 1,
    bugs: FrozenSet[str] = frozenset(),
) -> Callable[[], FrontendModel]:
    """Model factory.  ``tenants`` entries are ``(name, priority, depth,
    requests)`` with ``requests`` a sequence of session keys (None =
    sessionless) submitted in order."""
    return lambda: FrontendModel(tenants, dispatchers=dispatchers, bugs=bugs)


# ---------------------------------------------------------------------------
# the virtual-time cross-segment twin (deterministic — invariant-wrapped)
# ---------------------------------------------------------------------------


def verify_simulator_twin() -> List[Violation]:
    """Run the real ``_simulate_cross_stealing_reduce`` over a config grid
    and check its terminal claims: per-thread boundaries partition [0, n)
    contiguously across segment borders, and busy time never exceeds
    finish time.  (The twin is virtual-time deterministic, so there is no
    schedule space to explore — only invariants to enforce on every
    config.)"""
    import numpy as np

    from repro_torch.core.simulator import _simulate_cross_stealing_reduce

    violations: List[Violation] = []
    profiles = {
        "uniform": lambda n: np.ones(n),
        "ramp": lambda n: np.linspace(1.0, 4.0, n),
        "straggler": lambda n: np.where(np.arange(n) == n // 3, 50.0, 1.0),
    }
    grid = [
        (n, s, t)
        for n in (16, 64)
        for s in (2, 4)
        for t in (1, 2, 4)
    ]
    for name, profile in profiles.items():
        for n, s, t in grid:
            tag = f"sim:{name}/n{n}/s{s}/t{t}"
            out = _simulate_cross_stealing_reduce(profile(n), s, t)
            if out is None:
                continue  # infeasible seating — the host falls back too
            fins, busys, ops, bnds, cross = out
            flat = [tuple(b) for seg in bnds for b in seg]
            try:
                check_interval_partition(n, flat)
                if ops <= 0 or ops > n:
                    raise InvariantViolation(
                        "ops-conservation", f"{tag}: {ops} ops for n={n}"
                    )
                for fin, busy in zip(fins, busys):
                    if (np.asarray(busy) > np.asarray(fin) + 1e-9).any():
                        raise InvariantViolation(
                            "busy-le-finish", f"{tag}: busy exceeds finish"
                        )
                if cross < 0:
                    raise InvariantViolation(
                        "cross-count", f"{tag}: negative cross-steal count"
                    )
            except InvariantViolation as e:
                violations.append(Violation(e.invariant, f"{tag}: {e.detail}", ()))
    return violations


# ---------------------------------------------------------------------------
# the standard suite (CLI / CI / tests)
# ---------------------------------------------------------------------------

#: Labels the models branch on; tests assert the real executors hit the
#: corresponding runtime sync points (see tests/test_analysis.py).
SUITE_LABELS = (
    "gap.observe",
    "gap.take",
    "phase1.reduce",
    "phase2.scan",
    "phase3.apply",
    "lookback.read",
    "lookback.publish_prefix",
)

#: Labels the serving twin branches on; anchored separately (the serving
#: front end is driven by tests/test_analysis.py's manual frontend, not
#: the scan executors that anchor SUITE_LABELS).
SERVING_LABELS = (
    "serve.submit",
    "serve.reject",
    "serve.pick",
    "serve.complete",
)


def standard_suite(fast: bool = False) -> List[Tuple[str, ExploreResult]]:
    """The clean-tree exploration suite run by ``make analyze`` and CI.

    Every entry must come back ``ok`` (and, for dfs entries, ``exhausted``).
    ``fast=True`` drops the sampled large configs and the coarse 4-worker
    sweep — a sub-second smoke for pre-commit use.
    """
    entries: List[Tuple[str, ExploreResult]] = []

    def run(name, factory, **kw):
        entries.append((name, explore(factory, stop_on_violation=False, **kw)))

    # Gap claim protocol: fine-grained two-worker duel over one shared gap,
    # then wider seatings at coarse granularity.
    run("gap/2w/n5/fine", gap_model(5, 2, granularity="fine"))
    run("gap/3w/n7/coarse", gap_model(7, 3, granularity="coarse"))
    if not fast:
        run("gap/4w/n6/coarse", gap_model(6, 4, granularity="coarse"),
            max_schedules=300000)
        # Cross-segment seating: 2 segments sharing a boundary gap.
        run(
            "gap/cross/2x(2,1)/n8/coarse",
            gap_model(8, 3, granularity="coarse",
                      cross=(((0, 3), (4, 7)), (2, 1))),
            max_schedules=150000,
        )
        run(
            "gap/cross/2x2/n8/sample",
            gap_model(8, 4, granularity="fine", cross=(((0, 3), (4, 7)), (2, 2))),
            mode="sample", seed=7, samples=1500,
        )

    # Phase ordering.
    run("phase/s2", phase_model(2))
    if not fast:
        # s3's full space is >2M interleavings — seeded sampling only.
        run("phase/s3/sample", phase_model(3),
            mode="sample", seed=3, samples=2000)

    # Lookback board.
    run("lookback/t3/fine", lookback_model(3, granularity="fine"))
    run("lookback/t4/coarse", lookback_model(4, granularity="coarse"))
    if not fast:
        run(
            "lookback/t8/sample",
            lookback_model(8, granularity="fine"),
            mode="sample", seed=11, samples=1500,
        )

    # Serving front end: admission + priority lanes with one dispatcher,
    # then the busy-set session FIFO duel with two dispatchers.
    run("serve/2t/prio/d1", frontend_model(
        [("batch", 0, 1, [None, None]), ("inter", 1, 1, [None])],
    ))
    run("serve/session/d2", frontend_model(
        [("scope", 0, 2, ["s1", "s1"])], dispatchers=2,
    ))
    if not fast:
        # Three tasks' full product is out of dfs budget — seeded sampling.
        run("serve/mixed/d2/sample", frontend_model(
            [("batch", 0, 1, ["s1", "s1"]), ("inter", 1, 1, [None])],
            dispatchers=2,
        ), mode="sample", seed=5, samples=2000)

    return entries
