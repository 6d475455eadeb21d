"""Node-local work-stealing prefix scan (the paper's core contribution, §4.3).

The reduce-then-scan strategy leaves the *order* in which a segment is reduced
unconstrained: given associativity, a contiguous interval can be accumulated
left-to-right, right-to-left, or middle-outward.  The paper exploits this to
let faster threads steal boundary elements from slower neighbours (Algorithm 1):

    while s_{I-1} > 0 or s_{I+1} > 0:
        if both gaps non-empty:  d = LEFT if t_{I-1} > t_{I+1} else RIGHT
        else:                    d = the non-empty side
        extend pl/pr by one element, folding it into res_I from that side

where t_J is neighbour J's observed seconds-per-operator-application and s_I
the number of unclaimed elements between threads I and I+1.

This module is the *faithful host-level reproduction*: real Python threads,
shared gap counters, greedy direction choice from observed rates.  The
operator is expected to be expensive (seconds — image registration, or the
paper's sleep-based mock operators), so Python-level synchronization overhead
is negligible, exactly as MPI/OpenMP overhead was in the paper.

Execution is routed through an injected :class:`~repro_torch.runtime.scheduler`
pool (the process-wide shared :func:`get_default_pool` unless the caller
passes one): the executors here enqueue *worker tasks*, they never
construct OS threads, so concurrent series multiplex fairly onto one
resident runtime instead of each spawning a private thread army per call.

The same protocol is *promoted to the segment level* by the hierarchical
backend (``engine/hierarchical.py``): adjacent segments of a two-level
reduce share boundary ``_Gap`` objects, their edge threads drain them
concurrently, and direction choice at a shared gap compares per-segment
rate EMAs instead of thread rates — so a finished segment steals from a
straggler neighbour instead of idling (see ``stealing_reduce``'s
``starts``/``left_gap``/``right_gap``/``outer_rates`` parameters).

The deterministic virtual-time twin used for >10^3-core studies
(``simulator.py``) and the compiled-SPMD derivative (ahead-of-step boundary
rebalancing, ``runtime/straggler.py``) are not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

from repro_torch.analysis.invariants import (
    check_phase_order,
    check_segment_intervals,
    check_unique_claims,
    claim_once,
    record_events,
)
from repro_torch.analysis.sync import invariants_enabled, sync_point
from repro_torch.runtime.scheduler import get_default_pool
from repro_torch.runtime.tracing import span, timed

from .engine.backends import exec_element
from .engine.plan import ExecutionPlan, get_plan

Op = Callable[[Any, Any], Any]


@dataclasses.dataclass
class _Gap:
    """Unclaimed elements between two adjacent workers: half-open [lo, hi).

    A gap is *private* when both sides are threads of the same segment and
    *shared* when it sits between two segments of a hierarchical phase 1
    (``engine/hierarchical.py`` builds those): a finished segment's edge
    thread keeps draining the shared gap, stealing boundary elements the
    static decomposition would have billed to its still-running neighbour.
    ``taken_left``/``taken_right`` count claims per side so inter-segment
    steal traffic can be reported per boundary.  For a shared gap,
    ``border`` records the *static* segment boundary inside it (first
    element of the right segment): a claim only counts as a cross-segment
    steal when the claimed index lies on the other side of it — draining
    your own half of the no-man's-land is ordinary gap consumption.
    """

    lo: int
    hi: int
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    taken_left: int = 0
    taken_right: int = 0
    border: Optional[int] = None

    def size(self) -> int:
        # Racy probe by design: callers only use it to pick a direction, and
        # take_left/take_right re-validate lo < hi under the lock before
        # claiming, so a stale read can never over-claim.
        return max(0, self.hi - self.lo)  # analysis: allow[LCK001]

    def take_left(self) -> Optional[int]:
        """Left thread extends right: claim ``lo``."""
        with self.lock:
            if self.lo < self.hi:
                i = self.lo
                self.lo += 1
                self.taken_left += 1
                return i
            return None

    def take_right(self) -> Optional[int]:
        """Right thread extends left: claim ``hi - 1``."""
        with self.lock:
            if self.lo < self.hi:
                self.hi -= 1
                self.taken_right += 1
                return self.hi
            return None


@dataclasses.dataclass
class ThreadStats:
    ops: int = 0
    busy_time: float = 0.0
    pl: int = 0
    pr: int = 0
    finish_time: float = 0.0
    cross_steals: int = 0   # claims taken from a shared inter-segment gap
    failed_takes: int = 0   # lost take races (each followed by a backoff)
    task_time: float = 0.0  # seconds the thread's phase-1 task held, start
                            # to end (``busy_time`` is the operator's share)

    def rate(self) -> float:
        """Observed seconds per operator application (t_I in the paper)."""
        if self.ops == 0:
            return 0.0
        return self.busy_time / self.ops


@dataclasses.dataclass
class StealStats:
    threads: List[ThreadStats]
    makespan: float
    total_ops: int
    boundaries: List[Tuple[int, int]]  # inclusive [pl, pr] per thread
    # Thread-seconds of the scan's work after phase 1: phase 2 and the
    # seed combines on the calling thread, and phase 3's pool tasks.
    scan_time: float = 0.0
    # Thread-seconds the scan's threads held no task, phase 1's start to
    # phase 3's end: between and after phase-1 tasks, through phase 2
    # (the other threads), in phase 3 (0 for a reduce run on its own).
    wait_time: float = 0.0

    def task_seconds(self) -> float:
        """Thread-seconds the scan's work held: phase 1's tasks, then
        phases 2 and 3 (every operator application runs inside them)."""
        return sum(t.task_time for t in self.threads) + self.scan_time

    def failed_takes(self) -> int:
        """Steal takes lost to a neighbour, over all threads."""
        return sum(t.failed_takes for t in self.threads)

    def imbalance(self) -> float:
        """Relative difference between max and mean busy time (paper Fig. 5b)."""
        busy = [t.busy_time for t in self.threads]
        mean = sum(busy) / len(busy)
        return (max(busy) - mean) / mean if mean > 0 else 0.0

    def cross_steals(self) -> int:
        """Elements this reduce claimed from shared inter-segment gaps."""
        return sum(t.cross_steals for t in self.threads)


@contextlib.contextmanager
def held(name: str, sink: List[float]):
    """Run a stretch of a scan's work under the span ``name`` and append
    the thread-seconds it held to ``sink``."""
    with timed(name) as t:
        yield
    sink.append(t.seconds)


def _steal_direction(
    rate_left: float, rate_right: float, gap_left: int, gap_right: int
) -> str:
    """Pick the side to extend toward (Algorithm 1's greedy choice).

    With both neighbour rates observed, move toward the *slower* neighbour
    (higher sec/op).  Before either neighbour has completed an operator
    application both rates read 0.0 — indistinguishable — so the tie-break
    is the *larger gap*: it holds more unclaimed work, and extending into it
    relieves whichever neighbour turns out to be slower.
    """
    if gap_left <= 0:
        return "R"
    if gap_right <= 0:
        return "L"
    if rate_left == 0.0 and rate_right == 0.0:
        return "L" if gap_left > gap_right else "R"
    return "L" if rate_left > rate_right else "R"


def _start_positions(n: int, t: int) -> List[int]:
    """Thread start elements: 0, segment middles, N-1 (paper §4.3)."""
    if t == 1:
        return [0]
    seg = n / t
    starts = [0]
    for i in range(1, t - 1):
        starts.append(int(i * seg + seg / 2))
    starts.append(n - 1)
    # Ensure strictly increasing (tiny N edge cases).
    for i in range(1, len(starts)):
        starts[i] = max(starts[i], starts[i - 1] + 1)
    if starts[-1] >= n:
        raise ValueError(f"too many threads ({t}) for {n} elements")
    return starts


def cross_start_positions(
    bounds: Sequence[Tuple[int, int]], tcounts: Sequence[int], n: int
) -> Optional[List[int]]:
    """Worker start positions for cross-segment stealing — the single
    source of the seating geometry, shared by the host executor
    (``engine/hierarchical.py``) and its virtual-time twin
    (``simulator._simulate_cross_stealing_reduce``) so the two protocols
    cannot drift.

    The global edges are pinned to 0 and N-1 (nothing beyond them to
    steal); *every other* worker — including segment-edge workers — starts
    at the middle of its even per-thread sub-range, so the regions
    straddling the static segment borders stay unclaimed shared gaps until
    one side wins them.  Returns None when N is too small to seat every
    worker (callers fall back to static segments).
    """
    starts: List[int] = []
    for (lo, hi), tc in zip(bounds, tcounts):
        seg = (hi - lo + 1) / tc
        for j in range(tc):
            starts.append(lo + int(j * seg + seg / 2))
    starts[0] = 0
    starts[-1] = n - 1
    for i in range(1, len(starts)):
        starts[i] = max(starts[i], starts[i - 1] + 1)
    return starts if starts[-1] == n - 1 else None


def stealing_reduce(
    op: Op,
    items: Sequence[Any],
    num_threads: int,
    *,
    clock: Callable[[], float] = time.monotonic,
    starts: Optional[Sequence[int]] = None,
    left_gap: Optional[_Gap] = None,
    right_gap: Optional[_Gap] = None,
    outer_rates: Tuple[Optional[Callable[[], Optional[float]]],
                       Optional[Callable[[], Optional[float]]]] = (None, None),
    record: Optional[Callable[[float], None]] = None,
    pool=None,
) -> Tuple[List[Any], StealStats]:
    """Phase 1 of reduce-then-scan with work stealing (Algorithm 1).

    Returns per-thread partial reductions over the contiguous intervals each
    thread ended up owning, plus stealing statistics.

    Standalone use covers ``items`` exactly.  As one *segment* of a
    cross-segment hierarchical phase 1, the caller passes explicit global
    ``starts`` (``items`` is then the full element list, indexed globally)
    plus the shared boundary gaps:

    ``left_gap`` / ``right_gap``
        shared inter-segment :class:`_Gap` objects this segment's edge
        threads drain concurrently with the neighbour segment's edge
        threads — claims from them are *cross-segment steals*.
    ``outer_rates``
        zero-arg callables returning the left/right neighbour *segment's*
        observed seconds-per-op (an EMA from ``engine/telemetry.py``), used
        for Algorithm 1's direction choice at the shared gaps exactly as
        thread rates are used at private gaps.  ``None`` reads as
        unobserved (0.0) and falls back to the larger-gap tie-break.
    ``record``
        per-application duration callback feeding this segment's own rate
        EMA, so *its* neighbours can make the symmetric choice.
    ``pool``
        scheduler the worker tasks run on (shared process-wide
        :class:`~repro_torch.runtime.scheduler.WorkerPool` by default) — this
        function enqueues tasks, it never spawns threads.
    """
    n = len(items)
    t = num_threads
    auto_starts = starts is None
    if starts is None:
        starts = _start_positions(n, t)
    elif len(starts) != t:
        raise ValueError(f"{len(starts)} starts for {t} threads")
    # gaps[i] sits between thread i-1 and thread i (i in 1..t-1); gaps[0]
    # and gaps[t] are the segment's outer boundaries — None standalone,
    # shared inter-segment gaps under cross-segment stealing.
    gaps: List[Optional[_Gap]] = [None] * (t + 1)
    gaps[0] = left_gap
    gaps[t] = right_gap
    for i in range(1, t):
        gaps[i] = _Gap(starts[i - 1] + 1, starts[i])
    stats = [ThreadStats(pl=s, pr=s) for s in starts]
    results: List[Any] = [None] * t
    t0 = clock()
    # Debug claim ledger (REPRO_CHECK_INVARIANTS=1): every take recorded,
    # double claims raise at record time, coverage checked after the join.
    checking = invariants_enabled()
    claims: dict = {}
    claims_lock = threading.Lock() if checking else None

    def _outer_rate(side: int) -> float:
        fn = outer_rates[side]
        if fn is None:
            return 0.0
        r = fn() if callable(fn) else fn
        return 0.0 if r is None else float(r)

    def _steal(tid: int) -> None:
        st = stats[tid]
        left = gaps[tid]
        right = gaps[tid + 1]
        begin = clock()
        res = items[starts[tid]]
        st.busy_time += clock() - begin
        sync_point("gap.seat")
        if checking:
            with claims_lock:
                claim_once(claims, starts[tid], tid)
        spins = 0
        while True:
            sync_point("gap.observe")
            ls = left.size() if left else 0
            rs = right.size() if right else 0
            if ls == 0 and rs == 0:
                break
            # Greedy: move toward the *slower* neighbour (higher sec/op);
            # unobserved rates tie-break on the larger gap.  Edge threads
            # of a segment compare against the neighbour *segment's* rate.
            rate_l = stats[tid - 1].rate() if tid > 0 else _outer_rate(0)
            rate_r = stats[tid + 1].rate() if tid < t - 1 else _outer_rate(1)
            d = _steal_direction(
                rate_l if left else 0.0,
                rate_r if right else 0.0,
                ls, rs,
            )
            sync_point("gap.take")
            idx = left.take_right() if d == "L" else right.take_left()
            if idx is not None and checking:
                with claims_lock:
                    claim_once(claims, idx, tid)
            if idx is None:
                # Lost the race for the gap's last element(s).  Yield, then
                # back off (bounded) before re-observing both gap sizes —
                # a tight retry here spins a core while a neighbour that
                # won the race is still mid-application.
                st.failed_takes += 1
                spins += 1
                with span("repro.steal.backoff"):
                    time.sleep(0.0 if spins <= 2
                               else min(1e-3, 2e-5 * (1 << min(spins, 6))))
                continue
            spins = 0
            b = clock()
            if d == "L":
                res = op(items[idx], res)
                st.pl = idx
            else:
                res = op(res, items[idx])
                st.pr = idx
            dt = clock() - b
            st.busy_time += dt
            st.ops += 1
            if record is not None:
                record(dt)
            # Cross-segment steal = a claim from a shared outer gap that
            # landed beyond the static border (in the neighbour's half).
            if (tid == 0 and d == "L" and left.border is not None
                    and idx < left.border):
                st.cross_steals += 1
            elif (tid == t - 1 and d == "R" and right.border is not None
                    and idx >= right.border):
                st.cross_steals += 1
        results[tid] = res
        st.finish_time = clock() - t0

    def worker(tid: int) -> None:
        t_task = time.perf_counter()
        with span("repro.steal.task"):
            _steal(tid)
        stats[tid].task_time = time.perf_counter() - t_task

    if pool is None:
        pool = get_default_pool()
    pool.run_tasks(
        [functools.partial(worker, i) for i in range(t)], label="steal_reduce"
    )
    if checking:
        # Terminal safety: per-thread intervals contiguous (no boundary
        # element claimed twice or dropped); standalone reduces — no shared
        # outer gaps moving the edges — additionally cover [0, n) exactly.
        intervals = sorted((s.pl, s.pr) for s in stats)
        if auto_starts and left_gap is None and right_gap is None:
            check_segment_intervals(intervals, lo=0, hi=n - 1)
            check_unique_claims(n, claims)
        else:
            check_segment_intervals(intervals)
    makespan = max(s.finish_time for s in stats)
    return results, StealStats(
        threads=stats,
        makespan=makespan,
        total_ops=sum(s.ops for s in stats),
        boundaries=[(s.pl, s.pr) for s in stats],
    )


def static_reduce(
    op: Op,
    items: Sequence[Any],
    num_threads: int,
    *,
    clock: Callable[[], float] = time.monotonic,
    pool=None,
) -> Tuple[List[Any], StealStats]:
    """Baseline: fixed even segments, no stealing (paper's 'static')."""
    n = len(items)
    t = num_threads
    bounds = [(i * n // t, (i + 1) * n // t - 1) for i in range(t)]
    stats = [ThreadStats(pl=lo, pr=hi) for lo, hi in bounds]
    results: List[Any] = [None] * t
    t0 = clock()

    def worker(tid: int) -> None:
        t_task = time.perf_counter()
        lo, hi = bounds[tid]
        st = stats[tid]
        with span("repro.steal.task"):
            b = clock()
            res = items[lo]
            for i in range(lo + 1, hi + 1):
                res = op(res, items[i])
                st.ops += 1
            st.busy_time += clock() - b
        results[tid] = res
        st.finish_time = clock() - t0
        st.task_time = time.perf_counter() - t_task

    if pool is None:
        pool = get_default_pool()
    pool.run_tasks(
        [functools.partial(worker, i) for i in range(t)], label="static_reduce"
    )
    makespan = max(s.finish_time for s in stats)
    return results, StealStats(
        threads=stats,
        makespan=makespan,
        total_ops=sum(s.ops for s in stats),
        boundaries=bounds,
    )


def work_stealing_scan(
    op: Op,
    items: Sequence[Any],
    num_threads: int,
    *,
    algorithm: str = "dissemination",
    stealing: bool = True,
    seed: Any = None,
    plan: Optional[ExecutionPlan] = None,
    pool=None,
) -> Tuple[List[Any], StealStats]:
    """Full node-local reduce-then-scan with (optional) work stealing.

    Phase 1: (stealing) reduction over flexible segments.
    Phase 2: plan-driven scan over the T partials (paper uses dissemination —
             'its implementation is simpler … difference negligible for a
             dozen threads').  ``plan`` overrides ``algorithm`` when given
             (its width must equal ``num_threads``); either way the circuit
             is lowered once and cached, not re-traced per call.
    Phase 3: per-interval sequential scan seeded with the exclusive prefix.

    ``seed``: optional element logically preceding items[0] (used when this
    node is one rank of a distributed scan: the seed is the exclusive result
    received from the global phase).  ``pool``: the scheduler phases 1 and 3
    run on (process-wide shared pool by default).
    """
    n = len(items)
    t_start = time.perf_counter()
    # Thread-seconds of phases 2 and 3 (a single thread's chain counts as
    # phase 3): what StealStats.scan_time reports.
    after: List[float] = []
    if num_threads == 1:
        out = []
        acc = seed
        with held("repro.scan.apply", after):
            for x in items:
                acc = x if acc is None else op(acc, x)
                out.append(acc)
        st = ThreadStats(ops=n - (0 if seed is not None else 1), pl=0, pr=n - 1)
        return out, StealStats([st], 0.0, st.ops, [(0, n - 1)],
                               scan_time=sum(after))

    if pool is None:
        pool = get_default_pool()
    checking = invariants_enabled()
    events: List[Tuple[str, int]] = []
    events_lock = threading.Lock() if checking else None
    reduce_fn = stealing_reduce if stealing else static_reduce
    sync_point("phase1.reduce")
    partials, stats = reduce_fn(op, items, num_threads, pool=pool)
    if checking:
        record_events(events, "p1_done", 0)

    # Phase 2: scan over partials with a precompiled circuit plan.
    if plan is None or plan.n != len(partials):
        plan = get_plan(algorithm, len(partials))
    sync_point("phase2.scan")
    bounds = stats.boundaries
    seeds: List[Any] = []
    with held("repro.scan.combine", after):
        scanned, _ = exec_element(op, plan, partials)
        if checking:
            record_events(events, "p2_done", -1)
        stats.total_ops += plan.work()
        for i in range(len(bounds)):
            if i == 0:
                seeds.append(seed)
            elif seed is None:
                seeds.append(scanned[i - 1])
            else:
                # Seed combines execute the operator — they count toward
                # the total-work claim (~3N for a seeded full scan) like
                # any other.
                seeds.append(op(seed, scanned[i - 1]))
                stats.total_ops += 1

    # Phase 3: seeded per-interval scans (parallel threads).
    out: List[Any] = [None] * n

    def apply_worker(tid: int) -> None:
        sync_point("phase3.apply")
        if checking:
            with events_lock:
                record_events(events, "p3_start", 0)
        lo, hi = bounds[tid]
        acc = seeds[tid]
        with held("repro.scan.apply", after):
            for j in range(lo, hi + 1):
                acc = items[j] if acc is None else op(acc, items[j])
                out[j] = acc

    pool.run_tasks(
        [functools.partial(apply_worker, i) for i in range(len(bounds))],
        label="seeded_apply",
    )
    if checking:
        # Phase-3 applies must observe both completions: the event log is
        # append-ordered, so any apply recorded before p1_done/p2_done
        # trips the shared phase-order invariant.
        check_phase_order(events)
    stats.total_ops += sum(
        (hi - lo + 1) - (1 if s is None else 0)
        for (lo, hi), s in zip(bounds, seeds)
    )
    stats.scan_time = sum(after)
    stats.wait_time = (len(bounds) * (time.perf_counter() - t_start)
                       - stats.task_seconds())
    return out, stats


def rebalance_boundaries(
    costs: Sequence[float], boundaries: Sequence[Tuple[int, int]]
) -> List[Tuple[int, int]]:
    """Ahead-of-step greedy boundary rebalancing (TPU-idiomatic derivative).

    Given measured per-element costs from the previous step, move each
    boundary between neighbours so prefix-balanced load is achieved — the same
    greedy "give work to the slower side" rule as Algorithm 1, applied once,
    offline.  Used by ``runtime/straggler.py`` to rebalance host shards and
    by ``engine/hierarchical.py`` for ahead-of-time segment sizing from
    operator cost history.

    Always returns ``len(boundaries)`` contiguous inclusive intervals
    covering ``[0, len(costs))`` in order; when there are more segments than
    elements the trailing segments are *empty*, encoded as ``(lo, lo - 1)``
    so contiguity (``next.lo == prev.hi + 1``) still holds.  All-zero (or
    empty) cost vectors carry no imbalance signal and fall back to an even
    split rather than closing every segment after one element.
    """
    n = len(costs)
    t = len(boundaries)
    if t == 0:
        return []
    weights = [float(c) for c in costs]
    total = sum(weights)
    if total <= 0.0:
        weights = [1.0] * n
        total = float(n)
    out: List[Tuple[int, int]] = []
    lo = 0
    acc = 0.0
    for tid in range(t):
        if lo >= n:
            out.append((n, n - 1))  # empty tail segment (t > n)
            continue
        if tid == t - 1:
            out.append((lo, n - 1))
            lo = n
            continue
        # Extend to the cumulative fair share, keeping at least one element
        # for every remaining segment while elements remain.
        hi_cap = max(lo, n - 1 - (t - tid - 1))
        target = total * (tid + 1) / t
        hi = lo
        acc += weights[lo]
        while hi < hi_cap and acc < target:
            hi += 1
            acc += weights[hi]
        out.append((lo, hi))
        lo = hi + 1
    return out
