"""Algorithm 1 in the port: the reference's work-stealing tests, run
against ``repro_torch.core.work_stealing`` (the port's own copy of the
JAX-free module), plus parity with the reference on the same inputs."""

import time

import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline container: deterministic fallback sampler
    from _hypothesis_shim import given, settings, strategies as st

from repro.core import work_stealing as ref_ws
from repro_torch.core.work_stealing import (
    _Gap,
    _steal_direction,
    rebalance_boundaries,
    static_reduce,
    stealing_reduce,
    work_stealing_scan,
)
from repro_torch.runtime import scheduler


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    yield
    pool = scheduler.get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    scheduler.set_default_pool(None)


def _affine_op(a, b):
    """Non-commutative modular affine compose — cheap and order-sensitive."""
    return (a[0] * b[0] % 1000003, (a[1] * b[0] + b[1]) % 1000003)


def _seq_scan(xs):
    out = [xs[0]]
    for x in xs[1:]:
        out.append(_affine_op(out[-1], x))
    return out


@pytest.mark.parametrize("n,t", [(16, 2), (64, 4), (100, 8), (37, 5)])
@pytest.mark.parametrize("stealing", [False, True])
def test_scan_correct(n, t, stealing):
    xs = [(i % 7 + 1, i) for i in range(n)]
    out, stats = work_stealing_scan(_affine_op, xs, t, stealing=stealing)
    assert out == _seq_scan(xs)


@pytest.mark.parametrize("stealing", [False, True])
def test_boundaries_partition(stealing):
    """Invariant: thread intervals form a contiguous partition of [0, N)."""
    n, t = 97, 6
    xs = [(1, i) for i in range(n)]
    _, stats = work_stealing_scan(_affine_op, xs, t, stealing=stealing)
    b = sorted(stats.boundaries)
    assert b[0][0] == 0 and b[-1][1] == n - 1
    for (l1, r1), (l2, r2) in zip(b, b[1:]):
        assert l2 == r1 + 1, b


@settings(max_examples=15, deadline=None)
@given(n=st.integers(8, 60), t=st.integers(2, 6), seed=st.integers(0, 1000))
def test_property_every_element_once(n, t, seed):
    """Property: stealing processes every element exactly once (any op order)."""
    if t * 2 > n:
        t = max(2, n // 2)
    rng = np.random.default_rng(seed)
    xs = [(int(rng.integers(1, 7)), i) for i in range(n)]
    out, stats = work_stealing_scan(_affine_op, xs, t, stealing=True)
    assert out == _seq_scan(xs)
    covered = sorted(
        i for lo, hi in stats.boundaries for i in range(lo, hi + 1)
    )
    assert covered == list(range(n))


def test_stealing_balances_sleep_op():
    """With an imbalanced (sleepy) operator, stealing reduces the busy-time
    imbalance across threads vs the static split.  Tolerances are wide: on
    a 1-CPU CI runner the GIL serializes the non-sleep portions, so exact
    thread timings carry scheduler noise — the signal gated here is only
    'stealing is not meaningfully worse', the magnitude lives in the
    benchmarks."""
    n, t = 60, 3
    # Imbalance concentrated in one region (like the paper's outliers).
    delays = np.full(n, 0.001)
    delays[: n // 3] = 0.008

    def make_op():
        def op(a, b):
            idx = b[1] if isinstance(b, tuple) else 0
            time.sleep(delays[idx % n])
            return _affine_op(a, b)
        return op

    xs = [(i % 7 + 1, i) for i in range(n)]
    _, st_static = static_reduce(make_op(), xs, t)
    _, st_steal = stealing_reduce(make_op(), xs, t)
    assert st_steal.imbalance() <= st_static.imbalance() + 0.2
    assert st_steal.makespan <= st_static.makespan * 1.35


def test_steal_direction_unobserved_rates_pick_larger_gap():
    """Tie-break fix: before either neighbour has an observed rate (both read
    0.0 sec/op), the direction must follow the larger gap — not a fixed side
    — so the first steals flow into the region with more unclaimed work."""
    assert _steal_direction(0.0, 0.0, 10, 3) == "L"
    assert _steal_direction(0.0, 0.0, 3, 10) == "R"
    assert _steal_direction(0.0, 0.0, 4, 4) == "R"  # exact tie: either side
    # Observed rates still dominate the choice, whatever the gap sizes.
    assert _steal_direction(2.0, 1.0, 1, 50) == "L"
    assert _steal_direction(1.0, 2.0, 50, 1) == "R"
    # Empty sides remain forced regardless of rates.
    assert _steal_direction(9.0, 0.0, 0, 5) == "R"
    assert _steal_direction(0.0, 9.0, 5, 0) == "L"


def test_rebalance_boundaries():
    costs = np.array([1.0] * 10 + [9.0] * 10)
    new = rebalance_boundaries(costs, [(0, 9), (10, 19)])
    assert new[0][0] == 0 and new[-1][1] == 19
    assert new[0][1] >= 12  # fast region absorbs more elements
    loads = [costs[lo: hi + 1].sum() for lo, hi in new]
    assert max(loads) / min(loads) < 9.0  # was 9x imbalanced before


def test_rebalance_noop_on_balanced():
    costs = np.ones(32)
    new = rebalance_boundaries(costs, [(0, 15), (16, 31)])
    assert new == [(0, 15), (16, 31)]


def test_seeded_scan():
    """Seed (exclusive prefix from the global phase) composes correctly."""
    xs = [(i % 5 + 1, i) for i in range(24)]
    seed = (3, 7)
    out, _ = work_stealing_scan(_affine_op, xs, 3, seed=seed)
    ref = []
    acc = seed
    for x in xs:
        acc = _affine_op(acc, x)
        ref.append(acc)
    assert out == ref


# ------------------------------------------------- rebalance degenerate inputs


def test_rebalance_zero_costs_falls_back_to_even_split():
    """All-zero costs carry no signal: the old code made target == 0, so
    every segment closed after one element and the last segment got the
    whole tail.  Now it must degrade to an even split."""
    new = rebalance_boundaries([0.0] * 16, [(0, 3), (4, 7), (8, 11), (12, 15)])
    assert new == [(0, 3), (4, 7), (8, 11), (12, 15)]


def test_rebalance_single_element():
    new = rebalance_boundaries([5.0], [(0, 0), (0, 0), (0, 0)])
    assert new[0] == (0, 0)
    # Trailing segments are empty but contiguity-encoded: hi == lo - 1,
    # never the old inverted (n-1, n-2) padding.
    for lo, hi in new[1:]:
        assert hi == lo - 1
    assert len(new) == 3


def test_rebalance_more_segments_than_elements():
    """t > n: first n segments get one element each, the rest are empty —
    the old padding appended inverted (hi < lo - 1) intervals instead."""
    new = rebalance_boundaries([1.0, 1.0, 1.0], [(0, 0)] * 5)
    assert new[:3] == [(0, 0), (1, 1), (2, 2)]
    for lo, hi in new:
        assert hi >= lo - 1  # empty allowed, inverted not
    # Contiguity holds across empty segments too.
    for (_, h1), (l2, _) in zip(new, new[1:]):
        assert l2 == h1 + 1
    covered = [i for lo, hi in new for i in range(lo, hi + 1)]
    assert covered == [0, 1, 2]


def test_rebalance_partition_property():
    """Any costs/segment-count: output is a contiguous ordered partition."""
    rng = np.random.default_rng(7)
    for n in [1, 2, 3, 7, 33]:
        for t in [1, 2, 3, 5, 8]:
            costs = rng.exponential(1.0, n)
            if n % 3 == 0:
                costs[:] = 0.0  # exercise the zero-cost fallback too
            out = rebalance_boundaries(list(costs), [(0, 0)] * t)
            assert len(out) == t
            assert out[0][0] == 0
            covered = [i for lo, hi in out for i in range(lo, hi + 1)]
            assert covered == list(range(n)), (n, t, out)
            for (_, h1), (l2, _) in zip(out, out[1:]):
                assert l2 == h1 + 1, (n, t, out)


def test_cross_start_positions_infeasible_returns_none():
    from repro_torch.core.work_stealing import cross_start_positions

    # Feasible: one worker per 2-element segment seats at the middles.
    assert cross_start_positions([(0, 1), (2, 3)], [1, 1], 4) == [0, 3]
    # Infeasible: 4 workers cannot seat over 2 elements.
    assert cross_start_positions([(0, 0), (1, 1)], [2, 2], 2) is None


# --------------------------------------------------------- contended gaps


def test_gap_contended_drain_claims_each_element_once():
    """Two sides hammering one shared gap: every index claimed exactly once,
    side counters account for all claims."""
    import threading

    g = _Gap(0, 2000)
    claimed: list = []
    lock = threading.Lock()

    def drain(take):
        got = []
        while True:
            i = take()
            if i is None:
                break
            got.append(i)
        with lock:
            claimed.extend(got)

    threads = [
        threading.Thread(target=drain, args=(g.take_left,)),
        threading.Thread(target=drain, args=(g.take_right,)),
        threading.Thread(target=drain, args=(g.take_left,)),
        threading.Thread(target=drain, args=(g.take_right,)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(claimed) == list(range(2000))
    assert g.taken_left + g.taken_right == 2000
    assert g.size() == 0


def test_stealing_reduce_contended_gap_backoff():
    """Instant operator + many threads = maximal take-race pressure: the
    result must stay a correct contiguous partition, and lost races are
    visible (and bounded) in ``failed_takes`` rather than a silent spin."""
    n, t = 64, 8
    xs = [(i % 7 + 1, i) for i in range(n)]
    for _ in range(5):
        partials, st = stealing_reduce(_affine_op, xs, t)
        covered = sorted(
            i for lo, hi in st.boundaries for i in range(lo, hi + 1)
        )
        assert covered == list(range(n))
        # Folding per-thread partials in order reproduces the full reduce.
        acc = partials[0]
        for p in partials[1:]:
            acc = _affine_op(acc, p)
        ref = xs[0]
        for x in xs[1:]:
            ref = _affine_op(ref, x)
        assert acc == ref
        # A lost race costs at most one bounded backoff each; it can never
        # exceed the number of loop iterations that found work available.
        fails = sum(th.failed_takes for th in st.threads)
        assert fails <= 4 * n


# --------------------------------------------------- exact op accounting


def test_total_ops_counts_every_application_seeded():
    """total_ops must equal the *exact* number of operator applications —
    including the phase-3 seed combines that were previously uncounted —
    and stay within the paper's ~3N full-registration work bound."""
    n, t = 48, 4
    xs = [(i % 5 + 1, i) for i in range(n)]
    for seed in [None, (3, 7)]:
        calls = []

        def op(a, b):
            calls.append(1)
            return _affine_op(a, b)

        out, stats = work_stealing_scan(op, xs, t, seed=seed)
        assert stats.total_ops == len(calls), (seed, stats.total_ops, len(calls))
        # Reduce (~N) + width-T circuit + seeded apply (~N): ~2N + O(T log T),
        # comfortably under the paper's 3N full-registration bound.
        assert stats.total_ops <= 3 * n


def test_total_ops_counts_every_application_single_thread():
    xs = [(i % 5 + 1, i) for i in range(9)]
    calls = []

    def op(a, b):
        calls.append(1)
        return _affine_op(a, b)

    _, stats = work_stealing_scan(op, xs, 1, seed=(3, 7))
    assert stats.total_ops == len(calls) == 9


# ------------------------------------------- shared inter-segment gaps


def test_shared_gap_cross_segment_reduce():
    """Two stealing_reduce 'segments' sharing one boundary _Gap: the union
    of their final intervals partitions the range, the shared region is
    split between them, and claims from it are counted as cross-steals."""
    import threading

    n = 32
    xs = [(i % 7 + 1, i) for i in range(n)]
    # Static border inside the shared no-man's-land: elements < 16 belong
    # to segment a, >= 16 to segment b.
    shared = _Gap(11, 20, border=16)
    out: dict = {}

    def run(tag, starts, left, right):
        out[tag] = stealing_reduce(
            _affine_op, xs, len(starts), starts=starts,
            left_gap=left, right_gap=right,
        )

    ta = threading.Thread(target=run, args=("a", [0, 10], None, shared))
    tb = threading.Thread(target=run, args=("b", [20, 31], shared, None))
    ta.start(); tb.start(); ta.join(); tb.join()

    (pa, sa), (pb, sb) = out["a"], out["b"]
    bounds = sa.boundaries + sb.boundaries
    covered = sorted(i for lo, hi in bounds for i in range(lo, hi + 1))
    assert covered == list(range(n))
    assert shared.size() == 0
    assert shared.taken_left + shared.taken_right == 9  # the shared region
    # Only claims that landed beyond the static border count as steals:
    # a drains ascending from 11, so its steals are its claims >= 16;
    # b drains descending from 19, so its steals are its claims < 16.
    split = sb.boundaries[0][0]  # first element b ended up owning
    assert sa.cross_steals() == max(0, (split - 1) - 16 + 1)
    assert sb.cross_steals() == max(0, 16 - split)
    # Partials folded in order == full sequential reduce.
    acc = pa[0]
    for p in pa[1:] + pb:
        acc = _affine_op(acc, p)
    ref = xs[0]
    for x in xs[1:]:
        ref = _affine_op(ref, x)
    assert acc == ref


# ------------------------------------------------ parity with the reference


@pytest.mark.parametrize("n,t", [(16, 2), (37, 5), (64, 4)])
@pytest.mark.parametrize("seeded", [False, True])
def test_scan_matches_reference(n, t, seeded):
    xs = [(i % 7 + 1, i) for i in range(n)]
    seed = (3, 7) if seeded else None
    got, _ = work_stealing_scan(_affine_op, xs, t, seed=seed)
    want, _ = ref_ws.work_stealing_scan(_affine_op, xs, t, seed=seed)
    assert got == want


def test_cross_start_positions_match_reference():
    from repro_torch.core.work_stealing import cross_start_positions

    for bounds, tcounts, n in [
        ([(0, 9), (10, 19)], [2, 2], 20),
        ([(0, 4), (5, 12), (13, 30)], [2, 3, 4], 31),
        ([(0, 0), (1, 1)], [2, 2], 2),
    ]:
        assert cross_start_positions(bounds, tcounts, n) == (
            ref_ws.cross_start_positions(bounds, tcounts, n)
        )
