"""WorkerPool runtime in the port: the reference's scheduler tests, run
against ``repro_torch.runtime.scheduler`` (the port's own copy of the
JAX-free module) and the port's executors, with the thread-discipline
lint over the port's tree.

Under ``REPRO_CHECK_INVARIANTS=1`` the module ends by asserting that the
port's happens-before race tracker recorded no race (the counterpart of
the reference's ``make sanitize``)."""

import threading
import time

import pytest

from repro_torch.analysis.sync import get_race_tracker, invariants_enabled
from repro_torch.runtime.scheduler import (
    TransientPool,
    WorkerPool,
    get_default_pool,
    set_default_pool,
)


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    yield
    pool = get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    set_default_pool(None)
    if invariants_enabled():
        races = get_race_tracker().races()
        assert races == [], "\n".join(str(r) for r in races)


def test_work_stealing_hot_paths_spawn_no_threads():
    """Acceptance gate: the thread-discipline lint pass (THR001 — no raw
    thread/executor construction outside ``runtime/scheduler.py``) is
    clean over the port's tree."""
    from repro_torch.analysis.lint import run_lint

    findings = [f for f in run_lint() if f.rule == "THR001"]
    assert findings == [], "\n".join(str(f) for f in findings)


def test_join_waits_for_workers_of_a_shut_down_pool():
    pool = WorkerPool(max_workers=3, name="joined")
    pool.run_tasks([lambda: time.sleep(0.02) for _ in range(6)])
    assert pool.num_workers > 0
    pool.shutdown()
    pool.join(timeout=10)
    assert not any(t.is_alive() for t in pool._threads)


# ----------------------------------------------------------------- basics


@pytest.mark.parametrize("make", [WorkerPool, TransientPool])
def test_results_in_order(make):
    pool = make()
    out = pool.run_tasks([lambda i=i: i * i for i in range(20)])
    assert out == [i * i for i in range(20)]
    if isinstance(pool, WorkerPool):
        pool.shutdown()


@pytest.mark.parametrize("make", [WorkerPool, TransientPool])
def test_exception_propagates_after_group_settles(make):
    pool = make()
    done = []

    def ok(i):
        done.append(i)
        return i

    def boom():
        raise RuntimeError("task died")

    with pytest.raises(RuntimeError, match="task died"):
        pool.run_tasks([lambda: ok(0), boom, lambda: ok(2)])
    # The failing task must not strand its siblings: the whole group ran.
    assert sorted(done) == [0, 2]
    if isinstance(pool, WorkerPool):
        pool.shutdown()


def test_empty_group():
    pool = WorkerPool(max_workers=2)
    assert pool.run_tasks([]) == []
    pool.shutdown()


def test_zero_workers_degrades_to_caller_execution():
    """With no workers at all, the helping caller runs everything itself —
    the pool can never deadlock for lack of capacity."""
    pool = WorkerPool(max_workers=0)
    tids = pool.run_tasks([threading.get_ident for _ in range(5)])
    assert set(tids) == {threading.get_ident()}
    assert pool.num_workers == 0


def test_workers_are_reused_across_calls():
    pool = WorkerPool(max_workers=4)
    for _ in range(6):
        pool.run_tasks([lambda: time.sleep(0.005) for _ in range(4)])
    # Lazy spawn is capped: six 4-task groups never need > 4 resident
    # workers (the legacy behaviour spawned 24 threads for this).
    assert pool.num_workers <= 4
    assert pool.tasks_completed == 24
    pool.shutdown()


def test_concurrency_is_real():
    """Sleep tasks must overlap (the paper's operators block off-GIL)."""
    pool = WorkerPool(max_workers=8)
    t0 = time.perf_counter()
    pool.run_tasks([lambda: time.sleep(0.05) for _ in range(8)])
    assert time.perf_counter() - t0 < 0.05 * 8 * 0.6
    pool.shutdown()


# ---------------------------------------------------------------- nesting


def test_nested_submission_does_not_deadlock():
    """A task that submits its own subgroup (hierarchical phase 1 calling
    stealing_reduce) must complete even when the pool is smaller than the
    total task tree."""
    pool = WorkerPool(max_workers=2)

    def segment(i):
        return sum(pool.run_tasks([lambda j=j: i * 10 + j for j in range(4)]))

    out = pool.run_tasks([lambda i=i: segment(i) for i in range(4)])
    assert out == [sum(i * 10 + j for j in range(4)) for i in range(4)]
    pool.shutdown()


def test_fair_admission_interleaves_groups():
    """A long group submitted first must not starve a later short one:
    round-robin claiming lets the short series finish while the long one
    is still running (the multi-tenant fairness property)."""
    pool = WorkerPool(max_workers=2)
    finished = {}

    def client(name, count):
        pool.run_tasks([lambda: time.sleep(0.02) for _ in range(count)])
        finished[name] = time.perf_counter()

    long_c = threading.Thread(target=client, args=("long", 24))
    long_c.start()
    time.sleep(0.03)  # the long group is already queued and running
    short_c = threading.Thread(target=client, args=("short", 2))
    short_c.start()
    long_c.join()
    short_c.join()
    assert finished["short"] < finished["long"]
    pool.shutdown()


# ------------------------------------------------------- occupancy/tenancy


def test_occupancy_reflects_demand():
    pool = WorkerPool(max_workers=2)
    assert pool.occupancy() == 0.0
    gate = threading.Event()
    runner = threading.Thread(
        target=lambda: pool.run_tasks([gate.wait for _ in range(6)])
    )
    runner.start()
    for _ in range(100):
        if pool.occupancy() >= 1.0:
            break
        time.sleep(0.01)
    # 6 blocked tasks over capacity 2 (some claimed, some queued).
    assert pool.occupancy() >= 1.0
    gate.set()
    runner.join()
    assert pool.occupancy() == 0.0
    pool.shutdown()


def test_occupancy_counts_helper_claimed_tasks():
    """Regression: tasks the submitting caller claims while helping are
    demand too — a pool saturated by helping callers must not read idle."""
    pool = WorkerPool(max_workers=1)
    gate = threading.Event()
    runner = threading.Thread(
        target=lambda: pool.run_tasks([gate.wait, gate.wait])
    )
    runner.start()
    for _ in range(100):
        if pool.occupancy() >= 2.0:
            break
        time.sleep(0.01)
    # 1 task on the worker + 1 claimed by the helping caller, capacity 1.
    assert pool.occupancy() >= 2.0
    gate.set()
    runner.join()
    pool.shutdown()


def test_tenancy_counts_and_reentrancy():
    pool = WorkerPool(max_workers=2)
    assert pool.tenants() == 0
    with pool.tenant():
        assert pool.tenants() == 1
        with pool.tenant():  # same thread: no double count
            assert pool.tenants() == 1
    assert pool.tenants() == 0

    seen = []

    def other():
        with pool.tenant():
            seen.append(pool.tenants())
            time.sleep(0.05)

    with pool.tenant():
        t = threading.Thread(target=other)
        t.start()
        time.sleep(0.02)
        assert pool.tenants() == 2  # two concurrent series
        t.join()
    assert seen == [2]
    pool.shutdown()


def test_default_pool_is_shared_and_replaceable():
    try:
        p1 = get_default_pool()
        assert get_default_pool() is p1
        mine = WorkerPool(max_workers=2, name="test")
        set_default_pool(mine)
        assert get_default_pool() is mine
    finally:
        set_default_pool(None)
    fresh = get_default_pool()
    assert fresh is not mine


def test_shutdown_rejects_new_work():
    pool = WorkerPool(max_workers=2)
    pool.run_tasks([lambda: 1])
    pool.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        pool.run_tasks([lambda: 1])


# ------------------------------------------------ pools injected into scans


def test_stealing_reduce_runs_on_injected_pool():
    from repro_torch.core.work_stealing import stealing_reduce

    pool = WorkerPool(max_workers=4, name="inj")
    xs = [(i % 7 + 1, i) for i in range(24)]
    op = lambda a, b: (a[0] * b[0] % 1000003, (a[1] * b[0] + b[1]) % 1000003)
    before = pool.tasks_completed
    partials, stats = stealing_reduce(op, xs, 3, pool=pool)
    assert pool.tasks_completed == before + 3  # one task per worker
    assert len(partials) == 3
    pool.shutdown()


def test_hierarchical_scan_runs_on_injected_pool():
    from repro_torch.core.engine import scan

    pool = WorkerPool(max_workers=8, name="inj2")
    xs = [(i % 7 + 1, i) for i in range(32)]
    op = lambda a, b: (a[0] * b[0] % 1000003, (a[1] * b[0] + b[1]) % 1000003)
    ys = scan(op, list(xs), backend="hierarchical", num_segments=4,
              num_threads=2, pool=pool)
    acc = xs[0]
    ref = [acc]
    for x in xs[1:]:
        acc = op(acc, x)
        ref.append(acc)
    assert ys == ref
    assert pool.tasks_completed > 0
    assert pool.groups_submitted >= 2  # segment reduces + interval applies
    pool.shutdown()


# ------------------------------------------------------- priority lanes


def test_claim_order_prefers_higher_lane_then_round_robins():
    """White-box: the claim loop drains the highest non-empty priority
    lane exclusively, round-robin *within* the lane, before touching
    lower lanes."""
    from repro_torch.runtime.scheduler import _TaskGroup

    pool = WorkerPool(max_workers=0, name="lane-test")
    lo_a = _TaskGroup([lambda: "la"] * 2, "lo_a", priority=0)
    lo_b = _TaskGroup([lambda: "lb"] * 2, "lo_b", priority=0)
    hi = _TaskGroup([lambda: "hi"] * 2, "hi", priority=10)
    order = []
    with pool._cond:
        pool._groups.extend([lo_a, lo_b, hi])
        claim = pool._claim_locked()
        while claim is not None:
            group, _ = claim
            order.append(group.label)
            claim = pool._claim_locked()
    assert order[:2] == ["hi", "hi"]          # high lane drained first
    assert sorted(order[2:]) == ["lo_a"] * 2 + ["lo_b"] * 2
    assert order[2] != order[3]               # round-robin within the lane
    pool.shutdown()


def test_late_high_priority_group_jumps_queued_low_work():
    """A high-priority group submitted after low work is queued is claimed
    at the next yield point, ahead of the remaining low tasks."""
    from repro_torch.runtime.scheduler import _TaskGroup

    pool = WorkerPool(max_workers=0, name="lane-test2")
    lo = _TaskGroup([lambda: "lo"] * 4, "lo", priority=0)
    with pool._cond:
        pool._groups.append(lo)
        first, _ = pool._claim_locked()
        assert first.label == "lo"
        pool._groups.append(_TaskGroup([lambda: "hi"], "hi", priority=5))
        jumped, _ = pool._claim_locked()
        assert jumped.label == "hi"
    pool.shutdown()


def test_run_tasks_inherits_and_propagates_priority():
    """Tasks observe their group's priority via current_priority(), and
    nested submissions inherit it — on workers and on helping callers."""
    from repro_torch.runtime.scheduler import at_priority, current_priority

    pool = WorkerPool(max_workers=2, name="prio-inherit")
    seen = {}

    def outer():
        seen["outer"] = current_priority()
        pool.run_tasks(
            [lambda: seen.setdefault("nested", current_priority())],
            label="nested",
        )

    pool.run_tasks([outer], label="outer", priority=7)
    assert seen == {"outer": 7, "nested": 7}

    assert current_priority() == 0
    with at_priority(3):
        assert current_priority() == 3
        seen2 = pool.run_tasks([current_priority], label="ctx")
        with at_priority(9):
            assert current_priority() == 9
        assert current_priority() == 3
    assert current_priority() == 0
    assert seen2 == [3]
    pool.shutdown()


def test_priority_zero_default_keeps_fair_admission():
    """Default submissions all land in lane 0 and keep the existing fair
    round-robin interleave (no behaviour change for non-serving callers)."""
    pool = WorkerPool(max_workers=1, name="lane0")
    starts = []
    barrier = threading.Event()

    def make(tag):
        def fn():
            starts.append(tag)
            barrier.wait(5)
        return fn

    ta = threading.Thread(
        target=lambda: pool.run_tasks([make("a")] * 3, label="ga"))
    tb = threading.Thread(
        target=lambda: pool.run_tasks([make("b")] * 3, label="gb"))
    ta.start(); tb.start()
    time.sleep(0.15)
    barrier.set()
    ta.join(10); tb.join(10)
    # Both groups made progress interleaved; nothing starved.
    assert sorted(starts) == ["a"] * 3 + ["b"] * 3
    pool.shutdown()
