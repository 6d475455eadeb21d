"""Counterpart of ``tests/test_engine_dispatch.py`` for the port: the
cost-model dispatcher, plan caching through ``scan()`` and the API's edge
cases in ``repro_torch.core.engine``, with the reference test's inputs and
expectations."""

import time

import numpy as np
import pytest
import torch

from repro_torch.core.engine import (
    EXPENSIVE_OP_COST,
    dispatch,
    measure_op_cost,
    plan_cache,
    register_backend,
    scan,
)
from repro_torch.core.scan import prefix_scan
from repro_torch.runtime import scheduler


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    yield
    pool = scheduler.get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    scheduler.set_default_pool(None)


# ------------------------------------------------------------------ dispatch
def test_cheap_array_op_goes_vector():
    d = dispatch(256, domain="array")
    assert d.backend == "vector"
    assert d.algorithm == "ladner_fischer"  # depth-optimal for cheap ops


def test_large_cheap_array_goes_blocked():
    d = dispatch(1 << 20, domain="array", workers=4)
    assert d.backend == "blocked"
    assert d.strategy == "reduce_then_scan"
    assert d.num_blocks and (1 << 20) % d.num_blocks == 0


def test_expensive_array_op_goes_blocked_reduce_then_scan():
    """The paper's rule: when op cost dominates, pick reduce-then-scan."""
    d = dispatch(64, domain="array", op_cost=1.0, workers=4)
    assert d.backend == "blocked"
    assert d.strategy == "reduce_then_scan"


def test_expensive_element_op_goes_worksteal():
    d = dispatch(64, domain="element", op_cost=10.0, workers=4)
    assert d.backend == "worksteal"
    assert d.num_threads == 4
    assert d.algorithm == "dissemination"  # paper §4.3 phase-2 choice


def test_cheap_element_op_stays_element():
    d = dispatch(64, domain="element", op_cost=1e-6, workers=4)
    assert d.backend == "element"


def test_single_worker_never_worksteals():
    d = dispatch(64, domain="element", op_cost=10.0, workers=1)
    assert d.backend == "element"


def test_measure_op_cost_orders_regimes():
    fast = measure_op_cost(lambda a, b: a + b, [1.0, 2.0, 3.0])
    slow = measure_op_cost(
        lambda a, b: (time.sleep(0.01), a + b)[1], [1.0, 2.0, 3.0]
    )
    assert 0 <= fast < slow
    assert slow >= EXPENSIVE_OP_COST


def test_scan_measure_routes_expensive_op():
    """End-to-end: a slow operator measured at scan time -> worksteal."""

    def slow_add(a, b):
        time.sleep(0.006)
        return a + b

    vals = [float(i) for i in range(1, 17)]
    ys = scan(slow_add, vals, measure=True, workers=2)
    np.testing.assert_allclose(ys, np.cumsum(vals))


# ------------------------------------------------------------------- caching
def test_scan_hits_plan_cache_on_second_call():
    plan_cache.clear()
    x = torch.arange(1.0, 42.0)
    y1 = scan(lambda a, b: a + b, x, backend="vector")
    s = plan_cache.stats()
    y2 = scan(lambda a, b: a + b, x, backend="vector")
    s2 = plan_cache.stats()
    assert s2["hits"] > s["hits"] and s2["misses"] == s["misses"]
    np.testing.assert_allclose(y1.numpy(), y2.numpy())


# ------------------------------------------------------------------ API edge
def test_scan_trivial_sizes():
    assert scan(lambda a, b: a + b, []) == []
    assert scan(lambda a, b: a + b, [5.0]) == [5.0]
    x = torch.tensor([3.0])
    np.testing.assert_allclose(scan(lambda a, b: a + b, x).numpy(), [3.0])


def test_scan_matches_prefix_scan_wrapper():
    x = torch.arange(1.0, 34.0)
    a = prefix_scan(torch.maximum, x, algorithm="brent_kung")
    b = scan(torch.maximum, x, backend="vector", algorithm="brent_kung")
    assert torch.equal(a, b)


def test_where_mask_skips_elements():
    x = torch.arange(1.0, 9.0)
    where = [True, True, False, True, True, False, True, True]
    y = scan(lambda a, b: a + b, x, where=where).numpy()
    expect = [1, 3, None, 7, 12, None, 19, 27]  # masked -> identity
    for i, e in enumerate(expect):
        if e is not None:
            assert y[i] == e, (i, y[i], e)


def test_where_mask_rejects_decomposition_backends():
    """blocked/worksteal/pallas-tiles cannot honor masks: explicit -> raise."""
    x = torch.arange(1.0, 17.0)
    where = [True] * 8 + [False] * 8
    for kw in [dict(backend="blocked", num_blocks=4),
               dict(backend="pallas", num_blocks=4)]:
        with pytest.raises(NotImplementedError, match="where masks"):
            scan(lambda a, b: a + b, x, where=where, **kw)
    with pytest.raises(NotImplementedError, match="where masks"):
        scan(lambda a, b: a + b, list(range(16)), where=where,
             backend="worksteal", num_threads=2)


def test_where_mask_survives_auto_dispatch(monkeypatch):
    """When the dispatcher would pick 'blocked', a mask must force the flat
    executor, not be silently dropped."""
    from repro_torch.core.engine import cost

    monkeypatch.setattr(cost, "BLOCKED_MIN_N", 64)
    assert dispatch(64, domain="array").backend == "blocked"  # sanity
    n = 64
    x = torch.ones(n)
    where = [i < n // 2 for i in range(n)]
    y = scan(lambda a, b: a + b, x, where=where).numpy()
    assert y[n // 2 - 1] == n // 2
    assert y[-1] == n // 2  # masked second half contributes nothing


def test_where_mask_rejects_blelloch():
    with pytest.raises(NotImplementedError):
        scan(lambda a, b: a + b, torch.arange(4.0), algorithm="blelloch",
             where=[True, False, True, True])


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown scan backend"):
        scan(lambda a, b: a + b, torch.arange(4.0), backend="nope")


def test_duplicate_backend_registration_raises():
    with pytest.raises(ValueError, match="already registered"):
        register_backend("vector", lambda *a, **k: None)
