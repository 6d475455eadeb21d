"""Port parity: the scan engine (``repro_torch.core.engine``) against
``repro.core.engine``: the dispatcher's decisions, the copied plan and
circuit modules, and each ported backend's prefixes on seeded composition
scans (atol=1e-5).  The backends of later slices must raise."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.deformation as rdef
import repro_torch.core.deformation as tdef
from repro.core.engine import dispatch as ref_dispatch, get_plan as ref_get_plan
from repro.core.engine import scan as ref_scan
from repro_torch.analysis import sync
from repro_torch.core.engine import dispatch, get_plan, scan
from repro_torch.core.engine import hierarchical
from repro_torch.core.work_stealing import rebalance_boundaries, stealing_reduce
from repro_torch.interop import deformation_from_numpy
from repro_torch.runtime import scheduler

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    # One intra-op thread: the suite runs several test processes at once,
    # and small tensors gain nothing from more.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    pool = scheduler.get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    scheduler.set_default_pool(None)


def _elements(n, seed):
    rng = np.random.default_rng(seed)
    return [
        {"angle": np.float32(rng.uniform(-0.05, 0.05)),
         "shift": rng.uniform(-3, 3, 2).astype(np.float32)}
        for _ in range(n)
    ]


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return deformation_from_numpy(d)


def _assert_prefixes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("angle", "shift"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=ATOL)


# ------------------------------------------------------------- dispatcher

GRID = dict(
    n=[1, 2, 9, 33, 64, 300, 2048],
    op_cost=[None, 1e-6, 1e-3, 1e-2],
    workers=[None, 1, 4, 16, 32],
    op_imbalance=[None, 1.0, 3.0],
    pool_occupancy=[None, 0.5, 1.5],
    op_batchable=[None, True],
)


@pytest.mark.parametrize("domain", ["element", "array"])
@pytest.mark.parametrize("accel", [False, True])
@pytest.mark.parametrize("devices", [None, 1, 4])
def test_dispatch_matches_reference(domain, accel, devices):
    keys = list(GRID)
    for vals in itertools.product(*GRID.values()):
        kw = dict(zip(keys, vals))
        n = kw.pop("n")
        got = dispatch(n, domain=domain, accel=accel, devices=devices, **kw)
        want = ref_dispatch(n, domain=domain, accel=accel, devices=devices, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (n, kw)


@pytest.mark.parametrize("alg", ["sequential", "dissemination", "ladner_fischer",
                                 "brent_kung", "sklansky", "blelloch"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_copied_plan_matches_reference(alg, n):
    p, r = get_plan(alg, n), ref_get_plan(alg, n)
    assert p.num_rounds() == r.num_rounds() and p.work() == r.work()
    for a, b in zip(p.rounds, r.rounds):
        assert a.combines == b.combines and a.moves == b.moves
        assert a.capture_total == b.capture_total


# ------------------------------------------------ element-domain backends

BACKENDS = [
    ("element", {}),
    ("worksteal", {"num_threads": 3}),
    ("hierarchical", {"num_segments": 2, "num_threads": 2, "cross_steal": True}),
    ("hierarchical", {"num_segments": 2, "num_threads": 2, "cross_steal": False}),
    ("hierarchical", {"num_segments": 3, "num_threads": 2}),
]


@pytest.mark.parametrize("backend,opts", BACKENDS)
@pytest.mark.parametrize("n", [7, 16])
@pytest.mark.parametrize("seeded", [False, True])
def test_element_backends_match_reference(backend, opts, n, seeded):
    elems = _elements(n, seed=n)
    seed = _elements(1, seed=99)[0] if seeded else None
    kw = dict(backend=backend, **opts)
    want = ref_scan(rdef.compose, [_j(e) for e in elems],
                    seed=_j(seed) if seeded else None, **kw)
    got = scan(tdef.compose, [_t(e) for e in elems],
               seed=_t(seed) if seeded else None, **kw)
    _assert_prefixes(got, want)


@pytest.mark.parametrize("n", [7, 16])
def test_simulate_backend_matches_reference(n):
    elems = _elements(n, seed=n)
    want = ref_scan(rdef.compose, [_j(e) for e in elems], backend="simulate")
    got = scan(tdef.compose, [_t(e) for e in elems], backend="simulate")
    _assert_prefixes(got, want)


def test_hierarchical_stats_recorded():
    elems = [_t(e) for e in _elements(12, 3)]
    scan(tdef.compose, elems, backend="hierarchical", num_segments=3,
         num_threads=2, cross_steal=True)
    st = hierarchical.last_stats
    assert st.num_segments == 3 and st.threads_per_segment == 2
    assert set(st.phase_seconds) == {"reduce", "global", "apply"}
    assert st.total_ops > 0


def test_cost_dispatch_picks_worksteal_for_expensive_op():
    class Op:
        op_cost_estimate = 1.0

        def __call__(self, a, b):
            return tdef.compose(a, b)

    elems = [_t(e) for e in _elements(9, 4)]
    want = ref_scan(rdef.compose, [_j(e) for e in _elements(9, 4)],
                    backend="element")
    _assert_prefixes(scan(Op(), elems, workers=4), want)


# ------------------------------------------------- array-domain backends

@pytest.mark.parametrize("alg", ["ladner_fischer", "dissemination", "blelloch", "sklansky"])
@pytest.mark.parametrize("n", [6, 16])
def test_vector_backend_matches_reference(alg, n):
    elems = _elements(n, seed=7)
    stack = {k: np.stack([e[k] for e in elems]) for k in ("angle", "shift")}
    want = ref_scan(rdef.compose_batched, _j(stack), backend="vector", algorithm=alg)
    got = scan(tdef.compose_batched, _t(stack), backend="vector", algorithm=alg)
    for k in ("angle", "shift"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL)


@pytest.mark.parametrize("strategy", ["reduce_then_scan", "scan_then_map"])
def test_blocked_backend_matches_reference(strategy):
    elems = _elements(12, seed=8)
    stack = {k: np.stack([e[k] for e in elems]) for k in ("angle", "shift")}
    want = ref_scan(rdef.compose_batched, _j(stack), backend="blocked",
                    num_blocks=4, strategy=strategy)
    got = scan(tdef.compose_batched, _t(stack), backend="blocked",
               num_blocks=4, strategy=strategy)
    for k in ("angle", "shift"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL)


def test_where_mask_matches_reference():
    elems = _elements(9, seed=9)
    where = [True, False, True, True, False, True, True, True, False]
    want = ref_scan(rdef.compose, [_j(e) for e in elems], backend="element", where=where)
    got = scan(tdef.compose, [_t(e) for e in elems], backend="element", where=where)
    _assert_prefixes(got, want)


def test_argument_checks_match_reference():
    elems = [_t(e) for e in _elements(4, 1)]
    with pytest.raises(NotImplementedError):
        scan(tdef.compose, elems, backend="worksteal", where=[True] * 4)
    with pytest.raises(NotImplementedError):
        scan(tdef.compose, elems, backend="vector", seed=elems[0])
    with pytest.raises(ValueError, match="unknown scan backend"):
        scan(tdef.compose, elems, backend="nope")
    assert scan(tdef.compose, []) == []
    one = scan(tdef.compose, elems[:1], seed=elems[1], backend="element")
    _assert_prefixes(one, [rdef.compose(_j(_elements(4, 1)[1]), _j(_elements(4, 1)[0]))])


# ------------------------------------------- backends of later slices

@pytest.mark.parametrize("name", ["collective", "sharded"])
def test_unported_backends_raise(name):
    """The two backends that were stubs until they were ported raise on
    the same misuse as the reference's: ``collective`` outside a shard_map
    with no axis, ``sharded`` with a mask of the wrong length."""
    elems = _elements(4, 2)
    stack = {k: np.stack([e[k] for e in elems]) for k in ("angle", "shift")}
    kw = {"where": [True] * 3} if name == "sharded" else {}
    match = "where mask length" if name == "sharded" else "axis_name"
    with pytest.raises(ValueError, match=match):
        ref_scan(rdef.compose_batched, _j(stack), backend=name, **kw)
    with pytest.raises(ValueError, match=match):
        scan(tdef.compose_batched, _t(stack), backend=name, **kw)


# ------------------------- hierarchical device phase 1 and array domain

@pytest.mark.parametrize("path", ["device_phase1", "array"])
def test_hierarchical_device_and_array_paths_match_reference(path):
    elems = _elements(8, 2)
    if path == "device_phase1":
        want = ref_scan(rdef.compose_batched, [_j(e) for e in elems],
                        backend="hierarchical", device_phase1=True,
                        num_segments=2)
        got = scan(tdef.compose_batched, [_t(e) for e in elems],
                   backend="hierarchical", device_phase1=True, num_segments=2)
        assert hierarchical.last_stats.device_phase1
        _assert_prefixes(got, want)
        return
    stack = {k: np.stack([e[k] for e in elems]) for k in ("angle", "shift")}
    want = ref_scan(rdef.compose_batched, _j(stack), backend="hierarchical",
                    num_segments=2)
    got = scan(tdef.compose_batched, _t(stack), backend="hierarchical",
               num_segments=2)
    for k in ("angle", "shift"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL)


# ----------------------------------------------- work stealing protocol

def test_stealing_reduce_under_invariant_checks():
    """REPRO_CHECK_INVARIANTS keeps working in the port: the claim ledger
    and interval checks run on a real stealing reduce."""
    sync.set_checking(True)
    try:
        items = list(range(1, 41))
        partials, st = stealing_reduce(lambda a, b: a + b, items, 4)
        assert sum(partials) == sum(items)
        lo = [a for a, _ in st.boundaries]
        assert sorted(lo)[0] == 0 and max(b for _, b in st.boundaries) == 39
    finally:
        sync.set_checking(False)


@pytest.mark.parametrize("costs", [[1.0] * 10, [1, 1, 1, 9, 9, 1, 1, 1, 1, 1], [0.0] * 6])
def test_rebalance_boundaries_partition(costs):
    from repro.core.work_stealing import rebalance_boundaries as ref_rb

    bounds = [(0, 2), (3, 5), (6, len(costs) - 1)]
    assert rebalance_boundaries(costs, bounds) == ref_rb(costs, bounds)
