"""The hierarchical backend in the port: the reference's element-domain,
dispatch and telemetry tests (tests/test_hierarchical.py), run against
``repro_torch.core.engine``; and its array domain, batched device phase 1
and tile kernels (plain versions, ``repro_torch.kernels.tile_scan``) held
against the reference package on the same numpy inputs — the reference's
tile kernels in interpret mode."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.circuits import get_circuit
from repro_torch.core.engine import (
    OpTelemetry,
    dispatch,
    op_cost_from,
    scan,
)
from repro_torch.core.engine.hierarchical import segment_bounds
from repro_torch.core.scan import python_exec
from repro_torch.runtime import scheduler


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    yield
    pool = scheduler.get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    scheduler.set_default_pool(None)


def _affine_op(a, b):
    """Non-commutative — any reordering the executor tries would show."""
    return (a[0] * b[0] % 1000003, (a[1] * b[0] + b[1]) % 1000003)


def _delays(profile, n, base=0.0004):
    if profile == "uniform":
        return [base] * n
    if profile == "ramp":
        return [base * (0.2 + 1.6 * i / max(n - 1, 1)) for i in range(n)]
    if profile == "straggler":
        d = [base] * n
        d[n // 2] = base * 40
        return d
    raise ValueError(profile)


def _sleepy_op(delays):
    def op(a, b):
        time.sleep(delays[b[1] % len(delays)])
        return _affine_op(a, b)

    return op



# ---------------------------------------------------------------- element


@pytest.mark.parametrize("n", list(range(1, 18)) + [64])
def test_element_matches_oracle(n):
    xs = [(i % 7 + 1, i) for i in range(n)]
    ref, _ = python_exec(_affine_op, get_circuit("ladner_fischer", max(n, 1)), xs)
    for s, t in [(2, 2), (4, 2), (3, 3)]:
        ys = scan(_affine_op, list(xs), backend="hierarchical",
                  num_segments=s, num_threads=t)
        assert ys == ref, (n, s, t)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("profile", ["uniform", "ramp", "straggler"])
@pytest.mark.parametrize("n", [13, 64])
def test_element_matches_oracle_under_cost_profiles(profile, n, cross):
    """Scheduling under real imbalance (sleeps) must not change results —
    with and without cross-segment stealing."""
    xs = [(i % 7 + 1, i) for i in range(n)]
    ref, _ = python_exec(_affine_op, get_circuit("ladner_fischer", n), xs)
    ys = scan(_sleepy_op(_delays(profile, n)), list(xs),
              backend="hierarchical", num_segments=4, num_threads=2,
              cross_steal=cross)
    assert ys == ref, (profile, n, cross)


def test_stats_partition_and_phases():
    n = 64
    xs = [(i % 7 + 1, i) for i in range(n)]
    scan(_sleepy_op(_delays("straggler", n)), list(xs),
         backend="hierarchical", num_segments=4, num_threads=2)
    from repro_torch.core.engine import hierarchical

    st = hierarchical.last_stats
    assert st is not None and st.num_segments == 4
    assert st.segment_bounds[0][0] == 0 and st.segment_bounds[-1][1] == n - 1
    covered = sorted(i for lo, hi in st.intervals for i in range(lo, hi + 1))
    assert covered == list(range(n))  # intervals partition [0, N)
    assert set(st.phase_seconds) == {"reduce", "global", "apply"}


def test_segment_bounds_cover():
    for n in range(1, 40):
        for s in range(1, min(n, 9) + 1):
            b = segment_bounds(n, s)
            assert b[0][0] == 0 and b[-1][1] == n - 1
            assert all(l2 == h1 + 1 for (_, h1), (l2, _) in zip(b, b[1:]))


# ---------------------------------------------------- cross-segment stealing


def test_cross_steal_stats_and_partition():
    """Under a straggler-segment profile, neighbours must actually claim
    elements across the shared boundary gaps, and the final intervals must
    still partition [0, N)."""
    n = 64
    delays = [0.0005] * n
    for i in range(n // 4, n // 2):  # second segment is the straggler
        delays[i] = 0.0005 * 16
    xs = [(i % 7 + 1, i) for i in range(n)]
    ref, _ = python_exec(_affine_op, get_circuit("ladner_fischer", n), xs)
    ys = scan(_sleepy_op(delays), list(xs), backend="hierarchical",
              num_segments=4, num_threads=2, cross_steal=True)
    assert ys == ref
    from repro_torch.core.engine import hierarchical

    st = hierarchical.last_stats
    assert st.cross_steal
    assert st.total_inter_segment_steals() > 0
    assert len(st.inter_segment_steals) == st.num_segments
    covered = sorted(i for lo, hi in st.intervals for i in range(lo, hi + 1))
    assert covered == list(range(n))
    assert st.segment_bounds[0][0] == 0 and st.segment_bounds[-1][1] == n - 1
    for (_, h1), (l2, _) in zip(st.segment_bounds, st.segment_bounds[1:]):
        assert l2 == h1 + 1  # dynamic bounds stay a contiguous partition


def test_cross_steal_off_keeps_static_bounds():
    n = 64
    xs = [(i % 7 + 1, i) for i in range(n)]
    scan(_affine_op, list(xs), backend="hierarchical", num_segments=4,
         num_threads=2, cross_steal=False)
    from repro_torch.core.engine import hierarchical

    st = hierarchical.last_stats
    assert not st.cross_steal
    assert st.segment_bounds == segment_bounds(n, 4)
    assert st.total_inter_segment_steals() == 0


def test_cross_steal_infeasible_falls_back():
    """Too few elements to seat every worker mid-range: the executor must
    silently fall back to static segments, still correct."""
    xs = [(i % 7 + 1, i) for i in range(6)]
    ref, _ = python_exec(_affine_op, get_circuit("ladner_fischer", 6), xs)
    ys = scan(_affine_op, list(xs), backend="hierarchical", num_segments=3,
              num_threads=3, cross_steal=True)
    assert ys == ref


def test_aot_segment_sizing_from_element_costs():
    """Explicit per-element costs shrink the expensive stretch's segment
    ahead of time (equal cost, not equal count)."""
    n = 64
    costs = [1.0] * n
    for i in range(n // 2):
        costs[i] = 8.0  # first half 8x as expensive
    xs = [(i % 7 + 1, i) for i in range(n)]
    ref, _ = python_exec(_affine_op, get_circuit("ladner_fischer", n), xs)
    ys = scan(_affine_op, list(xs), backend="hierarchical", num_segments=4,
              num_threads=2, cross_steal=False, element_costs=costs)
    assert ys == ref
    from repro_torch.core.engine import hierarchical

    st = hierarchical.last_stats
    assert st.rebalanced
    sizes = [hi - lo + 1 for lo, hi in st.segment_bounds]
    # Expensive half is covered by more (smaller) segments than the cheap
    # half: the first segment must be smaller than the last.
    assert sizes[0] < sizes[-1]
    loads = [sum(costs[lo: hi + 1]) for lo, hi in st.segment_bounds]
    assert max(loads) / min(loads) < 3.0  # was 8x with an even split


def test_aot_segment_sizing_from_operator_history():
    """An operator exposing ``element_cost_estimates`` drives sizing with
    no explicit hint — the telemetry-closed loop."""
    n = 32

    class HistoryOp:
        def element_cost_estimates(self, m):
            return [4.0] * (m // 2) + [1.0] * (m - m // 2)

        def __call__(self, a, b):
            return _affine_op(a, b)

    xs = [(i % 7 + 1, i) for i in range(n)]
    ref, _ = python_exec(_affine_op, get_circuit("ladner_fischer", n), xs)
    ys = scan(HistoryOp(), list(xs), backend="hierarchical", num_segments=4,
              num_threads=2, cross_steal=False)
    assert ys == ref
    from repro_torch.core.engine import hierarchical

    assert hierarchical.last_stats.rebalanced


def test_hierarchical_total_ops_exact():
    """HierStats.total_ops == exact operator applications (the previously
    uncounted phase-3 seed combines included), cross modes and seeds."""
    from repro_torch.core.engine.hierarchical import exec_hierarchical
    from repro_torch.core.engine import get_plan, hierarchical

    n = 48
    xs = [(i % 5 + 1, i) for i in range(n)]
    for cross in [False, True]:
        for seed in [None, (3, 7)]:
            calls = []

            def op(a, b):
                calls.append(1)
                return _affine_op(a, b)

            ys, _total = exec_hierarchical(
                op, get_plan("ladner_fischer", 4), list(xs),
                num_segments=4, num_threads=2, seed=seed, cross_steal=cross,
            )
            st = hierarchical.last_stats
            assert st.total_ops == len(calls), (cross, seed)
            assert st.total_ops <= 3 * n
            acc = seed
            ref = []
            for x in xs:
                acc = x if acc is None else _affine_op(acc, x)
                ref.append(acc)
            assert ys == ref, (cross, seed)


# ------------------------------------------------- dispatch + telemetry


def test_dispatch_hierarchical_at_scale():
    d = dispatch(256, domain="element", op_cost=10.0, workers=32)
    assert d.backend == "hierarchical"
    assert d.num_segments and d.num_segments >= 2
    assert d.num_threads and d.num_threads >= 2
    # Below the worker threshold the single-level stealing executor stays.
    assert dispatch(64, domain="element", op_cost=10.0,
                    workers=4).backend == "worksteal"


def test_dispatch_cross_steal_rule():
    """Cross-segment stealing: on while imbalance is unobserved (insurance),
    off once telemetry shows a balanced operator, on again past the
    threshold."""
    base = dict(domain="element", op_cost=10.0, workers=32)
    assert dispatch(256, **base).cross_steal is True
    assert dispatch(256, **base, op_imbalance=1.05).cross_steal is False
    assert dispatch(256, **base, op_imbalance=3.0).cross_steal is True
    d = dispatch(256, **base, op_imbalance=1.05)
    assert "cross-segment=off" in d.reason


def test_op_imbalance_and_element_costs_sniffing():
    from repro_torch.core.engine import element_costs_from, op_imbalance_from

    class FakeOp:
        op_imbalance_estimate = 2.5
        element_cost_estimates = staticmethod(lambda n: [1.0] * n)

    assert op_imbalance_from(FakeOp()) == 2.5
    assert op_imbalance_from(lambda a, b: a) is None
    assert element_costs_from(FakeOp(), 7) == [1.0] * 7
    assert element_costs_from(lambda a, b: a, 7) is None

    class PartialHistory:
        element_cost_estimates = [1.0, 2.0]  # wrong length -> unusable

    assert element_costs_from(PartialHistory(), 7) is None


def test_telemetry_ema_and_feedback():
    tel = OpTelemetry(name="t", ema_alpha=0.5)
    assert tel.estimate() is None
    tel.record(1.0)
    tel.record(0.0)
    assert tel.calls == 2 and abs(tel.estimate() - 0.5) < 1e-9
    assert tel.imbalance() == pytest.approx(2.0)

    class FakeOp:
        op_cost_estimate = 0.5

    assert op_cost_from(FakeOp()) == 0.5
    assert op_cost_from(lambda a, b: a) is None


def test_scan_consults_operator_telemetry():
    """An operator carrying a telemetry estimate routes like an op_cost hint."""
    calls = []

    class CountingOp:
        op_cost_estimate = 10.0  # expensive -> stealing reduce-then-scan

        def __call__(self, a, b):
            calls.append(1)
            return _affine_op(a, b)

    xs = [(i % 7 + 1, i) for i in range(32)]
    ref, _ = python_exec(_affine_op, get_circuit("ladner_fischer", 32), xs)
    ys = scan(CountingOp(), list(xs), workers=4)
    assert ys == ref
    # reduce-then-scan work ~2N (< 100), below the flat Ladner–Fischer
    # circuit's ~129 applications at N=32 — proves the cost hint was used.
    assert len(calls) < 100


# ------------------------------------------- array domain vs the reference

from repro.core.engine import scan as ref_scan  # noqa: E402
import repro.core.deformation as rdef  # noqa: E402
import repro.kernels._tiling as rtiling  # noqa: E402
import repro.kernels.tile_scan as rts  # noqa: E402
import repro_torch.core.deformation as tdef  # noqa: E402
import repro_torch.kernels._tiling as ttiling  # noqa: E402
import repro_torch.kernels.tile_scan as tts  # noqa: E402
from repro_torch.core.engine import DEVICE_PHASE1_MIN_N  # noqa: E402
from repro_torch.core.engine import hierarchical as thier  # noqa: E402


def _rigid_ops():
    """compose_batched on packed [angle, s0, s1] rows, in both packages."""
    d = {"angle": np.zeros(2, np.float32), "shift": np.zeros((2, 2), np.float32)}
    _, tspec = ttiling.pack_leaves({k: torch.as_tensor(v) for k, v in d.items()})
    _, rspec = rtiling.pack_leaves({k: jnp.asarray(v) for k, v in d.items()})
    return (ttiling.packed_op(tdef.compose_batched, tspec),
            rtiling.packed_op(rdef.compose_batched, rspec))


def _rows(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "add":
        return rng.integers(-9, 10, (n, 2)).astype(np.float32)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    x[:, 0] *= 0.05
    return x


def _ops(kind):
    return (torch.add, jnp.add) if kind == "add" else _rigid_ops()


def _close(kind, got, want):
    if kind == "add":  # integer-valued: exact under any grouping
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:  # the reference's compose tolerance (tests/test_decoupled.py)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["add", "rigid"])
@pytest.mark.parametrize("n,t", [(64, 4), (60, 6), (16, 16), (12, 1)])
def test_tile_local_scan_plain_matches_reference_kernel(kind, n, t):
    x = _rows(kind, n, seed=n + t)
    top, rop = _ops(kind)
    local, partials = tts.tile_local_scan(top, torch.as_tensor(x), t)
    wlocal, wpartials = rts.tile_local_scan(rop, jnp.asarray(x), t,
                                            interpret=True)
    assert local.shape == wlocal.shape and partials.shape == wpartials.shape
    _close(kind, local, wlocal)
    _close(kind, partials, wpartials)


@pytest.mark.parametrize("kind", ["add", "rigid"])
@pytest.mark.parametrize("t,k", [(4, 16), (3, 5), (1, 8)])
def test_tile_apply_plain_matches_reference_kernel(kind, t, k):
    local = _rows(kind, t * k, seed=t * k).reshape(t, k, -1)
    seeds = _rows(kind, t, seed=t + 100)
    top, rop = _ops(kind)
    got = tts.tile_apply(top, torch.as_tensor(local), torch.as_tensor(seeds))
    want = rts.tile_apply(rop, jnp.asarray(local), jnp.asarray(seeds),
                          interpret=True)
    assert got.shape == want.shape
    _close(kind, got, want)
    np.testing.assert_array_equal(got[:k].numpy(), local[0])  # tile 0 passes


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("use_pallas", [None, True])
def test_array_matches_reference(s, use_pallas):
    n = 64
    x = np.arange(1.0, n + 1.0, dtype=np.float32)
    want = ref_scan(jnp.add, jnp.asarray(x), backend="hierarchical",
                    num_segments=s, use_pallas=bool(use_pallas),
                    interpret=True)
    got = scan(torch.add, torch.as_tensor(x), backend="hierarchical",
               num_segments=s, use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.cumsum(x), rtol=1e-6)


def test_array_pytree_matches_reference():
    n = 16
    a, b = np.arange(float(n), dtype=np.float32), np.ones((n, 2), np.float32)
    want = ref_scan(lambda u, v: jax.tree.map(jnp.add, u, v),
                    {"a": jnp.asarray(a), "b": jnp.asarray(b)},
                    backend="hierarchical", num_segments=4)
    got = scan(lambda u, v: {k: u[k] + v[k] for k in u},
               {"a": torch.as_tensor(a), "b": torch.as_tensor(b)},
               backend="hierarchical", num_segments=4)
    for k in ("a", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    np.testing.assert_allclose(got["b"][-1].numpy(), [n, n])


@pytest.mark.parametrize("s", [2, 4])
def test_array_compose_matches_reference(s):
    rng = np.random.default_rng(s)
    d = {"angle": (rng.normal(size=24) * 0.05).astype(np.float32),
         "shift": rng.normal(size=(24, 2)).astype(np.float32)}
    want = ref_scan(rdef.compose_batched,
                    {k: jnp.asarray(v) for k, v in d.items()},
                    backend="hierarchical", num_segments=s)
    got = scan(tdef.compose_batched,
               {k: torch.as_tensor(v) for k, v in d.items()},
               backend="hierarchical", num_segments=s)
    for k in ("angle", "shift"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def test_array_indivisible_segments_raise():
    with pytest.raises(ValueError, match="divide"):
        scan(torch.add, torch.arange(10.0), backend="hierarchical",
             num_segments=4)
    with pytest.raises(NotImplementedError, match="element-domain"):
        thier.exec_hierarchical(torch.add, None, torch.arange(8.0),
                                num_segments=2, seed=torch.tensor(1.0))


def _batchable_add():
    op = lambda a, b: a + b
    op.op_batchable = True
    op.op_identity = lambda: torch.zeros((4,))
    return op


@pytest.mark.parametrize("use_pallas", [None, True])
@pytest.mark.parametrize("seeded", [False, True])
def test_device_phase1_matches_reference(use_pallas, seeded):
    rop = lambda a, b: a + b
    rop.op_batchable = True
    rop.op_identity = lambda: jnp.zeros((4,))
    top = _batchable_add()
    top.kernel_op = "add"
    vals = [np.full((4,), float(i + 1), np.float32) for i in range(96)]
    seed = np.full((4,), 100.0, np.float32)
    want = ref_scan(rop, [jnp.asarray(v) for v in vals],
                    backend="hierarchical", device_phase1=True,
                    num_segments=6,
                    seed=jnp.asarray(seed) if seeded else None)
    got = scan(top, [torch.as_tensor(v) for v in vals],
               backend="hierarchical", device_phase1=True, num_segments=6,
               use_pallas=use_pallas,
               seed=torch.as_tensor(seed) if seeded else None)
    st = thier.last_stats
    assert st.device_phase1 and st.threads_per_segment == 0
    assert st.num_segments == 6 and set(st.phase_seconds) == {
        "stack", "device", "unstack"}
    assert isinstance(got, list) and len(got) == 96
    np.testing.assert_allclose(np.stack([g.numpy() for g in got]),
                               np.stack([np.asarray(w) for w in want]),
                               rtol=1e-6)
    want_sum = np.cumsum(np.arange(1.0, 97.0)) + (100.0 if seeded else 0.0)
    np.testing.assert_allclose([float(g[0]) for g in got], want_sum,
                               rtol=1e-6)


def test_device_phase1_compose_matches_reference():
    rng = np.random.default_rng(21)
    elems = [{"angle": np.float32(rng.normal() * 0.05),
              "shift": rng.normal(size=2).astype(np.float32)}
             for _ in range(30)]
    want = ref_scan(rdef.compose_batched,
                    [{k: jnp.asarray(v) for k, v in e.items()} for e in elems],
                    backend="hierarchical", device_phase1=True,
                    num_segments=4)
    got = scan(tdef.compose_batched,
               [{k: torch.as_tensor(v) for k, v in e.items()} for e in elems],
               backend="hierarchical", device_phase1=True, num_segments=4)
    assert thier.last_stats.device_phase1
    for g, w in zip(got, want):
        for k in ("angle", "shift"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=1e-5, atol=1e-6)


def test_device_phase1_unstackable_falls_back_to_threads():
    xs = [(i % 7 + 1, i) for i in range(16)]
    ref, _ = python_exec(_affine_op, get_circuit("ladner_fischer", 16), xs)
    ys = scan(_affine_op, list(xs), backend="hierarchical",
              device_phase1=True, num_segments=2, num_threads=2)
    assert ys == ref and not thier.last_stats.device_phase1


def test_dispatch_runs_device_phase1_for_cheap_batchable_ops():
    n = max(256, DEVICE_PHASE1_MIN_N)
    xs = [torch.full((4,), float(i + 1)) for i in range(n)]
    ys = scan(_batchable_add(), xs, op_cost=1e-5)
    assert thier.last_stats.device_phase1
    np.testing.assert_allclose([float(y[0]) for y in ys],
                               np.cumsum(np.arange(1.0, n + 1.0)), rtol=1e-6)
