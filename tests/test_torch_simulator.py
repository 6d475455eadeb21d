"""The port's discrete-event simulator (``repro_torch.core.simulator``):
the reference's cases of ``tests/test_simulator.py``, then parity with the
reference bit for bit (the model is numpy in float64 over MT19937(1410), so
the two packages must agree exactly), and the ``simulate`` scan backend's
values and virtual-time trace against the reference's on one plan."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.simulator as ref_sim
from repro.core.engine import backends as ref_backends
from repro.core.engine.plan import get_plan as ref_get_plan
import repro_torch.core.simulator as port_sim
from repro_torch.core.engine import backends, scan
from repro_torch.core.engine.plan import get_plan

from repro_torch.core.simulator import (
    NetworkModel,
    constant_costs,
    exponential_costs,
    registration_like_costs,
    simulate_distributed_scan,
    theoretical_bound_full,
    theoretical_bound_scan,
)


def test_cost_models_deterministic():
    a = exponential_costs(1000, mean=10.0)
    b = exponential_costs(1000, mean=10.0)
    np.testing.assert_array_equal(a, b)  # MT19937(1410), like the paper
    assert abs(a.mean() - 10.0) < 1.0
    r = registration_like_costs(4096)
    assert 5.0 < np.median(r) < 12.0 and r.max() > 15.0


def test_serial_equals_sum():
    costs = constant_costs(64, 2.0)
    r = simulate_distributed_scan(costs, ranks=1, threads=1)
    # phase1 = N ops, phase3 = N ops
    assert r.makespan >= costs.sum()


def test_balanced_speedup_close_to_bound():
    """Constant-cost operator: simulated speedup approaches Eq. (5)."""
    n, p = 4096, 64
    costs = constant_costs(n, 1.0)
    serial = (n - 1) * 1.0
    r = simulate_distributed_scan(costs, ranks=p, threads=1,
                                  algorithm="ladner_fischer")
    speedup = serial / r.makespan
    bound = theoretical_bound_scan(n, p)
    assert speedup <= bound * 1.02
    assert speedup >= bound * 0.5


def test_stealing_beats_static_imbalanced():
    """Fig 8c: work stealing improves imbalanced scans; more cores => more."""
    n = 4096
    costs = exponential_costs(n, mean=10.0)
    for ranks, threads in [(16, 12), (42, 12)]:
        n_use = n - n % ranks
        c = costs[:n_use]
        stat = simulate_distributed_scan(c, ranks=ranks, threads=threads,
                                         algorithm="dissemination", stealing=False)
        steal = simulate_distributed_scan(c, ranks=ranks, threads=threads,
                                          algorithm="dissemination", stealing=True)
        assert steal.makespan < stat.makespan, (ranks, threads)


def test_stealing_never_changes_work_much():
    costs = exponential_costs(1024, mean=1.0)
    a = simulate_distributed_scan(costs, ranks=8, threads=4, stealing=False)
    b = simulate_distributed_scan(costs, ranks=8, threads=4, stealing=True)
    # same phase structure => identical operator-application counts
    assert a.work == b.work


def test_energy_decreases_with_stealing():
    costs = exponential_costs(4096, mean=10.0)
    a = simulate_distributed_scan(costs, ranks=32, threads=12, stealing=False)
    b = simulate_distributed_scan(costs, ranks=32, threads=12, stealing=True)
    assert b.energy < a.energy


def test_hierarchical_reduces_global_ranks():
    """§4.2: P ranks -> P' x T with the same total worker count still scans
    correctly and reduces time on latency-heavy networks."""
    costs = constant_costs(4096, 0.05)
    slow_net = NetworkModel(latency=5e-3)
    flat = simulate_distributed_scan(costs, ranks=128, threads=1, net=slow_net)
    hier = simulate_distributed_scan(costs, ranks=16, threads=8, net=slow_net)
    assert hier.makespan < flat.makespan


def test_cross_stealing_beats_static_segments_on_straggler_segment():
    """The tentpole scenario: one rank's stretch is ~6x as expensive.
    Within-rank stealing cannot help (the whole rank is slow); shared
    inter-rank gaps let neighbours absorb boundary elements, cutting both
    phase 1 and the makespan."""
    n, ranks, threads = 4096, 8, 12
    per = n // ranks
    costs = np.full(n, 10.0)
    costs[2 * per: 3 * per] *= 6.0
    stat = simulate_distributed_scan(costs, ranks=ranks, threads=threads,
                                     stealing=True)
    cross = simulate_distributed_scan(costs, ranks=ranks, threads=threads,
                                      stealing=True, cross_stealing=True)
    assert cross.cross_steals > 0
    assert cross.phase1_end < stat.phase1_end
    assert cross.makespan < stat.makespan
    assert stat.cross_steals == 0


def test_cross_stealing_conserves_work():
    """Same phase structure => identical operator-application counts: the
    shared gaps move work between workers, they never duplicate it."""
    costs = exponential_costs(1024, mean=1.0)
    a = simulate_distributed_scan(costs, ranks=8, threads=4, stealing=True)
    b = simulate_distributed_scan(costs, ranks=8, threads=4, stealing=True,
                                  cross_stealing=True)
    assert a.work == b.work


def test_cross_stealing_boundaries_partition():
    from repro_torch.core.simulator import _simulate_cross_stealing_reduce

    costs = exponential_costs(512, mean=1.0)
    fin_per, busy_per, ops, bnds_per, cross = _simulate_cross_stealing_reduce(
        costs, 4, 4
    )
    flat = [iv for bnds in bnds_per for iv in bnds]
    covered = sorted(i for lo, hi in flat for i in range(lo, hi + 1))
    assert covered == list(range(512))
    for (_, h1), (l2, _) in zip(flat, flat[1:]):
        assert l2 == h1 + 1
    assert ops == 512 - len(flat)  # every non-start element costs one op


def test_cross_stealing_clamps_threads_on_tiny_ranks():
    """per-rank segments too small for the requested thread count: the
    cross reduce clamps workers per segment (host rule) and still produces
    a correct partition instead of crashing."""
    from repro_torch.core.simulator import _simulate_cross_stealing_reduce

    costs = constant_costs(16, 1.0)
    res = _simulate_cross_stealing_reduce(costs, 8, 4)
    assert res is not None
    fin_per, busy_per, ops, bnds_per, cross = res
    flat = [iv for bnds in bnds_per for iv in bnds]
    covered = sorted(i for lo, hi in flat for i in range(lo, hi + 1))
    assert covered == list(range(16))
    assert all(len(f) == 1 for f in fin_per)  # clamped to 1 worker/segment


def test_cross_stealing_infeasible_falls_back_like_host(monkeypatch):
    """When seating is infeasible (cross reduce returns None — the host's
    static-segment fallback path), the simulator must degrade to the
    per-rank reduce, not crash."""
    import repro_torch.core.simulator as sim

    monkeypatch.setattr(
        sim, "_simulate_cross_stealing_reduce", lambda *a, **k: None
    )
    costs = exponential_costs(512, mean=1.0)
    a = simulate_distributed_scan(costs, ranks=8, threads=4, stealing=True)
    b = simulate_distributed_scan(costs, ranks=8, threads=4, stealing=True,
                                  cross_stealing=True)
    assert b.cross_steals == 0
    assert b.makespan == a.makespan and b.work == a.work


def test_phase3_waits_for_own_phase1():
    """Accounting fix: a rank's apply cannot start before its own phase 1
    completes.  With the straggler as the *last* rank (no downstream ranks
    to mask it) the old seed-only timing finished phase 3 before phase 1
    ended — physically impossible."""
    n, ranks, threads = 2048, 4, 12
    per = n // ranks
    costs = np.full(n, 10.0)
    costs[(ranks - 1) * per:] *= 6.0
    r = simulate_distributed_scan(costs, ranks=ranks, threads=threads,
                                  stealing=True)
    # The straggler finishes phase 1 at phase1_end and must still apply
    # its whole (expensive) share afterwards.
    assert r.makespan > r.phase1_end + per * 60.0 / threads * 0.5


def test_bounds_monotone():
    for p in [64, 128, 256, 512, 1024]:
        assert theoretical_bound_scan(4096, p) < theoretical_bound_scan(4096, 2 * p)
        assert theoretical_bound_full(4096, p) < theoretical_bound_full(4096, 2 * p)
    # The paper's setup: speedup bound at 1024 cores is in the low hundreds.
    assert 100 < theoretical_bound_scan(4096, 1024) < 500


# ======================================================================
# parity with the reference, bit for bit
# ======================================================================

_COSTS = {
    "constant": lambda m, n: m.constant_costs(n, 0.5),
    "exponential": lambda m, n: m.exponential_costs(n, mean=10.0),
    "registration": lambda m, n: m.registration_like_costs(n),
}

#: (ranks, threads, algorithm, stealing, cross_stealing, network latency)
_MODES = {
    "static": (16, 1, "dissemination", False, False, None),
    "stealing": (8, 4, "ladner_fischer", True, False, None),
    "hierarchical": (4, 8, "brent_kung", False, False, 5e-3),
    "cross_stealing": (8, 4, "ladner_fischer", True, True, None),
}


@pytest.mark.parametrize("kind", sorted(_COSTS))
def test_cost_models_equal_reference(kind):
    np.testing.assert_array_equal(_COSTS[kind](port_sim, 4096),
                                  _COSTS[kind](ref_sim, 4096))


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("kind", sorted(_COSTS))
def test_simulate_distributed_scan_equals_reference(kind, mode):
    ranks, threads, alg, stealing, cross, latency = _MODES[mode]
    kw = dict(ranks=ranks, threads=threads, algorithm=alg, stealing=stealing,
              cross_stealing=cross)
    got = port_sim.simulate_distributed_scan(
        _COSTS[kind](port_sim, 1024),
        net=port_sim.NetworkModel() if latency is None
        else port_sim.NetworkModel(latency=latency), **kw)
    want = ref_sim.simulate_distributed_scan(
        _COSTS[kind](ref_sim, 1024),
        net=ref_sim.NetworkModel() if latency is None
        else ref_sim.NetworkModel(latency=latency), **kw)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)
    if cross:
        assert got.cross_steals > 0


def test_bounds_equal_reference():
    for p in (64, 1024, 6144):
        assert port_sim.theoretical_bound_scan(4096, p) == \
            ref_sim.theoretical_bound_scan(4096, p)
        assert port_sim.theoretical_bound_full(4096, p) == \
            ref_sim.theoretical_bound_full(4096, p)


# ======================================================================
# the simulate backend
# ======================================================================


@pytest.mark.parametrize("alg", ["ladner_fischer", "dissemination", "brent_kung"])
def test_exec_simulate_values_and_trace_equal_reference(alg):
    """Same plan, same per-wire costs and latency: the port's values equal
    the reference's elements and the virtual-time trace is the same."""
    n = 37
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(n)
    costs = rng.uniform(0.5, 2.0, n)
    op = lambda a, b: a * 0.5 + b
    ys, _ = backends.exec_simulate(op, get_plan(alg, n), list(vals),
                                   costs=costs, latency=0.25)
    trace = backends.last_trace
    want, _ = ref_backends.exec_simulate(op, ref_get_plan(alg, n), list(vals),
                                         costs=costs, latency=0.25)
    want_trace = ref_backends.last_trace
    np.testing.assert_array_equal(np.asarray(ys), np.asarray(want))
    assert trace.makespan == want_trace.makespan
    assert trace.work == want_trace.work == get_plan(alg, n).work()
    np.testing.assert_array_equal(trace.ready, want_trace.ready)


def test_simulate_backend_through_engine_on_tensors():
    """engine.scan(backend="simulate") on CPU tensors of rigid deformations
    gives the vector backend's values, with the backend's defaults
    (op_cost 1.0: the makespan is at most the plan's round count)."""
    from repro_torch.core.deformation import compose_batched

    n = 64
    rng = np.random.default_rng(5)
    angle = torch.from_numpy(rng.uniform(-0.05, 0.05, n).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0, 2, (n, 2)).astype(np.float32))
    elems = [{"angle": angle[i], "shift": shift[i]} for i in range(n)]
    got = scan(compose_batched, elems, backend="simulate",
               algorithm="ladner_fischer")
    want = scan(compose_batched, {"angle": angle, "shift": shift},
                backend="vector", algorithm="ladner_fischer")
    torch.testing.assert_close(torch.stack([g["shift"] for g in got]),
                               want["shift"], rtol=0, atol=0)
    torch.testing.assert_close(torch.stack([g["angle"] for g in got]),
                               want["angle"], rtol=0, atol=0)
    plan = get_plan("ladner_fischer", n)
    assert backends.last_trace.work == plan.work()
    assert 0 < backends.last_trace.makespan <= plan.num_rounds()
