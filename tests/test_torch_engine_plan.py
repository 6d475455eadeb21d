"""Port parity: plan lowering (``repro_torch.core.engine.plan``) against
``repro.core.engine``, the torch counterparts of ``tests/test_engine_plan.py``:
the reference test's golden structure, Table-1 consistency and cache
behaviour on the port's plans, and every port plan equal, round by round, to
the reference's."""

import numpy as np
import torch
import pytest

from repro.core.circuits import get_circuit as ref_get_circuit
from repro.core.engine import get_plan as ref_get_plan, lower as ref_lower
from repro.core.engine.backends import lower_collective as ref_lower_collective
from repro_torch.core.circuits import analyze, get_circuit
from repro_torch.core.engine import get_plan, lower, plan_cache, scan

ALGS = ["sequential", "dissemination", "blelloch", "ladner_fischer",
        "brent_kung", "sklansky"]


def _rounds(plan):
    return [(r.combines, r.moves, r.capture_total) for r in plan.rounds]


def _same_as_reference(plan, ref_plan):
    assert plan.n == ref_plan.n
    assert _rounds(plan) == _rounds(ref_plan)
    assert plan.work() == ref_plan.work()
    assert plan.num_moves() == ref_plan.num_moves()
    assert plan.exclusive == ref_plan.exclusive
    assert plan.total_available == ref_plan.total_available


# ---------------------------------------------------------------- golden plans
def test_sequential_plan_golden():
    plan = lower(get_circuit("sequential", 5))
    assert plan.num_rounds() == 4
    for r, rnd in enumerate(plan.rounds):
        assert rnd.moves == ()
        # (a, b, out, fanout, comm_src): y[i] = op(y[i-1], y[i])
        assert rnd.combines == ((r, r + 1, r + 1, 1, r),)
    assert plan.work() == 4 and plan.num_moves() == 0
    assert plan.combine_only() and not plan.exclusive
    _same_as_reference(plan, ref_lower(ref_get_circuit("sequential", 5)))


def test_dissemination_plan_golden():
    plan = lower(get_circuit("dissemination", 8))
    assert plan.num_rounds() == 3
    outs = [tuple(c[2] for c in rnd.combines) for rnd in plan.rounds]
    assert outs[0] == tuple(range(1, 8))     # distance 1
    assert outs[1] == tuple(range(2, 8))     # distance 2
    assert outs[2] == tuple(range(4, 8))     # distance 4
    assert plan.work() == 8 * 3 - 8 + 1      # Table 1: N log N - N + 1
    _same_as_reference(plan, ref_lower(ref_get_circuit("dissemination", 8)))


def test_blelloch_plan_golden():
    plan = lower(get_circuit("blelloch", 4))
    # up-sweep (2 rounds), z, down-sweep (2 rounds)
    assert plan.num_rounds() == 5
    assert plan.rounds[2].capture_total == 3      # root before zeroing
    assert plan.rounds[2].combines == () and plan.rounds[2].moves == ()
    assert plan.exclusive and plan.total_available
    # The first down-sweep round crosses the root with an identity parent:
    # pure data movement, zero operator applications.
    assert plan.rounds[3].combines == ()
    assert plan.rounds[3].num_moves == 2
    assert plan.work() == analyze(get_circuit("blelloch", 4)).work
    _same_as_reference(plan, ref_lower(ref_get_circuit("blelloch", 4)))


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("n", [2, 4, 8, 16, 64, 256])
def test_plan_work_matches_analyze(alg, n):
    """Plan compile-time identity resolution == analyze()'s accounting."""
    if alg == "blelloch" and n & (n - 1):
        pytest.skip("blelloch needs pow2")
    circuit = get_circuit(alg, n)
    plan = lower(circuit)
    assert plan.num_rounds() == len(circuit.rounds)
    assert plan.work() == analyze(circuit).work
    _same_as_reference(plan, ref_lower(ref_get_circuit(alg, n)))


@pytest.mark.parametrize("n,n_valid", [(8, 5), (16, 9), (16, 16), (64, 37)])
def test_padding_reduces_work(n, n_valid):
    """Suffix-identity padding compiles combines away, never adds work."""
    full = lower(get_circuit("blelloch", n))
    padded = get_plan("blelloch", n, n_valid=n_valid)
    assert padded.work() <= full.work()
    if n_valid < n:
        assert padded.work() < full.work()
    # padding wires start as identity
    assert padded.mask == tuple(i >= n_valid for i in range(n))
    _same_as_reference(padded, ref_get_plan("blelloch", n, n_valid=n_valid))


def test_mask_lowering_interior():
    """Interior identity wires (where= masks) also resolve at plan time."""
    n = 8
    mask = [False, False, True, False, False, True, False, False]
    plan = get_plan("dissemination", n, mask=mask)
    full = lower(get_circuit("dissemination", n))
    assert plan.work() < full.work()
    assert plan.num_moves() > 0  # identity combines became moves
    _same_as_reference(plan, ref_get_plan("dissemination", n, mask=mask))


# ---------------------------------------------------------------------- cache
def test_plan_cache_reuses_plans():
    plan_cache.clear()
    p1 = get_plan("ladner_fischer", 33)
    misses = plan_cache.stats()["misses"]
    p2 = get_plan("ladner_fischer", 33)
    assert p1 is p2
    assert plan_cache.stats()["hits"] >= 1
    assert plan_cache.stats()["misses"] == misses


def test_plan_cache_distinguishes_masks():
    a = get_plan("dissemination", 8)
    b = get_plan("dissemination", 8, n_valid=5)
    assert a is not b and a.work() != b.work()


# ----------------------------------------------------------- collective lower
# The port's lower_collective against the reference's, on the same plans.
def test_collective_lowering_pairs_and_fanout():
    from repro_torch.core.engine.backends import lower_collective

    plan = get_plan("ladner_fischer", 8)
    rounds = lower_collective(plan)
    ref_rounds = ref_lower_collective(ref_get_plan("ladner_fischer", 8))
    assert len(rounds) == len(ref_rounds) == plan.num_rounds()
    # LF_0 ends with the broadcast round: fanout > 1 (MPI_Bcast analogue).
    assert max(c[3] for c in plan.rounds[-1].combines) == rounds[-1].fanout > 1
    for rnd, ref, prnd in zip(rounds, ref_rounds, plan.rounds):
        assert rnd.perm == ref.perm and rnd.fanout == ref.fanout
        np.testing.assert_array_equal(rnd.src_of, ref.src_of)
        np.testing.assert_array_equal(rnd.dst_mask, ref.dst_mask)
        assert len(rnd.perm) == prnd.num_combines
        assert rnd.dst_mask.sum() == prnd.num_combines
        dst = np.zeros(plan.n, dtype=bool)
        dst[[c[2] for c in prnd.combines]] = True
        np.testing.assert_array_equal(rnd.dst_mask, dst)


def test_collective_lowering_rejects_blelloch():
    from functools import partial

    from repro_torch.core.engine.backends import lower_collective
    from repro_torch.core.spmd import Mesh, P, shard_map

    plan = get_plan("blelloch", 8)
    assert not plan.combine_only()           # why lower_collective refuses it
    with pytest.raises(NotImplementedError):
        ref_lower_collective(ref_get_plan("blelloch", 8))
    with pytest.raises(NotImplementedError):
        lower_collective(plan)
    f = shard_map(partial(scan, lambda a, b: a + b, backend="collective",
                          axis_name="x", algorithm="blelloch"),
                  Mesh(["cpu"] * 8, ("x",)), in_specs=P("x"),
                  out_specs=P("x"))
    with pytest.raises(NotImplementedError):
        f(torch.arange(8.0))
