"""The port's sharded backend (``repro_torch.core.engine.sharded``): the
counterparts of ``tests/test_sharded.py`` — exscan plans, collective
lowering, dispatch rules, shard geometry, the boundary ledger and its
sanitizer anchoring, the simulator's exscan rounds, and the 8- and
4-position runs — on meshes of CPU positions (the reference's run on 8
virtual devices), plus parity with the reference's ``sharded`` outputs.

Parity: one module fixture runs the reference's scans once in a
subprocess with 8 virtual devices, on inputs this module writes with numpy
from a seed.  Integer-valued data must come out bit-equal (claims move
grouping boundaries only); the rigid composition of float deformations is
held within rtol 1e-5 and atol 1e-5 (``PERF.md`` §2's composition
tolerance: 1e-6 of the largest shift, at least 1e-5).
"""

import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.deformation import compose_batched
from repro_torch.core.engine import scan, sharded

CPU = torch.device("cpu")
RIGID_TOL = dict(rtol=1e-5, atol=1e-5)


def _aff(a, b):
    return (a[0] * b[0], a[1] * b[0] + b[1])


def _inputs():
    rng = np.random.default_rng(7)
    n = 4096
    return {
        "xs": rng.integers(0, 100, n).astype(np.float32),
        "where": rng.random(n) < 0.7,
        "m": np.where(rng.random(n) < 0.004, 2.0, 1.0).astype(np.float32),
        "c": rng.integers(-4, 5, n).astype(np.float32),
        "items": rng.integers(0, 50, 2048).astype(np.float32),
        "pad": np.random.default_rng(3).integers(0, 9, 1031).astype(np.float32),
        "angle": (rng.normal(size=n) * 0.01).astype(np.float32),
        "shift": (rng.normal(size=(n, 2)) * 0.25).astype(np.float32),
    }


REFERENCE_SNIPPET = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.core.deformation import compose_batched
from repro.core.engine import scan, sharded

assert jax.device_count() == 8
inp = dict(np.load(%(inp)r))
xs = jnp.asarray(inp["xs"])
out = {}
out["auto"] = scan(jnp.add, xs, op_cost=1e-5)
assert sharded.last_stats.devices == 8
out["seeded"] = scan(jnp.add, xs, backend="sharded", seed=jnp.float32(1000.0))
out["masked"] = scan(jnp.add, xs, backend="sharded",
                     where=inp["where"].tolist())
aff = lambda a, b: (a[0] * b[0], a[1] * b[0] + b[1])
out["aff_m"], out["aff_c"] = scan(
    aff, (jnp.asarray(inp["m"]), jnp.asarray(inp["c"])), backend="sharded")
out["nosteal"] = scan(jnp.add, xs, backend="sharded", stealing=False)
def addel(a, b):
    return a + b
addel.op_batchable = True
addel.op_identity = np.float32(0.0)
out["items"] = np.asarray(
    scan(addel, [np.float32(v) for v in inp["items"]], op_cost=1e-5),
    dtype=np.float32)
out["pad4"] = scan(jnp.add, jnp.asarray(inp["pad"]), backend="sharded",
                   mesh=sharded.default_mesh(4))
assert sharded.last_stats.devices == 4
d = {"angle": jnp.asarray(inp["angle"]), "shift": jnp.asarray(inp["shift"])}
y = scan(compose_batched, d, backend="sharded")
out["rigid_angle"], out["rigid_shift"] = y["angle"], y["shift"]
np.savez(%(out)r, **{k: np.asarray(v) for k, v in out.items()})
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    """The reference's ``sharded`` outputs on :func:`_inputs`, as numpy."""
    d = tmp_path_factory.mktemp("sharded_parity")
    inp, out = str(d / "inputs.npz"), str(d / "outputs.npz")
    np.savez(inp, **_inputs())
    text = subproc(REFERENCE_SNIPPET % {"inp": inp, "out": out}, devices=8)
    assert "REFERENCE_OK" in text
    return dict(np.load(out))


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _equal(got, want, what):
    g = np.asarray(got)
    assert g.shape == want.shape and np.array_equal(g, want), what


# ---------------------------------------------------------------------------
# exscan circuit + collective lowering (fast, single device)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 3, 5, 8, 16])
def test_exscan_circuit_oracle(p):
    """Element-level simulation of the 2p-wire circuit: wire i ends with the
    exclusive prefix x_0 .. x_{i-1} in exactly ceil(log2 p) rounds; the
    port's circuit is the reference's, round for round."""
    from repro.core.circuits import get_exscan_circuit as ref_circuit
    from repro_torch.core.circuits import exscan_num_rounds, get_exscan_circuit

    circ = get_exscan_circuit(p)
    circ.validate()
    assert len(circ.rounds) == exscan_num_rounds(p)
    assert circ.exclusive
    assert [list(r) for r in circ.rounds] == [list(r) for r in ref_circuit(p).rounds]
    # op = tuple concatenation (free monoid: associative, non-commutative,
    # and the result spells out exactly which inputs combined in what order)
    wires = [() for _ in range(p)] + [(i,) for i in range(p)]
    for rnd in circ.rounds:
        snap = list(wires)
        for kind, src, dst in rnd:
            assert kind == "c"
            wires[dst] = snap[src] + snap[dst]
    for i in range(p):
        assert wires[i] == tuple(range(i)), (p, i, wires[i])


@pytest.mark.parametrize("p", [2, 3, 5, 8])
def test_exscan_collective_lowering(p):
    """registers=2 lowering: every round sends the s register, one-to-one,
    and equals the reference's lowering."""
    from repro.core.distributed import exscan_plan as ref_exscan_plan
    from repro.core.engine.backends import lower_collective as ref_lower
    from repro_torch.core.distributed import exscan_plan
    from repro_torch.core.engine.backends import lower_collective

    rounds = lower_collective(exscan_plan(p), registers=2)
    assert len(rounds) == math.ceil(math.log2(p))
    for rnd, ref in zip(rounds, ref_lower(ref_exscan_plan(p), registers=2)):
        assert rnd.send_reg == 1  # the window-sum register is what moves
        assert rnd.fanout == 1    # one-to-one ppermute, no multicast
        assert rnd.dst_mask.shape == (2, p)
        assert rnd.move_mask.shape == (2, p)
        assert rnd.perm == ref.perm and rnd.send_reg == ref.send_reg
        np.testing.assert_array_equal(rnd.dst_mask, ref.dst_mask)
        np.testing.assert_array_equal(rnd.move_mask, ref.move_mask)


def test_exscan_plan_round0_moves():
    """The identity-initialised e register makes round 0's e-updates compile
    to moves — received-value overwrites, zero operator applications."""
    from repro_torch.core.distributed import exscan_plan

    plan = exscan_plan(8)
    r0 = plan.rounds[0]
    e_moves = [m for m in r0.moves if m[1] < 8]
    assert len(e_moves) == 7  # every rank but 0 overwrites e with s_{i-1}
    assert all(out < 8 and src >= 8 for src, out, _f in e_moves)


def test_axis_size_guard():
    """_axis_size: an explicit size wins; outside a shard_map there is no
    axis to ask, so it raises naming the axis_size= argument (the reference
    raises so on a jax without jax.lax.axis_size)."""
    from repro_torch.core import spmd
    from repro_torch.core.distributed import _axis_size

    assert _axis_size("x", 8) == 8
    with pytest.raises(ValueError, match="axis_size="):
        _axis_size("x", None)
    mesh = spmd.Mesh([CPU] * 3, ("x",))
    got = spmd.shard_map(lambda t: t + _axis_size("x", None), mesh,
                         spmd.P("x"), spmd.P("x"))(torch.zeros(3))
    assert torch.equal(got, torch.full((3,), 3.0))


# ---------------------------------------------------------------------------
# dispatcher rules (fast)
# ---------------------------------------------------------------------------


def test_dispatch_sharded_rules():
    from repro.core.engine import dispatch as ref_dispatch
    from repro_torch.core.engine import dispatch
    from repro_torch.core.engine.cost import SHARDED_MIN_DEVICES, SHARDED_MIN_N

    d = dispatch(4096, domain="array", op_cost=1e-5,
                 devices=SHARDED_MIN_DEVICES)
    assert d.backend == "sharded" and d.algorithm == "exscan"
    assert d.devices == SHARDED_MIN_DEVICES
    d = dispatch(4096, domain="element", op_cost=1e-5, op_batchable=True,
                 devices=8)
    assert d.backend == "sharded"
    # every missing precondition keeps the existing single-device choice
    assert dispatch(4096, domain="array", op_cost=1e-5).backend != "sharded"
    assert dispatch(4096, domain="array", op_cost=1e-5,
                    devices=SHARDED_MIN_DEVICES - 1).backend != "sharded"
    assert dispatch(SHARDED_MIN_N - 1, domain="array", op_cost=1e-5,
                    devices=8).backend != "sharded"
    assert dispatch(4096, domain="element", op_cost=1e-5, op_batchable=None,
                    devices=8).backend != "sharded"
    assert dispatch(4096, domain="element", op_cost=1e-2, op_batchable=True,
                    devices=8).backend != "sharded"  # expensive op: threads
    # the same decisions as the reference's dispatcher
    for kw in ({"domain": "array", "op_cost": 1e-5, "devices": 4},
               {"domain": "element", "op_cost": 1e-5, "op_batchable": True,
                "devices": 8},
               {"domain": "array", "op_cost": 1e-5, "devices": 3}):
        assert dispatch(4096, **kw).backend == ref_dispatch(4096, **kw).backend


# ---------------------------------------------------------------------------
# shard geometry + boundary ledger (fast, host-only protocol logic)
# ---------------------------------------------------------------------------


def test_shard_geometry():
    from repro.core.engine.sharded import _shard_geometry as ref_geometry
    from repro_torch.core.engine.sharded import _shard_geometry

    n_pad, k, halo, blocks = _shard_geometry(4096, 8)
    assert n_pad == 4096 and k == 512
    assert blocks % 2 == 0 and halo == (blocks // 2) * (k // (2 * blocks))
    assert halo <= k // 4
    # padding: n not divisible by devices
    n_pad, k, _h, _b = _shard_geometry(1000, 8)
    assert n_pad == k * 8 and n_pad >= 1000
    # degenerate tiny shards: no halo, no stealing
    _np, _k, halo, _b = _shard_geometry(32, 8)
    assert halo == 0
    for n, p, nb in ((4096, 8, None), (1031, 4, None), (1 << 24, 8, None),
                     (1000, 8, 6), (33, 2, 3), (5, 8, None)):
        assert _shard_geometry(n, p, nb) == ref_geometry(n, p, nb)


def test_boundary_ledger_claims_and_finalize():
    from repro_torch.core.engine.sharded import BoundaryLedger, DEFAULT_GAP_BLOCKS

    b = DEFAULT_GAP_BLOCKS
    led = BoundaryLedger(num_gaps=7, blocks=b)
    # Shard 3 drains both its gaps before its neighbours even arrive.
    drained = 0
    while led.attempt(3):
        drained += 1
    assert drained == 2 * b  # both adjacent gaps fully claimed
    kl, kr = led.claims(3)
    assert kl + kr >= 0 and 0 <= kl <= b and 0 <= kr <= b
    # Virtual edge gaps always report the static border.
    kl0, _kr0 = led.claims(0)
    assert kl0 == b // 2
    _kl7, kr7 = led.claims(7)
    assert kr7 == b // 2
    # Finalize is idempotent and conserves blocks: every interior gap's
    # left + right claims cover it exactly.
    for s in range(8):
        led.claims(s)
    for g in led.gaps:
        assert g.taken_left + g.taken_right == b
    # Remainder of an untouched gap went left, deterministically.
    untouched = BoundaryLedger(num_gaps=1, blocks=b)
    kl, kr = untouched.claims(0)
    assert (kl, kr) == (b // 2, b)
    assert untouched.forced == b


def test_boundary_ledger_steal_direction_prefers_straggler():
    from repro_torch.core.engine.sharded import BoundaryLedger

    led = BoundaryLedger(num_gaps=2, blocks=4)
    # Shards 0 and 2 arrive; shard 1 never does (the straggler).  Both
    # neighbours must claim *toward* it (gap 0 right side, gap 1 left side).
    for _ in range(8):
        led.attempt(0)
    for _ in range(8):
        led.attempt(2)
    assert led.gaps[0].taken_left == 4   # shard 0 drained gap 0 leftward...
    assert led.gaps[1].taken_right == 4  # ...and shard 2 drained gap 1
    assert led.cross_steals >= 4         # claims crossed the static border


def test_boundary_ledger_sanitizer_anchoring_and_mutation():
    """Race-aware tooling covers the boundary-gap claim path.

    Anchoring: concurrent drains of a real :class:`BoundaryLedger` hit the
    kinded ``shard.gap.*`` sync points and produce *zero* race reports.
    Mutation: a ledger variant whose claim-count update drops the lock must
    be flagged by the happens-before sanitizer.

    The tracker and the observed labels are reset before and after, and
    every thread stays alive (a barrier) until all of its group are done:
    the tracker tells threads apart by ``threading.get_ident()``, which a
    thread started after another exited may reuse — the reference's test
    fails when its two short mutation threads, or a mutation thread and the
    last anchoring writer, share one ident (so its race is program order).
    """
    from repro_torch.analysis.sync import (
        get_race_tracker,
        invariants_enabled,
        observed_labels,
        reset_observed,
        reset_race_tracker,
        set_checking,
        sync_point,
    )
    from repro_torch.core.engine.sharded import BoundaryLedger

    was_checking = invariants_enabled()
    set_checking(True)
    reset_observed()
    reset_race_tracker()
    try:
        led = BoundaryLedger(num_gaps=3, blocks=4)
        done = threading.Barrier(4)

        def drain(shard):
            while led.attempt(shard):
                pass
            led.claims(shard)  # finalizes adjacent gaps
            done.wait(timeout=30)

        threads = [threading.Thread(target=drain, args=(s,)) for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for g in led.gaps:
            assert g.taken_left + g.taken_right == 4
        seen = observed_labels()
        for label in ("shard.gap.seat", "shard.gap.claim",
                      "shard.gap.finalize"):
            assert label in seen, (label, seen)
        assert not [r for r in get_race_tracker().races()
                    if r.var == "shard.ledger"]

        both = threading.Barrier(2)

        class _UnlockedClaimLedger(BoundaryLedger):
            # MUTATION: the cross-steal counter update no longer holds (or
            # declares) the ledger lock.
            def attempt(self, shard):  # noqa: ARG002 — twin keeps the API
                sync_point("shard.gap.claim", "write", var="shard.ledger")
                self.cross_steals += 1
                both.wait(timeout=30)
                return 0

        bad = _UnlockedClaimLedger(num_gaps=1, blocks=4)
        threads = [threading.Thread(target=bad.attempt, args=(s,))
                   for s in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        races = [r for r in get_race_tracker().races()
                 if r.var == "shard.ledger"]
        assert races, "sanitizer missed the unlocked ledger mutation"
    finally:
        # Deliberate seeded race: leave no report or label behind.
        reset_race_tracker()
        reset_observed()
        set_checking(was_checking)


# ---------------------------------------------------------------------------
# simulator: exscan schedule (fast)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [2, 4, 8])
def test_simulator_exscan_rounds(p):
    from repro_torch.core.simulator import (
        exponential_costs,
        simulate_distributed_scan,
    )

    costs = exponential_costs(1024)
    r_ex = simulate_distributed_scan(costs, ranks=p, algorithm="exscan")
    r_in = simulate_distributed_scan(costs, ranks=p, algorithm="ladner_fischer")
    assert r_ex.phase2_rounds == math.ceil(math.log2(p))
    # Round-efficiency: the exscan schedule beats inclusive + shift.
    assert r_ex.phase2_rounds < r_in.phase2_rounds
    # Same phase-1 work, same costs: the correctness of phases is unchanged.
    assert r_ex.phase1_end == r_in.phase1_end


# ---------------------------------------------------------------------------
# 8- and 4-position runs on the CPU
# ---------------------------------------------------------------------------


def test_sharded_8dev(reference, monkeypatch):
    from repro_torch.core import distributed as dist
    from repro_torch.core.simulator import constant_costs, simulate_distributed_scan

    inp = _inputs()
    xs = _t(inp["xs"])
    # --- auto-dispatch at 8 positions, bit-exact vs the vector oracle
    ys = scan(torch.add, xs, op_cost=1e-5, devices=8)
    st = sharded.last_stats
    assert st is not None and st.devices == 8, "dispatcher did not go sharded"
    assert st.phase3_route == "plain"      # CPU tensors: no kernel route
    oracle = scan(torch.add, xs, backend="vector")
    assert torch.equal(ys, oracle)
    _equal(ys, reference["auto"], "auto")

    # --- executed phase-2 schedule == lowering == simulator prediction
    assert st.phase2_algorithm == "exscan"
    assert st.phase2_rounds == 3                      # ceil(log2 8)
    assert dist.last_exscan_rounds() == st.phase2_rounds
    sim = simulate_distributed_scan(constant_costs(4096), ranks=8,
                                    algorithm="exscan")
    assert sim.phase2_rounds == st.phase2_rounds

    # --- seeded
    ys = scan(torch.add, xs, backend="sharded", devices=8,
              seed=torch.tensor(1000.0))
    assert torch.equal(ys, oracle + 1000.0)
    _equal(ys, reference["seeded"], "seeded")

    # --- masked (where): False elements are the identity
    where = inp["where"].tolist()
    ys = scan(torch.add, xs, backend="sharded", devices=8, where=where)
    assert torch.equal(ys, scan(torch.add, xs, backend="vector", where=where))
    _equal(ys, reference["masked"], "masked")

    # --- pytree (non-commutative affine compose), exactly-associative ints
    m, c = _t(inp["m"]), _t(inp["c"])
    ym, yc = scan(_aff, (m, c), backend="sharded", devices=8)
    om, oc = scan(_aff, (m, c), backend="vector")
    assert torch.equal(ym, om) and torch.equal(yc, oc)
    _equal(ym, reference["aff_m"], "aff_m")
    _equal(yc, reference["aff_c"], "aff_c")

    # --- stealing off: same bits, no ledger traffic
    ys = scan(torch.add, xs, backend="sharded", devices=8, stealing=False)
    assert torch.equal(ys, oracle)
    assert sharded.last_stats.boundary_claims == []
    _equal(ys, reference["nosteal"], "nosteal")

    # --- element domain: batchable op over a python list
    items = [torch.tensor(v) for v in inp["items"]]

    def addel(a, b):
        return a + b

    addel.op_batchable = True
    addel.op_identity = torch.tensor(0.0)
    sharded.last_stats = None
    ys = scan(addel, items, op_cost=1e-5, devices=8)
    assert sharded.last_stats is not None
    got = torch.stack(ys)
    assert torch.equal(got, torch.cumsum(torch.stack(items), 0))
    _equal(got, reference["items"], "items")

    # --- rigid composition of float deformations, against the reference
    d = {"angle": _t(inp["angle"]), "shift": _t(inp["shift"])}
    y = scan(compose_batched, d, backend="sharded", devices=8)
    v = scan(compose_batched, d, backend="vector")
    for k in ("angle", "shift"):
        np.testing.assert_allclose(y[k].numpy(), v[k].numpy(), **RIGID_TOL)
        np.testing.assert_allclose(y[k].numpy(), reference["rigid_" + k],
                                   **RIGID_TOL)

    # --- a series session on 8 devices pins a mesh for the sharded path
    from repro_torch import service
    from repro_torch.service import RegisterSeriesConfig, SeriesSession

    monkeypatch.setattr(service, "device_count", lambda device: 8)
    s = SeriesSession(RegisterSeriesConfig(), device="cpu")
    try:
        assert s._devices == 8 and s._mesh is not None
        assert s._mesh.size == 8 and s._mesh.devices[0] == CPU
    finally:
        s.close()


def test_sharded_4dev_padding(reference):
    xs = _t(_inputs()["pad"])
    ys = scan(torch.add, xs, op_cost=1e-5, devices=4)  # odd n: tail padding
    st = sharded.last_stats
    assert st is not None and st.devices == 4 and st.phase2_rounds == 2
    assert torch.equal(ys, scan(torch.add, xs, backend="vector"))
    _equal(ys, reference["pad4"], "pad4")


# ---------------------------------------------------------------------------
# the port's own paths
# ---------------------------------------------------------------------------


def test_sharded_phase3_lookback_route(monkeypatch):
    """Phase 3's kernel route, taken here through ``lookback_scan``'s plain
    version (CPU tensors): plain, seeded, masked and rigid composition
    against ``vector``."""
    monkeypatch.setattr(sharded, "_phase3_kernel", lambda op, xs, mesh: True)
    inp = _inputs()
    xs = _t(inp["xs"])
    oracle = scan(torch.add, xs, backend="vector")
    where = inp["where"].tolist()
    for kw, want in (({}, oracle),
                     ({"seed": torch.tensor(1000.0)}, oracle + 1000.0),
                     ({"where": where},
                      scan(torch.add, xs, backend="vector", where=where)),
                     ({"stealing": False}, oracle)):
        ys = scan(torch.add, xs, backend="sharded", devices=8, **kw)
        assert sharded.last_stats.phase3_route == "lookback_scan"
        assert torch.equal(ys, want), kw
    d = {"angle": _t(inp["angle"]), "shift": _t(inp["shift"])}
    y = scan(compose_batched, d, backend="sharded", devices=4)
    v = scan(compose_batched, d, backend="vector")
    for k in ("angle", "shift"):
        np.testing.assert_allclose(y[k].numpy(), v[k].numpy(), **RIGID_TOL)


@pytest.mark.parametrize("n,p", [(1, 8), (7, 8), (100, 3), (257, 8)])
def test_sharded_small_and_odd_sizes(n, p):
    """Shards of a few rows (no halo) and odd tails, seeded and masked."""
    rng = np.random.default_rng(n)
    xs = torch.tensor(rng.integers(-9, 10, n).astype(np.float32))
    where = (rng.random(n) < 0.5).tolist()
    seed = torch.tensor(5.0)
    assert torch.equal(scan(torch.add, xs, backend="sharded", devices=p),
                       torch.cumsum(xs, 0))
    assert torch.equal(
        scan(torch.add, xs, backend="sharded", devices=p, seed=seed),
        torch.cumsum(xs, 0) + seed)
    assert torch.equal(
        scan(torch.add, xs, backend="sharded", devices=p, where=where),
        scan(torch.add, xs, backend="vector", where=where))
