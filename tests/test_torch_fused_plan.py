"""Port parity: a whole plan in one launch (``fused_plan``) and the
streamed ``tile_apply``, through their plain versions.

* ``_tiling.plan_operands`` (the compact operand list the ``fused_plan``
  kernel reads) expands back, round by round, to the dense tables of
  ``_tiling.round_sources`` that the per-round kernel reads;
* ``fused_plan_reference`` equals the reference's chain of interpret-mode
  ``repro.kernels.tile_scan.fused_round`` calls over the plan, and its
  captured total the reference ``pallas`` backend's total;
* ``tile_apply``'s plain version equals the reference's interpret-mode
  ``tile_apply`` at every lane count and at tiles whose k*d floats are not
  a whole number of 16-byte words;
* the size rule and the plan cache keys.

Inputs are made with numpy from a seed.  Add runs on integer-valued rows
and max on random floats, so every comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import get_plan as ref_get_plan
from repro.core.engine.pallas_backend import exec_pallas as ref_exec_pallas
from repro.kernels import tile_scan as rts
from repro_torch.core.engine import get_plan, plan_cache, scan
from repro_torch.core.engine.backends import exec_vector
from repro_torch.core.engine.pallas_backend import exec_pallas
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import tile_scan as ts
from repro_torch.kernels._tiling import (
    PLAN_CLUSTER_BARRIER,
    PLAN_LOCAL_READS,
    PLAN_REWRITTEN,
    PLAN_SMEM_BYTES,
    plan_cluster_size,
    plan_min_cluster,
    plan_operands,
    plan_rows_per,
    plan_smem_bytes,
    round_sources,
)

CIRCUITS = ["sklansky", "brent_kung", "ladner_fischer", "dissemination",
            "blelloch"]
OPS = {"add": (jnp.add, torch.add), "max": (jnp.maximum, torch.maximum)}


def _plans(alg, n, masked=False):
    """The port's and the reference's plan as the engine builds them
    (Blelloch padded to a power of two; masked: a leading masked run)."""
    if alg == "blelloch":
        m = 1 << (n - 1).bit_length()
        kw = {"n_valid": n if m != n else None}
        return get_plan(alg, m, **kw), ref_get_plan(alg, m, **kw)
    mask = [i < 2 or i % 5 == 3 for i in range(n)] if masked else None
    return get_plan(alg, n, mask=mask), ref_get_plan(alg, n, mask=mask)


def _rows(op, n, d, seed):
    rng = np.random.default_rng(seed)
    if op == "add":
        return rng.integers(-3, 4, (n, d)).astype(np.float32)
    return rng.normal(size=(n, d)).astype(np.float32)


def _expand(plan_ops, k):
    """Live round k's triples as the dense (n, 2) table of round_sources."""
    n = plan_ops.n
    src = np.stack([np.arange(n), np.full(n, -1)], axis=1).astype(np.int32)
    t = plan_ops.round_ops(k).numpy()
    src[t[:, 0]] = t[:, 1:]
    return src


PLAN_CASES = ([(alg, n, False) for alg in CIRCUITS for n in (1000, 1024, 4096)]
              + [("ladner_fischer", n, True) for n in (1000, 1024, 4096)])


@pytest.mark.parametrize("alg,n,masked", PLAN_CASES)
@pytest.mark.parametrize("cluster", [1, 4, 16])
def test_plan_operands_expand_to_round_sources(alg, n, masked, cluster):
    plan = _plans(alg, n, masked)[0]
    m = plan.n
    po = plan_operands(plan, cluster)
    live = [src for src in (round_sources(r, m) for r in plan.rounds)
            if src is not None]
    assert po.rounds == len(live) and po.cluster == cluster
    assert po.ops.dtype == po.offsets.dtype == torch.int32
    assert po.entries == plan.work() + plan.num_moves()
    assert list(po.offsets.numpy()) == list(po.bounds)
    assert po.nbytes == 12 * po.entries + 4 * (po.rounds * (cluster + 1) + 1)
    local = []
    for k, want in enumerate(live):
        np.testing.assert_array_equal(_expand(po, k), want)
        for q in range(cluster):   # each CTA's group holds only its rows
            lo, hi = po.bounds[k * cluster + q], po.bounds[k * cluster + q + 1]
            dst = po.ops[lo:hi, 0].numpy() & (PLAN_REWRITTEN - 1)
            assert ((dst // po.rows_per) == q).all()
        # The next round's rows are marked, and only they.
        if k + 1 < len(live):
            rewritten = (po.round_ops(k)[:, 0].numpy()[:, None]
                         == po.round_ops(k + 1)[:, 0].numpy()[None]).any(1)
            marked = (po.ops[po.bounds[k * cluster] : po.bounds[(k + 1) * cluster],
                             0].numpy() & PLAN_REWRITTEN) != 0
            np.testing.assert_array_equal(marked, rewritten)
        t = po.round_ops(k).numpy()
        own = t[:, 0] // po.rows_per
        local.append(bool(((t[:, 1] // po.rows_per == own)
                           & ((t[:, 2] < 0) | (t[:, 2] // po.rows_per == own)))
                          .all()))
    # A round's flags: CTA-local reads exactly where it is CTA-local, and a
    # cluster barrier after it unless it and the next (if any) are.
    local.append(True)
    flags = po.flags.numpy()
    assert flags.dtype == np.int32 and flags.shape == (po.rounds,)
    for k in range(po.rounds):
        assert bool(flags[k] & PLAN_LOCAL_READS) == local[k]
        assert bool(flags[k] & PLAN_CLUSTER_BARRIER) == (
            not (local[k] and local[k + 1]))
    if cluster == 1:
        assert not (flags & PLAN_CLUSTER_BARRIER).any()
    if plan.total_available:
        (r,) = [i for i, rnd in enumerate(plan.rounds)
                if rnd.capture_total is not None]
        before = sum(1 for rnd in plan.rounds[:r]
                     if rnd.num_combines or rnd.num_moves)
        assert po.capture_round == before
        assert po.capture_wire == plan.rounds[r].capture_total
    else:
        assert po.capture_round == po.capture_wire == -1


@functools.lru_cache(maxsize=None)
def _ref_round(name):
    jop = OPS[name][0]
    return jax.jit(lambda y, mats: rts.fused_round(jop, y, mats,
                                                   interpret=True))


FUSED_CASES = ([(alg, op, d, False) for alg in CIRCUITS for op in OPS
                for d in (1, 4)]
               + [("ladner_fischer", "add", d, True) for d in (1, 4)])


@pytest.mark.parametrize("alg,op,d,masked", FUSED_CASES)
def test_fused_plan_reference_matches_reference_round_chain(alg, op, d, masked):
    n = 60
    plan, ref_plan = _plans(alg, n, masked)
    m = plan.n
    x = _rows(op, m, d, seed=m + d)
    got, total = ts.fused_plan(OPS[op][1], torch.as_tensor(x),
                               plan_operands(plan, 4))
    y = jnp.asarray(x)
    for ref_rnd in ref_plan.rounds:
        mats = rts.build_round_matrices(ref_rnd, m)
        if all(a is None for a in mats[:5]):
            continue
        y = _ref_round(op)(y, tuple(None if a is None else jnp.asarray(a)
                                    for a in mats))
    np.testing.assert_array_equal(got.numpy(), np.asarray(y))
    assert (total is None) == (not plan.total_available)


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("n", [8, 64])
def test_blelloch_total_matches_reference_backend(op, n):
    plan, ref_plan = _plans("blelloch", n)
    x = _rows(op, n, 2, seed=n)
    got, total = ts.fused_plan(OPS[op][1], torch.as_tensor(x),
                               plan_operands(plan, 2))
    want, want_total = ref_exec_pallas(OPS[op][0], ref_plan, jnp.asarray(x),
                                       interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(total.numpy(), np.asarray(want_total))
    ys, ptotal = exec_pallas(OPS[op][1], plan, torch.as_tensor(x))
    assert torch.equal(ys, got) and torch.equal(ptotal, total)


def test_fused_plan_reference_takes_any_op_and_float_dtype():
    plan = get_plan("brent_kung", 33)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(33, 2)))
    aff = lambda a, b: torch.stack([a[:, 0] * b[:, 0],          # noqa: E731
                                    a[:, 1] * b[:, 0] + b[:, 1]], 1)
    got, total = ts.fused_plan(aff, x, plan_operands(plan, 2))
    want, _ = exec_vector(aff, plan, x)
    assert got.dtype == torch.float64 and total is None
    assert torch.equal(got, want)


def test_fused_plan_checks_its_plan():
    po = plan_operands(get_plan("sklansky", 16))
    with pytest.raises(ValueError, match="fused_plan takes"):
        ts.fused_plan(torch.add, torch.zeros(17, 1), po)
    with pytest.raises(ValueError, match="cluster"):
        plan_operands(get_plan("sklansky", 16), 0)


# ------------------------------------------------------------- size rule


@pytest.mark.parametrize("n,d,want,rule", [
    (2**16, 1, 4, 16), (2**16, 4, 16, 16), (4096, 3, 1, 8), (1000, 1, 1, 1),
    (2**15, 1, 2, 16), (3000, 1, 1, 2), (2**20, 4, None, None),
    (2**17, 4, None, None), (116_224, 4, 16, 16), (116_228, 4, None, None),
])
def test_cluster_size_is_the_smallest_that_holds_the_buffer_twice(n, d, want,
                                                                   rule):
    c = plan_min_cluster(n, d)
    assert c == want
    if c is not None:
        assert plan_smem_bytes(n, d, c) <= PLAN_SMEM_BYTES
        assert c == 1 or plan_smem_bytes(n, d, c // 2) > PLAN_SMEM_BYTES
        assert c * plan_rows_per(n, c) >= n and plan_rows_per(n, c) % 4 == 0
    # The size rule: more CTAs while each would hold over 2,048 floats.
    assert plan_cluster_size(n, d) == rule


def test_rounds_mode_takes_one_plan_or_a_table_a_round_by_the_size_rule():
    """On CPU tensors both routes run the plain versions (no launch); the
    size rule decides which device operands the plan gets."""
    small = get_plan("sklansky", 1024)
    large = get_plan("sklansky", 2**17)
    reset_launch_counts()
    x = torch.as_tensor(_rows("add", 1024, 1, seed=1))
    exec_pallas(torch.add, small, x)
    xl = torch.as_tensor(_rows("add", 2**17, 4, seed=2))
    y, _ = exec_pallas(torch.add, large, xl)
    assert not any(launch_counts().values())
    assert set(small.scratch[("pallas", "cpu")]) == {("plan", 1)}
    assert set(large.scratch[("pallas", "cpu")]) == {"rounds"}
    assert torch.equal(y, torch.cumsum(xl.double(), 0).float())


# ------------------------------------------------------------ plan keys


def test_unmasked_and_all_false_masks_share_one_plan():
    plan_cache.clear()
    p = get_plan("ladner_fischer", 40)
    assert get_plan("ladner_fischer", 40, mask=[False] * 40) is p
    assert get_plan("ladner_fischer", 40, n_valid=40) is p
    assert plan_cache.stats()["misses"] == 1
    assert [key[2] for key in plan_cache._data] == [None]
    q = get_plan("ladner_fischer", 40, mask=[i == 3 for i in range(40)])
    assert q is not p and q.num_moves() > 0


def test_engine_scans_reuse_the_plans_device_operands():
    x = torch.as_tensor(_rows("add", 300, 1, seed=3))[:, 0]
    scan(torch.add, x, backend="pallas", algorithm="brent_kung")
    plan = get_plan("brent_kung", 300)
    ops = plan.scratch[("pallas", "cpu")][("plan", 1)]
    y = scan(torch.add, x, backend="pallas", algorithm="brent_kung")
    assert plan.scratch[("pallas", "cpu")][("plan", 1)] is ops
    assert torch.equal(y, torch.cumsum(x.double(), 0).float())


# ------------------------------------------------------------ tile_apply


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("t,k", [(3, 1001), (4, 16), (5, 3)])
def test_tile_apply_plain_matches_reference_kernel(op, d, t, k):
    local = _rows(op, t * k, d, seed=t * k + d).reshape(t, k, d)
    seeds = _rows(op, t, d, seed=t + d + 100)
    got = ts.tile_apply(OPS[op][1], torch.as_tensor(local),
                        torch.as_tensor(seeds))
    want = rts.tile_apply(OPS[op][0], jnp.asarray(local), jnp.asarray(seeds),
                          interpret=True)
    assert got.shape == want.shape == (t * k, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:k].numpy(), local[0])
