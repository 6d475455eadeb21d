"""Port parity: the decoupled-lookback backend
(``repro_torch.core.engine.decoupled_backend`` over the plain
``repro_torch.kernels.lookback_scan``) against the reference package.

The reference's Pallas ``lookback_scan`` does not run on the installed jax
(it calls ``pl.store``), so the oracle is the reference's own
``engine.scan(..., backend="vector")``, its ``lookback_resolve`` walk and
the expectations of ``tests/test_decoupled.py``, whose cases are ported
here.  Integer-valued float32 inputs with ``+`` (or 0/1 matrices with
``@``) make every association order give the same bits, so those cases
compare with ``array_equal``; rigid composition is held to the reference's
own tolerance (rtol 1e-5, atol 1e-6)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # offline container
    from _hypothesis_shim import given, settings, strategies as st

import repro.core.deformation as rdef
import repro.kernels.lookback_scan as rlb
import repro_torch.core.deformation as tdef
import repro_torch.core.engine as tengine
from repro.core.engine import dispatch as ref_dispatch
from repro.core.engine import scan as ref_scan
from repro_torch.analysis import sync
from repro_torch.analysis.invariants import InvariantViolation
from repro_torch.core.engine import (
    DECOUPLED_MIN_N,
    DEVICE_PHASE1_MIN_N,
    dispatch,
    scan,
)
from repro_torch.core.engine import decoupled_backend
from repro_torch.core.engine.decoupled_backend import stack_elements
from repro_torch.kernels.lookback_scan import (
    FLAG_AGG,
    FLAG_EMPTY,
    FLAG_PREFIX,
    LookbackProtocolError,
    lookback_resolve,
    lookback_scan,
)
from repro_torch.kernels.op_table import KernelOpError
from repro_torch.runtime import scheduler

add = lambda a, b: a + b


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    pool = scheduler.get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    scheduler.set_default_pool(None)


def _int_rows(n, d=3, seed=0):
    """Integer-valued float32 rows: exact under any summation order."""
    rng = np.random.default_rng(seed)
    return rng.integers(-9, 10, (n, d)).astype(np.float32)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- oracle equivalence


@pytest.mark.parametrize("n", list(range(1, 18)) + [64, 1000])
def test_matches_reference_bit_exact(n):
    x = _int_rows(n)
    want = ref_scan(jnp.add, jnp.asarray(x), backend="vector")
    y = scan(torch.add, torch.as_tensor(x), backend="decoupled")
    assert y.dtype == torch.float32
    _eq(y, want)
    seed = np.asarray([5.0, -3.0, 7.0], np.float32)
    y2 = scan(torch.add, torch.as_tensor(x), backend="decoupled",
              seed=torch.as_tensor(seed))
    _eq(y2, np.asarray(want) + seed[None])


def test_seeded_equals_prepended_unseeded():
    x = torch.as_tensor(_int_rows(40, seed=3))
    seed = torch.tensor([2.0, 4.0, -1.0])
    full = scan(add, torch.cat([seed[None], x]), backend="decoupled")
    seeded = scan(add, x, backend="decoupled", seed=seed)
    assert torch.equal(seeded, full[1:])


def test_tile_count_sweep_is_invariant():
    n = 96
    x = _int_rows(n, seed=1)
    want = ref_scan(jnp.add, jnp.asarray(x), backend="vector")
    for t in [1, 2, 3, 4, 6, 8, 12, 16, 96]:
        _eq(scan(add, torch.as_tensor(x), backend="decoupled", num_blocks=t),
            want)
    # Oversized tile counts clamp to n instead of erroring.
    _eq(scan(add, torch.as_tensor(x), backend="decoupled", num_blocks=10 * n),
        want)


def test_noncommutative_matmul():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2, (33, 2, 2)).astype(np.float32)
    want = ref_scan(lambda a, b: jnp.matmul(b, a), jnp.asarray(x),
                    backend="vector", algorithm="sequential")
    got = scan(lambda a, b: torch.matmul(b, a), torch.as_tensor(x),
               backend="decoupled", num_blocks=5)
    _eq(got, want)


def _deformations(n, seed):
    rng = np.random.default_rng(seed)
    return {"angle": (rng.normal(size=n) * 0.05).astype(np.float32),
            "shift": (rng.normal(size=(n, 2)) * 2.0).astype(np.float32)}


def _long_chain_atol(want) -> float:
    """Absolute tolerance of a long composition chain: the shifts grow to
    tens of px, and rotating a vector of length L rounds each component to
    ~L * float32 eps, so a component near 0 carries its neighbour's error.
    1e-6 * L is a few ulps of the largest shift."""
    return 1e-6 * max(1.0, float(np.abs(np.asarray(want["shift"])).max()))


# n = 37: the reference's own case and tolerance (atol 1e-6); n = 300: a
# long chain, at _long_chain_atol.
@pytest.mark.parametrize("n,tiles", [(37, None), (37, 5), (300, None)])
def test_pytree_deformation_compose(n, tiles):
    x = _deformations(n, 6)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.as_tensor(v) for k, v in x.items()}
    want = ref_scan(rdef.compose_batched, jx, backend="vector",
                    algorithm="sequential")
    atol = 1e-6 if n == 37 else _long_chain_atol(want)
    got = scan(tdef.compose_batched, tx, backend="decoupled", num_blocks=tiles)
    for k in ("angle", "shift"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=atol)
    # Seeded: decoupled is the one array-domain backend accepting a seed.
    seed = {"angle": np.float32(0.1), "shift": np.array([1.0, -2.0], np.float32)}
    wants = jax.vmap(lambda d: rdef.compose(
        {k: jnp.asarray(v) for k, v in seed.items()}, d))(want)
    gots = scan(tdef.compose_batched, tx, backend="decoupled",
                num_blocks=tiles,
                seed={k: torch.as_tensor(v) for k, v in seed.items()})
    for k in ("angle", "shift"):
        np.testing.assert_allclose(gots[k].numpy(), np.asarray(wants[k]),
                                   rtol=1e-5, atol=atol)


# ------------------------------------------------------------- where masks


MASKS = [
    lambda n: [i % 3 != 1 for i in range(n)],     # interior holes
    lambda n: [i >= 2 for i in range(n)],         # leading masked run
    lambda n: [i == n // 2 for i in range(n)],    # single valid
    lambda n: [True] * n,                         # all valid
]


@pytest.mark.parametrize("maskgen", MASKS)
def test_where_matches_plan_lowering(maskgen):
    n = 13
    x = _int_rows(n, d=2, seed=7)
    mask = maskgen(n)
    want = ref_scan(jnp.add, jnp.asarray(x), backend="vector", where=mask)
    _eq(scan(add, torch.as_tensor(x), backend="decoupled", where=mask), want)
    # A bool tensor is the same mask.
    _eq(scan(add, torch.as_tensor(x), backend="decoupled",
             where=torch.tensor(mask), num_blocks=4), want)


@pytest.mark.parametrize("tiles", [None, 3])
def test_where_with_seed(tiles):
    """Masked + seeded: masked leading positions pass the seed through,
    valid positions fold it in."""
    n = 9
    x = torch.as_tensor(_int_rows(n, d=2, seed=8))
    mask = [i not in (0, 1, 5) for i in range(n)]
    seed = torch.tensor([10.0, 20.0])
    y = scan(add, x, backend="decoupled", where=mask, seed=seed,
             num_blocks=tiles)
    acc = seed
    for i in range(n):
        if mask[i]:
            acc = acc + x[i]
        assert torch.equal(y[i], acc), i


def test_where_masked_compose_matches_reference():
    n = 40
    x = _deformations(n, 11)
    mask = [i % 4 != 2 and i > 1 for i in range(n)]
    want = ref_scan(rdef.compose_batched,
                    {k: jnp.asarray(v) for k, v in x.items()},
                    backend="vector", where=mask)
    got = scan(tdef.compose_batched,
               {k: torch.as_tensor(v) for k, v in x.items()},
               backend="decoupled", where=mask, num_blocks=6)
    for k in ("angle", "shift"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def test_where_length_mismatch_raises():
    with pytest.raises(ValueError, match="where mask length"):
        scan(add, torch.as_tensor(_int_rows(8)), backend="decoupled",
             where=[True] * 5)


def test_seed_with_single_element_folds_in():
    x = torch.tensor([[3.0, 4.0]])
    y = scan(add, x, backend="decoupled", seed=torch.tensor([1.0, 1.0]))
    assert torch.equal(y, torch.tensor([[4.0, 5.0]]))


# --------------------------------------------------------- element domain


def test_element_list_stacks_and_matches():
    xs = [{"v": torch.full((3,), float(i + 1))} for i in range(25)]
    op = lambda a, b: {"v": a["v"] + b["v"]}
    ys = scan(op, xs, backend="decoupled")
    assert isinstance(ys, list) and len(ys) == 25
    want = ref_scan(lambda a, b: {"v": a["v"] + b["v"]},
                    [{"v": jnp.full((3,), float(i + 1))} for i in range(25)],
                    backend="element")
    for y, w in zip(ys, want):
        _eq(y["v"], w["v"])


def test_unstackable_list_raises():
    xs = [torch.ones((2,)), torch.ones((3,))]
    assert stack_elements(xs) is None
    assert stack_elements([{"a": torch.ones(1)}, {"b": torch.ones(1)}]) is None
    assert stack_elements([(torch.ones(1), 3), (torch.ones(1), 4)]) is None
    with pytest.raises(ValueError, match="stackable"):
        scan(add, xs, backend="decoupled")


# ------------------------------------------- published protocol state


@pytest.mark.parametrize("seeded", [False, True])
def test_published_board_is_resolvable(seeded):
    """After a run every tile has published PREFIX and the board is
    self-consistent: replaying the lookback walk from any tile (through
    both packages' ``lookback_resolve``) yields that tile's exclusive
    prefix."""
    n, t = 60, 6
    x = _int_rows(n, d=2, seed=9)
    seed = np.array([3.0, -4.0], np.float32) if seeded else np.zeros(2, np.float32)
    y, status, aggs, prefs = lookback_scan(
        add, torch.as_tensor(x), t,
        seed=torch.as_tensor(seed) if seeded else None)
    assert status.shape == (t, 1) and status.dtype == torch.int32
    status = status.numpy()[:, 0]
    assert (status == FLAG_PREFIX).all()
    k = n // t
    tile_aggs = x.reshape(t, k, 2).sum(axis=1)
    _eq(aggs, tile_aggs)
    _eq(prefs, np.cumsum(tile_aggs, axis=0) + seed)
    for i in range(1, t):
        for resolve in (lookback_resolve, rlb.lookback_resolve):
            excl, steps = resolve(add, i, status, aggs.numpy(), prefs.numpy())
            _eq(excl, tile_aggs[:i].sum(axis=0) + seed)
            assert steps == 1   # in-order tiles: predecessor already PREFIX
    _eq(y, np.cumsum(x, axis=0) + seed)


def test_board_checked_under_invariants():
    sync.set_checking(True)
    try:
        y, status, _, _ = lookback_scan(add, torch.as_tensor(_int_rows(24)), 4)
        assert (status == FLAG_PREFIX).all()
    finally:
        sync.set_checking(False)


@settings(max_examples=60, deadline=None)
@given(
    t=st.integers(min_value=2, max_value=24),
    i=st.integers(min_value=1, max_value=23),
    pattern=st.integers(min_value=0, max_value=2**23 - 1),
)
def test_lookback_resolve_adversarial_interleavings(t, i, pattern):
    """Any interleaving of AGG/PREFIX publications that satisfies the
    protocol invariant resolves to the same exclusive prefix as the
    reference's walk, stopping at the nearest PREFIX."""
    i = min(i, t - 1)
    vals = [(j + 1) * 10 for j in range(t)]          # tile aggregates
    prefs = list(np.cumsum(vals))
    statuses = [FLAG_PREFIX] + [
        FLAG_PREFIX if (pattern >> j) & 1 else FLAG_AGG
        for j in range(1, t)
    ]
    excl, steps = lookback_resolve(add, i, statuses, vals, prefs)
    assert (excl, steps) == rlb.lookback_resolve(add, i, statuses, vals, prefs)
    assert excl == prefs[i - 1]
    nearest = next(
        j for j in range(i - 1, -1, -1) if statuses[j] == FLAG_PREFIX
    )
    assert steps == i - nearest


@pytest.mark.parametrize("checking", [False, True])
def test_lookback_resolve_rejects_protocol_violations(checking):
    vals = [10, 20, 30, 40]
    prefs = [10, 30, 60, 100]
    # Under REPRO_CHECK_INVARIANTS the shared invariant module catches the
    # EMPTY read first (an InvariantViolation), as in the reference.
    empty = InvariantViolation if checking else LookbackProtocolError
    sync.set_checking(checking)
    try:
        with pytest.raises(empty, match="EMPTY|empty"):
            lookback_resolve(
                add, 3, [FLAG_PREFIX, FLAG_EMPTY, FLAG_AGG], vals, prefs
            )
        with pytest.raises(LookbackProtocolError, match="past tile 0"):
            lookback_resolve(add, 3, [FLAG_AGG, FLAG_AGG, FLAG_AGG], vals,
                             prefs)
        with pytest.raises(ValueError, match="no predecessors"):
            lookback_resolve(add, 0, [FLAG_PREFIX], vals, prefs)
    finally:
        sync.set_checking(False)


# --------------------------------------------------------- dispatch rules


@pytest.mark.parametrize("n", [DECOUPLED_MIN_N - 1, DECOUPLED_MIN_N, 4096])
@pytest.mark.parametrize("op_cost", [None, 1e-5, 1.0])
def test_dispatch_accel_rules_match_reference(n, op_cost):
    for domain, batchable in (("array", None), ("element", True),
                              ("element", None)):
        kw = dict(domain=domain, op_cost=op_cost, accel=True,
                  op_batchable=batchable, workers=8)
        got, want = dispatch(n, **kw), ref_dispatch(n, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kw
    d = dispatch(max(4096, DECOUPLED_MIN_N), domain="array", op_cost=1e-5,
                 accel=True)
    assert d.backend == "decoupled"
    d = dispatch(max(256, DEVICE_PHASE1_MIN_N), domain="element",
                 op_cost=1e-5, op_batchable=True, accel=True)
    assert d.backend == "hierarchical" and d.device_phase1


@pytest.fixture
def card(monkeypatch):
    """Dispatch as on the card (tensors 'on CUDA'), and count the lookback
    scans the decoupled backend runs."""
    monkeypatch.setattr(tengine, "_accel_available", lambda xs: True)
    calls = []
    real = decoupled_backend.lookback_scan

    def counting(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(decoupled_backend, "lookback_scan", counting)
    return calls


def test_tagged_ops_dispatch_to_decoupled(card):
    n = DECOUPLED_MIN_N
    x = torch.as_tensor(_int_rows(n, d=1, seed=12))
    _eq(scan(torch.add, x), np.cumsum(x.numpy(), axis=0))
    tagged = lambda a, b: a + b
    tagged.kernel_op = "add"
    _eq(scan(tagged, x, devices=1), np.cumsum(x.numpy(), axis=0))
    dfm = {k: torch.as_tensor(v) for k, v in _deformations(n, 13).items()}
    want = ref_scan(rdef.compose_batched,
                    {k: jnp.asarray(v.numpy()) for k, v in dfm.items()},
                    backend="vector", algorithm="sequential")
    got = scan(tdef.compose_batched, dfm, devices=1)
    for k in ("angle", "shift"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=_long_chain_atol(want))
    assert len(card) == 3


def test_untagged_ops_dispatch_as_on_the_cpu(card):
    n = DECOUPLED_MIN_N
    x = torch.as_tensor(_int_rows(n, d=1, seed=14))
    _eq(scan(add, x, devices=1), np.cumsum(x.numpy(), axis=0))
    # Tagged, but wider than the kernels' rows: no kernel path either.
    wide = torch.as_tensor(_int_rows(n, d=6, seed=14))
    _eq(scan(torch.add, wide, devices=1), np.cumsum(wide.numpy(), axis=0))
    # Short scans stay off the single-pass kernel.
    _eq(scan(torch.add, x[: n - 1], devices=1),
        np.cumsum(x[: n - 1].numpy(), axis=0))
    assert card == []


def test_explicit_decoupled_with_untagged_op_raises_off_the_cpu():
    x = torch.empty((300, 2), device="meta")
    with pytest.raises(KernelOpError, match="add .*rigid_compose"):
        scan(add, x, backend="decoupled")
    with pytest.raises(KernelOpError, match="rigid_compose"):
        lookback_scan(add, torch.empty((8, 2), device="meta"), 2)


def test_compose_suffix_of_a_long_feed_reaches_decoupled(card):
    """refine=False: a feed of >= DECOUPLED_MIN_N new elements is composed
    through the decoupled backend when the session's tensors are on the
    card."""
    from repro_torch import RegisterSeriesConfig, open_series
    from repro_torch.core.registration import RegElement

    n = DECOUPLED_MIN_N + 3
    d = _deformations(n, 15)
    elems = [
        RegElement({"angle": torch.as_tensor(d["angle"][i]),
                    "shift": torch.as_tensor(d["shift"][i])}, i, i + 1)
        for i in range(n)
    ]
    with open_series(RegisterSeriesConfig(refine=False), device="cpu") as s:
        out = s._compose_suffix(elems, None)
    assert len(card) == 1 and card[0][0] >= n  # rows padded to the tiles
    want = ref_scan(rdef.compose_batched,
                    {k: jnp.asarray(v) for k, v in d.items()},
                    backend="vector", algorithm="sequential")
    got = np.stack([e.deformation["shift"].numpy() for e in out])
    np.testing.assert_allclose(got, np.asarray(want["shift"]), rtol=1e-5,
                               atol=_long_chain_atol(want))
