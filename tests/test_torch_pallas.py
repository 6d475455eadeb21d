"""Port parity: the ``pallas`` scan backend
(``repro_torch.core.engine.pallas_backend``; rounds mode through
``fused_plan``'s plain version, the chain of ``fused_round``'s) and the
``fused_round`` plain version against ``repro.core.engine``'s ``pallas`` backend and
``repro.kernels.tile_scan.fused_round`` in interpret mode.

Inputs are made with numpy from a seed and handed to both packages.  A
one-hot gather is exact for finite values, so every comparison with the
reference is ``assert_array_equal`` (which treats -0.0 and +0.0 as equal:
the reference's ``y * keep + ...`` turns a kept -0.0 into +0.0).  The
reference's one-hot rounds turn one ``inf`` into NaN everywhere
(``0 * inf``); the port gathers by index and gives what its ``vector``
backend gives, which a test pins.

Each reference round is one interpret-mode ``pallas_call``; it runs under
``jax.jit`` so rounds of equal shapes compile once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import get_plan as ref_get_plan
from repro.core.engine import scan as ref_scan
from repro.kernels.tile_scan import build_round_matrices as ref_round_matrices
from repro.kernels.tile_scan import fused_round as ref_fused_round
from repro_torch.core.engine import get_plan, lowered_cache, scan
from repro_torch.core.engine.backends import exec_vector
from repro_torch.core.engine.pallas_backend import exec_pallas
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import tile_scan as ts
from repro_torch.kernels._tiling import round_sources
from repro_torch.kernels.op_table import KernelOpError

CIRCUITS = ["sequential", "dissemination", "ladner_fischer", "brent_kung",
            "sklansky", "blelloch"]
INCLUSIVE = [c for c in CIRCUITS if c != "blelloch"]
OPS = {"add": (jnp.add, torch.add), "max": (jnp.maximum, torch.maximum)}


@functools.lru_cache(maxsize=None)
def _ref_round(name):
    jop = OPS[name][0]
    return jax.jit(lambda y, mats: ref_fused_round(jop, y, mats, interpret=True))


def _mask(n):
    """An identity mask with a leading masked run (True = identity)."""
    return [i < 2 or i % 5 == 3 for i in range(n)]


def _plans(alg, n, masked=False):
    """The port's and the reference's plan for ``alg`` over ``n`` rows, as
    the engine builds them (Blelloch: padded to a power of two)."""
    if alg == "blelloch":
        m = 1 << (n - 1).bit_length()
        kw = {"n_valid": n if m != n else None}
        return get_plan(alg, m, **kw), ref_get_plan(alg, m, **kw)
    mask = _mask(n) if masked else None
    return get_plan(alg, n, mask=mask), ref_get_plan(alg, n, mask=mask)


ROUND_CASES = (
    [(alg, n, "add", 1, False) for alg in CIRCUITS for n in (17, 64)]
    + [(alg, n, "max", 3, False) for alg in CIRCUITS for n in (17, 64)]
    + [(alg, n, "add", 1, True) for alg in INCLUSIVE for n in (17, 64)]
)


@pytest.mark.parametrize("alg,n,op,d,masked", ROUND_CASES)
def test_fused_round_matches_reference_kernel(alg, n, op, d, masked):
    plan, ref_plan = _plans(alg, n, masked)
    m = plan.n
    y = np.random.default_rng(n + d).normal(size=(m, d)).astype(np.float32)
    for rnd, ref_rnd in zip(plan.rounds, ref_plan.rounds):
        src = round_sources(rnd, m)
        mats = ref_round_matrices(ref_rnd, m)
        if src is None:
            assert all(a is None for a in mats[:5])
            continue
        got = ts.fused_round(OPS[op][1], torch.as_tensor(y), torch.as_tensor(src))
        want = _ref_round(op)(jnp.asarray(y), tuple(
            None if a is None else jnp.asarray(a) for a in mats))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        y = got.numpy()


@pytest.mark.parametrize("alg", CIRCUITS)
@pytest.mark.parametrize("n", [4, 13])
@pytest.mark.parametrize("masked", [False, True])
def test_round_sources_compute_what_the_one_hot_matrices_compute(alg, n, masked):
    """Both lowerings of every round, applied in numpy (float64, add)."""
    if masked and alg == "blelloch":
        masked = False
    plan = _plans(alg, n, masked)[0]
    m = plan.n
    y = np.random.default_rng(n).normal(size=(m, 2))
    for rnd in plan.rounds:
        src = round_sources(rnd, m)
        ga, gb, sc, gm, sm, keep = ref_round_matrices(rnd, m)
        if src is None:
            assert ga is None and gm is None
            continue
        want = y * keep
        if ga is not None:
            want = want + sc @ (ga @ y + gb @ y)
        if gm is not None:
            want = want + sm @ (gm @ y)
        a, b = src[:, 0], src[:, 1]
        got = np.where((b >= 0)[:, None], y[a] + y[np.maximum(b, 0)], y[a])
        np.testing.assert_array_equal(got, want)
        assert src.dtype == np.int32 and src.shape == (m, 2)
        y = got


# ----------------------------------------------------------- the backend

SCAN_CASES = (
    [("rounds", n) for n in (1, 7, 17, 64)]
    + [("masked", n) for n in (1, 7, 17, 64)]
    + [("blelloch", n) for n in (1, 7, 17, 64)]
    + [("tiles", 64)]
)


@pytest.mark.parametrize("mode,n", SCAN_CASES)
def test_scan_pallas_matches_reference(mode, n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    kw = {"backend": "pallas"}
    if mode == "masked":
        kw["where"] = [not v for v in _mask(n)]
    if mode == "blelloch":
        kw["algorithm"] = "blelloch"
    jop, top = jnp.add, torch.add
    if mode == "tiles":
        kw["num_blocks"] = 8
        jop, top = jnp.maximum, torch.maximum
    want = ref_scan(jop, jnp.asarray(x), interpret=True, **kw)
    got = scan(top, torch.as_tensor(x), **kw)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("alg", CIRCUITS)
@pytest.mark.parametrize("n", list(range(1, 18)) + [64])
def test_scan_pallas_sweep_matches_oracle_and_vector(alg, n):
    """The reference's own sweep (``test_engine_backends.py``), held to a
    numpy oracle and to the port's ``vector`` backend, bit for bit."""
    x = np.linspace(0.5, 2.0, n).astype(np.float32)
    got = scan(torch.add, torch.as_tensor(x), backend="pallas", algorithm=alg)
    vec = scan(torch.add, torch.as_tensor(x), backend="vector", algorithm=alg)
    np.testing.assert_array_equal(got.numpy(), vec.numpy())
    np.testing.assert_allclose(got.numpy(), np.cumsum(x.astype(np.float64)),
                               rtol=1e-5)


def test_inf_stays_inf_where_the_reference_gives_nan():
    x = np.arange(1.0, 9.0, dtype=np.float32)
    x[6] = np.inf
    got = scan(torch.add, torch.as_tensor(x), backend="pallas",
               algorithm="sklansky")
    vec = scan(torch.add, torch.as_tensor(x), backend="vector",
               algorithm="sklansky")
    np.testing.assert_array_equal(got.numpy(), vec.numpy())
    np.testing.assert_array_equal(got.numpy(), [1, 3, 6, 10, 15, 21, np.inf, np.inf])
    ref = ref_scan(jnp.add, jnp.asarray(x), backend="pallas",
                   algorithm="sklansky", interpret=True)
    assert np.isnan(np.asarray(ref)).all()   # the one-hot products' 0 * inf


def test_plain_version_takes_any_op_and_float_dtype():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(33, 2)))
    aff = lambda a, b: torch.stack([a[:, 0] * b[:, 0],          # noqa: E731
                                    a[:, 1] * b[:, 0] + b[:, 1]], 1)
    got = scan(aff, x, backend="pallas", algorithm="brent_kung")
    vec = scan(aff, x, backend="vector", algorithm="brent_kung")
    assert got.dtype == torch.float64
    assert torch.equal(got, vec)


def test_rounds_mode_captures_the_pre_round_total():
    plan = get_plan("blelloch", 8)
    x = torch.arange(1.0, 9.0)
    excl, total = exec_pallas(torch.add, plan, x)
    vexcl, vtotal = exec_vector(torch.add, plan, x)
    assert float(total) == float(vtotal) == 36.0
    assert torch.equal(excl, vexcl)
    assert torch.equal(excl[1:], torch.tensor([1.0, 3, 6, 10, 15, 21, 28]))


def test_input_errors_match_reference():
    x = torch.arange(1.0, 17.0)
    jx = jnp.arange(1.0, 17.0)
    for pkg_scan, arr, add in ((scan, x, torch.add), (ref_scan, jx, jnp.add)):
        with pytest.raises(ValueError, match="single-array inputs"):
            pkg_scan(add, {"a": arr, "b": arr}, backend="pallas")
        with pytest.raises(NotImplementedError, match="where masks"):
            pkg_scan(add, arr, backend="pallas", num_blocks=4, where=[True] * 16)
        with pytest.raises(NotImplementedError):
            pkg_scan(add, arr, backend="pallas", seed=arr[0])
    with pytest.raises(ValueError, match="float dtype"):
        scan(torch.add, torch.arange(16), backend="pallas")
    with pytest.raises(ValueError, match="float dtype"):
        ref_scan(jnp.add, jnp.arange(16), backend="pallas")
    with pytest.raises(ValueError, match="not divisible"):
        scan(torch.add, torch.arange(1.0, 18.0), backend="pallas", num_blocks=4)
    with pytest.raises(ValueError, match="not divisible"):
        ref_scan(jnp.add, jnp.arange(1.0, 18.0), backend="pallas", num_blocks=4,
                 interpret=True)


def test_round_tables_are_cached_per_plan_and_device():
    """The backend's operands hang off the plan, one entry a device (no
    lookup keyed by the plan's mask): a second call reuses them."""
    lowered_cache.clear()
    x = torch.arange(1.0, 42.0)
    scan(torch.add, x, backend="pallas", algorithm="brent_kung")
    plan = get_plan("brent_kung", 41)
    ops = plan.scratch[("pallas", "cpu")][("plan", 1)]
    y = scan(torch.add, x, backend="pallas", algorithm="brent_kung")
    assert plan.scratch[("pallas", "cpu")][("plan", 1)] is ops
    assert lowered_cache.stats() == {"hits": 0, "misses": 0, "size": 0}
    assert torch.equal(y, torch.cumsum(x, 0))


def test_cpu_tensors_launch_nothing():
    reset_launch_counts()
    scan(torch.add, torch.arange(1.0, 65.0), backend="pallas")
    scan(torch.maximum, torch.arange(1.0, 65.0), backend="pallas", num_blocks=8)
    assert not any(launch_counts().values())


def test_off_cpu_an_op_or_dtype_outside_the_table_raises_before_launch():
    """Tensors off the CPU take the kernels: an op or dtype they do not
    carry raises KernelOpError naming the table, in both modes, before any
    launch (``meta`` tensors stand in for the card here)."""
    x = torch.ones(64, device="meta")
    reset_launch_counts()
    for kw in ({}, {"num_blocks": 4}):
        with pytest.raises(KernelOpError, match="rigid_compose"):
            scan(lambda a, b: a + b, x, backend="pallas", **kw)
        with pytest.raises(KernelOpError, match="float32"):
            scan(torch.add, x.double(), backend="pallas", **kw)
    assert not any(launch_counts().values())
