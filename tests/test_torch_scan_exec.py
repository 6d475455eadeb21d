"""Port parity: the single-process scan executors (``repro_torch.core.scan``)
against ``repro.core.scan``, the torch counterparts of
``tests/test_scan_exec.py``: each case runs the same numpy inputs through
both packages and holds the port to the reference's output and to the
reference test's own oracle, at the reference test's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline container: deterministic fallback sampler
    from _hypothesis_shim import given, settings, strategies as st

from repro.core import scan as ref
from repro_torch.core import scan as port

ALGS = ["sequential", "dissemination", "blelloch", "ladner_fischer",
        "brent_kung", "sklansky"]


def _matmul_j(a, b):
    return jnp.einsum("...ij,...jk->...ik", a, b)


def _matmul_t(a, b):
    return torch.einsum("...ij,...jk->...ik", a, b)


def _affine(a, b):
    return (a[0] * b[0], a[1] * b[0] + b[1])


def _matrices(n, seed, spread):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 2, 2)) * spread + np.eye(2)).astype(np.float32)


def _chain(m):
    out = [m[0].astype(np.float64)]
    for i in range(1, len(m)):
        out.append(out[-1] @ m[i])
    return np.stack(out)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 16, 37, 64, 100])
def test_scan_add(alg, n):
    x = np.arange(1.0, n + 1, dtype=np.float32)
    got = port.prefix_scan(lambda a, b: a + b, torch.from_numpy(x),
                           algorithm=alg)
    want = ref.prefix_scan(lambda a, b: a + b, jnp.asarray(x), algorithm=alg)
    np.testing.assert_allclose(_np(got), np.cumsum(np.arange(1, n + 1)),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


@pytest.mark.parametrize("alg", ALGS[1:])
def test_scan_matmul_noncommutative(alg):
    m = _matrices(33, 0, 0.3)
    got = port.prefix_scan(_matmul_t, torch.from_numpy(m), algorithm=alg)
    want = ref.prefix_scan(_matmul_j, jnp.asarray(m), algorithm=alg)
    np.testing.assert_allclose(_np(got), _chain(m), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("alg", ["ladner_fischer", "blelloch"])
def test_scan_pytree_elements(alg):
    """Elements may be trees (the affine/SSM-state operator)."""
    rng = np.random.default_rng(1)
    n = 24
    m = rng.uniform(0.5, 1.0, n).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    ym, yc = port.prefix_scan(_affine, (torch.from_numpy(m),
                                        torch.from_numpy(c)), algorithm=alg)
    rm, rc = ref.prefix_scan(_affine, (jnp.asarray(m), jnp.asarray(c)),
                             algorithm=alg)
    om, oc = [m[0]], [c[0]]
    for i in range(1, n):
        om.append(om[-1] * m[i])
        oc.append(oc[-1] * m[i] + c[i])
    np.testing.assert_allclose(_np(ym), np.stack(om), rtol=1e-5)
    np.testing.assert_allclose(_np(yc), np.stack(oc), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(ym), _np(rm), rtol=1e-5)
    np.testing.assert_allclose(_np(yc), _np(rc), rtol=1e-4, atol=1e-6)


def test_exclusive_scan():
    x = np.arange(1.0, 9.0, dtype=np.float32)
    got = port.exclusive_scan(lambda a, b: a + b, torch.from_numpy(x))
    want = ref.exclusive_scan(lambda a, b: a + b, jnp.asarray(x))
    np.testing.assert_allclose(_np(got)[1:], np.cumsum(np.arange(1, 8)))
    # out[0] is x[0], the identity stand-in, in both packages.
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("strategy", ["scan_then_map", "reduce_then_scan"])
@pytest.mark.parametrize("alg", ["dissemination", "ladner_fischer", "blelloch"])
def test_blocked_scan(strategy, alg):
    x = np.arange(1.0, 97.0, dtype=np.float32)
    got = port.blocked_scan(lambda a, b: a + b, torch.from_numpy(x),
                            num_blocks=8, strategy=strategy, algorithm=alg)
    want = ref.blocked_scan(lambda a, b: a + b, jnp.asarray(x), num_blocks=8,
                            strategy=strategy, algorithm=alg)
    np.testing.assert_allclose(_np(got), np.cumsum(np.arange(1, 97)),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


def test_blocked_scan_noncommutative():
    m = _matrices(64, 2, 0.2)
    for strategy in ["scan_then_map", "reduce_then_scan"]:
        got = port.blocked_scan(_matmul_t, torch.from_numpy(m), num_blocks=8,
                                strategy=strategy)
        want = ref.blocked_scan(_matmul_j, jnp.asarray(m), num_blocks=8,
                                strategy=strategy)
        np.testing.assert_allclose(_np(got), _chain(m), rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-3, atol=1e-5)


def test_scan_jittable():
    """The reference jits its scan; the port runs eagerly, and a repeated
    call (its plan now cached) agrees with the first and with the
    reference's jitted scan."""
    x = np.arange(1.0, 65.0, dtype=np.float32)
    f = jax.jit(lambda v: ref.prefix_scan(lambda a, b: a + b, v,
                                          algorithm="ladner_fischer"))
    want = _np(f(jnp.asarray(x)))
    for _ in range(2):
        got = port.prefix_scan(lambda a, b: a + b, torch.from_numpy(x),
                               algorithm="ladner_fischer")
        np.testing.assert_allclose(_np(got), np.cumsum(np.arange(1, 65)),
                                   rtol=1e-6)
        np.testing.assert_allclose(_np(got), want, rtol=1e-6)


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(1, 50),
    alg=st.sampled_from(ALGS),
    seed=st.integers(0, 2**31 - 1),
)
def test_property_scan_matches_oracle(n, alg, seed):
    """Property: any algorithm == sequential oracle for max (associative,
    non-invertible, idempotent), in both packages bit for bit."""
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    got = port.prefix_scan(torch.maximum, torch.from_numpy(x), algorithm=alg)
    want = ref.prefix_scan(jnp.maximum, jnp.asarray(x), algorithm=alg)
    np.testing.assert_array_equal(_np(got), np.maximum.accumulate(x))
    np.testing.assert_array_equal(_np(got), _np(want))
