"""Counterpart of ``tests/test_engine_backends.py`` for the port: every
ported backend of ``repro_torch.core.engine`` equals the sequential
left-fold oracle, at the reference test's sizes, circuits and tolerances.

The reference's ``collective`` case runs on an 8-position CPU mesh of
``repro_torch.core.spmd`` (the reference's runs on 8 virtual devices)."""

import numpy as np
import pytest
import torch

from repro_torch.core.circuits import get_circuit
from repro_torch.core.engine import available_backends, scan
from repro_torch.core.scan import python_exec
from repro_torch.runtime import scheduler

CIRCUITS = ["ladner_fischer", "dissemination", "blelloch"]
SIZES = list(range(1, 18)) + [64, 100]


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    yield
    pool = scheduler.get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    scheduler.set_default_pool(None)


def _oracle(vals):
    """Sequential left-fold oracle (== python_exec on the sequential circuit,
    asserted once in test_oracle_is_python_exec)."""
    out = [vals[0]]
    for v in vals[1:]:
        out.append(out[-1] + v)
    return np.asarray(out)


def test_oracle_is_python_exec():
    n = 13
    vals = [float(i) for i in range(1, n + 1)]
    ys, _ = python_exec(lambda a, b: a + b, get_circuit("sequential", n), vals)
    np.testing.assert_allclose(ys, _oracle(vals))


def test_registry_exposes_all_backends():
    assert {"vector", "element", "blocked", "worksteal", "collective",
            "simulate", "pallas", "hierarchical", "decoupled"} <= set(
                available_backends())


# ----------------------------------------------------------- array backends
@pytest.mark.parametrize("alg", CIRCUITS)
@pytest.mark.parametrize("n", SIZES)
def test_vector_matches_oracle(alg, n):
    x = np.linspace(0.5, 2.0, n)
    y = scan(lambda a, b: a + b, torch.as_tensor(x), backend="vector",
             algorithm=alg)
    np.testing.assert_allclose(y.numpy(), _oracle(list(x)), rtol=1e-6)


@pytest.mark.parametrize("alg", CIRCUITS)
@pytest.mark.parametrize("n", list(range(1, 18)) + [64])
def test_pallas_matches_oracle(alg, n):
    x = np.linspace(0.5, 2.0, n)
    y = scan(lambda a, b: a + b, torch.as_tensor(x, dtype=torch.float32),
             backend="pallas", algorithm=alg)
    np.testing.assert_allclose(y.numpy(), _oracle(list(x)), rtol=1e-5)


def test_pallas_tiles_matches_oracle():
    n = 64
    x = np.linspace(0.1, 1.0, n)
    y = scan(torch.maximum, torch.as_tensor(x, dtype=torch.float32),
             backend="pallas", num_blocks=8)
    np.testing.assert_allclose(y.numpy(), np.maximum.accumulate(x), rtol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_blocked_matches_oracle(n):
    blocks = max(d for d in range(1, min(8, n) + 1) if n % d == 0)
    x = np.linspace(0.5, 2.0, n)
    y = scan(lambda a, b: a + b, torch.as_tensor(x), backend="blocked",
             num_blocks=blocks)
    np.testing.assert_allclose(y.numpy(), _oracle(list(x)), rtol=1e-6)


# --------------------------------------------------------- element backends
@pytest.mark.parametrize("alg", CIRCUITS)
@pytest.mark.parametrize("n", SIZES)
def test_element_backends_match_oracle(alg, n):
    vals = [float(i) * 0.5 for i in range(1, n + 1)]
    ys = scan(lambda a, b: a + b, vals, backend="element", algorithm=alg)
    np.testing.assert_allclose(ys, _oracle(vals), rtol=1e-9)


@pytest.mark.parametrize("alg", CIRCUITS)
@pytest.mark.parametrize("n", SIZES)
def test_simulate_backend_matches_oracle(alg, n):
    vals = [float(i) * 0.5 for i in range(1, n + 1)]
    ys = scan(lambda a, b: a + b, vals, backend="simulate", algorithm=alg)
    np.testing.assert_allclose(ys, _oracle(vals), rtol=1e-9)


@pytest.mark.parametrize("n", SIZES)
def test_worksteal_matches_oracle(n):
    vals = [float(i) * 0.5 for i in range(1, n + 1)]
    t = 4 if n >= 8 else (2 if n >= 4 else 1)
    ys = scan(lambda a, b: a + b, vals, backend="worksteal", num_threads=t)
    np.testing.assert_allclose(ys, _oracle(vals), rtol=1e-9)


@pytest.mark.parametrize("backend", ["collective"])
def test_unported_reference_backends_raise(backend):
    """``collective`` was a stub until it was ported; outside a
    ``shard_map`` with no axis it raises as the reference's does."""
    with pytest.raises(ValueError, match="axis_name"):
        scan(lambda a, b: a + b, [1.0, 2.0, 3.0], backend=backend)


def test_collective_backend_8dev():
    """Counterpart of the reference's ``test_collective_backend_8dev``:
    the engine's ``collective`` backend inside a shard_map of 8 positions."""
    from functools import partial

    from repro_torch.core.spmd import Mesh, P, shard_map

    mesh = Mesh([torch.device("cpu")] * 8, ("x",))
    x = torch.arange(1.0, 9.0, dtype=torch.float64)
    for alg in ["dissemination", "ladner_fischer", "brent_kung", "sklansky"]:
        f = shard_map(partial(scan, lambda a, b: a + b, backend="collective",
                              axis_name="x", axis_size=8, algorithm=alg),
                      mesh, in_specs=P("x"), out_specs=P("x"))
        np.testing.assert_allclose(f(x).numpy(), np.cumsum(np.arange(1, 9)))


# --------------------------------------------------- non-commutative operator
def _affine_op(a, b):
    return (a[0] * b[0], a[1] * b[0] + b[1])


def _affine_oracle(ms, cs):
    rm, rc = [ms[0]], [cs[0]]
    for m, c in zip(ms[1:], cs[1:]):
        rm.append(rm[-1] * m)
        rc.append(rc[-1] * m + c)
    return np.asarray(rm), np.asarray(rc)


@pytest.mark.parametrize("alg", CIRCUITS)
@pytest.mark.parametrize("n", [1, 2, 3, 7, 13, 17, 64])
def test_vector_noncommutative_pytree(alg, n):
    rng = np.random.default_rng(0)
    m = rng.uniform(0.6, 1.1, n).astype(np.float32)
    c = (rng.normal(size=n) * 0.5).astype(np.float32)
    ym, yc = scan(_affine_op, (torch.as_tensor(m), torch.as_tensor(c)),
                  backend="vector", algorithm=alg)
    rm, rc = _affine_oracle(m.astype(np.float64), c.astype(np.float64))
    np.testing.assert_allclose(ym.numpy(), rm, rtol=1e-5)
    np.testing.assert_allclose(yc.numpy(), rc, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("backend", ["element", "worksteal", "simulate"])
def test_element_noncommutative(backend):
    n = 33
    rng = np.random.default_rng(7)
    items = [(float(m), float(c))
             for m, c in zip(rng.uniform(0.7, 1.1, n), rng.normal(0, 0.5, n))]
    kw = {"num_threads": 4} if backend == "worksteal" else {}
    ys = scan(_affine_op, items, backend=backend, **kw)
    rm, rc = _affine_oracle([i[0] for i in items], [i[1] for i in items])
    np.testing.assert_allclose([y[0] for y in ys], rm, rtol=1e-9)
    np.testing.assert_allclose([y[1] for y in ys], rc, rtol=1e-9)
