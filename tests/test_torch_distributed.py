"""The port's multi-device scans (``repro_torch.core.distributed`` over
``repro_torch.core.spmd``): the counterparts of ``tests/test_distributed_scan.py``
on meshes of 8 CPU positions (the reference's run on 8 virtual devices), the
``spmd`` collectives themselves, and parity with the reference's
``shard_map`` outputs.

Parity: one module fixture runs the reference's calls once in a subprocess
with 8 virtual devices, on inputs this module writes with numpy from a
seed, and returns their outputs as numpy.  The port's same calls on the
same inputs must be bit-equal where the data is integer-valued (every
grouping gives the same bits); the affine scan of ``linspace`` floats is
held to the reference test's own tolerances (rtol 1e-5 for m; rtol 1e-4,
atol 1e-5 for c).
"""

import math
import threading
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import spmd
from repro_torch.core.distributed import (
    _axis_size,
    collective_scan,
    distributed_blocked_scan,
    exclusive_collective_scan,
    exclusive_hierarchical_scan,
    hierarchical_collective_scan,
    last_exscan_rounds,
)
from repro_torch.core.engine import scan as engine_scan
from repro_torch.core.engine.backends import lower_collective
from repro_torch.core.spmd import Mesh, P, shard_map

CPU = torch.device("cpu")
ALGS = ["dissemination", "ladner_fischer", "brent_kung", "sklansky"]
SPEC2 = P(("pod", "data"))


def _mesh1(p=8):
    return Mesh([CPU] * p, ("x",))


def _mesh2():
    return Mesh([CPU] * 8, ("pod", "data"), (2, 4))


def _aff(a, b):
    return (a[0] * b[0], a[1] * b[0] + b[1])


def _inputs():
    rng = np.random.default_rng(11)
    n = 64
    where = rng.random(n) < 0.6
    where[:5] = False
    vals = rng.integers(-100, 100, n).astype(np.float32)
    return {
        "x8": np.arange(1.0, 9.0, dtype=np.float32),
        "ints8": rng.integers(0, 100, 8).astype(np.float32),
        "xs64": rng.integers(0, 50, n).astype(np.float32),
        "masked64": np.where(where, vals, -np.inf).astype(np.float32),
        "m64": np.where(rng.random(n) < 0.1, 2.0, 1.0).astype(np.float32),
        "c64": rng.integers(-4, 5, n).astype(np.float32),
        "lin_m": np.linspace(0.9, 1.1, 64).astype(np.float32),
        "lin_c": np.linspace(-1, 1, 64).astype(np.float32),
        "em8": rng.integers(1, 3, 8).astype(np.float32),
        "ec8": rng.integers(-4, 5, 8).astype(np.float32),
    }


REFERENCE_SNIPPET = r"""
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map as _shard_map
from repro.core.distributed import (
    collective_scan, distributed_blocked_scan, exclusive_collective_scan,
    exclusive_hierarchical_scan, hierarchical_collective_scan)

def shard_map(*a, **k):  # one compiled program a call (eager is op by op)
    return jax.jit(_shard_map(*a, **k))

inp = {k: jnp.asarray(v) for k, v in np.load(%(inp)r).items()}
devs = np.array(jax.devices())
mesh1 = Mesh(devs, ("x",))
mesh2 = Mesh(devs.reshape(2, 4), ("pod", "data"))
spec = P(("pod", "data"))
aff = lambda a, b: (a[0] * b[0], a[1] * b[0] + b[1])
add = lambda a, b: a + b
out = {}
for alg in %(algs)r:
    f = shard_map(partial(collective_scan, add, axis_name="x", algorithm=alg,
                          axis_size=8), mesh=mesh1, in_specs=P("x"),
                  out_specs=P("x"))
    out["collective_" + alg] = f(inp["x8"])
f = shard_map(partial(exclusive_collective_scan, add, axis_name="x",
                      axis_size=8), mesh=mesh1, in_specs=P("x"), out_specs=P("x"))
out["exscan"] = f(inp["ints8"])
f = shard_map(partial(hierarchical_collective_scan, add,
                      axis_names=("pod", "data"), axis_sizes=(2, 4)),
              mesh=mesh2, in_specs=spec, out_specs=spec)
out["hier"] = f(inp["ints8"])
f = shard_map(partial(exclusive_hierarchical_scan, jnp.add,
                      axis_names=("pod", "data"), axis_sizes=(2, 4)),
              mesh=mesh2, in_specs=spec, out_specs=spec)
out["exhier"] = f(inp["ints8"])
for strat in ("scan_then_map", "reduce_then_scan"):
    for tag, algs in (("", None), ("_lf", ["ladner_fischer", "sklansky"])):
        f = shard_map(partial(distributed_blocked_scan, add,
                              axis_names=("pod", "data"), strategy=strat,
                              algorithms=algs, axis_sizes=(2, 4)),
                      mesh=mesh2, in_specs=spec, out_specs=spec)
        out["blocked_" + strat + tag] = f(inp["xs64"])
f = shard_map(partial(distributed_blocked_scan, jnp.maximum,
                      axis_names=("pod", "data"), axis_sizes=(2, 4)),
              mesh=mesh2, in_specs=spec, out_specs=spec)
out["max_masked"] = f(inp["masked64"])
for tag, algs in (("", None), ("_ex", ["exscan", "ladner_fischer"])):
    f = shard_map(partial(distributed_blocked_scan, aff,
                          axis_names=("pod", "data"), axis_sizes=(2, 4),
                          algorithms=algs),
                  mesh=mesh2, in_specs=(spec,), out_specs=spec)
    out["aff_m" + tag], out["aff_c" + tag] = f((inp["m64"], inp["c64"]))
f = shard_map(partial(distributed_blocked_scan, aff,
                      axis_names=("pod", "data"), axis_sizes=(2, 4)),
              mesh=mesh2, in_specs=(spec,), out_specs=spec)
out["lin_m"], out["lin_c"] = f((inp["lin_m"], inp["lin_c"]))
f = shard_map(partial(exclusive_collective_scan, aff, axis_name="x",
                      axis_size=8), mesh=mesh1, in_specs=(P("x"),),
              out_specs=P("x"))
out["exaff_m"], out["exaff_c"] = f((inp["em8"], inp["ec8"]))
np.savez(%(out)r, **{k: np.asarray(v) for k, v in out.items()})
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    """The reference's shard_map outputs on :func:`_inputs`, as numpy."""
    d = tmp_path_factory.mktemp("distributed_parity")
    inp, out = str(d / "inputs.npz"), str(d / "outputs.npz")
    np.savez(inp, **_inputs())
    text = subproc(REFERENCE_SNIPPET % {"inp": inp, "out": out, "algs": ALGS},
                   devices=8)
    assert "REFERENCE_OK" in text
    return dict(np.load(out))


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _equal(got, want, what):
    g = got.numpy()
    assert g.shape == want.shape and np.array_equal(g, want), (what, g, want)


# ---------------------------------------------------------------------------
# counterparts of tests/test_distributed_scan.py
# ---------------------------------------------------------------------------


def test_distributed_scans_8dev(reference):
    inp = _inputs()
    add = lambda a, b: a + b  # noqa: E731
    x = _t(inp["x8"])
    want = np.cumsum(np.arange(1, 9))
    for alg in ALGS:
        f = shard_map(partial(collective_scan, add, axis_name="x",
                              algorithm=alg, axis_size=8),
                      _mesh1(), in_specs=P("x"), out_specs=P("x"))
        y = f(x)
        np.testing.assert_allclose(y.numpy(), want)
        _equal(y, reference["collective_" + alg], alg)

    f = shard_map(partial(hierarchical_collective_scan, add,
                          axis_names=("pod", "data"), axis_sizes=(2, 4)),
                  _mesh2(), in_specs=SPEC2, out_specs=SPEC2)
    np.testing.assert_allclose(f(x).numpy(), want)
    _equal(f(_t(inp["ints8"])), reference["hier"], "hier")

    xs = torch.arange(1.0, 65.0)
    for strat in ["scan_then_map", "reduce_then_scan"]:
        f = shard_map(partial(distributed_blocked_scan, add,
                              axis_names=("pod", "data"), strategy=strat,
                              axis_sizes=(2, 4)),
                      _mesh2(), in_specs=SPEC2, out_specs=SPEC2)
        np.testing.assert_allclose(f(xs).numpy(), np.cumsum(np.arange(1, 65)))
        for tag, algs in (("", None), ("_lf", ["ladner_fischer", "sklansky"])):
            g = shard_map(partial(distributed_blocked_scan, add,
                                  axis_names=("pod", "data"), strategy=strat,
                                  algorithms=algs, axis_sizes=(2, 4)),
                          _mesh2(), in_specs=SPEC2, out_specs=SPEC2)
            _equal(g(_t(inp["xs64"])), reference["blocked_" + strat + tag],
                   strat + tag)

    # non-commutative affine op across the hierarchy
    m, c = _t(inp["lin_m"]), _t(inp["lin_c"])
    rm, rc = [m[0]], [c[0]]
    for i in range(1, 64):
        rm.append(rm[-1] * m[i])
        rc.append(rc[-1] * m[i] + c[i])
    f = shard_map(partial(distributed_blocked_scan, _aff,
                          axis_names=("pod", "data"),
                          strategy="reduce_then_scan", axis_sizes=(2, 4)),
                  _mesh2(), in_specs=(SPEC2,), out_specs=SPEC2)
    ym, yc = f((m, c))
    np.testing.assert_allclose(ym.numpy(), torch.stack(rm).numpy(), rtol=1e-5)
    np.testing.assert_allclose(yc.numpy(), torch.stack(rc).numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ym.numpy(), reference["lin_m"], rtol=1e-5)
    np.testing.assert_allclose(yc.numpy(), reference["lin_c"], rtol=1e-4,
                               atol=1e-5)


def test_hierarchical_two_axis_oracle_8dev(reference):
    inp = _inputs()
    # --- exclusive hierarchical scan: integers, bit for bit
    xs = _t(inp["ints8"])
    f = shard_map(partial(exclusive_hierarchical_scan, torch.add,
                          axis_names=("pod", "data"), axis_sizes=(2, 4)),
                  _mesh2(), in_specs=SPEC2, out_specs=SPEC2)
    got = f(xs)
    want = np.concatenate([[0.0], np.cumsum(inp["ints8"])[:-1]])
    assert np.array_equal(got.numpy(), want), (got, want)
    _equal(got, reference["exhier"], "exhier")
    # the inner "data" axis first (ceil(log2 4) = 2 rounds), then the outer
    # "pod" axis (ceil(log2 2) = 1 round)
    assert dist._exscan_rounds_log[-2:] == [2, 1], dist._exscan_rounds_log

    # --- seeded: fold the seed into element 0 before the distributed scan
    seed = 1000.0
    xs64 = _t(inp["xs64"])
    seeded = xs64.clone()
    seeded[0] += seed
    f = shard_map(partial(distributed_blocked_scan, torch.add,
                          axis_names=("pod", "data"), axis_sizes=(2, 4),
                          strategy="reduce_then_scan"),
                  _mesh2(), in_specs=SPEC2, out_specs=SPEC2)
    oracle = engine_scan(torch.add, xs64, backend="vector") + seed
    assert torch.equal(f(seeded), oracle)

    # --- masked: where=False elements pre-masked to -inf under max
    masked = _t(inp["masked64"])
    f = shard_map(partial(distributed_blocked_scan, torch.maximum,
                          axis_names=("pod", "data"), axis_sizes=(2, 4),
                          strategy="reduce_then_scan"),
                  _mesh2(), in_specs=SPEC2, out_specs=SPEC2)
    got = f(masked)
    assert torch.equal(got, engine_scan(torch.maximum, masked,
                                        backend="vector"))
    _equal(got, reference["max_masked"], "max_masked")

    # --- pytree compose: integer-valued affine maps, bit-exact
    m, c = _t(inp["m64"]), _t(inp["c64"])
    for tag, algorithms in (("", None), ("_ex", ["exscan", "ladner_fischer"])):
        f = shard_map(partial(distributed_blocked_scan, _aff,
                              axis_names=("pod", "data"), axis_sizes=(2, 4),
                              strategy="reduce_then_scan",
                              algorithms=algorithms),
                      _mesh2(), in_specs=(SPEC2,), out_specs=SPEC2)
        ym, yc = f((m, c))
        om, oc = engine_scan(_aff, (m, c), backend="vector")
        assert torch.equal(ym, om) and torch.equal(yc, oc)
        _equal(ym, reference["aff_m" + tag], "aff_m" + tag)
        _equal(yc, reference["aff_c" + tag], "aff_c" + tag)

    # --- single-axis exscan across all 8 positions, pytree payload
    f = shard_map(partial(exclusive_collective_scan, _aff, axis_name="x",
                          axis_size=8),
                  _mesh1(), in_specs=(P("x"),), out_specs=P("x"))
    em, ec = f((_t(inp["em8"]), _t(inp["ec8"])))
    assert last_exscan_rounds() == 3  # ceil(log2 8)
    assert em[0] == 0.0 and ec[0] == 0.0  # position 0 receives the init
    _equal(em, reference["exaff_m"], "exaff_m")
    _equal(ec, reference["exaff_c"], "exaff_c")

    # --- the plain exscan's values against the reference's
    f = shard_map(partial(exclusive_collective_scan, torch.add, axis_name="x"),
                  _mesh1(), in_specs=P("x"), out_specs=P("x"))
    _equal(f(xs), reference["exscan"], "exscan")


# Eq. (1)-(4): depth/work of the two strategies, counted exactly with a
# pure-python blocked scan mirroring scan.py's structure (the reference
# test's oracle), then on the port's distributed_blocked_scan itself.


def _blocked_python(xs, p, strategy, op_counter):
    n = len(xs)
    k = n // p
    segs = [xs[i * k: (i + 1) * k] for i in range(p)]
    if strategy == "scan_then_map":
        local = []
        for seg in segs:
            acc = [seg[0]]
            for e in seg[1:]:
                acc.append(op_counter(acc[-1], e))
            local.append(acc)
        partials = [loc[-1] for loc in local]
        gscan = [partials[0]]
        for e in partials[1:]:
            gscan.append(op_counter(gscan[-1], e))
        out = list(local[0])
        for i in range(1, p):
            seg = local[i]
            # inclusive trick: the last element is gscan[i] itself (free)
            out.extend([op_counter(gscan[i - 1], e) for e in seg[:-1]])
            out.append(gscan[i])
        return out
    partials = []
    for seg in segs:
        acc = seg[0]
        for e in seg[1:]:
            acc = op_counter(acc, e)
        partials.append(acc)
    gscan = [partials[0]]
    for e in partials[1:]:
        gscan.append(op_counter(gscan[-1], e))
    out = []
    for i, seg in enumerate(segs):
        acc = None if i == 0 else gscan[i - 1]
        for e in seg:
            acc = e if acc is None else op_counter(acc, e)
            out.append(acc)
    return out


@pytest.mark.parametrize("strategy,extra_work", [
    # Eq. (2): W = 2N - 2P - N/P + 1 + W_GS   (scan-then-map)
    ("scan_then_map", lambda n, p: 2 * n - 2 * p - n // p + 1),
    # Eq. (4): W = 2N - P + W_GS              (reduce-then-scan)
    ("reduce_then_scan", lambda n, p: 2 * n - p),
])
def test_strategy_work_formulas(strategy, extra_work):
    n, p = 64, 8
    count = {"ops": 0}

    def op(a, b):
        count["ops"] += 1
        return a + b

    out = _blocked_python(list(range(1, n + 1)), p, strategy, op)
    assert out == [int(x) for x in np.cumsum(np.arange(1, n + 1))]
    w_gs = p - 1  # sequential global scan in this accounting
    expected = extra_work(n, p) + w_gs
    if strategy == "reduce_then_scan":
        # The paper counts phase 3 uniformly as W_LP2 = P*(N/P) = N,
        # including a seed application for worker 0 which has no seed.
        expected -= 1
    assert count["ops"] == expected, (strategy, count["ops"], expected)

    # The port's distributed scan: element applications (a batched apply of
    # k rows counts k), the global phase the Träff exscan over the 8
    # positions.  Its scan-then-map maps every row of a later block (the
    # reference's shard_map does too), so p - 1 more than the trick above.
    lock = threading.Lock()
    applied = {"ops": 0}

    def counted(a, b):
        with lock:
            applied["ops"] += max(1, a.numel())
        return a + b

    f = shard_map(partial(distributed_blocked_scan, counted, axis_names=("x",),
                          strategy=strategy),
                  _mesh1(p), in_specs=P("x"), out_specs=P("x"))
    y = f(torch.arange(1, n + 1, dtype=torch.int64))
    assert torch.equal(y, torch.cumsum(torch.arange(1, n + 1), 0))
    w_ex = sum(int(r.dst_mask.sum())
               for r in lower_collective(dist.exscan_plan(p), registers=2))
    want = extra_work(n, p) + w_ex
    want += (p - 1) if strategy == "scan_then_map" else -1
    assert applied["ops"] == want, (strategy, applied["ops"], want)


# ---------------------------------------------------------------------------
# spmd: the shard_map counterpart
# ---------------------------------------------------------------------------


def test_spmd_collectives_two_axis_groups():
    """On a 2x4 mesh a collective over "data" stays inside its "pod";
    ppermute gives zeros to a position nothing is sent to; all_gather is in
    axis order and psum adds in axis order."""
    mesh = _mesh2()

    def body(x):
        pod, data = spmd.axis_index("pod"), spmd.axis_index("data")
        assert (spmd.axis_size("pod"), spmd.axis_size("data")) == (2, 4)
        assert spmd.position() == pod * 4 + data
        shifted = spmd.ppermute(x, "data", [(0, 1), (1, 2), (2, 3)])
        gathered = spmd.all_gather(x, "data")
        total = spmd.psum(x, "pod")
        return torch.cat([shifted, gathered.reshape(-1), total])

    x = torch.arange(8.0) * 10
    y = shard_map(body, mesh, P(("pod", "data")), P(("pod", "data")))(x)
    y = y.reshape(8, 6)
    for i in range(8):
        pod, data = divmod(i, 4)
        assert y[i, 0] == (0.0 if data == 0 else x[i - 1])
        assert torch.equal(y[i, 1:5], x[pod * 4: pod * 4 + 4])
        assert y[i, 5] == x[data] + x[4 + data]


def test_spmd_specs_replicate_and_split():
    mesh = _mesh2()

    def body(a, b):
        return a + b.sum()

    a = torch.arange(16.0)
    b = torch.ones(3)
    y = shard_map(body, mesh, (SPEC2, P()), SPEC2)(a, b)
    assert torch.equal(y, a + 3)
    # A spec over "pod" only: positions of one pod share its block, and the
    # output takes the positions at data index 0.
    y = shard_map(lambda t: t * (1 + spmd.axis_index("data")), mesh, P("pod"),
                  P("pod"))(a)
    assert torch.equal(y, a)
    with pytest.raises(ValueError, match="split"):
        shard_map(body, mesh, (SPEC2, P()), SPEC2)(torch.arange(6.0), b)


def test_spmd_raising_body_does_not_hang():
    """A body that raises in one position aborts the rendezvous: the others
    leave their collective, and shard_map raises the error in the caller
    (checked under its own 60 s timeout)."""
    mesh = _mesh1()

    def body(x):
        spmd.psum(x, "x")
        if spmd.axis_index("x") == 5:
            raise KeyError("position 5 failed")
        return spmd.psum(x, "x")

    result = {}

    def call():
        try:
            shard_map(body, mesh, P("x"), P("x"))(torch.arange(8.0))
        except BaseException as e:  # noqa: BLE001 — asserted below
            result["error"] = e

    t = threading.Thread(target=call, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "shard_map hung after a position raised"
    assert isinstance(result.get("error"), KeyError)
    assert "position 5" in str(result["error"])


def test_collectives_outside_shard_map_raise():
    with pytest.raises(RuntimeError, match="shard_map"):
        spmd.ppermute(torch.ones(1), "x", [(0, 1)])
    with pytest.raises(RuntimeError, match="shard_map"):
        spmd.axis_index("x")
    with pytest.raises(ValueError, match="axis_size="):
        _axis_size("x", None)
    assert _axis_size("x", 8) == 8
    # Inside a shard_map the size comes from the mesh; an unknown axis raises.
    sizes = shard_map(lambda t: t * _axis_size("x", None), _mesh1(4), P("x"),
                      P("x"))(torch.ones(4))
    assert torch.equal(sizes, torch.full((4,), 4.0))
    with pytest.raises(NameError, match="unbound axis"):
        shard_map(lambda t: spmd.psum(t, "y"), _mesh1(4), P("x"),
                  P("x"))(torch.ones(4))


@pytest.mark.parametrize("p", [2, 3, 5, 8])
def test_exclusive_collective_scan_rounds(p):
    """ceil(log2 p) rounds for any p, and every position's exclusive prefix
    of integer data."""
    x = torch.arange(1.0, p + 1.0)
    f = shard_map(partial(exclusive_collective_scan, torch.add, axis_name="x"),
                  _mesh1(p), P("x"), P("x"))
    y = f(x)
    assert last_exscan_rounds() == math.ceil(math.log2(p))
    want = torch.cat([torch.zeros(1), torch.cumsum(x, 0)[:-1]])
    assert torch.equal(y, want)
