"""Port parity: ``repro_torch.core.registration`` against ``repro.core.registration``.

Frames come from the reference's ``data/images.py`` as numpy; both packages
register the same pairs.  Function A descends in float32 along two
frameworks' rounding, so the two minimisers are held to the ground truth
(0.35 px, the reference's own bound) and to each other (0.05 px, 1e-3 rad).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.registration import (
    RegistrationConfig as RefConfig,
    register_pair as ref_register_pair,
)
from repro.data.images import make_series
from repro_torch.core import registration as reg
from repro_torch.core.deformation import compose, ncc_distance
from repro_torch.core.engine import scan
from repro_torch.interop import (
    elements_from_numpy,
    elements_to_numpy,
    registration_config,
)
from repro_torch.runtime import scheduler


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    # One intra-op thread: the suite runs several test processes at once,
    # and small tensors gain nothing from more.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    pool = scheduler.get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    scheduler.set_default_pool(None)


@pytest.fixture(scope="module")
def series64():
    frames, true = make_series(jax.random.PRNGKey(3), 6, size=64, noise=0.15)
    return np.array(frames), {k: np.array(v) for k, v in true.items()}


def _pair_truth(true, i, k):
    return true["shift"][k] - true["shift"][i], true["angle"][k] - true["angle"][i]


@pytest.mark.parametrize("i,k", [(0, 1), (1, 2), (2, 4)])
def test_register_pair_matches_reference(series64, i, k):
    frames, true = series64
    cfg = RefConfig()
    rj = ref_register_pair(frames[i], frames[k], None, cfg)
    rt = reg.register_pair(torch.from_numpy(frames[i]), torch.from_numpy(frames[k]),
                           None, registration_config(dataclasses.asdict(cfg)))
    sj = np.asarray(rj.deformation["shift"])
    st = rt.deformation["shift"].numpy()
    true_shift = true["shift"][k] - true["shift"][i]
    assert np.abs(sj - true_shift).max() < 0.35
    assert np.abs(st - true_shift).max() < 0.35
    assert np.abs(st - sj).max() < 0.05
    assert abs(float(rt.deformation["angle"]) - float(rj.deformation["angle"])) < 1e-3
    assert int(rt.iterations) > 0


@pytest.mark.parametrize("lane", [0, 2, 4])
def test_batch_independence_bit_exact(series64, lane):
    """Per-lane freezing: a pair's result and iteration count do not depend
    on the batch it runs in."""
    frames, _ = series64
    refs = torch.from_numpy(frames[:-1])
    tmps = torch.from_numpy(frames[1:])
    batch = reg.register_pair(refs, tmps)
    solo = reg.register_pair(refs[lane], tmps[lane])
    for key in ("angle", "shift"):
        assert torch.equal(batch.deformation[key][lane], solo.deformation[key])
    assert int(batch.iterations[lane]) == int(solo.iterations)
    assert torch.equal(batch.distance[lane], solo.distance)


def test_iterations_are_per_lane(series64):
    frames, _ = series64
    res = reg.register_pair(torch.from_numpy(frames[:-1]), torch.from_numpy(frames[1:]))
    its = res.iterations.tolist()
    assert len(set(its)) > 1, its  # not the cohort maximum everywhere


def test_register_pair_with_init(series64):
    frames, true = series64
    sh, ang = _pair_truth(true, 0, 2)
    init = {"angle": torch.tensor(float(ang)), "shift": torch.tensor(sh)}
    res = reg.register_pair(torch.from_numpy(frames[0]), torch.from_numpy(frames[2]), init)
    assert np.abs(res.deformation["shift"].numpy() - sh).max() < 0.35


def test_preprocess_batched_matches_sequential(series64):
    frames, _ = series64
    r = reg.SeriesRegistrar(torch.from_numpy(frames[:4]))
    seq = r.preprocess()
    bat = r.preprocess_vmapped()
    for a, b in zip(seq, bat):
        assert (a.i, a.k) == (b.i, b.k)
        for key in ("angle", "shift"):
            assert torch.equal(a.deformation[key], b.deformation[key])


@pytest.mark.parametrize("fused", [False, True])
def test_skip_path_equals_pure_composition_scan(series64, fused):
    """skip_tol=2.0 exceeds any 1 - NCC, so every guess is skipped and the
    scan is the pure composition scan (refine=False)."""
    frames, _ = series64
    fr = torch.from_numpy(frames)
    registrar = reg.SeriesRegistrar(fr)
    elems = registrar.preprocess_vmapped()
    op = reg.RegistrationOperator(registrar, skip_tol=2.0, fused=fused)
    got = scan(op, elems, backend="worksteal", num_threads=2)
    assert op.refined == 0 and op.skipped > 0
    pure = reg.SeriesRegistrar(fr, refine=False)
    want = scan(pure.op, elems, backend="element", algorithm="sequential")
    for g, w in zip(got, want):
        assert (g.i, g.k) == (w.i, w.k)
        for key in ("angle", "shift"):
            torch.testing.assert_close(g.deformation[key], w.deformation[key],
                                       rtol=1e-6, atol=1e-5)


def test_fused_distance_matches_plain(series64):
    frames, _ = series64
    fr = torch.from_numpy(frames)
    d = {"angle": torch.tensor(0.01), "shift": torch.tensor([0.5, -1.0])}
    for tile in (16, 32):
        np.testing.assert_allclose(
            float(reg.fused_ncc_distance(fr[0], fr[1], d, tile=tile)),
            float(ncc_distance(fr[0], fr[1], d)), atol=1e-5,
        )


def test_fused_default_follows_device():
    assert not reg.fused_default("cpu", (64, 64))
    assert reg.fused_default("cuda", (64, 64))
    assert not reg.fused_default("cuda", (64, 40))
    assert reg.fused_default("cpu", (64, 64), fused=True)
    assert not reg.fused_default("cpu", (64, 48), fused=True)
    assert reg.fused_ncc_eligible((64, 96)) and not reg.fused_ncc_eligible((64, 100))


def test_operator_telemetry_and_compile_classification(series64):
    frames, _ = series64
    reg.RegistrationOperator._reset_compile_tracking()
    registrar = reg.SeriesRegistrar(torch.from_numpy(frames))
    elems = registrar.preprocess_vmapped()
    op = reg.RegistrationOperator(registrar, skip_tol=1e-9)
    assert op.op_cost_estimate is None and op.op_imbalance_estimate is None
    op.prime(0.5)
    assert op.op_cost_estimate == pytest.approx(0.5)
    out = op(elems[0], elems[1])
    assert (out.i, out.k) == (0, 2)
    assert op.telemetry.compile_calls == 1  # first call under a fresh signature
    op(elems[1], elems[2])
    assert op.telemetry.calls == 2 and op.refined == 2 and op.skipped == 0
    with pytest.raises(ValueError, match="non-adjacent"):
        op(elems[0], elems[2])


def test_element_cost_estimates():
    registrar = reg.SeriesRegistrar(torch.zeros((5, 32, 32)))
    op = reg.RegistrationOperator(registrar)
    assert op.element_cost_estimates(4) is None
    op.prime_elements([1.0, 1.0, 4.0, 2.0])
    est = op.element_cost_estimates(4)
    assert est == pytest.approx([0.5, 0.5, 2.0, 1.0])
    assert op.element_cost_estimates(3) is None


def test_operator_matches_reference_operator_on_one_combine(series64):
    """One refining application of (.)_B in both packages."""
    from repro.core.registration import RegElement as RefElement
    from repro.core.registration import SeriesRegistrar as RefRegistrar

    frames, true = series64
    rr = RefRegistrar(frames)
    pre = rr.preprocess_vmapped()
    want = rr.op(pre[0], pre[1])
    rt = reg.SeriesRegistrar(torch.from_numpy(frames))
    a, b = elements_from_numpy(
        [(jax.device_get(e.deformation), e.i, e.k) for e in pre[:2]]
    )
    got = rt.op(a, b)
    assert isinstance(want, RefElement) and (got.i, got.k) == (want.i, want.k)
    sh = np.asarray(want.deformation["shift"])
    [(got_np, i, k)] = elements_to_numpy([got])
    assert (i, k) == (0, 2)
    assert np.abs(got_np["shift"] - sh).max() < 0.05
    assert np.abs(sh - (true["shift"][2] - true["shift"][0])).max() < 0.35
    g = compose(a.deformation, b.deformation)
    assert g["angle"].shape == ()
