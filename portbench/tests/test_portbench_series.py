"""The benchmark's series generator: ground truth at a small non-square
size, checked with the plain reference alone."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import judge, series  # noqa: E402
from portbench.reference import compose, registration  # noqa: E402

CFG = {"height": 72, "width": 104, "lattice_period": 12.0, "noise": 0.15,
       "distortion": 0.15, "blobs": 6, "specimen_seed": 1410}
DRIFT = {"drift_step_periods": 0.35, "rotation_step": 0.002, "chunk_frames": 4,
         "path_seed": 2010}
REG = {"levels": 2, "max_iters": 300, "lr_shift": 1.0, "lr_angle": 5e-4,
       "tol": 1e-7, "estimate_rotation": True}

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread, so that a test run with
    many workers does not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def test_same_seed_same_series_and_large_seeds():
    a, ta = series.make_series(2**33 + 5, CFG, DRIFT, 5, "cpu")
    b, tb = series.make_series(2**33 + 5, CFG, DRIFT, 5, "cpu")
    c, _ = series.make_series(2**33 + 6, CFG, DRIFT, 5, "cpu")
    assert torch.equal(a, b) and torch.equal(ta["shift"], tb["shift"])
    assert not torch.equal(a, c)
    assert a.shape == (5, 72, 104) and a.dtype == torch.float32


def test_truth_maps_every_frame_back_onto_frame_zero():
    """Without noise, frame i sampled at phi_i(x) is frame 0 wherever
    phi_i(x) stays inside the frame: f_i o phi_i == f_0."""
    cfg = dict(CFG, noise=0.0)
    frames, truth = series.make_series(11, cfg, DRIFT, 6, "cpu")
    ang = truth["angle"].float()
    sh = truth["shift"].float()
    back = registration.warp(frames, ang, sh)
    m = 12   # keep clear of the border the drift uncovers
    err = (back - frames[0:1])[:, m:-m, m:-m].abs().max()
    # Bilinear sampling of a 12-px lattice is good to ~0.1 of its unit std.
    assert float(err) < 0.15, float(err)
    wrong = registration.warp(frames, ang, -sh)[1:, m:-m, m:-m]
    assert float((wrong - frames[0:1, m:-m, m:-m]).abs().max()) > 0.5


def test_pair_truth_composes_to_the_cumulative_truth():
    angle, shift = series.trajectory(3, 40, 4.2, 0.002)
    pairs = series.pair_truth(angle, shift)
    chained = compose.chain(pairs)
    gaps = judge.corner_gaps(chained, {"angle": angle[1:], "shift": shift[1:]},
                             1856, 1920)
    assert float(gaps.max()) < 1e-9


def test_reference_function_a_recovers_the_pair_truth():
    frames, truth = series.make_series(7, CFG, DRIFT, 4, "cpu")
    got, iters = registration.register(frames[:-1], frames[1:], REG)
    want = series.pair_truth(truth["angle"], truth["shift"])
    gaps = judge.corner_gaps(got, want, 72, 104)
    assert float(gaps.max()) < 0.35, gaps
    assert bool((iters > 0).all())


def test_every_seed_registers_the_same_path_under_other_noise():
    """The mix's path_seed draws the motion, the run's seed the noise."""
    a, ta = series.make_series(1, CFG, DRIFT, 5, "cpu")
    b, tb = series.make_series(2**31 + 11, CFG, DRIFT, 5, "cpu")
    assert torch.equal(ta["angle"], tb["angle"])
    assert torch.equal(ta["shift"], tb["shift"])
    assert not torch.equal(a, b)
    other = dict(DRIFT, path_seed=2011)
    _, tc = series.make_series(1, CFG, other, 5, "cpu")
    assert not torch.equal(ta["shift"], tc["shift"])


def test_the_path_is_the_programs_random_walk():
    """Steps uniform up to drift_step a frame and axis, rotations up to
    rotation_step, frame 0 the identity."""
    angle, shift = series.trajectory(2010, 4000, 4.2, 0.002)
    assert float(angle[0]) == 0.0 and float(shift[0].abs().max()) == 0.0
    steps = torch.diff(shift, dim=0)
    turns = torch.diff(angle)
    assert float(steps.abs().max()) <= 4.2 and float(turns.abs().max()) <= 0.002
    # A uniform step's spread: (2 * 4.2)^2 / 12 a coordinate.
    assert float(steps.var()) == pytest.approx(4.2 ** 2 / 3, rel=0.08)
    assert float(steps.mean().abs()) < 0.2
