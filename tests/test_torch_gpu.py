"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and skips
with a reason where there is none.  On a machine with a card::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

import repro_torch
from repro_torch.data.images import lattice_image, make_series
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import warp_ncc as wn
from repro_torch.runtime import scheduler

pytestmark = pytest.mark.gpu

# (angle, shift as fractions of the frame size); the last pushes most
# samples past the border but leaves part of the frame in view (a frame
# clamped whole is constant, and its NCC is 0/0).
CASES = [(0.0, (3.0, -2.0)), (0.07, (1.5, 0.7)), (-0.1, (-4.0, 2.5)),
         (0.6, (0.36, -0.47))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda", 0)


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


@pytest.mark.parametrize("size", [64, 1920])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("ang,shift", CASES)
def test_warp_ncc_kernel_matches_plain(cuda, size, tile, ang, shift):
    if abs(shift[0]) < 1:
        shift = (shift[0] * size, shift[1] * size)
    img = lattice_image(size, seed=0, device=cuda)
    ref = lattice_image(size, seed=1, device=cuda)
    a = torch.tensor(ang, device=cuda)
    s = torch.tensor(shift, device=cuda)
    w_k, s_k = wn.warp_ncc_sums_cuda(img, ref, a, s, tile=tile)
    w_p, s_p = wn.warp_ncc_sums_reference(img, ref, a, s, tile=tile)
    torch.cuda.synchronize()
    torch.testing.assert_close(w_k, w_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(wn.fold(s_k), wn.fold(s_p), rtol=0, atol=1e-5)
    assert torch.equal(s_k[:, 5], torch.full_like(s_k[:, 5], tile * tile))
    assert not bool(s_k[:, 6:].any())


def test_kernel_counts_each_launch(cuda):
    img = lattice_image(64, seed=0, device=cuda)
    reset_launch_counts()
    for _ in range(3):
        wn.warp_ncc(img, img, 0.01, (0.5, 0.5))
    wn.warp_ncc_reference(img, img, 0.01, (0.5, 0.5))
    assert launch_counts()["warp_ncc"] == 3


def test_kernel_is_deterministic(cuda):
    img = lattice_image(256, seed=0, device=cuda)
    ref = lattice_image(256, seed=1, device=cuda)
    a = wn.warp_ncc_sums_cuda(img, ref, 0.05, (1.0, 2.0))
    b = wn.warp_ncc_sums_cuda(img, ref, 0.05, (1.0, 2.0))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_kernel_wrapper_checks(cuda):
    x = torch.zeros((64, 64), device=cuda)
    with pytest.raises(TypeError):
        wn.warp_ncc(x.double(), x.double(), 0.0, (0.0, 0.0))
    with pytest.raises(ValueError, match="contiguous"):
        wn.warp_ncc(x.t(), x, 0.0, (0.0, 0.0))
    with pytest.raises(ValueError):
        wn.warp_ncc(x, x, 0.0, (0.0, 0.0), tile=8)


def test_register_series_on_card_goes_through_kernel(cuda):
    frames, true = make_series(11, 8, size=96, noise=0.15, device=cuda)
    cfg = repro_torch.RegisterSeriesConfig(skip_tol=0.02)
    reset_launch_counts()
    res = repro_torch.register_series(frames, cfg)  # device=None: the card
    checks = sum(f["skipped"] + f["refined"] for f in res.feeds)
    assert launch_counts()["warp_ncc"] == checks > 0
    assert res.deformations["shift"].device.type == "cuda"
    err = (res.deformations["shift"] - true["shift"]).abs().max()
    assert float(err) < 0.35
