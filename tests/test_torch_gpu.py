"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and skips
with a reason where there is none.  On a machine with a card::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.deformation import compose_batched
from repro_torch.core.engine import scan
from repro_torch.data.images import lattice_image, make_series
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import lookback_scan as lb
from repro_torch.kernels import tile_scan as ts
from repro_torch.kernels import warp_ncc as wn
from repro_torch.kernels._tiling import (
    default_num_tiles_cuda,
    lift_masked,
    pack_leaves,
    packed_op,
)
from repro_torch.kernels.op_table import KernelOpError
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


# ----------------------------------------------------------- scan kernels


def _ints(n, d, device, seed=0):
    """Integer-valued float32 rows in [-2, 2]: every prefix is exact in
    float32 (|prefix| stays far below 2^24), so the kernels must match
    their plain versions bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(-2, 3, (n, d), generator=g).float().to(device)


def _deformations(n, device, seed=0):
    """Rigid deformations of a drifting series: angles ~0.01 rad and
    shifts ~0.25 px a step, so the composed shifts reach tens of px."""
    rng = np.random.default_rng(seed)
    return {
        "angle": torch.tensor(rng.normal(size=n) * 0.01,
                              dtype=torch.float32, device=device),
        "shift": torch.tensor(rng.normal(size=(n, 2)) * 0.25,
                              dtype=torch.float32, device=device),
    }


def _chain64(d):
    """The composed prefixes in float64, one composition at a time."""
    a = d["angle"].double().cpu().numpy()
    s = d["shift"].double().cpu().numpy()
    out_a, out_s = np.empty_like(a), np.empty_like(s)
    acc_a, acc_s = a[0], s[0].copy()
    out_a[0], out_s[0] = acc_a, acc_s
    for i in range(1, len(a)):
        c, sn = np.cos(a[i]), np.sin(a[i])
        acc_s = np.array([c * acc_s[0] - sn * acc_s[1],
                          sn * acc_s[0] + c * acc_s[1]]) + s[i]
        acc_a = acc_a + a[i]
        out_a[i], out_s[i] = acc_a, acc_s
    return out_a, out_s


def _rigid_tol(shift64):
    """rtol 1e-5; atol a few float32 ulps of the largest composed shift
    (rotating a vector of length L rounds each component to ~L * eps),
    never below 1e-5."""
    return dict(rtol=1e-5, atol=max(1e-5, 1e-6 * float(np.abs(shift64).max())))


@pytest.mark.parametrize("n", [1, 7, 256, 1000, 4097, 65536, 2**20 + 3])
@pytest.mark.parametrize("d", [1, 3, 4])
@pytest.mark.parametrize("tiles", ["card", "one", "many"])
def test_lookback_kernel_add_is_exact(cuda, n, d, tiles):
    t = {"card": default_num_tiles_cuda(n), "one": 1,
         "many": max(1, n // 37)}[tiles]
    m = -(-n // t) * t
    x = _ints(m, d, cuda, seed=n + d)
    seed = _ints(1, d, cuda, seed=7)[0]
    for sd in (None, seed):
        got = lb.lookback_scan_cuda(torch.add, x, t, seed=sd)
        want = lb.lookback_scan_reference(torch.add, x, t, seed=sd)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)
        assert bool((got[1] == lb.FLAG_PREFIX).all())


@pytest.mark.parametrize("n,t", [(13, 1), (1000, 7), (2**16, 64)])
@pytest.mark.parametrize("d", [1, 4])
def test_lookback_kernel_masked_add_is_exact(cuda, n, t, d):
    n = -(-n // t) * t
    x = _ints(n, d, cuda, seed=n)
    g = torch.Generator(device="cpu").manual_seed(n)
    valid = torch.rand(n, generator=g) < 0.7
    valid[:3] = False                      # a leading masked run
    flags = (~valid).float().to(cuda)[:, None]
    xf = torch.cat([x, flags], dim=1)
    op = lift_masked(torch.add)
    seed = torch.cat([_ints(1, d, cuda, seed=3)[0], flags.new_zeros(1)])
    for sd in (None, seed):
        got = lb.lookback_scan_cuda(op, xf, t, seed=sd)
        want = lb.lookback_scan_reference(op, xf, t, seed=sd)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("path", ["decoupled", "tiles"])
def test_rigid_compose_kernels_match_plain_and_float64(cuda, path):
    n = 4096
    dfm = _deformations(n, cuda, seed=1)
    a64, s64 = _chain64(dfm)
    x2, spec = pack_leaves(dfm)
    op = packed_op(compose_batched, spec)
    if path == "decoupled":
        reset_launch_counts()
        got = scan(compose_batched, dfm)           # dispatched on the card
        assert launch_counts()["lookback_scan"] == 1
        y = torch.cat([got["angle"][:, None], got["shift"]], dim=1)
        t = default_num_tiles_cuda(n)
        plain = lb.lookback_scan_reference(op, x2, t)[0]
        y_many = lb.lookback_scan_cuda(op, x2, 64)[0]
        plain_many = lb.lookback_scan_reference(op, x2, 64)[0]
        pairs = [(y, plain), (y_many, plain_many)]
    else:
        local, parts = ts.tile_local_scan_cuda(op, x2, 16)
        plocal, pparts = ts.tile_local_scan_reference(op, x2, 16)
        seeds = torch.cat([pparts[:1], pparts[:-1]])  # any seeds will do
        y = ts.tile_apply_cuda(op, plocal, seeds)
        plain = ts.tile_apply_reference(op, plocal, seeds)
        pairs = [(local.reshape(n, 3), plocal.reshape(n, 3)), (y, plain)]
        y = None
    torch.cuda.synchronize()
    tol = _rigid_tol(s64)
    for k_out, p_out in pairs:
        err = float((k_out - p_out).abs().max())
        print(f"{path}: kernel vs plain max abs err {err:.3e}")
        torch.testing.assert_close(k_out, p_out, **tol)
    if y is not None:
        e_a = float(np.abs(y[:, 0].double().cpu().numpy() - a64).max())
        e_s = float(np.abs(y[:, 1:].double().cpu().numpy() - s64).max())
        print(f"{path}: vs float64 chain: angle {e_a:.3e} shift {e_s:.3e} "
              f"(max |shift| {np.abs(s64).max():.1f})")
        np.testing.assert_allclose(y[:, 0].double().cpu().numpy(), a64, **tol)
        np.testing.assert_allclose(y[:, 1:].double().cpu().numpy(), s64, **tol)


def test_lookback_kernel_race_stress(cuda):
    """50 back-to-back launches at n = 2^22 with 256-row tiles (16384
    tiles in flight): every result bit-equal to the first, which is the
    exact prefix sum; every board all PREFIX; and the walks really
    accumulate AGG aggregates (some walk reads more than one tile)."""
    n, t = 2**22, 2**22 // 256
    x = _ints(n, 1, cuda, seed=11)
    exact = torch.cumsum(x.double(), 0).float()
    steps = torch.zeros((t,), dtype=torch.int32, device=cuda)
    first = None
    longest = 0
    for _ in range(50):
        y, status, _, _ = lb.lookback_scan_cuda(torch.add, x, t,
                                                walk_steps=steps)
        torch.cuda.synchronize()
        assert bool((status == lb.FLAG_PREFIX).all())
        if first is None:
            first = y
            assert torch.equal(first, exact)
        assert torch.equal(y, first)
        assert int(steps[1:].min()) >= 1
        longest = max(longest, int(steps.max()))
    print(f"longest lookback walk over 50 launches: {longest} tiles")
    assert longest > 1


@pytest.mark.parametrize("n,t", [(4096, 1), (2**20, 16), (2**20, 128),
                                 (3 * 5000, 3), (2**16 + 16, 16)])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_tile_kernels_add_are_exact(cuda, n, t, d):
    x = _ints(n, d, cuda, seed=n + t)
    local, parts = ts.tile_local_scan_cuda(torch.add, x, t)
    plocal, pparts = ts.tile_local_scan_reference(torch.add, x, t)
    seeds = torch.cat([pparts[:1], torch.cumsum(pparts, 0)[:-1]])
    out = ts.tile_apply_cuda(torch.add, plocal, seeds)
    pout = ts.tile_apply_reference(torch.add, plocal, seeds)
    torch.cuda.synchronize()
    assert torch.equal(local, plocal) and torch.equal(parts, pparts)
    assert torch.equal(out, pout)
    assert torch.equal(out, torch.cumsum(x.double(), 0).float())


@pytest.mark.parametrize("t", [2, 16, 1024])
def test_tile_local_scan_chains_chunks_within_tiles(cuda, t):
    """A tile longer than one block's chunk is scanned by a chain of
    blocks that restarts at every tile: 10 launches at n = 2^22, each
    equal to the exact per-tile prefix sums."""
    n = 2**22
    x = _ints(n, 1, cuda, seed=t)
    exact = torch.cumsum(x.double().view(t, n // t, 1), 1).float()
    for _ in range(10):
        local, parts = ts.tile_local_scan_cuda(torch.add, x, t)
        torch.cuda.synchronize()
        assert torch.equal(local, exact)
        assert torch.equal(parts, exact[:, -1])


def test_scan_engine_paths_go_through_their_kernels(cuda):
    n = 2**16
    x = _ints(n, 1, cuda, seed=5)[:, 0]
    exact = torch.cumsum(x.double(), 0).float()
    reset_launch_counts()
    assert torch.equal(scan(torch.add, x), exact)
    assert torch.equal(
        scan(torch.add, x, backend="hierarchical", num_segments=16), exact)
    xs = [x[i : i + 1] for i in range(4096)]
    op = lambda a, b: a + b
    op.op_batchable = True
    op.op_identity = lambda: torch.zeros((1,), device=cuda)
    op.kernel_op = "add"
    ys = scan(op, xs, op_cost=1e-6)
    assert torch.equal(torch.cat(ys), exact[:4096])
    counts = launch_counts()
    assert counts["lookback_scan"] == 1
    assert counts["tile_local_scan"] == counts["tile_apply"] == 2


def test_scan_kernels_refuse_what_they_do_not_carry(cuda):
    x = torch.zeros((64, 2), device=cuda)
    with pytest.raises(KernelOpError, match="rigid_compose"):
        scan(lambda a, b: a + b, x, backend="decoupled")
    with pytest.raises(KernelOpError):
        ts.tile_local_scan(lambda a, b: a + b, x, 4)
    with pytest.raises(KernelOpError):
        lb.lookback_scan(torch.add, torch.zeros((64, 5), device=cuda), 2)
    with pytest.raises(TypeError):
        lb.lookback_scan(torch.add, x.double(), 2)
    # Without a kernel form, the dispatcher keeps the card off the kernels.
    reset_launch_counts()
    y = scan(lambda a, b: a + b, torch.ones(512, device=cuda))
    assert float(y[-1]) == 512.0
    assert launch_counts().get("lookback_scan", 0) == 0
