"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and skips
with a reason where there is none.  On a machine with a card::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import registration
from repro_torch.core.deformation import compose_batched
from repro_torch.core.engine import get_plan, scan
from repro_torch.data.images import lattice_image, make_series
from repro_torch.data.scan_rows import (
    matmul_compose,
    orthogonal_matrices,
    telescoping_bf16,
)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import lookback_scan as lb
from repro_torch.kernels import ncc_grad as ng
from repro_torch.kernels import tile_scan as ts
from repro_torch.kernels import warp_ncc as wn
from repro_torch.kernels._tiling import (
    default_num_tiles_cuda,
    lift_masked,
    pack_leaves,
    packed_op,
    plan_cluster_size,
    plan_min_cluster,
    plan_operands,
    round_sources,
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
    _check_warp_ncc(img, ref, a, s, tile)


def _check_warp_ncc(img, ref, a, s, tile):
    """The kernel against the plain version: warped within 1e-4, the NCC
    folded on the card and on the host within 1e-5 of the plain sums'
    fold, the area and zero columns exact, two launches identical."""
    w_k, s_k = wn.warp_ncc_sums_cuda(img, ref, a, s, tile=tile)
    w_2, n_k = wn.warp_ncc(img, ref, a, s, tile=tile)
    w_3, n_2 = wn.warp_ncc(img, ref, a, s, tile=tile)
    w_p, s_p = wn.warp_ncc_sums_reference(img, ref, a, s, tile=tile)
    torch.cuda.synchronize()
    torch.testing.assert_close(w_k, w_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(wn.fold(s_k), wn.fold(s_p), rtol=0, atol=1e-5)
    torch.testing.assert_close(n_k, wn.fold(s_p), rtol=0, atol=1e-5)
    assert torch.equal(s_k[:, 5], torch.full_like(s_k[:, 5], tile * tile))
    assert not bool(s_k[:, 6:].any())
    assert torch.equal(w_k, w_2) and torch.equal(w_2, w_3)
    assert torch.equal(n_k, n_2)


def _frames(h, w, device, seeds=(0, 1)):
    """Lattice images cropped to (h, w)."""
    size = max(h, w)
    return [lattice_image(size, seed=k, device=device)[:h, :w].contiguous()
            for k in seeds]


@pytest.mark.parametrize("shape", [(96, 1920), (1920, 64), (64, 1952)])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("ang,shift", CASES)
def test_warp_ncc_kernel_non_square(cuda, shape, tile, ang, shift):
    """H != W, and a width (1952 = 61 x 32) that leaves the last patch of a
    tile row part full."""
    h, w = shape
    if abs(shift[0]) < 1:
        shift = (shift[0] * h, shift[1] * w)
    img, ref = _frames(h, w, cuda)
    _check_warp_ncc(img, ref, torch.tensor(ang, device=cuda),
                    torch.tensor(shift, device=cuda), tile)


@pytest.mark.parametrize("tile", [16, 32])
def test_warp_ncc_kernel_on_frames_of_a_stack(cuda, tile):
    """Frames taken as ``frames[i]`` of an (N, H, W) stack, as the series
    path hands them over."""
    frames = torch.stack(_frames(192, 320, cuda, seeds=(0, 1, 2)))
    _check_warp_ncc(frames[2], frames[1], torch.tensor(0.05, device=cuda),
                    torch.tensor((2.0, -1.5), device=cuda), tile)


def test_guess_check_launches_two_kernels(cuda):
    """One guess check (fused_ncc_distance, then float()) puts the kernel
    and its fold on the card and nothing else."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.registration import fused_ncc_distance

    img, ref = _frames(256, 256, cuda)
    d = {"angle": torch.tensor(0.03, device=cuda),
         "shift": torch.tensor((1.0, -0.5), device=cuda)}
    float(fused_ncc_distance(ref, img, d))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dist = float(fused_ncc_distance(ref, img, d))
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    assert len(names) == 2, names
    _, ncc = wn.warp_ncc_reference(img, ref, d["angle"], d["shift"])
    assert abs(dist - (1.0 - float(ncc))) <= 1e-5


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
    assert torch.equal(wn.warp_ncc(img, ref, 0.05, (1.0, 2.0))[1],
                       wn.warp_ncc(img, ref, 0.05, (1.0, 2.0))[1])


def test_kernel_wrapper_checks(cuda):
    x = torch.zeros((64, 64), device=cuda)
    with pytest.raises(TypeError):
        wn.warp_ncc(x.double(), x.double(), 0.0, (0.0, 0.0))
    with pytest.raises(ValueError, match="contiguous"):
        wn.warp_ncc(x.t(), x, 0.0, (0.0, 0.0))
    with pytest.raises(ValueError):
        wn.warp_ncc(x, x, 0.0, (0.0, 0.0), tile=8)
    # The angle and shift are read in place: f32, contiguous, on the card.
    with pytest.raises(TypeError, match="shift"):
        wn.warp_ncc(x, x, 0.0, torch.zeros(2, dtype=torch.float64,
                                           device=cuda))
    with pytest.raises(ValueError, match="shift"):
        wn.warp_ncc(x, x, 0.0, torch.zeros((2, 2), device=cuda)[:, 0])
    with pytest.raises(ValueError, match="angle"):
        wn.warp_ncc(x, x, torch.zeros(()), (0.0, 0.0))


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


# ----------------------------------------------------- function A's step

#: The benchmark's angle step at 1856 x 1920 (5e-4 * (96 / 1920)^2).
LR_ANGLE_1920 = 1.25e-6


def _pair_stack(h, w, n, device, seed):
    """``n`` consecutive frame pairs of ``h`` x ``w``, cut from a series
    rendered at ``max(h, w)`` px: ``(refs, tmpls)``."""
    frames, _ = make_series(seed, n + 1, size=max(h, w), noise=0.15,
                            device=device)
    f = frames[:, :h, :w].contiguous()
    return f[:-1].contiguous(), f[1:].contiguous()


def _corner_gap(d1, d2, h, w):
    """The widest distance, in px, between where two batches of
    deformations move a frame's four corners (float64)."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    corners = torch.tensor([[-cy, -cx], [-cy, cx], [cy, -cx], [cy, cx]],
                           dtype=torch.float64)

    def moved(d):
        a = d["angle"].double().cpu()[:, None]
        s = d["shift"].double().cpu()[:, None, :]
        c, sn = torch.cos(a), torch.sin(a)
        y = c * corners[:, 0] - sn * corners[:, 1]
        x = sn * corners[:, 0] + c * corners[:, 1]
        return torch.stack([y, x], dim=-1) + s

    return float((moved(d1) - moved(d2)).norm(dim=-1).max())


@pytest.mark.parametrize("shape", [(1856, 1920), (928, 960), (75, 100)])
def test_ncc_grad_kernels_match_twin_and_autograd(cuda, shape):
    """One sums pass and fold against the plain twin (float64 sums) and
    against autograd of ``ncc_distance`` on the card, with an ordinary
    lane, a small angle and a lane clamped by a shift of 40% of the
    frame."""
    h, w = shape
    ref, tmpl = _pair_stack(h, w, 3, cuda, seed=3)
    angle = torch.tensor([0.0, 0.003, -0.05], device=cuda)
    shift = torch.tensor([[1.5, -2.0], [0.3, 0.8], [-0.45 * h, 0.4 * w]],
                         device=cuda)
    reset_launch_counts()
    loss, grad, sums = ng.ncc_grad_cuda(ref, tmpl, angle, shift)
    assert launch_counts()["ncc_grad"] == 1
    want_loss, want_grad = ng.fold_reference(
        ng.sums_reference(ref, tmpl, angle, shift), h * w)
    a = angle.clone().requires_grad_(True)
    s = shift.clone().requires_grad_(True)
    auto_loss = registration.ncc_distance(ref, tmpl, {"angle": a, "shift": s})
    ga, gs = torch.autograd.grad(auto_loss.sum(), [a, s])
    auto_grad = torch.cat([ga[:, None], gs], dim=1)
    scale = want_grad.abs().amax(dim=0, keepdim=True)
    assert float((loss - want_loss).abs().max()) <= 1e-6
    assert bool(((grad - want_grad).abs() <= 1e-5 * scale).all())
    assert float((loss - auto_loss.detach()).abs().max()) <= 1e-5
    assert bool(((grad - auto_grad).abs() <= 1e-4 * scale).all())
    torch.testing.assert_close(ng.fold_reference(sums, h * w)[0], loss,
                               rtol=0, atol=1e-7)


def test_ncc_grad_lane_is_bit_equal_in_any_batch(cuda):
    """A lane's sums and its whole descent are the same bits in batches of
    1, 3 and 8 and from one launch to the next: the sums' partition depends
    on the frame's shape alone, and nothing is summed with atomics."""
    ref, tmpl = _pair_stack(928, 960, 8, cuda, seed=5)
    angle = torch.linspace(-0.004, 0.004, 8, device=cuda)
    shift = torch.stack([torch.linspace(-2.0, 2.0, 8, device=cuda),
                         torch.linspace(1.5, -1.0, 8, device=cuda)], dim=1)

    def run(lo, b):
        d = ng.Descent(ref[lo:lo + b], tmpl[lo:lo + b], angle[lo:lo + b],
                       shift[lo:lo + b], lr_angle=4 * LR_ANGLE_1920,
                       lr_shift=1.0, tol=1e-7, max_iters=300)
        more = d.start()
        first = d.sums.clone()
        while more:
            more = d.step()
        return [first, d.sums, d.grad, d.angle, d.shift, d.cur, d.it]

    whole = run(0, 8)
    assert len(set(whole[-1].tolist())) > 1     # lanes froze apart
    for got, want in zip(run(0, 8), whole):
        assert torch.equal(got, want)
    for b in (1, 3):
        for lo in range(0, 8 - b + 1, b):
            for got, want in zip(run(lo, b), whole):
                assert torch.equal(got, want[lo:lo + b])


def test_register_pair_on_card_matches_the_plain_route(cuda, monkeypatch):
    """Function A through the kernels against the autograd route run on the
    same card and frames (the benchmark's frame size and angle step).  The
    stopping test |prev - cur| > 1e-7 sits at the float32 rounding of the
    plain route's loss, so the two stop a few iterations apart: within
    0.005 px at the corners (the plain route reads 0.0014-0.0075 px against
    the float32 reference of the benchmark) and 10% of the iterations."""
    ref, tmpl = _pair_stack(1856, 1920, 8, cuda, seed=7)
    cfg = registration.RegistrationConfig(lr_angle=LR_ANGLE_1920)
    reset_launch_counts()
    got = registration.register_pair(ref, tmpl, None, cfg)
    assert got.kernel_steps == got.steps > 0
    # A start a level, then one entry call (two kernels) a step.
    assert launch_counts()["ncc_grad"] == got.steps + cfg.levels
    monkeypatch.setattr(registration, "_minimize_level",
                        registration._minimize_level_plain)
    want = registration.register_pair(ref, tmpl, None, cfg)
    assert want.kernel_steps == 0
    assert _corner_gap(got.deformation, want.deformation, 1856, 1920) <= 5e-3
    total, want_total = int(got.iterations.sum()), int(want.iterations.sum())
    assert abs(total - want_total) <= 0.1 * want_total
    assert float((got.distance - want.distance).abs().max()) <= 1e-5


def test_register_pair_from_eight_threads_gives_the_serial_answers(cuda):
    """Eight threads refining at once, as the work-stealing scan's
    refinements do: each descent owns its state and scratch, so every
    thread gets the answer it gets alone, bit for bit."""
    ref, tmpl = _pair_stack(464, 480, 8, cuda, seed=9)
    cfg = registration.RegistrationConfig(lr_angle=16 * LR_ANGLE_1920)
    guess = [{"angle": torch.tensor(0.001 * i, device=cuda),
              "shift": torch.tensor([0.5 * i, -0.25 * i], device=cuda)}
             for i in range(8)]

    def one(i):
        return registration.register_pair(ref[i], tmpl[i], guess[i], cfg)

    serial = [one(i) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(3):
            with ThreadPoolExecutor(8) as ex:
                futures = [ex.submit(one, i) for i in range(8)]
                results = [f.result(timeout=300) for f in futures]
            for got, want in zip(results, serial):
                assert torch.equal(got.deformation["angle"],
                                   want.deformation["angle"])
                assert torch.equal(got.deformation["shift"],
                                   want.deformation["shift"])
                assert torch.equal(got.iterations, want.iterations)
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.parametrize("refine", [False, True])
def test_series_feed_on_card_runs_function_a_on_its_kernels(cuda, refine):
    """A session's feeds launch ``ncc_grad`` for function A (and for every
    refinement) and count each step as a kernel step."""
    frames, _ = make_series(11, 17, size=192, noise=0.15, device=cuda)
    cfg = repro_torch.RegisterSeriesConfig(
        registration=registration.RegistrationConfig(
            lr_angle=5e-4 * (96 / 192) ** 2),
        refine=refine, skip_tol=1e-6 if refine else None)
    reset_launch_counts()
    with repro_torch.open_series(cfg) as s:   # the card: device=None
        s.feed(frames[:9])
        s.feed(frames[9:])
        feeds = s.result().feeds
    assert launch_counts()["ncc_grad"] > 0
    for f in feeds:
        assert f["fnA_kernel_steps"] == f["fnA_steps"] > 0
        assert f["refine_kernel_steps"] == f["refine_iters"]
    assert (sum(f["refine_iters"] for f in feeds) > 0) == refine


def test_ncc_grad_refuses_autograd_on_card(cuda):
    ref, tmpl = _pair_stack(64, 64, 2, cuda, seed=1)
    angle = torch.zeros(2, device=cuda)
    shift = torch.zeros(2, 2, device=cuda)
    reset_launch_counts()
    with pytest.raises(NotImplementedError, match="no gradient"):
        ng.ncc_grad_cuda(ref.requires_grad_(True), tmpl, angle, shift)
    assert launch_counts().get("ncc_grad", 0) == 0
    with torch.no_grad():
        loss, _, _ = ng.ncc_grad_cuda(ref, tmpl, angle, shift)
    assert loss.grad_fn is None and bool(torch.isfinite(loss).all())
    assert launch_counts()["ncc_grad"] == 1
    with pytest.raises(TypeError):
        ng.ncc_grad_cuda(ref.detach().double(), tmpl.double(), angle, shift)


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


# The main path's scan shape: 2^24 rows of width 1 over the card's 4096
# tiles (default_num_tiles_cuda).
FULL_N, FULL_TILES = 2**24, 4096


@pytest.mark.parametrize("case", ["add", "seeded", "masked", "max"])
def test_lookback_kernel_full_size_is_exact(cuda, case):
    """At 2^24 x 1 over 4096 tiles: integer-valued add (plain, seeded,
    masked) and max over random floats, bit for bit with the plain version
    and with torch's own scan."""
    n, t = FULL_N, FULL_TILES
    assert default_num_tiles_cuda(n) == t
    x = _ints(n, 1, cuda, seed=41)
    kw, op, exact = {}, torch.add, None
    if case == "seeded":
        kw["seed"] = torch.tensor([3.0], device=cuda)
        exact = torch.cumsum(x.double(), 0).float() + 3.0
    elif case == "masked":
        valid = (torch.arange(n, device=cuda) % 7) != 3
        valid[:5] = False
        x = torch.cat([x, (~valid).float()[:, None]], dim=1)
        op = lift_masked(torch.add)
    elif case == "max":
        x = _floats(n, 1, cuda, seed=42)
        op = torch.maximum
        exact = torch.cummax(x, 0).values
    else:
        exact = torch.cumsum(x.double(), 0).float()
    got = lb.lookback_scan_cuda(op, x, t, **kw)
    want = lb.lookback_scan_reference(op, x, t, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    if exact is not None:
        assert torch.equal(got[0], exact)


@pytest.mark.parametrize("d", [1, 3, 4])
def test_lookback_kernel_rows_of_any_width_are_exact(cuda, d):
    """W = 1, 3, 4 and an odd tile length, so the 16-byte words of a tile
    start and end inside rows: the ends are stored float by float."""
    for n, t in ((2**20, 256), (37 * 1001, 1001), (4099 * 5, 5)):
        x = _ints(n, d, cuda, seed=n + d)
        got = lb.lookback_scan_cuda(torch.add, x, t)
        want = lb.lookback_scan_reference(torch.add, x, t)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_lookback_kernel_walks_a_warp_at_a_time(cuda):
    """At 2^24 x 1 over 4096 tiles, over 20 launches: every walk folds at
    least one tile, and none passes the tiles that can be resident with it
    (8 blocks of 256 threads an SM): a tile further back has finished, so
    it has published its PREFIX.  The walk moves 32 tiles a warp step."""
    n, t = FULL_N, FULL_TILES
    resident = 8 * torch.cuda.get_device_properties(cuda).multi_processor_count
    x = _ints(n, 1, cuda, seed=43)
    steps = torch.zeros((t,), dtype=torch.int32, device=cuda)
    longest = 0
    for _ in range(20):
        lb.lookback_scan_cuda(torch.add, x, t, walk_steps=steps)
        torch.cuda.synchronize()
        assert int(steps[1:].min()) >= 1
        longest = max(longest, int(steps[1:].max()))
    print(f"longest walk over 20 launches: {longest} tiles, "
          f"{-(-longest // 32)} warp steps; {resident} tiles resident")
    assert longest < resident


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
    # The entries that take bfloat16 rows are add and max; matmul takes
    # m x m float32 matrices, and an untagged lambda raises whatever it
    # computes.
    with pytest.raises(KernelOpError, match="bfloat16"):
        lb.lookback_scan(matmul_compose,
                         torch.zeros((64, 4), device=cuda).bfloat16(), 2)
    with pytest.raises(KernelOpError, match="m x m"):
        lb.lookback_scan(matmul_compose, torch.zeros((64, 5), device=cuda), 2)
    with pytest.raises(KernelOpError, match="rigid_compose"):
        scan(lambda a, b: torch.matmul(b, a), torch.zeros((8, 2, 2),
                                                          device=cuda),
             backend="decoupled")
    # Without a kernel form, the dispatcher keeps the card off the kernels.
    reset_launch_counts()
    y = scan(lambda a, b: a + b, torch.ones(512, device=cuda))
    assert float(y[-1]) == 512.0
    assert launch_counts().get("lookback_scan", 0) == 0


# ----------------------------------- bfloat16 rows and the matmul entry


@pytest.mark.parametrize("n", [7, 4097, 2**20 + 3])
@pytest.mark.parametrize("d", [1, 3, 4])
def test_lookback_kernel_bf16_matches_plain(cuda, n, d):
    t = default_num_tiles_cuda(n)
    m = -(-n // t) * t
    x = telescoping_bf16(m, d, n + d, device=cuda)[0]
    f = _floats(m, d, cuda, seed=n).bfloat16()
    seed = telescoping_bf16(1, d, 9, bound=20, device=cuda)[0][0]
    for op, xs in ((torch.add, x), (torch.maximum, f)):
        for sd in (None, seed):
            got = lb.lookback_scan_cuda(op, xs, t, seed=sd)
            want = lb.lookback_scan_reference(op, xs, t, seed=sd)
            torch.cuda.synchronize()
            assert got[0].dtype == torch.bfloat16
            assert torch.equal(got[0], want[0])


def test_fused_plan_bf16_rounds_each_combine(cuda):
    """The sequential plan over [256, 1, 1, ...] in one fused_plan launch,
    whose rows stay in float32 shared memory between rounds: 256 + 1
    rounds back to 256 in bf16 and every later 1 is added to that, as the
    reference's Pallas kernels round (and the plain version, the op on
    bf16 tensors); one rounding per written row would climb to 318."""
    n = 64
    x = torch.ones((n, 1), dtype=torch.bfloat16, device=cuda)
    x[0] = 256
    plan = get_plan("sequential", n)
    got, _ = ts.fused_plan_cuda(torch.add, x, plan_operands(plan, 1).to(cuda))
    want, _ = ts.fused_plan_reference(torch.add, x, plan_operands(plan, 1))
    assert torch.equal(got, want)
    assert float(got.max()) == 256.0


@pytest.mark.parametrize("n,t", [(1000, 7), (2**16, 64)])
def test_lookback_kernel_masked_bf16_matches_plain(cuda, n, t):
    n = -(-n // t) * t
    g = torch.Generator(device="cpu").manual_seed(n)
    valid = torch.rand(n, generator=g) < 0.7
    valid[:3] = False
    # Telescoping over the valid rows: any combine stays below 256.
    x = torch.zeros((n, 2), dtype=torch.bfloat16, device=cuda)
    x[valid.to(cuda)] = telescoping_bf16(int(valid.sum()), 2, n,
                                         device=cuda)[0]
    flags = (~valid).to(device=cuda, dtype=torch.bfloat16)[:, None]
    op = lift_masked(torch.add)
    xf = torch.cat([x, flags], dim=1)
    got = lb.lookback_scan_cuda(op, xf, t)[0]
    want = lb.lookback_scan_reference(op, xf, t)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,t", [(2**20, 16), (4096 * 3 + 9, 3)])
@pytest.mark.parametrize("d", [1, 3])
def test_tile_kernels_bf16_match_plain(cuda, n, t, d):
    x = telescoping_bf16(n, d, n + d, device=cuda)[0]
    f = _floats(n, d, cuda, seed=d).bfloat16()
    for op, xs in ((torch.add, x), (torch.maximum, f)):
        local, parts = ts.tile_local_scan_cuda(op, xs, t)
        plocal, pparts = ts.tile_local_scan_reference(op, xs, t)
        seeds = telescoping_bf16(t, d, 3, bound=20, device=cuda)[0]
        y = ts.tile_apply_cuda(op, plocal, seeds)
        want = ts.tile_apply_reference(op, plocal, seeds)
        torch.cuda.synchronize()
        assert local.dtype == parts.dtype == y.dtype == torch.bfloat16
        assert torch.equal(local, plocal)
        assert torch.equal(parts, pparts)
        assert torch.equal(y, want)


@pytest.mark.parametrize("alg", ["ladner_fischer", "dissemination"])
@pytest.mark.parametrize("n", [1000, 2**16])
def test_fused_kernels_bf16_match_plain(cuda, alg, n):
    plan = get_plan(alg, n)
    for op, x in ((torch.add, telescoping_bf16(n, 1, n, device=cuda)[0]),
                  (torch.maximum, _floats(n, 2, cuda, seed=n).bfloat16())):
        want, _ = ts.fused_plan_reference(op, x, plan_operands(plan, 1))
        y = x
        for rnd in plan.rounds:
            src = round_sources(rnd, n)
            if src is not None:
                y = ts.fused_round_cuda(op, y, torch.as_tensor(src,
                                                               device=cuda))
        got, _ = ts.fused_plan_cuda(
            op, x, plan_operands(plan, plan_cluster_size(n, x.shape[1]))
            .to(cuda))
        torch.cuda.synchronize()
        assert y.dtype == got.dtype == torch.bfloat16
        assert torch.equal(y, want)
        assert torch.equal(got, want)


def test_engine_bf16_scans_run_their_kernels(cuda):
    """engine.scan of bf16 rows on the card: the decoupled backend, the
    dispatcher's default and the pallas backend in both modes launch their
    kernels and match the plain versions."""
    n = 2**16
    x = telescoping_bf16(n, 1, 1, device=cuda)[0][:, 0]
    want = lb.lookback_scan_reference(torch.add, x[:, None], 1)[0][:, 0]
    reset_launch_counts()
    for kw in ({"backend": "decoupled"}, {},
               {"backend": "pallas", "algorithm": "ladner_fischer"},
               {"backend": "pallas", "num_blocks": 16}):
        y = scan(torch.add, x, **kw)
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, want), kw
    counts = launch_counts()
    assert counts["lookback_scan"] >= 2
    assert counts["fused_plan"] == 1
    assert counts["tile_local_scan"] == counts["tile_apply"] == 1
    f = _floats(n, 1, cuda, seed=2)[:, 0].bfloat16()
    assert torch.equal(scan(torch.maximum, f, backend="decoupled"),
                       torch.cummax(f, 0).values)


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("n", [33, 4096, 2**16 + 5])
def test_matmul_entry_matches_plain(cuda, m, n):
    """later @ earlier over orthogonal matrices, through the decoupled
    backend (the lookback kernel), seeded and with where=, and through the
    tile kernels and the fused kernels, against the plain versions."""
    x = orthogonal_matrices(n, m, n + m, device=cuda)
    op = matmul_compose
    tol = dict(rtol=1e-4, atol=1e-4)
    reset_launch_counts()
    got = scan(op, x, backend="decoupled")
    assert launch_counts()["lookback_scan"] == 1
    x2 = x.reshape(n, m * m)
    want = lb.lookback_scan_reference(op, x2, 1)[0].reshape(n, m, m)
    torch.testing.assert_close(got, want, **tol)
    seed = orthogonal_matrices(1, m, 1, device=cuda)[0]
    got = scan(op, x, backend="decoupled", seed=seed)
    want = op(seed.reshape(1, m, m).expand(n, m, m), want)
    torch.testing.assert_close(got, want, **tol)
    valid = (torch.arange(n) % 5) != 2
    got = scan(op, x, backend="decoupled", where=valid)
    xm = torch.where(valid.to(cuda)[:, None, None], x,
                     torch.eye(m, device=cuda).expand(n, m, m))
    want = lb.lookback_scan_reference(op, xm.reshape(n, m * m), 1)[0]
    torch.testing.assert_close(got, want.reshape(n, m, m), **tol)
    t = 4
    k = n // t
    local, parts = ts.tile_local_scan_cuda(op, x2[: t * k], t)
    plocal, pparts = ts.tile_local_scan_reference(op, x2[: t * k], t)
    torch.testing.assert_close(local, plocal, **tol)
    y = ts.tile_apply_cuda(op, plocal, pparts)
    torch.testing.assert_close(y, ts.tile_apply_reference(op, plocal, pparts),
                               **tol)
    if n <= 4096:
        plan = get_plan("ladner_fischer", n)
        got, _ = ts.fused_plan_cuda(
            op, x2, plan_operands(plan, plan_cluster_size(n, m * m)).to(cuda))
        want, _ = ts.fused_plan_reference(op, x2, plan_operands(plan, 1))
        torch.testing.assert_close(got, want, **tol)


def test_matmul_entry_is_exact_on_the_reference_case(cuda):
    """tests/test_decoupled.py:100 on the card: 33 random 0/1 2 x 2
    matrices, five tiles, every product an integer float32 holds."""
    g = np.random.default_rng(5)
    x = torch.as_tensor(g.integers(0, 2, (33, 2, 2)).astype(np.float32),
                        device=cuda)
    op = matmul_compose
    reset_launch_counts()
    got = scan(op, x, backend="decoupled", num_blocks=5)
    assert launch_counts()["lookback_scan"] == 1
    acc, ref = x[0], [x[0]]
    for i in range(1, 33):
        acc = x[i] @ acc
        ref.append(acc)
    assert torch.equal(got, torch.stack(ref))


# ------------------------------------------- max entry, fused_round, pallas


def _floats(n, d, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn((n, d), generator=g).to(device)


@pytest.mark.parametrize("n,t", [(1000, 1), (2**20, 16), (2**20, 256)])
@pytest.mark.parametrize("d", [1, 4])
def test_scan_kernels_max_are_exact(cuda, n, t, d):
    x = _floats(n, d, cuda, seed=n + d)
    got = lb.lookback_scan_cuda(torch.maximum, x, t)
    want = lb.lookback_scan_reference(torch.maximum, x, t)
    local, parts = ts.tile_local_scan_cuda(torch.maximum, x, t)
    plocal, pparts = ts.tile_local_scan_reference(torch.maximum, x, t)
    seeds = torch.cat([pparts[:1], torch.cummax(pparts, 0).values[:-1]])
    out = ts.tile_apply_cuda(torch.maximum, plocal, seeds)
    pout = ts.tile_apply_reference(torch.maximum, plocal, seeds)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(local, plocal) and torch.equal(parts, pparts)
    assert torch.equal(out, pout)
    assert torch.equal(got[0], torch.cummax(x, 0).values)


def test_max_kernel_propagates_nan(cuda):
    x = _floats(4096, 2, cuda, seed=1)
    x[100, 0] = float("nan")
    x[3000, 1] = float("nan")
    got = lb.lookback_scan_cuda(torch.maximum, x, 4)[0]
    want = lb.lookback_scan_reference(torch.maximum, x, 4)[0]
    src = torch.as_tensor(round_sources(get_plan("sklansky", 4096).rounds[0],
                                        4096), device=cuda)
    fk = ts.fused_round_cuda(torch.maximum, x, src)
    fp = ts.fused_round_reference(torch.maximum, x, src)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert bool(got[100:, 0].isnan().all()) and bool(got[3000:, 1].isnan().all())
    assert torch.equal(fk.isnan(), fp.isnan())
    assert torch.equal(fk.nan_to_num(), fp.nan_to_num())


def _plan(alg, n, masked):
    mask = [i % 7 == 3 or i < 5 for i in range(n)] if masked else None
    return get_plan(alg, n, mask=mask)


# Every circuit at each size it has a plan for (Blelloch: powers of two,
# unmasked; the sequential plan only small: it has n - 1 rounds).
ROUND_CASES = [
    (alg, n, case)
    for alg in ("sklansky", "brent_kung", "ladner_fischer", "dissemination",
                "blelloch", "sequential")
    for n in (17, 1024, 2**16)
    for case in ("add1", "add4", "max1", "max3", "add1_masked")
    if not (alg == "sequential" and n > 1024)
    and not (alg == "blelloch" and (n == 17 or case.endswith("masked")))
]


@pytest.mark.parametrize("alg,n,case", ROUND_CASES)
def test_fused_round_kernel_matches_plain_round_by_round(cuda, alg, n, case):
    op = torch.add if case.startswith("add") else torch.maximum
    d = int(case[3])
    plan = _plan(alg, n, case.endswith("masked"))
    x = (_ints if op is torch.add else _floats)(n, d, cuda, seed=n + d)
    y = x
    launches = 0
    for rnd in plan.rounds:
        src = round_sources(rnd, n)
        if src is None:
            continue
        src = torch.as_tensor(src, device=cuda)
        got = ts.fused_round_cuda(op, y, src)
        want = ts.fused_round_reference(op, y, src)
        torch.cuda.synchronize()
        assert torch.equal(got, want), rnd
        y = got
        launches += 1
    assert launches == sum(1 for r in plan.rounds
                           if r.num_combines or r.num_moves)


def test_fused_round_rigid_matches_plain_and_float64(cuda):
    n = 4096
    dfm = _deformations(n, cuda, seed=3)
    a64, s64 = _chain64(dfm)
    x2, spec = pack_leaves(dfm)
    op = packed_op(compose_batched, spec)
    tol = _rigid_tol(s64)
    y = x2
    for rnd in get_plan("ladner_fischer", n).rounds:
        src = torch.as_tensor(round_sources(rnd, n), device=cuda)
        got = ts.fused_round_cuda(op, y, src)
        want = ts.fused_round_reference(op, y, src)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol)
        y = got
    np.testing.assert_allclose(y[:, 0].double().cpu().numpy(), a64, **tol)
    np.testing.assert_allclose(y[:, 1:].double().cpu().numpy(), s64, **tol)


PLAN_CIRCUITS = ["sklansky", "brent_kung", "ladner_fischer", "dissemination",
                 "blelloch"]
# Every circuit at n in {1000, 2^16} (Blelloch: 1024, a power of two) and
# d in {1, 3, 4} (the smallest clusters that hold them are 1, 4, 8 and 16),
# and 2^15 x 1, which 2 CTAs hold.
PLAN_CASES = (
    [(alg, n, d, op) for alg in PLAN_CIRCUITS
     for n in ((1024 if alg == "blelloch" else 1000), 2**16)
     for d in (1, 3, 4) for op in ("add", "max")]
    + [(alg, 2**15, 1, "add") for alg in PLAN_CIRCUITS]
    + [("ladner_fischer_masked", n, d, "add") for n in (1000, 2**16)
       for d in (1, 4)]
)


@pytest.mark.parametrize("alg,n,d,op", PLAN_CASES)
def test_fused_plan_kernel_matches_plain_at_every_cluster_size(cuda, alg, n,
                                                               d, op):
    """The whole plan in one launch, at the cluster size the size rule
    picks, at the smallest that holds it and at 16, against the plain
    version (the chain of plain rounds) and the per-round kernel, exact;
    Blelloch's total too."""
    masked = alg.endswith("_masked")
    plan = _plan(alg.replace("_masked", ""), n, masked)
    fn = torch.add if op == "add" else torch.maximum
    x = (_ints if op == "add" else _floats)(n, d, cuda, seed=n + d)
    want, want_total = ts.fused_plan_reference(fn, x, plan_operands(plan, 1))
    chain = x
    for rnd in plan.rounds:
        src = round_sources(rnd, n)
        if src is not None:
            chain = ts.fused_round_cuda(fn, chain, torch.as_tensor(src,
                                                                   device=cuda))
    for c in sorted({plan_min_cluster(n, d), plan_cluster_size(n, d), 16}):
        po = plan_operands(plan, c).to(cuda)
        reset_launch_counts()
        got, total = ts.fused_plan_cuda(fn, x, po)
        torch.cuda.synchronize()
        assert launch_counts()["fused_plan"] == 1
        assert torch.equal(got, want), c
        assert torch.equal(got, chain), c
        assert (total is None) == (want_total is None)
        if total is not None:
            assert torch.equal(total, want_total), c


def test_fused_plan_rigid_matches_plain_and_float64(cuda):
    n = 4096
    dfm = _deformations(n, cuda, seed=3)
    a64, s64 = _chain64(dfm)
    x2, spec = pack_leaves(dfm)
    op = packed_op(compose_batched, spec)
    tol = _rigid_tol(s64)
    plan = get_plan("ladner_fischer", n)
    assert plan_min_cluster(n, 3) == 1 and plan_cluster_size(n, 3) == 8
    for c in (1, 8, 16):
        po = plan_operands(plan, c)
        got, _ = ts.fused_plan_cuda(op, x2, po.to(cuda))
        want, _ = ts.fused_plan_reference(op, x2, po)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol)
        np.testing.assert_allclose(got[:, 0].double().cpu().numpy(), a64, **tol)
        np.testing.assert_allclose(got[:, 1:].double().cpu().numpy(), s64,
                                   **tol)


def test_a_plan_above_the_cluster_takes_a_launch_a_round(cuda):
    """2^20 x 4 floats do not fit twice in 16 CTAs' shared memory: the size
    rule sends the plan to the per-round kernel before any launch."""
    n, d = 2**20, 4
    assert plan_cluster_size(n, d) is None
    x = _ints(n, d, cuda, seed=9)
    plan = get_plan("brent_kung", n)
    rounds = sum(1 for r in plan.rounds if r.num_combines or r.num_moves)
    reset_launch_counts()
    y = scan(torch.add, x, backend="pallas", algorithm="brent_kung")
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"fused_round": rounds}
    assert torch.equal(y, torch.cumsum(x.double(), 0).float())


def test_a_refused_cluster_launch_raises(cuda):
    """A cluster the card refuses (32 CTAs; or 1 CTA whose slice is larger
    than its shared memory) raises: nothing runs in its place."""
    n = 2**16
    x = _ints(n, 4, cuda, seed=2)
    plan = get_plan("ladner_fischer", n)
    reset_launch_counts()
    for c in (32, 1):
        with pytest.raises(RuntimeError, match="fused_plan kernel launch"):
            ts.fused_plan_cuda(torch.add, x, plan_operands(plan, c).to(cuda))
    assert not any(launch_counts().values())
    # The refusal leaves no error behind for the next launch.
    y, _ = ts.fused_plan_cuda(torch.add, x, plan_operands(plan, 16).to(cuda))
    assert torch.equal(y, torch.cumsum(x.double(), 0).float())


@pytest.mark.parametrize("kind", ["add", "max", "rigid"])
@pytest.mark.parametrize("offset", [0, 1])
def test_tile_apply_unaligned_tiles_match_plain(cuda, kind, offset):
    """t = 3, k = 1001, d = 3: no tile starts or ends on 16 bytes (and with
    offset 1 the input is a view that does not either)."""
    t, k, d = 3, 1001, 3
    if kind == "rigid":
        dfm = _deformations(t * k + offset, cuda, seed=4)
        x2, spec = pack_leaves(dfm)
        op = packed_op(compose_batched, spec)
        base, seeds = x2, x2[:t].contiguous()
        tol = _rigid_tol(x2[:, 1:].double().cpu().numpy())
    else:
        op = torch.add if kind == "add" else torch.maximum
        base = (_ints if kind == "add" else _floats)(t * k + offset, d, cuda,
                                                       seed=5)
        seeds = (_ints if kind == "add" else _floats)(t, d, cuda, seed=6)
    local = base.view(-1)[offset * d:].view(t, k, d)
    got = ts.tile_apply_cuda(op, local, seeds)
    want = ts.tile_apply_reference(op, local, seeds)
    torch.cuda.synchronize()
    if kind == "rigid":
        torch.testing.assert_close(got, want, **tol)
    else:
        assert torch.equal(got, want)
    assert torch.equal(got[:k], local[0])


@pytest.mark.parametrize("alg", PLAN_CIRCUITS)
@pytest.mark.parametrize("n", [1000, 2**16])
def test_pallas_rounds_on_card_launch_one_fused_plan(cuda, alg, n):
    x = _ints(n, 1, cuda, seed=n)[:, 0]
    f = _floats(n, 1, cuda, seed=n)[:, 0]
    reset_launch_counts()
    y = scan(torch.add, x, backend="pallas", algorithm=alg)
    assert {k: v for k, v in launch_counts().items() if v} == {"fused_plan": 1}
    assert torch.equal(y, torch.cumsum(x.double(), 0).float())
    assert torch.equal(scan(torch.maximum, f, backend="pallas", algorithm=alg),
                       torch.cummax(f, 0).values)
    if alg != "blelloch":
        valid = (torch.arange(n, device=cuda) % 7) != 3
        valid[:5] = False
        want = torch.cumsum(torch.where(valid, x, 0.0).double(), 0).float()
        want[:5] = x[:5]
        got = scan(torch.add, x, backend="pallas", algorithm=alg, where=valid)
        assert torch.equal(got, want)
    counts = launch_counts()
    assert counts.get("lookback_scan", 0) == counts.get("tile_apply", 0) == 0


@pytest.mark.parametrize("tiles", [16, 4096])
def test_pallas_tiles_on_card_launch_the_tile_kernels(cuda, tiles):
    n = 2**22
    x = _ints(n, 1, cuda, seed=tiles)[:, 0]
    f = _floats(n, 1, cuda, seed=tiles)[:, 0]
    reset_launch_counts()
    y = scan(torch.add, x, backend="pallas", num_blocks=tiles)
    assert torch.equal(y, torch.cumsum(x.double(), 0).float())
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"tile_local_scan": 1, "tile_apply": 1}
    ym = scan(torch.maximum, f, backend="pallas", num_blocks=tiles)
    assert torch.equal(ym, torch.cummax(f, 0).values)


def test_pallas_on_card_refuses_before_any_launch(cuda):
    x = torch.ones(64, device=cuda)
    reset_launch_counts()
    for kw in ({}, {"num_blocks": 4}):
        with pytest.raises(KernelOpError, match="rigid_compose"):
            scan(lambda a, b: a + b, x, backend="pallas", **kw)
        with pytest.raises(KernelOpError, match="float32 or bfloat16"):
            scan(torch.add, x.double(), backend="pallas", **kw)
        with pytest.raises(KernelOpError, match="bfloat16"):
            scan(matmul_compose,
                 torch.zeros((64, 2, 2), device=cuda).bfloat16(),
                 backend="pallas", **kw)
        with pytest.raises(KernelOpError):
            scan(torch.add, torch.ones((64, 5), device=cuda), backend="pallas",
                 **kw)
    assert not any(launch_counts().values())


# ------------------------------------------------------------ LM kernels


def _chunk_inputs(g, l, dk, dv, dtype, device, seed=0, log_a_shift=0.0):
    """The reference's kernel-test inputs (tests/test_kernels.py): c, b
    ~0.3 N(0, 1), v ~0.5 N(0, 1), ca a cumulative sum of
    -softplus(N + log_a_shift).  A shift of -2 decays slowly (~0.18 a step,
    as Mamba2's dt bias of -2 does), so terms far below the diagonal and the
    whole state summary carry weight."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    c = t(rng.normal(size=(g, l, dk)) * 0.3).to(dtype)
    b = t(rng.normal(size=(g, l, dk)) * 0.3).to(dtype)
    v = t(rng.normal(size=(g, l, dv)) * 0.5).to(dtype)
    la = -np.logaddexp(0.0, rng.normal(size=(g, l)) + log_a_shift)
    ca = t(np.cumsum(la, axis=-1))[..., None]
    return c, b, v, ca


# Float32 at the reference's kernel-oracle tolerance (tests/test_kernels.py:
# 58-74).  In bf16 kernel and plain version both accumulate in float32 and
# round once, so they may differ by one bf16 step (at most 2^-7 of the
# value): rtol 8e-3, atol 1e-3.
_BF16_TOL = (8e-3, 1e-3)
_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: _BF16_TOL}


# The serving shape; the bf16 kernels' edges: L = 1 and 65 (one row of the
# second 64-row half), dk and dv of 8 and 128 (one padded k-step, two
# warpgroups on the state summary), dv padded to 48, and G = 133, 300 and
# 600, which leave the resident grid's last blocks a g short or idle and
# reuse each stage (600 with L = 100: the cp.async path's padding).
@pytest.mark.parametrize("g,l,dk,dv", [(1792, 128, 64, 64), (16, 128, 128, 128),
                                       (6, 32, 16, 16), (5, 100, 112, 40),
                                       (7, 1, 16, 16), (9, 65, 64, 64),
                                       (4, 128, 8, 128), (4, 96, 128, 8),
                                       (133, 128, 64, 64), (300, 64, 32, 48),
                                       (600, 100, 24, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("log_a_shift", [0.0, -2.0])
def test_chunk_kernels_match_plain(cuda, g, l, dk, dv, dtype, log_a_shift):
    from repro_torch.kernels import chunk_scan as cs

    c, b, v, ca = _chunk_inputs(g, l, dk, dv, dtype, cuda,
                                log_a_shift=log_a_shift)
    y_k, s_k = cs.chunk_local_cuda(c, b, v, ca)
    y_p, s_p = cs.chunk_local_reference(c, b, v, ca)
    torch.cuda.synchronize()
    assert y_k.dtype == dtype and s_k.dtype == torch.float32
    rtol, atol = _TOL[dtype]
    torch.testing.assert_close(y_k.float(), y_p.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(s_k, s_p, rtol=1e-4, atol=1e-4)
    rng = np.random.default_rng(1)
    s_prev = torch.tensor(rng.normal(size=(g, dk, dv)), dtype=torch.float32,
                          device=cuda)
    o_k = cs.chunk_apply_cuda(c, ca, y_p, s_prev)
    o_p = cs.chunk_apply_reference(c, ca, y_p, s_prev)
    torch.cuda.synchronize()
    assert o_k.dtype == dtype
    torch.testing.assert_close(o_k.float(), o_p.float(), rtol=rtol,
                               atol=max(atol, 1e-4))


# Head dims above 128 (the mLSTM of xLSTM-350M: dk = dv = 256, G = 64 a
# prefill): dv in two tiles (of 128; of 72 at 136, padded to 80), dk in
# four 64-row tiles, chunk_local on one stage; L = 100 and 65 take the
# cp.async path, L = 1 one padded row, G = 133 walks the resident grid.
@pytest.mark.parametrize("g,l,dk,dv", [(64, 128, 256, 256), (3, 128, 256, 64),
                                       (5, 100, 256, 136), (4, 65, 136, 256),
                                       (2, 1, 256, 256), (133, 128, 256, 256),
                                       (7, 128, 200, 248)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("log_a_shift", [0.0, -2.0])
def test_chunk_kernels_at_head_dim_256_match_plain(cuda, g, l, dk, dv, dtype,
                                                   log_a_shift):
    test_chunk_kernels_match_plain(cuda, g, l, dk, dv, dtype, log_a_shift)


def test_ssd_scan_at_head_dim_256_launches_the_kernels(cuda):
    """ops.ssd_scan at the mLSTM's shape (4 sequences of 512, 4 heads of
    256, bf16) through the kernels, against the "xla" path."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(7)
    t = lambda *s: torch.tensor(rng.normal(size=s) * 0.3, dtype=torch.float32,
                                device=cuda)
    q, k, v = (t(4, 4, 512, 256).bfloat16() for _ in range(3))
    la = torch.nn.functional.logsigmoid(t(4, 4, 512) * 3.0)
    reset_launch_counts()
    y = ops.ssd_scan(q, k, v, la, backend="pallas")
    counts = {kk: n for kk, n in launch_counts().items() if n}
    assert counts == {"chunk_local": 1, "chunk_apply": 1}
    y_x = ops.ssd_scan(q, k, v, la, backend="xla")
    torch.testing.assert_close(y.float(), y_x.float(), rtol=2e-2, atol=2e-2)


def test_chunk_kernels_take_views_off_a_16_byte_boundary(cuda):
    """The bf16 kernels copy 16-byte pieces of rows; a view that starts two
    bytes into its storage is copied first, not refused."""
    from repro_torch.kernels import chunk_scan as cs

    g, l, dk, dv = 3, 64, 16, 16
    c, b, v, ca = _chunk_inputs(g, l, dk, dv, torch.bfloat16, cuda)
    c_off = torch.empty(c.numel() + 1, dtype=c.dtype, device=cuda)[1:]
    c_off.copy_(c.reshape(-1))
    c_off = c_off.view(g, l, dk)
    assert c_off.data_ptr() % 16 != 0
    y_k, s_k = cs.chunk_local_cuda(c_off, b, v, ca)
    y_p, s_p = cs.chunk_local_reference(c, b, v, ca)
    torch.testing.assert_close(y_k.float(), y_p.float(), rtol=_BF16_TOL[0],
                               atol=_BF16_TOL[1])
    torch.testing.assert_close(s_k, s_p, rtol=1e-4, atol=1e-4)
    s_prev = torch.zeros((g, dk, dv), device=cuda)
    o_k = cs.chunk_apply_cuda(c_off, ca, y_p, s_prev)
    torch.testing.assert_close(o_k.float(), y_p.float(), rtol=0, atol=0)


def test_chunk_scan_bf16_kernels_use_the_tensor_cores(cuda):
    """The built chunk_scan library's bf16 kernels hold HGMMA (wgmma)
    instructions: their products run on the tensor cores (the method of
    chip_smoke.py's _hgmma_count)."""
    import os
    import subprocess

    from repro_torch.kernels import _cuda
    from repro_torch.kernels import chunk_scan as cs

    cs.ensure_built()
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _cuda.library_path(cs.LIBRARY)],
                          capture_output=True, text=True, check=True).stdout
    hgmma = {}
    kernel = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            kernel = ln.split("Function :")[1].strip()
        elif "HGMMA" in ln:
            hgmma[kernel] = hgmma.get(kernel, 0) + 1
    for name in ("chunk_local_bf16_kernel", "chunk_apply_bf16_kernel"):
        assert any(name in k for k in hgmma), (name, sorted(hgmma))
    assert not any("f32_kernel" in k for k in hgmma)


def test_chunk_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels import chunk_scan as cs

    c, b, v, ca = _chunk_inputs(4, 64, 16, 16, torch.float32, cuda)
    reset_launch_counts()
    with pytest.raises(TypeError):
        cs.chunk_local(c.double(), b.double(), v.double(), ca)
    with pytest.raises(TypeError):
        cs.chunk_local(c, b, v, ca.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        cs.chunk_local(c.transpose(1, 2).contiguous().transpose(1, 2), b, v, ca)
    big = _chunk_inputs(2, 256, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="chunk length"):
        cs.chunk_local(*big)
    odd = _chunk_inputs(2, 64, 12, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        cs.chunk_local(*odd)
    assert not any(launch_counts().values())


@pytest.mark.parametrize("bh,l,d,blocks", [(128, 512, 112, (256, 512)),
                                           (8, 512, 112, (128, 128)),
                                           (4, 256, 64, (128, 128)),
                                           (3, 96, 128, (32, 96))])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, bh, l, d, blocks, causal,
                                              dtype):
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(bh + l + d)
    q, k, v = (torch.tensor(rng.normal(size=(bh, l, d)) * 0.5,
                            dtype=torch.float32, device=cuda).to(dtype)
               for _ in range(3))
    o_k = fa.flash_attention_cuda(q, k, v, causal=causal, block_q=blocks[0],
                                  block_k=blocks[1])
    o_p = fa.flash_attention_reference(q, k, v, causal=causal,
                                       block_q=blocks[0], block_k=blocks[1])
    torch.cuda.synchronize()
    assert o_k.dtype == dtype
    # tests/test_kernels.py:105's 2e-3 in float32; one bf16 step in bf16.
    rtol, atol = (2e-3, 2e-3) if dtype == torch.float32 else _BF16_TOL
    torch.testing.assert_close(o_k.float(), o_p.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("l", [96, 512])
@pytest.mark.parametrize("d", [112, 64, 128, 40])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_tensor_core_kernel_matches_plain(cuda, l, d,
                                                               causal):
    """The bf16 kernel (wgmma) at the head dims it pads differently: 112,
    64 and 128 are multiples of 16, 40 is padded to 48 with zeros; L = 96
    leaves a ragged last key tile, L = 512 is the serving prompt."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(l * d + causal)
    q, k, v = (torch.tensor(rng.normal(size=(8, l, d)) * 0.5,
                            dtype=torch.float32, device=cuda).bfloat16()
               for _ in range(3))
    blocks = (32, 96) if l == 96 else (256, 512)
    o_k = fa.flash_attention_cuda(q, k, v, causal=causal, block_q=blocks[0],
                                  block_k=blocks[1])
    o_p = fa.flash_attention_reference(q, k, v, causal=causal,
                                       block_q=blocks[0], block_k=blocks[1])
    torch.cuda.synchronize()
    assert o_k.dtype == torch.bfloat16
    torch.testing.assert_close(o_k.float(), o_p.float(), rtol=_BF16_TOL[0],
                               atol=_BF16_TOL[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_noncausal_at_whisper_shape(cuda, dtype):
    """Whisper's encoder: BH = 4 x 8 heads, 1,024 frames, d = 64,
    non-causal (the kernel's causal == 0 branch), and the same queries
    against twice as many keys (lq != lk), against the plain version."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(64)
    t = lambda l: torch.tensor(rng.normal(size=(32, l, 64)) * 0.5,  # noqa: E731
                               dtype=torch.float32, device=cuda).to(dtype)
    q, k, v = t(1024), t(1024), t(1024)
    k2, v2 = t(2048), t(2048)
    rtol, atol = (2e-3, 2e-3) if dtype == torch.float32 else _BF16_TOL
    reset_launch_counts()
    for kk, vv in ((k, v), (k2, v2)):
        o_k = fa.flash_attention(q, kk, vv, causal=False)
        o_p = fa.flash_attention_reference(q, kk, vv, causal=False)
        torch.cuda.synchronize()
        assert o_k.shape == q.shape and o_k.dtype == dtype
        torch.testing.assert_close(o_k.float(), o_p.float(), rtol=rtol,
                                   atol=atol)
    counts = launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_noncausal"] == 2
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        q.view(4, 8, 1024, 64), k.view(4, 8, 1024, 64),
        v.view(4, 8, 1024, 64), is_causal=False)
    o_k = fa.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(o_k.view_as(sdpa).float(), sdpa.float(),
                               rtol=rtol, atol=atol)


def test_moe_smoke_prefill_on_card_matches_cpu(cuda):
    """A smoke MoE prefill and two decode steps on the card (flash for the
    attention, the dispatch einsums on cuBLAS) against the same weights on
    the CPU."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core._tree import tree_map
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config("arctic-480b"),
                              attn_backend="pallas", cache_dtype="float32")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    params_c = tree_map(lambda t: t.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64))).long()
    outs, fed = [], []
    for dev, p in (("cpu", params), (cuda, params_c)):
        states = lm.init_decode_states(cfg, 2, 72, device=dev)
        reset_launch_counts()
        lg, states = lm.prefill(p, cfg, {"tokens": toks.to(dev)}, states)
        seq = [lg]
        for t in range(2):
            # Both devices decode the CPU's greedy tokens.
            if dev == "cpu":
                fed.append(torch.argmax(seq[-1][:, -1], -1)[:, None])
            lg, states = lm.decode_step(p, cfg, fed[t].to(dev), 64 + t,
                                        states)
            seq.append(lg)
        outs.append([x.cpu() for x in seq])
    assert launch_counts()["flash_attention"] == cfg.n_layers
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=2e-3, atol=2e-3)


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros((2, 64, 100), device=cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((2, 64, 64), device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(AssertionError):
        fa.flash_attention(q, q, q, block_q=48)
    assert not any(launch_counts().values())


def test_ssd_scan_and_attention_on_card_launch_the_kernels(cuda):
    from repro_torch.kernels import ops

    rng = np.random.default_rng(3)
    t = lambda *s: torch.tensor(rng.normal(size=s) * 0.3, dtype=torch.float32,
                                device=cuda)
    q, k, v = t(2, 3, 512, 64), t(2, 3, 512, 64), t(2, 3, 512, 64)
    la = -torch.nn.functional.softplus(t(2, 3, 512))
    reset_launch_counts()
    y = ops.ssd_scan(q, k, v, la, backend="pallas")
    counts = {kk: n for kk, n in launch_counts().items() if n}
    assert counts == {"chunk_local": 1, "chunk_apply": 1}
    y_x = ops.ssd_scan(q, k, v, la, backend="xla")
    torch.testing.assert_close(y, y_x, rtol=2e-4, atol=1e-3)
    qa, ka, va = t(2, 8, 256, 32), t(2, 2, 256, 32), t(2, 2, 256, 32)
    reset_launch_counts()
    a = ops.attention(qa, ka, va, backend="pallas", block_q=128, block_k=128)
    assert launch_counts()["flash_attention"] == 1
    assert launch_counts().get("flash_attention_noncausal", 0) == 0
    torch.testing.assert_close(a, ops.attention(qa, ka, va, backend="xla"),
                               rtol=2e-3, atol=2e-3)


def test_zamba2_smoke_server_on_card_goes_through_the_kernels(cuda):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Request, ServeConfig, Server

    cfg = dataclasses.replace(get_smoke_config("zamba2-7b"),
                              attn_backend="pallas", ssm_backend="pallas")
    srv = Server(ServeConfig(arch="zamba2-7b", eos_id=None, max_len=80),
                 acfg=cfg)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(2, 500, 64, dtype=np.int32), max_new=8)
            for i in range(3)]
    reset_launch_counts()
    stats = srv.serve_batch(reqs)
    counts = {kk: n for kk, n in launch_counts().items() if n}
    assert counts == {"chunk_local": 2, "chunk_apply": 2, "flash_attention": 1}
    assert stats["generated"] == 24 and all(len(r.output) == 8 for r in reqs)


@pytest.mark.parametrize("arch,want", [
    ("xlstm-350m", {"chunk_local": 3, "chunk_apply": 3}),
    ("qwen3-32b", {"flash_attention": 2}),
    ("phi3.5-moe-42b-a6.6b", {"flash_attention": 2}),
    ("arctic-480b", {"flash_attention": 2}),
    ("internvl2-1b", {"flash_attention": 2}),
    ("whisper-base", {"flash_attention": 4,
                      "flash_attention_noncausal": 2})])
def test_new_smoke_servers_on_card_go_through_the_kernels(cuda, arch, want):
    """xLSTM's mLSTM blocks reach the chunk kernels (3 a superblock), the
    dense and MoE blocks flash attention (one a layer; InternVL2 behind its
    zero patches), Whisper's encoder and decoder one a layer each (the
    encoder's also counted as non-causal; the cross-attention takes the
    plain path); decode reaches none."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Request, ServeConfig, Server

    cfg = dataclasses.replace(get_smoke_config(arch), attn_backend="pallas",
                              ssm_backend="pallas")
    srv = Server(ServeConfig(arch=arch, eos_id=None, max_len=80), acfg=cfg)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(2, 500, 64, dtype=np.int32), max_new=4)
            for i in range(3)]
    reset_launch_counts()
    stats = srv.serve_batch(reqs)
    assert {kk: n for kk, n in launch_counts().items() if n} == want
    assert stats["generated"] == 12


def test_init_params_peak_is_the_weights_plus_2gb(cuda):
    """lm.init_params allocates each stacked leaf once and draws into it in
    float32 pieces of 64 MB: at qwen3-32b's width and 4 layers (~7 GB of
    bf16 weights) the peak is the weights plus at most 2 GB."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core._tree import tensor_leaves
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("qwen3-32b"), n_layers=4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    params = lm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tensor_leaves(params))
    peak = torch.cuda.max_memory_allocated(cuda) - base
    assert weights > 6e9
    assert weights <= peak <= weights + 2e9, (weights, peak)
    del params
    torch.cuda.empty_cache()


# ------------------------------------ serving, recovery, simulate on card


def _static_cfg(refine):
    """Refining: a static two-level decomposition with the guess check on;
    composing: the decoupled backend.  Both associate the same chunks the
    same way in every run, so a restored or served series can be held to
    a one-process run."""
    if refine:
        return repro_torch.RegisterSeriesConfig(
            skip_tol=0.02, backend="hierarchical", num_segments=2,
            num_threads=2, stealing=False, cross_steal=False)
    return repro_torch.RegisterSeriesConfig(refine=False, backend="decoupled")


@pytest.mark.parametrize("refine", [True, False])
def test_checkpoint_restore_on_card(cuda, tmp_path, refine):
    """A session whose tensors live on the card checkpoints to the host and
    restores onto the card (device=None); its extend launches the path's
    kernel and matches the uninterrupted session."""
    from repro_torch import service

    frames, _ = make_series(13, 12, size=96, noise=0.15, device=cuda)
    cfg = _static_cfg(refine)
    with service.open_series(cfg) as u:
        u.feed(frames[:7])
        want = u.extend(frames[7:])
    s = service.open_series(cfg, checkpoint_dir=str(tmp_path))
    s.feed(frames[:7])
    assert s.checkpoint() == 7
    s.close()
    r = service.SeriesSession.restore(str(tmp_path))
    assert r.device.type == "cuda"
    assert r._elements[0].deformation["shift"].device.type == "cuda"
    assert r._store[0].device.type == "cuda" and r._store[6].device.type == "cuda"
    reset_launch_counts()
    got = r.extend(frames[7:])
    r.close()
    kernel = "warp_ncc" if refine else "lookback_scan"
    assert launch_counts()[kernel] >= 1
    assert got.deformations["shift"].device.type == "cuda"
    torch.testing.assert_close(got.deformations["shift"],
                               want.deformations["shift"], rtol=0,
                               atol=1e-5 if refine else 1e-6)


def test_restore_without_cuda_raises(cuda, tmp_path, monkeypatch):
    from repro_torch import service

    frames, _ = make_series(14, 4, size=64, noise=0.15, device=cuda)
    s = service.open_series(_static_cfg(False), checkpoint_dir=str(tmp_path))
    s.feed(frames)
    s.checkpoint()
    s.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        service.SeriesSession.restore(str(tmp_path))


def test_frontend_session_on_card_goes_through_warp_ncc(cuda):
    from repro_torch.serving import FrontendConfig, RegistrationFrontend

    frames, true = make_series(15, 9, size=96, noise=0.15, device=cuda)
    reset_launch_counts()
    with RegistrationFrontend(FrontendConfig(dispatch_workers=1)) as fe:
        fe.add_tenant("scope", interactive=True)
        sid = fe.open_series("scope", _static_cfg(True))  # the card
        fe.feed("scope", sid, frames[:5])
        res = fe.extend("scope", sid, frames[5:]).result(timeout=120)
    checks = sum(f["skipped"] + f["refined"] for f in res.feeds)
    assert launch_counts()["warp_ncc"] == checks > 0
    assert res.deformations["shift"].device.type == "cuda"
    assert float((res.deformations["shift"] - true["shift"]).abs().max()) < 0.35


def test_simulate_backend_on_card_tensors(cuda):
    from repro_torch.core.engine import backends

    d = _deformations(300, cuda, seed=4)
    elems = [{"angle": d["angle"][i], "shift": d["shift"][i]}
             for i in range(300)]
    got = scan(compose_batched, elems, backend="simulate")
    want = scan(compose_batched, d, backend="vector",
                algorithm="ladner_fischer")
    assert got[0]["shift"].device.type == "cuda"
    assert torch.equal(torch.stack([g["shift"] for g in got]), want["shift"])
    assert torch.equal(torch.stack([g["angle"] for g in got]), want["angle"])
    assert backends.last_trace.work == get_plan("ladner_fischer", 300).work()


def _card_mesh(cuda, p):
    from repro_torch.core import spmd
    from repro_torch.core.engine.sharded import AXIS

    return spmd.Mesh([cuda] * p, (AXIS,))


@pytest.mark.parametrize("kw", [{}, {"seed": 1000.0}, {"where": 0.7},
                                {"stealing": False}],
                         ids=["plain", "seeded", "masked", "no_stealing"])
@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 7, 100])
def test_sharded_on_a_card_mesh_matches_vector(cuda, n, kw):
    """``sharded`` on 4 positions of one card: bit-equal to ``vector`` on
    integer-valued data, phase 3 one ``lookback_scan`` launch a position."""
    from repro_torch.core.engine import sharded

    g = torch.Generator().manual_seed(n)
    x = torch.randint(-2, 3, (n,), generator=g).float().to(cuda)
    opts = {}
    if "seed" in kw:
        opts["seed"] = torch.tensor(kw["seed"], device=cuda)
    if "where" in kw:
        opts["where"] = torch.rand(n, generator=g) < kw["where"]
        opts["where"] = opts["where"].tolist()
    if "stealing" in kw:
        opts["stealing"] = kw["stealing"]
    want = scan(torch.add, x, backend="vector",
                **({"where": opts["where"]} if "where" in opts else {}))
    if "seed" in opts:
        want = want + opts["seed"]
    reset_launch_counts()
    got = scan(torch.add, x, backend="sharded", mesh=_card_mesh(cuda, 4),
               **opts)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert torch.equal(got, want)
    st = sharded.last_stats
    assert st.phase3_route == "lookback_scan" and st.devices == 4
    assert st.phase2_rounds == 2
    assert launch_counts()["lookback_scan"] == 4


def test_sharded_on_a_card_mesh_composes_and_routes_by_op(cuda):
    """Rigid composition on 8 positions (the kernel's rigid_compose row),
    and the affine pytree op, which has no kernel form: the plain phase 3,
    no launch."""
    from repro_torch.core.engine import sharded

    d = _deformations(4096, cuda, seed=8)
    reset_launch_counts()
    got = scan(compose_batched, d, backend="sharded", mesh=_card_mesh(cuda, 8))
    assert launch_counts()["lookback_scan"] == 8
    assert sharded.last_stats.phase3_route == "lookback_scan"
    want = scan(compose_batched, d, backend="vector")
    for k in ("angle", "shift"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)

    aff = lambda a, b: (a[0] * b[0], a[1] * b[0] + b[1])  # noqa: E731
    g = torch.Generator().manual_seed(9)
    m = torch.where(torch.rand(4096, generator=g) < 0.004, 2.0, 1.0).to(cuda)
    c = torch.randint(-4, 5, (4096,), generator=g).float().to(cuda)
    reset_launch_counts()
    ym, yc = scan(aff, (m, c), backend="sharded", mesh=_card_mesh(cuda, 8))
    assert launch_counts().get("lookback_scan", 0) == 0
    assert sharded.last_stats.phase3_route == "plain"
    om, oc = scan(aff, (m, c), backend="vector")
    assert torch.equal(ym, om) and torch.equal(yc, oc)


def _autograd_entries(dev):
    """Each kernel's CUDA entry with small inputs on ``dev``: (name, the
    call, its float operands)."""
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.kernels import flash_attention as fa

    n = 4096
    x = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    src = torch.stack([torch.arange(n) - 1, torch.arange(n)], 1)
    src[0] = torch.tensor([0, -1])
    src = src.to(dtype=torch.int32, device=dev)
    plan_ops = plan_operands(get_plan("ladner_fischer", n), 1).to(dev)
    local = torch.ones((4, n // 4, 1), device=dev)
    seeds = torch.ones((4, 1), device=dev)
    img = lattice_image(64, seed=0, device=dev)
    ref = lattice_image(64, seed=1, device=dev)
    c, b, v, ca = _chunk_inputs(3, 64, 16, 16, torch.float32, dev)
    y_intra = torch.zeros((3, 64, 16), device=dev)
    s_prev = torch.zeros((3, 16, 16), device=dev)
    q = torch.randn((2, 128, 64), device=dev)
    return [
        ("warp_ncc", lambda: wn.warp_ncc_sums_cuda(img, ref, 0.05, (1.0, 2.0),
                                                   tile=16), (img,)),
        ("lookback_scan", lambda: lb.lookback_scan_cuda(torch.add, x, 16),
         (x,)),
        ("fused_round", lambda: ts.fused_round_cuda(torch.add, x, src), (x,)),
        ("fused_plan", lambda: ts.fused_plan_cuda(torch.add, x, plan_ops),
         (x,)),
        ("tile_local_scan", lambda: ts.tile_local_scan_cuda(torch.add, x, 16),
         (x,)),
        ("tile_apply", lambda: ts.tile_apply_cuda(torch.add, local, seeds),
         (local,)),
        ("chunk_local", lambda: cs.chunk_local_cuda(c, b, v, ca), (c,)),
        ("chunk_apply", lambda: cs.chunk_apply_cuda(c, ca, y_intra, s_prev),
         (c,)),
        ("flash_attention", lambda: fa.flash_attention_cuda(q, q, q), (q,)),
    ]


@pytest.mark.parametrize("index", range(9))
def test_cuda_entries_refuse_autograd(cuda, index):
    """A kernel has no backward: its CUDA entry raises under grad mode when
    an operand requires grad, and launches under ``torch.no_grad()``
    (the reference defines no backward for its Pallas kernels either)."""
    name, call, operands = _autograd_entries(cuda)[index]
    reset_launch_counts()
    for t in operands:
        t.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        call()
    assert launch_counts().get(name, 0) == 0
    with torch.no_grad():
        out = call()
    first = out[0] if isinstance(out, tuple) else out
    assert first.grad_fn is None and bool(torch.isfinite(first).all())
    assert launch_counts()[name] == 1


# ---------------------------------------------------------------------------
# LM multi-device on one card: positions and ranks that share cuda:0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,names", [((4,), ("data",)),
                                         ((2, 4), ("pod", "data"))])
@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16),
                                     (256, torch.bfloat16),
                                     (64, torch.float32)])
def test_sequence_sharded_ssd_scan_on_card_positions(cuda, shape, names, d,
                                                     dtype):
    """ssd_scan with L sharded over positions of cuda:0: chunk_local and
    chunk_apply launch once a position, and the result is the unsharded
    scan through the kernels (elementwise: the bf16 gate, float32 at the
    chunk kernels' tolerance) and the sharded scan through their plain
    versions (float32 elementwise; bf16 normwise, the gate times the
    largest |y|: where y_intra, rounded to bf16 between the phases, cancels
    the inter-chunk term, kernels and plain versions differ by up to two
    bf16 steps of y, sharded or not)."""
    from repro_torch.core import spmd
    from repro_torch.kernels import ops

    n = int(np.prod(shape))
    gen = torch.Generator(device=cuda).manual_seed(d)
    rn = lambda *s: torch.randn(s, generator=gen, device=cuda)
    q, k, v = ((rn(2, 4, 64 * n, d) * 0.3).to(dtype) for _ in range(3))
    la = -torch.nn.functional.softplus(rn(2, 4, 64 * n) - 2.0)
    mesh = spmd.Mesh([cuda] * n, names, shape)
    sp = spmd.P(None, None, names)

    def run(backend):
        return spmd.shard_map(
            lambda *a: ops.ssd_scan(*a, chunk=32, backend=backend,
                                    axis_names=names, axis_sizes=shape),
            mesh, sp, sp)(q, k, v, la)

    whole = ops.ssd_scan(q, k, v, la, chunk=32, backend="pallas")
    reset_launch_counts()
    y = run("pallas")
    torch.cuda.synchronize()
    counts = {kk: c for kk, c in launch_counts().items() if c}
    assert counts == {"chunk_local": n, "chunk_apply": n}
    rtol, atol = _BF16_TOL if dtype == torch.bfloat16 else (1e-4, 1e-5)
    torch.testing.assert_close(y.float(), whole.float(), rtol=rtol,
                               atol=atol)
    plain = run("pallas_interpret").float()
    if dtype == torch.float32:
        torch.testing.assert_close(y, plain, rtol=rtol, atol=atol)
    else:
        gap = float((y.float() - plain).abs().max())
        assert gap <= atol + rtol * float(plain.abs().max())


def test_gloo_collectives_on_card_tensors_and_staged_dtensor(cuda):
    """Four gloo ranks sharing cuda:0: gloo's own all-gather,
    reduce-scatter, all-reduce and all-to-all on card tensors, and
    DTensor's collectives through the host staging."""
    from repro_torch.launch import host_staging
    from repro_torch.launch.mesh import run_world

    for got in run_world(host_staging.probe, 4, device="cuda"):
        assert got == {"all_gather_into_tensor": True,
                       "reduce_scatter_tensor": True, "all_reduce": True,
                       "all_to_all_single": True,
                       "dtensor_collectives": True, "staged": True}


def test_train_on_a_card_mesh_matches_one_device(cuda, tmp_path):
    """qwen3-32b's smoke config, three float32 steps on a (2, 2) mesh of
    gloo ranks sharing cuda:0 against the same steps on the card alone."""
    from repro_torch.launch.train import TrainConfig, train

    kw = dict(arch="qwen3-32b", smoke=True, steps=3, batch=4, seq_len=32,
              save_every=100, device="cuda")
    one = train(TrainConfig(ckpt_dir=str(tmp_path / "one"), **kw))
    mesh = train(TrainConfig(ckpt_dir=str(tmp_path / "mesh"),
                             mesh_shape=(2, 2), **kw))
    assert mesh["backend"] == "gloo" and mesh["staged_collectives"]
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=1e-5)


_MESH_LR = 0.1       # the warmup scales it by 0, 1e-2, 2e-2: the params
                     # move ~3e-3, well past the params bound
_MESH_EPS = 1e-3     # AdamW's eps: at its default 1e-8 a gradient below
                     # float noise takes a step of either sign, 2 lr apart
                     # (chip_smoke.py's train_mesh_check counts them)
_MESH_STEPS, _MESH_BATCH, _MESH_SEQ = 3, 4, 32


def _card_mesh_steps(arch, device, mesh=None):
    """Three float32 steps of ``arch``'s smoke config at _MESH_LR and
    _MESH_EPS from seeded params and batches, on ``device`` alone or on
    ``mesh``:
    (losses, grad norms, params, first moments, initial params), the trees
    as numpy leaves."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core._tree import tree_flatten
    from repro_torch.interop import params_from_numpy, to_numpy
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.train import mesh_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = get_smoke_config(arch)
    opt_cfg = adamw.AdamWConfig(lr=_MESH_LR, eps=_MESH_EPS)
    start = to_numpy(lm.init_params(torch.Generator().manual_seed(0), cfg))
    params = params_from_numpy(start, device=device)
    if mesh is None:
        step_fn = steps.make_train_step(cfg, opt_cfg)
    else:
        params = shd.distribute(params, shd.param_shardings(params, cfg, mesh),
                                mesh)
        step_fn = mesh_step(cfg, opt_cfg, mesh)
    opt = adamw.init(params, opt_cfg)
    rng = np.random.default_rng(7)
    losses, gnorms = [], []
    for _ in range(_MESH_STEPS):
        batch = {k: torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (_MESH_BATCH, _MESH_SEQ)), device=device)
            for k in ("tokens", "labels")}
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))

    def full(tree):
        return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
                .detach().float().cpu().numpy()
                for t in tree_flatten(tree)[0]]

    return (losses, gnorms, full(params), full(opt.m),
            [np.asarray(t, np.float32) for t in tree_flatten(start)[0]])


def _card_mesh_rank(rank, device, arch, shape=(2, 2)):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, ("data", "model"), device=str(device))
    out = _card_mesh_steps(arch, device, mesh)
    return out if rank == 0 else None


@pytest.mark.parametrize("arch", ["xlstm-350m", "phi3.5-moe-42b-a6.6b"])
def test_float32_steps_on_a_card_mesh_match_one_device(cuda, arch):
    """Three float32 steps of ``arch``'s smoke config on a (2, 2) mesh of
    gloo ranks sharing cuda:0 (the sLSTM loop and the expert blocks on
    local shards, DTensor's collectives staged through host memory)
    against the same steps on the card alone, at the card's train check
    bounds (loss rtol 1e-4, grad norm 1e-3, params atol 1e-4; first
    moments within 1e-3 of each leaf's largest), at an lr that moves the
    params ten times the params bound and AdamW's eps at 1e-3."""
    from repro_torch.launch.mesh import run_world

    ml, mg, mp, mm, _ = run_world(_card_mesh_rank, 4, arch,
                                  device="cuda")[0]
    ol, og, op, om, start = _card_mesh_steps(arch, cuda)
    moved = max(float(np.abs(b - a).max()) for a, b in zip(start, op))
    assert moved > 1e-3, moved
    np.testing.assert_allclose(ml, ol, rtol=1e-4)
    np.testing.assert_allclose(mg, og, rtol=1e-3)
    assert len(mp) == len(op) == len(mm) == len(om)
    for a, b in zip(mp, op):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for a, b in zip(mm, om):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-3 * float(np.abs(b).max()))


@pytest.mark.parametrize("arch", ["qwen3-32b", "xlstm-350m"])
def test_float32_steps_on_a_1x4_card_mesh_match_one_device(cuda, arch):
    """The same on a (1, 4) mesh, where "model" does not divide the heads
    (qwen3-32b's 2 kv heads, xLSTM's 2) and the loss reads a quarter of
    the head a rank: the projections replicated over "model" before the
    per-head view (``shardctx.split_heads``), the vocab blocks combined
    over "model" (``shardctx.local_vocab``), on the card's torch."""
    from repro_torch.launch.mesh import run_world

    ml, mg, mp, mm, _ = run_world(_card_mesh_rank, 4, arch, (1, 4),
                                  device="cuda")[0]
    ol, og, op, om, _ = _card_mesh_steps(arch, cuda)
    np.testing.assert_allclose(ml, ol, rtol=1e-4)
    np.testing.assert_allclose(mg, og, rtol=1e-3)
    assert len(mp) == len(op) == len(mm) == len(om)
    for a, b in zip(mp, op):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for a, b in zip(mm, om):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-3 * float(np.abs(b).max()))
