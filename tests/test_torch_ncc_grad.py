"""Function A's kernel route on the CPU: ``kernels/ncc_grad.py``'s plain
twin against ``torch.autograd`` and the plain descent, the CUDA wrapper's
refusals, and the ``fnA_kernel_share`` reader.

The twin computes what the two CUDA kernels compute (the 14 raw sums in
float64 from ``warp``'s coordinates and taps, the loss and the analytic
gradient folded from them, the masked update); the kernels themselves
are held to it on the card (``tests/test_torch_gpu.py``).
"""

import importlib.util
import os
from types import SimpleNamespace

import pytest
import torch

from repro_torch import service
from repro_torch.core import registration as reg
from repro_torch.core.deformation import ncc_distance
from repro_torch.data.images import lattice_image, make_series
from repro_torch.kernels import ncc_grad as ng
from repro_torch.runtime import scheduler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _images(kind, shape, b, seed):
    """``b`` reference and template frames of ``shape``: smoothed uniform
    noise, or a lattice cut from a larger one (non-square frames)."""
    h, w = shape
    if kind == "random":
        g = torch.Generator().manual_seed(seed)
        x = torch.rand((2 * b, 1, h, w), generator=g)
        x = torch.nn.functional.avg_pool2d(x, 3, 1, 1)[:, 0]
    else:
        x = torch.stack([lattice_image(max(h, w), seed=seed + i,
                                       device="cpu")[:h, :w]
                         for i in range(2 * b)])
    return x[:b].contiguous(), x[b:].contiguous()


def _points(case, b, shape):
    """Small angles and shifts of a few px, or a heavy clamp: shifts of 40
    px and more along both axes (part of each frame stays in view)."""
    g = torch.Generator().manual_seed(b)
    angle = (torch.rand((b,), generator=g) - 0.5) * 0.04
    if case == "small":
        shift = (torch.rand((b, 2), generator=g) - 0.5) * 6.0
    else:
        h, w = shape
        sign = torch.where(torch.rand((b, 2), generator=g) < 0.5, -1.0, 1.0)
        shift = sign * torch.tensor([max(40.0, 0.45 * h), max(40.0, 0.45 * w)])
    return angle, shift


def _autograd(ref, tmpl, angle, shift):
    a = angle.clone().requires_grad_(True)
    s = shift.clone().requires_grad_(True)
    loss = ncc_distance(ref, tmpl, {"angle": a, "shift": s})
    ga, gs = torch.autograd.grad(loss.sum(), [a, s])
    return loss.detach(), torch.cat([ga[:, None], gs], dim=1)


@pytest.mark.parametrize("case", ["small", "clamp"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("shape", [(64, 64), (96, 80), (75, 100)])
@pytest.mark.parametrize("kind", ["random", "lattice"])
def test_twin_loss_and_gradient_match_autograd(kind, shape, b, case):
    """Float32 rounding apart, the twin's loss and analytic gradient are
    autograd's of ``ncc_distance`` (the plain route's loss), through the
    clamp too."""
    ref, tmpl = _images(kind, shape, b, seed=b + len(case))
    angle, shift = _points(case, b, shape)
    loss, grad = ng.ncc_grad_reference(ref, tmpl, angle, shift)
    want_loss, want_grad = _autograd(ref, tmpl, angle, shift)
    assert loss.dtype == grad.dtype == torch.float32
    assert grad.shape == (b, 3)
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=2e-6)
    # Each parameter's gradient against its own scale over the lanes.
    scale = want_grad.abs().amax(dim=0, keepdim=True)
    assert bool(((grad - want_grad).abs() <= 1e-5 * scale + 1e-7).all())


def test_twin_sums_are_the_raw_sums():
    """The sums' layout: Σa, Σb, Σa², Σb², Σab, then Σb_p, Σa·b_p, Σb·b_p
    for angle, shift_y, shift_x; at the identity the shifts' b_p are the
    template's own finite differences."""
    ref, tmpl = _images("random", (40, 56), 2, seed=5)
    zero = torch.zeros(2)
    s = ng.sums_reference(ref, tmpl, zero, torch.zeros(2, 2))
    assert s.dtype == torch.float64 and s.shape == (2, ng.N_SUMS)
    a, b = ref.double(), tmpl.double()
    for i, want in enumerate([a, b, a * a, b * b, a * b]):
        torch.testing.assert_close(s[:, i], want.sum(dim=(1, 2)))
    g_r = torch.zeros_like(b)
    g_r[:, :-1] = b[:, 1:] - b[:, :-1]
    torch.testing.assert_close(s[:, 6], g_r.sum(dim=(1, 2)))
    torch.testing.assert_close(s[:, 9], (a * g_r).sum(dim=(1, 2)))
    torch.testing.assert_close(s[:, 12], (b * g_r).sum(dim=(1, 2)))


@pytest.mark.parametrize("estimate_rotation", [True, False])
@pytest.mark.parametrize("max_iters, tol", [(1, 1e-7), (3, 1e-7),
                                            (300, 2e-3)])
def test_twin_update_matches_the_plain_loop(estimate_rotation, max_iters,
                                            tol):
    """The twin's masked update against the plain loop's steps: one step,
    three, and a descent whose lanes freeze at different steps."""
    frames, _ = make_series(3, 9, size=64, noise=0.15, device="cpu")
    ref, tmpl = frames[:-1].contiguous(), frames[1:].contiguous()
    cfg = reg.RegistrationConfig(max_iters=max_iters, tol=tol,
                                 estimate_rotation=estimate_rotation)
    init = {"angle": torch.full((8,), 0.001), "shift": torch.zeros(8, 2)}
    d, cur, it, steps, kernel_steps = reg._minimize_level_plain(
        ref, tmpl, init, cfg)
    d2, cur2, it2, steps2 = ng.descent_reference(
        ref, tmpl, init["angle"], init["shift"],
        lr_angle=cfg.lr_angle if estimate_rotation else 0.0,
        lr_shift=cfg.lr_shift, tol=tol, max_iters=max_iters)
    assert kernel_steps == 0
    assert torch.equal(it, it2) and steps == steps2
    if max_iters == 300:
        assert len(set(it.tolist())) > 1      # the lanes froze apart
    if not estimate_rotation:
        assert torch.equal(d2["angle"], init["angle"])
    torch.testing.assert_close(d2["angle"], d["angle"], rtol=0, atol=1e-8)
    torch.testing.assert_close(d2["shift"], d["shift"], rtol=0, atol=1e-5)
    torch.testing.assert_close(cur2, cur, rtol=0, atol=1e-6)


def test_cpu_frames_take_the_plain_route():
    """On the CPU ``_minimize_level`` is the autograd version, bit for bit,
    and ``register_pair`` reports no kernel step."""
    frames, _ = make_series(4, 5, size=48, noise=0.15, device="cpu")
    ref, tmpl = frames[:-1].contiguous(), frames[1:].contiguous()
    init = {"angle": torch.zeros(4), "shift": torch.zeros(4, 2)}
    cfg = reg.RegistrationConfig(max_iters=20)
    d, cur, it, steps, kernel_steps = reg._minimize_level(ref, tmpl, init,
                                                          cfg)
    d2, cur2, it2, steps2, _ = reg._minimize_level_plain(ref, tmpl, init,
                                                         cfg)
    assert torch.equal(d["angle"], d2["angle"])
    assert torch.equal(d["shift"], d2["shift"])
    assert torch.equal(cur, cur2) and torch.equal(it, it2)
    assert steps == steps2 > 0 and kernel_steps == 0
    res = reg.register_pair(ref, tmpl, None, cfg)
    assert res.steps > 0 and res.kernel_steps == 0


@pytest.mark.parametrize("call", ["descent", "ncc_grad_cuda"])
def test_wrapper_refuses_cpu_tensors_and_autograd(call):
    """The CUDA wrapper launches nothing for CPU tensors (no fallback to
    the twin) nor for an operand that requires grad (no backward)."""
    ref, tmpl = _images("random", (32, 32), 2, seed=1)
    angle, shift = torch.zeros(2), torch.zeros(2, 2)

    def run(*args):
        if call == "descent":
            return ng.Descent(*args, lr_angle=1e-3, lr_shift=1.0, tol=1e-7,
                              max_iters=3)
        return ng.ncc_grad_cuda(*args)

    before = ng.LAUNCHES.count
    with pytest.raises(ValueError, match="ref is on cpu"):
        run(ref, tmpl, angle, shift)
    with pytest.raises(NotImplementedError, match="no gradient"):
        run(ref, tmpl, angle.requires_grad_(True), shift)
    assert ng.LAUNCHES.count == before


def _share(feeds):
    path = os.path.join(ROOT, "portbench", "metrics", "fnA_kernel_share.py")
    spec = importlib.util.spec_from_file_location("_fnA_kernel_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read({"result": SimpleNamespace(timings={}, feeds=feeds)})


def _feed(**kw):
    f = {"n_elems": 16, "fnA_steps": 0, "fnA_kernel_steps": 0,
         "refine_iters": 0, "refine_kernel_steps": 0}
    f.update(kw)
    return f


@pytest.mark.parametrize("feeds, want", [
    ([_feed(fnA_steps=90, fnA_kernel_steps=90)], 1.0),
    ([_feed(fnA_steps=90, fnA_kernel_steps=90, refine_iters=30,
            refine_kernel_steps=30),
      _feed(fnA_steps=80, fnA_kernel_steps=80)], 1.0),
    ([_feed(fnA_steps=90, refine_iters=30)], 0.0),
    ([_feed(fnA_steps=60, fnA_kernel_steps=60, refine_iters=40)], 0.6),
    ([_feed()], None),
    ([], None),
    # Feed records of a program without the kernel counters.
    ([{"n_elems": 16, "fnA_steps": 90, "refine_iters": 30}], None),
])
def test_fnA_kernel_share_reader(feeds, want):
    got = _share(feeds)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("refine", [True, False])
def test_cpu_feeds_count_no_kernel_step(refine):
    """A CPU session's feeds carry the kernel counters, at zero, and the
    reader gives 0.0 from them."""
    frames, _ = make_series(6, 9, size=48, noise=0.15, device="cpu")
    cfg = service.RegisterSeriesConfig(
        registration=reg.RegistrationConfig(max_iters=20), refine=refine,
        skip_tol=1e-6 if refine else None, backend="worksteal" if refine
        else None)
    with service.open_series(cfg, device="cpu") as s:
        s.feed(frames[:5])
        s.feed(frames[5:])
        res = s.result()
    feeds = res.feeds
    assert all(f["fnA_kernel_steps"] == 0 and f["refine_kernel_steps"] == 0
               for f in feeds)
    assert sum(f["fnA_steps"] for f in feeds) > 0
    if refine:
        assert sum(f["refine_iters"] for f in feeds) > 0
    assert _share(feeds) == 0.0
