"""Synthetic near-periodic electron-microscopy-like image series.

Port of ``repro/data/images.py``.  The paper's TEM data (1920x1856 @ 400 fps
aluminum-oxidation series) is not public; frames are generated with the
structural properties that make the registration problem hard and the scan
operator imbalanced:

  * (nearly) periodic atomic lattice  -> registration ambiguous mod period;
  * per-frame rigid drift (random walk, steps < period/2 so the neighbouring-
    frame assumption of §2.3.2 holds);
  * heavy shot noise (low-dose imaging)  -> unpredictable minimiser cost.

A seed or ``torch.Generator`` replaces the reference's jax key; the two give
different numbers, so tests that compare the packages take their frames
from the reference as numpy.  The small random draws (drift, rotation, blob
centres, one noise seed per frame) come from a CPU generator, so they are
the same on every device; each frame's noise comes from its own generator
on ``device``, so a chunked render equals the one-shot render.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple, Union

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.deformation import Deformation, make_deformation, warp

Seed = Union[int, torch.Generator, None]


def _generator(seed: Seed, default: int) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(default if seed is None else int(seed))


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0):
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (hi - lo) + lo


def lattice_image(
    size: int = 96,
    period: float = 12.0,
    seed: Seed = None,
    distortion: float = 0.15,
    *,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Near-periodic lattice: sum of two cosine gratings + random low-frequency
    distortion field (the 'deviations' that carry the material signal)."""
    dev = resolve_device(device)
    gen = _generator(seed, 1410)
    r = torch.arange(size, dtype=torch.float32, device=dev)
    y, x = torch.meshgrid(r, r, indexing="ij")
    img = (
        torch.cos(2 * math.pi * x / period)
        + torch.cos(2 * math.pi * y / period)
        + 0.5 * torch.cos(2 * math.pi * (x + y) / (period * math.sqrt(2.0)))
    )
    # Low-frequency defects: a few Gaussian blobs that break perfect symmetry.
    nblobs = 6
    cx = (_uniform(gen, (nblobs,)) * size).tolist()
    cy = (_uniform(gen, (nblobs,)) * size).tolist()
    for i in range(nblobs):
        img = img + distortion * torch.exp(
            -(((x - cx[i]) ** 2 + (y - cy[i]) ** 2) / (2 * (period * 0.8) ** 2))
        ) * (1.0 if i % 2 == 0 else -1.0)
    img = (img - img.mean()) / (img.std(correction=0) + 1e-6)
    return img


def make_series(
    seed: Seed,
    n_frames: int,
    size: int = 96,
    period: float = 12.0,
    drift_step: Optional[float] = None,
    rotation_step: float = 0.002,
    noise: float = 0.25,
    *,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, Deformation]:
    """Returns (frames[N,H,W], true cumulative deformations phi_{0,i}).

    frames[i] is the base lattice observed after cumulative drift d_i, i.e.
    f_i o phi_{0,i} ~= f_0 with phi_{0,i} = translation(d_i) (+ tiny rotation).
    One batched render — the single-chunk case of :func:`stream_series`.
    """
    chunks, true = stream_series(
        seed, n_frames, chunk_size=n_frames, size=size, period=period,
        drift_step=drift_step, rotation_step=rotation_step, noise=noise,
        device=device,
    )
    return next(chunks), true


def stream_series(
    seed: Seed,
    n_frames: int,
    *,
    chunk_size: int = 32,
    size: int = 96,
    period: float = 12.0,
    drift_step: Optional[float] = None,
    rotation_step: float = 0.002,
    noise: float = 0.25,
    device: DeviceLike = None,
) -> Tuple[Iterator[torch.Tensor], Deformation]:
    """Streaming twin of :func:`make_series`: frames arrive in acquisition
    order as ``(chunk,)`` batches of at most ``chunk_size``.

    The drift trajectory is fixed up front (it is metadata-sized), but
    frames are *rendered* lazily per chunk on ``device``, so a consumer can
    overlap function-A preprocessing with acquisition.

    Returns ``(chunks, true)``: the chunk iterator and the ground-truth
    cumulative deformations (for evaluation only — not consumed upstream).
    """
    dev = resolve_device(device)
    if drift_step is None:
        drift_step = period * 0.35
    gen = _generator(seed, 0)
    base = lattice_image(size, period, int(torch.randint(
        0, 2**62, (), generator=gen)), device=dev)
    steps = _uniform(gen, (n_frames, 2), -drift_step, drift_step)
    rots = _uniform(gen, (n_frames,), -rotation_step, rotation_step)
    noise_seeds = torch.randint(0, 2**62, (n_frames,), generator=gen).tolist()
    steps[0] = 0.0
    rots[0] = 0.0
    cum_shift = torch.cumsum(steps, dim=0).to(dev)
    cum_rot = torch.cumsum(rots, dim=0).to(dev)

    def render_chunk(lo: int, hi: int) -> torch.Tensor:
        # f_i(x) = f_0(phi^{-1}(x)) so that f_i(phi(x)) = f_0(x):
        # warp() samples f_0 at phi_inv(x) when given the inverse deformation.
        inv = make_deformation(-cum_rot[lo:hi], -cum_shift[lo:hi])
        frames = warp(base.expand(hi - lo, size, size), inv)
        for j, i in enumerate(range(lo, hi)):
            g = torch.Generator(device=dev).manual_seed(noise_seeds[i])
            frames[j] += noise * torch.randn(
                (size, size), generator=g, device=dev
            )
        return frames

    def chunks() -> Iterator[torch.Tensor]:
        for lo in range(0, n_frames, chunk_size):
            yield render_chunk(lo, min(lo + chunk_size, n_frames))

    true = {"angle": cum_rot, "shift": cum_shift}
    return chunks(), true
