"""Synthetic TEM series of H x W frames, made on the device from a seed.

The benchmark's own generator, rewritten from the program's square-frame
``data/images.stream_series`` for the paper's 1856 x 1920 frames.  Its
structure is the same: a near-periodic lattice (two cosine gratings and a
diagonal one, plus a few Gaussian defects), a random-walk rigid drift a
frame, and shot noise.  Two things differ on purpose:

* Frames are evaluated from the analytic lattice at each pixel's
  pre-image, not resampled from a rendered base frame, so no
  interpolation or border clamping enters the frames.
* The pre-image is the exact inverse of the frame's drift,
  ``phi_i^{-1}(x) = R(-a_i)(x - c - G_i) + c``.  The program's generator
  samples at ``R(-a_i)(x - c) + c - G_i``, which is off by about
  ``a_i |G_i|`` (tenths of a pixel after a few hundred frames).

So ``f_i o phi_i == f_0`` up to noise, and ``phi_i`` (angle ``a_i``, shift
``G_i``, rotation about the frame centre ``c``) is the exact ground truth
``phi_{0,i}`` of registration.  The trajectory is drawn on the host in
float64; frames and noise are made on ``device`` in float32, a chunk of
frames a call, with one device generator seeded from the seed.

The specimen (the lattice and its defects) belongs to the configuration,
the motion to the traffic mix, and the seed draws the noise alone.  The
motion is the program's generator's random walk (steps uniform in
``[-drift_step, drift_step]`` a frame and axis, rotations in
``[-rotation_step, rotation_step]``), drawn once from the mix's
``path_seed``: every seed registers the same path, so a seed changes the
noise and not the amount of work.  (The refinements register each frame to
frame 0, and how far a walk has wandered from it sets how many guesses pass
the check: walks drawn from the run's seed made two seeds' windows differ
by 9% composing and 18% refining.)
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

#: Frames rendered a call: large calls, a bounded temporary (~1.6 GB at
#: 1856 x 1920).
RENDER_BATCH = 16


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo


def trajectory(path_seed: int, n_frames: int, drift_step: float,
               rotation_step: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(angle (n,), shift (n, 2))`` in float64 on the host: the cumulative
    motion ``phi_{0,i}`` of each frame, a random walk drawn from
    ``path_seed`` (module docstring); frame 0 is the identity.  All shift
    steps are drawn before the rotations, so the path also depends on
    ``n_frames``: a configuration's frame count is part of its path."""
    gen = torch.Generator().manual_seed(int(path_seed))
    steps = _uniform(gen, (n_frames, 2), -drift_step, drift_step)
    rots = _uniform(gen, (n_frames,), -rotation_step, rotation_step)
    steps[0] = 0.0
    rots[0] = 0.0
    return torch.cumsum(rots, 0), torch.cumsum(steps, 0)


def pair_truth(angle: torch.Tensor, shift: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Ground truth of function A's pairs, ``phi_{i,i+1} = phi_{i+1} o
    phi_i^{-1}``, in float64: angle ``a_{i+1} - a_i`` and shift
    ``G_{i+1} - R(a_{i+1} - a_i) G_i`` (rotations act on (row, col))."""
    a = angle.double()
    g = shift.double()
    da = a[1:] - a[:-1]
    c, s = torch.cos(da), torch.sin(da)
    gy, gx = g[:-1, 0], g[:-1, 1]
    rot = torch.stack([c * gy - s * gx, s * gy + c * gx], dim=-1)
    return {"angle": da, "shift": g[1:] - rot}


class Lattice:
    """The analytic near-periodic lattice ``L(row, col)`` of one specimen
    seed, normalised by frame 0's mean and standard deviation."""

    def __init__(self, seed: int, height: int, width: int, period: float,
                 distortion: float, blobs: int, device):
        gen = torch.Generator().manual_seed(int(seed))
        self.period = float(period)
        self.distortion = float(distortion)
        self.blob_rows = (_uniform(gen, (blobs,), 0.0, 1.0) * height).tolist()
        self.blob_cols = (_uniform(gen, (blobs,), 0.0, 1.0) * width).tolist()
        self.mean, self.std = 0.0, 1.0
        rows = torch.arange(height, dtype=torch.float32, device=device)
        cols = torch.arange(width, dtype=torch.float32, device=device)
        base = self(rows[:, None], cols[None, :])
        self.mean = float(base.mean())
        self.std = float(base.std(correction=0)) + 1e-6

    def __call__(self, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        w = 2.0 * math.pi / self.period
        img = (torch.cos(w * c) + torch.cos(w * r)
               + 0.5 * torch.cos((w / math.sqrt(2.0)) * (c + r)))
        inv2s2 = 1.0 / (2.0 * (self.period * 0.8) ** 2)
        for i, (br, bc) in enumerate(zip(self.blob_rows, self.blob_cols)):
            sign = 1.0 if i % 2 == 0 else -1.0
            img = img + (sign * self.distortion) * torch.exp(
                -((c - bc) ** 2 + (r - br) ** 2) * inv2s2)
        return (img - self.mean) / self.std


def render(out: torch.Tensor, lattice: Lattice, angle: torch.Tensor,
           shift: torch.Tensor, noise: float, gen: torch.Generator) -> None:
    """Fill ``out`` (n, H, W) with frames ``f_i = L o phi_i^{-1}`` plus
    ``noise`` times standard normal noise drawn from ``gen`` (on ``out``'s
    device), ``RENDER_BATCH`` frames a call; ``angle``/``shift`` are the
    host trajectory of these n frames."""
    n, h, w = out.shape
    dev = out.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rel_r = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[:, None]
    rel_c = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, :]
    for lo in range(0, n, RENDER_BATCH):
        hi = min(lo + RENDER_BATCH, n)
        a = angle[lo:hi].double()
        cos = torch.cos(a).float().to(dev)[:, None, None]
        sin = torch.sin(a).float().to(dev)[:, None, None]
        gy = shift[lo:hi, 0].float().to(dev)[:, None, None]
        gx = shift[lo:hi, 1].float().to(dev)[:, None, None]
        dr = rel_r - gy
        dc = rel_c - gx
        # R(-a) (x - c - G) + c, R(t) = [[cos t, -sin t], [sin t, cos t]].
        qr = cos * dr + sin * dc + cy
        qc = cos * dc - sin * dr + cx
        frames = lattice(qr, qc)
        del qr, qc, dr, dc
        frames.add_(torch.randn(frames.shape, generator=gen, device=dev,
                                dtype=torch.float32), alpha=float(noise))
        out[lo:hi] = frames
        del frames


def make_series(seed: int, cfg: dict, traffic: dict, n_frames: int, device):
    """``(frames (n, H, W) float32 on device, truth)``: the cell's resident
    series for ``seed`` and its ground truth ``{"angle", "shift"}`` (float64,
    host).  ``cfg`` is the configuration file's dict, ``traffic`` the mix's."""
    period = float(cfg["lattice_period"])
    angle, shift = trajectory(
        int(traffic["path_seed"]), n_frames,
        float(traffic["drift_step_periods"]) * period,
        float(traffic["rotation_step"]))
    h, w = int(cfg["height"]), int(cfg["width"])
    lattice = Lattice(int(cfg["specimen_seed"]), h, w, period,
                      float(cfg["distortion"]), int(cfg["blobs"]), device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    frames = torch.empty((n_frames, h, w), dtype=torch.float32, device=device)
    render(frames, lattice, angle, shift, float(cfg["noise"]), gen)
    return frames, {"angle": angle, "shift": shift}
