"""Rigid deformations and differentiable image warping (paper §2.3.1).

PyTorch port of ``repro/core/deformation.py``.  A rigid deformation is
phi(x) = R(alpha) (x - c) + c + G — rotation by alpha about the image centre
c plus translation G (in pixels).  Stored as a dict of tensors
``{"angle": (), "shift": (2,)}``, the reference's pytree layout; every
function also accepts leading batch axes (``{"angle": (B,), "shift": (B, 2)}``
with images ``(B, H, W)``), which is how the port writes out ``vmap``.

Composition convention (§2.3.2): elements of the series-registration scan are
phi_{i,j} with  f_j o phi_{i,j} ~= f_i.  The scan operator's initial guess is

    compose(phi_{i,j}, phi_{j,k}) = phi_{j,k} o phi_{i,j}

Rigid transforms are closed and *associative* under composition and
non-commutative — the canonical scan element.
"""

from __future__ import annotations

from typing import Dict

import torch

Deformation = Dict[str, torch.Tensor]


def identity_deformation(dtype=torch.float32, device=None) -> Deformation:
    return {
        "angle": torch.zeros((), dtype=dtype, device=device),
        "shift": torch.zeros((2,), dtype=dtype, device=device),
    }


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=device or x.device)
    if isinstance(x, (list, tuple)) and any(isinstance(v, torch.Tensor) for v in x):
        return torch.stack([_f32(v, device) for v in x])
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_deformation(angle, shift, device=None) -> Deformation:
    return {"angle": _f32(angle, device), "shift": _f32(shift, device)}


def rotation_matrix(angle: torch.Tensor) -> torch.Tensor:
    """``(..., 2, 2)`` rotation matrices [[c, -s], [s, c]]."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def compose(a: Deformation, b: Deformation) -> Deformation:
    """b o a  (apply ``a`` first): the series-scan initial-guess operator.

    With phi(x) = R(alpha)(x-c) + c + G (all about the same centre c):
      b(a(x)) = R(ab)(x-c) + c + R(b) G_a + G_b ,  alpha_ab = alpha_a + alpha_b.
    Broadcasts over any leading axes.
    """
    angle = a["angle"] + b["angle"]
    rb = rotation_matrix(b["angle"])
    shift = (rb @ a["shift"].unsqueeze(-1)).squeeze(-1) + b["shift"]
    return {"angle": angle, "shift": shift}


def compose_batched(a: Deformation, b: Deformation) -> Deformation:
    """Leading-axis-batched compose (the circuit-executor operator contract)."""
    angle = a["angle"] + b["angle"]
    c, s = torch.cos(b["angle"]), torch.sin(b["angle"])
    ax, ay = a["shift"][..., 0], a["shift"][..., 1]
    shift = torch.stack([c * ax - s * ay, s * ax + c * ay], dim=-1) + b["shift"]
    return {"angle": angle, "shift": shift}


# Pure composition accepts operands stacked along a new leading axis, and the
# declared identity makes it a monoid (padding / ``where=`` mask lifting).
compose_batched.op_batchable = True
compose_batched.op_identity = identity_deformation
# The scan kernels' table entry for it (kernels/op_table.py): packed as
# [angle, shift0, shift1], the CUDA kernels compute the same function.
compose_batched.kernel_op = "rigid_compose"


def inverse(d: Deformation) -> Deformation:
    """phi^{-1}: R(-a)(x - c - G) + c."""
    ang = -d["angle"]
    r = rotation_matrix(ang)
    return {"angle": ang, "shift": -(r @ d["shift"].unsqueeze(-1)).squeeze(-1)}


def _bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample img[..., H, W] at float coords[..., P, Q, 2] (row, col),
    edge-clamped.  The leading axes of ``img`` batch the leading axes of
    ``coords``."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    r = torch.clamp(coords[..., 0], 0.0, h - 1.0)
    c = torch.clamp(coords[..., 1], 0.0, w - 1.0)
    r0 = torch.floor(r).to(torch.int64)
    c0 = torch.floor(c).to(torch.int64)
    r1 = torch.clamp(r0 + 1, max=h - 1)
    c1 = torch.clamp(c0 + 1, max=w - 1)
    fr = r - r0.to(r.dtype)
    fc = c - c0.to(c.dtype)
    flat = img.reshape(*lead, h * w)

    def g(rr, cc):
        idx = (rr * w + cc).reshape(*lead, -1)
        return torch.gather(flat, -1, idx).reshape(rr.shape)

    v00 = g(r0, c0)
    v01 = g(r0, c1)
    v10 = g(r1, c0)
    v11 = g(r1, c1)
    top = v00 * (1 - fc) + v01 * fc
    bot = v10 * (1 - fc) + v11 * fc
    return top * (1 - fr) + bot * fr


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one rounding to float32 (a fused multiply-add; the
    float64 product of two float32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def warp_coords(shape, d: Deformation) -> torch.Tensor:
    """phi(x) for every output pixel x of an ``(H, W)`` grid:
    ``(..., H, W, 2)`` (row, col) coordinates, batched like ``d``.

    The rotation is the reference's two-term dot product R (x - c), rounded
    as XLA's dot rounds it: the column term is fused onto the rounded row
    term (one multiply-add), so the port samples at the reference's
    coordinates to the last bit."""
    h, w = shape
    angle, shift = d["angle"], d["shift"]
    dev = angle.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rel_r = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[:, None]
    rel_c = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, :]
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    sy = shift[..., 0, None, None]
    sx = shift[..., 1, None, None]
    ry = _fma(-s, rel_c, c * rel_r) + cy + sy
    rx = _fma(c, rel_c, s * rel_r) + cx + sx
    return torch.stack([ry, rx], dim=-1)


def warp(img: torch.Tensor, d: Deformation) -> torch.Tensor:
    """(T o phi)(x) = T(phi(x)): deform template ``img`` by ``d``.

    Differentiable w.r.t. ``d`` (bilinear interpolation).
    """
    return _bilinear_sample(img, warp_coords(img.shape[-2:], d))


def ncc(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalized cross-correlation in [-1, 1] over the last two axes."""
    dims = (-2, -1)
    a = a - a.mean(dim=dims, keepdim=True)
    b = b - b.mean(dim=dims, keepdim=True)
    denom = torch.sqrt((a * a).sum(dim=dims) * (b * b).sum(dim=dims)) + eps
    return (a * b).sum(dim=dims) / denom


def ncc_distance(
    ref: torch.Tensor, tmpl: torch.Tensor, d: Deformation
) -> torch.Tensor:
    """D(R, T o phi) = 1 - NCC(R, T o phi)  (0 at perfect alignment)."""
    return 1.0 - ncc(ref, warp(tmpl, d))


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x average-pool over the last two axes (the multilevel pyramid step)."""
    h, w = img.shape[-2:]
    h2, w2 = h // 2 * 2, w // 2 * 2
    lead = img.shape[:-2]
    x = img[..., :h2, :w2].reshape(*lead, h2 // 2, 2, w2 // 2, 2)
    return x.mean(dim=(-3, -1))
