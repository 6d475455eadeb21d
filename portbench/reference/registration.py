"""Function A in plain PyTorch: multilevel rigid registration by gradient
descent on 1 - NCC (paper §2.3, Berkels et al.), the benchmark's reference.

Written from the paper's method, not from the program: a rigid deformation
``phi(x) = R(a)(x - c) + c + G`` about the frame centre ``c`` (rotations act
on (row, col) vectors), the template sampled bilinearly at ``phi(x)`` with
edge clamping, a pyramid of 2x average pools coarse to fine, and on each
level gradient steps ``G -= lr_shift dD/dG``, ``a -= lr_angle dD/da`` until
``|D_prev - D| <= tol`` or ``max_iters`` steps.  A batch of pairs runs as
independent lanes: a lane that has stopped keeps its point.

``dtype`` is the precision of the pixels and of the arithmetic on them
(warp, means, sums); the deformation parameters and the sampling
coordinates stay float32.  float32 is the reference; bfloat16 is the
control that ``correct`` has to refuse.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _coords(h: int, w: int, angle: torch.Tensor, shift: torch.Tensor):
    """Sampling rows and columns ``phi(x)`` of every output pixel: (B, h, w)."""
    dev = angle.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rr = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[None, :, None]
    cc = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, None, :]
    cos = torch.cos(angle)[:, None, None]
    sin = torch.sin(angle)[:, None, None]
    rows = cos * rr - sin * cc + cy + shift[:, 0, None, None]
    cols = sin * rr + cos * cc + cx + shift[:, 1, None, None]
    return rows, cols


def warp(img: torch.Tensor, angle: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``img`` (B, h, w) sampled at ``phi(x)``: bilinear, edge-clamped."""
    b, h, w = img.shape
    rows, cols = _coords(h, w, angle, shift)
    r = rows.clamp(0.0, h - 1.0)
    c = cols.clamp(0.0, w - 1.0)
    r0 = torch.floor(r)
    c0 = torch.floor(c)
    fr = (r - r0).to(img.dtype)
    fc = (c - c0).to(img.dtype)
    r0 = r0.long()
    c0 = c0.long()
    r1 = (r0 + 1).clamp(max=h - 1)
    c1 = (c0 + 1).clamp(max=w - 1)
    flat = img.reshape(b, h * w)

    def at(ri, ci):
        return torch.gather(flat, 1, (ri * w + ci).reshape(b, -1)).reshape(b, h, w)

    top = at(r0, c0) * (1 - fc) + at(r0, c1) * fc
    bottom = at(r1, c0) * (1 - fc) + at(r1, c1) * fc
    return top * (1 - fr) + bottom * fr


def distance(ref: torch.Tensor, tmpl: torch.Tensor, angle: torch.Tensor,
             shift: torch.Tensor) -> torch.Tensor:
    """``D = 1 - NCC(ref, tmpl o phi)`` a lane: (B,)."""
    a = ref - ref.mean(dim=(1, 2), keepdim=True)
    t = warp(tmpl, angle, shift)
    t = t - t.mean(dim=(1, 2), keepdim=True)
    num = (a * t).sum(dim=(1, 2))
    den = torch.sqrt((a * a).sum(dim=(1, 2)) * (t * t).sum(dim=(1, 2))) + 1e-6
    return 1.0 - num / den


def _half(img: torch.Tensor) -> torch.Tensor:
    b, h, w = img.shape
    h2, w2 = h // 2, w // 2
    x = img[:, :2 * h2, :2 * w2].reshape(b, h2, 2, w2, 2)
    return x.mean(dim=(2, 4))


def _level(ref, tmpl, angle, shift, reg: dict):
    """Gradient descent on one level, lanes frozen as they stop."""
    lr_a = float(reg["lr_angle"]) if reg.get("estimate_rotation", True) else 0.0
    lr_s = float(reg["lr_shift"])
    tol = float(reg["tol"])
    max_iters = int(reg["max_iters"])
    angle, shift = angle.detach(), shift.detach()
    with torch.enable_grad():
        pa = angle.clone().requires_grad_(True)
        ps = shift.clone().requires_grad_(True)
        loss = distance(ref, tmpl, pa, ps)
        cur = loss.detach().float()
        prev = cur + 1.0
        steps = torch.zeros(cur.shape, dtype=torch.int32, device=cur.device)
        while True:
            active = (steps < max_iters) & ((prev - cur).abs() > tol)
            if not bool(active.any()):
                break
            ga, gs = torch.autograd.grad(loss.sum(), [pa, ps])
            na = angle - lr_a * ga.float()
            ns = shift - lr_s * gs.float()
            pa = na.detach().requires_grad_(True)
            ps = ns.detach().requires_grad_(True)
            loss = distance(ref, tmpl, pa, ps)
            new = loss.detach().float()
            angle = torch.where(active, na.detach(), angle)
            shift = torch.where(active[:, None], ns.detach(), shift)
            prev = torch.where(active, cur, prev)
            cur = torch.where(active, new, cur)
            steps = steps + active.to(torch.int32)
    return angle, shift, steps


def register(ref: torch.Tensor, tmpl: torch.Tensor, reg: dict,
             dtype: torch.dtype = torch.float32,
             init: Dict[str, torch.Tensor] = None
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Function A on a batch of pairs ``ref``/``tmpl`` (B, H, W): the
    deformation ``{"angle" (B,), "shift" (B, 2)}`` (float32) with
    ``tmpl o phi ~= ref``, and each lane's total iterations.  ``init`` is
    the starting deformation (the identity when None)."""
    b = ref.shape[0]
    dev = ref.device
    refs, tmps = [ref.to(dtype)], [tmpl.to(dtype)]
    levels = int(reg["levels"])
    for _ in range(levels - 1):
        refs.append(_half(refs[-1]))
        tmps.append(_half(tmps[-1]))
    scale = 2.0 ** (levels - 1)
    if init is None:
        angle = torch.zeros((b,), dtype=torch.float32, device=dev)
        shift = torch.zeros((b, 2), dtype=torch.float32, device=dev)
    else:
        angle = init["angle"].float().to(dev)
        shift = init["shift"].float().to(dev) / scale
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    for lvl in range(levels - 1, -1, -1):
        angle, shift, n = _level(refs[lvl], tmps[lvl], angle, shift, reg)
        iters = iters + n
        if lvl:
            shift = shift * 2.0
    return {"angle": angle, "shift": shift}, iters
