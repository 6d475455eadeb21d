"""Function A's gradient step in one pass: the CUDA kernels and their plain twin.

Function A (``core/registration.py:_minimize_level``) descends
D = 1 - NCC(ref, tmpl o phi) over ``[angle, shift_y, shift_x]`` for a batch
of frame pairs.  On the card each step is two launches
(``csrc/ncc_grad.cu``): a sums kernel that takes, for every lane, the 14
raw sums from which the loss and its analytic gradient follow (one pass
over the output pixels, with the coordinates and taps of
``deformation.warp``), and a step kernel that folds them and applies the
descent's masked update on the card.  The host reads one word a step, the
``more`` flag.  It replaces no TPU kernel: the reference's ``jax.grad``
inside its jitted loop is fused by XLA, and the port's plain route is
``torch.autograd`` over ``warp`` and ``ncc``.

:class:`Descent` launches the kernels and raises for CPU tensors; there is
no fallback from the card to the plain version.  :func:`sums_reference`,
:func:`fold_reference`, :func:`step_reference` and
:func:`descent_reference` are its plain PyTorch twin, in float64 where the
kernels sum in float64, for the tests on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.deformation import warp_coords

from . import _cuda

NAME = "ncc_grad"
SOURCE = "src/repro_torch/kernels/csrc/ncc_grad.cu"
LAUNCHES = _cuda.launch_counter(NAME)

#: The sums, in the kernels' order: Σa, Σb, Σa², Σb², Σab, then for p in
#: (angle, shift_y, shift_x) Σb_p, Σa·b_p, Σb·b_p (b_p = ∂b/∂p).
N_SUMS = 14
#: Pixels a block of the sums kernel takes (``csrc/ncc_grad.cu: kChunk``).
CHUNK = 4096
#: The per-lane float32 state, in runs of ``b`` values (``State``).
_FLOATS = (("angle", 1), ("shift", 2), ("probe_angle", 1),
           ("probe_shift", 2), ("grad", 3), ("cur", 1), ("prev", 1))
_N_FLOATS = sum(k for _, k in _FLOATS)


def n_chunks(h: int, w: int) -> int:
    """Blocks of the sums kernel a lane."""
    return -(-h * w // CHUNK)


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------


def _taps(tmpl: torch.Tensor, angle: torch.Tensor, shift: torch.Tensor):
    """``(b, [b_angle, b_y, b_x])``: the template sampled at phi(x) for every
    output pixel, as ``deformation.warp`` samples it, and its derivatives
    in the three parameters (zero through a coordinate the clamp held)."""
    h, w = tmpl.shape[-2:]
    lead = tmpl.shape[:-2]
    coords = warp_coords((h, w), {"angle": angle, "shift": shift})
    ry, rx = coords[..., 0], coords[..., 1]
    in_r = (ry >= 0.0) & (ry <= h - 1.0)
    in_c = (rx >= 0.0) & (rx <= w - 1.0)
    r = torch.clamp(ry, 0.0, h - 1.0)
    c = torch.clamp(rx, 0.0, w - 1.0)
    r0 = torch.floor(r).to(torch.int64)
    c0 = torch.floor(c).to(torch.int64)
    r1 = torch.clamp(r0 + 1, max=h - 1)
    c1 = torch.clamp(c0 + 1, max=w - 1)
    fr = r - r0.to(r.dtype)
    fc = c - c0.to(c.dtype)
    flat = tmpl.reshape(*lead, h * w)

    def g(rr, cc):
        idx = (rr * w + cc).reshape(*lead, -1)
        return torch.gather(flat, -1, idx).reshape(rr.shape)

    v00, v01, v10, v11 = g(r0, c0), g(r0, c1), g(r1, c0), g(r1, c1)
    top = v00 * (1 - fc) + v01 * fc
    bot = v10 * (1 - fc) + v11 * fc
    b = top * (1 - fr) + bot * fr
    zero = torch.zeros_like(b)
    g_r = torch.where(in_r, bot - top, zero)
    g_c = torch.where(in_c, (v01 - v00) * (1 - fr) + (v11 - v10) * fr, zero)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rel_r = (torch.arange(h, dtype=torch.float32, device=b.device) - cy)[:, None]
    rel_c = (torch.arange(w, dtype=torch.float32, device=b.device) - cx)[None, :]
    cs = torch.cos(angle)[..., None, None]
    sn = torch.sin(angle)[..., None, None]
    b_a = g_r * (-cs * rel_c - sn * rel_r) + g_c * (cs * rel_r - sn * rel_c)
    return b, (b_a, g_r, g_c)


def sums_reference(ref: torch.Tensor, tmpl: torch.Tensor,
                   angle: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The 14 raw sums of each lane, ``(B, 14)`` float64, from the same
    coordinates and taps as the sums kernel (``ref``/``tmpl`` ``(B, h, w)``,
    ``angle (B,)``, ``shift (B, 2)``)."""
    b, bp = _taps(tmpl, angle, shift)
    a = ref.double()
    b = b.double()
    bp = [x.double() for x in bp]
    dims = (-2, -1)
    cols = [a, b, a * a, b * b, a * b, *bp, *(a * x for x in bp),
            *(b * x for x in bp)]
    return torch.stack([x.sum(dim=dims) for x in cols], dim=-1)


def fold_reference(sums: torch.Tensor,
                   n_px: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, grad)`` from the raw sums, as the step kernel folds them:
    float64 arithmetic, each rounded to float32 at the end; ``grad (B, 3)``
    is dD/d[angle, shift_y, shift_x]."""
    s = sums.double()
    n = float(n_px)
    saa = s[:, 2] - s[:, 0] * s[:, 0] / n
    sbb = s[:, 3] - s[:, 1] * s[:, 1] / n
    sab = s[:, 4] - s[:, 0] * s[:, 1] / n
    root = torch.sqrt(saa * sbb)
    den = root + 1e-6
    loss = (1.0 - sab / den).float()
    dsab = s[:, 8:11] - s[:, :1] * s[:, 5:8] / n
    dsbb = s[:, 11:14] - s[:, 1:2] * s[:, 5:8] / n
    grad = -(dsab / den[:, None]
             - (sab / (den * den) * saa)[:, None] * dsbb / root[:, None])
    return loss, grad.float()


def ncc_grad_reference(ref: torch.Tensor, tmpl: torch.Tensor,
                       angle: torch.Tensor,
                       shift: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of one sums pass and fold: ``(loss (B,), grad (B, 3))``."""
    h, w = ref.shape[-2:]
    return fold_reference(sums_reference(ref, tmpl, angle, shift), h * w)


def step_reference(st: Dict[str, torch.Tensor], loss: torch.Tensor,
                   grad: torch.Tensor, *, lr_angle: float, lr_shift: float,
                   tol: float, max_iters: int, first: bool) -> bool:
    """The step kernel's update of ``st`` in place, from the loss and the
    gradient at the point the sums were taken at (``st``'s accepted point
    when ``first``, else its probe); returns ``more``.  A lane frozen
    before the step keeps its state."""
    if first:
        st["cur"] = loss.clone()
        st["prev"] = loss + 1.0
        st["it"] = torch.zeros_like(st["it"])
        moved = torch.ones_like(st["act"])
    else:
        moved = st["act"].clone()
        st["angle"] = torch.where(moved, st["probe_angle"], st["angle"])
        st["shift"] = torch.where(moved[:, None], st["probe_shift"],
                                  st["shift"])
        st["prev"] = torch.where(moved, st["cur"], st["prev"])
        st["cur"] = torch.where(moved, loss, st["cur"])
        st["it"] = st["it"] + moved.to(torch.int32)
    st["grad"] = torch.where(moved[:, None], grad, st["grad"])
    act = (st["it"] < max_iters) & ((st["prev"] - st["cur"]).abs() > tol)
    st["act"] = torch.where(moved, act, st["act"])
    st["probe_angle"] = torch.where(
        moved, st["angle"] - lr_angle * st["grad"][:, 0], st["probe_angle"])
    st["probe_shift"] = torch.where(
        moved[:, None], st["shift"] - lr_shift * st["grad"][:, 1:],
        st["probe_shift"])
    return bool(st["act"].any())


def descent_reference(ref: torch.Tensor, tmpl: torch.Tensor,
                      angle: torch.Tensor, shift: torch.Tensor, *,
                      lr_angle: float, lr_shift: float, tol: float,
                      max_iters: int):
    """The plain twin of :class:`Descent`'s loop on one pyramid level:
    ``(deformation, cur, it, steps)`` as ``_minimize_level`` returns them."""
    b = ref.shape[0]
    z = torch.zeros((b,), dtype=torch.float32, device=ref.device)
    st = {"angle": angle.detach().float().clone(),
          "shift": shift.detach().float().clone(),
          "probe_angle": z, "probe_shift": z[:, None].expand(b, 2),
          "grad": z[:, None].expand(b, 3), "cur": z, "prev": z,
          "it": torch.zeros((b,), dtype=torch.int32, device=ref.device),
          "act": torch.zeros((b,), dtype=torch.bool, device=ref.device)}
    kw = dict(lr_angle=lr_angle, lr_shift=lr_shift, tol=tol,
              max_iters=max_iters)
    loss, grad = ncc_grad_reference(ref, tmpl, st["angle"], st["shift"])
    more = step_reference(st, loss, grad, first=True, **kw)
    steps = 0
    while more:
        loss, grad = ncc_grad_reference(ref, tmpl, st["probe_angle"],
                                        st["probe_shift"])
        more = step_reference(st, loss, grad, first=False, **kw)
        steps += 1
    return ({"angle": st["angle"], "shift": st["shift"]}, st["cur"],
            st["it"], steps)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _launcher():
    """The library's launch and error-string entry points, typed."""
    lib = _cuda.load(NAME)
    fn = lib.ncc_grad_launch
    if fn.argtypes is None:  # argtypes last: it marks the entry as typed
        fn.restype = ctypes.c_int
        lib.ncc_grad_error_string.restype = ctypes.c_char_p
        lib.ncc_grad_error_string.argtypes = [ctypes.c_int]
        lib.ncc_grad_chunk_pixels.restype = ctypes.c_int
        if lib.ncc_grad_chunk_pixels() != CHUNK:
            raise RuntimeError("ncc_grad: the library's chunk is not CHUNK")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
    return fn, lib.ncc_grad_error_string


def _check(ref: torch.Tensor, tmpl: torch.Tensor, angle: torch.Tensor,
           shift: torch.Tensor) -> None:
    _cuda.refuse_autograd("ncc_grad kernel", ref, tmpl, angle, shift)
    for name, t in (("ref", ref), ("tmpl", tmpl)):
        if t.device.type != "cuda":
            raise ValueError(f"ncc_grad kernel: {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ncc_grad kernel: {name} is {t.dtype}, not f32")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"ncc_grad kernel: {name} must be a contiguous "
                             f"(B, h, w) stack, got {tuple(t.shape)}")
    if tmpl.shape != ref.shape or tmpl.device != ref.device:
        raise ValueError("ncc_grad kernel: ref and tmpl differ in shape or "
                         "device")
    b = ref.shape[0]
    if tuple(angle.shape) != (b,) or tuple(shift.shape) != (b, 2):
        raise ValueError(f"ncc_grad kernel: angle {tuple(angle.shape)} and "
                         f"shift {tuple(shift.shape)} for {b} lanes")


class Descent:
    """Function A's descent on one pyramid level, on the card.

    ``ref``/``tmpl``: contiguous float32 ``(B, h, w)`` on a CUDA device;
    ``angle (B,)``/``shift (B, 2)`` the starting point (copied).  The state
    (the accepted point, the next point, the gradient, ``cur``, ``prev``,
    ``it``, ``act`` and ``more``) and the sums' scratch live on the card,
    allocated per instance, so threads may descend at once.  Launches go
    to the device's current stream.  :meth:`start` evaluates the starting
    point, :meth:`step` takes one masked step; each returns ``more``, the
    host's one sync."""

    def __init__(self, ref: torch.Tensor, tmpl: torch.Tensor,
                 angle: torch.Tensor, shift: torch.Tensor, *,
                 lr_angle: float, lr_shift: float, tol: float,
                 max_iters: int):
        _check(ref, tmpl, angle, shift)
        self.ref, self.tmpl = ref, tmpl
        b, h, w = ref.shape
        self._shape = (b, h, w)
        self._hyper = (float(lr_angle), float(lr_shift), float(tol),
                       int(max_iters))
        dev = ref.device
        self._fn, self._error_string = _launcher()
        with torch.cuda.device(dev):
            self._f = torch.empty((_N_FLOATS * b + 2 * b + 1,),
                                  dtype=torch.float32, device=dev)
            self._scratch = torch.empty(
                (b * N_SUMS * (1 + n_chunks(h, w)),), dtype=torch.float64,
                device=dev)
        views, at = {}, 0
        for name, k in _FLOATS:
            views[name] = self._f[at:at + k * b].view(b, k) if k > 1 \
                else self._f[at:at + b]
            at += k * b
        ints = self._f[at:].view(torch.int32)
        self.angle, self.shift = views["angle"], views["shift"]
        self.grad, self.cur = views["grad"], views["cur"]
        self.it, self._more = ints[:b], ints[2 * b:]
        self.sums = self._scratch[:b * N_SUMS].view(b, N_SUMS)
        self.angle.copy_(angle.detach())
        self.shift.copy_(shift.detach())

    def _launch(self, first: int) -> bool:
        b, h, w = self._shape
        dev = self.ref.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = self._fn(self.ref.data_ptr(), self.tmpl.data_ptr(),
                       self._f.data_ptr(), self._scratch.data_ptr(), b, h, w,
                       *self._hyper, first, stream)
        if err != 0:
            msg = self._error_string(err).decode()
            raise RuntimeError(f"ncc_grad kernel launch failed: {msg} ({err})")
        LAUNCHES.add()
        return bool(self._more)

    def start(self) -> bool:
        """Evaluate the starting point: ``cur`` its loss, ``prev = cur + 1``,
        ``it = 0``, and the first step's point."""
        return self._launch(1)

    def step(self) -> bool:
        """Move every active lane to its next point and test it."""
        return self._launch(0)

    @property
    def deformation(self) -> Dict[str, torch.Tensor]:
        return {"angle": self.angle, "shift": self.shift}


def ncc_grad_cuda(ref: torch.Tensor, tmpl: torch.Tensor, angle: torch.Tensor,
                  shift: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """One sums pass and fold on the card: ``(loss (B,), grad (B, 3),
    sums (B, 14) float64)`` at ``(angle, shift)``.  Raises on anything the
    kernels do not take (CPU tensors, tensors that require grad, dtype,
    layout, shapes)."""
    d = Descent(ref, tmpl, angle, shift, lr_angle=0.0, lr_shift=0.0, tol=0.0,
                max_iters=0)
    d.start()
    return d.cur, d.grad, d.sums


def ensure_built() -> float:
    """Build the kernels if this process has not; returns the seconds spent."""
    return _cuda.build([NAME])
