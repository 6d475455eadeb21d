"""Fused rigid-warp + NCC partial sums: the CUDA kernel and its plain version.

Port of ``repro/kernels/warp_ncc.py``.  The registration operator's guess
check evaluates D(R, T o phi) = 1 - NCC(R, T o phi); this kernel computes the
warped template and the per-tile NCC partial sums in one pass over output
tiles (``csrc/warp_ncc.cu``), and a one-block kernel launched after it folds
the ``(n_tiles, 8)`` sums into the NCC scalar on the card, so a guess check
is two launches and one copy of the result to the host.

:func:`warp_ncc` and :func:`ncc_distance` take their route from where the
tensors lie: on the CPU they run :func:`warp_ncc_reference`, the plain
PyTorch version of the same function; on a CUDA device they launch the
kernels (building them at first use) or raise.  There is no fallback from
the card to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.deformation import warp

from . import _cuda

NAME = "warp_ncc"
SOURCE = "src/repro_torch/kernels/csrc/warp_ncc.cu"
REPLACES = "src/repro/kernels/warp_ncc.py:29"
LAUNCHES = _cuda.launch_counter(NAME)


def _params(angle, shift, device) -> torch.Tensor:
    """``[angle, shift_y, shift_x]`` as a contiguous f32 vector on ``device``
    (built with tensor ops, so a device-resident guess never syncs)."""
    angle = torch.as_tensor(angle, dtype=torch.float32, device=device)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=device)
    return torch.cat([angle.reshape(1), shift.reshape(2)]).contiguous()


def fold(sums: torch.Tensor) -> torch.Tensor:
    """NCC from the per-tile partial sums (the reference's host fold)."""
    s = sums.sum(dim=0)
    n = s[5]
    sa, sb, saa, sbb, sab = s[0], s[1], s[2], s[3], s[4]
    cov = sab - sa * sb / n
    va = saa - sa * sa / n
    vb = sbb - sb * sb / n
    return cov / (torch.sqrt(va * vb) + 1e-6)


def _check_shapes(img: torch.Tensor, ref: torch.Tensor, tile: int) -> None:
    if img.dim() != 2 or img.shape != ref.shape:
        raise ValueError(
            f"warp_ncc takes two (H, W) images of one shape, got "
            f"{tuple(img.shape)} and {tuple(ref.shape)}"
        )
    h, w = img.shape
    if tile not in (16, 32):
        raise ValueError(f"tile must be 16 or 32, got {tile}")
    if h % tile or w % tile:
        raise ValueError(f"({h}, {w}) does not divide into {tile}-tiles")


def warp_ncc_sums_reference(
    img: torch.Tensor, ref: torch.Tensor, angle, shift, *, tile: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(warped, sums)`` with sums ``(n_tiles, 8)``
    in the kernel's layout (row-major tile order)."""
    _check_shapes(img, ref, tile)
    h, w = img.shape
    p = _params(angle, shift, img.device)
    warped = warp(img, {"angle": p[0], "shift": p[1:]}).to(img.dtype)
    a = warped.to(torch.float32)
    b = ref.to(torch.float32)

    def per_tile(x):
        t = x.reshape(h // tile, tile, w // tile, tile)
        return t.sum(dim=(1, 3)).reshape(-1)

    n_tiles = (h // tile) * (w // tile)
    area = torch.full((n_tiles,), float(tile * tile), device=img.device)
    zero = torch.zeros((n_tiles,), device=img.device)
    sums = torch.stack([
        per_tile(a), per_tile(b), per_tile(a * a), per_tile(b * b),
        per_tile(a * b), area, zero, zero,
    ], dim=1)
    return warped, sums


def warp_ncc_reference(
    img: torch.Tensor, ref: torch.Tensor, angle, shift, *, tile: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`warp_ncc`: ``(warped, ncc)``."""
    warped, sums = warp_ncc_sums_reference(img, ref, angle, shift, tile=tile)
    return warped, fold(sums)


def _launcher():
    """The kernel library's launch and error-string entry points, typed."""
    lib = _cuda.load(NAME)
    fn = lib.warp_ncc_launch
    if fn.argtypes is None:  # argtypes last: it marks the entry as typed
        fn.restype = ctypes.c_int
        lib.warp_ncc_error_string.restype = ctypes.c_char_p
        lib.warp_ncc_error_string.argtypes = [ctypes.c_int]
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    return fn, lib.warp_ncc_error_string


def _param(x, n: int, name: str, device: torch.device) -> torch.Tensor:
    """``angle`` or ``shift`` as the kernel reads it: a contiguous f32
    tensor of ``n`` values on ``device``.  A tensor is taken as it is (the
    deformation's own, no copy) or refused; a Python number or sequence is
    copied to the device."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.float32, device=device)
    if x.device != device:
        raise ValueError(f"warp_ncc kernel: {name} is on {x.device}, the "
                         f"images on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"warp_ncc kernel: {name} is {x.dtype}, not f32")
    if x.numel() != n or not x.is_contiguous():
        raise ValueError(f"warp_ncc kernel: {name} must be {n} contiguous "
                         f"values, got shape {tuple(x.shape)}")
    return x


def _check_images(img: torch.Tensor, ref: torch.Tensor) -> None:
    for name, t in (("img", img), ("ref", ref)):
        if t.device.type != "cuda":
            raise ValueError(f"warp_ncc kernel: {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"warp_ncc kernel: {name} is {t.dtype}, not f32")
        if not t.is_contiguous():
            raise ValueError(f"warp_ncc kernel: {name} is not contiguous")
    if ref.device != img.device:
        raise ValueError("warp_ncc kernel: img and ref on different devices")


def _launch(img, ref, angle, shift, tile: int, *, with_ncc: bool):
    """One launch of the warp kernel (and of the fold when ``with_ncc``):
    ``(warped, sums, [ncc, 1 - ncc] or None)``."""
    _cuda.refuse_autograd("warp_ncc kernel", img, ref, angle, shift)
    _check_shapes(img, ref, tile)
    _check_images(img, ref)
    dev = img.device
    angle = _param(angle, 1, "angle", dev)
    shift = _param(shift, 2, "shift", dev)
    fn, error_string = _launcher()
    h, w = img.shape
    n = h * w
    rows = (h // tile) * (w // tile)
    with torch.cuda.device(dev):
        # One allocation for the three outputs (host time is most of a
        # guess check).  h * w is a multiple of 256, so sums starts on a
        # 16-byte boundary, as the fold's 16-byte reads need.
        out = torch.empty((n + rows * 8 + 4,), dtype=torch.float32,
                          device=dev)
        warped = out[:n].view(h, w)
        sums = out[n:n + rows * 8].view(rows, 8)
        ncc = out[n + rows * 8:n + rows * 8 + 2] if with_ncc else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(angle.data_ptr(), shift.data_ptr(), img.data_ptr(),
                 ref.data_ptr(), warped.data_ptr(), sums.data_ptr(),
                 None if ncc is None else ncc.data_ptr(), h, w, tile, stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"warp_ncc kernel launch failed: {msg} ({err})")
    LAUNCHES.add()
    return warped, sums, ncc


def warp_ncc_sums_cuda(
    img: torch.Tensor, ref: torch.Tensor, angle, shift, *, tile: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: ``(warped, sums)``.  Raises on anything the
    kernel does not take (device, dtype, layout, tile divisibility; an
    ``angle`` or ``shift`` tensor that is not contiguous f32 on the images'
    device)."""
    warped, sums, _ = _launch(img, ref, angle, shift, tile, with_ncc=False)
    return warped, sums


def warp_ncc(
    img: torch.Tensor, ref: torch.Tensor, angle, shift, *, tile: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused warp+NCC: returns ``(warped image, ncc scalar)``.

    ``img`` (template T), ``ref`` (reference R): ``(H, W)`` with
    ``H, W % tile == 0``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel and its fold on the card.
    """
    if img.device.type == "cpu" and ref.device.type == "cpu":
        return warp_ncc_reference(img, ref, angle, shift, tile=tile)
    warped, _, ncc = _launch(img, ref, angle, shift, tile, with_ncc=True)
    return warped, ncc[0]


def ncc_distance(
    img: torch.Tensor, ref: torch.Tensor, angle, shift, *, tile: int = 32
) -> torch.Tensor:
    """``1 - NCC(ref, img o phi)`` as a 0-d tensor: on the card the kernel
    and its fold, two launches with nothing after them; on the CPU the
    plain version."""
    if img.device.type == "cpu" and ref.device.type == "cpu":
        return 1.0 - warp_ncc_reference(img, ref, angle, shift, tile=tile)[1]
    _, _, ncc = _launch(img, ref, angle, shift, tile, with_ncc=True)
    return ncc[1]


def ensure_built() -> float:
    """Build the kernel if this process has not; returns the seconds spent."""
    return _cuda.build([NAME])
