"""Fused rigid-warp + NCC partial sums: the CUDA kernel and its plain version.

Port of ``repro/kernels/warp_ncc.py``.  The registration operator's guess
check evaluates D(R, T o phi) = 1 - NCC(R, T o phi); this kernel computes the
warped template and the per-tile NCC partial sums in one pass over output
tiles (``csrc/warp_ncc.cu``), and the host folds the ``(n_tiles, 8)`` sums
into the NCC scalar with a few tensor operations on the same device.

:func:`warp_ncc` takes its route from where the tensors lie: on the CPU it
runs :func:`warp_ncc_reference`, the plain PyTorch version of the same
function; on a CUDA device it launches the kernel (building it at first use)
or raises.  There is no fallback from the card to the plain version.
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn, lib.warp_ncc_error_string


def warp_ncc_sums_cuda(
    img: torch.Tensor, ref: torch.Tensor, angle, shift, *, tile: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: ``(warped, sums)``.  Raises on anything the
    kernel does not take (device, dtype, layout, tile divisibility)."""
    _check_shapes(img, ref, tile)
    for name, t in (("img", img), ("ref", ref)):
        if t.device.type != "cuda":
            raise ValueError(f"warp_ncc kernel: {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"warp_ncc kernel: {name} is {t.dtype}, not f32")
        if not t.is_contiguous():
            raise ValueError(f"warp_ncc kernel: {name} is not contiguous")
    if ref.device != img.device:
        raise ValueError("warp_ncc kernel: img and ref on different devices")
    fn, error_string = _launcher()
    h, w = img.shape
    with torch.cuda.device(img.device):
        params = _params(angle, shift, img.device)
        warped = torch.empty((h, w), dtype=torch.float32, device=img.device)
        sums = torch.empty(((h // tile) * (w // tile), 8),
                           dtype=torch.float32, device=img.device)
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(params.data_ptr(), img.data_ptr(), ref.data_ptr(),
                 warped.data_ptr(), sums.data_ptr(), h, w, tile, stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"warp_ncc kernel launch failed: {msg} ({err})")
    LAUNCHES.add()
    return warped, sums


def warp_ncc(
    img: torch.Tensor, ref: torch.Tensor, angle, shift, *, tile: int = 32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused warp+NCC: returns ``(warped image, ncc scalar)``.

    ``img`` (template T), ``ref`` (reference R): ``(H, W)`` with
    ``H, W % tile == 0``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel.
    """
    if img.device.type == "cpu" and ref.device.type == "cpu":
        return warp_ncc_reference(img, ref, angle, shift, tile=tile)
    warped, sums = warp_ncc_sums_cuda(img, ref, angle, shift, tile=tile)
    return warped, fold(sums)


def ensure_built() -> float:
    """Build the kernel if this process has not; returns the seconds spent."""
    return _cuda.build([NAME])
