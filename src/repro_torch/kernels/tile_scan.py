"""The local phases of the local–global–local scan: CUDA kernels and their
plain versions.

Port of ``repro/kernels/tile_scan.py:tile_local_scan`` and ``:tile_apply``
(the paper's §4.1 decomposition with each local phase one launch):

* :func:`tile_local_scan` — per-tile inclusive scans plus the tile totals
  for the global phase;
* :func:`tile_apply` — folds each tile's exclusive global prefix into its
  local scan with one batched operator application; tile 0 passes through.

The small global phase over the tile totals runs outside (the engine's
vector executor on the plan).  Each function takes its route from where its
tensors lie: CPU tensors run the plain PyTorch version; CUDA tensors launch
``csrc/tile_scan.cu`` (built at first use) or raise.  The fused round kernel
of the same reference module belongs to a later slice (``ROADMAP.md``).
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, Tuple

import torch

from . import _cuda
from ._tiling import CUDA_TILE_ROWS
from .lookback_scan import doubling_scan
from .op_table import KERNEL_OPS, check_kernel_row

Op = Callable[[Any, Any], Any]

LIBRARY = "tile_scan"
SOURCE = "src/repro_torch/kernels/csrc/tile_scan.cu"
LOCAL_NAME = "tile_local_scan"
APPLY_NAME = "tile_apply"
LOCAL_REPLACES = "src/repro/kernels/tile_scan.py:126"
APPLY_REPLACES = "src/repro/kernels/tile_scan.py:165"
LOCAL_LAUNCHES = _cuda.launch_counter(LOCAL_NAME)
APPLY_LAUNCHES = _cuda.launch_counter(APPLY_NAME)


def _split(x: torch.Tensor, num_tiles: int) -> Tuple[int, int, int]:
    if x.dim() != 2:
        raise ValueError(f"tile_local_scan takes (n, d) rows, got {tuple(x.shape)}")
    n, d = x.shape
    t = int(num_tiles)
    k = n // t if t >= 1 else 0
    if t < 1 or k * t != n:
        raise ValueError(f"n={n} not divisible by num_tiles={t}")
    return t, k, d


def tile_local_scan_reference(
    op: Op, x: torch.Tensor, num_tiles: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`tile_local_scan`."""
    t, k, d = _split(x, num_tiles)
    local = doubling_scan(op, x.reshape(t, k, d))
    return local, local[:, k - 1]


def tile_apply_reference(
    op: Op, local: torch.Tensor, seeds: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of :func:`tile_apply`."""
    t, k, d = local.shape
    rest = local[1:]
    applied = op(
        seeds[1:, None].expand(rest.shape).reshape(-1, d), rest.reshape(-1, d)
    ).reshape(rest.shape)
    return torch.cat([local[:1], applied], dim=0).reshape(t * k, d)


def _entries():
    """The library's two launch entry points and its error string, typed."""
    lib = _cuda.load(LIBRARY)
    loc, app = lib.tile_local_scan_launch, lib.tile_apply_launch
    if app.argtypes is None:  # argtypes last: it marks the entries as typed
        for fn in (loc, app):
            fn.restype = ctypes.c_int
        lib.tile_scan_error_string.restype = ctypes.c_char_p
        lib.tile_scan_error_string.argtypes = [ctypes.c_int]
        loc.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        app.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return loc, app, lib.tile_scan_error_string


def _check_tensor(what: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: tensor is {t.dtype}, not f32")


def _raise_on(err: int, what: str, error_string) -> None:
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def tile_local_scan_cuda(
    op: Op, x: torch.Tensor, num_tiles: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the ``tile_local_scan`` kernel; raises on anything it does
    not take (op outside the table, width, device, dtype).  Each tile is
    cut into chunks of at most ``CUDA_TILE_ROWS`` rows, one block a chunk,
    chained within the tile; the chunk board is scratch allocated here."""
    t, k, d = _split(x, num_tiles)
    name = check_kernel_row(op, d)
    _check_tensor("tile_local_scan kernel", x)
    chunk_rows = min(k, CUDA_TILE_ROWS)
    chunks = -(-k // chunk_rows)
    dev = x.device
    with torch.cuda.device(dev):
        xc = x.contiguous()
        local = torch.empty((t, k, d), dtype=torch.float32, device=dev)
        partials = torch.empty((t, d), dtype=torch.float32, device=dev)
        status = torch.zeros((t * chunks,), dtype=torch.int32, device=dev)
        aggs = torch.empty((t * chunks, d), dtype=torch.float32, device=dev)
        prefs = torch.empty((t * chunks, d), dtype=torch.float32, device=dev)
        counter = torch.zeros((1,), dtype=torch.int32, device=dev)
        loc, _app, error_string = _entries()
        err = loc(KERNEL_OPS[name], d, xc.data_ptr(), local.data_ptr(),
                  partials.data_ptr(), status.data_ptr(), aggs.data_ptr(),
                  prefs.data_ptr(), counter.data_ptr(), t, k, chunk_rows,
                  chunks, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, LOCAL_NAME, error_string)
    LOCAL_LAUNCHES.add()
    return local, partials


def tile_apply_cuda(
    op: Op, local: torch.Tensor, seeds: torch.Tensor
) -> torch.Tensor:
    """Launch the ``tile_apply`` kernel; raises on anything it does not
    take."""
    if local.dim() != 3 or seeds.shape != (local.shape[0], local.shape[2]):
        raise ValueError(
            f"tile_apply takes local (T, K, d) and seeds (T, d), got "
            f"{tuple(local.shape)} and {tuple(seeds.shape)}"
        )
    t, k, d = local.shape
    name = check_kernel_row(op, d)
    _check_tensor("tile_apply kernel", local)
    _check_tensor("tile_apply kernel", seeds)
    if seeds.device != local.device:
        raise ValueError("tile_apply kernel: local and seeds on different devices")
    dev = local.device
    with torch.cuda.device(dev):
        lc, sc = local.contiguous(), seeds.contiguous()
        out = torch.empty((t * k, d), dtype=torch.float32, device=dev)
        _loc, app, error_string = _entries()
        err = app(KERNEL_OPS[name], d, lc.data_ptr(), sc.data_ptr(),
                  out.data_ptr(), t, k,
                  torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, APPLY_NAME, error_string)
    APPLY_LAUNCHES.add()
    return out


def tile_local_scan(
    op: Op, x: torch.Tensor, num_tiles: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile inclusive scans and tile totals.

    ``x``: (n, d) with n divisible by ``num_tiles``.  Returns
    ``(local, partials)``: (T, K, d) per-tile inclusive scans and (T, d)
    tile totals for the global phase.  CPU tensors take the plain version;
    CUDA tensors launch the kernel.
    """
    if x.device.type == "cpu":
        return tile_local_scan_reference(op, x, num_tiles)
    return tile_local_scan_cuda(op, x, num_tiles)


def tile_apply(op: Op, local: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Fold each tile's exclusive global prefix into its local scan.

    ``local``: (T, K, d); ``seeds``: (T, d) where seeds[i] is the inclusive
    global scan of tiles < i (seeds[0] is ignored — tile 0 passes through).
    Returns the flat (T*K, d) inclusive scan.  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if local.device.type == "cpu" and seeds.device.type == "cpu":
        return tile_apply_reference(op, local, seeds)
    return tile_apply_cuda(op, local, seeds)


def ensure_built() -> float:
    """Build the kernels if this process has not; returns the seconds spent."""
    return _cuda.build([LIBRARY])
