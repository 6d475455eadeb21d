"""Single-pass decoupled-lookback scan: the CUDA kernel and its plain version.

Port of ``repro/kernels/lookback_scan.py`` (LightScan, PAPERS.md).  Each
tile scans its rows locally, *publishes* its aggregate, then resolves its
exclusive prefix by walking backwards over its predecessors' published
state — stopping at the first predecessor that has already published an
inclusive prefix:

    status[i] ∈ {EMPTY, AGG, PREFIX}
    tile i: local scan → publish (agg, AGG)
            excl ← Σ_op backwards over j = i-1, i-2, … until status[j] ==
                   PREFIX (accumulate agg[j] for AGG tiles, fold pref[j]
                   and stop at a PREFIX tile)
            publish (excl ∘ agg, PREFIX); emit excl ∘ local

:func:`lookback_scan` takes its route from where ``x`` lies: on the CPU it
runs :func:`lookback_scan_reference`, the plain PyTorch version, which does
what the TPU kernel did, tile by tile in order (so every walk takes one
step); on a CUDA device it launches ``csrc/lookback_scan.cu`` (built at
first use), where the tiles run at once and the walk really accumulates
AGG aggregates, or raises.  :func:`lookback_resolve` is the pure-Python
twin of the walk, the oracle of both.

Seeding: an optional ``seed`` row is the exclusive prefix of tile 0 (the
incremental ``SeriesSession.extend`` path folds the retained running total
in here).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from repro_torch.analysis.invariants import (
    check_board_published,
    check_lookback_step,
)
from repro_torch.analysis.sync import invariants_enabled, sync_point

from . import _cuda
from .op_table import check_kernel_row, op_code

Op = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

NAME = "lookback_scan"
SOURCE = "src/repro_torch/kernels/csrc/lookback_scan.cu"
REPLACES = "src/repro/kernels/lookback_scan.py:93"
LAUNCHES = _cuda.launch_counter(NAME)

#: Tile-status protocol flags (published in program order).
FLAG_EMPTY = 0    # tile has published nothing yet
FLAG_AGG = 1      # tile aggregate available (no prefix yet)
FLAG_PREFIX = 2   # inclusive prefix available — lookback stops here


class LookbackProtocolError(RuntimeError):
    """A lookback read observed an unpublished (EMPTY) predecessor."""


def lookback_resolve(op, i: int, statuses, aggs, prefs):
    """Pure-Python twin of the kernel's lookback walk (for property tests).

    Resolves tile ``i``'s exclusive prefix from the published tile states.
    Returns ``(exclusive_prefix, steps)``; raises
    :class:`LookbackProtocolError` on an EMPTY predecessor (the protocol
    guarantees every predecessor has published at least its aggregate
    before tile ``i`` starts its walk).
    """
    if i <= 0:
        raise ValueError("tile 0 has no predecessors to resolve against")
    checking = invariants_enabled()
    acc = None
    steps = 0
    for j in range(i - 1, -1, -1):
        st = statuses[j]
        if checking:
            # Debug runs route every read through the shared invariant
            # module (same checks the schedule explorer asserts) before
            # the protocol error below.
            sync_point("lookback.read")
            check_lookback_step(i, j, int(st), stopped=(st == FLAG_PREFIX))
        if st == FLAG_EMPTY:
            raise LookbackProtocolError(
                f"tile {i} read EMPTY status at predecessor {j}"
            )
        v = prefs[j] if st == FLAG_PREFIX else aggs[j]
        acc = v if acc is None else op(v, acc)
        steps += 1
        if st == FLAG_PREFIX:
            return acc, steps
    raise LookbackProtocolError(
        f"tile {i} walked past tile 0 without finding a PREFIX"
    )


def doubling_scan(op: Op, x3: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of each tile of ``x3`` (t, k, d) along axis 1 by
    doubling (Hillis–Steele): log2(k) batched applications of ``op`` on
    (m, d) rows, ``op(earlier, later)``."""
    t, k, d = x3.shape
    y = x3
    off = 1
    while off < k:
        comb = op(y[:, : k - off].reshape(-1, d), y[:, off:].reshape(-1, d))
        y = torch.cat([y[:, :off], comb.reshape(t, k - off, d)], dim=1)
        off *= 2
    return y


def _check_args(x: torch.Tensor, num_tiles: int) -> Tuple[int, int, int]:
    if x.dim() != 2:
        raise ValueError(f"lookback_scan takes (n, d) rows, got {tuple(x.shape)}")
    n, d = x.shape
    t = int(num_tiles)
    if t < 1:
        raise ValueError(f"num_tiles must be >= 1, got {t}")
    k = n // t
    if k * t != n:
        raise ValueError(f"n={n} not divisible by num_tiles={t}")
    return t, k, d


def _check_board(status: torch.Tensor) -> None:
    if invariants_enabled():
        # Terminal board state (debug runs only — forces a device sync):
        # every tile must have published its inclusive PREFIX.
        sync_point("lookback.publish_prefix")
        check_board_published([int(s) for s in status[:, 0].tolist()])


def lookback_scan_reference(
    op: Op, x: torch.Tensor, num_tiles: int, *,
    seed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`lookback_scan`, on any device.

    The tiles' local scans run batched (:func:`doubling_scan`); then tile
    by tile in order: publish AGG, resolve through
    :func:`lookback_resolve`, publish PREFIX — the TPU's sequential grid.
    """
    t, k, d = _check_args(x, num_tiles)
    local = doubling_scan(op, x.reshape(t, k, d))
    agg_rows = local[:, k - 1]                                # (t, d)
    seed_row = None if seed is None else seed.to(x.dtype).reshape(1, d)
    statuses = [FLAG_EMPTY] * t
    aggs = [agg_rows[i : i + 1] for i in range(t)]
    prefs = [None] * t
    excls = []
    for i in range(t):
        statuses[i] = FLAG_AGG
        excl = seed_row if i == 0 else lookback_resolve(
            op, i, statuses, aggs, prefs)[0]
        prefs[i] = aggs[i] if excl is None else op(excl, aggs[i])
        statuses[i] = FLAG_PREFIX
        excls.append(excl)
    first = 0 if seed_row is not None else 1
    y = local
    if first < t:
        e = torch.cat(excls[first:], dim=0)                   # (m, d)
        rest = local[first:]
        applied = op(
            e[:, None].expand(rest.shape).reshape(-1, d), rest.reshape(-1, d)
        ).reshape(rest.shape)
        y = torch.cat([local[:first], applied], dim=0)
    status = torch.tensor(statuses, dtype=torch.int32,
                          device=x.device).reshape(t, 1)
    _check_board(status)
    return y.reshape(t * k, d), status, agg_rows, torch.cat(prefs, dim=0)


def _launcher():
    """The kernel library's launch and error-string entry points, typed."""
    lib = _cuda.load(NAME)
    fn = lib.lookback_scan_launch
    if fn.argtypes is None:  # argtypes last: it marks the entry as typed
        fn.restype = ctypes.c_int
        lib.lookback_scan_error_string.restype = ctypes.c_char_p
        lib.lookback_scan_error_string.argtypes = [ctypes.c_int]
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return fn, lib.lookback_scan_error_string


def lookback_scan_cuda(
    op: Op, x: torch.Tensor, num_tiles: int, *,
    seed: Optional[torch.Tensor] = None,
    walk_steps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on float32 or bfloat16 rows (``y`` in x's
    dtype; the board's aggregates and prefixes are float32).  Raises on
    anything it does not take: an op outside the kernel table
    (``op_table.py``), a width it does not hold, another device or dtype.  ``walk_steps``: an optional (t,) int32 tensor
    on the same device that receives each tile's lookback walk length
    (tiles > 0; how many predecessors the walk read), for tests and
    measurements of the protocol."""
    _cuda.refuse_autograd("lookback_scan kernel", x, seed)
    t, k, d = _check_args(x, num_tiles)
    masked = bool(getattr(op, "kernel_masked", False))
    name = check_kernel_row(op, d, masked, x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"lookback_scan kernel: x is on {x.device}")
    dev = x.device
    with torch.cuda.device(dev):
        xc = x.contiguous()
        seed_row = None
        if seed is not None:
            seed_row = seed.to(device=dev, dtype=x.dtype).reshape(d)
            seed_row = seed_row.contiguous()
        y = torch.empty((t * k, d), dtype=x.dtype, device=dev)
        # Column 0 is each tile's flag; for one-float rows the kernel
        # publishes the value beside it in column 1 (one 8-byte word).
        board = torch.zeros((t, 2), dtype=torch.int32, device=dev)
        status = board[:, :1]
        aggs = torch.empty((t, d), dtype=torch.float32, device=dev)
        prefs = torch.empty((t, d), dtype=torch.float32, device=dev)
        counter = torch.zeros((1,), dtype=torch.int32, device=dev)
        if walk_steps is not None and (
            walk_steps.shape != (t,) or walk_steps.dtype != torch.int32
            or walk_steps.device != dev or not walk_steps.is_contiguous()
        ):
            raise ValueError("walk_steps must be a contiguous (t,) int32 "
                             "tensor on x's device")
        fn, error_string = _launcher()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(op_code(name, x.dtype), d - int(masked), int(masked),
                 xc.data_ptr(),
                 seed_row.data_ptr() if seed_row is not None else None,
                 y.data_ptr(), board.data_ptr(), aggs.data_ptr(),
                 prefs.data_ptr(), counter.data_ptr(),
                 walk_steps.data_ptr() if walk_steps is not None else None,
                 t, k, stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"lookback_scan kernel launch failed: {msg} ({err})")
    LAUNCHES.add()
    _check_board(status)
    return y, status, aggs, prefs


def lookback_scan(
    op: Op, x: torch.Tensor, num_tiles: int, *,
    seed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-pass decoupled-lookback inclusive scan of ``x`` (n, d).

    ``op`` is batched over the leading axis (applied to (m, d) row blocks).
    ``n`` must divide into ``num_tiles`` (see ``_tiling.pad_rows``).
    ``seed``: optional (d,) or (1, d) exclusive prefix of the whole scan.

    Returns ``(y, status, aggs, prefs)``: the (n, d) inclusive scan plus
    the published per-tile protocol state ((t, 1) int32 statuses, (t, d)
    aggregates, (t, d) inclusive prefixes).  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if x.device.type == "cpu":
        return lookback_scan_reference(op, x, num_tiles, seed=seed)
    return lookback_scan_cuda(op, x, num_tiles, seed=seed)


def ensure_built() -> float:
    """Build the kernel if this process has not; returns the seconds spent."""
    return _cuda.build([NAME])
