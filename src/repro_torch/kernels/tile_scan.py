"""The engine's tile-scan kernels: CUDA kernels and their plain versions.

Port of ``repro/kernels/tile_scan.py``, whose three Pallas kernels carry
the ``pallas`` backend (``core/engine/pallas_backend.py``) and the
hierarchical array paths:

* :func:`fused_round` — one round of a compiled plan, ``out[r] =
  op(y[a], y[b])`` for combined rows and ``y[src]`` for the rest, read by
  index from the round's operand table (``_tiling.round_sources``; the
  reference multiplies one-hot matrices instead);
* :func:`fused_plan` — every round of a plan in one launch, the buffer
  resident in the shared memory of one thread-block cluster, reading the
  plan's compact operand list (``_tiling.plan_operands``): what the
  reference's chain of ``fused_round`` calls computes, with the plan's
  captured total;
* :func:`tile_local_scan` — per-tile inclusive scans plus the tile totals
  for the global phase of the paper's §4.1 local–global–local scan;
* :func:`tile_apply` — folds each tile's exclusive global prefix into its
  local scan with one batched operator application; tile 0 passes through.

The small global phase over the tile totals runs outside (the engine's
vector executor on the plan).  Each function takes its route from where its
tensors lie: CPU tensors run the plain PyTorch version; CUDA tensors launch
``csrc/fused_round.cu`` (``fused_round`` and ``fused_plan``) or
``csrc/tile_scan.cu`` (built at first use) or raise.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, Optional, Tuple

import torch

from . import _cuda
from ._tiling import CUDA_TILE_ROWS, PlanOperands, plan_stride
from .lookback_scan import doubling_scan
from .op_table import check_kernel_row, op_code

Op = Callable[[Any, Any], Any]

LIBRARY = "tile_scan"
SOURCE = "src/repro_torch/kernels/csrc/tile_scan.cu"
FUSED_NAME = "fused_round"
FUSED_SOURCE = "src/repro_torch/kernels/csrc/fused_round.cu"
FUSED_REPLACES = "src/repro/kernels/tile_scan.py:50"
FUSED_LAUNCHES = _cuda.launch_counter(FUSED_NAME)
PLAN_NAME = "fused_plan"
PLAN_LAUNCHES = _cuda.launch_counter(PLAN_NAME)
LOCAL_NAME = "tile_local_scan"
APPLY_NAME = "tile_apply"
LOCAL_REPLACES = "src/repro/kernels/tile_scan.py:126"
APPLY_REPLACES = "src/repro/kernels/tile_scan.py:165"
LOCAL_LAUNCHES = _cuda.launch_counter(LOCAL_NAME)
APPLY_LAUNCHES = _cuda.launch_counter(APPLY_NAME)


def _round_args(y: torch.Tensor, src: torch.Tensor) -> Tuple[int, int]:
    if y.dim() != 2 or src.shape != (y.shape[0], 2):
        raise ValueError(
            f"fused_round takes y (n, d) and src (n, 2), got {tuple(y.shape)} "
            f"and {tuple(src.shape)}"
        )
    return y.shape[0], y.shape[1]


def fused_round_reference(op: Op, y: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_round`, for any op and float
    dtype: an index gather, one ``op`` call on the combined rows, an index
    scatter."""
    _round_args(y, src)
    a = src[:, 0].long()
    b = src[:, 1].long()
    out = y[a]
    rows = torch.nonzero(b >= 0).squeeze(1)
    if rows.numel():
        out = out.index_copy(0, rows, op(y[a[rows]], y[b[rows]]))
    return out


def fused_round_cuda(op: Op, y: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Launch the ``fused_round`` kernel into a new buffer (all reads of the
    round happen before any write); raises on anything it does not take."""
    _cuda.refuse_autograd("fused_round kernel", y)
    n, d = _round_args(y, src)
    name = check_kernel_row(op, d, dtype=y.dtype)
    _check_tensor("fused_round kernel", y)
    if src.device != y.device or src.dtype != torch.int32:
        raise ValueError("fused_round kernel: src must be int32 on y's device")
    dev = y.device
    with torch.cuda.device(dev):
        yc, sc = y.contiguous(), src.contiguous()
        if sc.data_ptr() % 8:
            sc = sc.clone()
        out = torch.empty_like(yc)
        fn, _plan, error_string = _fused_entries()
        err = fn(op_code(name, y.dtype), d, yc.data_ptr(), sc.data_ptr(),
                 out.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, FUSED_NAME, error_string)
    FUSED_LAUNCHES.add()
    return out


def fused_round(op: Op, y: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """One plan round: ``out[r] = op(y[src[r, 0]], y[src[r, 1]])`` where
    ``src[r, 1] >= 0``, else ``y[src[r, 0]]``.

    ``y``: (n, d); ``src``: the round's (n, 2) int32 operand table
    (``_tiling.round_sources``) on ``y``'s device.  Returns a new (n, d)
    tensor.  CPU tensors take the plain version; CUDA tensors launch the
    kernel.
    """
    if y.device.type == "cpu":
        return fused_round_reference(op, y, src)
    return fused_round_cuda(op, y, src)


def _fused_entries():
    """The fused_round library's two launch entries (``fused_round``,
    ``fused_plan``) and its error string, typed."""
    lib = _cuda.load(FUSED_NAME)
    rnd, plan = lib.fused_round_launch, lib.fused_plan_launch
    if plan.argtypes is None:  # argtypes last: it marks the entries as typed
        for fn in (rnd, plan):
            fn.restype = ctypes.c_int
        lib.fused_round_error_string.restype = ctypes.c_char_p
        lib.fused_round_error_string.argtypes = [ctypes.c_int]
        rnd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                        + [ctypes.c_int, ctypes.c_void_p])
        plan.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return rnd, plan, lib.fused_round_error_string


def _plan_args(y: torch.Tensor, plan_ops: PlanOperands) -> Tuple[int, int]:
    if y.dim() != 2 or y.shape[0] != plan_ops.n:
        raise ValueError(
            f"fused_plan takes y ({plan_ops.n}, d) for its plan, got "
            f"{tuple(y.shape)}"
        )
    return y.shape[0], y.shape[1]


def fused_plan_reference(
    op: Op, y: torch.Tensor, plan_ops: PlanOperands
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`fused_plan`, for any op and float
    dtype: the chain of :func:`fused_round_reference` over the plan's
    rounds, each round's table expanded from its triples, and the row
    captured before its round (None when the plan captures none)."""
    n, _ = _plan_args(y, plan_ops)
    total = None
    rows = torch.arange(n, device=y.device)
    for k in range(plan_ops.rounds):
        if k == plan_ops.capture_round:
            total = y[plan_ops.capture_wire].clone()
        t = plan_ops.round_ops(k).to(y.device).long()
        src = torch.stack([rows, torch.full_like(rows, -1)], dim=1)
        src[t[:, 0]] = t[:, 1:]
        y = fused_round_reference(op, y, src)
    if plan_ops.capture_round == plan_ops.rounds:
        total = y[plan_ops.capture_wire].clone()
    return y, total


def fused_plan_cuda(
    op: Op, y: torch.Tensor, plan_ops: PlanOperands
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the ``fused_plan`` kernel on one cluster of
    ``plan_ops.cluster`` CTAs; raises on anything it does not take, and
    when the card refuses the cluster (its shared memory, its size, or no
    room for it): nothing runs in its place."""
    _cuda.refuse_autograd("fused_plan kernel", y)
    n, d = _plan_args(y, plan_ops)
    name = check_kernel_row(op, d, dtype=y.dtype)
    _check_tensor("fused_plan kernel", y)
    if plan_ops.ops.device != y.device:
        raise ValueError("fused_plan kernel: the operand list must be on "
                         "y's device (PlanOperands.to)")
    dev = y.device
    c = plan_ops.cluster
    with torch.cuda.device(dev):
        yc = y.contiguous()
        out = torch.empty_like(yc)
        total = (torch.empty((d,), dtype=y.dtype, device=dev)
                 if plan_ops.capture_round >= 0 else None)
        _round, fn, error_string = _fused_entries()
        err = fn(op_code(name, y.dtype), d, yc.data_ptr(),
                 plan_ops.ops.data_ptr(),
                 plan_ops.offsets.data_ptr(), plan_ops.flags.data_ptr(),
                 out.data_ptr(),
                 None if total is None else total.data_ptr(), n,
                 plan_ops.rows_per, plan_stride(n, d, c), plan_ops.rounds,
                 plan_ops.capture_round, plan_ops.capture_wire, c,
                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, PLAN_NAME, error_string)
    PLAN_LAUNCHES.add()
    return out, total


def fused_plan(
    op: Op, y: torch.Tensor, plan_ops: PlanOperands
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Every round of a plan: what :func:`fused_round` over each round's
    table computes, in one launch.

    ``y``: (n, d); ``plan_ops``: the plan's operand list
    (``_tiling.plan_operands``) on ``y``'s device.  Returns ``(out,
    total)``: a new (n, d) tensor and the (d,) row the plan captures before
    its capture round (None when it captures none).  CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    if y.device.type == "cpu":
        return fused_plan_reference(op, y, plan_ops)
    return fused_plan_cuda(op, y, plan_ops)


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
    _cuda.refuse_autograd("tile_local_scan kernel", x)
    t, k, d = _split(x, num_tiles)
    name = check_kernel_row(op, d, dtype=x.dtype)
    _check_tensor("tile_local_scan kernel", x)
    chunk_rows = min(k, CUDA_TILE_ROWS)
    chunks = -(-k // chunk_rows)
    dev = x.device
    with torch.cuda.device(dev):
        xc = x.contiguous()
        local = torch.empty((t, k, d), dtype=x.dtype, device=dev)
        partials = torch.empty((t, d), dtype=x.dtype, device=dev)
        status = torch.zeros((t * chunks, 2), dtype=torch.int32, device=dev)
        aggs = torch.empty((t * chunks, d), dtype=torch.float32, device=dev)
        prefs = torch.empty((t * chunks, d), dtype=torch.float32, device=dev)
        counter = torch.zeros((1,), dtype=torch.int32, device=dev)
        loc, _app, error_string = _entries()
        err = loc(op_code(name, x.dtype), d, xc.data_ptr(), local.data_ptr(),
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
    _cuda.refuse_autograd("tile_apply kernel", local, seeds)
    if local.dim() != 3 or seeds.shape != (local.shape[0], local.shape[2]):
        raise ValueError(
            f"tile_apply takes local (T, K, d) and seeds (T, d), got "
            f"{tuple(local.shape)} and {tuple(seeds.shape)}"
        )
    t, k, d = local.shape
    name = check_kernel_row(op, d, dtype=local.dtype)
    _check_tensor("tile_apply kernel", local)
    _check_tensor("tile_apply kernel", seeds)
    if seeds.device != local.device or seeds.dtype != local.dtype:
        raise ValueError("tile_apply kernel: local and seeds on different "
                         "devices or of different dtypes")
    dev = local.device
    with torch.cuda.device(dev):
        lc, sc = local.contiguous(), seeds.contiguous()
        if lc.data_ptr() % 16:   # the kernel streams 16-byte words
            lc = lc.clone()
        out = torch.empty((t * k, d), dtype=local.dtype, device=dev)
        _loc, app, error_string = _entries()
        err = app(op_code(name, local.dtype), d, lc.data_ptr(), sc.data_ptr(),
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
    return _cuda.build([LIBRARY, FUSED_NAME])
