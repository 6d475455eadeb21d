"""The operators the scan kernels carry, and the rule that maps a callable
to one of them.

A CUDA kernel cannot call a Python operator, so the scan kernels
(``csrc/lookback_scan.cu``, ``csrc/tile_scan.cu``, ``csrc/fused_round.cu``)
are compiled once per entry of a small table (``csrc/scan_ops.cuh``):

  add            ``a + b`` lane by lane, float32 or bfloat16 rows of width
                 ``d <= 4`` (``torch.add``, ``operator.add``, or any
                 callable tagged ``kernel_op = "add"``);
  rigid_compose  rigid deformations packed as ``[angle, shift0, shift1]``
                 (``core/deformation.py:compose_batched``, tagged there):
                 ``angle = a0 + b0``, ``shift = R(b0) (a1, a2) + (b1, b2)``,
                 in ``op(earlier, later)`` order; float32;
  max            ``torch.maximum(a, b)`` lane by lane, NaN-propagating as
                 ``torch.maximum`` is, float32 or bfloat16 rows of width
                 ``d <= 4`` (``torch.maximum``, or any callable tagged
                 ``kernel_op = "max"``);
  matmul         ``m x m`` float32 matrices, ``m <= 4``, one leaf of shape
                 (n, m, m) packed row-major into rows of ``m * m`` lanes:
                 ``op(earlier, later) = later @ earlier`` (the reference's
                 ``jnp.matmul(b, a)``); only a callable tagged
                 ``kernel_op = "matmul"`` reaches it.

bfloat16 rows are read into float32 registers and every combine's result
is rounded to bfloat16 at once: the reference's Pallas kernels round there.
Its ``tile_local_scan`` (``lax.associative_scan`` of the op on the bf16
block) and ``fused_round`` (bf16 gathers, the op, a bf16 scatter), run with
``interpret=True`` on the CPU over the rows [256, 1, 1, ...], both give
256, 256, 256, 258, 260, ...: 256 + 1 rounds back to 256 and the next 1
is added to that, where one rounding per written row would give 256, 256,
258, 260.  The plain versions (the op on bf16 tensors) round the same way.
How a scan groups its combines differs between the kernels and the plain
versions, so bf16 results agree to the rounding of their groupings, not
bit for bit (integer-valued sums that bf16 holds exactly agree exactly).

The lookback kernel also takes a ``masked`` flag: one more lane carries the
``where=`` identity flag and the op is lifted as ``_tiling.lift_masked``
lifts it (so matmul rows reach 17 lanes).

This is a routing rule decided before any launch.  A CPU tensor always
takes the plain PyTorch version, which accepts any op.  On CUDA the
dispatcher only picks a kernel path for an op and data the table covers
(:func:`kernel_op_for`); a kernel wrapper asked to run anything else
raises :class:`KernelOpError` and names the table.  An untagged Python
lambda always raises there, whatever it computes: the kernel cannot call
it, and the table cannot know what it does.
"""

from __future__ import annotations

import operator
from typing import Any, Optional

import torch

from repro_torch.core._tree import tree_flatten

#: Entry name -> the code the C interface takes (``scan_ops.cuh``).
KERNEL_OPS = {"add": 0, "rigid_compose": 1, "max": 2, "matmul": 3}
#: Added to an entry's code for bfloat16 rows (``kStorageBf16``).
STORAGE_BF16 = 16
#: Widest row (operator lanes, not counting the mask flag) a lane-wise
#: entry takes.
MAX_WIDTH = 4
#: Row widths of the matmul entry: m * m for m = 1..4.
MATMUL_WIDTHS = (1, 4, 9, 16)
#: The storage types each entry takes.
DTYPES = {"add": (torch.float32, torch.bfloat16),
          "max": (torch.float32, torch.bfloat16),
          "rigid_compose": (torch.float32,),
          "matmul": (torch.float32,)}
TABLE = ("add (float32 or bfloat16, d <= 4), max (float32 or bfloat16, "
         "d <= 4), rigid_compose (float32 [angle, shift0, shift1], d = 3), "
         "matmul (float32 m x m matrices, m <= 4, tagged kernel_op='matmul'); "
         "the lookback kernel adds a where= flag lane")


class KernelOpError(ValueError):
    """A kernel was asked to run an op or a layout its table does not hold."""


class KernelDtypeError(KernelOpError, TypeError):
    """The rows are of a dtype no entry of the table takes."""


def kernel_op_of(op: Any) -> Optional[str]:
    """The table entry ``op`` maps to, or None."""
    if op is torch.add or op is operator.add:
        return "add"
    if op is torch.maximum:
        return "max"
    name = getattr(op, "kernel_op", None)
    return name if name in KERNEL_OPS else None


def op_code(name: str, dtype: torch.dtype) -> int:
    """The code the C interface takes for entry ``name`` on rows of
    ``dtype``."""
    return KERNEL_OPS[name] + (STORAGE_BF16 if dtype == torch.bfloat16 else 0)


def matrix_side(tail) -> Optional[int]:
    """m when ``tail`` is an (m, m) matrix with m <= 4, else None."""
    tail = tuple(tail)
    ok = len(tail) == 2 and tail[0] == tail[1] and 1 <= tail[0] <= 4
    return tail[0] if ok else None


def kernel_op_for(op: Any, xs: Any) -> Optional[str]:
    """The table entry that runs ``op`` over the array-domain tree ``xs``
    (leading axis n) in a kernel, or None: the op is in the table, every
    leaf is a tensor of one dtype the entry takes, and the packed row fits
    the entry."""
    name = kernel_op_of(op)
    if name is None:
        return None
    leaves, treedef = tree_flatten(xs)
    if not leaves or not all(
        isinstance(t, torch.Tensor) and t.dtype == leaves[0].dtype
        and t.dim() >= 1 for t in leaves
    ) or leaves[0].dtype not in DTYPES[name]:
        return None
    width = sum(int(torch.Size(t.shape[1:]).numel()) for t in leaves)
    if name == "rigid_compose":
        keys = treedef[1] if treedef is not None and treedef[0] == "dict" else None
        ok = (keys == ("angle", "shift")
              and tuple(leaves[0].shape[1:]) == ()
              and tuple(leaves[1].shape[1:]) == (2,))
        return name if ok else None
    if name == "matmul":
        ok = len(leaves) == 1 and matrix_side(leaves[0].shape[1:]) is not None
        return name if ok else None
    return name if width <= MAX_WIDTH else None


def check_kernel_row(op: Any, d: int, masked: bool = False,
                     dtype: Optional[torch.dtype] = None) -> str:
    """The entry of a packed op on ``(n, d)`` rows (``d`` counts the flag
    lane when ``masked``) of ``dtype`` (None: not checked); raises
    :class:`KernelOpError` when the kernels cannot run it, and its
    :class:`KernelDtypeError` (also a TypeError) for a dtype no entry
    takes."""
    if dtype is not None and not any(dtype in v for v in DTYPES.values()):
        raise KernelDtypeError(
            f"the scan kernels take float32 or bfloat16 rows, got {dtype}; "
            f"the scan kernels carry: {TABLE}"
        )
    name = kernel_op_of(op)
    if name is None:
        raise KernelOpError(
            f"no CUDA kernel form for op {op!r}; the scan kernels carry: "
            f"{TABLE}.  Tag the op with kernel_op=, or run it on CPU tensors "
            "or through another backend"
        )
    if dtype is not None and dtype not in DTYPES[name]:
        raise KernelOpError(
            f"{name} rows of {dtype} have no CUDA kernel form; the scan "
            f"kernels carry: {TABLE}"
        )
    width = d - (1 if masked else 0)
    if name == "matmul":
        if width not in MATMUL_WIDTHS:
            raise KernelOpError(
                f"matmul takes rows of m x m matrices (m <= 4), got width "
                f"{width}; the scan kernels carry: {TABLE}"
            )
        return name
    if name == "rigid_compose" and width != 3:
        raise KernelOpError(
            f"rigid_compose takes packed [angle, shift0, shift1] rows, got "
            f"width {width}; the scan kernels carry: {TABLE}"
        )
    if not 1 <= width <= MAX_WIDTH:
        raise KernelOpError(
            f"row width {width} is outside the kernels' 1..{MAX_WIDTH}; the "
            f"scan kernels carry: {TABLE}"
        )
    return name
