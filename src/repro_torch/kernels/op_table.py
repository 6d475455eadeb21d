"""The operators the scan kernels carry, and the rule that maps a callable
to one of them.

A CUDA kernel cannot call a Python operator, so the scan kernels
(``csrc/lookback_scan.cu``, ``csrc/tile_scan.cu``) are compiled once per
entry of a small table (``csrc/scan_ops.cuh``):

  add            ``a + b`` lane by lane, float32 rows of width ``d <= 4``
                 (``torch.add``, ``operator.add``, or any callable tagged
                 ``kernel_op = "add"``);
  rigid_compose  rigid deformations packed as ``[angle, shift0, shift1]``
                 (``core/deformation.py:compose_batched``, tagged there):
                 ``angle = a0 + b0``, ``shift = R(b0) (a1, a2) + (b1, b2)``,
                 in ``op(earlier, later)`` order.

The lookback kernel also takes a ``masked`` flag: one more lane carries the
``where=`` identity flag and the op is lifted as ``_tiling.lift_masked``
lifts it.

This is a routing rule decided before any launch.  A CPU tensor always
takes the plain PyTorch version, which accepts any op.  On CUDA the
dispatcher only picks a kernel path for an op and data the table covers
(:func:`kernel_op_for`); a kernel wrapper asked to run anything else
raises :class:`KernelOpError` and names the table.
"""

from __future__ import annotations

import operator
from typing import Any, Optional

import torch

from repro_torch.core._tree import tree_flatten

#: Entry name -> the code the C interface takes (``scan_ops.cuh``).
KERNEL_OPS = {"add": 0, "rigid_compose": 1}
#: Widest row (operator lanes, not counting the mask flag) a kernel takes.
MAX_WIDTH = 4
TABLE = ("add (float32, d <= 4), rigid_compose (float32 [angle, shift0, "
         "shift1], d = 3); the lookback kernel adds a where= flag lane")


class KernelOpError(ValueError):
    """A kernel was asked to run an op or a layout its table does not hold."""


def kernel_op_of(op: Any) -> Optional[str]:
    """The table entry ``op`` maps to, or None."""
    if op is torch.add or op is operator.add:
        return "add"
    name = getattr(op, "kernel_op", None)
    return name if name in KERNEL_OPS else None


def kernel_op_for(op: Any, xs: Any) -> Optional[str]:
    """The table entry that runs ``op`` over the array-domain tree ``xs``
    (leading axis n) in a kernel, or None: the op is in the table, every
    leaf is a float32 tensor, and the packed row fits the entry."""
    name = kernel_op_of(op)
    if name is None:
        return None
    leaves, treedef = tree_flatten(xs)
    if not leaves or not all(
        isinstance(t, torch.Tensor) and t.dtype == torch.float32
        and t.dim() >= 1 for t in leaves
    ):
        return None
    width = sum(int(torch.Size(t.shape[1:]).numel()) for t in leaves)
    if name == "rigid_compose":
        keys = treedef[1] if treedef is not None and treedef[0] == "dict" else None
        ok = (keys == ("angle", "shift")
              and tuple(leaves[0].shape[1:]) == ()
              and tuple(leaves[1].shape[1:]) == (2,))
        return name if ok else None
    return name if width <= MAX_WIDTH else None


def check_kernel_row(op: Any, d: int, masked: bool = False) -> str:
    """The entry of a packed op on ``(n, d)`` rows (``d`` counts the flag
    lane when ``masked``); raises :class:`KernelOpError` when the kernels
    cannot run it."""
    name = kernel_op_of(op)
    if name is None:
        raise KernelOpError(
            f"no CUDA kernel form for op {op!r}; the scan kernels carry: "
            f"{TABLE}.  Tag the op with kernel_op=, or run it on CPU tensors "
            "or through another backend"
        )
    width = d - (1 if masked else 0)
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
