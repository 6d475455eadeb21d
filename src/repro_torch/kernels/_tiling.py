"""Shared tiling helpers for the scan kernels.

Port of ``repro/kernels/_tiling.py``.  Both scan kernels (``tile_scan.py``'s
local–global–local tiles and ``lookback_scan.py``'s single-pass decoupled
lookback) need the same plumbing around the kernel proper:

* **round lowerings**: :func:`round_sources` (numpy) lowers a
  ``PlanRound``'s static gather/scatter index sets to the per-output-row
  operand table the ``fused_round`` kernel reads; :func:`build_round_matrices`
  keeps the reference's one-hot matrices, which the parity tests hand to the
  reference's kernel;
* **tile sizing and padding** (:func:`default_num_tiles`,
  :func:`default_num_tiles_cuda`, :func:`pad_rows`) — kernels want ``n``
  divisible by the tile count; the pad rows repeat the last element so a
  padded tail tile stays a valid scan segment (its aggregate is never
  consumed: only *earlier* tiles are read during lookback, and padded
  outputs are sliced off);
* **pytree packing** (:func:`pack_leaves` / :func:`unpack_leaves` /
  :func:`packed_op`) — the kernels operate on a single ``(n, D)`` tensor,
  so multi-leaf operands (``{"angle": (), "shift": (2,)}``) are flattened
  column-wise in sorted-key order, as the reference packs them, and the
  operator is wrapped to unpack → apply → repack (reshapes and concats
  only, exact in floating point);
* **identity-flag lifting** (:func:`lift_masked`) — ``where=`` masks ride
  along as one extra lane holding 1.0 for "this element is the operator
  identity"; the lifted operator is associative whenever the base operator
  is, and reproduces the engine's mask semantics.

A packed or lifted operator keeps the kernel-table entry of the operator it
wraps (``kernel_op``, plus ``kernel_masked`` after lifting), so a kernel
wrapper can route it (``op_table.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core._tree import tree_flatten, tree_unflatten

from .op_table import kernel_op_of

Op = Callable[[Any, Any], Any]

#: Rows of one tile on the card: one block of 256 threads, 16 rows each.
CUDA_TILE_ROWS = 256 * 16


def build_round_matrices(rnd, n: int):
    """One-hot gather/scatter matrices + keep mask for one PlanRound.

    Returns (ga, gb, sc, gm, sm, keep): combine gathers (m, n), combine
    scatter (n, m), move gather (q, n), move scatter (n, q), keep (n, 1).
    Combine/move groups are None when empty.
    """
    m = rnd.num_combines
    q = rnd.num_moves
    keep = np.ones((n, 1), dtype=np.float32)
    ga = gb = sc = gm = sm = None
    if m:
        ga = np.zeros((m, n), dtype=np.float32)
        gb = np.zeros((m, n), dtype=np.float32)
        sc = np.zeros((n, m), dtype=np.float32)
        for i, (a, b, out, _fan, _cs) in enumerate(rnd.combines):
            ga[i, a] = 1.0
            gb[i, b] = 1.0
            sc[out, i] = 1.0
            keep[out, 0] = 0.0
    if q:
        gm = np.zeros((q, n), dtype=np.float32)
        sm = np.zeros((n, q), dtype=np.float32)
        for i, (src, out, _fan) in enumerate(rnd.moves):
            gm[i, src] = 1.0
            sm[out, i] = 1.0
            keep[out, 0] = 0.0
    return ga, gb, sc, gm, sm, keep


def round_sources(rnd, n: int) -> Optional[np.ndarray]:
    """The operand table of one PlanRound for the ``fused_round`` kernel.

    Returns (n, 2) int32 ``(src_a, src_b)`` per output row ``r``: a
    combined row reads ``(a, b)`` (``out[r] = op(y[a], y[b])``), a moved
    row ``(src, -1)`` and a kept row ``(r, -1)``, so every output row is
    written exactly once.  None for a round with nothing to do.
    """
    m = rnd.num_combines
    if not m and not rnd.num_moves:
        return None
    out = rnd.upd_idx
    src = np.empty((n, 2), dtype=np.int32)
    src[:, 0] = np.arange(n, dtype=np.int32)
    src[:, 1] = -1
    src[out[:m], 0] = rnd.a_idx
    src[out[:m], 1] = rnd.b_idx
    src[out[m:], 0] = rnd.mv_src
    return src


# ---------------------------------------------------------------------------
# tile sizing + padding
# ---------------------------------------------------------------------------


def default_num_tiles(n: int) -> int:
    """Tile count for an n-element single-pass scan of CPU tensors.

    Small inputs run as one tile (the lookback machinery is pure overhead
    below ~2 tiles); large inputs cap at 16 tiles so the per-tile loop of
    the plain version stays short while each tile still holds enough rows
    to vectorize.
    """
    if n < 32:
        return 1
    return max(1, min(16, n // 16))


def default_num_tiles_cuda(n: int) -> int:
    """Tile count on the card: one block's rows (:data:`CUDA_TILE_ROWS`)
    per tile, so a large scan launches enough blocks to fill every SM."""
    return max(1, -(-n // CUDA_TILE_ROWS))


def pad_rows(x2: torch.Tensor, num_tiles: int) -> Tuple[torch.Tensor, int]:
    """Pad ``x2`` (n, d) so its row count divides ``num_tiles``.

    Pad rows repeat the last row: the padded tail is still a monotone scan
    segment, and its outputs/aggregate are sliced off / never read.
    Returns ``(padded, n)`` with the original row count.
    """
    n = x2.shape[0]
    k = -(-n // num_tiles)  # ceil
    m = k * num_tiles
    if m == n:
        return x2, n
    pad = x2[n - 1 : n].expand((m - n,) + tuple(x2.shape[1:]))
    return torch.cat([x2, pad], dim=0), n


# ---------------------------------------------------------------------------
# pytree <-> (n, D) packing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Layout of a pytree packed column-wise into one (n, D) tensor."""

    treedef: Any
    tails: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    widths: Tuple[int, ...]
    dtype: Any                       # common packed dtype

    @property
    def dim(self) -> int:
        return sum(self.widths)


def pack_leaves(xs) -> Tuple[torch.Tensor, PackSpec]:
    """Flatten a pytree of (n, *tail) tensors into one (n, D) tensor."""
    leaves, treedef = tree_flatten(xs)
    if not leaves:
        raise ValueError("cannot pack an empty pytree")
    leaves = [torch.as_tensor(t) for t in leaves]
    n = leaves[0].shape[0]
    tails = tuple(tuple(t.shape[1:]) for t in leaves)
    dtypes = tuple(t.dtype for t in leaves)
    widths = tuple(int(np.prod(tl)) if tl else 1 for tl in tails)
    common = dtypes[0]
    for dt in dtypes[1:]:
        common = torch.promote_types(common, dt)
    spec = PackSpec(treedef, tails, dtypes, widths, common)
    cols = [t.reshape(n, w).to(common) for t, w in zip(leaves, widths)]
    return (cols[0] if len(cols) == 1 and widths[0] == spec.dim
            else torch.cat(cols, dim=1)), spec


def unpack_leaves(y2: torch.Tensor, spec: PackSpec):
    """Inverse of :func:`pack_leaves` for a (n, D) tensor."""
    n = y2.shape[0]
    leaves = []
    off = 0
    for tail, dt, w in zip(spec.tails, spec.dtypes, spec.widths):
        col = y2[:, off : off + w]
        leaves.append(col.reshape((n,) + tail).to(dt))
        off += w
    return tree_unflatten(spec.treedef, leaves)


def pack_element(x, spec: PackSpec) -> torch.Tensor:
    """Pack a single element (pytree of ``tail``-shaped leaves) to (D,)."""
    leaves, _ = tree_flatten(x)
    cols = [
        torch.as_tensor(t).reshape(w).to(spec.dtype)
        for t, w in zip(leaves, spec.widths)
    ]
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=0)


def packed_op(op: Op, spec: PackSpec) -> Op:
    """Lift ``op`` (pytree-batched) to act on packed (m, D) rows.

    Unpack → apply → repack is reshapes and concats only, so the packed
    operator is bit-identical to the original and stays associative.  It
    keeps ``op``'s kernel-table entry when the packed layout is the one
    that entry reads (``rigid_compose``: the ``{"angle", "shift"}`` dict).
    """

    def pop(a2, b2):
        y = op(unpack_leaves(a2, spec), unpack_leaves(b2, spec))
        leaves, _ = tree_flatten(y)
        m = a2.shape[0]
        cols = [
            t.reshape(m, w).to(spec.dtype)
            for t, w in zip(leaves, spec.widths)
        ]
        return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)

    name = kernel_op_of(op)
    if name == "rigid_compose" and not (
        spec.treedef is not None and spec.treedef[0] == "dict"
        and spec.treedef[1] == ("angle", "shift") and spec.widths == (1, 2)
    ):
        name = None
    pop.kernel_op = name
    return pop


# ---------------------------------------------------------------------------
# where-mask support: identity-flag lane
# ---------------------------------------------------------------------------


def add_flag_lane(x2: torch.Tensor, where: Optional[Sequence[bool]]):
    """Append one lane: 1.0 = "this row is the operator identity".

    ``where`` follows the engine convention (True = valid); None marks
    every row valid (used for seed rows, which always participate).  A bool
    tensor is taken as it is (no Python loop over a long mask).
    """
    n = x2.shape[0]
    if where is None:
        flags = torch.zeros((n, 1), dtype=x2.dtype, device=x2.device)
    else:
        if isinstance(where, torch.Tensor):
            valid = where.to(device=x2.device, dtype=torch.bool)
        else:
            valid = torch.as_tensor([bool(v) for v in where],
                                    dtype=torch.bool, device=x2.device)
        flags = (~valid).to(x2.dtype).reshape(n, 1)
    return torch.cat([x2, flags], dim=1)


def lift_masked(pop: Op) -> Op:
    """Lift a packed operator to the "optional monoid" over flagged rows.

    An identity-flagged operand passes the other operand through; the
    result is flagged identity only when both operands are.  Associative
    whenever ``pop`` is, and matches the plan-lowering ``where`` semantics
    (identity combines compile to moves there; here they select).
    """

    def lifted(a, b):
        va, fa = a[:, :-1], a[:, -1:]
        vb, fb = b[:, :-1], b[:, -1:]
        v = pop(va, vb)
        v = torch.where(fa == 1.0, vb, torch.where(fb == 1.0, va, v))
        return torch.cat([v, fa * fb], dim=1)

    lifted.kernel_op = kernel_op_of(pop)
    lifted.kernel_masked = True
    return lifted
