"""Shared tiling helpers for the scan kernels.

Port of ``repro/kernels/_tiling.py``.  Both scan kernels (``tile_scan.py``'s
local–global–local tiles and ``lookback_scan.py``'s single-pass decoupled
lookback) need the same plumbing around the kernel proper:

* **round lowerings**: :func:`round_sources` (numpy) lowers a
  ``PlanRound``'s static gather/scatter index sets to the per-output-row
  operand table the ``fused_round`` kernel reads; :func:`plan_operands`
  lowers a whole plan to the compact operand list the ``fused_plan`` kernel
  reads, grouped for a cluster of :func:`plan_cluster_size` CTAs (the
  size rule);
  :func:`build_round_matrices` keeps the reference's one-hot matrices, which
  the parity tests hand to the reference's kernel;
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

from .op_table import kernel_op_of, matrix_side

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
# a whole plan on one thread-block cluster (fused_plan)
# ---------------------------------------------------------------------------

#: Shared memory one CTA may hold on sm_90 (the card's opt-in limit,
#: ``cudaDevAttrMaxSharedMemoryPerBlockOptin``, 227 KB).
PLAN_SMEM_BYTES = 232_448
#: The largest cluster Hopper schedules (non-portable above 8).
PLAN_MAX_CLUSTER = 16
#: Floats of the plan buffer a CTA holds before the size rule adds CTAs:
#: two a thread of its 1,024.
PLAN_FLOATS_PER_CTA = 2048
#: Round flags of a plan's operand list (``PlanOperands.flags``; the same
#: bits in ``csrc/fused_round.cu``).
PLAN_CLUSTER_BARRIER = 1
PLAN_LOCAL_READS = 2
#: Set on a triple's ``dst`` when the next live round writes that row too,
#: so the kernel's copy forward skips it (``PlanOperands.ops``).
PLAN_REWRITTEN = 1 << 30


def plan_rows_per(n: int, cluster: int) -> int:
    """Rows each CTA of a ``cluster``-CTA plan owns: ceil(n / cluster),
    rounded up to a multiple of 4 so that every CTA's slice of an (n, d)
    float32 buffer starts on 16 bytes."""
    return 4 * -(-(-(-n // cluster)) // 4)


def plan_stride(n: int, d: int, cluster: int) -> int:
    """Floats of one CTA slice (one of its two buffers), a multiple of 4."""
    return 4 * -(-(plan_rows_per(n, cluster) * d) // 4)


def plan_smem_bytes(n: int, d: int, cluster: int) -> int:
    """Shared memory a CTA needs to hold its slice of the buffer twice."""
    return 2 * 4 * plan_stride(n, d, cluster)


def plan_min_cluster(n: int, d: int) -> Optional[int]:
    """The smallest power-of-two cluster, at most :data:`PLAN_MAX_CLUSTER`,
    whose CTAs hold an (n, d) float32 plan buffer twice in their shared
    memory; None when none does."""
    c = 1
    while c <= PLAN_MAX_CLUSTER:
        if plan_smem_bytes(n, d, c) <= PLAN_SMEM_BYTES:
            return c
        c *= 2
    return None


def plan_cluster_size(n: int, d: int) -> Optional[int]:
    """The cluster a plan over (n, d) rows runs on: from the smallest that
    holds its buffer, doubled while a CTA would hold more than
    :data:`PLAN_FLOATS_PER_CTA` floats, up to :data:`PLAN_MAX_CLUSTER`;
    None when no cluster holds it (the plan then runs a launch a round).
    More CTAs split a round's operands finer at a dearer barrier: on the
    H100, 16 CTAs take Ladner-Fischer at 2^16 x 1 1.6x faster than the 4
    that hold it, while 1,024 x 1 runs fastest on one and 4,096 x 3 on 4-8
    (``tools/kernel_variants.py fused_round C``, PERF.md §6)."""
    c = plan_min_cluster(n, d)
    if c is None:
        return None
    while c < PLAN_MAX_CLUSTER and c * PLAN_FLOATS_PER_CTA < n * d:
        c *= 2
    return c


@dataclasses.dataclass(frozen=True)
class PlanOperands:
    """A plan's compact operand list for the ``fused_plan`` kernel.

    ``ops`` (entries, 3) int32: one ``(dst, a, b)`` triple a combine
    (``y[dst] = op(y[a], y[b])``) or move (``b = -1``: ``y[dst] = y[a]``),
    none for a kept row; the plan's non-empty rounds in order, each grouped
    by the CTA owning ``dst`` (``dst // rows_per``).  ``dst`` carries
    :data:`PLAN_REWRITTEN` where the next round writes the same row;
    :meth:`round_ops` gives the plain triples.  The triples of live
    round k and CTA q are ``ops[bounds[k*C + q] : bounds[k*C + q + 1]]``;
    ``offsets`` holds ``bounds`` as an int32 tensor beside ``ops``.
    ``flags`` (rounds,) int32, per round: :data:`PLAN_CLUSTER_BARRIER`
    where a cluster barrier must follow it (else one among each CTA's
    threads suffices: it and the next round, if any, are CTA-local), and
    :data:`PLAN_LOCAL_READS` where it is CTA-local (every operand is a row
    of the CTA that owns ``dst``).  The pre-round value of row ``capture_wire``
    at live round ``capture_round`` (``rounds``: after the last) is the
    plan's total; -1 for none.
    """

    n: int
    cluster: int
    rows_per: int
    ops: torch.Tensor
    offsets: torch.Tensor
    bounds: Tuple[int, ...]
    flags: torch.Tensor
    capture_round: int = -1
    capture_wire: int = -1

    @property
    def rounds(self) -> int:
        return (len(self.bounds) - 1) // self.cluster

    @property
    def entries(self) -> int:
        return self.bounds[-1]

    @property
    def nbytes(self) -> int:
        """Bytes of the list on the device (triples, offsets, flags)."""
        return 4 * (3 * self.entries + len(self.bounds) + self.rounds)

    def round_ops(self, k: int) -> torch.Tensor:
        """The ``(dst, a, b)`` triples of live round ``k``, all CTAs."""
        c = self.cluster
        t = self.ops[self.bounds[k * c] : self.bounds[(k + 1) * c]].clone()
        t[:, 0] &= PLAN_REWRITTEN - 1
        return t

    def to(self, device) -> "PlanOperands":
        return dataclasses.replace(self, ops=self.ops.to(device),
                                   offsets=self.offsets.to(device),
                                   flags=self.flags.to(device))


def plan_operands(plan, cluster: int = 1) -> PlanOperands:
    """Lower an ExecutionPlan to its compact operand list for a cluster of
    ``cluster`` CTAs (host tensors; built once a plan and cluster size)."""
    if cluster < 1:
        raise ValueError(f"cluster must be >= 1, got {cluster}")
    n = plan.n
    rows_per = plan_rows_per(n, cluster)
    parts, counts, local = [], [], []
    cap_round = cap_wire = -1
    for rnd in plan.rounds:
        if rnd.capture_total is not None:
            cap_round, cap_wire = len(parts), int(rnd.capture_total)
        if not rnd.num_combines and not rnd.num_moves:
            continue
        dst = rnd.upd_idx
        a = np.concatenate([rnd.a_idx, rnd.mv_src])
        b = np.concatenate([rnd.b_idx,
                            np.full(rnd.num_moves, -1, dtype=np.int32)])
        owner = dst // rows_per
        order = np.argsort(owner, kind="stable")
        parts.append(np.stack([dst, a, b], axis=1)[order].astype(np.int32))
        counts.append(np.bincount(owner, minlength=cluster))
        local.append(bool(((a // rows_per == owner)
                           & ((b < 0) | (b // rows_per == owner))).all()))
    for k in range(len(parts) - 1):
        later = np.isin(parts[k][:, 0], parts[k + 1][:, 0])
        parts[k][later, 0] |= PLAN_REWRITTEN
    ops = (np.concatenate(parts) if parts
           else np.zeros((0, 3), dtype=np.int32))
    bounds = np.concatenate([[0], np.cumsum(np.concatenate(counts))
                             if counts else []]).astype(np.int64)
    local.append(True)   # after the last round only its own CTA reads
    flags = [(0 if local[k] and local[k + 1] else PLAN_CLUSTER_BARRIER)
             | (PLAN_LOCAL_READS if local[k] else 0)
             for k in range(len(parts))]
    return PlanOperands(
        n=n, cluster=cluster, rows_per=rows_per,
        ops=torch.from_numpy(np.ascontiguousarray(ops)),
        offsets=torch.from_numpy(bounds.astype(np.int32)),
        bounds=tuple(int(v) for v in bounds),
        flags=torch.tensor(flags, dtype=torch.int32),
        capture_round=cap_round, capture_wire=cap_wire,
    )


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
    that entry reads (``rigid_compose``: the ``{"angle", "shift"}`` dict;
    ``matmul``: one leaf of (m, m) matrices, packed row-major).
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
    if name == "matmul" and not (
        len(spec.tails) == 1 and matrix_side(spec.tails[0]) is not None
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
