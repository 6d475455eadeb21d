"""Distributed prefix scan over mesh axes (paper §4.1/§4.2) — ``spmd``.

Port of ``repro/core/distributed.py`` over :mod:`repro_torch.core.spmd`,
the port's ``shard_map`` counterpart.  A precompiled
:class:`~repro_torch.core.engine.plan.ExecutionPlan` is executed *across
mesh positions*: one scan element per position along a named axis, one
plan round per communication round.  The per-round permutation tables,
source indices and destination masks are resolved once by
:func:`repro_torch.core.engine.backends.lower_collective` (cached), not
re-derived from the circuit IR on every call.  One-to-one rounds lower to
``spmd.ppermute`` (the MPI point-to-point sends of the paper); multicast
rounds — Ladner–Fischer's MPI_Bcast steps — lower to ``spmd.all_gather``
plus a select, as in the reference.  This module is the engine's
``collective`` backend.

Hierarchy: the paper replaces P flat ranks by P' ranks x T threads.  Here
the hierarchy is mesh axes — ``("pod", "data")``: an inner scan on the fast
axis, a single outer scan on the slow one, mirroring "restrict the global
phase to the highest hierarchy level" (§4.2/§4.3).

All functions are *collectives*: call them inside ``spmd.shard_map``.  A
position's axis index is a host integer there, so where the reference
selects with a traced mask the port picks one side (the values are the
same; a position that would discard an operator application skips it).
``axis_size`` may be passed; inside a ``shard_map`` it is read from the
mesh, outside one it must be given.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from . import spmd
from ._tree import tensor_leaves, tree_map
from .circuits import get_exscan_circuit
from .engine.backends import lower_collective
from .engine.plan import ExecutionPlan, get_plan
from .scan import _local_inclusive_scan, _local_reduce

Op = Callable[[Any, Any], Any]


def _axis_size(axis_name: str, axis_size: Optional[int]) -> int:
    if axis_size is not None:
        return int(axis_size)
    if not spmd.in_shard_map():
        raise ValueError(
            f"cannot determine the size of mesh axis {axis_name!r} outside "
            f"a shard_map — pass the static axis_size= argument explicitly"
        )
    return spmd.axis_size(axis_name)


def _tree_concat(parts):
    return tree_map(lambda *ts: torch.cat(ts, dim=0), *parts)


def collective_scan_plan(op: Op, x, axis_name: str, plan: ExecutionPlan) -> Any:
    """Execute a precompiled plan's rounds as collectives across ``axis_name``.

    Every position takes part in every round's exchange; only the
    round's destinations apply the operator — the SPMD analogue of idle
    workers in the paper's Figure 2.
    """
    rounds = lower_collective(plan)  # raises for non-combine-only circuits
    my = spmd.axis_index(axis_name)
    y = x
    for rnd in rounds:
        if rnd.fanout == 1:
            recv = spmd.ppermute(y, axis_name, perm=list(rnd.perm))
        else:
            # Multicast round (Ladner-Fischer broadcast): all_gather + select.
            gathered = spmd.all_gather(y, axis_name)
            src_idx = int(rnd.src_of[my])
            recv = tree_map(lambda t: t[src_idx], gathered)
        if rnd.dst_mask[my]:
            y = op(recv, y)
    return y


def collective_scan(
    op: Op,
    x,
    axis_name: str,
    *,
    algorithm: str = "ladner_fischer",
    axis_size: Optional[int] = None,
) -> Any:
    """Inclusive prefix scan of one element per position across ``axis_name``.

    Lowers the chosen circuit to a plan (cached across calls) and executes it
    with ppermute/all_gather rounds via :func:`collective_scan_plan`.
    """
    p = _axis_size(axis_name, axis_size)
    if p == 1:
        return x
    return collective_scan_plan(op, x, axis_name, get_plan(algorithm, p))


def exclusive_shift(x, axis_name: str, *, axis_size: Optional[int] = None):
    """Shift values one position to the right along the axis.  Position 0
    receives zeros — callers must mask with ``axis_index(axis) > 0``."""
    p = _axis_size(axis_name, axis_size)
    return spmd.ppermute(x, axis_name, perm=[(i, i + 1) for i in range(p - 1)])


def exscan_plan(p: int) -> ExecutionPlan:
    """Plan for the Träff round-efficient exclusive scan over ``p`` ranks.

    The 2p-wire circuit's e-register starts as the identity, expressed to the
    planner via the wire mask — round 0's e-updates therefore compile into
    *moves* (received-value overwrites), not operator applications.
    """
    circ = get_exscan_circuit(p)
    return get_plan(circ, mask=[True] * p + [False] * p)


#: Log of executed exclusive-scan schedules: one entry per
#: ``exclusive_collective_scan`` call (logged by the mesh's first position,
#: as the reference logs once per trace), the number of ppermute rounds.
#: Tests assert the executed round count matches the Träff schedule
#: (ceil(log2 p)) and the simulator's prediction.
_exscan_rounds_log: List[int] = []


def last_exscan_rounds() -> Optional[int]:
    return _exscan_rounds_log[-1] if _exscan_rounds_log else None


def exclusive_collective_scan(
    op: Op,
    x,
    axis_name: str,
    *,
    axis_size: Optional[int] = None,
    init=None,
):
    """Round-efficient *exclusive* scan across ``axis_name`` (Träff 2025).

    Position i ends with x_0 (.) ... (.) x_{i-1} in ceil(log2 p) ppermute
    rounds — one round fewer than the naive inclusive-scan-then-shift
    (:func:`collective_scan` + :func:`exclusive_shift`): each round's single
    message carries the sender's window sum and updates *both* the exclusive
    prefix and the window registers of the receiver.

    Position 0 receives ``init`` (zeros by default) — callers must mask with
    ``axis_index(axis) > 0`` unless ``init`` is a true identity of ``op``.
    """
    p = _axis_size(axis_name, axis_size)
    if init is None:
        init = tree_map(torch.zeros_like, x)
    if p == 1:
        return init
    rounds = lower_collective(exscan_plan(p), registers=2)
    my = spmd.axis_index(axis_name)
    if spmd.position() == 0:
        _exscan_rounds_log.append(len(rounds))
    regs = [init, x]  # [e, s]: exclusive prefix, window sum
    for rnd in rounds:
        # Exscan rounds are one-to-one by construction (fanout == 1).
        recv = spmd.ppermute(regs[rnd.send_reg], axis_name, perm=list(rnd.perm))
        new_regs = []
        for r in range(2):
            y = regs[r]
            if rnd.dst_mask[r][my]:
                y = op(recv, y)
            if rnd.move_mask[r][my]:
                y = recv
            new_regs.append(y)
        regs = new_regs
    return regs[0]


def _masked_total(y, axis_name: str, p: int):
    """Value held by the last position on the axis, broadcast to all.

    Implemented as a masked psum: one all-reduce, no gather of the full axis.
    """
    if spmd.axis_index(axis_name) != p - 1:
        y = tree_map(torch.zeros_like, y)
    return spmd.psum(y, axis_name)


def hierarchical_collective_scan(
    op: Op,
    x,
    axis_names: Sequence[str],
    *,
    algorithms: Optional[Sequence[str]] = None,
    axis_sizes: Optional[Sequence[int]] = None,
) -> Any:
    """Inclusive scan across the flattened (outer..., inner) hierarchy.

    ``axis_names`` ordered outer-to-inner, e.g. ("pod", "data"): the element
    order is pod-major.  Each level scans internally, then passes one summary
    per group up — the paper's hierarchical scan (§4.2) with mesh axes playing
    ranks/threads.  Only the outermost scan crosses the slow network.
    """
    if algorithms is None:
        # Non-innermost levels fold an *exclusive* group prefix — default to
        # the round-efficient exscan there; the innermost level is a plain
        # inclusive scan and keeps the paper's Ladner–Fischer circuit.
        algorithms = ["exscan"] * (len(axis_names) - 1) + ["ladner_fischer"]
    if axis_sizes is None:
        axis_sizes = [None] * len(axis_names)
    if len(axis_names) == 1:
        return collective_scan(
            op, x, axis_names[0], algorithm=algorithms[0], axis_size=axis_sizes[0]
        )
    inner_names = axis_names[1:]
    inner_algs = algorithms[1:]
    inner_sizes = axis_sizes[1:]
    # Scan within the inner hierarchy.
    y = hierarchical_collective_scan(
        op, x, inner_names, algorithms=inner_algs, axis_sizes=inner_sizes
    )
    # One summary per inner group = the last inner position's inclusive value.
    p_inner = [_axis_size(n, s) for n, s in zip(inner_names, inner_sizes)]
    total = y
    for n, p in zip(inner_names, p_inner):
        total = _masked_total(total, n, p)
    # Outer *exclusive* scan over group summaries, folded back into every
    # member of the group.  The default outer schedule is the round-efficient
    # exscan — ceil(log2 p) rounds instead of the legacy inclusive scan plus
    # shift (one round more, kept for explicitly-requested circuits).
    outer = axis_names[0]
    p_outer = _axis_size(outer, axis_sizes[0])
    if algorithms[0] in (None, "exscan"):
        g_prev = exclusive_collective_scan(op, total, outer, axis_size=p_outer)
    else:
        g = collective_scan(
            op, total, outer, algorithm=algorithms[0], axis_size=p_outer
        )
        g_prev = exclusive_shift(g, outer, axis_size=p_outer)
    return op(g_prev, y) if spmd.axis_index(outer) > 0 else y


def exclusive_hierarchical_scan(
    op: Op,
    x,
    axis_names: Sequence[str],
    *,
    axis_sizes: Optional[Sequence[int]] = None,
) -> Any:
    """Exclusive scan across the flattened (outer..., inner) hierarchy.

    Every level runs the round-efficient exscan schedule directly — no
    inclusive scan followed by shifts (:func:`_exclusive_over_hierarchy`), so
    the slowest (outermost) axis sees exactly ceil(log2 p) rounds.  The
    hierarchically-first position receives zeros — callers must mask with
    :func:`_nonzero_linear_index`.
    """
    if axis_sizes is None:
        axis_sizes = [None] * len(axis_names)
    outer = axis_names[0]
    p_outer = _axis_size(outer, axis_sizes[0])
    if len(axis_names) == 1:
        return exclusive_collective_scan(op, x, outer, axis_size=p_outer)
    inner_names = axis_names[1:]
    inner_sizes = axis_sizes[1:]
    e_in = exclusive_hierarchical_scan(op, x, inner_names, axis_sizes=inner_sizes)
    # Group total = the last inner position's *inclusive* value; positions
    # with an inner predecessor fold their exclusive prefix in first
    # (op-agnostic: only one position per group contributes to the masked
    # psum).
    inner_first = not _nonzero_linear_index(inner_names)
    incl = x if inner_first else op(e_in, x)
    total = incl
    for n, s in zip(inner_names, inner_sizes):
        total = _masked_total(total, n, _axis_size(n, s))
    e_out = exclusive_collective_scan(op, total, outer, axis_size=p_outer)
    # Positions on outer index 0 keep the inner exclusive prefix; inner-first
    # positions of later groups take the group prefix verbatim.
    if spmd.axis_index(outer) == 0:
        return e_in
    return e_out if inner_first else op(e_out, e_in)


def distributed_blocked_scan(
    op: Op,
    xs_local,
    axis_names: Sequence[str],
    *,
    strategy: str = "reduce_then_scan",
    algorithms: Optional[Sequence[str]] = None,
    axis_sizes: Optional[Sequence[int]] = None,
) -> Any:
    """Local–global–local distributed scan (paper Fig. 6) inside shard_map.

    ``xs_local``: this position's contiguous segment (leading axis K) of the
    global N = K * prod(axis sizes) element array, laid out axis-major.
    Strategy and global circuit per the paper §4.1; the global phase is the
    (possibly hierarchical) collective scan.
    """
    def _exclusive_prefix(partial):
        """Exclusive position prefix of the per-position partials.

        Default (no explicit circuits): every level runs the round-efficient
        exscan directly.  Explicit ``algorithms`` keep the legacy inclusive
        hierarchical scan + shift cascade.
        """
        if algorithms is None:
            return exclusive_hierarchical_scan(
                op, partial, axis_names, axis_sizes=axis_sizes
            )
        g = hierarchical_collective_scan(
            op, partial, axis_names, algorithms=algorithms, axis_sizes=axis_sizes
        )
        return _exclusive_over_hierarchy(g, axis_names, axis_sizes)

    if strategy == "scan_then_map":
        local = _local_inclusive_scan(op, xs_local)          # LP1: local scan
        partial = tree_map(lambda t: t[-1], local)
        prev = _exclusive_prefix(partial)
        if not _nonzero_linear_index(axis_names):
            return local
        k = tensor_leaves(local)[0].shape[0]
        prev_b = tree_map(lambda t: t[None].expand((k,) + t.shape), prev)
        return op(prev_b, local)
    if strategy == "reduce_then_scan":
        partial = _local_reduce(op, xs_local)                # LP1: local reduce
        prev = _exclusive_prefix(partial)
        # Seed the first local element with the exclusive prefix, then scan.
        x0 = tree_map(lambda t: t[:1], xs_local)
        if _nonzero_linear_index(axis_names):
            x0 = op(tree_map(lambda t: t[None], prev), x0)
        rest = tree_map(lambda t: t[1:], xs_local)
        return _local_inclusive_scan(op, _tree_concat([x0, rest]))
    raise ValueError(f"unknown strategy {strategy!r}")


def _nonzero_linear_index(axis_names: Sequence[str]) -> bool:
    """True on every position except the hierarchically-first one."""
    return any(spmd.axis_index(n) > 0 for n in axis_names)


def _exclusive_over_hierarchy(g, axis_names, axis_sizes):
    """Exclusive value for the *flattened* hierarchy: the previous position
    in axis-major order.  Shift along the innermost axis; the first position
    of each inner group instead takes the last position of the previous
    group, which equals the (inclusive) value shifted along the next-outer
    axis.
    """
    sizes = {
        n: _axis_size(n, None if axis_sizes is None else axis_sizes[i])
        for i, n in enumerate(axis_names)
    }
    inner = axis_names[-1]
    p_in = sizes[inner]
    prev = exclusive_shift(g, inner, axis_size=p_in)
    carry_mask = spmd.axis_index(inner) == 0
    # Walk outward: for positions at index 0 of all inner axes so far, the
    # predecessor lives one step back on the next-outer axis (its last slot).
    for depth in range(len(axis_names) - 2, -1, -1):
        ax = axis_names[depth]
        p = sizes[ax]
        # Value of the last inner-slot holder of the previous outer index:
        # g is inclusive per position; the predecessor of (o, 0,...) is
        # (o-1, last,...) whose inclusive value g we need: ppermute over ax
        # from the position with inner index = last.  Since all positions of
        # a group hold different g, first broadcast the group-last g inward.
        last_g = g
        for n in axis_names[depth + 1 :]:
            last_g = _masked_total(last_g, n, sizes[n])
        shifted = exclusive_shift(last_g, ax, axis_size=p)
        if carry_mask:
            prev = shifted
        carry_mask = carry_mask and spmd.axis_index(ax) == 0
    return prev
