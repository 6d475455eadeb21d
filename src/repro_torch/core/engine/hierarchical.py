"""Hierarchical two-level reduce-then-scan backend (paper §4.2/§4.3).

Port of ``repro/core/engine/hierarchical.py``.  N elements are split across
S node-local *segments*; each segment is reduced independently with the
work-stealing executor (Algorithm 1 — threads steal boundary elements from
slower neighbours), a *small* cross-segment scan runs over the S segment
totals (plan-driven, width S), and a final local-apply pass folds each
segment's exclusive prefix back into its elements.  Work stays ~3N while the
critical path collapses to O(N/(S·T) + log S).

Two domains, same phase structure:

* **element** (Python list, expensive opaque operator — the registration
  operator), with cross-segment stealing through shared boundary
  ``_Gap``s, ahead-of-time segment sizing from cost history, and
  :class:`HierStats`.  Both phases execute on the injected
  :mod:`repro_torch.runtime.scheduler` pool — no threads are spawned here.
  A batchable operator can instead run the whole scan as batched device
  work (``device_phase1``, :func:`_exec_hier_device`).
* **array** (tree of tensors, vectorizable operator): phases 1/3 are
  batched segment scans/applies, routed through the ``tile_local_scan`` /
  ``tile_apply`` kernels (``kernels/tile_scan.py``) when the input is a
  single float leaf and the op has a kernel form (``kernels/op_table.py``);
  by default that is when the tensors lie on CUDA.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels._tiling import pack_leaves, packed_op, unpack_leaves
from repro_torch.kernels.op_table import kernel_op_for
from repro_torch.runtime.scheduler import get_default_pool

from .._tree import tensor_leaves, tree_index, tree_map
from .backends import exec_element, exec_vector, register_backend
from .plan import ExecutionPlan, get_plan

Op = Callable[[Any, Any], Any]


@dataclasses.dataclass
class HierStats:
    """Telemetry of one hierarchical element-domain execution."""

    num_segments: int
    threads_per_segment: int
    segment_bounds: List[Tuple[int, int]]       # inclusive [lo, hi] per segment
    intervals: List[Tuple[int, int]]            # final per-thread intervals
    steal_stats: List[Any]                      # per-segment StealStats | None
    phase_seconds: Dict[str, float]
    total_ops: int
    cross_steal: bool = False                   # inter-segment stealing ran
    inter_segment_steals: List[int] = dataclasses.field(default_factory=list)
    rebalanced: bool = False                    # AOT cost-history segment sizing
    device_phase1: bool = False                 # batched vmap reduce, no threads
    phase2_rounds: int = 0                      # cross-segment comm rounds: the
    # inclusive plan's rounds + 1 for the exclusive shift a distributed
    # lowering would pay (compare with the sharded backend's exscan count)

    def imbalance(self) -> float:
        """Max relative busy-time imbalance across segments (paper Fig. 5b)."""
        vals = [s.imbalance() for s in self.steal_stats if s is not None]
        return max(vals) if vals else 0.0

    def total_inter_segment_steals(self) -> int:
        """Boundary elements claimed across segment borders (phase 1)."""
        return sum(self.inter_segment_steals)


#: Stats of the most recent element-domain hierarchical execution.
last_stats: Optional[HierStats] = None


def segment_bounds(n: int, s: int) -> List[Tuple[int, int]]:
    """Contiguous near-even split of [0, n) into s inclusive intervals."""
    base, extra = divmod(n, s)
    out = []
    lo = 0
    for i in range(s):
        hi = lo + base + (1 if i < extra else 0) - 1
        out.append((lo, hi))
        lo = hi + 1
    return out


# ---------------------------------------------------------------------------
# element domain — segments reduced by the work-stealing executor
# ---------------------------------------------------------------------------


def _exec_hier_element(
    op: Op,
    plan: Optional[ExecutionPlan],
    xs: Sequence[Any],
    *,
    num_segments: int,
    num_threads: int,
    stealing: bool,
    seed: Any,
    cross_steal: Optional[bool] = None,
    element_costs: Optional[Sequence[float]] = None,
    pool=None,
) -> Tuple[list, Any]:
    from ..work_stealing import (
        _Gap,
        cross_start_positions,
        rebalance_boundaries,
        static_reduce,
        stealing_reduce,
    )
    from .telemetry import OpTelemetry, element_costs_from

    global last_stats
    if pool is None:
        pool = get_default_pool()
    n = len(xs)
    s = max(1, min(num_segments, n))
    t = max(1, num_threads)

    # Ahead-of-time segment sizing: when the operator carries per-element
    # cost history (RegistrationOperator telemetry, or an explicit
    # ``element_costs``), size segments to equal *cost* instead of equal
    # count, so a known-expensive stretch starts with fewer elements.
    costs = element_costs if element_costs is not None else (
        element_costs_from(op, n)
    )
    rebalanced = costs is not None and len(costs) == n and s > 1
    if rebalanced:
        bounds = rebalance_boundaries(list(costs), segment_bounds(n, s))
    else:
        bounds = segment_bounds(n, s)
    phase: Dict[str, float] = {}
    ops_count = 0

    # Cross-segment stealing (default on): finished segments drain shared
    # boundary gaps into still-running neighbours.  Needs stealing, >1
    # segment, and enough elements to seat every worker mid-range.
    cross = stealing and s > 1 if cross_steal is None else (
        cross_steal and stealing and s > 1
    )
    tcounts = [max(1, min(t, (hi - lo + 1) // 2)) for lo, hi in bounds]
    starts = cross_start_positions(bounds, tcounts, n) if cross else None
    cross = cross and starts is not None

    # --- phase 1: per-segment (stealing) reduction, segments concurrent.
    def reduce_segment(lo: int, hi: int):
        seg = list(xs[lo : hi + 1])
        ln = hi - lo + 1
        t_eff = min(t, ln // 2)
        if t_eff >= 2:
            fn = stealing_reduce if stealing else static_reduce
            partials, st = fn(op, seg, t_eff, pool=pool)
            intervals = [(lo + a, lo + b) for a, b in st.boundaries]
            reduce_ops = st.total_ops
        else:
            acc = seg[0]
            for item in seg[1:]:
                acc = op(acc, item)
            partials, st, intervals = [acc], None, [(lo, hi)]
            reduce_ops = ln - 1
        # Inclusive scan over the thread partials (T is small) — its last
        # entry is the segment total for the global phase, its prefixes seed
        # the per-interval applies in phase 3.
        pscan = [partials[0]]
        for p in partials[1:]:
            pscan.append(op(pscan[-1], p))
        return pscan, intervals, st, reduce_ops + len(pscan) - 1

    if cross:
        # Shared inter-segment gaps between the adjacent edge workers of
        # neighbouring segments, plus a per-segment rate EMA so direction
        # choice at a shared gap follows the *segment-level* Algorithm 1.
        offs = [0]
        for tc in tcounts:
            offs.append(offs[-1] + tc)
        inter: List[Optional[_Gap]] = [None] * (s + 1)
        for i in range(1, s):
            inter[i] = _Gap(starts[offs[i] - 1] + 1, starts[offs[i]],
                            border=bounds[i][0])
        seg_tel = [
            OpTelemetry(name=f"hier_seg{i}", ema_alpha=0.4) for i in range(s)
        ]

        def reduce_segment_cross(i: int):
            partials, st = stealing_reduce(
                op,
                xs,
                tcounts[i],
                starts=starts[offs[i] : offs[i + 1]],
                left_gap=inter[i],
                right_gap=inter[i + 1],
                outer_rates=(
                    seg_tel[i - 1].estimate if i > 0 else None,
                    seg_tel[i + 1].estimate if i < s - 1 else None,
                ),
                record=seg_tel[i].record,
                pool=pool,
            )
            pscan = [partials[0]]
            for p in partials[1:]:
                pscan.append(op(pscan[-1], p))
            return pscan, st.boundaries, st, st.total_ops + len(pscan) - 1

    t0 = time.perf_counter()
    if cross:
        seg_results = pool.run_tasks(
            [functools.partial(reduce_segment_cross, i) for i in range(s)],
            label="hier_reduce_cross",
        )
        # Boundaries moved with the steals: report the segments' final spans.
        bounds = [(r[1][0][0], r[1][-1][1]) for r in seg_results]
    elif s == 1:
        seg_results = [reduce_segment(*bounds[0])]
    else:
        seg_results = pool.run_tasks(
            [functools.partial(reduce_segment, lo, hi) for lo, hi in bounds],
            label="hier_reduce",
        )
    phase["reduce"] = time.perf_counter() - t0
    for _pscan, _intervals, _st, seg_ops in seg_results:
        ops_count += seg_ops

    # --- phase 2: small cross-segment scan over the S totals.
    t0 = time.perf_counter()
    totals = [r[0][-1] for r in seg_results]
    if s > 1:
        if plan is None or plan.n != s or plan.exclusive:
            plan = get_plan("ladner_fischer", s)
        scanned, _ = exec_element(op, plan, totals)
        ops_count += plan.work()
    else:
        scanned = totals
    total = scanned[-1]
    phase["global"] = time.perf_counter() - t0

    # --- phase 3: seeded per-interval applies, all intervals concurrent.
    t0 = time.perf_counter()
    out: List[Any] = [None] * n
    jobs: List[Tuple[int, int, Any]] = []
    for i, (pscan, intervals, _st, _ops) in enumerate(seg_results):
        if i == 0:
            base = seed
        elif seed is None:
            base = scanned[i - 1]
        else:
            base = op(seed, scanned[i - 1])
            ops_count += 1  # seed combines execute the operator: count them
        for j, (lo, hi) in enumerate(intervals):
            if j == 0:
                sj = base
            else:
                sj = pscan[j - 1] if base is None else op(base, pscan[j - 1])
                ops_count += 0 if base is None else 1
            jobs.append((lo, hi, sj))

    def apply_interval(job):
        lo, hi, acc = job
        k = 0
        for idx in range(lo, hi + 1):
            acc = xs[idx] if acc is None else op(acc, xs[idx])
            out[idx] = acc
            k += 1
        return k - (1 if job[2] is None else 0)

    if len(jobs) == 1:
        ops_count += apply_interval(jobs[0])
    else:
        ops_count += sum(
            pool.run_tasks(
                [functools.partial(apply_interval, j) for j in jobs],
                label="hier_apply",
            )
        )
    phase["apply"] = time.perf_counter() - t0

    last_stats = HierStats(
        num_segments=s,
        threads_per_segment=t,
        segment_bounds=bounds,
        intervals=[(lo, hi) for lo, hi, _ in jobs],
        steal_stats=[r[2] for r in seg_results],
        phase_seconds=phase,
        total_ops=ops_count,
        cross_steal=cross,
        inter_segment_steals=[
            r[2].cross_steals() if r[2] is not None else 0
            for r in seg_results
        ] if cross else [0] * s,
        rebalanced=rebalanced,
        phase2_rounds=(plan.num_rounds() + 1) if s > 1 else 0,
    )
    return out, total


# ---------------------------------------------------------------------------
# element domain, device phase 1 — batched device work instead of threads
# ---------------------------------------------------------------------------


def _exec_hier_device(
    op: Op,
    xs: Sequence[Any],
    stacked,
    *,
    num_segments: int,
    seed: Any,
    use_pallas: Optional[bool],
) -> Tuple[list, Any]:
    """Device-resident phase 1 for batchable operators.

    The element list is stacked to the array domain, the whole two-level
    reduce-then-scan runs as batched device work
    (:func:`_exec_hier_array`), an optional seed folds in with **one**
    batched operator application, and the result is unstacked back to a
    list.  No WorkerPool tasks: for a cheap batchable operator the
    per-task Python dispatch is the phase-1 critical path, not the
    operator.
    """
    from .cost import _largest_divisor_at_most

    global last_stats
    n = len(xs)
    phase: Dict[str, float] = {}

    t0 = time.perf_counter()
    # Stacking happened in the caller (it doubles as the eligibility
    # check); the array path needs S | N.
    s = _largest_divisor_at_most(n, max(1, num_segments))
    plan = get_plan("ladner_fischer", s) if s > 1 else None
    phase["stack"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ys_arr, _total = _exec_hier_array(
        op, plan, stacked, num_segments=s, use_pallas=use_pallas,
    )
    if seed is not None:
        seed_b = tree_map(
            lambda sl, yl: torch.as_tensor(
                sl, dtype=yl.dtype, device=yl.device
            )[None].expand(yl.shape),
            seed, ys_arr,
        )
        ys_arr = op(seed_b, ys_arr)
    leaves = tensor_leaves(ys_arr)
    if leaves and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)
    phase["device"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = [tree_index(ys_arr, i) for i in range(n)]
    total = tree_index(ys_arr, -1)
    phase["unstack"] = time.perf_counter() - t0

    last_stats = HierStats(
        num_segments=s,
        threads_per_segment=0,
        segment_bounds=segment_bounds(n, s),
        intervals=[],
        steal_stats=[None] * s,
        phase_seconds=phase,
        total_ops=0,  # device-side applications are not individually timed
        device_phase1=True,
        phase2_rounds=(plan.num_rounds() + 1) if plan is not None else 0,
    )
    return out, total


# ---------------------------------------------------------------------------
# array domain — batched segment scans, or the tile kernels
# ---------------------------------------------------------------------------


def _pallas_eligible(xs) -> bool:
    """One floating leaf: the data the tile kernels' path takes."""
    leaves = tensor_leaves(xs)
    return len(leaves) == 1 and leaves[0].is_floating_point()


def _exec_hier_array(
    op: Op,
    plan: Optional[ExecutionPlan],
    xs,
    *,
    num_segments: int,
    use_pallas: Optional[bool],
) -> Tuple[Any, Any]:
    from ..scan import _local_inclusive_scan

    n = tensor_leaves(xs)[0].shape[0]
    s = num_segments
    if n % s:
        raise ValueError(
            f"hierarchical array scan needs N divisible by num_segments, "
            f"got N={n}, S={s}"
        )
    if plan is None or plan.n != s or plan.exclusive:
        plan = get_plan("ladner_fischer", s) if s > 1 else None
    if s == 1:
        ys = _local_inclusive_scan(op, xs)
        return ys, tree_index(ys, -1)

    if use_pallas is None:
        # Routing, decided before any launch: the kernels where the tensors
        # lie on CUDA and the op has a kernel form.  An explicit True takes
        # the tile functions on any device (CPU tensors run their plain
        # versions; on CUDA an op without a kernel form raises there).
        use_pallas = (tensor_leaves(xs)[0].device.type == "cuda"
                      and kernel_op_for(op, xs) is not None)
    if use_pallas and _pallas_eligible(xs):
        # Tile kernels: per-tile scan, the small global phase over the tile
        # totals, then the seed apply.
        from repro_torch.kernels.tile_scan import tile_apply, tile_local_scan

        x2, spec = pack_leaves(xs)
        pop = packed_op(op, spec)
        local, partials = tile_local_scan(pop, x2, s)
        gscan, _ = exec_vector(pop, plan, partials)
        seeds = torch.cat([partials[:1], gscan[:-1]], dim=0)
        ys = unpack_leaves(tile_apply(pop, local, seeds), spec)
        total = tree_index(unpack_leaves(gscan[-1:], spec), 0)
        return ys, total

    k = n // s
    segs = tree_map(lambda t: t.reshape((s, k) + t.shape[1:]), xs)
    local = _local_inclusive_scan(op, segs, axis=1)
    partials = tree_map(lambda t: t[:, -1], local)
    gscan, _ = exec_vector(op, plan, partials)
    # Apply: segment i>0 folds in the inclusive global prefix of segments <i.
    excl = tree_map(lambda t: t[:-1], gscan)
    head = tree_map(lambda t: t[:1], local)
    rest = tree_map(lambda t: t[1:], local)
    upd = op(
        tree_map(
            lambda e, r: e.unsqueeze(1).expand((e.shape[0], k) + e.shape[1:]),
            excl, rest,
        ),
        rest,
    )
    out = tree_map(lambda h, u: torch.cat([h, u], 0), head, upd)
    ys = tree_map(lambda t: t.reshape((n,) + t.shape[2:]), out)
    return ys, tree_index(gscan, -1)


# ---------------------------------------------------------------------------
# backend entry point
# ---------------------------------------------------------------------------


def exec_hierarchical(
    op: Op,
    plan: Optional[ExecutionPlan],
    xs,
    *,
    num_segments: Optional[int] = None,
    num_threads: Optional[int] = None,
    stealing: bool = True,
    seed: Any = None,
    cross_steal: Optional[bool] = None,
    element_costs: Optional[Sequence[float]] = None,
    use_pallas: Optional[bool] = None,
    device_phase1: Optional[bool] = None,
    pool=None,
    **_,
) -> Tuple[Any, Any]:
    """Two-level reduce-then-scan; ``plan`` covers the cross-segment phase.

    ``num_segments`` defaults to the plan width; ``num_threads`` is the
    work-stealing thread count *per segment* (element domain only).
    ``cross_steal`` extends Algorithm 1 to the segment level (shared
    boundary gaps; default on where feasible); ``element_costs`` is an
    optional per-element cost prior for ahead-of-time segment sizing
    (otherwise read from the operator's telemetry, if it has any).
    ``device_phase1`` runs element-domain phase 1 as batched device work
    instead of pool threads (operators advertising ``op_batchable``; falls
    back to threads when the elements don't stack).  ``use_pallas``: run
    the array path's local phases through the tile kernels (default: the
    tensors lie on CUDA and the op has a kernel form).  ``pool`` is the
    scheduler segment reduces and interval applies run on (element domain;
    the process-wide shared pool by default).
    """
    s = num_segments if num_segments is not None else (plan.n if plan else 1)
    if isinstance(xs, list):
        if device_phase1:
            from .decoupled_backend import stack_elements

            stacked = stack_elements(xs)
            if stacked is not None:
                return _exec_hier_device(
                    op, xs, stacked,
                    num_segments=s, seed=seed, use_pallas=use_pallas,
                )
            # Elements don't stack (opaque payloads): threads still work.
        return _exec_hier_element(
            op,
            plan,
            xs,
            num_segments=s,
            num_threads=num_threads if num_threads is not None else 2,
            stealing=stealing,
            seed=seed,
            cross_steal=cross_steal,
            element_costs=element_costs,
            pool=pool,
        )
    if seed is not None:
        raise NotImplementedError(
            "seeded hierarchical scan is element-domain only"
        )
    return _exec_hier_array(
        op, plan, xs, num_segments=s, use_pallas=use_pallas,
    )


register_backend("hierarchical", exec_hierarchical)
