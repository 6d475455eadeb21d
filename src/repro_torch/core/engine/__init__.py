"""The unified scan engine (port of ``repro/core/engine``): circuit → plan
compiler, pluggable backends, cost-model dispatch.

  circuits.py   prefix-circuit IR (rounds of combine/cross/zero entries)
  plan.py       ``lower``: circuit → :class:`ExecutionPlan`, LRU-cached
  backends.py   registry of plan-consuming executors (vector / element /
                blocked / worksteal, + hierarchical from hierarchical.py and
                decoupled from decoupled_backend.py; the backends of later
                slices are registered as stubs)
  cost.py       operator cost model + dispatcher

Public entry point::

    from repro_torch.core.engine import scan

    ys = scan(op, xs)                            # cost-model dispatch
    ys = scan(op, items, backend="worksteal", num_threads=4)
    ys = scan(op, items, backend="hierarchical", num_segments=4, num_threads=2)
    ys = scan(op, xs, where=[True, ...])         # masked elements = identity

``xs`` may be a dict/tuple tree of tensors with a common leading axis
(vectorized domain: the operator is batched over leading axes) or a Python
list of opaque items (element domain: the operator combines single items —
the seconds-long registration operator).  ``scan`` always returns the
inclusive prefix scan in the same container type.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.kernels.op_table import kernel_op_for, kernel_op_of
from repro_torch.runtime.scheduler import get_default_pool

from .._tree import tensor_leaves, tree_map
from .backends import (
    available_backends,
    dtype_struct,
    get_backend,
    lowered_cache,
    register_backend,
)

from .cost import (
    CHEAP_OP_COST,
    CROSS_STEAL_MIN_IMBALANCE,
    DECOUPLED_MIN_N,
    DEVICE_PHASE1_MIN_N,
    EXPENSIVE_OP_COST,
    POOL_BUSY_OCCUPANCY,
    SHARDED_MIN_DEVICES,
    SHARDED_MIN_N,
    Dispatch,
    dispatch,
    measure_op_cost,
    pool_aware_workers,
)
from .plan import ExecutionPlan, PlanRound, get_plan, lower, plan_cache
from .telemetry import (
    OpTelemetry,
    element_costs_from,
    get_telemetry,
    op_batchable_from,
    op_cost_from,
    op_imbalance_from,
    release_telemetry,
)

# Register the "hierarchical" and "decoupled" backends on import.
from . import decoupled_backend as _decoupled  # noqa: F401
from . import hierarchical as _hierarchical  # noqa: F401

Op = Callable[[Any, Any], Any]

__all__ = [
    "CHEAP_OP_COST",
    "CROSS_STEAL_MIN_IMBALANCE",
    "DECOUPLED_MIN_N",
    "DEVICE_PHASE1_MIN_N",
    "EXPENSIVE_OP_COST",
    "POOL_BUSY_OCCUPANCY",
    "SHARDED_MIN_DEVICES",
    "SHARDED_MIN_N",
    "pool_aware_workers",
    "get_default_pool",
    "release_telemetry",
    "scan",
    "lower",
    "get_plan",
    "ExecutionPlan",
    "PlanRound",
    "register_backend",
    "get_backend",
    "available_backends",
    "dispatch",
    "Dispatch",
    "measure_op_cost",
    "plan_cache",
    "lowered_cache",
    "cache_stats",
    "dtype_struct",
    "OpTelemetry",
    "get_telemetry",
    "op_batchable_from",
    "op_cost_from",
    "op_imbalance_from",
    "element_costs_from",
]


def _scan_device(xs) -> Optional[torch.device]:
    """The device of the scan's first tensor (None for tensor-free items)."""
    leaves = tensor_leaves(xs[0] if isinstance(xs, list) and xs else xs)
    return leaves[0].device if leaves else None


def _accel_available(xs) -> bool:
    """True when the scan's tensors lie on a CUDA device — the regime where
    the accelerator-only dispatch rules apply (the reference asks
    ``jax.default_backend()``)."""
    dev = _scan_device(xs)
    return dev is not None and dev.type == "cuda"


def _accel_for(op, xs, element_domain: bool) -> bool:
    """The dispatcher's ``accel``: the tensors lie on CUDA *and* the op has
    a kernel form (``kernels/op_table.py``) — for an array scan, one that
    fits the data's packed rows.  Without one the card is dispatched like a
    host without an accelerator, so no kernel path is picked that would
    have to raise."""
    if not _accel_available(xs):
        return False
    if element_domain:
        return kernel_op_of(op) is not None
    return kernel_op_for(op, xs) is not None


def cache_stats():
    """Hit/miss/size counters of the plan and backend-lowering caches."""
    return {"plan": plan_cache.stats(), "lowered": lowered_cache.stats()}


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def _leading_n(xs) -> int:
    leaves = tensor_leaves(xs)
    if not leaves:
        raise ValueError("scan of an empty tree")
    return leaves[0].shape[0]


def _pad_array(xs, m: int, n: int):
    return tree_map(
        lambda t: torch.cat(
            [t, t[:1].expand((m - n,) + t.shape[1:])], dim=0
        ),
        xs,
    )


def scan(
    op: Op,
    xs,
    *,
    where: Optional[Sequence[bool]] = None,
    backend: Optional[str] = None,
    algorithm: Optional[str] = None,
    op_cost: Optional[float] = None,
    measure: bool = False,
    num_blocks: Optional[int] = None,
    num_threads: Optional[int] = None,
    num_segments: Optional[int] = None,
    strategy: Optional[str] = None,
    stealing: bool = True,
    cross_steal: Optional[bool] = None,
    element_costs: Optional[Sequence[float]] = None,
    workers: Optional[int] = None,
    seed: Any = None,
    device_phase1: Optional[bool] = None,
    use_pallas: Optional[bool] = None,
    pool=None,
    devices: Optional[int] = None,
):
    """Inclusive prefix scan of ``xs`` with associative ``op``.

    With no ``backend``, the cost-model dispatcher picks backend + circuit +
    block size from ``op_cost`` (seconds per application; set
    ``measure=True`` to microbenchmark it).  ``where`` is a *static* boolean
    mask — False elements are treated as the operator identity (they never
    reach ``op``); positions before the first True element pass through
    unchanged.

    ``seed``: an element logically preceding ``xs[0]`` — the scan returns
    the prefixes of ``[seed] + xs`` without the seed itself (the
    incremental-extension primitive of a series session).  Supported by the
    element-domain backends.

    ``pool`` (element domain): the :class:`~repro_torch.runtime.scheduler`
    worker pool the threaded backends execute on (process-wide shared pool
    by default).  Each element-domain scan is admitted as a pool *tenant*
    for its duration; the dispatcher reads the pool's occupancy and tenant
    count.

    ``devices``: local CUDA device count for the dispatcher's multi-device
    rule (default: ``torch.cuda.device_count()`` when the scan's tensors are
    on a CUDA device, else 1).

    Backend-specific options: ``num_blocks``/``strategy`` (blocked),
    ``num_threads``/``stealing`` (worksteal), ``num_segments``/
    ``num_threads``/``cross_steal``/``element_costs`` (hierarchical),
    ``num_blocks`` (decoupled: the tile count).  ``use_pallas``
    (hierarchical array and device phase-1 paths): run the local phases
    through the ``tile_local_scan``/``tile_apply`` kernels; default: when
    the tensors lie on CUDA and the op has a kernel form.
    """
    element_domain = isinstance(xs, list)
    if (
        seed is not None
        and backend not in ("decoupled", "sharded")
        and (not element_domain or backend == "collective")
    ):
        raise NotImplementedError("seed= is supported in the element domain "
                                  "(worksteal/hierarchical/element) and by "
                                  "the decoupled and sharded backends")
    if element_domain and backend != "collective":
        if pool is None:
            pool = get_default_pool()
        with pool.tenant():
            return _scan_impl(
                op, xs, element_domain,
                where=where, backend=backend, algorithm=algorithm,
                op_cost=op_cost, measure=measure, num_blocks=num_blocks,
                num_threads=num_threads, num_segments=num_segments,
                strategy=strategy, stealing=stealing, cross_steal=cross_steal,
                element_costs=element_costs, workers=workers, seed=seed,
                device_phase1=device_phase1, use_pallas=use_pallas,
                pool=pool, devices=devices,
            )
    return _scan_impl(
        op, xs, element_domain,
        where=where, backend=backend, algorithm=algorithm, op_cost=op_cost,
        measure=measure, num_blocks=num_blocks, num_threads=num_threads,
        num_segments=num_segments, strategy=strategy, stealing=stealing,
        cross_steal=cross_steal, element_costs=element_costs,
        workers=workers, seed=seed, device_phase1=device_phase1,
        use_pallas=use_pallas, pool=pool, devices=devices,
    )


def _seeded_chain(op: Op, xs: Sequence[Any], seed: Any) -> list:
    """Work-optimal sequential chain over ``xs`` seeded with ``seed``."""
    out: List[Any] = []
    acc = seed
    for x in xs:
        acc = x if acc is None else op(acc, x)
        out.append(acc)
    return out


def _scan_impl(
    op: Op,
    xs,
    element_domain: bool,
    *,
    where,
    backend,
    algorithm,
    op_cost,
    measure,
    num_blocks,
    num_threads,
    num_segments,
    strategy,
    stealing,
    cross_steal,
    element_costs,
    workers,
    seed,
    device_phase1,
    use_pallas,
    pool,
    devices,
):
    # --- collective: SPMD over a mesh axis (not ported: the stub raises).
    if backend == "collective":
        return get_backend("collective")(op, None, xs)

    n = len(xs) if element_domain else _leading_n(xs)
    if n == 0:
        return xs
    if n == 1:
        if element_domain and seed is not None:
            return [op(seed, xs[0])]
        if seed is None:
            return list(xs) if element_domain else xs
        # array-domain seeded scan (decoupled backend): the single element
        # still has to fold the seed in — fall through to the backend.

    # --- dispatch
    if element_domain and workers is None:
        # Fair-share sizing: concurrent tenants on the shared pool divide
        # the machine instead of each planning a full-size thread army.
        workers = pool_aware_workers(pool, workers)
    accel = _accel_available(xs)
    if backend is None:
        cost = op_cost
        if cost is None:
            # Telemetry feedback: operator adapters expose a running per-call
            # cost estimate (EMA of observed wall times).
            cost = op_cost_from(op)
        if cost is None and measure:
            cost = measure_op_cost(op, xs)
        occupancy = (
            pool.occupancy() if element_domain and pool is not None else None
        )
        if devices is None:
            devices = torch.cuda.device_count() if accel else 1
        d = dispatch(n, domain="element" if element_domain else "array",
                     op_cost=cost, workers=workers,
                     op_imbalance=op_imbalance_from(op),
                     pool_occupancy=occupancy,
                     op_batchable=op_batchable_from(op),
                     accel=_accel_for(op, xs, element_domain),
                     devices=devices)
        backend = d.backend
        if where is not None and backend in ("blocked", "worksteal",
                                             "hierarchical"):
            # Decomposition backends cannot honor identity masks; fall back
            # to the flat plan executors, which resolve them at plan time.
            backend = "element" if element_domain else "vector"
        algorithm = algorithm or d.algorithm
        num_blocks = num_blocks if num_blocks is not None else d.num_blocks
        num_threads = num_threads if num_threads is not None else d.num_threads
        num_segments = (num_segments if num_segments is not None
                        else d.num_segments)
        cross_steal = cross_steal if cross_steal is not None else d.cross_steal
        strategy = strategy or d.strategy
        if device_phase1 is None:
            device_phase1 = d.device_phase1
    elif where is not None and (
        backend in ("blocked", "worksteal", "hierarchical")
        or (backend == "pallas" and num_blocks is not None and num_blocks > 1)
    ):
        raise NotImplementedError(
            f"where masks are not supported by the {backend!r} backend's "
            "local-global-local decomposition; use vector/element/pallas "
            "(rounds mode) or drop the mask"
        )
    algorithm = algorithm or "ladner_fischer"
    strategy = strategy or "reduce_then_scan"
    fn = get_backend(backend)

    # --- single-pass decoupled lookback: no plan, no global phase.
    if backend == "decoupled":
        ys, _ = fn(op, None, xs, num_blocks=num_blocks, seed=seed,
                   where=where)
        return ys

    # --- sharded multi-device execution (a later slice: the stub raises),
    # called as the reference calls it.
    if backend == "sharded":
        ys, _ = fn(op, None, xs, num_blocks=num_blocks, seed=seed,
                   where=where, devices=devices)
        return ys

    # --- backends with their own decomposition (plan covers the small phase)
    if backend == "blocked":
        p = num_blocks or 8
        # An exclusive (Blelloch) global phase needs padding + shift handling
        # inside prefix_scan; only inclusive plans execute directly.
        plan = None if algorithm == "blelloch" else get_plan(algorithm, p)
        ys, _ = fn(op, plan, xs, num_blocks=p, strategy=strategy,
                   algorithm=algorithm)
        return ys
    if backend == "worksteal":
        t = num_threads or 4
        alg = algorithm if algorithm in ("dissemination", "ladner_fischer",
                                         "brent_kung", "sklansky",
                                         "sequential") else "dissemination"
        plan = get_plan(alg, t) if t > 1 else None
        ys, _ = fn(op, plan, xs, num_threads=t, stealing=stealing, seed=seed,
                   pool=pool)
        return ys
    if backend == "hierarchical":
        # Two-level reduce-then-scan; the plan covers the cross-segment phase.
        from .cost import _default_workers, _largest_divisor_at_most

        w = workers if workers is not None else _default_workers()
        if element_domain:
            s = num_segments or max(2, min(w // 2, n // 4) or 1)
            s = max(1, min(s, n))
            t = num_threads or max(2, w // max(s, 1))
        else:
            s = num_segments or _largest_divisor_at_most(n, max(2 * w, 8))
            if n % s:
                raise ValueError(
                    f"num_segments={s} must divide N={n} for array inputs"
                )
            t = num_threads or 1
        alg = algorithm if algorithm != "blelloch" else "ladner_fischer"
        plan = get_plan(alg, s) if s > 1 else None
        ys, _ = fn(op, plan, xs, num_segments=s, num_threads=t,
                   stealing=stealing, cross_steal=cross_steal,
                   element_costs=element_costs, use_pallas=use_pallas,
                   seed=seed, device_phase1=device_phase1, pool=pool)
        return ys
    if backend == "pallas" and num_blocks is not None and num_blocks > 1:
        plan = get_plan("ladner_fischer" if algorithm == "blelloch"
                        else algorithm, num_blocks)
        ys, _ = fn(op, plan, xs)
        return ys

    # --- seeded element execution without a decomposition backend: the
    # work-optimal chain (a flat circuit cannot consume a seed without
    # multiplying applications, defeating the seed's purpose).
    if seed is not None:
        if backend != "element":
            raise NotImplementedError(
                f"seed= is not supported by the {backend!r} backend; use "
                "element, worksteal or hierarchical"
            )
        if where is not None:
            raise NotImplementedError("seed= cannot be combined with where=")
        return _seeded_chain(op, xs, seed)

    # --- flat circuit execution (vector / element / pallas-rounds / simulate)
    mask = list(where) if where is not None else None
    if mask is not None:
        if len(mask) != n:
            raise ValueError(f"where mask length {len(mask)} != n {n}")
        mask = [not bool(v) for v in mask]  # where=True means *valid*
    if algorithm == "blelloch":
        if mask is not None:
            raise NotImplementedError(
                "where masks are not supported with the exclusive Blelloch "
                "circuit; use an inclusive algorithm"
            )
        m = _next_pow2(n)
        plan = get_plan("blelloch", m, n_valid=n if m != n else None)
        if element_domain:
            padded = list(xs) + [xs[0]] * (m - n)
            excl, total = fn(op, plan, padded)
            if m > n:
                return excl[1 : n + 1]
            return excl[1:n] + [total]
        padded = _pad_array(xs, m, n) if m != n else xs
        excl, total = fn(op, plan, padded)
        if m > n:
            return tree_map(lambda t: t[1 : n + 1], excl)
        return tree_map(
            lambda b, last: torch.cat([b[1:n], last[None]], 0), excl, total
        )
    plan = get_plan(algorithm, n, mask=mask)
    ys, _ = fn(op, plan, xs)
    return ys
