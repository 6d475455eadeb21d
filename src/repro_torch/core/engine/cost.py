"""Operator cost model + backend/circuit/block-size dispatcher.

Port of ``repro/core/engine/cost.py``: the decision function is plain
Python over numbers and is copied as it is, so for the same inputs the
port's ``dispatch`` returns the reference's :class:`Dispatch`.  ``accel``
is set by the caller when the scan's tensors lie on a CUDA device.

The paper's central decision procedure (§4, Table 3): the right scan
algorithm depends on the operator-cost regime —

* **cheap, vectorizable** operators (adds, maxes — sub-microsecond): depth
  and memory movement dominate; run the whole circuit vectorized on one
  device (``vector``), switching to the work-optimal local–global–local
  decomposition (``blocked``, reduce-then-scan) once N is large enough that
  O(N log N) circuit work beats O(N) + tiny global circuit.
* **expensive** operators (the image-registration operator: seconds per
  application): operator applications dominate everything; choose
  reduce-then-scan so total work stays ~2N, and use the work-stealing
  executor (``worksteal``) so load imbalance does not serialize phase 1.
* in between, per-element execution (``element``) avoids the batching
  overhead that vectorization pays for operators that do not fuse.

``dispatch`` encodes exactly this; ``measure_op_cost`` provides the
microbenchmark estimate when the caller has no hint.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional

Op = Callable[[Any, Any], Any]

# Regime thresholds (seconds per operator application).  CHEAP is roughly the
# cost where one Python-level dispatch (~1 us) stops being negligible;
# EXPENSIVE is where a single application dwarfs thread/synchronization
# overhead (the paper's registration operator sits at ~10 s).
CHEAP_OP_COST = 1e-4
EXPENSIVE_OP_COST = 5e-3

# Above this N a cheap-operator scan is better served by the blocked
# local-global-local decomposition than by a flat O(N log N) circuit.
# Conservative: in eager mode the blocked path pays ~constant lax.scan
# dispatch overhead (~200 ms on this container's CPU), so the crossover vs
# the vectorized flat circuit sits near half a million elements; under jit
# the local phases fuse and the crossover drops.
BLOCKED_MIN_N = 1 << 19

# Two-level hierarchical reduce-then-scan (paper §4.2): worth its extra
# cross-segment phase once there are enough workers to populate segments ×
# threads (the paper's nodes × cores).  Below this, flat work stealing over
# one segment wins — one fewer scan phase, stealing across the whole range.
HIER_MIN_WORKERS = 16
HIER_SEGMENT_THREADS = 4  # stealing threads per segment (paper: cores/node)

# Cross-segment stealing (segment-level Algorithm 1) pays when the operator's
# per-call cost is imbalanced enough that one straggler segment would bound
# phase 1 — the paper's Fig. 5a registration tail sits at ~3x.  Below this
# max/mean ratio static segments are already balanced and the shared-gap
# protocol only adds lock traffic; with *no* observed imbalance the
# dispatcher keeps it on as cheap insurance (the gaps go idle if unneeded).
CROSS_STEAL_MIN_IMBALANCE = 1.5

# Pool-occupancy awareness (the resident runtime, runtime/scheduler.py).
# Under saturation the scheduler is work-conserving: aggregate throughput
# across concurrent series is bounded by total operator *work*, and
# reduce-then-scan trades ~2.5N applications for parallelism a saturated
# pool cannot deliver.  At or past this occupancy (demand / capacity), a
# small expensive-op series therefore runs the work-optimal sequential
# chain in its caller's thread instead of queueing a thread army.
POOL_BUSY_OCCUPANCY = 1.0
# ... but only *small* series: a huge series under a transiently busy pool
# still wants parallel latency once the backlog drains.
POOL_BUSY_MAX_N = 1024

# Device-resident phase 1 (batched segment reduce): an operator that
# advertises batchability (``op_batchable``) and costs less than the
# expensive regime runs phase 1 as one vmapped device launch instead of a
# WorkerPool thread army — per-task Python dispatch (~10-100 us) dwarfs
# the operator itself there.  Below this N the stack/unstack overhead
# around the launch eats the win.
DEVICE_PHASE1_MIN_N = 64

# Single-pass decoupled-lookback backend (array domain): worth its tile
# protocol once the input is large enough to fill several tiles, on a real
# accelerator (on CPU the interpreted kernel loses to plain XLA, so the
# dispatcher only routes there when ``accel`` is set; explicit
# ``backend="decoupled"`` always works).
DECOUPLED_MIN_N = 256

# Sharded multi-device execution: one series split across the local devices
# inside shard_map, boundary stealing at the shard gaps, the cross-shard
# phase as the round-efficient Träff exscan.  Needs a batchable operator
# (the shard body is one vectorized launch), enough devices for the
# cross-shard phase to beat one device's vectorized scan, and a series long
# enough that per-shard work dominates the halo/claim overhead.
SHARDED_MIN_DEVICES = 4
SHARDED_MIN_N = 1024


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """A dispatch decision: backend + circuit + block size + rationale."""

    backend: str
    algorithm: str
    num_blocks: Optional[int] = None
    num_threads: Optional[int] = None
    num_segments: Optional[int] = None
    strategy: str = "reduce_then_scan"
    cross_steal: Optional[bool] = None
    device_phase1: Optional[bool] = None   # batched vmap phase-1 reduce
    devices: Optional[int] = None          # mesh size for the sharded backend
    reason: str = ""


def measure_op_cost(op: Op, xs, *, reps: int = 3) -> float:
    """Microbenchmark: median seconds per single operator application.

    For array inputs the op is applied to length-1 slices (the per-element
    cost a circuit executor pays); for element sequences, to the first two
    items.  CUDA work is synchronized so device time is included.
    """
    import torch

    from .._tree import tensor_leaves, tree_map

    if isinstance(xs, list):
        a = xs[0]
        b = xs[1] if len(xs) > 1 else xs[0]
    else:
        a = tree_map(lambda t: t[:1], xs)
        b = tree_map(lambda t: t[1:2] if t.shape[0] > 1 else t[:1], xs)
    cuda = any(t.is_cuda for t in tensor_leaves((a, b)))
    times = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        op(a, b)
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _default_workers() -> int:
    return max(os.cpu_count() or 1, 1)


def pool_aware_workers(pool, workers: Optional[int]) -> Optional[int]:
    """Effective worker budget for one scan sharing ``pool`` with others.

    An explicit ``workers`` hint always wins.  Otherwise the machine's
    cores are divided fairly among the pool's admitted tenants (element-
    domain scans currently in flight, the caller included when it has
    already entered ``pool.tenant()``): four concurrent series on an
    8-core host each plan for 2 workers instead of all four planning an
    8-thread army.  With a single tenant this is exactly the old
    core-count default.
    """
    if workers is not None or pool is None:
        return workers
    tenants = max(1, pool.tenants())
    return max(1, _default_workers() // tenants)


def _largest_divisor_at_most(n: int, cap: int) -> int:
    for p in range(min(cap, n), 0, -1):
        if n % p == 0:
            return p
    return 1


def dispatch(
    n: int,
    *,
    domain: str,
    op_cost: Optional[float] = None,
    workers: Optional[int] = None,
    op_imbalance: Optional[float] = None,
    pool_occupancy: Optional[float] = None,
    op_batchable: Optional[bool] = None,
    accel: bool = False,
    devices: Optional[int] = None,
) -> Dispatch:
    """Pick backend + circuit + block size for one scan call.

    ``domain``: "array" (pytree of arrays, op vectorized over the leading
    axis) or "element" (list of opaque items, op on single items).
    ``op_cost``: estimated seconds per operator application (user hint or
    :func:`measure_op_cost`); None means "assume cheap/vectorizable".
    ``op_imbalance``: observed max/mean per-call cost ratio (operator
    telemetry); decides whether cross-segment stealing is worth its shared
    boundary gaps.  None means unobserved — stealing stays on as insurance.
    ``pool_occupancy``: the shared worker pool's demand/capacity ratio
    (``WorkerPool.occupancy()``).  At/above ``POOL_BUSY_OCCUPANCY`` a small
    expensive-op element series runs the work-optimal sequential chain
    instead of queueing parallel phases behind other tenants' tasks (the
    array-domain backends never touch the pool, so nothing shifts there —
    vector/blocked already are the non-queueing choice).
    ``op_batchable``: the operator advertises a batched form (it accepts
    stacked operands) — cheap/medium element-domain scans then run phase 1
    as one device launch (``Dispatch.device_phase1``) instead of threads.
    ``accel``: a real accelerator backs the default device; enables the
    single-pass ``decoupled`` backend for cheap/medium array scans.
    ``devices``: local device count (None = unknown/single-device); at
    ``SHARDED_MIN_DEVICES``+ a long batchable series runs across all of
    them (``sharded`` backend: shard_map phase 1 with boundary stealing,
    Träff exscan phase 2).
    """
    if n <= 1:
        return Dispatch("element" if domain == "element" else "vector",
                        "sequential", reason="trivial n")
    w = workers if workers is not None else _default_workers()
    cost = op_cost if op_cost is not None else 0.0
    sharded_ok = (
        op_batchable
        and devices is not None
        and devices >= SHARDED_MIN_DEVICES
        and n >= SHARDED_MIN_N
        and cost < EXPENSIVE_OP_COST
    )

    if domain == "element":
        if sharded_ok:
            return Dispatch(
                "sharded", "exscan", devices=devices,
                strategy="reduce_then_scan",
                reason=f"batchable op, {devices} devices, N={n} -> sharded "
                       "multi-device scan (boundary stealing + exscan "
                       "cross-shard phase)",
            )
        if (
            op_batchable
            and op_cost is not None
            and cost < EXPENSIVE_OP_COST
            and n >= DEVICE_PHASE1_MIN_N
        ):
            # Batched phase 1: a cheap/medium operator that vectorizes
            # runs its segment reduces as one vmapped device launch —
            # per-task Python dispatch would dominate a thread army.
            s = _largest_divisor_at_most(n, max(2 * w, 8))
            return Dispatch(
                "hierarchical", "ladner_fischer",
                num_segments=s, num_threads=1,
                strategy="reduce_then_scan", device_phase1=True,
                reason=f"batchable cheap op ({cost:.2e}s) -> device-resident "
                       "phase-1 reduce (vmap, no pool threads)",
            )
        if (
            cost >= EXPENSIVE_OP_COST
            and pool_occupancy is not None
            and pool_occupancy >= POOL_BUSY_OCCUPANCY
            and n <= POOL_BUSY_MAX_N
        ):
            # Saturated runtime: parallel phases would only queue, and
            # reduce-then-scan pays ~2.5N applications for parallelism the
            # pool cannot deliver right now.  The N-1-application chain in
            # the caller's own thread is the throughput-optimal choice.
            return Dispatch(
                "element", "sequential",
                strategy="sequential",
                reason=f"pool saturated (occupancy {pool_occupancy:.2f} >= "
                       f"{POOL_BUSY_OCCUPANCY}) -> work-optimal sequential "
                       "chain instead of queueing",
            )
        if cost >= EXPENSIVE_OP_COST and w >= HIER_MIN_WORKERS and n >= 2 * w:
            # Paper §4.2: at nodes × cores scale, two-level reduce-then-scan —
            # stealing within segments, a tiny cross-segment scan between.
            s = max(2, w // HIER_SEGMENT_THREADS)
            cross = (
                op_imbalance is None
                or op_imbalance >= CROSS_STEAL_MIN_IMBALANCE
            )
            why = (
                "unobserved imbalance" if op_imbalance is None else
                f"imbalance {op_imbalance:.1f}x "
                + (">=" if cross else "<")
                + f" {CROSS_STEAL_MIN_IMBALANCE}"
            )
            return Dispatch(
                "hierarchical", "ladner_fischer",
                num_segments=s, num_threads=max(2, w // s),
                strategy="reduce_then_scan",
                cross_steal=cross,
                reason=f"expensive op ({cost:.2e}s), {w} workers -> "
                       "hierarchical stealing reduce-then-scan; "
                       f"cross-segment={'on' if cross else 'off'} ({why})",
            )
        if cost >= EXPENSIVE_OP_COST and w > 1:
            # Paper §4.3: op cost dominates -> reduce-then-scan (work ~2N)
            # with Algorithm-1 stealing over the flexible phase-1 segments.
            # Threads clamp to n//2 (each needs >= 2 elements), so a short
            # series on a many-core host still parallelizes instead of
            # falling through to the serial executor.
            t = min(w, n // 2)
            if t > 1:
                return Dispatch(
                    "worksteal", "dissemination", num_threads=t,
                    strategy="reduce_then_scan",
                    reason=f"expensive op ({cost:.2e}s) -> "
                           "stealing reduce-then-scan",
                )
        # The element executor is a serial Python loop: depth-optimal
        # circuits only multiply the operator applications (~4x at N=32),
        # so the fallback is the work-optimal sequential chain.
        return Dispatch(
            "element", "sequential",
            reason="serial per-element execution; work-optimal chain",
        )

    # Array domain.  The op is vectorized over the leading axis by the
    # domain contract, so batchability needs no separate advertisement.
    if (
        devices is not None
        and devices >= SHARDED_MIN_DEVICES
        and n >= SHARDED_MIN_N
        and cost < EXPENSIVE_OP_COST
        and op_batchable is not False
    ):
        return Dispatch(
            "sharded", "exscan", devices=devices,
            strategy="reduce_then_scan",
            reason=f"batchable op, {devices} devices, N={n} -> sharded "
                   "multi-device scan (boundary stealing + exscan "
                   "cross-shard phase)",
        )
    if cost >= EXPENSIVE_OP_COST:
        blocks = _largest_divisor_at_most(n, max(w, 2))
        if blocks > 1:
            return Dispatch(
                "blocked", "ladner_fischer", num_blocks=blocks,
                strategy="reduce_then_scan",
                reason=f"expensive op ({cost:.2e}s) -> work-optimal "
                       "reduce-then-scan",
            )
    if accel and cost < EXPENSIVE_OP_COST and n >= DECOUPLED_MIN_N:
        # Accelerator-backed cheap/medium scan: the single-pass decoupled
        # lookback touches every element once and never leaves the device
        # (no separate global phase).  CPU keeps the flat circuit — the
        # interpreted kernel loses to plain XLA there.
        return Dispatch(
            "decoupled", "ladner_fischer",
            num_blocks=None,  # kernel picks its tile count
            strategy="single_pass",
            reason=f"accelerator + cheap op, N={n} -> single-pass "
                   "decoupled-lookback kernel",
        )
    if n >= BLOCKED_MIN_N:
        blocks = _largest_divisor_at_most(n, max(2 * w, 8))
        if blocks > 1:
            return Dispatch(
                "blocked", "ladner_fischer", num_blocks=blocks,
                strategy="reduce_then_scan",
                reason=f"large N={n} -> local-global-local",
            )
    return Dispatch(
        "vector", "ladner_fischer",
        reason="cheap vectorizable op; depth-optimal flat circuit",
    )
