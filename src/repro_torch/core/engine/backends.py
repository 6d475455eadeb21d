"""Backend registry + the plan-consuming executors.

Port of ``repro/core/engine/backends.py``.  A backend is a callable
``(op, plan, xs, **opts) -> (ys, total)`` executing a precompiled
:class:`~repro_torch.core.engine.plan.ExecutionPlan`.  ``total`` is the
all-elements reduction when the plan makes it available (Blelloch root before
zeroing), else None.  Registered backends:

  vector     gather → batched op → scatter per round in PyTorch (cheap ops)
  element    per-element Python execution (seconds-long operators; the oracle)
  blocked    local–global–local over one device; the plan drives the global
             phase over block partials (paper §4.1)
  worksteal  threaded reduce-then-scan with Algorithm-1 stealing; the plan
             drives the phase-2 scan over thread partials (paper §4.3)
  simulate   per-element execution that additionally tracks deterministic
             virtual time per wire (the discrete-event model of simulator.py)
  hierarchical  two-level reduce-then-scan (``engine/hierarchical.py``)
  decoupled  single-pass decoupled-lookback scan
             (``engine/decoupled_backend.py``)
  pallas     a plan as one ``fused_plan`` kernel (or a ``fused_round``
             kernel a round), or tiles over the tile kernels
             (``engine/pallas_backend.py``)
  collective one element a mesh position: the plan's rounds as
             ``spmd`` ppermute/all_gather rounds (``core/distributed.py``;
             call inside ``spmd.shard_map``)
  sharded    one series across the positions of a mesh, with boundary
             stealing (``engine/sharded.py``)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._tree import tensor_leaves, tree_map
from .plan import ExecutionPlan, LRUCache

Op = Callable[[Any, Any], Any]
Backend = Callable[..., Tuple[Any, Any]]

_REGISTRY: Dict[str, Backend] = {}

#: Backend-specific lowering cache, keyed on
#: (plan identity, backend, dtype-struct).
lowered_cache = LRUCache(maxsize=256)


def register_backend(name: str, fn: Backend, *, overwrite: bool = False) -> None:
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered")
    _REGISTRY[name] = fn


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scan backend {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


def plan_key(plan: ExecutionPlan) -> Tuple:
    return (plan.circuit.name, plan.n, plan.mask)


def dtype_struct(xs) -> Tuple:
    """Hashable (shape-tail, dtype) signature of a tree of tensors."""
    return tuple(
        (tuple(t.shape[1:]), str(t.dtype)) for t in tensor_leaves(xs)
    )


# ---------------------------------------------------------------------------
# vector backend — vectorized execution of plan rounds
# ---------------------------------------------------------------------------


def _round_device_indices(plan: ExecutionPlan, r: int, device):
    """Index tensors for round r on ``device``, memoized on the plan."""
    key = ("tidx", r, str(device))
    cached = plan.scratch.get(key)
    if cached is None:
        rnd = plan.rounds[r]
        cached = tuple(
            torch.as_tensor(a, dtype=torch.int64, device=device)
            for a in (rnd.a_idx, rnd.b_idx, rnd.mv_src, rnd.upd_idx)
        )
        plan.scratch[key] = cached
    return cached


def exec_vector(op: Op, plan: ExecutionPlan, xs, **_) -> Tuple[Any, Any]:
    """One gather → batched-op → scatter step per plan round."""
    device = tensor_leaves(xs)[0].device
    y = xs
    total = None
    for r, rnd in enumerate(plan.rounds):
        if rnd.capture_total is not None:
            total = tree_map(lambda t: t[rnd.capture_total], y)
        if not rnd.num_combines and not rnd.num_moves:
            continue
        a_idx, b_idx, mv_src, upd_idx = _round_device_indices(plan, r, device)
        vals = []
        if rnd.num_combines:
            vals.append(
                op(
                    tree_map(lambda t: t[a_idx], y),
                    tree_map(lambda t: t[b_idx], y),
                )
            )
        if rnd.num_moves:
            vals.append(tree_map(lambda t: t[mv_src], y))
        v = (tree_map(lambda *ts: torch.cat(ts, dim=0), *vals)
             if len(vals) > 1 else vals[0])
        y = tree_map(lambda t, u: t.index_copy(0, upd_idx, u), y, v)
    return y, total


# ---------------------------------------------------------------------------
# element backend — per-element execution (the oracle; expensive operators)
# ---------------------------------------------------------------------------


def exec_element(op: Op, plan: ExecutionPlan, xs: Sequence[Any], **_) -> Tuple[list, Any]:
    y: List[Any] = list(xs)
    total = None
    for rnd in plan.rounds:
        if rnd.capture_total is not None:
            total = y[rnd.capture_total]
        if not rnd.num_combines and not rnd.num_moves:
            continue
        reads = list(y)  # all reads observe pre-round values
        for a, b, out, _fan, _cs in rnd.combines:
            y[out] = op(reads[a], reads[b])
        for src, out, _fan in rnd.moves:
            y[out] = reads[src]
    return y, total


# ---------------------------------------------------------------------------
# adapters — blocked / worksteal reuse the executors
# (lazy imports: those modules themselves consume plans from this package)
# ---------------------------------------------------------------------------


def exec_blocked(
    op: Op,
    plan: Optional[ExecutionPlan],
    xs,
    *,
    num_blocks: Optional[int] = None,
    strategy: str = "reduce_then_scan",
    algorithm: str = "ladner_fischer",
    **_,
) -> Tuple[Any, Any]:
    """Local–global–local over one device; ``plan`` drives the global phase
    over the block partials when it is an inclusive width-P plan."""
    from ..scan import blocked_scan

    p = num_blocks if num_blocks is not None else (plan.n if plan else 8)
    usable = plan is not None and not plan.exclusive and plan.n == p
    ys = blocked_scan(op, xs, num_blocks=p, strategy=strategy,
                      algorithm=algorithm,
                      global_plan=plan if usable else None)
    return ys, None


def exec_worksteal(
    op: Op,
    plan: ExecutionPlan,
    xs: Sequence[Any],
    *,
    num_threads: Optional[int] = None,
    stealing: bool = True,
    seed: Any = None,
    pool=None,
    **_,
) -> Tuple[list, Any]:
    """Threaded reduce-then-scan (Algorithm 1); ``plan`` is the phase-2
    circuit over the thread partials (its width == num_threads); ``pool``
    the scheduler phases 1/3 run on (shared process pool by default).
    Returns the scan and its :class:`~repro_torch.core.work_stealing.StealStats`."""
    from ..work_stealing import work_stealing_scan

    t = num_threads if num_threads is not None else plan.n
    return work_stealing_scan(
        op, list(xs), t,
        plan=plan if plan is not None and plan.n == t else None,
        stealing=stealing, seed=seed, pool=pool,
    )


# ---------------------------------------------------------------------------
# simulate backend — element execution + deterministic virtual time
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimTrace:
    """Virtual-time trace of one simulated plan execution."""

    makespan: float
    work: int
    ready: np.ndarray  # per-wire completion time


#: Trace of the most recent ``simulate`` backend execution (inspectable).
last_trace: Optional[SimTrace] = None


def exec_simulate(
    op: Op,
    plan: ExecutionPlan,
    xs: Sequence[Any],
    *,
    op_cost: float = 1.0,
    costs: Optional[Sequence[float]] = None,
    latency: float = 0.0,
    **_,
) -> Tuple[list, Any]:
    """Execute the plan per-element while tracking virtual time per wire.

    ``costs``: optional per-*combine-output-wire* operator cost (defaults to
    the scalar ``op_cost``); ``latency``: per-message transfer time for a
    combine/move whose source is another wire.  The full distributed model
    (noise, multicast factors, hierarchy) lives in ``core/simulator.py`` —
    this backend is its single-circuit kernel, useful to compare circuit
    makespans while also producing real values.
    """
    global last_trace
    y: List[Any] = list(xs)
    ready = np.zeros(plan.n, dtype=np.float64)
    total = None
    work = 0
    for rnd in plan.rounds:
        if rnd.capture_total is not None:
            total = y[rnd.capture_total]
        if not rnd.num_combines and not rnd.num_moves:
            continue
        reads = list(y)
        t_reads = ready.copy()
        for a, b, out, _fan, cs in rnd.combines:
            y[out] = op(reads[a], reads[b])
            c = float(costs[out]) if costs is not None else float(op_cost)
            t_a = t_reads[a] + (latency if cs == a else 0.0)
            t_b = t_reads[b] + (latency if cs == b else 0.0)
            ready[out] = max(t_a, t_b) + c
            work += 1
        for src, out, _fan in rnd.moves:
            y[out] = reads[src]
            ready[out] = t_reads[src] + latency
    last_trace = SimTrace(makespan=float(ready.max(initial=0.0)), work=work,
                          ready=ready)
    return y, total


# ---------------------------------------------------------------------------
# collective lowering — plan rounds as ppermute/all_gather schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CollectiveRound:
    """One communication round over a mesh axis of size ``p``.

    ``perm``: (src, dst) pairs for ``spmd.ppermute`` (fanout == 1 rounds).
    ``src_of``: per-device source index for all_gather+select multicast rounds.
    ``dst_mask``: boolean per device — which devices apply the operator.

    Multi-register schedules (``lower_collective(..., registers=R)``, the
    Träff exscan family: R virtual wires per device) extend the layout:
    ``dst_mask``/``move_mask`` have shape (R, p) — per register, which devices
    combine (``y[r] = op(recv, y[r])``) or overwrite (``y[r] = recv``) — and
    ``send_reg`` names the single register whose value goes over the wire.
    """

    perm: Tuple[Tuple[int, int], ...]
    src_of: np.ndarray
    dst_mask: np.ndarray
    fanout: int
    move_mask: Optional[np.ndarray] = None
    send_reg: int = 0


def lower_collective(
    plan: ExecutionPlan, *, registers: int = 1
) -> Tuple[CollectiveRound, ...]:
    """Lower a plan into per-round collective schedules.

    ``registers=1`` (default): combine-only plans, one wire per device.
    ``registers=R>1``: the plan's ``n`` must be ``R * p``; wire ``w`` lives on
    device ``w % p`` in register ``w // p``.  Moves are allowed (they become
    received-value overwrites) but each round must send from a single register
    and deliver at most one message per destination device — the shape of the
    Träff 2025 exscan schedules, where one message updates both registers.
    """
    if registers == 1 and not plan.combine_only():
        raise NotImplementedError(
            f"collective execution supports combine-only circuits, got "
            f"{plan.circuit.name} (moves={plan.num_moves()}, "
            f"total={plan.total_available})"
        )
    if registers > 1 and plan.total_available:
        raise NotImplementedError(
            "multi-register collective execution does not support plans "
            "with capture_total rounds"
        )
    if plan.n % registers:
        raise ValueError(
            f"plan width {plan.n} not divisible by registers={registers}"
        )
    key = (plan_key(plan), "collective", registers)
    cached = lowered_cache.get(key)
    if cached is not None:
        return cached
    p = plan.n // registers
    out: List[CollectiveRound] = []
    for rnd in plan.rounds:
        if registers == 1:
            pairs = [(c[4], c[2]) for c in rnd.combines]  # (comm_src, dst)
            srcs = [s for s, _ in pairs]
            fanout = max((srcs.count(s) for s in set(srcs)), default=1)
            src_of = np.zeros(p, dtype=np.int32)
            dst_mask = np.zeros(p, dtype=bool)
            for s, d in pairs:
                src_of[d] = s
                dst_mask[d] = True
            out.append(
                CollectiveRound(
                    perm=tuple(pairs), src_of=src_of, dst_mask=dst_mask,
                    fanout=fanout,
                )
            )
            continue
        # Multi-register round: device-level message schedule + per-register
        # combine/move masks.  entries: (src_wire, dst_wire, is_combine).
        entries = []
        for a, b, o, _fan, cs in rnd.combines:
            if cs != a or o != b:
                raise NotImplementedError(
                    f"{plan.circuit.name}: multi-register lowering expects "
                    f"in-place combines with the communicated left operand "
                    f"(got a={a}, b={b}, out={o}, comm_src={cs})"
                )
            entries.append((a, o, True))
        for s, o, _fan in rnd.moves:
            entries.append((s, o, False))
        if not entries:
            continue
        send_regs = {s // p for s, _, _ in entries}
        if len(send_regs) != 1:
            raise NotImplementedError(
                f"{plan.circuit.name}: round sends from registers "
                f"{sorted(send_regs)}; multi-register lowering needs one"
            )
        send_reg = send_regs.pop()
        src_dev_of: Dict[int, int] = {}
        combine_mask = np.zeros((registers, p), dtype=bool)
        move_mask = np.zeros((registers, p), dtype=bool)
        for s, o, is_c in entries:
            sd, dd, dr = s % p, o % p, o // p
            prev = src_dev_of.get(dd)
            if prev is not None and prev != sd:
                raise NotImplementedError(
                    f"{plan.circuit.name}: device {dd} receives from both "
                    f"{prev} and {sd} in one round"
                )
            src_dev_of[dd] = sd
            (combine_mask if is_c else move_mask)[dr, dd] = True
        pairs = sorted((s, d) for d, s in src_dev_of.items())
        srcs = [s for s, _ in pairs]
        fanout = max((srcs.count(s) for s in set(srcs)), default=1)
        src_of = np.zeros(p, dtype=np.int32)
        for s, d in pairs:
            src_of[d] = s
        out.append(
            CollectiveRound(
                perm=tuple(pairs), src_of=src_of, dst_mask=combine_mask,
                fanout=fanout, move_mask=move_mask, send_reg=send_reg,
            )
        )
    result = tuple(out)
    lowered_cache.put(key, result)
    return result


def exec_collective(
    op: Op,
    plan: ExecutionPlan,
    x,
    *,
    axis_name: str,
    **_,
) -> Tuple[Any, Any]:
    """SPMD execution across ``axis_name`` — call inside ``spmd.shard_map``."""
    from ..distributed import collective_scan_plan

    return collective_scan_plan(op, x, axis_name, plan), None


register_backend("vector", exec_vector)
register_backend("element", exec_element)
register_backend("blocked", exec_blocked)
register_backend("worksteal", exec_worksteal)
register_backend("simulate", exec_simulate)
register_backend("collective", exec_collective)
