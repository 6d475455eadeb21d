"""Single-process scan executors (port of ``repro/core/scan.py``).

* :func:`python_exec` — the engine's ``element`` backend over a circuit:
  per-element execution for expensive operators, and the oracle of the
  property tests.
* :func:`prefix_scan` — circuit scan of a tree of tensors; equivalent to
  ``engine.scan(op, xs, backend="vector")``.
* :func:`blocked_scan` — the paper's local–global–local decomposition
  (§4.1) for N >> P: *scan-then-map* (Fig. 6a) and *reduce-then-scan*
  (Fig. 6b), with any circuit as the global phase; it backs the engine's
  ``blocked`` backend.

Array-domain operators are batched over leading axes (the same contract as
``jax.lax.associative_scan``), so the reference's ``vmap`` over segments is
the segment axis kept as a leading batch axis here, and its ``lax.scan``
local phases are Python loops along the element axis.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch

from ._tree import tensor_leaves, tree_map
from .circuits import Circuit
from .engine.backends import exec_element, exec_vector
from .engine.plan import get_plan

Op = Callable[[Any, Any], Any]  # batched over leading axes, tree -> tree


def python_exec(op: Op, circuit: Circuit, xs: Sequence[Any]) -> Tuple[list, Any]:
    """Reference per-element executor (lists of elements; op on single items)."""
    plan = get_plan(circuit)
    return exec_element(op, plan, xs)


def prefix_scan(op: Op, xs, *, algorithm: str = "ladner_fischer") -> Any:
    """Inclusive prefix scan of ``xs`` (tree, leading axis N) with ``op``."""
    from .engine import scan as engine_scan

    return engine_scan(op, xs, backend="vector", algorithm=algorithm)


def _local_inclusive_scan(op: Op, seg, axis: int = 0):
    """Sequential (work-optimal) inclusive scan along ``axis``: depth K-1,
    work K-1 per segment (the paper's local phase).  Leading axes before
    ``axis`` are batch axes of ``op``."""
    k = tensor_leaves(seg)[0].shape[axis]
    take = lambda j: tree_map(lambda t: t.select(axis, j), seg)
    carry = take(0)
    outs = [carry]
    for j in range(1, k):
        carry = op(carry, take(j))
        outs.append(carry)
    return tree_map(lambda *ts: torch.stack(ts, dim=axis), *outs)


def _local_reduce(op: Op, seg, axis: int = 0):
    """Sequential reduction along ``axis`` (the reduce-then-scan phase 1)."""
    k = tensor_leaves(seg)[0].shape[axis]
    take = lambda j: tree_map(lambda t: t.select(axis, j), seg)
    carry = take(0)
    for j in range(1, k):
        carry = op(carry, take(j))
    return carry


def blocked_scan(
    op: Op,
    xs,
    *,
    num_blocks: int,
    strategy: str = "reduce_then_scan",
    algorithm: str = "ladner_fischer",
    global_plan=None,
) -> Any:
    """Local–global–local inclusive scan (paper §4.1) in a single process.

    N must be divisible by ``num_blocks``.  The global phase over the P
    block partials executes ``global_plan`` directly when given (an
    inclusive width-P :class:`ExecutionPlan`); otherwise the chosen
    ``algorithm`` runs through the plan-cached vector backend.
    """
    n = tensor_leaves(xs)[0].shape[0]
    p = num_blocks
    if n % p:
        raise ValueError(f"N={n} not divisible by num_blocks={p}")
    k = n // p
    segs = tree_map(lambda t: t.reshape((p, k) + t.shape[1:]), xs)

    if global_plan is not None and (global_plan.exclusive or global_plan.n != p):
        raise ValueError(
            f"global_plan must be an inclusive width-{p} plan, got "
            f"{global_plan.circuit.name} (n={global_plan.n})"
        )

    def _global_scan(partials):
        if global_plan is not None:
            ys, _ = exec_vector(op, global_plan, partials)
            return ys
        return prefix_scan(op, partials, algorithm=algorithm)

    def bcast(e, like):
        return tree_map(
            lambda t, s: t.unsqueeze(1).expand((t.shape[0], s.shape[1]) + t.shape[1:]),
            e, like,
        )

    if strategy == "scan_then_map":
        # Phase 1: local inclusive scan per segment (strict left-to-right).
        local = _local_inclusive_scan(op, segs, axis=1)
        partials = tree_map(lambda t: t[:, -1], local)
        # Phase 2: global circuit scan over P partials.
        gscan = _global_scan(partials)
        # Phase 3: combine the exclusive global result into blocks 1..P-1.
        excl = tree_map(lambda t: t[:-1], gscan)
        head = tree_map(lambda t: t[:1], local)
        rest = tree_map(lambda t: t[1:], local)
        upd = op(bcast(excl, rest), rest)
        out = tree_map(lambda h, u: torch.cat([h, u], 0), head, upd)
    elif strategy == "reduce_then_scan":
        # Phase 1: local reduction (order-free -> enables work stealing).
        partials = _local_reduce(op, segs, axis=1)
        # Phase 2: global circuit scan.
        gscan = _global_scan(partials)
        # Phase 3: local scan seeded with the exclusive global result.
        excl = tree_map(lambda t: t[:-1], gscan)
        rest = tree_map(lambda t: t[1:], segs)
        first = op(excl, tree_map(lambda t: t[:, 0], rest))
        seeded = tree_map(
            lambda f, s: torch.cat([f.unsqueeze(1), s[:, 1:]], dim=1),
            first, rest,
        )
        upd = _local_inclusive_scan(op, seeded, axis=1)
        head = _local_inclusive_scan(op, tree_map(lambda t: t[:1], segs), axis=1)
        out = tree_map(lambda h, u: torch.cat([h, u], 0), head, upd)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return tree_map(lambda t: t.reshape((n,) + t.shape[2:]), out)

