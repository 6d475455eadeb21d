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
  hierarchical  two-level reduce-then-scan (``engine/hierarchical.py``)
  decoupled  single-pass decoupled-lookback scan
             (``engine/decoupled_backend.py``)

Not ported yet, registered as stubs that raise ``NotImplementedError``
naming their ``ROADMAP.md`` item, so that a dispatch to one is loud:
``simulate``, ``collective``, ``pallas`` and ``sharded``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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
    the scheduler phases 1/3 run on (shared process pool by default)."""
    from ..work_stealing import work_stealing_scan

    t = num_threads if num_threads is not None else plan.n
    ys, _stats = work_stealing_scan(
        op, list(xs), t,
        plan=plan if plan is not None and plan.n == t else None,
        stealing=stealing, seed=seed, pool=pool,
    )
    return ys, None


# ---------------------------------------------------------------------------
# backends of later slices
# ---------------------------------------------------------------------------

#: Backend -> the ``ROADMAP.md`` item (Queue 1) that ports it.
UNPORTED = {
    "pallas": "Queue 1 item 3 (pallas backend + fused_round kernel)",
    "simulate": "Queue 1 item 4 (simulator)",
    "collective": "Queue 1 item 4 (distributed / sharded execution)",
    "sharded": "Queue 1 item 4 (distributed / sharded execution)",
}


def not_ported(what: str, item: str) -> Callable[..., Any]:
    """An executor that raises: ``what`` waits for ``ROADMAP.md`` ``item``."""

    def fn(*_args, **_kwargs):
        raise NotImplementedError(
            f"{what} is not ported to repro_torch yet (ROADMAP.md, {item})"
        )

    return fn


register_backend("vector", exec_vector)
register_backend("element", exec_element)
register_backend("blocked", exec_blocked)
register_backend("worksteal", exec_worksteal)
for _name, _item in UNPORTED.items():
    register_backend(_name, not_ported(f"the {_name!r} scan backend", _item))
