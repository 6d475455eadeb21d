"""Tile-scan backend: plans executed as kernels.

Port of ``repro/core/engine/pallas_backend.py`` (the backend keeps its
name, ``"pallas"``).  Two modes, selected by the width of the plan handed
in (the same convention as the ``blocked`` backend):

* ``plan.n == len(xs)``  → **rounds mode**: a plan whose (n, d) buffer
  fits twice in the shared memory of one thread-block cluster of up to 16
  CTAs (``_tiling.plan_cluster_size`` picks the size: n·d up to ~465k
  floats) runs as one ``fused_plan`` launch over its compact operand list
  (``_tiling.plan_operands``); a larger one runs one ``fused_round``
  launch a non-empty round, reading the round's dense operand table
  (``_tiling.round_sources``).  The size rule picks before any launch, and
  a refused cluster launch raises.  The device operands hang off the plan
  (``plan.scratch[("pallas", device)]``), built once a plan and device.
* ``plan.n <  len(xs)``  → **tiles mode**: the paper's local–global–local
  decomposition, the local phases one ``tile_local_scan`` and one
  ``tile_apply`` launch; the plan drives the small global phase over
  ``plan.n`` tile totals through the ``vector`` executor.

Restricted to single-leaf float tensors and operators that vectorize over
the leading axis (the "common low-compute operators" regime of the paper
§4.1).  CPU tensors run the kernels' plain versions, with any op and float
dtype; on CUDA the op and dtype must be in the kernels' table
(``kernels/op_table.py``), checked before any launch.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels._tiling import (
    PlanOperands,
    plan_cluster_size,
    plan_operands,
    round_sources,
)
from repro_torch.kernels.op_table import check_kernel_row
from repro_torch.kernels.tile_scan import (
    fused_plan,
    fused_round,
    tile_apply,
    tile_local_scan,
)

from .._tree import tree_flatten
from .backends import exec_vector, register_backend
from .plan import ExecutionPlan

Op = Callable[[Any, Any], Any]


def _as_2d(xs) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    leaves, _ = tree_flatten(xs)
    if len(leaves) != 1:
        raise ValueError(
            "pallas backend supports single-array inputs; got a pytree with "
            f"{len(leaves)} leaves — use backend='vector'"
        )
    x = leaves[0]
    if not isinstance(x, torch.Tensor) or not torch.is_floating_point(x):
        dtype = x.dtype if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"pallas backend requires a float dtype, got {dtype}")
    n = x.shape[0]
    tail = tuple(x.shape[1:])
    d = int(np.prod(tail)) if tail else 1
    return x.reshape(n, d), tail


def _lowering(plan: ExecutionPlan, device) -> dict:
    """The backend's device operands of ``plan`` on ``device``, kept on the
    plan itself: a lookup hashes a short key, never the plan's mask."""
    key = ("pallas", str(device))
    low = plan.scratch.get(key)
    if low is None:
        low = plan.scratch.setdefault(key, {})
    return low


def _round_index_tensors(plan: ExecutionPlan, device) -> Tuple[Optional[torch.Tensor], ...]:
    """Per-round operand tables on ``device`` (None for an empty round)."""
    low = _lowering(plan, device)
    tables = low.get("rounds")
    if tables is None:
        tables = low["rounds"] = tuple(
            None if src is None else torch.as_tensor(src, device=device)
            for src in (round_sources(rnd, plan.n) for rnd in plan.rounds)
        )
    return tables


def _plan_operands(plan: ExecutionPlan, device, cluster: int) -> PlanOperands:
    """The plan's compact operand list for ``cluster`` CTAs, on ``device``."""
    low = _lowering(plan, device)
    ops = low.get(("plan", cluster))
    if ops is None:
        ops = low[("plan", cluster)] = plan_operands(plan, cluster).to(device)
    return ops


def _check_on_card(op: Op, y2: torch.Tensor) -> None:
    """On CUDA the kernels run only the table's ops, on float32 rows or
    (add, max) bfloat16 ones."""
    if y2.device.type == "cpu":
        return
    check_kernel_row(op, y2.shape[1], dtype=y2.dtype)


def exec_pallas(op: Op, plan: ExecutionPlan, xs, **_) -> Tuple[Any, Any]:
    y2, tail = _as_2d(xs)
    n = y2.shape[0]
    _check_on_card(op, y2)

    if plan.n == n:
        cluster = plan_cluster_size(n, y2.shape[1])
        if cluster is not None:
            # Rounds mode, the whole plan in one launch on one cluster.
            y2, total = fused_plan(op, y2, _plan_operands(plan, y2.device,
                                                          cluster))
            if total is not None:
                total = total.reshape(tail)
            return y2.reshape((n,) + tail), total
        # Rounds mode, too large for a cluster: a launch a non-empty round.
        total = None
        for rnd, src in zip(plan.rounds, _round_index_tensors(plan, y2.device)):
            if rnd.capture_total is not None:
                # The pre-round value, copied out before the launch.
                total = y2[rnd.capture_total].clone().reshape(tail)
            if src is not None:
                y2 = fused_round(op, y2, src)
        return y2.reshape((n,) + tail), total

    # Tiles mode: plan.n tiles, local phases one launch each.
    t = plan.n
    if n % t:
        raise ValueError(f"n={n} not divisible by tile count {t}")
    local, partials = tile_local_scan(op, y2, t)
    gscan, _ = exec_vector(op, plan, partials)
    seeds = torch.cat([partials[:1], gscan[:-1]], dim=0)
    out = tile_apply(op, local, seeds)
    return out.reshape((n,) + tail), None


register_backend("pallas", exec_pallas)
