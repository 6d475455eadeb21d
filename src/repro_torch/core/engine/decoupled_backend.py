"""Decoupled-lookback scan backend: single-pass, device-resident.

Port of ``repro/core/engine/decoupled_backend.py``.  Wraps
``kernels/lookback_scan.py`` as an engine backend named ``"decoupled"``.
Unlike the multi-pass decompositions (blocked, hierarchical-array) every
element is read once; the cross-tile dependency resolves through the
published tile-status board instead of a separate global phase, so on the
card the whole scan is one kernel launch that never leaves the device.

What this adapter adds around the raw kernel:

* **pytree operands** — leaves are packed column-wise into one (n, D)
  tensor and the operator is lifted through ``_tiling.packed_op`` (pure
  reshapes, bit-exact);
* **``where=`` masks** — an identity-flag lane rides along and the packed
  operator is lifted to the optional monoid (``_tiling.lift_masked``);
* **seeding** — a seed element becomes tile 0's exclusive prefix;
* **arbitrary n** — rows are padded to a tile multiple by repeating the
  last row (padded outputs are sliced off);
* **element-domain lists** — stackable element lists are stacked to the
  array domain, scanned in one launch, and unstacked.

The tile count defaults to ``_tiling.default_num_tiles_cuda`` on the card
and ``default_num_tiles`` on the CPU.  On CUDA the op must be in the
kernels' table (``kernels/op_table.py``), or the kernel wrapper raises.
``plan`` is ignored: the decoupled formulation has no global circuit phase.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.kernels._tiling import (
    add_flag_lane,
    default_num_tiles,
    default_num_tiles_cuda,
    lift_masked,
    pack_element,
    pack_leaves,
    packed_op,
    pad_rows,
    unpack_leaves,
)
from repro_torch.kernels.lookback_scan import lookback_scan

from .._tree import tree_flatten, tree_map, tree_unflatten
from .backends import register_backend

Op = Callable[[Any, Any], Any]


def stack_elements(xs):
    """Stack a list of same-structure pytree elements along a new leading
    axis, or return None when the elements are not stackable (mismatched
    structures/shapes, non-tensor leaves like RegElement's index ints)."""
    if not xs:
        return None
    flat = [tree_flatten(x) for x in xs]
    ref = flat[0][1]
    if any(td != ref for _, td in flat[1:]):
        return None
    columns = list(zip(*(leaves for leaves, _ in flat)))
    if not columns or any(
        not isinstance(t, torch.Tensor) for col in columns for t in col
    ):
        return None
    try:
        stacked = [torch.stack(col, dim=0) for col in columns]
    except RuntimeError:  # shapes, dtypes or devices that do not stack
        return None
    return tree_unflatten(ref, stacked)


def exec_decoupled(
    op: Op,
    plan,
    xs,
    *,
    num_blocks: Optional[int] = None,
    seed: Any = None,
    where=None,
    **_,
) -> Tuple[Any, Any]:
    """Single-pass decoupled-lookback scan; returns ``(ys, total)``."""
    if isinstance(xs, list):
        stacked = stack_elements(xs)
        if stacked is None:
            raise ValueError(
                "decoupled backend needs stackable array elements; got a "
                "list the operator cannot be batched over — use "
                "element/worksteal/hierarchical"
            )
        ys, total = exec_decoupled(
            op, plan, stacked, num_blocks=num_blocks, seed=seed, where=where,
        )
        return [tree_map(lambda t, i=i: t[i], ys) for i in range(len(xs))], total

    x2, spec = pack_leaves(xs)
    n = x2.shape[0]
    pop = packed_op(op, spec)

    masked = where is not None
    if masked:
        if len(where) != n:
            raise ValueError(f"where mask length {len(where)} != n {n}")
        x2 = add_flag_lane(x2, where)
        pop = lift_masked(pop)

    seed_row = None
    if seed is not None:
        seed_row = pack_element(seed, spec).to(x2.device)
        if masked:
            # The seed always participates: identity flag 0.
            seed_row = torch.cat([seed_row, seed_row.new_zeros((1,))], dim=0)

    if num_blocks is not None:
        t = num_blocks
    elif x2.device.type == "cpu":
        t = default_num_tiles(n)
    else:
        t = default_num_tiles_cuda(n)
    t = max(1, min(int(t), n))
    x2p, _ = pad_rows(x2, t)

    y2p, _status, _aggs, _prefs = lookback_scan(pop, x2p, t, seed=seed_row)
    y2 = y2p[:n]
    if masked:
        y2 = y2[:, :-1]
    ys = unpack_leaves(y2, spec)
    total = tree_map(lambda t: t[-1], ys)
    return ys, total


register_backend("decoupled", exec_decoupled)
