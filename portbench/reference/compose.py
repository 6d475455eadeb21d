"""Composition of rigid deformations, the scan's pure operator, in plain
PyTorch.

``compose(a, b) = b o a`` (apply ``a`` first) for ``phi(x) = R(t)(x - c) + c
+ G`` about one centre: angle ``t_a + t_b``, shift ``R(t_b) G_a + G_b``
(paper §2.3.2).  The cumulative deformations ``phi_{0,i}`` of a series are
the running composition of its pair elements ``phi_{i-1,i}``.
"""

from __future__ import annotations

from typing import Dict

import torch


def compose(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    c, s = torch.cos(b["angle"]), torch.sin(b["angle"])
    ay, ax = a["shift"][..., 0], a["shift"][..., 1]
    shift = torch.stack([c * ay - s * ax, s * ay + c * ax], dim=-1) + b["shift"]
    return {"angle": a["angle"] + b["angle"], "shift": shift}


def chain(elements: Dict[str, torch.Tensor], dtype=torch.float64):
    """``phi_{0,i}`` for i = 1..n from the n pair elements (angle (n,),
    shift (n, 2)), composed one after another in ``dtype``."""
    angle = elements["angle"].to(dtype)
    shift = elements["shift"].to(dtype)
    acc = {"angle": angle[0], "shift": shift[0]}
    out_a, out_s = [acc["angle"]], [acc["shift"]]
    for i in range(1, angle.shape[0]):
        acc = compose(acc, {"angle": angle[i], "shift": shift[i]})
        out_a.append(acc["angle"])
        out_s.append(acc["shift"])
    return {"angle": torch.stack(out_a), "shift": torch.stack(out_s)}
