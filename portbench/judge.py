"""The comparisons that decide ``correct``.

Every number is a widest gap in pixels between the program's answers and
the reference's, over the answers a check covers:

* ``pair_ref_px``: function A's pair elements against the plain reference
  (``reference/registration.py``) on the same frames, over the sampled
  sub-batches;
* ``pair_truth_px``: every pair element of the run against the ground
  truth ``phi_{i,i+1}`` of the rendered series;
* ``chain_px``: every composed ``phi_{0,i}`` against the float64 chain
  (``reference/compose.py``) of the program's own pair elements;
* ``truth_shift_px``: every refined ``phi_{0,i}``'s shift against the
  ground truth, the widest coordinate (the guarantee the configuration
  states);
* ``truth_corner_px``: every refined ``phi_{0,i}`` against the ground
  truth, angle and shift together, by the corner gap below.

A gap between two rigid deformations is the farthest that they move any
pixel of the frame apart, which for rigid motions is at a corner.
A missing or non-finite answer counts as failed and makes the gap infinite.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Deformation = Dict[str, torch.Tensor]


def corner_gaps(a: Deformation, b: Deformation, height: int, width: int) -> torch.Tensor:
    """(n,) float64: for each pair of deformations, the largest distance in
    px between where they send the frame's four corners."""
    cy, cx = (height - 1) / 2.0, (width - 1) / 2.0
    corners = torch.tensor([[-cy, -cx], [-cy, cx], [cy, -cx], [cy, cx]],
                           dtype=torch.float64)

    def moved(d):
        ang = d["angle"].double().reshape(-1)
        sh = d["shift"].double().reshape(-1, 2)
        c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        r = c * corners[None, :, 0] - s * corners[None, :, 1]
        q = s * corners[None, :, 0] + c * corners[None, :, 1]
        return torch.stack([r, q], dim=-1) + sh[:, None, :]

    gap = (moved(a) - moved(b)).norm(dim=-1).amax(dim=1)
    return torch.where(torch.isfinite(gap), gap,
                       torch.full_like(gap, float("inf")))


def shift_gaps(a: Deformation, b: Deformation) -> torch.Tensor:
    """(n,) float64: the larger coordinate gap of the two shifts."""
    gap = (a["shift"].double() - b["shift"].double()).abs().amax(dim=-1)
    return torch.where(torch.isfinite(gap), gap,
                       torch.full_like(gap, float("inf")))


def hold(gaps: torch.Tensor, expected: int, limit: float) -> Tuple[float, list]:
    """``(widest gap, positions failed)`` of ``gaps`` for ``expected``
    answers held to ``limit``; a missing answer fails and makes the widest
    gap infinite."""
    failed = [j for j in range(int(gaps.numel())) if not gaps[j] <= limit]
    failed += list(range(int(gaps.numel()), expected))
    if expected > gaps.numel() or not gaps.numel():
        return float("inf"), failed
    return float(gaps.max()), failed


def verdict(checks: Dict[str, dict]) -> bool:
    """True when every number lies within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())
