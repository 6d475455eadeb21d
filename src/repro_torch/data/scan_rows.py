"""Rows and an op for the scan kernels' bfloat16 and matmul entries
(``kernels/op_table.py``), made from a seed.

:func:`telescoping_bf16` gives bfloat16 rows whose every run of combines is
an integer bfloat16 holds exactly, so any grouping of the sums gives the same
bits and a kernel must match its plain version, and the exact scan, bit for
bit.  :data:`matmul_compose` is the op of the matmul entry, and
:func:`orthogonal_matrices` gives matrices whose long chains of products stay
bounded.
"""

from __future__ import annotations

from typing import Tuple

import torch


def telescoping_bf16(n: int, d: int, seed: int, bound: int = 100,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """bfloat16 rows ``x[i] = s[i + 1] - s[i]`` of integers ``s`` in
    ``[-bound, bound]``, and their exact inclusive scan ``s[i + 1] - s[0]``:
    every combine of consecutive rows is an integer of magnitude at most
    ``2 * bound < 256``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = torch.randint(-bound, bound + 1, (n + 1, d), generator=g).float()
    x = (s[1:] - s[:-1]).to(device=device, dtype=torch.bfloat16)
    return x, (s[1:] - s[:1]).to(device=device, dtype=torch.bfloat16)


def matmul_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``op(earlier, later) = later @ earlier`` on (n, m, m) matrices or
    their packed (n, m * m) rows; tagged for the kernels' matmul entry."""
    m = int(round(a[0].numel() ** 0.5))
    return torch.matmul(b.reshape(-1, m, m),
                        a.reshape(-1, m, m)).reshape(a.shape)


matmul_compose.kernel_op = "matmul"


def orthogonal_matrices(n: int, m: int, seed: int,
                        device=None) -> torch.Tensor:
    """(n, m, m) float32 orthogonal matrices (QR of Gaussian ones)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((n, m, m), generator=g,
                                       dtype=torch.float64))
    return q.float().to(device)
