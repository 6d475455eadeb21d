"""Straggler mitigation: the paper's Algorithm-1 boundary rule at fleet level.

A compiled SPMD step cannot steal work mid-step (DESIGN.md §3), but the
paper's insight — *flexible segment boundaries are free when the first phase
is order-free* — applies between steps: per-host data-shard boundaries are
contiguous row ranges of the global batch, and moving a boundary by k rows
is exactly the steal operation.  The monitor tracks per-host step-time EMAs
and applies the greedy move-toward-the-slower-neighbour rule.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.work_stealing import rebalance_boundaries


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    ema: float = 0.7
    trigger_imbalance: float = 0.15   # rebalance when (max-mean)/mean exceeds
    min_rows: int = 1
    cooldown_steps: int = 10


class StragglerMonitor:
    def __init__(self, num_hosts: int, global_batch: int,
                 cfg: Optional[StragglerConfig] = None):
        self.cfg = cfg if cfg is not None else StragglerConfig()
        self.n = num_hosts
        self.batch = global_batch
        self.bounds: List[Tuple[int, int]] = [
            (i * global_batch // num_hosts, (i + 1) * global_batch // num_hosts - 1)
            for i in range(num_hosts)
        ]
        self._ema: Optional[np.ndarray] = None
        self._since = 0

    def imbalance(self) -> float:
        if self._ema is None:
            return 0.0
        mean = float(self._ema.mean())
        return (float(self._ema.max()) - mean) / mean if mean > 0 else 0.0

    def observe(self, step_times: Sequence[float]) -> Optional[List[Tuple[int, int]]]:
        """Record per-host step times; returns new boundaries when rebalancing."""
        t = np.asarray(step_times, dtype=np.float64)
        assert t.shape == (self.n,)
        self._ema = t if self._ema is None else self.cfg.ema * self._ema + (1 - self.cfg.ema) * t
        self._since += 1
        if self._since < self.cfg.cooldown_steps:
            return None
        if self.imbalance() < self.cfg.trigger_imbalance:
            return None
        # Per-row cost estimate: host time / rows, spread over its rows.
        costs = np.empty(self.batch)
        for (lo, hi), ht in zip(self.bounds, self._ema):
            rows = hi - lo + 1
            costs[lo : hi + 1] = ht / max(rows, 1)
        new_bounds = rebalance_boundaries(costs, self.bounds)
        # Clamp: every host keeps >= min_rows.
        ok = all(hi - lo + 1 >= self.cfg.min_rows for lo, hi in new_bounds)
        if not ok or new_bounds == self.bounds:
            return None
        self.bounds = new_bounds
        self._since = 0
        return new_bounds
