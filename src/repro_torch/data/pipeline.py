"""Deterministic sharded synthetic token pipeline with straggler rebalancing.

Port of ``repro/data/pipeline.py`` (a copy: numpy batches over the port's
scheduler daemons).

Every (step, host) pair maps to a deterministic slice of a virtual infinite
token stream, so restarts resume exactly (the checkpoint stores only the step
counter) and elastic rescaling re-slices the same stream across a different
host count.  Per-host shard *boundaries* are adjustable at runtime by the
straggler monitor (``runtime/straggler.py``) using the paper's greedy
boundary-stealing rule — the fleet-level analogue of Algorithm 1.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.scheduler import DaemonHandle, spawn_daemon


@dataclasses.dataclass
class PipelineConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 1410
    prefetch: int = 2
    structured: bool = True   # learnable structure (k-gram chains), not iid noise


class TokenPipeline:
    """Iterator over host-local batches of (tokens, labels)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        # Fair static boundaries; may be rebalanced by the straggler monitor.
        b = cfg.global_batch
        h = cfg.num_hosts
        self._bounds: List[Tuple[int, int]] = [
            (i * b // h, (i + 1) * b // h - 1) for i in range(h)
        ]
        self._step = 0
        self._q: Optional[queue.Queue] = None
        self._producer: Optional[DaemonHandle] = None
        self._stop = threading.Event()

    # -- deterministic content ------------------------------------------
    def _sample(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.Generator(
            np.random.Philox(key=cfg.seed, counter=[step, row, 0, 0])
        )
        if not cfg.structured:
            return rng.integers(0, cfg.vocab_size, cfg.seq_len + 1, dtype=np.int32)
        # Markov-ish stream: next token = f(prev) + noise; gives a learnable
        # signal so example train runs show loss decreasing.
        toks = np.empty(cfg.seq_len + 1, dtype=np.int32)
        toks[0] = rng.integers(0, cfg.vocab_size)
        noise = rng.integers(0, 17, cfg.seq_len)
        for t in range(cfg.seq_len):
            toks[t + 1] = (toks[t] * 31 + 7 + noise[t]) % cfg.vocab_size
        return toks

    def host_rows(self) -> Tuple[int, int]:
        return self._bounds[self.cfg.host_id]

    def set_boundaries(self, bounds: Sequence[Tuple[int, int]]) -> None:
        """Install rebalanced per-host row boundaries (straggler monitor)."""
        assert len(bounds) == self.cfg.num_hosts
        lo0, hi_last = bounds[0][0], bounds[-1][1]
        assert lo0 == 0 and hi_last == self.cfg.global_batch - 1
        self._bounds = list(bounds)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        lo, hi = self.host_rows()
        rows = [self._sample(step, r) for r in range(lo, hi + 1)]
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    # -- iterator protocol with background prefetch ----------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def _fill(self):
        while not self._stop.is_set():
            item = (self._step_bg, self.batch_at(self._step_bg))
            # Bounded-wait put, re-checking the stop signal: an
            # unconditional put on the full queue would park this daemon
            # (and pin the pipeline) forever once the consumer stops.
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue
            self._step_bg += 1

    def start(self, step: int = 0):
        self._step = step
        self._step_bg = step
        self._q = queue.Queue(maxsize=self.cfg.prefetch)
        self._stop.clear()
        # spawn_daemon (the scheduler's sanctioned service-thread spawn
        # point) captures a producer crash into the handle; __next__ polls
        # it instead of deadlocking on a queue no one will ever fill.
        self._producer = spawn_daemon(self._fill, name="token-pipeline")
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._q is None:
            batch = self.batch_at(self._step)
            self._step += 1
            return batch
        while True:
            try:
                step, batch = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                err = self._producer.error() if self._producer else None
                if err is not None:
                    raise RuntimeError("token pipeline producer failed") from err
        self._step = step + 1
        return batch

    def stop(self):
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass

    @property
    def step(self) -> int:
        return self._step
