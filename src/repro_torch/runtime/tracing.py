"""Program spans in the profiler's trace.

``span(name)`` marks a stretch of the program under a fixed name.  With no
``torch.profiler`` recording it costs one flag check and returns a shared
no-op context; while a profiler records it is
``torch.profiler.record_function(name)``, so the span lands in the same
trace as the aten ops and the device's kernels, on the same clock, and is
written out with them.

The profiler collects host events on the thread that started it only,
unless it was started with :func:`all_threads_config`: the spans of the
pool's worker threads (phase-1 and phase-3 tasks, and the operator
applications they run) reach the trace only then.  The spans of the
calling thread (the session's, function A's, the dispatch, phase 2 and
its waits on the pool) reach it either way.

The names, one at each layer boundary (:data:`NAMES`):

* session: ``repro.feed`` (one ``SeriesSession.feed``), ``repro.feed.ingest``,
  ``repro.feed.evict``, ``repro.compile`` (the pair launcher's cache miss);
* function A: ``repro.fnA`` (one sub-batch of pairs), ``repro.fnA.step``
  (one batched gradient step, through its host sync);
* scan engine: ``repro.scan`` (a feed's scan stage), ``repro.scan.dispatch``,
  ``repro.scan.compose`` (the composing scan), ``repro.steal.task`` (a
  phase-1 pool task), ``repro.steal.backoff`` (the sleep after a lost take),
  ``repro.scan.combine`` (phase 2 and the seed combines), ``repro.scan.apply``
  (a phase-3 pool task), ``repro.pool.wait`` (a caller of
  ``WorkerPool.run_tasks`` waiting for the tasks that workers still run);
* operator B: ``repro.op.check`` (compose and guess check, through the
  distance's host read), ``repro.op.refine`` (the refinement; its steps nest
  as ``repro.fnA.step``).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["NAMES", "all_threads_config", "span", "timed"]

NAMES = (
    "repro.feed", "repro.feed.ingest", "repro.feed.evict", "repro.compile",
    "repro.fnA", "repro.fnA.step",
    "repro.scan", "repro.scan.dispatch", "repro.scan.compose",
    "repro.steal.task", "repro.steal.backoff", "repro.scan.combine",
    "repro.scan.apply", "repro.pool.wait",
    "repro.op.check", "repro.op.refine",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in the profiler's trace while one
    records, and does nothing otherwise."""
    # The profiler's process-wide flag: set while any profiler records,
    # whichever thread started it (``torch.autograd._profiler_enabled()``
    # reads the calling thread's collection only).
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


class timed:
    """``span(name)`` that also clocks its block: ``seconds`` holds the
    block's wall time once it has run, so that a stage clock and its span
    cover the same code."""

    __slots__ = ("_span", "_t0", "seconds")

    def __init__(self, name: str):
        self._span = span(name)
        self.seconds = 0.0

    def __enter__(self) -> "timed":
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return self._span.__exit__(*exc)


def all_threads_config():
    """The ``experimental_config`` for ``torch.profiler.profile`` under
    which the profiler collects the host events of every thread, the
    pool's workers included."""
    from torch._C._profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)
