"""End-to-end series registration: the one-shot entry point over the session runtime.

Port of ``repro/pipeline.py``.  ``register_series(frames, cfg)`` is the
paper's full application (§2.3/§3/§5) as one call, a thin wrapper over
:mod:`repro_torch.service`: it opens a
:class:`~repro_torch.service.SeriesSession` on the shared worker pool, feeds
every chunk (prefetching ``cfg.prefetch_depth`` chunks ahead so acquisition
overlaps function-A preprocessing *and* the seeded suffix scan of the
previous chunk), and returns ``session.result()``:

  ingest      frames arrive as a tensor/array or a *stream* of chunks
              (``data/images.py:stream_series``)
  preprocess  function A on consecutive pairs, batched per chunk; its
              measured per-pair cost *primes* the session's operator
              telemetry
  scan        each chunk's new elements are scanned *seeded* with the
              retained cumulative element (cost-model dispatch with pool
              awareness: hierarchical / worksteal for the expensive
              refining operator, the sequential chain when the shared pool
              is saturated)
  compose     results are stacked into one batched deformation dict
              (identity at frame 0)

It runs on the CUDA device unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from repro_torch._device import DeviceLike
from repro_torch.runtime.scheduler import spawn_daemon
from repro_torch.service import (  # noqa: F401 — canonical home; re-exported here
    RegisterSeriesConfig,
    SeriesResult,
    SeriesSession,
)


def _prefetched(chunks: Iterable, depth: int = 1):
    """Pull ``chunks`` on a background thread, ``depth`` ahead of the
    consumer — acquisition/rendering of chunk k+1 overlaps function-A
    preprocessing of chunk k (PyTorch releases the GIL in its kernels).  Producer
    exceptions re-raise at the consuming ``next()``.  ``depth`` must be
    >= 1 (``RegisterSeriesConfig.prefetch_depth`` plumbs it through for
    streaming ingest that wants more than one chunk in flight).

    The producer only ever blocks on the bounded queue *with a timeout*,
    re-checking a stop signal the consumer sets when the generator is
    closed or abandoned early — an unconditional ``q.put`` would park the
    daemon thread forever on a full queue (and pin the source iterator)
    once the consumer is gone."""
    import queue
    import threading as _threading

    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = _threading.Event()
    err: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for c in chunks:
                if not _put(c):
                    return  # consumer gone: drop the rest, exit cleanly
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            # Recorded before the ``end`` sentinel goes out (the finally
            # below), so the consumer never sees ``end`` with an empty
            # error list.
            err.append(e)
        finally:
            _put(end)

    # Service-thread construction goes through the scheduler's sanctioned
    # spawn point (lint THR001).
    spawn_daemon(producer, name="repro_torch-prefetch")
    try:
        while True:
            c = q.get()
            if c is end:
                if err:
                    raise err[0]
                return
            yield c
    finally:
        stop.set()


def register_series(
    frames,
    cfg: Optional[RegisterSeriesConfig] = None,
    *,
    pool=None,
    device: DeviceLike = None,
) -> SeriesResult:
    """Register an image series: the paper's pipeline, engine-dispatched.

    ``frames``: ``(N, H, W)`` tensor or array, or an iterable of chunk
    tensors/arrays (streaming ingest, prefetched ``cfg.prefetch_depth``
    chunks ahead).  ``pool``: optional
    :class:`~repro_torch.runtime.scheduler.WorkerPool` (the process-wide
    shared pool by default).  ``device``: where to run — the CUDA device
    when None (raising if there is none), or e.g. ``"cpu"``.  Returns
    cumulative deformations phi_{0,i} aligning every frame to frame 0, with
    per-stage timings (wall-clock seconds) and operator telemetry.

    Blocking: runs the whole pipeline on the calling thread (pool workers
    help with scan tasks) and returns only when every frame has folded in.
    """
    if cfg is None:
        cfg = RegisterSeriesConfig()
    session = SeriesSession(cfg, pool=pool, device=device)
    try:
        if hasattr(frames, "shape"):
            session.feed(frames)
        else:
            for chunk in _prefetched(frames, depth=cfg.prefetch_depth):
                session.feed(chunk)
        return session.result()
    finally:
        session.close()
