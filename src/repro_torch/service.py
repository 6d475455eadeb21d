"""Persistent registration runtime: series sessions over the shared pool.

Port of ``repro/service.py``::

    session = open_series(cfg)            # a tenant of the shared WorkerPool
    session.feed(chunk)                   # ingest + function A + seeded scan
    session.feed(chunk)                   #   ... as frames arrive
    res = session.result()                # SeriesResult for everything so far
    res2 = session.extend(late_frames)    # O(new) fold, no recompute
    session.close()

**Incremental scan.**  The scan operator is associative, so a session only
has to retain the running cumulative element phi_{0,m}: a suffix of ``k``
new frames costs the ``k`` function-A pair registrations plus a *seeded*
engine scan of the ``k`` new elements.

**Multi-tenancy.**  All sessions execute on one injected
:class:`~repro_torch.runtime.scheduler.WorkerPool` (process-wide shared pool
by default); a session's scan runs inside ``pool.tenant()``, so the
dispatcher sees the pool's occupancy and tenant count.

**Device.**  A session runs on the CUDA device unless it is opened with
``device="cpu"``; chunks are moved there on ingest.  Function A runs each
chunk in sub-batches of at most :data:`PAIR_SUB_BATCH` pairs so that a
full-width chunk fits in the card's memory; per-lane freezing makes every
pair's result independent of the sub-batch it runs in.

**Frame residency.**  Function B only ever touches frame 0, the boundary
frame of the previous chunk and the frames of the chunk being scanned, so
after each feed the session evicts everything else (:class:`_FrameStore`).

Not ported yet (``ROADMAP.md`` Queue 1 item 4): ``checkpoint``/``restore``
and the persistent compile cache (``runtime/compile_cache.py``).  The
``compile`` timing stage holds the one-time kernel build, and the
compile-cache counters stay 0.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, device_count, resolve_device
from repro_torch.core._tree import tree_index, tree_stack
from repro_torch.core.deformation import (
    Deformation,
    compose_batched,
    identity_deformation,
)
from repro_torch.core.engine import (
    dispatch as cost_dispatch,
    get_telemetry,
    op_batchable_from,
    pool_aware_workers,
    release_telemetry,
    scan as engine_scan,
)
from repro_torch.core.engine.backends import not_ported
from repro_torch.core.registration import (
    RegElement,
    RegistrationConfig,
    RegistrationOperator,
    SeriesRegistrar,
    fused_default,
    register_pair,
)
from repro_torch.runtime.scheduler import get_default_pool

#: Function A runs a chunk's pairs in sub-batches of at most this many.  At
#: 1920x1920 f32 one pair's autograd graph holds a few hundred MB, so 8
#: pairs stay far below the card's 80 GB.
PAIR_SUB_BATCH = 8


@dataclasses.dataclass(frozen=True)
class RegisterSeriesConfig:
    """Knobs for :func:`repro_torch.register_series` and
    :class:`SeriesSession` (same fields as the reference; defaults follow
    the paper)."""

    registration: RegistrationConfig = RegistrationConfig()
    refine: bool = True                  # function B refinement (paper's B)
    backend: Optional[str] = None        # None -> cost-model dispatch
    algorithm: Optional[str] = None
    num_segments: Optional[int] = None   # hierarchical: node-local segments
    num_threads: Optional[int] = None    # threads (per segment, if hier)
    stealing: bool = True
    cross_steal: Optional[bool] = None   # inter-segment stealing; None ->
                                         # dispatcher rule (telemetry imbalance)
    workers: Optional[int] = None
    devices: Optional[int] = None        # local devices for the dispatcher's
                                         # multi-device rule; None ->
                                         # torch.cuda.device_count() on CUDA
    skip_tol: Optional[float] = None     # fused guess check threshold
    fused_ncc: Optional[bool] = None     # route checks through warp_ncc
    telemetry_name: str = "registration_B"
    prefetch_depth: int = 1              # streaming-ingest lookahead chunks

    def __post_init__(self):
        if self.prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {self.prefetch_depth}"
            )


@dataclasses.dataclass
class SeriesResult:
    """Everything :func:`repro_torch.register_series` / ``session.result()``
    produce.

    ``timings`` maps pipeline stage -> cumulative wall-clock **seconds**
    spent in that stage over the session's whole life (a ``result()``
    mid-stream reports the seconds so far, and later results include the
    earlier work):

    * ``ingest``     — slicing/stacking fed chunks into frame pairs;
    * ``compile``    — the one-time build of the CUDA kernels the session's
      path launches (kept out of ``preprocess``/``scan`` so cost telemetry
      is not poisoned by one-off compilation);
    * ``preprocess`` — function A proper: batched pairwise registration of
      new frame pairs (paper §3's element construction);
    * ``scan``       — the (.)_B prefix scan over elements (work-stealing /
      hierarchical / sequential, whichever the dispatcher chose);
    * ``compose``    — batching per-element deformations into the stacked
      ``Deformation`` output.

    A plain dataclass of already-materialised values: safe to read from
    any thread once returned, and never mutated by the session afterwards
    (``timings`` is a copy).
    """

    deformations: Deformation            # batched phi_{0,i}, identity at i=0
    elements: List[RegElement]           # scan output, N-1 entries
    timings: Dict[str, float]            # per-stage wall seconds (see above)
    backend: str                         # backend that executed the scan
    op_telemetry: Dict[str, float]       # adapter cost statistics
    scan_stats: Optional[Any] = None     # HierStats when hierarchical ran
    compile_cache: Optional[Dict[str, float]] = None  # session hit/miss/secs
    # Added in the port: one record per feed that scanned elements — its
    # element count, backend, guess checks skipped/refined and scan seconds
    # (``backend`` above is only the last feed's).
    feeds: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    @property
    def n_frames(self) -> int:
        return len(self.elements) + 1

    def report(self) -> str:
        lines = [
            f"registered {self.n_frames} frames via backend={self.backend!r}"
        ]
        total = sum(self.timings.values())
        for stage, secs in self.timings.items():
            lines.append(f"  {stage:<12} {secs:8.3f}s")
        lines.append(f"  {'total':<12} {total:8.3f}s")
        tel = self.op_telemetry
        if tel.get("calls"):
            lines.append(
                f"  operator: {tel['calls']:.0f} calls, "
                f"mean {tel['mean_s'] * 1e3:.1f} ms, "
                f"max {tel['max_s'] * 1e3:.1f} ms "
                f"(imbalance {tel['imbalance']:.1f}x)"
            )
        cc = self.compile_cache
        if cc is not None and (cc.get("hits") or cc.get("misses")):
            lines.append(
                f"  compile cache: {cc.get('hits', 0):.0f} hits, "
                f"{cc.get('misses', 0):.0f} misses, "
                f"{cc.get('compile_s', 0.0):.3f}s compiling"
            )
        if self.scan_stats is not None:
            st = self.scan_stats
            ph = st.phase_seconds
            if hasattr(st, "devices"):  # ShardedStats
                lines.append(
                    f"  sharded: {st.devices} devices x {st.shard_rows} rows; "
                    f"phase-2 {st.phase2_rounds} rounds "
                    f"({st.phase2_algorithm}); "
                    f"{st.cross_steals} cross-shard steals; "
                    + ", ".join(f"{k}={v:.3f}s" for k, v in ph.items())
                )
                return "\n".join(lines)
            lines.append(
                f"  hierarchical: {st.num_segments} segments x "
                f"{st.threads_per_segment} threads; "
                + ", ".join(f"{k}={v:.3f}s" for k, v in ph.items())
            )
            if getattr(st, "cross_steal", False):
                per_seg = ",".join(str(k) for k in st.inter_segment_steals)
                lines.append(
                    "  cross-segment steals: "
                    f"{st.total_inter_segment_steals()} "
                    f"(per segment: {per_seg})"
                    + ("; cost-history segment sizing"
                       if st.rebalanced else "")
                )
        return "\n".join(lines)


class _FrameStore:
    """Frame access by *global* series index with O(1) residency.

    Registrar-compatible (``shape`` + integer indexing), so function B can
    keep addressing ``frames[a.i]`` / ``frames[b.k]`` by global index while
    the session retains only the frames an incremental scan can touch:
    frame 0 and the chunk boundary (everything else is evicted after its
    chunk has been folded in).  Touching an evicted frame is a protocol
    bug, not a recoverable condition — it raises with the index.
    """

    def __init__(self):
        self._frames: Dict[int, torch.Tensor] = {}
        self._n = 0
        self._hw: tuple = ()
        self.device: Optional[torch.device] = None

    @property
    def n(self) -> int:
        return self._n

    @property
    def shape(self) -> tuple:
        return (self._n,) + tuple(self._hw)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i) -> torch.Tensor:
        try:
            return self._frames[int(i)]
        except KeyError:
            raise IndexError(
                f"frame {int(i)} was evicted from the session's frame "
                f"window (resident: {sorted(self._frames)}); an incremental "
                "scan should only touch frame 0, the chunk boundary and the "
                "current chunk"
            ) from None

    def last(self) -> Optional[torch.Tensor]:
        return self._frames.get(self._n - 1)

    def append_chunk(self, chunk: torch.Tensor) -> None:
        for i in range(chunk.shape[0]):
            self._frames[self._n + i] = chunk[i]
        self._n += int(chunk.shape[0])
        self._hw = tuple(chunk.shape[1:])
        self.device = chunk.device

    def evict(self, keep) -> None:
        keep = set(keep)
        self._frames = {i: f for i, f in self._frames.items() if i in keep}


@dataclasses.dataclass
class _ChunkSummary:
    """Retained per-feed reduce summary (recovery / introspection)."""

    first_elem: int          # global index of the first element folded in
    n_elems: int
    seconds: float           # scan-stage wall time of this feed
    ops: int                 # operator applications this feed recorded
    backend: str = "none"    # backend the feed's scan ran on
    skipped: int = 0         # guess checks that skipped refinement
    refined: int = 0         # operator applications that refined




_session_ids = itertools.count()

_NOT_PORTED_ITEM = ("Queue 1 item 4 (compile cache, checkpoint/restore, "
                    "simulator, serving, sharded)")


class SeriesSession:
    """One resident series: feed chunks, read results, extend.

    **Thread-safety.**  A series is one ordered stream: concurrent
    ``feed``/``extend`` calls on the *same* session are serialized by an
    internal lock.  Many sessions on the shared pool are safe and intended.

    **Blocking.**  ``feed``/``result``/``extend`` run their compute
    synchronously on the calling thread (plus pool workers) and return only
    when the device work is done.

    **Device.**  ``device=None`` runs on the CUDA device and raises when
    there is none; ``device="cpu"`` runs on the CPU.

    **Units.**  All timing fields are wall-clock seconds (see
    :class:`SeriesResult` for the per-stage breakdown).
    """

    def __init__(
        self,
        cfg: Optional[RegisterSeriesConfig] = None,
        *,
        pool=None,
        session_id: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.cfg = cfg if cfg is not None else RegisterSeriesConfig()
        self.device = resolve_device(device)
        self.id = session_id or f"series{next(_session_ids)}"
        self.pool = pool if pool is not None else get_default_pool()
        self.telemetry = get_telemetry(
            self.cfg.telemetry_name, session=self.id
        )
        self._store = _FrameStore()
        self._elements: List[RegElement] = []   # cumulative phi_{0,k}
        self._pair_iters: List[int] = []        # function-A cost history
        self._summaries: List[_ChunkSummary] = []
        self._timings: Dict[str, float] = {
            "ingest": 0.0, "preprocess": 0.0, "scan": 0.0, "compose": 0.0,
            "compile": 0.0,
        }
        # The persistent compile cache is not ported: its counters stay 0.
        self._compile: Dict[str, float] = {
            "hits": 0, "misses": 0, "compile_s": 0.0,
        }
        self._backend_used: Optional[str] = None
        self._scan_stats = None
        available = device_count(self.device)
        self._devices = max(1, min(
            self.cfg.devices if self.cfg.devices is not None else available,
            available,
        ))
        self._pre_seconds = 0.0
        self._pre_pairs = 0
        self._feed_lock = threading.Lock()
        self._closed = False

    # ------------------------------------------------------------ queries

    @property
    def n_frames(self) -> int:
        return self._store.n

    @property
    def n_elements(self) -> int:
        return len(self._elements)

    @property
    def summaries(self) -> List[_ChunkSummary]:
        return list(self._summaries)

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(f"session {self.id!r} is closed")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --------------------------------------------------------------- feed

    def feed(self, chunk) -> "SeriesSession":
        """Ingest one chunk of frames and fold it into the running scan.

        Runs function A on the chunk's consecutive pairs (including the
        pair spanning the previous chunk's boundary), then scans the new
        elements *seeded* with the retained cumulative element — O(new)
        operator applications however long the series already is.  Empty
        chunks (ragged stream tails) are skipped.  ``chunk`` is an
        ``(n, H, W)`` tensor or array; it is moved to the session's device.
        """
        self._check_open()
        with self._feed_lock:
            t0 = time.perf_counter()
            if not isinstance(chunk, torch.Tensor):
                chunk = torch.from_numpy(np.array(chunk, dtype=np.float32))
            chunk = chunk.to(dtype=torch.float32, device=self.device)
            self._sync()
            self._timings["ingest"] += time.perf_counter() - t0
            if chunk.shape[0] == 0:
                return self
            t0 = time.perf_counter()
            prev_last = self._store.last()
            refs = (
                chunk[:-1] if prev_last is None
                else torch.cat([prev_last[None], chunk[:-1]], dim=0)
            )
            tmps = chunk if prev_last is not None else chunk[1:]
            new_elems: List[RegElement] = []
            if refs.shape[0]:
                defs, iters = self._register_pairs(refs, tmps)
                first = self._store.n - 1 if self._store.n else 0
                new_elems = [
                    RegElement(tree_index(defs, i), first + i, first + i + 1)
                    for i in range(int(refs.shape[0]))
                ]
                self._pair_iters.extend(int(v) for v in iters.tolist())
            self._store.append_chunk(chunk)
            dt = time.perf_counter() - t0
            self._timings["preprocess"] += dt
            if new_elems:
                self._pre_pairs += len(new_elems)
                self._pre_seconds += dt
                self._build_kernels()
                self._scan_suffix(new_elems)
            # O(1) residency: only frame 0 and the boundary frame can be
            # touched by future feeds.
            self._store.evict({0, self._store.n - 1})
        return self

    def _register_pairs(self, refs: torch.Tensor, tmps: torch.Tensor):
        """Function A on all pairs, in sub-batches of ``PAIR_SUB_BATCH``:
        ``(deformations, iterations)`` batched over the pairs."""
        cfg = self.cfg.registration
        n = int(refs.shape[0])
        outs = [
            register_pair(refs[lo:lo + PAIR_SUB_BATCH],
                          tmps[lo:lo + PAIR_SUB_BATCH], None, cfg)
            for lo in range(0, n, PAIR_SUB_BATCH)
        ]
        defs = {
            k: torch.cat([o.deformation[k] for o in outs], dim=0)
            for k in outs[0].deformation
        }
        iters = torch.cat([o.iterations for o in outs], dim=0)
        self._sync()
        return defs, iters

    def _build_kernels(self) -> None:
        """Build the CUDA kernels this session's scan will launch (once per
        process; on-disk builds are reused) and account the seconds to the
        ``compile`` stage, before the scan's timer starts."""
        cfg = self.cfg
        if (self.device.type != "cuda" or not cfg.refine
                or cfg.skip_tol is None
                or not fused_default(self.device, self._store.shape[1:],
                                     fused=cfg.fused_ncc)):
            return
        from repro_torch.kernels import warp_ncc

        self._timings["compile"] += warp_ncc.ensure_built()

    def _scan_suffix(self, new_elems: List[RegElement]) -> None:
        cfg = self.cfg
        t0 = time.perf_counter()
        seed = self._elements[-1] if self._elements else None
        first_elem = len(self._elements)
        ops_before = self.telemetry.calls + self.telemetry.compile_calls
        skipped = refined = 0
        if not cfg.refine:
            out = self._compose_suffix(new_elems, seed)
            backend_used = cfg.backend or "vector"
        else:
            out, backend_used, op = self._refine_suffix(new_elems, seed)
            skipped, refined = op.skipped, op.refined
        self._sync()
        self._backend_used = backend_used
        self._elements.extend(out)
        dt = time.perf_counter() - t0
        self._timings["scan"] += dt
        self._summaries.append(_ChunkSummary(
            first_elem=first_elem,
            n_elems=len(new_elems),
            seconds=dt,
            ops=self.telemetry.calls + self.telemetry.compile_calls
                - ops_before,
            backend=backend_used,
            skipped=skipped,
            refined=refined,
        ))

    def _compose_suffix(self, new_elems, seed) -> List[RegElement]:
        """refine=False: exactly-associative pure composition, vectorized —
        one batched engine scan over the chunk, one broadcast seed fold."""
        cfg = self.cfg
        batched = tree_stack([e.deformation for e in new_elems])
        scanned = engine_scan(
            compose_batched,
            batched,
            backend=cfg.backend,
            algorithm=cfg.algorithm,
            workers=cfg.workers,
            devices=self._devices,
        )
        if seed is not None:
            sd = seed.deformation
            scanned = compose_batched(
                {k: v.expand_as(scanned[k]) for k, v in sd.items()}, scanned
            )
        base_k = len(self._elements) + 1
        return [
            RegElement(tree_index(scanned, i), 0, base_k + i)
            for i in range(len(new_elems))
        ]

    def _refine_suffix(self, new_elems, seed):
        """refine=True: function-B scan of the suffix, seeded with the
        cumulative element, dispatched with pool awareness."""
        cfg = self.cfg
        registrar = SeriesRegistrar(self._store, cfg.registration, refine=True)
        op = RegistrationOperator(
            registrar,
            name=cfg.telemetry_name,
            telemetry=self.telemetry,
            skip_tol=cfg.skip_tol,
            fused=cfg.fused_ncc,
        )
        sec_per_pair = self._pre_seconds / max(self._pre_pairs, 1)
        if op.op_cost_estimate is None and sec_per_pair > 0:
            # Telemetry priming: function A's per-pair cost is the best
            # prior for function B (same minimiser, same frames).
            op.prime(sec_per_pair)
        n_new = len(new_elems)
        if n_new and len(self._pair_iters) >= n_new:
            # The new pairs' function-A iteration counts seed per-element
            # cost priors for this suffix's ahead-of-time segment sizing.
            op.prime_elements(self._pair_iters[-n_new:])
        backend_used = cfg.backend
        algorithm = cfg.algorithm
        num_segments, num_threads = cfg.num_segments, cfg.num_threads
        cross_steal = cfg.cross_steal
        with self.pool.tenant():
            if backend_used is None:
                d = cost_dispatch(
                    n_new, domain="element",
                    op_cost=op.op_cost_estimate,
                    workers=pool_aware_workers(self.pool, cfg.workers),
                    op_imbalance=op.op_imbalance_estimate,
                    pool_occupancy=self.pool.occupancy(),
                    op_batchable=op_batchable_from(op),
                    devices=self._devices,
                )
                # Execute exactly what the dispatcher decided (its circuit,
                # segment and thread counts — unless the config pins them).
                backend_used = d.backend
                if algorithm is None:
                    algorithm = d.algorithm
                if num_segments is None:
                    num_segments = d.num_segments
                if num_threads is None:
                    num_threads = d.num_threads
                if cross_steal is None:
                    cross_steal = d.cross_steal
            out = engine_scan(
                op,
                list(new_elems),
                backend=backend_used,
                algorithm=algorithm,
                num_segments=num_segments,
                num_threads=num_threads,
                stealing=cfg.stealing,
                cross_steal=cross_steal,
                workers=cfg.workers,
                seed=seed,
                pool=self.pool,
                devices=self._devices,
            )
        if backend_used == "hierarchical":
            from repro_torch.core.engine import hierarchical

            self._scan_stats = hierarchical.last_stats
        return out, backend_used, op

    # -------------------------------------------------------------- result

    def result(self) -> SeriesResult:
        """Assemble the :class:`SeriesResult` for everything fed so far.

        Does *not* finalize the session: ``feed``/``extend`` keep working
        afterwards.  Cheap relative to ``feed`` — it only stacks the
        retained per-element deformations (the ``compose`` timing stage).
        """
        self._check_open()
        if not self._elements:
            raise ValueError(
                f"register_series needs >= 2 frames, got {self._store.n}"
            )
        t0 = time.perf_counter()
        deformations = tree_stack(
            [identity_deformation(device=self.device)]
            + [e.deformation for e in self._elements]
        )
        self._sync()
        self._timings["compose"] += time.perf_counter() - t0
        return SeriesResult(
            deformations=deformations,
            elements=list(self._elements),
            timings=dict(self._timings),
            backend=self._backend_used or "none",
            op_telemetry=self.telemetry.summary(),
            scan_stats=self._scan_stats,
            compile_cache=dict(self._compile),
            feeds=[
                {"n_elems": s.n_elems, "backend": s.backend,
                 "skipped": s.skipped, "refined": s.refined,
                 "seconds": s.seconds}
                for s in self._summaries
            ],
        )

    def extend(self, new_frames) -> SeriesResult:
        """Fold a suffix of frames in and return the updated result."""
        self.feed(new_frames)
        return self.result()

    # ------------------------------------------------------------ recovery

    checkpoint = not_ported("SeriesSession.checkpoint", _NOT_PORTED_ITEM)
    restore = classmethod(not_ported("SeriesSession.restore", _NOT_PORTED_ITEM))

    # ------------------------------------------------------------ lifetime

    def close(self) -> None:
        """Release the session's telemetry channel and frame window."""
        if self._closed:
            return
        self._closed = True
        release_telemetry(self.cfg.telemetry_name, session=self.id)
        self._store = _FrameStore()

    def __enter__(self) -> "SeriesSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_series(
    cfg: Optional[RegisterSeriesConfig] = None,
    *,
    pool=None,
    session_id: Optional[str] = None,
    device: DeviceLike = None,
) -> SeriesSession:
    """Open a resident series session on the shared runtime (on the CUDA
    device unless ``device`` says otherwise)."""
    return SeriesSession(cfg, pool=pool, session_id=session_id, device=device)
