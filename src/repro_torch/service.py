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

**Compile cache.**  Function A's batched launcher comes from the
process-wide :class:`~repro_torch.runtime.compile_cache.CompileCache`,
keyed by (chunk length, frame shape, registration config, device): a miss
builds the CUDA kernels the session's path launches (the ``compile``
stage), a hit reuses them.  ``compile_cache_dir`` attaches the persistent
plan store, so a fresh process skips lowering every plan an earlier run
lowered.

**Recovery.**  ``checkpoint()`` snapshots the scan state (cumulative
deformations, boundary frames, per-pair cost history, telemetry prime)
through :class:`~repro_torch.checkpoint.checkpointer.Checkpointer`, in the
reference's format; ``SeriesSession.restore`` rebuilds a mid-series session
from the latest snapshot on its device and continues feeding.  Eager
PyTorch has no compiled executable to persist for function A, so a restored
process's first feed takes the launcher's one miss; what persists are the
``nvcc`` libraries under ``build/`` (the miss loads them, it does not
compile) and, with ``compile_cache_dir``, the lowered plans.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, device_count, resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core._tree import tree_index, tree_stack
from repro_torch.core.deformation import (
    Deformation,
    compose_batched,
    identity_deformation,
)
from repro_torch.core.engine import (
    SHARDED_MIN_DEVICES,
    dispatch as cost_dispatch,
    get_telemetry,
    op_batchable_from,
    pool_aware_workers,
    release_telemetry,
    scan as engine_scan,
)
from repro_torch.core.registration import (
    RegElement,
    RegistrationConfig,
    RegistrationOperator,
    SeriesRegistrar,
    fused_default,
    register_pair,
)
from repro_torch.runtime.compile_cache import get_compile_cache, set_cache_dir
from repro_torch.runtime.scheduler import get_default_pool
from repro_torch.runtime.tracing import span, timed

#: Function A runs a chunk's pairs in sub-batches of at most this many.  At
#: 1920x1920 f32 one pair's autograd graph (the CPU route) holds a few
#: hundred MB, so 8 pairs stay far below any memory; the card's kernel
#: route holds no graph, and what width suits it is not measured yet.
PAIR_SUB_BATCH = 8


def _register_pairs(pair_fn, cfg: RegistrationConfig, refs: torch.Tensor,
                    tmps: torch.Tensor):
    """Function A on all pairs, in sub-batches of ``PAIR_SUB_BATCH``:
    ``(deformations, iterations, steps, lane_steps, kernel_steps)``, the
    first two batched over the pairs; ``steps`` counts the batched
    gradient steps of every sub-batch and level, ``lane_steps`` each step
    times its sub-batch's width (the lane-steps paid for),
    ``kernel_steps`` the steps the ncc_grad kernels ran."""
    n = int(refs.shape[0])
    outs = []
    for lo in range(0, n, PAIR_SUB_BATCH):
        with span("repro.fnA"):
            outs.append(pair_fn(refs[lo:lo + PAIR_SUB_BATCH],
                                tmps[lo:lo + PAIR_SUB_BATCH], None, cfg))
    defs = {
        k: torch.cat([o.deformation[k] for o in outs], dim=0)
        for k in outs[0].deformation
    }
    iters = torch.cat([o.iterations for o in outs], dim=0)
    steps = sum(o.steps for o in outs)
    lane_steps = sum(o.steps * int(o.iterations.shape[0]) for o in outs)
    kernel_steps = sum(o.kernel_steps for o in outs)
    return defs, iters, steps, lane_steps, kernel_steps


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
    # (``backend`` above is only the last feed's), and the feed's counters
    # of function A, operator B and the scan's tasks (``_ChunkSummary``).
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

    def restore(self, n: int, frames: Dict[int, torch.Tensor]) -> None:
        self._n = n
        self._frames = dict(frames)
        if frames:
            first = next(iter(frames.values()))
            self._hw = tuple(first.shape)
            self.device = first.device


@dataclasses.dataclass
class _ChunkSummary:
    """Retained per-feed reduce summary (recovery / introspection).

    Every field after ``ops`` defaults, so that snapshots written before a
    field existed restore."""

    first_elem: int          # global index of the first element folded in
    n_elems: int
    seconds: float           # scan-stage wall time of this feed
    ops: int                 # operator applications this feed recorded
    backend: str = "none"    # backend the feed's scan ran on
    skipped: int = 0         # guess checks that skipped refinement
    refined: int = 0         # operator applications that refined
    # Function A on the feed's pairs: its ``preprocess`` seconds, the
    # lanes' iterations, the batched gradient steps, the lane-steps
    # they paid for (steps times sub-batch width) and the steps the
    # ncc_grad kernels ran.
    fnA_s: float = 0.0
    pair_iters: int = 0
    fnA_steps: int = 0
    fnA_lane_steps: int = 0
    fnA_kernel_steps: int = 0
    # Operator B (zeros for a composing feed): the refinements' gradient
    # steps and those of them the kernels ran, their thread-seconds, and
    # the thread-seconds of all operator applications.
    refine_iters: int = 0
    refine_kernel_steps: int = 0
    refine_s: float = 0.0
    op_s: float = 0.0
    # The scan's thread-seconds in its pool tasks (phases 1 and 3) and in
    # phase 2; those its threads held no task; the steal takes lost to a
    # neighbour.
    task_s: float = 0.0
    wait_s: float = 0.0
    failed_takes: int = 0


#: The per-feed record's keys (``SeriesResult.feeds``).
_FEED_KEYS = tuple(f.name for f in dataclasses.fields(_ChunkSummary)
                   if f.name not in ("first_elem", "ops"))
#: The operator's counters a refining feed records, read by name.
_OP_COUNTERS = ("skipped", "refined", "refine_iters", "refine_kernel_steps",
                "refine_s", "op_s")


#: The reference's ``_ChunkSummary`` fields: a snapshot's ``summaries`` hold
#: only these, so that the reference can restore it; the port's others go
#: under ``feeds``.
_REFERENCE_SUMMARY_FIELDS = ("first_elem", "n_elems", "seconds", "ops")


def _unflatten_keys(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Rebuild a nested dict from '/'-joined checkpoint leaf keys."""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


_session_ids = itertools.count()


class SeriesSession:
    """One resident series: feed chunks, read results, extend, recover.

    **Thread-safety.**  A series is one ordered stream: concurrent
    ``feed``/``extend`` calls on the *same* session are serialized by an
    internal lock (submit in order from one thread, or route through
    :class:`repro_torch.serving.RegistrationFrontend`, which guarantees
    per-session FIFO).  Many sessions on the shared pool are safe and
    intended.

    **Blocking.**  ``feed``/``result``/``extend``/``checkpoint`` run their
    compute synchronously on the calling thread (plus pool workers) and
    return only when the device work is done.

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
        checkpoint_dir: Optional[str] = None,
        compile_cache_dir: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.cfg = cfg if cfg is not None else RegisterSeriesConfig()
        self.device = resolve_device(device)
        self.id = session_id or f"series{next(_session_ids)}"
        if compile_cache_dir is not None:
            # Attaches the persistent plan store; the in-process callable
            # cache works regardless.
            set_cache_dir(compile_cache_dir)
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
        # This session's view of the process-wide callable cache.
        self._compile: Dict[str, float] = {
            "hits": 0, "misses": 0, "compile_s": 0.0,
        }
        self._backend_used: Optional[str] = None
        self._scan_stats = None
        # Pin the mesh once: every suffix scan of this series runs on the
        # same positions.
        available = device_count(self.device)
        self._devices = max(1, min(
            self.cfg.devices if self.cfg.devices is not None else available,
            available,
        ))
        if self._devices >= SHARDED_MIN_DEVICES:
            from repro_torch.core.engine.sharded import default_mesh

            self._mesh = default_mesh(self._devices, device=self.device)
        else:
            self._mesh = None
        self._pre_seconds = 0.0
        self._pre_pairs = 0
        self._feed_lock = threading.Lock()
        self._closed = False
        self._ckpt = (
            Checkpointer(checkpoint_dir, async_save=False)
            if checkpoint_dir is not None else None
        )

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
        with self._feed_lock, span("repro.feed"):
            with timed("repro.feed.ingest") as stage:
                if not isinstance(chunk, torch.Tensor):
                    chunk = torch.from_numpy(np.array(chunk, dtype=np.float32))
                chunk = chunk.to(dtype=torch.float32, device=self.device)
                self._sync()
            self._timings["ingest"] += stage.seconds
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
            compile_before = self._compile["compile_s"]
            pair_iters = steps = lane_steps = kernel_steps = 0
            if refs.shape[0]:
                launch = self._pair_launcher(int(refs.shape[0]),
                                             tuple(chunk.shape[1:]))
                defs, iters, steps, lane_steps, kernel_steps = launch(refs,
                                                                      tmps)
                self._sync()
                first = self._store.n - 1 if self._store.n else 0
                new_elems = [
                    RegElement(tree_index(defs, i), first + i, first + i + 1)
                    for i in range(int(refs.shape[0]))
                ]
                iters = [int(v) for v in iters.tolist()]
                pair_iters = sum(iters)
                self._pair_iters.extend(iters)
            self._store.append_chunk(chunk)
            dt = time.perf_counter() - t0
            # Build seconds are accounted to their own stage, out of
            # "preprocess" and the telemetry prime derived from it.
            dt_compile = self._compile["compile_s"] - compile_before
            dt -= dt_compile
            self._timings["compile"] += dt_compile
            self._timings["preprocess"] += dt
            if new_elems:
                self._pre_pairs += len(new_elems)
                self._pre_seconds += dt
                self._scan_suffix(new_elems)
                fed = self._summaries[-1]
                fed.fnA_s, fed.pair_iters = dt, pair_iters
                fed.fnA_steps, fed.fnA_lane_steps = steps, lane_steps
                fed.fnA_kernel_steps = kernel_steps
            # O(1) residency: only frame 0 and the boundary frame can be
            # touched by future feeds.
            with span("repro.feed.evict"):
                self._store.evict({0, self._store.n - 1})
        return self

    def _pair_launcher(self, n_pairs: int, hw: tuple):
        """Function A's batched launcher for ``n_pairs`` pairs of ``hw``
        frames, from the process-wide compile cache.

        A miss builds the CUDA kernels this session will launch (function
        A's ``ncc_grad``, the guess check's ``warp_ncc``; once per process,
        on-disk builds are reused), so the build lands in the ``compile``
        stage and not in the first feed.  The live module-level ``register_pair`` is part
        of the key so a swapped implementation never reuses a stale
        launcher."""
        cfg = self.cfg
        needs_ncc = (self.device.type == "cuda" and cfg.refine
                     and cfg.skip_tol is not None
                     and fused_default(self.device, hw, fused=cfg.fused_ncc))
        pair_fn = register_pair

        def build():
            with span("repro.compile"):
                if self.device.type == "cuda":
                    from repro_torch.kernels import ncc_grad

                    ncc_grad.ensure_built()
                if needs_ncc:
                    from repro_torch.kernels import warp_ncc

                    warp_ncc.ensure_built()
                return functools.partial(_register_pairs, pair_fn,
                                         cfg.registration)

        return get_compile_cache().get_compiled(
            ("pair_batch", pair_fn, n_pairs, hw, "float32", cfg.registration,
             str(self.device), needs_ncc),
            build,
            counters=self._compile,
        )

    def _scan_suffix(self, new_elems: List[RegElement]) -> None:
        cfg = self.cfg
        with timed("repro.scan") as stage:
            seed = self._elements[-1] if self._elements else None
            first_elem = len(self._elements)
            ops_before = self.telemetry.calls + self.telemetry.compile_calls
            stats, counts = (), {}
            if not cfg.refine:
                out = self._compose_suffix(new_elems, seed)
                backend_used = cfg.backend or "vector"
            else:
                out, backend_used, op = self._refine_suffix(new_elems, seed)
                # A stand-in for the operator may lack the counters.
                counts = {k: getattr(op, k, 0) for k in _OP_COUNTERS}
                stats = getattr(op, "scan_stats", ())
            self._sync()
            self._backend_used = backend_used
            self._elements.extend(out)
        self._timings["scan"] += stage.seconds
        self._summaries.append(_ChunkSummary(
            first_elem=first_elem,
            n_elems=len(new_elems),
            seconds=stage.seconds,
            ops=self.telemetry.calls + self.telemetry.compile_calls
                - ops_before,
            backend=backend_used,
            task_s=sum(st.task_seconds() for st in stats),
            wait_s=sum(st.wait_time for st in stats),
            failed_takes=sum(st.failed_takes() for st in stats),
            **counts,
        ))

    def _compose_suffix(self, new_elems, seed) -> List[RegElement]:
        """refine=False: exactly-associative pure composition, vectorized —
        one batched engine scan over the chunk, one broadcast seed fold."""
        cfg = self.cfg
        with span("repro.scan.compose"):
            batched = tree_stack([e.deformation for e in new_elems])
            scanned = engine_scan(
                compose_batched,
                batched,
                backend=cfg.backend,
                algorithm=cfg.algorithm,
                workers=cfg.workers,
                devices=self._devices,
                mesh=self._mesh,
            )
            if seed is not None:
                sd = seed.deformation
                scanned = compose_batched(
                    {k: v.expand_as(scanned[k]) for k, v in sd.items()},
                    scanned,
                )
        base_k = len(self._elements) + 1
        return [
            RegElement(tree_index(scanned, i), 0, base_k + i)
            for i in range(len(new_elems))
        ]

    def _refine_suffix(self, new_elems, seed):
        """refine=True: function-B scan of the suffix, seeded with the
        cumulative element, dispatched with pool awareness.  Returns the
        elements, the backend and the feed's operator, which holds the
        feed's counters and the engine's stats of its scan."""
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
                with span("repro.scan.dispatch"):
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
                mesh=self._mesh,
                stats=op.scan_stats,
            )
        if backend_used == "hierarchical":
            if op.scan_stats:  # a one-element feed runs no scan
                self._scan_stats = op.scan_stats[-1]
        elif backend_used == "sharded":
            from repro_torch.core.engine import sharded

            self._scan_stats = sharded.last_stats
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
            feeds=[{k: getattr(s, k) for k in _FEED_KEYS}
                   for s in self._summaries],
        )

    def extend(self, new_frames) -> SeriesResult:
        """Fold a suffix of frames in and return the updated result."""
        self.feed(new_frames)
        return self.result()

    # ------------------------------------------------------------ recovery

    def checkpoint(self) -> int:
        """Snapshot the scan state; returns the step (frames seen).

        The snapshot holds the cumulative deformations, the two resident
        boundary frames, the per-pair cost history and the telemetry
        prime — everything ``restore`` needs to continue the series —
        copied to the host, in the reference's format.
        """
        self._check_open()
        if self._ckpt is None:
            raise ValueError(
                "session was opened without checkpoint_dir; pass one to "
                "open_series(..., checkpoint_dir=...)"
            )
        if not self._elements:
            raise ValueError("nothing to checkpoint: no elements scanned yet")
        m = self._store.n
        state = {
            "cum": tree_stack([e.deformation for e in self._elements]),
            "frame0": self._store[0],
            "last_frame": self._store[m - 1],
            "pair_iters": torch.tensor(self._pair_iters, dtype=torch.int32),
        }
        summaries = [dataclasses.asdict(s) for s in self._summaries]
        meta = {
            "session_id": self.id,
            "n_frames": m,
            "backend": self._backend_used,
            "cfg": dataclasses.asdict(self.cfg),
            "telemetry_name": self.cfg.telemetry_name,
            "telemetry_ema_s": self.telemetry.summary()["ema_s"],
            "timings": dict(self._timings),
            "pre_seconds": self._pre_seconds,
            "pre_pairs": self._pre_pairs,
            "summaries": [
                {k: s[k] for k in _REFERENCE_SUMMARY_FIELDS} for s in summaries
            ],
            "feeds": [
                {k: v for k, v in s.items()
                 if k not in _REFERENCE_SUMMARY_FIELDS}
                for s in summaries
            ],
        }
        self._ckpt.save(m, state, meta)
        self._ckpt.wait()
        return m

    @classmethod
    def restore(
        cls,
        checkpoint_dir: str,
        cfg: Optional[RegisterSeriesConfig] = None,
        *,
        pool=None,
        step: Optional[int] = None,
        device: DeviceLike = None,
        compile_cache_dir: Optional[str] = None,
    ) -> "SeriesSession":
        """Rebuild a mid-series session from its latest (or given) snapshot
        on ``device`` (the card when None; it raises where there is none).

        The restored session resumes exactly where the snapshot left off:
        retained cumulative elements, boundary frames, cost history and a
        re-primed telemetry EMA (per-call imbalance statistics restart
        from scratch).  Snapshots of the reference package restore too.

        ``cfg=None`` rebuilds the config the snapshot was taken under; an
        explicit ``cfg`` must agree on the registration-affecting fields
        (``registration``/``refine``) or restore refuses, since a
        mixed-settings series is silent data corruption.
        """
        ckpt = Checkpointer(checkpoint_dir, async_save=False)
        by_key, meta, _step = ckpt.restore_raw(step=step)
        saved_cfg = meta.get("cfg")
        if saved_cfg is not None:
            stored = RegisterSeriesConfig(
                registration=RegistrationConfig(**saved_cfg["registration"]),
                **{k: v for k, v in saved_cfg.items() if k != "registration"},
            )
            if cfg is None:
                cfg = stored
            elif (cfg.registration, cfg.refine) != (
                stored.registration, stored.refine,
            ):
                raise ValueError(
                    "restore cfg disagrees with the snapshot's "
                    "registration-affecting settings "
                    f"(snapshot: registration={stored.registration}, "
                    f"refine={stored.refine}); resume with cfg=None or "
                    "matching settings"
                )
        self = cls(
            cfg,
            pool=pool,
            session_id=meta["session_id"],
            checkpoint_dir=checkpoint_dir,
            compile_cache_dir=compile_cache_dir,
            device=device,
        )
        dev = self.device

        def on_device(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.array(a)).to(dev)

        m = int(meta["n_frames"])
        # Rebuild the deformation tree generically from the flattened
        # checkpoint keys — the schema belongs to the Deformation type,
        # not to this method (a variant with extra leaves must round-trip).
        cum = _unflatten_keys({
            k[len("cum/"):]: on_device(v)
            for k, v in by_key.items() if k.startswith("cum/")
        })
        self._elements = [
            RegElement(tree_index(cum, i), 0, i + 1) for i in range(m - 1)
        ]
        self._store.restore(m, {
            0: on_device(by_key["frame0"]),
            m - 1: on_device(by_key["last_frame"]),
        })
        self._pair_iters = [int(v) for v in by_key["pair_iters"]]
        self._backend_used = meta.get("backend")
        self._timings.update(meta.get("timings", {}))
        self._pre_seconds = float(meta.get("pre_seconds", 0.0))
        self._pre_pairs = int(meta.get("pre_pairs", 0))
        feeds = meta.get("feeds") or [{}] * len(meta.get("summaries", []))
        self._summaries = [
            _ChunkSummary(**s, **f)
            for s, f in zip(meta.get("summaries", []), feeds)
        ]
        ema = meta.get("telemetry_ema_s") or 0.0
        if ema > 0:
            self.telemetry.record(float(ema))
        return self

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
    checkpoint_dir: Optional[str] = None,
    compile_cache_dir: Optional[str] = None,
    device: DeviceLike = None,
) -> SeriesSession:
    """Open a resident series session on the shared runtime, on the CUDA
    device unless ``device`` says otherwise.

    ``pool``: the :class:`~repro_torch.runtime.scheduler.WorkerPool` to
    execute on (process-wide shared pool by default).  ``checkpoint_dir``
    enables ``session.checkpoint()`` / :meth:`SeriesSession.restore`.
    ``compile_cache_dir`` attaches the persistent plan store there so
    restarts warm-start (:mod:`repro_torch.runtime.compile_cache`).
    """
    return SeriesSession(
        cfg, pool=pool, session_id=session_id, checkpoint_dir=checkpoint_dir,
        compile_cache_dir=compile_cache_dir, device=device,
    )
