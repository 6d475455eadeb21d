"""Sharded series execution across the positions of a mesh (``sharded``).

Port of ``repro/core/engine/sharded.py`` over :mod:`repro_torch.core.spmd`.
One long series runs as one ``spmd.shard_map`` over a 1-D ``("shard",)``
mesh — one position per card by default, or any list of devices with
repeats (several positions on one card, or on the host):

  phase 1  per-shard reduce.  Each position reduces the *core* of its
           static shard; the halo region around every shard boundary is
           split into fixed-size blocks whose partials both neighbours
           compute redundantly (one ppermute halo exchange each way), and
           the stealing protocol decides at run time which side's total
           each block joins: each position, once its core reduce has
           finished on its device, claims blocks from a shared boundary
           :class:`~repro_torch.core.work_stealing._Gap` ledger, so the
           first shard to finish its core drains more of the no-man's-land
           — the paper's Algorithm-1 greedy loop promoted to the device
           level.
  phase 2  cross-shard *round-efficient exclusive scan* over the shard
           totals: the Träff 2025 exscan schedule
           (``core/circuits.exscan_circuit`` lowered through
           ``lower_collective(..., registers=2)``) — exactly
           ceil(log2 positions) ppermute rounds, no shift round.
  phase 3  seeded local scan: every position folds seed + exclusive prefix
           into one scan of the rows it claimed; outputs for rows a
           neighbour claimed come back over one overhang ppermute.  Where
           the packed op has a kernel form and the positions are on the
           card (the dispatcher's ``engine._accel_for`` rule) this is one
           ``lookback_scan`` launch a position, the flag-lane row as the
           ``decoupled`` backend runs it; otherwise the plain doubling scan.

Everything runs in the packed + identity-flag domain of
``kernels/_tiling`` (one ``(rows, D+1)`` tensor a position), which makes
``where=`` masks, seeds, tail padding and the exscan's identity
initialisation uniform — and makes any claim outcome value-exact for
exactly-associative operators: claims move *grouping boundaries* only,
never element order.

The claim protocol is deadlock-free by construction: claim attempts never
block (single ``_Gap``-lock critical sections), and the final block
partition is read only after a neighbour token exchange (a ppermute, which
every position enters only after its own claim loop) proves both drainers
of each adjacent gap have finished.  ``finalize`` then assigns any
unclaimed remainder deterministically, so lost claims degrade balance,
never correctness.

What the reference needs and the port does not: its ``_LedgerSlot`` and
``_fn_cache`` exist because a traced, cached executable cannot hold a
fresh ledger a call (the callbacks close over a mutable slot).  An eager
body is built a call and takes its call's ledger directly, so there is
nothing to cache.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.analysis.sync import sync_point
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
from repro_torch.kernels.lookback_scan import doubling_scan, lookback_scan

from .. import spmd
from .._tree import tree_map

Op = Callable[[Any, Any], Any]

AXIS = "shard"

#: Smallest per-position shard (rows) for which boundary stealing is
#: enabled: below this the halo blocks would be single rows and the claim
#: traffic costs more than the imbalance it removes.
MIN_STEAL_SHARD = 16

#: Default number of boundary blocks per shard gap (must be even: half the
#: blocks come from each neighbour's static side).
DEFAULT_GAP_BLOCKS = 4


# ---------------------------------------------------------------------------
# host-side boundary ledger
# ---------------------------------------------------------------------------


class BoundaryLedger:
    """Shared-``_Gap`` claim ledger for the D-1 shard boundaries.

    Gap ``g`` (between shards ``g`` and ``g+1``) holds ``blocks`` claimable
    block indices ``[0, blocks)``; ``border = blocks // 2`` marks the static
    shard boundary inside it.  Shard ``g`` drains from the left
    (``take_left``), shard ``g+1`` from the right (``take_right``), so the
    final partition is always a prefix/suffix split.  Claims past the border
    count as cross-shard steals, mirroring ``_Gap.border`` accounting in the
    thread-level protocol.
    """

    def __init__(self, num_gaps: int, blocks: int):
        from ..work_stealing import _Gap

        self.blocks = blocks
        self.border = blocks // 2  # analysis: allow[THR002] ctor precedes publication
        self.gaps = [_Gap(0, blocks, border=self.border) for _ in range(num_gaps)]
        self.arrival: Dict[int, float] = {}   # shard -> core-finish host time
        self.cross_steals = 0
        self.forced = 0
        self.finalized = [False] * num_gaps
        self._lock = threading.Lock()

    def _neighbour_rate_locked(self, shard: int, now: float) -> float:
        """Arrival-time proxy for a neighbour's sec/op rate: a shard that has
        not reached its boundary yet is the straggler (large rate).  Caller
        holds ``_lock`` (the ``arrival`` map is lock-guarded)."""
        t = self.arrival.get(shard)
        if t is None:
            return float("inf")
        return max(now - t, 0.0)

    def attempt(self, shard: int) -> int:
        """One greedy claim attempt by ``shard`` (Algorithm-1 step at the
        device level).  Returns the number of blocks claimed (0 or 1)."""
        from ..work_stealing import _steal_direction

        d = int(shard)
        now = time.monotonic()
        with self._lock:
            sync_point("shard.gap.seat", "write",
                       var="shard.ledger", lock="shard.ledger.lock")
            if d not in self.arrival:
                self.arrival[d] = now
            rate_l = self._neighbour_rate_locked(d - 1, now)
            rate_r = self._neighbour_rate_locked(d + 1, now)
        lg = self.gaps[d - 1] if d >= 1 else None
        rg = self.gaps[d] if d < len(self.gaps) else None
        size_l = lg.size() if lg is not None else 0
        size_r = rg.size() if rg is not None else 0
        if size_l <= 0 and size_r <= 0:
            return 0
        side = _steal_direction(rate_l, rate_r, size_l, size_r)
        if side == "L":
            idx = lg.take_right()
            cross = idx is not None and idx < self.border
        else:
            idx = rg.take_left()
            cross = idx is not None and idx >= self.border
        if idx is None:
            return 0
        with self._lock:
            sync_point("shard.gap.claim", "write",
                       var="shard.ledger", lock="shard.ledger.lock")
            if cross:
                self.cross_steals += 1
        return 1

    def _finalize_gap(self, g: int) -> None:
        """Deterministically assign any unclaimed remainder (idempotent).

        Reached when both drainers have proven (token exchange) they spent
        their claim budgets and blocks are left: give the remainder to the
        left side.  Any consistent split is value-correct; only balance
        degrades.
        """
        if g < 0 or g >= len(self.gaps):
            return
        with self._lock:
            sync_point("shard.gap.finalize", "read",
                       var="shard.ledger", lock="shard.ledger.lock")
            if self.finalized[g]:
                return
        gap = self.gaps[g]
        while gap.take_left() is not None:
            with self._lock:
                self.forced += 1
        with self._lock:
            sync_point("shard.gap.finalize", "write",
                       var="shard.ledger", lock="shard.ledger.lock")
            self.finalized[g] = True

    def claims(self, shard: int) -> np.ndarray:
        """Final (k_left, k_right) for ``shard`` — blocks of its left/right
        gap owned by the gap's *left* side.  Virtual edge gaps report the
        static border.  Call only after the neighbour token exchange."""
        d = int(shard)
        with self._lock:
            already = (d - 1 < 0 or self.finalized[d - 1]) and (
                d >= len(self.gaps) or self.finalized[d]
            )
        if not already:
            self._finalize_gap(d - 1)
            self._finalize_gap(d)
        kl = self.gaps[d - 1].taken_left if d >= 1 else self.border
        kr = self.gaps[d].taken_left if d < len(self.gaps) else self.border
        return np.asarray([kl, kr], dtype=np.int32)

    def claim_counts(self) -> List[Tuple[int, int]]:
        return [(g.taken_left, g.taken_right) for g in self.gaps]


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedStats:
    """Telemetry of the most recent sharded execution."""

    devices: int
    n: int
    shard_rows: int            # padded rows per position
    halo: int                  # halo rows each side of a boundary
    gap_blocks: int            # claimable blocks per boundary gap
    phase2_rounds: int         # executed exscan ppermute rounds
    phase2_algorithm: str
    boundary_claims: List[Tuple[int, int]]  # per gap: (left, right) blocks
    cross_steals: int          # blocks claimed past the static border
    forced_blocks: int         # remainder blocks assigned by finalize
    stealing: bool
    phase_seconds: Dict[str, float]
    phase3_route: str          # "lookback_scan" (kernel) or "plain"


#: Stats of the most recent ``sharded`` execution (None before the first).
last_stats: Optional[ShardedStats] = None


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def _shard_geometry(
    n: int, devices: int, num_blocks: Optional[int] = None
) -> Tuple[int, int, int, int]:
    """(padded_n, rows_per_shard, halo, gap_blocks) for an n-row series."""
    k = -(-n // devices)  # ceil
    n_pad = k * devices
    if k < MIN_STEAL_SHARD:
        return n_pad, k, 0, 0
    blocks = int(num_blocks) if num_blocks else DEFAULT_GAP_BLOCKS
    blocks = max(2, blocks - (blocks % 2))
    bs = max(1, k // (2 * blocks))
    halo = (blocks // 2) * bs
    return n_pad, k, halo, blocks


def default_mesh(devices: Optional[int] = None, device=None) -> spmd.Mesh:
    """1-D mesh over ``device``'s kind (the card when None): on CUDA one
    position a card, the first ``devices`` of them (all by default); on
    the CPU ``devices`` positions (1 by default), all on the host — the
    counterpart of XLA's virtual host devices."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        avail = torch.cuda.device_count()
        d = avail if devices is None else min(int(devices), avail)
        return spmd.Mesh([torch.device("cuda", i) for i in range(d)], (AXIS,))
    d = 1 if devices is None else int(devices)
    return spmd.Mesh([dev] * d, (AXIS,))


# ---------------------------------------------------------------------------
# the shard body
# ---------------------------------------------------------------------------


def _id_row(width: int, dtype, device) -> torch.Tensor:
    """The lifted-monoid identity: zero values, identity flag 1."""
    row = torch.zeros((1, width), dtype=dtype, device=device)
    row[0, -1] = 1.0
    return row


def _fold_blocks(pop: Op, x3: torch.Tensor) -> torch.Tensor:
    """Left-to-right fold of each (m, w) block of ``x3`` (b, m, w) into a
    (b, w) row: pairwise, ceil(log2 m) batched applications, order kept."""
    b, m, w = x3.shape
    y = x3
    while m > 1:
        h = m // 2
        pairs = pop(y[:, 0:2 * h:2].reshape(-1, w),
                    y[:, 1:2 * h:2].reshape(-1, w)).reshape(b, h, w)
        y = torch.cat([pairs, y[:, 2 * h:]], dim=1) if m % 2 else pairs
        m = y.shape[1]
    return y[:, 0]


def _seeded_scan(pop: Op, rows: torch.Tensor, seed_row: torch.Tensor,
                 kernel: bool) -> torch.Tensor:
    """Inclusive scan of ``rows`` (m, w) with ``seed_row`` folded in front:
    one ``lookback_scan`` (the seed as its exclusive prefix) or the plain
    doubling scan."""
    m = rows.shape[0]
    if kernel:
        t = (default_num_tiles_cuda(m) if rows.is_cuda
             else default_num_tiles(m))
        padded, _ = pad_rows(rows, t)
        y, _status, _aggs, _prefs = lookback_scan(pop, padded, t,
                                                  seed=seed_row)
        return y[:m]
    scanned = doubling_scan(pop, rows[None])[0]
    return pop(seed_row.expand_as(scanned), scanned)


def _reach_boundary(core: torch.Tensor) -> None:
    """Wait until the core reduce has finished on its device: the "I
    reached my boundary" signal that starts the claim loop."""
    if core.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(core.device))
        done.synchronize()


def _shard_body(pop: Op, p: int, k: int, halo: int, blocks: int,
                ledger: Optional[BoundaryLedger], kernel: bool):
    """The body every position runs on its (k, width) rows."""
    from ..distributed import exclusive_collective_scan

    bs = (2 * halo) // blocks if blocks else 0
    fwd = [(i, i + 1) for i in range(p - 1)]   # send right
    bwd = [(i + 1, i) for i in range(p - 1)]   # send left

    def body(x, seed_row):
        my = spmd.axis_index(AXIS)
        ident = _id_row(x.shape[1], x.dtype, x.device)
        if halo == 0:
            # Degenerate geometry: no boundary gaps, static shards only.
            total = _fold_blocks(pop, x[None])
            e = exclusive_collective_scan(pop, total, AXIS, axis_size=p,
                                          init=ident)
            return _seeded_scan(pop, x, pop(seed_row, e), kernel)

        # --- halo exchange: left gap rows = neighbour tail + own head -----
        from_left = spmd.ppermute(x[k - halo:], AXIS, perm=fwd)
        from_right = spmd.ppermute(x[:halo], AXIS, perm=bwd)
        ext = torch.cat([from_left, x, from_right], dim=0)

        # --- phase 1: core reduce + redundant boundary-block partials -----
        core = _fold_blocks(pop, ext[2 * halo: k][None])
        bp_left = _fold_blocks(pop, ext[: 2 * halo].reshape(blocks, bs, -1))
        bp_right = _fold_blocks(pop, ext[k: k + 2 * halo].reshape(blocks, bs, -1))

        if ledger is not None:
            # Claim loop: ``blocks`` attempts once the core reduce is done.
            # One budget covers both adjacent gaps: a straggler's neighbour
            # can still claim a whole shared gap (all its attempts steer to
            # one side), and any blocks left when both budgets are spent
            # fall to the deterministic finalize — balance, not correctness.
            _reach_boundary(core)
            got = sum(ledger.attempt(my) for _ in range(blocks))
            # Token exchange: every position enters it after its claim loop,
            # so once through, both drainers of each adjacent gap are done.
            token = torch.tensor([got])
            spmd.ppermute(token, AXIS, perm=fwd)
            spmd.ppermute(token, AXIS, perm=bwd)
            kl, kr = (int(v) for v in ledger.claims(my))
        else:
            kl = kr = blocks // 2

        # --- assemble this shard's total over its claimed range -----------
        acc = ident
        for j in range(kl, blocks):
            acc = pop(acc, bp_left[j: j + 1])
        acc = pop(acc, core)
        for j in range(kr):
            acc = pop(acc, bp_right[j: j + 1])

        # --- phase 2: Träff exscan over shard totals ----------------------
        e = exclusive_collective_scan(pop, acc, AXIS, axis_size=p, init=ident)

        # --- phase 3: seeded scan of the claimed range --------------------
        # Extended rows [lo, hi) are this shard's after the claims; the
        # reference scans all of them with the rest flagged identity (a
        # static shape), the port scans the slice.
        lo, hi = kl * bs, k + kr * bs
        scanned = _seeded_scan(pop, ext[lo:hi], pop(seed_row, e), kernel)
        out_ext = torch.cat([ext[:lo], scanned, ext[hi:]], dim=0)

        # --- overhang exchange: rows a neighbour scanned ------------------
        recv_l = spmd.ppermute(out_ext[k + halo:], AXIS, perm=fwd)
        recv_r = spmd.ppermute(out_ext[:halo], AXIS, perm=bwd)
        cut_l, cut_r = max(lo - halo, 0), min(hi - halo, k)
        return torch.cat([recv_l[:cut_l], out_ext[halo + cut_l: halo + cut_r],
                          recv_r[cut_r - (k - halo):]], dim=0)

    return body


def _phase3_kernel(op, xs, mesh: spmd.Mesh) -> bool:
    """The dispatcher's rule: the op has a kernel form for these rows and
    every position is on the card."""
    from . import _accel_for

    return (_accel_for(op, xs, False)
            and all(d.type == "cuda" for d in mesh.devices))


# ---------------------------------------------------------------------------
# backend entry point
# ---------------------------------------------------------------------------


def exec_sharded(
    op: Op,
    plan,
    xs,
    *,
    devices: Optional[int] = None,
    mesh: Optional[spmd.Mesh] = None,
    num_blocks: Optional[int] = None,
    seed: Any = None,
    where=None,
    stealing: bool = True,
    **_,
) -> Tuple[Any, Any]:
    """Multi-position sharded scan; returns ``(ys, total=None)``.

    ``plan`` is ignored: the cross-shard phase always runs the Träff exscan
    schedule (that round-efficiency is the point of the backend).
    ``mesh`` pins the mesh (sessions build one per series); ``devices``
    caps the mesh size when no mesh is given (:func:`default_mesh` on the
    data's device kind).
    """
    from ..circuits import exscan_num_rounds
    from .decoupled_backend import stack_elements

    global last_stats

    if isinstance(xs, list):
        stacked = stack_elements(xs)
        if stacked is None:
            raise ValueError(
                "sharded backend needs stackable array elements; got a list "
                "the operator cannot be batched over — use "
                "element/worksteal/hierarchical"
            )
        ys, total = exec_sharded(
            op, plan, stacked, devices=devices, mesh=mesh,
            num_blocks=num_blocks, seed=seed, where=where, stealing=stealing,
        )
        return [tree_map(lambda t, i=i: t[i], ys) for i in range(len(xs))], total

    t0 = time.perf_counter()
    x2, spec = pack_leaves(xs)
    n = x2.shape[0]
    if where is not None and len(where) != n:
        raise ValueError(f"where mask length {len(where)} != n {n}")
    # Identity-flag lane: where= masks and tail padding ride along.
    x2 = add_flag_lane(x2, where)
    if mesh is None:
        mesh = default_mesh(devices, device=x2.device)
    p = mesh.shape[AXIS]
    width = x2.shape[1]

    n_pad, k, halo, blocks = _shard_geometry(n, p, num_blocks)
    if n_pad != n:
        pad = _id_row(width, x2.dtype, x2.device).expand(n_pad - n, width)
        x2 = torch.cat([x2, pad], dim=0)
    if seed is not None:
        seed_row = torch.cat([pack_element(seed, spec).to(x2.device),
                              x2.new_zeros((1,))])[None]
    else:
        seed_row = _id_row(width, x2.dtype, x2.device)

    steal = bool(stealing) and halo > 0 and p > 1
    kernel = _phase3_kernel(op, xs, mesh)
    ledger = BoundaryLedger(p - 1, blocks) if steal else None
    body = _shard_body(lift_masked(packed_op(op, spec)), p, k, halo, blocks,
                       ledger, kernel)
    fn = spmd.shard_map(body, mesh, in_specs=(spmd.P(AXIS), spmd.P()),
                        out_specs=spmd.P(AXIS))

    t1 = time.perf_counter()
    y2 = fn(x2, seed_row)
    if y2.is_cuda:
        torch.cuda.synchronize(y2.device)
    t2 = time.perf_counter()

    ys = unpack_leaves(y2[:n, :-1], spec)
    last_stats = ShardedStats(
        devices=p,
        n=n,
        shard_rows=k,
        halo=halo,
        gap_blocks=blocks,
        phase2_rounds=exscan_num_rounds(p),
        phase2_algorithm="exscan",
        boundary_claims=ledger.claim_counts() if ledger else [],
        cross_steals=ledger.cross_steals if ledger else 0,
        forced_blocks=ledger.forced if ledger else 0,
        stealing=steal,
        phase_seconds={
            "setup": t1 - t0,
            "execute": t2 - t1,
            "unpack": time.perf_counter() - t2,
        },
        phase3_route="lookback_scan" if kernel else "plain",
    )
    return ys, None


from .backends import register_backend  # noqa: E402  (import cycle: registry)

register_backend("sharded", exec_sharded)
