"""Discrete-event simulator for distributed/hierarchical/work-stealing scans.

The paper evaluates on up to 6144 Haswell cores; this container has one CPU.
The simulator executes the *same circuits* (circuits.py) and the *same
Algorithm 1* (work_stealing.py) in deterministic virtual time, with per-op
costs drawn from the paper's microbenchmark distributions:

  * constant cost t                      (paper Fig. 8a)
  * Exponential(lambda = 1/t)            (paper Fig. 8b/8c)
  * empirical registration costs         (measured from core/registration.py)

Costs are drawn from a Mersenne-Twister generator with seed 1410 — the exact
PRNG/seed the paper uses — and, as in the paper, static and stealing runs
consume the generator identically so comparisons are valid.

The simulator is what backs benchmarks/bench_strong_scaling.py (Table 3),
bench_hierarchical.py (Table 4), bench_work_energy.py (Table 5) and
bench_weak_scaling.py (Fig. 10).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import List, Optional, Tuple

import numpy as np

from .circuits import Circuit, get_circuit, get_exscan_circuit
from .engine.plan import get_plan


# ---------------------------------------------------------------------------
# Cost models
# ---------------------------------------------------------------------------


def constant_costs(n: int, t: float = 1.0) -> np.ndarray:
    return np.full(n, t, dtype=np.float64)


def exponential_costs(n: int, mean: float = 1.0, seed: int = 1410) -> np.ndarray:
    """Exponential(lambda=1/mean) via MT19937(1410), as in paper §5.1."""
    rng = np.random.Generator(np.random.MT19937(seed))
    return rng.exponential(scale=mean, size=n)


def registration_like_costs(n: int, seed: int = 1410) -> np.ndarray:
    """Heavy-tailed mixture resembling paper Fig. 5a: ~10 s typical, 30 s
    outliers (lognormal body + occasional restarts of the minimiser)."""
    rng = np.random.Generator(np.random.MT19937(seed))
    base = rng.lognormal(mean=math.log(8.0), sigma=0.35, size=n)
    outlier = rng.random(n) < 0.04
    base[outlier] *= rng.uniform(2.0, 3.5, size=int(outlier.sum()))
    return base


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Per-message cost for the global phase.  The paper's operator payload is
    20 bytes — latency dominates; defaults approximate Cray Aries.

    ``noise``: multiplicative per-operator system noise (OS jitter, MPI
    progression, cache effects).  Deep dependency chains across many ranks
    accumulate max-of-noise — the mechanism that degrades the paper's flat
    1024-rank scans and that a noise-free model cannot show.  Sampled
    deterministically (MT19937) so static/stealing comparisons stay valid.
    """

    latency: float = 2e-6         # seconds per message
    bandwidth: float = 10e9       # bytes/s
    msg_bytes: int = 20
    bcast_factor: float = 2.0     # multicast rounds cost ~log(fanout) more
    noise: float = 0.15           # lognormal sigma per op application

    def msg_time(self) -> float:
        return self.latency + self.msg_bytes / self.bandwidth

    def bcast_time(self, fanout: int) -> float:
        return self.msg_time() * max(1.0, self.bcast_factor * math.log2(max(fanout, 2)))

    def noise_stream(self, n: int, seed: int = 997) -> np.ndarray:
        if self.noise <= 0:
            return np.ones(n)
        rng = np.random.Generator(np.random.MT19937(seed))
        return rng.lognormal(mean=0.0, sigma=self.noise, size=n)


@dataclasses.dataclass
class SimResult:
    makespan: float
    work: int                     # exact operator applications
    phase1_end: float
    global_end: float
    busy: np.ndarray              # per-worker busy seconds
    energy: float = 0.0
    cross_steals: int = 0         # elements claimed across segment borders
    phase2_rounds: int = 0        # communication rounds the phase-2 schedule
    # executes on the wire: the plan's rounds, +1 for the exclusive shift
    # every *inclusive* algorithm pays in the distributed lowering
    # (``distributed.exclusive_shift``).  ``algorithm="exscan"`` needs no
    # shift — its count must match ``distributed.last_exscan_rounds()``.

    def efficiency(self, serial_time: float, workers: int) -> float:
        return serial_time / (self.makespan * workers) if self.makespan else 0.0


# ---------------------------------------------------------------------------
# Phase 1: local reduction — static or work-stealing (virtual-time Algorithm 1)
# ---------------------------------------------------------------------------


def _simulate_static_reduce(
    costs: np.ndarray, bounds: List[Tuple[int, int]]
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Each worker reduces its fixed segment; returns (finish, busy, ops)."""
    t = len(bounds)
    finish = np.zeros(t)
    ops = 0
    for i, (lo, hi) in enumerate(bounds):
        finish[i] = costs[lo : hi + 1].sum()
        ops += max(0, hi - lo)  # K-1 combines; first element is free init
    return finish, finish.copy(), ops


def _simulate_stealing_reduce(
    costs: np.ndarray, num_threads: int
) -> Tuple[np.ndarray, np.ndarray, int, List[Tuple[int, int]]]:
    """Virtual-time replica of Algorithm 1 over one node's threads.

    Event-driven: pop the thread that becomes free earliest; it greedily takes
    an element from the gap toward its slower neighbour.
    """
    n = len(costs)
    t = num_threads
    if t == 1:
        tot = costs.sum()
        return np.array([tot]), np.array([tot]), n - 1, [(0, n - 1)]
    seg = n / t
    starts = [0] + [int(i * seg + seg / 2) for i in range(1, t - 1)] + [n - 1]
    for i in range(1, t):
        starts[i] = max(starts[i], starts[i - 1] + 1)
    gaps: List[List[int]] = [[0, 0] for _ in range(t + 1)]  # [lo, hi)
    for i in range(1, t):
        gaps[i] = [starts[i - 1] + 1, starts[i]]
    busy = np.zeros(t)
    ops = np.zeros(t, dtype=np.int64)
    pl = list(starts)
    pr = list(starts)
    # Heap of (time_free, tid); initial work = processing own start element.
    heap = [(float(costs[starts[i]]), i) for i in range(t)]
    for i in range(t):
        busy[i] = costs[starts[i]]
    heapq.heapify(heap)
    finish = np.zeros(t)
    while heap:
        now, tid = heapq.heappop(heap)
        lg, rg = gaps[tid], gaps[tid + 1]
        ls, rs = lg[1] - lg[0], rg[1] - rg[0]
        if ls <= 0 and rs <= 0:
            finish[tid] = now
            continue
        if ls > 0 and rs > 0:
            rate_l = busy[tid - 1] / max(ops[tid - 1], 1)
            rate_r = busy[tid + 1] / max(ops[tid + 1], 1)
            d = "L" if rate_l > rate_r else "R"
        else:
            d = "L" if ls > 0 else "R"
        if d == "L":
            lg[1] -= 1
            idx = lg[1]
            pl[tid] = idx
        else:
            idx = rg[0]
            rg[0] += 1
            pr[tid] = idx
        c = float(costs[idx])
        busy[tid] += c
        ops[tid] += 1
        heapq.heappush(heap, (now + c, tid))
    return finish, busy, int(ops.sum()) + 0, list(zip(pl, pr))


def _simulate_cross_stealing_reduce(
    costs: np.ndarray, num_segments: int, threads: int
) -> Optional[Tuple[List[np.ndarray], List[np.ndarray], int,
                    List[List[Tuple[int, int]]], int]]:
    """Virtual-time twin of the *cross-segment* stealing protocol
    (``engine/hierarchical.py``): S segments x T threads, shared
    inter-segment gaps between the edge workers of neighbouring segments,
    and — exactly as on the host — direction choice at a shared gap driven
    by the neighbouring *segment's* observed seconds-per-op instead of a
    single thread's.  The seating geometry is the host's own
    ``work_stealing.cross_start_positions``; like the host, infeasible
    seating (too few elements) returns None and the caller falls back to
    static segments.

    Returns per-segment (finish, busy) worker arrays, total operator
    applications, per-segment global [pl, pr] thread boundaries, and the
    number of elements claimed across segment borders.
    """
    from .work_stealing import _steal_direction, cross_start_positions

    n = len(costs)
    s = num_segments
    per = n // s
    bounds = [(i * per, (i + 1) * per - 1) for i in range(s)]
    tcounts = [max(1, min(threads, (hi - lo + 1) // 2)) for lo, hi in bounds]
    starts = cross_start_positions(bounds, tcounts, n)
    if starts is None:
        return None
    w = len(starts)
    offs = [0]
    seg_of: List[int] = []
    for i, tc in enumerate(tcounts):
        seg_of += [i] * tc
        offs.append(offs[-1] + tc)
    gaps: List[List[int]] = [[0, 0] for _ in range(w + 1)]
    for i in range(1, w):
        gaps[i] = [starts[i - 1] + 1, starts[i]]
    busy = np.zeros(w)
    ops = np.zeros(w, dtype=np.int64)
    seg_busy = np.zeros(s)
    seg_ops = np.zeros(s, dtype=np.int64)
    pl = list(starts)
    pr = list(starts)
    heap = [(float(costs[starts[i]]), i) for i in range(w)]
    for i in range(w):
        busy[i] = costs[starts[i]]
    heapq.heapify(heap)
    finish = np.zeros(w)
    cross = 0

    def seg_rate(j: int) -> float:
        # Host semantics: 0.0 while unobserved (no completed application).
        return seg_busy[j] / seg_ops[j] if seg_ops[j] else 0.0

    def thread_rate(v: int) -> float:
        return busy[v] / ops[v] if ops[v] else 0.0

    while heap:
        now, wid = heapq.heappop(heap)
        si = seg_of[wid]
        first = wid == offs[si]
        last = wid == offs[si + 1] - 1
        lg, rg = gaps[wid], gaps[wid + 1]
        ls, rs = lg[1] - lg[0], rg[1] - rg[0]
        if ls <= 0 and rs <= 0:
            finish[wid] = now
            continue
        # The host's own rule — including the larger-gap tie-break while
        # both rates are unobserved — so the twin cannot drift from it.
        # Empty-side rates stay 0.0 (the global edges have no neighbour
        # segment to read).
        rate_l = 0.0 if ls <= 0 else (
            seg_rate(si - 1) if first else thread_rate(wid - 1)
        )
        rate_r = 0.0 if rs <= 0 else (
            seg_rate(si + 1) if last else thread_rate(wid + 1)
        )
        d = _steal_direction(rate_l, rate_r, ls, rs)
        # As on the host: a cross steal is a shared-gap claim that landed
        # beyond the *static* border, not any drain of the no-man's-land.
        if d == "L":
            lg[1] -= 1
            idx = lg[1]
            pl[wid] = idx
            if first and si > 0 and idx < bounds[si][0]:
                cross += 1
        else:
            idx = rg[0]
            rg[0] += 1
            pr[wid] = idx
            if last and si < s - 1 and idx >= bounds[si + 1][0]:
                cross += 1
        c = float(costs[idx])
        busy[wid] += c
        ops[wid] += 1
        seg_busy[si] += c
        seg_ops[si] += 1
        heapq.heappush(heap, (now + c, wid))
    fin_per = [finish[offs[i]: offs[i + 1]] for i in range(s)]
    busy_per = [busy[offs[i]: offs[i + 1]] for i in range(s)]
    bnds_per = [
        list(zip(pl[offs[i]: offs[i + 1]], pr[offs[i]: offs[i + 1]]))
        for i in range(s)
    ]
    return fin_per, busy_per, int(ops.sum()), bnds_per, cross


# ---------------------------------------------------------------------------
# Global phase: circuit execution over ranks in virtual time
# ---------------------------------------------------------------------------


def _simulate_circuit(
    circuit: Circuit,
    avail: np.ndarray,
    op_cost: float,
    net: NetworkModel,
    mask: Optional[List[bool]] = None,
) -> Tuple[np.ndarray, int]:
    """Run a prefix circuit over P ranks: returns (per-rank ready time, ops).

    The circuit is lowered to a precompiled plan (engine.plan, LRU-cached):
    identity combines are already moves, and each primitive carries the
    multicast fanout of its source wire.  A combine at dst waits for both
    operands (the ``comm_src`` operand arrives after a message); each op
    application carries multiplicative system noise (NetworkModel).

    ``mask`` marks identity-initialised wires (the exscan circuit's
    e registers) so their first touch compiles to a move, exactly as the
    real collective lowering compiles it."""
    plan = get_plan(circuit, mask=mask)
    ready = avail.astype(np.float64).copy()
    ops = 0
    noise = net.noise_stream(sum(len(r) for r in circuit.rounds) + 1)
    n_i = 0
    for rnd in plan.rounds:
        writes = []
        for a, b, out, fan, cs in rnd.combines:
            comm = net.bcast_time(fan) if fan > 1 else net.msg_time()
            ops += 1
            c_op = op_cost * noise[n_i]; n_i += 1
            t_a = ready[a] + (comm if cs == a else 0.0)
            t_b = ready[b] + (comm if cs == b else 0.0)
            writes.append((out, max(t_a, t_b) + c_op))
        for src, out, fan in rnd.moves:
            comm = net.bcast_time(fan) if fan > 1 else net.msg_time()
            writes.append((out, ready[src] + comm))
        for d, tr in writes:
            ready[d] = tr
    return ready, ops


# ---------------------------------------------------------------------------
# End-to-end distributed scan simulation (paper §4.1/§4.2/§4.3)
# ---------------------------------------------------------------------------


def simulate_distributed_scan(
    costs: np.ndarray,
    *,
    ranks: int,
    threads: int = 1,
    algorithm: str = "ladner_fischer",
    stealing: bool = False,
    cross_stealing: bool = False,
    strategy: str = "reduce_then_scan",
    net: NetworkModel = NetworkModel(),
    apply_costs: Optional[np.ndarray] = None,
    preprocess_costs: Optional[np.ndarray] = None,
    idle_power: float = 80.0,
    busy_power: float = 280.0,
) -> SimResult:
    """Simulate one distributed scan over N = len(costs) elements.

    ``ranks`` x ``threads`` workers (threads>1 => hierarchical scan §4.2;
    stealing=True => dynamic hierarchical scan §4.3; cross_stealing=True
    additionally shares the inter-rank boundary gaps so a finished rank's
    edge workers steal from a straggler neighbour — the host protocol of
    ``engine/hierarchical.py``).  ``apply_costs`` are the phase-3
    per-element costs (defaults to ``costs``); ``preprocess_costs`` models
    the massively-parallel function-A step of *full registration*.
    """
    n = len(costs)
    p = ranks
    total_workers = ranks * threads
    per_rank = n // p
    if per_rank * p != n:
        raise ValueError(f"N={n} must divide ranks={p}")
    apply_costs = costs if apply_costs is None else apply_costs
    work = 0
    busy = np.zeros(total_workers)

    # Optional massively-parallel preprocessing (function A), flat split.
    t_pre = np.zeros(p)
    if preprocess_costs is not None:
        per_w = n / total_workers
        wbusy = np.zeros(total_workers)
        for w in range(total_workers):
            lo, hi = int(w * per_w), int((w + 1) * per_w)
            wbusy[w] = preprocess_costs[lo:hi].sum()
        busy += wbusy
        t_pre = wbusy.reshape(p, threads).max(axis=1)
        work += n

    # ---- Phase 1: local reduction per rank (over `threads` workers).
    # ``rank_results`` carries (per-worker finish, busy, GLOBAL boundaries)
    # per rank, whether the reduce ran rank-local or as one cross-rank
    # stealing pass over shared boundary gaps.
    rank_ready = np.zeros(p)
    boundaries_per_rank: List[List[Tuple[int, int]]] = []
    cross_count = 0
    rank_results = None
    if cross_stealing and stealing and p > 1:
        cross_res = _simulate_cross_stealing_reduce(costs, p, threads)
        if cross_res is not None:  # None: infeasible seating, host falls
            fin_per, busy_per, cops, bnds_per, cross_count = cross_res
            work += cops           # back to static segments — so do we
            rank_results = list(zip(fin_per, busy_per, bnds_per))
    if rank_results is None:
        rank_results = []
        for r in range(p):
            seg = costs[r * per_rank : (r + 1) * per_rank]
            if stealing and threads > 1:
                fin, b, ops, bnds = _simulate_stealing_reduce(seg, threads)
            else:
                if threads > 1:
                    tb = [
                        (i * per_rank // threads,
                         (i + 1) * per_rank // threads - 1)
                        for i in range(threads)
                    ]
                else:
                    tb = [(0, per_rank - 1)]
                fin, b, ops = _simulate_static_reduce(seg, tb)
                bnds = tb
            work += ops
            off = r * per_rank
            rank_results.append(
                (fin, b, [(lo + off, hi + off) for lo, hi in bnds])
            )
    for r, (fin, b, bnds) in enumerate(rank_results):
        boundaries_per_rank.append(bnds)
        busy[r * threads : r * threads + len(b)] += b
        # Hierarchical: local circuit scan over the T thread partials (§4.2).
        if len(fin) > 1:
            local_circ = get_circuit("dissemination", len(fin))
            local_net = NetworkModel(latency=1e-7, bandwidth=100e9, msg_bytes=net.msg_bytes)
            ready, lops = _simulate_circuit(
                local_circ, fin, float(np.median(costs)), local_net
            )
            work += lops
            rank_ready[r] = ready.max()
        else:
            rank_ready[r] = fin.max()
    rank_ready += t_pre

    # ---- Phase 2: global circuit scan over P rank partials.
    exscan = algorithm == "exscan"
    if exscan:
        # Träff round-efficient exclusive scan: 2 registers per rank
        # (e = exclusive prefix on wires [0, p), s = window sum on
        # [p, 2p)), both resident on rank ``w % p`` — exactly the layout
        # ``lower_collective(..., registers=2)`` executes on devices.
        # The e registers start as identity (mask), s as the rank partial.
        circ = get_exscan_circuit(p)
        gready, gops = _simulate_circuit(
            circ, np.concatenate([rank_ready, rank_ready]),
            float(np.median(costs)), net,
            mask=[True] * p + [False] * p,
        )
        seed_ready = gready[:p]  # rank r's own e register IS its seed
        phase2_rounds = len(circ.rounds)
        global_end = float(seed_ready.max())
    else:
        circ = get_circuit(algorithm, p)
        gready, gops = _simulate_circuit(
            circ, rank_ready, float(np.median(costs)), net
        )
        # Inclusive schedule: rank r's seed is rank r-1's inclusive
        # prefix — the exclusive shift the distributed lowering pays as
        # one extra ppermute round (modelled free here, but counted).
        seed_ready = np.concatenate([[rank_ready[0]], gready[:-1]])
        phase2_rounds = len(circ.rounds) + (1 if p > 1 else 0)
        global_end = float(gready.max())
    work += gops

    # ---- Phase 3: seeded local scans over final (global) boundaries.
    # A rank's apply cannot start before BOTH its seed arrives (the global
    # exclusive prefix) and its own phase 1 finished — the interval seeds
    # come from the local scan over its thread partials.
    finish = np.zeros(p)
    for r in range(p):
        seed_t = (
            max(seed_ready[r], rank_ready[r]) if r > 0 else rank_ready[r]
        )
        t_fin = 0.0
        for w, (lo, hi) in enumerate(boundaries_per_rank[r]):
            c = apply_costs[lo : hi + 1].sum()
            busy[r * threads + w] += c
            t_fin = max(t_fin, seed_t + c)
            work += hi - lo + 1
        finish[r] = t_fin
    makespan = float(finish.max())
    idle = np.maximum(0.0, makespan - busy)
    energy = float((busy * busy_power + idle * idle_power).sum())
    return SimResult(
        makespan=makespan,
        work=work,
        phase1_end=float(rank_ready.max()),
        global_end=global_end,
        busy=busy,
        energy=energy,
        cross_steals=cross_count,
        phase2_rounds=phase2_rounds,
    )


def theoretical_bound_scan(n: int, p: int, c1: float = 1.0) -> float:
    """Paper Eq. (5): speedup bound (N-1)/(2N/P - 1 + C1*log2 P)."""
    return (n - 1) / (2 * n / p - 1 + c1 * math.log2(p))


def theoretical_bound_full(n: int, p: int, c1: float = 1.0) -> float:
    """Paper Eq. (6): (2N-1)/(3N/P - 1 + C1*log2 P)."""
    return (2 * n - 1) / (3 * n / p - 1 + c1 * math.log2(p))
