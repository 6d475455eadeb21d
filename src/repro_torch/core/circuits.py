"""Prefix-circuit IR and generators.

The paper analyses prefix-scan algorithms as *prefix circuits* (Table 1).  We make
that the literal source of truth: every algorithm is a generator producing a
``Circuit`` — a sequence of *rounds*, each round a tuple of entries executed in
parallel (all reads happen before any write within a round):

  ("c", src, dst):  y[dst] = y[src] (.) y[dst]         one operator application
  ("x", l, r):      y[l], y[r] = y[r], y[r] (.) y[l]   Blelloch down-sweep cross
                    (r holds the parent = prefix before the subtree; the right
                     child's exclusive prefix is parent (.) left-subtree-sum —
                     order matters for non-commutative operators)
  ("z", i):         y[i] = identity                    free (bookkeeping only)

A circuit is never executed directly: the engine (``engine/plan.py``) lowers
it once into an :class:`~repro_torch.core.engine.plan.ExecutionPlan` — static
gather/scatter index arrays with identities resolved — which the registered
backends consume (JAX vectorized, Python per-element, threaded work-stealing,
Pallas tile kernels, discrete-event simulation, shard_map collectives).  See
``engine/``, ``scan.py``, ``work_stealing.py``, ``simulator.py``,
``distributed.py`` and docs/ARCHITECTURE.md.

Work/depth of every generated circuit is validated against Table 1 of the paper
in ``tests/test_circuits.py`` via :func:`analyze`, which symbolically executes
the circuit with identity tracking (combining with an identity is a move and
costs zero operator applications, matching the paper's accounting).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Callable, Dict, List, Sequence, Tuple

Entry = Tuple  # ("c", src, dst) | ("x", l, r) | ("z", i)
Round = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class Circuit:
    """A prefix circuit over ``n`` inputs producing an inclusive prefix scan.

    ``rounds`` may contain multicast rounds (one src feeding several dsts) —
    the paper's Ladner–Fischer circuit uses MPI_Bcast for those; our collective
    executor lowers them to ``all_gather`` + select (DESIGN.md §3).
    """

    n: int
    rounds: Tuple[Round, ...]
    name: str
    # True when executing the circuit yields the *exclusive* scan (Blelloch).
    exclusive: bool = False

    def num_rounds(self) -> int:
        return len(self.rounds)

    def validate(self) -> None:
        """Structural sanity: indices in range, no dst written twice per round."""
        for r, rnd in enumerate(self.rounds):
            written = set()
            for e in rnd:
                kind = e[0]
                idxs = e[1:]
                for i in idxs:
                    if not (0 <= i < self.n):
                        raise ValueError(f"{self.name}: round {r}: index {i} out of range")
                if kind == "c":
                    dsts = (e[2],)
                elif kind == "x":
                    dsts = (e[1], e[2])
                elif kind == "z":
                    dsts = (e[1],)
                else:
                    raise ValueError(f"{self.name}: unknown entry kind {kind!r}")
                for d in dsts:
                    if d in written:
                        raise ValueError(
                            f"{self.name}: round {r}: index {d} written twice"
                        )
                    written.add(d)


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------


def sequential_circuit(n: int) -> Circuit:
    """Serial scan: depth N-1, work N-1 (Table 1, row 'Sequential')."""
    rounds = tuple((("c", i - 1, i),) for i in range(1, n))
    return Circuit(n, rounds, "sequential")


def dissemination_circuit(n: int) -> Circuit:
    """Kogge–Stone / Hillis–Steele recursive doubling (paper Fig. 2).

    Depth ceil(log2 N); work N*log2(N) - N + 1 for power-of-two N (Table 1).
    """
    rounds: List[Round] = []
    k = 1
    while k < n:
        rounds.append(tuple(("c", i - k, i) for i in range(k, n)))
        k *= 2
    return Circuit(n, tuple(rounds), "dissemination")


def brent_kung_circuit(n: int) -> Circuit:
    """Inclusive double-sweep tree scan (Brent & Kung).

    Depth 2*ceil(log2 N) - 1; work 2N - 2 - log2(N) for power-of-two N.
    """
    rounds: List[Round] = []
    # Up-sweep.
    d = 1
    while d < n:
        rnd = tuple(
            ("c", i + d - 1, i + 2 * d - 1)
            for i in range(0, n - 2 * d + 1, 2 * d)
        )
        if rnd:
            rounds.append(rnd)
        d *= 2
    # Down-sweep: propagate into the skipped midpoints.
    d //= 2
    while d >= 1:
        rnd = tuple(
            ("c", i - 1, i + d - 1)
            for i in range(2 * d, n - d + 1, 2 * d)
        )
        if rnd:
            rounds.append(rnd)
        d //= 2
    return Circuit(n, tuple(rounds), "brent_kung")


def blelloch_circuit(n: int) -> Circuit:
    """Blelloch's exclusive scan: up-sweep, zero the root, cross down-sweep.

    Depth 2*log2 N; work <= 2(N-1) (Table 1, row 'Blelloch').  The executor is
    responsible for converting to an inclusive result (shift left; the total is
    available at the root *before* the ``z`` entry — see ``scan.py``).

    Requires power-of-two ``n``.
    """
    if n & (n - 1):
        raise ValueError("blelloch_circuit requires power-of-two n")
    rounds: List[Round] = []
    d = 1
    while d < n:
        rounds.append(
            tuple(
                ("c", i + d - 1, i + 2 * d - 1)
                for i in range(0, n, 2 * d)
            )
        )
        d *= 2
    rounds.append((("z", n - 1),))
    d = n // 2
    while d >= 1:
        rounds.append(
            tuple(("x", i + d - 1, i + 2 * d - 1) for i in range(0, n, 2 * d))
        )
        d //= 2
    return Circuit(n, tuple(rounds), "blelloch", exclusive=True)


def _merge_parallel(a: List[List[Entry]], b: List[List[Entry]]) -> List[List[Entry]]:
    """Zip two independent sub-circuits round-by-round (they run in parallel)."""
    out: List[List[Entry]] = []
    for i in range(max(len(a), len(b))):
        rnd: List[Entry] = []
        if i < len(a):
            rnd.extend(a[i])
        if i < len(b):
            rnd.extend(b[i])
        out.append(rnd)
    return out


def _lf(indices: Sequence[int], k: int) -> List[List[Entry]]:
    """Ladner–Fischer recursive family P_k over a subsequence of wire indices.

    P_k (k>=1): pair round; P_{k-1} on pair sums; fix-up round for the even
    (pair-start) wires.  Note the last wire always receives its final value
    from the recursion — i.e. the segment *total* is ready one level early,
    which is the property the depth-optimal P_0 construction exploits.

    P_0: P_1 on the first half (slower outputs but early total) || P_0 on the
    second half; then a multicast round combining the first half's total into
    every wire of the second half (the round the paper implements with
    MPI_Bcast).  Depth = ceil(log2 n), work < 4n (Ladner & Fischer 1980).
    """
    n = len(indices)
    if n <= 1:
        return []
    if n == 2:
        return [[("c", indices[0], indices[1])]]
    if k == 0:
        mid = (n + 1) // 2
        left = _lf(indices[:mid], 1)
        right = _lf(indices[mid:], 0)
        rounds = _merge_parallel(left, right)
        bcast = [("c", indices[mid - 1], indices[j]) for j in range(mid, n)]
        rounds.append(bcast)
        return rounds
    # k >= 1: odd-even construction.
    rounds: List[List[Entry]] = []
    pair_round: List[Entry] = []
    sums: List[int] = []
    for i in range(0, n - 1, 2):
        pair_round.append(("c", indices[i], indices[i + 1]))
        sums.append(indices[i + 1])
    if n % 2 == 1:
        sums.append(indices[-1])  # unpaired tail joins the recursion directly
    rounds.append(pair_round)
    rounds.extend(_lf(sums, k - 1))
    # Fix-up: even (pair-start) wires i >= 2 combine with the final value of
    # wire i-1.  Wires inside ``sums`` are already final — never rewritten.
    stop = n if n % 2 == 0 else n - 1
    fixup: List[Entry] = [
        ("c", indices[i - 1], indices[i]) for i in range(2, stop, 2)
    ]
    if fixup:
        rounds.append(fixup)
    return rounds


def ladner_fischer_circuit(n: int, k: int = 0) -> Circuit:
    """Ladner–Fischer P_k circuit: depth ~ ceil(log2 N)+C2, work < 4N-5 (k=0)."""
    rounds = [tuple(r) for r in _lf(list(range(n)), k) if r]
    return Circuit(n, tuple(rounds), f"ladner_fischer_{k}")


def sklansky_circuit(n: int) -> Circuit:
    """Sklansky divide-and-broadcast: depth exactly ceil(log2 N), work N/2*log2 N.

    Included as the depth-optimal extreme of the trade-off space the paper
    discusses; heavy multicast (maps to all_gather in the collective executor).
    """

    def rec(idx: Sequence[int]) -> List[List[Entry]]:
        m = len(idx)
        if m <= 1:
            return []
        mid = (m + 1) // 2
        rounds = _merge_parallel(rec(idx[:mid]), rec(idx[mid:]))
        rounds.append([("c", idx[mid - 1], idx[j]) for j in range(mid, m)])
        return rounds

    rounds = [tuple(r) for r in rec(list(range(n))) if r]
    return Circuit(n, tuple(rounds), "sklansky")


def exscan_circuit(p: int) -> Circuit:
    """Round-efficient *exclusive* scan over ``p`` ranks (Träff 2025, MPI_Exscan).

    The naive exclusive scan is an inclusive scan followed by a shift —
    ceil(log2 p) + 1 communication rounds.  Träff's doubling schedule fuses the
    shift away by keeping two registers per rank:

      e_i  (wires [0, p))   the exclusive prefix, initially the identity
      s_i  (wires [p, 2p))  the running window sum, initially the input x_i

    Round with distance d sends one message per receiving rank — rank i >= d
    receives s_{i-d} and applies it to *both* registers:

      e_i = s_{i-d} (.) e_i        s_i = s_{i-d} (.) s_i

    Invariant before the round at distance d:
    e_i = x[max(0, i-d+1) .. i-1],  s_i = x[max(0, i-d+1) .. i] — so after
    ceil(log2 p) rounds e_i is the full exclusive prefix.  One round fewer
    than shift-then-scan, on the slowest axis of the hierarchy.

    The e-wires start as identity; express that to the planner via a wire mask
    (``get_plan(circ, mask=[True]*p + [False]*p)``), *not* with ``z`` rounds —
    a ``z`` round would flag ``total_available`` and break collective lowering.
    Rank 0's e-wire is never written: it keeps whatever the executor
    initialised it with (the identity, or zeros that callers mask).
    """
    if p < 1:
        raise ValueError("exscan_circuit requires p >= 1")
    rounds: List[Round] = []
    d = 1
    while d < p:
        rnd: List[Entry] = []
        for i in range(d, p):
            rnd.append(("c", p + i - d, i))      # e_i = s_{i-d} (.) e_i
            rnd.append(("c", p + i - d, p + i))  # s_i = s_{i-d} (.) s_i
        rounds.append(tuple(rnd))
        d *= 2
    return Circuit(2 * p, tuple(rounds), "exscan", exclusive=True)


@lru_cache(maxsize=256)
def get_exscan_circuit(p: int) -> Circuit:
    """Cached, validated exscan circuit for ``p`` ranks (2p wires)."""
    c = exscan_circuit(p)
    c.validate()
    return c


def exscan_num_rounds(p: int) -> int:
    """Communication rounds of the exscan schedule: ceil(log2 p)."""
    return math.ceil(math.log2(p)) if p > 1 else 0


GENERATORS: Dict[str, Callable[[int], Circuit]] = {
    "sequential": sequential_circuit,
    "dissemination": dissemination_circuit,
    "brent_kung": brent_kung_circuit,
    "blelloch": blelloch_circuit,
    "ladner_fischer": ladner_fischer_circuit,
    "sklansky": sklansky_circuit,
}


@lru_cache(maxsize=512)
def get_circuit(name: str, n: int) -> Circuit:
    try:
        gen = GENERATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown scan algorithm {name!r}; available: {sorted(GENERATORS)}"
        ) from None
    c = gen(n)
    c.validate()
    return c


# ---------------------------------------------------------------------------
# Analysis: exact work / depth with identity tracking
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CircuitStats:
    work: int          # operator applications (identity combines are free moves)
    depth: int         # critical path length in operator applications
    rounds: int        # communication rounds
    multicast_rounds: int  # rounds containing a src used by >1 dst (MPI_Bcast-like)
    max_fanout: int


def analyze(circuit: Circuit) -> CircuitStats:
    """Symbolically execute the circuit, counting ops and the critical path."""
    n = circuit.n
    depth = [0] * n          # critical path (in ops) to produce y[i]
    is_id = [False] * n
    work = 0
    multicast_rounds = 0
    max_fanout = 1
    for rnd in circuit.rounds:
        src_count: Dict[int, int] = {}
        for e in rnd:
            if e[0] in ("c", "x"):
                src_count[e[1]] = src_count.get(e[1], 0) + 1
        fanout = max(src_count.values()) if src_count else 1
        max_fanout = max(max_fanout, fanout)
        if fanout > 1:
            multicast_rounds += 1
        writes: List[Tuple[int, int, bool]] = []  # (idx, depth, is_id)
        for e in rnd:
            kind = e[0]
            if kind == "z":
                writes.append((e[1], 0, True))
            elif kind == "c":
                s, d = e[1], e[2]
                if is_id[s]:
                    writes.append((d, depth[d], is_id[d]))
                elif is_id[d]:
                    writes.append((d, depth[s], False))
                else:
                    work += 1
                    writes.append((d, max(depth[s], depth[d]) + 1, False))
            elif kind == "x":
                l, r = e[1], e[2]
                # y[l] <- y[r]  (move)
                writes.append((l, depth[r], is_id[r]))
                # y[r] <- y[l] . y[r]
                if is_id[l]:
                    writes.append((r, depth[r], is_id[r]))
                elif is_id[r]:
                    writes.append((r, depth[l], False))
                else:
                    work += 1
                    writes.append((r, max(depth[l], depth[r]) + 1, False))
        for idx, dep, iid in writes:
            depth[idx] = dep
            is_id[idx] = iid
    return CircuitStats(
        work=work,
        depth=max(depth) if n else 0,
        rounds=len(circuit.rounds),
        multicast_rounds=multicast_rounds,
        max_fanout=max_fanout,
    )


def table1_bounds(name: str, n: int) -> Dict[str, float]:
    """The paper's Table 1 expressions, used by the faithfulness tests."""
    lg = math.ceil(math.log2(max(n, 1)))
    if name == "sequential":
        return {"depth": n - 1, "work": n - 1}
    if name == "blelloch":
        return {"depth": 2 * lg, "work": 2 * (n - 1)}
    if name == "dissemination":
        return {"depth": lg, "work": n * lg - n + 1}
    if name == "ladner_fischer":
        return {"depth": lg, "work": 4 * n - 5}
    raise KeyError(name)
