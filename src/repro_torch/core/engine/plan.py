"""Circuit → ExecutionPlan lowering: the backend-neutral compiled schedule.

Every executor used to re-interpret the circuit IR (``circuits.Circuit``) with
its own per-call Python loop — re-deriving identity masks, gather/scatter
index lists and move lists on *every* scan call.  ``lower`` runs that symbolic
trace exactly once and records the result as an :class:`ExecutionPlan`:

* per-round **combine** primitives ``y[out] = op(y[a], y[b])`` with the
  operand/output wires resolved into static index arrays (gather/scatter
  ready), and
* per-round **move** primitives ``y[out] = y[src]`` — combines whose one
  operand was symbolically known to be the identity (Blelloch padding /
  ``where`` masks) compile to moves and cost zero operator applications,
* the wire whose pre-round value is the full reduction (Blelloch root before
  the ``z`` zeroing), and
* a per-primitive communication fanout (multicast degree of the source wire),
  consumed by the collective lowering and the discrete-event simulator.

All reads within a round observe pre-round values (the circuit IR contract),
so a plan round is one gather → combine → scatter step — directly executable
as a vectorized JAX round, a Pallas kernel, a set of ppermute/all_gather
collectives, or a virtual-time event batch.

Plans are cached in a small LRU (:func:`get_plan`) keyed on
``(circuit, n, identity-mask)``, the mask None when no wire is the identity;
backend-specific device lowerings (the ``pallas`` backend's operand tables
and lists) hang off the plan's ``scratch``.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ...runtime.compile_cache import get_plan_store
from ..circuits import Circuit, get_circuit


@dataclasses.dataclass(frozen=True)
class PlanRound:
    """One compiled round: all reads happen before any write.

    ``combines[i] = (a, b, out, fanout, comm_src)``: ``y[out] = op(y[a], y[b])``
    where ``comm_src`` (== a or b) is the operand that arrives over the wire
    in a distributed/simulated execution (the circuit entry's source; for a
    Blelloch cross it is the *second* operand).
    ``moves[i] = (src, out, fanout)``:     ``y[out] = y[src]``.
    ``capture_total``: wire whose *pre-round* value is the full reduction
    (recorded on the Blelloch ``z`` round), else None.
    """

    combines: Tuple[Tuple[int, int, int, int, int], ...]
    moves: Tuple[Tuple[int, int, int], ...]
    capture_total: Optional[int] = None

    # Dense index arrays for vectorized executors, built once at lower time.
    # (kept out of __eq__/__hash__ — derived from the tuples above)
    a_idx: np.ndarray = dataclasses.field(compare=False, repr=False, default=None)
    b_idx: np.ndarray = dataclasses.field(compare=False, repr=False, default=None)
    mv_src: np.ndarray = dataclasses.field(compare=False, repr=False, default=None)
    upd_idx: np.ndarray = dataclasses.field(compare=False, repr=False, default=None)

    @staticmethod
    def build(combines, moves, capture_total=None) -> "PlanRound":
        combines = tuple(combines)
        moves = tuple(moves)
        a = np.asarray([c[0] for c in combines], dtype=np.int32)
        b = np.asarray([c[1] for c in combines], dtype=np.int32)
        out = np.asarray([c[2] for c in combines], dtype=np.int32)
        ms = np.asarray([m[0] for m in moves], dtype=np.int32)
        mo = np.asarray([m[1] for m in moves], dtype=np.int32)
        return PlanRound(
            combines=combines,
            moves=moves,
            capture_total=capture_total,
            a_idx=a,
            b_idx=b,
            mv_src=ms,
            upd_idx=np.concatenate([out, mo]),
        )

    @property
    def num_combines(self) -> int:
        return len(self.combines)

    @property
    def num_moves(self) -> int:
        return len(self.moves)


@dataclasses.dataclass
class ExecutionPlan:
    """A fully lowered scan schedule for one (circuit, identity-mask) pair."""

    circuit: Circuit
    rounds: Tuple[PlanRound, ...]
    mask: Tuple[bool, ...]        # initial identity mask (True = identity)
    final_id: Tuple[bool, ...]    # identity mask after the last round

    # Per-plan scratch for backend lowerings that want to memoize jnp arrays
    # (e.g. device-resident index arrays); not part of plan identity.
    scratch: Dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def n(self) -> int:
        return self.circuit.n

    @property
    def n_valid(self) -> int:
        return self.mask.count(False)

    @property
    def exclusive(self) -> bool:
        return self.circuit.exclusive

    @property
    def total_available(self) -> bool:
        return any(r.capture_total is not None for r in self.rounds)

    def num_rounds(self) -> int:
        return len(self.rounds)

    def work(self) -> int:
        """Operator applications (identity combines already compiled away)."""
        return sum(r.num_combines for r in self.rounds)

    def num_moves(self) -> int:
        return sum(r.num_moves for r in self.rounds)

    def combine_only(self) -> bool:
        """True when every round is pure combines (lowerable to ppermute)."""
        return self.num_moves() == 0 and not self.total_available


def lower(circuit: Circuit, *, mask: Optional[Sequence[bool]] = None) -> ExecutionPlan:
    """Symbolically execute ``circuit`` once, resolving identity tracking.

    ``mask``: initial per-wire identity flags (True = the wire holds the
    identity element, e.g. padding).  Combines against a known identity
    compile into moves or no-ops, exactly the accounting of
    :func:`repro_torch.core.circuits.analyze` and the paper's Table 1.
    """
    n = circuit.n
    if mask is None:
        is_id: List[bool] = [False] * n
    else:
        if len(mask) != n:
            raise ValueError(f"mask length {len(mask)} != circuit.n {n}")
        is_id = list(mask)
    plan_rounds: List[PlanRound] = []
    for rnd in circuit.rounds:
        combines: List[Tuple[int, int, int, int, int]] = []
        moves: List[Tuple[int, int, int]] = []
        new_id: List[Tuple[int, bool]] = []
        capture: Optional[int] = None
        # Multicast degree of every source wire this round ("c"/"x" first
        # index), matching the simulator's and collective executor's
        # accounting of MPI_Bcast-like rounds.
        src_count: Dict[int, int] = {}
        for e in rnd:
            if e[0] in ("c", "x"):
                src_count[e[1]] = src_count.get(e[1], 0) + 1

        def fan(w: int) -> int:
            return src_count.get(w, 1)

        for e in rnd:
            kind = e[0]
            if kind == "z":
                i = e[1]
                capture = i  # pre-round value at the root == full reduction
                new_id.append((i, True))
            elif kind == "c":
                s, d = e[1], e[2]
                if is_id[s]:
                    pass  # y[d] unchanged
                elif is_id[d]:
                    moves.append((s, d, fan(s)))
                    new_id.append((d, False))
                else:
                    combines.append((s, d, d, fan(s), s))
            elif kind == "x":
                l, r = e[1], e[2]
                # y[l] <- y[r]  (left child receives the parent prefix)
                moves.append((r, l, fan(l)))
                new_id.append((l, is_id[r]))
                # y[r] <- y[r] . y[l]  (parent (.) left-subtree-sum)
                if is_id[l]:
                    pass  # y[r] unchanged
                elif is_id[r]:
                    moves.append((l, r, fan(l)))
                    new_id.append((r, False))
                else:
                    combines.append((r, l, r, fan(l), l))
            else:
                raise ValueError(f"unknown circuit entry kind {kind!r}")
        plan_rounds.append(PlanRound.build(combines, moves, capture))
        for i, v in new_id:
            is_id[i] = v
    return ExecutionPlan(
        circuit=circuit,
        rounds=tuple(plan_rounds),
        mask=tuple(mask) if mask is not None else (False,) * n,
        final_id=tuple(is_id),
    )


# ---------------------------------------------------------------------------
# LRU plan cache
# ---------------------------------------------------------------------------


class LRUCache:
    """Tiny thread-safe LRU with hit/miss counters (inspectable in tests)."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            try:
                val = self._data.pop(key)
            except KeyError:
                self.misses += 1
                return None
            self._data[key] = val
            self.hits += 1
            return val

    def put(self, key, val):
        with self._lock:
            self._data.pop(key, None)
            self._data[key] = val
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def clear(self):
        with self._lock:
            self._data.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self):
        return len(self._data)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses, "size": len(self._data)}


plan_cache = LRUCache(maxsize=256)


def _mask_key(mask: Optional[Sequence[bool]]) -> Optional[Tuple[bool, ...]]:
    """The cache key of an identity mask: None when no wire is the
    identity (no mask, or one all False), so the common unmasked lookup
    hashes no n-long tuple."""
    if mask is None:
        return None
    key = tuple(bool(m) for m in mask)
    return key if any(key) else None


def get_plan(
    circuit: Union[str, Circuit],
    n: Optional[int] = None,
    *,
    mask: Optional[Sequence[bool]] = None,
    n_valid: Optional[int] = None,
) -> ExecutionPlan:
    """Lower (or fetch from the LRU cache) the plan for a circuit.

    ``circuit`` may be an algorithm name (resolved via
    :func:`repro_torch.core.circuits.get_circuit` with ``n``) or a built Circuit.
    ``n_valid`` is shorthand for a suffix-padding mask (elements at index
    >= n_valid are identity).
    """
    if isinstance(circuit, str):
        if n is None:
            raise ValueError("n is required when passing an algorithm name")
        circuit = get_circuit(circuit, n)
    if n_valid is not None:
        if mask is not None:
            raise ValueError("pass either mask or n_valid, not both")
        if n_valid < circuit.n:
            mask = [i >= n_valid for i in range(circuit.n)]
    key = (circuit.name, circuit.n, _mask_key(mask))
    plan = plan_cache.get(key)
    # Name+n almost always identifies the circuit (generators are pure); a
    # hand-built circuit reusing a registry name is detected by the equality
    # check (cheap tuple comparison) and lowered fresh, uncached.
    if plan is not None and plan.circuit == circuit:
        return plan
    # LRU miss: a previous process may have lowered this schedule already —
    # the persistent plan store (when configured via
    # runtime.compile_cache.set_cache_dir) skips the symbolic trace.
    store = get_plan_store()
    if plan is None and store is not None:
        stored = store.load(key)
        if stored is not None and stored.circuit == circuit:
            plan_cache.put(key, stored)
            return stored
    fresh = lower(circuit, mask=mask)
    if plan is None:
        plan_cache.put(key, fresh)
        if store is not None:
            store.store(key, fresh)
    return fresh
