"""Vector-clock happens-before race sanitizer (dependency-free).

The dynamic half of the race-aware analysis layer: ``sync_point`` labels
(:mod:`repro_torch.analysis.sync`) can carry an event *kind* — ``acquire`` /
``release`` on a named lock, or ``read`` / ``write`` on a named shared
variable.  When checking is on, :class:`RaceTracker` maintains FastTrack-
style per-thread vector clocks and reports **unordered conflicting
accesses**: two accesses to the same variable, at least one a write, from
different threads, with neither ordered before the other by the recorded
acquire/release edges.  Unlike a stress test, this flags the race even
when the lucky interleaving happened to produce the right answer.

The clock algebra (Lamport happens-before over lock synchronization):

* each thread ``t`` owns a vector clock ``C[t]``; its own component ticks
  on every release (so distinct critical sections get distinct epochs);
* ``release(t, l)`` publishes: ``L[l] := C[t]`` (copy), then ticks ``t``;
* ``acquire(t, l)`` inherits: ``C[t] := C[t] ⊔ L[l]`` (pointwise max);
* an access by ``t`` at epoch ``c = C[t][t]`` is ordered after a prior
  access ``(u, c_u)`` iff ``c_u <= C[t][u]`` — otherwise nothing
  synchronized the two and they race if they conflict.

Accesses passed with ``lock=`` are shorthand for an access *inside* that
critical section (acquire + access + release folded into one call) — the
instrumentation pattern the serving front end and the WorkerPool claim
path use, since their accesses happen under ``with self._cond``.

The tracker is deliberately modest: it sees only instrumented accesses
(``sync_point(..., kind=...)`` sites), keeps whole vector clocks rather
than FastTrack's adaptive epochs, and bounds its memory by capping
recorded races and last-access history.  That is the right trade for a
sanitizer that runs the existing concurrency tests in CI.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["RaceReport", "RaceTracker"]

#: Stop recording after this many distinct race reports (memory bound).
_MAX_RACES = 64


@dataclasses.dataclass(frozen=True)
class RaceReport:
    """One unordered conflicting pair on a shared variable."""

    var: str
    first_kind: str
    first_label: Optional[str]
    second_kind: str
    second_label: Optional[str]

    def __str__(self) -> str:
        a = f"{self.first_kind}@{self.first_label or '?'}"
        b = f"{self.second_kind}@{self.second_label or '?'}"
        return f"race on {self.var!r}: {a} unordered with {b}"


@dataclasses.dataclass
class _Epoch:
    tid: int
    clock: int
    kind: str
    label: Optional[str]


class _VarState:
    __slots__ = ("write", "reads")

    def __init__(self):
        self.write: Optional[_Epoch] = None
        #: last read per thread (a write must be ordered after *all* reads)
        self.reads: Dict[int, _Epoch] = {}


class RaceTracker:
    """Happens-before tracker over sync_point acquire/release/read/write
    events.  Thread-safe; all state lives behind one internal lock (the
    tracker itself must not race)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._clocks: Dict[int, Dict[int, int]] = {}
        self._lock_clocks: Dict[str, Dict[int, int]] = {}
        self._vars: Dict[str, _VarState] = {}
        self._races: List[RaceReport] = []
        self._race_keys: set = set()

    # ------------------------------------------------------------ clocks

    def _clock_of(self, tid: int) -> Dict[int, int]:
        c = self._clocks.get(tid)
        if c is None:
            c = {tid: 1}
            self._clocks[tid] = c
        return c

    @staticmethod
    def _join(into: Dict[int, int], other: Dict[int, int]) -> None:
        for t, v in other.items():
            if v > into.get(t, 0):
                into[t] = v

    def _acquire_locked(self, tid: int, lock: str) -> None:
        lc = self._lock_clocks.get(lock)
        if lc:
            self._join(self._clock_of(tid), lc)

    def _release_locked(self, tid: int, lock: str) -> None:
        c = self._clock_of(tid)
        self._lock_clocks[lock] = dict(c)
        c[tid] = c.get(tid, 0) + 1

    # ------------------------------------------------------------ events

    def acquire(self, tid: int, lock: str) -> None:
        with self._lock:
            self._acquire_locked(tid, lock)

    def release(self, tid: int, lock: str) -> None:
        with self._lock:
            self._release_locked(tid, lock)

    def access(
        self,
        tid: int,
        var: str,
        kind: str,
        *,
        lock: Optional[str] = None,
        label: Optional[str] = None,
    ) -> None:
        """Record a read/write of ``var`` by ``tid``.

        ``lock=`` marks the access as performed inside that critical
        section: acquire → access → release, folded into one event.
        """
        if kind not in ("read", "write"):
            raise ValueError(f"access kind must be read/write, got {kind!r}")
        with self._lock:
            if lock is not None:
                self._acquire_locked(tid, lock)
            self._check_and_record_locked(tid, var, kind, label)
            if lock is not None:
                self._release_locked(tid, lock)

    # ---------------------------------------------------------- detection

    def _ordered_before(self, prior: _Epoch, c: Dict[int, int]) -> bool:
        return prior.clock <= c.get(prior.tid, 0)

    def _report_locked(
        self, var: str, prior: _Epoch, kind: str, label: Optional[str]
    ) -> None:
        key = (var, prior.kind, prior.label, kind, label)
        if key in self._race_keys or len(self._races) >= _MAX_RACES:
            return
        self._race_keys.add(key)
        self._races.append(RaceReport(
            var, prior.kind, prior.label, kind, label,
        ))

    def _check_and_record_locked(
        self, tid: int, var: str, kind: str, label: Optional[str]
    ) -> None:
        c = self._clock_of(tid)
        st = self._vars.get(var)
        if st is None:
            st = self._vars[var] = _VarState()
        w = st.write
        if w is not None and w.tid != tid and not self._ordered_before(w, c):
            self._report_locked(var, w, kind, label)
        if kind == "write":
            for r in st.reads.values():
                if r.tid != tid and not self._ordered_before(r, c):
                    self._report_locked(var, r, kind, label)
            st.write = _Epoch(tid, c.get(tid, 0), "write", label)
            st.reads.clear()
        else:
            st.reads[tid] = _Epoch(tid, c.get(tid, 0), "read", label)

    # ------------------------------------------------------------ results

    def races(self) -> List[RaceReport]:
        with self._lock:
            return list(self._races)

    def reset(self) -> None:
        with self._lock:
            self._clocks.clear()
            self._lock_clocks.clear()
            self._vars.clear()
            self._races.clear()
            self._race_keys.clear()
