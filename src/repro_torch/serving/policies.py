"""Dispatch policies for the serving front end (queue_flex/MICA methodology).

Which queued request runs next is *the* tail-latency decision under load —
the MICA dispatch-policy study (SNIPPETS.md Snippet 3) compares policies by
p99/p999 under open-loop Poisson arrivals, never by mean throughput, and
that is exactly how the reference's ``benchmarks/bench_slo.py`` compares
these.  A policy sees one :class:`QueueView` per tenant with a runnable head request and
returns the tenant to serve; the front end handles admission, priority
lanes (policies only ever see the highest non-empty lane) and per-session
ordering before the policy is consulted.

All policies are single-threaded from the front end's perspective: ``select``
is only called under the front end's lock.  Choosing a policy:

* ``fifo`` — global arrival order.  Lowest overhead, but one tenant
  flooding its queue makes every later arrival wait behind the flood
  (no isolation; the bench's straggler-tenant scenario is its worst case).
* ``round_robin`` — cycle over tenants with runnable work.  Any tenant's
  head request waits at most O(#tenants) dispatch turns regardless of how
  deep other queues are (``tests/test_torch_serving.py`` pins the bound).
* ``sewf`` — shortest expected work first: expected seconds of the head
  request, from the per-tenant operator-cost EMAs the front end records
  into :mod:`repro_torch.core.engine.telemetry`.  Minimizes mean sojourn time
  (SJF); pair it with the priority lane to protect it from starving a
  long-work tenant forever.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class QueueView:
    """One tenant's runnable head request, as a policy sees it."""

    tenant: str
    depth: int            # requests queued for this tenant
    head_seq: int         # global arrival sequence number of the head
    head_work: float      # expected service seconds of the head (0 if
                          # unobserved — EMAs need one completion to exist)
    priority: int         # claim lane (informational: the front end has
                          # already filtered views to the top lane)


class DispatchPolicy:
    """Base: ``select`` returns the tenant name to serve, or None."""

    name = "base"

    def select(self, views: Sequence[QueueView]) -> Optional[str]:
        raise NotImplementedError


class FifoPolicy(DispatchPolicy):
    """Global arrival order: the oldest queued request anywhere runs next."""

    name = "fifo"

    def select(self, views: Sequence[QueueView]) -> Optional[str]:
        if not views:
            return None
        return min(views, key=lambda v: v.head_seq).tenant


class RoundRobinPolicy(DispatchPolicy):
    """Per-tenant round-robin: one request per tenant per turn.

    The cursor remembers the last tenant served and picks the next tenant
    (in registration order) that has runnable work, so a straggler tenant
    with a deep queue gets exactly one turn per cycle and any tenant's
    head waits at most one full cycle — O(#tenants) turns.
    """

    name = "round_robin"

    def __init__(self) -> None:
        self._last: Optional[str] = None

    def select(self, views: Sequence[QueueView]) -> Optional[str]:
        if not views:
            return None
        names = [v.tenant for v in views]
        if self._last in names:
            start = names.index(self._last) + 1
            names = names[start:] + names[:start]
        chosen = names[0]
        self._last = chosen
        return chosen


class ShortestExpectedWorkPolicy(DispatchPolicy):
    """Shortest-expected-work-first from the telemetry cost EMAs.

    ``head_work`` is (items in the request) x (the tenant's observed EMA
    seconds per operator application); an unobserved tenant reads as zero
    work — optimistically short, so new tenants get served and observed
    quickly.  Ties (including the all-unobserved cold start) fall back to
    arrival order.
    """

    name = "sewf"

    def select(self, views: Sequence[QueueView]) -> Optional[str]:
        if not views:
            return None
        return min(views, key=lambda v: (v.head_work, v.head_seq)).tenant


_POLICIES = {
    FifoPolicy.name: FifoPolicy,
    RoundRobinPolicy.name: RoundRobinPolicy,
    ShortestExpectedWorkPolicy.name: ShortestExpectedWorkPolicy,
}


def get_policy(name: str) -> DispatchPolicy:
    """Instantiate a dispatch policy by name (stateful: one per frontend)."""
    try:
        return _POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown dispatch policy {name!r}; known: {sorted(_POLICIES)}"
        ) from None


def policy_names() -> List[str]:
    return sorted(_POLICIES)
