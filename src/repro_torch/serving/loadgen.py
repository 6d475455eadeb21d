"""Open-loop load generation and HDR-style latency histograms.

The MICA dispatch study (SNIPPETS.md Snippet 3) measures tail latency the
only honest way: **open loop** — arrivals fire on a Poisson schedule fixed
in advance, whether or not earlier requests finished.  A closed loop
(send, wait, send) lets a slow server throttle its own offered load,
which hides exactly the queueing delay a tail percentile is supposed to
expose (coordinated omission).  :func:`run_open_loop` drives any submit
callable that returns a :class:`~repro_torch.serving.frontend.Ticket` on that
schedule and folds completions into :class:`LatencyHistogram` buckets.

Everything here is dependency-free and deterministic given a seed; the
clock and sleep are injectable so tests run on a fake clock in
microseconds of real time.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.serving.frontend import AdmissionError, Ticket


class LatencyHistogram:
    """Geometric-bucket latency histogram (HDR-histogram style).

    Buckets grow geometrically from ``min_s`` with ``buckets_per_decade``
    buckets per factor of 10 (default 40 — <6% relative bucket width), so
    one small fixed array covers microseconds to minutes with bounded
    relative error on any percentile.  ``record`` is O(1); percentiles are
    read from the cumulative counts.  Not thread-safe: the load generator
    records from its completion pass only — merge per-thread histograms
    with :meth:`merge` instead of sharing one.
    """

    def __init__(self, *, min_s: float = 1e-6, max_s: float = 300.0,
                 buckets_per_decade: int = 40):
        self._min = min_s
        self._per_decade = buckets_per_decade
        n = int(math.ceil(math.log10(max_s / min_s) * buckets_per_decade)) + 2
        self._counts = [0] * n
        self._count = 0
        self._sum = 0.0
        self._max = 0.0

    def _bucket(self, seconds: float) -> int:
        if seconds <= self._min:
            return 0
        idx = int(math.log10(seconds / self._min) * self._per_decade) + 1
        return min(idx, len(self._counts) - 1)

    def record(self, seconds: float) -> None:
        self._counts[self._bucket(seconds)] += 1
        self._count += 1
        self._sum += seconds
        if seconds > self._max:
            self._max = seconds

    def merge(self, other: "LatencyHistogram") -> None:
        if len(other._counts) != len(self._counts):
            raise ValueError("histogram geometries differ")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self._count += other._count
        self._sum += other._sum
        self._max = max(self._max, other._max)

    @property
    def count(self) -> int:
        return self._count

    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-th percentile (0 < p <= 100).

        Reported as the bucket's upper edge, so a percentile never
        under-states the observed latency by more than the bucket width.
        """
        if not 0.0 < p <= 100.0:
            raise ValueError(f"percentile must be in (0, 100], got {p}")
        if self._count == 0:
            return 0.0
        rank = math.ceil(self._count * p / 100.0)
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                if i == 0:
                    return self._min
                return min(
                    self._min * 10 ** (i / self._per_decade), self._max
                )
        return self._max

    def summary(self) -> Dict[str, float]:
        """count / mean / p50 / p90 / p99 / p999 / max, all in seconds."""
        return {
            "count": float(self._count),
            "mean_s": self.mean(),
            "p50_s": self.percentile(50),
            "p90_s": self.percentile(90),
            "p99_s": self.percentile(99),
            "p999_s": self.percentile(99.9),
            "max_s": self._max,
        }


def poisson_arrivals(rate_hz: float, duration_s: float, *,
                     seed: int = 0) -> List[float]:
    """Arrival offsets (seconds from start) of a Poisson process.

    Exponential inter-arrival gaps at ``rate_hz``; deterministic for a
    given seed so benchmark arms replay the identical schedule.
    """
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    rng = random.Random(seed)
    out: List[float] = []
    t = rng.expovariate(rate_hz)
    while t < duration_s:
        out.append(t)
        t += rng.expovariate(rate_hz)
    return out


@dataclasses.dataclass
class LoadResult:
    """Outcome of one open-loop run.

    ``latency``/``wait``/``service`` histograms hold end-to-end, queued,
    and executing seconds per completed request.  ``rejected`` counts
    :class:`AdmissionError` submits — under open load these are *expected*
    at saturation and are the backpressure working; report them next to
    the percentiles, never silently drop them.  ``offered_hz`` is the
    schedule's rate; ``achieved_hz`` is completions over the measurement
    window — a gap between the two is the saturation signal.
    """

    latency: LatencyHistogram
    wait: LatencyHistogram
    service: LatencyHistogram
    completed: int
    rejected: int
    errors: int
    offered_hz: float
    achieved_hz: float

    def report(self) -> Dict[str, float]:
        out = {f"latency_{k}": v for k, v in self.latency.summary().items()}
        out.update({
            "wait_p99_s": self.wait.percentile(99),
            "service_p50_s": self.service.percentile(50),
            "completed": float(self.completed),
            "rejected": float(self.rejected),
            "errors": float(self.errors),
            "offered_hz": self.offered_hz,
            "achieved_hz": self.achieved_hz,
        })
        return out


def run_open_loop(
    submit: Callable[[], Ticket],
    arrivals: Sequence[float],
    *,
    drain_timeout_s: float = 30.0,
    clock: Callable[[], float] = time.perf_counter,
    sleep: Callable[[float], None] = time.sleep,
) -> LoadResult:
    """Fire ``submit`` on the arrival schedule; collect latency histograms.

    Open loop: the next submit happens at its scheduled offset even when
    earlier tickets are still in flight (late = fire immediately, never
    skip).  ``submit`` must be non-blocking — :class:`AdmissionError` is
    counted as a rejection, any other exception as an error.  After the
    last arrival, waits up to ``drain_timeout_s`` for in-flight tickets;
    tickets still pending after the drain window are dropped from the
    histograms but reflected in ``achieved_hz``.

    Blocks the calling thread for the schedule's duration plus drain.
    """
    tickets: List[Ticket] = []
    rejected = 0
    errors = 0
    t0 = clock()
    for offset in arrivals:
        delay = (t0 + offset) - clock()
        if delay > 0:
            sleep(delay)
        try:
            tickets.append(submit())
        except AdmissionError:
            rejected += 1
        except Exception:
            errors += 1

    deadline = clock() + drain_timeout_s
    latency = LatencyHistogram()
    wait = LatencyHistogram()
    service = LatencyHistogram()
    completed = 0
    for ticket in tickets:
        remaining = deadline - clock()
        if not ticket.wait(max(0.0, remaining)):
            continue
        lat = ticket.latency_s
        if lat is None:
            continue
        if ticket._error is not None:
            errors += 1
            continue
        latency.record(lat)
        q = ticket.queue_wait_s
        s = ticket.service_s
        if q is not None:
            wait.record(q)
        if s is not None:
            service.record(s)
        completed += 1
    elapsed = max(clock() - t0, 1e-9)
    duration = arrivals[-1] if arrivals else 0.0
    offered = len(arrivals) / duration if duration > 0 else 0.0
    return LoadResult(
        latency=latency,
        wait=wait,
        service=service,
        completed=completed,
        rejected=rejected,
        errors=errors,
        offered_hz=offered,
        achieved_hz=completed / elapsed,
    )
