"""Per-operator cost telemetry feeding the dispatcher (paper §4, Table 3).

The dispatcher's decision procedure needs an operator-cost estimate.  A user
hint (``op_cost=``) or a one-off microbenchmark (``measure=True``) works for
stationary operators, but the registration operator's cost is *data
dependent* (iteration counts vary per frame pair, §2.3.3) and drifts over a
series.  ``OpTelemetry`` closes the loop: operator adapters record every
application's wall time, and the engine consults the adapter's running
estimate on the next ``scan`` call (``scan`` looks for an
``op_cost_estimate`` attribute on the operator when no explicit hint is
given).

The estimate is an exponential moving average, so a straggler-heavy stretch
raises the estimate quickly while one outlier does not pin it forever.
Thread-safe: the work-stealing executors apply the operator from many
threads concurrently.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional


@dataclasses.dataclass
class OpTelemetry:
    """Running per-call cost statistics for one operator."""

    name: str = "op"
    ema_alpha: float = 0.2

    calls: int = 0
    total_time: float = 0.0
    max_time: float = 0.0
    ema_time: Optional[float] = None
    # Trace/JIT-compile time, kept strictly out of the per-call rate
    # statistics: the first application after process start used to fold
    # seconds of XLA compilation into the cost EMA, and the dispatcher
    # then planned the whole first series around a 100x-inflated operator.
    compile_calls: int = 0
    compile_time: float = 0.0

    def __post_init__(self):
        self._lock = threading.Lock()

    def record(self, seconds: float, *, compile: bool = False) -> None:
        """Record one application.  ``compile=True`` marks a call whose
        wall time is dominated by tracing/compilation — it is accumulated
        separately and never touches the mean/max/EMA rate statistics."""
        with self._lock:
            if compile:
                self.compile_calls += 1
                self.compile_time += seconds
                return
            self.calls += 1
            self.total_time += seconds
            self.max_time = max(self.max_time, seconds)
            self.ema_time = (
                seconds
                if self.ema_time is None
                else (1 - self.ema_alpha) * self.ema_time + self.ema_alpha * seconds
            )

    # The readers take the lock too: ``_lock`` is a plain (non-reentrant)
    # ``threading.Lock``, so the shared arithmetic lives in ``*_locked``
    # helpers the locked public methods compose without re-acquiring.

    def _mean_locked(self) -> float:
        return self.total_time / self.calls if self.calls else 0.0

    def _imbalance_locked(self) -> float:
        m = self._mean_locked()
        return self.max_time / m if m > 0 else 1.0

    def mean(self) -> float:
        with self._lock:
            return self._mean_locked()

    def estimate(self) -> Optional[float]:
        """Seconds/application for the dispatcher; None before any call."""
        with self._lock:
            return self.ema_time

    def imbalance(self) -> float:
        """max/mean per-call cost ratio — the paper's imbalance signal."""
        with self._lock:
            return self._imbalance_locked()

    def reset(self) -> None:
        with self._lock:
            self.calls = 0
            self.total_time = 0.0
            self.max_time = 0.0
            self.ema_time = None
            self.compile_calls = 0
            self.compile_time = 0.0

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return {
                "calls": self.calls,
                "total_s": self.total_time,
                "mean_s": self._mean_locked(),
                "max_s": self.max_time if self.calls else 0.0,
                "ema_s": self.ema_time if self.ema_time is not None else 0.0,
                "imbalance": self._imbalance_locked(),
                "compile_calls": self.compile_calls,
                "compile_s": self.compile_time,
            }


_registry: Dict[str, OpTelemetry] = {}
_registry_lock = threading.Lock()


def _channel_key(name: str, session: Optional[str]) -> str:
    return name if session is None else f"{session}:{name}"


def get_telemetry(name: str, *, session: Optional[str] = None) -> OpTelemetry:
    """Named telemetry channel (benchmarks and sessions read these back).

    ``session`` namespaces the channel: two concurrent series sessions
    whose operators share a bare name (the default ``registration_B``)
    must not share cost/imbalance EMAs — a 2048-frame series would poison
    a 16-frame one's dispatch.  Anonymous callers (no session) fall back
    to the process-global channel, preserving the accumulate-across-runs
    behaviour benchmarks rely on.
    """
    key = _channel_key(name, session)
    with _registry_lock:
        tel = _registry.get(key)
        if tel is None:
            tel = _registry[key] = OpTelemetry(name=key)
        return tel


def release_telemetry(name: str, *, session: Optional[str] = None) -> None:
    """Drop a channel from the registry (session close — long-lived
    processes would otherwise accumulate one channel per finished series).
    Unknown channels are ignored."""
    with _registry_lock:
        _registry.pop(_channel_key(name, session), None)


def op_cost_from(op) -> Optional[float]:
    """Extract a telemetry-fed cost estimate from an operator, if it has one.

    Adapters expose ``op_cost_estimate`` as a float or a zero-arg callable
    returning a float (None when nothing has been observed yet).
    """
    est = getattr(op, "op_cost_estimate", None)
    if est is None:
        return None
    if callable(est):
        est = est()
    return float(est) if est is not None else None


def op_imbalance_from(op) -> Optional[float]:
    """Extract the operator's observed per-call cost imbalance (max/mean).

    Adapters expose ``op_imbalance_estimate`` (float or zero-arg callable;
    None when unobserved).  The dispatcher uses it to decide whether
    cross-segment stealing pays: a near-uniform operator gains nothing from
    the shared boundary gaps, a heavy-tailed one gains the paper's Fig. 5b.
    """
    est = getattr(op, "op_imbalance_estimate", None)
    if est is None:
        return None
    if callable(est):
        est = est()
    return float(est) if est is not None else None


def op_batchable_from(op) -> Optional[bool]:
    """Does the operator advertise a batched form?

    Adapters expose ``op_batchable`` (bool or zero-arg callable) when the
    operator accepts operands stacked along a new leading axis — e.g. pure
    deformation composition.  The dispatcher then runs element-domain
    phase 1 as one vmapped device launch (``Dispatch.device_phase1``)
    instead of WorkerPool threads.  None/absent means "unknown": never
    assume batchability.
    """
    est = getattr(op, "op_batchable", None)
    if est is None:
        return None
    if callable(est):
        est = est()
    return bool(est) if est is not None else None


def element_costs_from(op, n: int) -> Optional[list]:
    """Per-element cost priors from the operator's history, if it keeps any.

    Adapters expose ``element_cost_estimates`` as a sequence or a callable
    taking the element count; only a full-length vector is usable for
    ahead-of-time segment sizing (a partial one can't place boundaries).
    """
    src = getattr(op, "element_cost_estimates", None)
    if src is None:
        return None
    costs = src(n) if callable(src) else src
    if costs is None:
        return None
    costs = list(costs)
    return costs if len(costs) == n else None
