"""Registration-as-a-service: SLO-aware front end over the shared runtime
(port of ``repro/serving``; the modules are copies with the import paths
changed).  Its sessions are the port's, so they run on the card unless
``open_series(..., device="cpu")`` asks otherwise.

Public surface:

* :class:`RegistrationFrontend` / :class:`FrontendConfig` — admission
  (bounded per-tenant queues, reject-not-block), pluggable dispatch,
  priority lanes over the shared WorkerPool.
* :mod:`~repro_torch.serving.policies` — ``fifo`` / ``round_robin`` / ``sewf``
  dispatch policies and the :class:`~repro_torch.serving.policies.QueueView`
  protocol for writing new ones.
* :mod:`~repro_torch.serving.loadgen` — open-loop Poisson load generation and
  HDR-style latency histograms (what the reference's
  ``benchmarks/bench_slo.py`` runs).

See docs/SERVING.md for the operator's guide (written for the reference;
the port's front end has the same API).
"""

from repro_torch.serving.frontend import (
    INTERACTIVE_PRIORITY,
    AdmissionError,
    FrontendClosedError,
    FrontendConfig,
    RegistrationFrontend,
    Ticket,
)
from repro_torch.serving.loadgen import (
    LatencyHistogram,
    LoadResult,
    poisson_arrivals,
    run_open_loop,
)
from repro_torch.serving.policies import (
    DispatchPolicy,
    FifoPolicy,
    QueueView,
    RoundRobinPolicy,
    ShortestExpectedWorkPolicy,
    get_policy,
    policy_names,
)

__all__ = [
    "AdmissionError",
    "DispatchPolicy",
    "FifoPolicy",
    "FrontendClosedError",
    "FrontendConfig",
    "INTERACTIVE_PRIORITY",
    "LatencyHistogram",
    "LoadResult",
    "QueueView",
    "RegistrationFrontend",
    "RoundRobinPolicy",
    "ShortestExpectedWorkPolicy",
    "Ticket",
    "get_policy",
    "policy_names",
    "poisson_arrivals",
    "run_open_loop",
]
