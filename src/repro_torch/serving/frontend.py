"""SLO-aware async front end over the shared registration runtime.

Everything below :class:`~repro_torch.service.SeriesSession` executes whatever it
is handed, immediately — so before this module existed, one straggler
series could occupy the process-wide WorkerPool and every other caller
just waited.  :class:`RegistrationFrontend` is the admission-and-dispatch
layer that makes the runtime safe to expose to many callers:

* **Bounded per-tenant queues, explicit rejection.**  Every tenant gets a
  queue of at most ``queue_depth`` requests.  A submit against a full
  queue raises :class:`AdmissionError` *immediately* — backpressure is the
  caller's signal to shed or retry, and a full tenant can never block or
  slow another tenant's admission (``tests/test_torch_serving.py`` pins
  reject-not-block).
* **Pluggable dispatch policies** (:mod:`repro_torch.serving.policies`): which
  queued request runs next — ``fifo``, ``round_robin`` (any tenant waits
  O(#tenants) turns), or ``sewf`` (shortest expected work first, priced by
  the per-tenant operator-cost EMAs this front end records into
  :mod:`repro_torch.core.engine.telemetry`).
* **Priority lanes / preemption.**  Tenants registered ``interactive=True``
  dispatch ahead of batch tenants, and their requests execute inside
  :func:`repro_torch.runtime.scheduler.at_priority` — every pool group their
  scans submit claims ahead of queued batch segment tasks at the pool's
  yield points (cooperative: a segment task already executing finishes;
  the next claim goes to the interactive lane).
* **Latency accounting.**  Tickets timestamp arrival → dispatch → done with
  an injectable clock; the reference's ``benchmarks/bench_slo.py`` turns
  those into HDR-style histograms under open-loop Poisson load and gates p99.

Threading model: ``submit``/``feed``/``result``/``extend`` and
``dispatch_one`` are thread-safe and non-blocking (admission either
enqueues or raises; it never waits).  Request *execution* happens on the
front end's dispatcher daemons (``dispatch_workers`` of them, spawned via
the sanctioned :func:`repro_torch.runtime.scheduler.spawn_daemon`) — or on
whichever thread calls :meth:`RegistrationFrontend.dispatch_one` when
constructed with ``auto_dispatch=False`` (deterministic tests, embedding
event loops).  :meth:`Ticket.wait` / :meth:`Ticket.result` are the only
blocking calls, and they block only the caller.  Requests that target the
same session never execute concurrently or out of submission order (a
series is one ordered stream); requests for different sessions and raw
calls interleave freely.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from repro_torch.analysis.sync import sync_point
from repro_torch.core.engine.telemetry import get_telemetry, release_telemetry
from repro_torch.runtime.scheduler import at_priority, get_default_pool, spawn_daemon
from repro_torch.serving.policies import QueueView, get_policy

#: Claim-lane level interactive tenants run at (batch work runs at 0).
INTERACTIVE_PRIORITY = 10


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Knobs for :class:`RegistrationFrontend`.

    ``policy``: dispatch policy name (``fifo`` / ``round_robin`` / ``sewf``
    — see :mod:`repro_torch.serving.policies` for when to use which).
    ``queue_depth``: default per-tenant admission bound (a tenant can
    override at :meth:`RegistrationFrontend.add_tenant`).
    ``dispatch_workers``: dispatcher daemons executing requests; 1 gives
    the clean single-server queueing model ``bench_slo.py`` measures,
    more overlap requests from different sessions.
    ``interactive_priority``: the claim-lane level ``interactive=True``
    tenants dispatch and execute at.
    """

    policy: str = "round_robin"
    queue_depth: int = 8
    dispatch_workers: int = 1
    interactive_priority: int = INTERACTIVE_PRIORITY

    def __post_init__(self):
        if self.queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.dispatch_workers < 0:
            raise ValueError(
                f"dispatch_workers must be >= 0, got {self.dispatch_workers}"
            )


class AdmissionError(RuntimeError):
    """A tenant's queue is full: the request was rejected, not queued.

    Raised synchronously at submit time — admission never blocks.  The
    caller decides: shed the request, retry after backoff, or treat it as
    the saturation signal it is (see docs/SERVING.md's runbook).
    """

    def __init__(self, tenant: str, depth: int):
        super().__init__(
            f"tenant {tenant!r} queue full ({depth} queued); "
            "rejecting instead of blocking"
        )
        self.tenant = tenant
        self.depth = depth


class FrontendClosedError(RuntimeError):
    """The front end shut down before this request was dispatched."""


class Ticket:
    """Handle to one admitted request: completion event + latency record.

    Timestamps are in the front end's clock units (``time.perf_counter``
    seconds unless a fake clock was injected): ``t_arrival`` at admission,
    ``t_dispatch`` when a dispatcher picked the request, ``t_done`` at
    completion.  ``turns_waited`` counts dispatch turns between admission
    and dispatch — the clock-free fairness measure the round-robin bound
    is stated in.
    """

    __slots__ = (
        "tenant", "kind", "seq", "t_arrival", "t_dispatch", "t_done",
        "arrival_turn", "dispatch_turn", "_event", "_value", "_error",
    )

    def __init__(self, tenant: str, kind: str, seq: int, t_arrival: float,
                 arrival_turn: int):
        self.tenant = tenant
        self.kind = kind
        self.seq = seq
        self.t_arrival = t_arrival
        self.t_dispatch: Optional[float] = None
        self.t_done: Optional[float] = None
        self.arrival_turn = arrival_turn
        self.dispatch_turn: Optional[int] = None
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- waiting

    @property
    def done(self) -> bool:
        """True once the request completed (successfully or not)."""
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block the *calling* thread until completion; True if completed."""
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> Any:
        """Wait and return the request's value, re-raising its exception."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.kind!r} for tenant {self.tenant!r} not done "
                f"after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._value

    def _complete(self, value: Any, error: Optional[BaseException],
                  t_done: float) -> None:
        self._value = value
        self._error = error
        self.t_done = t_done
        self._event.set()

    # ------------------------------------------------------------- latency

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Seconds spent queued (arrival -> dispatch); None until dispatched."""
        if self.t_dispatch is None:
            return None
        return self.t_dispatch - self.t_arrival

    @property
    def service_s(self) -> Optional[float]:
        """Seconds executing (dispatch -> done); None until done."""
        if self.t_done is None or self.t_dispatch is None:
            return None
        return self.t_done - self.t_dispatch

    @property
    def latency_s(self) -> Optional[float]:
        """End-to-end seconds (arrival -> done); None until done."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_arrival

    @property
    def turns_waited(self) -> Optional[int]:
        """Dispatch turns this request sat queued; None until dispatched."""
        if self.dispatch_turn is None:
            return None
        return self.dispatch_turn - self.arrival_turn


@dataclasses.dataclass
class _Request:
    tenant: str
    kind: str
    fn: Callable[[], Any]
    items: int                       # work units (elements) for SEWF pricing
    session_key: Optional[str]       # serialize requests per session
    ticket: Ticket


class _Tenant:
    __slots__ = (
        "name", "queue", "depth", "priority", "telemetry",
        "admitted", "rejected", "completed", "failed",
    )

    def __init__(self, name: str, depth: int, priority: int, telemetry):
        self.name = name
        self.queue: Deque[_Request] = deque()
        self.depth = depth
        self.priority = priority
        self.telemetry = telemetry
        self.admitted = 0
        self.rejected = 0
        self.completed = 0
        self.failed = 0


_frontend_ids = itertools.count()


class RegistrationFrontend:
    """Admission + dispatch + priority over the shared registration runtime.

    See the module docstring for the threading model.  Typical lifecycle::

        fe = RegistrationFrontend(FrontendConfig(policy="round_robin"))
        fe.add_tenant("scope-7", interactive=True)
        fe.add_tenant("overnight-batch", queue_depth=4)
        sid = fe.open_series("scope-7", cfg)
        ticket = fe.feed("scope-7", sid, chunk)    # -> Ticket, or raises
        ...                                        #    AdmissionError
        res = fe.result("scope-7", sid).result(timeout=30)
        fe.close()
    """

    def __init__(
        self,
        cfg: Optional[FrontendConfig] = None,
        *,
        pool=None,
        clock: Callable[[], float] = time.perf_counter,
        auto_dispatch: bool = True,
    ):
        self.cfg = cfg if cfg is not None else FrontendConfig()
        self.pool = pool if pool is not None else get_default_pool()
        self._clock = clock
        self._id = next(_frontend_ids)
        self._cond = threading.Condition()
        self._tenants: Dict[str, _Tenant] = {}   # insertion = policy order
        self._policy = get_policy(self.cfg.policy)
        self._seq = itertools.count()
        self._turns = 0                          # completed dispatch turns
        self._sessions: Dict[str, Any] = {}
        self._busy: set = set()                  # session keys mid-execution
        self._stop = False
        # Happens-before sanitizer names, precomputed so the sync_point
        # call sites stay cheap when checking is off (constant attribute
        # loads, no per-call string building).
        self._sp_state = f"frontend{self._id}.queues"
        self._sp_lock = f"frontend{self._id}.cond"
        self._dispatchers = []
        if auto_dispatch:
            for i in range(self.cfg.dispatch_workers):
                self._dispatchers.append(spawn_daemon(
                    self._dispatch_loop, name=f"serving{self._id}-d{i}"
                ))

    # ------------------------------------------------------------- tenants

    def add_tenant(
        self,
        name: str,
        *,
        queue_depth: Optional[int] = None,
        interactive: bool = False,
        priority: Optional[int] = None,
    ) -> None:
        """Register a tenant (idempotent-free: a duplicate name raises).

        ``interactive=True`` puts the tenant in the high-priority lane:
        dispatched before any batch tenant's work and executed under
        :func:`~repro_torch.runtime.scheduler.at_priority`, so its scans claim
        ahead on the WorkerPool too.  ``priority`` overrides the lane
        level explicitly (higher wins).
        """
        depth = queue_depth if queue_depth is not None else self.cfg.queue_depth
        if depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {depth}")
        prio = priority if priority is not None else (
            self.cfg.interactive_priority if interactive else 0
        )
        with self._cond:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = _Tenant(
                name, depth, prio,
                get_telemetry(name, session=f"serving{self._id}"),
            )

    # ------------------------------------------------------------ sessions

    def open_series(self, tenant: str, cfg=None, **open_kwargs) -> str:
        """Open a :class:`~repro_torch.service.SeriesSession` owned by ``tenant``.

        Synchronous (opening allocates no compute); returns the session id
        used by :meth:`feed` / :meth:`result` / :meth:`extend`.  Extra
        keyword arguments forward to :func:`repro_torch.service.open_series`
        (``device=``, ``checkpoint_dir=``, ``compile_cache_dir=`` ...); with
        no ``device`` the session runs on the card.  The session always
        executes on this front end's pool.
        """
        from repro_torch.service import open_series

        self._tenant_of(tenant)  # validate before allocating
        session = open_series(cfg, pool=self.pool, **open_kwargs)
        with self._cond:
            self._sessions[session.id] = session
        return session.id

    def feed(self, tenant: str, session_id: str, chunk) -> Ticket:
        """Queue a ``session.feed(chunk)``; raises :class:`AdmissionError`
        when the tenant's queue is full.  Never blocks."""
        session = self._session_of(session_id)
        n_items = max(1, len(chunk))
        return self._submit(
            tenant, "feed", lambda: session.feed(chunk),
            items=n_items, session_key=session_id,
        )

    def result(self, tenant: str, session_id: str) -> Ticket:
        """Queue a ``session.result()`` (returns the SeriesResult so far)."""
        session = self._session_of(session_id)
        return self._submit(
            tenant, "result", session.result, items=1, session_key=session_id,
        )

    def extend(self, tenant: str, session_id: str, frames) -> Ticket:
        """Queue a ``session.extend(frames)`` — O(new) incremental fold."""
        session = self._session_of(session_id)
        n_items = max(1, len(frames))
        return self._submit(
            tenant, "extend", lambda: session.extend(frames),
            items=n_items, session_key=session_id,
        )

    def close_series(self, tenant: str, session_id: str) -> Ticket:
        """Queue the session close behind its earlier requests."""
        session = self._session_of(session_id)

        def _close():
            session.close()
            with self._cond:
                self._sessions.pop(session_id, None)

        return self._submit(
            tenant, "close", _close, items=1, session_key=session_id,
        )

    def call(
        self,
        tenant: str,
        fn: Callable[[], Any],
        *,
        kind: str = "call",
        items: int = 1,
    ) -> Ticket:
        """Queue a raw callable under ``tenant``'s admission and priority.

        The load generator / benchmarks / tests use this to drive the
        admission, dispatch and latency machinery with controlled mock
        work; production callers want the session verbs above.  ``items``
        prices the request for the ``sewf`` policy (expected seconds =
        items x the tenant's recorded per-item cost EMA).
        """
        return self._submit(tenant, kind, fn, items=items, session_key=None)

    # ------------------------------------------------------------ admission

    # `_cond`'s default lock is an RLock, so these lookups stay safe to
    # call from inside `_submit`'s locked section and from bare call sites
    # alike — re-entry just recurses the lock.

    def _tenant_of(self, name: str) -> _Tenant:
        with self._cond:
            try:
                return self._tenants[name]
            except KeyError:
                raise ValueError(
                    f"unknown tenant {name!r}; add_tenant() first "
                    f"(known: {sorted(self._tenants)})"
                ) from None

    def _session_of(self, session_id: str):
        with self._cond:
            try:
                return self._sessions[session_id]
            except KeyError:
                raise ValueError(
                    f"unknown session {session_id!r}; open_series() first"
                ) from None

    def _submit(self, tenant: str, kind: str, fn, *, items: int,
                session_key: Optional[str]) -> Ticket:
        with self._cond:
            if self._stop:
                raise FrontendClosedError("front end is closed")
            t = self._tenant_of(tenant)
            if len(t.queue) >= t.depth:
                t.rejected += 1
                sync_point("serve.reject", "read",
                           var=self._sp_state, lock=self._sp_lock)
                raise AdmissionError(tenant, t.depth)
            ticket = Ticket(tenant, kind, next(self._seq), self._clock(),
                            self._turns)
            t.queue.append(_Request(tenant, kind, fn, items, session_key,
                                    ticket))
            t.admitted += 1
            sync_point("serve.submit", "write",
                       var=self._sp_state, lock=self._sp_lock)
            self._cond.notify_all()
        return ticket

    # ------------------------------------------------------------- dispatch

    def _pick_locked(self) -> Optional[_Request]:
        """Choose and pop the next runnable request (policy + priority).

        A tenant whose head request targets a session that is currently
        executing is not runnable (per-session order must hold); requests
        behind it in that tenant's queue stay queued too — a tenant's own
        queue is strictly FIFO.
        """
        views: List[QueueView] = []
        for t in self._tenants.values():
            if not t.queue:
                continue
            head = t.queue[0]
            if head.session_key is not None and head.session_key in self._busy:
                continue
            est = t.telemetry.estimate()
            views.append(QueueView(
                tenant=t.name,
                depth=len(t.queue),
                head_seq=head.ticket.seq,
                head_work=(est or 0.0) * head.items,
                priority=t.priority,
            ))
        if not views:
            return None
        top = max(v.priority for v in views)
        lane = [v for v in views if v.priority == top]
        chosen = self._policy.select(lane)
        if chosen is None:
            return None
        t = self._tenants[chosen]
        req = t.queue.popleft()
        if req.session_key is not None:
            self._busy.add(req.session_key)
        req.ticket.dispatch_turn = self._turns
        self._turns += 1
        req.ticket.t_dispatch = self._clock()
        sync_point("serve.pick", "write",
                   var=self._sp_state, lock=self._sp_lock)
        return req

    def _execute(self, req: _Request) -> None:
        with self._cond:
            t = self._tenants[req.tenant]
        value = None
        error: Optional[BaseException] = None
        try:
            if t.priority > 0:
                with at_priority(t.priority):
                    value = req.fn()
            else:
                value = req.fn()
        except BaseException as e:  # noqa: BLE001 — recorded on the ticket
            error = e
        t_done = self._clock()
        with self._cond:
            if req.session_key is not None:
                self._busy.discard(req.session_key)
            if error is None:
                t.completed += 1
                service = t_done - (req.ticket.t_dispatch or t_done)
                # Per-item cost EMA: what the sewf policy prices heads by.
                t.telemetry.record(service / max(req.items, 1))
            else:
                t.failed += 1
            sync_point("serve.complete", "write",
                       var=self._sp_state, lock=self._sp_lock)
            self._cond.notify_all()
        req.ticket._complete(value, error, t_done)

    def dispatch_one(self) -> bool:
        """Dispatch and execute one request on the calling thread.

        Returns False when nothing is runnable.  This is the whole
        dispatcher: the daemons just call it in a loop, and tests /
        embedding event loops (``auto_dispatch=False``) call it directly
        for deterministic stepping.
        """
        with self._cond:
            req = self._pick_locked()
        if req is None:
            return False
        self._execute(req)
        return True

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                req = self._pick_locked()
                while req is None:
                    if self._stop:
                        return
                    # Timeout, not pure wait: a head blocked on a busy
                    # session becomes runnable on completion notify, but a
                    # lost race is cheap to retry.
                    self._cond.wait(timeout=0.05)
                    req = self._pick_locked()
            self._execute(req)

    # ------------------------------------------------------------ telemetry

    def stats(self) -> Dict[str, Any]:
        """Saturation snapshot: per-tenant queue/counters + pool signals.

        The runbook in docs/SERVING.md reads this: rising ``rejected``
        with high ``pool_occupancy`` is overload; rising ``rejected`` with
        a *low* occupancy points at dispatch starvation or a stuck
        session.
        """
        with self._cond:
            tenants = {
                t.name: {
                    "queued": len(t.queue),
                    "depth": t.depth,
                    "priority": t.priority,
                    "admitted": t.admitted,
                    "rejected": t.rejected,
                    "completed": t.completed,
                    "failed": t.failed,
                    "ema_s_per_item": t.telemetry.estimate(),
                }
                for t in self._tenants.values()
            }
            turns = self._turns
            sessions = len(self._sessions)
        return {
            "policy": self._policy.name,
            "turns": turns,
            "sessions": sessions,
            "tenants": tenants,
            "pool_occupancy": self.pool.occupancy(),
            "pool_tenants": self.pool.tenants(),
        }

    # ------------------------------------------------------------- lifetime

    def close(self, *, timeout: float = 2.0) -> None:
        """Stop dispatching, fail queued requests, close owned sessions.

        Requests already executing finish normally (their tickets
        complete); still-queued requests complete with
        :class:`FrontendClosedError`.  Dispatcher daemons are joined
        best-effort for ``timeout`` seconds — one blocked inside a request
        dies with the process (they are daemons).
        """
        with self._cond:
            if self._stop:
                return
            self._stop = True
            dropped: List[_Request] = []
            tenants = list(self._tenants.values())
            for t in tenants:
                dropped.extend(t.queue)
                t.queue.clear()
            sessions = list(self._sessions.values())
            self._sessions.clear()
            self._cond.notify_all()
        t_now = self._clock()
        for req in dropped:
            req.ticket._complete(
                None, FrontendClosedError("front end closed before dispatch"),
                t_now,
            )
        for d in self._dispatchers:
            d.join(timeout)
        for session in sessions:
            session.close()
        for t in tenants:
            release_telemetry(t.name, session=f"serving{self._id}")

    def __enter__(self) -> "RegistrationFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
