"""Process-wide persistent worker pool — the resident registration runtime.

The paper's setting is *streaming* acquisition: series arrive continuously
and several may be in flight at once.  Before this module, every
``stealing_reduce`` / hierarchical phase spawned a fresh army of OS threads
and threw it away at return — concurrent series oversubscribed the machine
and nothing was fair about who got the cores.  :class:`WorkerPool` replaces
that with one shared, long-lived executor:

* **long-lived workers** — threads are spawned lazily up to ``max_workers``
  and then reused; a scan call enqueues *tasks*, it never constructs
  threads (``tests/test_scheduler.py`` pins the zero-``threading.Thread``
  invariant on the work-stealing hot paths);
* **fair admission** — each ``run_tasks`` call forms a *task group* (one
  series' phase: segment reduces, stealing workers, interval applies) and
  workers claim tasks round-robin **across groups**, so a 4096-frame series
  cannot starve a 16-frame one that arrived later;
* **priority lanes** — ``run_tasks(..., priority=)`` places a group in a
  claim lane; at every yield point between tasks, workers claim from the
  highest non-empty lane exclusively (round-robin *within* a lane), and a
  task inherits its group's lane for the nested groups it submits.  The
  serving front end (``repro_torch.serving``) runs interactive tenants'
  ``feed``/``result`` scans under :func:`at_priority` so they jump ahead
  of long batch series without interrupting a task mid-flight;
* **caller helping** — the submitting thread drains its own group while it
  waits.  This makes nested submission (a segment task whose
  ``stealing_reduce`` submits its thread tasks) deadlock-free by
  construction: every group always has at least one thread working on it,
  and with zero workers the pool degrades to correct sequential execution;
* **occupancy / tenancy telemetry** — ``occupancy()`` (claimed + queued
  demand over capacity) and ``tenants()`` (element-domain scans currently
  admitted) feed the dispatcher (``engine/cost.py``): a saturated pool
  shifts small expensive-op series to the work-optimal sequential chain,
  and concurrent tenants shrink each other's effective worker budget
  instead of all sizing for an idle machine.

``max_workers`` is a *concurrency capacity*, deliberately larger than the
core count: the operators this pool runs are seconds-long and block in
GIL-releasing XLA compute (or ``time.sleep`` in the mock benchmarks), so
tasks overlap far beyond the cores exactly as the per-call threads did.
How much parallelism a single scan should *request* is the dispatcher's
decision, made from core count and tenancy — not the pool's.

:class:`TransientPool` preserves the legacy behaviour — fresh threads per
call — behind the same interface; it exists as the benchmark baseline
(``benchmarks/bench_serve.py``) and an isolation escape hatch.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.analysis.invariants import check_group_settled
from repro_torch.analysis.sync import invariants_enabled, sync_point


class _TaskGroup:
    """One ``run_tasks`` batch: claim cursor, results, first error.

    All mutation happens under the owning pool's condition lock.
    """

    __slots__ = (
        "fns", "label", "next", "completed", "results", "errors", "priority",
    )

    def __init__(
        self, fns: List[Callable[[], Any]], label: str, priority: int = 0
    ):
        self.fns = fns
        self.label = label
        self.priority = priority            # claim lane (higher wins)
        self.next = 0                       # next unclaimed task index
        self.completed = 0
        self.results: List[Any] = [None] * len(fns)
        self.errors: List[BaseException] = []

    def unclaimed(self) -> int:
        return len(self.fns) - self.next

    def done(self) -> bool:
        return self.completed == len(self.fns)


# Thread-local claim-lane level: a task executing on a worker inherits its
# group's priority, so the nested groups it submits (a segment task's
# stealing_reduce thread tasks, its phase-3 interval applies) land in the
# same lane as the scan that spawned them.  Without inheritance only the
# top-level segment group of an interactive scan would jump the lane and
# every nested phase would queue behind batch work again.
_task_priority = threading.local()


def current_priority() -> int:
    """The claim-lane priority ``run_tasks`` uses when none is passed:
    the priority of the group whose task this thread is executing, or 0."""
    return getattr(_task_priority, "value", 0)


@contextlib.contextmanager
def at_priority(level: int):
    """Run this thread's pool submissions at claim-lane ``level``.

    The serving front end wraps interactive requests in
    ``with at_priority(INTERACTIVE_PRIORITY):`` — every ``run_tasks`` the
    wrapped scan performs (and, via inheritance, every nested group its
    worker tasks submit) claims ahead of priority-0 batch work at the
    pool's yield points.  Purely cooperative: a task already executing is
    never interrupted.
    """
    prev = current_priority()
    _task_priority.value = level
    try:
        yield
    finally:
        _task_priority.value = prev


class WorkerPool:
    """Shared long-lived thread pool with fair cross-group task admission."""

    def __init__(self, max_workers: Optional[int] = None, *, name: str = "pool"):
        if max_workers is None:
            max_workers = default_capacity()
        if max_workers < 0:
            raise ValueError(f"max_workers must be >= 0, got {max_workers}")
        self.max_workers = max_workers
        self.name = name
        self._cond = threading.Condition()
        self._groups: List[_TaskGroup] = []  # groups with unclaimed tasks
        self._rr = 0                         # round-robin cursor over groups
        self._threads: List[threading.Thread] = []
        self._idle = 0
        self._claimed = 0                    # tasks currently executing on workers
        self._tenants = 0                    # admitted element-domain scans
        self._tenant_depth = threading.local()
        self._shutdown = False
        # Lifetime counters (benchmarks / introspection).
        self.tasks_completed = 0
        self.groups_submitted = 0
        # Happens-before sanitizer names (precomputed: sync_point argument
        # evaluation must stay cheap on the claim hot path when checking
        # is off).
        self._sp_state = f"pool{id(self)}.groups"
        self._sp_lock = f"pool{id(self)}.cond"

    # ------------------------------------------------------------- workers

    def _spawn_locked(self) -> None:
        """Ensure enough workers exist for the currently queued demand."""
        want = sum(g.unclaimed() for g in self._groups) - self._idle
        while want > 0 and len(self._threads) < self.max_workers:
            t = threading.Thread(
                target=self._worker_loop,
                daemon=True,
                name=f"{self.name}-w{len(self._threads)}",
            )
            self._threads.append(t)
            t.start()
            want -= 1

    def _claim_locked(self):
        """Claim the next task: priority lane first, round-robin within it.

        Groups in the highest non-empty priority lane are claimed from
        exclusively (an interactive ``result()``'s tasks jump every queued
        batch segment); groups sharing a lane keep the fair round-robin
        admission.  Each claim boundary is the pool's cooperative *yield
        point*: a worker finishing one segment task of a long batch scan
        re-enters here, sees the higher lane, and picks up the interactive
        work before touching the batch group's remaining tasks.
        """
        self._groups = [g for g in self._groups if g.unclaimed() > 0]
        if not self._groups:
            return None
        top = max(g.priority for g in self._groups)
        if top > 0:
            sync_point("pool.lane.priority", "read",
                       var=self._sp_state, lock=self._sp_lock)
        lane = [g for g in self._groups if g.priority == top]
        g = lane[self._rr % len(lane)]
        self._rr += 1
        idx = g.next
        g.next += 1
        sync_point("pool.claim", "write",
                   var=self._sp_state, lock=self._sp_lock)
        return g, idx

    def _complete_locked(self, group: _TaskGroup, idx: int, result, err) -> None:
        group.results[idx] = result
        if err is not None:
            group.errors.append(err)
        group.completed += 1
        self.tasks_completed += 1
        self._cond.notify_all()

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                claim = self._claim_locked()
                while claim is None:
                    if self._shutdown:
                        return
                    self._idle += 1
                    self._cond.wait()
                    self._idle -= 1
                    claim = self._claim_locked()
                self._claimed += 1
            group, idx = claim
            err = result = None
            prev_prio = current_priority()
            _task_priority.value = group.priority
            try:
                result = group.fns[idx]()
            except BaseException as e:  # noqa: BLE001 — re-raised at run_tasks
                err = e
            finally:
                _task_priority.value = prev_prio
            with self._cond:
                self._claimed -= 1
                self._complete_locked(group, idx, result, err)

    # ------------------------------------------------------------- submit

    def run_tasks(
        self,
        fns: Sequence[Callable[[], Any]],
        *,
        label: str = "tasks",
        priority: Optional[int] = None,
    ) -> List[Any]:
        """Run ``fns`` to completion, return their results in order.

        Tasks may execute on pool workers *and* on the calling thread (the
        caller helps drain its own group while waiting), so nested
        ``run_tasks`` from inside a task cannot deadlock.  The first task
        exception is re-raised here after the whole group has settled.

        ``priority`` selects the claim lane (default: the caller's
        inherited :func:`current_priority`, 0 outside any task).  Higher
        lanes are claimed from exclusively at every yield point between
        tasks; admission within a lane stays round-robin fair.  Priority
        is cooperative — it never interrupts a task already executing —
        and a sustained higher lane starves lower ones by design (the
        serving front end bounds how long it keeps a lane elevated).
        """
        fns = list(fns)
        if not fns:
            return []
        group = _TaskGroup(
            fns, label,
            current_priority() if priority is None else priority,
        )
        with self._cond:
            if self._shutdown:
                raise RuntimeError(f"pool {self.name!r} is shut down")
            self._groups.append(group)
            self.groups_submitted += 1
            self._spawn_locked()
            self._cond.notify_all()
        while True:
            with self._cond:
                if group.done():
                    break
                if group.unclaimed() > 0:
                    idx = group.next
                    group.next += 1
                    sync_point("pool.claim", "write",
                               var=self._sp_state, lock=self._sp_lock)
                    # Helper-claimed tasks are demand like any other:
                    # occupancy() must see them or a saturated pool of
                    # helping callers reads as idle.
                    self._claimed += 1
                else:
                    # Everything is claimed but still running on workers.
                    self._cond.wait(timeout=0.1)
                    continue
            err = result = None
            # Helper-claimed tasks run in the group's lane too: a nested
            # submission from a helper must inherit the same priority it
            # would have inherited on a worker.
            prev_prio = current_priority()
            _task_priority.value = group.priority
            try:
                result = group.fns[idx]()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err = e
            finally:
                _task_priority.value = prev_prio
            with self._cond:
                self._claimed -= 1
                self._complete_locked(group, idx, result, err)
        if invariants_enabled():
            # The group a caller returns from must be fully settled: every
            # task claimed exactly once and every claim completed.
            with self._cond:
                check_group_settled(len(fns), group.next, group.completed)
        if group.errors:
            raise group.errors[0]
        return group.results

    # ----------------------------------------------------------- telemetry

    @property
    def num_workers(self) -> int:
        """Workers spawned so far (grows lazily toward ``max_workers``)."""
        with self._cond:
            return len(self._threads)

    def queued(self) -> int:
        """Tasks admitted but not yet claimed by any thread."""
        with self._cond:
            return sum(g.unclaimed() for g in self._groups)

    def occupancy(self) -> float:
        """Demand over capacity: (executing + queued) / max_workers.

        >= 1.0 means saturated — every worker the pool may ever have is
        spoken for and new tasks will queue.  The dispatcher reads this
        (``engine/cost.py:POOL_BUSY_OCCUPANCY``).
        """
        with self._cond:
            demand = self._claimed + sum(g.unclaimed() for g in self._groups)
        if self.max_workers == 0:
            return float("inf") if demand else 0.0
        return demand / self.max_workers

    def tenants(self) -> int:
        """Element-domain scans currently admitted (including the caller's,
        when called from inside its own ``tenant()`` block)."""
        with self._cond:
            return self._tenants

    @contextlib.contextmanager
    def tenant(self):
        """Admission scope for one element-domain scan.

        Re-entrant per thread: only the outermost block counts, so a caller
        (``service.SeriesSession``) can admit itself for dispatch and the
        engine's own admission inside the same call does not double-count.
        """
        depth = getattr(self._tenant_depth, "value", 0)
        self._tenant_depth.value = depth + 1
        if depth == 0:
            with self._cond:
                self._tenants += 1
        try:
            yield self
        finally:
            self._tenant_depth.value = depth
            if depth == 0:
                with self._cond:
                    self._tenants -= 1

    # ------------------------------------------------------------ shutdown

    def shutdown(self) -> None:
        """Stop accepting work and wake idle workers (threads are daemons)."""
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait up to ``timeout`` seconds per worker for the workers of a
        shut-down pool to exit.  A process that used the pool for PyTorch
        work joins it before exiting: a daemon worker still alive at exit
        can abort the process while PyTorch tears down."""
        with self._cond:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)


class TransientPool:
    """Legacy per-call executor: fresh OS threads for every ``run_tasks``.

    This is exactly what ``stealing_reduce`` did before the shared runtime —
    kept behind the :class:`WorkerPool` interface as the baseline that
    ``benchmarks/bench_serve.py`` measures the shared pool against, and as
    an isolation escape hatch (a transient pool shares nothing, so a
    pathological tenant cannot affect other series).
    """

    max_workers = 0  # capacity is unbounded but never resident

    def __init__(self, *, name: str = "transient"):
        self.name = name
        self.tasks_completed = 0
        self.groups_submitted = 0
        self.threads_spawned = 0

    def run_tasks(
        self,
        fns: Sequence[Callable[[], Any]],
        *,
        label: str = "tasks",
        priority: Optional[int] = None,
    ) -> List[Any]:
        fns = list(fns)
        if not fns:
            return []
        results: List[Any] = [None] * len(fns)
        errors: List[BaseException] = []
        lock = threading.Lock()

        def call(i: int) -> None:
            try:
                results[i] = fns[i]()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                with lock:
                    errors.append(e)

        threads = [
            threading.Thread(target=call, args=(i,))
            for i in range(1, len(fns))
        ]
        for t in threads:
            t.start()
        call(0)  # caller runs one task itself, like the helping pool
        for t in threads:
            t.join()
        self.groups_submitted += 1
        self.tasks_completed += len(fns)
        self.threads_spawned += len(threads)
        if errors:
            raise errors[0]
        return results

    def occupancy(self) -> float:
        return 0.0

    def tenants(self) -> int:
        return 0

    @contextlib.contextmanager
    def tenant(self):
        yield self

    def shutdown(self) -> None:
        pass


class DaemonHandle:
    """Handle to a service thread spawned via :func:`spawn_daemon`.

    The wrapped target's exception (if any) is captured into ``errors`` —
    a daemon that dies silently strands its consumer on a queue forever,
    so consumers poll :meth:`error` (or pass their own ``error_sink``)
    instead of discovering the loss by deadlock.
    """

    __slots__ = ("thread", "errors")

    def __init__(self, thread: threading.Thread, errors: List[BaseException]):
        self.thread = thread
        self.errors = errors

    def error(self) -> Optional[BaseException]:
        return self.errors[0] if self.errors else None

    def alive(self) -> bool:
        return self.thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> None:
        self.thread.join(timeout)


def spawn_daemon(
    target: Callable[[], None],
    *,
    name: str = "repro_torch-daemon",
    error_sink: Optional[List[BaseException]] = None,
) -> DaemonHandle:
    """Spawn a long-lived daemon *service* thread (prefetch producers,
    monitors) — the one sanctioned thread-construction point outside the
    pool itself.

    Hot-path compute must go through a :class:`WorkerPool` (the lint pass
    THR001 enforces that); this helper exists for the streaming producers
    whose lifetime is a generator's, not a task group's.  The target runs
    wrapped so a crash is recorded in the returned handle (or the caller's
    ``error_sink`` list) rather than vanishing with the thread.
    """
    errors: List[BaseException] = error_sink if error_sink is not None else []

    def _run() -> None:
        try:
            target()
        except BaseException as e:  # noqa: BLE001 — surfaced via the handle
            errors.append(e)

    t = threading.Thread(target=_run, daemon=True, name=name)
    handle = DaemonHandle(t, errors)
    t.start()
    return handle


def default_capacity() -> int:
    """Default worker capacity: generous relative to cores (see module doc —
    tasks block in GIL-releasing operator applications, so concurrency well
    beyond the core count is the paper's normal operating point)."""
    return max(32, 4 * (os.cpu_count() or 1))


_default_pool: Optional[WorkerPool] = None
_default_lock = threading.Lock()


def get_default_pool() -> WorkerPool:
    """The process-wide shared pool every scan uses unless injected."""
    global _default_pool
    with _default_lock:
        if _default_pool is None or _default_pool._shutdown:
            _default_pool = WorkerPool(name="repro_torch-shared")
        return _default_pool


def set_default_pool(pool: Optional[WorkerPool]) -> None:
    """Replace the process-wide pool (tests / embedding applications).

    ``None`` resets to a fresh lazily-created pool on next use.
    """
    global _default_pool
    with _default_lock:
        _default_pool = pool
