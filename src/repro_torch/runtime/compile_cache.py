"""Compilation caches: warm-start the registration hot path.

Port of ``repro/runtime/compile_cache.py``.  The reference removes XLA
compilation from a series' first chunk with three layers; in the port:

1. **In-process callable cache** (:class:`CompileCache`): built callables
   keyed by ``(fn role, shapes, dtype, config, device)``.  The session's
   batched function-A launcher is built once per (chunk length, frame
   shape, registration config, device) signature and reused across feeds,
   sessions and series; hit/miss/build-second counters are surfaced per
   session (``SeriesResult.report()``).  PyTorch runs eagerly, so there is
   no ahead-of-time lowering: ``lower_args`` is accepted for the
   reference's signature and ignored, and the cached object is the callable
   itself.  What a miss pays is its build function's work — on the card, the
   one-time ``nvcc`` build (or on-disk load) of the kernels the launcher's
   session will run.
2. **Persistent executables.**  The reference points
   ``jax_compilation_cache_dir`` at the cache directory.  The port has no
   XLA executables to persist; its compiled artifacts are the ``nvcc``
   libraries, which already persist under ``build/torch_kernels/`` keyed by
   a hash of their sources (``kernels/_cuda.py``).  :func:`set_cache_dir`
   therefore returns False.
3. **Plan store** (:class:`PlanStore`): lowered
   :class:`~repro_torch.core.engine.plan.ExecutionPlan` schedules pickled
   under the cache directory.  ``get_plan`` consults the store on an LRU
   miss, so a fresh process skips the symbolic circuit trace for every
   schedule any previous run has lowered (backend ``scratch`` memos are
   stripped before pickling — they hold device tensors and are rebuilt
   lazily).  As in the reference, a plan is stored when it is lowered: a
   plan this process lowered before the store was attached stays out of it.

Everything here is dependency-free and failure-tolerant: a broken cache dir
never breaks a scan, it only forfeits the warm start.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import threading
import time
from typing import Any, Callable, Dict, Optional

__all__ = [
    "CompileCache",
    "PlanStore",
    "get_compile_cache",
    "get_plan_store",
    "reset_compile_cache",
    "set_cache_dir",
]


class CompileCache:
    """Thread-safe cache of built callables.

    ``get_compiled(key, build)`` returns the cached callable for ``key``; on
    a miss it calls ``build()``, times it, and caches the result.
    ``lower_args`` is the reference's ahead-of-time lowering input; eager
    PyTorch has no such step, so it is ignored.

    ``counters`` lets a caller (a series session) accumulate its own view
    of hits/misses/build seconds on top of the process-wide totals.
    """

    def __init__(self):
        self._fns: Dict[Any, Any] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.compile_seconds = 0.0

    def get_compiled(
        self,
        key: Any,
        build: Callable[[], Callable],
        *,
        lower_args: Optional[tuple] = None,
        counters: Optional[Dict[str, float]] = None,
    ):
        del lower_args  # no ahead-of-time lowering in eager PyTorch
        with self._lock:
            fn = self._fns.get(key)
            if fn is not None:
                self.hits += 1
                if counters is not None:
                    counters["hits"] = counters.get("hits", 0) + 1
                return fn
        # Build outside the lock: a long kernel build must not serialize
        # unrelated sessions.  A racing duplicate build is wasted work, not
        # an error — last writer wins on identical callables.
        t0 = time.perf_counter()
        fn = build()
        dt = time.perf_counter() - t0
        with self._lock:
            self.misses += 1
            self.compile_seconds += dt
            self._fns[key] = fn
        if counters is not None:
            counters["misses"] = counters.get("misses", 0) + 1
            counters["compile_s"] = counters.get("compile_s", 0.0) + dt
        return fn

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "compile_s": self.compile_seconds,
                "size": len(self._fns),
            }

    def clear(self) -> None:
        with self._lock:
            self._fns.clear()
            self.hits = 0
            self.misses = 0
            self.compile_seconds = 0.0


class PlanStore:
    """Pickle-per-key persistent store for lowered execution plans.

    Keys are the ``get_plan`` cache keys (name, n, mask key); each plan
    lives in its own file named by the key's sha1, so concurrent processes
    never contend on one index file.  Writes go through a same-directory
    temp file + ``os.replace`` (atomic on POSIX); loads tolerate missing,
    truncated or version-incompatible files by returning None.
    """

    def __init__(self, directory: str):
        self.directory = os.path.join(directory, "plans")
        os.makedirs(self.directory, exist_ok=True)
        # The hit counters are read by cache stats while worker threads
        # load/store plans concurrently; `n += 1` is not atomic.
        self._lock = threading.Lock()
        self.loads = 0
        self.stores = 0

    def _path(self, key: Any) -> str:
        digest = hashlib.sha1(repr(key).encode()).hexdigest()
        return os.path.join(self.directory, f"{digest}.pkl")

    def load(self, key: Any):
        try:
            with open(self._path(key), "rb") as f:
                plan = pickle.load(f)
        except (OSError, pickle.UnpicklingError, EOFError, AttributeError,
                ImportError, IndexError):
            return None
        with self._lock:
            self.loads += 1
        return plan

    def store(self, key: Any, plan) -> bool:
        # Backend scratch memos hold device tensors (index tables, a
        # kernel's operand list) — rebuilt lazily on the device that runs
        # the plan, so persist the plan without them.
        plan = dataclasses.replace(plan, scratch={})
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(plan, f)
            os.replace(tmp, path)
        except (OSError, pickle.PicklingError, TypeError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        with self._lock:
            self.stores += 1
        return True


_cache = CompileCache()
_plan_store: Optional[PlanStore] = None
_state_lock = threading.Lock()


def get_compile_cache() -> CompileCache:
    """The process-wide callable cache."""
    return _cache


def get_plan_store() -> Optional[PlanStore]:
    """The persistent plan store, or None until ``set_cache_dir`` ran."""
    return _plan_store


def reset_compile_cache() -> None:
    """Drop all in-process cached callables and detach the plan store
    (tests; the on-disk store is left intact)."""
    global _plan_store
    with _state_lock:
        _cache.clear()
        _plan_store = None


def set_cache_dir(path: str) -> bool:
    """Attach the plan store at ``path``; create the directory if needed.

    Returns False: the reference returns True when JAX's persistent
    compilation cache accepted the directory, and the port has no such
    cache (its ``nvcc`` libraries persist under ``build/torch_kernels/``
    whatever this is given).  What survives a restart is the plan store.
    """
    global _plan_store
    path = os.fspath(path)
    os.makedirs(path, exist_ok=True)
    with _state_lock:
        _plan_store = PlanStore(path)
    return False
