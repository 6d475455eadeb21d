"""The port's compile cache (``repro_torch.runtime.compile_cache``): the
cases of ``tests/test_compile_cache.py`` — callable cache, plan store, the
compile-time/telemetry split, the session's warm start — plus the plans the
store returns held against the reference's, and a restore in a fresh
process whose plans come from the store."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.engine.plan import get_plan, plan_cache
from repro_torch.core.engine.telemetry import OpTelemetry
from repro_torch.runtime import scheduler
from repro_torch.runtime.compile_cache import (
    CompileCache,
    PlanStore,
    get_compile_cache,
    get_plan_store,
    reset_compile_cache,
    set_cache_dir,
)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    yield
    pool = scheduler.get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    scheduler.set_default_pool(None)


@pytest.fixture
def clean_cache_state():
    """Detach the global plan store / callable cache around a test, so
    cache-dir tests never leak into the rest of the suite."""
    yield
    reset_compile_cache()


# --------------------------------------------------------- callable cache


def test_compile_cache_hit_miss_and_counters():
    cache = CompileCache()
    builds = []

    def build():
        builds.append(lambda x: x * 2.0)
        return builds[-1]

    x = torch.arange(4.0)
    counters = {"hits": 0, "misses": 0, "compile_s": 0.0}
    f1 = cache.get_compiled("k", build, lower_args=(x,), counters=counters)
    f2 = cache.get_compiled("k", build, lower_args=(x,), counters=counters)
    assert f1 is f2 and len(builds) == 1
    assert counters["hits"] == 1 and counters["misses"] == 1
    assert counters["compile_s"] > 0
    np.testing.assert_array_equal(f1(x).numpy(), np.arange(4.0) * 2)
    st = cache.stats()
    assert st["hits"] == 1 and st["misses"] == 1 and st["size"] == 1
    # No ahead-of-time lowering in eager PyTorch: lower_args is ignored and
    # the cached object is the callable build() returned.
    assert f1 is builds[0]
    # Distinct keys build separately.
    cache.get_compiled("k2", build, lower_args=(x,))
    assert len(builds) == 2
    cache.clear()
    assert cache.stats() == {"hits": 0, "misses": 0, "compile_s": 0.0,
                             "size": 0}


def test_compile_cache_without_lower_args_caches_callable():
    cache = CompileCache()
    fn = cache.get_compiled("k", lambda: (lambda x: x + 1))
    assert fn(1) == 2
    assert cache.get_compiled("k", lambda: None) is fn


# ------------------------------------------------------------- plan store


def test_plan_store_roundtrip(tmp_path):
    store = PlanStore(str(tmp_path))
    plan = get_plan("ladner_fischer", 16)
    plan.scratch["probe"] = torch.zeros(3)       # a device memo
    key = ("ladner_fischer", 16, None)
    assert store.store(key, plan)
    loaded = store.load(key)
    assert loaded is not None
    assert loaded.circuit == plan.circuit
    assert loaded.rounds == plan.rounds
    assert loaded.scratch == {}          # device memos are stripped
    assert "probe" in plan.scratch       # ...from the stored copy only
    del plan.scratch["probe"]
    assert store.load(("missing", 8, None)) is None


def test_plan_store_tolerates_corruption(tmp_path):
    store = PlanStore(str(tmp_path))
    plan = get_plan("ladner_fischer", 8)
    key = ("ladner_fischer", 8, None)
    store.store(key, plan)
    with open(store._path(key), "wb") as f:
        f.write(b"not a pickle")
    assert store.load(key) is None


def test_get_plan_consults_persistent_store(tmp_path, clean_cache_state):
    assert set_cache_dir(str(tmp_path)) is False   # no XLA cache to accept
    store = get_plan_store()
    assert store is not None
    plan_cache.clear()
    plan = get_plan("brent_kung", 32)          # lowers fresh, persists
    assert store.stores >= 1
    plan_cache.clear()                          # simulate a fresh process
    loads_before = store.loads
    again = get_plan("brent_kung", 32)
    assert store.loads == loads_before + 1
    assert again.circuit == plan.circuit and again.rounds == plan.rounds
    # And the loaded plan executes: scan through it bit-exactly.
    from repro_torch.core.engine import scan

    x = torch.arange(32.0, dtype=torch.float32)
    y = scan(lambda a, b: a + b, x, backend="vector", algorithm="brent_kung")
    np.testing.assert_array_equal(y.numpy(), np.cumsum(np.arange(32.0)))


@pytest.mark.parametrize("alg", ["brent_kung", "ladner_fischer", "sklansky"])
def test_stored_plan_equals_reference_plan(tmp_path, alg):
    """A plan that went through the store is the reference's plan, round
    for round."""
    from repro.core.engine.plan import get_plan as ref_get_plan

    store = PlanStore(str(tmp_path))
    key = (alg, 24, None)
    store.store(key, get_plan(alg, 24))
    loaded = store.load(key)
    want = ref_get_plan(alg, 24)
    assert [(r.combines, r.moves, r.capture_total) for r in loaded.rounds] == [
        (r.combines, r.moves, r.capture_total) for r in want.rounds
    ]


# ----------------------------------------------- telemetry compile split


def test_telemetry_compile_split():
    tel = OpTelemetry(name="t")
    tel.record(5.0, compile=True)
    assert tel.calls == 0 and tel.estimate() is None
    assert tel.compile_calls == 1 and tel.compile_time == 5.0
    tel.record(0.1)
    assert tel.calls == 1
    assert abs(tel.estimate() - 0.1) < 1e-12   # EMA untouched by compile
    s = tel.summary()
    assert s["compile_calls"] == 1 and s["compile_s"] == 5.0
    tel.reset()
    assert tel.compile_calls == 0 and tel.compile_time == 0.0


def test_operator_first_call_classified_as_compile():
    from repro_torch.core.registration import (
        RegElement,
        RegistrationOperator,
        SeriesRegistrar,
    )

    RegistrationOperator._reset_compile_tracking()
    frames = torch.zeros((4, 8, 8), dtype=torch.float32)
    reg = SeriesRegistrar(frames, refine=False)
    op = RegistrationOperator(reg, name="t_cold")
    e = lambda i: RegElement(
        {"angle": torch.zeros(()), "shift": torch.zeros(2)}, i, i + 1
    )
    op(e(0), e(1))
    assert op.telemetry.compile_calls == 1 and op.telemetry.calls == 0
    op(e(1), e(2))
    assert op.telemetry.compile_calls == 1 and op.telemetry.calls == 1
    # Compile-dominated samples never become per-element cost observations.
    assert list(op._elem_obs) != [] and 0 not in op._elem_obs
    # A second operator over the same signature starts warm.
    op2 = RegistrationOperator(SeriesRegistrar(frames, refine=False),
                               name="t_warm")
    op2(e(0), e(1))
    assert op2.telemetry.compile_calls == 0 and op2.telemetry.calls == 1


# -------------------------------------------------------- service wiring


def test_series_session_warm_start(tmp_path, clean_cache_state):
    from repro_torch.service import RegisterSeriesConfig, open_series

    frames = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 16, 16)).astype(np.float32)
    )

    def run(tag):
        with open_series(
            RegisterSeriesConfig(refine=False, telemetry_name=tag),
            compile_cache_dir=str(tmp_path), device="cpu",
        ) as s:
            s.feed(frames[:4])
            s.feed(frames[4:])
            return s.result()

    cold = run("t_cc_cold")
    assert cold.compile_cache["misses"] >= 1
    assert cold.timings["compile"] > 0
    # Build seconds were moved out of preprocess, not double counted.
    assert cold.timings["preprocess"] >= 0
    warm = run("t_cc_warm")
    assert warm.compile_cache["hits"] >= 1
    assert warm.compile_cache["misses"] == 0
    assert warm.timings["compile"] == 0
    np.testing.assert_allclose(
        warm.deformations["shift"].numpy(),
        cold.deformations["shift"].numpy(),
        atol=1e-6,
    )
    assert "compile cache:" in warm.report()


_RESTORE_IN_FRESH_PROCESS = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    import repro_torch.service as service
    from repro_torch.runtime.compile_cache import get_compile_cache, get_plan_store

    ckpt, cache, frames = sys.argv[1], sys.argv[2], np.load(sys.argv[3])
    r = service.SeriesSession.restore(ckpt, device="cpu",
                                      compile_cache_dir=cache)
    res = r.extend(torch.from_numpy(frames))
    print(json.dumps({
        "session": res.compile_cache,
        "process": get_compile_cache().stats(),
        "plan_loads": get_plan_store().loads,
        "shift": res.deformations["shift"].tolist(),
    }))
""")


def test_restore_warm_starts_a_fresh_process(tmp_path, clean_cache_state):
    """Checkpoint in this process, restore in a cold one: the cold
    process builds function A's launcher once (eager PyTorch has no
    executable to persist), its plans come from the store, and the series
    ends where the uninterrupted one does."""
    from repro_torch.service import RegisterSeriesConfig, open_series

    frames = np.random.default_rng(1).standard_normal((17, 16, 16)).astype(
        np.float32)
    cfg = RegisterSeriesConfig(refine=False, algorithm="ladner_fischer")
    with open_series(cfg, device="cpu") as u:
        u.feed(torch.from_numpy(frames[:9]))
        want = u.extend(torch.from_numpy(frames[9:]))
    ckpt, cache = tmp_path / "ckpt", tmp_path / "cache"
    # A plan is stored when it is lowered: the writing session starts from
    # an empty plan cache, as a process with the store attached from its
    # start does.
    plan_cache.clear()
    with open_series(cfg, checkpoint_dir=str(ckpt),
                     compile_cache_dir=str(cache), device="cpu") as s:
        s.feed(torch.from_numpy(frames[:9]))
        assert s.checkpoint() == 9
    np.save(tmp_path / "rest.npy", frames[9:])
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c", _RESTORE_IN_FRESH_PROCESS, str(ckpt),
         str(cache), str(tmp_path / "rest.npy")],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["session"]["misses"] == 1      # the first feed's one build
    assert got["process"]["misses"] == 1
    assert got["plan_loads"] >= 1
    np.testing.assert_allclose(np.asarray(got["shift"]),
                               want.deformations["shift"].numpy(), atol=1e-7)
