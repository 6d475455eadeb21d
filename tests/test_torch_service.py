"""Series sessions in the port: the reference's session tests
(tests/test_service.py) against ``repro_torch.service`` — incremental
feed/extend against the one-shot pipeline, frame residency, telemetry
isolation, prefetch depth and pool-aware dispatch, checkpoint/restore —
and snapshots that cross between the two packages both ways."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline container: deterministic fallback sampler
    from _hypothesis_shim import given, settings, strategies as st

import repro_torch
import repro_torch.service as service
from repro_torch.core.registration import RegResult
from repro_torch.pipeline import _prefetched
from repro_torch.runtime import scheduler
from repro_torch.runtime.scheduler import WorkerPool
from repro_torch.service import _FrameStore


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    # One intra-op thread: the suite runs several test processes at once,
    # and small tensors gain nothing from more.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    pool = scheduler.get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    scheduler.set_default_pool(None)
    # The parity tests ran the reference's sessions on its own pool.
    ref_scheduler = sys.modules.get("repro.runtime.scheduler")
    if ref_scheduler is not None:
        ref_pool = ref_scheduler.get_default_pool()
        ref_pool.shutdown()
        for t in list(ref_pool._threads):
            t.join(timeout=10)
        ref_scheduler.set_default_pool(None)


def open_series(cfg=None, **kw):
    return service.open_series(cfg, device="cpu", **kw)


def register_series(frames, cfg=None):
    return repro_torch.register_series(frames, cfg, device="cpu")


# A deterministic, batch-independent stand-in for function A (batched over
# the leading axis, as the session calls it): pure elementwise picks, so the
# property under test is the session's seeded suffix scanning alone.
def _fake_register_pair(ref, tmpl, init=None, cfg=None):
    angle = (ref[:, 2, 3] - tmpl[:, 3, 2]) * 1e-3
    shift = torch.stack(
        [ref[:, 0, 0] - tmpl[:, 0, 0], 0.5 * (ref[:, 1, 1] - tmpl[:, 1, 1])],
        dim=-1,
    )
    b = ref.shape[0]
    return RegResult(
        {"angle": angle, "shift": shift},
        torch.zeros(b),
        torch.full((b,), 3, dtype=torch.int32),
    )


@pytest.fixture
def fake_a(monkeypatch):
    monkeypatch.setattr(service, "register_pair", _fake_register_pair)


def _frames(n, seed, size=8):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, size, size)).astype(np.float32))


def _random_chunks(frames, rng):
    """Split frames into random-size chunks, occasionally empty."""
    chunks = []
    i = 0
    n = frames.shape[0]
    while i < n:
        if rng.random() < 0.15:
            chunks.append(frames[i:i])  # empty chunk (ragged stream tail)
        k = int(rng.integers(1, n - i + 1))
        chunks.append(frames[i : i + k])
        i += k
    return chunks


# --------------------------------------------- incremental == one-shot

# Chunked and one-shot scans associate the float32 compositions in another
# order; with cumulative shifts up to ~16 px that moves results by a few
# ulps (~2e-6).  The reference's own 1e-6 fails on the same inputs
# (n=28, seed=8608: 1.79e-6 in the reference, 1.85e-6 here), so these
# tests allow 1e-5.
ASSOC_ATOL = 1e-5


@settings(max_examples=12, deadline=None)
@given(n=st.integers(4, 28), seed=st.integers(0, 10_000))
def test_property_feed_over_random_chunks_matches_oneshot(n, seed):
    """Property: feeding any random chunk split produces element-wise the
    same cumulative deformations as one-shot register_series on the
    concatenated series (to float32 reassociation, ``ASSOC_ATOL``)."""
    orig = service.register_pair
    service.register_pair = _fake_register_pair
    try:
        frames = _frames(n, seed)
        cfg = repro_torch.RegisterSeriesConfig(refine=False)
        ref = register_series(frames, cfg)
        rng = np.random.default_rng(seed + 1)
        with open_series(cfg) as s:
            for chunk in _random_chunks(frames, rng):
                s.feed(chunk)
            got = s.result()
        for key in ("angle", "shift"):
            np.testing.assert_allclose(
                got.deformations[key].numpy(), ref.deformations[key].numpy(),
                atol=ASSOC_ATOL, rtol=1e-6,
            )
        assert [(e.i, e.k) for e in got.elements] == [
            (e.i, e.k) for e in ref.elements
        ]
    finally:
        service.register_pair = orig


@settings(max_examples=8, deadline=None)
@given(n=st.integers(6, 24), cut=st.integers(2, 5), seed=st.integers(0, 999))
def test_property_extend_after_result_matches_oneshot(n, cut, seed):
    """Property: result() mid-series then extend() with the remaining
    suffix equals the one-shot scan — completion does not finalize."""
    cut = min(cut, n - 1)
    orig = service.register_pair
    service.register_pair = _fake_register_pair
    try:
        frames = _frames(n, seed)
        cfg = repro_torch.RegisterSeriesConfig(refine=False)
        ref = register_series(frames, cfg)
        with open_series(cfg) as s:
            s.feed(frames[:cut])
            mid = s.result()
            assert mid.n_frames == cut
            got = s.extend(frames[cut:])
        np.testing.assert_allclose(
            got.deformations["shift"].numpy(), ref.deformations["shift"].numpy(),
            atol=ASSOC_ATOL, rtol=1e-6,
        )
    finally:
        service.register_pair = orig


def test_real_registration_chunked_matches_batch():
    """With the real minimiser, per-lane freezing makes every pair's result
    independent of its chunk, so chunked and batch runs differ only by the
    composition scan's rounding (the reference allows 5e-3 here)."""
    from repro_torch.data.images import make_series

    frames, _ = make_series(7, 10, size=64, noise=0.12, device="cpu")
    cfg = repro_torch.RegisterSeriesConfig(refine=False)
    a = register_series(frames, cfg)
    with open_series(cfg) as s:
        s.feed(frames[:4])
        b = s.extend(frames[4:])
    np.testing.assert_allclose(
        a.deformations["shift"].numpy(), b.deformations["shift"].numpy(),
        atol=1e-5,
    )


def test_refined_incremental_session_recovers_truth():
    """refine=True across feeds: the seeded function-B scan on the suffix
    still recovers the ground-truth drift (paper §2.3.3)."""
    from repro_torch.data.images import make_series

    frames, true = make_series(11, 12, size=64, noise=0.12, device="cpu")
    with open_series(
        repro_torch.RegisterSeriesConfig(telemetry_name="test_svc_refine")
    ) as s:
        s.feed(frames[:7])
        res = s.extend(frames[7:])
    assert res.n_frames == 12
    err = (res.deformations["shift"][1:] - true["shift"][1:]).abs().max()
    assert float(err) < 0.35, err
    assert res.op_telemetry["calls"] > 0
    assert set(res.timings) == {
        "ingest", "preprocess", "scan", "compose", "compile",
    }


def test_session_requires_two_frames_and_close_is_final():
    s = open_series(repro_torch.RegisterSeriesConfig(refine=False))
    s.feed(_frames(1, 0))
    with pytest.raises(ValueError, match=">= 2 frames"):
        s.result()
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.feed(_frames(2, 0))


def test_frame_window_stays_o1(fake_a):
    """Resident-runtime memory contract: after each feed only frame 0 and
    the boundary frame remain resident, however long the series."""
    with open_series(repro_torch.RegisterSeriesConfig(refine=False)) as s:
        for k in range(6):
            s.feed(_frames(8, k))
        assert s.n_frames == 48
        assert sorted(s._store._frames) == [0, 47]
        s.result()


def test_frame_store_evicted_access_raises_clearly():
    store = _FrameStore()
    store.append_chunk(torch.ones((4, 2, 2)))
    store.evict({0, 3})
    assert store.shape == (4, 2, 2)
    store[0], store[3]
    with pytest.raises(IndexError, match="evicted"):
        store[1]


# ------------------------------------------------- checkpoint / restore


def test_checkpoint_restore_resumes_exactly(tmp_path, fake_a):
    """Kill-and-restore mid-series: the restored session's extend must
    match the uninterrupted session (deterministic operator, same chunk
    boundaries)."""
    frames = _frames(20, 42)
    cfg = repro_torch.RegisterSeriesConfig(refine=False)
    with open_series(cfg) as uninterrupted:
        uninterrupted.feed(frames[:12])
        ref = uninterrupted.extend(frames[12:])

    s = open_series(cfg, checkpoint_dir=str(tmp_path))
    s.feed(frames[:12])
    step = s.checkpoint()
    assert step == 12
    written = s.summaries
    s.close()  # the "crash"

    r = service.SeriesSession.restore(str(tmp_path), cfg, device="cpu")
    assert r.n_frames == 12 and r.n_elements == 11
    # Every per-feed field survives, the feed's counters too.
    assert r.summaries == written
    assert written[0].pair_iters == 3 * 11 and written[0].fnA_s > 0
    got = r.extend(frames[12:])
    r.close()
    np.testing.assert_allclose(
        got.deformations["shift"].numpy(),
        ref.deformations["shift"].numpy(),
        atol=1e-7,
    )
    assert len(r.summaries) >= 2  # restored summary + the extend's


def test_checkpoint_requires_dir_and_state(tmp_path):
    s = open_series(repro_torch.RegisterSeriesConfig(refine=False))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        s.checkpoint()
    s.close()
    s = open_series(repro_torch.RegisterSeriesConfig(refine=False),
                    checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="nothing to checkpoint"):
        s.checkpoint()
    s.close()


def test_restore_rebuilds_and_guards_config(tmp_path, fake_a):
    """The snapshot carries the config: restore(cfg=None) resumes under
    the settings the prefix was registered with, and an explicit cfg that
    disagrees on registration-affecting fields is refused (a mixed-
    settings series is silent corruption)."""
    from repro_torch.core.registration import RegistrationConfig

    cfg = repro_torch.RegisterSeriesConfig(
        refine=False,
        registration=RegistrationConfig(max_iters=50, tol=1e-5),
    )
    s = open_series(cfg, checkpoint_dir=str(tmp_path))
    s.feed(_frames(8, 0))
    s.checkpoint()
    s.close()
    r = service.SeriesSession.restore(str(tmp_path), device="cpu")
    assert r.cfg.registration.max_iters == 50
    assert r.cfg.registration.tol == 1e-5
    assert r.cfg.refine is False
    r.close()
    with pytest.raises(ValueError, match="registration-affecting"):
        service.SeriesSession.restore(
            str(tmp_path), repro_torch.RegisterSeriesConfig(refine=True),
            device="cpu",
        )


def test_restore_reprimes_telemetry(tmp_path):
    """The snapshot carries the telemetry prime so a restored session
    dispatches from the observed cost, not from scratch."""
    from repro_torch.data.images import make_series

    frames, _ = make_series(5, 8, size=64, noise=0.12, device="cpu")
    cfg = repro_torch.RegisterSeriesConfig(telemetry_name="test_svc_ckpt")
    s = open_series(cfg, checkpoint_dir=str(tmp_path))
    s.feed(frames)
    s.result()
    assert s.telemetry.estimate() is not None
    s.checkpoint()
    s.close()
    r = service.SeriesSession.restore(str(tmp_path), cfg, device="cpu")
    assert r.telemetry.estimate() is not None and r.telemetry.estimate() > 0
    assert [f["backend"] for f in r.result().feeds] == [
        sm.backend for sm in s.summaries
    ]
    r.close()


def test_restore_runs_on_the_card_by_default(tmp_path, fake_a, monkeypatch):
    """restore(device=None) means the card: where there is none it raises,
    and never quietly restores onto the CPU."""
    s = open_series(repro_torch.RegisterSeriesConfig(refine=False),
                    checkpoint_dir=str(tmp_path))
    s.feed(_frames(4, 0))
    s.checkpoint()
    s.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        service.SeriesSession.restore(str(tmp_path))


def _ref_fake_register_pair(ref, tmpl, init=None, cfg=None):
    """The reference's per-pair form of ``_fake_register_pair``."""
    import jax.numpy as jnp
    from repro.core.registration import RegResult as RefRegResult

    angle = (ref[2, 3] - tmpl[3, 2]) * 1e-3
    shift = jnp.stack([ref[0, 0] - tmpl[0, 0], 0.5 * (ref[1, 1] - tmpl[1, 1])])
    return RefRegResult({"angle": angle, "shift": shift}, jnp.zeros(()),
                        jnp.asarray(3, jnp.int32))


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_snapshot_crosses_packages(tmp_path, fake_a, monkeypatch, writer):
    """A snapshot written by either package restores in the other and
    extends to what the restoring package's own uninterrupted session
    gives (atol 1e-7), and to the other package's within the parity
    tolerance (their float32 compositions round apart by an ulp)."""
    import jax.numpy as jnp

    import repro
    import repro.service as ref_service

    monkeypatch.setattr(ref_service, "register_pair", _ref_fake_register_pair)
    frames = _frames(20, 42).numpy()
    pcfg = repro_torch.RegisterSeriesConfig(refine=False)
    rcfg = repro.RegisterSeriesConfig(refine=False)
    with open_series(pcfg) as u:
        u.feed(torch.from_numpy(frames[:12]))
        port_ref = u.extend(torch.from_numpy(frames[12:]))
    with ref_service.open_series(rcfg) as u:
        u.feed(jnp.asarray(frames[:12]))
        ref_ref = u.extend(jnp.asarray(frames[12:]))
    ckpt = str(tmp_path / "ckpt")
    if writer == "repro":
        s = ref_service.open_series(rcfg, checkpoint_dir=ckpt)
        s.feed(jnp.asarray(frames[:12]))
    else:
        s = open_series(pcfg, checkpoint_dir=ckpt)
        s.feed(torch.from_numpy(frames[:12]))
    assert s.checkpoint() == 12
    s.close()
    with open(tmp_path / "ckpt" / "step_00000012" / "manifest.json") as f:
        keys = json.load(f)["keys"]
    assert keys == ["cum/angle", "cum/shift", "frame0", "last_frame",
                    "pair_iters"]

    if writer == "repro":
        r = service.SeriesSession.restore(ckpt, device="cpu")
        got = r.extend(torch.from_numpy(frames[12:]))
        own, other = port_ref, ref_ref
        shift = got.deformations["shift"].numpy()
    else:
        r = ref_service.SeriesSession.restore(ckpt)
        got = r.extend(jnp.asarray(frames[12:]))
        own, other = ref_ref, port_ref
        shift = np.asarray(got.deformations["shift"])
    r.close()
    assert got.n_frames == 20 and len(r.summaries) == 2
    np.testing.assert_allclose(shift, np.asarray(own.deformations["shift"]),
                               atol=1e-7)
    np.testing.assert_allclose(shift, np.asarray(other.deformations["shift"]),
                               atol=1e-6)


# --------------------------------------------------- telemetry isolation


def test_telemetry_namespaced_per_session():
    """Regression (cross-contamination): two sessions with the same
    operator name must not share cost/imbalance EMAs."""
    from repro_torch.core.engine.telemetry import get_telemetry, release_telemetry

    a = get_telemetry("op_shared", session="sessA")
    b = get_telemetry("op_shared", session="sessB")
    anon = get_telemetry("op_shared")
    assert a is not b and a is not anon and b is not anon
    a.record(10.0)  # a heavy series...
    assert b.estimate() is None  # ...must not poison its neighbour
    assert anon.estimate() is None
    b.record(0.001)
    assert a.estimate() == pytest.approx(10.0)
    release_telemetry("op_shared", session="sessA")
    release_telemetry("op_shared", session="sessB")
    release_telemetry("op_shared")
    # Fresh channel after release: history gone.
    assert get_telemetry("op_shared", session="sessA").estimate() is None
    release_telemetry("op_shared", session="sessA")


def test_sessions_get_distinct_channels_and_close_releases():
    from repro_torch.core.engine import telemetry as tmod

    cfg = repro_torch.RegisterSeriesConfig(refine=False,
                                     telemetry_name="test_svc_iso")
    s1 = open_series(cfg)
    s2 = open_series(cfg)
    assert s1.telemetry is not s2.telemetry
    key1 = f"{s1.id}:test_svc_iso"
    assert key1 in tmod._registry
    s1.close()
    assert key1 not in tmod._registry
    s2.close()


# -------------------------------------------------- prefetch-depth plumb


def test_prefetch_depth_validated():
    with pytest.raises(ValueError, match="prefetch_depth"):
        repro_torch.RegisterSeriesConfig(prefetch_depth=0)
    with pytest.raises(ValueError, match=">= 1"):
        list(_prefetched(iter([1, 2]), depth=0))


def test_prefetch_depth_bounds_lookahead():
    """depth=3 must actually run further ahead than depth=1 (the old
    hardcoded behaviour), and stay bounded."""
    counts = {}
    for depth in (1, 3):
        produced = []

        def source():
            for i in range(1000):
                produced.append(i)
                yield i

        gen = _prefetched(source(), depth=depth)
        assert next(gen) == 0
        time.sleep(0.2)  # let the producer fill the lookahead
        counts[depth] = len(produced)
        gen.close()
    assert counts[3] > counts[1]
    assert counts[3] <= 3 + 4  # queue depth + in flight + consumed slack


def test_register_series_streaming_with_deeper_prefetch(fake_a):
    frames = _frames(12, 9)
    chunks = [frames[i : i + 3] for i in range(0, 12, 3)]
    cfg = repro_torch.RegisterSeriesConfig(refine=False, prefetch_depth=3)
    a = register_series(frames, repro_torch.RegisterSeriesConfig(refine=False))
    b = register_series(iter(chunks), cfg)
    np.testing.assert_allclose(
        a.deformations["shift"].numpy(), b.deformations["shift"].numpy(),
        atol=1e-6,
    )


# ------------------------------------------------- pool-aware dispatching


def _affine_op(a, b):
    return (a[0] * b[0] % 1000003, (a[1] * b[0] + b[1]) % 1000003)


def test_scan_shifts_to_sequential_on_saturated_pool():
    """A saturated shared pool must route a small expensive-op series to
    the work-optimal sequential chain (N-1 applications) instead of
    queueing a ~2.5N reduce-then-scan behind other tenants."""
    from repro_torch.core.engine import scan

    pool = WorkerPool(max_workers=2, name="busy")
    gate = threading.Event()
    bg = threading.Thread(
        target=lambda: pool.run_tasks([gate.wait for _ in range(4)])
    )
    bg.start()
    for _ in range(100):
        if pool.occupancy() >= 1.0:
            break
        time.sleep(0.01)
    try:
        calls = []

        class ExpensiveOp:
            op_cost_estimate = 1.0

            def __call__(self, a, b):
                calls.append(1)
                return _affine_op(a, b)

        n = 32
        xs = [(i % 7 + 1, i) for i in range(n)]
        ys = scan(ExpensiveOp(), list(xs), workers=8, pool=pool)
        acc = xs[0]
        ref = [acc]
        for x in xs[1:]:
            acc = _affine_op(acc, x)
            ref.append(acc)
        assert ys == ref
        assert len(calls) == n - 1  # sequential chain, not ~2.5N
    finally:
        gate.set()
        bg.join()
        pool.shutdown()


def test_pool_aware_workers_fair_share():
    from repro_torch.core.engine import pool_aware_workers
    from repro_torch.core.engine.cost import _default_workers

    class FakePool:
        def __init__(self, t):
            self._t = t

        def tenants(self):
            return self._t

    assert pool_aware_workers(FakePool(1), None) == _default_workers()
    many = pool_aware_workers(FakePool(4), None)
    assert many == max(1, _default_workers() // 4)
    # An explicit hint always wins; no pool means no scaling.
    assert pool_aware_workers(FakePool(4), 6) == 6
    assert pool_aware_workers(None, None) is None


def test_dispatch_pool_occupancy_rule():
    from repro_torch.core.engine import dispatch

    base = dict(domain="element", op_cost=1.0, workers=8)
    assert dispatch(64, **base).backend == "worksteal"
    d = dispatch(64, **base, pool_occupancy=1.5)
    assert d.backend == "element" and "saturated" in d.reason
    assert dispatch(64, **base, pool_occupancy=0.2).backend == "worksteal"
    # Huge series keep their parallel latency even under a busy pool.
    from repro_torch.core.engine.cost import POOL_BUSY_MAX_N

    big = dispatch(POOL_BUSY_MAX_N + 2, **base, pool_occupancy=1.5)
    assert big.backend != "element"


def test_concurrent_sessions_on_shared_pool():
    """Two sessions scanning at once on one pool: both correct, and the
    pool saw both as tenants at some point."""
    orig = service.register_pair
    service.register_pair = _fake_register_pair
    try:
        pool = WorkerPool(max_workers=8, name="multi")
        frames_a, frames_b = _frames(16, 1), _frames(16, 2)
        cfg = repro_torch.RegisterSeriesConfig(refine=False)
        ref_a = register_series(frames_a, cfg)
        ref_b = register_series(frames_b, cfg)
        out = {}

        def run(name, frames):
            with open_series(cfg, pool=pool) as s:
                for i in range(0, 16, 4):
                    s.feed(frames[i : i + 4])
                out[name] = s.result()

        ta = threading.Thread(target=run, args=("a", frames_a))
        tb = threading.Thread(target=run, args=("b", frames_b))
        ta.start()
        tb.start()
        ta.join()
        tb.join()
        for name, ref in (("a", ref_a), ("b", ref_b)):
            np.testing.assert_allclose(
                out[name].deformations["shift"].numpy(),
                ref.deformations["shift"].numpy(),
                atol=1e-6,
            )
        pool.shutdown()
    finally:
        service.register_pair = orig
