"""The port's serving front end (``repro_torch.serving``): the cases of
``tests/test_serving.py`` — admission, dispatch policies,
priority/preemption, and the open-loop load generator, all deterministic
(fake clock / manual dispatch) except the one end-to-end preemption test,
which is event-gated — plus parity with the reference's front end and load
generator on the same inputs.  Sessions run on the CPU here.

The three acceptance scenarios of the reference live here too:
  (a) a full tenant queue rejects rather than blocks;
  (b) round-robin bounds any tenant's wait to O(#tenants) dispatch turns
      under a straggler tenant while FIFO's wait grows with the straggler's
      queue depth;
  (c) a high-priority ``result()`` completes while a long batch series is
      mid-scan on the shared pool.

Under ``REPRO_CHECK_INVARIANTS=1`` the module ends by asserting that the
port's happens-before race tracker recorded no race (the counterpart of
the reference's ``make sanitize``).
"""

import sys
import threading

import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.service as service
from repro_torch.analysis.sync import get_race_tracker, invariants_enabled
from repro_torch.core.registration import RegResult
from repro_torch.runtime import scheduler
from repro_torch.runtime.scheduler import WorkerPool, current_priority
from repro_torch.serving import (
    AdmissionError,
    FrontendClosedError,
    FrontendConfig,
    LatencyHistogram,
    RegistrationFrontend,
    get_policy,
    poisson_arrivals,
    policy_names,
    run_open_loop,
)


@pytest.fixture(autouse=True, scope="module")
def _pool_and_race_sanitizer():
    yield
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
    if invariants_enabled():
        races = get_race_tracker().races()
        assert races == [], "\n".join(str(r) for r in races)


class FakeClock:
    """Deterministic time source: advances only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _manual_frontend(policy="fifo", **cfg_kw):
    clk = FakeClock()
    fe = RegistrationFrontend(
        FrontendConfig(policy=policy, **cfg_kw),
        clock=clk, auto_dispatch=False,
    )
    return fe, clk


# ------------------------------------------------------------- admission


def test_full_queue_rejects_not_blocks():
    fe, clk = _manual_frontend(queue_depth=3)
    fe.add_tenant("a")
    fe.add_tenant("b")
    for _ in range(3):
        fe.call("a", lambda: None)
    # 4th submit must raise immediately (nothing is dispatching, so a
    # blocking implementation would hang here forever).
    with pytest.raises(AdmissionError) as exc:
        fe.call("a", lambda: None)
    assert exc.value.tenant == "a" and exc.value.depth == 3
    # A full tenant never affects another tenant's admission.
    t = fe.call("b", lambda: 42)
    assert fe.stats()["tenants"]["a"]["rejected"] == 1
    assert fe.stats()["tenants"]["b"]["rejected"] == 0
    while fe.dispatch_one():
        pass
    assert t.result() == 42
    fe.close()


def test_per_tenant_depth_overrides_default():
    fe, _ = _manual_frontend(queue_depth=8)
    fe.add_tenant("small", queue_depth=1)
    fe.call("small", lambda: None)
    with pytest.raises(AdmissionError):
        fe.call("small", lambda: None)
    fe.close()


def test_unknown_and_duplicate_tenants_raise():
    fe, _ = _manual_frontend()
    fe.add_tenant("a")
    with pytest.raises(ValueError, match="already registered"):
        fe.add_tenant("a")
    with pytest.raises(ValueError, match="unknown tenant"):
        fe.call("ghost", lambda: None)
    with pytest.raises(ValueError, match="unknown session"):
        fe.feed("a", "no-such-session", [])
    fe.close()


def test_config_validation():
    with pytest.raises(ValueError):
        FrontendConfig(queue_depth=0)
    with pytest.raises(ValueError):
        FrontendConfig(dispatch_workers=-1)
    with pytest.raises(ValueError, match="unknown dispatch policy"):
        get_policy("lifo")
    assert policy_names() == ["fifo", "round_robin", "sewf"]


# ------------------------------------- dispatch policies (fake clock)


def _straggler_run(policy, depth):
    """One straggler tenant with ``depth`` queued 1s requests, then one
    request each from two interactive-ish tenants; drain and return the
    two latecomers' tickets."""
    fe, clk = _manual_frontend(policy=policy, queue_depth=depth + 4)
    fe.add_tenant("bulk")
    fe.add_tenant("alice")
    fe.add_tenant("bob")
    for _ in range(depth):
        fe.call("bulk", lambda: clk.advance(1.0))
    ta = fe.call("alice", lambda: clk.advance(0.01))
    tb = fe.call("bob", lambda: clk.advance(0.01))
    while fe.dispatch_one():
        pass
    fe.close()
    return ta, tb


@pytest.mark.parametrize("depth", [4, 12])
def test_fifo_wait_grows_with_straggler_depth(depth):
    ta, tb = _straggler_run("fifo", depth)
    # FIFO: the latecomers queue behind the straggler's whole backlog.
    assert ta.turns_waited == depth
    assert tb.turns_waited == depth + 1
    assert ta.queue_wait_s == pytest.approx(depth * 1.0, abs=0.1)


@pytest.mark.parametrize("depth", [4, 12])
def test_round_robin_bounds_wait_to_tenant_count(depth):
    n_tenants = 3
    ta, tb = _straggler_run("round_robin", depth)
    # Round-robin: one straggler turn per cycle, so any tenant's head
    # waits at most one full cycle — O(#tenants), independent of depth.
    assert ta.turns_waited <= n_tenants
    assert tb.turns_waited <= n_tenants
    assert ta.queue_wait_s <= n_tenants * 1.0 + 0.1


def test_sewf_prefers_observed_cheap_tenant():
    fe, clk = _manual_frontend(policy="sewf")
    fe.add_tenant("cheap")
    fe.add_tenant("pricey")
    # Observe one completion each so both tenants have cost EMAs.
    fe.call("cheap", lambda: clk.advance(0.001))
    fe.call("pricey", lambda: clk.advance(5.0))
    while fe.dispatch_one():
        pass
    # Now pricey arrives FIRST; sewf must still serve cheap's head first.
    tp = fe.call("pricey", lambda: clk.advance(5.0))
    tc = fe.call("cheap", lambda: clk.advance(0.001))
    while fe.dispatch_one():
        pass
    assert tc.dispatch_turn < tp.dispatch_turn
    fe.close()


def test_priority_tenant_dispatches_first_and_executes_in_lane():
    fe, clk = _manual_frontend(policy="fifo")
    fe.add_tenant("batch")
    fe.add_tenant("scope", interactive=True)
    seen = {}
    tb = fe.call("batch", lambda: seen.setdefault("batch", current_priority()))
    ts = fe.call("scope", lambda: seen.setdefault("scope", current_priority()))
    while fe.dispatch_one():
        pass
    # Interactive arrived later but dispatched first (higher lane)...
    assert ts.dispatch_turn < tb.dispatch_turn
    # ...and executed under at_priority, so its pool submissions would
    # claim ahead of batch segment tasks too.
    assert seen["scope"] == FrontendConfig().interactive_priority
    assert seen["batch"] == 0
    fe.close()


def test_busy_session_defers_tenant_without_blocking_others():
    fe, _ = _manual_frontend(policy="fifo")
    fe.add_tenant("a")
    fe.add_tenant("b")
    # White-box: mark a's target session as mid-execution.
    fe._busy.add("s1")
    ta = fe._submit("a", "feed", lambda: "a", items=1, session_key="s1")
    tb = fe._submit("b", "feed", lambda: "b", items=1, session_key="s2")
    assert fe.dispatch_one()
    assert tb.done and not ta.done  # a's head skipped, b ran
    assert not fe.dispatch_one()    # a still blocked on its busy session
    fe._busy.discard("s1")
    assert fe.dispatch_one()
    assert ta.result() == "a"
    fe.close()


# ------------------------------------------------------ tickets / close


def test_ticket_error_propagates_and_counts():
    fe, _ = _manual_frontend()
    fe.add_tenant("a")

    def boom():
        raise RuntimeError("op failed")

    t = fe.call("a", boom)
    fe.dispatch_one()
    with pytest.raises(RuntimeError, match="op failed"):
        t.result()
    assert fe.stats()["tenants"]["a"]["failed"] == 1
    assert fe.stats()["tenants"]["a"]["completed"] == 0
    fe.close()


def test_ticket_result_timeout():
    fe, _ = _manual_frontend()
    fe.add_tenant("a")
    t = fe.call("a", lambda: None)  # never dispatched
    with pytest.raises(TimeoutError):
        t.result(timeout=0.01)
    fe.close()


def test_close_fails_pending_tickets_and_rejects_new_work():
    fe, _ = _manual_frontend()
    fe.add_tenant("a")
    pending = [fe.call("a", lambda: None) for _ in range(3)]
    fe.close()
    for t in pending:
        assert t.done
        with pytest.raises(FrontendClosedError):
            t.result()
    with pytest.raises(FrontendClosedError):
        fe.call("a", lambda: None)
    fe.close()  # idempotent


# --------------------------------------------------------- end-to-end


def _fake_register_pair(ref, tmpl, init=None, cfg=None):
    """Function A's stand-in, batched over the leading axis as the port's
    session calls it: pure elementwise picks."""
    shift = torch.stack(
        [ref[:, 0, 0] - tmpl[:, 0, 0], 0.5 * (ref[:, 1, 1] - tmpl[:, 1, 1])],
        dim=-1,
    )
    b = ref.shape[0]
    return RegResult(
        {"angle": (ref[:, 2, 3] - tmpl[:, 3, 2]) * 1e-3, "shift": shift},
        torch.zeros(b),
        torch.full((b,), 3, dtype=torch.int32),
    )


def _frames(n, seed, size=8):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, size, size)).astype(np.float32))


def test_frontend_session_verbs_match_oneshot():
    """feed/result/extend/close through the front end equal the one-shot
    pipeline — the front end adds scheduling, never changes results."""
    orig = service.register_pair
    service.register_pair = _fake_register_pair
    try:
        frames = _frames(12, 3)
        cfg = repro_torch.RegisterSeriesConfig(refine=False)
        ref = repro_torch.register_series(frames, cfg, device="cpu")
        with RegistrationFrontend(FrontendConfig(dispatch_workers=1)) as fe:
            fe.add_tenant("scope", interactive=True)
            sid = fe.open_series("scope", cfg, device="cpu")
            fe.feed("scope", sid, frames[:5])
            fe.feed("scope", sid, frames[5:9])
            mid = fe.result("scope", sid).result(timeout=30)
            assert mid.n_frames == 9
            got = fe.extend("scope", sid, frames[9:]).result(timeout=30)
            fe.close_series("scope", sid).result(timeout=30)
        np.testing.assert_allclose(
            got.deformations["shift"].numpy(),
            ref.deformations["shift"].numpy(),
            atol=1e-6, rtol=1e-6,
        )
    finally:
        service.register_pair = orig


def test_preemption_interactive_result_completes_mid_batch_scan():
    """Scenario (c): while a long batch series holds the shared
    pool mid-scan (segment tasks gated on an event), an interactive
    tenant's feed + result must still complete — via the priority lane
    and the pool's caller-helping yield points."""
    pool = WorkerPool(max_workers=2, name="serving-test")
    fe = RegistrationFrontend(
        FrontendConfig(policy="round_robin", dispatch_workers=2),
        pool=pool,
    )
    fe.add_tenant("batch")
    fe.add_tenant("scope", interactive=True)
    gate = threading.Event()
    scan_started = threading.Event()

    def gated_segment():
        scan_started.set()
        assert gate.wait(30), "test gate never released"

    batch_ticket = fe.call(
        "batch", lambda: pool.run_tasks([gated_segment] * 8, label="batch"),
    )
    assert scan_started.wait(10)  # the batch series is now mid-scan

    orig = service.register_pair
    service.register_pair = _fake_register_pair
    try:
        frames = _frames(8, 5)
        cfg = repro_torch.RegisterSeriesConfig(refine=False)
        sid = fe.open_series("scope", cfg, device="cpu")
        fe.feed("scope", sid, frames)
        res = fe.result("scope", sid).result(timeout=30)
        assert res.n_frames == 8
    finally:
        service.register_pair = orig

    assert not batch_ticket.done  # batch still gated: we truly preempted
    gate.set()
    batch_ticket.result(timeout=30)
    fe.close()
    pool.shutdown()


# ----------------------------------------------------------- load gen


def test_poisson_arrivals_deterministic_and_calibrated():
    a = poisson_arrivals(50.0, 20.0, seed=9)
    b = poisson_arrivals(50.0, 20.0, seed=9)
    assert a == b
    assert a == sorted(a) and a[-1] < 20.0
    assert len(a) == pytest.approx(50.0 * 20.0, rel=0.15)
    assert poisson_arrivals(50.0, 20.0, seed=10) != a
    with pytest.raises(ValueError):
        poisson_arrivals(0.0, 1.0)


def test_histogram_percentiles_bounded_relative_error():
    h = LatencyHistogram()
    for v in [0.001] * 90 + [0.010] * 9 + [1.0]:
        h.record(v)
    assert h.count == 100
    assert h.percentile(50) == pytest.approx(0.001, rel=0.07)
    assert h.percentile(99) == pytest.approx(0.010, rel=0.07)
    assert h.percentile(99.9) == pytest.approx(1.0, rel=0.07)
    s = h.summary()
    assert s["max_s"] == 1.0
    assert s["mean_s"] == pytest.approx((0.09 + 0.09 + 1.0) / 100, rel=1e-6)
    with pytest.raises(ValueError):
        h.percentile(0.0)


def test_histogram_merge():
    a, b = LatencyHistogram(), LatencyHistogram()
    a.record(0.001)
    b.record(0.1)
    a.merge(b)
    assert a.count == 2
    assert a.percentile(99) == pytest.approx(0.1, rel=0.07)


def test_run_open_loop_on_fake_time():
    """The whole load-generation path on a fake clock: scheduled arrivals,
    inline dispatch, exact service times, zero real seconds slept."""
    clk = FakeClock()
    fe = RegistrationFrontend(
        FrontendConfig(policy="fifo", queue_depth=64),
        clock=clk, auto_dispatch=False,
    )
    fe.add_tenant("lg")

    def submit():
        t = fe.call("lg", lambda: clk.advance(0.004))
        fe.dispatch_one()  # serve inline: wait ~0, service 4ms fake
        return t

    arrivals = [0.01 * i for i in range(100)]
    res = run_open_loop(submit, arrivals, clock=clk, sleep=clk.advance)
    assert res.completed == 100 and res.rejected == 0 and res.errors == 0
    assert res.latency.percentile(50) == pytest.approx(0.004, rel=0.07)
    assert res.service.percentile(50) == pytest.approx(0.004, rel=0.07)
    assert res.offered_hz == pytest.approx(100 / 0.99, rel=0.01)
    fe.close()


def test_run_open_loop_counts_rejections():
    clk = FakeClock()
    fe = RegistrationFrontend(
        FrontendConfig(queue_depth=2), clock=clk, auto_dispatch=False,
    )
    fe.add_tenant("lg")
    # Nothing dispatches: after 2 admissions everything is rejected.
    res = run_open_loop(
        lambda: fe.call("lg", lambda: None),
        [0.001 * i for i in range(10)],
        drain_timeout_s=0.0, clock=clk, sleep=clk.advance,
    )
    assert res.rejected == 8
    assert res.completed == 0
    fe.close()


# ------------------------------------------------ parity with the reference


def _ref_fake_register_pair(ref, tmpl, init=None, cfg=None):
    import jax.numpy as jnp
    from repro.core.registration import RegResult as RefRegResult

    shift = jnp.stack([ref[0, 0] - tmpl[0, 0], 0.5 * (ref[1, 1] - tmpl[1, 1])])
    return RefRegResult(
        {"angle": (ref[2, 3] - tmpl[3, 2]) * 1e-3, "shift": shift},
        jnp.zeros(()),
        jnp.asarray(3, jnp.int32),
    )


def test_frontend_sessions_equal_reference(monkeypatch):
    """The same chunks through both packages' front ends (a refine=False
    tenant and an interactive one) give the same shifts."""
    import jax.numpy as jnp

    import repro
    import repro.service as ref_service
    from repro.serving import (
        FrontendConfig as RefConfig,
        RegistrationFrontend as RefFrontend,
    )

    monkeypatch.setattr(service, "register_pair", _fake_register_pair)
    monkeypatch.setattr(ref_service, "register_pair", _ref_fake_register_pair)
    frames = _frames(14, 8).numpy()
    chunks = [frames[:6], frames[6:11], frames[11:]]

    def drive(fe, cfg, frames_of, **kw):
        fe.add_tenant("batch")
        fe.add_tenant("scope", interactive=True)
        sids = {t: fe.open_series(t, cfg, **kw) for t in ("batch", "scope")}
        for c in chunks:
            for t, sid in sids.items():
                fe.feed(t, sid, frames_of(c))
        return {t: fe.result(t, sid).result(timeout=30)
                for t, sid in sids.items()}

    with RegistrationFrontend(FrontendConfig(policy="round_robin",
                                             dispatch_workers=1)) as fe:
        got = drive(fe, repro_torch.RegisterSeriesConfig(refine=False),
                    torch.from_numpy, device="cpu")
    with RefFrontend(RefConfig(policy="round_robin",
                               dispatch_workers=1)) as fe:
        want = drive(fe, repro.RegisterSeriesConfig(refine=False),
                     jnp.asarray)
    for t in ("batch", "scope"):
        assert got[t].n_frames == want[t].n_frames == 14
        np.testing.assert_allclose(got[t].deformations["shift"].numpy(),
                                   np.asarray(want[t].deformations["shift"]),
                                   atol=1e-6, rtol=1e-6)


def test_loadgen_equals_reference():
    """Arrival schedules and histogram percentiles are the reference's."""
    from repro.serving import LatencyHistogram as RefHistogram
    from repro.serving import poisson_arrivals as ref_arrivals

    assert poisson_arrivals(40.0, 5.0, seed=3) == ref_arrivals(40.0, 5.0, seed=3)
    rng = np.random.default_rng(4)
    h, r = LatencyHistogram(), RefHistogram()
    for v in rng.lognormal(-5.0, 1.0, 500):
        h.record(float(v))
        r.record(float(v))
    for q in (50, 90, 99, 99.9):
        assert h.percentile(q) == r.percentile(q)
    assert h.summary() == r.summary()


def test_open_series_runs_on_the_card_by_default(monkeypatch):
    """A front end's sessions take the port's default device: the card,
    which raises where there is none (no quiet fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with RegistrationFrontend(FrontendConfig(dispatch_workers=0)) as fe:
        fe.add_tenant("a")
        with pytest.raises(RuntimeError, match="CUDA"):
            fe.open_series("a", repro_torch.RegisterSeriesConfig())
