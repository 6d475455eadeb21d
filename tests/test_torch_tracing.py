"""The port's spans and per-feed counters (``runtime/tracing.py``,
``SeriesResult.feeds``) on a tiny session: 64 x 96 frames, two 16-frame
feeds, refining and composing, on the CPU."""

import dataclasses
import json
import os
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch import service
from repro_torch.core import work_stealing
from repro_torch.core.engine import scan
from repro_torch.core.registration import RegistrationConfig, register_pair
from repro_torch.data.images import make_series
from repro_torch.runtime import scheduler, tracing

#: Short descents keep the tiny sessions quick; each test gets a config of
#: its own (``lr_shift``), so that its first feed misses the launcher cache.
REG = dict(levels=2, max_iters=25)


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    pool = scheduler.get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    scheduler.set_default_pool(None)


@pytest.fixture(scope="module")
def frames():
    """32 frames of 64 x 96: a drifting lattice cut from 96 x 96 renders."""
    f, _ = make_series(29, 32, size=96, noise=0.15, device="cpu")
    return f[:, :64, :].contiguous()


def _config(refine: bool, lr_shift: float, max_iters: int = 25, **kw):
    if refine:
        # Refinements stealing on two pool threads, all refining.
        kw = dict(dict(skip_tol=1e-6, backend="worksteal", num_threads=2), **kw)
    return repro_torch.RegisterSeriesConfig(
        registration=RegistrationConfig(lr_shift=lr_shift, levels=2,
                                        max_iters=max_iters),
        refine=refine, **kw)


def _run(cfg, frames, feeds: int = 2):
    with service.open_series(cfg, device="cpu") as s:
        for lo in range(0, 16 * feeds, 16):
            s.feed(frames[lo:lo + 16])
        return s.result()


def _lose_first_take(monkeypatch):
    """The first steal take of the test loses its race (as when a
    neighbour claims the gap's last element first)."""
    real = work_stealing._Gap.take_left
    lost = []

    def take_left(self):
        if not lost:
            lost.append(1)
            return None
        return real(self)

    monkeypatch.setattr(work_stealing._Gap, "take_left", take_left)


def _caller_waits_on_the_pool():
    """Two tasks run at once, on the calling thread and on a worker; the
    worker's outlasts the caller's, so the caller waits for it."""
    caller = threading.get_ident()
    both = threading.Barrier(2)

    def task():
        both.wait(timeout=30)
        if threading.get_ident() != caller:
            time.sleep(0.05)

    scheduler.get_default_pool().run_tasks([task, task])


def test_every_span_lands_in_the_trace_and_pool_threads_trace(frames,
                                                              monkeypatch):
    _lose_first_take(monkeypatch)
    # Every aten op of every thread is recorded: descents of a few steps.
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=tracing.all_threads_config()) as prof:
        # Stealing refinements on the pool; the dispatcher's own choice;
        # a composing scan.
        stolen = _run(_config(True, 1.01, max_iters=3), frames)
        _run(_config(True, 1.01, max_iters=3, backend=None, num_threads=None),
             frames, feeds=1)
        _run(_config(False, 1.01, max_iters=3), frames, feeds=1)
        _caller_waits_on_the_pool()
    events = prof.profiler.kineto_results.events()
    threads = {}
    for e in events:
        threads.setdefault(e.name(), set()).add(e.start_thread_id())
    missing = [n for n in tracing.NAMES if n not in threads]
    assert not missing
    (main,) = threads["repro.feed"]
    for name in ("repro.steal.task", "repro.op.refine", "repro.fnA.step"):
        assert threads[name] - {main}, name
    assert sum(f["failed_takes"] for f in stolen.feeds) >= 1


def test_spans_of_the_calling_thread_need_no_option(frames):
    """Under the profiler's default collection the calling thread's spans
    still land."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(_config(False, 1.02, max_iters=3), frames)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"repro.feed", "repro.feed.ingest", "repro.fnA", "repro.fnA.step",
            "repro.scan", "repro.scan.compose", "repro.feed.evict"} <= names


@pytest.mark.parametrize("refine", [True, False])
def test_no_profiler_no_record_function(frames, monkeypatch, refine):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("repro.feed") is tracing.span("repro.scan")
    res = _run(_config(refine, 1.03), frames)
    assert len(res.feeds) == 2


@pytest.mark.parametrize("refine", [True, False])
def test_feed_counters(frames, refine):
    res = _run(_config(refine, 1.04), frames)
    reg = RegistrationConfig(lr_shift=1.04, **REG)
    want = register_pair(frames[:-1], frames[1:], None, reg)
    feeds = res.feeds
    assert [f["n_elems"] for f in feeds] == [15, 16]
    assert sum(f["pair_iters"] for f in feeds) == int(want.iterations.sum())
    for f in feeds:
        assert set(f) == set(service._FEED_KEYS)
        assert f["fnA_steps"] >= reg.levels
        assert 0 < f["pair_iters"] <= f["fnA_lane_steps"]
        assert f["fnA_s"] > 0
        if refine:
            assert f["refined"] > 0 and f["refine_iters"] >= f["refined"]
            assert 0 < f["refine_s"] <= f["op_s"] <= f["task_s"]
            assert f["wait_s"] >= 0
        else:
            assert (f["refine_iters"], f["op_s"], f["task_s"], f["wait_s"]) \
                == (0, 0.0, 0.0, 0.0)
    # The session's stage clock is the feeds' function A seconds.
    assert sum(f["fnA_s"] for f in feeds) == pytest.approx(
        res.timings["preprocess"])
    json.dumps(feeds)


def test_snapshot_from_before_the_counters_restores(tmp_path, frames):
    """A snapshot whose feed records lack the counters restores them as
    zeros."""
    cfg = _config(False, 1.05)
    s = service.open_series(cfg, device="cpu", checkpoint_dir=str(tmp_path))
    s.feed(frames[:16])
    s.checkpoint()
    s.close()
    path = os.path.join(tmp_path, "step_00000016", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    old = ("backend", "skipped", "refined")
    manifest["metadata"]["feeds"] = [
        {k: v for k, v in f.items() if k in old}
        for f in manifest["metadata"]["feeds"]]
    with open(path, "w") as f:
        json.dump(manifest, f)
    r = service.SeriesSession.restore(str(tmp_path), device="cpu")
    (summary,) = r.summaries
    r.close()
    assert summary.n_elems == 15 and summary.backend == "vector"
    fields = [f.name for f in dataclasses.fields(summary)]
    for name in fields[fields.index("fnA_s"):]:
        assert getattr(summary, name) == 0, name


@pytest.mark.parametrize("backend, kw", [
    ("worksteal", dict(num_threads=2)),
    ("hierarchical", dict(num_segments=2, num_threads=2)),
])
def test_scan_thread_time_is_tasks_and_waits(backend, kw):
    """The stats an element-domain scan hands back split its threads' time
    into task seconds and idle seconds, none of it outside the scan."""
    def op(a, b):
        time.sleep(0.002)
        return a + b

    stats = []
    vals = [float(v) for v in range(12)]
    t0 = time.perf_counter()
    ys = scan(op, vals, backend=backend, stats=stats, **kw)
    wall = time.perf_counter() - t0
    assert ys == pytest.approx([sum(vals[:i + 1]) for i in range(12)])
    (st,) = stats
    threads = len(getattr(st, "boundaries", None) or st.intervals)
    assert threads == 2 * kw.get("num_segments", 1)
    assert st.task_seconds() > 0 and st.wait_time >= 0
    assert st.task_seconds() + st.wait_time <= threads * wall


def test_one_element_feed_keeps_the_last_scan_stats(frames):
    """A one-element feed runs no scan: the session keeps the stats of its
    last scan, and the feed records no task time."""
    cfg = _config(True, 1.06, max_iters=3, backend="hierarchical",
                  num_segments=2)
    with service.open_series(cfg, device="cpu") as s:
        s.feed(frames[:16])
        first = s.result().scan_stats
        s.feed(frames[16:17])
        res = s.result()
    assert type(first).__name__ == "HierStats" and first.wait_time >= 0
    assert res.scan_stats is first
    assert res.feeds[-1]["n_elems"] == 1 and res.feeds[-1]["task_s"] == 0
