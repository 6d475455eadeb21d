"""The port's slice end to end: ``repro_torch.register_series`` against
``repro.register_series``, the session's streaming behaviour, its device
rule, and the port's independence from JAX and the reference package."""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.data.images import make_series
from repro_torch import service
from repro_torch.runtime import scheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIFT_MAX = 0.35   # the reference's own bound (test_hierarchical.py)
PARITY_PX = 0.05


@pytest.fixture(autouse=True, scope="module")
def _pool_teardown():
    # One intra-op thread: the suite runs several test processes at once,
    # and small tensors gain nothing from more.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    from repro.runtime import scheduler as ref_scheduler

    pool = scheduler.get_default_pool()
    pool.shutdown()
    pool.join(timeout=10)
    scheduler.set_default_pool(None)
    # The reference's pool ran the reference's half of the parity test.
    ref_pool = ref_scheduler.get_default_pool()
    ref_pool.shutdown()
    for t in list(ref_pool._threads):
        t.join(timeout=10)
    ref_scheduler.set_default_pool(None)


@pytest.fixture(scope="module")
def series8():
    frames, true = make_series(jax.random.PRNGKey(11), 8, size=96, noise=0.15)
    return frames, np.array(frames), {k: np.array(v) for k, v in true.items()}


def test_register_series_matches_reference(series8):
    frames_j, frames, true = series8
    kw = dict(backend="hierarchical", num_segments=2, num_threads=2,
              skip_tol=1e-6, fused_ncc=True)
    want = repro.register_series(
        frames_j, repro.RegisterSeriesConfig(telemetry_name="parity_ref", **kw)
    )
    got = repro_torch.register_series(
        frames, repro_torch.RegisterSeriesConfig(telemetry_name="parity", **kw),
        device="cpu",
    )
    s_ref = np.asarray(want.deformations["shift"])
    s_port = got.deformations["shift"].numpy()
    assert got.deformations["shift"].shape == (8, 2)
    assert np.abs(s_ref - true["shift"])[1:].max() < SHIFT_MAX
    assert np.abs(s_port - true["shift"])[1:].max() < SHIFT_MAX
    assert np.abs(s_port - s_ref).max() < PARITY_PX
    assert got.backend == "hierarchical" and got.scan_stats is not None
    assert set(got.timings) == {"ingest", "preprocess", "scan", "compose", "compile"}
    assert got.op_telemetry["calls"] > 0
    # One feed: one lookup of function A's launcher in the compile cache.
    cc = got.compile_cache
    assert set(cc) == {"hits", "misses", "compile_s"}
    assert cc["hits"] + cc["misses"] == 1
    # every refining application ran the guess check (skip_tol 1e-6 never skips)
    assert [f["skipped"] for f in got.feeds] == [0]
    assert got.feeds[0]["refined"] > 0
    assert "hierarchical" in got.report()


def test_streaming_matches_batch():
    """The same frames fed as one array and as a stream of chunks.  (The
    reference's ``stream_series`` renders its chunks with other batch
    shapes than ``make_series``, and its frames then differ by ~5e-6, which
    function A amplifies to ~1e-3 px; so both runs here take one render.)"""
    key = jax.random.PRNGKey(12)
    frames = np.array(make_series(key, 6, size=96, noise=0.12)[0])
    cfg = repro_torch.RegisterSeriesConfig(refine=False)
    a = repro_torch.register_series(frames, cfg, device="cpu")
    b = repro_torch.register_series((frames[i:i + 3] for i in (0, 3)), cfg,
                                    device="cpu")
    torch.testing.assert_close(a.deformations["shift"], b.deformations["shift"],
                               rtol=0, atol=1e-5)


def test_streaming_refined_matches_batch(series8):
    """With function B refining, chunked scans combine in another order;
    the minimiser lands within the parity bound all the same."""
    _, frames, _ = series8
    cfg = repro_torch.RegisterSeriesConfig(skip_tol=0.02)
    a = repro_torch.register_series(frames, cfg, device="cpu")
    b = repro_torch.register_series([frames[:5], frames[5:]], cfg, device="cpu")
    assert (a.deformations["shift"] - b.deformations["shift"]).abs().max() < PARITY_PX
    assert len(b.feeds) == 2


def test_empty_chunks_are_skipped(series8):
    _, frames, _ = series8
    fr = frames[:6]
    chunks = [fr[0:0], fr[0:3], fr[3:3], fr[3:6], fr[6:6]]
    cfg = repro_torch.RegisterSeriesConfig(refine=False)
    a = repro_torch.register_series(fr, cfg, device="cpu")
    b = repro_torch.register_series(iter(chunks), cfg, device="cpu")
    torch.testing.assert_close(a.deformations["shift"], b.deformations["shift"],
                               rtol=0, atol=1e-5)


def test_function_a_sub_batch_does_not_change_results(series8, monkeypatch):
    """A full chunk runs function A in fixed sub-batches; per-lane freezing
    makes each pair's result independent of the sub-batch, bit for bit."""
    _, frames, _ = series8
    cfg = repro_torch.RegisterSeriesConfig(refine=False)
    runs = []
    for sub in (2, 8):
        monkeypatch.setattr(service, "PAIR_SUB_BATCH", sub)
        runs.append(repro_torch.register_series(frames, cfg, device="cpu"))
    assert torch.equal(runs[0].deformations["shift"], runs[1].deformations["shift"])
    assert torch.equal(runs[0].deformations["angle"], runs[1].deformations["angle"])


def test_rejects_single_frame(series8):
    _, frames, _ = series8
    with pytest.raises(ValueError, match=">= 2 frames"):
        repro_torch.register_series(frames[:1], device="cpu")


def test_session_extend_after_result(series8):
    _, frames, _ = series8
    cfg = repro_torch.RegisterSeriesConfig(refine=False)
    with repro_torch.open_series(cfg, device="cpu") as s:
        s.feed(frames[:4])
        r1 = s.result()
        r2 = s.extend(frames[4:])
    assert r1.n_frames == 4 and r2.n_frames == 8
    full = repro_torch.register_series(frames, cfg, device="cpu")
    torch.testing.assert_close(r2.deformations["shift"], full.deformations["shift"],
                               rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError, match="closed"):
        s.feed(frames[:2])


def test_checkpoint_restore_not_ported(tmp_path):
    """The error paths of checkpoint/restore (their round trips are in
    test_torch_service.py): no checkpoint_dir, and no snapshot to read."""
    s = repro_torch.open_series(device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        s.checkpoint()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        repro_torch.SeriesSession.restore(str(tmp_path), device="cpu")
    s.close()


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.register_series(np.zeros((2, 32, 32), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.SeriesSession()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.SeriesSession(device="cuda")


def test_port_renders_its_own_series():
    """data/images.py: chunked rendering equals the one-shot render, and the
    drift stays below half the lattice period."""
    from repro_torch.data.images import make_series as tmake, stream_series as tstream

    frames, true = tmake(5, 7, size=48, device="cpu")
    chunks, _ = tstream(5, 7, chunk_size=3, size=48, device="cpu")
    assert torch.equal(frames, torch.cat(list(chunks)))
    steps = torch.diff(true["shift"], dim=0).abs()
    assert float(steps.max()) < 12.0 / 2
    assert frames.shape == (7, 48, 48) and bool(torch.isfinite(frames).all())


def test_import_pulls_in_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch\n"
        "from repro_torch.data.images import make_series\n"
        "frames, _ = make_series(0, 3, size=32, device='cpu')\n"
        "cfg = repro_torch.RegisterSeriesConfig(skip_tol=0.5, fused_ncc=True)\n"
        "res = repro_torch.register_series(frames, cfg, device='cpu')\n"
        "assert res.deformations['shift'].shape == (3, 2)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print('LEAKED', bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout


def _chip_smoke(*args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # the script finds src/ itself
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), *args],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )


def test_chip_smoke_cpu_rehearsal_runs_the_flow():
    """The chip script's series, compose, engine, serving, restore,
    simulate, multi-device, LM, training, LM multi-device and dry-run
    phases (every served configuration's smoke model; the mesh on gloo CPU
    ranks; the dry-run on a fake world) on the CPU (plain kernels): it
    prints their lines, no result line, and exits 3."""
    out = _chip_smoke("--cpu-rehearsal")
    assert out.returncode == 3, out.stderr
    lines = out.stdout.splitlines()
    assert [ln[:ln.index(" {")] for ln in lines] == [
        "series", "series_hier", "series_compose", "scan_engine", "serving",
        "series_restore", "simulate", "collective", "sharded", "lm_serve",
        "lm_serve codeqwen1.5-7b", "lm_serve internlm2-20b",
        "lm_serve qwen3-32b", "lm_serve qwen2-72b", "lm_serve xlstm-350m",
        "lm_serve phi3.5-moe-42b-a6.6b", "lm_serve arctic-480b",
        "lm_serve internvl2-1b", "lm_serve whisper-base",
        "lm_check", "lm_check xlstm-350m", "lm_check whisper-base",
        "train xlstm-350m", "train phi3.5-moe-42b", "train_check",
        "ssd_sharded", "compressed_psum", "train_mesh xlstm-350m",
        "train_mesh_check", "dryrun"]
    assert '"ok"' not in out.stdout


def test_chip_smoke_without_cuda_prints_no_result(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _chip_smoke()
    assert out.returncode == 2 and out.stdout == ""


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)|"
    r"from\s+repro\b(?!_torch))",
    re.MULTILINE,
)


def test_port_sources_import_no_jax_and_no_reference():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "src", "repro_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    offenders = []
    for p in paths:
        with open(p) as f:
            src = f.read()
        offenders += [(p, m.group(0).strip()) for m in _FORBIDDEN.finditer(src)]
    assert not offenders, offenders


def test_prefetched_producer_stops_when_consumer_abandons():
    """tests/test_hierarchical.py:409 on the port's pipeline: after the
    consumer closes the generator the producer thread stops pulling from
    the source promptly, with bounded lookahead."""
    import time

    from repro_torch.pipeline import _prefetched

    produced = []

    def source():
        for i in range(10_000):
            produced.append(i)
            yield i

    gen = _prefetched(source(), depth=1)
    assert next(gen) == 0
    gen.close()  # consumer walks away
    time.sleep(0.3)  # let any still-running producer make progress
    count = len(produced)
    time.sleep(0.2)
    assert len(produced) == count, "producer kept pulling after close()"
    # Bounded lookahead: one in flight + queue depth + one blocked put.
    assert count <= 8


def test_prefetched_reraises_producer_exception():
    """tests/test_hierarchical.py:433 on the port's pipeline."""
    from repro_torch.pipeline import _prefetched

    def source():
        yield 1
        raise RuntimeError("stream died")

    gen = _prefetched(source())
    assert next(gen) == 1
    with pytest.raises(RuntimeError, match="stream died"):
        next(gen)


def test_register_series_cross_steal_knob_and_report():
    """tests/test_hierarchical.py:446: cross_steal=True on a hierarchical
    run surfaces inter-segment steal counts in the stage report, in both
    packages, and the two agree on the shifts."""
    frames_j, _ = make_series(jax.random.PRNGKey(13), 10, size=96, noise=0.12)
    kw = dict(backend="hierarchical", num_segments=2, num_threads=2,
              cross_steal=True)
    want = repro.register_series(
        frames_j, repro.RegisterSeriesConfig(telemetry_name="test_cross_ref",
                                             **kw))
    got = repro_torch.register_series(
        np.array(frames_j),
        repro_torch.RegisterSeriesConfig(telemetry_name="test_cross", **kw),
        device="cpu")
    for res in (want, got):
        assert res.scan_stats is not None and res.scan_stats.cross_steal
        assert "cross-segment steals:" in res.report()
    assert np.abs(got.deformations["shift"].numpy()
                  - np.asarray(want.deformations["shift"])).max() < PARITY_PX
