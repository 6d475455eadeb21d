"""The readers of the program's per-feed counters: their arithmetic on
hand-made feed records, and a tiny traced run of each cell on the CPU
that reports them."""

import importlib.util
import os
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import run  # noqa: E402

FN_A = ("fnA_iters_per_pair", "fnA_lane_use", "fnA_ms_per_step")
REFINE = ("refine_iters_per_refinement", "refine_ms_per_iter", "steal_wait_share")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(name, feeds):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_spans_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read({"result": SimpleNamespace(timings={}, feeds=feeds)})


def _feed(**kw):
    f = {"n_elems": 16, "backend": "worksteal", "skipped": 0, "refined": 0,
         "seconds": 1.0, "fnA_s": 0.0, "pair_iters": 0, "fnA_steps": 0,
         "fnA_lane_steps": 0, "refine_iters": 0, "refine_s": 0.0,
         "op_s": 0.0, "task_s": 0.0, "wait_s": 0.0, "failed_takes": 0}
    f.update(kw)
    return f


REFINING = [
    _feed(n_elems=15, fnA_s=1.2, pair_iters=600, fnA_steps=150,
          fnA_lane_steps=1140, refined=10, skipped=5, refine_iters=400,
          refine_s=2.0, op_s=2.5, task_s=3.0, wait_s=1.0),
    _feed(n_elems=16, fnA_s=1.4, pair_iters=640, fnA_steps=170,
          fnA_lane_steps=1360, refined=6, skipped=10, refine_iters=200,
          refine_s=1.0, op_s=1.5, task_s=2.0, wait_s=2.0),
]
COMPOSING = [_feed(n_elems=15, fnA_s=1.0, pair_iters=300, fnA_steps=100,
                   fnA_lane_steps=800, backend="vector")]


@pytest.mark.parametrize("name, feeds, want", [
    ("fnA_iters_per_pair", REFINING, 1240 / 31),
    ("fnA_lane_use", REFINING, 1240 / 2500),
    ("fnA_ms_per_step", REFINING, 1e3 * 2.6 / 320),
    ("refine_iters_per_refinement", REFINING, 600 / 16),
    ("refine_ms_per_iter", REFINING, 1e3 * 3.0 / 600),
    ("steal_wait_share", REFINING, 1 - 4.0 / 8.0),
    ("fnA_iters_per_pair", COMPOSING, 20.0),
    ("fnA_lane_use", COMPOSING, 300 / 800),
    ("fnA_ms_per_step", COMPOSING, 10.0),
])
def test_reader_arithmetic(name, feeds, want):
    assert _read(name, feeds) == pytest.approx(want)


def test_wait_share_reads_only_feeds_that_ran_pool_tasks():
    """A feed whose scan ran no pool task (a sequential chain) holds
    operator time but no task time: it is left out, not counted as a
    negative wait."""
    chain = _feed(refined=3, refine_iters=30, refine_s=0.4, op_s=0.5)
    assert _read("steal_wait_share", REFINING + [chain]) == pytest.approx(0.5)


@pytest.mark.parametrize("name", FN_A + REFINE)
def test_nothing_to_read_is_none(name):
    """A zero denominator reads None: a composing session's refinements,
    or feed records without the counters (a program that lacks them)."""
    old = [{k: f[k] for k in ("n_elems", "backend", "skipped", "refined",
                              "seconds")} for f in REFINING]
    assert _read(name, old) is None
    assert _read(name, []) is None
    if name in REFINE:
        assert _read(name, COMPOSING) is None


#: Tiny runs: 64 x 96 frames and short descents (what is read is whether
#: the counters arrive, not the answers).
TINY = {"height": 64, "width": 96, "pair_ref_blocks": 1,
        "registration": {"levels": 2, "max_iters": 20, "lr_shift": 1.0,
                         "lr_angle": 1.25e-6, "tol": 1e-7,
                         "estimate_rotation": True}}


@pytest.mark.parametrize("cell, overrides, traffic, want", [
    ("tem_compose.drift", {"n_frames": 96}, {}, FN_A),
    # Every check refines, on the stealing scan (the dispatcher would run
    # a tiny operator as a sequential chain).
    ("tem_refine.drift", {"n_frames": 48, "skip_tol": 1e-6,
                          "backend": "worksteal"}, {"chunk_frames": 8},
     FN_A + REFINE),
])
def test_traced_tiny_run_reports_the_counters(cell, overrides, traffic, want):
    line = run.run_cell(cell, 2**31 + 5, 0.0, True, device="cpu",
                        overrides=dict(TINY, **overrides),
                        traffic_overrides=traffic)
    m = line["metrics"]
    assert set(want) <= set(m) and not (set(FN_A + REFINE) - set(want)) & set(m)
    assert 0 < m["fnA_lane_use"]["value"] <= 1
    assert m["fnA_lane_use"]["unit"] == "ratio"
    if "steal_wait_share" in want:
        assert m["refine_iters_per_refinement"]["value"] >= 1
        assert m["steal_wait_share"]["value"] < 1
