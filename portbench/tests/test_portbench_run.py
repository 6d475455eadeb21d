"""End to end through the harness at a tiny size on the CPU, and the run
that finds no card."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import run  # noqa: E402

TINY = {"height": 64, "width": 96, "n_frames": 96, "pair_ref_blocks": 2}

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread, so that a test run with
    many workers does not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture
def no_card_env():
    """The environment of a run that sees no CUDA device, whether or not
    this machine has one."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys_of_a_tiny_run(trace):
    line = run.run_cell("tem_compose.drift", 2**31 + 3, 0.2, bool(trace),
                        device="cpu", overrides=TINY)
    assert list(line)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    # The traced feeds come after the window, and their answers are checked too.
    extra = line["attempted"] - (line["window"]["frames"] - 1)
    assert extra % 16 == 0 and (extra >= 16 if trace else extra == 0)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == {"pair_ref_px", "pair_truth_px", "chain_px"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    m = line["metrics"]
    if trace:
        assert {"fnA_ms_per_pair", "scan_ms_per_frame"} <= set(m)
        assert "frames_per_s" not in m
        # No device on the CPU: nothing for the device's readers but idle.
        assert "warp_ncc_roofline" not in m
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0
    else:
        # The rate is over all the work and all the time of the window.
        w = line["window"]
        assert m["frames_per_s"]["value"] == pytest.approx(w["frames"] / w["seconds"])
        assert m["setup_s"]["value"] > 0
        # A CPU run reports no device memory metric.
        assert "program_peak_gb" not in m
    json.dumps(line)


def test_refining_cell_end_to_end_tiny():
    line = run.run_cell("tem_refine.drift", 17, 0.0, False, device="cpu",
                        overrides=dict(TINY, n_frames=20),
                        traffic_overrides={"chunk_frames": 4})
    assert line["correct"] is True
    assert set(line["checks"]) == {"pair_ref_px", "pair_truth_px", "truth_shift_px",
                                   "truth_corner_px"}
    assert line["window"]["frames"] == 4


def test_run_without_a_card_fails_and_prints_no_result(no_card_env):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tem_refine.drift",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=no_card_env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        run.load_cell("no_such.cell")


def test_cells_find_their_files_by_name():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for cell in bench["workloads"]:
        spec = run.load_cell(cell["name"])
        assert spec["config"]["name"] == cell["config"]
        assert spec["traffic"]["name"] == cell["traffic"]
        for m in spec["per_layer"]:
            assert callable(run._reader(m["name"]))
