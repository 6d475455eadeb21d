"""The benchmark's arithmetic: roofline, trace reduction, comparisons."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import judge, roofline, trace  # noqa: E402


def test_guess_check_roofline_at_the_paper_frame():
    nbytes, flops = roofline.guess_check_work(1856, 1920)
    assert nbytes == 2 * 1856 * 1920 * 4 + 8
    # Bound by bytes: 28.5 MB at 3.35 TB/s.
    assert roofline.bound_s(nbytes, flops) == pytest.approx(nbytes / 3.35e12)
    assert flops / roofline.PEAK_F32_FLOPS < nbytes / roofline.PEAK_BYTES_PER_S


def test_union_counts_overlapping_intervals_once():
    merged = trace.union([(5, 9), (0, 4), (2, 6), (12, 20), (30, 40)], 1, 35)
    assert merged == [(1, 9), (12, 20), (30, 35)]
    assert trace.gaps(merged, 0, 40) == [(0, 1), (9, 12), (20, 30), (35, 40)]


def _synthetic():
    # Two streams whose kernels overlap, an idle stretch under a host op.
    device = [("k_a", 100, 300), ("k_b", 200, 400), ("k_a", 600, 700)]
    host = [(0, 1000, "feed"), (400, 600, "aten::item"), (700, 1000, "py")]
    return trace.Trace(device, host, (0, 1000))


def test_idle_share_of_a_synthetic_trace():
    t = _synthetic()
    assert t.busy_s == pytest.approx(400e-9)      # 100-400 and 600-700
    assert t.window_s == pytest.approx(1000e-9)
    from portbench.metrics import device_idle_share
    assert device_idle_share.read({"trace": t}) == pytest.approx(0.6)


def test_breakdown_names_gaps_by_innermost_host_op():
    b = _synthetic().breakdown()
    ops = dict((k, v) for k, v in b["device_ops"])
    assert ops["k_a"] == pytest.approx(300e-9)
    assert ops["k_b"] == pytest.approx(200e-9)
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # 0-100 under "feed", 400-600 under "aten::item", 700-1000 under "py".
    assert gaps == pytest.approx({"feed": 100e-9, "aten::item": 200e-9,
                                  "py": 300e-9})


def test_roofline_reader_uses_device_time_a_check():
    dev = [("void warp_ncc_kernel<32>(...)", 0, 20000),
           ("warp_ncc_fold_kernel(...)", 20000, 25000),
           ("void warp_ncc_kernel<32>(...)", 30000, 50000),
           ("warp_ncc_fold_kernel(...)", 50000, 55000)]
    t = trace.Trace(dev, [], (0, 60000))
    from portbench.metrics import warp_ncc_roofline
    got = warp_ncc_roofline.read({"trace": t, "config": {"height": 1856, "width": 1920}})
    want = 100 * (2 * 1856 * 1920 * 4 + 8) / 3.35e12 / 25e-6
    assert got == pytest.approx(want)
    assert warp_ncc_roofline.read({"trace": trace.Trace([], [], (0, 1)),
                                   "config": {}}) is None


def test_corner_gap_of_rigid_deformations():
    a = {"angle": torch.tensor([0.0, 0.0]), "shift": torch.tensor([[0.0, 0.0], [3.0, 4.0]])}
    b = {"angle": torch.tensor([0.001, 0.0]), "shift": torch.zeros(2, 2)}
    gaps = judge.corner_gaps(a, b, 101, 201)
    # A rotation moves the corner (50, 100) by angle * radius; a shift by its length.
    assert float(gaps[0]) == pytest.approx(0.001 * (50**2 + 100**2) ** 0.5, rel=1e-3)
    assert float(gaps[1]) == pytest.approx(5.0)
    nan = {"angle": torch.tensor([float("nan")]), "shift": torch.zeros(1, 2)}
    assert judge.hold(judge.corner_gaps(nan, nan, 8, 8), 1, 1.0) == (float("inf"), [0])
    assert judge.hold(torch.tensor([0.1]), 3, 1.0) == (float("inf"), [1, 2])
    assert judge.hold(torch.tensor([0.1, 2.0, 0.3]), 3, 1.0) == (2.0, [1])
