"""The control (the reference in the program's place in bfloat16) fails a
number of every cell, at a size a test run holds."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import control, judge  # noqa: E402

SMALL = {"height": 64, "width": 96, "pair_ref_blocks": 2}

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread, so that a test run with
    many workers does not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.mark.parametrize("cell", ["tem_compose.drift", "tem_refine.drift"])
def test_the_control_fails_the_cell(cell):
    """Through the harness's own comparison, ``correct`` comes out false."""
    checks = control.readings(cell, 31, 33, torch.device("cpu"), overrides=SMALL)
    assert judge.verdict(checks) is False, checks
    assert checks["pair_ref_px"]["value"] > checks["pair_ref_px"]["limit"]


def test_the_reference_in_float32_passes_where_the_control_fails():
    checks = control.readings("tem_compose.drift", 31, 33, torch.device("cpu"),
                              overrides=SMALL, dtype=torch.float32)
    assert checks["pair_ref_px"]["value"] == 0.0
    assert judge.verdict(checks) is True, checks
