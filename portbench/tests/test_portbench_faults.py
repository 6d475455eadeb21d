"""The timed path broken underneath, with the rest of a run as it is:
``correct`` has to come out false for each fault a cell can have.  (The
cells run on one chip: there is no exchange between chips to leave out.)"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import math  # noqa: E402
import types  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench import run  # noqa: E402
from repro_torch import service  # noqa: E402
from repro_torch.core.deformation import identity_deformation  # noqa: E402
from repro_torch.core.registration import RegElement, RegResult  # noqa: E402

TINY = {"height": 64, "width": 96, "n_frames": 40, "pair_ref_blocks": 2}
CELLS = {"tem_compose.drift": {"chunk_frames": 8},
         "tem_refine.drift": {"chunk_frames": 4}}

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tensors are tiny: one intra-op thread, so that a test run with
    many workers does not oversubscribe the cores (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _run(cell):
    return run.run_cell(cell, 23, 0.0, False, device="cpu", overrides=TINY,
                        traffic_overrides=CELLS[cell])


def _state_unchanged(mp):
    """Every scan step returns the state it was seeded with."""
    def unchanged(self, new_elems, seed):
        base = (seed.deformation if seed is not None
                else identity_deformation(device=self.device))
        k = len(self._elements) + 1
        return [RegElement(base, 0, k + i) for i in range(len(new_elems))]

    def unchanged_refine(self, new_elems, seed):
        return (unchanged(self, new_elems, seed), "element",
                types.SimpleNamespace(skipped=0, refined=0))

    mp.setattr(service.SeriesSession, "_compose_suffix", unchanged)
    mp.setattr(service.SeriesSession, "_refine_suffix", unchanged_refine)


def _half_batch(mp):
    """Function A registers half of each batch; the others get the mean."""
    real = service.register_pair

    def half(ref, tmpl, init, cfg):
        n = ref.shape[0]
        k = max(1, n // 2)
        res = real(ref[:k], tmpl[:k], None, cfg)
        d = {key: torch.cat([v, v.mean(0, keepdim=True).expand(n - k, *v.shape[1:])])
             for key, v in res.deformation.items()}
        return RegResult(d, torch.cat([res.distance, res.distance[:1].expand(n - k)]),
                         torch.cat([res.iterations, res.iterations[:1].expand(n - k)]))

    mp.setattr(service, "register_pair", half)


def _pair_altered(mp):
    """One of function A's answers is a pixel off where it is made."""
    real = service.register_pair
    calls = []

    def altered(ref, tmpl, init, cfg):
        res = real(ref, tmpl, init, cfg)
        calls.append(1)
        if len(calls) == 3:
            res.deformation["shift"][min(1, ref.shape[0] - 1), 0] += 1.0
        return res

    mp.setattr(service, "register_pair", altered)


def _output_altered(mp):
    """One registered phi_{0,i} is off by a pixel where it is returned."""
    real = service.SeriesSession.result

    def altered(self):
        res = real(self)
        res.deformations["shift"] = res.deformations["shift"].clone()
        res.deformations["shift"][2, 1] += 1.0
        return res

    mp.setattr(service.SeriesSession, "result", altered)


def _angle_altered(mp):
    """One registered phi_{0,i}'s angle is off where it is returned, by as
    much as moves a corner of the frame one pixel (a thousandth of a
    radian at 1856 x 1920)."""
    real = service.SeriesSession.result

    def altered(self):
        res = real(self)
        res.deformations["angle"] = res.deformations["angle"].clone()
        res.deformations["angle"][2] += 1.0 / math.hypot(
            (TINY["height"] - 1) / 2.0, (TINY["width"] - 1) / 2.0)
        return res

    mp.setattr(service.SeriesSession, "result", altered)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _pair_altered, _output_altered,
                                   _angle_altered])
def test_a_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = _run(cell)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"] is True, line["checks"]
