"""The control of ``correct``: the plain reference put in the program's place
in bfloat16, the precision below the configurations' float32.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--frames N]

For each seed it renders the cell's series (``N`` frames: as many as a
window of the cell registers) and makes the answers a run would hand to
the check, with the bfloat16 reference in the program's place:

* the pair elements: function A on every pair ``(f_i, f_{i+1})``;
* the ``phi_{0,i}``: those elements composed one after another; in a
  refining cell each composed guess is then refined by function A on
  ``(f_0, f_i)`` (operator B with every guess refined).

Those answers go through the harness's own comparison (``run.check``), so
the control is judged exactly as a run is.  Each seed's numbers, with their
limits, and the verdict go to standard output as one JSON line; the verdict
has to be false.  It runs on the card (the tests call ``readings`` on the
CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import judge, series  # noqa: E402
from portbench.reference import compose as ref_compose  # noqa: E402
from portbench.reference import registration as ref_registration  # noqa: E402
from portbench.run import REF_BLOCK, check, load_cell  # noqa: E402


def _register(refs, tmps, reg: dict, dtype, init=None) -> dict:
    got, _ = ref_registration.register(refs, tmps, reg, dtype=dtype, init=init)
    return {k: v.detach().cpu() for k, v in got.items()}


def answers(cfg: dict, frames: torch.Tensor, dtype) -> tuple:
    """``(pair elements, phi_{0,i} for i = 0..n-1)`` of the reference in
    ``dtype`` in the program's place (module docstring)."""
    n, h, w = frames.shape
    reg = cfg["registration"]
    blocks = [list(range(lo, min(lo + REF_BLOCK, n - 1)))
              for lo in range(0, n - 1, REF_BLOCK)]
    parts = [_register(frames[b], frames[[i + 1 for i in b]], reg, dtype)
             for b in blocks]
    pairs = {k: torch.cat([p[k] for p in parts]) for k in ("angle", "shift")}
    chain = ref_compose.chain(pairs, dtype=dtype)
    if cfg["refine"]:
        parts = [_register(frames[:1].expand(len(b), h, w),
                           frames[[i + 1 for i in b]], reg, dtype,
                           init={k: v[b].float() for k, v in chain.items()})
                 for b in blocks]
        chain = {k: torch.cat([p[k] for p in parts]) for k in ("angle", "shift")}
    outputs = {"angle": torch.cat([torch.zeros(1), chain["angle"].float()]),
               "shift": torch.cat([torch.zeros(1, 2), chain["shift"].float()])}
    return pairs, outputs


def readings(workload: str, seed: int, n_frames: int, device,
             overrides: dict = None, dtype=torch.bfloat16) -> dict:
    """The harness's checks (``{name: {"value", "limit"}}``) of the
    reference in ``dtype`` in the program's place, for one seed."""
    spec = load_cell(workload)
    cfg = dict(spec["config"], **(overrides or {}))
    frames, truth = series.make_series(seed, cfg, spec["traffic"], n_frames,
                                       device)
    pairs, outputs = answers(cfg, frames, dtype)
    checks, _ = check(cfg, seed, frames, truth, n_frames,
                      list(range(n_frames - 1)), pairs, outputs)
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = readings(args.workload, seed, args.frames, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "frames": args.frames, "correct": judge.verdict(checks),
                          "checks": checks,
                          "fails": sorted(k for k, c in checks.items()
                                          if not c["value"] <= c["limit"])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
