"""Time a few kernels and the decoupled scan from a given tree, for runs in turns.

Run from the repository root on a machine with a CUDA card, once per tree
and in turns (e.g. an earlier commit unpacked with ``git archive`` into
the ignored ``build/``)::

    for t in build/parent . . build/parent; do
        python tools/kernel_turns.py $t
    done

It imports ``chip_smoke.py`` and ``repro_torch`` from the tree given,
builds ``lookback_scan`` and ``chunk_scan`` there, runs ``chip_smoke.py``'s
``check_lookback_scan`` and ``check_chunk_kernels`` (each kernel held to
its plain version and timed by CUDA events) and times ``engine.scan`` of
add over 2^24 floats (the ``decoupled`` backend) by the host clock, the
median of 20 calls.  It prints one JSON line.
"""

import json
import os
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
sys.path.insert(0, os.path.join(root, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.engine import scan  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402

_cuda.build(["lookback_scan", "chunk_scan"])
dev = torch.device("cuda", 0)
kl = cs.check_lookback_scan(dev)
kc_local, kc_apply = cs.check_chunk_kernels(dev)
x = cs._ints(1 << 24, 1, dev, seed=5)[:, 0]
walls = []
for _ in range(20):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan(torch.add, x)
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({
    "tree": sys.argv[1], "lookback_ms": kl["ms"],
    "chunk_local_ms": kc_local["ms"], "chunk_apply_ms": kc_apply["ms"],
    "chunk_local_f32_ms": kc_local["f32"]["ms"],
    "chunk_apply_f32_ms": kc_apply["f32"]["ms"],
    "decoupled_add_wall_ms_median": sorted(walls)[10],
    "card": cs._smi(),
}), flush=True)
