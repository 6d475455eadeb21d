"""Time a few kernels and the decoupled scan from a given tree, for runs in turns.

Run from the repository root on a machine with a CUDA card, once per tree
and in turns (e.g. an earlier commit unpacked with ``git archive`` into
the ignored ``build/``)::

    for t in build/parent . . build/parent; do
        python tools/kernel_turns.py $t
    done

It imports ``chip_smoke.py`` and ``repro_torch`` from the tree given,
builds ``lookback_scan``, ``tile_scan`` and ``chunk_scan`` there, runs
``chip_smoke.py``'s ``check_lookback_scan`` and ``check_chunk_kernels``
(each kernel held to its plain version and timed by CUDA events), times
the float32 add of ``tile_local_scan`` (16, 128 and 4,096 tiles) and
``tile_apply`` (16 tiles) over 2^24 floats by CUDA events and from a CUDA
graph, and times ``engine.scan`` of add over 2^24 floats (the
``decoupled`` backend) by the host clock, the median of 20 calls.  It
prints one JSON line.
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
from repro_torch.kernels import tile_scan as ts  # noqa: E402

_cuda.build(["lookback_scan", "tile_scan", "chunk_scan"])
dev = torch.device("cuda", 0)
kl = cs.check_lookback_scan(dev)
kc_local, kc_apply = cs.check_chunk_kernels(dev)
xt = cs._ints(1 << 24, 1, dev, seed=3)
tiles = {}
for t in (16, 128, 4096):
    call = lambda t=t: ts.tile_local_scan_cuda(torch.add, xt, t)  # noqa: E731
    tiles[f"tile_local_scan_T{t}"] = {"ms": cs._time_ms(call),
                                      "graph_ms": cs._graph_ms(call)}
local, parts = ts.tile_local_scan_cuda(torch.add, xt, 16)
seeds = torch.cumsum(parts, 0)
call = lambda: ts.tile_apply_cuda(torch.add, local, seeds)  # noqa: E731
tiles["tile_apply_T16"] = {"ms": cs._time_ms(call),
                           "graph_ms": cs._graph_ms(call)}
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
    "decoupled_add_wall_ms_median": sorted(walls)[10], **tiles,
    "card": cs._smi(),
}), flush=True)
