"""Where the bf16 ``chunk_local`` kernel's time goes, and what its rounding
does to the served model.  Run from the repository root on a machine with a
CUDA card::

    python tools/chunk_probe.py ablate
    python tools/chunk_probe.py phases
    python tools/chunk_probe.py gap --previous-csrc DIR

``ablate`` builds copies of ``csrc/chunk_scan.cu`` with one part of
``chunk_local_bf16_kernel`` switched off (its stores, the state summary,
y_intra), times each at the serving shape (bf16, G 1792, L 128, dk = dv =
64) by CUDA-graph replay, in turns and then in reverse, and prints the
milliseconds; the outputs of a copy are wrong by design and are not checked.

``phases`` builds a copy that records ``clock64()`` at the phase boundaries
of each g (thread 0 of each warpgroup, blocks 0-1, the first 8 g a block)
and prints the cycles of each phase: issuing the next g's copies, waiting
for this g's, the two barriers, the state summary, y_intra, staging and
storing y_intra.

``gap`` serves one prefill of Zamba2-7B at full width and depth in bf16
(4 prompts of 512 tokens, seeded weights) through the current chunk
kernels, through those built from ``--previous-csrc`` (an earlier commit's
``src/repro_torch/kernels/csrc``) and through the "xla" backends, and
prints the largest logit gaps between the three.

Each prints the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (timing helpers, shapes, inputs)
from repro_torch.kernels import _cuda  # noqa: E402

# The parts ``ablate`` switches off: (old text, new text) edits of
# chunk_scan.cu, each of which must match exactly once.
_S_STORE = ("            *reinterpret_cast<float2*>(sg + (long long)k * dv "
            "+ col) =")
_Y_STORE = "      *reinterpret_cast<uint4*>(yg + (long long)i * 8) ="
_STATE = "    if (64 * wg < dk) {\n      float acc[DVP / 2];"
_Y = "    if (y_rows) {\n      const float ca_r"
ABLATIONS = {
    "baseline": [],
    "no_state_stores": [(_S_STORE, _S_STORE.replace("*", "if (L < 0) *", 1))],
    "no_y_stores": [(_Y_STORE, _Y_STORE.replace("*", "if (L < 0) *", 1))],
    "no_state": [(_STATE, _STATE.replace("dk)", "dk && L < 0)"))],
    "no_y": [(_Y, _Y.replace("(y_rows)", "(y_rows && L < 0)"))],
}

# ``phases``: MARK(k) goes before (True) or after (False) each of these
# lines of the kernel's loop over g (each must match once).
_MARKS = [
    ("  for (int it = 0; g < G; ++it, g += gridDim.x) {\n", False, 0),
    ("    if (tma) {\n      wgmma::mbar_wait(", True, 1),
    ("      wgmma::fence_async_smem();\n    }\n", False, 2),
    ("    const unsigned char* ct = st;\n", True, 3),
    ("    // State summary: rows 64 wg..", True, 4),
    ("    // y_intra: this warpgroup's half", True, 5),
    ("    __syncthreads();   // every product has read this stage\n", False, 6),
    ("    __syncthreads();   // this stage and w are free for the next g\n",
     False, 7),
]
PHASES = ["issue next g", "wait for this g", "barrier", "w and barrier",
          "state summary", "y_intra", "stage and store y_intra"]


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"chunk_probe: the source no longer holds {old!r} "
                         "once; update the probe")
    return src.replace(old, new)


def _build(tag: str, edit) -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "chunk_probe", tag)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, out)
    path = os.path.join(out, "chunk_scan.cu")
    with open(path) as f:
        src = edit(f.read())
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(out, "lib.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, path],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib)


def _local_entry(lib: ctypes.CDLL):
    fn = lib.chunk_local_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def _serving_inputs(device):
    cfg, g, l = chip_smoke._lm_shapes()
    dk, dv = cfg.ssm_state, cfg.ssm_head_dim
    c, b, v, ca = chip_smoke._chunk_inputs(g, l, dk, dv, torch.bfloat16,
                                           device, seed=20)
    y = torch.empty_like(v)
    s = torch.empty((g, dk, dv), device=device)

    def run(fn):
        err = fn(1, c.data_ptr(), b.data_ptr(), v.data_ptr(), ca.data_ptr(),
                 y.data_ptr(), s.data_ptr(), g, l, dk, dv,
                 torch.cuda.current_stream(device).cuda_stream)
        assert err == 0, err

    return run


def ablate(device) -> None:
    run = _serving_inputs(device)
    fns = {}
    for name, edits in ABLATIONS.items():
        def edit(src, edits=edits):
            for old, new in edits:
                src = _edit(src, old, new)
            return src
        fns[name] = _local_entry(_build(f"ablate-{name}", edit))
    times = {name: [] for name in fns}
    for order in (list(fns), list(reversed(list(fns)))):
        for name in order:
            times[name].append(chip_smoke._graph_ms(
                lambda fn=fns[name]: run(fn)))
    for name, ms in times.items():
        print(f"chunk_local {name}: graph ms {ms}", flush=True)


def phases(device) -> None:
    def edit(src):
        src = _edit(src, "using bf16 = __nv_bfloat16;\n",
                    "using bf16 = __nv_bfloat16;\n"
                    "__device__ long long g_probe[2][2][8][8];\n"
                    "#define MARK(k) if ((threadIdx.x & 127) == 0 && "
                    "blockIdx.x < 2 && it < 8) g_probe[blockIdx.x]"
                    "[threadIdx.x >> 7][it][k] = clock64();\n")
        for anchor, before, k in _MARKS:
            mark = f"    MARK({k})\n"
            src = _edit(src, anchor,
                        mark + anchor if before else anchor + mark)
        return src + ('\nextern "C" int chunk_probe_read(void* host) {\n'
                      "  return (int)cudaMemcpyFromSymbol(host, g_probe, "
                      "sizeof(g_probe));\n}\n")
    lib = _build("phases", edit)
    run = _serving_inputs(device)
    fn = _local_entry(lib)
    for _ in range(3):
        run(fn)
    torch.cuda.synchronize()
    marks = np.zeros((2, 2, 8, 8), dtype=np.int64)
    assert lib.chunk_probe_read(ctypes.c_void_p(marks.ctypes.data)) == 0
    print("chunk_local phase cycles a g (" + ", ".join(PHASES) + ", total)")
    for blk in range(2):
        for wg in range(2):
            for it in range(8):
                t = marks[blk, wg, it]
                if t[0] == 0:
                    break
                row = [int(t[k] - t[k - 1]) for k in range(1, 8)]
                print(f"block {blk} warpgroup {wg} g #{it}: {row} "
                      f"{int(t[7] - t[0])}", flush=True)


def gap(device, previous_csrc: str) -> None:
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.launch.serve import ServeConfig, Server
    from repro_torch.models import lm

    cfg = chip_smoke._lm_config(False, attn_backend="pallas",
                                ssm_backend="pallas")
    xcfg = chip_smoke._lm_config(False, attn_backend="xla", ssm_backend="xla")
    srv = Server(ServeConfig(arch="zamba2-7b", smoke=False, max_batch=4,
                             max_len=1024, eos_id=None),
                 device=device, acfg=cfg)
    rng = np.random.default_rng(0)
    tokens = np.stack([rng.integers(2, cfg.vocab_size, chip_smoke.LM_PROMPT)
                       for _ in range(chip_smoke.LM_BATCH)])
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.long,
                                       device=device)}

    def prefill(c):
        states = lm.init_decode_states(c, chip_smoke.LM_BATCH, 1024,
                                       device=device)
        with torch.no_grad():
            return lm.prefill(srv.params, c, batch, states)[0]

    new, xla = prefill(cfg), prefill(xcfg)
    pl, pa = (chip_smoke._previous_launch(previous_csrc, name)
              for name in ("chunk_local", "chunk_apply"))
    entries = cs._entries
    cs._entries = lambda: (pl, pa, entries()[2])
    try:
        old = prefill(cfg)
    finally:
        cs._entries = entries
    for what, a, b in (("current kernels vs xla", new, xla),
                       ("previous kernels vs xla", old, xla),
                       ("current vs previous kernels", new, old)):
        print(f"{what}: {chip_smoke._logit_gap(a, b)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["ablate", "phases", "gap"])
    ap.add_argument("--previous-csrc", default=None,
                    help="gap: csrc directory of the previous chunk kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chunk_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if args.what == "ablate":
        ablate(device)
    elif args.what == "phases":
        phases(device)
    else:
        if not args.previous_csrc:
            ap.error("gap needs --previous-csrc")
        gap(device, args.previous_csrc)
    print(chip_smoke._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
