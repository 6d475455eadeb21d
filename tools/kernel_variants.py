"""Time variants of a port kernel that differ in one compile-time constant.

Run from the repository root on a machine with a CUDA card::

    python tools/kernel_variants.py flash_attention kQWG 1 2

For each value it copies ``src/repro_torch/kernels/csrc`` into
``build/variants/<kernel>-<name>-<value>/``, sets the line
``constexpr int <name> = ...;`` of ``<kernel>.cu`` to the value, builds the
library with the port's nvcc flags (printing ptxas's register lines),
holds its output against the plain version at the main path's shape
(except an ablation's 0, wrong by design), and times it by CUDA-graph
replay (the card's own time), the variants in turn and then in reverse
order.  It prints one line per variant, and the card's name and power
limit.

Kernels: ``warp_ncc`` (1920x1920 f32, tile 32, angle 0.07, shift (1.5,
0.7): the series path's guess check; its constants are the patch width
``kPatchCols``, the rows a thread has in flight ``kUnroll``, the register
cap ``kMinBlocks``, and the ablation switches ``kGather``, ``kStore`` and
``kReduce``, whose 0 drops the template gathers, the warped store or the
block reduction, e.g. ``warp_ncc kGather 1 0``), ``flash_attention``
(bf16, BH 128, L 512, d 112, causal: the serving path's prefill),
``lookback_scan`` (add over 2^24 x 1 floats in 4096 tiles: the decoupled
backend's scan), ``fused_round`` (the
``fused_plan`` kernel of ``fused_round.cu``: a Ladner-Fischer plan over
2^16 x 1 floats in one launch, as the pallas backend's rounds mode runs
it) and ``tile_apply`` (add over 2^24 x 1 floats in 16 tiles, e.g.
``kApplyLoads``: float4 loads in flight a thread), ``chunk_local`` and
``chunk_apply`` (bf16 at the serving path's G = 1792, L = 128, dk = dv =
64; e.g. ``chunk_local kLocalTma 0 1``).  For ``fused_round`` the
name ``C`` varies the cluster size instead, a launch argument (no
rebuild), and ``--n``/``--d`` set the plan's rows and row width::

    python tools/kernel_variants.py fused_round C 4 8 16
    python tools/kernel_variants.py fused_round C 1 2 4 8 16 --n 4096 --d 3
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (timing helpers and tolerances)
from repro_torch.kernels import _cuda  # noqa: E402


# Each kernel's source (csrc/<source>.cu) and its C launch entry.
SOURCES = {"warp_ncc": ("warp_ncc", "warp_ncc_launch"),
           "flash_attention": ("flash_attention", "flash_attention_launch"),
           "lookback_scan": ("lookback_scan", "lookback_scan_launch"),
           "fused_round": ("fused_round", "fused_plan_launch"),
           "tile_apply": ("tile_scan", "tile_apply_launch"),
           "chunk_local": ("chunk_scan", "chunk_local_launch"),
           "chunk_apply": ("chunk_scan", "chunk_apply_launch")}


def _build(kernel: str, name: str, value: int):
    source, entry = SOURCES[kernel]
    out_dir = os.path.join(ROOT, "build", "variants",
                           f"{kernel}-{name}-{value}")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, out_dir)
    src_path = os.path.join(out_dir, f"{source}.cu")
    for path in [src_path] + [os.path.join(out_dir, f)
                              for f in os.listdir(out_dir)
                              if f.endswith(".cuh")]:
        with open(path) as f:
            src = f.read()
        new, hits = re.subn(rf"constexpr int {name} = [^;]+;",
                            f"constexpr int {name} = {value};", src)
        if hits:
            with open(path, "w") as f:
                f.write(new)
            break
    else:
        raise SystemExit(f"no 'constexpr int {name}' in {source}.cu or "
                         "the headers")
    lib = os.path.join(out_dir, "lib.so")
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib,
                           src_path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}={value}:\n{proc.stdout}"
                         f"{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or ("spill" in line
                                   and " 0 bytes spill stores" not in line):
            print(f"{kernel} {name}={value} ptxas: {line.strip()}")
    return getattr(ctypes.CDLL(lib), entry)


def _warp_ncc(device, pairs: int = 1):
    """One launch on each of ``pairs`` distinct (template, reference) pairs;
    the time printed is a launch's.  Four pairs (177 MB with the warped
    images) pass through the 50 MB L2, so each launch finds its frames cold,
    as a guess check of a series does."""
    from repro_torch.data.images import lattice_image
    from repro_torch.kernels import warp_ncc as wn

    size = chip_smoke.SIZE
    frames = [lattice_image(size, seed=k, device=device)
              for k in range(pairs + 1)]
    angle = torch.tensor(0.07, device=device)
    shift = torch.tensor((1.5, 0.7), device=device)
    want_w, want_s = wn.warp_ncc_sums_reference(frames[0], frames[1], angle,
                                                shift, tile=32)
    outs = [(torch.empty_like(frames[0]),
             torch.empty(((size // 32) ** 2, 8), device=device))
            for _ in range(pairs)]

    def run(fn):
        for k, (warped, sums) in enumerate(outs):
            err = fn(angle.data_ptr(), shift.data_ptr(),
                     frames[k].data_ptr(), frames[k + 1].data_ptr(),
                     warped.data_ptr(), sums.data_ptr(), None, size, size,
                     32, torch.cuda.current_stream(device).cuda_stream)
            assert err == 0, err
        return outs[0]

    def check(out):
        chip_smoke._close_to(out[0], want_w, chip_smoke.WARP_RTOL,
                             chip_smoke.WARP_ATOL, "variant warped")
        dn = float((wn.fold(out[1]) - wn.fold(want_s)).abs())
        assert dn <= chip_smoke.NCC_ATOL, dn

    argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return run, check, argtypes, pairs


def _flash(device):
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(22)
    q, k, v = ((torch.randn((128, 512, 112), generator=gen, device=device)
                * 0.5).to(torch.bfloat16) for _ in range(3))
    want = fa.flash_attention_reference(q, k, v)

    def run(fn):
        out = torch.empty_like(q)
        err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 128, 512, 512, 112, 112 ** -0.5, 1,
                 torch.cuda.current_stream(device).cuda_stream)
        assert err == 0, err
        return out

    def check(out):
        chip_smoke._close_to(out, want, *chip_smoke.BF16_TOL, "variant")

    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return run, check, argtypes


def _lookback(device):
    from repro_torch.kernels._tiling import default_num_tiles_cuda

    n = chip_smoke.SCAN_N
    t = default_num_tiles_cuda(n)
    x = chip_smoke._ints(n, 1, device, seed=1)
    want = torch.cumsum(x.double(), 0).float()

    def run(fn):
        y = torch.empty_like(x)
        board = torch.zeros((t, 2), dtype=torch.int32, device=device)
        aggs = torch.empty((t, 1), device=device)
        prefs = torch.empty((t, 1), device=device)
        counter = torch.zeros((1,), dtype=torch.int32, device=device)
        err = fn(0, 1, 0, x.data_ptr(), None, y.data_ptr(), board.data_ptr(),
                 aggs.data_ptr(), prefs.data_ptr(), counter.data_ptr(), None,
                 t, n // t, torch.cuda.current_stream(device).cuda_stream)
        assert err == 0, err
        return y

    def check(out):
        chip_smoke._require_equal(out, want, "variant")

    argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return run, check, argtypes


def _fused_plan(device, cluster=None, n=None, d=1):
    """Ladner-Fischer add over n x d (ROUNDS_N x 1 by default) as one
    fused_plan launch on ``cluster`` CTAs (the size rule's when None)."""
    from repro_torch.core.engine import get_plan
    from repro_torch.core.engine.pallas_backend import _plan_operands
    from repro_torch.kernels._tiling import plan_cluster_size, plan_stride

    n = n or chip_smoke.ROUNDS_N
    c = cluster or plan_cluster_size(n, d)
    po = _plan_operands(get_plan("ladner_fischer", n), device, c)
    x = chip_smoke._ints(n, d, device, seed=12)
    want = torch.cumsum(x.double(), 0).float()

    def run(fn):
        y = torch.empty_like(x)
        err = fn(0, d, x.data_ptr(), po.ops.data_ptr(), po.offsets.data_ptr(),
                 po.flags.data_ptr(), y.data_ptr(), None, n, po.rows_per,
                 plan_stride(n, d, c),
                 po.rounds, -1, -1, c,
                 torch.cuda.current_stream(device).cuda_stream)
        assert err == 0, err
        return y

    def check(out):
        chip_smoke._require_equal(out, want, "variant")

    argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return run, check, argtypes


def _tile_apply(device):
    from repro_torch.kernels import tile_scan as ts

    n, t = chip_smoke.SCAN_N, chip_smoke.TILE_COUNTS[0]
    x = chip_smoke._ints(n, 1, device, seed=3)
    local, parts = ts.tile_local_scan_reference(torch.add, x, t)
    seeds = torch.cat([parts[:1], torch.cumsum(parts, 0)[:-1]])
    want = torch.cumsum(x.double(), 0).float()

    def run(fn):
        out = torch.empty((n, 1), device=device)
        err = fn(0, 1, local.data_ptr(), seeds.data_ptr(), out.data_ptr(), t,
                 n // t, torch.cuda.current_stream(device).cuda_stream)
        assert err == 0, err
        return out

    def check(out):
        chip_smoke._require_equal(out, want, "variant")

    argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return run, check, argtypes


def _chunk_inputs(device):
    cfg, g, l = chip_smoke._lm_shapes()
    dk, dv = cfg.ssm_state, cfg.ssm_head_dim
    c, b, v, ca = chip_smoke._chunk_inputs(g, l, dk, dv, torch.bfloat16,
                                           device, seed=20)
    return (g, l, dk, dv), c, b, v, ca


def _chunk_local(device):
    from repro_torch.kernels import chunk_scan as cs

    (g, l, dk, dv), c, b, v, ca = _chunk_inputs(device)
    want_y, want_s = cs.chunk_local_reference(c, b, v, ca)

    def run(fn):
        y = torch.empty_like(v)
        s = torch.empty((g, dk, dv), device=device)
        err = fn(1, c.data_ptr(), b.data_ptr(), v.data_ptr(), ca.data_ptr(),
                 y.data_ptr(), s.data_ptr(), g, l, dk, dv,
                 torch.cuda.current_stream(device).cuda_stream)
        assert err == 0, err
        return y, s

    def check(out):
        chip_smoke._close_to(out[0], want_y, *chip_smoke.BF16_TOL, "variant")
        chip_smoke._close_to(out[1], want_s, *chip_smoke.STATE_TOL, "variant")

    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
    return run, check, argtypes


def _chunk_apply(device):
    from repro_torch.kernels import chunk_scan as cs

    (g, l, dk, dv), c, b, v, ca = _chunk_inputs(device)
    y_intra, _ = cs.chunk_local_reference(c, b, v, ca)
    gen = torch.Generator(device=device).manual_seed(21)
    s_prev = torch.randn((g, dk, dv), generator=gen, device=device)
    want = cs.chunk_apply_reference(c, ca, y_intra, s_prev)

    def run(fn):
        out = torch.empty_like(y_intra)
        err = fn(1, c.data_ptr(), ca.data_ptr(), y_intra.data_ptr(),
                 s_prev.data_ptr(), out.data_ptr(), g, l, dk, dv,
                 torch.cuda.current_stream(device).cuda_stream)
        assert err == 0, err
        return out

    def check(out):
        rtol, atol = chip_smoke.BF16_TOL
        chip_smoke._close_to(out, want, rtol, max(atol, 1e-4), "variant")

    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
    return run, check, argtypes


# Switches whose 0 drops part of a kernel's work: that variant's output is
# wrong by design and is not checked.
ABLATIONS = {"kGather", "kStore", "kReduce"}

KERNELS = {"warp_ncc": _warp_ncc, "flash_attention": _flash, "lookback_scan": _lookback,
           "fused_round": _fused_plan, "tile_apply": _tile_apply,
           "chunk_local": _chunk_local, "chunk_apply": _chunk_apply}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=list(KERNELS))
    ap.add_argument("name", help="the constexpr int to vary (fused_round: "
                                 "or C, the cluster size)")
    ap.add_argument("values", type=int, nargs="+")
    ap.add_argument("--n", type=int, default=None,
                    help="fused_round: the plan's rows (default ROUNDS_N)")
    ap.add_argument("--pairs", type=int, default=1,
                    help="warp_ncc: distinct frame pairs a replay runs one "
                         "launch on each (4: cold frames; default 1)")
    ap.add_argument("--d", type=int, default=1,
                    help="fused_round: the row width (default 1)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    calls = {}
    per = 1   # launches a replay (warp_ncc: one a frame pair)
    for value in args.values:
        if args.kernel == "fused_round" and args.name == "C":
            run, check, argtypes = _fused_plan(device, value, args.n, args.d)
            fn = getattr(_cuda.load("fused_round"), SOURCES["fused_round"][1])
        elif args.kernel == "fused_round":
            run, check, argtypes = _fused_plan(device, None, args.n, args.d)
            fn = _build(args.kernel, args.name, value)
        elif args.kernel == "warp_ncc":
            run, check, argtypes, per = _warp_ncc(device, args.pairs)
            fn = _build(args.kernel, args.name, value)
        else:
            run, check, argtypes = KERNELS[args.kernel](device)
            fn = _build(args.kernel, args.name, value)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        out = run(fn)
        torch.cuda.synchronize()
        if not (args.name in ABLATIONS and value == 0):
            check(out)
        calls[value] = (lambda run=run, fn=fn: run(fn))
    times = {value: [] for value in calls}
    for order in (list(calls), list(reversed(list(calls)))):
        for value in order:
            times[value].append(chip_smoke._graph_ms(calls[value]) / per)
    for value, ms in times.items():
        print(f"{args.kernel} {args.name}={value}: graph ms {ms}", flush=True)
    print(chip_smoke._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
