"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA device::

    python3 chip_smoke.py

It builds every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``
(into ``build/torch_kernels/``, one ``nvcc`` per source, all at once), holds
each kernel against its plain PyTorch version at the main path's shapes,
then drives the paths through the entry points a user calls, each with the
kernels' launch counts zeroed just before it and read just after:

* ``series`` / ``series_hier``: full-width 1920x1920 TEM series through
  ``repro_torch.register_series`` with the guess check on — cost-model
  dispatch, then the pinned two-level ``hierarchical`` backend (the
  ``warp_ncc`` kernel);
* ``series_compose``: ``register_series(refine=False)`` on 257 frames of
  1920x1920 in one chunk, so one feed composes 256 elements through the
  ``decoupled`` backend (the ``lookback_scan`` kernel);
* ``scan_engine``: ``repro_torch.core.engine.scan`` on card tensors by
  dispatch — ``decoupled`` add at n = 2^24 (plain, seeded, masked) and rigid
  composition of 4096 deformations (``lookback_scan``), ``hierarchical`` add
  at 2^24 and an element list's device phase 1 (``tile_local_scan`` +
  ``tile_apply``); and ``backend="pallas"``: rounds mode at n = 2^16
  (Ladner-Fischer plain and masked, Blelloch; the whole plan in one
  ``fused_plan`` launch on a thread-block cluster) and at 2^17 x 4 (too
  large for a cluster: one ``fused_round`` launch a non-empty round), and
  tiles mode at 2^24 (add over 16 tiles, max over 4096; one
  ``tile_local_scan`` and one ``tile_apply`` launch); and the same paths
  on bf16 rows (decoupled at 2^24, rounds at 2^16, tiles at 2^24) and
  the matmul entry (later @ earlier over 4,096 2 x 2 matrices, decoupled
  and rounds);
* ``serving``: a ``repro_torch.serving.RegistrationFrontend`` (round-robin,
  one dispatcher) whose sessions take the default device, with three
  tenants of 1920x1920 frames (an interactive refining one, a composing
  one on ``decoupled``, a second refining one) fed by
  ``loadgen.run_open_loop`` on a seeded Poisson schedule; each tenant's
  shifts are held against ``register_series`` of the same chunks
  (``warp_ncc`` and ``lookback_scan``);
* ``series_restore``: a session checkpointed after 17 of 33 frames in a
  cold subprocess opened with the compile cache directory, restored in a
  second one and extended, held to the uninterrupted session — refining,
  then composing;
* ``simulate``: ``engine.scan(backend="simulate")`` on 4,096 rigid
  deformations on the card against ``vector``, the backend with the
  paper's registration-like costs, and the host simulator's static and
  stealing makespans at 1,020 and 6,144 cores;
* ``collective``: ``core/distributed.py`` on a mesh of 8 positions of the
  card (``core/spmd.py``): ``collective_scan`` of every combine-only
  circuit, the Träff exscan (3 rounds), the 2x4 ("pod", "data")
  hierarchical scans and the blocked scan (both strategies, 1,024 rows a
  position, add and the affine pytree op), each bit-equal to exact
  prefixes;
* ``sharded``: ``engine.scan(backend="sharded")`` on meshes of 4 and 8
  positions of the card: add at 2^24 (plain, seeded, masked, stealing off,
  2^24 + 7 rows), rigid composition of 4,096 deformations and the affine
  pytree op, with phase-2 rounds against the simulator's, the claims and
  phase 3's ``lookback_scan`` launches (one a position).  One card's
  positions check values, launches and the protocol, not multi-device
  speed;
* ``lm_serve``: ``repro_torch.launch.serve.Server`` serving Zamba2-7B at full
  width and depth (81 layers, bf16, seeded random weights on the card) with
  the kernel backends passed in through ``acfg``: 4 requests (three 512-token
  prompts, one of 300 left-padded), 16 new tokens each; prefill launches
  ``chunk_local`` and ``chunk_apply`` 54 times each and ``flash_attention``
  27 times, decode none; the same prefill through the "xla" backends is
  compared as a finding;
* ``lm_serve <arch>``: the same traffic on codeqwen1.5-7b, internlm2-20b
  and qwen3-32b (``flash_attention`` at d = 128, 32, 48 and 64 launches a
  prefill) and xlstm-350m (``chunk_local`` and ``chunk_apply`` at
  dk = dv = 256, 18 each) at full width and depth, and qwen2-72b at full
  width and 16 of 80 layers (its cut listed under ``reduced``);
  phi3.5-moe-42b-a6.6b at 28 of 32 layers and arctic-480b at 2 of 35
  (``moe`` blocks: flash once a layer, the MoE einsums on cuBLAS);
  internvl2-1b behind 256 zero patches with text prompts of 256 (150)
  tokens (flash 24 a prefill); whisper-base on its registry's "xla"
  backends with 1500 zero frames and prompts of 4 tokens (no kernel: 1500
  frames fail the flash kernel's block check in both packages, the line
  says so); each line gives the init's seconds and peak memory (at most
  the weights plus 2 GB) and the serves' peak, each model freed before
  the next;
* ``lm_check``: Zamba2-7B at full width and 3 superblocks in float32, batch 2,
  prompt 512: logits through the kernels against the "xla" path, within 2e-2;
  ``lm_check xlstm-350m`` the same at full width and depth (the float32
  chunk kernels at d = 256); ``lm_check whisper-base`` at full width and
  depth with the encoder on 1,024 seeded frames (6 non-causal flash
  launches in the encoder, 6 causal in the decoder, counted apart);
* ``train xlstm-350m``: ``repro_torch.launch.train.train`` on xLSTM-350M at
  full width and depth (24 blocks, bf16): 16 steps of 8 x 256 tokens from
  the port's ``TokenPipeline`` at lr 3e-2, bf16 checkpoints every 8 steps,
  a failure injected at step 10 (one restart from step 8): every step's
  loss, the replayed steps' difference, step seconds and tokens/s, peak
  memory, the checkpoints' seconds and bytes, a profile of one step; gated
  on finite, falling losses, one restart and no kernel launch (training
  runs on the "xla" backends: the kernels have no backward);
* ``train phi3.5-moe-42b``: ``steps.make_train_step`` at full width and 2
  of 32 layers (``reduced``: AdamW's state outgrows the card), 4 steps of
  8 x 256: the MoE block's backward; step seconds, peak, grad norm, aux;
* ``train_check``: xLSTM-350M at full width and 4 layers in float32, three
  steps on the card against the same steps on the CPU (loss, grad norm,
  params);
* ``ssd_sharded``: ``ops.ssd_scan(axis_names=...)`` in ``spmd.shard_map``
  at full width: Zamba2-7B's Mamba2 scan (bf16, B 4, 112 heads, 64 x 64,
  L 2,048) over 4 positions of the card and over (2, 4) ("pod", "data"),
  xLSTM-350M's mLSTM scan (d 256) over 4; ``chunk_local`` and
  ``chunk_apply`` once a position a call, held to the unsharded scan and
  to the plain versions;
* ``compressed_psum``: xLSTM-350M's embedding gradient (50,432 x 1,024)
  summed in int8 over 8 positions, held to the exact float32 sum, every
  residual to y - dequantize(quantize(y)); int8 against float32 bytes;
* ``train_mesh xlstm-350m``: a gloo probe of 4 ranks sharing the card,
  then ``train(mesh_shape=(2, 2))`` at full width and depth, the train
  phase's first 4 steps with a checkpoint at step 2 and a failure at
  step 3, then a restore onto ``elastic.plan_rescale(4,
  model_parallel=1)``'s (4, 1) mesh and step 5; each loss within 2e-2 of
  the train phase's and each grad norm within 5e-2 of its, each rank's
  local bytes and peak, step seconds and the collectives staged through
  host memory.  One card's ranks check values, placements and the
  restore, not multi-device speed;
* ``train_mesh_check``: ``train_check``'s model (float32, 4 layers) on a
  (2, 2) mesh of ranks sharing the card against one device on the card,
  three steps at lr 0.1 (the params move ~3e-3) with AdamW's eps 1e-8
  and 1e-3: losses, grad norms and each leaf's first moment at
  ``train_check``'s bounds, and at eps 1e-3 the params too (at 1e-8 an
  element whose gradient is below float noise takes Adam's step with
  either sign; the line counts them);
* ``dryrun``: ``repro_torch.launch.dryrun`` in child processes (its fake
  process group never meets the ``train_mesh`` world): the cells
  xlstm-350m x train_4k (the sLSTM loop counted once) and qwen3-32b x
  decode_32k on the fake production 16 x 16 mesh, each with its
  seconds; the dry-run's one-device peak for the ``train xlstm-350m``
  phase's step beside the peak of one such step measured on the card and
  the peak that phase measured; and one (2, 2) step's
  predicted collectives by kind beside what ``train_mesh``'s rank 0
  staged a step.  The gaps are reported, not gated.

Output, one line each: ``env``, ``build``, ``kernel warp_ncc``,
``kernel ncc_grad`` (function A's step kernels at 8 x 1856 x 1920 and
8 x 928 x 960 against the twin, their bound and the autograd step),
``kernel lookback_scan``, ``kernel tile_local_scan``, ``kernel tile_apply``,
``kernel fused_round`` (the per-round kernel and the whole-plan
``fused_plan`` kernel), ``kernel chunk_local``, ``kernel chunk_apply``
(and each at the mLSTM's d = 256, ``kernel chunk_local d256``),
``kernel flash_attention`` (and at qwen3-32b's d = 128, ``kernel
flash_attention d128``, at InternVL2's d = 64, ``kernel flash_attention
d64``, and non-causal at Whisper's encoder shape, ``kernel
flash_attention d64 noncausal``, each beside SDPA; the scan kernels' lines
carry their bf16 add and matmul entries), ``redesign`` (the seven kernels redesigned for
Hopper, warp_ncc, flash_attention, lookback_scan, fused_round, tile_apply,
chunk_local and chunk_apply, beside their previous designs: times, the
library call's, the bound, the HGMMA count of flash_attention's and
chunk_scan's SASS and lookback_scan's longest walk),
``series``, ``series_hier``, ``series_compose``,
``scan_engine``, ``serving``, ``series_restore``, ``simulate``,
``collective``, ``sharded``, ``lm_serve`` (and one a configuration),
``lm_check`` (and ``lm_check xlstm-350m``, ``lm_check whisper-base``),
``train xlstm-350m``, ``train phi3.5-moe-42b``, ``train_check``,
``ssd_sharded``, ``compressed_psum``, ``train_mesh xlstm-350m``,
``train_mesh_check``, ``dryrun``, ``kernels`` (JSON), the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.  Any
failed phase raises and the script exits non-zero; without a CUDA device it
exits 2 and prints no result.

``--cpu-rehearsal`` runs the series, compose, engine, serving, restore,
simulate, collective, sharded, LM, training, LM multi-device and dry-run
phases on the CPU at small sizes (the LM and training phases on each
configuration's smoke config, the mesh on gloo CPU ranks, the dry-run's
cells on a fake (2, 2) world) with the kernels' plain versions, to rehearse the script's flow without a card; it skips the
kernel phases and exits 3 without a result line.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Card peaks for the bounds (NVIDIA H100 SXM data sheet, at its 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12   # dense tensor-core rate
FULL_POWER_W = 700.0

SIZE = 1920
NOISE = 0.15
# The guess check's threshold on 1 - NCC.  The CPU rehearsal at 384 and 768
# px (noise 0.15) measured composed-guess distances of 0.019-0.029 against
# refined distances of 0.018-0.028; 0.02 skips the guesses that sit at the
# noise floor and refines the rest.
SKIP_TOL = 0.02
# Warp-check tolerances of the reference's own kernel test
# (tests/test_kernels.py::test_warp_ncc_kernel).
WARP_RTOL = WARP_ATOL = 1e-4
NCC_ATOL = 1e-5
SHIFT_ERR_MAX = 0.35  # tests/test_hierarchical.py::test_register_series_smoke
# The scan kernels' shapes: add over 2^24 float32 rows of width 1 (integer
# valued in [-2, 2], so every prefix is exact and kernel and plain version
# must agree bit for bit), and the paper's series length of deformations.
SCAN_N = 1 << 24
SERIES_LEN = 4096
TILE_COUNTS = (16, 128)   # the engine's segment count, and a larger one
# The pallas backend's rounds mode: the paper's circuits as plan rounds at
# n = 2^16 (host plan compilation grows with n: 0.2-1.8 s a plan here), one
# fused_round launch a round; its tiles mode at SCAN_N over these counts.
ROUNDS_N = 1 << 16
ROUND_CIRCUITS = ("sklansky", "brent_kung", "ladner_fischer",
                  "dissemination", "blelloch")
PALLAS_TILES = (16, 4096)
# Rigid composition: rtol 1e-5, and an absolute tolerance of a few float32
# ulps of the largest composed shift (tests/test_torch_gpu.py::_rigid_tol).
RIGID_RTOL = 1e-5


_START = time.perf_counter()


def _line(tag: str, payload) -> None:
    print(f"{tag} {json.dumps(payload, sort_keys=False)}", flush=True)
    # Where the run's time goes, on stderr.
    print(f"chip_smoke: {tag} done at {time.perf_counter() - _START:.1f} s",
          file=sys.stderr, flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _power_limit_w(smi: str) -> float:
    """The limit in watts, NaN when nvidia-smi reports none."""
    try:
        return float(smi.split(",")[-1].strip().split()[0])
    except (ValueError, IndexError):
        return float("nan")


def _time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int = 20) -> float:
    """Device time of ``fn``'s launches, replayed from a CUDA graph: no
    host work between launches, so a host-bound sequence of small kernels
    shows what the card itself spends on it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _time_ms(graph.replay, reps=reps)


def check_warp_ncc(device, power_w: float) -> dict:
    """The warp_ncc kernel against its plain version on the card, at the
    main path's frame size, both tiles and four (angle, shift) cases."""
    from repro_torch.data.images import lattice_image
    from repro_torch.kernels import warp_ncc as wn

    img = lattice_image(SIZE, seed=0, device=device)
    ref = lattice_image(SIZE, seed=1, device=device)
    cases = [
        (0.0, (3.0, -2.0)),
        (0.07, (1.5, 0.7)),
        (-0.1, (-4.0, 2.5)),
        # Clamps heavily: most samples fall past the border, part of the
        # frame stays in view (a frame clamped whole has NCC 0/0).
        (0.6, (0.36 * SIZE, -0.47 * SIZE)),
    ]
    err_w = err_n = err_s = 0.0
    for tile in (32, 16):
        for ang, shift in cases:
            a = torch.tensor(ang, device=device)
            s = torch.tensor(shift, device=device)
            w_k, s_k = wn.warp_ncc_sums_cuda(img, ref, a, s, tile=tile)
            w_2, n_k = wn.warp_ncc(img, ref, a, s, tile=tile)
            w_p, s_p = wn.warp_ncc_sums_reference(img, ref, a, s, tile=tile)
            torch.cuda.synchronize()
            what = f"warp_ncc (tile {tile}, case {ang}, {shift})"
            bad = (w_k - w_p).abs() > WARP_ATOL + WARP_RTOL * w_p.abs()
            if bool(bad.any()):
                raise AssertionError(f"{what}: warped image disagrees in "
                                     f"{int(bad.sum())} pixels")
            if not torch.equal(w_k, w_2):
                raise AssertionError(f"{what}: two launches differ")
            if not (bool((s_k[:, 5] == tile * tile).all())
                    and not bool(s_k[:, 6:].any())):
                raise AssertionError(f"{what}: area or zero columns wrong")
            want = wn.fold(s_p)
            dn = max(float((wn.fold(s_k) - want).abs()),
                     float((n_k - want).abs()))
            if not dn <= NCC_ATOL:
                raise AssertionError(f"{what}: ncc (card fold and host "
                                     f"fold of its sums) off by {dn}")
            err_w = max(err_w, float((w_k - w_p).abs().max()))
            err_n = max(err_n, dn)
            err_s = max(err_s, float(((s_k - s_p).abs()
                                      / (s_p.abs() + 1.0)).max()))
    a = torch.tensor(0.07, device=device)
    s = torch.tensor((1.5, 0.7), device=device)
    ms = _time_ms(lambda: wn.warp_ncc_sums_cuda(img, ref, a, s, tile=32))
    graph_ms = _graph_ms(lambda: wn.warp_ncc_sums_cuda(img, ref, a, s,
                                                       tile=32))
    # With the fold on the card: the guess check's two launches.
    fold_graph_ms = _graph_ms(lambda: wn.warp_ncc(img, ref, a, s, tile=32))
    check = _guess_check(ref, img, {"angle": a, "shift": s})
    plain_ms = _time_ms(
        lambda: wn.warp_ncc_sums_reference(img, ref, a, s, tile=32), reps=10
    )
    n_tiles = (SIZE // 32) ** 2
    nbytes = 3 * SIZE * SIZE * 4 + n_tiles * 8 * 4 + 3 * 4
    flops = 30 * SIZE * SIZE  # coordinates, clamp, blend and the five sums
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    return {
        "name": wn.NAME, "route": "cuda", "source": wn.SOURCE,
        "replaces": wn.REPLACES,
        "shape": [SIZE, SIZE], "tile": 32, "cases": len(cases) * 2,
        "max_abs_err": err_w, "max_abs_err_ncc": err_n,
        "max_rel_err_sums": err_s,
        "ms": ms, "graph_ms": graph_ms,
        "graph_ms_with_fold": fold_graph_ms, "plain_ms": plain_ms,
        "guess_check": check,
        "timing": "ms: warp_ncc_sums_cuda back to back (CUDA events, "
                  "wrapper included); graph_ms: the same replayed from a "
                  "CUDA graph (the kernel's device time); "
                  "graph_ms_with_fold: warp_ncc, kernel and fold",
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_ms_at_power_limit": max(bytes_ms, ops_ms)
        * FULL_POWER_W / min(power_w, FULL_POWER_W),
        "library_ms": None,
    }


#: Function A's batch on the main path (``service.PAIR_SUB_BATCH``) and the
#: benchmark's frame, with its coarse pyramid level.
NCC_GRAD_SHAPES = ((8, 1856, 1920), (8, 928, 960))


def check_ncc_grad(device, power_w: float) -> dict:
    """Function A's step kernels (``ncc_grad``: the sums pass and the
    fold/update) at the main path's shapes: one sums pass against the plain
    twin, then the pair's time alone (CUDA events over back-to-back launch
    pairs, and replayed from a CUDA graph), a step as the descent runs it
    (the pair and the host's ``bool(more)``), the twin's, and the
    autograd step it replaces (``_minimize_level_plain``'s body), the
    kernel and the autograd step timed in turns."""
    from repro_torch.core.deformation import ncc_distance
    from repro_torch.data.images import make_series
    from repro_torch.kernels import ncc_grad as ng

    rows = {}
    for b, h, w in NCC_GRAD_SHAPES:
        frames, _ = make_series(21, b + 1, size=max(h, w), noise=NOISE,
                                device=device)
        f = frames[:, :h, :w].contiguous()
        del frames
        ref, tmpl = f[:-1].contiguous(), f[1:].contiguous()
        del f
        angle = torch.linspace(-0.002, 0.002, b, device=device)
        shift = torch.linspace(-3.0, 3.0, 2 * b, device=device).view(b, 2)
        loss, grad, _ = ng.ncc_grad_cuda(ref, tmpl, angle, shift)
        want_loss, want_grad = ng.ncc_grad_reference(ref, tmpl, angle, shift)
        scale = want_grad.abs().amax(dim=0, keepdim=True)
        err_loss = float((loss - want_loss).abs().max())
        err_grad = float(((grad - want_grad).abs() / scale).max())
        if not (err_loss <= 1e-6 and err_grad <= 1e-5):
            raise AssertionError(f"ncc_grad {b}x{h}x{w}: loss off by "
                                 f"{err_loss}, gradient by {err_grad} of "
                                 "its scale")
        # A descent that never stops (tol < 0) and barely moves.
        desc = ng.Descent(ref, tmpl, angle, shift, lr_angle=1e-12,
                          lr_shift=1e-9, tol=-1.0, max_iters=2**30)
        desc.start()
        fn, _ = ng._launcher()

        def pair():
            fn(ref.data_ptr(), tmpl.data_ptr(), desc._f.data_ptr(),
               desc._scratch.data_ptr(), b, h, w, 1e-12, 1e-9, -1.0, 2**30,
               0, torch.cuda.current_stream(device).cuda_stream)

        leaves = {"angle": angle.clone().requires_grad_(True),
                  "shift": shift.clone().requires_grad_(True)}

        def autograd_step():
            with torch.enable_grad():
                loss_g = ncc_distance(ref, tmpl, leaves)
                torch.autograd.grad(loss_g.sum(), [leaves["angle"],
                                                   leaves["shift"]])
                bool((loss_g.detach() > 2.0).any())

        turns = {"ms": [], "autograd_step_ms": []}
        for _ in range(2):
            turns["ms"].append(_time_ms(pair))
            turns["autograd_step_ms"].append(_time_ms(autograd_step,
                                                      reps=10, warmup=2))
        graph_ms = _graph_ms(pair)
        t0 = time.perf_counter()
        for _ in range(50):
            desc.step()
        step_ms = (time.perf_counter() - t0) * 1e3 / 50
        plain_ms = _time_ms(
            lambda: ng.ncc_grad_reference(ref, tmpl, angle, shift), reps=5,
            warmup=1)
        nbytes = 2 * b * h * w * 4
        flops = 70 * b * h * w   # coordinates, taps, blend, gradients, sums
        bound = _bound(nbytes, flops)
        rows[f"{b}x{h}x{w}"] = {
            "max_abs_err_loss": err_loss, "max_rel_err_grad": err_grad,
            "ms": min(turns["ms"]), "graph_ms": graph_ms,
            "step_ms": step_ms, "plain_ms": plain_ms,
            "autograd_step_ms": min(turns["autograd_step_ms"]),
            "turns": turns, **bound,
            "bound_ms_at_power_limit": bound["bound_ms"] * FULL_POWER_W
            / min(power_w, FULL_POWER_W),
            "roofline_pct": 100.0 * bound["bound_ms"] / graph_ms,
        }
        del desc, ref, tmpl
    main = rows["8x1856x1920"]
    return {
        "name": ng.NAME, "route": "cuda", "source": ng.SOURCE,
        "replaces": None, "shape": list(NCC_GRAD_SHAPES[0]),
        "max_abs_err": main["max_abs_err_loss"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "shapes": rows,
        "timing": "ms: the sums and step kernels' launch pair through the C "
                  "entry back to back (CUDA events); graph_ms: the same "
                  "replayed from a CUDA graph; step_ms: Descent.step on the "
                  "host clock (the pair and the bool(more) sync); "
                  "autograd_step_ms: the plain route's step (loss with its "
                  "graph, autograd.grad, the stopping test's sync) in turns "
                  "with ms; plain_ms: the twin (float64 sums)",
    }


def _guess_check(ref, tmpl, d, reps: int = 50) -> dict:
    """One guess check of the registration operator as the series path
    makes it (``fused_ncc_distance``, then ``float()``, which syncs): its
    wall ms on the host clock, and the kernels and copies it puts on the
    card a check, counted by ``torch.profiler`` over ``reps`` checks."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.registration import fused_ncc_distance

    def one():
        return float(fused_ncc_distance(ref, tmpl, d))

    for _ in range(5):
        one()
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            one()
    kernels = copies = launch_calls = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            launch_calls += 1
    return {"wall_ms": wall_ms, "kernels_per_check": kernels / reps,
            "launch_calls_per_check": launch_calls / reps,
            "copies_per_check": copies / reps, "reps": reps,
            "timing": f"host clock over {reps} checks after 5 warm-ups; "
                      "kernels and copies: torch.profiler device events, "
                      "launch calls: its cudaLaunchKernel runtime events"}


def _bound(nbytes: float, ops: float, peak_ops: float = PEAK_F32_FLOPS) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the operands' peak rate (f32 unless given), whichever
    is larger."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / peak_ops * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _ints(n: int, d: int, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(-2, 3, (n, d), generator=g).float().to(device)


def _floats(n: int, d: int, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn((n, d), generator=g).to(device)


def _masked_cumsum(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The engine's masked inclusive sum of integer-valued x: invalid rows
    are the identity; rows before the first valid one pass through."""
    out = torch.cumsum(torch.where(valid, x, 0.0).double(), 0).float()
    first = int(valid.nonzero()[0])
    out[:first] = x[:first]
    return out


def _deformations(n: int, device, seed: int) -> dict:
    """Deformations of a drifting series (angles ~0.01 rad, shifts ~0.25 px
    a step), made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return {
        "angle": torch.tensor(rng.normal(size=n) * 0.01, dtype=torch.float32,
                              device=device),
        "shift": torch.tensor(rng.normal(size=(n, 2)) * 0.25,
                              dtype=torch.float32, device=device),
    }


def _chain64(angle, shift):
    """Composed prefixes of (angle, shift) elements in float64, one
    composition at a time (compose_batched's function)."""
    a = angle.double().cpu().numpy().reshape(-1)
    s = shift.double().cpu().numpy().reshape(-1, 2)
    out_a, out_s = np.empty_like(a), np.empty_like(s)
    acc_a, acc_s = a[0], s[0].copy()
    out_a[0], out_s[0] = acc_a, acc_s
    for i in range(1, len(a)):
        c, sn = np.cos(a[i]), np.sin(a[i])
        acc_s = np.array([c * acc_s[0] - sn * acc_s[1],
                          sn * acc_s[0] + c * acc_s[1]]) + s[i]
        acc_a = acc_a + a[i]
        out_a[i], out_s[i] = acc_a, acc_s
    return out_a, out_s


def _rigid_atol(shift64) -> float:
    return max(1e-5, 1e-6 * float(np.abs(shift64).max()))


def _check_vs_chain64(angle, shift, a64, s64, what: str) -> dict:
    """Max errors of composed (angle, shift) against the float64 chain;
    raises past rtol 1e-5 / the shift-scaled atol."""
    atol = _rigid_atol(s64)
    ga = angle.double().cpu().numpy().reshape(-1)
    gs = shift.double().cpu().numpy().reshape(-1, 2)
    ea, es = np.abs(ga - a64), np.abs(gs - s64)
    if not ((ea <= atol + RIGID_RTOL * np.abs(a64)).all()
            and (es <= atol + RIGID_RTOL * np.abs(s64)).all()):
        raise AssertionError(
            f"{what}: composition disagrees with the float64 chain "
            f"(angle {ea.max():.3e}, shift {es.max():.3e}, atol {atol:.3e})"
        )
    return {"max_err_angle_vs_f64": float(ea.max()),
            "max_err_shift_vs_f64": float(es.max()),
            "max_abs_shift": float(np.abs(s64).max()), "atol": atol}


def _require_equal(got, want, what: str) -> float:
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or err != 0.0:
        raise AssertionError(
            f"{what}: kernel and plain version disagree "
            f"(shapes {tuple(got.shape)} {tuple(want.shape)}, err {err})"
        )
    return err


def check_lookback_scan(device) -> dict:
    """The lookback_scan kernel against its plain version: add at
    n = 2^24 (the card's tile count; unseeded, seeded, masked), exact; and
    rigid composition of 4096 deformations, to tolerance."""
    from repro_torch.core.deformation import compose_batched
    from repro_torch.kernels import lookback_scan as lb
    from repro_torch.kernels._tiling import (
        default_num_tiles_cuda, lift_masked, pack_leaves, packed_op,
    )

    n, d = SCAN_N, 1
    t = default_num_tiles_cuda(n)
    x = _ints(n, d, device, seed=1)
    seed = torch.tensor([2.0], device=device)
    steps = torch.zeros((t,), dtype=torch.int32, device=device)
    err = 0.0
    for sd in (None, seed):
        got = lb.lookback_scan_cuda(torch.add, x, t, seed=sd,
                                    walk_steps=steps)
        want = lb.lookback_scan_reference(torch.add, x, t, seed=sd)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("y", "status", "aggs", "prefs")):
            err = max(err, _require_equal(g, w, f"lookback_scan {what}"))
        if not bool((got[1] == lb.FLAG_PREFIX).all()):
            raise AssertionError("lookback_scan: a tile did not publish PREFIX")
    walk = steps[1:].float()
    valid = (torch.arange(n, device=device) % 5) != 2
    valid[:3] = False
    xm = torch.cat([x, (~valid).float()[:, None]], dim=1)
    mop = lift_masked(torch.add)
    got = lb.lookback_scan_cuda(mop, xm, t)[0]
    want = lb.lookback_scan_reference(mop, xm, t)[0]
    err = max(err, _require_equal(got, want, "lookback_scan masked"))

    ms = _time_ms(lambda: lb.lookback_scan_cuda(torch.add, x, t))
    plain_ms = _time_ms(lambda: lb.lookback_scan_reference(torch.add, x, t),
                        reps=3, warmup=1)
    library_ms = _time_ms(lambda: torch.cumsum(x, 0))
    nbytes = 2 * n * d * 4 + t * (2 * d * 4 + 4)

    # max over random floats, exact against the plain version and cummax.
    xf = _floats(n, d, device, seed=10)
    got = lb.lookback_scan_cuda(torch.maximum, xf, t)
    want = lb.lookback_scan_reference(torch.maximum, xf, t)
    torch.cuda.synchronize()
    err_max = max(_require_equal(g, w, f"lookback_scan max {what}")
                  for g, w, what in zip(got, want, ("y", "status", "aggs",
                                                    "prefs")))
    _require_equal(got[0], torch.cummax(xf, 0).values, "lookback_scan max "
                   "vs torch.cummax")
    max_row = {"max_abs_err": err_max,
               "ms": _time_ms(lambda: lb.lookback_scan_cuda(torch.maximum,
                                                            xf, t)),
               "library_ms": _time_ms(lambda: torch.cummax(xf, 0)),
               "library_call": "torch.cummax(x, 0)"}

    # Rigid composition at the paper's series length, one tile and many.
    dfm = _deformations(SERIES_LEN, device, seed=2)
    x2, spec = pack_leaves(dfm)
    pop = packed_op(compose_batched, spec)
    a64, s64 = _chain64(dfm["angle"], dfm["shift"])
    rigid = {"n": SERIES_LEN}
    for tiles in (default_num_tiles_cuda(SERIES_LEN), 64):
        yk = lb.lookback_scan_cuda(pop, x2, tiles)[0]
        yp = lb.lookback_scan_reference(pop, x2, tiles)[0]
        torch.cuda.synchronize()
        atol = _rigid_atol(s64)
        if not torch.allclose(yk, yp, rtol=RIGID_RTOL, atol=atol):
            raise AssertionError(f"lookback_scan rigid ({tiles} tiles): "
                                 "kernel and plain version disagree")
        rigid[f"tiles_{tiles}"] = {
            "max_abs_err_vs_plain": float((yk - yp).abs().max()),
            **_check_vs_chain64(yk[:, 0], yk[:, 1:], a64, s64,
                                f"lookback_scan rigid ({tiles} tiles)"),
        }
    t1 = default_num_tiles_cuda(SERIES_LEN)
    rigid["ms"] = _time_ms(lambda: lb.lookback_scan_cuda(pop, x2, t1))
    rigid["plain_ms"] = _time_ms(
        lambda: lb.lookback_scan_reference(pop, x2, t1), reps=10)
    rigid.update(_bound(2 * SERIES_LEN * 3 * 4, SERIES_LEN * 50))
    rigid["library_ms"] = None
    return {
        "name": lb.NAME, "route": "cuda", "source": lb.SOURCE,
        "replaces": lb.REPLACES, "shape": [n, d], "tiles": t,
        "op": "add", "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, **_bound(nbytes, n * d),
        "library_ms": library_ms, "library_call": "torch.cumsum(x, 0)",
        "walk_steps_max": int(walk.max()), "walk_steps_mean": float(walk.mean()),
        "rigid_compose": rigid, "max": max_row,
    }


MATMUL_N = 4096              # the matmul entry's rows (the series length)
MATMUL_TOL = 1e-4            # kernel vs plain: float32 sums in other orders


def check_scan_entries(device) -> dict:
    """The scan kernels' bfloat16 add entry and matmul entry against their
    plain versions: bf16 add at 2^24 x 1 through lookback_scan and the tile
    kernels, and at 2^16 x 1 through fused_round (every round of a
    Ladner-Fischer plan) and fused_plan, exact (telescoping integer rows);
    later @ earlier over 4,096 orthogonal 2 x 2 and 4 x 4 float32 matrices
    through each, to MATMUL_TOL.  Times beside torch.cumsum on the same
    bf16 tensor (no library call scans matrices) and the bound.  Returns
    {kernel name: {"bf16_add": ..., "matmul_2x2": ..., "matmul_4x4": ...}}."""
    from repro_torch.core.engine import get_plan
    from repro_torch.core.engine.pallas_backend import (
        _plan_operands, _round_index_tensors,
    )
    from repro_torch.data.scan_rows import (
        matmul_compose, orthogonal_matrices, telescoping_bf16,
    )
    from repro_torch.kernels import lookback_scan as lb
    from repro_torch.kernels import tile_scan as ts
    from repro_torch.kernels._tiling import (
        default_num_tiles_cuda, plan_cluster_size,
    )

    out = {name: {} for name in ("lookback_scan", "tile_local_scan",
                                 "tile_apply", "fused_round", "fused_plan")}
    tiles = TILE_COUNTS[0]

    def rounds(fn, op, x, live):
        for src in live:
            x = fn(op, x, src)
        return x

    def entry(n, d, esize, ops, err, call, plain, library=None, **extra):
        row = {"shape": [n, d], "max_abs_err": err, "ms": _time_ms(call),
               "plain_ms": _time_ms(plain, reps=3, warmup=1),
               "library_ms": None if library is None else _time_ms(library),
               **_bound(2 * n * d * esize, ops), **extra}
        if library is not None:
            row["library_call"] = "torch.cumsum(x, 0) on the bf16 rows"
        return row

    # bf16 add: lookback_scan and the tile kernels at 2^24 x 1.
    n = SCAN_N
    x, exact = telescoping_bf16(n, 1, 30, device=device)
    t = default_num_tiles_cuda(n)
    yk = lb.lookback_scan_cuda(torch.add, x, t)[0]
    yp = lb.lookback_scan_reference(torch.add, x, t)[0]
    err = max(_require_equal(yk, yp, "lookback_scan bf16"),
              _require_equal(yk, exact, "lookback_scan bf16 vs exact"))
    cumsum = lambda: torch.cumsum(x, 0)   # noqa: E731
    out["lookback_scan"]["bf16_add"] = entry(
        n, 1, 2, n, err, lambda: lb.lookback_scan_cuda(torch.add, x, t),
        lambda: lb.lookback_scan_reference(torch.add, x, t), cumsum, tiles=t)
    loc, parts = ts.tile_local_scan_cuda(torch.add, x, tiles)
    ploc, pparts = ts.tile_local_scan_reference(torch.add, x, tiles)
    err = max(_require_equal(loc, ploc, "tile_local_scan bf16"),
              _require_equal(parts, pparts, "tile partials bf16"))
    out["tile_local_scan"]["bf16_add"] = entry(
        n, 1, 2, n, err, lambda: ts.tile_local_scan_cuda(torch.add, x, tiles),
        lambda: ts.tile_local_scan_reference(torch.add, x, tiles), cumsum,
        tiles=tiles)
    seeds = torch.cat([pparts[:1], torch.cumsum(pparts.float(), 0)[:-1]
                       .to(torch.bfloat16)])
    yk = ts.tile_apply_cuda(torch.add, ploc, seeds)
    yp = ts.tile_apply_reference(torch.add, ploc, seeds)
    err = max(_require_equal(yk, yp, "tile_apply bf16"),
              _require_equal(yk, exact.view(-1, 1), "tile kernels bf16 vs "
                             "exact"))
    out["tile_apply"]["bf16_add"] = entry(
        n, 1, 2, n, err, lambda: ts.tile_apply_cuda(torch.add, ploc, seeds),
        lambda: ts.tile_apply_reference(torch.add, ploc, seeds), cumsum,
        tiles=tiles)
    del loc, parts, ploc, pparts, yk, yp

    # bf16 add: fused_round and fused_plan at 2^16 x 1 (Ladner-Fischer).
    n = ROUNDS_N
    xr, exact_r = telescoping_bf16(n, 1, 31, device=device)
    plan = get_plan("ladner_fischer", n)
    live = [s for s in _round_index_tensors(plan, device) if s is not None]
    po = _plan_operands(plan, device, plan_cluster_size(n, 1))
    yk = rounds(ts.fused_round_cuda, torch.add, xr, live)
    yp = rounds(ts.fused_round_reference, torch.add, xr, live)
    err = max(_require_equal(yk, yp, "fused_round bf16"),
              _require_equal(yk, exact_r, "fused_round bf16 vs exact"))
    cumsum_r = lambda: torch.cumsum(xr, 0)   # noqa: E731
    out["fused_round"]["bf16_add"] = entry(
        n, 1, 2, plan.work(), err,
        lambda: rounds(ts.fused_round_cuda, torch.add, xr, live),
        lambda: rounds(ts.fused_round_reference, torch.add, xr, live),
        cumsum_r, rounds=len(live))
    yk, _ = ts.fused_plan_cuda(torch.add, xr, po)
    yp, _ = ts.fused_plan_reference(torch.add, xr, po)
    err = max(_require_equal(yk, yp, "fused_plan bf16"),
              _require_equal(yk, exact_r, "fused_plan bf16 vs exact"))
    out["fused_plan"]["bf16_add"] = entry(
        n, 1, 2, plan.work(), err,
        lambda: ts.fused_plan_cuda(torch.add, xr, po),
        lambda: ts.fused_plan_reference(torch.add, xr, po), cumsum_r,
        cluster=po.cluster)

    # matmul: 2 x 2 and 4 x 4 float32 matrices, 4,096 of them.
    op = matmul_compose
    n = MATMUL_N
    plan = get_plan("ladner_fischer", n)
    live = [s for s in _round_index_tensors(plan, device) if s is not None]
    for m in (2, 4):
        d = m * m
        x2 = orthogonal_matrices(n, m, 32 + m, device=device).reshape(n, d)
        ops = 2 * m ** 3         # multiplies and adds of one product
        want = lb.lookback_scan_reference(op, x2.double(), 1)[0]

        def held(got, what, want=want):
            err = float((got.double() - want).abs().max())
            if not err <= MATMUL_TOL:
                raise AssertionError(f"{what} matmul {m}x{m}: error {err} "
                                     "against the float64 chain")
            return err

        tag = f"matmul_{m}x{m}"
        t = default_num_tiles_cuda(n)
        yk = lb.lookback_scan_cuda(op, x2, t)[0]
        yp = lb.lookback_scan_reference(op, x2, t)[0]
        err = max(held(yk, "lookback_scan"), float((yk - yp).abs().max()))
        out["lookback_scan"][tag] = entry(
            n, d, 4, n * ops, err, lambda: lb.lookback_scan_cuda(op, x2, t),
            lambda: lb.lookback_scan_reference(op, x2, t), tiles=t,
            max_abs_err_vs_float64=held(yk, "lookback_scan"))
        loc, parts = ts.tile_local_scan_cuda(op, x2, tiles)
        ploc, pparts = ts.tile_local_scan_reference(op, x2, tiles)
        err = float((loc - ploc).abs().max())
        if not err <= MATMUL_TOL:
            raise AssertionError(f"tile_local_scan {tag}: error {err}")
        out["tile_local_scan"][tag] = entry(
            n, d, 4, n * ops, err,
            lambda: ts.tile_local_scan_cuda(op, x2, tiles),
            lambda: ts.tile_local_scan_reference(op, x2, tiles), tiles=tiles)
        gscan = lb.lookback_scan_reference(op, pparts, 1)[0]
        seeds = torch.cat([pparts[:1], gscan[:-1]])
        yk = ts.tile_apply_cuda(op, ploc, seeds)
        yp = ts.tile_apply_reference(op, ploc, seeds)
        err = max(float((yk - yp).abs().max()), held(yk, "tile kernels"))
        out["tile_apply"][tag] = entry(
            n, d, 4, n * ops, err, lambda: ts.tile_apply_cuda(op, ploc, seeds),
            lambda: ts.tile_apply_reference(op, ploc, seeds), tiles=tiles)
        yk = rounds(ts.fused_round_cuda, op, x2, live)
        yp = rounds(ts.fused_round_reference, op, x2, live)
        err = max(float((yk - yp).abs().max()), held(yk, "fused_round"))
        out["fused_round"][tag] = entry(
            n, d, 4, plan.work() * ops, err,
            lambda: rounds(ts.fused_round_cuda, op, x2, live),
            lambda: rounds(ts.fused_round_reference, op, x2, live),
            rounds=len(live))
        po = _plan_operands(plan, device, plan_cluster_size(n, d))
        yk, _ = ts.fused_plan_cuda(op, x2, po)
        yp, _ = ts.fused_plan_reference(op, x2, po)
        err = max(float((yk - yp).abs().max()), held(yk, "fused_plan"))
        out["fused_plan"][tag] = entry(
            n, d, 4, plan.work() * ops, err,
            lambda: ts.fused_plan_cuda(op, x2, po),
            lambda: ts.fused_plan_reference(op, x2, po), cluster=po.cluster)
    torch.cuda.synchronize()
    return out


def check_tile_kernels(device) -> tuple:
    """tile_local_scan and tile_apply against their plain versions: add at
    n = 2^24 over the card's tile count, 16 and 128 tiles (exact), and rigid
    composition of 4096 deformations over 16 tiles (to tolerance)."""
    from repro_torch.core.deformation import compose_batched
    from repro_torch.kernels import tile_scan as ts
    from repro_torch.kernels._tiling import (
        default_num_tiles_cuda, pack_leaves, packed_op,
    )

    n, d = SCAN_N, 1
    x = _ints(n, d, device, seed=3)
    local_rows, apply_rows = {}, {}
    err_l = err_a = 0.0
    for t in (default_num_tiles_cuda(n), *TILE_COUNTS):
        k = n // t
        loc, parts = ts.tile_local_scan_cuda(torch.add, x, t)
        ploc, pparts = ts.tile_local_scan_reference(torch.add, x, t)
        seeds = torch.cat([pparts[:1], torch.cumsum(pparts, 0)[:-1]])
        out = ts.tile_apply_cuda(torch.add, ploc, seeds)
        pout = ts.tile_apply_reference(torch.add, ploc, seeds)
        torch.cuda.synchronize()
        err_l = max(err_l, _require_equal(loc, ploc, f"tile_local_scan T={t}"),
                    _require_equal(parts, pparts, f"tile partials T={t}"))
        err_a = max(err_a, _require_equal(out, pout, f"tile_apply T={t}"))
        view = x.view(t, k, d)
        local_rows[t] = {
            "ms": _time_ms(lambda: ts.tile_local_scan_cuda(torch.add, x, t)),
            "plain_ms": _time_ms(
                lambda: ts.tile_local_scan_reference(torch.add, x, t),
                reps=5, warmup=1),
            "library_ms": _time_ms(lambda: torch.cumsum(view, 1)),
            **_bound(2 * n * d * 4 + t * d * 4, n * d),
        }
        apply_rows[t] = {
            "ms": _time_ms(lambda: ts.tile_apply_cuda(torch.add, ploc, seeds)),
            "plain_ms": _time_ms(
                lambda: ts.tile_apply_reference(torch.add, ploc, seeds),
                reps=10),
            "library_ms": _time_ms(lambda: ploc + seeds[:, None]),
            **_bound(2 * n * d * 4 + t * d * 4, n * d),
        }

    dfm = _deformations(SERIES_LEN, device, seed=4)
    x2, spec = pack_leaves(dfm)
    pop = packed_op(compose_batched, spec)
    _a64, s64 = _chain64(dfm["angle"], dfm["shift"])
    atol = _rigid_atol(s64)
    loc, parts = ts.tile_local_scan_cuda(pop, x2, 16)
    ploc, pparts = ts.tile_local_scan_reference(pop, x2, 16)
    seeds = torch.cat([pparts[:1], pparts[:-1]])
    out = ts.tile_apply_cuda(pop, ploc, seeds)
    pout = ts.tile_apply_reference(pop, ploc, seeds)
    torch.cuda.synchronize()
    for got, want, what in ((loc, ploc, "tile_local_scan"),
                            (out, pout, "tile_apply")):
        if not torch.allclose(got, want, rtol=RIGID_RTOL, atol=atol):
            raise AssertionError(f"{what} rigid: kernel and plain disagree")
    rigid_l = {"n": SERIES_LEN, "tiles": 16, "atol": atol,
               "max_abs_err_vs_plain": float((loc - ploc).abs().max()),
               "ms": _time_ms(lambda: ts.tile_local_scan_cuda(pop, x2, 16)),
               "plain_ms": _time_ms(
                   lambda: ts.tile_local_scan_reference(pop, x2, 16), reps=10),
               "library_ms": None}
    rigid_a = {"n": SERIES_LEN, "tiles": 16, "atol": atol,
               "max_abs_err_vs_plain": float((out - pout).abs().max()),
               "ms": _time_ms(lambda: ts.tile_apply_cuda(pop, ploc, seeds)),
               "plain_ms": _time_ms(
                   lambda: ts.tile_apply_reference(pop, ploc, seeds), reps=10),
               "library_ms": None}

    main_t = TILE_COUNTS[0]
    # max over random floats at the engine's segment count, exact.
    xf = _floats(n, d, device, seed=11)
    loc, parts = ts.tile_local_scan_cuda(torch.maximum, xf, main_t)
    ploc, pparts = ts.tile_local_scan_reference(torch.maximum, xf, main_t)
    seeds_m = torch.cat([pparts[:1], torch.cummax(pparts, 0).values[:-1]])
    out = ts.tile_apply_cuda(torch.maximum, ploc, seeds_m)
    pout = ts.tile_apply_reference(torch.maximum, ploc, seeds_m)
    torch.cuda.synchronize()
    max_l = {"tiles": main_t,
             "max_abs_err": max(_require_equal(loc, ploc, "tile_local_scan max"),
                                _require_equal(parts, pparts, "tile max partials")),
             "ms": _time_ms(lambda: ts.tile_local_scan_cuda(torch.maximum, xf,
                                                            main_t))}
    max_a = {"tiles": main_t,
             "max_abs_err": _require_equal(out, pout, "tile_apply max"),
             "ms": _time_ms(lambda: ts.tile_apply_cuda(torch.maximum, ploc,
                                                       seeds_m))}
    _require_equal(out, torch.cummax(xf, 0).values, "tile kernels max vs "
                   "torch.cummax")

    def line(name, replaces, rows, err, rigid, call, mx):
        head = rows[main_t]
        return {
            "name": name, "route": "cuda", "source": ts.SOURCE,
            "replaces": replaces, "shape": [n, d], "tiles": main_t,
            "op": "add", "max_abs_err": err,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library_call": call,
            "by_tiles": {str(t): r for t, r in rows.items()},
            "rigid_compose": rigid, "max": mx,
        }

    return (line(ts.LOCAL_NAME, ts.LOCAL_REPLACES, local_rows, err_l, rigid_l,
                 "torch.cumsum(x.view(T, K, d), 1)", max_l),
            line(ts.APPLY_NAME, ts.APPLY_REPLACES, apply_rows, err_a, rigid_a,
                 "local + seeds[:, None]", max_a))


def _live_rounds(plan) -> int:
    return sum(1 for r in plan.rounds if r.num_combines or r.num_moves)


def check_fused_round(device) -> tuple:
    """The per-round fused_round kernel and the whole-plan fused_plan kernel
    against their plain versions on the same input, exact: add over
    integer-valued rows (d = 1 and 4) and max over random floats for each
    circuit at n = 2^16 (the plan kernel at the cluster size the engine's
    size rule picks, and held against the per-round kernel's chain and the
    library scan; Blelloch's captured total too), a masked Ladner-Fischer
    plan, and rigid composition of 4096 deformations (to tolerance, and
    against the float64 chain).  Ladner-Fischer add is also timed at every
    cluster size that holds it.  Plans and their operands are built before
    every timed window.  Returns the ``kernel fused_round`` line (with the
    plan kernel's numbers) and the plan kernel's row of the kernels line."""
    from repro_torch.core.deformation import compose_batched
    from repro_torch.core.engine import get_plan, scan
    from repro_torch.core.engine.pallas_backend import (
        _plan_operands, _round_index_tensors,
    )
    from repro_torch.kernels import tile_scan as ts
    from repro_torch.kernels._tiling import (
        PLAN_MAX_CLUSTER, pack_leaves, packed_op, plan_cluster_size,
        plan_min_cluster,
    )

    n = ROUNDS_N

    def rounds(fn, op, x, live):
        y = x
        for src in live:
            y = fn(op, y, src)
        return y

    def held(op, x, live, what) -> float:
        y, err = x, 0.0
        for src in live:
            yk = ts.fused_round_cuda(op, y, src)
            yp = ts.fused_round_reference(op, y, src)
            err = max(err, _require_equal(yk, yp, f"fused_round {what}"))
            y = yk
        return err

    def plan_held(op, x, po, live, what) -> float:
        yk, tk = ts.fused_plan_cuda(op, x, po)
        yp, tp = ts.fused_plan_reference(op, x, po)
        err = _require_equal(yk, yp, f"fused_plan {what} C={po.cluster}")
        _require_equal(yk, rounds(ts.fused_round_cuda, op, x, live),
                       f"fused_plan {what} vs the per-round kernel")
        if (tk is None) != (tp is None):
            raise AssertionError(f"fused_plan {what}: total {tk} vs {tp}")
        if tk is not None:
            err = max(err, _require_equal(tk, tp, f"fused_plan {what} total"))
        return err

    def plan_bound(plan, po, d) -> dict:
        b = _bound(2 * n * d * 4 + po.nbytes, plan.work() * d)
        return {"plan_bound_ms": b["bound_ms"], "plan_bound_by": b["bound_by"]}

    data = {"add_d1": (torch.add, _ints(n, 1, device, seed=12)),
            "add_d4": (torch.add, _ints(n, 4, device, seed=13)),
            "max_d1": (torch.maximum, _floats(n, 1, device, seed=14))}
    by_case, err, plan_err = {}, 0.0, 0.0
    for alg in ROUND_CIRCUITS:
        t0 = time.perf_counter()
        plan = get_plan(alg, n)         # host compilation, once a plan
        plan_s = time.perf_counter() - t0
        live = [s for s in _round_index_tensors(plan, device) if s is not None]
        for label, (op, x) in data.items():
            d = x.shape[1]
            c = plan_cluster_size(n, d)
            po = _plan_operands(plan, device, c)
            e = held(op, x, live, f"{alg} {label}")
            ep = plan_held(op, x, po, live, f"{alg} {label}")
            y, total = ts.fused_plan_cuda(op, x, po)
            lib = (torch.cumsum(x.double(), 0).float() if op is torch.add
                   else torch.cummax(x, 0).values)
            if plan.exclusive:          # Blelloch: y[i] = x[0] o ... o x[i-1]
                _require_equal(y[1:], lib[:-1], f"fused_plan {alg} {label} "
                               "vs the library scan")
                _require_equal(total, lib[-1], f"fused_plan {alg} {label} "
                               "total vs the library reduction")
            else:
                _require_equal(y, lib, f"fused_plan {alg} {label} vs the "
                               "library scan")
            err, plan_err = max(err, e), max(plan_err, ep)
            row = {"rounds": len(live), "max_abs_err": e,
                   "plan_max_abs_err": ep, "plan_s": plan_s, "cluster": c,
                   "entries": po.entries, "operand_bytes": po.nbytes}
            if label != "add_d4":
                lib_fn = ((lambda x=x: torch.cumsum(x, 0)) if op is torch.add
                          else (lambda x=x: torch.cummax(x, 0)))
                xs1 = x[:, 0]
                chain = _time_ms(lambda op=op, x=x: rounds(
                    ts.fused_round_cuda, op, x, live), reps=20)
                row.update({
                    "ms": chain, "ms_per_round": chain / len(live),
                    "graph_ms": _graph_ms(lambda op=op, x=x: rounds(
                        ts.fused_round_cuda, op, x, live)),
                    "plan_ms": _time_ms(lambda op=op, x=x, po=po:
                                        ts.fused_plan_cuda(op, x, po)),
                    "plan_graph_ms": _graph_ms(lambda op=op, x=x, po=po:
                                               ts.fused_plan_cuda(op, x, po)),
                    "scan_ms": _time_ms(lambda op=op, xs1=xs1: scan(
                        op, xs1, backend="pallas", algorithm=alg), reps=20),
                    "plain_ms": _time_ms(lambda op=op, x=x: rounds(
                        ts.fused_round_reference, op, x, live), reps=3,
                        warmup=1),
                    "plan_plain_ms": _time_ms(
                        lambda op=op, x=x, po=po: ts.fused_plan_reference(
                            op, x, po), reps=3, warmup=1),
                    "library_ms": _time_ms(lib_fn),
                    **_bound(len(live) * (2 * n * d * 4 + 8 * n),
                             plan.work() * d),
                    **plan_bound(plan, po, d),
                })
            by_case[f"{alg}/{label}"] = row

    # Ladner-Fischer add at every cluster size that holds it: more CTAs
    # split a round's operands finer, at a barrier across more.
    plan = get_plan("ladner_fischer", n)
    live = [s for s in _round_index_tensors(plan, device) if s is not None]
    x = data["add_d1"][1]
    by_cluster = {}
    c = plan_min_cluster(n, 1)
    while c <= PLAN_MAX_CLUSTER:
        po = _plan_operands(plan, device, c)
        plan_err = max(plan_err, plan_held(torch.add, x, po, live,
                                           "ladner_fischer add_d1"))
        by_cluster[str(c)] = {
            "plan_ms": _time_ms(lambda po=po: ts.fused_plan_cuda(torch.add,
                                                                 x, po)),
            "plan_graph_ms": _graph_ms(lambda po=po: ts.fused_plan_cuda(
                torch.add, x, po))}
        c *= 2

    # One masked Ladner-Fischer plan (moves as well as combines).
    valid = (torch.arange(n, device=device) % 7) != 3
    valid[:5] = False
    plan = get_plan("ladner_fischer", n, mask=(~valid).tolist())
    live = [s for s in _round_index_tensors(plan, device) if s is not None]
    po = _plan_operands(plan, device, plan_cluster_size(n, 1))
    e = held(torch.add, x, live, "masked ladner_fischer")
    ep = plan_held(torch.add, x, po, live, "masked ladner_fischer")
    y, _ = ts.fused_plan_cuda(torch.add, x, po)
    _require_equal(y[:, 0], _masked_cumsum(x[:, 0], valid),
                   "fused_plan masked vs the masked sum")
    err, plan_err = max(err, e), max(plan_err, ep)
    by_case["ladner_fischer_masked/add_d1"] = {
        "rounds": len(live), "moves": plan.num_moves(), "max_abs_err": e,
        "plan_max_abs_err": ep, "cluster": po.cluster,
        "entries": po.entries}

    # Rigid composition at the paper's series length: order shows here.
    dfm = _deformations(SERIES_LEN, device, seed=15)
    x2, spec = pack_leaves(dfm)
    pop = packed_op(compose_batched, spec)
    a64, s64 = _chain64(dfm["angle"], dfm["shift"])
    plan = get_plan("ladner_fischer", SERIES_LEN)
    live = [s for s in _round_index_tensors(plan, device) if s is not None]
    po = _plan_operands(plan, device, plan_cluster_size(SERIES_LEN, 3))
    atol = _rigid_atol(s64)
    y, rigid_err = x2, 0.0
    for src in live:
        yk = ts.fused_round_cuda(pop, y, src)
        yp = ts.fused_round_reference(pop, y, src)
        torch.cuda.synchronize()
        if not torch.allclose(yk, yp, rtol=RIGID_RTOL, atol=atol):
            raise AssertionError("fused_round rigid: kernel and plain disagree")
        rigid_err = max(rigid_err, float((yk - yp).abs().max()))
        y = yk
    yk, _ = ts.fused_plan_cuda(pop, x2, po)
    yp, _ = ts.fused_plan_reference(pop, x2, po)
    torch.cuda.synchronize()
    if not torch.allclose(yk, yp, rtol=RIGID_RTOL, atol=atol):
        raise AssertionError("fused_plan rigid: kernel and plain disagree")
    rigid = {"n": SERIES_LEN, "rounds": len(live), "cluster": po.cluster,
             "max_abs_err_vs_plain": rigid_err,
             "plan_max_abs_err_vs_plain": float((yk - yp).abs().max()),
             **_check_vs_chain64(y[:, 0], y[:, 1:], a64, s64,
                                 "fused_round rigid"),
             "plan": _check_vs_chain64(yk[:, 0], yk[:, 1:], a64, s64,
                                       "fused_plan rigid"),
             "ms": _time_ms(lambda: rounds(ts.fused_round_cuda, pop, x2, live)),
             "plan_ms": _time_ms(lambda: ts.fused_plan_cuda(pop, x2, po)),
             "plain_ms": _time_ms(lambda: rounds(ts.fused_round_reference, pop,
                                                 x2, live), reps=5),
             "library_ms": None}

    # Host time of the lookups a rounds-mode engine call makes: the plan
    # (keyed without its mask) and its operand list (kept on the plan).
    reps = 20
    c = plan_cluster_size(n, 1)
    t0 = time.perf_counter()
    for _ in range(reps):
        _plan_operands(get_plan("ladner_fischer", n), device, c)
    lookup_ms = (time.perf_counter() - t0) / reps * 1e3

    head = by_case["ladner_fischer/add_d1"]
    line = {
        "name": ts.FUSED_NAME, "route": "cuda", "source": ts.FUSED_SOURCE,
        "replaces": ts.FUSED_REPLACES, "shape": [n, 1], "op": "add",
        "circuit": "ladner_fischer", "max_abs_err": err,
        "ms": head["ms"], "ms_per_round": head["ms_per_round"],
        "graph_ms": head["graph_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "library_call": "torch.cumsum(x, 0)",
        "plan_ms": head["plan_ms"], "plan_graph_ms": head["plan_graph_ms"],
        "cluster": head["cluster"], "operand_bytes": head["operand_bytes"],
        "plan_bound_ms": head["plan_bound_ms"],
        "plan_bound_by": head["plan_bound_by"],
        "plan_max_abs_err": plan_err, "plan_lookup_ms": lookup_ms,
        "scan_ms": head["scan_ms"],
        "timing": "ms, plain_ms: all rounds of the plan through the "
                  "per-round kernel's wrapper / its plain version; graph_ms: "
                  "the same launches replayed from a CUDA graph; plan_ms, "
                  "plan_graph_ms: the whole plan as one fused_plan launch "
                  "on `cluster` CTAs, through its wrapper / from a graph; "
                  "scan_ms: engine.scan(backend='pallas') (one fused_plan "
                  "launch); plan_lookup_ms: host time of its plan and "
                  "operand lookups; plan_s: host plan compilation; "
                  "bound_ms: the rounds' bytes summed (dense tables); "
                  "plan_bound_ms: x, y and the operand list once",
        "by_case": by_case, "by_cluster": by_cluster, "rigid_compose": rigid,
    }
    row = {
        "name": ts.PLAN_NAME, "route": "cuda", "source": ts.FUSED_SOURCE,
        "replaces": ts.FUSED_REPLACES, "shape": [n, 1], "op": "add",
        "circuit": "ladner_fischer", "cluster": head["cluster"],
        "max_abs_err": plan_err, "ms": head["plan_ms"],
        "graph_ms": head["plan_graph_ms"], "plain_ms": head["plan_plain_ms"],
        "bound_ms": head["plan_bound_ms"], "bound_by": head["plan_bound_by"],
        "library_ms": head["library_ms"], "library_call": "torch.cumsum(x, 0)",
        "operand_bytes": head["operand_bytes"], "scan_ms": head["scan_ms"],
    }
    return line, row


def run_series(device, n_frames: int, size: int, **cfg_kw) -> dict:
    """``repro_torch.register_series`` on a rendered series, streamed in
    chunks of 16, with the launch counts read around exactly that call."""
    import repro_torch
    from repro_torch.core.registration import RegistrationConfig
    from repro_torch.data.images import stream_series
    from repro_torch.kernels import launch_counts, reset_launch_counts

    chunks, true = stream_series(11, n_frames, chunk_size=16, size=size,
                                 noise=NOISE, device=device)
    # The reference's lr_angle (5e-4) is tuned to 96-px frames: the NCC
    # distance's curvature in the angle grows with the frame's second moment
    # (size^2), so the step is scaled by (96 / size)^2 to stay stable.
    reg = RegistrationConfig(lr_angle=5e-4 * (96 / size) ** 2)
    cfg = repro_torch.RegisterSeriesConfig(
        registration=reg, skip_tol=SKIP_TOL, **cfg_kw
    )
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = repro_torch.register_series(chunks, cfg, device=device)
    wall = time.perf_counter() - t0
    launches = launch_counts().get("warp_ncc", 0)
    grad_launches = launch_counts().get("ncc_grad", 0)
    shift = res.deformations["shift"]
    if tuple(shift.shape) != (n_frames, 2) or not bool(
        torch.isfinite(shift).all()
    ):
        raise AssertionError(f"bad result shift {tuple(shift.shape)}")
    err = float((shift - true["shift"]).abs().max())
    checks = sum(f["skipped"] + f["refined"] for f in res.feeds)
    out = {
        "frames": n_frames, "size": size, "skip_tol": SKIP_TOL,
        "lr_angle": reg.lr_angle,
        "backend": res.backend,
        "feeds": [[f["n_elems"], f["backend"], f["skipped"], f["refined"]]
                  for f in res.feeds],
        "warp_ncc_launches": launches, "guess_checks": checks,
        "ncc_grad_launches": grad_launches,
        "skipped": sum(f["skipped"] for f in res.feeds),
        "refined": sum(f["refined"] for f in res.feeds),
        "max_shift_err_px": err,
        "timings_s": res.timings, "wall_s": wall,
        "operator_calls": res.op_telemetry["calls"]
        + res.op_telemetry["compile_calls"],
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }
    if res.scan_stats is not None:
        st = res.scan_stats
        out["hier"] = {
            "segments": st.num_segments, "threads": st.threads_per_segment,
            "cross_steal": st.cross_steal,
            "inter_segment_steals": st.inter_segment_steals,
            "phase_s": st.phase_seconds,
        }
    if not err < SHIFT_ERR_MAX:
        raise AssertionError(f"shift error {err} px >= {SHIFT_ERR_MAX}")
    fused = device.type == "cuda"
    if fused and not (launches > 0 and launches == checks):
        raise AssertionError(
            f"warp_ncc launched {launches} times for {checks} guess checks"
        )
    return out


def run_series_compose(device, n_frames: int, size: int) -> dict:
    """``register_series(refine=False)`` with all frames in one chunk: one
    feed composes n_frames - 1 function-A elements in one engine scan,
    which on the card dispatches to the decoupled backend.  The frames are
    rendered before the timed call."""
    import repro_torch
    from repro_torch import service
    from repro_torch.core.registration import RegistrationConfig
    from repro_torch.data.images import stream_series
    from repro_torch.kernels import launch_counts, reset_launch_counts

    # Rendered 16 frames at a time (a 257-frame render at 1920 px would
    # hold ~20 frame-sized temporaries at once), then fed as one chunk.
    chunks, true = stream_series(12, n_frames, chunk_size=16, size=size,
                                 noise=NOISE, device=device)
    frames = torch.cat(list(chunks), dim=0)
    reg = RegistrationConfig(lr_angle=5e-4 * (96 / size) ** 2)
    cfg = repro_torch.RegisterSeriesConfig(registration=reg, refine=False)
    # Keep the function-A elements the scan composes, to hold the result
    # against a float64 chain of the same elements.
    fed = []
    compose_suffix = service.SeriesSession._compose_suffix

    def recording(self, new_elems, seed):
        fed.extend(e.deformation for e in new_elems)
        return compose_suffix(self, new_elems, seed)

    service.SeriesSession._compose_suffix = recording
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        res = repro_torch.register_series(frames, cfg, device=device)
        wall = time.perf_counter() - t0
        launches = launch_counts().get("lookback_scan", 0)
        grad_launches = launch_counts().get("ncc_grad", 0)
    finally:
        service.SeriesSession._compose_suffix = compose_suffix
    shift = res.deformations["shift"]
    if tuple(shift.shape) != (n_frames, 2) or not bool(
        torch.isfinite(shift).all()
    ):
        raise AssertionError(f"bad result shift {tuple(shift.shape)}")
    a64, s64 = _chain64(torch.stack([e["angle"] for e in fed]),
                        torch.stack([e["shift"] for e in fed]))
    chain = _check_vs_chain64(res.deformations["angle"][1:], shift[1:],
                              a64, s64, "series_compose")
    out = {
        "frames": n_frames, "size": size, "refine": False,
        "backend": res.backend,
        "feeds": [[f["n_elems"], f["backend"]] for f in res.feeds],
        "lookback_scan_launches": launches,
        "ncc_grad_launches": grad_launches,
        "composed_vs_f64_chain": chain,
        "max_shift_err_px": float((shift - true["shift"]).abs().max()),
        "timings_s": res.timings, "wall_s": wall,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }
    if device.type == "cuda" and launches < 1:
        raise AssertionError("series_compose never launched lookback_scan")
    return out


# ------------------------------------------------------------ serving path

#: The front end's tenants: (name, frames, refine, frames a feed,
#: interactive).  The refining tenants reach warp_ncc through the guess
#: check; the composing one reaches lookback_scan through ``decoupled``.
SERVING_TENANTS = (("scope", 33, True, 8, True),
                   ("batch_a", 33, False, 16, False),
                   ("batch_b", 17, True, 8, False))
SERVING_RATE_HZ = 4.0        # offered requests a second (Poisson, open loop)
SERVING_DRAIN_S = 900.0      # every admitted ticket completes inside this
COMPOSE_TOL = 1e-6           # tests/test_serving.py:288-291 (rtol and atol)
REFINE_ATOL = 1e-5           # px: the port's streamed-vs-one-shot bound


def _series_cfg(size: int, refine: bool, name: str):
    """A session config at ``size`` px.  The refining sessions pin a static
    two-level decomposition and the composing ones the decoupled backend,
    so that the same chunks associate the same way in any process and
    under any pool load: the comparisons below then hold the front end and
    a restore to the same arithmetic as a one-process run."""
    import repro_torch
    from repro_torch.core.registration import RegistrationConfig

    reg = RegistrationConfig(lr_angle=5e-4 * (96 / size) ** 2)
    if refine:
        return repro_torch.RegisterSeriesConfig(
            registration=reg, skip_tol=SKIP_TOL, backend="hierarchical",
            num_segments=2, num_threads=2, stealing=False, cross_steal=False,
            telemetry_name=name)
    return repro_torch.RegisterSeriesConfig(
        registration=reg, refine=False, backend="decoupled",
        telemetry_name=name)


def _rendered(seed: int, n_frames: int, size: int, device):
    from repro_torch.data.images import stream_series

    chunks, true = stream_series(seed, n_frames, chunk_size=16, size=size,
                                 noise=NOISE, device=device)
    return torch.cat(list(chunks), dim=0), true


def _hold_shifts(got, want, true, refine: bool, what: str) -> dict:
    """Hold a session's shifts to ``register_series`` of the same chunks:
    rtol and atol COMPOSE_TOL without refinement, REFINE_ATOL px and the
    ground truth with it."""
    g, w = got.double(), want.double()
    err = float((g - w).abs().max())
    out = {"max_abs_err_px": err}
    if refine:
        truth = float((got - true["shift"]).abs().max())
        out["max_shift_err_px"] = truth
        if not err <= REFINE_ATOL:
            raise AssertionError(f"{what}: {err} px from register_series "
                                 f"(bound {REFINE_ATOL})")
        if not truth < SHIFT_ERR_MAX:
            raise AssertionError(f"{what}: shift error {truth} px >= "
                                 f"{SHIFT_ERR_MAX}")
    elif not bool(((g - w).abs() <= COMPOSE_TOL + COMPOSE_TOL * w.abs()).all()):
        raise AssertionError(f"{what}: {err} from register_series "
                             f"(rtol and atol {COMPOSE_TOL})")
    return out


def run_serving(device, size: int, tenants=SERVING_TENANTS) -> dict:
    """Three tenants' series through a ``RegistrationFrontend``
    (round-robin, one dispatcher) whose sessions take the default device,
    fed by ``loadgen.run_open_loop`` on a seeded Poisson schedule; each
    tenant's shifts are then held against ``register_series`` of the same
    chunks."""
    import repro_torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (
        FrontendConfig,
        LatencyHistogram,
        RegistrationFrontend,
        poisson_arrivals,
        run_open_loop,
    )

    # None on the card: a front end's sessions run there by default.
    session_device = None if device.type == "cuda" else device
    series = {}
    for i, (name, n, refine, chunk, interactive) in enumerate(tenants):
        frames, true = _rendered(30 + i, n, size, device)
        series[name] = {
            "frames": frames, "true": true, "refine": refine,
            "interactive": interactive,
            "chunks": [frames[lo:lo + chunk] for lo in range(0, n, chunk)],
            "cfg": _series_cfg(size, refine, f"serving_{name}"),
        }
    depth = max(len(s["chunks"]) + 1 for s in series.values())
    fe = RegistrationFrontend(FrontendConfig(
        policy="round_robin", dispatch_workers=1, queue_depth=depth))
    # Each tenant's requests in order, interleaved across tenants: its
    # feeds, then its result.
    requests, per_tenant = [], {}
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        for name, s in series.items():
            fe.add_tenant(name, interactive=s["interactive"])
            s["sid"] = fe.open_series(name, s["cfg"], device=session_device)
            per_tenant[name] = []
        for r in range(depth):
            for name, s in series.items():
                if r < len(s["chunks"]):
                    requests.append((name, "feed", s["chunks"][r]))
                elif r == len(s["chunks"]):
                    requests.append((name, "result", None))
        pending = iter(requests)

        def submit():
            name, kind, chunk = next(pending)
            sid = series[name]["sid"]
            t = (fe.feed(name, sid, chunk) if kind == "feed"
                 else fe.result(name, sid))
            per_tenant[name].append(t)
            return t

        arrivals = poisson_arrivals(SERVING_RATE_HZ, 1e6, seed=2026)
        load = run_open_loop(submit, arrivals[:len(requests)],
                             drain_timeout_s=SERVING_DRAIN_S)
        results = {name: ts[-1].result(timeout=0)
                   for name, ts in per_tenant.items()}
        stats = fe.stats()["tenants"]
    finally:
        fe.close()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if load.completed != len(requests) or load.rejected or load.errors:
        raise AssertionError(
            f"serving: {load.completed}/{len(requests)} completed, "
            f"{load.rejected} rejected, {load.errors} errors")
    out = {"size": size, "policy": "round_robin", "dispatch_workers": 1,
           "requests": len(requests), "rate_hz": SERVING_RATE_HZ,
           "wall_s": wall, "offered_hz": load.offered_hz,
           "achieved_hz": load.achieved_hz,
           "latency_p50_s": load.latency.percentile(50),
           "latency_p99_s": load.latency.percentile(99),
           "warp_ncc_launches": launches.get("warp_ncc", 0),
           "lookback_scan_launches": launches.get("lookback_scan", 0),
           "tenants": {}}
    for name, s in series.items():
        res, tickets = results[name], per_tenant[name]
        hist = LatencyHistogram()
        for t in tickets:
            hist.record(t.latency_s)
        alone = repro_torch.register_series(s["chunks"], s["cfg"],
                                            device=device)
        shift = res.deformations["shift"]
        if shift.device.type != device.type or tuple(shift.shape) != (
                s["frames"].shape[0], 2):
            raise AssertionError(f"serving {name}: shift {tuple(shift.shape)} "
                                 f"on {shift.device}")
        out["tenants"][name] = {
            "frames": int(s["frames"].shape[0]), "refine": s["refine"],
            "interactive": s["interactive"], "requests": len(tickets),
            "latency_p50_s": hist.percentile(50),
            "latency_p99_s": hist.percentile(99),
            "rejected": stats[name]["rejected"],
            "feeds": [[f["n_elems"], f["backend"], f["skipped"], f["refined"]]
                      for f in res.feeds],
            "wall_s": max(t.t_done for t in tickets)
            - min(t.t_arrival for t in tickets),
            **_hold_shifts(shift, alone.deformations["shift"], s["true"],
                           s["refine"], f"serving {name}"),
        }
    if device.type == "cuda":
        for kernel in ("warp_ncc", "lookback_scan"):
            if out[f"{kernel}_launches"] < 1:
                raise AssertionError(f"serving never launched {kernel}")
    return out


# ------------------------------------------------------ checkpoint/restore

#: A cold process's part of ``series_restore``: ``write`` opens a session
#: with the checkpoint and compile cache directories from its start, feeds
#: the frames and checkpoints; ``restore`` restores that snapshot and
#: extends it.  Each prints one JSON line.
_RESTORE_CHILD = r"""
import json, pickle, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch import service
from repro_torch.kernels import _cuda, launch_counts, reset_launch_counts
from repro_torch.runtime.compile_cache import get_compile_cache, get_plan_store

mode, ckpt, cache, frames, device, cfg = sys.argv[2:8]
frames = torch.from_numpy(np.load(frames))
device = None if device == "cuda" else device
reset_launch_counts()
t0 = time.perf_counter()
if mode == "write":
    with open(cfg, "rb") as f:
        cfg = pickle.load(f)
    s = service.open_series(cfg, checkpoint_dir=ckpt, compile_cache_dir=cache,
                            device=device)
    s.feed(frames)
    out = {"step": s.checkpoint(), "checkpoint_s": time.perf_counter() - t0}
    s.close()
else:
    s = service.SeriesSession.restore(ckpt, device=device,
                                      compile_cache_dir=cache)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = s.extend(frames)
    s.close()
    out = {
        "restore_s": restore_s, "extend_s": time.perf_counter() - t0,
        "device": str(res.deformations["shift"].device),
        "compile_cache": res.compile_cache,
        "compile_stage_s": res.timings["compile"],
        "feeds": [[f["n_elems"], f["backend"], f["skipped"], f["refined"]]
                  for f in res.feeds],
        "shift": res.deformations["shift"].tolist(),
    }
store = get_plan_store()
print(json.dumps({
    **out,
    "process_compile_cache": get_compile_cache().stats(),
    "plan_store": {"loads": store.loads, "stores": store.stores},
    # Libraries nvcc compiled in this process (none: they load from build/).
    "nvcc_built": [n for n in ("warp_ncc", "lookback_scan")
                   if _cuda.build_log(n)],
    "launches": launch_counts(),
}))
"""


def _restore_child(mode: str, tmp: str, frames, device, what: str) -> dict:
    """Run ``_RESTORE_CHILD`` in a fresh interpreter on ``frames``."""
    path = os.path.join(tmp, f"{mode}.npy")
    np.save(path, frames.cpu().numpy())
    proc = subprocess.run(
        [sys.executable, "-c", _RESTORE_CHILD, os.path.join(ROOT, "src"),
         mode, os.path.join(tmp, "ckpt"), os.path.join(tmp, "cache"), path,
         device.type, os.path.join(tmp, "cfg.pkl")],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: the {mode} process failed:\n"
                             f"{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    # Each cold process builds function A's launcher once, on its first
    # feed (eager PyTorch has no executable to persist), and that build
    # loads the kernel library from build/ without nvcc.
    if got["process_compile_cache"]["misses"] != 1 or got["nvcc_built"]:
        raise AssertionError(f"{what}: {mode} process compile cache "
                             f"{got['process_compile_cache']}, nvcc built "
                             f"{got['nvcc_built']}")
    return got


def run_series_restore(device, n_frames: int, size: int, cut: int) -> dict:
    """Checkpoint a session after ``cut`` frames in one cold subprocess
    (opened with the checkpoint and compile cache directories), restore it
    in a second one and extend it with the rest, and hold the series to
    the uninterrupted session with the same chunk boundaries — refining
    (warp_ncc), then composing (lookback_scan through ``decoupled``).
    The launch counts are the two subprocesses'."""
    import pickle
    import tempfile

    from repro_torch import service

    out = {"frames": n_frames, "size": size, "cut": cut}
    for seed, refine in ((40, True), (41, False)):
        frames, true = _rendered(seed, n_frames, size, device)
        cfg = _series_cfg(size, refine, f"restore_{int(refine)}")
        tag = "refine" if refine else "compose"
        what = f"series_restore {tag}"
        with service.open_series(cfg, device=device) as u:
            u.feed(frames[:cut])
            want = u.extend(frames[cut:])
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "cfg.pkl"), "wb") as f:
                pickle.dump(cfg, f)
            wrote = _restore_child("write", tmp, frames[:cut], device, what)
            child = _restore_child("restore", tmp, frames[cut:], device, what)
        got = torch.tensor(child.pop("shift"), dtype=torch.float32,
                           device=device)
        held = _hold_shifts(got, want.deformations["shift"], true, refine,
                            what)
        cc = child["compile_cache"]
        if wrote["step"] != cut or cc["misses"] != 1:
            raise AssertionError(f"{what}: step {wrote['step']}, restored "
                                 f"compile cache {cc}")
        if refine and child["plan_store"]["loads"] < 1:
            raise AssertionError(f"{what}: no plan came from the store "
                                 f"({child['plan_store']})")
        if device.type == "cuda" and not child["device"].startswith("cuda"):
            raise AssertionError(f"{what}: restored onto {child['device']}")
        restored = child.pop("launches")
        launches = {k: wrote["launches"].get(k, 0) + restored.get(k, 0)
                    for k in ("warp_ncc", "lookback_scan")}
        out[tag] = {"refine": refine,
                    "feeds_uninterrupted": [[f["n_elems"], f["backend"]]
                                            for f in want.feeds],
                    "write": {k: wrote[k] for k in (
                        "checkpoint_s", "process_compile_cache",
                        "plan_store", "launches")},
                    **child, "restored_launches": restored,
                    "launches": launches, **held}
    if device.type == "cuda":
        for tag, kernel in (("refine", "warp_ncc"),
                            ("compose", "lookback_scan")):
            if out[tag]["restored_launches"].get(kernel, 0) < 1:
                raise AssertionError(f"series_restore {tag}: the restored "
                                     f"session never launched {kernel}")
    return out


# ---------------------------------------------------------- simulate path

SIM_N = 4096                 # the paper's series length
#: (cores, frames): the paper's 1,024-core run as ranks x 12 threads (85 x
#: 12 = 1,020, as benchmarks/bench_strong_scaling.py), and 6,144 cores (512
#: ranks x 12) at four frames a core.
SIM_RUNS = ((1020, 4096), (6144, 24576))


def run_simulate(device, n: int = SIM_N) -> dict:
    """``engine.scan(backend="simulate")`` on ``n`` rigid deformations on
    ``device`` against the ``vector`` backend, the backend itself with the
    paper's registration-like costs, and the simulator's static and
    stealing makespans at the paper's core counts (host numbers)."""
    from repro_torch.core.deformation import compose_batched
    from repro_torch.core.engine import backends, get_backend, get_plan, scan
    from repro_torch.core.simulator import (
        registration_like_costs,
        simulate_distributed_scan,
        theoretical_bound_scan,
    )

    d = _deformations(n, device, seed=50)
    elems = [{"angle": d["angle"][i], "shift": d["shift"][i]}
             for i in range(n)]
    want = scan(compose_batched, d, backend="vector",
                algorithm="ladner_fischer")
    t0 = time.perf_counter()
    got = scan(compose_batched, elems, backend="simulate",
               algorithm="ladner_fischer")
    scan_s = time.perf_counter() - t0
    default_trace = backends.last_trace
    if got[0]["shift"].device.type != device.type:
        raise AssertionError(f"simulate ran on {got[0]['shift'].device}")
    err = {k: _require_equal(torch.stack([g[k] for g in got]), want[k],
                             f"simulate vs vector ({k})")
           for k in ("angle", "shift")}
    plan = get_plan("ladner_fischer", n)
    costs = registration_like_costs(n)
    ys, _ = get_backend("simulate")(compose_batched, plan, elems, costs=costs)
    trace = backends.last_trace
    _require_equal(torch.stack([y["shift"] for y in ys]), want["shift"],
                   "simulate with costs vs vector")
    if trace.work != plan.work() or default_trace.work != plan.work():
        raise AssertionError(f"simulate: {trace.work} combines traced, the "
                             f"plan has {plan.work()}")
    out = {"n": n, "circuit": "ladner_fischer", "scan_s": scan_s,
           "max_abs_err_vs_vector": err, "work": trace.work,
           "rounds": plan.num_rounds(),
           "makespan_unit_cost": default_trace.makespan,
           "makespan_registration_costs_s": trace.makespan,
           "serial_registration_costs_s": float(costs.sum()),
           "host_simulator": {}}
    for cores, frames in SIM_RUNS:
        c = registration_like_costs(frames)
        ranks = cores // 12
        c = c[:frames - frames % ranks]
        runs = {}
        for mode, stealing in (("static", False), ("stealing", True)):
            t0 = time.perf_counter()
            r = simulate_distributed_scan(c, ranks=ranks, threads=12,
                                          algorithm="ladner_fischer",
                                          stealing=stealing)
            runs[mode] = {"makespan_s": r.makespan,
                          "speedup": float(c.sum()) / r.makespan,
                          "host_s": time.perf_counter() - t0}
        out["host_simulator"][str(cores)] = {
            "ranks": ranks, "threads": 12, "frames": len(c), **runs,
            "stealing_gain": runs["static"]["makespan_s"]
            / runs["stealing"]["makespan_s"],
            "bound_speedup": theoretical_bound_scan(len(c), cores),
        }
    return out


# The multi-device scans on one card: meshes of positions on cuda:0 (one
# card's machine has one card), 8 positions for the collectives and 4 and 8
# for the sharded backend.  They check values, launches and the protocol;
# positions on one card are not devices, so no multi-device speed is read.
COLLECTIVE_ROWS = 1024       # distributed_blocked_scan rows a position (at
                             # 4,096 its Python loops took 75-110 s)
SHARDED_MESHES = (4, 8)


def _walled(call, on_card: bool):
    """``call()`` and its wall ms, the card synchronised on both sides."""
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = call()
    if on_card:
        torch.cuda.synchronize()
    return y, (time.perf_counter() - t0) * 1e3


def _affine_inputs(n: int, device, seed: int):
    """Affine maps (m, c) with integer values whose sequential composition
    stays exact in float32: four doublings in m, c in [-4, 4]."""
    rng = np.random.default_rng(seed)
    m = np.ones(n, np.float32)
    m[rng.choice(n, 4, replace=False)] = 2.0
    c = rng.integers(-4, 5, n).astype(np.float32)
    return (torch.tensor(m, device=device), torch.tensor(c, device=device))


def _affine_fold(m, c):
    """The sequential fold of affine maps, in float64 on the host."""
    mm, cc = m.double().cpu().numpy(), c.double().cpu().numpy()
    om, oc = np.empty_like(mm), np.empty_like(cc)
    am, ac = mm[0], cc[0]
    om[0], oc[0] = am, ac
    for i in range(1, len(mm)):
        am, ac = am * mm[i], ac * mm[i] + cc[i]
        om[i], oc[i] = am, ac
    return (torch.tensor(om, dtype=torch.float32),
            torch.tensor(oc, dtype=torch.float32))


def _affine(a, b):
    return (a[0] * b[0], a[1] * b[0] + b[1])


def run_collective(device, rows: int = COLLECTIVE_ROWS) -> dict:
    """``core/distributed.py`` on a mesh of 8 positions of ``device``: the
    ``collective_scan`` of every combine-only circuit, the Träff exscan,
    the 2x4 ("pod", "data") hierarchy, and the local-global-local blocked
    scan (both strategies, ``rows`` a position; the affine pytree op too),
    each bit-equal to the exact prefixes of integer-valued data."""
    from functools import partial

    from repro_torch.core import distributed as dist
    from repro_torch.core.circuits import GENERATORS
    from repro_torch.core.engine import get_plan
    from repro_torch.core.spmd import Mesh, P, shard_map

    on_card = device.type == "cuda"
    mesh = Mesh([device] * 8, ("x",))
    mesh2 = Mesh([device] * 8, ("pod", "data"), (2, 4))
    spec2 = P(("pod", "data"))
    x = _ints(8, 1024, device, seed=60)          # one 1024-wide element each
    exact = torch.cumsum(x.double(), 0).float()
    out = {"positions": 8, "element_width": x.shape[1], "rows": rows,
           "calls": {}}

    def held(name, call, ok):
        walls = []
        for _ in range(2):
            y, ms = _walled(call, on_card)
            walls.append(ms)
            if not ok(y):
                raise AssertionError(f"collective {name}: wrong result")
        out["calls"][name] = {"wall_ms_first": walls[0],
                              "wall_ms_second": walls[1]}

    add = torch.add
    circuits = [a for a in sorted(GENERATORS)
                if get_plan(a, 8).combine_only()]
    out["circuits"] = circuits
    for alg in circuits:
        f = shard_map(partial(dist.collective_scan, add, axis_name="x",
                              algorithm=alg), mesh, P("x"), P("x"))
        held(f"collective_scan_{alg}", lambda f=f: f(x),
             lambda y: torch.equal(y, exact))
    f = shard_map(partial(dist.exclusive_collective_scan, add, axis_name="x"),
                  mesh, P("x"), P("x"))
    held("exclusive_collective_scan", lambda: f(x),
         lambda y: torch.equal(y[1:], exact[:-1]) and not y[0].any())
    out["exscan_rounds"] = dist.last_exscan_rounds()
    if out["exscan_rounds"] != 3:
        raise AssertionError(f"exscan ran {out['exscan_rounds']} rounds, "
                             "want ceil(log2 8) = 3")
    f = shard_map(partial(dist.hierarchical_collective_scan, add,
                          axis_names=("pod", "data")), mesh2, spec2, spec2)
    held("hierarchical_collective_scan", lambda: f(x),
         lambda y: torch.equal(y, exact))
    f = shard_map(partial(dist.exclusive_hierarchical_scan, add,
                          axis_names=("pod", "data")), mesh2, spec2, spec2)
    held("exclusive_hierarchical_scan", lambda: f(x),
         lambda y: torch.equal(y[1:], exact[:-1]) and not y[0].any())
    out["exhier_rounds"] = dist._exscan_rounds_log[-2:]

    xs = _ints(8 * rows, 1, device, seed=61)[:, 0]
    exact_xs = torch.cumsum(xs.double(), 0).float()
    m, c = _affine_inputs(8 * rows, device, seed=62)
    fold_m, fold_c = _affine_fold(m, c)
    for strat in ("scan_then_map", "reduce_then_scan"):
        f = shard_map(partial(dist.distributed_blocked_scan, add,
                              axis_names=("pod", "data"), strategy=strat),
                      mesh2, spec2, spec2)
        held(f"distributed_blocked_scan_{strat}", lambda f=f: f(xs),
             lambda y: torch.equal(y, exact_xs))
        f = shard_map(partial(dist.distributed_blocked_scan, _affine,
                              axis_names=("pod", "data"), strategy=strat),
                      mesh2, (spec2,), spec2)
        held(f"distributed_blocked_scan_{strat}_affine",
             lambda f=f: f((m, c)),
             lambda y: torch.equal(y[0].cpu(), fold_m)
             and torch.equal(y[1].cpu(), fold_c))
    return out


def run_sharded(device, n: int, series_len: int = SERIES_LEN,
                meshes=SHARDED_MESHES) -> dict:
    """``engine.scan(backend="sharded")`` with explicit meshes of 4 and 8
    positions of ``device``: add at ``n`` rows (plain, seeded, masked,
    stealing off, an odd n), rigid composition of ``series_len``
    deformations, and the affine pytree op (no kernel form: the plain
    phase 3); each call checked, its launches counted."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.deformation import compose_batched
    from repro_torch.core.engine import scan, sharded
    from repro_torch.core.engine.sharded import AXIS
    from repro_torch.core.simulator import (
        constant_costs,
        simulate_distributed_scan,
    )
    from repro_torch.core.spmd import Mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts

    on_card = device.type == "cuda"
    x = _ints(n, 1, device, seed=70)[:, 0]
    exact = torch.cumsum(x.double(), 0).float()
    seed = torch.tensor(1000.0, device=device)
    g = torch.Generator(device="cpu").manual_seed(71)
    valid = (torch.rand(n, generator=g) < 0.7).to(device)
    masked = _masked_cumsum(x, valid)
    x_odd = _ints(n + 7, 1, device, seed=72)[:, 0]
    exact_odd = torch.cumsum(x_odd.double(), 0).float()
    dfm = _deformations(series_len, device, seed=73)
    a64, s64 = _chain64(dfm["angle"], dfm["shift"])
    m, c = _affine_inputs(series_len * 8, device, seed=74)
    want_m, want_c = scan(_affine, (m, c), backend="vector")
    fold_m, fold_c = _affine_fold(m, c)
    if not (torch.equal(want_m.cpu(), fold_m)
            and torch.equal(want_c.cpu(), fold_c)):
        raise AssertionError("vector's affine scan is not the exact fold")

    out = {"n": n, "series_len": series_len, "meshes": {}}
    total_launches = 0
    for p in meshes:
        mesh = Mesh([device] * p, (AXIS,))
        sim_rounds = simulate_distributed_scan(
            constant_costs(4096), ranks=p, algorithm="exscan").phase2_rounds
        calls = [
            ("add", lambda: scan(torch.add, x, backend="sharded", mesh=mesh),
             lambda y: torch.equal(y, exact), True),
            ("add_seeded",
             lambda: scan(torch.add, x, backend="sharded", mesh=mesh,
                          seed=seed),
             lambda y: torch.equal(y, exact + seed), True),
            ("add_masked",
             lambda: scan(torch.add, x, backend="sharded", mesh=mesh,
                          where=valid),
             lambda y: torch.equal(y, masked), True),
            ("add_no_stealing",
             lambda: scan(torch.add, x, backend="sharded", mesh=mesh,
                          stealing=False),
             lambda y: torch.equal(y, exact), True),
            ("add_odd_n",
             lambda: scan(torch.add, x_odd, backend="sharded", mesh=mesh),
             lambda y: torch.equal(y, exact_odd), True),
            ("rigid_compose",
             lambda: scan(compose_batched, dfm, backend="sharded", mesh=mesh),
             lambda y: bool(_check_vs_chain64(y["angle"], y["shift"], a64,
                                              s64, f"sharded p={p} compose")),
             True),
            ("affine_pytree",
             lambda: scan(_affine, (m, c), backend="sharded", mesh=mesh),
             lambda y: torch.equal(y[0], want_m) and torch.equal(y[1], want_c),
             False),
        ]
        res = {}
        for name, call, ok, kernel in calls:
            for _ in range(2):      # the second call's numbers are read
                reset_launch_counts()
                y, ms = _walled(call, on_card)
                launches = launch_counts().get("lookback_scan", 0)
                if not ok(y):
                    raise AssertionError(f"sharded p={p} {name}: wrong result")
            st = sharded.last_stats
            rounds = math.ceil(math.log2(p))
            if not (st.phase2_rounds == rounds == sim_rounds
                    == dist.last_exscan_rounds()):
                raise AssertionError(
                    f"sharded p={p} {name}: phase 2 ran {st.phase2_rounds} "
                    f"rounds (exscan log {dist.last_exscan_rounds()}, "
                    f"simulator {sim_rounds}), want {rounds}")
            want_route = "lookback_scan" if on_card and kernel else "plain"
            if st.phase3_route != want_route or (
                    on_card and launches != (p if kernel else 0)):
                raise AssertionError(
                    f"sharded p={p} {name}: phase 3 {st.phase3_route} with "
                    f"{launches} lookback_scan launches")
            total_launches += launches
            res[name] = {
                "wall_ms_second": ms,
                "phase_seconds": st.phase_seconds,
                "phase2_rounds": st.phase2_rounds,
                "boundary_claims": st.boundary_claims,
                "cross_steals": st.cross_steals,
                "forced_blocks": st.forced_blocks,
                "phase3_route": st.phase3_route,
                "lookback_scan_launches": launches,
            }
        out["meshes"][str(p)] = {"simulator_phase2_rounds": sim_rounds,
                                 "calls": res}
    out["lookback_scan_launches"] = total_launches
    return out


def run_scan_engine(device, n: int, series_len: int, rounds_n: int) -> dict:
    """``repro_torch.core.engine.scan`` on ``device`` tensors, by dispatch
    and through the ``pallas`` backend's two modes (rounds at ``rounds_n``,
    tiles at ``n``), each call with its launch counts and result checked."""
    from repro_torch.core.deformation import compose_batched
    from repro_torch.core.engine import get_plan, hierarchical, scan
    from repro_torch.data.scan_rows import (
        matmul_compose, orthogonal_matrices, telescoping_bf16,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts

    on_card = device.type == "cuda"
    x = _ints(n, 1, device, seed=5)[:, 0]
    exact = torch.cumsum(x.double(), 0).float()
    seed = torch.tensor(3.0, device=device)
    valid = (torch.arange(n, device=device) % 7) != 3
    valid[:5] = False
    masked = torch.cumsum(torch.where(valid, x, 0.0).double(), 0).float()
    masked[:5] = x[:5]          # before the first valid element: unchanged
    dfm = _deformations(series_len, device, seed=6)
    a64, s64 = _chain64(dfm["angle"], dfm["shift"])
    add = lambda a, b: a + b    # noqa: E731 — an element-domain op
    add.op_batchable = True
    add.op_identity = lambda: torch.zeros((1,), device=device)
    add.kernel_op = "add"
    elems = [x[i : i + 1] for i in range(series_len)]
    xr = x[:rounds_n]
    valid_r = valid[:rounds_n]
    masked_r = _masked_cumsum(xr, valid_r)
    where_r = valid_r.tolist()
    xf = _floats(n, 1, device, seed=16)[:, 0]
    cummax = torch.cummax(xf, 0).values
    # Rows of width 4 over twice rounds_n: on the card a buffer too large
    # for one cluster (the size rule), so a launch a non-empty round.
    xw = _ints(2 * rounds_n, 4, device, seed=17)
    exact_w = torch.cumsum(xw.double(), 0).float()
    # Plans are compiled here, before the timed calls (as a session would
    # hold them): each rounds-mode call that fits a cluster launches
    # fused_plan once, the wide one fused_round once a non-empty round.
    for alg, m, mask in (("ladner_fischer", rounds_n, None),
                         ("ladner_fischer", rounds_n,
                          [not v for v in where_r]),
                         ("blelloch", rounds_n, None)):
        get_plan(alg, m, mask=mask)
    wide = _live_rounds(get_plan("ladner_fischer", 2 * rounds_n))
    plan1 = {"fused_plan": 1}
    tiles = {"tile_local_scan": 1, "tile_apply": 1}
    # bf16 rows (telescoping integers: exact in any grouping) and the
    # matmul entry over 2 x 2 orthogonal matrices, against float64.
    xb, exact_b = (t[:, 0] for t in telescoping_bf16(n, 1, 33,
                                                     device=device))
    xbr, exact_br = (t[:, 0] for t in telescoping_bf16(rounds_n, 1, 34,
                                                       device=device))
    matop = matmul_compose
    mats = orthogonal_matrices(series_len, 2, 35, device=device)
    chain = [mats[0].double()]
    for i in range(1, series_len):
        chain.append(mats[i].double() @ chain[-1])
    mats64 = torch.stack(chain)
    near = lambda y: float((y.double() - mats64).abs().max()) <= MATMUL_TOL  # noqa: E731

    calls = [
        ("decoupled_add", lambda: scan(torch.add, x),
         lambda y: torch.equal(y, exact), {"lookback_scan": 1}),
        ("decoupled_add_seeded",
         lambda: scan(torch.add, x, backend="decoupled", seed=seed),
         lambda y: torch.equal(y, exact + seed), {"lookback_scan": 1}),
        ("decoupled_add_masked", lambda: scan(torch.add, x, where=valid),
         lambda y: torch.equal(y, masked), {"lookback_scan": 1}),
        ("decoupled_compose", lambda: scan(compose_batched, dfm),
         lambda y: bool(_check_vs_chain64(y["angle"], y["shift"], a64, s64,
                                          "scan_engine compose")),
         {"lookback_scan": 1}),
        ("hierarchical_add",
         lambda: scan(torch.add, x, backend="hierarchical"),
         lambda y: torch.equal(y, exact),
         {"tile_local_scan": 1, "tile_apply": 1}),
        ("device_phase1_add", lambda: scan(add, elems, op_cost=1e-6),
         lambda y: torch.equal(torch.cat(y), exact[:series_len])
         and hierarchical.last_stats.device_phase1,
         {"tile_local_scan": 1, "tile_apply": 1}),
        ("pallas_rounds_add",
         lambda: scan(torch.add, xr, backend="pallas",
                      algorithm="ladner_fischer"),
         lambda y: torch.equal(y, exact[:rounds_n]), plan1),
        ("pallas_rounds_add_masked",
         lambda: scan(torch.add, xr, backend="pallas",
                      algorithm="ladner_fischer", where=where_r),
         lambda y: torch.equal(y, masked_r), plan1),
        ("pallas_rounds_add_blelloch",
         lambda: scan(torch.add, xr, backend="pallas", algorithm="blelloch"),
         lambda y: torch.equal(y, exact[:rounds_n]), plan1),
        ("pallas_rounds_add_wide",
         lambda: scan(torch.add, xw, backend="pallas",
                      algorithm="ladner_fischer"),
         lambda y: torch.equal(y, exact_w), {"fused_round": wide}),
        ("pallas_tiles_add_16",
         lambda: scan(torch.add, x, backend="pallas",
                      num_blocks=PALLAS_TILES[0]),
         lambda y: torch.equal(y, exact), tiles),
        ("pallas_tiles_max_4096",
         lambda: scan(torch.maximum, xf, backend="pallas",
                      num_blocks=PALLAS_TILES[1]),
         lambda y: torch.equal(y, cummax), tiles),
        ("decoupled_add_bf16", lambda: scan(torch.add, xb),
         lambda y: torch.equal(y, exact_b), {"lookback_scan": 1}),
        ("pallas_rounds_add_bf16",
         lambda: scan(torch.add, xbr, backend="pallas",
                      algorithm="ladner_fischer"),
         lambda y: torch.equal(y, exact_br), plan1),
        ("pallas_tiles_add_bf16_16",
         lambda: scan(torch.add, xb, backend="pallas",
                      num_blocks=PALLAS_TILES[0]),
         lambda y: torch.equal(y, exact_b), tiles),
        ("decoupled_matmul_2x2", lambda: scan(matop, mats,
                                              backend="decoupled"),
         near, {"lookback_scan": 1}),
        ("pallas_rounds_matmul_2x2",
         lambda: scan(matop, mats, backend="pallas",
                      algorithm="ladner_fischer"),
         near, plan1),
    ]
    out = {"n": n, "rounds_n": rounds_n, "series_len": series_len,
           "calls": {}}
    for name, call, ok, want_launches in calls:
        # Twice: the first call also pays one-time set-up (plans, index
        # tensors, PyTorch's first use of an operator on the device).
        walls = []
        for _ in range(2):
            reset_launch_counts()
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = call()
            if on_card:
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            counts = {k: v for k, v in launch_counts().items() if v}
            if not ok(y):
                raise AssertionError(f"scan_engine {name}: wrong result")
            if on_card and counts != want_launches:
                raise AssertionError(
                    f"scan_engine {name}: launches {counts}, want "
                    f"{want_launches}"
                )
        out["calls"][name] = {"launches": counts, "wall_ms_first": walls[0],
                              "wall_ms_second": walls[1]}
    return out


# The LM serving slice: Zamba2-7B at full width (ArchConfig of
# src/repro_torch/configs/zamba2_7b.py), batch 4, prompts of 512 tokens
# (chunk 128), so the chunk kernels run at G = 4 * 112 * 4 and flash
# attention at BH = 4 * 32, L = 512, d = 112.
LM_BATCH = 4
LM_PROMPT = 512
LM_SHORT_PROMPT = 300        # left-padded to LM_PROMPT
LM_MAX_NEW = 16
LM_MAX_LEN = 1024            # >= prompt + max_new: decode drops later writes
LM_CHECK_LAYERS = 9          # lm_check: 3 superblocks in float32
LM_CHECK_TOL = 2e-2          # tests/test_models.py:99 (prefill logits)
# Whisper's encoder frames in lm_check and the non-causal kernel line: its
# published 1500 fail the kernel's block check (1500 % 256 != 0) in both
# packages, 1024 is the nearest length that passes.
WHISPER_CHECK_FRAMES = 1024
# Kernel checks against the plain versions on the card: float32 at the
# reference's kernel-oracle tolerance (tests/test_kernels.py:58-74, :105).
# In bfloat16 kernel and plain version both accumulate in float32 and round
# once, so they may differ by one bf16 step (at most 2^-7 of the value):
# rtol 8e-3 with atol 1e-3.  Typical outputs are 0.02-0.5, so an error of a
# few percent of the value fails.
BF16_TOL = (8e-3, 1e-3)
CHUNK_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: BF16_TOL}
STATE_TOL = (1e-4, 1e-4)     # the float32 state summaries, both dtypes
FLASH_TOL = {torch.float32: (2e-3, 2e-3), torch.bfloat16: BF16_TOL}


def _lm_shapes():
    from repro_torch.configs import get_config

    cfg = get_config("zamba2-7b")
    chunk = min(cfg.ssm_chunk, LM_PROMPT)
    g = LM_BATCH * cfg.ssm_heads * (LM_PROMPT // chunk)
    return cfg, g, chunk


def _chunk_inputs(g, l, dk, dv, dtype, device, seed, log_a_shift=0.0):
    """The reference's kernel-test inputs (tests/test_kernels.py): c, b
    ~0.3 N(0, 1), v ~0.5 N(0, 1), ca a cumulative sum of
    -softplus(N + log_a_shift).  The shift 0 decays ~0.8 a step, so weights
    vanish ~15 positions below the diagonal; -2 decays ~0.18 a step, as
    Mamba2's dt bias of -2 does, and keeps the far terms and the whole
    state summary in play."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=device)
    c = (rn(g, l, dk) * 0.3).to(dtype)
    b = (rn(g, l, dk) * 0.3).to(dtype)
    v = (rn(g, l, dv) * 0.5).to(dtype)
    log_a = -torch.nn.functional.softplus(rn(g, l) + log_a_shift)
    ca = torch.cumsum(log_a, -1)[..., None]
    return c, b, v, ca


def _close_to(got, want, rtol, atol, what) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: kernel and plain version disagree "
                             f"(max abs err {err}, rtol {rtol}, atol {atol})")
    return err


def _check_chunk_slow_decay(cs, g, l, dk, dv, device) -> dict:
    """Both kernels against their plain versions on slowly decaying inputs
    (log_a_shift -2), bf16 and float32, at the tolerances of the timed
    case; returns the largest errors."""
    errs = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        c, b, v, ca = _chunk_inputs(g, l, dk, dv, dtype, device, seed=23,
                                    log_a_shift=-2.0)
        y_k, s_k = cs.chunk_local_cuda(c, b, v, ca)
        y_p, s_p = cs.chunk_local_reference(c, b, v, ca)
        gen = torch.Generator(device=device).manual_seed(24)
        s_prev = torch.randn((g, dk, dv), generator=gen, device=device)
        o_k = cs.chunk_apply_cuda(c, ca, y_p, s_prev)
        o_p = cs.chunk_apply_reference(c, ca, y_p, s_prev)
        torch.cuda.synchronize()
        rtol, atol = CHUNK_TOL[dtype]
        errs[tag] = {
            "y_intra": _close_to(y_k, y_p, rtol, atol,
                                 f"chunk_local y_intra {tag} slow decay"),
            "state": _close_to(s_k, s_p, *STATE_TOL,
                               f"chunk_local state {tag} slow decay"),
            "chunk_apply": _close_to(o_k, o_p, rtol, max(atol, 1e-4),
                                     f"chunk_apply {tag} slow decay"),
            "max_abs_y_intra": float(y_p.float().abs().max()),
            "ca_end_mean": float(ca[:, -1].mean()),
        }
    return errs


def _chunk_rows(cs, g, l, dk, dv, device) -> tuple:
    """chunk_local's and chunk_apply's rows at (g, l, dk, dv), by dtype:
    held against the plain versions on the reference's fast-decaying
    inputs and on slowly decaying ones, timed beside the plain versions and
    the bounds."""
    slow = _check_chunk_slow_decay(cs, g, l, dk, dv, device)
    local, apply = {}, {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        c, b, v, ca = _chunk_inputs(g, l, dk, dv, dtype, device, seed=20)
        y_k, s_k = cs.chunk_local_cuda(c, b, v, ca)
        y_p, s_p = cs.chunk_local_reference(c, b, v, ca)
        torch.cuda.synchronize()
        rtol, atol = CHUNK_TOL[dtype]
        err_y = _close_to(y_k, y_p, rtol, atol, f"chunk_local y_intra {tag}")
        err_s = _close_to(s_k, s_p, *STATE_TOL, f"chunk_local state {tag}")
        gen = torch.Generator(device=device).manual_seed(21)
        s_prev = torch.randn((g, dk, dv), generator=gen, device=device)
        o_k = cs.chunk_apply_cuda(c, ca, y_p, s_prev)
        o_p = cs.chunk_apply_reference(c, ca, y_p, s_prev)
        torch.cuda.synchronize()
        err_o = _close_to(o_k, o_p, rtol, max(atol, 1e-4), f"chunk_apply {tag}")
        esz = c.element_size()
        tri = l * (l + 1) // 2                 # causal (t, s) pairs
        local_bytes = 3 * g * l * dk * esz + g * l * 4 + g * l * dv * esz \
            + g * dk * dv * 4
        local_ops = g * (2 * tri * dk + 2 * tri * dv + 2 * l * dk * dv)
        apply_bytes = g * l * dk * esz + g * l * 4 + 2 * g * l * dv * esz \
            + g * dk * dv * 4
        apply_ops = g * 2 * l * dk * dv
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        local[tag] = {
            "max_abs_err": err_y, "max_abs_err_state": err_s,
            "mean_abs_out": float(y_p.float().abs().mean()),
            "ms": _time_ms(lambda: cs.chunk_local_cuda(c, b, v, ca)),
            "graph_ms": _graph_ms(lambda: cs.chunk_local_cuda(c, b, v, ca)),
            "plain_ms": _time_ms(lambda: cs.chunk_local_reference(c, b, v, ca),
                                 reps=10),
            **_bound(local_bytes, local_ops, peak),
            "bytes": local_bytes, "flops": local_ops,
        }
        apply[tag] = {
            "max_abs_err": err_o,
            "ms": _time_ms(lambda: cs.chunk_apply_cuda(c, ca, y_p, s_prev)),
            "graph_ms": _graph_ms(
                lambda: cs.chunk_apply_cuda(c, ca, y_p, s_prev)),
            "plain_ms": _time_ms(
                lambda: cs.chunk_apply_reference(c, ca, y_p, s_prev), reps=10),
            **_bound(apply_bytes, apply_ops, peak),
            "bytes": apply_bytes, "flops": apply_ops,
        }
        del c, b, v, ca, y_k, s_k, y_p, s_p, o_k, o_p, s_prev
    return local, apply, slow


def _xlstm_chunk_shape():
    """The mLSTM's chunk kernels in an xlstm-350m prefill: G = batch x heads
    x chunks, L = 128, dk = dv = ssm_head_dim = 256."""
    from repro_torch.configs import get_config

    cfg = get_config("xlstm-350m")
    chunk = min(cfg.ssm_chunk, LM_PROMPT)
    return (LM_BATCH * cfg.n_heads * (LM_PROMPT // chunk), chunk,
            cfg.ssm_head_dim, cfg.ssm_head_dim)


def check_chunk_kernels(device) -> tuple:
    """chunk_local and chunk_apply against their plain versions at
    Zamba2's serving shape (G = 1792, L = 128, dk = dv = 64) and at the
    mLSTM's of xlstm-350m (G = 64, dk = dv = 256), bf16 (the serving
    dtype, timed) and float32 (lm_check's), on the reference's
    fast-decaying inputs and on slowly decaying ones; returns the two
    kernels' lines, the d = 256 rows under "d256"."""
    from repro_torch.kernels import chunk_scan as cs

    cfg, g, l = _lm_shapes()
    dk, dv = cfg.ssm_state, cfg.ssm_head_dim
    local, apply, slow = _chunk_rows(cs, g, l, dk, dv, device)
    wide_shape = _xlstm_chunk_shape()
    wide_local, wide_apply, wide_slow = _chunk_rows(cs, *wide_shape, device)

    def wide(rows, slow):
        head = rows["bf16"]
        return {"shape": list(wide_shape), "dtype": "bf16",
                **{k: head[k] for k in ("max_abs_err", "ms", "graph_ms",
                                        "plain_ms", "bound_ms", "bound_by")},
                "library_ms": None, "f32": rows["f32"],
                "slow_decay_max_abs_err": slow}

    def line(name, replaces, rows, wide_rows):
        head = rows["bf16"]
        return {
            "name": name, "route": "cuda", "source": cs.SOURCE,
            "replaces": replaces, "shape": [g, l, dk, dv], "dtype": "bf16",
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "f32": rows["f32"], "bf16": rows["bf16"],
            "slow_decay_max_abs_err": slow,
            "d256": wide(wide_rows, wide_slow),
        }

    return (line(cs.LOCAL_NAME, cs.LOCAL_REPLACES, local, wide_local),
            line(cs.APPLY_NAME, cs.APPLY_REPLACES, apply, wide_apply))


def _flash_rows(fa, heads, kv_heads, l, d, dtypes, device,
                causal: bool = True) -> dict:
    """flash_attention's rows at a prefill of LM_BATCH x heads, by dtype:
    held against its plain version (causal and not, two block choices),
    timed beside it in the ``causal`` mode given, SDPA on the same tensors
    in that mode and the bound.  With GQA (kv_heads < heads) the kernel
    gets K and V repeated to the query heads, as ops.attention feeds it."""
    bh = LM_BATCH * heads
    rows = {}
    for dtype, tag in dtypes:
        gen = torch.Generator(device=device).manual_seed(22)
        q = (torch.randn((bh, l, d), generator=gen, device=device)
             * 0.5).to(dtype)
        k, v = ((torch.randn((LM_BATCH, kv_heads, l, d), generator=gen,
                             device=device) * 0.5).to(dtype)
                .repeat_interleave(heads // kv_heads, dim=1)
                .reshape(bh, l, d) for _ in range(2))
        err = 0.0
        for held_causal in (True, False):
            for blocks in ((256, 512), (128, 128)):
                kw = {"causal": held_causal, "block_q": blocks[0],
                      "block_k": blocks[1]}
                o_k = fa.flash_attention_cuda(q, k, v, **kw)
                o_p = fa.flash_attention_reference(q, k, v, **kw)
                torch.cuda.synchronize()
                err = max(err, _close_to(o_k, o_p, *FLASH_TOL[dtype],
                                         f"flash_attention {tag} {kw}"))
        q4, k4, v4 = (t.view(LM_BATCH, heads, l, d) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        kern = lambda: fa.flash_attention_cuda(q, k, v, causal=causal)  # noqa: E731
        plain = lambda: fa.flash_attention_reference(q, k, v, causal=causal)  # noqa: E731
        err_sdpa = float((kern().view_as(q4).float()
                          - sdpa(q4, k4, v4, is_causal=causal).float())
                         .abs().max())
        esz = q.element_size()
        pairs = l * (l + 1) // 2 if causal else l * l
        nbytes = 4 * bh * l * d * esz
        ops = bh * 4 * pairs * d        # q k^T and p v over the pairs attended
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        mag = float(plain().float().abs().mean())
        rows[tag] = {
            "max_abs_err": err, "max_abs_err_vs_sdpa": err_sdpa,
            "mean_abs_out": mag, "causal": causal,
            "ms": _time_ms(kern), "graph_ms": _graph_ms(kern),
            "plain_ms": _time_ms(plain, reps=10),
            "library_ms": _time_ms(lambda: sdpa(q4, k4, v4,
                                                is_causal=causal)),
            **_bound(nbytes, ops, peak), "bytes": nbytes, "flops": ops,
        }
        del q, k, v, q4, k4, v4
    return rows


def check_flash_attention(device) -> dict:
    """flash_attention against its plain version at Zamba2's serving shape
    (BH = 128, L = 512, d = 112), bf16 (timed) and float32, and at
    qwen3-32b's (BH = 4 x 64, K and V repeated from 8 heads, d = 128) in
    bf16, under "d128"; SDPA timed beside it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    cfg, _g, _l = _lm_shapes()
    bh, l, d = LM_BATCH * cfg.n_heads, LM_PROMPT, cfg.hd
    rows = _flash_rows(fa, cfg.n_heads, cfg.n_kv_heads, l, d,
                       ((torch.bfloat16, "bf16"), (torch.float32, "f32")),
                       device)
    dense = get_config("qwen3-32b")
    d128 = _flash_rows(fa, dense.n_heads, dense.n_kv_heads, l, dense.hd,
                       ((torch.bfloat16, "bf16"),), device)["bf16"]
    d128.update(shape=[LM_BATCH * dense.n_heads, l, dense.hd], dtype="bf16",
                arch=dense.name, kv_heads=dense.n_kv_heads,
                library_call="F.scaled_dot_product_attention(q, k, v, "
                             f"is_causal=True) on ({LM_BATCH}, "
                             f"{dense.n_heads}, {l}, {dense.hd})")
    # d = 64: InternVL2-1B's decoder (14 query heads over 2, causal, L =
    # 512) and Whisper-base's encoder (8 heads, non-causal, L = 1024, the
    # frames lm_check feeds it; f32 is what lm_check runs).
    vlm = get_config("internvl2-1b")
    d64 = _flash_rows(fa, vlm.n_heads, vlm.n_kv_heads, l, vlm.hd,
                      ((torch.bfloat16, "bf16"),), device)["bf16"]
    d64.update(shape=[LM_BATCH * vlm.n_heads, l, vlm.hd], dtype="bf16",
               arch=vlm.name, kv_heads=vlm.n_kv_heads,
               library_call="F.scaled_dot_product_attention(q, k, v, "
                            f"is_causal=True) on ({LM_BATCH}, "
                            f"{vlm.n_heads}, {l}, {vlm.hd})")
    asr = get_config("whisper-base")
    nc = _flash_rows(fa, asr.n_heads, asr.n_kv_heads, WHISPER_CHECK_FRAMES,
                     asr.hd, ((torch.bfloat16, "bf16"),
                              (torch.float32, "f32")), device, causal=False)
    d64_nc = dict(nc["bf16"])
    d64_nc.update(shape=[LM_BATCH * asr.n_heads, WHISPER_CHECK_FRAMES,
                         asr.hd], dtype="bf16", arch=asr.name,
                  f32=nc["f32"],
                  library_call="F.scaled_dot_product_attention(q, k, v, "
                               f"is_causal=False) on ({LM_BATCH}, "
                               f"{asr.n_heads}, {WHISPER_CHECK_FRAMES}, "
                               f"{asr.hd})")
    head = rows["bf16"]
    return {
        "name": fa.NAME, "route": "cuda", "source": fa.SOURCE,
        "replaces": fa.REPLACES, "shape": [bh, l, d], "dtype": "bf16",
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library_call": "F.scaled_dot_product_attention(q, k, v, "
                        "is_causal=True) on (4, 32, 512, 112)",
        "f32": rows["f32"], "bf16": rows["bf16"], "d128": d128,
        "d64": d64, "d64_noncausal": d64_nc,
    }


# The redesigned kernels' previous designs (flash_attention with the bf16
# products on the f32 CUDA cores; lookback_scan with each thread's strided
# rows read twice and a one-tile-at-a-time walk; fused_round as one launch
# a round of the plan; tile_apply as one thread a row; chunk_local and
# chunk_apply with bf16 staged as float32 and the products on the CUDA
# cores; warp_ncc as a block a tile, its sums folded by PyTorch ops): their
# times as PERF.md records them, used when --previous-csrc does not name
# the sources to build and time them in this run.
PREVIOUS_RECORDED = {
    "flash_attention": {"ms": 0.543, "origin": "PERF.md §6 row 8, the "
                        "previous design (NVIDIA H100 80GB HBM3, 700.00 W)"},
    "lookback_scan": {"ms": 0.313, "origin": "PERF.md §6 row 2, the "
                      "previous design (NVIDIA H100 80GB HBM3, 700.00 W)"},
    "fused_round": {"ms": 0.582, "graph_ms": 0.0361,
                    "origin": "PERF.md §6 row 3, the previous design: 23 "
                    "per-round launches (NVIDIA H100 80GB HBM3, 700.00 W)"},
    "tile_apply": {"ms": 0.0848, "origin": "PERF.md §6 row 5, the previous "
                   "design (NVIDIA H100 80GB HBM3, 700.00 W)"},
    "chunk_local": {"ms": 0.802, "origin": "PERF.md §6 row 6, the previous "
                    "design (NVIDIA H100 80GB HBM3, 700.00 W)"},
    "chunk_apply": {"ms": 0.236, "origin": "PERF.md §6 row 7, the previous "
                    "design (NVIDIA H100 80GB HBM3, 700.00 W)"},
    "warp_ncc": {"ms": 0.0359, "origin": "PERF.md §6 row 1, the previous "
                 "design (NVIDIA H100 80GB HBM3, 700.00 W)"},
}

# The kernels whose previous design --previous-csrc builds (this slice's
# redesigns; the earlier ones are quoted from PERF.md): each one's library
# (csrc/<source>.cu) and the argument types of its C entry <name>_launch.
_PREVIOUS_ENTRIES = {
    # params [angle, shift_y, shift_x], img, ref, warped, sums; h, w, tile.
    "warp_ncc": ("warp_ncc",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p]),
}


def _previous_launch(csrc: str, name: str):
    """Kernel ``name`` built from another checkout's ``csrc`` directory with
    the port's nvcc flags; returns its launch entry point, typed with that
    design's C interface."""
    from repro_torch.kernels import _cuda

    source, argtypes = _PREVIOUS_ENTRIES[name]
    out = os.path.join(_cuda.BUILD_DIR, "previous", f"lib{source}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", out,
                        os.path.join(csrc, f"{source}.cu")], check=True,
                       capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(out), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


# Predecessor tiles whose flags warp 0 reads in one lookback step (one a
# lane; chained_scan.cuh:warp_lookback).
LOOKBACK_STEP_TILES = 32


def _hgmma_count(name: str) -> int:
    """HGMMA (wgmma) instructions in kernel ``name``'s built library."""
    from repro_torch.kernels import _cuda

    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _cuda.library_path(name)],
                          capture_output=True, text=True, check=True).stdout
    return sum(1 for ln in sass.splitlines() if "HGMMA" in ln)


def check_redesigns(device, kw: dict, kfa: dict, kl: dict, kf: dict,
                    ka: dict, kcl: dict, kca: dict,
                    previous_csrc: str = None) -> dict:
    """The redesigned kernels beside their previous designs at the main
    path's shapes: warp_ncc at 1920x1920, tile 32, flash_attention bf16 at
    (128, 512, 112), lookback_scan add at 2^24 x 1, fused_round as
    Ladner-Fischer add at 2^16 x 1 (the whole plan in one fused_plan launch
    against the previous design's launch a round), tile_apply add at 2^24 x
    1 over 16 tiles, and chunk_local and chunk_apply bf16 at (1792, 128,
    64, 64).  With ``previous_csrc`` this slice's previous source
    (warp_ncc) is built, held against the plain version and timed here in
    turns (previous, new, new, previous), through its launch entry and
    replayed from a CUDA graph; else, and for the kernels of earlier slices,
    the previous times are PERF.md's.  The new kernels' correctness is held
    in the check_* phases."""
    from repro_torch.core.engine import get_plan
    from repro_torch.core.engine.pallas_backend import (
        _plan_operands, _round_index_tensors,
    )
    from repro_torch.data.images import lattice_image
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lookback_scan as lb
    from repro_torch.kernels import tile_scan as ts
    from repro_torch.kernels import warp_ncc as wn
    from repro_torch.kernels._tiling import (
        default_num_tiles_cuda, plan_cluster_size,
    )

    cfg, g, cl = _lm_shapes()
    bh, l, d = LM_BATCH * cfg.n_heads, LM_PROMPT, cfg.hd
    gen = torch.Generator(device=device).manual_seed(22)
    q, k, v = ((torch.randn((bh, l, d), generator=gen, device=device)
                * 0.5).to(torch.bfloat16) for _ in range(3))
    n = SCAN_N
    t = default_num_tiles_cuda(n)
    x = _ints(n, 1, device, seed=1)
    rn = ROUNDS_N
    plan = get_plan("ladner_fischer", rn)
    rounds = sum(src is not None
                 for src in _round_index_tensors(plan, device))
    po = _plan_operands(plan, device, plan_cluster_size(rn, 1))
    xr = _ints(rn, 1, device, seed=12)
    at = TILE_COUNTS[0]
    ploc, pparts = ts.tile_local_scan_reference(torch.add, x, at)
    seeds = torch.cat([pparts[:1], torch.cumsum(pparts, 0)[:-1]])
    dk, dv = cfg.ssm_state, cfg.ssm_head_dim
    cc, cb, cv, cca = _chunk_inputs(g, cl, dk, dv, torch.bfloat16, device,
                                    seed=20)
    cy, _ = cs.chunk_local_reference(cc, cb, cv, cca)
    gen = torch.Generator(device=device).manual_seed(21)
    csp = torch.randn((g, dk, dv), generator=gen, device=device)
    # warp_ncc through its C entry (the previous design's is timed the same
    # way), on one frame pair, and on four (177 MB with the warped images,
    # past the 50 MB L2: each launch finds its frames cold, as a guess check
    # of a series does).
    frames = [lattice_image(SIZE, seed=i, device=device) for i in range(5)]
    img, ref = frames[0], frames[1]
    wa = torch.tensor(0.07, device=device)
    ws = torch.tensor((1.5, 0.7), device=device)
    n_tiles = (SIZE // 32) ** 2
    warp_entry, _ = wn._launcher()

    def new_warp(tmpl=img, ref=ref):
        warped = torch.empty_like(tmpl)
        sums = torch.empty((n_tiles, 8), device=device)
        err = warp_entry(wa.data_ptr(), ws.data_ptr(), tmpl.data_ptr(),
                         ref.data_ptr(), warped.data_ptr(), sums.data_ptr(),
                         None, SIZE, SIZE, 32,
                         torch.cuda.current_stream(device).cuda_stream)
        assert err == 0, err
        return warped, sums

    new = {"warp_ncc": new_warp,
           "flash_attention": lambda: fa.flash_attention_cuda(q, k, v),
           "lookback_scan": lambda: lb.lookback_scan_cuda(torch.add, x, t),
           "fused_round": lambda: ts.fused_plan_cuda(torch.add, xr, po)[0],
           "tile_apply": lambda: ts.tile_apply_cuda(torch.add, ploc, seeds),
           "chunk_local": lambda: cs.chunk_local_cuda(cc, cb, cv, cca),
           "chunk_apply": lambda: cs.chunk_apply_cuda(cc, cca, cy, csp)}
    previous = {}
    if previous_csrc:
        pw = _previous_launch(previous_csrc, "warp_ncc")
        params = torch.cat([wa.reshape(1), ws])

        def prev_warp(tmpl=img, ref=ref):
            warped = torch.empty_like(tmpl)
            sums = torch.empty((n_tiles, 8), device=device)
            err = pw(params.data_ptr(), tmpl.data_ptr(), ref.data_ptr(),
                     warped.data_ptr(), sums.data_ptr(), SIZE, SIZE, 32,
                     torch.cuda.current_stream(device).cuda_stream)
            assert err == 0, err
            return warped, sums

        previous = {"warp_ncc": prev_warp}
        # The previous kernel computes the same function.
        w_o, s_o = prev_warp()
        w_p, s_p = wn.warp_ncc_sums_reference(img, ref, wa, ws)
        _close_to(w_o, w_p, WARP_RTOL, WARP_ATOL, "previous warp_ncc")
        dn = float((wn.fold(s_o) - wn.fold(s_p)).abs())
        if not dn <= NCC_ATOL:
            raise AssertionError(f"previous warp_ncc ncc disagrees: {dn}")
    rows = {"warp_ncc": kw, "flash_attention": kfa, "lookback_scan": kl,
            "fused_round": kf, "tile_apply": ka, "chunk_local": kcl,
            "chunk_apply": kca}
    out = {}
    for name, fn in new.items():
        if name in previous:
            runs = [_time_ms(previous[name]), _time_ms(fn), _time_ms(fn),
                    _time_ms(previous[name])]
            ms = min(runs[1], runs[2])
            prev = {"previous_ms": min(runs[0], runs[3]),
                    "previous_graph_ms": _graph_ms(previous[name]),
                    "previous_origin": "built from --previous-csrc and "
                                       "timed in this run",
                    "turns_ms": runs}
        else:
            ms = _time_ms(fn)
            rec = PREVIOUS_RECORDED[name]
            prev = {"previous_ms": rec["ms"],
                    "previous_origin": rec["origin"]}
            if "graph_ms" in rec:
                prev["previous_graph_ms"] = rec["graph_ms"]
        row = rows[name]
        out[name] = {"ms": ms, "graph_ms": _graph_ms(fn), **prev,
                     "library_ms": row["library_ms"],
                     "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                     "speedup_vs_previous": prev["previous_ms"] / ms}
    cold = {"new": lambda: [new_warp(frames[i], frames[i + 1])
                            for i in range(4)]}
    if previous_csrc:
        cold["previous"] = lambda: [previous["warp_ncc"](frames[i],
                                                         frames[i + 1])
                                    for i in range(4)]
    turns = [name for name in ("previous", "new", "new", "previous")
             if name in cold]
    cold_ms = {}
    for name in turns:
        cold_ms.setdefault(name, []).append(_graph_ms(cold[name]) / 4)
    out["warp_ncc"].update(
        shape=[SIZE, SIZE], tile=32,
        graph_ms_cold=min(cold_ms["new"]), cold_turns_ms=cold_ms,
        timing="ms, previous_ms: through the C entries back to back, one "
               "frame pair (the wrapper's time is kernel warp_ncc's ms); "
               "graph_ms, previous_graph_ms: from a CUDA graph; "
               "graph_ms_cold: a launch on each of four pairs from a graph, "
               "over 4 (frames cold in L2)")
    if "previous" in cold_ms:
        out["warp_ncc"]["previous_graph_ms_cold"] = min(cold_ms["previous"])
    out["flash_attention"].update(shape=[bh, l, d], dtype="bf16",
                                  hgmma_in_sass=_hgmma_count(fa.NAME))
    out["lookback_scan"].update(
        shape=[n, 1], tiles=t, walk_tiles_max=kl["walk_steps_max"],
        walk_warp_steps_max=-(-kl["walk_steps_max"] // LOOKBACK_STEP_TILES))
    out["fused_round"].update(
        shape=[rn, 1], circuit="ladner_fischer", rounds=rounds,
        cluster=po.cluster, kernel="fused_plan (one launch; previous: "
        "fused_round, a launch a round)",
        bound_ms=kf["plan_bound_ms"], bound_by=kf["plan_bound_by"],
        round_bound_ms=kf["bound_ms"])
    out["tile_apply"].update(shape=[n, 1], tiles=at)
    hgmma_chunk = _hgmma_count(cs.LIBRARY)
    for name in ("chunk_local", "chunk_apply"):
        out[name].update(shape=[g, cl, dk, dv], dtype="bf16",
                         hgmma_in_sass=hgmma_chunk)
    return out


def _lm_config(smoke: bool, arch: str = "zamba2-7b", **kw):
    from dataclasses import replace

    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if smoke else get_config)(arch)
    return replace(cfg, **kw)


def _want_prefill_launches(cfg) -> dict:
    """The LM kernels a prefill of ``cfg`` launches: flash_attention once
    an attention or MoE block and once an encoder layer (those also count
    as flash_attention_noncausal), chunk_local and chunk_apply once a
    Mamba2 or mLSTM block (the sLSTM runs none; the cross-attention takes
    the plain path); none on the "xla" backends."""
    want = {}
    attn = ("flash_attention",) if cfg.attn_backend == "pallas" else ()
    enc = attn + ("flash_attention_noncausal",) if attn else ()
    ssm = (("chunk_local", "chunk_apply") if cfg.ssm_backend == "pallas"
           else ())
    for kind in cfg.block_pattern:
        names = {"attn": attn, "shared_attn": attn, "moe": attn,
                 "mamba2": ssm, "mlstm": ssm}.get(kind, ())
        for name in names:
            want[name] = want.get(name, 0) + cfg.n_super
    for name in enc if cfg.encoder_layers else ():
        want[name] = want.get(name, 0) + cfg.encoder_layers
    return want


def _free_device(device) -> None:
    """Return the caching allocator's free blocks to the card, so the next
    model's weights fit."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _logit_gap(a, b) -> dict:
    a, b = a.float(), b.float()
    return {"max_abs_gap": float((a - b).abs().max()),
            "max_abs_logit": float(b.abs().max()),
            "top1_agree": float((a.argmax(-1) == b.argmax(-1)).float().mean())}


# lm_serve's models: Zamba2-7B, then the other configurations at full
# width and depth, but those whose bf16 weights outgrow the 80 GB card at
# a cut depth: qwen2-72b at 16 of 80 layers, phi3.5-moe at 28 of 32,
# arctic at 2 of 35.
LM_SERVE_ARCHS = ("codeqwen1.5-7b", "internlm2-20b", "qwen3-32b",
                  "qwen2-72b", "xlstm-350m", "phi3.5-moe-42b-a6.6b",
                  "arctic-480b", "internvl2-1b", "whisper-base")
_MULTI_DEVICE = "full depth waits for LM multi-device (ROADMAP.md Queue 1)"
LM_SERVE_CUT = {
    "qwen2-72b": (16, "145 GB of bf16 weights at 80 layers against one "
                      "80 GB card; " + _MULTI_DEVICE),
    "phi3.5-moe-42b-a6.6b": (28, "83.7 GB of bf16 weights at 32 layers "
                                 "against one 80 GB card (28 layers: 73.3 "
                                 "GB); " + _MULTI_DEVICE),
    "arctic-480b": (2, "954 GB of bf16 weights at 35 layers (27.2 GB a "
                       "layer) against one 80 GB card; " + _MULTI_DEVICE),
}
VLM_SHORT_PROMPT = 150       # left-padded behind the patches
WHISPER_PROMPT = 4           # decoder prompts, padded to 8 by serve_batch


def _serve_prompts(cfg) -> list:
    """The prompt lengths ``cfg`` is served with: LM_PROMPT x 3 and
    LM_SHORT_PROMPT; behind a patch prefix, text that fills LM_PROMPT
    positions with it (InternVL2's 256 patches + 256 tokens: 768 positions
    would fail the kernel's block check, as in the reference); short
    decoder prompts for an encoder-decoder config."""
    if cfg.frontend == "patch":
        return [LM_PROMPT - cfg.frontend_len] * (LM_BATCH - 1) + [
            VLM_SHORT_PROMPT]
    if cfg.encoder_layers:
        return [WHISPER_PROMPT] * LM_BATCH
    return [LM_PROMPT] * (LM_BATCH - 1) + [LM_SHORT_PROMPT]

# Served on its registry config (the "xla" backends), as the reference's
# Server serves it: its 1500 frames fail the kernel's block check in both
# packages.
LM_SERVE_REGISTRY = {"whisper-base": "1500 encoder frames fail the flash "
                                     "kernel's block check (1500 % 256 != "
                                     "0) in both packages; served on the "
                                     "registry's \"xla\" backends, as the "
                                     "reference's Server serves it"}


def run_lm_serve(device, smoke: bool = False,
                 arch: str = "zamba2-7b") -> dict:
    """``repro_torch.launch.serve.Server`` on ``arch`` (at full width and
    depth unless LM_SERVE_CUT cuts it), the kernel backends passed in
    through ``acfg``: 4 requests (three 512-token prompts, one of 300
    left-padded to 512), 16 new tokens each, bf16 weights from a seeded
    generator on the device.  The init's seconds and peak memory, then
    the serves' peak; launch counts are read around the prefill and around
    the decode; the same prefill through the "xla" backends is compared as
    a finding."""
    from repro_torch.core._tree import tensor_leaves
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import Request, ServeConfig, Server
    from repro_torch.models import lm

    layers, why = LM_SERVE_CUT.get(arch, (None, None)) if not smoke \
        else (None, None)
    cut = {"n_layers": layers} if layers else {}
    registry_why = LM_SERVE_REGISTRY.get(arch)
    backends = ({} if registry_why else
                {"attn_backend": "pallas", "ssm_backend": "pallas"})
    cfg = _lm_config(smoke, arch, **backends, **cut)
    prompt_lens = _serve_prompts(cfg)
    on_card = device.type == "cuda"
    if on_card:
        _free_device(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    srv = Server(ServeConfig(arch=arch, smoke=smoke,
                             max_batch=LM_BATCH, max_len=LM_MAX_LEN,
                             eos_id=None), device=device, acfg=cfg)
    _sync(device)
    init_s = time.perf_counter() - t0
    leaves = tensor_leaves(srv.params)
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    init_peak = None
    if on_card:
        init_peak = torch.cuda.max_memory_allocated(device) - base
        torch.cuda.reset_peak_memory_stats(device)

    seen = {"logits": [], "batch": None, "prefill": None}
    prefill_step, decode_step = srv._prefill, srv._decode

    def prefill(params, batch, states):
        seen["batch"] = batch
        _sync(device)
        reset_launch_counts()
        out = prefill_step(params, batch, states)
        _sync(device)
        seen["prefill"] = {k: v for k, v in launch_counts().items() if v}
        reset_launch_counts()
        seen["logits"].append(out[0])
        return out

    def decode(params, tok, pos, states):
        out = decode_step(params, tok, pos, states)
        seen["logits"].append(out[0])
        return out

    srv._prefill, srv._decode = prefill, decode
    rng = np.random.default_rng(0)
    runs = []
    for _ in range(2):   # the first run is the counted one; both are checked
        reqs = [Request(i, rng.integers(2, cfg.vocab_size, n, dtype=np.int32),
                        max_new=LM_MAX_NEW)
                for i, n in enumerate(prompt_lens)]
        seen["logits"].clear()
        reset_launch_counts()
        stats = srv.serve_batch(reqs)
        decode_counts = {k: v for k, v in launch_counts().items() if v}
        bad = [i for i, lg in enumerate(seen["logits"])
               if not bool(torch.isfinite(lg).all())]
        if bad:
            raise AssertionError(f"lm_serve: non-finite logits in steps {bad}")
        if not all(len(r.output) == LM_MAX_NEW for r in reqs):
            raise AssertionError("lm_serve: a request got the wrong length")
        runs.append({**stats, "prefill_launches": seen["prefill"],
                     "decode_launches": decode_counts,
                     "outputs_head": [r.output[:4] for r in reqs]})
    peak_memory = torch.cuda.max_memory_allocated(device) if on_card else None
    want = _want_prefill_launches(cfg)
    if on_card:
        for run in runs:
            if run["prefill_launches"] != want or run["decode_launches"]:
                raise AssertionError(
                    f"lm_serve {arch} launches: prefill "
                    f"{run['prefill_launches']} "
                    f"(want {want}), decode {run['decode_launches']} (want none)")

    # Where the time of one prefill and one decode step goes on the card.
    prefix, _ = srv._init_states(1)
    positions = prefix + seen["batch"]["tokens"].shape[1]
    cache_len = prefix + LM_MAX_LEN
    profile = None
    if on_card:
        profile = {}
        states = lm.init_decode_states(cfg, LM_BATCH, cache_len, device=device)
        with torch.no_grad():
            profile["prefill"], (logits, states) = _profile(
                device, lambda: lm.prefill(srv.params, cfg, seen["batch"],
                                           states))
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            profile["decode_step"], _ = _profile(
                device, lambda: lm.decode_step(srv.params, cfg, tok,
                                               positions, states))
        del states, logits

    # The same prefill through the plain "xla" backends: a finding.
    xcfg = _lm_config(smoke, arch, attn_backend="xla", ssm_backend="xla",
                      **cut)
    states = lm.init_decode_states(xcfg, LM_BATCH, cache_len, device=device)
    with torch.no_grad():
        xl, _ = lm.prefill(srv.params, xcfg, seen["batch"], states)
    # ... and through the kernels' plain versions ("pallas_interpret"),
    # which round y_intra where the kernels do: the kernels' own share of
    # the gap is their distance to these.  A config served on "xla" has
    # none (the plain versions keep the kernels' block check).
    pl = None
    if not registry_why:
        pcfg = _lm_config(smoke, arch, attn_backend="pallas_interpret",
                          ssm_backend="pallas_interpret", **cut)
        states = lm.init_decode_states(pcfg, LM_BATCH, cache_len,
                                       device=device)
        with torch.no_grad():
            pl, _ = lm.prefill(srv.params, pcfg, seen["batch"], states)
        del states
    gap = _logit_gap(seen["logits"][0], xl)
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "reduced": ({"n_layers": [layers, _lm_config(smoke, arch).n_layers],
                     "why": why} if layers else None),
        "params": n_params, "param_count_analytic": cfg.param_count(),
        "weight_bytes": weight_bytes,
        "dtype": cfg.param_dtype, "batch": LM_BATCH,
        "prompts": prompt_lens, "frontend_prefix": prefix,
        "positions": positions,
        "backends": {"attn": cfg.attn_backend, "ssm": cfg.ssm_backend},
        "no_kernel_why": registry_why,
        "flash_launches_prefill": runs[0]["prefill_launches"].get(
            "flash_attention", 0),
        "max_new": LM_MAX_NEW, "max_len": LM_MAX_LEN, "init_s": init_s,
        "init_max_memory_allocated": init_peak,
        "prefill_s": runs[0]["prefill_s"], "decode_s": runs[0]["decode_s"],
        "tokens_per_s": runs[0]["tokens_per_s"],
        "prefill_launches": runs[0]["prefill_launches"],
        "decode_launches": runs[0]["decode_launches"],
        "second_run": {k: runs[1][k] for k in
                       ("prefill_s", "decode_s", "tokens_per_s",
                        "prefill_launches", "decode_launches")},
        "outputs_head": runs[0]["outputs_head"],
        "prefill_vs_xla": gap,
        "prefill_plain_vs_xla": None if pl is None else _logit_gap(pl, xl),
        "prefill_vs_plain": (None if pl is None
                             else _logit_gap(seen["logits"][0], pl)),
        "max_memory_allocated": peak_memory,   # over the two serves
        "profile": profile,
    }
    if on_card and init_peak > weight_bytes + 2e9:
        raise AssertionError(f"lm_serve {arch}: init peak {init_peak} B "
                             f"above the weights ({weight_bytes} B) + 2 GB")
    del srv, seen, xl, pl
    _free_device(device)
    return out


_KERNEL_GROUPS = (("chunk_local", "chunk_local_bf16_kernel"),
                  ("chunk_local", "chunk_local_f32_kernel"),
                  ("chunk_apply", "chunk_apply_bf16_kernel"),
                  ("chunk_apply", "chunk_apply_f32_kernel"),
                  ("flash_attention", "flash_bf16_kernel"),
                  ("flash_attention", "flash_f32_kernel"))


def _kernel_group(name: str) -> str:
    for group, key in _KERNEL_GROUPS:
        if key in name:
            return group
    low = name.lower()
    # cuBLAS's kernels: "nvjet_*" (its JIT kernels on Hopper), gemm, gemv.
    if any(key in low for key in ("nvjet", "gemm", "gemv", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, reductions)"


def _profile(device, fn) -> tuple:
    """``fn()`` once under ``torch.profiler``: its wall ms, the device's
    kernel ms by group and the top kernels, and the device's idle share of
    the wall time (1 - kernel time / wall time).  The device events are
    summed from the trace's raw events: ``key_averages()`` would build a
    Python object for each of the ~10^6 CPU and device events of a train
    step first (~50 s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        ms, n = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    groups = {}
    for name, (ms, _) in by_name.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    device_ms = sum(groups.values())
    kernels = sorted(((ms, n, name[:80]) for name, (ms, n) in by_name.items()),
                     reverse=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": (1.0 - device_ms / wall_ms) if wall_ms else None,
            "device_launches": sum(n for _, n in by_name.values()),
            "device_ms_by_group": groups,
            "top_kernels": [{"ms": ms, "count": n, "name": k}
                            for ms, n, k in kernels[:8]]}, out


def run_lm_check(device, smoke: bool = False, arch: str = "zamba2-7b",
                 layers: int = LM_CHECK_LAYERS) -> dict:
    """``arch`` at full width in float32 (Zamba2-7B at 3 superblocks;
    ``layers=None``: full depth), batch 2, prompt 512: prefill logits (and
    the teacher-forced logits of every position) through the kernels
    against the "xla" path, gated at LM_CHECK_TOL.  An encoder-decoder
    config also gets seeded frames (WHISPER_CHECK_FRAMES of them at full
    size); the flash wrapper counts its non-causal launches (the
    encoder's) apart, so the one prefill gives both the encoder's and the
    decoder's (causal) counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm

    layers = None if smoke else layers
    kw = dict(param_dtype="float32", compute_dtype="float32",
              cache_dtype="float32")
    if layers:
        kw["n_layers"] = layers
    reduced = None
    if _lm_config(smoke, arch).encoder_layers and not smoke:
        kw["frontend_len"] = WHISPER_CHECK_FRAMES
        reduced = {"frontend_len": [WHISPER_CHECK_FRAMES,
                                    _lm_config(False, arch).frontend_len],
                   "why": LM_SERVE_REGISTRY.get(arch)}
    cfg = _lm_config(smoke, arch, attn_backend="pallas",
                     ssm_backend="pallas", **kw)
    xcfg = _lm_config(smoke, arch, attn_backend="xla", ssm_backend="xla",
                      **kw)
    params = lm.init_params(torch.Generator(device=device).manual_seed(1), cfg)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, LM_PROMPT)),
                             dtype=torch.long, device=device)
    batch = {"tokens": tokens}
    if cfg.encoder_layers:
        batch["frames"] = torch.as_tensor(
            rng.standard_normal((2, cfg.frontend_len, cfg.d_model)) * 0.1,
            dtype=torch.float32, device=device)
    with torch.no_grad():
        _sync(device)
        reset_launch_counts()
        lk, _ = lm.prefill(params, cfg, batch,
                           lm.init_decode_states(cfg, 2, LM_PROMPT, device))
        _sync(device)
        counts = {k: v for k, v in launch_counts().items() if v}
        lx, _ = lm.prefill(params, xcfg, batch,
                           lm.init_decode_states(xcfg, 2, LM_PROMPT, device))
        fk, _ = lm.forward_train(params, cfg, batch)
        fx, _ = lm.forward_train(params, xcfg, batch)
    if device.type == "cuda":
        want = _want_prefill_launches(cfg)
        if counts != want:
            raise AssertionError(f"lm_check {arch} launches {counts}, want "
                                 f"{want}")
    for got, ref, what in ((lk, lx, "prefill"), (fk, fx, "forward")):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"lm_check: non-finite {what} logits")
        if not torch.allclose(got, ref, rtol=LM_CHECK_TOL, atol=LM_CHECK_TOL):
            raise AssertionError(
                f"lm_check {arch} {what}: kernels vs xla gap "
                f"{float((got - ref).abs().max())} > {LM_CHECK_TOL}")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": "float32", "batch": 2, "prompt": LM_PROMPT,
           "tol": LM_CHECK_TOL, "prefill_launches": counts,
           "reduced": reduced}
    if cfg.encoder_layers:
        enc = counts.get("flash_attention_noncausal", 0)
        out.update(encoder_layers=cfg.encoder_layers,
                   frames=cfg.frontend_len,
                   flash_noncausal_launches=enc,
                   flash_causal_launches=counts.get("flash_attention", 0) - enc)
    out.update(prefill_vs_xla=_logit_gap(lk, lx),
               forward_vs_xla=_logit_gap(fk, fx))
    del params, lk, lx, fk, fx
    _free_device(device)
    return out


# train xlstm-350m: the reference's default arch at full width and depth
# through train() itself, with one injected failure between checkpoints.
# The lr is 10x the reference's loss test's 3e-3 (tests/test_system.py:19):
# the step's cosine warmup (100 steps from 0, steps.py) keeps 3e-3 below
# 4.5e-4 for 16 steps, and at full width the loss did not move (11.315 ->
# 11.316 over the first and last four steps, H100); at 3e-2 it falls by
# 0.12 (PERF.md, §6).
TRAIN_ARCH = "xlstm-350m"
TRAIN_STEPS = 16
TRAIN_BATCH = 8
TRAIN_SEQ = 256
TRAIN_LR = 3e-2
TRAIN_SAVE_EVERY = 8
TRAIN_FAIL_AT = (10,)
# train phi3.5-moe-42b: full width at 2 of 32 layers, make_train_step alone.
MOE_TRAIN_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 4
MOE_TRAIN_WHY = ("AdamW's float32 master, m and v beside the bf16 params "
                 "and grads: 16 bytes a parameter, ~670 GB at 32 layers "
                 "(41.9 B parameters) against one 80 GB card; "
                 + _MULTI_DEVICE)
# train_check: the card against the CPU, xLSTM-350M at full width, 4 layers
# (one superblock), float32, batch 2 x 128, three steps.
CHECK_TRAIN_LAYERS = 4
CHECK_TRAIN_BATCH = 2
CHECK_TRAIN_SEQ = 128
CHECK_TRAIN_STEPS = 3
# The CPU rehearsal's sequences: the smoke models' losses fall within 16
# steps at 16 tokens, and the sLSTM's per-token loop stays short.
REHEARSAL_SEQ = 16
CHECK_LOSS_RTOL = 1e-4
CHECK_GNORM_RTOL = 1e-3
CHECK_PARAM_ATOL = 1e-4      # tests/test_substrate.py:210-212 (a train step)


def _no_launches(what: str) -> dict:
    """The kernel counts since the last reset; training reaches no kernel
    (the reference's trains on "xla" through XLA), so any launch means a
    path went around the autograd guard."""
    from repro_torch.kernels import launch_counts

    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{what}: kernels launched while training: "
                             f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def _finite(xs, what: str) -> None:
    if not all(math.isfinite(x) for x in xs):
        raise AssertionError(f"{what}: non-finite values {xs}")


def _leaves(tree) -> list:
    from repro_torch.core._tree import tree_leaves

    return tree_leaves(tree)


def _train_batch(cfg, batch: int, seq: int, step: int, device) -> dict:
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline

    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        global_batch=batch, seq_len=seq))
    return {k: torch.as_tensor(v, dtype=torch.long, device=device)
            for k, v in pipe.batch_at(step).items()}


def run_train(device, smoke: bool = False) -> dict:
    """``repro_torch.launch.train.train`` on xLSTM-350M (24 blocks, d 1024,
    bf16; its smoke config in a rehearsal): TRAIN_STEPS steps of 8 x 256
    tokens from the port's TokenPipeline, checkpoints every 8 steps (bf16
    params, float32 AdamW state), a failure injected at step 10, so the
    run restores step 8 and replays 8-9.  Then one more step of the same
    model profiled.  Gates: finite losses, the last four below the first
    four, one restart, 16 steps, and no kernel launched."""
    import shutil
    import tempfile

    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    seq = REHEARSAL_SEQ if smoke else TRAIN_SEQ
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cfg_t = TrainConfig(arch=TRAIN_ARCH, smoke=smoke, steps=TRAIN_STEPS,
                        batch=TRAIN_BATCH, seq_len=seq, lr=TRAIN_LR,
                        save_every=TRAIN_SAVE_EVERY, fail_at=TRAIN_FAIL_AT,
                        ckpt_dir=ckpt_dir, log_every=4, device=str(device))
    on_card = device.type == "cuda"
    _free_device(device)
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        # train()'s progress lines go to stderr: stdout holds result lines.
        with contextlib.redirect_stdout(sys.stderr):
            out = train(cfg_t)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    _sync(device)
    wall_s = time.perf_counter() - t0
    counts = _no_launches("train")
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    by_step, first_run, gnorm_by_step = {}, {}, {}
    for step, loss, gnorm in zip(out["loss_steps"], out["losses"],
                                 out["grad_norms"]):
        if step in by_step:
            first_run[step] = by_step[step]
        by_step[step] = loss
        gnorm_by_step[step] = gnorm
    losses = [by_step[i] for i in range(TRAIN_STEPS)]
    grad_norms = [gnorm_by_step[i] for i in range(TRAIN_STEPS)]
    replay_diff = max((abs(by_step[i] - first_run[i]) for i in first_run),
                      default=None)
    _finite(out["losses"], "train")
    head, tail = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    if not tail < head:
        raise AssertionError(f"train: loss did not fall ({head} -> {tail})")
    if out["restarts"] != 1 or out["steps"] != TRAIN_STEPS:
        raise AssertionError(f"train: restarts {out['restarts']}, steps "
                             f"{out['steps']}")
    acfg = _lm_config(smoke, TRAIN_ARCH)

    # One step of the same model, profiled, after a warm-up step.
    params = lm.init_params(torch.Generator(device=device).manual_seed(0),
                            acfg)
    opt = adamw.init(params, adamw.AdamWConfig(lr=TRAIN_LR))
    step_fn = steps.make_train_step(acfg, adamw.AdamWConfig(lr=TRAIN_LR))
    batch = _train_batch(acfg, TRAIN_BATCH, seq, 0, device)
    step_fn(params, opt, batch)
    profile = None
    if on_card:
        profile, _ = _profile(device, lambda: step_fn(params, opt, batch))
        profile.pop("top_kernels")
    n_params = sum(t.numel() for t in _leaves(params))
    del params, opt
    _free_device(device)
    mean_s = out["mean_step_s"]
    return {
        "arch": acfg.name, "layers": acfg.n_layers, "d_model": acfg.d_model,
        "dtype": acfg.param_dtype, "params": n_params,
        "batch": TRAIN_BATCH, "seq_len": seq, "lr": TRAIN_LR,
        "steps": out["steps"], "restarts": out["restarts"],
        "save_every": TRAIN_SAVE_EVERY, "fail_at": list(TRAIN_FAIL_AT),
        "losses": losses, "grad_norms": grad_norms,
        "loss_steps_run": out["loss_steps"],
        "losses_run": out["losses"],
        "replay_max_abs_diff": replay_diff,
        "mean_first4": head, "mean_last4": tail,
        "step_s": out["step_s"], "mean_step_s": mean_s,
        "tokens_per_s": (TRAIN_BATCH * seq / mean_s) if mean_s else None,
        "wall_s": wall_s, "max_memory_allocated": peak,
        "checkpoint_save_s": out["checkpoint"]["save"],
        "checkpoint_write_s": out["checkpoint"]["write"],
        "checkpoint_restore_s": out["checkpoint"]["restore"],
        "checkpoint_bytes": out["checkpoint"]["bytes"],
        "launches": counts, "profile_one_step": profile,
    }


def run_train_moe(device, smoke: bool = False) -> dict:
    """``steps.make_train_step`` on phi3.5-moe-42b at full width and
    MOE_TRAIN_LAYERS of 32 layers (its smoke config in a rehearsal), bf16,
    MOE_TRAIN_STEPS steps of 8 x 256 tokens, no checkpoints: the MoE
    block's backward (capacity routing, the one-hot dispatch einsums, the
    aux loss) and GQA attention's at full width.  Gates: finite numbers, a
    peak under the card's memory, no kernel launched."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cut = {} if smoke else {"n_layers": MOE_TRAIN_LAYERS}
    cfg = _lm_config(smoke, MOE_TRAIN_ARCH, **cut)
    seq = REHEARSAL_SEQ if smoke else TRAIN_SEQ
    on_card = device.type == "cuda"
    _free_device(device)
    _sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    opt = adamw.init(params)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    step_fn = steps.make_train_step(cfg)
    reset_launch_counts()
    step_s, metrics = [], []
    for i in range(MOE_TRAIN_STEPS):
        batch = _train_batch(cfg, TRAIN_BATCH, seq, i, device)
        _sync(device)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = _no_launches("train moe")
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    for m in metrics:
        _finite(list(m.values()), "train moe")
    if on_card:
        total = torch.cuda.get_device_properties(device).total_memory
        if not peak < total:
            raise AssertionError(f"train moe: peak {peak} B >= {total} B")
    del params, opt
    _free_device(device)
    return {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_experts": cfg.n_experts, "top_k": cfg.top_k,
        "reduced": (None if smoke else {
            "n_layers": [MOE_TRAIN_LAYERS,
                         _lm_config(False, MOE_TRAIN_ARCH).n_layers],
            "why": MOE_TRAIN_WHY}),
        "dtype": cfg.param_dtype, "params": n_params,
        "batch": TRAIN_BATCH, "seq_len": seq, "init_s": init_s,
        "step_s": step_s,
        "mean_step_s_after_first": float(np.mean(step_s[1:])),
        "metrics": metrics, "max_memory_allocated": peak,
        "card_memory": (torch.cuda.get_device_properties(device).total_memory
                        if on_card else None),
        "launches": counts,
    }


def run_train_check(device, smoke: bool = False) -> dict:
    """The port's train step on ``device`` against the same step on the
    CPU: xLSTM-350M at full width and CHECK_TRAIN_LAYERS layers in float32
    (its smoke config in a rehearsal), batch 2 x 128, three steps from the
    same seeded params (drawn on the CPU, carried to the device with
    ``interop.params_from_numpy``).  Gates: each step's loss within
    CHECK_LOSS_RTOL, grad norm within CHECK_GNORM_RTOL, params after the
    third step within CHECK_PARAM_ATOL."""
    from repro_torch.core._tree import tree_map
    from repro_torch.interop import params_from_numpy, to_numpy
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    kw = dict(param_dtype="float32", compute_dtype="float32",
              cache_dtype="float32")
    if not smoke:
        kw["n_layers"] = CHECK_TRAIN_LAYERS
    cfg = _lm_config(smoke, TRAIN_ARCH, **kw)
    cpu = torch.device("cpu")
    p_cpu = lm.init_params(torch.Generator().manual_seed(3), cfg)
    start = to_numpy(tree_map(torch.clone, p_cpu))   # the step is in place
    p_dev = params_from_numpy(start, device=device)
    o_cpu, o_dev = adamw.init(p_cpu), adamw.init(p_dev)
    step_fn = steps.make_train_step(cfg)
    seq = REHEARSAL_SEQ if smoke else CHECK_TRAIN_SEQ
    rows = []
    for i in range(CHECK_TRAIN_STEPS):
        p_cpu, o_cpu, m_cpu = step_fn(p_cpu, o_cpu, _train_batch(
            cfg, CHECK_TRAIN_BATCH, seq, i, cpu))
        p_dev, o_dev, m_dev = step_fn(p_dev, o_dev, _train_batch(
            cfg, CHECK_TRAIN_BATCH, seq, i, device))
        rows.append({k: [float(m_dev[k]), float(m_cpu[k])]
                     for k in ("loss", "grad_norm", "lr")})
    param_diff = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        _leaves(p_dev), _leaves(p_cpu)))
    moved = max(float(np.abs(b.numpy() - a).max()) for a, b in zip(
        _leaves(start), _leaves(p_cpu)))
    for i, r in enumerate(rows):
        for k, rtol in (("loss", CHECK_LOSS_RTOL),
                        ("grad_norm", CHECK_GNORM_RTOL)):
            got, want = r[k]
            if not abs(got - want) <= rtol * abs(want):
                raise AssertionError(f"train_check step {i} {k}: {got} on "
                                     f"{device}, {want} on the CPU")
    if not param_diff <= CHECK_PARAM_ATOL:
        raise AssertionError(f"train_check: params differ by {param_diff}")
    del p_cpu, p_dev, o_cpu, o_dev
    _free_device(device)
    return {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": "float32", "batch": CHECK_TRAIN_BATCH,
            "seq_len": seq, "steps": rows,
            "tol": {"loss_rtol": CHECK_LOSS_RTOL,
                    "grad_norm_rtol": CHECK_GNORM_RTOL,
                    "param_atol": CHECK_PARAM_ATOL},
            "param_max_abs_diff": param_diff,
            "param_max_abs_change": moved}


# ---------------------------------------------------------------------------
# LM multi-device: the sequence-sharded scan, compressed psums, a mesh
# ---------------------------------------------------------------------------

SSD_SHARDED_L = 2048         # tokens a sequence, split over the positions
SSD_SHARDED_MESHES = (((4,), ("data",)), ((2, 4), ("pod", "data")))
PSUM_POSITIONS = 8
PSUM_TOL = 0.05              # tests/test_substrate.py:94 (rtol and atol)
MESH_TRAIN_STEPS = 4         # the first steps of the train xlstm-350m phase
MESH_SAVE_EVERY = 2
MESH_FAIL_AT = (3,)
MESH_LOSS_TOL = 2e-2         # a mesh step's loss against the one-device one
MESH_GNORM_RTOL = 5e-2       # and its grad norm (bf16)
# train_mesh_check: train_check's model (xLSTM-350M at full width, 4
# layers, float32) on a (2, 2) mesh against one device, both on the card,
# at train_check's bounds, at an lr that moves the params well past them.
MESH_CHECK_LR = 0.1          # the warmup scales it by 0, 1e-2, 2e-2: ~3e-3
MESH_CHECK_MOVED = 10 * CHECK_PARAM_ATOL
MESH_CHECK_M_RTOL = 1e-3     # a leaf's first moment against its largest entry
MESH_CHECK_PARAMS_EPS = 1e-3  # AdamW eps of the run whose params are held
MESH_CHECK_EPS = (1e-8, MESH_CHECK_PARAMS_EPS)   # AdamW's default first


def _ssd_inputs(b, h, l, dk, dv, dtype, device, seed, shift):
    """q, k ~0.3 N(0, 1), v ~0.5 N(0, 1) in ``dtype``; float32 log_a =
    -softplus(N + shift) (shift -2: Mamba2's dt of ~0.13 a step)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=device)
    return ((rn(b, h, l, dk) * 0.3).to(dtype), (rn(b, h, l, dk) * 0.3).to(dtype),
            (rn(b, h, l, dv) * 0.5).to(dtype),
            -torch.nn.functional.softplus(rn(b, h, l) + shift))


def run_ssd_sharded(device, smoke: bool = False) -> dict:
    """``ops.ssd_scan(axis_names=...)`` inside ``spmd.shard_map`` on meshes
    of positions of ``device``: Zamba2-7B's Mamba2 scan (bf16, B 4, 112
    heads, ds = hd = 64, chunk 128, L 2,048) over 4 positions and over a
    (2, 4) ("pod", "data") mesh, and xLSTM-350M's mLSTM scan (4 heads,
    dk = dv = 256) over 4.  Each position runs ``chunk_local`` and
    ``chunk_apply`` once a call (counted).  Gates, each elementwise: bf16,
    the unsharded scan through the same kernels at the bf16 gate; float32
    inputs, the sharded scan through the kernels' plain versions at the
    chunk kernels' float32 tolerance.  The bf16 sharded scan against its
    plain versions is held normwise (the bf16 gate times the largest
    |y|) and to at most the unsharded pair's gap on the same inputs:
    elementwise the bf16 kernels and plain versions, sharded or not,
    differ by up to two bf16 steps where y_intra, rounded to bf16 between
    the phases by both, cancels the inter-chunk term."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import spmd
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts

    on_card = device.type == "cuda"
    get = get_smoke_config if smoke else get_config
    zcfg, xcfg = get("zamba2-7b"), get("xlstm-350m")
    l = 256 if smoke else SSD_SHARDED_L
    cases = (
        ("zamba2-7b mamba2", zcfg.ssm_heads, zcfg.ssm_state,
         zcfg.d_inner // zcfg.ssm_heads, min(zcfg.ssm_chunk, l // 8), -2.0,
         SSD_SHARDED_MESHES),
        ("xlstm-350m mlstm", xcfg.n_heads, xcfg.ssm_head_dim,
         xcfg.ssm_head_dim, min(xcfg.ssm_chunk, l // 8), 0.0,
         SSD_SHARDED_MESHES[:1]),
    )
    f32_tol = CHUNK_TOL[torch.float32]
    out, launches = {}, {"chunk_local": 0, "chunk_apply": 0}
    for seed, (tag, h, dk, dv, chunk, shift, meshes) in enumerate(cases):
        q, k, v, la = _ssd_inputs(LM_BATCH, h, l, dk, dv, torch.bfloat16,
                                  device, 40 + seed, shift)
        q32, k32, v32 = q.float(), k.float(), v.float()
        whole = ops.ssd_scan(q, k, v, la, chunk=chunk, backend="pallas")
        whole_plain = ops.ssd_scan(q, k, v, la, chunk=chunk,
                                   backend="pallas_interpret")
        whole_gap = float((whole.float() - whole_plain.float()).abs().max())
        runs = {}
        for shape, names in meshes:
            n = math.prod(shape)
            mesh = spmd.Mesh([device] * n, names, shape)
            sp = spmd.P(None, None, names)

            def sharded(backend):
                return spmd.shard_map(
                    lambda *a: ops.ssd_scan(*a, chunk=chunk, backend=backend,
                                            axis_names=names,
                                            axis_sizes=shape),
                    mesh, sp, sp)

            run, plain = sharded("pallas"), sharded("pallas_interpret")
            counts = {}

            def counted(*args):
                _sync(device)
                reset_launch_counts()
                t0 = time.perf_counter()
                y = run(*args)
                _sync(device)
                secs = time.perf_counter() - t0
                for name, c in launch_counts().items():
                    if name in launches:
                        counts[name] = counts.get(name, 0) + c
                return y, secs

            y, first_s = counted(q, k, v, la)
            y32, _ = counted(q32, k32, v32, la)
            for name in launches:
                launches[name] += counts.get(name, 0)
                if on_card and counts.get(name, 0) != 2 * n:
                    raise AssertionError(f"ssd_sharded {tag}: {name} launched "
                                         f"{counts.get(name, 0)} times in two "
                                         f"calls on {n} positions")
            y_plain = plain(q, k, v, la)
            gap = float((y.float() - y_plain.float()).abs().max())
            scale = float(y_plain.float().abs().max())
            if gap > BF16_TOL[1] + BF16_TOL[0] * scale or gap > whole_gap:
                raise AssertionError(f"ssd_sharded {tag}: bf16 kernels and "
                                     f"plain versions {gap} apart (max |y| "
                                     f"{scale}; unsharded {whole_gap})")
            t0 = time.perf_counter()
            for _ in range(3):
                run(q, k, v, la)
            _sync(device)
            runs["x".join(map(str, shape))] = {
                "positions": n, "tokens_a_position": l // n,
                "g_a_position": LM_BATCH * h * (l // n // chunk),
                "launches_bf16_and_f32": {k_: counts.get(k_, 0)
                                          for k_ in launches},
                "max_abs_err_vs_unsharded": _close_to(
                    y, whole, *BF16_TOL, f"ssd_sharded {tag} vs unsharded"),
                "f32_max_abs_err_vs_plain": _close_to(
                    y32, plain(q32, k32, v32, la), *f32_tol,
                    f"ssd_sharded {tag} float32 vs plain"),
                "bf16_max_abs_err_vs_plain": gap,
                "max_abs_y": scale,
                "first_s": first_s,
                "ms": (time.perf_counter() - t0) / 3 * 1e3,
            }
        out[tag] = {"batch": LM_BATCH, "heads": h, "dk": dk, "dv": dv,
                    "chunk": chunk, "seq_len": l, "dtype": "bf16",
                    "unsharded_bf16_kernel_vs_plain_max_abs_err": whole_gap,
                    "meshes": runs}
    out["launches"] = launches
    out["bf16_tol"] = list(BF16_TOL)
    out["f32_tol"] = list(f32_tol)
    return out


def run_compressed_psum(device, smoke: bool = False) -> dict:
    """``optim.compress.compressed_psum`` on 8 positions of ``device``:
    each holds a seeded float32 gradient of xLSTM-350M's largest leaf, the
    embedding table (50,432 x 1,024); the int8 sum is held to the exact
    float32 sum (the reference test's rtol / atol 0.05), every position
    to the same sum, and each residual to y - dequantize(quantize(y))."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import spmd
    from repro_torch.optim import compress

    cfg = (get_smoke_config if smoke else get_config)("xlstm-350m")
    v, d = cfg.padded_vocab, cfg.d_model
    n = PSUM_POSITIONS
    gen = torch.Generator(device=device).manual_seed(51)
    grads = torch.randn((n, v, d), generator=gen, device=device) * 1e-3
    mesh = spmd.Mesh([device] * n, ("d",))

    def body(xs):
        s, r = compress.compressed_psum(xs[0], "d")
        return s[None], r[None]

    run = spmd.shard_map(body, mesh, spmd.P("d"), (spmd.P("d"), spmd.P("d")))
    _sync(device)
    t0 = time.perf_counter()
    s, r = run(grads)
    _sync(device)
    secs = time.perf_counter() - t0
    exact = grads.sum(0)
    err = _close_to(s[0], exact, PSUM_TOL, PSUM_TOL, "compressed_psum sum")
    for i in range(1, n):
        if not torch.equal(s[i], s[0]):
            raise AssertionError(f"compressed_psum: position {i} holds "
                                 "another sum")
    for i in range(n):
        q, sc = compress.quantize_int8(grads[i])
        want = grads[i] - compress.dequantize_int8(q, sc, grads[i].shape,
                                                   torch.float32)
        if not torch.equal(r[i], want):
            raise AssertionError(f"compressed_psum: position {i}'s residual "
                                 "is not y - dequantize(quantize(y))")
    out = {"positions": n, "leaf": "embed/table", "shape": [v, d],
           "max_abs_err_vs_exact": err,
           "max_abs_sum": float(exact.abs().max()),
           "max_abs_residual": float(r.abs().max()),
           "int8_wire_bytes": compress.wire_bytes(v * d),
           "float32_bytes": v * d * 4, "seconds": secs, "tol": PSUM_TOL}
    del grads, s, r, exact
    _free_device(device)
    return out


def run_train_mesh(device, one_device: dict, smoke: bool = False) -> dict:
    """``train(TrainConfig(mesh_shape=(2, 2)))`` on xLSTM-350M at full width
    and depth (bf16; its smoke config in a rehearsal): 4 ranks in one gloo
    world sharing ``device``, the train phase's first 4 steps (8 x 256 from
    the TokenPipeline, its lr) with a checkpoint at step 2 and a failure at
    step 3 (one restart); then ``elastic.plan_rescale(4,
    model_parallel=1)``'s (4, 1) mesh restores the step-4 checkpoint with
    ``shardings=`` and takes step 5.  Every loss within 2e-2 of the same
    step of the one-device phase (``one_device``'s losses), every grad
    norm within MESH_GNORM_RTOL of its grad norm.  First, the
    gloo probe: its own collectives on the device's tensors and DTensor's
    through the host staging."""
    import shutil
    import tempfile

    from repro_torch.launch import host_staging
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import run_world
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.runtime import elastic

    _free_device(device)
    t0 = time.perf_counter()
    probe = run_world(host_staging.probe, 4, device=str(device))
    probe_s = time.perf_counter() - t0
    if any(v is not True for k, v in probe[0].items() if k != "staged"):
        raise AssertionError(f"train_mesh: gloo probe {probe[0]}")
    seq = REHEARSAL_SEQ if smoke else TRAIN_SEQ
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    kw = dict(arch=TRAIN_ARCH, smoke=smoke, batch=TRAIN_BATCH, seq_len=seq,
              lr=TRAIN_LR, ckpt_dir=ckpt_dir, log_every=1,
              device=str(device))
    plan = elastic.plan_rescale(4, model_parallel=1)
    # train()'s progress lines go to stderr, the spawned ranks' too (they
    # inherit file descriptor 1): stdout holds result lines.
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            t0 = time.perf_counter()
            mesh = train(TrainConfig(steps=MESH_TRAIN_STEPS,
                                     save_every=MESH_SAVE_EVERY,
                                     fail_at=MESH_FAIL_AT, mesh_shape=(2, 2),
                                     **kw))
            mesh_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rescaled = train(TrainConfig(steps=MESH_TRAIN_STEPS + 1,
                                         save_every=100,
                                         mesh_shape=plan.mesh_shape, **kw))
            rescaled_s = time.perf_counter() - t0
    finally:
        os.dup2(saved, 1)
        os.close(saved)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    by_step = dict(zip(mesh["loss_steps"], mesh["losses"]))
    by_step.update(zip(rescaled["loss_steps"], rescaled["losses"]))
    gnorm_by_step = dict(zip(mesh["loss_steps"], mesh["grad_norms"]))
    gnorm_by_step.update(zip(rescaled["loss_steps"], rescaled["grad_norms"]))
    want = one_device["losses"]
    want_gnorms = one_device["grad_norms"]
    n = MESH_TRAIN_STEPS + 1
    gaps = [abs(by_step[i] - want[i]) for i in range(n)]
    gnorm_gaps = [abs(gnorm_by_step[i] - want_gnorms[i]) / want_gnorms[i]
                  for i in range(n)]
    _finite(list(by_step.values()) + list(gnorm_by_step.values()),
            "train_mesh")
    if max(gaps) > MESH_LOSS_TOL:
        raise AssertionError(f"train_mesh: loss gaps {gaps} to the one-device "
                             f"steps exceed {MESH_LOSS_TOL}")
    if max(gnorm_gaps) > MESH_GNORM_RTOL:
        raise AssertionError(f"train_mesh: grad norms {gnorm_by_step} against "
                             f"the one-device {want_gnorms[:n]}: relative gaps "
                             f"{gnorm_gaps} exceed {MESH_GNORM_RTOL}")
    if mesh["restarts"] != 1 or rescaled["loss_steps"] != [MESH_TRAIN_STEPS]:
        raise AssertionError(f"train_mesh: restarts {mesh['restarts']}, "
                             f"rescaled steps {rescaled['loss_steps']}")
    acfg = _lm_config(smoke, TRAIN_ARCH)
    # What one MoE layer's experts (w1, w3, w2) hold at full width, and a
    # rank's block of them on a mesh with "model" of size tp: what each
    # rank gathers at a layer and the size of the gradient it forms.
    expert_bytes = {}
    for arch in ("phi3.5-moe-42b-a6.6b", "arctic-480b"):
        c = _lm_config(False, arch)
        whole = (3 * c.n_experts * c.d_model * c.d_ff
                 * torch.empty((), dtype=c.pdtype).element_size())
        expert_bytes[arch] = {"experts": c.n_experts, "a_layer": whole, **{
            f"a_rank_tp{tp}": whole // tp for tp in (2, 16)
            if c.n_experts % tp == 0}}
    structs = steps.params_struct(acfg)
    param_total = sum(t.numel() * t.element_size() for t in _leaves(structs))
    n_params = sum(t.numel() for t in _leaves(structs))
    opt_total = n_params * 4 * 3 + 4          # m, v, float32 master, step
    return {
        "arch": acfg.name, "layers": acfg.n_layers, "d_model": acfg.d_model,
        "dtype": acfg.param_dtype, "batch": TRAIN_BATCH, "seq_len": seq,
        "lr": TRAIN_LR, "mesh": list(mesh["mesh"]),
        "backend": mesh["backend"], "gloo_probe": probe[0],
        "gloo_probe_s": probe_s,
        "loss_steps_2x2": mesh["loss_steps"], "losses_2x2": mesh["losses"],
        "step_s_2x2": mesh["step_s"], "restarts_2x2": mesh["restarts"],
        "rescaled_mesh": list(plan.mesh_shape),
        "loss_steps_4x1": rescaled["loss_steps"],
        "losses_4x1": rescaled["losses"], "step_s_4x1": rescaled["step_s"],
        "one_device_losses": want[:n],
        "loss_gaps": gaps, "loss_tol": MESH_LOSS_TOL,
        "grad_norms": [gnorm_by_step[i] for i in range(n)],
        "one_device_grad_norms": want_gnorms[:n],
        "grad_norm_rel_gaps": gnorm_gaps, "grad_norm_rtol": MESH_GNORM_RTOL,
        "ranks_2x2": mesh["ranks"], "ranks_4x1": rescaled["ranks"],
        "one_device_param_bytes": param_total,
        "one_device_opt_bytes": opt_total,
        "checkpoint_restore_s_2x2": mesh["checkpoint"]["restore"],
        "checkpoint_restore_s_4x1": rescaled["checkpoint"]["restore"],
        "staged_collectives_2x2": mesh["staged_collectives"],
        "staged_collectives_4x1": rescaled["staged_collectives"],
        "wall_s_2x2": mesh_s, "wall_s_4x1": rescaled_s,
        "moe_expert_bytes": expert_bytes,
    }


def _mesh_check_params(cfg, device):
    """train_check's seeded params, drawn on the CPU, on ``device``."""
    from repro_torch.interop import params_from_numpy, to_numpy
    from repro_torch.models import lm

    return params_from_numpy(to_numpy(lm.init_params(
        torch.Generator().manual_seed(3), cfg)), device=device)


def _mesh_check_steps(cfg, device, seq, mesh=None) -> dict:
    """For each AdamW eps of MESH_CHECK_EPS, CHECK_TRAIN_STEPS steps at
    MESH_CHECK_LR from the seeded params, on one device or (``mesh``) on
    DTensors laid out by the rules: eps -> (losses, grad norms, final
    params, final first moments), the trees as float32 numpy leaves."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.train import mesh_step
    from repro_torch.optim import adamw

    def full(tree):
        return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
                .detach().float().cpu().numpy() for t in _leaves(tree)]

    out = {}
    for eps in MESH_CHECK_EPS:
        opt_cfg = adamw.AdamWConfig(lr=MESH_CHECK_LR, eps=eps)
        params = _mesh_check_params(cfg, device)
        if mesh is None:
            step_fn = steps.make_train_step(cfg, opt_cfg)
        else:
            params = shd.distribute(
                params, shd.param_shardings(params, cfg, mesh), mesh)
            step_fn = mesh_step(cfg, opt_cfg, mesh)
        opt = adamw.init(params, opt_cfg)
        losses, gnorms = [], []
        for i in range(CHECK_TRAIN_STEPS):
            params, opt, m = step_fn(params, opt, _train_batch(
                cfg, CHECK_TRAIN_BATCH, seq, i, device))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[eps] = (losses, gnorms, full(params), full(opt.m))
        del params, opt
    return out


def _mesh_check_rank(rank, device, cfg, seq):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device=str(device))
    out = _mesh_check_steps(cfg, device, seq, mesh)
    return out if rank == 0 else None


def run_train_mesh_check(device, smoke: bool = False) -> dict:
    """train_check's model (xLSTM-350M at full width and
    CHECK_TRAIN_LAYERS layers, float32; its smoke config in a rehearsal)
    on a (2, 2) mesh of 4 gloo ranks sharing ``device``, against the same
    steps on ``device`` alone, from the same seeded params and batches
    (2 x 128), at MESH_CHECK_LR so the params move past the bound, with
    AdamW's default eps and with MESH_CHECK_PARAMS_EPS.  Gates, each eps:
    each step's loss within CHECK_LOSS_RTOL and grad norm within
    CHECK_GNORM_RTOL (train_check's), each leaf's first moment within
    MESH_CHECK_M_RTOL of its largest entry, the largest param change above
    MESH_CHECK_MOVED, no kernel launched; at MESH_CHECK_PARAMS_EPS the
    params after the third step within CHECK_PARAM_ATOL.  At the default
    eps 1e-8 Adam's step m / (sqrt(v) + eps) is the sign of a gradient
    far below float noise, so an element whose gradient the two runs see
    with opposite signs moves 2 lr apart; the line reports those elements
    (count, the largest gap, their first moments against their leaf's
    largest), not gated.  At eps 1e-3 a gradient's noise moves the step
    by at most the noise / 1e-3."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.mesh import run_world

    kw = dict(param_dtype="float32", compute_dtype="float32",
              cache_dtype="float32")
    if not smoke:
        kw["n_layers"] = CHECK_TRAIN_LAYERS
    cfg = _lm_config(smoke, TRAIN_ARCH, **kw)
    seq = REHEARSAL_SEQ if smoke else CHECK_TRAIN_SEQ
    _free_device(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    one = _mesh_check_steps(cfg, device, seq)
    one_s = time.perf_counter() - t0
    counts = _no_launches("train_mesh_check")
    t0 = time.perf_counter()
    mesh = run_world(_mesh_check_rank, 4, cfg, seq, device=str(device))[0]
    mesh_s = time.perf_counter() - t0
    start = [t.float().cpu().numpy() for t in
             _leaves(_mesh_check_params(cfg, torch.device("cpu")))]
    runs, failed = {}, []
    for eps in MESH_CHECK_EPS:
        (ml, mg, mp, mm), (ol, og, op, om) = mesh[eps], one[eps]
        moved = max(float(np.abs(b - a).max()) for a, b in zip(start, op))
        m_rel = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                     1e-30)
                    for a, b in zip(mm, om))
        over, worst, m_over = 0, 0.0, 0.0
        for a, b, ma, mb in zip(mp, op, mm, om):
            gap = np.abs(a - b)
            hit = gap > CHECK_PARAM_ATOL
            over += int(hit.sum())
            worst = max(worst, float(gap.max()))
            if hit.any():
                scale = max(float(np.abs(mb).max()), 1e-30)
                m_over = max(m_over, float(np.maximum(
                    np.abs(ma[hit]), np.abs(mb[hit])).max()) / scale)
        rows = [{"loss": [ml[i], ol[i]], "grad_norm": [mg[i], og[i]]}
                for i in range(CHECK_TRAIN_STEPS)]
        for i, r in enumerate(rows):
            for k, rtol in (("loss", CHECK_LOSS_RTOL),
                            ("grad_norm", CHECK_GNORM_RTOL)):
                got, want = r[k]
                if not abs(got - want) <= rtol * abs(want):
                    failed.append(f"eps {eps} step {i} {k}: {got} on the "
                                  f"mesh, {want} on one device")
        if not moved > MESH_CHECK_MOVED:
            failed.append(f"eps {eps}: the params moved {moved}")
        if not m_rel <= MESH_CHECK_M_RTOL:
            failed.append(f"eps {eps}: first moments {m_rel} apart")
        if eps == MESH_CHECK_PARAMS_EPS and not worst <= CHECK_PARAM_ATOL:
            failed.append(f"eps {eps}: params {worst} apart")
        runs[str(eps)] = {
            "steps": rows, "param_max_abs_diff": worst,
            "params_over_atol": over,
            "their_max_abs_m_over_leaf_max": m_over if over else None,
            "param_max_abs_change": moved, "m_max_rel_diff": m_rel,
            "params_gated": eps == MESH_CHECK_PARAMS_EPS}
    if failed:
        raise AssertionError(f"train_mesh_check: {failed}; {runs}")
    _free_device(device)
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": "float32", "mesh": [2, 2],
            "batch": CHECK_TRAIN_BATCH, "seq_len": seq, "lr": MESH_CHECK_LR,
            "tol": {"loss_rtol": CHECK_LOSS_RTOL,
                    "grad_norm_rtol": CHECK_GNORM_RTOL,
                    "param_atol": CHECK_PARAM_ATOL,
                    "m_rtol": MESH_CHECK_M_RTOL,
                    "moved_min": MESH_CHECK_MOVED},
            "eps": runs, "one_device_s": one_s, "mesh_s": mesh_s,
            "launches": counts}


# dryrun: two cells of the production dry-run at 16 x 16 (the sLSTM's
# once-counted recurrence, and a decode), and the dry-run's predictions for
# this script's own training phases, each in a child process of its own
# (the fake process group must never meet the train_mesh gloo world).
DRYRUN_CELLS = (("xlstm-350m", "train_4k"), ("qwen3-32b", "decode_32k"))
DRYRUN_TIMEOUT_S = 170        # the phase's budget: the children run at once
# host_staging's op names -> the dry-run's collective kinds.
STAGED_KINDS = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
                "all_to_all_single": "all-to-all", "broadcast": "broadcast"}

_DRYRUN_CHILD = r"""
import json, sys, time
sys.path.insert(0, %(src)r)
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
t0 = time.perf_counter()
if %(what)r == "cell":
    shape = (ShapeConfig(*%(shape)r) if isinstance(%(shape)r, tuple)
             else %(shape)r)
    out = dryrun.run_cell(%(arch)r, shape, multi_pod=False, save=False,
                          verbose=False, mesh_shape=%(mesh)r, smoke=%(smoke)r)
else:
    out = dryrun.count_step(%(arch)r, ShapeConfig(*%(shape)r),
                            mesh_shape=%(mesh)r, smoke=%(smoke)r,
                            once=%(once)r)
out["seconds"] = time.perf_counter() - t0
print("DRYRUN " + json.dumps(out))
"""


def _one_step_peak(device, smoke: bool, seq: int):
    """The card's peak over one ``train`` phase step of a fresh model
    (init, AdamW state, one step), above what was allocated before; None
    off the card."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    if device.type != "cuda":
        return None
    acfg = _lm_config(smoke, TRAIN_ARCH)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR)
    _free_device(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    params = lm.init_params(torch.Generator(device=device).manual_seed(0),
                            acfg)
    opt = adamw.init(params, opt_cfg)
    steps.make_train_step(acfg, opt_cfg)(
        params, opt, _train_batch(acfg, TRAIN_BATCH, seq, 0, device))
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del params, opt
    _free_device(device)
    return peak


def run_dryrun(device, one_device: dict, mesh_run: dict,
               smoke: bool = False) -> dict:
    """``repro_torch.launch.dryrun`` in child processes started together:
    DRYRUN_CELLS at the production 16 x 16 (in a rehearsal the smoke
    configs at short shapes on (2, 2)), and two predictions tied to this
    run's training phases: the one-device peak of the ``train`` phase's
    step (full depth, 8 x 256, bf16, the sLSTM loop walked whole) beside
    the peak of one such step measured here on the card and the peak the
    whole ``train`` phase measured (its restart holds a second model and
    state), and one (2, 2) step's collectives by kind beside what
    ``train_mesh``'s rank 0 staged through host memory a step.  No gate on
    the gaps: every cell must be ``ok`` with positive counts."""
    from repro_torch.models.config import SHAPES

    seq = REHEARSAL_SEQ if smoke else TRAIN_SEQ
    step_peak = _one_step_peak(device, smoke, seq)
    train_shape = ("train_phase", seq, TRAIN_BATCH, "train")
    jobs = {}
    for arch, shape in DRYRUN_CELLS:
        if smoke:
            kind = SHAPES[shape].kind
            shape = (f"{kind}_rehearsal", 32, 8, kind)
        jobs[f"{arch} {shape if isinstance(shape, str) else shape[0]}"] = dict(
            what="cell", arch=arch, shape=shape,
            mesh=(2, 2) if smoke else None, smoke=smoke, once=True)
    jobs["one_device_peak"] = dict(what="count", arch=TRAIN_ARCH,
                                   shape=train_shape, mesh=None, smoke=smoke,
                                   once=False)
    jobs["mesh_step"] = dict(what="count", arch=TRAIN_ARCH, shape=train_shape,
                             mesh=(2, 2), smoke=smoke, once=True)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    src = os.path.join(ROOT, "src")
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_CHILD % dict(job, src=src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name, job in jobs.items()}
    got, errors = {}, {}
    try:
        for name, proc in procs.items():
            left = max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0))
            out, err = proc.communicate(timeout=left)
            line = [ln for ln in out.splitlines() if ln.startswith("DRYRUN ")]
            if proc.returncode != 0 or not line:
                errors[name] = err.strip().splitlines()[-3:]
                continue
            got[name] = json.loads(line[-1][len("DRYRUN "):])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall_s = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"dryrun: children failed: {errors}")
    cells = {}
    for arch, shape in DRYRUN_CELLS:
        name = next(n for n in got if n.startswith(arch + " "))
        cell = got[name]
        if cell.get("status") != "ok" or not all(
                cell[k] > 0 for k in ("flops_per_device", "bytes_per_device",
                                      "arg_bytes", "peak_bytes")):
            raise AssertionError(f"dryrun: {name}: {cell}")
        cells[name] = {k: cell[k] for k in (
            "mesh", "n_chips", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collectives", "arg_bytes",
            "peak_bytes", "fits", "t_compute", "t_memory", "t_collective",
            "bottleneck", "model_flops_ratio", "seconds")}
    peak = got["one_device_peak"]
    steps_run = len(mesh_run["loss_steps_2x2"])
    staged = {}
    for op, (calls, to_host, back) in mesh_run[
            "staged_collectives_2x2"].items():
        rec = staged.setdefault(STAGED_KINDS.get(op, op),
                                {"count": 0.0, "bytes": 0.0})
        rec["count"] += calls / steps_run
        rec["bytes"] += back / steps_run
    return {
        "cells": cells,
        "one_device_peak": {
            "arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq_len": seq,
            "predicted_bytes": peak["peak_bytes"],
            "predicted_arg_bytes": peak["arg_bytes"],
            "measured_one_step": step_peak,
            "measured_train_phase": one_device["max_memory_allocated"],
            "seconds": peak["seconds"]},
        "mesh_step_collectives": {
            "mesh": [2, 2], "predicted_per_step": got["mesh_step"][
                "collectives"],
            "staged_per_step_rank0": staged, "steps_run": steps_run,
            "seconds": got["mesh_step"]["seconds"]},
        "device": None if smoke else _smi(),
        "wall_s": wall_s,
    }


def _close_pool() -> None:
    """Stop the shared worker pool and wait for its threads, so none is
    alive while PyTorch tears down at exit."""
    from repro_torch.runtime.scheduler import get_default_pool

    pool = get_default_pool()
    pool.shutdown()
    pool.join(timeout=60)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the series, engine, serving, restore, "
                         "simulate, collective, sharded, LM and training "
                         "phases on the CPU at small sizes with the plain "
                         "kernels; "
                         "exits 3 with no result line")
    ap.add_argument("--previous-csrc", default=None,
                    help="csrc directory of the kernels' previous designs "
                         "(e.g. from git archive of an earlier commit): "
                         "build and time warp_ncc from there beside the "
                         "current one; without it, and for the kernels "
                         "redesigned in earlier slices, the redesign line "
                         "quotes PERF.md's times")
    args = ap.parse_args()

    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo
    from repro_torch.kernels import _cuda

    if args.cpu_rehearsal:
        dev = torch.device("cpu")
        _line("series", run_series(dev, 9, 96))
        _line("series_hier", run_series(
            dev, 5, 96, backend="hierarchical", num_segments=2,
            num_threads=2))
        _line("series_compose", run_series_compose(dev, 17, 64))
        _line("scan_engine", run_scan_engine(dev, 1 << 12, 256, 1 << 10))
        _line("serving", run_serving(dev, 96, tenants=(
            ("scope", 9, True, 4, True), ("batch_a", 9, False, 8, False),
            ("batch_b", 5, True, 4, False))))
        _line("series_restore", run_series_restore(dev, 9, 96, 5))
        _line("simulate", run_simulate(dev, 256))
        _line("collective", run_collective(dev, rows=64))
        _line("sharded", run_sharded(dev, 1 << 12, series_len=256))
        _line("lm_serve", run_lm_serve(dev, smoke=True))
        for arch in LM_SERVE_ARCHS:
            _line(f"lm_serve {arch}", run_lm_serve(dev, smoke=True, arch=arch))
        _line("lm_check", run_lm_check(dev, smoke=True))
        _line("lm_check xlstm-350m", run_lm_check(dev, smoke=True,
                                                  arch="xlstm-350m"))
        _line("lm_check whisper-base", run_lm_check(dev, smoke=True,
                                                    arch="whisper-base"))
        one = run_train(dev, smoke=True)
        _line(f"train {TRAIN_ARCH}", one)
        _line("train phi3.5-moe-42b", run_train_moe(dev, smoke=True))
        _line("train_check", run_train_check(dev, smoke=True))
        _line("ssd_sharded", run_ssd_sharded(dev, smoke=True))
        _line("compressed_psum", run_compressed_psum(dev, smoke=True))
        mesh_run = run_train_mesh(dev, one, smoke=True)
        _line(f"train_mesh {TRAIN_ARCH}", mesh_run)
        _line("train_mesh_check", run_train_mesh_check(dev, smoke=True))
        _line("dryrun", run_dryrun(dev, one, mesh_run, smoke=True))
        _close_pool()
        print("cpu rehearsal: no result", file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    power_w = _power_limit_w(smi)
    _line("env", {
        "nvidia_smi": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    })

    # Each library (csrc/<name>.cu) and the kernels it holds.
    libraries = {"warp_ncc": ["warp_ncc"],
                 "ncc_grad": ["ncc_grad_sums", "ncc_grad_step"],
                 "lookback_scan": ["lookback_scan"],
                 "tile_scan": ["tile_local_scan", "tile_apply"],
                 "fused_round": ["fused_round", "fused_plan"],
                 "chunk_scan": ["chunk_local", "chunk_apply"],
                 "flash_attention": ["flash_attention"]}
    secs = _cuda.build(list(libraries))
    ptxas = {name: [ln.strip() for ln in _cuda.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in libraries}
    _line("build", {"seconds": secs, "kernels": libraries, "ptxas": ptxas})

    k = check_warp_ncc(dev, power_w)
    _line("kernel warp_ncc", k)
    kg = check_ncc_grad(dev, power_w)
    _line("kernel ncc_grad", kg)
    # The scan kernels' bf16 add and matmul entries, under each line.
    entries = check_scan_entries(dev)
    kl = {**check_lookback_scan(dev), **entries["lookback_scan"]}
    _line("kernel lookback_scan", kl)
    kt_local, kt_apply = check_tile_kernels(dev)
    kt_local.update(entries["tile_local_scan"])
    kt_apply.update(entries["tile_apply"])
    _line("kernel tile_local_scan", kt_local)
    _line("kernel tile_apply", kt_apply)
    kf, kp = check_fused_round(dev)
    kf.update(entries["fused_round"])
    kp.update(entries["fused_plan"])
    _line("kernel fused_round", kf)
    kc_local, kc_apply = check_chunk_kernels(dev)
    _line("kernel chunk_local", kc_local)
    _line("kernel chunk_apply", kc_apply)
    _line("kernel chunk_local d256", kc_local["d256"])
    _line("kernel chunk_apply d256", kc_apply["d256"])
    kfa = check_flash_attention(dev)
    _line("kernel flash_attention", kfa)
    _line("kernel flash_attention d128", kfa["d128"])
    _line("kernel flash_attention d64", kfa["d64"])
    _line("kernel flash_attention d64 noncausal", kfa["d64_noncausal"])
    redesign = check_redesigns(dev, k, kfa, kl, kf, kt_apply, kc_local,
                               kc_apply, args.previous_csrc)
    _line("redesign", redesign)
    for name in ("flash_attention", "chunk_local"):
        if redesign[name]["hgmma_in_sass"] < 1:
            raise AssertionError(f"{name}'s library has no HGMMA "
                                 "instruction: the bf16 products are not on "
                                 "the tensor cores")

    series = run_series(dev, 33, SIZE)
    _line("series", series)
    hier = run_series(dev, 17, SIZE, backend="hierarchical", num_segments=4,
                      num_threads=2)
    _line("series_hier", hier)
    compose = run_series_compose(dev, 257, SIZE)
    _line("series_compose", compose)
    engine = run_scan_engine(dev, SCAN_N, SERIES_LEN, ROUNDS_N)
    _line("scan_engine", engine)
    serving = run_serving(dev, SIZE)
    _line("serving", serving)
    restore = run_series_restore(dev, 33, SIZE, 17)
    _line("series_restore", restore)
    _line("simulate", run_simulate(dev))
    _line("collective", run_collective(dev))
    shard = run_sharded(dev, SCAN_N)
    _line("sharded", shard)
    serve = run_lm_serve(dev)
    _line("lm_serve", serve)
    serves = {}
    for arch in LM_SERVE_ARCHS:
        serves[arch] = run_lm_serve(dev, arch=arch)
        _line(f"lm_serve {arch}", serves[arch])
    check = run_lm_check(dev)
    _line("lm_check", check)
    check_x = run_lm_check(dev, arch="xlstm-350m", layers=None)
    _line("lm_check xlstm-350m", check_x)
    check_w = run_lm_check(dev, arch="whisper-base", layers=None)
    _line("lm_check whisper-base", check_w)
    want_w = _lm_config(False, "whisper-base")
    if (check_w["flash_noncausal_launches"], check_w["flash_causal_launches"]
            ) != (want_w.encoder_layers, want_w.n_layers):
        raise AssertionError(f"lm_check whisper-base: flash launches "
                             f"{check_w['flash_noncausal_launches']} "
                             f"non-causal, {check_w['flash_causal_launches']} "
                             "causal")
    one = run_train(dev)
    _line(f"train {TRAIN_ARCH}", one)
    _line("train phi3.5-moe-42b", run_train_moe(dev))
    _line("train_check", run_train_check(dev))
    ssd = run_ssd_sharded(dev)
    _line("ssd_sharded", ssd)
    _line("compressed_psum", run_compressed_psum(dev))
    mesh_run = run_train_mesh(dev, one)
    _line(f"train_mesh {TRAIN_ARCH}", mesh_run)
    _line("train_mesh_check", run_train_mesh_check(dev))
    _line("dryrun", run_dryrun(dev, one, mesh_run))

    k["launches"] = series["warp_ncc_launches"]
    k["launches_series_hier"] = hier["warp_ncc_launches"]
    kg["launches"] = series["ncc_grad_launches"]
    kg["launches_series_hier"] = hier["ncc_grad_launches"]
    kg["launches_series_compose"] = compose["ncc_grad_launches"]
    engine_launches = {}
    for call in engine["calls"].values():
        for name, v in call["launches"].items():
            engine_launches[name] = engine_launches.get(name, 0) + v
    kl["launches_series_compose"] = compose["lookback_scan_launches"]
    kl["launches_scan_engine"] = engine_launches.get("lookback_scan", 0)
    kl["launches"] = kl["launches_series_compose"] + kl["launches_scan_engine"]
    kl["launches_sharded"] = shard["lookback_scan_launches"]
    if not kl["launches_sharded"] >= 1:
        raise AssertionError("lookback_scan was never launched on the "
                             "sharded path")
    for entry in (k, kl):
        entry["launches_serving"] = serving[f"{entry['name']}_launches"]
        entry["launches_series_restore"] = sum(
            restore[tag]["launches"][entry["name"]]
            for tag in ("refine", "compose"))
        for path in ("serving", "series_restore"):
            if not entry[f"launches_{path}"] >= 1:
                raise AssertionError(f"{entry['name']} was never launched "
                                     f"on the {path} path")
    for kt in (kt_local, kt_apply, kf, kp):
        kt["launches"] = kt["launches_scan_engine"] = engine_launches.get(
            kt["name"], 0)
    for kt in (kc_local, kc_apply, kfa):
        kt["launches"] = serve["prefill_launches"].get(kt["name"], 0)
        kt["launches_lm_check"] = check["prefill_launches"].get(kt["name"], 0)
        kt["launches_lm_check_xlstm-350m"] = check_x["prefill_launches"].get(
            kt["name"], 0)
        kt["launches_lm_check_whisper-base"] = check_w["prefill_launches"].get(
            kt["name"], 0)
        if kt is not kfa:
            kt["launches_ssd_sharded"] = ssd["launches"][kt["name"]]
            if not kt["launches_ssd_sharded"] >= 1:
                raise AssertionError(f"{kt['name']} was never launched on the "
                                     "ssd_sharded path")
        kt["launches_lm_serve_by_arch"] = {
            arch: run["prefill_launches"].get(kt["name"], 0)
            for arch, run in serves.items()}
        if not any(kt["launches_lm_serve_by_arch"].values()):
            raise AssertionError(f"{kt['name']} was never launched on the "
                                 "new configurations' lm_serve paths")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rows = []
    for entry in (k, kg, kl, kt_local, kt_apply, kf, kp, kc_local, kc_apply,
                  kfa):
        if not entry["launches"] >= 1:
            raise AssertionError(f"{entry['name']} was never launched on "
                                 "the main path")
        extra = {key: v for key, v in entry.items() if key not in keys}
        rows.append({**{key: entry[key] for key in keys}, **extra})
    print(json.dumps({"kernels": rows}), flush=True)

    _close_pool()
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
