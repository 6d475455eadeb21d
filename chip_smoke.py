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
  ``tile_apply``).

Output, one line each: ``env``, ``build``, ``kernel warp_ncc``,
``kernel lookback_scan``, ``kernel tile_local_scan``, ``kernel tile_apply``,
``series``, ``series_hier``, ``series_compose``, ``scan_engine``,
``kernels`` (JSON), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero; without a CUDA device it exits 2 and prints no result.

``--cpu-rehearsal`` runs the series, compose and engine phases on the CPU at
small sizes with the kernels' plain versions, to rehearse the script's flow
without a card; it skips the kernel phases and exits 3 without a result
line.
"""

from __future__ import annotations

import argparse
import json
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
# Rigid composition: rtol 1e-5, and an absolute tolerance of a few float32
# ulps of the largest composed shift (tests/test_torch_gpu.py::_rigid_tol).
RIGID_RTOL = 1e-5


def _line(tag: str, payload) -> None:
    print(f"{tag} {json.dumps(payload, sort_keys=False)}", flush=True)


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
            w_p, s_p = wn.warp_ncc_sums_reference(img, ref, a, s, tile=tile)
            torch.cuda.synchronize()
            bad = (w_k - w_p).abs() > WARP_ATOL + WARP_RTOL * w_p.abs()
            if bool(bad.any()):
                raise AssertionError(
                    f"warp_ncc warped image disagrees (tile {tile}, "
                    f"case {ang}, {shift}): {int(bad.sum())} pixels"
                )
            dn = float((wn.fold(s_k) - wn.fold(s_p)).abs())
            if not dn <= NCC_ATOL:
                raise AssertionError(
                    f"warp_ncc ncc disagrees (tile {tile}, case {ang}, "
                    f"{shift}): {dn}"
                )
            err_w = max(err_w, float((w_k - w_p).abs().max()))
            err_n = max(err_n, dn)
            err_s = max(err_s, float(((s_k - s_p).abs()
                                      / (s_p.abs() + 1.0)).max()))
    a = torch.tensor(0.07, device=device)
    s = torch.tensor((1.5, 0.7), device=device)
    ms = _time_ms(lambda: wn.warp_ncc_sums_cuda(img, ref, a, s, tile=32))
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
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_ms_at_power_limit": max(bytes_ms, ops_ms)
        * FULL_POWER_W / min(power_w, FULL_POWER_W),
        "library_ms": None,
    }


def _bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _ints(n: int, d: int, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(-2, 3, (n, d), generator=g).float().to(device)


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
        "rigid_compose": rigid,
    }


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

    def line(name, replaces, rows, err, rigid, call):
        head = rows[main_t]
        return {
            "name": name, "route": "cuda", "source": ts.SOURCE,
            "replaces": replaces, "shape": [n, d], "tiles": main_t,
            "op": "add", "max_abs_err": err,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "library_call": call,
            "by_tiles": {str(t): r for t, r in rows.items()},
            "rigid_compose": rigid,
        }

    return (line(ts.LOCAL_NAME, ts.LOCAL_REPLACES, local_rows, err_l, rigid_l,
                 "torch.cumsum(x.view(T, K, d), 1)"),
            line(ts.APPLY_NAME, ts.APPLY_REPLACES, apply_rows, err_a, rigid_a,
                 "local + seeds[:, None]"))


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
        "composed_vs_f64_chain": chain,
        "max_shift_err_px": float((shift - true["shift"]).abs().max()),
        "timings_s": res.timings, "wall_s": wall,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }
    if device.type == "cuda" and launches < 1:
        raise AssertionError("series_compose never launched lookback_scan")
    return out


def run_scan_engine(device, n: int, series_len: int) -> dict:
    """``repro_torch.core.engine.scan`` on ``device`` tensors by dispatch,
    each call with its launch counts and result checked."""
    from repro_torch.core.deformation import compose_batched
    from repro_torch.core.engine import hierarchical, scan
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
    ]
    out = {"n": n, "series_len": series_len, "calls": {}}
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
                    help="run the series phases on the CPU at 96x96 with "
                         "the plain kernels; exits 3 with no result line")
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
        _line("scan_engine", run_scan_engine(dev, 1 << 12, 256))
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

    libraries = ["warp_ncc", "lookback_scan", "tile_scan"]
    secs = _cuda.build(libraries)
    ptxas = {name: [ln.strip() for ln in _cuda.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in libraries}
    _line("build", {"seconds": secs, "ptxas": ptxas})

    k = check_warp_ncc(dev, power_w)
    _line("kernel warp_ncc", k)
    kl = check_lookback_scan(dev)
    _line("kernel lookback_scan", kl)
    kt_local, kt_apply = check_tile_kernels(dev)
    _line("kernel tile_local_scan", kt_local)
    _line("kernel tile_apply", kt_apply)

    series = run_series(dev, 33, SIZE)
    _line("series", series)
    hier = run_series(dev, 17, SIZE, backend="hierarchical", num_segments=4,
                      num_threads=2)
    _line("series_hier", hier)
    compose = run_series_compose(dev, 257, SIZE)
    _line("series_compose", compose)
    engine = run_scan_engine(dev, SCAN_N, SERIES_LEN)
    _line("scan_engine", engine)

    k["launches"] = series["warp_ncc_launches"]
    k["launches_series_hier"] = hier["warp_ncc_launches"]
    engine_launches = {}
    for call in engine["calls"].values():
        for name, v in call["launches"].items():
            engine_launches[name] = engine_launches.get(name, 0) + v
    kl["launches_series_compose"] = compose["lookback_scan_launches"]
    kl["launches_scan_engine"] = engine_launches.get("lookback_scan", 0)
    kl["launches"] = kl["launches_series_compose"] + kl["launches_scan_engine"]
    for kt in (kt_local, kt_apply):
        kt["launches"] = kt["launches_scan_engine"] = engine_launches.get(
            kt["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rows = []
    for entry in (k, kl, kt_local, kt_apply):
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
