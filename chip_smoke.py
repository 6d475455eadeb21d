"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

Run from the repository root on a machine with a CUDA device::

    python3 chip_smoke.py

It builds every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``
(into ``build/torch_kernels/``), holds each kernel against its plain PyTorch
version at the main path's shapes, then registers full-width 1920x1920 TEM
series through ``repro_torch.register_series`` — once with cost-model
dispatch and once on the pinned two-level ``hierarchical`` backend — and
checks that the path went through the kernels and recovered the drift.

Output, one line each: ``env``, ``build``, ``kernel warp_ncc``, ``series``,
``series_hier``, ``kernels`` (JSON), the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits non-zero; without a CUDA device it exits 2 and prints no
result.

``--cpu-rehearsal`` runs the two series phases on the CPU at 96x96 with the
kernels' plain versions, to rehearse the script's flow without a card; it
skips the kernel phases and exits 3 without a result line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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

    secs = _cuda.build(["warp_ncc"])
    ptxas = [ln.strip() for ln in _cuda.build_log("warp_ncc").splitlines()
             if "registers" in ln or "spill" in ln]
    _line("build", {"seconds": secs, "ptxas": ptxas})

    k = check_warp_ncc(dev, power_w)
    _line("kernel warp_ncc", k)

    series = run_series(dev, 33, SIZE)
    _line("series", series)
    hier = run_series(dev, 17, SIZE, backend="hierarchical", num_segments=4,
                      num_threads=2)
    _line("series_hier", hier)

    k["launches"] = series["warp_ncc_launches"]
    k["launches_series_hier"] = hier["warp_ncc_launches"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = {key: v for key, v in k.items() if key not in keys}
    print(json.dumps({"kernels": [
        {**{key: k[key] for key in keys}, **extra}
    ]}), flush=True)

    _close_pool()
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
