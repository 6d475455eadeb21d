"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``portbench/configs/<name>.json``) and a traffic mix
(``portbench/traffic/<name>.json``).  A run:

1. set-up: renders the configuration's resident series on the card from
   the seed (``n_frames``: what a window, its traced feeds and the warm-up
   reach, with room for a faster program), then warms up every shape the
   mix uses with the series' first two feeds on a throwaway session
   (kernel builds land in the program's ``build/`` inside the checkout,
   so only a checkout's first run compiles);
2. the window: one ``SeriesSession`` from frame 0, fed one chunk after
   another (a closed loop) until the first feed that returns after
   ``--seconds``, or until only the frames held back for the traced feeds
   are left; ``result()`` at its close;
3. with ``--trace 1``, one or more further feeds of the same session under
   ``torch.profiler``, at least ``TRACE_MIN_S`` seconds of them;
4. the check: the program's answers against the plain reference and the
   rendered ground truth (``judge.py``), after the peak memory is read and
   the session is freed.

The last line of standard output is one JSON object; with ``--trace 0`` its
metrics are the cell's end-to-end ones, with ``--trace 1`` its per-layer
ones.  The numbers compared, each beside its limit, are the last lines of
standard error and the last key of the line.  Without a CUDA device the
run exits 2 and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
OUT = os.path.join(HERE, "out")

#: Build and kernel caches of anything the program loads, at fixed paths
#: inside the checkout (the program's own nvcc libraries go to its
#: ``build/`` there).
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(OUT, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(OUT, "triton"))

for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from portbench import judge, series, trace as trace_mod  # noqa: E402
from portbench.reference import compose as ref_compose  # noqa: E402
from portbench.reference import registration as ref_registration  # noqa: E402

#: The traced run profiles whole feeds after the window, until this many
#: seconds of them have run.
TRACE_MIN_S = 2.0
#: Feeds' worth of frames at the end of the series that the window leaves
#: for the traced feeds.
TRACE_RESERVE_FEEDS = 4
#: Pairs a reference block (one batched call of the reference).
REF_BLOCK = 8
#: Module names whose presence after the window fails the run: JAX and the
#: JAX package, compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str) -> dict:
    """The cell's entry of ``BENCHMARK.json``, its configuration, its mix
    and the per-layer metrics it reports."""
    bench = _load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = _load_json(os.path.join(HERE, "configs", f"{cell['config']}.json"))
    traffic = _load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    reported = {m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 or ("workloads" not in m and m["moves"] in reported)]
    return {"bench": bench, "cell": cell, "config": cfg, "traffic": traffic,
            "per_layer": per_layer}


def _reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _session_config(cfg: dict):
    from repro_torch.core.registration import RegistrationConfig
    from repro_torch.service import RegisterSeriesConfig

    return RegisterSeriesConfig(
        registration=RegistrationConfig(**cfg["registration"]),
        refine=bool(cfg["refine"]),
        skip_tol=cfg.get("skip_tol"),
        backend=cfg.get("backend"),
    )


def _record_pairs(session, sink: list) -> None:
    """Keep each feed's function-A pair elements (references to the tensors
    the program made; no copy, no sync) as the session hands them to its
    scan."""
    scan_suffix = session._scan_suffix

    def recording(new_elems):
        sink.extend((e.i, e.deformation) for e in new_elems)
        return scan_suffix(new_elems)

    session._scan_suffix = recording


def _forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _stack(defs: list) -> dict:
    return {k: torch.stack([d[k] for d in defs]).detach().to("cpu")
            for k in ("angle", "shift")}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, overrides: dict = None,
             traffic_overrides: dict = None) -> dict:
    """One run of ``workload``; returns the result line's object.

    ``overrides`` and ``traffic_overrides`` replace keys of the
    configuration and of the mix (tests run a tiny series on the CPU with
    them); ``device`` defaults to the card."""
    spec = load_cell(workload)
    cfg = dict(spec["config"], **(overrides or {}))
    traffic = dict(spec["traffic"], **(traffic_overrides or {}))
    device = torch.device(device or "cuda")
    on_card = device.type == "cuda"
    import repro_torch

    chunk = int(traffic["chunk_frames"])
    n_frames = int(cfg["n_frames"])
    scfg = _session_config(cfg)

    # ---- set-up: the resident series, then two warm-up feeds of the
    # mix's chunk on a throwaway session (the series' first two chunks).
    t_render = time.perf_counter()
    frames, truth = series.make_series(seed, cfg, traffic, n_frames, device)
    _sync(device)
    t_render = time.perf_counter() - t_render
    render_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    frames_bytes = frames.numel() * frames.element_size()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t_warm = time.perf_counter()
    with repro_torch.open_series(scfg, device=device) as warm:
        for lo in (0, chunk):
            warm.feed(frames[lo:lo + chunk])
        warm.result()
    _sync(device)
    t_warm = time.perf_counter() - t_warm
    setup_s = time.perf_counter() - _T0
    print(f"portbench: set-up {setup_s:.3f} s (rendering {n_frames} frames "
          f"{t_render:.3f} s, two warm-up feeds {t_warm:.3f} s)", file=sys.stderr)

    # ---- the window.
    session = repro_torch.open_series(scfg, device=device)
    pairs: list = []
    _record_pairs(session, pairs)
    last = n_frames - TRACE_RESERVE_FEEDS * chunk
    host0 = _host_reading()
    t0 = time.perf_counter()
    fed = 0
    while True:
        if fed + chunk > last:
            print(f"portbench: the window reached frame {last} of {n_frames} "
                  "(the rest is for the traced feeds) and stopped feeding; "
                  "its rate is over the time it ran", file=sys.stderr)
            break
        session.feed(frames[fed:fed + chunk])
        fed += chunk
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    host = _host_reading(host0, window_s)
    at_close = session.result()
    window = {"frames": fed, "pairs": fed - 1, "seconds": window_s,
              "feeds": fed // chunk}

    # ---- the traced feeds.
    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with record_function(trace_mod.WINDOW_SPAN):
                t1 = time.perf_counter()
                while fed + chunk <= n_frames and (
                        fed == window["frames"]
                        or time.perf_counter() - t1 < TRACE_MIN_S):
                    session.feed(frames[fed:fed + chunk])
                    fed += chunk
                _sync(device)
        traced = trace_mod.Trace.from_profiler(prof)
    final = session.result() if fed > window["frames"] else at_close
    memory_peak = max(render_peak, torch.cuda.max_memory_allocated(device)) if on_card else 0
    program_peak = (torch.cuda.max_memory_allocated(device) - frames_bytes) if on_card else 0

    # The per-layer readers take the program's spans and counters as they
    # stood when the window closed.
    at_close = SimpleNamespace(timings=dict(at_close.timings),
                               feeds=list(at_close.feeds))

    # ---- the check, once the peak is read and the session is freed.
    outputs = {k: v.detach().to("cpu") for k, v in final.deformations.items()}
    pairs.sort(key=lambda p: p[0])
    elem_idx = [i for i, _ in pairs]
    prog_pairs = _stack([d for _, d in pairs])
    session.close()
    del session, final, pairs
    t_check = time.perf_counter()
    checks, failed = check(cfg, seed, frames, truth, fed, elem_idx,
                           prog_pairs, outputs)
    print(f"portbench: window {window_s:.3f} s, {window['feeds']} feeds, "
          f"{host['cores_busy']:.2f} cores busy, preempted "
          f"{host['preempted']} times; "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    del frames

    line = {"correct": judge.verdict(checks), "attempted": fed - 1,
            "failed": failed}
    metrics = {}
    if not trace:
        values = {"frames_per_s": (window["frames"] / window_s, "frames/s"),
                  "setup_s": (setup_s, "s")}
        if on_card:
            values["program_peak_gb"] = (program_peak / 1e9, "GB")
        for m in spec["bench"]["end_to_end"]:
            if (workload in m.get("workloads", [workload])
                    and m["name"] in values):
                value, unit = values[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": unit}
    else:
        ctx = {"config": cfg, "traffic": traffic, "window": window,
               "result": at_close, "trace": traced}
        for m in spec["per_layer"]:
            value = _reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": memory_peak,
    }
    if traced is not None:
        line["device"]["busy_s"] = traced.busy_s
        line["device"]["window_s"] = traced.window_s
        line["breakdown"] = traced.breakdown()
    line["window"] = dict(
        window, backends=sorted({f["backend"] for f in at_close.feeds}),
        skipped=sum(f["skipped"] for f in at_close.feeds),
        refined=sum(f["refined"] for f in at_close.feeds))
    line["host"] = host
    line["checks"] = checks
    return line


def _host_reading(start: dict = None, seconds: float = None) -> dict:
    """This process's CPU seconds and involuntary context switches (the
    times another process took its core); with ``start``, the cores the
    window kept busy and the switches since then."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    now = {"cpu_s": use.ru_utime + use.ru_stime, "switches": use.ru_nivcsw}
    if start is None:
        return now
    return {"cores_busy": (now["cpu_s"] - start["cpu_s"]) / seconds,
            "preempted": now["switches"] - start["switches"]}


def _blocks(seed: int, n_pairs: int, count: int) -> list:
    """``count`` blocks of ``REF_BLOCK`` consecutive pair indices, drawn
    from the seed among the blocks that start at multiples of
    ``REF_BLOCK``, always with the last block (the newest pairs)."""
    starts = list(range(0, n_pairs, REF_BLOCK))
    rng = random.Random(seed)
    picked = sorted(set(rng.sample(starts[:-1], min(count - 1, len(starts) - 1))
                        + starts[-1:]))
    return [list(range(s, min(s + REF_BLOCK, n_pairs))) for s in picked]


def check(cfg: dict, seed: int, frames: torch.Tensor, truth: dict, fed: int,
          elem_idx: list, prog_pairs: dict, outputs: dict):
    """The numbers compared, each ``{"value", "limit"}``, and the count of
    answers that failed a limit.  ``prog_pairs`` are the program's function-A
    elements (pair ``i`` registers frame ``i + 1`` to frame ``i``),
    ``outputs`` its ``phi_{0,i}`` for i = 0..fed-1."""
    limits = cfg["checks"]
    h, w = frames.shape[1:]
    n_pairs = fed - 1
    failed = set()
    checks = {}

    def note(name, gaps, index):
        value, bad = judge.hold(gaps, len(index), limits[name])
        failed.update(index[j] for j in bad)
        checks[name] = {"value": value, "limit": limits[name]}

    ok_idx = elem_idx == list(range(n_pairs))
    if "pair_truth_px" in limits:
        want = series.pair_truth(truth["angle"][:fed], truth["shift"][:fed])
        gaps = (judge.corner_gaps(prog_pairs, want, h, w) if ok_idx
                else torch.full((n_pairs,), float("inf"), dtype=torch.float64))
        note("pair_truth_px", gaps, list(range(n_pairs)))
    if "pair_ref_px" in limits:
        gaps, index = [], []
        for block in _blocks(seed, n_pairs, int(cfg["pair_ref_blocks"])):
            got, _ = ref_registration.register(
                frames[block], frames[[i + 1 for i in block]],
                cfg["registration"])
            got = {k: v.detach().to("cpu") for k, v in got.items()}
            mine = ({k: v[block] for k, v in prog_pairs.items()} if ok_idx
                    else {k: torch.full_like(v, float("nan")) for k, v in got.items()})
            gaps.append(judge.corner_gaps(mine, got, h, w))
            index += block
        note("pair_ref_px", torch.cat(gaps), index)
    out = {k: v[1:fed] for k, v in outputs.items()}
    if "chain_px" in limits:
        want = ref_compose.chain(prog_pairs) if ok_idx else None
        gaps = (judge.corner_gaps(out, want, h, w) if want is not None
                and out["angle"].shape[0] == n_pairs
                else torch.full((n_pairs,), float("inf"), dtype=torch.float64))
        note("chain_px", gaps, list(range(n_pairs)))
    whole = out["angle"].shape[0] == n_pairs
    want = {k: v[1:fed] for k, v in truth.items()}
    if "truth_shift_px" in limits:
        gaps = (judge.shift_gaps(out, want) if whole
                else torch.full((n_pairs,), float("inf"), dtype=torch.float64))
        note("truth_shift_px", gaps, list(range(n_pairs)))
    if "truth_corner_px" in limits:
        gaps = (judge.corner_gaps(out, want, h, w) if whole
                else torch.full((n_pairs,), float("inf"), dtype=torch.float64))
        note("truth_corner_px", gaps, list(range(n_pairs)))
    return checks, len(failed)


def _print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"portbench check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    need = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: {args.workload} needs {need} CUDA device(s); this "
              f"machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    try:
        line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    finally:
        from repro_torch.runtime.scheduler import get_default_pool

        # Stop the program's worker threads and wait for them.
        pool = get_default_pool()
        pool.shutdown()
        pool.join(timeout=60)
    found = _forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found} (JAX or the JAX package); "
              "no result", file=sys.stderr)
        return 3
    _print_checks(line["checks"])
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
