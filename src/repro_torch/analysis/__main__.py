"""CLI for the correctness tooling (port of ``repro/analysis/__main__.py``):
``python -m repro_torch.analysis``.

Subcommands (default ``all``):

* ``lint``    — run the static invariant lint over the configured tree
  (THR/OPC/KRN plus the LCK lockset-inference pass over
  ``lockset_modules``).
* ``explore`` — run the deterministic schedule-explorer suite (exhaustive
  small configs + seeded sampled large ones, including the serving
  front-end twin) plus the invariant-wrapped simulator-twin sweep.
* ``all``     — both engines; exit status is non-zero on any finding.

``--fast`` switches the explorer to its sub-second smoke subset.
"""

from __future__ import annotations

import argparse
import sys
import time


def _run_lint() -> int:
    from .lint import run_lint

    findings = run_lint()
    for f in findings:
        print(f)
    print(f"lint: {len(findings)} finding(s)")
    return 1 if findings else 0


def _run_explore(fast: bool) -> int:
    from .schedule import standard_suite, verify_simulator_twin

    failures = 0
    t0 = time.perf_counter()
    for name, res in standard_suite(fast=fast):
        status = "ok" if res.ok else "FAIL"
        cov = "exhaustive" if res.exhausted else "sampled/bounded"
        print(
            f"explore {name:32s} {status:4s} "
            f"{res.schedules:>7d} schedules ({cov})"
        )
        if not res.ok:
            failures += 1
            for v in res.violations[:5]:
                print(f"    [{v.invariant}] {v.detail}")
                print(f"    schedule: {list(v.schedule)}")
    sim_violations = verify_simulator_twin()
    status = "ok" if not sim_violations else "FAIL"
    print(f"explore {'sim/cross-twin-sweep':32s} {status}")
    for v in sim_violations[:5]:
        print(f"    [{v.invariant}] {v.detail}")
    if sim_violations:
        failures += 1
    dt = time.perf_counter() - t0
    print(f"explore: {failures} failing config(s) in {dt:.1f}s")
    return 1 if failures else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant + lockset lint, deterministic "
                    "schedule explorer (stealing/lookback/serving twins)",
    )
    parser.add_argument(
        "command", nargs="?", default="all", choices=("lint", "explore", "all")
    )
    parser.add_argument(
        "--fast", action="store_true",
        help="explorer smoke subset (skip sampled/large configs)",
    )
    args = parser.parse_args(argv)

    rc = 0
    if args.command in ("lint", "all"):
        rc |= _run_lint()
    if args.command in ("explore", "all"):
        rc |= _run_explore(args.fast)
    return rc


if __name__ == "__main__":
    sys.exit(main())
