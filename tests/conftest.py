# NOTE: no XLA_FLAGS here on purpose — unit tests and benches run on the
# single real CPU device; only launch/dryrun.py (its own process) forces 512
# placeholder devices.  Multi-device tests spawn subprocesses (see
# tests/test_distributed_scan.py) with the flag set in the child env.
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running tests (multi-device subprocesses, big sims); "
        "deselect with -m 'not slow'",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the PyTorch/CUDA port's kernels); skips "
        "without one — run with -m gpu on the card",
    )


def pytest_sessionfinish(session, exitstatus):
    """Surface happens-before sanitizer reports as a run failure.

    Under ``REPRO_CHECK_INVARIANTS=1`` the kinded sync points feed the
    process-wide vector-clock RaceTracker; a race observed anywhere in the
    run (even inside an otherwise-passing test) must fail CI's sanitizer
    job.  A no-op in normal runs: the gate is off and the tracker is never
    created.
    """
    try:
        from repro.analysis import sync as _sync
    except Exception:
        return
    if not _sync.invariants_enabled() or _sync._tracker is None:
        return
    races = _sync._tracker.races()
    if races:
        rep = session.config.pluginmanager.get_plugin("terminalreporter")
        lines = [f"  {r}" for r in races]
        msg = "happens-before sanitizer reported races:\n" + "\n".join(lines)
        if rep is not None:
            rep.write_sep("=", "RACE SANITIZER", red=True)
            rep.write_line(msg)
        else:
            print(msg)
        session.exitstatus = 1


def run_in_subprocess(code: str, *, devices: int = 8, timeout: int = 600):
    """Run a python snippet with N virtual host devices; returns stdout."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=timeout, env=env,
    )
    if out.returncode != 0:
        raise AssertionError(
            f"subprocess failed:\nSTDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
        )
    return out.stdout


@pytest.fixture(scope="session")
def subproc():
    return run_in_subprocess
