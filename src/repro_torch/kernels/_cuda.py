"""Build, load and count the port's hand-written CUDA kernels.

Each kernel library is one ``csrc/<name>.cu`` with a plain C interface
(the scan kernels share ``csrc/scan_ops.cuh``).  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` at the repository root and loaded with ``ctypes``.
The library's file name carries a hash of the source, the shared headers
and the flags, so an edited source rebuilds and a stale library is never
loaded.  Nothing here
runs at import: ``import repro_torch`` never needs ``nvcc``.

Every kernel wrapper owns a :class:`LaunchCounter` registered here, which it
bumps exactly where it launches the kernel; ``launch_counts()`` and
``reset_launch_counts()`` let a run show which kernels its path went
through.

No kernel here has a backward: :func:`refuse_autograd` is each wrapper's
guard against a launch whose output autograd would need to differentiate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "kernels", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG)), "build",
                         "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # No fused multiply-add contraction: the kernels repeat the plain
    # PyTorch versions' arithmetic (separate mul / add / sub) term by term.
    "-fmad=false",
    "-Xptxas", "-v",
)


class LaunchCounter:
    """Thread-safe count of one kernel's launches."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._n


_counters: Dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    """The process-wide counter of kernel ``name`` (created on first use)."""
    return _counters.setdefault(name, LaunchCounter(name))


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in _counters.items()}


def reset_launch_counts() -> None:
    for c in _counters.values():
        c.reset()


def refuse_autograd(what: str, *tensors) -> None:
    """Raise when autograd would need ``what``'s backward: grad mode is on
    and an operand requires grad.  A kernel launched through ctypes writes
    a fresh tensor with no ``grad_fn``, so a backward pass through it would
    silently drop the gradient of everything upstream.  The reference
    defines no backward for its Pallas kernels either (``jax.grad``
    through them raises); training runs on the "xla" backends.  Operands
    that are not tensors are ignored; under ``torch.no_grad()`` or with
    detached operands nothing is checked further."""
    if not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: no gradient through a kernel.  The reference defines "
            "no backward for its Pallas kernels, and neither does the port; "
            "train on the \"xla\" backends, or run the kernel under "
            "torch.no_grad() / on detached tensors"
        )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled at first use "
        "on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> str:
    """Where kernel ``name``'s library for the current source lands."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # The source and every shared header it may include.
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


class _Build:
    def __init__(self, name: str):
        self.name = name
        self.out = library_path(name)
        self.tmp = f"{self.out}.{os.getpid()}.{threading.get_ident()}.tmp"
        self.proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        if os.path.exists(self.out):
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", self.tmp,
               os.path.join(CSRC, f"{self.name}.cu")]
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )

    def finish(self) -> str:
        """Wait for nvcc; returns its output ('' when already built)."""
        if self.proc is None:
            return ""
        out, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.name}.cu:\n{out}")
        os.replace(self.tmp, self.out)
        return out


_libs: Dict[str, ctypes.CDLL] = {}
_build_log: Dict[str, str] = {}
_lock = threading.Lock()


def build(names: Sequence[str]) -> float:
    """Compile the named kernels that are not built yet, all ``nvcc``
    processes started together; returns the seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs: List[_Build] = [_Build(n) for n in names if n not in _libs]
        for j in jobs:
            j.start()
        for j in jobs:
            _build_log[j.name] = j.finish()
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v`` register and spill report) of the
    build of ``name`` in this process, '' if it was already built."""
    return _build_log.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(library_path(name))
    return lib
