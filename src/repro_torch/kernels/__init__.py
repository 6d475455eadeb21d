"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Ported so far: ``warp_ncc`` (CUDA C++, ``csrc/warp_ncc.cu``).

Modules here import ``torch`` only; a kernel is built at its first launch
(``_cuda.py``), never at import.
"""

from ._cuda import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
