"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Ported so far (CUDA C++): ``warp_ncc`` (``csrc/warp_ncc.cu``),
``lookback_scan`` (``csrc/lookback_scan.cu``), ``tile_local_scan`` and
``tile_apply`` (``csrc/tile_scan.cu``).  The scan kernels run the operators
of ``op_table.py``; ``_tiling.py`` packs trees of tensors into their rows.

Modules here import ``torch`` only; a kernel is built at its first launch
(``_cuda.py``), never at import.
"""

from ._cuda import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
