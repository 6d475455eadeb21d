"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version, all CUDA C++: ``warp_ncc`` (``csrc/warp_ncc.cu``), function A's
gradient step ``ncc_grad`` (``csrc/ncc_grad.cu``, a kernel of the port
alone), ``lookback_scan`` (``csrc/lookback_scan.cu``), ``tile_local_scan`` and
``tile_apply`` (``csrc/tile_scan.cu``), ``fused_round``
(``csrc/fused_round.cu``), and the LM kernels ``chunk_local`` and
``chunk_apply`` (``csrc/chunk_scan.cu``) and ``flash_attention``
(``csrc/flash_attention.cu``), which ``ops.py`` wraps as the model's SSD
scan and attention (``ref.py`` holds their oracles).  The scan kernels run
the operators of ``op_table.py``; ``_tiling.py`` packs trees of tensors
into their rows.

Modules here import ``torch`` only; a kernel is built at its first launch
(``_cuda.py``), never at import.
"""

from ._cuda import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
