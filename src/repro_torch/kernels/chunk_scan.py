"""The SSD chunk kernels: CUDA kernels and their plain versions.

Port of ``repro/kernels/chunk_scan.py``.  Two kernels carry the two *local*
phases of the paper's reduce-then-scan (§4.1) applied to the Mamba2 / SSD
recurrence (``ops.ssd_scan``); the *global* phase, the inter-chunk scan of
(decay, state) summaries, runs outside them.

* :func:`chunk_local` — per flattened (batch, head, chunk) index g:
  ``att = C Bᵀ``, ``y_intra = (att ⊙ D) V`` with the causal decay mask
  ``D = exp(where(causal, ca[t] - ca[s], -1e30))``, and the state summary
  ``s = (B ⊙ exp(ca[L-1] - ca))ᵀ V``; ``y_intra`` in ``v``'s dtype, ``s``
  in float32.
* :func:`chunk_apply` — ``y = y_intra + (C ⊙ exp(ca)) S_prev`` in
  ``y_intra``'s dtype.

Each takes its route from where its tensors lie: CPU tensors run the plain
PyTorch version; CUDA tensors launch ``csrc/chunk_scan.cu`` (built at first
use) or raise.  The kernels take float32 or bfloat16 operands (``ca``,
``s`` and ``s_prev`` float32), ``L <= 128`` and ``dk, dv`` multiples of 8
up to 256, and the operands' dtype picks the kernel: bfloat16 runs the
products on the tensor cores (``wgmma``; float32 products such as
``att ⊙ D`` enter them as two bf16 terms), float32 the CUDA-core kernels,
which keep float32 products throughout.  The bf16 kernels pad L and d with
zeros in shared memory; above 128 (the mLSTM's dk = dv = 256) every kernel
takes dv in tiles of at most 128 columns, a block a (g, tile).  Nothing
falls back from one route to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _cuda

LIBRARY = "chunk_scan"
SOURCE = "src/repro_torch/kernels/csrc/chunk_scan.cu"
LOCAL_NAME = "chunk_local"
APPLY_NAME = "chunk_apply"
LOCAL_REPLACES = "src/repro/kernels/chunk_scan.py:72"
APPLY_REPLACES = "src/repro/kernels/chunk_scan.py:101"
LOCAL_LAUNCHES = _cuda.launch_counter(LOCAL_NAME)
APPLY_LAUNCHES = _cuda.launch_counter(APPLY_NAME)

MAX_L = 128
MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _causal(l: int, device) -> torch.Tensor:
    row = torch.arange(l, device=device)
    return row[:, None] >= row[None, :]


def chunk_local_reference(c, b, v, ca) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`chunk_local`, batched over g."""
    _local_shapes(c, b, v, ca)
    c32, b32, v32 = c.float(), b.float(), v.float()
    ca32 = ca.float()                                   # (G, L, 1)
    l = c.shape[1]
    att = c32 @ b32.transpose(1, 2)                     # (G, L, L)
    delta = ca32 - ca32.transpose(1, 2)                 # ca[t] - ca[s]
    d = torch.exp(torch.where(_causal(l, c.device), delta, -1e30))
    y = ((att * d) @ v32).to(v.dtype)
    decay_to_end = torch.exp(ca32[:, l - 1:l] - ca32)   # (G, L, 1)
    s = (b32 * decay_to_end).transpose(1, 2) @ v32      # (G, dk, dv)
    return y, s


def chunk_apply_reference(c, ca, y_intra, s_prev) -> torch.Tensor:
    """Plain PyTorch version of :func:`chunk_apply`, batched over g."""
    _apply_shapes(c, ca, y_intra, s_prev)
    inter = (c.float() * torch.exp(ca.float())) @ s_prev.float()
    return (y_intra.float() + inter).to(y_intra.dtype)


def _local_shapes(c, b, v, ca) -> Tuple[int, int, int, int]:
    if c.dim() != 3 or b.shape != c.shape or v.dim() != 3 or (
        v.shape[:2] != c.shape[:2]
    ) or ca.shape != (*c.shape[:2], 1):
        raise ValueError(
            "chunk_local takes c, b (G, L, dk), v (G, L, dv) and ca "
            f"(G, L, 1), got {tuple(c.shape)}, {tuple(b.shape)}, "
            f"{tuple(v.shape)}, {tuple(ca.shape)}"
        )
    g, l, dk = c.shape
    return g, l, dk, v.shape[2]


def _apply_shapes(c, ca, y_intra, s_prev) -> Tuple[int, int, int, int]:
    if c.dim() != 3 or y_intra.dim() != 3 or (
        y_intra.shape[:2] != c.shape[:2]
    ) or ca.shape != (*c.shape[:2], 1) or s_prev.shape != (
        c.shape[0], c.shape[2], y_intra.shape[2]
    ):
        raise ValueError(
            "chunk_apply takes c (G, L, dk), ca (G, L, 1), y_intra "
            f"(G, L, dv) and s_prev (G, dk, dv), got {tuple(c.shape)}, "
            f"{tuple(ca.shape)}, {tuple(y_intra.shape)}, "
            f"{tuple(s_prev.shape)}"
        )
    g, l, dk = c.shape
    return g, l, dk, y_intra.shape[2]


def _check_kernel_args(what: str, l: int, dk: int, dv: int, operands,
                       f32s) -> int:
    """Raise on anything the kernel does not take; its dtype code."""
    if not 1 <= l <= MAX_L:
        raise ValueError(f"{what} kernel: chunk length {l} outside 1..{MAX_L}")
    for name, dim in (("dk", dk), ("dv", dv)):
        if not (8 <= dim <= MAX_D and dim % 8 == 0):
            raise ValueError(f"{what} kernel: {name}={dim} is not a multiple "
                             f"of 8 in 8..{MAX_D}")
    device = operands[0][1].device
    dtype = operands[0][1].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{what} kernel: operands are {dtype}, not float32 "
                        "or bfloat16")
    for name, t in (*operands, *f32s):
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{what} kernel: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel: {name} is not contiguous")
    for name, t in operands:
        if t.dtype != dtype:
            raise TypeError(f"{what} kernel: {name} is {t.dtype}, the other "
                            f"operands {dtype}")
    for name, t in f32s:
        if t.dtype != torch.float32:
            raise TypeError(f"{what} kernel: {name} is {t.dtype}, not f32")
    return _DTYPES[dtype]


def _entries():
    """The library's launch and error-string entry points, typed."""
    lib = _cuda.load(LIBRARY)
    local, apply = lib.chunk_local_launch, lib.chunk_apply_launch
    if apply.argtypes is None:  # argtypes last: it marks the entries typed
        lib.chunk_scan_error_string.restype = ctypes.c_char_p
        lib.chunk_scan_error_string.argtypes = [ctypes.c_int]
        local.restype = ctypes.c_int
        local.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                          + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        apply.restype = ctypes.c_int
        apply.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                          + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return local, apply, lib.chunk_scan_error_string


def _aligned(*ts):
    """The bf16 kernels copy and read 16-byte pieces of rows (by cp.async
    or TMA): a tensor that starts off a 16-byte boundary (a view) is copied
    to one that does not."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def _raise_on(err: int, what: str, error_string) -> None:
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def chunk_local_cuda(c, b, v, ca) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the ``chunk_local`` kernel; raises on anything it does not
    take (device, dtype, layout, sizes)."""
    _cuda.refuse_autograd("chunk_local kernel", c, b, v, ca)
    g, l, dk, dv = _local_shapes(c, b, v, ca)
    code = _check_kernel_args("chunk_local", l, dk, dv,
                              (("c", c), ("b", b), ("v", v)), (("ca", ca),))
    if code == _DTYPES[torch.bfloat16]:
        c, b, v, ca = _aligned(c, b, v, ca)
    local, _apply, error_string = _entries()
    with torch.cuda.device(c.device):
        y = torch.empty((g, l, dv), dtype=v.dtype, device=c.device)
        s = torch.empty((g, dk, dv), dtype=torch.float32, device=c.device)
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = local(code, c.data_ptr(), b.data_ptr(), v.data_ptr(),
                    ca.data_ptr(), y.data_ptr(), s.data_ptr(), g, l, dk, dv,
                    stream)
    _raise_on(err, "chunk_local", error_string)
    LOCAL_LAUNCHES.add()
    return y, s


def chunk_apply_cuda(c, ca, y_intra, s_prev) -> torch.Tensor:
    """Launch the ``chunk_apply`` kernel; raises on anything it does not
    take."""
    _cuda.refuse_autograd("chunk_apply kernel", c, ca, y_intra, s_prev)
    g, l, dk, dv = _apply_shapes(c, ca, y_intra, s_prev)
    code = _check_kernel_args("chunk_apply", l, dk, dv,
                              (("c", c), ("y_intra", y_intra)),
                              (("ca", ca), ("s_prev", s_prev)))
    if code == _DTYPES[torch.bfloat16]:
        c, y_intra, s_prev = _aligned(c, y_intra, s_prev)
    _local, apply, error_string = _entries()
    with torch.cuda.device(c.device):
        out = torch.empty((g, l, dv), dtype=y_intra.dtype, device=c.device)
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = apply(code, c.data_ptr(), ca.data_ptr(), y_intra.data_ptr(),
                    s_prev.data_ptr(), out.data_ptr(), g, l, dk, dv, stream)
    _raise_on(err, "chunk_apply", error_string)
    APPLY_LAUNCHES.add()
    return out


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def chunk_local(c, b, v, ca) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-local reduce: ``(y_intra (G, L, dv), s_chunk (G, dk, dv))``.

    c, b: (G, L, dk) — G = batch*heads*num_chunks flattened; v: (G, L, dv);
    ca: (G, L, 1) inclusive cumulative log-decay.  CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    if _on_cpu(c, b, v, ca):
        return chunk_local_reference(c, b, v, ca)
    return chunk_local_cuda(c, b, v, ca)


def chunk_apply(c, ca, y_intra, s_prev) -> torch.Tensor:
    """Chunk-local apply: fold the inter-chunk state into the outputs.

    c (G, L, dk); ca (G, L, 1); y_intra (G, L, dv); s_prev (G, dk, dv).
    Returns y (G, L, dv) in ``y_intra``'s dtype.
    """
    if _on_cpu(c, ca, y_intra, s_prev):
        return chunk_apply_reference(c, ca, y_intra, s_prev)
    return chunk_apply_cuda(c, ca, y_intra, s_prev)


def ensure_built() -> float:
    """Build the library if this process has not; returns the seconds."""
    return _cuda.build([LIBRARY])
