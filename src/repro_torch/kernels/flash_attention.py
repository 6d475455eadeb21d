"""Causal flash attention: the CUDA kernel and its plain version.

Port of ``repro/kernels/flash_attention.py``.  ``q, k, v`` are ``(BH, L,
d)`` with matching head counts (GQA kv heads are repeated upstream, in
``ops.attention``); the output is in ``q``'s dtype.  The causal mask is
aligned top-left (``rows >= cols``), masked scores are ``NEG_INF = -1e30``,
and a denominator of 0 reads as 1, all as in the TPU kernel.  The wrapper
keeps the TPU kernel's block checks (``blk = min(block, L)``, ``L % blk ==
0``); the CUDA kernels tile by 64 x 64 whatever the blocks, and their result
does not depend on them beyond float32 rounding.

:func:`flash_attention` takes its route from where its tensors lie: CPU
tensors run :func:`flash_attention_reference`; CUDA tensors launch
``csrc/flash_attention.cu`` (built at first use) or raise.  The library
holds two kernels and the dtype picks one: bfloat16 runs both products on
the tensor cores (``wgmma``, f32 accumulators, P as two bf16 terms in
P·V); float32 runs them on the CUDA cores in full float32, since ``wgmma``
on float32 operands would be TF32.  Both take ``d`` a multiple of 8 up to
128.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _cuda

NAME = "flash_attention"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:76"
LAUNCHES = _cuda.launch_counter(NAME)
#: The non-causal ones among LAUNCHES (an encoder's), counted beside it.
LAUNCHES_NONCAUSAL = _cuda.launch_counter(NAME + "_noncausal")

NEG_INF = -1e30
MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_blocks(q, k, v, block_q: int, block_k: int) -> Tuple[int, int, int, int]:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or (
        k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]
    ):
        raise ValueError(
            "flash_attention takes q (BH, Lq, d) and k, v (BH, Lk, d), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    bh, lq, d = q.shape
    lk = k.shape[1]
    blk_q = min(block_q, lq)
    blk_k = min(block_k, lk)
    assert lq % blk_q == 0 and lk % blk_k == 0
    return bh, lq, lk, d


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None,
                              block_q: int = 256, block_k: int = 512):
    """Plain PyTorch version of :func:`flash_attention`: the whole softmax
    at once, with the TPU kernel's mask and denominator rule."""
    bh, lq, lk, d = _check_blocks(q, k, v, block_q, block_k)
    scale = (d ** -0.5) if scale is None else scale
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    if causal:
        rows = torch.arange(lq, device=q.device)[:, None]
        cols = torch.arange(lk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, 1.0, denom)
    return ((p @ v.float()) / denom).to(q.dtype)


def _launcher():
    lib = _cuda.load(NAME)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:  # argtypes last: it marks the entry as typed
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
    return fn, lib.flash_attention_error_string


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         scale: Optional[float] = None,
                         block_q: int = 256, block_k: int = 512):
    """Launch the kernel; raises on anything it does not take (device,
    dtype, layout, head dim)."""
    _cuda.refuse_autograd("flash_attention kernel", q, k, v)
    bh, lq, lk, d = _check_blocks(q, k, v, block_q, block_k)
    if not (8 <= d <= MAX_D and d % 8 == 0):
        raise ValueError(f"flash_attention kernel: head dim {d} is not a "
                         f"multiple of 8 in 8..{MAX_D}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel: q is {q.dtype}, not "
                        "float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} is on {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention kernel: {name} is {t.dtype}, "
                            f"q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} is not "
                             "contiguous")
    scale = (d ** -0.5) if scale is None else scale
    if q.dtype == torch.bfloat16:
        # The bf16 kernel copies 16-byte pieces of rows (cp.async).
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    fn, error_string = _launcher()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), bh, lq, lk, d, scale, int(causal), stream)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"({err})")
    LAUNCHES.add()
    if not causal:
        LAUNCHES_NONCAUSAL.add()
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, block_q: int = 256,
                    block_k: int = 512):
    """q, k, v: (BH, L, d) with matching head counts (repeat GQA kv
    upstream).  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         block_q=block_q, block_k=block_k)
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                block_q=block_q, block_k=block_k)


def ensure_built() -> float:
    """Build the kernel if this process has not; returns the seconds."""
    return _cuda.build([NAME])
