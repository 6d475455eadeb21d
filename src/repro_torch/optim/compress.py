"""Gradient compression for the data-parallel all-reduce (port of
``repro/optim/compress.py``).

int8 block-quantized all-reduce with error feedback: quantize -> psum ->
dequantize, with the quantization residual carried to the next step.
Called inside ``spmd.shard_map`` data-parallel bodies, where the reference
calls it inside ``shard_map``: the sum is ``spmd.psum`` of the dequantized
values, as the reference's is ``lax.psum``.  The wire format it stands for
is the int8 payload plus one float32 scale a block (``wire_bytes``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import spmd
from repro_torch.core._tree import tree_flatten, tree_unflatten

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization. Returns (q, scales): q of
    shape (blocks, BLOCK), scales (blocks, 1) float32; a block of zeros
    gets scale 1.  Rounds half to even, as ``jnp.round``."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape)).to(dtype)


def wire_bytes(numel: int) -> int:
    """Bytes of one leaf's int8 payload plus its float32 block scales."""
    blocks = -(-numel // BLOCK)
    return blocks * BLOCK + 4 * blocks


def compressed_psum(
    x: torch.Tensor, axis_name: str, *, residual: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-compressed all-reduce with error feedback.

    Returns (summed, new_residual).  Call inside ``spmd.shard_map`` over
    ``axis_name``.
    """
    y = x if residual is None else x + residual.to(x.dtype)
    q, scale = quantize_int8(y)
    deq = dequantize_int8(q, scale, x.shape, torch.float32)
    new_residual = y.to(torch.float32) - deq
    summed = spmd.psum(deq, axis_name)
    return summed.to(x.dtype), new_residual


def compressed_psum_tree(grads, axis_name: str, residuals=None):
    """Tree-mapped compressed_psum; residuals tree carried across steps."""
    leaves, treedef = tree_flatten(grads)
    res_leaves = (tree_flatten(residuals)[0] if residuals is not None
                  else [None] * len(leaves))
    out, res = [], []
    for g, r in zip(leaves, res_leaves):
        s, nr = compressed_psum(g, axis_name, residual=r)
        out.append(s)
        res.append(nr)
    return tree_unflatten(treedef, out), tree_unflatten(treedef, res)
