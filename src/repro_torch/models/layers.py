"""Primitive layers: functional init/apply pairs over plain dict trees
(port of ``repro/models/layers.py``).

Inits draw from a ``torch.Generator`` and allocate on its device; they give
other numbers than the reference's ``jax.random`` keys, so the tests carry
the reference's parameters across (``interop.params_from_numpy``).  The
reference's ``shardctx`` constraints are no-ops without a mesh and are
dropped here.  ``chunked_cross_entropy`` and ``softmax_cross_entropy``
belong to training and come with it (``ROADMAP.md``).
"""

from __future__ import annotations

import math

import torch


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen, d_in: int, d_out: int, dtype, *, bias: bool = False,
               scale=None):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    w = _normal(gen, (d_in, d_out)).mul_(scale)
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def embed_init(gen, vocab: int, d: int, dtype):
    return {"table": _normal(gen, (vocab, d)).mul_(0.02).to(dtype)}


def embed(p, ids):
    return p["table"][ids]


def rope_freqs(hd: int, theta: float, device=None):
    return theta ** (-torch.arange(0, hd // 2, dtype=torch.float32,
                                   device=device) / (hd // 2))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, H, L, hd); positions: (B, L) or (L,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)       # (hd/2,)
    if positions.dim() == 1:
        ang = positions[:, None].float() * freqs[None, :]
        ang = ang[None, None]                            # (1,1,L,hd/2)
    else:
        ang = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x):
    """x * sigmoid(x) as the reference computes it: ``jax.nn.silu`` lowers
    to x * (1 / (1 + exp(-x))), and XLA rounds each of those operations to
    x's type.  ``F.silu`` rounds once; in bf16 that differs from the
    reference in ~40% of the elements, and the difference grows with
    depth."""
    return x * torch.reciprocal(torch.exp(-x) + 1)


def swiglu_init(gen, d: int, f: int, dtype):
    return {
        "w1": dense_init(gen, d, f, dtype),     # gate
        "w3": dense_init(gen, d, f, dtype),     # up
        "w2": dense_init(gen, f, d, dtype),     # down
    }


def swiglu(p, x):
    return dense(p["w2"], silu(dense(p["w1"], x)) * dense(p["w3"], x))


def head_init(gen, d: int, vocab: int, n_chunks: int, dtype):
    """Unembedding stored chunk-major: (NC, D, V/NC), as the reference
    keeps it for its vocab-chunked loss."""
    assert vocab % n_chunks == 0
    w = _normal(gen, (n_chunks, d, vocab // n_chunks))
    return {"w": w.div_(math.sqrt(d)).to(dtype)}


def head_logits(p, x, softcap: float = 0.0):
    """Materialized logits (tests / decode / small models)."""
    logits = torch.einsum("bld,cdv->blcv", x, p["w"])
    logits = logits.reshape(*x.shape[:-1], -1).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
