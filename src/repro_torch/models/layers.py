"""Primitive layers: functional init/apply pairs over plain dict trees
(port of ``repro/models/layers.py``).

Inits draw from a ``torch.Generator`` and allocate on its device; they give
other numbers than the reference's ``jax.random`` keys, so the tests carry
the reference's parameters across (``interop.params_from_numpy``).  Every
init helper takes its parameters' storage from :func:`param` and draws
into it in float32 pieces (:func:`normal_param`), so no whole-matrix
float32 copy lives beside the weights; :func:`params_into` hands that
storage out from tensors the caller made (``lm.init_params`` fills its
stacked leaves a superblock at a time) or walks the shapes on the meta
device.  ``dense`` and the loss's vocabulary chunks call the ``shardctx``
anchors where the reference does.  The training loss is
``chunked_cross_entropy``: an online logsumexp over the chunk-major head's
vocabulary chunks, each chunk recomputed in the backward pass, so (B, L, V)
logits never exist; ``softmax_cross_entropy`` over materialized logits is
its oracle.  On a mesh each rank takes the loss of its own batch rows
against its "model" block of the head's vocabulary
(``shardctx.local_vocab``).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch.utils.checkpoint import checkpoint

from . import shardctx

# Values a float32 draw holds at a time (64 MB).
_PIECE = 1 << 24
_into = threading.local()


@contextlib.contextmanager
def params_into(targets=None):
    """Inside, :func:`param` takes each parameter's storage from
    ``targets`` in the order the init helpers make them, or, with
    ``targets=None``, makes it on the meta device, where nothing is drawn.
    Yields the list of tensors handed out."""
    made = []
    prev = getattr(_into, "state", None)
    _into.state = (None if targets is None else iter(targets), made)
    try:
        yield made
    finally:
        _into.state = prev


def param(shape, dtype, device) -> torch.Tensor:
    """Storage for one parameter: the next tensor of the active
    :func:`params_into`, else a new tensor on ``device``."""
    state = getattr(_into, "state", None)
    if state is None:
        return torch.empty(shape, dtype=dtype, device=device)
    targets, made = state
    if targets is None:
        t = torch.empty(shape, dtype=dtype, device="meta")
    else:
        t = next(targets)
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"parameter target {tuple(t.shape)} {t.dtype} "
                             f"for a {tuple(shape)} {dtype} parameter")
    made.append(t)
    return t


def normal_param(gen: torch.Generator, shape, dtype,
                 scale: float = 1.0) -> torch.Tensor:
    """A parameter of N(0, 1) draws times ``scale``, drawn in float32 pieces
    of at most ``_PIECE`` values and rounded into its dtype."""
    t = param(shape, dtype, gen.device)
    if t.is_meta:
        return t
    flat = t.view(-1)
    for i in range(0, flat.numel(), _PIECE):
        n = min(_PIECE, flat.numel() - i)
        flat[i:i + n] = torch.randn(n, generator=gen, device=gen.device,
                                    dtype=torch.float32).mul_(scale)
    return t


def const_param(shape, value: float, dtype, device) -> torch.Tensor:
    """A parameter filled with ``value``."""
    t = param(shape, dtype, device)
    if not t.is_meta:
        t.fill_(value)
    return t


def dense_init(gen, d_in: int, d_out: int, dtype, *, bias: bool = False,
               scale=None):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    p = {"w": normal_param(gen, (d_in, d_out), dtype, scale)}
    if bias:
        p["b"] = const_param((d_out,), 0.0, dtype, gen.device)
    return p


def dense(p, x):
    y = shardctx.seq_gathered_grad(shardctx.gather_seq(x) @ p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(d: int, dtype, device=None):
    return {"scale": const_param((d,), 1.0, dtype, device)}


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, device=None):
    return {"scale": const_param((d,), 1.0, dtype, device),
            "bias": const_param((d,), 0.0, dtype, device)}


def layernorm(p, x, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def embed_init(gen, vocab: int, d: int, dtype):
    return {"table": normal_param(gen, (vocab, d), dtype, 0.02)}


def embed(p, ids):
    if hasattr(p["table"], "device_mesh"):
        return shardctx.local_embed(p["table"], ids)
    return p["table"][ids]


def unembed(p, x, softcap: float = 0.0):
    logits = (x @ p["table"].T).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


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
    return dense(p["w2"],
                 silu(dense(p["w1"], x)) * dense(p["w3"], x))


def head_init(gen, d: int, vocab: int, n_chunks: int, dtype):
    """Unembedding stored chunk-major: (NC, D, V/NC), as the reference
    keeps it for its vocab-chunked loss."""
    assert vocab % n_chunks == 0
    return {"w": normal_param(gen, (n_chunks, d, vocab // n_chunks), dtype,
                              1.0 / math.sqrt(d))}


def head_logits(p, x, softcap: float = 0.0):
    """Materialized logits (tests / decode / small models); on a mesh each
    rank's vocab blocks, joined (``shardctx.vocab_logits``)."""
    if hasattr(x, "device_mesh"):
        logits = shardctx.vocab_logits(
            lambda w, x: torch.einsum("bld,cdv->blcv", x, w), p["w"], x)
    else:
        logits = torch.einsum("bld,cdv->blcv", x, p["w"])
    logits = logits.reshape(*x.shape[:-1], -1).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def softmax_cross_entropy(logits, labels, ignore_id: int = -1):
    """logits (..., V) fp32; labels (...) int; mean over non-ignored."""
    mask = labels != ignore_id
    labels = torch.where(mask, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def _ce_chunk(m, s, gold, x, w, is_here, chunk_pos, softcap: float):
    """One vocabulary chunk of :func:`chunked_cross_entropy`: the chunk's
    logits, folded into the running max ``m``, the rescaled sum of
    exponentials ``s`` and the gold logit of the labels that fall in it."""
    lg = (x @ w).float()                                    # (B, L, vc)
    lg = shardctx.constrain_vocab_chunk(lg)
    if softcap:
        lg = torch.tanh(lg / softcap) * softcap
    m_new = torch.maximum(m, lg.amax(-1))
    s = s * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
    g = torch.gather(lg, -1, chunk_pos[..., None])[..., 0]
    gold = gold + torch.where(is_here, g, 0.0)
    return m_new, s, gold


def chunked_cross_entropy(p, x, labels, *, softcap: float = 0.0,
                          ignore_id: int = -1):
    """CE over a chunk-major head without materializing full logits.

    A loop over the head's (NC, D, V/NC) vocabulary chunks with an online
    logsumexp, as the reference's ``lax.scan``.  Under grad each chunk runs
    inside a non-reentrant ``torch.utils.checkpoint``, so the backward pass
    re-runs its matmul (the reference's scan-remat): one extra head matmul
    for O(V/NC) live memory instead of O(V).
    """
    if hasattr(x, "device_mesh"):
        # On a mesh each rank takes the loss of its batch rows against its
        # vocab block of the head: one partial sum of nll and of tokens.
        vc = p["w"].shape[2]
        nll, count = shardctx.local_vocab(
            lambda w, x, labels, lo: _ce_parts(w, x, labels, softcap,
                                               ignore_id, vc, lo),
            p["w"], x, labels)
    else:
        logz, gold, mask = _ce_parts(p["w"], x, labels, softcap, ignore_id)
        nll = (logz - gold) * mask
        nll, count = nll.sum(), mask.sum()
    return nll / torch.clamp(count, min=1)


def _ce_parts(head_w, x, labels, softcap: float, ignore_id: int,
              vc=None, lo: int = 0):
    """Each token's (logsumexp, gold logit, non-ignored mask) over a
    chunk-major head (NC, D, V/NC), or over the columns ``lo:lo +
    head_w.shape[2]`` of each of its chunks of ``vc`` columns (a "model"
    rank's block): the gold logit is 0 where the label lies elsewhere."""
    nc, d, vc_here = head_w.shape
    vc = vc_here if vc is None else vc
    mask = labels != ignore_id
    labels_s = torch.where(mask, labels, 0).long()
    chunk_id = labels_s // vc
    chunk_pos = labels_s % vc - lo
    in_block = (chunk_pos >= 0) & (chunk_pos < vc_here)
    chunk_pos = chunk_pos.clamp(0, vc_here - 1)
    b, l = labels.shape
    m = torch.full((b, l), -1e30, dtype=torch.float32, device=x.device)
    s = torch.zeros((b, l), dtype=torch.float32, device=x.device)
    gold = torch.zeros((b, l), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for ci, w in enumerate(head_w.unbind(0)):
        args = (m, s, gold, x, w, (chunk_id == ci) & in_block, chunk_pos,
                softcap)
        if remat:
            # The chunk draws no random numbers: no RNG state to keep.
            m, s, gold = checkpoint(_ce_chunk, *args, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            m, s, gold = _ce_chunk(*args)
    return m + torch.log(s), gold, mask
