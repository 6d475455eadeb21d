"""GQA attention block (qk_norm / qkv_bias / rope / KV-cache / cross-attn)
(port of ``repro/models/attention.py``).

``cross_attention`` is whisper's encoder-decoder path: it always takes the
plain "xla" attention, as the reference hard-codes it, whatever the
config's ``attn_backend``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

from . import shardctx
from .config import ArchConfig
from .layers import apply_rope, dense, dense_init, rmsnorm, rmsnorm_init


def attn_init(gen, cfg: ArchConfig, *, cross: bool = False):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, d, hq * hd, cfg.pdtype, bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, hkv * hd, cfg.pdtype, bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, hkv * hd, cfg.pdtype, bias=cfg.qkv_bias),
        "wo": dense_init(gen, hq * hd, d, cfg.pdtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, cfg.pdtype, gen.device)
        p["k_norm"] = rmsnorm_init(hd, cfg.pdtype, gen.device)
    return p


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
                  device=None):
    dtype = dtype or cfg.cache_torch_dtype
    hkv, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, hkv, max_len, hd), dtype=dtype, device=device),
    }


def _project_qkv(p, cfg: ArchConfig, x, positions, *, rope: bool = True):
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = shardctx.split_heads(dense(p["wq"], x), hq, hd).transpose(1, 2)
    k = shardctx.split_heads(dense(p["wk"], x), hkv, hd).transpose(1, 2)
    v = shardctx.split_heads(dense(p["wv"], x), hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shardctx.constrain_heads(q)
    k = shardctx.constrain_heads(k)
    v = shardctx.constrain_heads(v)
    return q, k, v


def attention_block(p, cfg: ArchConfig, x, positions, *, causal: bool = True):
    """Full-sequence attention (train / prefill).  x: (B, L, D)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    o = shardctx.local_heads(
        lambda q, k, v: kops.attention(q, k, v, causal=causal,
                                       backend=cfg.attn_backend), q, k, v)
    o = shardctx.merge_heads(o.transpose(1, 2))
    return dense(p["wo"], o.to(x.dtype))


def attention_prefill(p, cfg: ArchConfig, x, positions, cache):
    """Prefill: run full attention and fill the cache in one pass.

    When the prompt fills the whole cache it replaces it outright; otherwise
    the prompt's keys and values go into the cache's first positions (a new
    cache, as the reference's functional update)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    o = shardctx.local_heads(
        lambda q, k, v: kops.attention(q, k, v, causal=True,
                                       backend=cfg.attn_backend), q, k, v)
    o = shardctx.merge_heads(o.transpose(1, 2))
    cache = {"k": shardctx.fill_cache(cache["k"], k),
             "v": shardctx.fill_cache(cache["v"], v)}
    return dense(p["wo"], o.to(x.dtype)), cache


def attention_decode(p, cfg: ArchConfig, x, pos, cache):
    """One-token decode: x (B, 1, D); pos the current position, an int or
    a 0-d integer tensor (read on the device, never on the host: a meta
    tensor runs too).

    The cache write is a one-hot select, as the reference's: a position past
    the cache writes nothing (``max_len`` must cover prompt + new tokens).
    GQA uses grouped einsums instead of repeating kv heads."""
    bsz = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=x.device).reshape(1, 1).expand(bsz, 1)
    q, k, v = _project_qkv(p, cfg, x, positions)
    if hasattr(cache["k"], "device_mesh"):
        # On a mesh the cache stays sequence-sharded: each rank attends
        # its slots, and the blocks combine (``shardctx.local_cache``).
        o, ck, cv = shardctx.local_cache(
            lambda q, k, v, ck, cv, lo: _decode_scores(q, k, v, ck, cv, pos,
                                                       lo, hkv),
            _decode_out, q, k, v, cache["k"], cache["v"])
        o = shardctx.merge_heads(o.reshape(bsz, 1, hq, hd))
        return dense(p["wo"], o.to(x.dtype)), {"k": ck, "v": cv}
    scores, ck, cv = _decode_scores(q, k, v, cache["k"], cache["v"], pos, 0,
                                    hkv)
    o = _decode_out(torch.softmax(scores, dim=-1), cv)
    o = o.reshape(bsz, 1, hq * hd)
    return dense(p["wo"], o.to(x.dtype)), {"k": ck, "v": cv}


def _decode_scores(q, k, v, ck, cv, pos, lo: int, hkv: int):
    """:func:`attention_decode`'s scores over the cache slots ``lo:lo +
    S_block`` (all of them on one device; a rank's block on a mesh): the
    token written into its slot if it lies there, and (the masked float32
    scores (B, Hkv, G, S_block), ck, cv)."""
    bsz, hq, _, hd = q.shape
    slots = torch.arange(lo, lo + ck.shape[2], device=q.device)
    onehot = (slots == pos)[None, None, :, None]
    ck = torch.where(onehot, k.to(ck.dtype), ck)
    cv = torch.where(onehot, v.to(cv.dtype), cv)
    qg = q.reshape(bsz, hkv, hq // hkv, hd)
    # The dot accumulates in float32, as the reference's
    # preferred_element_type=float32.
    scores = torch.einsum("bkgd,bksd->bkgs", qg.to(ck.dtype).float(),
                          ck.float()) * (hd ** -0.5)
    mask = (slots <= pos)[None, None, None, :]
    return torch.where(mask, scores, -1e30), ck, cv


def _decode_out(probs, cv):
    """A block's share of the output, the probabilities rounded to the
    cache's dtype as one device rounds them."""
    return torch.einsum("bkgs,bksd->bkgd", probs.to(cv.dtype).float(),
                        cv.float())


def cross_attention(p, cfg: ArchConfig, x, enc_out):
    """Encoder-decoder cross attention (whisper): queries from ``x``, keys
    and values from ``enc_out``, no RoPE and no qk-norm; non-causal, on
    the plain path, as the reference hard-codes it."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = shardctx.split_heads(dense(p["wq"], x), hq, hd).transpose(1, 2)
    k = shardctx.split_heads(dense(p["wk"], enc_out), hkv, hd).transpose(1, 2)
    v = shardctx.split_heads(dense(p["wv"], enc_out), hkv, hd).transpose(1, 2)
    o = shardctx.local_heads(
        lambda q, k, v: kops.attention(q, k, v, causal=False, backend="xla"),
        *(shardctx.constrain_heads(t) for t in (q, k, v)))
    o = shardctx.merge_heads(o.transpose(1, 2))
    return dense(p["wo"], o.to(x.dtype))
