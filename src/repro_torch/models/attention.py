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
    bsz, l, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(p["wq"], x).reshape(bsz, l, hq, hd).transpose(1, 2)
    k = dense(p["wk"], x).reshape(bsz, l, hkv, hd).transpose(1, 2)
    v = dense(p["wv"], x).reshape(bsz, l, hkv, hd).transpose(1, 2)
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
    bsz, l, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    o = shardctx.local_heads(
        lambda q, k, v: kops.attention(q, k, v, causal=causal,
                                       backend=cfg.attn_backend), q, k, v)
    o = o.transpose(1, 2).reshape(bsz, l, cfg.n_heads * cfg.hd)
    return dense(p["wo"], o.to(x.dtype))


def attention_prefill(p, cfg: ArchConfig, x, positions, cache):
    """Prefill: run full attention and fill the cache in one pass.

    When the prompt fills the whole cache it replaces it outright; otherwise
    the prompt's keys and values go into the cache's first positions (a new
    cache, as the reference's functional update)."""
    bsz, l, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    o = kops.attention(q, k, v, causal=True, backend=cfg.attn_backend)
    o = o.transpose(1, 2).reshape(bsz, l, cfg.n_heads * cfg.hd)
    if l == cache["k"].shape[2]:
        cache = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    else:
        ck, cv = cache["k"].clone(), cache["v"].clone()
        ck[:, :, :l] = k.to(ck.dtype)
        cv[:, :, :l] = v.to(cv.dtype)
        cache = {"k": ck, "v": cv}
    return dense(p["wo"], o.to(x.dtype)), cache


def attention_decode(p, cfg: ArchConfig, x, pos, cache):
    """One-token decode: x (B, 1, D); pos int (current position).

    The cache write is a one-hot select, as the reference's: a position past
    the cache writes nothing (``max_len`` must cover prompt + new tokens).
    GQA uses grouped einsums instead of repeating kv heads."""
    bsz = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    positions = torch.full((bsz, 1), int(pos), dtype=torch.int32,
                           device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    s_len = cache["k"].shape[2]
    slots = torch.arange(s_len, device=x.device)
    onehot = (slots == pos)[None, None, :, None]
    ck = torch.where(onehot, k.to(cache["k"].dtype), cache["k"])
    cv = torch.where(onehot, v.to(cache["v"].dtype), cache["v"])
    g = hq // hkv
    qg = q.reshape(bsz, hkv, g, hd)                   # (B, Hkv, G, hd)
    # The dot accumulates in float32, as the reference's
    # preferred_element_type=float32.
    scores = torch.einsum("bkgd,bksd->bkgs", qg.to(ck.dtype).float(),
                          ck.float()) * (hd ** -0.5)
    mask = (slots <= pos)[None, None, None, :]
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", probs.to(cv.dtype).float(), cv.float())
    o = o.reshape(bsz, 1, hq * hd)
    return dense(p["wo"], o.to(x.dtype)), {"k": ck, "v": cv}


def cross_attention(p, cfg: ArchConfig, x, enc_out):
    """Encoder-decoder cross attention (whisper): queries from ``x``, keys
    and values from ``enc_out``, no RoPE and no qk-norm; non-causal, on
    the plain path, as the reference hard-codes it."""
    bsz, l, _ = x.shape
    le = enc_out.shape[1]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(p["wq"], x).reshape(bsz, l, hq, hd).transpose(1, 2)
    k = dense(p["wk"], enc_out).reshape(bsz, le, hkv, hd).transpose(1, 2)
    v = dense(p["wv"], enc_out).reshape(bsz, le, hkv, hd).transpose(1, 2)
    o = kops.attention(q, k, v, causal=False, backend="xla")
    o = o.transpose(1, 2).reshape(bsz, l, hq * hd)
    return dense(p["wo"], o.to(x.dtype))
