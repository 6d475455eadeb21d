"""Block assembly: pre-norm residual blocks of each kind + state plumbing
(port of ``repro/models/blocks.py``).

Every kind of the reference: ``attn``, ``shared_attn``, ``moe`` (attention
plus the MoE layer, plus a dense MLP beside it where
``moe_dense_residual`` is set), ``mamba2``, ``mlstm`` and ``slstm``; and
the cross-attention an ``attn`` block gets with ``cross=True`` (``lnx``
and ``xattn``, read when an encoder output is passed).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from .attention import (
    attention_block,
    attention_decode,
    attention_prefill,
    attn_init,
    cross_attention,
    init_kv_cache,
)
from .config import ArchConfig
from .layers import rmsnorm, rmsnorm_init, swiglu, swiglu_init
from .moe import moe_apply, moe_init
from .ssm import (
    mamba2_apply,
    mamba2_decode,
    mamba2_init,
    mamba2_prefill,
    mamba2_state_init,
    mlstm_apply,
    mlstm_decode,
    mlstm_init,
    mlstm_prefill,
    mlstm_state_init,
    slstm_apply,
    slstm_decode,
    slstm_init,
    slstm_state_init,
)

def block_init(gen, cfg: ArchConfig, kind: str, *, cross: bool = False):
    d = cfg.d_model
    if kind in ("attn", "shared_attn"):
        p = {
            "ln1": rmsnorm_init(d, cfg.pdtype, gen.device),
            "attn": attn_init(gen, cfg),
            "ln2": rmsnorm_init(d, cfg.pdtype, gen.device),
            "mlp": swiglu_init(gen, d, cfg.d_ff, cfg.pdtype),
        }
        if cross:
            p["lnx"] = rmsnorm_init(d, cfg.pdtype, gen.device)
            p["xattn"] = attn_init(gen, cfg)
        return p
    if kind == "moe":
        p = {
            "ln1": rmsnorm_init(d, cfg.pdtype, gen.device),
            "attn": attn_init(gen, cfg),
            "ln2": rmsnorm_init(d, cfg.pdtype, gen.device),
            "moe": moe_init(gen, cfg),
        }
        if cfg.moe_dense_residual:
            p["dense_mlp"] = swiglu_init(gen, d, cfg.d_ff, cfg.pdtype)
        return p
    mixer_init = {"mamba2": mamba2_init, "mlstm": mlstm_init,
                  "slstm": slstm_init}.get(kind)
    if mixer_init is not None:
        return {"ln1": rmsnorm_init(d, cfg.pdtype, gen.device),
                "mixer": mixer_init(gen, cfg)}
    raise ValueError(f"unknown block kind {kind!r}")


def block_state_init(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     device=None):
    """Decode-time state for one block instance."""
    if kind in ("attn", "shared_attn", "moe"):
        return init_kv_cache(cfg, batch, max_len, device=device)
    if kind == "mamba2":
        return mamba2_state_init(cfg, batch, device=device)
    if kind == "mlstm":
        return mlstm_state_init(cfg, batch, device=device)
    if kind == "slstm":
        return slstm_state_init(cfg, batch, device=device)
    raise ValueError(kind)


def block_apply(
    p,
    cfg: ArchConfig,
    kind: str,
    x,
    *,
    positions=None,
    mode: str = "train",
    state=None,
    pos=None,
    enc_out=None,
    seq_axes=None,
) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Apply one block. Returns (x, new_state, aux_loss)."""
    x_in, y, new_state, aux = block_residual(
        p, cfg, kind, x, positions=positions, mode=mode, state=state,
        pos=pos, enc_out=enc_out, seq_axes=seq_axes)
    return x_in + y, new_state, aux


def _norm(p, cfg: ArchConfig, x, x32=None):
    """rmsnorm of the residual stream x, or of x32, the same sum formed in
    float32 where it was never rounded to x's type (see block_residual)."""
    return rmsnorm(p, x if x32 is None else x32, cfg.norm_eps).to(x.dtype)


def block_residual(
    p,
    cfg: ArchConfig,
    kind: str,
    x,
    *,
    norm_in=None,
    positions=None,
    mode: str = "train",
    state=None,
    pos=None,
    enc_out=None,
    seq_axes=None,
):
    """Apply one block as (x_in, y, new_state, aux_loss): its output is the
    residual sum x_in + y, left to the caller.

    Inside the reference's compiled superblock XLA forms a residual sum that
    feeds a norm in float32 from its two bf16 terms, unrounded (the norm's
    upcast absorbs the add), while the stream carries the rounded sum.
    ``norm_in`` is that float32 sum for this block's first norm (the caller
    has it from the previous block of the superblock); the attention
    block's later norms (``lnx`` after the self-attention, ``ln2``) get
    theirs the same way.  In float32 all equal x.  A ``moe`` block's aux
    loss comes back as ``aux_loss``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("attn", "shared_attn", "moe"):
        h = _norm(p["ln1"], cfg, x, norm_in)
        if mode == "train":
            a = attention_block(p["attn"], cfg, h, positions)
            new_state = None
        elif mode == "prefill":
            a, new_state = attention_prefill(p["attn"], cfg, h, positions, state)
        elif mode == "decode":
            a, new_state = attention_decode(p["attn"], cfg, h, pos, state)
        else:
            raise ValueError(mode)
        x_sum = x.float() + a.float()
        x = x + a
        if "xattn" in p and enc_out is not None:
            h = _norm(p["lnx"], cfg, x, x_sum)
            c = cross_attention(p["xattn"], cfg, h, enc_out)
            x_sum = x.float() + c.float()
            x = x + c
        h = _norm(p["ln2"], cfg, x, x_sum)
        if kind == "moe":
            y, aux = moe_apply(p["moe"], cfg, h)
            if cfg.moe_dense_residual:
                y = y + swiglu(p["dense_mlp"], h)
            return x, y, new_state, aux
        return x, swiglu(p["mlp"], h), new_state, aux
    if kind == "mamba2":
        h = _norm(p["ln1"], cfg, x, norm_in)
        if mode == "train":
            y, new_state = mamba2_apply(p["mixer"], cfg, h, seq_axes=seq_axes), None
        elif mode == "prefill":
            y, new_state = mamba2_prefill(p["mixer"], cfg, h, state)
        else:
            y, new_state = mamba2_decode(p["mixer"], cfg, h, state)
        return x, y, new_state, aux
    if kind == "mlstm":
        h = _norm(p["ln1"], cfg, x, norm_in)
        if mode == "train":
            y, new_state = mlstm_apply(p["mixer"], cfg, h, seq_axes=seq_axes), None
        elif mode == "prefill":
            y, new_state = mlstm_prefill(p["mixer"], cfg, h, state)
        else:
            y, new_state = mlstm_decode(p["mixer"], cfg, h, state)
        return x, y, new_state, aux
    if kind == "slstm":
        h = _norm(p["ln1"], cfg, x, norm_in)
        if mode == "train":
            y, new_state = slstm_apply(p["mixer"], cfg, h), None
        elif mode == "prefill":
            y, new_state = slstm_apply(p["mixer"], cfg, h, None,
                                       return_state=True)
        else:
            y, new_state = slstm_decode(p["mixer"], cfg, h, state)
        return x, y, new_state, aux
    raise ValueError(kind)
