"""The unified language model: superblocks, the training loss, prefill and
decode (port of ``repro/models/lm.py``).

A model is ``n_super`` repetitions of ``cfg.block_pattern`` (a
"superblock").  Parameters of pattern positions are stacked with leading
dim n_super, as in the reference; the forward pass is a Python loop over
superblocks, each stacked leaf unbound once a pass.  In training with
``cfg.remat`` each superblock runs inside a non-reentrant
``torch.utils.checkpoint``, as the reference wraps it in ``jax.checkpoint``:
its activations are recomputed in the backward pass.  ``loss_fn`` is the
vocab-chunked cross entropy plus ``AUX_WEIGHT`` times the MoE aux loss.
``init_params`` allocates each stacked leaf
once and draws every superblock straight into its slice, so its peak is
the weights plus a float32 draw of at most 64 MB (``layers.params_into``).
``shared_attn`` blocks (zamba2) keep one unstacked parameter set used by
every superblock.

Multimodal frontends are stubs, as in the reference: ``batch["patches"]``
(InternVL2's patch prefix, prepended to the token embeddings) and
``batch["frames"]`` (Whisper's encoder input) carry precomputed embeddings
at d_model width.  An encoder-decoder config stacks its encoder's ``attn``
blocks under ``params["encoder"]``, and every decoder block cross-attends
the encoder output, which the decode states carry (``enc_out``).

The ``shardctx`` anchors sit where the reference's do: the embeddings and
each superblock's output are constrained tokens-major.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core._tree import tree_index, tree_map, tree_stack, tree_unbind

from . import shardctx
from .attention import attention_block
from .blocks import _norm, block_init, block_residual, block_state_init
from .config import ArchConfig
from .layers import (
    chunked_cross_entropy,
    embed,
    embed_init,
    head_init,
    head_logits,
    param,
    params_into,
    rmsnorm,
    rmsnorm_init,
    swiglu,
)

AUX_WEIGHT = 0.01


def _stacked_init(gen: torch.Generator, cfg: ArchConfig, kind: str,
                  count: int, cross: bool = False):
    """One block kind's parameters stacked ``count`` times (the
    superblocks, or the encoder's layers): the block's shapes from a walk
    on the meta device, each stacked leaf made once, then every instance
    drawn into its slice."""
    with params_into() as protos:
        tree = block_init(gen, cfg, kind, cross=cross)
    stacks = [param((count, *t.shape), t.dtype, gen.device) for t in protos]
    for i in range(count):
        with params_into([s[i] for s in stacks]):
            block_init(gen, cfg, kind, cross=cross)
    where = {id(t): s for t, s in zip(protos, stacks)}
    return tree_map(lambda t: where[id(t)], tree)


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    """Parameters drawn from ``gen``, on its device."""
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype),
        "final_norm": rmsnorm_init(cfg.d_model, cfg.pdtype, gen.device),
        "head": head_init(
            gen, cfg.d_model, cfg.padded_vocab, cfg.head_chunks, cfg.pdtype
        ),
    }
    cross = cfg.encoder_layers > 0
    blocks = {}
    for j, kind in enumerate(cfg.block_pattern):
        if kind == "shared_attn":
            continue
        blocks[f"b{j}"] = _stacked_init(gen, cfg, kind, cfg.n_super,
                                        cross=cross)
    params["blocks"] = blocks
    if "shared_attn" in cfg.block_pattern:
        params["shared"] = block_init(gen, cfg, "shared_attn")
    if cfg.encoder_layers:
        params["encoder"] = {
            "blocks": _stacked_init(gen, cfg, "attn", cfg.encoder_layers),
            "norm": rmsnorm_init(cfg.d_model, cfg.pdtype, gen.device),
        }
    return params


def init_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """``init_params``' tree as meta tensors: every leaf's shape and dtype,
    with nothing allocated and nothing drawn (the reference's
    ``jax.eval_shape`` of ``init_params``)."""
    with params_into():
        return init_params(torch.Generator(), cfg)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _encode(params, cfg: ArchConfig, frames):
    """Whisper-style encoder over precomputed frame embeddings (stub
    frontend): its ``attn`` blocks with bidirectional attention
    (causal=False, through ``cfg.attn_backend``), RoPE on the frame
    positions as the reference's ``_project_qkv`` applies it, then the
    encoder norm.  The second norm of a layer reads the float32 residual
    sum, as ``block_residual``'s do."""
    x = frames.to(cfg.cdtype)
    positions = torch.arange(x.shape[1], device=x.device)
    enc = params["encoder"]
    for p in tree_unbind(enc["blocks"], cfg.encoder_layers):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        a = attention_block(p["attn"], cfg, h, positions, causal=False)
        h = _norm(p["ln2"], cfg, x, x.float() + a.float())
        x = x + a
        x = x + swiglu(p["mlp"], h)
    return rmsnorm(enc["norm"], x, cfg.norm_eps)


def _embed_inputs(params, cfg: ArchConfig, batch):
    """Token embeddings, with multimodal prefixes prepended (VLM).
    Returns (x, n_prefix)."""
    x = embed(params["embed"], batch["tokens"]).to(cfg.cdtype)
    x = shardctx.constrain_tokens_major(x)
    n_prefix = 0
    if cfg.frontend == "patch" and "patches" in batch:
        x = torch.cat([batch["patches"].to(cfg.cdtype), x], dim=1)
        n_prefix = batch["patches"].shape[1]
    return x, n_prefix


def _encoder_out(params, cfg: ArchConfig, batch):
    """The encoder's output for ``batch["frames"]``, or None."""
    if cfg.encoder_layers and "frames" in batch:
        return _encode(params, cfg, batch["frames"])
    return None


def _run_blocks(params, cfg: ArchConfig, x, *, positions, mode, states=None,
                pos=None, enc_out=None, seq_axes=None):
    """Loop over superblocks.  states: with ``cfg.scan_layers``, dict b{j}
    -> stacked (n_super, ...); otherwise dict sb{i} -> {b{j}: state}."""
    pattern = cfg.block_pattern
    has_states = states is not None

    def superblock(x, aux, layer_params, layer_states):
        new_states = {}
        # The superblock's input comes rounded (the reference's scan carry);
        # inside it, each block's first norm reads the float32 residual sum.
        norm_in = None
        for j, kind in enumerate(pattern):
            p = params["shared"] if kind == "shared_attn" else layer_params[f"b{j}"]
            st = layer_states.get(f"b{j}") if has_states else None
            x_in, y, nst, a = block_residual(
                p, cfg, kind, x, norm_in=norm_in,
                positions=positions, mode=mode, state=st, pos=pos,
                enc_out=enc_out, seq_axes=seq_axes,
            )
            x = x_in + y
            norm_in = x_in.float() + y.float()
            aux = aux + a
            if has_states:
                new_states[f"b{j}"] = nst
        return shardctx.constrain_tokens_major(x), aux, new_states

    # jax.checkpoint(superblock): the backward pass re-runs each superblock
    # from its input.  The recompute routes a MoE block's top-k exactly as
    # the first pass did: the same inputs give the same router logits, and
    # topk's choice among them is deterministic.  Nothing draws random
    # numbers, so no RNG state is kept.
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_super = []
    for i, layer_params in enumerate(tree_unbind(params["blocks"],
                                                 cfg.n_super)):
        if not has_states:
            layer_states = {}
        elif cfg.scan_layers:
            layer_states = tree_index(states, i)
        else:
            layer_states = states.get(f"sb{i}", {})
        if remat:
            x, aux, new_states = checkpoint(
                shardctx.bind(superblock), x, aux, layer_params, layer_states,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux, new_states = superblock(x, aux, layer_params,
                                            layer_states)
        per_super.append(new_states)
    if not has_states:
        return x, aux, None
    if cfg.scan_layers:
        return x, aux, tree_stack(per_super)
    return x, aux, {f"sb{i}": st for i, st in enumerate(per_super)}


def forward_hidden(params, cfg: ArchConfig, batch, *, seq_axes=None):
    """Shared trunk: returns (final-norm hidden on token positions, aux)."""
    x, n_prefix = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux, _ = _run_blocks(params, cfg, x, positions=positions, mode="train",
                            enc_out=_encoder_out(params, cfg, batch),
                            seq_axes=seq_axes)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    return x, aux


def forward_train(params, cfg: ArchConfig, batch, *, seq_axes=None):
    """Full teacher-forced forward: returns (logits[B, L_tokens, V], aux)."""
    x, aux = forward_hidden(params, cfg, batch, seq_axes=seq_axes)
    logits = head_logits(params["head"], x, cfg.logits_softcap)
    return logits, aux


def loss_fn(params, cfg: ArchConfig, batch, *, seq_axes=None):
    """Training loss with vocab-chunked CE (never materializes full
    logits): ``(ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux})``."""
    x, aux = forward_hidden(params, cfg, batch, seq_axes=seq_axes)
    loss = chunked_cross_entropy(
        params["head"], x, batch["labels"], softcap=cfg.logits_softcap,
    )
    return loss + AUX_WEIGHT * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode with per-block state
# ---------------------------------------------------------------------------


def init_decode_states(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Per-superblock states + enc-dec extras.

    scan_layers=True: stacked (n_super, ...) trees, as the reference's;
    scan_layers=False: a dict of per-superblock states.  An
    encoder-decoder config adds ``enc_out``, zeros until a prefill fills
    it."""
    if cfg.scan_layers:
        blocks = {}
        for j, kind in enumerate(cfg.block_pattern):
            proto = block_state_init(cfg, kind, batch, max_len, device=device)
            blocks[f"b{j}"] = tree_map(
                lambda t: t[None].repeat((cfg.n_super,) + (1,) * t.dim()),
                proto,
            )
    else:
        blocks = {
            f"sb{i}": {
                f"b{j}": block_state_init(cfg, kind, batch, max_len,
                                          device=device)
                for j, kind in enumerate(cfg.block_pattern)
            }
            for i in range(cfg.n_super)
        }
    states = {"blocks": blocks}
    if cfg.encoder_layers:
        states["enc_out"] = torch.zeros(
            (batch, cfg.frontend_len, cfg.d_model), dtype=cfg.cdtype,
            device=device)
    return states


def prefill(params, cfg: ArchConfig, batch, states, *, seq_axes=None):
    """Process the prompt, fill caches; returns (last_logits, states)."""
    x, _ = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    enc_out = _encoder_out(params, cfg, batch)
    x, aux, new_blocks = _run_blocks(
        params, cfg, x, positions=positions, mode="prefill",
        states=states["blocks"], enc_out=enc_out, seq_axes=seq_axes,
    )
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = head_logits(params["head"], x, cfg.logits_softcap)
    new_states = {"blocks": new_blocks}
    if cfg.encoder_layers:
        new_states["enc_out"] = (enc_out if enc_out is not None
                                 else states["enc_out"])
    return logits, new_states


def decode_step(params, cfg: ArchConfig, token, pos, states):
    """One token for every sequence: token (B, 1) int, pos int."""
    x = embed(params["embed"], token).to(cfg.cdtype)
    enc_out = states.get("enc_out") if cfg.encoder_layers else None
    x, aux, new_blocks = _run_blocks(
        params, cfg, x, positions=None, mode="decode", states=states["blocks"],
        pos=pos, enc_out=enc_out,
    )
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = head_logits(params["head"], x, cfg.logits_softcap)
    new_states = dict(states)
    new_states["blocks"] = new_blocks
    return logits, new_states
