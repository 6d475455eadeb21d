"""The unified language model: superblocks, prefill and decode
(port of ``repro/models/lm.py``).

A model is ``n_super`` repetitions of ``cfg.block_pattern`` (a
"superblock").  Parameters of pattern positions are stacked with leading
dim n_super, as in the reference; the forward pass is a Python loop over
superblocks that indexes them.  ``init_params`` allocates each stacked leaf
once and draws every superblock straight into its slice, so its peak is
the weights plus a float32 draw of at most 64 MB (``layers.params_into``).
``shared_attn`` blocks (zamba2) keep one unstacked parameter set used by
every superblock.

Not ported yet: ``loss_fn`` (LM training, ``ROADMAP.md`` Queue 1),
``_encode`` and the patch/audio frontends (the LM configurations and block
kinds, Queue 1); they raise.
The reference's ``shardctx`` constraints are no-ops without a mesh and are
dropped.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core._tree import tree_index, tree_map, tree_stack

from .blocks import block_init, block_residual, block_state_init
from .config import ArchConfig
from .layers import (
    embed,
    embed_init,
    head_init,
    head_logits,
    param,
    params_into,
    rmsnorm,
    rmsnorm_init,
)


def _stacked_init(gen: torch.Generator, cfg: ArchConfig, kind: str):
    """One block kind's parameters stacked over the superblocks: the
    block's shapes from a walk on the meta device, each stacked leaf made
    once, then every superblock drawn into its slice."""
    with params_into() as protos:
        tree = block_init(gen, cfg, kind)
    stacks = [param((cfg.n_super, *t.shape), t.dtype, gen.device)
              for t in protos]
    for i in range(cfg.n_super):
        with params_into([s[i] for s in stacks]):
            block_init(gen, cfg, kind)
    where = {id(t): s for t, s in zip(protos, stacks)}
    return tree_map(lambda t: where[id(t)], tree)


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, Any]:
    """Parameters drawn from ``gen``, on its device."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            "encoder-decoder configurations are not ported yet "
            "(the LM configurations and block kinds, ROADMAP.md Queue 1)"
        )
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype),
        "final_norm": rmsnorm_init(cfg.d_model, cfg.pdtype, gen.device),
        "head": head_init(
            gen, cfg.d_model, cfg.padded_vocab, cfg.head_chunks, cfg.pdtype
        ),
    }
    blocks = {}
    for j, kind in enumerate(cfg.block_pattern):
        if kind == "shared_attn":
            continue
        blocks[f"b{j}"] = _stacked_init(gen, cfg, kind)
    params["blocks"] = blocks
    if "shared_attn" in cfg.block_pattern:
        params["shared"] = block_init(gen, cfg, "shared_attn")
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
    raise NotImplementedError(
        "the encoder (whisper's audio frontend) is not ported yet "
        "(the LM configurations and block kinds, ROADMAP.md Queue 1)"
    )


def _embed_inputs(params, cfg: ArchConfig, batch):
    """Token embeddings (the multimodal prefixes of a later slice raise)."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"the {cfg.frontend!r} frontend is not ported yet "
            "(the LM configurations and block kinds, ROADMAP.md Queue 1)"
        )
    x = embed(params["embed"], batch["tokens"]).to(cfg.cdtype)
    return x, 0


def _run_blocks(params, cfg: ArchConfig, x, *, positions, mode, states=None,
                pos=None, enc_out=None, seq_axes=None):
    """Loop over superblocks.  states: with ``cfg.scan_layers``, dict b{j}
    -> stacked (n_super, ...); otherwise dict sb{i} -> {b{j}: state}."""
    pattern = cfg.block_pattern
    has_states = states is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_super = []
    for i in range(cfg.n_super):
        layer_params = tree_index(params["blocks"], i)
        if not has_states:
            layer_states = {}
        elif cfg.scan_layers:
            layer_states = tree_index(states, i)
        else:
            layer_states = states.get(f"sb{i}", {})
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
                            seq_axes=seq_axes)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


def forward_train(params, cfg: ArchConfig, batch, *, seq_axes=None):
    """Full teacher-forced forward: returns (logits[B, L_tokens, V], aux)."""
    x, aux = forward_hidden(params, cfg, batch, seq_axes=seq_axes)
    logits = head_logits(params["head"], x, cfg.logits_softcap)
    return logits, aux


def loss_fn(params, cfg: ArchConfig, batch, *, seq_axes=None):
    raise NotImplementedError(
        "training (loss_fn, chunked_cross_entropy) is not ported yet "
        "(LM training, ROADMAP.md Queue 1)"
    )


# ---------------------------------------------------------------------------
# Serving: prefill + decode with per-block state
# ---------------------------------------------------------------------------


def init_decode_states(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Per-superblock states.

    scan_layers=True: stacked (n_super, ...) trees, as the reference's;
    scan_layers=False: a dict of per-superblock states."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            "encoder-decoder configurations are not ported yet "
            "(the LM configurations and block kinds, ROADMAP.md Queue 1)"
        )
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
    return {"blocks": blocks}


def prefill(params, cfg: ArchConfig, batch, states, *, seq_axes=None):
    """Process the prompt, fill caches; returns (last_logits, states)."""
    x, _ = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux, new_blocks = _run_blocks(
        params, cfg, x, positions=positions, mode="prefill",
        states=states["blocks"], seq_axes=seq_axes,
    )
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = head_logits(params["head"], x, cfg.logits_softcap)
    return logits, {"blocks": new_blocks}


def decode_step(params, cfg: ArchConfig, token, pos, states):
    """One token for every sequence: token (B, 1) int, pos int."""
    x = embed(params["embed"], token).to(cfg.cdtype)
    x, aux, new_blocks = _run_blocks(
        params, cfg, x, positions=None, mode="decode", states=states["blocks"],
        pos=pos,
    )
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = head_logits(params["head"], x, cfg.logits_softcap)
    new_states = dict(states)
    new_states["blocks"] = new_blocks
    return logits, new_states
