"""Mixture-of-Experts layer: top-k routing, capacity-bounded dispatch einsums
(port of ``repro/models/moe.py``).

Tokens are viewed as (groups, group_size); per group each expert accepts at
most C = group_size * top_k * capacity_factor / E tokens, and the choices
past an expert's capacity are dropped.  The router's load imbalance is the
LLM-world analogue of the paper's imbalanced operator: the aux loss plus
the capacity factor play the role of the balancing step.

The dispatch is the reference's dense one: one-hot dispatch and combine
tensors and einsums over every expert, so a step reads every expert's
weights whichever tokens it routes.  The reference computes these products
outside any Pallas kernel, and so do these ``torch.einsum`` calls.  On a
mesh the expert dim of w1/w3/w2 is stored sharded over "model" by the
sharding rules (``launch/sharding.py``), as the reference's is, and stays
so: each rank routes its own batch rows through its block of experts, and
the blocks' shares of y are summed over "model" (``shardctx.local_experts``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import shardctx
from .config import ArchConfig
from .layers import dense_init, normal_param, silu


def moe_init(gen, cfg: ArchConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = 1.0 / math.sqrt(d)
    return {
        "router": dense_init(gen, d, e, torch.float32),   # router in fp32
        "w1": normal_param(gen, (e, d, f), cfg.pdtype, scale),
        "w3": normal_param(gen, (e, d, f), cfg.pdtype, scale),
        "w2": normal_param(gen, (e, f, d), cfg.pdtype, 1.0 / math.sqrt(f)),
    }


def moe_apply(p, cfg: ArchConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, D) -> (y, aux_loss).

    Grouped top-k dispatch (T5X/Switch style), as the reference's: the
    router in float32; queue positions by a cumulative sum over the
    flattened (s, k) order; the dispatch and combine one-hots in x's dtype,
    the gates rounded to it; the Switch aux loss e * sum_e f_e * p_e.
    """
    bsz, l, d = x.shape
    t = bsz * l
    g_size = min(cfg.moe_group_size, t)
    assert t % g_size == 0, f"tokens {t} % group {g_size}"
    if hasattr(x, "device_mesh"):
        # On a mesh each rank routes its batch rows (whole groups) through
        # its block of experts; the aux loss is the mean over groups.
        return shardctx.local_experts(
            lambda p, x, lo: _moe_groups(p, cfg, x, g_size, lo), p, x,
            rows_ok=lambda rows: (rows * l) % g_size == 0)
    return _moe_groups(p, cfg, x, g_size)


def _moe_groups(p, cfg: ArchConfig, x, g_size: int, lo: int = 0):
    """:func:`moe_apply` on ``x``'s tokens in groups of ``g_size``, through
    the experts ``p`` holds: ``lo:lo + len(p["w1"])`` of the router's
    (every expert by default; on a mesh a rank's block, whose share of y
    the caller sums)."""
    bsz, l, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = bsz * l // g_size
    xg = x.reshape(g, g_size, d)
    dt = xg.dtype

    logits = xg.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)                 # (g, s, e)
    gate_vals, idx = torch.topk(probs, k, dim=-1)         # (g, s, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # Aux load-balancing loss (Switch): e * sum_e f_e * p_e.
    me = probs.mean(dim=1)                                # (g, e)
    ce = F.one_hot(idx[..., 0], e).float().mean(dim=1)    # (g, e)
    aux = (me * ce).sum(-1).mean() * e

    capacity = int(g_size * k * cfg.capacity_factor / e) + 1
    oh = F.one_hot(idx, e).to(torch.int32)                # (g, s, k, e)
    # Position of each (token, choice) in its expert's queue, counted over
    # the flattened (s, k) order.
    flat = oh.reshape(g, g_size * k, e)
    pos_flat = torch.cumsum(flat, dim=1) - 1              # (g, s*k, e)
    pos = (pos_flat.reshape(g, g_size, k, e) * oh).sum(-1)  # (g, s, k)
    keep = pos < capacity
    gate_vals = gate_vals * keep

    # A position past the capacity has no one-hot (jax.nn.one_hot gives a
    # zero row); keep zeroes it after clamping it into range.
    pos_oh = (F.one_hot(pos.clamp(max=capacity - 1).long(), capacity).to(dt)
              * keep[..., None].to(dt))
    ohc = oh.to(dt)
    disp = torch.einsum("gske,gskc->gsec", ohc, pos_oh)
    comb = torch.einsum("gske,gskc->gsec", gate_vals.to(dt)[..., None] * ohc,
                        pos_oh)

    hi = lo + p["w1"].shape[0]
    if (lo, hi) != (0, e):
        disp, comb = disp[:, :, lo:hi], comb[:, :, lo:hi]
    xe = torch.einsum("gsec,gsd->egcd", disp, xg)         # (e, g, c, d)
    h = torch.einsum("egcd,edf->egcf", xe, p["w1"])
    u = torch.einsum("egcd,edf->egcf", xe, p["w3"])
    h = silu(h) * u
    ye = torch.einsum("egcf,efd->egcd", h, p["w2"])       # (e, g, c, d)
    y = torch.einsum("gsec,egcd->gsd", comb, ye)
    return y.reshape(bsz, l, d), aux
