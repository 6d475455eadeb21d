"""SSM blocks: Mamba2 (SSD) (port of ``repro/models/ssm.py``).

Mamba2's sequence mixing is a prefix scan with an expensive associative
operator — the LM-side instance of the paper's problem.  It runs through
``kernels.ops.ssd_scan``: the chunk-local kernels around an inter-chunk
prefix circuit, i.e. reduce-then-scan (§4.1) inside the model.

As in the reference, Mamba2 uses n_groups=1 (B/C shared across heads).
The mLSTM and sLSTM blocks (xlstm-350m) come in a later slice
(``ROADMAP.md`` Queue 1, the LM configurations and block kinds); their
functions raise until then.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .config import ArchConfig
from .layers import dense, dense_init, rmsnorm, rmsnorm_init, silu


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_init(gen, cfg: ArchConfig):
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = gen.device
    conv_ch = di + 2 * ds
    in_proj = dense_init(gen, d, 2 * di + 2 * ds + nh, cfg.pdtype)
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=gen, device=dev)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.mul_(0.1).to(cfg.pdtype),
        "conv_b": torch.zeros((conv_ch,), dtype=cfg.pdtype, device=dev),
        "a_log": torch.zeros((nh,), dtype=torch.float32, device=dev),  # A = -1
        "dt_bias": torch.full((nh,), -2.0, dtype=torch.float32, device=dev),
        "d_skip": torch.ones((nh,), dtype=torch.float32, device=dev),
        "gate_norm": rmsnorm_init(di, cfg.pdtype, dev),
        "out_proj": dense_init(gen, di, d, cfg.pdtype),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv along L.  x: (B, L, C); w: (W, C).

    Returns (y, new_state) where state is the last W-1 inputs."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width))
    new_state = xp[:, -(width - 1):] if width > 1 else None
    return silu(y + b), new_state


def _mamba2_inner(p, cfg: ArchConfig, u, conv_state=None, ssm_state=None,
                  seq_axes=None):
    """Shared forward: u (B, L, D) -> (y, conv_state, ssm_state)."""
    bsz, l, _ = u.shape
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = di // nh
    proj = dense(p["in_proj"], u)
    x, z, bmat, cmat, dt = torch.split(proj, [di, di, ds, ds, nh], dim=-1)
    xbc = torch.cat([x, bmat, cmat], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    x, bmat, cmat = torch.split(xbc, [di, ds, ds], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                      # (B, L, nh)
    log_a = -torch.exp(p["a_log"]) * dt                             # <= 0
    v = x.reshape(bsz, l, nh, hd).transpose(1, 2)                   # (B,nh,L,hd)
    v_in = v * dt.transpose(1, 2)[..., None].to(v.dtype)
    # n_groups = 1: B and C are shared by the heads.  The kernels take them
    # per (batch, head, chunk), so they are materialised, as the reference's
    # flat reshape does.
    k = bmat[:, None].expand(bsz, nh, l, ds)
    q = cmat[:, None].expand(bsz, nh, l, ds)
    la = log_a.transpose(1, 2)                                      # (B, nh, L)

    if l == 1 and ssm_state is not None:
        y, new_ssm = kops.ssm_decode_step(
            q[:, :, 0], k[:, :, 0], v_in[:, :, 0], la[:, :, 0], ssm_state
        )
        y = y[:, :, None]
    else:
        y = kops.ssd_scan(
            q, k, v_in, la,
            chunk=min(cfg.ssm_chunk, l),
            backend=cfg.ssm_backend,
            scan_algorithm=cfg.scan_algorithm,
            axis_names=seq_axes,
        )
        new_ssm = None  # full-state return handled by the prefill wrapper
    y = y + p["d_skip"][None, :, None, None] * v.float()
    y = y.transpose(1, 2).reshape(bsz, l, di).to(u.dtype)
    # The gate's product feeds the norm's float32 upcast, and XLA, inside
    # the reference's compiled layer, forms it in float32 without rounding
    # it to u's type first; so does this.
    y = rmsnorm(p["gate_norm"], y.float() * silu(z).float(), cfg.norm_eps)
    return dense(p["out_proj"], y.to(u.dtype)), new_conv, new_ssm


def mamba2_apply(p, cfg: ArchConfig, x, *, seq_axes=None):
    y, _, _ = _mamba2_inner(p, cfg, x, seq_axes=seq_axes)
    return y


def mamba2_state_init(cfg: ArchConfig, batch: int, device=None):
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = di // nh
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * ds),
                            dtype=cfg.cdtype, device=device),
        "ssm": torch.zeros((batch, nh, ds, hd), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(p, cfg: ArchConfig, x, state):
    y, new_conv, new_ssm = _mamba2_inner(
        p, cfg, x, conv_state=state["conv"], ssm_state=state["ssm"]
    )
    return y, {"conv": new_conv.to(state["conv"].dtype), "ssm": new_ssm}


def mamba2_prefill(p, cfg: ArchConfig, x, state):
    """Prefill: full scan + reconstruct the final recurrent state."""
    bsz, l, _ = x.shape
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = di // nh
    # Recompute the pieces needed for the final state (cheap vs the scan).
    proj = dense(p["in_proj"], x)
    xs, z, bmat, cmat, dt = torch.split(proj, [di, di, ds, ds, nh], dim=-1)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    new_conv = xbc[:, -(cfg.ssm_conv - 1):].to(state["conv"].dtype)
    xbc_c, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, bmat, cmat = torch.split(xbc_c, [di, ds, ds], dim=-1)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    log_a = (-torch.exp(p["a_log"]) * dtv).transpose(1, 2)         # (B,nh,L)
    v = (xs.reshape(bsz, l, nh, hd).transpose(1, 2)
         * dtv.transpose(1, 2)[..., None].to(xs.dtype))
    k = bmat[:, None].expand(bsz, nh, l, ds)
    # final state = sum_t decay(t..L) k_t^T v_t
    ca = torch.cumsum(log_a, dim=-1)
    to_end = torch.exp(ca[..., -1:] - ca)                           # (B,nh,L)
    ssm = torch.einsum("bhls,bhlv->bhsv", k.float() * to_end[..., None],
                       v.float())
    y, _, _ = _mamba2_inner(p, cfg, x)
    return y, {"conv": new_conv, "ssm": ssm}


# ---------------------------------------------------------------------------
# mLSTM / sLSTM (xLSTM): a later slice
# ---------------------------------------------------------------------------


def _xlstm_not_ported(*_args, **_kwargs):
    raise NotImplementedError(
        "mLSTM/sLSTM blocks (xlstm-350m) are not ported yet "
        "(the LM configurations and block kinds, ROADMAP.md Queue 1)"
    )


mlstm_init = mlstm_apply = mlstm_state_init = _xlstm_not_ported
mlstm_decode = mlstm_prefill = _xlstm_not_ported
slstm_init = slstm_apply = slstm_state_init = slstm_decode = _xlstm_not_ported
