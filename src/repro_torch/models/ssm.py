"""SSM / linear-RNN blocks: Mamba2 (SSD), mLSTM, sLSTM
(port of ``repro/models/ssm.py``).

The sequence mixing of Mamba2 and mLSTM is a prefix scan with an expensive
associative operator — the LM-side instance of the paper's problem.  Both
run through ``kernels.ops.ssd_scan``: the chunk-local kernels around an
inter-chunk prefix circuit, i.e. reduce-then-scan (§4.1) inside the model.
The mLSTM's normaliser ``n_t = f_t n_{t-1} + i_t k_t`` is a (dk,)-vector
scan of its own, in plain PyTorch (``core.scan.prefix_scan``), as the
reference's is an ``associative_scan`` in plain XLA.

sLSTM is a *nonlinear* recurrence (h_{t-1} feeds the gates) — not
scannable; it runs as a Python loop over time, where the reference runs
``lax.scan``.

As in the reference: mLSTM uses sigmoid input gates instead of
exp-with-max-stabilizer; Mamba2 uses n_groups=1 (B/C shared across heads).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.core.scan import prefix_scan
from repro_torch.kernels import ops as kops

from . import shardctx
from .config import ArchConfig
from .layers import (
    const_param,
    dense,
    dense_init,
    normal_param,
    rmsnorm,
    rmsnorm_init,
    silu,
)


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_init(gen, cfg: ArchConfig):
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = gen.device
    conv_ch = di + 2 * ds
    in_proj = dense_init(gen, d, 2 * di + 2 * ds + nh, cfg.pdtype)
    conv_w = normal_param(gen, (cfg.ssm_conv, conv_ch), cfg.pdtype, 0.1)
    f32 = torch.float32
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": const_param((conv_ch,), 0.0, cfg.pdtype, dev),
        "a_log": const_param((nh,), 0.0, f32, dev),       # A = -exp(0) = -1
        "dt_bias": const_param((nh,), -2.0, f32, dev),    # softplus(-2) ~ .12
        "d_skip": const_param((nh,), 1.0, f32, dev),
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
    v = shardctx.split_heads(x, nh, hd).transpose(1, 2)             # (B,nh,L,hd)
    v_in = v * dt.transpose(1, 2)[..., None].to(v.dtype)
    # n_groups = 1: B and C are shared by the heads.  The kernels take them
    # per (batch, head, chunk), so they are materialised, as the reference's
    # flat reshape does.
    k = bmat[:, None].expand(bsz, nh, l, ds)
    q = cmat[:, None].expand(bsz, nh, l, ds)
    # Mamba2 heads (112 for zamba2) shard over TP — without the anchor these
    # (B, nh, L, ds/hd) activations replicate over the model axis.
    v_in = shardctx.constrain_heads(v_in)
    k = shardctx.constrain_heads(k)
    q = shardctx.constrain_heads(q)
    la = log_a.transpose(1, 2)                                      # (B, nh, L)

    if l == 1 and ssm_state is not None:
        y, new_ssm = shardctx.local_heads(
            kops.ssm_decode_step, q[:, :, 0], k[:, :, 0], v_in[:, :, 0],
            la[:, :, 0], ssm_state)
        y = y[:, :, None]
    else:
        y = shardctx.local_heads(
            lambda q, k, v, la: kops.ssd_scan(
                q, k, v, la,
                chunk=min(cfg.ssm_chunk, l),
                backend=cfg.ssm_backend,
                scan_algorithm=cfg.scan_algorithm,
                axis_names=seq_axes,
            ), q, k, v_in, la)
        new_ssm = None  # full-state return handled by the prefill wrapper
    y = y + p["d_skip"][None, :, None, None] * v.float()
    y = shardctx.merge_heads(y.transpose(1, 2)).to(u.dtype)
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
    v = (shardctx.split_heads(xs, nh, hd).transpose(1, 2)
         * dtv.transpose(1, 2)[..., None].to(xs.dtype))
    k = bmat[:, None].expand(bsz, nh, l, ds)

    def final(k, v, log_a):
        # final state = sum_t decay(t..L) k_t^T v_t
        ca = torch.cumsum(log_a, dim=-1)
        to_end = torch.exp(ca[..., -1:] - ca)                       # (B,nh,L)
        return torch.einsum("bhls,bhlv->bhsv", k.float() * to_end[..., None],
                            v.float())

    ssm = shardctx.local_heads(final, k, v, log_a)
    y, _, _ = _mamba2_inner(p, cfg, x)
    return y, {"conv": new_conv, "ssm": ssm}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM)
# ---------------------------------------------------------------------------


def mlstm_init(gen, cfg: ArchConfig):
    d, nh = cfg.d_model, cfg.n_heads
    hd = cfg.ssm_head_dim
    return {
        "wq": dense_init(gen, d, nh * hd, cfg.pdtype),
        "wk": dense_init(gen, d, nh * hd, cfg.pdtype),
        "wv": dense_init(gen, d, nh * hd, cfg.pdtype),
        "w_gates": dense_init(gen, d, 2 * nh, cfg.pdtype),  # i, f per head
        "wz": dense_init(gen, d, nh * hd, cfg.pdtype),      # output gate
        "out_norm": rmsnorm_init(nh * hd, cfg.pdtype, gen.device),
        "out_proj": dense_init(gen, nh * hd, d, cfg.pdtype),
    }


def _mlstm_qkv(p, cfg: ArchConfig, x):
    nh, hd = cfg.n_heads, cfg.ssm_head_dim
    shp = lambda t: shardctx.split_heads(t, nh, hd).transpose(1, 2)
    q = shp(dense(p["wq"], x)) * (hd ** -0.5)
    k = shp(dense(p["wk"], x)) * (hd ** -0.5)
    v = shp(dense(p["wv"], x))
    gates = dense(p["w_gates"], x).float()
    ig, fg = torch.chunk(gates, 2, dim=-1)                  # (B, L, nh)
    i = torch.sigmoid(ig).transpose(1, 2)                   # (B, nh, L)
    log_f = shardctx.pointwise(F.logsigmoid, fg).transpose(1, 2)
    return q, k, v, i, log_f


def _normalizer_op(a, b):
    """(f, n) pairs composed along the sequence: n' = f_b n_a + n_b."""
    return a[0] * b[0], a[1] * b[0][..., None] + b[1]


def _mlstm_normalizer(log_f, k_in):
    """n_t = f_t n_{t-1} + i_t k_t for every t: an inclusive scan of
    (f_t, k_in_t) along L, as the reference's ``associative_scan``.  The
    gates multiply one step at a time: a cumulative decay (k / cumprod(f))
    would underflow float32 within a chunk."""
    elems = (torch.movedim(torch.exp(log_f), -1, 0).contiguous(),  # (L,B,nh)
             torch.movedim(k_in, 2, 0).contiguous())               # (L,B,nh,dk)
    _, n = prefix_scan(_normalizer_op, elems)
    return torch.movedim(n, 0, 2)                                  # (B,nh,L,dk)


def _mlstm_out(p, cfg: ArchConfig, x, y):
    """The heads' outputs (B, L, nh * hd) through the output norm, the
    output gate and the projection."""
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps)
    y = y * silu(dense(p["wz"], x))
    return dense(p["out_proj"], y)


def mlstm_apply(p, cfg: ArchConfig, x, *, seq_axes=None):
    l = x.shape[1]
    q, k, v, i, log_f = _mlstm_qkv(p, cfg, x)
    k_in = k * i[..., None].to(k.dtype)

    def heads(q, k_in, v, log_f):
        num = kops.ssd_scan(
            q, k_in, v, log_f,
            chunk=min(cfg.ssm_chunk, l),
            backend=cfg.ssm_backend,
            scan_algorithm=cfg.scan_algorithm,
            axis_names=seq_axes,
        )
        n = _mlstm_normalizer(log_f, k_in.float())
        denom = torch.abs(torch.einsum("bhld,bhld->bhl", q.float(), n))
        return num / torch.clamp(denom, min=1.0)[..., None].to(num.dtype)

    y = shardctx.local_heads(heads, q, k_in, v, log_f)
    return _mlstm_out(p, cfg, x, shardctx.merge_heads(y.transpose(1, 2)))


def mlstm_state_init(cfg: ArchConfig, batch: int, device=None):
    nh, hd = cfg.n_heads, cfg.ssm_head_dim
    return {
        "C": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
    }


def mlstm_decode(p, cfg: ArchConfig, x, state):
    bsz = x.shape[0]
    nh, hd = cfg.n_heads, cfg.ssm_head_dim
    q, k, v, i, log_f = _mlstm_qkv(p, cfg, x)

    def step(q1, k1, v1, i1, log_f1, C, n):
        q1 = q1.float()
        f = torch.exp(log_f1)[..., None, None]
        k_in = (k1 * i1[..., None].to(k1.dtype)).float()
        C = f * C + torch.einsum("bhd,bhv->bhdv", k_in, v1.float())
        n = f[..., 0] * n + k_in
        num = torch.einsum("bhd,bhdv->bhv", q1, C)
        denom = torch.abs(torch.einsum("bhd,bhd->bh", q1, n))
        return num / torch.clamp(denom, min=1.0)[..., None], C, n

    y, C, n = shardctx.local_heads(
        step, q[:, :, 0], k[:, :, 0], v[:, :, 0], i[..., 0], log_f[..., 0],
        state["C"], state["n"])
    y = shardctx.merge_heads(y.to(x.dtype).reshape(bsz, 1, nh, hd))
    return _mlstm_out(p, cfg, x, y), {"C": C, "n": n}


def mlstm_prefill(p, cfg: ArchConfig, x, state):
    """Prefill: full scan + the final (C, n) state."""
    q, k, v, i, log_f = _mlstm_qkv(p, cfg, x)
    k_in = (k * i[..., None].to(k.dtype)).float()

    def final(k_in, v, log_f):
        ca = torch.cumsum(log_f, dim=-1)
        to_end = torch.exp(ca[..., -1:] - ca)                      # (B,nh,L)
        C = torch.einsum("bhld,bhlv->bhdv", k_in * to_end[..., None],
                         v.float())
        return C, torch.einsum("bhld,bhl->bhd", k_in, to_end)

    C, n = shardctx.local_heads(final, k_in, v, log_f)
    y = mlstm_apply(p, cfg, x)
    return y, {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM: nonlinear recurrence — a Python loop over time (not scannable)
# ---------------------------------------------------------------------------


def slstm_init(gen, cfg: ArchConfig):
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    return {
        "w_in": dense_init(gen, d, 4 * d, cfg.pdtype),     # z, i, f, o
        "r": normal_param(gen, (nh, hd, 4 * hd), cfg.pdtype,
                          hd ** -0.5),                     # block-diag recurrent
        "out_norm": rmsnorm_init(d, cfg.pdtype, gen.device),
        "out_proj": dense_init(gen, d, d, cfg.pdtype),
    }


def _slstm_cell(p, cfg: ArchConfig, wx_t, state, r=None):
    """One step: wx_t (B, 4D) precomputed input part; state dict of
    (B, nh, hd).  ``r``: ``p["r"]`` in float32, when the caller has it
    (on a mesh the caller's local heads: nh and hd are read from it)."""
    r = p["r"].float() if r is None else r
    nh, hd = r.shape[0], r.shape[1]
    h, c, n = state["h"], state["c"], state["n"]
    rec = torch.einsum("bhd,hdk->bhk", h, r)                  # (B, nh, 4hd)
    pre = shardctx.divisible(wx_t, -1, nh).reshape(-1, nh, 4 * hd).float() + rec
    z, i, f, o = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z)
    i = torch.exp(torch.clamp(i, max=10.0) - 10.0)  # bounded exp input gate
    f = torch.sigmoid(f)
    o = torch.sigmoid(o)
    c = f * c + i * z
    n = f * n + i
    h = o * c / torch.clamp(n, min=1e-3)
    return {"h": h, "c": c, "n": n}


def slstm_state_init(cfg: ArchConfig, batch: int, device=None):
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    zero = lambda: torch.zeros((batch, nh, hd), dtype=torch.float32,
                               device=device)
    return {"h": zero(), "c": zero(), "n": zero()}


_ONCE = [False]


@contextlib.contextmanager
def recurrence_counted_once():
    """Inside, the sLSTM recurrence runs its cell for the first step only
    and repeats that step's h over the sequence: the full loop's shapes for
    one step's work.  ``launch/dryrun.py`` counts a step so, as XLA's cost
    analysis counts a ``while`` body once, and adds the other steps'
    FLOPs analytically.  The values are not the model's."""
    prev = _ONCE[0]
    _ONCE[0] = True
    try:
        yield
    finally:
        _ONCE[0] = prev


def _slstm_loop(p, cfg: ArchConfig, wx, state, r):
    """The recurrence over wx's L steps: (h for every step (B, L, nh, hd),
    final state)."""
    if _ONCE[0]:
        state = _slstm_cell(p, cfg, wx[:, 0], state, r)
        h = state["h"]
        return h[:, None].expand(h.shape[0], wx.shape[1], *h.shape[1:]), state
    hs = []
    for t in range(wx.shape[1]):
        state = _slstm_cell(p, cfg, wx[:, t], state, r)
        hs.append(state["h"])
    return torch.stack(hs, dim=1), state


def _slstm_local(p, cfg: ArchConfig, wx, state=None):
    """The recurrence of a DTensor ``wx`` on local shards: batch over its
    data axes and heads over "model" where they divide, inside one
    ``to_local``/``from_local`` pair (~500 steps a layer would otherwise
    pay DTensor's dispatch on each of their launches), from ``state``
    (zeros when None).  The heads' h come back as a DTensor (B, L, D) laid
    out alike, with the final state.  ``r``'s gradient on a rank covers
    its batch rows only: partial over the data axes the rows are split
    over."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = wx.device_mesh
    names = mesh.mesh_dim_names
    bsz, l, _ = wx.shape
    nh = cfg.n_heads
    wx_pl, r_pl, r_grad_pl = [], [], []
    for i, name in enumerate(names):
        n = mesh.size(i)
        if name == "model" and n > 1 and nh % n == 0:
            wx_pl.append(Shard(2))
            r_pl.append(Shard(0))
            r_grad_pl.append(Shard(0))
        elif name != "model" and n > 1 and bsz % n == 0:
            wx_pl.append(Shard(0))
            r_pl.append(Replicate())
            r_grad_pl.append(Partial())
        else:
            wx_pl.append(Replicate())
            r_pl.append(Replicate())
            r_grad_pl.append(Replicate())
    wx_l = shardctx.to_local(wx, wx_pl)
    r_l = shardctx.to_local(p["r"].float(), r_pl, r_grad_pl)
    # A state (B, nh, hd) is laid out as wx: batch, then heads.
    st_pl = [Shard(1) if isinstance(q, Shard) and q.dim == 2 else q
             for q in wx_pl]
    if state is None:
        # Shard(0) on several data axes nests; the local batch is what is
        # left.
        state = slstm_state_init(cfg, wx_l.shape[0], device=wx_l.device)
        state = {k: v[:, :r_l.shape[0]] for k, v in state.items()}
    else:
        state = {k: shardctx.to_local(v, st_pl) for k, v in state.items()}
    h, state = _slstm_loop(p, cfg, wx_l, state, r_l)
    h = h.reshape(wx_l.shape[0], l, -1)
    return (shardctx.from_local(h, mesh, wx_pl, shape=(bsz, l, cfg.d_model)),
            {k: shardctx.from_local(v, mesh, st_pl, shape=(bsz, nh, v.shape[2]))
             for k, v in state.items()})


def slstm_apply(p, cfg: ArchConfig, x, state=None, return_state: bool = False):
    bsz, l, d = x.shape
    wx = dense(p["w_in"], x)                              # (B, L, 4D)
    if hasattr(wx, "device_mesh"):
        y, state = _slstm_local(p, cfg, wx, state)
        y = y.to(x.dtype)
    else:
        if state is None:
            state = slstm_state_init(cfg, bsz, device=x.device)
        h, state = _slstm_loop(p, cfg, wx, state, p["r"].float())
        y = h.reshape(bsz, l, d).to(x.dtype)
    y = dense(p["out_proj"], rmsnorm(p["out_norm"], y, cfg.norm_eps))
    if return_state:
        return y, state
    return y


def slstm_decode(p, cfg: ArchConfig, x, state):
    y, state = slstm_apply(p, cfg, x, state, return_state=True)
    return y, state
