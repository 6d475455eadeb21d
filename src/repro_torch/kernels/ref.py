"""Plain-torch oracles of the LM kernels (port of ``repro/kernels/ref.py``).

The SSM chunk scan implements the gated linear-attention recurrence that
covers both Mamba2's SSD (scalar-per-head decay) and xLSTM's mLSTM (scalar
forget gate), per head:

    S_t = a_t * S_{t-1} + k_t^T v_t          S in R^{dk x dv},  a_t in (0, 1]
    y_t = q_t @ S_t

The chunked formulation is the paper's reduce-then-scan (§4.1): chunk-local
reduce (intra-chunk attention + chunk state summary), inter-chunk exclusive
scan of (decay, state) summaries, chunk-local apply.  The tests hold the
port's kernels and ``ops`` against these; the serving path does not call
them.
"""

from __future__ import annotations

import torch


def ssm_scan_reference(q, k, v, log_a):
    """Sequential recurrence oracle.

    Args:
      q, k: (L, dk);  v: (L, dv);  log_a: (L,) with log decay <= 0.
    Returns:
      y: (L, dv) float32
    """
    dk, dv = q.shape[-1], v.shape[-1]
    q32, k32, v32 = q.float(), k.float(), v.float()
    la = log_a.float()
    s = torch.zeros((dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(q.shape[0]):
        s = torch.exp(la[t]) * s + torch.outer(k32[t], v32[t])
        ys.append(q32[t] @ s)
    return torch.stack(ys)


def chunk_local_reference(c, b, v, ca):
    """Oracle for the chunk-local kernel (one chunk, one head).

    Args:
      c (queries): (L, dk); b (keys): (L, dk); v: (L, dv)
      ca: (L,) inclusive cumulative log-decay within the chunk.
    Returns:
      y_intra: (L, dv) — contribution of in-chunk positions.
      s_chunk: (dk, dv) — the chunk's state summary (decayed to chunk end).
    """
    L = c.shape[0]
    c32, b32, v32 = c.float(), b.float(), v.float()
    ca32 = ca.float()
    att = c32 @ b32.T                                   # (L, L)
    # D[t, s] = prod_{u=s+1..t} a_u  for s <= t, else 0.
    delta = ca32[:, None] - ca32[None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=c.device))
    d = torch.exp(torch.where(mask, delta, -1e30))  # mask pre-exp (no inf*0)
    y_intra = (att * d) @ v32
    decay_to_end = torch.exp(ca32[-1] - ca32)           # (L,)
    s_chunk = (b32 * decay_to_end[:, None]).T @ v32     # (dk, dv)
    return y_intra, s_chunk


def chunk_apply_reference(c, ca, y_intra, s_prev):
    """Oracle for the apply kernel: add the inter-chunk state contribution."""
    c32 = c.float()
    scale = torch.exp(ca.float())[:, None]
    return y_intra + (c32 * scale) @ s_prev.float()


def chunked_ssm_reference(q, k, v, log_a, chunk: int):
    """Full chunked (reduce-then-scan) oracle in plain torch, one head."""
    L = q.shape[0]
    assert L % chunk == 0
    nc = L // chunk
    qc, kc, vc = (t.reshape(nc, chunk, -1) for t in (q, k, v))
    lac = log_a.reshape(nc, chunk)
    ca = torch.cumsum(lac.float(), dim=-1)

    ys, states, decays = [], [], []
    for i in range(nc):
        y_i, s_i = chunk_local_reference(qc[i], kc[i], vc[i], ca[i])
        ys.append(y_i)
        states.append(s_i)
        decays.append(torch.exp(ca[i, -1]))
    # Inter-chunk exclusive scan: S_prev for chunk i.
    s_prev = torch.zeros_like(states[0])
    out = []
    for i in range(nc):
        out.append(chunk_apply_reference(qc[i], ca[i], ys[i], s_prev))
        s_prev = decays[i] * s_prev + states[i]
    return torch.cat(out, dim=0)


def attention_reference(q, k, v, *, causal: bool = True, scale=None):
    """Plain softmax attention oracle, one head: q (Lq, d), k/v (Lk, d);
    the causal mask is aligned bottom-right (``tril(k=lk-lq)``)."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = (q.float() @ k.float().T) * scale
    if causal:
        lq, lk = q.shape[0], k.shape[0]
        mask = torch.tril(torch.ones((lq, lk), dtype=torch.bool,
                                     device=q.device), diagonal=lk - lq)
        s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return p @ v.float()
