"""Wrappers around the LM kernels (port of ``repro/kernels/ops.py``).

``ssd_scan`` is the full chunked SSM scan — the paper's reduce-then-scan as
a model layer:

  phase 1 (local reduce)  : ``chunk_local``      (kernel)
  phase 2 (global scan)   : inter-chunk scan of (decay, state) summaries —
                            a prefix circuit (``core.scan.prefix_scan``), or
                            the distributed hierarchical scan when the
                            sequence is sharded over mesh axes
                            (``axis_names``, inside ``spmd.shard_map``)
  phase 3 (local apply)   : ``chunk_apply``      (kernel)

Backends:
  * "pallas"            — the kernels: on CUDA tensors they launch
                          ``csrc/chunk_scan.cu`` / ``csrc/flash_attention.cu``
                          (or raise); on CPU tensors they run their plain
                          versions
  * "pallas_interpret"  — the kernels' plain versions on any device (the
                          reference's interpret mode)
  * "xla"               — the same math in plain torch einsums, as the
                          reference's XLA path; it does not round y_intra to
                          the input dtype between the phases, the kernel
                          backends do

The kernel backends have no backward, on either device, as the reference's
Pallas kernels have none (``jax.grad`` through them raises): under grad
mode with an operand that requires grad they raise
(``_cuda.refuse_autograd``).  Training runs on "xla".
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.distributed import (
    _exclusive_over_hierarchy,
    _nonzero_linear_index,
    hierarchical_collective_scan,
)
from repro_torch.core.scan import prefix_scan

from . import _cuda
from . import chunk_scan as _cs
from . import flash_attention as _fa

_KERNEL_BACKENDS = ("pallas", "pallas_interpret")


def _state_op(a, b):
    """Associative combine of (decay, state) chunk summaries.

    (a1, S1) . (a2, S2) = (a1*a2, a2*S1 + S2); batched over leading axes.
    """
    d1, s1 = a
    d2, s2 = b
    return d1 * d2, d2[..., None, None] * s1 + s2


def ssd_scan(
    q,
    k,
    v,
    log_a,
    *,
    chunk: int = 128,
    backend: str = "xla",
    scan_algorithm: str = "ladner_fischer",
    axis_names: Optional[Sequence[str]] = None,
    axis_sizes: Optional[Sequence[int]] = None,
):
    """Gated linear-attention / SSD scan over the sequence.

    Args:
      q, k: (B, H, L, dk);  v: (B, H, L, dv);  log_a: (B, H, L), <= 0.
      chunk: chunk length (the local segment size of reduce-then-scan).
      axis_names: when set, L is this position's shard (call inside
        ``spmd.shard_map``) and the inter-chunk scan continues
        hierarchically across the given mesh axes, outer first (sequence
        parallelism for the 500k-token shapes).
    Returns: y (B, H, L, dv) in ``v``'s dtype.
    """
    if backend in _KERNEL_BACKENDS:
        _cuda.refuse_autograd(f"ssd_scan(backend={backend!r})", q, k, v,
                              log_a)
    bsz, h, l, dk = q.shape
    dv = v.shape[-1]
    assert l % chunk == 0, f"L={l} % chunk={chunk}"
    nc = l // chunk
    ca = torch.cumsum(log_a.reshape(bsz, h, nc, chunk).float(), dim=-1)

    qc = q.reshape(bsz, h, nc, chunk, dk)
    kc = k.reshape(bsz, h, nc, chunk, dk)
    vc = v.reshape(bsz, h, nc, chunk, dv)

    def flat(t):
        return t.reshape((bsz * h * nc,) + t.shape[3:]).contiguous()

    if backend in _KERNEL_BACKENDS:
        local = (_cs.chunk_local if backend == "pallas"
                 else _cs.chunk_local_reference)
        y_intra, s_chunk = local(flat(qc), flat(kc), flat(vc),
                                 flat(ca[..., None]))
        y_intra = y_intra.reshape(bsz, h, nc, chunk, dv)
        s_chunk = s_chunk.reshape(bsz, h, nc, dk, dv)
    elif backend == "xla":
        c32, b32, v32 = qc.float(), kc.float(), vc.float()
        att = torch.einsum("bhntd,bhnsd->bhnts", c32, b32)
        mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                     device=q.device))
        # Mask *before* exp: above-diagonal deltas are positive and overflow.
        delta = torch.where(mask, ca[..., :, None] - ca[..., None, :], -1e30)
        decay = torch.exp(delta)
        y_intra = torch.einsum("bhnts,bhnsv->bhntv", att * decay, v32)
        to_end = torch.exp(ca[..., -1:] - ca)
        s_chunk = torch.einsum("bhnsd,bhnsv->bhndv", b32 * to_end[..., None],
                               v32)
    else:
        raise ValueError(f"unknown backend {backend!r}")

    decay_tot = torch.exp(ca[..., -1])                  # (B, H, nc)

    # ---- global phase: inter-chunk exclusive scan, leading-axis layout
    # (nc, B, H, ...) for the circuit executor.
    elems = (
        torch.movedim(decay_tot, -1, 0).contiguous(),   # (nc, B, H)
        torch.movedim(s_chunk, 2, 0).contiguous(),      # (nc, B, H, dk, dv)
    )
    inc = prefix_scan(_state_op, elems, algorithm=scan_algorithm)
    if axis_names:
        # Continue the scan across positions: combine the exclusive
        # inter-position prefix into every local chunk (hierarchical scan,
        # paper §4.2).
        last = (inc[0][-1], inc[1][-1])
        g = hierarchical_collective_scan(_state_op, last, axis_names,
                                         axis_sizes=axis_sizes)
        d_p, s_p = _exclusive_over_hierarchy(g, axis_names, axis_sizes)
        if not _nonzero_linear_index(axis_names):
            d_p, s_p = torch.ones_like(d_p), torch.zeros_like(s_p)
        d_in, s_in = inc
        inc = (d_in * d_p[None], d_in[..., None, None] * s_p[None] + s_in)
        s_prev_first = s_p                              # seed for chunk 0
    else:
        s_prev_first = torch.zeros_like(inc[1][0])
    # Exclusive over chunks: chunk i sees the inclusive state of i-1.
    s_prev = torch.cat([s_prev_first[None], inc[1][:-1]], dim=0)
    s_prev = torch.movedim(s_prev, 0, 2)                # (B, H, nc, dk, dv)

    # ---- phase 3: apply.
    if backend in _KERNEL_BACKENDS:
        apply = (_cs.chunk_apply if backend == "pallas"
                 else _cs.chunk_apply_reference)
        y = apply(flat(qc), flat(ca[..., None]), flat(y_intra), flat(s_prev))
        y = y.reshape(bsz, h, nc, chunk, dv)
    else:
        inter = torch.einsum(
            "bhntd,bhndv->bhntv", qc.float() * torch.exp(ca)[..., None], s_prev
        )
        y = y_intra + inter
    return y.reshape(bsz, h, l, dv).to(v.dtype)


def ssm_decode_step(q, k, v, log_a, state):
    """Single-token recurrence (decode): state (B,H,dk,dv) -> (y, new_state).

    q,k: (B,H,dk); v: (B,H,dv); log_a: (B,H)."""
    a = torch.exp(log_a.float())[..., None, None]
    new_state = a * state + torch.einsum("bhd,bhv->bhdv", k, v).float()
    y = torch.einsum("bhd,bhdv->bhv", q.float(), new_state)
    return y.to(v.dtype), new_state


def attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    backend: str = "xla",
    block_q: int = 256,
    block_k: int = 512,
):
    """Multi-head attention wrapper: q (B,Hq,Lq,d), k/v (B,Hkv,Lk,d).

    GQA kv heads are repeated to Hq.  backend as in ``ssd_scan``.
    """
    if backend in _KERNEL_BACKENDS:
        _cuda.refuse_autograd(f"attention(backend={backend!r})", q, k, v)
    bsz, hq, lq, d = q.shape
    hkv = k.shape[1]
    if hkv != hq:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    if backend in _KERNEL_BACKENDS:
        fn = (_fa.flash_attention if backend == "pallas"
              else _fa.flash_attention_reference)
        qf = q.reshape(bsz * hq, lq, d).contiguous()
        kf = k.reshape(bsz * hq, -1, d).contiguous()
        vf = v.reshape(bsz * hq, -1, d).contiguous()
        o = fn(qf, kf, vf, causal=causal, block_q=block_q, block_k=block_k)
        return o.reshape(bsz, hq, lq, d)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    # Plain path (identical math).  Long sequences take the blockwise form:
    # query blocks that attend only their key prefix.
    scale = d ** -0.5
    lk = k.shape[2]
    if lq > 1024 or lq * lk > 1024 * 2048:
        return _blockwise_attention(q, k, v, scale, causal=causal, block_q=512)
    # The scores in float32 from the operands as they are: the reference's
    # einsum(...).astype(f32) compiles to a product with a float32 result,
    # not one rounded to q's type first.
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((lq, lk), dtype=torch.bool,
                                     device=q.device), diagonal=lk - lq)
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _blockwise_attention(q, k, v, scale, *, block_q: int, causal: bool,
                         n_buckets: int = 8):
    """Attention over query blocks, each against a key prefix.

    As the reference's: a causal block's key-prefix length is rounded up to
    one of ``n_buckets`` uniform sizes (the reference does so to reuse one
    score slab per bucket); the rounded-up keys are masked, so the result is
    that of the full causal attention."""
    bsz, h, l, d = q.shape
    block_q = min(block_q, l)

    def blk(q_blk, k_pre, v_pre, q_start):
        s = torch.einsum("bhqd,bhkd->bhqk", q_blk.float(), k_pre.float()) * scale
        if causal:
            rows = q_start + torch.arange(q_blk.shape[2], device=q.device)[:, None]
            cols = torch.arange(k_pre.shape[2], device=q.device)[None, :]
            s = torch.where(rows >= cols, s, -1e30)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p.to(v_pre.dtype), v_pre)

    if not causal:
        nb = (l + block_q - 1) // block_q
        if nb * block_q != l:
            return blk(q, k, v, 0)  # ragged small case: direct
        return torch.cat([blk(q[:, :, i * block_q:(i + 1) * block_q], k, v,
                              i * block_q) for i in range(nb)], dim=2)

    assert l == k.shape[2], "causal path expects self-attention"
    nb = l // block_q
    assert nb * block_q == l, (l, block_q)
    granule = max(block_q, l // n_buckets)
    out = []
    for i in range(nb):
        hi = (i + 1) * block_q
        kb = min(((hi + granule - 1) // granule) * granule, l)
        out.append(blk(q[:, :, i * block_q:hi], k[:, :, :kb], v[:, :, :kb],
                       i * block_q))
    return torch.cat(out, dim=2)
