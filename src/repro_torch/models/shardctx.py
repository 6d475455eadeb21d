"""Activation-sharding context: explicit anchors inside the model (port of
``repro/models/shardctx.py``).

The reference anchors activations with ``with_sharding_constraint`` so
GSPMD keeps the batch sharded across remat and attention blocks.  The port
holds a sharded step's params and batch as ``DTensor``s; its anchors are
``redistribute`` calls to the same specs, so DTensor's propagation sees
the layout the reference asks GSPMD for.  The launcher installs this
context around the step; the model calls ``constrain_*`` at block
boundaries.  Without a context, or on a plain tensor (every one-device
path), every call returns its argument.

Where DTensor (torch 2.11, the card's) has no sharding rule on the path,
the port gathers explicitly, as GSPMD gathers there: the sequence before a
projection (``gather_seq``, and its gradient: ``seq_gathered_grad``), and
each rank's batch rows or (batch, head) blocks run on local tensors inside
one ``to_local``/``from_local`` pair (``local_heads``: the attention and
SSD cores; ``local_vocab``: the loss, its head kept in vocab blocks over
"model"; ``local_experts``: the MoE layer, its experts kept in blocks
over "model"; ``local_rows``: either, where "model" does not divide the
blocks, with the weights gathered whole; ``local_embed``; ``pointwise``:
``logsigmoid``, whose backward has no rule).  A weight taken to local
tensors declares its gradient partial over the data axes its rows are
split over.  A projection viewed as heads that "model" does not divide is
replicated over "model" first (``split_heads``).  ``bind`` carries the
context into a remat recompute, which runs on the autograd engine's
thread.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.core.spmd import P

_tls = threading.local()


def _get():
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def activation_sharding(mesh, *, dp, tp):
    """dp: tuple of data axes; tp: model axis name or None."""
    prev = _get()
    _tls.ctx = {"mesh": mesh, "dp": tuple(dp), "tp": tp}
    try:
        yield
    finally:
        _tls.ctx = prev


def current():
    """The installed context's dict, or None."""
    return _get()


def bind(fn):
    """``fn`` run under the context installed now.  A checkpointed
    function's recompute runs in the backward pass, on the autograd
    engine's device thread, where the launcher's thread-local context is
    not installed; bound, it recomputes under the same anchors."""
    ctx = _get()

    def run(*args, **kwargs):
        prev = _get()
        _tls.ctx = ctx
        try:
            return fn(*args, **kwargs)
        finally:
            _tls.ctx = prev

    return run


def _axis_size(mesh, names) -> int:
    from repro_torch.launch.mesh import axis_size

    return axis_size(mesh, names)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _apply(x, spec):
    from repro_torch.launch.sharding import placements

    mesh = _get()["mesh"]
    return x.redistribute(mesh, placements(spec, mesh))


def _active(x):
    """The context, when it is installed and ``x`` is a DTensor."""
    ctx = _get()
    if ctx is None or not _is_dtensor(x):
        return None
    return ctx


def constrain_tokens_major(x):
    """(B, L, D) activations: batch over dp, sequence over tp.

    The L/tp factor is Megatron-style sequence parallelism for the residual
    stream: per-layer saved residuals shrink by the TP degree.  The
    all-gather before attention/MLP and the reduce-scatter after come from
    DTensor's propagation, as GSPMD's do in the reference."""
    ctx = _active(x)
    if ctx is None or x.ndim != 3:
        return x
    mesh, dp, tp = ctx["mesh"], ctx["dp"], ctx["tp"]
    b_ok = x.shape[0] % _axis_size(mesh, dp) == 0
    l_ok = tp is not None and x.shape[1] % _axis_size(mesh, tp) == 0 and x.shape[1] > 1
    if b_ok or l_ok:
        return _apply(x, P(dp if b_ok else None, tp if l_ok else None, None))
    return x


def constrain_heads(x):
    """(B, H, L, hd): batch over dp, heads over tp when divisible."""
    ctx = _active(x)
    if ctx is None or x.ndim != 4:
        return x
    mesh, dp, tp = ctx["mesh"], ctx["dp"], ctx["tp"]
    b_ok = x.shape[0] % _axis_size(mesh, dp) == 0
    h_ok = tp is not None and x.shape[1] % _axis_size(mesh, tp) == 0
    if b_ok or h_ok:
        return _apply(x, P(dp if b_ok else None, tp if h_ok else None, None, None))
    return x


def constrain_vocab_chunk(x):
    """(B, L, Vc) logit chunks: batch over dp, vocab over tp."""
    ctx = _active(x)
    if ctx is None or x.ndim != 3:
        return x
    mesh, dp, tp = ctx["mesh"], ctx["dp"], ctx["tp"]
    b_ok = x.shape[0] % _axis_size(mesh, dp) == 0
    v_ok = tp is not None and x.shape[2] % _axis_size(mesh, tp) == 0
    if b_ok or v_ok:
        return _apply(x, P(dp if b_ok else None, None, tp if v_ok else None))
    return x


def _canonical(t):
    """``t`` with the strides of a contiguous tensor of its shape.  DTensor
    derives a global stride from a local shard's, and a dim of size 1 may
    carry any stride (a head dim of 1 out of an einsum does), which it
    scales into a transposed layout that later views trip over."""
    return t.contiguous().reshape(-1).view(t.shape)


class _CanonicalGrad(torch.autograd.Function):
    """Identity whose backward gives the gradient canonical strides."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _canonical(g)


def to_local(x, placements, grad_placements=None):
    """``x`` redistributed to ``placements``, as its local shard, whose
    gradient comes back with canonical strides (:func:`_canonical`)."""
    t = x.redistribute(x.device_mesh, placements).to_local(
        grad_placements=grad_placements)
    return _CanonicalGrad.apply(t) if t.requires_grad else t


def from_local(t, mesh, placements, **kw):
    """A DTensor of local shards ``t`` laid out by ``placements``, made
    from canonical strides (:func:`_canonical`)."""
    from torch.distributed.tensor import DTensor

    if "shape" in kw and "stride" not in kw:
        stride, n = [], 1
        for size in reversed(kw["shape"]):
            stride.insert(0, n)
            n *= size
        kw["stride"] = tuple(stride)
    return DTensor.from_local(_canonical(t), mesh, placements,
                              run_check=False, **kw)


def pointwise(fn, x):
    """``fn`` (elementwise) of ``x``; on a DTensor, of its local shard
    inside one ``to_local``/``from_local`` pair, for ops DTensor has no
    sharding rule for (``log_sigmoid_backward``).  A partial value is
    reduced first."""
    if not _is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Partial, Replicate

    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return from_local(fn(to_local(x, pl)), x.device_mesh, pl, shape=x.shape)


def gather_seq(x):
    """A (B, L, ..., D) DTensor with its middle dims gathered (batch and
    last dim kept as they are laid out): the all-gather GSPMD inserts
    before a projection of a sequence-parallel residual stream.  DTensor
    (torch 2.11) refuses to flatten (B, L) for a matmul while L is
    sharded."""
    if not _is_dtensor(x) or x.ndim < 3:
        return x
    from torch.distributed.tensor import Replicate, Shard

    pl = [Replicate() if isinstance(p, Shard) and 0 < p.dim < x.ndim - 1
          else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def divisible(y, dim: int, n: int):
    """``y`` ready to have its dim ``dim`` split into ``n`` groups (heads):
    a DTensor sharded on that dim over a mesh dim whose size does not
    divide ``n`` (8 kv heads over a "model" of 16) is replicated over that
    mesh dim, as GSPMD reshards the reference's there (DTensor cannot
    unflatten a dim whose shards cut through a group).  Where the groups
    divide, or on a plain tensor, nothing moves."""
    if not _is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate, Shard

    mesh = y.device_mesh
    dim %= y.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim % y.ndim == dim
          and n % mesh.size(i) else p for i, p in enumerate(y.placements)]
    if pl == list(y.placements):
        return y
    return y.redistribute(mesh, pl)


def split_heads(y, n_heads: int, head_dim: int):
    """A projection's output ``y`` (B, L, n_heads * head_dim) viewed as
    (B, L, n_heads, head_dim), :func:`divisible` first."""
    y = divisible(y, -1, n_heads)
    return y.reshape(*y.shape[:-1], n_heads, head_dim)


class _MergedHeadsGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient :func:`divisible` into
    the heads, for the view back to (..., heads, head_dim)."""

    @staticmethod
    def forward(ctx, y, n_heads):
        ctx.n_heads = n_heads
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return divisible(g, -1, ctx.n_heads), None


def merge_heads(o):
    """(..., H, hd) heads as (..., H * hd), the inverse of
    :func:`split_heads`: on a DTensor the gradient coming back is made
    :func:`divisible` into the H heads before it is viewed as them (a
    projection's gradient comes back sharded over "model" whether or not
    "model" divides H)."""
    n_heads = o.shape[-2]
    y = o.reshape(*o.shape[:-2], n_heads * o.shape[-1])
    return _MergedHeadsGrad.apply(y, n_heads) if _is_dtensor(y) else y


def local_heads(fn, *xs):
    """``fn(*xs)`` for (B, H, ...) tensors that are independent per batch
    row and head (attention's and the SSD scan's cores, the recurrent
    decode steps): on DTensors, run on each rank's local (batch, head)
    block inside one ``to_local``/``from_local`` pair — batch over the data
    axes and heads over "model" where every input's count divides — and
    the result, a (B, H, ...) tensor or a tuple of them, laid out alike.
    Plain tensors go straight to ``fn``."""
    if not any(_is_dtensor(x) for x in xs):
        return fn(*xs)
    from torch.distributed.tensor import Shard

    mesh = next(x for x in xs if _is_dtensor(x)).device_mesh
    pl = _batch_placements(mesh, xs[0].shape[0])
    for i, name in enumerate(mesh.mesh_dim_names):
        if name == "model" and mesh.size(i) > 1 and all(
                x.shape[1] % mesh.size(i) == 0 for x in xs):
            pl[i] = Shard(1)
    out = fn(*[to_local(x, pl) for x in xs])
    if isinstance(out, tuple):
        return tuple(from_local(t, mesh, pl) for t in out)
    return from_local(out, mesh, pl)


class _GatherSeqGrad(torch.autograd.Function):
    """Identity whose backward gathers the gradient's middle dims."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return gather_seq(g)


def seq_gathered_grad(y):
    """``y``; on a DTensor, its gradient arrives with the sequence gathered
    (``gather_seq``): a (B, L, .) product's gradient may come back
    sequence-sharded from the residual stream, and DTensor (torch 2.11)
    cannot flatten it for the matmul's backward."""
    return _GatherSeqGrad.apply(y) if _is_dtensor(y) else y


def _batch_placements(mesh, bsz: int, rows_ok=lambda rows: True):
    """Placements that split a batch of ``bsz`` rows over the data axes
    where it divides (and ``rows_ok`` accepts the rows a rank keeps), and
    replicate it over "model" and over axes of size 1."""
    from torch.distributed.tensor import Replicate, Shard

    pl, ways = [], 1
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if (name != "model" and n > 1 and bsz % (ways * n) == 0
                and rows_ok(bsz // (ways * n))):
            ways *= n
            pl.append(Shard(0))
        else:
            pl.append(Replicate())
    return pl


def _grad_placements(batch_pl, keep=None):
    """A gathered weight's gradient on each rank: partial over the mesh dims
    its batch rows are split over, whole (replicated, or ``keep``'s shard)
    elsewhere."""
    from torch.distributed.tensor import Partial, Shard

    out = []
    for i, p in enumerate(batch_pl):
        if isinstance(p, Shard):
            out.append(Partial())
        else:
            out.append(keep[i] if keep is not None else p)
    return out


def local_rows(fn, params, *xs, rows_ok=lambda rows: True,
               outs=("rows", "mean")):
    """``fn(params, *xs)`` for (B, ...) DTensors ``xs`` whose batch rows
    are independent (the MoE layer's groups, the loss's tokens): each rank
    runs ``fn`` on its rows (split over the data axes where ``rows_ok``
    accepts the rows a rank keeps) with every weight of ``params``
    gathered whole — the all-gather GSPMD inserts before a layer it does
    not shard — and the weights' gradients reduced back to their shards.
    Each output comes back by its kind in ``outs``: "rows" laid out like
    the rows, "mean" / "sum" a scalar averaged / summed over the ranks'
    rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.core._tree import tree_map

    mesh = xs[0].device_mesh
    pl = _batch_placements(mesh, xs[0].shape[0], rows_ok)
    full = [Replicate()] * mesh.ndim
    gpl = _grad_placements(pl)
    local_p = tree_map(lambda w: to_local(w, full, gpl), params)
    got = fn(local_p, *[to_local(x, pl) for x in xs])

    ways = 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            ways *= mesh.size(i)

    def back(t, kind):
        if kind == "rows":
            return from_local(t, mesh, pl)
        # A mean is the sum of each rank's share: a partial "avg" would
        # take the whole gradient back to every rank's term (the backward
        # of a reduction passes the gradient through unscaled).
        if kind == "mean":
            t = t / ways
        return from_local(
            t, mesh, [Partial() if isinstance(p, Shard) else p for p in pl])

    return tuple(back(t, kind) for t, kind in zip(got, outs))


_EXPERTS = ("w1", "w3", "w2")     # the MoE layer's (E, ., .) leaves


def local_experts(fn, params, x, *, rows_ok):
    """The MoE layer on a mesh with its experts kept sharded over "model"
    (GSPMD's layout for the reference's dense dispatch, whose expert
    contraction it reduces over "model"): each rank routes its batch rows
    (split over the data axes where ``rows_ok`` accepts them) with the
    whole router, and runs only its block of experts, gathered over the
    data axes alone.  ``fn(local_params, x_local, lo)`` gets the experts
    ``lo:lo + E / tp`` and returns (its experts' share of y, the aux
    loss); the shares are summed over "model", the aux loss averaged over
    the ranks' rows.  Gradients: the experts' stay sharded over "model"
    and are partial over the data axes the rows are split over; the
    router's and the rows' are partial over "model" too, so each rank
    gives its share.  When "model" does not divide E, every rank gathers
    every expert (:func:`local_rows`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    n_exp = params[_EXPERTS[0]].shape[0]
    mi = next((i for i, name in enumerate(names)
               if name == "model" and n_exp % mesh.size(i) == 0), None)
    if mi is None:
        return local_rows(lambda p, x: fn(p, x, 0), params, x,
                          rows_ok=rows_ok)
    pl = _batch_placements(mesh, x.shape[0], rows_ok)
    ways = 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            ways *= mesh.size(i)
    tp = mesh.size(mi)
    part_m = [Partial() if i == mi else p for i, p in enumerate(pl)]
    e_pl = [Shard(0) if i == mi else Replicate() for i in range(mesh.ndim)]

    def gathered(key, w):
        if key in _EXPERTS:
            return to_local(w, e_pl, _grad_placements(pl, keep=e_pl))
        return to_local(w, [Replicate()] * mesh.ndim,
                        _grad_placements(part_m))

    local_p = {k: (gathered(k, w) if k in _EXPERTS else
                   {kk: gathered(k, ww) for kk, ww in w.items()})
               for k, w in params.items()}
    lo = mesh.get_local_rank(mi) * (n_exp // tp)
    y, aux = fn(local_p, to_local(x, pl, part_m), lo)
    y = from_local(y, mesh, part_m).redistribute(mesh, pl)
    # Every "model" rank forms the same aux loss: each gives a tp-th share.
    aux = from_local(aux / (ways * tp), mesh,
                     [Partial() if isinstance(p, Shard) else p
                      for p in part_m])
    return y, aux


def local_vocab(fn, head_w, x, labels):
    """The vocab-chunked loss on a mesh with the chunk-major head (NC, D,
    Vc) kept in blocks over "model" (the rules' layout, GSPMD's for the
    reference's loss): each rank takes its batch rows (split over the data
    axes where they divide) against its vocab block ``lo:lo + Vc / tp`` of
    every chunk, gathered over the data axes alone.  ``fn(w_local,
    x_local, labels_local, lo)`` returns the block's (logsumexp, gold
    logit, mask) of each token; one all-gather over "model" brings every
    block's pair to every rank, which combines them (a logsumexp of the
    blocks' logsumexps, a sum of the gold logits).  Returns the non-ignored
    tokens' nll sum and count, each summed over the ranks' rows.
    Gradients: the head's blocks stay sharded over "model", partial over
    the data axes the rows are split over; the rows' is partial over
    "model", each block giving its share.  When "model" does not divide
    Vc, every rank gathers the whole head (:func:`local_rows`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    vc = head_w.shape[2]
    mi = next((i for i, name in enumerate(mesh.mesh_dim_names)
               if name == "model" and mesh.size(i) > 1
               and vc % mesh.size(i) == 0), None)

    def sums(logz, gold, mask):
        nll = (logz - gold) * mask
        return nll.sum(), mask.sum()

    if mi is None:
        return local_rows(lambda w, x, labels: sums(*fn(w, x, labels, 0)),
                          head_w, x, labels, outs=("sum", "sum"))
    pl = _batch_placements(mesh, x.shape[0])
    part_m = [Partial() if i == mi else p for i, p in enumerate(pl)]
    w_pl = [Shard(2) if i == mi else Replicate() for i in range(mesh.ndim)]
    w_local = to_local(head_w, w_pl, _grad_placements(pl, keep=w_pl))
    x_local = to_local(x, pl, part_m)
    if not _is_dtensor(labels):
        labels = from_local(labels, mesh, [Replicate()] * mesh.ndim)
    labels_local = to_local(labels, pl)
    lo = mesh.get_local_rank(mi) * (vc // mesh.size(mi))
    logz, gold, mask = fn(w_local, x_local, labels_local, lo)
    # Every block's (logsumexp, gold) pair, stacked over "model" on every
    # rank; each rank then forms the same loss (replicated over "model").
    stacked = [Shard(0) if i == mi else
               (Shard(p.dim + 1) if isinstance(p, Shard) else p)
               for i, p in enumerate(pl)]
    gathered = [Replicate() if i == mi else p for i, p in enumerate(stacked)]
    both = to_local(from_local(torch.stack([logz, gold])[None], mesh,
                               stacked), gathered, gathered)
    nll, count = sums(torch.logsumexp(both[:, 0], dim=0), both[:, 1].sum(0),
                      mask)
    total = [Partial() if isinstance(p, Shard) else p for p in pl]
    return from_local(nll, mesh, total), from_local(count, mesh, total)


def vocab_logits(fn, head_w, x):
    """A chunk-major head's (B, L, NC, Vc) logits on a mesh: each rank
    forms its batch rows' logits against its "model" block of every chunk
    (``fn(w_local, x_local)``), and one all-gather over "model" joins the
    blocks (DTensor (torch 2.11) cannot flatten the head's sharded vocab
    dim inside an einsum).  The logits come back with the rows laid out
    as the batch and the vocab whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    vc = head_w.shape[2]
    mi = next((i for i, name in enumerate(mesh.mesh_dim_names)
               if name == "model" and mesh.size(i) > 1
               and vc % mesh.size(i) == 0), None)
    pl = _batch_placements(mesh, x.shape[0])
    w_pl = [Shard(2) if i == mi else Replicate() for i in range(mesh.ndim)]
    part_m = [Partial() if i == mi else p for i, p in enumerate(pl)]
    out = fn(to_local(head_w, w_pl, _grad_placements(pl, keep=w_pl)),
             to_local(x, pl, part_m))
    return from_local(out, mesh, [Shard(3) if i == mi else p
                                  for i, p in enumerate(pl)]).redistribute(
        mesh, pl)


def local_cache(scores_fn, out_fn, q, k, v, cache_k, cache_v):
    """One decode step's attention with the KV cache kept where the rules
    put it (batch over the data axes, the sequence over "model", or over
    every axis when the batch does not divide them): each rank writes the
    token into its own slots and attends them.  ``scores_fn(q, k, v, ck,
    cv, lo)`` gets the rank's rows of every head and its cache block of
    slots ``lo:lo + S_local`` and returns (its masked float32 scores, ck,
    cv); ``out_fn(probs, cv)`` is the block's share of the output.  Two
    all-gathers over the mesh dims that split the sequence make the
    softmax whole: each block's (max, sum of exponentials) first, so every
    block normalises its probabilities as one device would (and rounds
    them alike), then the blocks' shares, summed.  Returns (output, new k
    cache, new v cache)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = cache_k.device_mesh
    # Batch and sequence stay where they are; any other split is undone.
    cpl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
           for p in cache_k.placements]
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in cpl]
    seq = [i for i, p in enumerate(cpl) if isinstance(p, Shard) and p.dim == 2]
    stacked = [Shard(0) if i in seq else
               (Shard(p.dim + 1) if isinstance(p, Shard) else p)
               for i, p in enumerate(rows)]
    gathered = [Replicate() if i in seq else p for i, p in enumerate(stacked)]

    def every_block(t):
        return to_local(from_local(t[None], mesh, stacked), gathered)

    _, offset = compute_local_shape_and_global_offset(cache_k.shape, mesh, cpl)
    scores, ck, cv = scores_fn(*[to_local(t, rows) for t in (q, k, v)],
                               to_local(cache_k, cpl), to_local(cache_v, cpl),
                               offset[2])
    m = scores.amax(-1)
    e = torch.exp(scores - m[..., None])
    if seq:
        ms = every_block(torch.stack([m, e.sum(-1)], -1))
        top = ms[..., 0].amax(0)
        total = (ms[..., 1] * torch.exp(ms[..., 0] - top)).sum(0)
        o = every_block(out_fn(e * (torch.exp(m - top) / total)[..., None],
                               cv)).sum(0)
    else:
        o = out_fn(e / e.sum(-1, keepdim=True), cv)
    return (from_local(o, mesh, rows),
            from_local(ck, mesh, cpl, shape=cache_k.shape),
            from_local(cv, mesh, cpl, shape=cache_v.shape))


def fill_cache(cache, new):
    """``cache`` (B, H, S, hd) with ``new`` (B, H, L, hd) written into its
    first L slots, as a new tensor.  On a mesh the cache keeps its layout
    (the sequence split over "model"): each rank writes the part of
    ``new`` that falls in its own block of slots."""
    l = new.shape[2]
    if not _is_dtensor(cache):
        if l == cache.shape[2]:
            return new.to(cache.dtype)
        out = cache.clone()
        out[:, :, :l] = new.to(out.dtype)
        return out
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = cache.device_mesh
    cpl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
           for p in cache.placements]
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in cpl]
    local = to_local(cache, cpl)
    lo = compute_local_shape_and_global_offset(cache.shape, mesh, cpl)[1][2]
    hi = min(lo + local.shape[2], l)
    new = to_local(new, rows)
    if hi - lo == local.shape[2]:          # the block lies inside the prompt
        local = new[:, :, lo:hi].to(local.dtype)
    else:
        local = local.clone()
        if hi > lo:
            local[:, :, :hi - lo] = new[:, :, lo:hi].to(local.dtype)
    return from_local(local, mesh, cpl, shape=cache.shape)


def local_embed(table, ids):
    """``table[ids]`` for a DTensor table (V, D), its D over "model", and
    (B, L) ids: each rank looks its batch rows up in its D block; the
    table's gradient is partial over the data axes the rows are split
    over."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = table.device_mesh
    pl = _batch_placements(mesh, ids.shape[0])
    tpl = [p if name == "model" else Replicate()
           for name, p in zip(mesh.mesh_dim_names, table.placements)]
    t_local = to_local(table, tpl, _grad_placements(pl, keep=tpl))
    if not _is_dtensor(ids):
        ids = from_local(ids, mesh, [Replicate()] * mesh.ndim)
    out_pl = [Shard(2) if isinstance(tp, Shard) else p
              for p, tp in zip(pl, tpl)]
    return from_local(t_local[to_local(ids, pl)], mesh, out_pl)
