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
SSD cores; ``local_rows``: the loss, its head gathered whole;
``local_experts``: the MoE layer, its experts kept in blocks over
"model"; ``local_embed``; ``pointwise``: ``logsigmoid``, whose backward
has no rule).  A weight taken to local tensors declares its gradient
partial over the data axes its rows are split over.  ``bind`` carries the
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


def pointwise(fn, x):
    """``fn`` (elementwise) of ``x``; on a DTensor, of its local shard
    inside one ``to_local``/``from_local`` pair, for ops DTensor has no
    sharding rule for (``log_sigmoid_backward``).  A partial value is
    reduced first."""
    if not _is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


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


def local_heads(fn, *xs):
    """``fn(*xs)`` for (B, H, ...) tensors that are independent per batch
    row and head (attention's and the SSD scan's cores): on DTensors, run
    on each rank's local (batch, head) block inside one
    ``to_local``/``from_local`` pair — batch over the data axes and heads
    over "model" where every input's count divides — and the result, a
    (B, H, ...) tensor, laid out alike.  Plain tensors go straight to
    ``fn``."""
    if not any(_is_dtensor(x) for x in xs):
        return fn(*xs)
    from torch.distributed.tensor import DTensor, Shard

    mesh = next(x for x in xs if _is_dtensor(x)).device_mesh
    pl = _batch_placements(mesh, xs[0].shape[0])
    for i, name in enumerate(mesh.mesh_dim_names):
        if name == "model" and all(x.shape[1] % mesh.size(i) == 0
                                   for x in xs):
            pl[i] = Shard(1)
    local = [x.redistribute(mesh, pl).to_local() for x in xs]
    return DTensor.from_local(fn(*local), mesh, pl, run_check=False)


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
    replicate it over "model"."""
    from torch.distributed.tensor import Replicate, Shard

    pl, ways = [], 1
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if (name != "model" and bsz % (ways * n) == 0
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
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.core._tree import tree_map

    mesh = xs[0].device_mesh
    pl = _batch_placements(mesh, xs[0].shape[0], rows_ok)
    full = [Replicate()] * mesh.ndim
    gpl = _grad_placements(pl)
    local_p = tree_map(lambda w: w.redistribute(mesh, full).to_local(
        grad_placements=gpl), params)
    got = fn(local_p, *[x.redistribute(mesh, pl).to_local() for x in xs])

    ways = 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            ways *= mesh.size(i)

    def back(t, kind):
        if kind == "rows":
            return DTensor.from_local(t, mesh, pl, run_check=False)
        # A mean is the sum of each rank's share: a partial "avg" would
        # take the whole gradient back to every rank's term (the backward
        # of a reduction passes the gradient through unscaled).
        if kind == "mean":
            t = t / ways
        return DTensor.from_local(
            t, mesh, [Partial() if isinstance(p, Shard) else p for p in pl],
            run_check=False)

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
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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
            return w.redistribute(mesh, e_pl).to_local(
                grad_placements=_grad_placements(pl, keep=e_pl))
        full = [Replicate()] * mesh.ndim
        return w.redistribute(mesh, full).to_local(
            grad_placements=_grad_placements(part_m))

    local_p = {k: (gathered(k, w) if k in _EXPERTS else
                   {kk: gathered(k, ww) for kk, ww in w.items()})
               for k, w in params.items()}
    lo = mesh.get_local_rank(mi) * (n_exp // tp)
    y, aux = fn(local_p, x.redistribute(mesh, pl).to_local(
        grad_placements=part_m), lo)
    y = DTensor.from_local(y, mesh, part_m, run_check=False).redistribute(
        mesh, pl)
    # Every "model" rank forms the same aux loss: each gives a tp-th share.
    aux = DTensor.from_local(
        aux / (ways * tp), mesh,
        [Partial() if isinstance(p, Shard) else p for p in part_m],
        run_check=False)
    return y, aux


def local_embed(table, ids):
    """``table[ids]`` for a DTensor table (V, D), its D over "model", and
    (B, L) ids: each rank looks its batch rows up in its D block; the
    table's gradient is partial over the data axes the rows are split
    over."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = table.device_mesh
    pl = _batch_placements(mesh, ids.shape[0])
    tpl = [p if name == "model" else Replicate()
           for name, p in zip(mesh.mesh_dim_names, table.placements)]
    t_local = table.redistribute(mesh, tpl).to_local(
        grad_placements=_grad_placements(pl, keep=tpl))
    if not _is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    out_pl = [Shard(2) if isinstance(tp, Shard) else p
              for p, tp in zip(pl, tpl)]
    return DTensor.from_local(t_local[ids.redistribute(mesh, pl).to_local()],
                              mesh, out_pl, run_check=False)
