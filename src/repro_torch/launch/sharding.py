"""Sharding rules: parameters (TP + FSDP), activations, caches (port of
``repro/launch/sharding.py``).

Policy, rule for rule the reference's:
  * TP over "model": attention head projections, MLP hidden, experts, vocab.
  * FSDP over ("pod","data"): the other big dim of every weight matrix.
  * A dim is sharded only when divisible by the axis size (small models —
    whisper, internvl2 — simply replicate what doesn't divide).
  * Stacked-superblock params get a leading None (the scan dim).
  * KV caches: batch over DP, *sequence over TP*.

The rules return trees of :class:`~repro_torch.core.spmd.P` (the
reference's ``PartitionSpec``) and need only the mesh's axis names and
sizes.  :func:`placements` turns a spec into DTensor placements on a
``DeviceMesh`` and :func:`distribute` lays a tree out by its specs: where
the reference hands ``NamedSharding`` trees to ``jax.jit``, the port holds
every leaf as a ``DTensor`` and lets DTensor's sharding propagation insert
the collectives, as GSPMD does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import torch

from repro_torch.core._tree import tree_map
from repro_torch.core.spmd import P
from repro_torch.models.config import ArchConfig

from .mesh import axis_names, axis_size, dp_axes, mesh_shape, tp_axis

# Parents whose 2D weight is a *down* projection: (out_features inherit FSDP).
_DOWN = {"wo", "w2", "out_proj", "head"}
_UP = {"wq", "wk", "wv", "w1", "w3", "wz", "w_in", "in_proj", "w_gates"}


def _div(n: int, axes, mesh) -> bool:
    return axes is not None and n % axis_size(mesh, axes) == 0


def _spec_for(path_keys, shape, mesh) -> P:
    dp = dp_axes(mesh)
    # The reference reads ``tp`` here without binding it (its rules raise
    # NameError on every param tree); the port binds it as
    # ``batch_specs`` and ``state_specs`` do.
    tp = tp_axis(mesh)
    keys = [str(k) for k in path_keys]
    stacked = "blocks" in keys or "encoder" in keys
    name_chain = keys
    parent = None
    for cand in reversed(name_chain):
        if cand in _DOWN | _UP | {"router", "table", "moe", "r", "conv_w",
                                  "conv_b", "a_log", "dt_bias", "d_skip",
                                  "scale", "bias", "b"}:
            parent = cand
            break
    base_shape = shape[1:] if stacked else shape
    nd = len(base_shape)

    def dims(spec_list):
        return P(*([None] + spec_list if stacked else spec_list))

    in_moe = "moe" in keys
    if parent == "table":  # embedding (V, D): D over TP, vocab replicated
        v, d = base_shape
        return dims([None, tp if _div(d, tp, mesh) else None])
    if "head" in keys and nd == 3:  # chunk-major unembedding (NC, D, Vc)
        _, d, vc = base_shape
        return dims([None, dp if _div(d, dp, mesh) else None,
                     tp if _div(vc, tp, mesh) else None])
    if parent == "router":
        d, e = base_shape
        return dims([dp if _div(d, dp, mesh) else None, None])
    if in_moe and parent in ("w1", "w3") and nd == 3:  # (E, D, F)
        e, d, f = base_shape
        return dims([tp if _div(e, tp, mesh) else None,
                     dp if _div(d, dp, mesh) else None, None])
    if in_moe and parent == "w2" and nd == 3:          # (E, F, D)
        e, f, d = base_shape
        return dims([tp if _div(e, tp, mesh) else None, None,
                     dp if _div(d, dp, mesh) else None])
    if parent in _UP and nd == 2:                      # (D_in, F_out)
        din, dout = base_shape
        return dims([dp if _div(din, dp, mesh) else None,
                     tp if _div(dout, tp, mesh) else None])
    if parent in _DOWN and nd == 2:                    # (F_in, D_out)
        fin, dout = base_shape
        return dims([tp if _div(fin, tp, mesh) else None,
                     dp if _div(dout, dp, mesh) else None])
    if parent == "b" and nd == 1:                      # bias of the layer above
        # biases follow the output dim of their parent projection
        grand = keys[-3] if len(keys) >= 3 else ""
        ax = dp if grand in _DOWN else tp
        return dims([ax if _div(base_shape[0], ax, mesh) else None])
    if parent == "r" and nd == 3:                      # sLSTM recurrent (nh, hd, 4hd)
        nh = base_shape[0]
        return dims([tp if _div(nh, tp, mesh) else None, None, None])
    # norms, conv, gates, scalars: replicate (tiny).
    return dims([None] * nd)


def _map_with_keys(fn, tree, keys=()):
    """``tree`` with each leaf replaced by ``fn(path keys, leaf)``: dict
    keys as they are, sequence indices as ``jax.tree_util`` prints them
    (``[i]``), named-tuple fields as ``.name``."""
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_with_keys(fn, v, keys + (f".{f}",))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_keys(fn, v, keys + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(keys, tree)


def param_shardings(params, cfg: ArchConfig, mesh):
    """Spec tree for a params (or opt-state params-like) tree."""
    return _map_with_keys(lambda keys, leaf: _spec_for(keys, leaf.shape, mesh),
                          params)


def opt_state_shardings(opt_state, params_shardings, mesh):
    """m/v/master inherit the param shardings; step is replicated."""
    from repro_torch.optim.adamw import OptState

    ps = params_shardings
    return OptState(
        step=P(),
        m=ps,
        v=ps,
        master=ps if opt_state.master != () else (),
    )


# ---------------------------------------------------------------------------
# Activations / inputs / caches
# ---------------------------------------------------------------------------


def batch_specs(cfg: ArchConfig, mesh, *, kind: str, seq_shard: bool = False):
    """Specs for the input batch dict."""
    dp = dp_axes(mesh)
    if kind == "decode":
        token_spec = P(dp, None)
    elif seq_shard:
        # Sequence parallelism: shard L over the DP axes (batch may be small).
        token_spec = P(None, dp)
    else:
        token_spec = P(dp, None)
    specs = {"tokens": token_spec, "labels": token_spec}
    if cfg.frontend == "patch":
        specs["patches"] = P(token_spec[0], None, None)
    if cfg.frontend == "audio":
        specs["frames"] = P(token_spec[0], None, None)
    return specs


def state_specs(cfg: ArchConfig, mesh, states, *, batch: int):
    """Decode-state specs: KV caches (n_super, B, Hkv, S, hd) -> sequence
    over TP, batch over DP (when divisible); SSM states shard heads over TP."""
    dp = dp_axes(mesh)
    tp = tp_axis(mesh)
    b_ok = batch % axis_size(mesh, dp) == 0

    # When the batch can't shard over DP (long_500k: B=1), fold the DP axes
    # into the cache-sequence sharding instead.
    s_axes = tp if b_ok else (tuple(dp) + ((tp,) if tp else ()))

    def spec(keys, leaf):
        shape = leaf.shape
        if "enc_out" in keys:
            return P(dp if b_ok else None, None, None)
        # KV caches: stacked (n_super, B, Hkv, S, hd) or per-layer 4D.
        if keys and keys[-1] in ("k", "v") and len(shape) in (4, 5):
            stacked = len(shape) == 5
            s = shape[3] if stacked else shape[2]
            body = P(
                dp if b_ok else None,
                None,
                s_axes if _div(s, s_axes, mesh) else None,
                None,
            )
            return P(None, *body) if stacked else body
        # SSM/mLSTM matrix states: (n_super?, B, nh, ds, hd)
        if keys and keys[-1] in ("ssm", "C") and len(shape) >= 3:
            stacked = len(shape) >= 5
            nh = shape[2] if stacked else shape[1]
            body = P(dp if b_ok else None,
                     tp if _div(nh, tp, mesh) else None)
            return P(None, *body) if stacked else body
        # generic small states (conv, normalizers, h/c/n): batch-shard when
        # possible; leading n_super dim for the stacked layout.
        if len(shape) >= 2:
            if keys and any(k.startswith("sb") for k in keys):
                return P(dp if b_ok else None)
            return P(None, dp if b_ok else None)
        return P()

    return _map_with_keys(spec, states)


def logits_spec(cfg: ArchConfig, mesh):
    dp = dp_axes(mesh)
    tp = tp_axis(mesh)
    v_ok = cfg.padded_vocab % axis_size(mesh, tp) == 0 if tp else False
    return P(dp, None, tp if v_ok else None)


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: P, mesh) -> List[Any]:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` that names it, else (or where
    the axis has size 1) ``Replicate()``.  A dim split over several axes takes ``Shard(d)`` on
    each, in mesh order: the reference's major-first block order."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    spec = spec if isinstance(spec, P) else P(*spec)
    where = {}
    for d in range(len(spec)):
        axes = spec.axes(d)
        for a in axes:
            if a not in names:
                raise NameError(f"unbound axis name {a!r}; the mesh has "
                                f"{names}")
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            where[a] = d
    # An axis of size 1 splits nothing: replicated, so DTensor's rules
    # never meet a sharded dim they would have to reshape.
    sizes = mesh_shape(mesh)
    return [Shard(where[a]) if a in where and sizes[a] > 1 else Replicate()
            for a in names]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: the reference's ``NamedSharding``, for
    ``Checkpointer.restore(shardings=...)``."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> List[Any]:
        return placements(self.spec, self.mesh)


def named(mesh, specs):
    """A tree of :class:`NamedSharding` from a tree of specs (a spec is a
    tuple, so tree maps would descend into it)."""
    if isinstance(specs, P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: named(mesh, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*[named(mesh, v) for v in specs])
    if isinstance(specs, (list, tuple)):
        return type(specs)(named(mesh, v) for v in specs)
    return specs


def distribute(tree, specs, mesh):
    """Every tensor leaf of ``tree`` as a ``DTensor`` laid out by its spec.
    Each rank must hold the same full value: each keeps its own block, with
    no communication (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, mesh, placements(spec, mesh),
                                 src_data_rank=None)

    return tree_map(lambda t, ns: one(t, ns.spec), tree, named(mesh, specs))
