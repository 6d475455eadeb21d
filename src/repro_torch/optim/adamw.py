"""AdamW with decoupled weight decay, fp32 state, global-norm clipping
(port of ``repro/optim/adamw.py``).

The state is a tree shaped like the params.  Params may be bf16; the
update is computed in fp32 against an fp32 master copy kept inside the
state (mixed-precision training discipline).  The arithmetic is the
reference's, step for step: the bias corrections, the learning rate and
the clip scale are float32 tensors on the params' device.

``update`` writes m, v, the master and the params **in place**: the
port's counterpart of the reference's ``jax.jit(..., donate_argnums=(0,
1))``, so the optimizer state exists once, not twice, at the peak of a
step.  A caller who keeps the old state must clone it first.  Large leaves
are updated in pieces, so the temporaries stay small.

On a mesh the params and the state are ``DTensor``s laid out alike
(``launch/sharding.py``): each gradient is first redistributed to its
param's placements (a reduce-scatter of a partial sum, as GSPMD inserts),
then every rank updates its local shards in place.  The clip's global norm
is over the whole gradient: each rank's local sum of squares, divided by
the number of ranks that hold the same shard, summed over the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.core._tree import tree_flatten, tree_map

# Elements a piece of the update holds (256 MB of float32 temporaries).
_PIECE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    keep_master: bool = True   # fp32 master copy when params are low-precision


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any
    master: Any  # fp32 params, or () when keep_master=False


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _local(x):
    """A DTensor's local shard (shares its storage), else ``x``."""
    return x.to_local() if _is_dtensor(x) else x


def _device_of(params) -> torch.device:
    leaves, _ = tree_flatten(params)
    return leaves[0].device if leaves else torch.device("cpu")


def init(params, cfg: AdamWConfig = AdamWConfig()) -> OptState:
    """Zero moments and (``keep_master``) a float32 copy of the params, on
    the params' device (the meta device gives shapes only)."""
    def zeros(p):
        if _is_dtensor(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    master = (
        tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
        if cfg.keep_master else ()
    )
    step = torch.zeros((), dtype=torch.int32, device=_device_of(params))
    leaves = tree_flatten(params)[0]
    if leaves and _is_dtensor(leaves[0]):
        # On a mesh the step is replicated, as the reference's sharding
        # rules give it.
        from torch.distributed.tensor import Replicate, distribute_tensor

        mesh = leaves[0].device_mesh
        step = distribute_tensor(step, mesh, [Replicate()] * mesh.ndim,
                                 src_data_rank=None)
    return OptState(step, tree_map(zeros, params), tree_map(zeros, params),
                    master)


def _pieces(t: torch.Tensor, written: bool = False):
    """``t`` flattened and split into views of at most ``_PIECE``
    elements; a tensor written through them must be contiguous."""
    if written and not t.is_contiguous():
        raise ValueError("AdamW updates its state in place: every m, v, "
                         "master (and, without one, param) leaf must be "
                         "contiguous")
    flat = t.reshape(-1)
    return flat.split(_PIECE) if flat.numel() else ()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares.  DTensor leaves
    count each element once: one all-reduce over their mesh of the local
    sums, each divided by its shard's replica count."""
    leaves, _ = tree_flatten(tree)
    total = torch.zeros((), dtype=torch.float32, device=_device_of(tree))
    mesh = None
    for x in leaves:
        part = torch.zeros_like(total)
        for piece in _pieces(_local(x)):
            part = part + torch.sum(torch.square(piece.float()))
        if _is_dtensor(x):
            mesh = x.device_mesh
            part = part / _replicas(x)
        total = total + part
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Partial

        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                                   run_check=False).full_tensor()
    return torch.sqrt(total)


def _replicas(x) -> int:
    """Ranks of ``x``'s mesh that hold each of its shards."""
    from torch.distributed.tensor import Replicate

    n = 1
    for d, pl in enumerate(x.placements):
        if isinstance(pl, Replicate):
            n *= x.device_mesh.size(d)
    return n


def _aligned(g, p):
    """``g`` laid out as ``p`` (a DTensor gradient may come back partial
    or otherwise placed)."""
    if _is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def update(
    grads, state: OptState, params, cfg: AdamWConfig = AdamWConfig(),
    lr_scale: Union[torch.Tensor, float] = 1.0,
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics): the
    same trees, updated."""
    count = _local(state.step)
    dev = count.device
    count.add_(1)
    step = count.float()
    grads = tree_map(_aligned, grads, params)
    gnorm = global_norm(grads)
    one = _as_f32(1.0, dev)
    scale = torch.minimum(one, cfg.clip_norm / (gnorm + 1e-9))
    lr = _as_f32(cfg.lr, dev) * _as_f32(lr_scale, dev)
    b1c = 1.0 - torch.pow(_as_f32(cfg.b1, dev), step)
    b2c = 1.0 - torch.pow(_as_f32(cfg.b2, dev), step)

    flat_g, _ = tree_flatten(grads)
    flat_m, _ = tree_flatten(state.m)
    flat_v, _ = tree_flatten(state.v)
    flat_p, _ = tree_flatten(params)
    flat_ref = tree_flatten(state.master)[0] if cfg.keep_master else flat_p
    for g, m, v, ref, p in zip(flat_g, flat_m, flat_v, flat_ref, flat_p):
        g, m, v, ref, p = map(_local, (g, m, v, ref, p))
        pieces = zip(_pieces(g), _pieces(m, True), _pieces(v, True),
                     _pieces(ref, True))
        for gi, mi, vi, ri in pieces:
            g32 = gi.float() * scale
            mi.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
            vi.mul_(cfg.b2).add_((g32 * (1 - cfg.b2)) * g32)
            del g32
            den = torch.sqrt(vi / b2c).add_(cfg.eps)
            u = (mi / b1c).div_(den)
            del den
            # ri is the float32 master, or (keep_master=False) the param.
            r32 = ri.float()
            u.add_(cfg.weight_decay * r32)
            ri.copy_(r32 - lr * u)
        if cfg.keep_master:
            p.copy_(ref)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, state, metrics


def cosine_schedule(step, *, warmup: int, total: int, floor: float = 0.1):
    """Warmup-then-cosine multiplier in [floor, 1], as a float32 tensor."""
    step = torch.as_tensor(_local(step)).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
