"""Mesh factories (port of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the initialised process group: each rank is one device of the reference's
``jax.sharding.Mesh``.  Functions, never module-level meshes: a mesh needs
a process group, and importing this module needs none.

The sharding rules read only a mesh's axis names and sizes, so
:func:`dp_axes`, :func:`tp_axis` and :func:`axis_size` take a
``DeviceMesh``, an ``spmd.Mesh`` of positions, or a shape-only
:class:`AbstractMesh` (the reference's ``jax.sharding.AbstractMesh``),
which lets the rules of a 512-device mesh run with no process group.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device


class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind them."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{axis_names}")
        self.axis_names = tuple(axis_names)
        #: Axis name -> size, as ``jax.sharding.Mesh.shape``.
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, an ``spmd.Mesh`` or an
    :class:`AbstractMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the first
    ``prod(shape)`` ranks of the initialised world, its tensors on
    ``device``'s kind (the card unless ``device="cpu"``).  On the card over
    gloo (ranks sharing one GPU) DTensor's collectives are staged through
    host memory (``host_staging``)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    kind = resolve_device(device).type
    if kind == "cuda" and dist.get_backend() == "gloo":
        from .host_staging import install

        install()
    return DeviceMesh(kind, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The assigned production meshes: 16x16 per pod; 2 pods when
    multi_pod.  Needs a world of 256 (512) ranks; the rules alone run on
    :func:`production_shape`'s shape-only mesh."""
    return make_mesh(*production_shape(multi_pod=multi_pod), device=device)


def production_shape(*, multi_pod: bool = False):
    """``(shape, axes)`` of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel / FSDP axes of a production mesh (all but 'model')."""
    return tuple(n for n in axis_names(mesh) if n != "model")


def tp_axis(mesh) -> Optional[str]:
    return "model" if "model" in axis_names(mesh) else None


def axis_size(mesh, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    sizes = mesh_shape(mesh)
    size = 1
    for n in names:
        size *= sizes[n]
    return size


# ---------------------------------------------------------------------------
# A world of ranks
# ---------------------------------------------------------------------------


def world_backend(device: DeviceLike, world: int) -> str:
    """NCCL when each of ``world`` ranks has a GPU of its own, else gloo
    (the CPU, or ranks that share a card: NCCL refuses two ranks on one
    GPU)."""
    if resolve_device(device).type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device: DeviceLike, backend: str, rank: int) -> torch.device:
    """A rank's device: its own card under NCCL, the shared one under gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank if backend == "nccl"
                            else (dev.index or 0))
    return dev


def _world_rank(rank: int, world: int, tmp: str, device, fn, args) -> None:
    backend = world_backend(device, world)
    dev = rank_device(device, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 world))
    try:
        out = fn(rank, dev, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable[..., Any], world: int, *args,
              device: DeviceLike = None) -> List[Any]:
    """``fn(rank, device, *args)`` on ``world`` spawned ranks of a new
    process group (a ``FileStore`` rendezvous in a temporary directory, so
    no port is taken); each rank's return value, in rank order.  ``fn``
    must be importable by name (a module-level function), and a script
    that calls this needs an ``if __name__ == "__main__":`` guard."""
    import torch.multiprocessing as mp

    resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_world_rank, nprocs=world, join=True,
                 args=(world, tmp, device, fn, args))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
