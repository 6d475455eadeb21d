"""DTensor's collectives on CUDA tensors over gloo, staged through host
memory.

Ranks that share one card cannot use NCCL (it refuses two ranks on one
GPU), so their process group is gloo.  gloo's own collectives take CUDA
tensors (``dist.all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single``, ``broadcast``: probed on
the H100), but DTensor reaches them through the functional collectives
(``torch.ops._c10d_functional``), whose CUDA path over gloo ends the
process with SIGSEGV (torch 2.11, H100).  :func:`install` registers a
CUDA kernel for each functional collective DTensor issues: it copies the
inputs into pinned host buffers, runs the op's CPU path (gloo on the host
copies), and copies the result back to the input's device.  Every tensor
and all compute stay on the card; only the collective's payload crosses.
Python ``ProcessGroup`` subclasses registered with
``Backend.register_backend`` cannot do this: the functional collectives
dispatch to a C++ backend such a group does not have.

:data:`counts` holds, per op, the calls and the bytes staged each way.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import torch

_OPS = ("all_reduce", "all_reduce_coalesced", "all_gather_into_tensor",
        "all_gather_into_tensor_coalesced", "reduce_scatter_tensor",
        "reduce_scatter_tensor_coalesced", "all_to_all_single", "broadcast")

#: op name -> [calls, bytes to the host, bytes back to the card]
counts: Dict[str, List[int]] = {}
_lock = threading.Lock()
_lib = None


def installed() -> bool:
    return _lib is not None


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
    return h.copy_(t)


def _staged(name: str):
    op = getattr(torch.ops._c10d_functional, name)
    wait = torch.ops._c10d_functional.wait_tensor

    def impl(inp, *args):
        many = isinstance(inp, (list, tuple))
        ins = list(inp) if many else [inp]
        device = ins[0].device
        host = [_host(t) for t in ins]
        out = op(host if many else host[0], *args)
        outs = [wait(t) for t in (out if many else [out])]
        back = [t.to(device) for t in outs]
        with _lock:
            c = counts.setdefault(name, [0, 0, 0])
            c[0] += 1
            c[1] += sum(t.numel() * t.element_size() for t in host)
            c[2] += sum(t.numel() * t.element_size() for t in back)
        return back if many else back[0]

    return impl


def install() -> None:
    """Register the staged CUDA kernels (once a process)."""
    global _lib
    if _lib is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in _OPS:
        lib.impl(name, _staged(name), "CUDA")
    _lib = lib


def probe(rank: int, device) -> dict:
    """On every rank of a world: gloo's own collectives on ``device``
    tensors (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_reduce``, ``all_to_all_single``), each checked against its
    exact result, then a DTensor all-gather, reduce-scatter and all-to-all
    through the staged functional collectives.  Returns each op's True or
    its error.  (The functional collectives' own CUDA path is not probed:
    it kills the process.)"""
    import torch.distributed as dist

    world = dist.get_world_size()
    out = {}

    def attempt(name, fn):
        try:
            out[name] = True if fn() else "wrong result"
        except Exception as e:  # noqa: BLE001 — the probe reports it
            out[name] = f"{type(e).__name__}: {e}"[:200]

    x = torch.full((8,), float(rank + 1), device=device)

    def all_gather():
        o = torch.empty(8 * world, device=device)
        dist.all_gather_into_tensor(o, x)
        return o[::8].tolist() == [float(r + 1) for r in range(world)]

    def reduce_scatter():
        i = torch.arange(8 * world, dtype=torch.float32, device=device)
        o = torch.empty(8, device=device)
        dist.reduce_scatter_tensor(o, i)
        return o.tolist() == [float(world * (8 * rank + j)) for j in range(8)]

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool(torch.all(y == world * (world + 1) / 2))

    def all_to_all():
        i = torch.arange(world, dtype=torch.float32, device=device) + 10 * rank
        o = torch.empty(world, device=device)
        dist.all_to_all_single(o, i)
        return o.tolist() == [float(10 * r + rank) for r in range(world)]

    for name, fn in (("all_gather_into_tensor", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("all_reduce", all_reduce), ("all_to_all_single",
                                                  all_to_all)):
        attempt(name, fn)

    def dtensor():
        from torch.distributed.tensor import Partial, Shard, distribute_tensor

        from .mesh import make_mesh

        mesh = make_mesh((world,), ("data",), device=device)
        full = torch.arange(4.0 * world * world, device=device).reshape(
            2 * world, 2 * world)
        t = distribute_tensor(full, mesh, [Shard(0)], src_data_rank=None)
        ok = torch.equal(t.full_tensor(), full)                  # all-gather
        ok &= torch.equal(t.redistribute(mesh, [Shard(1)]).full_tensor(),
                          full)                                  # all-to-all
        p = type(t).from_local(full, mesh, [Partial()], run_check=False)
        ok &= torch.equal(p.redistribute(mesh, [Shard(0)]).full_tensor(),
                          full * world)                          # reduce-scatter
        return ok

    attempt("dtensor_collectives", dtensor)
    out["staged"] = installed()
    return out
