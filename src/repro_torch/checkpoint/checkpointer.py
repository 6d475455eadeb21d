"""Checkpointing: atomic, async, keep-last-k, restore onto a device.

Port of ``repro/checkpoint/checkpointer.py``, with the same on-disk format,
so a snapshot written by either package restores in the other:

Layout:  <dir>/step_<N>/
             manifest.json     leaf keys, metadata
             arrays.npz        flattened leaves (host values)

Leaves are flattened as ``jax.tree`` flattens them — dict entries in
sorted-key order, sequences by index, named tuples by field, ``None`` as
an empty subtree — and keyed by the same ``/``-joined paths.  Writes go to
a tmp dir and are renamed only after fsync — a crash never corrupts the
latest checkpoint.  ``save`` copies every tensor to the host before it
returns (the trainer then updates its state in place, as the reference's
donated step does), and only the files are written in the background.
``restore`` builds the tensors on the device it is given (the card when
none, never quietly the CPU) and, given ``shardings=`` (a tree of
``launch.sharding.NamedSharding``), lays each leaf out on its mesh as a
``DTensor``: the reference's device_put against the new shardings, the
elastic rescale.

On a mesh the state's leaves are ``DTensor``s and ``save`` is a
collective: every rank gathers each leaf's full value (``full_tensor``),
rank 0 alone writes, synchronously, and all ranks meet at a barrier before
``save`` returns, so a checkpoint stays topology-free full arrays and every
rank sees it before the next restore.

bfloat16 leaves are stored as the reference stores its ``ml_dtypes``
bfloat16 arrays: their bits as 2-byte void (``|V2``), so ``np.load`` of
either package's file gives the same bytes.  ``restore`` views such a leaf
back as bfloat16 (the reference's own restore of it raises: numpy has no
cast from ``|V2``); every other dtype is cast to the prototype's.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

_SEP = "/"


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """``(path entry, child)`` pairs of a container in ``jax.tree`` order,
    or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _map_with_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """Rebuild ``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [
        _map_with_paths(fn, v, f"{prefix}{_SEP}{k}" if prefix else k)
        for k, v in kids
    ]
    if isinstance(tree, dict):
        return {k: v for (k, _), v in zip(kids, out)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*out)
    return type(tree)(out)


def _flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    _map_with_paths(lambda k, leaf: out.append((k, leaf)), tree)
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates do not reach
    (a DTensor's full value: a collective)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if _is_dtensor(t):
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).to("cpu", copy=True).numpy().view("V2")
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _from_host(arr: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """A stored leaf as a tensor of ``dtype`` on ``device``: a ``|V2``
    leaf holds bfloat16 bits and is viewed as such, then cast."""
    if arr.dtype == np.dtype("V2"):
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(dtype=dtype, device=device)


class Checkpointer:
    """``timings`` lists the seconds of each ``save``'s host copy (what the
    caller waits for), each write of the files, and each ``restore``."""

    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.timings: Dict[str, List[float]] = {"save": [], "write": [],
                                                "restore": []}
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree, metadata: Optional[Dict] = None) -> None:
        """Snapshot device values to the host, then write in the background."""
        t0 = time.perf_counter()
        sharded = any(_is_dtensor(leaf) for _, leaf in _flatten_with_paths(tree))
        host_tree = _map_with_paths(lambda _k, leaf: _to_host(leaf), tree)
        self.timings["save"].append(time.perf_counter() - t0)
        if sharded:
            import torch.distributed as dist

            if dist.get_rank() == 0:
                self.wait()
                self._write(step, host_tree, metadata or {})
            dist.barrier()
            return
        if self._pending is not None:
            self._pending.result()  # one in flight at a time
        if self.async_save:
            self._pending = self._pool.submit(
                self._write, step, host_tree, metadata or {}
            )
        else:
            self._write(step, host_tree, metadata or {})

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, host_tree, metadata: Dict) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        items = _flatten_with_paths(host_tree)
        arrays = {f"a{i}": leaf for i, (_, leaf) in enumerate(items)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": [k for k, _ in items],
            "metadata": metadata,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            # Re-saving the same step (restart retry): replace atomically-ish.
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.timings["write"].append(time.perf_counter() - t0)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_raw(
        self, *, step: Optional[int] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict, int]:
        """Read a checkpoint without a target prototype.

        Returns ``(arrays_by_key, metadata, step)`` with shapes/dtypes as
        stored, as host arrays.  Used by consumers whose state *structure*
        depends on the checkpoint itself — a series session resuming
        mid-series does not know how many frames the snapshot covers until
        it reads it.
        """
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
        by_key = {k: data[f"a{i}"] for i, k in enumerate(manifest["keys"])}
        return by_key, manifest["metadata"], step

    def restore(
        self, target_tree, *, step: Optional[int] = None,
        device: DeviceLike = None, shardings=None,
    ):
        """Restore into the structure of ``target_tree``.

        Every leaf comes back as a tensor of its prototype's dtype on
        ``device`` (the card when None); with ``shardings`` (a tree of the
        same structure whose leaves have ``mesh`` and ``placements``) as a
        ``DTensor`` laid out by its sharding.  Every rank reads the full
        arrays and keeps its own blocks: no communication."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        by_key, metadata, step = self.restore_raw(step=step)
        where = ({} if shardings is None else
                 dict(_flatten_with_paths(shardings)))

        def leaf(key, proto):
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = by_key[key]
            proto = torch.as_tensor(proto)
            if tuple(arr.shape) != tuple(proto.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != target "
                    f"{tuple(proto.shape)}"
                )
            t = _from_host(arr, proto.dtype, dev)
            if shardings is None:
                return t
            from torch.distributed.tensor import distribute_tensor

            shd = where[key]
            return distribute_tensor(t, shd.mesh, shd.placements,
                                     src_data_rank=None)

        tree = _map_with_paths(leaf, target_tree)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timings["restore"].append(time.perf_counter() - t0)
        return tree, metadata, step
