"""The smallest ``shard_map`` counterpart the multi-device scans need.

The reference runs its multi-device scans (``core/distributed.py``,
``core/engine/sharded.py``) as one jitted ``jax.experimental.shard_map``
over the local devices, with ``lax.ppermute`` / ``all_gather`` / ``psum``
between them.  Eager PyTorch has no SPMD transform, so this module gives
the port exactly what those two modules use:

* :class:`Mesh` — a grid of *positions*, each a ``torch.device``.  Repeats
  are allowed: ``Mesh([torch.device("cuda", 0)] * 8, ("x",))`` is a mesh of
  8 positions on one card, ``[cpu] * 8`` the counterpart of XLA's 8 virtual
  host devices.
* :class:`P` — the reference's ``PartitionSpec``: an entry per tensor dim.
* :func:`shard_map` — splits each input along the dims its spec names
  (axis-major, as ``P(("pod", "data"))`` does), runs ``body`` once per
  position, each in a thread of its own (on a CUDA stream of its own when
  the position is on the card), and concatenates the outputs.
* Collectives a body calls: :func:`axis_index`, :func:`axis_size`,
  :func:`ppermute` (a position that receives nothing gets zeros, as in
  ``lax.ppermute``), :func:`all_gather` and :func:`psum` (added in position
  order, so deterministic), each over a pytree.  A collective over one axis
  of a several-axis mesh exchanges only among the positions that share
  every other axis index.

Every position of an SPMD body calls the same collectives in the same
order, so each collective is one rendezvous of all positions: each posts
its value, a barrier, each reads what it needs, a second barrier (so no
position posts the next value before all have read this one).  On the card
a posted tensor carries an event recorded on its producer's stream; the
reader's stream waits on it and ``record_stream`` keeps the allocator from
reusing its memory before the reader is done.  A body that raises aborts
the barrier, so no position waits forever; :func:`shard_map` re-raises the
error in the caller.  A collective called outside a ``shard_map`` raises.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ._tree import tree_flatten, tree_map


class P(tuple):
    """Partition spec, as ``jax.sharding.PartitionSpec``: one entry per
    tensor dim, each None (not split), a mesh axis name, or a tuple of
    names the dim is split over, major first (``P("x")`` splits the
    leading dim over ``"x"``, ``P(None, None, ("pod", "data"))`` the third
    over both axes).  Trailing dims without an entry are not split;
    ``P()`` replicates the argument on every position."""

    def __new__(cls, *dims):
        entries = []
        for d in dims:
            if d is None or isinstance(d, str):
                entries.append(d)
            else:
                names = tuple(d)
                if not all(isinstance(n, str) for n in names):
                    raise TypeError(f"spec entry {d!r}: axis names are str")
                # One name stands alone, as jax's PartitionSpec keeps it.
                entries.append(names[0] if len(names) == 1 else names or None)
        return super().__new__(cls, entries)

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes dim ``dim`` is split over, major first."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e,) if isinstance(e, str) else e

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so equal positions compare equal."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A grid of positions over ``axis_names`` of sizes ``shape``
    (default: one axis over all ``devices``), positions in row-major
    (axis-major) order."""

    def __init__(self, devices: Sequence[Any], axis_names,
                 shape: Optional[Sequence[int]] = None):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        self.axis_names = ((axis_names,) if isinstance(axis_names, str)
                           else tuple(axis_names))
        dims = ((len(self.devices),) if shape is None
                else tuple(int(s) for s in shape))
        if len(dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {dims} does not match axes "
                             f"{self.axis_names}")
        if (not self.devices or min(dims) < 1
                or math.prod(dims) != len(self.devices)):
            raise ValueError(f"mesh shape {dims} does not hold "
                             f"{len(self.devices)} positions")
        #: Axis name -> size, as ``jax.sharding.Mesh.shape``.
        self.shape = dict(zip(self.axis_names, dims))
        self.size = len(self.devices)

    def coords(self, linear: int) -> Tuple[int, ...]:
        out = []
        for s in reversed(list(self.shape.values())):
            linear, c = divmod(linear, s)
            out.append(c)
        return tuple(reversed(out))

    def linear(self, coords: Sequence[int]) -> int:
        i = 0
        for c, s in zip(coords, self.shape.values()):
            i = i * s + c
        return i

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


class _Exchange:
    """The rendezvous of one ``shard_map`` call's positions."""

    def __init__(self, size: int):
        self.slots: List[Any] = [None] * size
        self.barrier = threading.Barrier(size)


class _Position:
    """What a position's thread knows while it runs the body."""

    def __init__(self, mesh: Mesh, index: int, exchange: _Exchange,
                 stream: Optional[torch.cuda.Stream]):
        self.mesh = mesh
        self.index = index
        self.coords = mesh.coords(index)
        self.device = mesh.devices[index]
        self.exchange = exchange
        self.stream = stream


_local = threading.local()


def _current() -> _Position:
    pos = getattr(_local, "position", None)
    if pos is None:
        raise RuntimeError("spmd collectives run only inside a shard_map body")
    return pos


def in_shard_map() -> bool:
    """True on a position's thread while it runs a ``shard_map`` body."""
    return getattr(_local, "position", None) is not None


def position() -> int:
    """This position's linear index in its mesh (0 is the first)."""
    return _current().index


def _axis(pos: _Position, name: str) -> int:
    try:
        return pos.mesh.axis_names.index(name)
    except ValueError:
        raise NameError(f"unbound axis name {name!r}; the mesh has "
                        f"{pos.mesh.axis_names}") from None


def axis_index(name: str) -> int:
    """This position's index along mesh axis ``name``."""
    pos = _current()
    return pos.coords[_axis(pos, name)]


def axis_size(name: str) -> int:
    """The size of mesh axis ``name``."""
    pos = _current()
    _axis(pos, name)
    return pos.mesh.shape[name]


def _group(pos: _Position, name: str) -> List[int]:
    """Linear indices of the positions along ``name`` through ``pos``."""
    ax = _axis(pos, name)
    coords = list(pos.coords)
    out = []
    for j in range(pos.mesh.shape[name]):
        coords[ax] = j
        out.append(pos.mesh.linear(coords))
    return out


def _rendezvous(value: Any) -> List[Any]:
    """Post ``value``; return every position's posted (value, event)."""
    pos = _current()
    ex = pos.exchange
    event = pos.stream.record_event() if pos.stream is not None else None
    ex.slots[pos.index] = (value, event)
    ex.barrier.wait()
    view = list(ex.slots)
    ex.barrier.wait()
    return view


def _receive(pos: _Position, posted) -> Any:
    """A value another position posted, ordered after its producer and
    usable on this position's device and stream."""
    value, event = posted
    if pos.stream is not None and event is not None:
        pos.stream.wait_event(event)

    def take(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.is_cuda and pos.stream is not None:
            t.record_stream(pos.stream)
        return t.to(pos.device)

    return tree_map(take, value)


def ppermute(x: Any, name: str, perm: Sequence[Tuple[int, int]]) -> Any:
    """Send ``x`` along axis ``name`` by (source, destination) index pairs;
    a position no pair sends to receives zeros."""
    pos = _current()
    me = pos.coords[_axis(pos, name)]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1:
        raise ValueError(f"ppermute: position {me} receives from {srcs}")
    view = _rendezvous(x)
    if not srcs:
        return tree_map(torch.zeros_like, x)
    return _receive(pos, view[_group(pos, name)[srcs[0]]])


def all_gather(x: Any, name: str) -> Any:
    """Every position's ``x`` along axis ``name``, stacked on a new leading
    axis in axis order."""
    pos = _current()
    view = _rendezvous(x)
    parts = [_receive(pos, view[i]) for i in _group(pos, name)]
    return tree_map(lambda *ts: torch.stack(ts, dim=0), *parts)


def psum(x: Any, name: str) -> Any:
    """The sum of every position's ``x`` along axis ``name``, added in axis
    order (so every position gets the same bits)."""
    pos = _current()
    view = _rendezvous(x)
    parts = [_receive(pos, view[i]) for i in _group(pos, name)]
    total = parts[0]
    for part in parts[1:]:
        total = tree_map(lambda a, b: a + b, total, part)
    return total


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------


def _block(mesh: Mesh, axes: Tuple[str, ...],
           coords: Tuple[int, ...]) -> Tuple[int, int]:
    """(block index, block count) of the position at ``coords`` along
    ``axes``, major first."""
    b, count = 0, 1
    for a in axes:
        if a not in mesh.shape:
            raise NameError(f"unbound axis name {a!r}; the mesh has "
                            f"{mesh.axis_names}")
        s = mesh.shape[a]
        b = b * s + coords[mesh.axis_names.index(a)]
        count *= s
    return b, count


def _shard(x: Any, mesh: Mesh, spec: P, index: int) -> Any:
    coords = mesh.coords(index)
    blocks = [(d, *_block(mesh, spec.axes(d), coords))
              for d in range(len(spec))]
    dev = mesh.devices[index]

    def piece(t):
        if not isinstance(t, torch.Tensor):
            return t
        for d, b, count in blocks:
            if count == 1:
                continue
            n = t.shape[d]
            if n % count:
                raise ValueError(f"shard_map: dim {d} of size {n} does not "
                                 f"split into {count} blocks")
            k = n // count
            t = t.narrow(d, b * k, k)
        return t.to(dev)

    return tree_map(piece, x)


def _specs_for(in_specs, nargs: int) -> List[P]:
    if isinstance(in_specs, P):
        return [in_specs] * nargs
    specs = list(in_specs)
    if len(specs) != nargs:
        raise ValueError(f"shard_map: {len(specs)} in_specs for {nargs} "
                         "arguments")
    return [s if isinstance(s, P) else P(s) for s in specs]


def _gather(outs: List[Any], mesh: Mesh, spec: P, dest) -> Any:
    """Concatenate the positions' outputs along every dim ``spec`` splits,
    one block per index of that dim's axes; axes the spec does not name
    take the positions at index 0."""
    coords = [0] * len(mesh.axis_names)

    def assemble(dim: int) -> Any:
        if dim == len(spec):
            return tree_map(lambda t: t.to(dest)
                            if isinstance(t, torch.Tensor) else t,
                            outs[mesh.linear(coords)])
        axes = spec.axes(dim)
        if not axes:
            return assemble(dim + 1)
        parts = []
        for b in range(math.prod(mesh.shape[a] for a in axes)):
            for a in reversed(axes):
                b, c = divmod(b, mesh.shape[a])
                coords[mesh.axis_names.index(a)] = c
            parts.append(assemble(dim + 1))
        for a in axes:
            coords[mesh.axis_names.index(a)] = 0
        return tree_map(lambda *ts: torch.cat(ts, dim=dim), *parts)

    return assemble(0)


def shard_map(body: Callable[..., Any], mesh: Mesh, in_specs,
              out_specs: P) -> Callable[..., Any]:
    """``body`` run once per position of ``mesh`` on that position's
    blocks of the arguments (``in_specs``: one :class:`P` for all
    arguments, or a sequence of one per argument); the outputs
    concatenated under ``out_specs`` (one :class:`P`, or a sequence of one
    per element of an output tuple) onto the first input tensor's
    device."""

    def run(*args):
        specs = _specs_for(in_specs, len(args))
        first = [t for a in args for t in tree_flatten(a)[0]
                 if isinstance(t, torch.Tensor)]
        dest = first[0].device if first else mesh.devices[0]
        pieces = [[_shard(a, mesh, s, i) for a, s in zip(args, specs)]
                  for i in range(mesh.size)]
        # The pieces were cut on the caller's streams; each position's
        # stream starts after them.
        caller = {d: torch.cuda.current_stream(d)
                  for d in set(mesh.devices) | {dest} if d.type == "cuda"}
        exchange = _Exchange(mesh.size)
        streams: List[Optional[torch.cuda.Stream]] = [
            torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in mesh.devices]
        outs: List[Any] = [None] * mesh.size
        errors: List[Optional[BaseException]] = [None] * mesh.size

        def position_main(i: int) -> None:
            stream = streams[i]
            _local.position = _Position(mesh, i, exchange, stream)
            try:
                if stream is None:
                    outs[i] = body(*pieces[i])
                    return
                stream.wait_stream(caller[mesh.devices[i]])
                with torch.cuda.device(mesh.devices[i]), torch.cuda.stream(stream):
                    for t in tree_flatten(pieces[i])[0]:
                        if isinstance(t, torch.Tensor) and t.is_cuda:
                            t.record_stream(stream)
                    outs[i] = body(*pieces[i])
            except BaseException as e:  # noqa: BLE001 — re-raised by the caller
                errors[i] = e
                exchange.barrier.abort()
            finally:
                _local.position = None

        threads = [threading.Thread(target=position_main, args=(i,),
                                    name=f"spmd-{i}", daemon=True)
                   for i in range(mesh.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            real = [e for e in failed
                    if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or failed)[0]
        # The caller's streams continue after every position's stream.
        for i, stream in enumerate(streams):
            if stream is None:
                continue
            for s in caller.values():
                s.wait_stream(stream)
            for t in tree_flatten(outs[i])[0]:
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(caller[t.device])
        if isinstance(out_specs, P):
            return _gather(outs, mesh, out_specs, dest)
        # A sequence of specs: one per element of the body's output tuple.
        return tuple(_gather([o[i] for o in outs], mesh, s, dest)
                     for i, s in enumerate(out_specs))

    return run
