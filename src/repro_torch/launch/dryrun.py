"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on a fake
production mesh and count it (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step for 512 placeholder XLA
host devices and reads the compiled program's memory and cost analyses and
its HLO's collectives.  PyTorch has no compiler to ask, so the port runs
the step itself, eagerly, on meta tensors: a ``fake`` process group of 256
ranks (512 with ``--multipod``) stands in for the devices, and this
process plays rank 0 of it.  For each cell :func:`run_cell`

  1. builds the world and ``mesh.make_production_mesh`` over it ((16, 16)
     or (2, 16, 16)), and tears both down after the cell;
  2. lays ``steps.params_struct``, ``opt_state_struct``, ``batch_struct``
     and ``decode_state_struct`` out as DTensors by the sharding rules
     (``sharding.distribute``; nothing is allocated: every shard is a meta
     tensor);
  3. runs the step (train through ``train.mesh_step``; prefill and decode
     under ``activation_sharding`` and ``implicit_replication``) at two
     reduced depths (ns = 2 and 4 superblocks) under :class:`_Counter`, a
     dispatch mode that sees each rank-local operation DTensor runs;
  4. extrapolates the per-rank counts linearly to full depth, as the
     reference does, and prices them against H100 datasheet rates;
  5. writes ``experiments/dryrun_torch/<cell>.json``.

What a cell counts, per rank (rank 0; with uneven shards, the largest):

  * ``flops``: matmuls and attention, by ``torch.utils.flop_counter``'s
    rules.  XLA's ``cost_analysis`` also counts elementwise work, so
    ``model_flops_ratio`` reads higher here than the reference's;
  * ``bytes``: each operation's operand and result bytes, views excluded.
    Nothing is fused, so this bounds XLA's ``bytes accessed`` from above;
  * ``collectives``: the count and result bytes of each functional
    collective (``torch.ops._c10d_functional``) by kind, as the
    reference's ``parse_collectives`` reads the HLO's;
  * ``arg_bytes``: the local shards of the step's inputs at full depth;
  * ``peak_bytes``: the most local bytes live at once: the inputs plus
    every storage an operation makes, held until its last reference dies.

The sLSTM recurrence (a Python loop over the sequence) runs its body once
(``ssm.recurrence_counted_once``), as XLA counts a ``while`` body once, and
its other steps' FLOPs come from :func:`_slstm_correction`, as the
reference's.  Its bytes are counted once too, and its per-step saved
tensors are missing from ``peak_bytes``.

No configuration sets ``seq_shard_prefill``, and the port's
``activation_sharding`` has no ``seq_shard`` or ``fsdp_gather`` option, so
the dry-run passes neither.  Importing this module sets no environment
variable and starts no process group.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multipod] [--and-single]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core._tree import tree_flatten
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

ARTIFACT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch"
)

# H100 SXM constants (per card), datasheet figures.
PEAK_FLOPS = 989e12          # bf16 dense tensor-core rate
HBM_BW = 3.35e12             # bytes/s, HBM3
# A 16 x 16 mesh of 8-GPU nodes spans 32 nodes, and both of its axes cross
# nodes (a "model" group of 16 ranks spans two), so a collective is bound
# by the inter-node link: one 400 Gb/s ConnectX-7 InfiniBand port a GPU
# (DGX H100 datasheet), 50e9 bytes/s each way.
LINK_BW = 50e9
HBM_BYTES = 80e9             # device memory

_COLLECTIVE_KINDS = (("all_gather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_reduce", "all-reduce"),
                     ("all_to_all", "all-to-all"),
                     ("broadcast", "broadcast"))


def applicable(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """Returns a skip-reason string, or None when the cell runs."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return "long_500k skipped: quadratic full attention (DESIGN.md)"
    return None


# ---------------------------------------------------------------------------
# The fake world and the counting mode
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks, this process rank
    0: its collectives return at once, and on meta tensors they only shape
    their results.  Refuses to start where a group is initialised (a stray
    world would send ``train()`` down its mesh branch), and destroys the
    group on exit."""
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process of its own: a "
                           "process group is already initialised")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def _local_bytes(tree) -> int:
    return sum(_nbytes(_local(t)) for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _collective_kind(func) -> Optional[str]:
    if not func.namespace.startswith("_c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    return next((kind for prefix, kind in _COLLECTIVE_KINDS
                 if name.startswith(prefix)), None)


class _Counter:
    """A dispatch mode that counts every rank-local operation: an
    operation on DTensors is handed back to DTensor (``NotImplemented``),
    which runs it as local operations that come back here; the shape
    propagation DTensor runs under its own fake mode is skipped."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return counter._dispatch(func, types, args, kwargs or {})

        self.mode = Mode()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it dies."""
        import weakref

        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        size = st.nbytes()
        self._storages[key] = size
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _dispatch(self, func, types, args, kwargs):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if (any(issubclass(t, FakeTensor) for t in types)
                or torch._C._get_dispatch_mode(
                    torch._C._TorchDispatchModeKey.FAKE) is not None):
            return out
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        kind = _collective_kind(func)
        if kind is not None:
            rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0})
            rec["count"] += 1
            rec["bytes"] += sum(_nbytes(t) for t in outs)
            return out
        if func.is_view:
            return out
        from torch.utils.flop_counter import flop_registry

        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func._overloadpacket not in (torch.ops.aten.empty,
                                        torch.ops.aten.empty_strided):
            self.bytes += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                           + sum(_nbytes(t) for t in outs))
        return out


# ---------------------------------------------------------------------------
# Lowering a cell: its inputs, laid out by the rules, and its step
# ---------------------------------------------------------------------------


def lower_cell(cfg: ArchConfig, shape: ShapeConfig, mesh):
    """Build one cell's inputs and step.  Returns ``(run, inputs)``:
    ``run()`` takes the step on ``inputs``, meta tensors laid out by the
    rules as DTensors on ``mesh`` (plain meta tensors with ``mesh=None``:
    one device), under the activation anchors."""
    from repro_torch.core.spmd import P
    from repro_torch.models.shardctx import activation_sharding
    from repro_torch.optim import adamw

    from . import sharding as shd
    from . import steps
    from .train import mesh_step

    def place(tree, specs):
        return tree if mesh is None else shd.distribute(tree, specs, mesh)

    def anchored(fn):
        if mesh is None:
            return fn

        def run(*args):
            from torch.distributed.tensor.experimental import (
                implicit_replication)

            with activation_sharding(mesh, dp=shd.dp_axes(mesh),
                                     tp=shd.tp_axis(mesh)), \
                    implicit_replication():
                return fn(*args)

        return run

    if shape.kind == "decode":
        # Serving layout: unrolled layers + per-layer state dicts + fp8 KV
        # cache (halves cache memory and the bandwidth-bound decode term).
        cfg = dataclasses.replace(cfg, scan_layers=False,
                                  cache_dtype="float8_e4m3fn")
    params = steps.params_struct(cfg)
    pspecs = None if mesh is None else shd.param_shardings(params, cfg, mesh)
    dparams = place(params, pspecs)
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig()
        opt = steps.opt_state_struct(cfg, params, opt_cfg)
        dopt = place(opt, None if mesh is None else
                     shd.opt_state_shardings(opt, pspecs, mesh))
        batch = steps.batch_struct(cfg, shape)
        accum = int(os.environ.get("REPRO_GRAD_ACCUM", "1"))
        if mesh is None:
            fn = steps.make_train_step(cfg, opt_cfg, grad_accum=accum)
            return (lambda: fn(dparams, dopt, batch)), (dparams, dopt, batch)
        # The mesh step splits the full batch itself; its local shards are
        # what a rank holds.
        bspecs = shd.batch_specs(cfg, mesh, kind="train")
        fn = mesh_step(cfg, opt_cfg, mesh, grad_accum=accum)
        return ((lambda: fn(dparams, dopt, batch)),
                (dparams, dopt, place(batch, {k: bspecs[k] for k in batch})))
    states = steps.decode_state_struct(cfg, shape)
    dstates = place(states, None if mesh is None else shd.state_specs(
        cfg, mesh, states, batch=shape.global_batch))
    if shape.kind == "prefill":
        batch = steps.batch_struct(cfg, shape)
        batch.pop("labels", None)
        dbatch = place(batch, None if mesh is None else {
            k: v for k, v in shd.batch_specs(cfg, mesh, kind="prefill").items()
            if k in batch})
        fn = anchored(steps.make_prefill_step(cfg))
        return ((lambda: fn(dparams, dbatch, dstates)),
                (dparams, dbatch, dstates))
    if shape.kind == "decode":
        token, pos = steps.decode_inputs_struct(cfg, shape)
        if mesh is not None:
            dp = shd.dp_axes(mesh)
            b_ok = shape.global_batch % shd.axis_size(mesh, dp) == 0
            token = place(token, P(dp if b_ok else None, None))
        fn = anchored(steps.make_decode_step(cfg))
        return ((lambda: fn(dparams, token, pos, dstates)),
                (dparams, token, pos, dstates))
    raise ValueError(shape.kind)


def _model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6ND train (fwd 2ND + bwd 4ND), 2ND prefill, 2N/token decode.

    N = active params (6*N_active*D for MoE per the roofline instructions)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def _reduced_cfg(cfg: ArchConfig, ns: int) -> ArchConfig:
    """Same architecture at reduced depth (ns superblocks), layers unrolled."""
    repl = dict(
        n_layers=ns * len(cfg.block_pattern),
        scan_layers=False,
    )
    if cfg.encoder_layers:
        repl["encoder_layers"] = ns  # whisper: n_super == encoder_layers
    return dataclasses.replace(cfg, **repl)


def _measure(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Dict:
    """Run one configuration's step under the counter; return raw per-rank
    measurements."""
    t0 = time.time()
    run, inputs = lower_cell(cfg, shape, mesh)
    return _count(run, inputs, time.time() - t0, once=True)


def _count(run, inputs, t_lower: float, *, once: bool) -> Dict:
    """``run()`` under :class:`_Counter`, ``inputs`` live throughout."""
    from repro_torch.models.ssm import recurrence_counted_once

    counter = _Counter()
    for t in _tensors(inputs):
        counter.track(_local(t))
    t0 = time.time()
    with counter, (recurrence_counted_once() if once
                   else contextlib.nullcontext()):
        out = run()
    t_run = time.time() - t0
    colls = counter.collectives
    return {
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_run, 1),
        "arg_bytes": _local_bytes(inputs),
        "out_bytes": _local_bytes(out),
        "peak_bytes": counter.peak,
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "collectives": colls,
        "coll_bytes": sum(v["bytes"] for v in colls.values()),
    }


def _slstm_correction(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Analytic FLOPs of the sLSTM time-recurrence (a lax.scan over L that
    cannot be unrolled): per step, the block-diagonal recurrent matmul is
    B * nh * hd * 4hd MACs.  x3 for train (bwd)."""
    n_slstm = sum(1 for k in cfg.block_pattern if k == "slstm") * cfg.n_super
    if n_slstm == 0 or shape.kind == "decode":
        return 0.0
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    per_tok = nh * hd * 4 * hd * 2
    total = n_slstm * shape.global_batch * shape.seq_len * per_tok
    if shape.kind == "train":
        total *= 3
    return float(total)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             save: bool = True, verbose: bool = True,
             mesh_shape: Optional[tuple] = None, smoke: bool = False) -> Dict:
    """One dry-run cell.

    Two reduced-depth runs (ns = 2, 4 superblocks) give exact per-superblock
    FLOP / byte / collective / memory counts, extrapolated linearly to full
    depth: superblocks are homogeneous, so the extrapolation is exact.
    ``arg_bytes`` is read at full depth (the inputs' shards, no run).

    ``mesh_shape`` (e.g. (2, 2) over ("data", "model")), ``smoke`` (the
    smoke config) and a ``ShapeConfig`` for ``shape_name`` replace the
    production mesh, config and shape, for tests.
    """
    from repro_torch.configs import get_smoke_config

    from .mesh import make_mesh, production_shape

    cfg = (get_smoke_config if smoke else get_config)(arch)
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    skip = applicable(cfg, shape)
    if mesh_shape is None:
        mesh_shape, axes = production_shape(multi_pod=multi_pod)
    else:
        axes = ("pod", "data", "model")[-len(mesh_shape):]
    cell = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(s) for s in mesh_shape),
        "status": "skip" if skip else "pending",
    }
    if skip:
        cell["reason"] = skip
        cell["status"] = "skip"
        if verbose:
            print(f"[dryrun] {arch} x {shape.name}: SKIP ({skip})", flush=True)
        if save:
            _save_cell(cell)
        return cell
    n_chips = math.prod(mesh_shape)
    ns_a, ns_b = 2, 4
    with fake_world(n_chips):
        mesh = make_mesh(tuple(mesh_shape), axes, device="cpu")
        t0 = time.time()
        _, full_inputs = lower_cell(cfg, shape, mesh)
        arg_bytes = _local_bytes(full_inputs)
        del full_inputs
        t_lower = time.time() - t0
        m_a = _measure(_reduced_cfg(cfg, ns_a), shape, mesh)
        m_b = _measure(_reduced_cfg(cfg, ns_b), shape, mesh)
    ns_full = cfg.n_super

    def extrap(key):
        per = (m_b[key] - m_a[key]) / (ns_b - ns_a)
        base = m_a[key] - ns_a * per
        return max(0.0, base + ns_full * per), per

    flops, flops_per_sb = extrap("flops")
    flops += _slstm_correction(cfg, shape) / n_chips
    bytes_acc, _ = extrap("bytes")
    coll_bytes, _ = extrap("coll_bytes")
    peak, _ = extrap("peak_bytes")
    out_bytes, _ = extrap("out_bytes")
    coll_kinds = {}
    for kind in set(m_a["collectives"]) | set(m_b["collectives"]):
        ba = m_a["collectives"].get(kind, {"bytes": 0.0, "count": 0})
        bb = m_b["collectives"].get(kind, {"bytes": 0.0, "count": 0})
        per = (bb["bytes"] - ba["bytes"]) / (ns_b - ns_a)
        cnt_per = (bb["count"] - ba["count"]) / (ns_b - ns_a)
        coll_kinds[kind] = {
            "bytes": max(0.0, ba["bytes"] + (ns_full - ns_a) * per),
            "count": int(max(0, ba["count"] + (ns_full - ns_a) * cnt_per)),
        }
    cell.update(
        status="ok",
        n_chips=n_chips,
        lower_s=round(t_lower + m_a["lower_s"] + m_b["lower_s"], 1),
        compile_s=round(m_a["compile_s"] + m_b["compile_s"], 1),
        arg_bytes=arg_bytes,
        out_bytes=int(out_bytes),
        temp_bytes=int(max(0.0, peak - arg_bytes)),
        peak_bytes=int(peak),
        fits=peak <= HBM_BYTES,
        # The reference's full-depth scanned compile; here the shallower
        # counted run (ns_a superblocks).
        scanned_flops_per_device=m_a["flops"],
        scanned_collectives=m_a["collectives"],
        counted_superblocks=[ns_a, ns_b],
        flops_per_device=flops,
        flops_per_superblock=flops_per_sb,
        bytes_per_device=bytes_acc,
        collective_bytes_per_device=coll_bytes,
        collectives=coll_kinds,
        t_compute=flops / PEAK_FLOPS,
        t_memory=bytes_acc / HBM_BW,
        t_collective=coll_bytes / LINK_BW,
        model_flops_total=_model_flops(cfg, shape),
    )
    terms = {"compute": cell["t_compute"], "memory": cell["t_memory"],
             "collective": cell["t_collective"]}
    cell["bottleneck"] = max(terms, key=terms.get)
    # FlopCounterMode counts matmuls and attention only; XLA's
    # cost_analysis adds elementwise work, so the reference's ratio is
    # lower for the same program.
    cell["model_flops_ratio"] = (
        cell["model_flops_total"] / (flops * n_chips) if flops else 0.0
    )
    for key in ("flops_per_device", "bytes_per_device", "arg_bytes",
                "peak_bytes"):
        if not cell[key] > 0:
            raise RuntimeError(f"{arch} x {shape.name}: {key} is "
                               f"{cell[key]}: the counter saw nothing")
    if verbose:
        print(f"[dryrun] {arch} x {shape.name} x {cell['mesh']}: OK "
              f"run={cell['compile_s']:.0f}s "
              f"peak={cell['peak_bytes']/2**30:.2f}GiB/dev"
              f" flops/dev={cell['flops_per_device']:.3g}"
              f" bytes/dev={cell['bytes_per_device']:.3g}"
              f" coll/dev={cell['collective_bytes_per_device']:.3g}"
              f" bottleneck={cell['bottleneck']}"
              f" fits={cell['fits']}", flush=True)
    if save:
        _save_cell(cell)
    return cell


def count_step(arch: str, shape, *, mesh_shape: Optional[tuple] = None,
               smoke: bool = False, once: bool = True) -> Dict:
    """The per-rank counts of one step of ``arch`` (its smoke config with
    ``smoke``) at full depth and ``shape`` (a name of
    ``SHAPES`` or a ``ShapeConfig``), with no extrapolation: on one device
    (plain meta tensors, no process group) or on a fake world of
    ``mesh_shape`` over ("data", "model").  ``once=False`` walks the sLSTM
    loop whole."""
    from repro_torch.configs import get_smoke_config

    from .mesh import make_mesh

    cfg = (get_smoke_config if smoke else get_config)(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    with (contextlib.nullcontext() if mesh_shape is None
          else fake_world(math.prod(mesh_shape))):
        t0 = time.time()
        mesh = None if mesh_shape is None else make_mesh(
            tuple(mesh_shape), ("data", "model")[:len(mesh_shape)],
            device="cpu")
        run, inputs = lower_cell(cfg, shape, mesh)
        return _count(run, inputs, time.time() - t0, once=once)


def _save_cell(cell: Dict) -> None:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    fname = (f"{cell['arch']}__{cell['shape']}__"
             f"{cell['mesh'].replace('x', '_')}.json")
    with open(os.path.join(ARTIFACT_DIR, fname), "w") as f:
        json.dump(cell, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--and-single", action="store_true",
                    help="with --all: run both meshes")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose artifact JSON already exists")
    args = ap.parse_args(argv)

    # Cheap-first ordering banks results early.
    arch_order = ["whisper-base", "internvl2-1b", "xlstm-350m", "codeqwen1.5-7b",
                  "internlm2-20b", "zamba2-7b", "phi3.5-moe-42b-a6.6b",
                  "qwen3-32b", "arctic-480b", "qwen2-72b"]
    shape_order = ["decode_32k", "long_500k", "prefill_32k", "train_4k"]
    archs = arch_order if args.all or not args.arch else [args.arch]
    shapes = shape_order if args.all or not args.shape else [args.shape]
    meshes = [args.multipod]
    if args.and_single and args.multipod:
        meshes = [False, True]
    results = []
    for shape in shapes:
        for arch in archs:
            for mp in meshes:
                mesh_name = "2_16_16" if mp else "16_16"
                path = os.path.join(
                    ARTIFACT_DIR, f"{arch}__{shape}__{mesh_name}.json")
                if args.resume and os.path.exists(path):
                    with open(path) as f:
                        cell = json.load(f)
                    if cell.get("status") in ("ok", "skip"):
                        results.append(cell)
                        print(f"[dryrun] {arch} x {shape} x {cell['mesh']}: "
                              f"cached ({cell['status']})", flush=True)
                        continue
                try:
                    results.append(
                        run_cell(arch, shape, multi_pod=mp, save=not args.no_save)
                    )
                except Exception as e:  # noqa: BLE001 — a failed cell is a bug: report loudly
                    traceback.print_exc()
                    results.append({
                        "arch": arch, "shape": shape,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": "fail", "error": f"{type(e).__name__}: {e}",
                    })
    ok = sum(1 for r in results if r["status"] == "ok")
    skip = sum(1 for r in results if r["status"] == "skip")
    fail = sum(1 for r in results if r["status"] == "fail")
    print(f"\n[dryrun] done: {ok} ok, {skip} skip, {fail} FAIL of {len(results)}")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
