"""End-to-end training driver (port of ``repro/launch/train.py``).

Composes every substrate layer: config -> model -> step -> data pipeline ->
checkpointing -> fault handling -> straggler monitor, on the card unless the
caller asks for the CPU (``device="cpu"``).  The step is eager PyTorch and
updates params and optimizer state in place, where the reference jits a
step that donates them.  Training runs on the configurations' "xla"
backends, as the reference's does; a kernel backend under autograd raises
(``kernels/_cuda.refuse_autograd``).

On a mesh (``mesh_shape``, e.g. (2, 2) over ("data", "model")) every rank
of a process group runs the same step on ``DTensor``s: params and AdamW
state laid out by the sharding rules (TP + FSDP), the batch split by
``batch_specs``, the model's ``shardctx`` anchors active.  ``train`` with
no process group spawns ``prod(mesh_shape)`` ranks itself (a ``FileStore``
rendezvous in a temporary directory) and returns rank 0's result; under
``torchrun`` it uses the group that is there.  The backend is NCCL when
every rank has a GPU of its own, else gloo (the CPU, or ranks that share
one card: NCCL refuses two ranks on one GPU).

Usage:
  python -m repro_torch.launch.train --arch xlstm-350m --smoke --steps 50 \\
      [--device cpu] [--mesh 2x2]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.core._tree import tree_flatten
from repro_torch.models import lm
from repro_torch.models.shardctx import activation_sharding
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FailureInjector, run_with_restarts
from repro_torch.runtime.straggler import StragglerMonitor

from . import host_staging
from . import sharding as shd
from . import steps
from .mesh import (dp_axes, make_mesh, rank_device, run_world, tp_axis,
                   world_backend)

_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState


@dataclasses.dataclass
class TrainConfig:
    arch: str = "xlstm-350m"
    smoke: bool = False
    steps: int = 100
    batch: int = 8
    seq_len: int = 256
    lr: float = 3e-4
    save_every: int = 50
    ckpt_dir: str = _CKPT_DIR
    mesh_shape: Optional[tuple] = None     # e.g. (2, 2); None = single device
    fail_at: tuple = ()                    # failure-injection steps
    log_every: int = 10
    device: Optional[str] = None           # None: the card


def build(cfg_t: TrainConfig):
    """``(arch config, AdamW config, step function, mesh)``.  With
    ``mesh_shape`` the mesh is a ``DeviceMesh`` over the initialised
    world's first ranks (raising when it is smaller), and the step takes
    DTensor params and state and a full batch, which it splits by
    ``batch_specs``."""
    acfg = (get_smoke_config if cfg_t.smoke else get_config)(cfg_t.arch)
    opt_cfg = adamw.AdamWConfig(lr=cfg_t.lr)
    if not cfg_t.mesh_shape:
        return acfg, opt_cfg, steps.make_train_step(acfg, opt_cfg), None
    names = ("data", "model")[: len(cfg_t.mesh_shape)]
    mesh = make_mesh(tuple(cfg_t.mesh_shape), names, device=cfg_t.device)
    return acfg, opt_cfg, mesh_step(acfg, opt_cfg, mesh), mesh


def mesh_step(acfg, opt_cfg: adamw.AdamWConfig, mesh, *,
              grad_accum: int = 1):
    """``steps.make_train_step`` on ``mesh``: the step takes DTensor params
    and state (``sharding.distribute`` by the rules) and a full batch, which
    it splits by ``batch_specs``, and runs under the activation anchors."""
    step_fn = steps.make_train_step(acfg, opt_cfg, grad_accum=grad_accum)
    bspecs = shd.batch_specs(acfg, mesh, kind="train")

    def sharded_step(params, opt, batch):
        from torch.distributed.tensor.experimental import implicit_replication

        batch = shd.distribute(batch, {k: bspecs[k] for k in batch}, mesh)
        # Plain tensors the model makes (positions, masks, accumulators)
        # hold the same full value on every rank: replicated.
        with activation_sharding(mesh, dp=dp_axes(mesh), tp=tp_axis(mesh)), \
                implicit_replication():
            return step_fn(params, opt, batch)

    return sharded_step


def _train_rank(rank: int, device: torch.device, cfg_t: "TrainConfig"):
    out = train(dataclasses.replace(cfg_t, device=str(device)))
    return out if rank == 0 else None


def _local_bytes(tree) -> int:
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def train(cfg_t: TrainConfig) -> Dict[str, Any]:
    """Train ``cfg_t.steps`` steps with checkpoints and restarts.  Returns
    the reference's keys (``losses``, ``final_loss``, ``restarts``,
    ``steps``, ``mean_step_s``) plus ``loss_steps`` (the step of each
    loss: a replayed step appears twice), ``grad_norms`` (each loss's step's
    global grad norm), ``step_s`` (each step's seconds)
    and ``checkpoint`` (``Checkpointer.timings`` and the bytes of the last
    checkpoint).  On a mesh it adds ``mesh``, ``backend``, ``ranks``
    (each rank's local param and optimizer bytes and peak device memory)
    and rank 0's ``staged_collectives`` (``host_staging.counts``);
    with no process group it spawns the mesh's ranks and returns rank 0's
    result."""
    if cfg_t.mesh_shape and not dist.is_initialized():
        return run_world(_train_rank, math.prod(cfg_t.mesh_shape), cfg_t,
                         device=cfg_t.device)[0]
    device = resolve_device(cfg_t.device)
    acfg, opt_cfg, step_fn, mesh = build(cfg_t)
    rank0 = mesh is None or dist.get_rank() == 0
    if mesh is not None:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        structs = steps.params_struct(acfg)
        pspecs = shd.param_shardings(structs, acfg, mesh)
        state_specs = TrainState(pspecs, shd.opt_state_shardings(
            steps.opt_state_struct(acfg, structs, opt_cfg), pspecs, mesh))
    pipe = TokenPipeline(
        PipelineConfig(
            vocab_size=acfg.vocab_size,
            global_batch=cfg_t.batch,
            seq_len=cfg_t.seq_len,
        )
    )
    ckpt = Checkpointer(cfg_t.ckpt_dir, keep=2)
    injector = FailureInjector(fail_at_steps=tuple(cfg_t.fail_at))
    monitor = StragglerMonitor(1, cfg_t.batch)
    losses: list = []
    grad_norms: list = []
    loss_steps: list = []
    times: list = []
    kept: list = [None]

    def make_state():
        gen = torch.Generator(device=device).manual_seed(0)
        params = lm.init_params(gen, acfg)
        if mesh is not None:
            # Every rank draws the same full params and keeps its blocks.
            params = shd.distribute(params, pspecs, mesh)
        return TrainState(params, adamw.init(params, opt_cfg))

    def extra_batch(b, tokens_np):
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=device)
                 for k, v in tokens_np.items()}
        key = {"patch": "patches", "audio": "frames"}.get(acfg.frontend)
        if key is not None:
            batch[key] = torch.zeros((b, acfg.frontend_len, acfg.d_model),
                                     dtype=acfg.cdtype, device=device)
        return batch

    def one_step(state: TrainState, step: int) -> TrainState:
        t0 = time.time()
        batch = extra_batch(cfg_t.batch, pipe.batch_at(step))
        params, opt, metrics = step_fn(state.params, state.opt, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        loss_steps.append(step)
        dt = time.time() - t0
        times.append(dt)
        monitor.observe([dt])
        if rank0 and step % cfg_t.log_every == 0:
            print(f"[train] step={step:5d} loss={loss:.4f} "
                  f"gnorm={grad_norms[-1]:.3f} dt={dt*1e3:.0f}ms")
        return TrainState(params, opt)

    run = run_with_restarts(
        total_steps=cfg_t.steps,
        make_state=make_state,
        train_step=one_step,
        checkpointer=ckpt,
        save_every=cfg_t.save_every,
        state_device=device,
        state_shardings=(None if mesh is None
                         else shd.named(mesh, state_specs)),
        injector=injector,
        on_step=lambda _s, state: kept.__setitem__(0, state),
    )
    pipe.stop()
    last = ckpt.latest_step()
    extra: Dict[str, Any] = {}
    if mesh is not None:
        state = kept[0]
        mine = {
            "rank": dist.get_rank(),
            "param_bytes": _local_bytes(state.params),
            "opt_bytes": _local_bytes(state.opt),
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
        }
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        extra = {"mesh": tuple(cfg_t.mesh_shape),
                 "backend": dist.get_backend(), "ranks": ranks,
                 "staged_collectives": {k: list(v) for k, v in
                                        host_staging.counts.items()}}
    return {
        "losses": losses,
        "final_loss": losses[-1] if losses else None,
        "restarts": run.restarts,
        "steps": run.step,
        "mean_step_s": float(np.mean(times[2:])) if len(times) > 2 else None,
        "loss_steps": loss_steps,
        "grad_norms": grad_norms,
        "step_s": times,
        "checkpoint": dict(
            ckpt.timings,
            bytes=(None if last is None else _dir_bytes(
                os.path.join(ckpt.dir, f"step_{last:08d}")))),
        **extra,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=_CKPT_DIR)
    ap.add_argument("--mesh", default=None, help="e.g. 2x2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    mesh_shape = (
        tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None
    )
    device = args.device
    if mesh_shape and "RANK" in os.environ and not dist.is_initialized():
        # Under torchrun: join its world (env:// rendezvous).
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        backend = world_backend(device, world)
        dev = rank_device(device, backend, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend)
        device = str(dev)
    out = train(TrainConfig(
        arch=args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq_len=args.seq_len, lr=args.lr, ckpt_dir=args.ckpt_dir,
        mesh_shape=mesh_shape, device=device,
    ))
    if mesh_shape and dist.is_initialized() and dist.get_rank() != 0:
        return
    print(f"[train] done: final_loss={out['final_loss']:.4f} "
          f"restarts={out['restarts']} mean_step={out['mean_step_s']}")


if __name__ == "__main__":
    main()
