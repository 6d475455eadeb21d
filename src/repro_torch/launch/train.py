"""End-to-end training driver (port of ``repro/launch/train.py``).

Composes every substrate layer: config -> model -> step -> data pipeline ->
checkpointing -> fault handling -> straggler monitor, on one device: the
card unless the caller asks for the CPU (``device="cpu"``).  The step is
eager PyTorch and updates params and optimizer state in place, where the
reference jits a step that donates them.  Training runs on the
configurations' "xla" backends, as the reference's does; a kernel backend
under autograd raises (``kernels/_cuda.refuse_autograd``).  The reference's
mesh path (``mesh_shape``) waits for LM multi-device.

Usage:
  python -m repro_torch.launch.train --arch xlstm-350m --smoke --steps 50 \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FailureInjector, run_with_restarts
from repro_torch.runtime.straggler import StragglerMonitor

from . import steps

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
    """``(arch config, AdamW config, step function, mesh)``; the mesh is
    always None here."""
    if cfg_t.mesh_shape:
        raise NotImplementedError(
            "training on a mesh (mesh_shape) is not ported yet "
            "(LM multi-device, ROADMAP.md Queue 1)"
        )
    acfg = (get_smoke_config if cfg_t.smoke else get_config)(cfg_t.arch)
    opt_cfg = adamw.AdamWConfig(lr=cfg_t.lr)
    return acfg, opt_cfg, steps.make_train_step(acfg, opt_cfg), None


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def train(cfg_t: TrainConfig) -> Dict[str, Any]:
    """Train ``cfg_t.steps`` steps with checkpoints and restarts.  Returns
    the reference's keys (``losses``, ``final_loss``, ``restarts``,
    ``steps``, ``mean_step_s``) plus ``loss_steps`` (the step of each
    loss: a replayed step appears twice), ``step_s`` (each step's seconds)
    and ``checkpoint`` (``Checkpointer.timings`` and the bytes of the last
    checkpoint)."""
    acfg, opt_cfg, step_fn, _ = build(cfg_t)
    device = resolve_device(cfg_t.device)
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
    loss_steps: list = []
    times: list = []

    def make_state():
        gen = torch.Generator(device=device).manual_seed(0)
        params = lm.init_params(gen, acfg)
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
        loss_steps.append(step)
        dt = time.time() - t0
        times.append(dt)
        monitor.observe([dt])
        if step % cfg_t.log_every == 0:
            print(f"[train] step={step:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} dt={dt*1e3:.0f}ms")
        return TrainState(params, opt)

    run = run_with_restarts(
        total_steps=cfg_t.steps,
        make_state=make_state,
        train_step=one_step,
        checkpointer=ckpt,
        save_every=cfg_t.save_every,
        state_device=device,
        injector=injector,
    )
    pipe.stop()
    last = ckpt.latest_step()
    return {
        "losses": losses,
        "final_loss": losses[-1] if losses else None,
        "restarts": run.restarts,
        "steps": run.step,
        "mean_step_s": float(np.mean(times[2:])) if len(times) > 2 else None,
        "loss_steps": loss_steps,
        "step_s": times,
        "checkpoint": dict(
            ckpt.timings,
            bytes=(None if last is None else _dir_bytes(
                os.path.join(ckpt.dir, f"step_{last:08d}")))),
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
    out = train(TrainConfig(
        arch=args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq_len=args.seq_len, lr=args.lr, ckpt_dir=args.ckpt_dir,
        mesh_shape=mesh_shape, device=args.device,
    ))
    print(f"[train] done: final_loss={out['final_loss']:.4f} "
          f"restarts={out['restarts']} mean_step={out['mean_step_s']}")


if __name__ == "__main__":
    main()
