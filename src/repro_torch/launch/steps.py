"""The step functions (train / prefill / decode) and their input specs
(port of ``repro/launch/steps.py``).

PyTorch runs eagerly, so a step is the model function with its config
bound.  The train step takes ``torch.autograd.grad`` of ``lm.loss_fn`` over
the param leaves, as ``jax.value_and_grad`` does, and updates params and
optimizer state in place (``optim/adamw.py``): the counterpart of the
reference's donated jit.  The ``*_struct`` helpers give every input of a
step as meta tensors — shapes and dtypes, nothing allocated, nothing drawn
— as the reference's ``jax.ShapeDtypeStruct`` stand-ins do.  On a mesh
the same step runs on ``DTensor`` params and batches
(``launch/train.py``); its metrics come back as plain tensors.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core._tree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.optim import adamw

_META = torch.device("meta")


def make_train_step(cfg: ArchConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(), *,
                    grad_accum: int = 1):
    """One optimizer step: ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` with ``loss``, ``ce``, ``aux``,
    ``grad_norm`` and ``lr``.  ``grad_accum`` > 1 splits the batch into
    microbatches run one after another (activation memory scales with the
    microbatch); their grads, losses and aux are summed in float32 and
    averaged — identical numerics.  Params and state are updated in place."""

    def grads_of(leaves, treedef, batch):
        with torch.enable_grad():
            live = [t.detach().requires_grad_(True) for t in leaves]
            loss, metrics = lm.loss_fn(tree_unflatten(treedef, live), cfg,
                                       batch)
            grads = torch.autograd.grad(loss, live)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(params, opt_state, batch):
        leaves, treedef = tree_flatten(params)
        if grad_accum == 1:
            loss, metrics, grads = grads_of(leaves, treedef, batch)
        else:
            def micro(t, i):
                n = t.shape[0] // grad_accum
                return t[i * n:(i + 1) * n]

            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            asum = torch.zeros_like(lsum)
            for i in range(grad_accum):
                l, m, g = grads_of(leaves, treedef,
                                   tree_map(lambda t: micro(t, i), batch))
                for acc, gi in zip(gsum, g):
                    acc.add_(gi)
                del g
                lsum = lsum + l
                asum = asum + m["aux"]
            grads = [acc / grad_accum for acc in gsum]
            del gsum
            loss = lsum / grad_accum
            metrics = {"ce": loss, "aux": asum / grad_accum}
        lr_scale = adamw.cosine_schedule(opt_state.step, warmup=100,
                                         total=10000)
        params, opt_state, opt_metrics = adamw.update(
            tree_unflatten(treedef, list(grads)), opt_state, params, opt_cfg,
            lr_scale,
        )
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, {k: _full(v) for k, v in metrics.items()}

    return train_step


def _full(t):
    """A metric as a plain tensor: a DTensor's global value (on a mesh the
    loss comes back partial or sharded)."""
    full = getattr(t, "full_tensor", None)
    return full() if full is not None else t


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch, states):
        with torch.no_grad():
            return lm.prefill(params, cfg, batch, states)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, token, pos, states):
        with torch.no_grad():
            return lm.decode_step(params, cfg, token, pos, states)

    return decode_step


# ---------------------------------------------------------------------------
# Meta-device inputs (the reference's ShapeDtypeStruct stand-ins)
# ---------------------------------------------------------------------------


def batch_struct(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Input batch stand-ins for train/prefill of one (arch, shape) cell."""
    b, l = shape.global_batch, shape.seq_len

    def tok(*s):
        return torch.empty(s, dtype=torch.int32, device=_META)

    def emb(*s):
        return torch.empty(s, dtype=cfg.cdtype, device=_META)

    batch: Dict[str, Any] = {}
    if cfg.frontend == "patch":
        n_text = l - cfg.frontend_len
        batch["tokens"] = tok(b, n_text)
        batch["labels"] = tok(b, n_text)
        batch["patches"] = emb(b, cfg.frontend_len, cfg.d_model)
    elif cfg.frontend == "audio":
        batch["tokens"] = tok(b, l)
        batch["labels"] = tok(b, l)
        batch["frames"] = emb(b, cfg.frontend_len, cfg.d_model)
    else:
        batch["tokens"] = tok(b, l)
        batch["labels"] = tok(b, l)
    return batch


def params_struct(cfg: ArchConfig):
    return lm.init_shapes(cfg)


def opt_state_struct(cfg: ArchConfig, params,
                     opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig()):
    return adamw.init(tree_map(lambda p: p.to(_META), params), opt_cfg)


def decode_state_struct(cfg: ArchConfig, shape: ShapeConfig):
    return lm.init_decode_states(cfg, shape.global_batch, shape.seq_len,
                                 device=_META)


def decode_inputs_struct(cfg: ArchConfig, shape: ShapeConfig):
    b = shape.global_batch
    return (
        torch.empty((b, 1), dtype=torch.int32, device=_META),   # token
        torch.empty((), dtype=torch.int32, device=_META),       # pos
    )
