"""Training on a mesh in the port (``launch/train.py`` with ``mesh_shape``):
the smoke configs of ``xlstm-350m``, ``qwen3-32b`` and
``phi3.5-moe-42b-a6.6b`` on a (2, 2) ("data", "model") mesh of gloo CPU
ranks, held to

* the port's one-device step on the same params and batches (loss rtol
  1e-5, grad norm rtol 1e-4, params, AdamW's master copy and moments atol
  ``STEP_ATOL``, and each leaf's first moment within ``M_RTOL`` of its
  largest entry), and
* the reference's ``build(TrainConfig(mesh_shape=(2, 2)))`` step on 4
  virtual devices, from the reference's own initial params carried across
  (the bounds ``tests/test_torch_train.py`` holds the one-device step to:
  losses rtol 1e-5 / atol ``STEP_ATOL``, params atol ``STEP_ATOL``);

and the training entry point end to end: ``main(["--mesh", "2x2", ...])``
spawns its ranks and checkpoints, and ``train(mesh_shape=(4, 1))`` (the
elastic plan for 4 devices at TP 1) restores that checkpoint and continues
with the uninterrupted one-device run's loss.

The reference's ``_spec_for`` reads an unbound ``tp``; its subprocess
binds ``repro.launch.sharding.tp = "model"`` first (see
``tests/test_torch_multidevice.py``).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core._tree import tree_flatten
from repro_torch.interop import params_from_numpy
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import run_world
from repro_torch.launch.train import TrainConfig, build, main, train
from repro_torch.optim import adamw
from repro_torch.runtime import elastic

ARCHS = ("xlstm-350m", "qwen3-32b", "phi3.5-moe-42b-a6.6b")
STEPS = 3
BATCH, SEQ = 4, 32
LR = 0.1                # the warmup's first steps scale it by 0, 1e-2, 2e-2:
                        # the params move ~3e-3, well past STEP_ATOL
STEP_ATOL = 1e-4        # tests/test_torch_train.py (the reference's step bound)
LOSS_RTOL = 1e-5        # mesh vs one device: the same sums, other orders
GNORM_RTOL = 1e-4
M_RTOL = 1e-4           # a leaf's first moment against its largest entry:
                        # small moments (the sLSTM's r) fall under STEP_ATOL
MOVED = 10 * STEP_ATOL  # the least the largest param change must reach

REFERENCE_SNIPPET = r"""
import pickle
import numpy as np, jax
import repro.launch.sharding as rs
rs.tp = "model"          # the rule's unbound name (see the module docstring)
from repro.launch.train import TrainConfig, build
from repro.models import lm
from repro.optim import adamw

batches = np.load(%(batches)r)
out = {}
for arch in %(archs)r:
    acfg, opt_cfg, step, mesh = build(TrainConfig(
        arch=arch, smoke=True, mesh_shape=(2, 2), lr=%(lr)r))
    params = lm.init_params(jax.random.PRNGKey(0), acfg)
    init = jax.device_get(params)
    opt = adamw.init(params, opt_cfg)
    losses = []
    for i in range(%(steps)d):
        batch = {k: batches[f"{arch}/{k}{i}"] for k in ("tokens", "labels")}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    out[arch] = {"init": init, "final": jax.device_get(params),
                 "losses": losses}
with open(%(out)r, "wb") as f:
    pickle.dump(out, f)
print("REFERENCE_OK")
"""


def _batches():
    out = {}
    for j, arch in enumerate(ARCHS):
        vocab = get_smoke_config(arch).vocab_size
        rng = np.random.default_rng(100 + j)
        for i in range(STEPS):
            for k in ("tokens", "labels"):
                out[f"{arch}/{k}{i}"] = rng.integers(
                    0, vocab, (BATCH, SEQ)).astype(np.int32)
    return out


def _batch(batches, arch, i):
    return {k: torch.as_tensor(batches[f"{arch}/{k}{i}"], dtype=torch.long)
            for k in ("tokens", "labels")}


def _full_numpy(tree):
    return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().float().numpy() for t in tree_flatten(tree)[0]]


def _run_steps(arch, params, batches, mesh_shape=None):
    """STEPS steps from ``params``: (losses, grad norms, final params,
    final AdamW state (m, v, master), initial params)."""
    cfg_t = TrainConfig(arch=arch, smoke=True, lr=LR, device="cpu",
                        mesh_shape=mesh_shape)
    acfg, opt_cfg, step, mesh = build(cfg_t)
    if mesh is not None:
        params = shd.distribute(params, shd.param_shardings(params, acfg, mesh),
                                mesh)
    start = _full_numpy(params)
    opt = adamw.init(params, opt_cfg)
    losses, gnorms = [], []
    for i in range(STEPS):
        params, opt, m = step(params, opt, _batch(batches, arch, i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return (losses, gnorms, _full_numpy(params),
            tuple(_full_numpy(t) for t in (opt.m, opt.v, opt.master)), start)


def _mesh_rank(rank, device, ref_path, batches_path):
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    batches = dict(np.load(batches_path))
    out = {arch: _run_steps(arch, params_from_numpy(ref[arch]["init"]),
                            batches, mesh_shape=(2, 2)) for arch in ARCHS}
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh")
    batches_path, ref_path = str(d / "batches.npz"), str(d / "ref.pkl")
    batches = _batches()
    np.savez(batches_path, **batches)
    subproc(REFERENCE_SNIPPET % {"batches": batches_path, "archs": ARCHS,
                                 "lr": LR, "steps": STEPS, "out": ref_path},
            devices=4)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    mesh = run_world(_mesh_rank, 4, ref_path, batches_path, device="cpu")[0]
    one = {arch: _run_steps(arch, params_from_numpy(ref[arch]["init"]),
                            batches) for arch in ARCHS}
    return ref, mesh, one


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_steps_match_one_device(runs, arch):
    _, mesh, one = runs
    (ml, mg, mp, ms, start), (ol, og, op, os_, _) = mesh[arch], one[arch]
    moved = max(float(np.abs(b - a).max()) for a, b in zip(start, op))
    assert moved > MOVED, f"the params moved only {moved}"
    np.testing.assert_allclose(ml, ol, rtol=LOSS_RTOL)
    np.testing.assert_allclose(mg, og, rtol=GNORM_RTOL)
    assert len(mp) == len(op) and all(len(a) == len(op) for a in ms + os_)
    for a, b in zip(mp + [t for ts in ms for t in ts],
                    op + [t for ts in os_ for t in ts]):
        np.testing.assert_allclose(a, b, rtol=0, atol=STEP_ATOL)
    for a, b in zip(ms[0], os_[0]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=M_RTOL * float(np.abs(b).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_steps_match_reference_mesh(runs, arch):
    ref, mesh, _ = runs
    losses, _, params, _, _ = mesh[arch]
    np.testing.assert_allclose(losses, ref[arch]["losses"], rtol=1e-5,
                               atol=STEP_ATOL)
    want = [np.asarray(x, np.float32) for x in
            tree_flatten(params_from_numpy(ref[arch]["final"]))[0]]
    assert len(params) == len(want)
    for a, b in zip(params, want):
        np.testing.assert_allclose(a, b.numpy() if hasattr(b, "numpy") else b,
                                   rtol=0, atol=STEP_ATOL)


def test_mesh_checkpoint_restores_onto_4x1(tmp_path, capsys):
    """``main --mesh 2x2`` trains 3 steps and checkpoints (rank 0 writes
    the full arrays); ``train`` on the elastic plan's (4, 1) mesh restores
    them with ``shardings=`` and takes step 4, which has the loss of the
    uninterrupted one-device run's step 4."""
    kw = dict(arch="qwen3-32b", smoke=True, batch=BATCH, seq_len=SEQ,
              lr=LR, device="cpu")
    one = train(TrainConfig(steps=STEPS + 1, save_every=100,
                            ckpt_dir=str(tmp_path / "one"), **kw))
    ckpt = str(tmp_path / "mesh")
    main(["--arch", "qwen3-32b", "--smoke", "--steps", str(STEPS),
          "--batch", str(BATCH), "--seq-len", str(SEQ), "--lr", str(LR),
          "--ckpt-dir", ckpt, "--device", "cpu", "--mesh", "2x2"])
    printed = capsys.readouterr().out
    assert f"final_loss={one['losses'][STEPS - 1]:.4f}" in printed
    assert os.path.isdir(os.path.join(ckpt, f"step_{STEPS:08d}"))
    plan = elastic.plan_rescale(4, model_parallel=1)
    assert plan.mesh_shape == (4, 1)
    out = train(TrainConfig(steps=STEPS + 1, save_every=100, ckpt_dir=ckpt,
                            mesh_shape=plan.mesh_shape, **kw))
    assert out["loss_steps"] == [STEPS]
    np.testing.assert_allclose(out["losses"][0], one["losses"][STEPS],
                               rtol=LOSS_RTOL)
    assert out["mesh"] == (4, 1) and out["backend"] == "gloo"
    assert len(out["ranks"]) == 4 and len(out["checkpoint"]["restore"]) == 1
    # FSDP over 4 ranks: each holds about a quarter of the params and state.
    total = sum(t.numel() * 4 for t in tree_flatten(
        steps.params_struct(get_smoke_config("qwen3-32b")))[0])
    for r in out["ranks"]:
        assert r["param_bytes"] < total / 2
        assert r["opt_bytes"] < 3 * total / 2
