"""Training on a (1, 4) ("data", "model") mesh, where "model" does not
divide every head count: qwen3-32b's smoke config (4 query heads, 2 kv
heads) and xlstm-350m's (2 heads).  A projection's columns are sharded
over "model" whenever its width divides 4, and before the per-head view
the port replicates them over "model" where the heads do not divide
(``shardctx.split_heads``), as GSPMD reshards the reference's.

Held, at ``tests/test_torch_train_mesh.py``'s bounds, to

* the reference's ``build(TrainConfig(mesh_shape=(1, 4)))`` step on 4
  virtual devices (its unbound ``tp`` bound to "model"), from its own
  initial params carried across, and
* the port's one-device step on the same params and batches;

and on that mesh the loss takes each "model" rank's vocab block of the
chunk-major head (``shardctx.local_vocab``): the head a rank forms its
logits from is a quarter of the whole.

AdamW runs at eps 1e-3 in both packages (``chip_smoke.py``'s
``train_mesh_check`` does the same): at the default 1e-8 an entry whose
gradient is float noise (a few of the embedding table's) takes Adam's
step with either sign, so the port's one-device step and the reference's
already part there by ~1e-3 (ROADMAP, "Facts about the reference").
"""

import dataclasses
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
from repro_torch.launch.train import TrainConfig, build, mesh_step
from repro_torch.models import layers
from repro_torch.optim import adamw

ARCHS = ("qwen3-32b", "xlstm-350m")
MESH = (1, 4)
STEPS = 3
BATCH, SEQ = 4, 32
LR = 0.1                # tests/test_torch_train_mesh.py: the params move
EPS = 1e-3              # AdamW's eps (see the module docstring)
MOVED = 10 * 1e-4       # the least the largest param change must reach
STEP_ATOL = 1e-4        # tests/test_torch_train.py (the reference's step bound)
LOSS_RTOL = 1e-5        # mesh vs one device: the same sums, other orders
GNORM_RTOL = 1e-4

REFERENCE_SNIPPET = r"""
import pickle
import numpy as np, jax
import repro.launch.sharding as rs
rs.tp = "model"          # the rule's unbound name
import repro.optim.adamw as radamw
_AdamW = radamw.AdamWConfig
radamw.AdamWConfig = lambda **kw: _AdamW(**{"eps": %(eps)r, **kw})
from repro.launch.train import TrainConfig, build
from repro.models import lm
from repro.optim import adamw

batches = np.load(%(batches)r)
out = {}
for arch in %(archs)r:
    acfg, opt_cfg, step, mesh = build(TrainConfig(
        arch=arch, smoke=True, mesh_shape=%(mesh)r, lr=%(lr)r))
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
        rng = np.random.default_rng(200 + j)
        for i in range(STEPS):
            for k in ("tokens", "labels"):
                out[f"{arch}/{k}{i}"] = rng.integers(
                    0, vocab, (BATCH, SEQ)).astype(np.int32)
    return out


def _full_numpy(tree):
    return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().float().numpy() for t in tree_flatten(tree)[0]]


def _run_steps(arch, params, batches, mesh_shape=None):
    """STEPS steps from ``params``: (losses, grad norms, final params, the
    head bytes each loss call formed its logits from)."""
    cfg_t = TrainConfig(arch=arch, smoke=True, lr=LR, device="cpu",
                        mesh_shape=mesh_shape)
    acfg, opt_cfg, _, mesh = build(cfg_t)
    opt_cfg = dataclasses.replace(opt_cfg, eps=EPS)
    if mesh is None:
        step = steps.make_train_step(acfg, opt_cfg)
    else:
        step = mesh_step(acfg, opt_cfg, mesh)
        params = shd.distribute(params, shd.param_shardings(params, acfg, mesh),
                                mesh)
    opt = adamw.init(params, opt_cfg)
    head_bytes = []
    ce_parts = layers._ce_parts

    def spy(head_w, *args, **kw):
        head_bytes.append(head_w.numel() * head_w.element_size())
        return ce_parts(head_w, *args, **kw)

    layers._ce_parts = spy
    losses, gnorms = [], []
    try:
        for i in range(STEPS):
            batch = {k: torch.as_tensor(batches[f"{arch}/{k}{i}"],
                                        dtype=torch.long)
                     for k in ("tokens", "labels")}
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    finally:
        layers._ce_parts = ce_parts
    return losses, gnorms, _full_numpy(params), sorted(set(head_bytes))


def _mesh_rank(rank, device, ref_path, batches_path):
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    batches = dict(np.load(batches_path))
    out = {arch: _run_steps(arch, params_from_numpy(ref[arch]["init"]),
                            batches, mesh_shape=MESH) for arch in ARCHS}
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_heads")
    batches_path, ref_path = str(d / "batches.npz"), str(d / "ref.pkl")
    batches = _batches()
    np.savez(batches_path, **batches)
    subproc(REFERENCE_SNIPPET % {"batches": batches_path, "archs": ARCHS,
                                 "mesh": MESH, "lr": LR, "eps": EPS,
                                 "steps": STEPS,
                                 "out": ref_path}, devices=4)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    mesh = run_world(_mesh_rank, 4, ref_path, batches_path, device="cpu")[0]
    one = {arch: _run_steps(arch, params_from_numpy(ref[arch]["init"]),
                            batches) for arch in ARCHS}
    return ref, mesh, one


@pytest.mark.parametrize("arch", ARCHS)
def test_heads_that_do_not_divide_model(arch):
    """The fault's precondition: a projection "model" shards whose heads it
    does not divide."""
    cfg = get_smoke_config(arch)
    heads = cfg.n_kv_heads if arch == "qwen3-32b" else cfg.n_heads
    width = heads * (cfg.hd if arch == "qwen3-32b" else cfg.ssm_head_dim)
    assert width % MESH[1] == 0 and heads % MESH[1] != 0


@pytest.mark.parametrize("arch", ARCHS)
def test_1x4_steps_match_reference_mesh(runs, arch):
    ref, mesh, _ = runs
    losses, _, params, _ = mesh[arch]
    np.testing.assert_allclose(losses, ref[arch]["losses"], rtol=1e-5,
                               atol=STEP_ATOL)
    want = [np.asarray(x, np.float32) for x in
            tree_flatten(params_from_numpy(ref[arch]["final"]))[0]]
    start = [np.asarray(x, np.float32) for x in
             tree_flatten(params_from_numpy(ref[arch]["init"]))[0]]
    moved = max(float(np.abs(b - a).max()) for a, b in zip(start, want))
    assert moved > MOVED, f"the params moved only {moved}"
    assert len(params) == len(want)
    for a, b in zip(params, want):
        np.testing.assert_allclose(a, b.numpy() if hasattr(b, "numpy") else b,
                                   rtol=0, atol=STEP_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_1x4_steps_match_one_device(runs, arch):
    _, mesh, one = runs
    (ml, mg, mp, _), (ol, og, op, _) = mesh[arch], one[arch]
    np.testing.assert_allclose(ml, ol, rtol=LOSS_RTOL)
    np.testing.assert_allclose(mg, og, rtol=GNORM_RTOL)
    for a, b in zip(mp, op):
        np.testing.assert_allclose(a, b, rtol=0, atol=STEP_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_head_stays_in_vocab_blocks(runs, arch):
    """A rank's loss reads a quarter of the chunk-major head; one device
    reads it whole."""
    _, mesh, one = runs
    cfg = get_smoke_config(arch)
    whole = cfg.padded_vocab * cfg.d_model * 4          # float32 smoke head
    assert one[arch][3] == [whole]
    assert mesh[arch][3] == [whole // MESH[1]]


# ------------------------------------------------- serving steps on a mesh
SERVE_ARCHS = ("qwen3-32b", "zamba2-7b", "xlstm-350m", "whisper-base",
               "phi3.5-moe-42b-a6.6b")
SERVE_MESHES = ((2, 2), (1, 4))
PROMPT, CACHE, NEW = 16, 32, 3


def _serve(arch, batch, mesh=None):
    """A prefill of ``batch``'s prompts and NEW greedy decode steps of
    ``arch``'s smoke config from seeded params: every step's logits (as
    numpy, whole).  On ``mesh`` the params, caches and batch are laid out
    by the rules and the steps run under the activation anchors, the KV
    caches sequence-sharded (``shardctx.local_cache``).  A batch the data
    axes do not divide (the reference's batch rule would split it
    unevenly) is prefilled on one device, and its states are laid out on
    the mesh for the decode steps: the cache then splits its sequence over
    every axis."""
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import lm
    from repro_torch.models.shardctx import activation_sharding

    cfg = get_smoke_config(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    b = batch["tokens"].shape[0]
    states = lm.init_decode_states(cfg, b, CACHE)
    whole_batch = mesh is None or b % shd.axis_size(mesh, shd.dp_axes(mesh))

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()

    def place(tree, specs):
        return shd.distribute(tree, specs, mesh)

    out = []
    with torch.no_grad():
        if whole_batch:
            logits, states = lm.prefill(params, cfg, batch, states)
            out.append(whole(logits))
        if mesh is None:
            ctx = contextlib.nullcontext()
        else:
            params = place(params, shd.param_shardings(params, cfg, mesh))
            states = place(states, shd.state_specs(cfg, mesh, states, batch=b))
            ctx = contextlib.ExitStack()
            ctx.enter_context(activation_sharding(
                mesh, dp=shd.dp_axes(mesh), tp=shd.tp_axis(mesh)))
            ctx.enter_context(implicit_replication())
        with ctx:
            if not whole_batch:
                specs = shd.batch_specs(cfg, mesh, kind="prefill")
                logits, states = lm.prefill(
                    params, cfg, place(batch, {k: specs[k] for k in batch}),
                    states)
                out.append(whole(logits))
            for i in range(NEW):
                tok = torch.as_tensor(out[-1][:, -1].argmax(-1)[:, None])
                logits, states = lm.decode_step(params, cfg, tok, PROMPT + i,
                                                states)
                out.append(whole(logits))
    return out


def _serve_batches():
    out = {}
    for j, arch in enumerate(SERVE_ARCHS):
        cfg = get_smoke_config(arch)
        rng = np.random.default_rng(300 + j)
        for b in (4, 1):
            batch = {"tokens": torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (b, PROMPT)))}
            if cfg.frontend == "audio":
                batch["frames"] = torch.as_tensor(rng.normal(size=(
                    b, cfg.frontend_len, cfg.d_model)).astype(np.float32))
            out[(arch, b)] = batch
    return out


def _serve_rank(rank, device, shape):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {key: _serve(key[0], batch, mesh)
           for key, batch in _serve_batches().items()}
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def served():
    one = {key: _serve(key[0], batch)
           for key, batch in _serve_batches().items()}
    return one, {shape: run_world(_serve_rank, 4, shape, device="cpu")[0]
                 for shape in SERVE_MESHES}


@pytest.mark.parametrize("shape", SERVE_MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_on_a_mesh_match_one_device(served, arch, shape):
    """A prefill and three decode steps on the mesh (batch 4, and batch 1,
    whose cache is sequence-sharded over every axis) give one device's
    logits: the KV cache blocks attended where they lie and combined, the
    head's vocab blocks joined, the recurrent states on local heads."""
    one, mesh = served
    for b in (4, 1):
        for got, want in zip(mesh[shape][(arch, b)], one[(arch, b)]):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
