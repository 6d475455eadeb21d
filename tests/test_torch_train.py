"""LM training in the port: ``steps.make_train_step`` against the
reference's jitted step, the training driver (``launch/train.py``: the
counterparts of ``tests/test_system.py``'s two training cases), bf16
checkpoints that cross between the packages, the guard that keeps autograd
away from the kernel backends, and the meta-device ``*_struct`` helpers
against the reference's ``jax.eval_shape`` structs.  Parameters are the
reference's, carried across with ``interop.params_from_numpy``; batches are
numpy from a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.kernels import ops as ref_ops
from repro.launch import steps as ref_steps
from repro.launch.train import TrainState as RefTrainState
from repro.models import config as ref_config
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core._tree import tree_flatten, tree_map
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.train import TrainConfig, TrainState, build, train
from repro_torch.models import config
from repro_torch.models import lm
from repro_torch.optim import adamw

# The reference's own bound for a train step (tests/test_substrate.py:212).
STEP_ATOL = 1e-4


def _batch_np(cfg, b=4, l=64, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)}


def _state_from_reference(rparams):
    params = params_from_numpy(jax.device_get(rparams))
    return params, adamw.init(params)


def _leaves_np(tree):
    return [t.detach().float().numpy() for t in tree_flatten(tree)[0]]


def _close(got_tree, want_tree, atol=STEP_ATOL):
    got = _leaves_np(got_tree)
    want = [np.asarray(x, np.float32) for x in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("arch,grad_accum", [
    ("internlm2_20b", 1), ("xlstm_350m", 1), ("internlm2_20b", 2)])
def test_three_train_steps_match_reference(arch, grad_accum):
    """Three steps from the same params and batches (step 1's lr is 0: the
    cosine warmup starts at 0): params, m, v, master and the metrics within
    the reference's own step bound."""
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    ropt = ref_adamw.init(rparams)
    params, opt = _state_from_reference(rparams)
    rstep = jax.jit(ref_steps.make_train_step(rcfg, grad_accum=grad_accum))
    step = steps.make_train_step(cfg, grad_accum=grad_accum)
    for i in range(3):
        batch = _batch_np(cfg, seed=i)
        rparams, ropt, rm = rstep(rparams, ropt, batch)
        params, opt, m = step(params, opt,
                              {k: torch.as_tensor(v) for k, v in batch.items()})
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-5,
                                       atol=STEP_ATOL, err_msg=k)
    assert float(rm["lr"]) > 0.0 and int(opt.step) == 3
    _close(params, rparams)
    _close(opt.m, ropt.m)
    _close(opt.v, ropt.v)
    _close(opt.master, ropt.master)


def test_grad_accum_matches_single_step():
    """grad_accum=k averages microbatch grads — numerically identical step
    (the counterpart of tests/test_substrate.py:193)."""
    cfg = get_smoke_config("internlm2-20b")
    batch = {k: torch.as_tensor(v) for k, v in _batch_np(cfg).items()}
    out = []
    for accum in (1, 2):
        params = lm.init_params(torch.Generator().manual_seed(0), cfg)
        out.append(steps.make_train_step(cfg, grad_accum=accum)(
            params, adamw.init(params), batch))
    (p1, _, m1), (p2, _, m2) = out
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    for a, b in zip(_leaves_np(p1), _leaves_np(p2)):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_train_step_updates_state_in_place():
    """The step writes params and optimizer state where they are (the
    reference's ``donate_argnums=(0, 1)``); a caller who keeps the old
    state clones it first."""
    cfg = get_smoke_config("internlm2-20b")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    opt = adamw.init(params)
    kept = tree_map(torch.clone, (params, opt))
    ptrs = [t.data_ptr() for t in tree_flatten((params, opt))[0]]
    batch = {k: torch.as_tensor(v) for k, v in _batch_np(cfg).items()}
    step = steps.make_train_step(cfg)
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    assert [t.data_ptr() for t in tree_flatten((params, opt))[0]] == ptrs
    assert int(opt.step) == 2 and int(kept[1].step) == 0
    assert not torch.equal(params["head"]["w"], kept[0]["head"]["w"])


# ---------------------------------------------------------------- driver
def test_train_loss_decreases(tmp_path):
    out = train(TrainConfig(
        arch="internlm2-20b", smoke=True, steps=40, batch=8, seq_len=128,
        lr=3e-3, ckpt_dir=str(tmp_path), save_every=100, device="cpu",
    ))
    losses = out["losses"]
    assert len(losses) == 40
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, (
        losses[:5] + losses[-5:])


def test_train_restarts_from_checkpoint(tmp_path):
    """Inject a failure mid-run: the driver must restore and finish, and the
    deterministic pipeline must replay the same stream."""
    out = train(TrainConfig(
        arch="internlm2-20b", smoke=True, steps=24, batch=4, seq_len=64,
        ckpt_dir=str(tmp_path), save_every=8, fail_at=(13,), device="cpu",
    ))
    assert out["restarts"] == 1
    assert out["steps"] == 24
    assert np.isfinite(out["final_loss"])
    # Steps 8-12 ran twice, from the step-8 checkpoint: the same losses.
    steps_run = out["loss_steps"]
    assert steps_run == list(range(13)) + list(range(8, 24))
    first, replay = out["losses"][8:13], out["losses"][13:18]
    np.testing.assert_allclose(replay, first, rtol=1e-6)
    assert len(out["checkpoint"]["restore"]) == 1
    assert out["checkpoint"]["bytes"] > 0


def test_train_defaults_and_what_raises(tmp_path, monkeypatch):
    cfg_t = TrainConfig()
    assert (cfg_t.arch, cfg_t.batch, cfg_t.seq_len, cfg_t.lr) == (
        "xlstm-350m", 8, 256, 3e-4)
    assert cfg_t.device is None
    # A mesh needs a world of ranks: build() lays it on the initialised
    # process group (train() spawns one); with none it raises, as the
    # reference's make_mesh does with too few devices.
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        build(TrainConfig(mesh_shape=(2, 2), device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(TrainConfig(smoke=True, steps=1, ckpt_dir=str(tmp_path)))


def test_train_main_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    main(["--arch", "whisper-base", "--smoke", "--steps", "2", "--batch", "2",
          "--seq-len", "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert "[train] done: final_loss=" in capsys.readouterr().out


# ----------------------------------------------------------- checkpoints
def _bf16_state():
    cfg = dataclasses.replace(get_smoke_config("internlm2-20b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    opt = adamw.init(params)
    opt.step.fill_(7)
    for t in tree_flatten(opt.m)[0]:
        t.normal_()
    return cfg, TrainState(params, opt)


def test_bf16_train_state_round_trips(tmp_path):
    """A save, then an in-place step, then a restore: the snapshot holds
    the state as it was at the save, bit for bit (the host copy is taken
    before ``save`` returns; the files are written in the background)."""
    cfg, state = _bf16_state()
    kept = tree_map(torch.clone, state)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state)
    batch = {k: torch.as_tensor(v) for k, v in _batch_np(cfg).items()}
    steps.make_train_step(cfg)(state.params, state.opt, batch)
    ck.wait()
    assert not torch.equal(state.params["head"]["w"], kept.params["head"]["w"])
    proto = tree_map(torch.zeros_like, kept)
    got, _, step = ck.restore(proto, device="cpu")
    assert step == 3 and isinstance(got, TrainState)
    for a, b in zip(tree_flatten(got)[0], tree_flatten(kept)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.params["embed"]["table"].dtype == torch.bfloat16
    raw, _, _ = ck.restore_raw()
    assert raw[".params/embed/table"].dtype == np.dtype("V2")


def _ref_bf16_state():
    rcfg = dataclasses.replace(ref_smoke("internlm2-20b"),
                               param_dtype="bfloat16")
    rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    return RefTrainState(rparams, ref_adamw.init(rparams))


def test_reference_bf16_checkpoint_restores_bit_equal(tmp_path):
    """The reference writes its bf16 leaves as |V2 (their bits); the port
    restores them bit-equal, and np.load gives the same bytes for either
    package's file."""
    rstate = _ref_bf16_state()
    RefCheckpointer(str(tmp_path / "ref"), async_save=False).save(4, rstate)
    proto = tree_map(torch.zeros_like, TrainState(
        *_state_from_reference(rstate.params)))
    proto = TrainState(tree_map(lambda t: t.bfloat16(), proto.params),
                       proto.opt)
    got, _, step = Checkpointer(str(tmp_path / "ref")).restore(proto,
                                                               device="cpu")
    assert step == 4
    for a, b in zip(jax.tree.leaves(rstate), tree_flatten(got)[0]):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)
    Checkpointer(str(tmp_path / "port"), async_save=False).save(4, got)
    ref_raw, _, _ = RefCheckpointer(str(tmp_path / "ref")).restore_raw()
    port_raw, _, _ = RefCheckpointer(str(tmp_path / "port")).restore_raw()
    assert sorted(ref_raw) == sorted(port_raw)
    for k, a in ref_raw.items():
        assert a.dtype == port_raw[k].dtype, k
        assert a.tobytes() == port_raw[k].tobytes(), k


def test_reference_restore_of_bf16_checkpoint_raises(tmp_path):
    """A fact about the reference: its ``restore`` casts a |V2 leaf with
    ``astype(bfloat16)``, which numpy has no cast for.  The port views the
    bits instead (above)."""
    rstate = _ref_bf16_state()
    RefCheckpointer(str(tmp_path), async_save=False).save(1, rstate)
    with pytest.raises(ValueError, match="cast"):
        RefCheckpointer(str(tmp_path)).restore(rstate)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_float32_train_state_crosses_packages(tmp_path, writer):
    rcfg = ref_smoke("internlm2-20b")
    rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    rstate = RefTrainState(rparams, ref_adamw.init(rparams))
    state = TrainState(*_state_from_reference(rparams))
    if writer == "repro":
        RefCheckpointer(str(tmp_path), async_save=False).save(2, rstate)
        got, _, _ = Checkpointer(str(tmp_path)).restore(
            tree_map(torch.zeros_like, state), device="cpu")
        pairs = zip(tree_flatten(got)[0], jax.tree.leaves(rstate))
    else:
        Checkpointer(str(tmp_path), async_save=False).save(2, state)
        got, _, _ = RefCheckpointer(str(tmp_path)).restore(rstate)
        pairs = zip(tree_flatten(state)[0], jax.tree.leaves(got))
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------- the guard
def _attn_inputs():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((1, 2, 128, 64)) * 0.3).astype(np.float32)


def _ssd_inputs():
    rng = np.random.default_rng(6)
    q = (rng.standard_normal((1, 2, 128, 16)) * 0.3).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((1, 2, 128))).astype(
        np.float32)
    return q, la


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret"])
def test_kernel_backends_refuse_autograd(backend):
    """In the port a kernel backend under autograd raises on the CPU too;
    under ``torch.no_grad()`` (or with detached operands) it runs."""
    q = torch.tensor(_attn_inputs(), requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        ops.attention(q, q, q, backend=backend)
    sq, sla = (torch.tensor(x, requires_grad=True) for x in _ssd_inputs())
    with pytest.raises(NotImplementedError, match="no gradient"):
        ops.ssd_scan(sq, sq, sq, sla, chunk=64, backend=backend)
    with torch.no_grad():
        a = ops.attention(q, q, q, backend=backend)
        y = ops.ssd_scan(sq, sq, sq, sla, chunk=64, backend=backend)
    ax = ops.attention(q, q, q, backend="xla")
    torch.testing.assert_close(a, ax.detach(), rtol=2e-3, atol=2e-3)
    assert y.shape == sq.shape and a.grad_fn is None
    # "xla" trains.
    (g,) = torch.autograd.grad(ax.sum(), [q])
    assert bool(torch.isfinite(g).all())
    y2 = ops.ssd_scan(sq.detach(), sq.detach(), sq.detach(), sla.detach(),
                      chunk=64, backend=backend)
    torch.testing.assert_close(y2, y)


def test_reference_kernel_backends_have_no_gradient():
    """A fact about the reference: ``jax.grad`` through its Pallas kernels
    (interpret mode on the CPU) raises — AssertionError in
    ``pallas_call``'s JVP rule for attention, ValueError (linearization
    failed) for the chunk scan — and both run without a gradient."""
    q = jnp.asarray(_attn_inputs())
    with pytest.raises(AssertionError):
        jax.grad(lambda x: ref_ops.attention(
            x, x, x, backend="pallas_interpret").sum())(q)
    sq, sla = (jnp.asarray(x) for x in _ssd_inputs())
    with pytest.raises(ValueError):
        jax.grad(lambda x: ref_ops.ssd_scan(
            x, x, x, sla, chunk=64, backend="pallas_interpret").sum())(sq)
    assert np.isfinite(np.asarray(ref_ops.attention(
        q, q, q, backend="pallas_interpret"))).all()


# ------------------------------------------------------ the meta structs
def _spec(tree):
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in tree_flatten(tree)[0]]


def _ref_spec(tree):
    return [(tuple(t.shape), str(t.dtype)) for t in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", list_archs())
def test_structs_match_reference(arch):
    """Every input of a step as meta tensors, leaf for leaf the reference's
    ``jax.eval_shape`` structs, with nothing allocated."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    rtrain, train_shape = ref_config.TRAIN_4K, config.TRAIN_4K
    rdec, dec_shape = ref_config.DECODE_32K, config.DECODE_32K
    rp = ref_steps.params_struct(rcfg)
    p = steps.params_struct(cfg)
    got = [p, steps.opt_state_struct(cfg, p),
           steps.batch_struct(cfg, train_shape),
           steps.decode_state_struct(cfg, dec_shape),
           steps.decode_inputs_struct(cfg, dec_shape)]
    want = [rp, ref_steps.opt_state_struct(rcfg, rp),
            ref_steps.batch_struct(rcfg, rtrain),
            ref_steps.decode_state_struct(rcfg, rdec),
            ref_steps.decode_inputs_struct(rcfg, rdec)]
    for g, w in zip(got, want):
        assert _spec(g) == _ref_spec(w)
        assert all(t.is_meta for t in tree_flatten(g)[0])
