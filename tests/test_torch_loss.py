"""The port's training loss against the reference's: ``lm.loss_fn`` and its
gradients for every smoke configuration (the reference's
``jax.value_and_grad(lm.loss_fn, has_aux=True)``), the vocab-chunked cross
entropy against the materialized one, and remat against none.  Parameters
are the reference's, carried across with ``interop.params_from_numpy``;
batches are numpy from a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.configs import list_archs
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro_torch.configs import get_smoke_config
from repro_torch.core._tree import tree_flatten, tree_unflatten
from repro_torch.interop import params_from_numpy
from repro_torch.models import layers, lm

# Loss, ce and aux: rtol 1e-5.  Gradients: relative norm error a leaf.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# xLSTM's mLSTM blocks: each block's forward differs from the reference's by
# ~5e-6 (the chunk scan's exp of cumulative log-gates, summed in another
# order), and the model's backward amplifies such differences ~100x: a 1e-7
# relative perturbation of the port's own params moves its grads by 1e-5.
# Block by block, with the reference's inputs and upstream gradient, every
# block's backward agrees within 1.5e-6; through the whole model 1.4e-4.
GRAD_RTOL_BY_ARCH = {"xlstm_350m": 5e-4}


def _batch_np(cfg, b=2, l=64, seed=0):
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32),
    }
    key = {"patch": "patches", "audio": "frames"}.get(cfg.frontend)
    if key is not None:
        batch[key] = (rng.standard_normal((b, cfg.frontend_len, cfg.d_model))
                      * 0.1).astype(np.float32)
    return batch


def _port_value_and_grad(params, cfg, batch):
    leaves, treedef = tree_flatten(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss, metrics = lm.loss_fn(tree_unflatten(treedef, live), cfg, batch)
    return loss, metrics, torch.autograd.grad(loss, live)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = b.detach().float().numpy()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_grads_match_reference(arch):
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    rparams = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    batch = _batch_np(rcfg)
    (rloss, rmet), rgrads = jax.jit(
        jax.value_and_grad(ref_lm.loss_fn, has_aux=True), static_argnums=1
    )(rparams, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})

    params = params_from_numpy(jax.device_get(rparams))
    loss, met, grads = _port_value_and_grad(
        params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(rloss),
                               rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(met[k]), float(rmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    # jax.tree.leaves orders dict keys as tree_flatten does.
    rleaves = jax.tree.leaves(rgrads)
    assert len(rleaves) == len(grads)
    tol = GRAD_RTOL_BY_ARCH.get(arch, GRAD_RTOL)
    errs = [_rel(a, b) for a, b in zip(rleaves, grads)]
    assert max(errs) < tol, (arch, max(errs))
    for a, b in zip(rleaves, grads):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32


@pytest.mark.parametrize("ignore", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunked_ce_matches_materialized(ignore, softcap):
    """The online logsumexp over vocabulary chunks equals the cross entropy
    of ``head_logits``, with and without ignored labels, and equals the
    reference's chunked CE; its grads equal the materialized one's."""
    rng = np.random.default_rng(3)
    nc, d, vc, b, l = 4, 16, 32, 2, 24
    w = (rng.standard_normal((nc, d, vc)) * 0.5).astype(np.float32)
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    labels = rng.integers(0, nc * vc, (b, l)).astype(np.int32)
    if ignore:
        labels[0, :7] = -1
        labels[1, -3:] = -1

    def port(fn):
        xt = torch.tensor(x, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        loss = fn({"w": wt}, xt, torch.as_tensor(labels))
        return loss, torch.autograd.grad(loss, [xt, wt])

    chunked, g_chunked = port(lambda p, xt, lt: layers.chunked_cross_entropy(
        p, xt, lt, softcap=softcap))
    plain, g_plain = port(lambda p, xt, lt: layers.softmax_cross_entropy(
        layers.head_logits(p, xt, softcap), lt))
    ref = ref_layers.chunked_cross_entropy({"w": jnp.asarray(w)},
                                           jnp.asarray(x), jnp.asarray(labels),
                                           softcap=softcap)
    ref_plain = ref_layers.softmax_cross_entropy(
        ref_layers.head_logits({"w": jnp.asarray(w)}, jnp.asarray(x),
                               softcap), jnp.asarray(labels))
    np.testing.assert_allclose(float(chunked), float(plain), rtol=1e-6)
    np.testing.assert_allclose(float(chunked), float(ref), rtol=1e-6)
    np.testing.assert_allclose(float(plain), float(ref_plain), rtol=1e-6)
    for a, b in zip(g_chunked, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_ce_of_only_ignored_labels_is_zero():
    """``max(mask.sum(), 1)``: a batch of ignored labels gives 0, not NaN."""
    w = torch.randn(2, 8, 16)
    x = torch.randn(1, 3, 8)
    labels = torch.full((1, 3), -1)
    assert float(layers.chunked_cross_entropy({"w": w}, x, labels)) == 0.0
    assert float(layers.softmax_cross_entropy(
        layers.head_logits({"w": w}, x), labels)) == 0.0


def test_unembed_matches_reference():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((40, 8)).astype(np.float32)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    for cap in (0.0, 5.0):
        want = ref_layers.unembed({"table": jnp.asarray(table)},
                                  jnp.asarray(x), cap)
        got = layers.unembed({"table": torch.tensor(table)}, torch.tensor(x),
                             cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ["zamba2_7b", "phi3_5_moe_42b"])
def test_remat_gives_equal_loss_and_grads(arch):
    """Checkpointed superblocks (``cfg.remat``) recompute exactly what the
    first pass computed: the MoE's top-k routes the same tokens again."""
    cfg = get_smoke_config(arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.as_tensor(v) for k, v in _batch_np(cfg).items()}
    out = [_port_value_and_grad(params, dataclasses.replace(cfg, remat=r),
                                batch) for r in (True, False)]
    (l1, m1, g1), (l2, m2, g2) = out
    assert torch.equal(l1, l2) and torch.equal(m1["aux"], m2["aux"])
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
