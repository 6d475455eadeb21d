"""The port's MoE layer and ``moe`` blocks against the reference, on the
smoke configs of phi3.5-moe-42b and arctic-480b, with the reference's
weights carried across by ``interop.params_from_numpy``.

Tolerances: the layer and its aux loss 1e-5 (the reference has no test of
its own for the layer; 1e-5 is its unrolled-layers tolerance,
``tests/test_models.py:151``); prefill logits 2e-2 and decode logits 3e-2
(``tests/test_models.py:99, :106``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import blocks as ref_blocks
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.interop import params_from_numpy
from repro_torch.models import blocks, lm, moe

PHI = "phi3.5-moe-42b-a6.6b"
ARCTIC = "arctic-480b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, **kw):
    return (dataclasses.replace(configs.get_smoke_config(arch), **kw),
            dataclasses.replace(ref_get_smoke(arch), **kw))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _capacity(cfg, t):
    """The reference's capacity for t tokens (``moe.py:61``)."""
    g_size = min(cfg.moe_group_size, t)
    return int(g_size * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1


def _moe_pair(arch, x, seed=1, **kw):
    """The reference's and the port's moe_apply on the same weights and x."""
    tcfg, rcfg = _cfgs(arch, **kw)
    rp = ref_moe.moe_init(jax.random.PRNGKey(seed), rcfg)
    tp = params_from_numpy(jax.device_get(rp))
    ry, raux = ref_moe.moe_apply(rp, rcfg, jnp.asarray(x))
    ty, taux = moe.moe_apply(tp, tcfg, torch.from_numpy(x))
    return (np.asarray(ry), float(raux)), (ty.numpy(), float(taux)), rp


@pytest.mark.parametrize("arch", [PHI, ARCTIC])
@pytest.mark.parametrize("case", ["groups", "drops", "decode"])
def test_moe_apply_matches_reference(arch, case):
    """Two groups of 64 tokens at the config's capacity factor; the same at
    0.25, where the queues overflow and choices are dropped; and a decode
    step's group of 4 tokens over 16 experts, whose capacity is 1."""
    kw, shape = {}, (2, 64, 64)
    if case == "drops":
        kw = {"capacity_factor": 0.25}
    elif case == "decode":
        kw, shape = {"n_experts": 16}, (4, 1, 64)
    x = _x(shape, seed=len(case))
    (ry, raux), (ty, taux), _ = _moe_pair(arch, x, **kw)
    assert ty.shape == x.shape and ty.dtype == np.float32
    np.testing.assert_allclose(ty, ry, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux, raux, rtol=1e-5, atol=1e-5)
    if case != "groups":
        # Choices really were dropped: the same tokens with room for all
        # of them give another output.
        roomy = dict(kw, capacity_factor=16.0)
        (ry2, _), (ty2, _), _ = _moe_pair(arch, x, **roomy)
        np.testing.assert_allclose(ty2, ry2, rtol=1e-5, atol=1e-5)
        assert np.abs(ty2 - ty).max() > 1e-3


def test_moe_decode_group_keeps_one_token_an_expert():
    """4 decode tokens over 16 experts: capacity 1, so of two tokens that
    pick the same expert the later choice is dropped, as the reference
    drops it.  The port's output equals a dispatch by hand that keeps the
    first (token, choice) of each expert in the flattened (s, k) order."""
    tcfg, _ = _cfgs(PHI, n_experts=16)
    assert _capacity(tcfg, 4) == 1
    x = _x((4, 1, 64), seed=7)
    (ry, _), (ty, _), rp = _moe_pair(PHI, x, n_experts=16)
    np.testing.assert_allclose(ty, ry, rtol=1e-5, atol=1e-5)
    tp = params_from_numpy(jax.device_get(rp))
    xt = torch.from_numpy(x).reshape(4, 64)
    probs = torch.softmax(xt @ tp["router"]["w"], -1)
    gates, idx = torch.topk(probs, 2, -1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    want = torch.zeros_like(xt)
    taken = set()
    for s in range(4):
        for c in range(2):
            e = int(idx[s, c])
            if e in taken:
                continue
            taken.add(e)
            h = moe.silu(xt[s] @ tp["w1"][e]) * (xt[s] @ tp["w3"][e])
            want[s] += gates[s, c] * (h @ tp["w2"][e])
    assert len(taken) < 8          # this draw does drop a choice
    np.testing.assert_allclose(ty.reshape(4, 64), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", [PHI, ARCTIC])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_moe_block_matches_reference(arch, mode):
    """One ``moe`` block (attention, the MoE layer and, for arctic, the
    dense residual MLP beside it) in each mode, to 1e-5, with its aux
    loss."""
    tcfg, rcfg = _cfgs(arch)
    rp = ref_blocks.block_init(jax.random.PRNGKey(3), rcfg, "moe")
    tp = params_from_numpy(jax.device_get(rp))
    assert ("dense_mlp" in tp) == (arch == ARCTIC)
    b, l = 2, 32
    x = _x((b, l, rcfg.d_model), seed=4, scale=0.5)
    kw_r, kw_t = {}, {}
    if mode != "train":
        kw_r["state"] = ref_blocks.block_state_init(rcfg, "moe", b, l + 4)
        kw_t["state"] = blocks.block_state_init(tcfg, "moe", b, l + 4)
    if mode == "decode":
        x = x[:, :1]
        kw_r["pos"], kw_t["pos"] = jnp.int32(3), 3
    else:
        kw_r["positions"] = jnp.arange(l)
        kw_t["positions"] = torch.arange(l)
    ry, rst, raux = ref_blocks.block_apply(rp, rcfg, "moe", jnp.asarray(x),
                                           mode=mode, **kw_r)
    ty, tst, taux = blocks.block_apply(tp, tcfg, "moe", torch.from_numpy(x),
                                       mode=mode, **kw_t)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5, atol=1e-5)
    if mode != "train":
        for k in ("k", "v"):
            # arctic's smoke cache is bf16: k and v agree to 1e-5 before
            # the cache rounds them, so to one bf16 step (at most 2^-7
            # of the value) after.
            tol = 1e-5 if tst[k].dtype == torch.float32 else 2.0 ** -7
            np.testing.assert_allclose(tst[k].float().numpy(),
                                       np.asarray(rst[k], np.float32),
                                       rtol=tol, atol=1e-5)


def test_moe_router_balancing_loss():
    """tests/test_models.py::test_moe_router_balancing_loss on the port:
    the Switch aux loss is ~1 a layer for a balanced router, >= 1
    otherwise; and it is the reference's on the same weights."""
    tcfg, rcfg = _cfgs(PHI)
    rp = ref_lm.init_params(jax.random.PRNGKey(0), rcfg)
    tp = params_from_numpy(jax.device_get(rp))
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size, (2, 64))
    _, aux = lm.forward_train(tp, tcfg,
                              {"tokens": torch.from_numpy(toks).long()})
    assert 0.5 < float(aux) / tcfg.n_layers < 4.0
    _, raux = ref_lm.forward_train(rp, rcfg,
                                   {"tokens": jnp.asarray(toks, jnp.int32)})
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    # A port-drawn model balances as well.
    p = lm.init_params(torch.Generator().manual_seed(0), tcfg)
    _, aux = lm.forward_train(p, tcfg, {"tokens": torch.from_numpy(toks).long()})
    assert 0.5 < float(aux) / tcfg.n_layers < 4.0


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", [PHI, ARCTIC])
def test_prefill_decode_matches_forward(arch, backend):
    """tests/test_models.py::test_prefill_decode_matches_forward for the
    MoE configs on the port, at the reference's no-drop capacity factor
    8.0: prefill(x[:t]) + decode steps reproduce forward_train's logits."""
    tcfg, rcfg = _cfgs(arch, capacity_factor=8.0, attn_backend=backend)
    rp = ref_lm.init_params(jax.random.PRNGKey(1), rcfg)
    tp = params_from_numpy(jax.device_get(rp))
    b, l = 2, 32
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (b, l))).long()
    full, _ = lm.forward_train(tp, tcfg, {"tokens": tokens})
    n_pre = l - 4
    states = lm.init_decode_states(tcfg, b, l + 4)
    lg, states = lm.prefill(tp, tcfg, {"tokens": tokens[:, :n_pre]}, states)
    torch.testing.assert_close(lg[:, 0], full[:, n_pre - 1], rtol=2e-2,
                               atol=2e-2)
    for t in range(n_pre, l):
        lg, states = lm.decode_step(tp, tcfg, tokens[:, t:t + 1], t, states)
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=3e-2, atol=3e-2)
