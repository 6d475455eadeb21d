"""The port's AdamW (``optim/adamw.py``): the counterparts of the
optimizer cases of ``tests/test_substrate.py``, and ``update`` and
``cosine_schedule`` held to the reference's on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro_torch.core._tree import tree_map
from repro_torch.optim import adamw


def test_adamw_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params, cfg)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        params, state, _ = adamw.update({"w": g}, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 2.0], atol=1e-2)


def test_adamw_clipping_and_metrics():
    cfg = adamw.AdamWConfig(lr=1e-3, clip_norm=1.0)
    params = {"w": torch.ones((4,))}
    before = params["w"].clone()
    state = adamw.init(params, cfg)
    g = {"w": torch.full((4,), 100.0)}
    new_params, state, m = adamw.update(g, state, params, cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    delta = (new_params["w"] - before).abs().max()
    assert float(delta) < 0.01  # clipped step is tiny


def test_adamw_bf16_params_master_fp32():
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0)
    params = {"w": torch.ones((8,), dtype=torch.bfloat16)}
    state = adamw.init(params, cfg)
    for _ in range(20):
        g = {"w": torch.full((8,), 1e-3, dtype=torch.bfloat16)}
        params, state, _ = adamw.update(g, state, params, cfg)
    assert params["w"].dtype == torch.bfloat16
    assert state.master["w"].dtype == torch.float32
    # master accumulates updates below bf16 resolution
    assert float(state.master["w"][0]) != 1.0


def test_cosine_schedule():
    s = adamw.cosine_schedule(torch.arange(0, 1000), warmup=100, total=1000)
    s = s.numpy()
    assert s[0] == 0.0 and abs(s[100] - 1.0) < 0.02
    assert s[-1] <= s[200]
    want = ref_adamw.cosine_schedule(jnp.arange(0, 1000), warmup=100,
                                     total=1000)
    np.testing.assert_allclose(s, np.asarray(want), rtol=1e-6, atol=1e-7)


def test_update_is_in_place():
    """``update`` writes params, m, v, master and the step counter where
    they are (the reference's donated step); it returns the same trees."""
    params = {"w": torch.ones((3,), dtype=torch.bfloat16)}
    state = adamw.init(params)
    ptrs = [params["w"].data_ptr(), state.m["w"].data_ptr(),
            state.v["w"].data_ptr(), state.master["w"].data_ptr(),
            state.step.data_ptr()]
    new_p, new_s, _ = adamw.update({"w": torch.ones((3,))}, state, params)
    assert new_p is params and new_s is state and int(state.step) == 1
    assert ptrs == [params["w"].data_ptr(), state.m["w"].data_ptr(),
                    state.v["w"].data_ptr(), state.master["w"].data_ptr(),
                    state.step.data_ptr()]
    assert float(state.m["w"][0]) != 0.0


def _ref_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("keep_master", [True, False])
def test_update_matches_reference_on_bf16_params(keep_master):
    """Five steps of ``update`` on bf16 params with bf16 grads, clipping on
    (grad norm above 1) and a scheduled lr: params bit-equal, and m, v,
    master, grad norm and lr within 1e-6 of the reference's."""
    cfg = adamw.AdamWConfig(lr=3e-2, keep_master=keep_master)
    rcfg = ref_adamw.AdamWConfig(lr=3e-2, keep_master=keep_master)
    rng = np.random.default_rng(0)
    p_np = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((11,)).astype(np.float32)}}
    params = tree_map(lambda x: torch.tensor(x).bfloat16(), p_np)
    rparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), p_np)
    state, rstate = adamw.init(params, cfg), ref_adamw.init(rparams, rcfg)
    for i in range(5):
        g_np = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * 0.7).astype(np.float32),
            p_np)
        grads = tree_map(lambda x: torch.tensor(x).bfloat16(), g_np)
        rgrads = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g_np)
        sched = adamw.cosine_schedule(state.step, warmup=2, total=10)
        rsched = ref_adamw.cosine_schedule(rstate.step, warmup=2, total=10)
        params, state, m = adamw.update(grads, state, params, cfg, sched)
        rparams, rstate, rm = ref_adamw.update(rgrads, rstate, rparams, rcfg,
                                               rsched)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-6)
        assert int(state.step) == int(rstate.step) == i + 1
        for got, want in zip(jax.tree.leaves(tree_map(
                lambda t: t.float().numpy(), params)),
                jax.tree.leaves(rparams)):
            np.testing.assert_array_equal(got, np.asarray(want, np.float32))
        trees = [(state.m, rstate.m), (state.v, rstate.v)]
        if keep_master:
            trees.append((state.master, rstate.master))
        for tree, rtree in trees:
            for got, want in zip(jax.tree.leaves(tree_map(
                    lambda t: t.numpy(), tree)), jax.tree.leaves(rtree)):
                np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                           atol=1e-7)
