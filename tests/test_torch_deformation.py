"""Port parity: ``repro_torch.core.deformation`` against ``repro.core.deformation``.

Every input is made with numpy from a seed and handed to both packages;
tolerance rtol=1e-5, atol=1e-6 (float32 arithmetic in two frameworks, whose
sums and products round in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.deformation as ref
import repro_torch.core.deformation as port

RTOL, ATOL = 1e-5, 1e-6
SEEDS = [0, 1, 2]


def _close(t, j):
    np.testing.assert_allclose(
        t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL
    )


def _defs(rng, batch=None, scale=3.0):
    shape = () if batch is None else (batch,)
    angle = rng.uniform(-0.1, 0.1, shape).astype(np.float32)
    shift = rng.uniform(-scale, scale, shape + (2,)).astype(np.float32)
    return {"angle": angle, "shift": shift}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _img(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_rotation_matrix(seed):
    a = np.random.default_rng(seed).uniform(-3, 3, ()).astype(np.float32)
    _close(port.rotation_matrix(torch.tensor(a)), ref.rotation_matrix(jnp.asarray(a)))


@pytest.mark.parametrize("seed", SEEDS)
def test_compose(seed):
    rng = np.random.default_rng(seed)
    a, b = _defs(rng), _defs(rng)
    got = port.compose(_t(a), _t(b))
    want = ref.compose(_j(a), _j(b))
    for k in ("angle", "shift"):
        _close(got[k], want[k])


@pytest.mark.parametrize("seed", SEEDS)
def test_compose_batched(seed):
    rng = np.random.default_rng(seed)
    a, b = _defs(rng, 7), _defs(rng, 7)
    got = port.compose_batched(_t(a), _t(b))
    want = ref.compose_batched(_j(a), _j(b))
    for k in ("angle", "shift"):
        _close(got[k], want[k])
    # the batched compose equals the per-element compose
    per = jax.vmap(ref.compose)(_j(a), _j(b))
    for k in ("angle", "shift"):
        _close(got[k], per[k])


def test_compose_batched_declares_monoid():
    assert port.compose_batched.op_batchable is True
    ident = port.compose_batched.op_identity()
    assert set(ident) == {"angle", "shift"}
    d = _t(_defs(np.random.default_rng(5)))
    out = port.compose_batched(ident, d)
    for k in d:
        torch.testing.assert_close(out[k], d[k])


@pytest.mark.parametrize("seed", SEEDS)
def test_inverse(seed):
    d = _defs(np.random.default_rng(seed))
    got = port.inverse(_t(d))
    want = ref.inverse(_j(d))
    for k in ("angle", "shift"):
        _close(got[k], want[k])


@pytest.mark.parametrize("seed", SEEDS)
def test_bilinear_sample(seed):
    rng = np.random.default_rng(seed)
    img = _img(rng, 24, 20)
    # Coordinates inside, on and well past the border (edge clamping).
    coords = rng.uniform(-6.0, 30.0, (9, 11, 2)).astype(np.float32)
    got = port._bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords))
    want = ref._bilinear_sample(jnp.asarray(img), jnp.asarray(coords))
    _close(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(32, 32), (40, 24)])
def test_warp(seed, shape):
    rng = np.random.default_rng(seed)
    img = _img(rng, *shape)
    d = _defs(rng)
    _close(port.warp(torch.from_numpy(img), _t(d)), ref.warp(jnp.asarray(img), _j(d)))


def test_warp_batched_matches_per_frame():
    """The batch axis written out: a batched warp is the per-frame warps,
    bit for bit, and each matches the reference's warp of that frame."""
    rng = np.random.default_rng(3)
    imgs = _img(rng, 4, 32, 32)
    d = _defs(rng, 4)
    got = port.warp(torch.from_numpy(imgs), _t(d))
    for i in range(4):
        di = {k: v[i] for k, v in d.items()}
        torch.testing.assert_close(
            got[i], port.warp(torch.from_numpy(imgs[i]), _t(di)),
            rtol=0, atol=0,
        )
        _close(got[i], ref.warp(jnp.asarray(imgs[i]), _j(di)))


@pytest.mark.parametrize("seed", SEEDS)
def test_ncc(seed):
    rng = np.random.default_rng(seed)
    a = _img(rng, 32, 32)
    b = a + 0.5 * _img(rng, 32, 32)
    _close(port.ncc(torch.from_numpy(a), torch.from_numpy(b)),
           ref.ncc(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("seed", SEEDS)
def test_ncc_distance(seed):
    rng = np.random.default_rng(seed)
    r, t = _img(rng, 32, 32), _img(rng, 32, 32)
    d = _defs(rng)
    _close(port.ncc_distance(torch.from_numpy(r), torch.from_numpy(t), _t(d)),
           ref.ncc_distance(jnp.asarray(r), jnp.asarray(t), _j(d)))


@pytest.mark.parametrize("shape", [(32, 32), (33, 18)])
def test_downsample2(shape):
    img = _img(np.random.default_rng(4), *shape)
    _close(port.downsample2(torch.from_numpy(img)), ref.downsample2(jnp.asarray(img)))


def test_identity_and_make_deformation():
    ident = port.identity_deformation()
    assert ident["angle"].shape == () and ident["shift"].shape == (2,)
    assert float(ident["angle"]) == 0.0 and ident["shift"].abs().sum() == 0
    d = port.make_deformation(0.25, [1.0, -2.0])
    assert d["angle"].dtype == torch.float32 and d["shift"].dtype == torch.float32
    _close(d["shift"], ref.make_deformation(0.25, [1.0, -2.0])["shift"])


def test_warp_gradient_matches_jax():
    """Function A differentiates warp+NCC w.r.t. the deformation."""
    rng = np.random.default_rng(6)
    r, t = _img(rng, 32, 32), _img(rng, 32, 32)
    d = _defs(rng, scale=1.0)
    want = jax.grad(lambda dd: ref.ncc_distance(jnp.asarray(r), jnp.asarray(t), dd))(_j(d))
    leaves = {k: v.requires_grad_(True) for k, v in _t(d).items()}
    loss = port.ncc_distance(torch.from_numpy(r), torch.from_numpy(t), leaves)
    g_angle, g_shift = torch.autograd.grad(loss, [leaves["angle"], leaves["shift"]])
    np.testing.assert_allclose(g_angle.numpy(), np.asarray(want["angle"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_shift.numpy(), np.asarray(want["shift"]), rtol=1e-4, atol=1e-5)
