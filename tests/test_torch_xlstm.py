"""xLSTM in the port against the reference: the mLSTM and sLSTM blocks,
and the SSD chunk kernels' plain versions at the mLSTM's head dim of 256.

The blocks get the reference's weights (``interop.params_from_numpy``) and
seeded numpy inputs.  Tolerances: the chunk kernels' plain versions
against the reference's kernels in interpret mode at the reference's
kernel-oracle tolerance (rtol 1e-4, atol 1e-5, ``tests/test_kernels.py:
58-74``, as ``tests/test_torch_chunk_scan.py``); the blocks, whose outputs
are normalised and projected in float32, at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.kernels import chunk_scan as ref_cs
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import chunk_scan as cs
from repro_torch.models import ssm

ARCH = "xlstm-350m"
BACKENDS = [("xla", "xla"), ("pallas", "pallas_interpret")]
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(tb, rb):
    return (dataclasses.replace(get_smoke_config(ARCH), attn_backend=tb,
                                ssm_backend=tb),
            dataclasses.replace(ref_get_smoke(ARCH), attn_backend=rb,
                                ssm_backend=rb))


def _x(b, l, d, seed):
    return (np.random.default_rng(seed).normal(size=(b, l, d)) * 0.5).astype(
        np.float32)


def _close(t, r, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), rtol=tol,
                               atol=tol)


def test_full_config_runs_the_chunk_scan_at_head_dim_256():
    """The mLSTM's ssd_scan runs at dk = dv = ssm_head_dim = 1024 / 4."""
    cfg = get_config(ARCH)
    assert cfg.ssm_head_dim == ref_get_config(ARCH).ssm_head_dim == 256
    assert cs.MAX_D >= cfg.ssm_head_dim


def _chunk_np(g, l, dk, dv, seed, log_a_shift=0.0):
    """The reference's kernel-test inputs; the decay is log_sigmoid-like,
    -softplus(N + shift), as the mLSTM's forget gates give."""
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(g, l, dk)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(g, l, dk)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(g, l, dv)) * 0.5).astype(np.float32)
    la = -np.logaddexp(0.0, rng.normal(size=(g, l)) + log_a_shift)
    ca = np.cumsum(la, axis=-1).astype(np.float32)[..., None]
    return c, b, v, ca


@pytest.mark.parametrize("log_a_shift", [0.0, -2.0])
@pytest.mark.parametrize("dk,dv", [(256, 256), (256, 64), (64, 256)])
def test_chunk_kernels_at_head_dim_256_match_reference_kernels(dk, dv,
                                                               log_a_shift):
    g, l = 2, 128
    c, b, v, ca = _chunk_np(g, l, dk, dv, seed=dk + dv, log_a_shift=log_a_shift)
    y_r, s_r = ref_cs.chunk_local(*(jnp.asarray(a) for a in (c, b, v, ca)),
                                  interpret=True)
    y, s = cs.chunk_local(*(torch.from_numpy(a) for a in (c, b, v, ca)))
    assert y.shape == (g, l, dv) and s.shape == (g, dk, dv)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-4, atol=1e-5)
    sp = np.random.default_rng(9).normal(size=(g, dk, dv)).astype(np.float32)
    o_r = ref_cs.chunk_apply(*(jnp.asarray(a) for a in (c, ca, y_r, sp)),
                             interpret=True)
    o = cs.chunk_apply(*(torch.from_numpy(np.array(a))
                         for a in (c, ca, y_r, sp)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=1e-4, atol=1e-5)


def test_chunk_kernel_wrappers_refuse_head_dims_above_256():
    """The kernels' argument check, which a wrapper runs before it
    launches, refuses dk or dv above MAX_D."""
    with pytest.raises(ValueError, match="multiple of 8"):
        cs._check_kernel_args("chunk_local", 128, 264, 256, (), ())
    with pytest.raises(ValueError, match="multiple of 8"):
        cs._check_kernel_args("chunk_apply", 128, 256, 260, (), ())


@pytest.fixture(scope="module")
def mlstm_params():
    rp = ref_ssm.mlstm_init(jax.random.PRNGKey(3), ref_get_smoke(ARCH))
    return rp, params_from_numpy(jax.device_get(rp))


@pytest.mark.parametrize("tb,rb", BACKENDS)
def test_mlstm_block_matches_reference(mlstm_params, tb, rb):
    """mlstm_apply, mlstm_prefill (output and final (C, n) state) and
    mlstm_decode steps from that state."""
    rp, tp = mlstm_params
    tcfg, rcfg = _cfgs(tb, rb)
    x = _x(2, 64, tcfg.d_model, seed=5)
    _close(ssm.mlstm_apply(tp, tcfg, torch.from_numpy(x)),
           ref_ssm.mlstm_apply(rp, rcfg, jnp.asarray(x)))
    rs = ref_ssm.mlstm_state_init(rcfg, 2)
    ts = ssm.mlstm_state_init(tcfg, 2)
    ry, rs = ref_ssm.mlstm_prefill(rp, rcfg, jnp.asarray(x), rs)
    ty, ts = ssm.mlstm_prefill(tp, tcfg, torch.from_numpy(x), ts)
    _close(ty, ry)
    for key in ("C", "n"):
        _close(ts[key], rs[key])
    for t in range(3):
        x1 = _x(2, 1, tcfg.d_model, seed=6 + t)
        ry, rs = ref_ssm.mlstm_decode(rp, rcfg, jnp.asarray(x1), rs)
        ty, ts = ssm.mlstm_decode(tp, tcfg, torch.from_numpy(x1), ts)
        _close(ty, ry)
        _close(ts["C"], rs["C"])


def test_mlstm_decode_continues_the_prefill(mlstm_params):
    """Prefill of x[:t] then decode steps give mlstm_apply's outputs at the
    same positions: the final (C, n) state carries the whole prefix."""
    _, tp = mlstm_params
    cfg = get_smoke_config(ARCH)
    x = torch.from_numpy(_x(2, 32, cfg.d_model, seed=8))
    full = ssm.mlstm_apply(tp, cfg, x)
    _, st = ssm.mlstm_prefill(tp, cfg, x[:, :28], ssm.mlstm_state_init(cfg, 2))
    for t in range(28, 32):
        y, st = ssm.mlstm_decode(tp, cfg, x[:, t:t + 1], st)
        torch.testing.assert_close(y[:, 0], full[:, t], rtol=TOL, atol=TOL)


def test_mlstm_normalizer_survives_fast_decay():
    """The normaliser as a scan of one-step gates stays finite and matches a
    float64 recurrence where the cumulative decay underflows float32 (a
    cumsum(k / cumprod(f)) form gives inf and NaN there)."""
    rng = np.random.default_rng(10)
    b, h, l, dk = 1, 2, 256, 8
    log_f = np.full((b, h, l), -1.5, np.float32)
    k = rng.normal(size=(b, h, l, dk)).astype(np.float32)
    assert np.exp(np.cumsum(log_f, -1, dtype=np.float32))[..., -1].max() == 0.0
    n = ssm._mlstm_normalizer(torch.from_numpy(log_f), torch.from_numpy(k))
    want = np.zeros((b, h, l, dk))
    acc = np.zeros((b, h, dk))
    for t in range(l):
        acc = np.exp(log_f[..., t].astype(np.float64))[..., None] * acc + k[:, :, t]
        want[:, :, t] = acc
    assert bool(torch.isfinite(n).all())
    np.testing.assert_allclose(n.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def slstm_params():
    rp = ref_ssm.slstm_init(jax.random.PRNGKey(4), ref_get_smoke(ARCH))
    return rp, params_from_numpy(jax.device_get(rp))


def test_slstm_block_matches_reference(slstm_params):
    """slstm_apply (output and final state; the reference's lax.scan over
    time as a Python loop) and slstm_decode steps from that state, with
    inputs large enough that the bounded exp input gate and the
    max(n, 1e-3) floor act."""
    rp, tp = slstm_params
    tcfg, rcfg = _cfgs("xla", "xla")
    x = _x(2, 48, tcfg.d_model, seed=11) * 6.0
    _close(slstm_out := ssm.slstm_apply(tp, tcfg, torch.from_numpy(x)),
           ref_ssm.slstm_apply(rp, rcfg, jnp.asarray(x)))
    assert bool(torch.isfinite(slstm_out).all())
    ry, rs = ref_ssm.slstm_apply(rp, rcfg, jnp.asarray(x), return_state=True)
    ty, ts = ssm.slstm_apply(tp, tcfg, torch.from_numpy(x), return_state=True)
    _close(ty, ry)
    for key in ("h", "c", "n"):
        _close(ts[key], rs[key])
    for t in range(3):
        x1 = _x(2, 1, tcfg.d_model, seed=12 + t)
        ry, rs = ref_ssm.slstm_decode(rp, rcfg, jnp.asarray(x1), rs)
        ty, ts = ssm.slstm_decode(tp, tcfg, torch.from_numpy(x1), ts)
        _close(ty, ry)
        _close(ts["h"], rs["h"])


def test_slstm_cell_matches_reference(slstm_params):
    rp, tp = slstm_params
    tcfg, rcfg = _cfgs("xla", "xla")
    d, nh = tcfg.d_model, tcfg.n_heads
    rng = np.random.default_rng(13)
    wx = (rng.normal(size=(3, 4 * d)) * 8.0).astype(np.float32)
    st = {k: (rng.uniform(0.0, 2.0, size=(3, nh, d // nh))).astype(np.float32)
          for k in ("h", "c", "n")}
    st["n"][0] = 0.0          # the max(n, 1e-3) floor
    rout = ref_ssm._slstm_cell(rp, rcfg, jnp.asarray(wx),
                               {k: jnp.asarray(v) for k, v in st.items()})
    tout = ssm._slstm_cell(tp, tcfg, torch.from_numpy(wx),
                           {k: torch.from_numpy(v) for k, v in st.items()})
    for key in ("h", "c", "n"):
        _close(tout[key], rout[key])
