"""The SSD chunk kernels' plain versions and ``ops.ssd_scan`` against the
reference's Pallas kernels in interpret mode and its oracles.

Inputs are made with numpy from a seed and fed to both packages.  The
tolerances are the reference's own (``tests/test_kernels.py``): rtol 1e-4,
atol 1e-5 for the kernels against their oracles (:58-74); 2e-4 in float32
and 2e-2 in bfloat16 for ``ssd_scan`` against the recurrence (:32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chunk_scan as ref_cs
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import chunk_scan as cs
from repro_torch.kernels import ops
from repro_torch.kernels import ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chunk_np(g, l, dk, dv, seed, log_a_shift=0.0):
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(g, l, dk)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(g, l, dk)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(g, l, dv)) * 0.5).astype(np.float32)
    la = -np.logaddexp(0.0, rng.normal(size=(g, l)) + log_a_shift)
    ca = np.cumsum(la, axis=-1).astype(np.float32)[..., None]
    return c, b, v, ca


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


# The odd shapes are those the CUDA kernels pad (L to 64 or 128 rows, dk and
# dv to multiples of 16): on the card they are held to these plain versions.
_ODD_SHAPES = [(3, 65, 32, 64), (2, 100, 112, 40), (2, 128, 8, 128),
               (4, 1, 16, 16)]


@pytest.mark.parametrize("g,l,dk,dv", [(4, 128, 32, 64), (3, 64, 16, 32),
                                       (2, 128, 64, 112), *_ODD_SHAPES])
def test_chunk_local_matches_reference_kernel(g, l, dk, dv):
    c, b, v, ca = _chunk_np(g, l, dk, dv, seed=g + l)
    y_r, s_r = ref_cs.chunk_local(*(jnp.asarray(a) for a in (c, b, v, ca)),
                                  interpret=True)
    y, s = cs.chunk_local(*_t(c, b, v, ca))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("g,l,dk,dv", [(3, 64, 16, 32), (2, 128, 64, 64),
                                       *_ODD_SHAPES])
def test_chunk_apply_matches_reference_kernel(g, l, dk, dv):
    c, _b, v, ca = _chunk_np(g, l, dk, dv, seed=7)
    rng = np.random.default_rng(8)
    sp = rng.normal(size=(g, dk, dv)).astype(np.float32)
    y_r = ref_cs.chunk_apply(*(jnp.asarray(a) for a in (c, ca, v, sp)),
                             interpret=True)
    y = cs.chunk_apply(*_t(c, ca, v, sp))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-4, atol=1e-5)


def test_chunk_kernels_match_reference_kernels_under_slow_decay():
    """Decay of ~0.18 a step (Mamba2's dt bias of -2): terms far below the
    diagonal and every row of the state summary carry weight."""
    g, l, dk, dv = 3, 128, 32, 64
    c, b, v, ca = _chunk_np(g, l, dk, dv, seed=11, log_a_shift=-2.0)
    assert float(np.exp(ca[:, -1] - ca[:, 0]).min()) > 1e-12
    y_r, s_r = ref_cs.chunk_local(*(jnp.asarray(a) for a in (c, b, v, ca)),
                                  interpret=True)
    y, s = cs.chunk_local(*_t(c, b, v, ca))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-4, atol=1e-5)
    sp = np.random.default_rng(12).normal(size=(g, dk, dv)).astype(np.float32)
    o_r = ref_cs.chunk_apply(*(jnp.asarray(a) for a in (c, ca, y, sp)),
                             interpret=True)
    o = cs.chunk_apply(*_t(c, ca, y.numpy(), sp))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=1e-4, atol=1e-5)


def test_chunk_kernels_match_the_oracles():
    g, l, dk, dv = 4, 128, 32, 64
    c, b, v, ca = _t(*_chunk_np(g, l, dk, dv, seed=2))
    y, s = cs.chunk_local(c, b, v, ca)
    sp = torch.randn((g, dk, dv), generator=torch.Generator().manual_seed(0))
    o = cs.chunk_apply(c, ca, y, sp)
    for i in range(g):
        y_o, s_o = ref.chunk_local_reference(c[i], b[i], v[i], ca[i, :, 0])
        torch.testing.assert_close(y[i], y_o, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(s[i], s_o, rtol=1e-4, atol=1e-5)
        o_o = ref.chunk_apply_reference(c[i], ca[i, :, 0], y[i], sp[i])
        torch.testing.assert_close(o[i], o_o, rtol=1e-4, atol=1e-5)


def test_chunk_local_keeps_v_dtype_and_masks_before_exp():
    """bf16 operands give y_intra in bf16 and the state in f32; a steep
    decay (above-diagonal deltas far past exp's range) stays finite."""
    c, b, v, ca = _t(*_chunk_np(2, 64, 16, 16, seed=3))
    ca = ca * 200.0
    y, s = cs.chunk_local(c.bfloat16(), b.bfloat16(), v.bfloat16(), ca)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all())
    out = cs.chunk_apply(c.bfloat16(), ca, y, s)
    assert out.dtype == torch.bfloat16


def _inputs(b, h, l, dk, dv, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, h, l, dk)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(b, h, l, dk)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(b, h, l, dv)) * 0.5).astype(np.float32)
    la = (-np.logaddexp(0.0, rng.normal(size=(b, h, l)))).astype(np.float32)
    return q, k, v, la


@pytest.mark.parametrize("l,dk,dv,chunk", [(128, 16, 16, 32), (256, 32, 64, 64),
                                           (256, 64, 64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_pallas_matches_recurrence(l, dk, dv, chunk, dtype):
    q, k, v, la = _inputs(2, 2, l, dk, dv, seed=l + dk)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    y = ops.ssd_scan(tq, tk, tv, torch.from_numpy(la), chunk=chunk,
                     backend="pallas")
    assert y.dtype == tdt
    # The recurrence on the same (rounded) operands, in the reference.
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (tq, tk, tv))
    want = jax.vmap(jax.vmap(ref_ref.ssm_scan_reference))(jq, jk, jv,
                                                          jnp.asarray(la))
    tol = 2e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want),
                               rtol=tol, atol=tol * 5)


@pytest.mark.parametrize("tb,rb", [("xla", "xla"),
                                   ("pallas", "pallas_interpret"),
                                   ("pallas_interpret", "pallas_interpret")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_backends_match_reference(tb, rb, dtype):
    q, k, v, la = _inputs(2, 3, 256, 32, 64, seed=1)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = ref_ops.ssd_scan(jq, jk, jv, jnp.asarray(la), chunk=64, backend=rb)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(getattr(torch, dtype)) for a in (jq, jk, jv))
    y = ops.ssd_scan(tq, tk, tv, torch.from_numpy(la), chunk=64, backend=tb)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol if dtype == "bfloat16" else 1e-5)


def test_ssd_backends_agree_with_chunked_oracle():
    """The reference's test_ssd_backends_agree, on the port's backends and
    oracle."""
    q, k, v, la = _t(*_inputs(2, 3, 256, 32, 64, seed=1))
    y_ref = ref.chunked_ssm_reference(q[0, 0], k[0, 0], v[0, 0], la[0, 0], 64)
    for backend in ("xla", "pallas", "pallas_interpret"):
        y = ops.ssd_scan(q, k, v, la, chunk=64, backend=backend)
        torch.testing.assert_close(y[0, 0], y_ref, rtol=1e-4, atol=1e-5)


def test_decode_step_consistency():
    q, k, v, la = _t(*_inputs(2, 2, 64, 16, 32, seed=4))
    full = ops.ssd_scan(q, k, v, la, chunk=32, backend="xla")
    state = torch.zeros((2, 2, 16, 32))
    for t in range(64):
        yt, state = ops.ssm_decode_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                        la[:, :, t], state)
    torch.testing.assert_close(yt, full[:, :, -1], rtol=1e-4, atol=1e-5)


def test_ssd_scan_rejects_ragged_length_and_sharding():
    q, k, v, la = _t(*_inputs(1, 1, 384, 16, 16, seed=5))
    with pytest.raises(AssertionError):
        ops.ssd_scan(q, k, v, la, chunk=256, backend="pallas")
    # The sequence-sharded scan is a collective: outside a shard_map body
    # it has no mesh to continue over.
    with pytest.raises(ValueError, match="shard_map"):
        ops.ssd_scan(q, k, v, la, chunk=128, axis_names=("data",))
    with pytest.raises(ValueError):
        ops.ssd_scan(q, k, v, la, chunk=128, backend="mosaic")


def test_state_op_is_associative():
    rng = np.random.default_rng(6)
    els = [(torch.tensor(rng.uniform(0.1, 1.0, (2,)), dtype=torch.float32),
            torch.tensor(rng.normal(size=(2, 3, 4)), dtype=torch.float32))
           for _ in range(3)]
    a = ops._state_op(ops._state_op(els[0], els[1]), els[2])
    b = ops._state_op(els[0], ops._state_op(els[1], els[2]))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
