"""Flash attention's plain version and ``ops.attention`` against the
reference's Pallas kernel in interpret mode and its oracle.

Inputs are made with numpy from a seed and fed to both packages.  The
tolerance is the reference's own, 2e-3 (``tests/test_kernels.py:105`` and
``:116``), for d = 64 and Zamba2's head dim 112, causal and not, at two
block choices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(shape_q, shape_kv, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=shape_q) * scale).astype(np.float32)
    k = (rng.normal(size=shape_kv) * scale).astype(np.float32)
    v = (rng.normal(size=shape_kv) * scale).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("l,d,blocks", [(256, 64, (128, 128)),
                                        (512, 112, (256, 128)),
                                        (256, 112, (256, 512))])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference_kernel(l, d, blocks, causal):
    q, k, v = _qkv((2, l, d), (2, l, d), seed=l + d)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=blocks[0], block_k=blocks[1],
                     interpret=True)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             block_q=blocks[0], block_k=blocks[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_oracle(causal):
    q, k, v = (torch.from_numpy(a) for a in _qkv((4, 256, 112), (4, 256, 112),
                                                 seed=5))
    o = fa.flash_attention(q, k, v, causal=causal, block_q=128, block_k=128)
    for i in range(4):
        o_ref = ref.attention_reference(q[i], k[i], v[i], causal=causal)
        torch.testing.assert_close(o[i], o_ref, rtol=2e-3, atol=2e-3)


def test_flash_attention_block_choices_agree_and_keep_dtype():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 512, 112), (2, 512, 112),
                                                 seed=6))
    a = fa.flash_attention(q, k, v)                      # 256 x 512
    b = fa.flash_attention(q, k, v, block_q=64, block_k=128)
    torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
    out = fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16
    with pytest.raises(AssertionError):
        fa.flash_attention(q[:, :384], k[:, :384], v[:, :384])


@pytest.mark.parametrize("tb,rb", [("xla", "xla"), ("pallas", "pallas_interpret"),
                                   ("pallas_interpret", "pallas_interpret")])
def test_attention_wrapper_gqa_matches_reference(tb, rb):
    q, k, v = _qkv((2, 8, 256, 32), (2, 2, 256, 32), seed=7, scale=0.4)
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, backend=rb, block_q=128, block_k=128)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, backend=tb,
                        block_q=128, block_k=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_attention_backends_agree_gqa():
    """The reference's test_attention_wrapper_gqa on the port's backends."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 8, 256, 32),
                                                 (2, 2, 256, 32), seed=8,
                                                 scale=0.4))
    a = ops.attention(q, k, v, causal=True, backend="xla")
    b = ops.attention(q, k, v, causal=True, backend="pallas", block_q=128,
                      block_k=128)
    torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)


def test_blockwise_attention_matches_full():
    """The plain path's query-block form (L > 1024) == softmax attention."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 2048, 32),
                                                 (1, 2, 2048, 32), seed=9,
                                                 scale=0.4))
    blockwise = ops.attention(q, k, v, causal=True, backend="xla")
    for i in range(2):
        o_ref = ref.attention_reference(q[0, i], k[0, i], v[0, i], causal=True)
        torch.testing.assert_close(blockwise[0, i], o_ref, rtol=2e-3, atol=2e-3)
    flat = ops.attention(q, k, v, causal=False, backend="xla")
    o_ref = ref.attention_reference(q[0, 0], k[0, 0], v[0, 0], causal=False)
    torch.testing.assert_close(flat[0, 0], o_ref, rtol=2e-3, atol=2e-3)


def test_oracles_match_reference_oracles():
    q, k, v = _qkv((64, 16), (64, 16), seed=10)
    la = -np.logaddexp(0.0, np.random.default_rng(11).normal(size=64))
    la = la.astype(np.float32)
    from repro.kernels import ref as rref

    tq, tk, tv, tla = (torch.from_numpy(a) for a in (q, k, v, la))
    np.testing.assert_allclose(
        ref.attention_reference(tq, tk, tv).numpy(),
        np.asarray(rref.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))),
        rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        ref.ssm_scan_reference(tq, tk, tv, tla).numpy(),
        np.asarray(rref.ssm_scan_reference(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(la))),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        ref.chunked_ssm_reference(tq, tk, tv, tla, 16).numpy(),
        np.asarray(rref.chunked_ssm_reference(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), jnp.asarray(la),
                                              16)),
        rtol=1e-4, atol=1e-5)
