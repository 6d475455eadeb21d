"""The port's frontends against the reference: Whisper-base's encoder and
cross-attention, InternVL2-1B's patch prefix and the server's zero
frontend inputs, on their smoke configs with the reference's weights
carried across by ``interop.params_from_numpy``; and ``layernorm``.

Tolerances are the reference's own (``tests/test_models.py``): 2e-2 for
the encoder, cross-attention and prefill logits (:99), 3e-2 for decode
logits (:106); ``layernorm`` 1e-6.  The kernel backends are compared as
the port's ``"pallas"`` on CPU tensors (the kernels' plain versions)
against the reference's ``"pallas_interpret"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke
from repro.launch import serve as ref_serve
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro_torch import configs
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import attention, layers, lm

WHISPER = "whisper-base"
INTERNVL = "internvl2-1b"
BACKENDS = [("xla", "xla"), ("pallas", "pallas_interpret")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shared(arch, seed=1, **kw):
    rcfg = dataclasses.replace(ref_get_smoke(arch), **kw)
    rp = ref_lm.init_params(jax.random.PRNGKey(seed), rcfg)
    return rp, params_from_numpy(jax.device_get(rp))


def _cfgs(arch, tb="xla", rb="xla", **kw):
    return (dataclasses.replace(configs.get_smoke_config(arch),
                                attn_backend=tb, **kw),
            dataclasses.replace(ref_get_smoke(arch), attn_backend=rb, **kw))


def _normal(shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _tokens(b, l, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(np.int32)


def _close(t, r, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(r, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("tb,rb", BACKENDS)
def test_encoder_matches_reference(tb, rb):
    """Whisper's encoder: bidirectional attention blocks with RoPE over the
    frame positions, then the encoder norm."""
    rp, tp = _shared(WHISPER)
    tcfg, rcfg = _cfgs(WHISPER, tb, rb)
    frames = _normal((2, tcfg.frontend_len, tcfg.d_model), seed=1)
    want = ref_lm._encode(rp, rcfg, jnp.asarray(frames))
    got = lm._encode(tp, tcfg, torch.from_numpy(frames))
    assert got.shape == (2, tcfg.frontend_len, tcfg.d_model)
    _close(got, want, 2e-2)
    # Bidirectional: the first frame sees the last one.
    moved = frames.copy()
    moved[:, -1] += 1.0
    got2 = lm._encode(tp, tcfg, torch.from_numpy(moved))
    assert float((got2[:, 0] - got[:, 0]).abs().max()) > 1e-4


def test_cross_attention_matches_reference():
    """Queries from 8 decoder positions, keys and values from 32 encoder
    frames (lq != lk), non-causal: every query reads every frame."""
    rp, tp = _shared(WHISPER)
    tcfg, rcfg = _cfgs(WHISPER, "pallas", "pallas_interpret")
    xp = jax.tree_util.tree_map(lambda a: a[0], rp["blocks"]["b0"]["xattn"])
    tx = {k: {kk: vv[0] for kk, vv in v.items()}
          for k, v in tp["blocks"]["b0"]["xattn"].items()}
    x = _normal((2, 8, tcfg.d_model), seed=2, scale=1.0)
    enc = _normal((2, 32, tcfg.d_model), seed=3, scale=1.0)
    want = ref_attention.cross_attention(xp, rcfg, jnp.asarray(x),
                                         jnp.asarray(enc))
    got = attention.cross_attention(tx, tcfg, torch.from_numpy(x),
                                    torch.from_numpy(enc))
    assert got.shape == (2, 8, tcfg.d_model)
    _close(got, want, 2e-2)
    enc2 = enc.copy()
    enc2[:, -1] += 1.0
    got2 = attention.cross_attention(tx, tcfg, torch.from_numpy(x),
                                     torch.from_numpy(enc2))
    assert float((got2[:, 0] - got[:, 0]).abs().max()) > 1e-4


@pytest.mark.parametrize("tb,rb", BACKENDS)
def test_whisper_prefill_decode_match_reference(tb, rb):
    """Whisper's forward, prefill (the encoder on the frames, every decoder
    block cross-attending its output) and 4 decode steps reading the
    encoder output from the states."""
    rp, tp = _shared(WHISPER)
    tcfg, rcfg = _cfgs(WHISPER, tb, rb)
    b, l = 2, 16
    toks = _tokens(b, l, tcfg.vocab_size)
    frames = _normal((b, tcfg.frontend_len, tcfg.d_model), seed=4)
    rbatch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "frames": torch.from_numpy(frames)}
    full_r, _ = ref_lm.forward_train(rp, rcfg, rbatch)
    full_t, _ = lm.forward_train(tp, tcfg, tbatch)
    _close(full_t, full_r, 2e-2)
    rs = ref_lm.init_decode_states(rcfg, b, l + 8)
    ts = lm.init_decode_states(tcfg, b, l + 8)
    assert ts["enc_out"].shape == tuple(rs["enc_out"].shape)
    lg_r, rs = ref_lm.prefill(rp, rcfg, rbatch, rs)
    lg_t, ts = lm.prefill(tp, tcfg, tbatch, ts)
    _close(lg_t, lg_r, 2e-2)
    _close(ts["enc_out"], rs["enc_out"], 2e-2)
    for t in range(4):
        tok = np.argmax(np.asarray(lg_r)[:, -1], -1).astype(np.int32)[:, None]
        lg_r, rs = ref_lm.decode_step(rp, rcfg, jnp.asarray(tok),
                                      jnp.int32(l + t), rs)
        lg_t, ts = lm.decode_step(tp, tcfg, torch.from_numpy(tok).long(),
                                  l + t, ts)
        _close(lg_t, lg_r, 3e-2)


@pytest.mark.parametrize("tb,rb", BACKENDS)
def test_patch_prefix_matches_reference(tb, rb):
    """InternVL2's patches prepended to the token embeddings: the forward
    strips them from the logits, prefill attends them, decode continues
    after them (positions prefix + l on)."""
    rp, tp = _shared(INTERNVL)
    tcfg, rcfg = _cfgs(INTERNVL, tb, rb)
    b, l, pre = 2, 16, tcfg.frontend_len
    toks = _tokens(b, l, tcfg.vocab_size, seed=5)
    patches = _normal((b, pre, tcfg.d_model), seed=6)
    rbatch = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "patches": torch.from_numpy(patches)}
    full_r, _ = ref_lm.forward_train(rp, rcfg, rbatch)
    full_t, _ = lm.forward_train(tp, tcfg, tbatch)
    assert full_t.shape == (b, l, tcfg.padded_vocab)
    _close(full_t, full_r, 2e-2)
    rs = ref_lm.init_decode_states(rcfg, b, pre + l + 8)
    ts = lm.init_decode_states(tcfg, b, pre + l + 8)
    lg_r, rs = ref_lm.prefill(rp, rcfg, rbatch, rs)
    lg_t, ts = lm.prefill(tp, tcfg, tbatch, ts)
    _close(lg_t, lg_r, 2e-2)
    for t in range(3):
        tok = np.argmax(np.asarray(lg_r)[:, -1], -1).astype(np.int32)[:, None]
        pos = pre + l + t
        lg_r, rs = ref_lm.decode_step(rp, rcfg, jnp.asarray(tok),
                                      jnp.int32(pos), rs)
        lg_t, ts = lm.decode_step(tp, tcfg, torch.from_numpy(tok).long(),
                                  pos, ts)
        _close(lg_t, lg_r, 3e-2)


@pytest.mark.parametrize("arch", [INTERNVL, WHISPER])
def test_server_feeds_zero_frontends_as_the_reference(arch):
    """Server.serve_batch with the reference server's zero patches or
    frames, on the port's CPU path: the same greedy tokens as the
    reference's Server on the same weights; patch caches hold prefix +
    max_len positions."""
    rp, tp = _shared(arch, seed=0)
    cfg_s = dict(arch=arch, smoke=True, max_batch=3, max_len=48)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 500, n, dtype=np.int32) for n in (12, 5, 9)]
    rsrv = ref_serve.Server(ref_serve.ServeConfig(**cfg_s), params=rp)
    tsrv = serve.Server(serve.ServeConfig(**cfg_s), params=tp, device="cpu")
    extras = tsrv._extras(3)
    key = "patches" if arch == INTERNVL else "frames"
    assert list(extras) == [key]
    assert extras[key].shape == (3, tsrv.acfg.frontend_len,
                                 tsrv.acfg.d_model)
    assert not bool(extras[key].any())
    prefix, states = tsrv._init_states(3)
    rprefix, rstates = rsrv._init_states(3)
    assert prefix == rprefix
    k0 = states["blocks"]["b0"]["k"]
    assert k0.shape[-2] == rstates["blocks"]["b0"]["k"].shape[-2]
    assert k0.shape[-2] == prefix + 48
    rreqs = [ref_serve.Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    treqs = [serve.Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    rsrv.serve_batch(rreqs)
    stats = tsrv.serve_batch(treqs)
    assert stats["generated"] == sum(len(r.output) for r in rreqs)
    assert [r.output for r in treqs] == [r.output for r in rreqs]


def test_kernel_block_check_refuses_whisper_frames_and_long_vlm_prompts():
    """Both packages' flash kernels keep lq % min(256, lq) == 0 and lk %
    min(512, lk) == 0: Whisper's 1500 frames fail the first (1500 % 256 =
    220) and InternVL2's 256 patches behind 512 tokens (768 positions)
    the second, so both raise AssertionError on the kernel backends; 256
    patches behind 256 tokens (512 positions) pass."""
    rp, tp = _shared(WHISPER, frontend_len=1500)
    tcfg, rcfg = _cfgs(WHISPER, "pallas", "pallas_interpret",
                       frontend_len=1500)
    frames = np.zeros((1, 1500, tcfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        ref_lm._encode(rp, rcfg, jnp.asarray(frames))
    with pytest.raises(AssertionError):
        lm._encode(tp, tcfg, torch.from_numpy(frames))
    rp, tp = _shared(INTERNVL, frontend_len=256)
    tcfg, rcfg = _cfgs(INTERNVL, "pallas", "pallas_interpret",
                       frontend_len=256)
    patches = np.zeros((1, 256, tcfg.d_model), np.float32)
    for l, ok in ((512, False), (256, True)):
        toks = _tokens(1, l, tcfg.vocab_size)
        tbatch = {"tokens": torch.from_numpy(toks).long(),
                  "patches": torch.from_numpy(patches)}
        ts = lm.init_decode_states(tcfg, 1, 256 + l)
        if ok:
            lg, _ = lm.prefill(tp, tcfg, tbatch, ts)
            assert bool(torch.isfinite(lg).all())
            continue
        rbatch = {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}
        rs = ref_lm.init_decode_states(rcfg, 1, 256 + l)
        with pytest.raises(AssertionError):
            ref_lm.prefill(rp, rcfg, rbatch, rs)
        with pytest.raises(AssertionError):
            lm.prefill(tp, tcfg, tbatch, ts)


def test_layernorm_matches_reference():
    x = _normal((3, 5, 64), seed=7, scale=2.0) + 0.5
    scale = _normal((64,), seed=8, scale=1.0)
    bias = _normal((64,), seed=9, scale=1.0)
    rp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    want = ref_layers.layernorm(rp, jnp.asarray(x))
    got = layers.layernorm(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    init = layers.layernorm_init(64, torch.bfloat16)
    rinit = ref_layers.layernorm_init(64, jnp.bfloat16)
    for k in ("scale", "bias"):
        assert init[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(init[k].float().numpy(),
                                      np.asarray(rinit[k], np.float32))
