"""The dense LM configurations, xLSTM-350M, the MoE configurations and
those with a frontend in the port against the reference, on their smoke configs with the reference's weights carried
across by ``interop.params_from_numpy``, and their full configs walked on
the meta device.

Tolerances are the reference's own (``tests/test_models.py``): prefill
logits 2e-2 (:99), decode logits 3e-2 (:106), the unrolled layers 1e-5
(:151); the eval-shape count within 25% of the analytic one (:63).  The
kernel backends are compared as the port's ``"pallas"`` on CPU tensors (the
kernels' plain versions) against the reference's ``"pallas_interpret"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.launch import serve as ref_serve
from repro.models import lm as ref_lm
from repro_torch import configs
from repro_torch.core._tree import tensor_leaves
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import layers, lm

NEW_ARCHS = ["codeqwen1.5-7b", "internlm2-20b", "qwen3-32b", "qwen2-72b",
             "xlstm-350m", "phi3.5-moe-42b-a6.6b", "arctic-480b",
             "internvl2-1b", "whisper-base"]
BACKENDS = [("xla", "xla"), ("pallas", "pallas_interpret")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(b, l, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(np.int32)


def _shared(arch, seed=1):
    """The reference's smoke parameters, as the reference's arrays and as
    the port's tensors."""
    rp = ref_lm.init_params(jax.random.PRNGKey(seed), ref_get_smoke(arch))
    return rp, params_from_numpy(jax.device_get(rp))


def _cfgs(arch, tb, rb, **kw):
    return (dataclasses.replace(configs.get_smoke_config(arch),
                                attn_backend=tb, ssm_backend=tb, **kw),
            dataclasses.replace(ref_get_smoke(arch), attn_backend=rb,
                                ssm_backend=rb, **kw))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_configs_well_formed(arch):
    """tests/test_models.py::test_full_configs_well_formed on the port:
    the full config's leaves walked on the meta device (nothing allocated)
    count within 25% of the analytic count, which is the reference's."""
    cfg = configs.get_config(arch)
    assert cfg.n_super * len(cfg.block_pattern) == cfg.n_layers
    assert cfg.padded_vocab >= cfg.vocab_size
    assert cfg.padded_vocab % 256 == 0
    assert cfg.param_count() == ref_get_config(arch).param_count() > 0
    assert cfg.active_param_count() <= cfg.param_count()
    leaves = tensor_leaves(lm.init_shapes(cfg))
    assert leaves and all(t.is_meta for t in leaves)
    assert {t.dtype for t in leaves} <= {cfg.pdtype, torch.float32}
    n = sum(t.numel() for t in leaves)
    assert abs(n - cfg.param_count()) / cfg.param_count() < 0.25, (
        arch, n, cfg.param_count())


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_tree_matches_reference(arch):
    """init_params and init_shapes give the reference's tree: every leaf's
    path, shape and dtype."""
    rp, _ = _shared(arch)
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  jax.device_get(rp))
    cfg = configs.get_smoke_config(arch)
    desc = lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    tp = lm.init_params(torch.Generator().manual_seed(0), cfg)
    assert jax.tree_util.tree_map(desc, tp) == want
    assert jax.tree_util.tree_map(desc, lm.init_shapes(cfg)) == want


def test_init_params_fills_stacked_leaves_superblock_by_superblock(
        monkeypatch):
    """Each stacked leaf is one tensor that init_params fills a superblock
    at a time: drawn in float32 pieces (here of 7 values), every
    superblock's slice drawn anew, the same seed giving the same weights."""
    monkeypatch.setattr(layers, "_PIECE", 7)
    cfg = dataclasses.replace(configs.get_smoke_config("internlm2-20b"),
                              n_layers=3)
    p = lm.init_params(torch.Generator().manual_seed(0), cfg)
    w = p["blocks"]["b0"]["attn"]["wq"]["w"]
    assert w.shape == (3, cfg.d_model, cfg.n_heads * cfg.hd)
    assert w.is_contiguous() and w._base is None
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    scale = 1.0 / np.sqrt(cfg.d_model)
    assert 0.8 * scale < float(w.std()) < 1.2 * scale
    norm = p["blocks"]["b0"]["ln1"]["scale"]
    assert torch.equal(norm, torch.ones_like(norm))
    again = lm.init_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(again["blocks"]["b0"]["attn"]["wq"]["w"], w)
    assert torch.equal(again["head"]["w"], p["head"]["w"])


def test_params_into_refuses_a_target_of_another_shape():
    target = torch.empty((4, 8))
    with pytest.raises(ValueError, match="target"):
        with layers.params_into([target]):
            layers.dense_init(torch.Generator(), 8, 4, torch.float32)


@pytest.mark.parametrize("tb,rb", BACKENDS)
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_logits_match_reference(arch, tb, rb):
    """The forward, prefill and decode part of
    tests/test_models.py::test_arch_smoke_forward_and_step, held to the
    reference on the same weights and tokens: teacher-forced logits, then
    prefill and 4 decode steps."""
    rp, tp = _shared(arch)
    tcfg, rcfg = _cfgs(arch, tb, rb)
    b, l = 2, 64
    toks = _tokens(b, l, rcfg.vocab_size)
    full_r, _ = ref_lm.forward_train(rp, rcfg, {"tokens": jnp.asarray(toks)})
    full_t, _ = lm.forward_train(tp, tcfg,
                                 {"tokens": torch.from_numpy(toks).long()})
    assert full_t.shape == (b, l, tcfg.padded_vocab)
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_r), rtol=2e-2,
                               atol=2e-2)
    rs = ref_lm.init_decode_states(rcfg, b, l + 8)
    ts = lm.init_decode_states(tcfg, b, l + 8)
    lg_r, rs = ref_lm.prefill(rp, rcfg, {"tokens": jnp.asarray(toks)}, rs)
    lg_t, ts = lm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                          ts)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), rtol=2e-2,
                               atol=2e-2)
    for t in range(4):
        tok = np.argmax(np.asarray(lg_r)[:, -1], -1).astype(np.int32)[:, None]
        lg_r, rs = ref_lm.decode_step(rp, rcfg, jnp.asarray(tok),
                                      jnp.int32(l + t), rs)
        lg_t, ts = lm.decode_step(tp, tcfg, torch.from_numpy(tok).long(),
                                  l + t, ts)
        assert bool(torch.isfinite(lg_t).all())
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), rtol=3e-2,
                                   atol=3e-2)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "xlstm-350m"])
def test_prefill_decode_matches_forward(arch, backend):
    """tests/test_models.py::test_prefill_decode_matches_forward on the
    port: prefill(x[:t]) + decode steps reproduce forward_train's logits at
    the same positions."""
    _, tp = _shared(arch, seed=2)
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              attn_backend=backend, ssm_backend=backend)
    b, l = 2, 32
    tokens = torch.from_numpy(_tokens(b, l, cfg.vocab_size, seed=1)).long()
    full_logits, _ = lm.forward_train(tp, cfg, {"tokens": tokens})
    n_pre = l - 4
    states = lm.init_decode_states(cfg, b, l + 4)
    lg, states = lm.prefill(tp, cfg, {"tokens": tokens[:, :n_pre]}, states)
    torch.testing.assert_close(lg[:, 0], full_logits[:, n_pre - 1], rtol=2e-2,
                               atol=2e-2)
    for t in range(n_pre, l):
        lg, states = lm.decode_step(tp, cfg, tokens[:, t:t + 1], t, states)
        torch.testing.assert_close(lg[:, 0], full_logits[:, t], rtol=3e-2,
                                   atol=3e-2)


def test_unrolled_matches_scanned():
    """tests/test_models.py::test_unrolled_matches_scanned's forward half:
    scan_layers=False (one state dict a superblock) gives the same logits
    to 1e-5; the loss half waits for LM training."""
    _, tp = _shared("internlm2-20b", seed=0)
    cfg = configs.get_smoke_config("internlm2-20b")
    tokens = torch.from_numpy(_tokens(2, 64, cfg.vocab_size, seed=3)).long()
    l1, _ = lm.forward_train(tp, cfg, {"tokens": tokens})
    cfg2 = dataclasses.replace(cfg, scan_layers=False)
    l2, _ = lm.forward_train(tp, cfg2, {"tokens": tokens})
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-5, atol=1e-5)
    s1 = lm.init_decode_states(cfg, 2, 68)
    s2 = lm.init_decode_states(cfg2, 2, 68)
    p1, _ = lm.prefill(tp, cfg, {"tokens": tokens}, s1)
    p2, _ = lm.prefill(tp, cfg2, {"tokens": tokens}, s2)
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=1e-5, atol=1e-5)


def test_server_default_is_the_reference_default():
    """ServeConfig() serves xlstm-350m, as the reference's does; on the
    same weights both servers emit the same greedy tokens."""
    assert serve.ServeConfig().arch == ref_serve.ServeConfig().arch \
        == "xlstm-350m"
    rsrv = ref_serve.Server(ref_serve.ServeConfig(eos_id=None))
    tsrv = serve.Server(serve.ServeConfig(eos_id=None),
                        params=params_from_numpy(jax.device_get(rsrv.params)),
                        device="cpu")
    assert tsrv.acfg == configs.get_smoke_config("xlstm-350m")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, 500, n, dtype=np.int32) for n in (24, 32, 17)]
    rreqs = [ref_serve.Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    treqs = [serve.Request(i, p, max_new=6) for i, p in enumerate(prompts)]
    rsrv.serve_batch(rreqs)
    stats = tsrv.serve_batch(treqs)
    assert stats["generated"] == 18
    assert [r.output for r in treqs] == [r.output for r in rreqs]
