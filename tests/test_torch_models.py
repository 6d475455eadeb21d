"""The port's LM (configs, layers, Mamba2 and attention blocks, lm) against
the reference on Zamba2's smoke config, with the reference's weights
carried across by ``interop.params_from_numpy``.

Tolerances are the reference's own (``tests/test_models.py:96-107``):
prefill logits 2e-2 (:99), decode logits 3e-2 (:106).  The kernel backends
are compared as the port's ``"pallas"`` on CPU tensors (the kernels' plain
versions) against the reference's ``"pallas_interpret"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import config as ref_config
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro_torch import configs
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import blocks, config, layers, lm
from repro_torch.models.attention import cross_attention

ARCH = "zamba2-7b"
BACKENDS = [("xla", "xla"), ("pallas", "pallas_interpret")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def shared_params():
    """The reference's smoke-config parameters, as numpy and as tensors."""
    cfg = ref_get_smoke(ARCH)
    rp = ref_lm.init_params(jax.random.PRNGKey(1), cfg)
    return rp, params_from_numpy(jax.device_get(rp))


def _cfgs(tb, rb):
    return (dataclasses.replace(configs.get_smoke_config(ARCH),
                                attn_backend=tb, ssm_backend=tb),
            dataclasses.replace(ref_get_smoke(ARCH), attn_backend=rb,
                                ssm_backend=rb))


def _tokens(b, l, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, l)).astype(np.int32)


# The reference's configurations, in its order: the port serves them all.
PORTED = ["codeqwen1.5-7b", "internlm2-20b", "qwen3-32b", "qwen2-72b",
          "xlstm-350m", "zamba2-7b", "phi3.5-moe-42b-a6.6b", "arctic-480b",
          "internvl2-1b", "whisper-base"]


def test_configs_match_reference():
    from repro.configs import ALIASES as REF_ALIASES
    from repro.configs import list_archs as ref_list_archs

    for arch in PORTED:
        for get_t, get_r in ((configs.get_config, ref_get_config),
                             (configs.get_smoke_config, ref_get_smoke)):
            t, r = get_t(arch), get_r(arch)
            assert dataclasses.asdict(t) == dataclasses.asdict(r)
            for prop in ("hd", "padded_vocab", "head_chunks", "n_super",
                         "d_inner", "ssm_heads", "ssm_head_dim"):
                assert getattr(t, prop) == getattr(r, prop), prop
            assert t.param_count() == r.param_count()
            assert t.active_param_count() == r.active_param_count()
            assert t.pdtype == getattr(torch, str(r.pdtype))
            assert t.cdtype == getattr(torch, str(r.cdtype))
    assert configs.get_config("zamba2_7b") is configs.get_config(ARCH)
    assert configs.ALIASES == {a: REF_ALIASES[a] for a in PORTED}
    assert configs.list_archs() == [a for a in ref_list_archs()
                                    if a in configs.ALIASES.values()]
    assert {s.name: dataclasses.astuple(s) for s in config.SHAPES.values()} == {
        s.name: dataclasses.astuple(s) for s in ref_config.SHAPES.values()}
    # Zamba2 at full width: 4.64 B parameters by the analytic count.
    assert round(configs.get_config(ARCH).param_count() / 1e9, 2) == 4.64


def test_unported_configs_and_kinds_raise():
    """The MoE and frontend configurations, the ``moe`` kind, cross-attention
    blocks, the encoder, the patch prefix, training (``loss_fn``), the
    sequence-sharded ``ssd_scan`` and training on a mesh work now; what
    still raises is an unknown config, the sequence-sharded scan called
    outside a ``shard_map`` body (it is a collective), and a mesh larger
    than the process group (``build`` with no world to lay it on)."""
    for name in ("phi3.5-moe-42b-a6.6b", "arctic-480b", "internvl2-1b",
                 "whisper-base"):
        assert configs.get_config(name).name == name
        assert configs.get_smoke_config(name).name.endswith("-smoke")
    with pytest.raises(ModuleNotFoundError, match="no config"):
        configs.get_config("gpt-5")
    cfg = configs.get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    moe_cfg = configs.get_smoke_config("arctic-480b")
    p = blocks.block_init(gen, moe_cfg, "moe")
    assert {"ln1", "attn", "ln2", "moe", "dense_mlp"} == set(p)
    st = blocks.block_state_init(moe_cfg, "moe", 1, 8)
    x = torch.randn(1, 8, moe_cfg.d_model, generator=gen)
    y, st, aux = blocks.block_apply(p, moe_cfg, "moe", x,
                                    positions=torch.arange(8),
                                    mode="prefill", state=st)
    assert y.shape == x.shape and aux.shape == () and float(aux) > 0
    px = blocks.block_init(gen, cfg, "attn", cross=True)
    assert {"lnx", "xattn"} <= set(px)
    enc = torch.randn(1, 5, cfg.d_model, generator=gen)
    out = cross_attention(px["xattn"], cfg, x[..., :cfg.d_model], enc)
    assert out.shape == (1, 8, cfg.d_model)
    xp, n_prefix = lm._embed_inputs(
        {"embed": {"table": torch.zeros(4, cfg.d_model)}},
        dataclasses.replace(cfg, frontend="patch"),
        {"tokens": torch.zeros(1, 3, dtype=torch.long),
         "patches": torch.ones(1, 2, cfg.d_model)})
    assert xp.shape == (1, 5, cfg.d_model) and n_prefix == 2
    wcfg = configs.get_smoke_config("whisper-base")
    assert "encoder" in lm.init_params(gen, wcfg)
    from repro_torch.kernels import ops
    q = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="shard_map"):
        ops.ssd_scan(q, q, q, torch.zeros(1, 1, 8), chunk=4,
                     axis_names=("sp",))
    from repro_torch.core import spmd
    mesh = spmd.Mesh(["cpu"] * 2, ("sp",))
    sp = spmd.P(None, None, "sp")
    y = spmd.shard_map(
        lambda *a: ops.ssd_scan(*a, chunk=4, axis_names=("sp",)), mesh,
        sp, sp)(q, q, q, torch.zeros(1, 1, 8))
    assert y.shape == q.shape
    from repro_torch.launch.train import TrainConfig, build
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        build(TrainConfig(smoke=True, mesh_shape=(2, 2), device="cpu"))


def test_param_tree_matches_reference(shared_params):
    rp, _ = shared_params
    cfg = configs.get_smoke_config(ARCH)
    tp = lm.init_params(torch.Generator().manual_seed(0), cfg)
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  jax.device_get(rp))
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        tp)
    assert got == want


def test_zamba2_shared_attention_is_shared():
    """All shared_attn applications must use the same parameters."""
    cfg = configs.get_smoke_config(ARCH)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    assert "shared" in params
    shared_positions = [j for j, k in enumerate(cfg.block_pattern)
                        if k == "shared_attn"]
    for j in shared_positions:
        assert f"b{j}" not in params["blocks"]


def test_layers_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 8, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(8, dtype=np.int32)
    np.testing.assert_allclose(
        layers.rmsnorm({"scale": torch.from_numpy(scale)},
                       torch.from_numpy(x)).numpy(),
        np.asarray(ref_layers.rmsnorm({"scale": jnp.asarray(scale)},
                                      jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    for p in (pos, np.stack([pos, pos + 3])):
        np.testing.assert_allclose(
            layers.apply_rope(torch.from_numpy(x), torch.from_numpy(p)).numpy(),
            np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(p))),
            rtol=1e-5, atol=1e-5)
    w = {k: {"w": rng.normal(size=s).astype(np.float32) * 0.2}
         for k, s in (("w1", (16, 32)), ("w3", (16, 32)), ("w2", (32, 16)))}
    np.testing.assert_allclose(
        layers.swiglu(params_from_numpy(w), torch.from_numpy(x)).numpy(),
        np.asarray(ref_layers.swiglu(w, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    head = {"w": rng.normal(size=(2, 16, 24)).astype(np.float32)}
    h = x[:, 0]
    np.testing.assert_allclose(
        layers.head_logits(params_from_numpy(head), torch.from_numpy(h)).numpy(),
        np.asarray(ref_layers.head_logits(head, jnp.asarray(h))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tb,rb", BACKENDS)
def test_zamba2_smoke_logits_match_reference(shared_params, tb, rb):
    """Teacher-forced, prefill and decode logits of the port and the
    reference on the same weights and tokens."""
    rp, tp = shared_params
    tcfg, rcfg = _cfgs(tb, rb)
    b, l = 2, 64
    toks = _tokens(b, l, rcfg.vocab_size)
    full_r, _ = ref_lm.forward_train(rp, rcfg, {"tokens": jnp.asarray(toks)})
    full_t, _ = lm.forward_train(tp, tcfg, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_r), rtol=2e-2,
                               atol=2e-2)
    rs = ref_lm.init_decode_states(rcfg, b, l + 4)
    ts = lm.init_decode_states(tcfg, b, l + 4)
    lg_r, rs = ref_lm.prefill(rp, rcfg, {"tokens": jnp.asarray(toks)}, rs)
    lg_t, ts = lm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, ts)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), rtol=2e-2,
                               atol=2e-2)
    for t in range(3):
        tok = np.argmax(np.asarray(lg_r)[:, -1], -1).astype(np.int32)[:, None]
        lg_r, rs = ref_lm.decode_step(rp, rcfg, jnp.asarray(tok),
                                      jnp.int32(l + t), rs)
        lg_t, ts = lm.decode_step(tp, tcfg, torch.from_numpy(tok).long(),
                                  l + t, ts)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_r), rtol=3e-2,
                                   atol=3e-2)
    # The decode states too: same layout (stacked over superblocks).
    flat_r = jax.tree_util.tree_leaves(jax.device_get(rs))
    flat_t = jax.tree_util.tree_leaves(to_numpy(
        jax.tree_util.tree_map(lambda t: t.float(), ts)))
    assert [a.shape for a in flat_t] == [a.shape for a in flat_r]
    for a, r in zip(flat_t, flat_r):
        np.testing.assert_allclose(a, np.asarray(r, np.float32), rtol=3e-2,
                                   atol=3e-2)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_prefill_decode_matches_forward(shared_params, backend):
    """Teacher-forcing consistency on Zamba2: prefill(x[:t]) + decode steps
    reproduce forward_train's logits at the same positions."""
    _, tp = shared_params
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
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


def test_unstacked_states_match_stacked(shared_params):
    """scan_layers=False keeps one state dict a superblock; the numbers are
    those of the stacked layout."""
    _, tp = shared_params
    cfg = configs.get_smoke_config(ARCH)
    cfg2 = dataclasses.replace(cfg, scan_layers=False)
    tokens = torch.from_numpy(_tokens(2, 16, cfg.vocab_size, seed=2)).long()
    out = []
    for c in (cfg, cfg2):
        st = lm.init_decode_states(c, 2, 20)
        lg, st = lm.prefill(tp, c, {"tokens": tokens}, st)
        lg2, st = lm.decode_step(tp, c, tokens[:, :1], 16, st)
        out.append((lg, lg2, st))
    assert set(out[1][2]["blocks"]) == {f"sb{i}" for i in range(cfg.n_super)}
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=0)


def test_bf16_smoke_model_runs_both_backends(shared_params):
    """The full config's dtypes (bf16 weights and activations) on the smoke
    widths: the kernel backends round y_intra to bf16, the xla path does
    not, and the two stay within the reference's bf16 tolerance (2e-2,
    tests/test_kernels.py:32)."""
    rp, _ = shared_params
    base = dataclasses.replace(configs.get_smoke_config(ARCH),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    p16 = params_from_numpy(jax.device_get(rp), dtype=torch.bfloat16)
    assert p16["embed"]["table"].dtype == torch.bfloat16
    tokens = torch.from_numpy(_tokens(2, 64, base.vocab_size, seed=3)).long()
    outs = {}
    for backend in ("xla", "pallas"):
        cfg = dataclasses.replace(base, attn_backend=backend,
                                  ssm_backend=backend)
        st = lm.init_decode_states(cfg, 2, 64)
        outs[backend], _ = lm.prefill(p16, cfg, {"tokens": tokens}, st)
        assert bool(torch.isfinite(outs[backend]).all())
    torch.testing.assert_close(outs["pallas"], outs["xla"], rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("tb,rb", BACKENDS)
@pytest.mark.parametrize("flavour", [
    {}, {"qk_norm": True}, {"qkv_bias": True, "n_kv_heads": 2}])
def test_attention_block_matches_reference(tb, rb, flavour):
    """The attention block's prefill, full-sequence and decode forms, with
    the flavours the dense configurations use (qk_norm, qkv_bias, GQA), at
    the reference's attention tolerance (tests/test_kernels.py:116)."""
    from repro.models import attention as ref_attn
    from repro_torch.models import attention as attn

    rcfg = dataclasses.replace(ref_get_smoke(ARCH), attn_backend=rb, **flavour)
    tcfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                               attn_backend=tb, **flavour)
    rp = ref_attn.attn_init(jax.random.PRNGKey(4), rcfg)
    if "qkv_bias" in flavour:   # zeros at init: make the bias count
        rng = np.random.default_rng(5)
        for name in ("wq", "wk", "wv"):
            rp[name]["b"] = jnp.asarray(
                rng.normal(size=rp[name]["b"].shape).astype(np.float32) * 0.1)
    tp = params_from_numpy(jax.device_get(rp))
    x = np.random.default_rng(6).normal(size=(2, 32, 64)).astype(np.float32)
    pos = np.arange(32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(
        attn.attention_block(tp, tcfg, tx, torch.from_numpy(pos)).numpy(),
        np.asarray(ref_attn.attention_block(rp, rcfg, jx, jnp.asarray(pos))),
        rtol=2e-3, atol=2e-3)
    rc = ref_attn.init_kv_cache(rcfg, 2, 40)
    tc = attn.init_kv_cache(tcfg, 2, 40)
    ro, rc = ref_attn.attention_prefill(rp, rcfg, jx, jnp.asarray(pos), rc)
    to, tc = attn.attention_prefill(tp, tcfg, tx, torch.from_numpy(pos), tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=2e-3,
                               atol=2e-3)
    x1 = x[:, :1] * 0.5
    ro, _ = ref_attn.attention_decode(rp, rcfg, jnp.asarray(x1), jnp.int32(32),
                                      rc)
    to, _ = attn.attention_decode(tp, tcfg, torch.from_numpy(x1), 32, tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=2e-3,
                               atol=2e-3)
