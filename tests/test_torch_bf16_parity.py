"""bf16 parity at depth: the port's Zamba2 (smoke widths, bf16 parameters
and compute, the reference's weights carried across) against the
reference's "xla" path, at 3 and 12 layers.

The bound at each depth is the reference's own gap between its kernel path
("pallas_interpret") and its "xla" path on the same weights and tokens,
computed here: the port may depart from the reference no further than the
reference's two paths depart from each other."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import lm as ref_lm
from repro_torch import configs
from repro_torch.interop import params_from_numpy
from repro_torch.models import lm

ARCH = "zamba2-7b"
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _ref_logits(params, cfg, tokens, backend):
    cfg = dataclasses.replace(cfg, attn_backend=backend, ssm_backend=backend)
    out, _ = ref_lm.forward_train(params, cfg, {"tokens": jnp.asarray(tokens)})
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("layers", [3, 12])
def test_bf16_logits_match_reference_within_its_own_kernel_gap(layers):
    rcfg = dataclasses.replace(ref_get_smoke(ARCH), n_layers=layers, **BF16)
    tcfg = dataclasses.replace(configs.get_smoke_config(ARCH), n_layers=layers,
                               attn_backend="xla", ssm_backend="xla", **BF16)
    rp = ref_lm.init_params(jax.random.PRNGKey(1), rcfg)
    tp = params_from_numpy(jax.device_get(rp), dtype=torch.bfloat16)
    tokens = np.random.default_rng(0).integers(
        0, rcfg.vocab_size, (2, 128)).astype(np.int32)

    ref_xla = _ref_logits(rp, rcfg, tokens, "xla")
    ref_kernel = _ref_logits(rp, rcfg, tokens, "pallas_interpret")
    got, _ = lm.forward_train(tp, tcfg,
                              {"tokens": torch.from_numpy(tokens).long()})
    got = got.float().numpy()

    bound = float(np.abs(ref_kernel - ref_xla).max())
    gap = float(np.abs(got - ref_xla).max())
    print(f"{layers} layers: port vs reference {gap:.4f}, reference's "
          f"kernel vs xla {bound:.4f}, max |logit| {np.abs(ref_xla).max():.2f}")
    assert np.isfinite(got).all() and got.shape == ref_xla.shape
    assert 0.0 < bound < 1.0          # the bound is a real, small gap
    assert gap <= bound
