"""InternLM2-20B: dense, 48L, GQA kv=8 [arXiv:2403.17297]."""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1e6,
    block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="internlm2-20b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, param_dtype="float32", compute_dtype="float32",
)
