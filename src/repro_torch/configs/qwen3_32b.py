"""Qwen3-32B: dense, 64L, GQA kv=8, qk_norm, head_dim=128 [hf:Qwen/Qwen3-8B]."""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen3-32b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
    vocab_size=512, param_dtype="float32", compute_dtype="float32",
)
