"""Qwen2-72B: dense, 80L, GQA kv=8, QKV bias [arXiv:2407.10671]."""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="qwen2-72b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, param_dtype="float32", compute_dtype="float32",
)
