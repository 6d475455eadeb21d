"""CodeQwen1.5-7B: dense, 32L, GQA kv=32 (full MHA) [hf:Qwen/CodeQwen1.5-7B]."""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,            # qwen1.5 family uses QKV bias
    rope_theta=1e6,
    block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="codeqwen1.5-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, param_dtype="float32", compute_dtype="float32",
)
