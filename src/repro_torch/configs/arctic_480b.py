"""Snowflake Arctic-480B: 35L, 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base]."""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    block_pattern=("moe",),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="arctic-480b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    n_experts=8, vocab_size=512, moe_group_size=64,
    param_dtype="float32", compute_dtype="float32",
)
