"""Zamba2-7B: Mamba2 backbone + weight-shared attention [arXiv:2411.15242].

81 layers as 27 superblocks of (mamba2, mamba2, shared_attn): 54 Mamba2
blocks + 27 applications of ONE shared attention+MLP block.  ssm_state=64.
The Mamba2 SSD scan is the paper's reduce-then-scan as a model layer.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    block_pattern=("mamba2", "mamba2", "shared_attn"),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="zamba2-7b-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, ssm_state=16,
    param_dtype="float32", compute_dtype="float32",
)
