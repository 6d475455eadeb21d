"""Phi-3.5-MoE-42B (6.6B active): 32L, 16 experts top-2, GQA kv=8
[hf:microsoft/Phi-3.5-MoE-instruct]."""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    top_k=2,
    block_pattern=("moe",),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="phi3.5-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    n_experts=4, vocab_size=512, moe_group_size=64,
    # Full fp32 including the KV cache: a bf16 cache perturbs decode hidden
    # states just enough to flip top-k router choices vs the fp32 forward
    # pass (routing is discontinuous), breaking prefill/decode parity.
    param_dtype="float32", compute_dtype="float32", cache_dtype="float32",
)
