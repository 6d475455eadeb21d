"""InternVL2-1B: InternViT patch stub + InternLM2 LM backbone
[arXiv:2404.16821].  The ViT frontend is a STUB: input_specs() provides 256
precomputed patch embeddings at d_model width, prepended to the text tokens.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    rope_theta=1e6,
    frontend="patch",
    frontend_len=256,
    block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="internvl2-1b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, frontend_len=16,
    param_dtype="float32", compute_dtype="float32",
)
