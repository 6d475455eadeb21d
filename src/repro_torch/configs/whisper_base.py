"""Whisper-base: 6L encoder + 6L decoder, d=512, conv frontend STUB
[arXiv:2212.04356].  input_specs() provides 1500 precomputed frame embeddings
(post-conv) to the encoder; the decoder cross-attends every block.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    frontend="audio",
    frontend_len=1500,
    block_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="whisper-base-smoke",
    n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, frontend_len=32,
    param_dtype="float32", compute_dtype="float32",
)
