"""xLSTM-350M: 24 blocks of sLSTM + mLSTM (3:1 m:s) [arXiv:2405.04517].

d_ff=0 per the assignment: mLSTM/sLSTM blocks carry their own projections,
there is no separate MLP.  The mLSTM sequence mix runs through the chunked
SSD scan (the paper's reduce-then-scan); sLSTM is a nonlinear recurrence
(lax.scan over time) — see DESIGN.md §Arch-applicability.
"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
)

SMOKE = dataclasses.replace(
    CONFIG,
    name="xlstm-350m-smoke",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
    vocab_size=512, param_dtype="float32", compute_dtype="float32",
)
