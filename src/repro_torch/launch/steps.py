"""The step functions of serving (port of ``repro/launch/steps.py``).

PyTorch runs eagerly, so a step is the model function with its config
bound.  ``make_train_step`` and the ``*_struct`` dry-run helpers come with
LM training and LM multi-device (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch, states):
        with torch.no_grad():
            return lm.prefill(params, cfg, batch, states)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, token, pos, states):
        with torch.no_grad():
            return lm.decode_step(params, cfg, token, pos, states)

    return decode_step
