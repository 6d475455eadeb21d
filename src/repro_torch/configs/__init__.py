"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``
(port of ``repro/configs``).

It lists the configurations the port can run, in the reference's order:
the dense ones (``attn`` blocks), xLSTM-350M (mLSTM and sLSTM blocks) and
Zamba2-7B (Mamba2 and shared attention blocks).  The reference's MoE
configurations and those with a frontend wait for their block kinds
(``ROADMAP.md`` Queue 1, the LM configurations and block kinds); asking for
one of them, or any other name, raises ``NotImplementedError``.
"""

from __future__ import annotations

from importlib import import_module
from typing import List

from repro_torch.models.config import ArchConfig

_ARCHS = [
    "codeqwen1_5_7b",
    "internlm2_20b",
    "qwen3_32b",
    "qwen2_72b",
    "xlstm_350m",
    "zamba2_7b",
]

ALIASES = {
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "internlm2-20b": "internlm2_20b",
    "qwen3-32b": "qwen3_32b",
    "qwen2-72b": "qwen2_72b",
    "xlstm-350m": "xlstm_350m",
    "zamba2-7b": "zamba2_7b",
}


def list_archs() -> List[str]:
    return list(_ARCHS)


def _module(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in _ARCHS:
        raise NotImplementedError(
            f"config {name!r} is not ported (the port has {list(ALIASES)}; "
            "the reference's MoE and frontend configurations wait for the "
            "LM configurations and block kinds, ROADMAP.md Queue 1)"
        )
    return import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE
