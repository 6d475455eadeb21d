"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``
(port of ``repro/configs``).

It lists the reference's ten configurations, in its order: the dense ones
(``attn`` blocks), xLSTM-350M (mLSTM and sLSTM blocks), Zamba2-7B (Mamba2
and shared attention blocks), the two MoE ones (``moe`` blocks) and the two
with a frontend (InternVL2-1B's patch prefix, Whisper-base's encoder and
cross-attention).  Full configs run at their published widths; smoke
configs are reduced same-family models for the CPU.  An unknown name
raises ``ModuleNotFoundError``, as the reference's ``import_module`` does.
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
    "phi3_5_moe_42b",
    "arctic_480b",
    "internvl2_1b",
    "whisper_base",
]

ALIASES = {
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "internlm2-20b": "internlm2_20b",
    "qwen3-32b": "qwen3_32b",
    "qwen2-72b": "qwen2_72b",
    "xlstm-350m": "xlstm_350m",
    "zamba2-7b": "zamba2_7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "arctic-480b": "arctic_480b",
    "internvl2-1b": "internvl2_1b",
    "whisper-base": "whisper_base",
}


def list_archs() -> List[str]:
    return list(_ARCHS)


def _module(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in _ARCHS:
        raise ModuleNotFoundError(
            f"no config {name!r} (the registry has {list(ALIASES)})"
        )
    return import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE
