"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``
(port of ``repro/configs``).

It lists only the configurations the port can run: Zamba2-7B (Mamba2 and
shared attention blocks).  The reference's other nine wait for their block
kinds (``ROADMAP.md`` Queue 1, the LM configurations and block kinds);
asking for any other name raises
``NotImplementedError``.
"""

from __future__ import annotations

from importlib import import_module
from typing import List

from repro_torch.models.config import ArchConfig

_ARCHS = [
    "zamba2_7b",
]

ALIASES = {
    "zamba2-7b": "zamba2_7b",
}


def list_archs() -> List[str]:
    return list(_ARCHS)


def _module(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in _ARCHS:
        raise NotImplementedError(
            f"config {name!r} is not ported (the port has {list(ALIASES)}; "
            "the reference's others wait for the LM configurations and "
            "block kinds, ROADMAP.md Queue 1)"
        )
    return import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE
