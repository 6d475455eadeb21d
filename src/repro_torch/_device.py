"""Where the port's entry points run: the CUDA device unless asked otherwise.

Nothing carries on on the CPU when it finds no GPU: ``device=None`` means
``"cuda"``, and asking for CUDA on a machine without it raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def device_count(device: Optional[torch.device]) -> int:
    """Local devices of ``device``'s kind: the CUDA device count on CUDA,
    else 1 (the reference's ``jax.device_count()``)."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1
