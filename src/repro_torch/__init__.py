"""repro_torch — the PyTorch/CUDA port of ``repro``, the work-stealing prefix
scan for large-scale image registration.

It mirrors the JAX package's layout and names and imports nothing of it.
Public surface:

* :func:`register_series` — end-to-end TEM series registration through the
  scan engine, one-shot batch entry point (``repro_torch.pipeline``).
* :func:`open_series` — series sessions on the shared worker pool:
  ``session.feed(chunk)`` streaming ingest, ``session.extend(frames)``
  incremental suffix folding (``repro_torch.service``).
* :func:`scan` — the engine's generic prefix-scan entry point
  (``repro_torch.core.engine``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``.  All are imported lazily so ``import repro_torch`` stays
light.
"""

from typing import Any

__all__ = [
    "RegisterSeriesConfig",
    "SeriesResult",
    "SeriesSession",
    "open_series",
    "register_series",
    "scan",
]


def __getattr__(name: str) -> Any:
    if name in ("register_series", "RegisterSeriesConfig", "SeriesResult"):
        from . import pipeline

        return getattr(pipeline, name)
    if name in ("open_series", "SeriesSession"):
        from . import service

        return getattr(service, name)
    if name == "scan":
        from .core.engine import scan

        return scan
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
