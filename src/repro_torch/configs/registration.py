"""The paper's own application config: prefix-scan TEM series registration."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RegistrationAppConfig:
    n_frames: int = 4096          # the paper's series length
    image_size: int = 96          # synthetic stand-in (paper: 1920x1856)
    period: float = 12.0
    noise: float = 0.15
    # scan execution
    strategy: str = "reduce_then_scan"
    algorithm: str = "ladner_fischer"   # global circuit
    ranks: int = 86                     # paper: 1024 cores = 86 ranks x 12 threads
    threads: int = 12
    stealing: bool = True
    # registration operator
    levels: int = 2
    max_iters: int = 300


CONFIG = RegistrationAppConfig()
SMOKE = RegistrationAppConfig(
    n_frames=16, image_size=64, ranks=2, threads=2, max_iters=100
)
