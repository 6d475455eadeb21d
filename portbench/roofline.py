"""Peaks of the card and the least work of the kernels the cells time.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates, at the full
700 W power limit); the bf16 rate is for the readers of cells to come,
such as an ``mfu`` of the LM path.  A kernel's least time is the larger of
the bytes it must move over the memory rate and the operations it must do
over the compute rate; its roofline share is that least time over its
measured device time.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS) -> float:
    """The least seconds: bytes over the memory rate or operations over the
    compute rate, whichever is larger."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def guess_check_work(height: int, width: int) -> tuple:
    """``(bytes, flops)`` that one guess check needs: ``1 - NCC(ref, tmpl o
    phi)`` for one pair of float32 frames reads the template and the
    reference once and writes one number (8 bytes: the NCC and its
    distance).  About 30 operations a pixel: the rotated coordinates, the
    clamp, the four-tap bilinear blend and the five running sums.  The
    warped frame is not needed by the check, so it is not counted."""
    pixels = height * width
    return 2 * pixels * 4 + 8, 30 * pixels
