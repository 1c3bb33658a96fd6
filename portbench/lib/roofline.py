"""Peaks of the card and the work of a kernel, counted from shapes.

The counts depend on the operation, never on how the program implements
it: a split-precision product that runs six bf16 passes is charged one
product, and each input and output byte is charged once.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The roofline's least time: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def mdct_analysis(rows: int, blocks: int, n: int, itemsize: int = 4):
    """(FLOPs, bytes) of one MDCT analysis of ``rows`` signals of
    ``blocks`` blocks of N samples into blocks + 1 frames of N bins: one
    [frames, N] x [N, N] product a row; the signal read once, the frames
    written once."""
    frames = blocks + 1
    flops = 2.0 * rows * frames * n * n
    nbytes = itemsize * rows * n * (blocks + frames)
    return flops, nbytes


def mdct_synthesis(rows: int, frames: int, n: int, itemsize: int = 4):
    """(FLOPs, bytes) of one MDCT synthesis of ``frames`` frames into
    frames + 1 blocks of overlap-added samples."""
    flops = 2.0 * rows * frames * n * n
    nbytes = itemsize * rows * n * (frames + frames + 1)
    return flops, nbytes
