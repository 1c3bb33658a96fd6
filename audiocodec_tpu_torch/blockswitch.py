"""Block switching in PyTorch (counterpart of ``audiocodec_tpu/blockswitch.py``):
per-frame long/short transform selection for transients.

The long spectrum of a frame is y = O_N f / s (O_N the orthonormal DCT-IV of
the folded frame f). A block-diagonal bank of ``factor`` orthonormal DCT-IVs
of size M = N/factor on the same folded frame gives the short-time form

    y_short = BD(O_M) f / s = [BD(O_M) @ O_N] y = T y,       T orthogonal,

so block switching is one [N, N] change of basis after the standard
transform, and the per-frame choice is a ``where``. The product follows the
codec's precision tier (``ops/dct.matmul``; "int8" maps to "default", the
switched input being spectra). The matrices are built once per (N, factor,
dtype, device). Threshold pooling is elementwise (reshape, min), so both
sides of the wire pool identically. The flags ride the container.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audiocodec_tpu_torch.ops import dct as _dct
from audiocodec_tpu_torch.utils import dtypes as _dtypes

FACTOR = 8  # sub-blocks per short frame (AAC's eight-short)

# A frame goes short when its loudest sub-block's energy exceeds the mean of
# its 3 quietest (floored at DETECT_NOISE_REL of the loudest) by this factor
DETECT_RATIO = 30.0
DETECT_NOISE_REL = 1e-4
# frames whose total spectral energy is at most this never switch: an
# absolute floor, so flags are a pure per-frame function
DETECT_FLOOR = 1e-12


@functools.lru_cache(maxsize=8)
def _transition_matrix_f64(filters_n: int, factor: int) -> np.ndarray:
    """T = BD(O_M) @ O_N as a right-multiply matrix (O_N @ BD), float64."""
    if filters_n % factor != 0:
        raise ValueError(
            f"filters_n={filters_n} not divisible by factor={factor}"
        )
    m = filters_n // factor
    o_m = _dct.dct4_matrix(m)
    bd = np.zeros((filters_n, filters_n), dtype=np.float64)
    for s in range(factor):
        bd[s * m : (s + 1) * m, s * m : (s + 1) * m] = o_m
    return _dct.dct4_matrix(filters_n) @ bd


@functools.lru_cache(maxsize=16)
def _matrices(filters_n: int, factor: int, dtype: torch.dtype,
              device: torch.device):
    t = torch.from_numpy(_transition_matrix_f64(filters_n, factor))
    return (t.to(device=device, dtype=dtype),
            t.T.contiguous().to(device=device, dtype=dtype))


def transition_matrices(filters_n: int, factor: int = FACTOR,
                        dtype=torch.float32, device="cuda"):
    """(fwd, inv) right-multiply matrices on ``device``: y_short = y @ fwd,
    y_long = y_short @ inv; float64 for a float64 pipeline, else float32.
    Built once per (N, factor, dtype, device)."""
    mat_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    return _matrices(filters_n, factor, mat_dtype, torch.device(device))


def _apply(spectrum: torch.Tensor, mat: torch.Tensor,
           precision: str = "highest") -> torch.Tensor:
    """[B, F, N, C] @ [N, N] along the bin axis at the tier ``precision``."""
    if precision == "int8":
        precision = "default"
    y = _dct.matmul(spectrum.to(mat.dtype).transpose(-2, -1), mat, precision)
    return y.transpose(-2, -1).to(spectrum.dtype)


def split_spectrum(spectrum: torch.Tensor, flags: torch.Tensor,
                   factor: int = FACTOR,
                   precision: str = "highest") -> torch.Tensor:
    """Long spectrum -> the switched representation: frames flagged True
    [B, frames] become ``factor`` time-ordered M-bin sub-spectra; long
    frames pass through."""
    fwd, _ = transition_matrices(spectrum.shape[2], factor, spectrum.dtype,
                                 spectrum.device)
    short = _apply(spectrum, fwd, precision)
    return torch.where(flags[:, :, None, None], short, spectrum)


def merge_spectrum(spectrum_sw: torch.Tensor, flags: torch.Tensor,
                   factor: int = FACTOR,
                   precision: str = "highest") -> torch.Tensor:
    """The switched representation -> long spectrum (the inverse of
    :func:`split_spectrum`; T is orthogonal)."""
    _, inv = transition_matrices(spectrum_sw.shape[2], factor,
                                 spectrum_sw.dtype, spectrum_sw.device)
    long = _apply(spectrum_sw, inv, precision)
    return torch.where(flags[:, :, None, None], long, spectrum_sw)


def detect(spectrum: torch.Tensor, factor: int = FACTOR,
           ratio: float = DETECT_RATIO,
           precision: str = "highest") -> torch.Tensor:
    """Per-frame transient flags from the short-basis envelope: by Parseval
    the energy of sub-spectrum s is that of segment s of the folded frame.
    A frame switches on loud/quiet contrast, channels pooled by max (joint
    stereo needs one flag a frame), if its energy is above DETECT_FLOOR.

    :param spectrum: [B, frames, N, C] long spectrum.
    :return: bool [B, frames].
    """
    b, f, n, c = spectrum.shape
    fwd, _ = transition_matrices(n, factor, spectrum.dtype, spectrum.device)
    short = _apply(spectrum, fwd, precision)
    e = torch.sum(
        short.to(torch.float32).reshape(b, f, factor, n // factor, c) ** 2,
        dim=3,
    )  # [B, F, factor, C]
    e = torch.amax(e, dim=-1)  # channel pool -> [B, F, factor]
    peak = torch.amax(e, dim=-1)
    quiet = torch.div(
        torch.sum(torch.sort(e, dim=-1).values[..., :3], dim=-1),
        _dtypes.divisor(3.0, e.dtype, e.device),
    )
    floor = torch.clamp_min(DETECT_NOISE_REL * peak, 1e-30)
    contrast = peak > ratio * torch.maximum(quiet, floor)
    loud = torch.sum(e, dim=-1) > DETECT_FLOOR
    return contrast & loud


def pool_threshold(threshold: torch.Tensor, flags: torch.Tensor,
                   factor: int = FACTOR) -> torch.Tensor:
    """Masking threshold of the switched representation: short-basis bin j
    of every sub-block spans the long bins [factor*j, factor*(j+1)), whose
    threshold amplitudes it MIN-pools; long frames are untouched. Part of
    the wire format: both sides pool identically.

    :param threshold: [B, frames, N, C]; ``flags`` bool [B, frames].
    """
    b, f, n, c = threshold.shape
    m = n // factor
    pooled = torch.amin(threshold.reshape(b, f, m, factor, c), dim=3)
    tiled = pooled.repeat(1, 1, factor, 1)
    return torch.where(flags[:, :, None, None], tiled, threshold)


def pack_flags(flags: torch.Tensor) -> np.ndarray:
    """bool [B, frames] -> uint8 bitmap [B, ceil(frames/8)] (the container's
    wire form; np.packbits' big-endian bit order)."""
    return np.packbits(flags.detach().cpu().numpy().astype(bool), axis=-1)


def unpack_flags(bits, frames: int, device="cuda") -> torch.Tensor:
    """Inverse of :func:`pack_flags`: bool [B, frames] on ``device``."""
    out = np.unpackbits(np.asarray(bits, dtype=np.uint8), axis=-1)
    if out.shape[-1] < frames:
        raise ValueError(
            f"flag bitmap holds {out.shape[-1]} frames < {frames}"
        )
    return torch.from_numpy(out[..., :frames].astype(bool)).to(device)
