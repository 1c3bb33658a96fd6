"""Bandwidth extension in PyTorch (counterpart of ``audiocodec_tpu/bwe.py``):
spectral gap filling by low-band replication.

The decoder rebuilds zero-coded bins above a crossover by copying the plain
``codes * delta`` reconstruction of the low band up in frequency and scaling
each 16-bin group to a transmitted envelope: one uint8 gain per (frame,
group, channel), log-coding the amplitude ratio between the lost energy and
the copied source. The copy-up map is a static index vector, kept on the
device once per (N, crossover, device). With noise filling active, both
sides cap the fill's band at the crossover: bwe owns [start, N).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audiocodec_tpu_torch.utils import dtypes as _dtypes

# bins per transmitted gain group (~690 Hz at 44.1 kHz, N=1024)
GROUP = 16

# gains are log-coded: level 0 = no fill, else the amplitude ratio is
# g = 2^((level - BIAS) / K), 1.5 dB steps
LEVEL_K = 4.0
LEVEL_BIAS = 128.0

# per-bin fill ceiling in units of the target bin's own step size (a
# zero-coded bin held less than ~delta); part of the format
FILL_CLAMP = 1.0


def default_start(filters_n: int, sample_rate: int) -> int:
    """Default crossover bin: ~10.5 kHz, rounded to a GROUP multiple, with a
    source region and at least one replicated group."""
    bin_hz = sample_rate / (2.0 * filters_n)
    start = int(round(10500.0 / bin_hz / GROUP)) * GROUP
    return int(np.clip(start, GROUP, filters_n - GROUP))


def validate_start(filters_n: int, start: int) -> None:
    """Raise unless ``start`` is a legal crossover for this band count."""
    if (
        not GROUP <= start <= filters_n - GROUP
        or start % GROUP
        or (filters_n - start) % GROUP
    ):
        raise ValueError(
            f"bwe start {start} must be a multiple of {GROUP} in "
            f"[{GROUP}, {filters_n - GROUP}] for filters_n={filters_n}"
        )


def n_groups(filters_n: int, start: int) -> int:
    return (filters_n - start) // GROUP


def source_index(filters_n: int, start: int) -> np.ndarray:
    """Static copy-up map: target bin ``start + j`` reads source bin
    ``index[j]``, the widest GROUP-multiple window ending at the crossover,
    tiled upward when the target is wider."""
    validate_start(filters_n, start)
    width = filters_n - start
    src_width = min(width, (start // GROUP) * GROUP)
    return (start - src_width) + (np.arange(width) % src_width)


@functools.lru_cache(maxsize=None)
def _source_index(filters_n: int, start: int,
                  device: torch.device) -> torch.Tensor:
    return torch.from_numpy(source_index(filters_n, start)).to(device)


def _source(codes, delta, start, dtype):
    """The plain ``codes * delta`` reconstruction at the mapped-down
    positions of [start, N)."""
    idx = _source_index(codes.shape[-2], start, codes.device)
    plain = codes.to(dtype) * delta.to(dtype)
    return torch.index_select(plain, -2, idx)


def gain_to_amp(gains: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 gains -> linear amplitude ratio (0 stays 0)."""
    g = gains.to(dtype)
    amp = torch.exp2((g - LEVEL_BIAS) / LEVEL_K)
    return torch.where(g > 0, amp, 0.0)


def _group_sum(a: torch.Tensor) -> torch.Tensor:
    b, f, w, c = a.shape
    return torch.sum(a.reshape(b, f, w // GROUP, GROUP, c), dim=-2)


def analyze(spec: torch.Tensor, codes: torch.Tensor, delta: torch.Tensor,
            start: int, exclude: torch.Tensor | None = None) -> torch.Tensor:
    """Per-(frame, group, channel) replication gain: g = sqrt(sum(x^2) /
    sum(src^2)) over the group's zero-coded target bins, src the decoder's
    plain reconstruction at the mapped-down positions. Silent sources, and
    gains past the grid's ceiling, transmit 0.

    :param spec: the spectrum the quantizer saw [B, frames, N, C].
    :param exclude: bool [N, C] bins another mechanism owns
        (intensity.owned_mask), neither metered nor filled.
    :return: uint8 [B, frames, n_groups, C] gains.
    """
    wdt = _dtypes.sidecar_work_dtype(spec)
    src = _source(codes, delta, start, wdt)
    tgt = spec[..., start:, :].to(wdt)
    zero = (codes[..., start:, :] == 0).to(wdt)
    if exclude is not None:
        zero = zero * (~exclude[start:, :]).to(wdt)
    e_lost = _group_sum(torch.square(tgt) * zero)
    e_src = _group_sum(torch.square(src) * zero)
    g = torch.sqrt(e_lost / torch.clamp_min(e_src, 1e-30))
    level = torch.round(
        LEVEL_BIAS + LEVEL_K * torch.log2(torch.clamp_min(g, 1e-30))
    )
    keep = (e_lost > 0) & (g <= 2.0 ** ((255 - LEVEL_BIAS) / LEVEL_K))
    level = torch.where(keep, level, 0.0)
    return torch.clamp(level, 0, 255).to(torch.uint8)


def fill(spec: torch.Tensor, codes: torch.Tensor, delta: torch.Tensor,
         gains: torch.Tensor, start: int,
         exclude: torch.Tensor | None = None) -> torch.Tensor:
    """Decoder fill: every zero-coded bin above ``start`` receives its group
    gain times the plain reconstruction of its source bin, clamped to its
    own step size (FILL_CLAMP).

    :param spec: dequantized spectrum [B, F, N, C], in the coded domain.
    :param gains: uint8 [B, F, n_groups, C] from :func:`analyze`.
    :param exclude: must match the encoder's.
    """
    src = _source(codes, delta, start, spec.dtype)
    amp = torch.repeat_interleave(gain_to_amp(gains, spec.dtype), GROUP,
                                  dim=-2)
    hole = codes[..., start:, :] == 0
    if exclude is not None:
        hole = hole & ~exclude[start:, :]
    cap = FILL_CLAMP * delta[..., start:, :].to(spec.dtype)
    fill_v = torch.clamp(amp * src, min=-cap, max=cap)
    band = spec[..., start:, :] + torch.where(hole, fill_v, 0.0)
    return torch.cat([spec[..., :start, :], band], dim=-2)
