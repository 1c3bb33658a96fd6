"""Intensity stereo in PyTorch (counterpart of ``audiocodec_tpu/intensity.py``):
a pan-coded side channel above a crossover.

At and above the crossover the side channel is no longer coded: its codes
are forced to zero and one signed log-gain per (frame, 16-bin group)
carries the least-squares projection of the side spectrum onto the
decoder's own mid reconstruction; the decoder rebuilds side = gain * mid
there. Noise filling and bandwidth extension exclude the owned region on
both sides (:func:`owned_mask`, kept on the device once per (N, crossover,
device)). Short block-switch frames are not forced; their gains read 0.

Wire format: uint8 per (frame, group): 0 = no fill, else bit 7 the sign
and bits 0-6 a 1.5 dB log magnitude; levels past LEVEL_MAX decode as the
GAIN_CEIL = 8x ceiling.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audiocodec_tpu_torch import bwe as _bwe
from audiocodec_tpu_torch.utils import dtypes as _dtypes

GROUP = 16

# |g| = 2^((level - BIAS) / K): usable levels 1..LEVEL_MAX span [-131, +18]
# dB around unity; the ceiling is a format rule enforced by the fill too
LEVEL_K = 4.0
LEVEL_BIAS = 88.0
GAIN_CEIL = 8.0
LEVEL_MAX = int(LEVEL_BIAS + LEVEL_K * np.log2(GAIN_CEIL))  # = 100
_SIGN_BIT = 128


def default_start(filters_n: int, sample_rate: int) -> int:
    """Default crossover bin: ~6 kHz, rounded to a GROUP multiple, with at
    least one coded group."""
    bin_hz = sample_rate / (2.0 * filters_n)
    start = int(round(6000.0 / bin_hz / GROUP)) * GROUP
    return int(np.clip(start, GROUP, filters_n - GROUP))


def validate_start(filters_n: int, start: int) -> None:
    """Raise unless ``start`` is a legal crossover for this band count."""
    if (
        not GROUP <= start <= filters_n - GROUP
        or start % GROUP
        or (filters_n - start) % GROUP
    ):
        raise ValueError(
            f"intensity start {start} must be a multiple of {GROUP} in "
            f"[{GROUP}, {filters_n - GROUP}] for filters_n={filters_n}"
        )


def n_groups(filters_n: int, start: int) -> int:
    return (filters_n - start) // GROUP


@functools.lru_cache(maxsize=None)
def _owned_mask(filters_n: int, start: int,
                device: torch.device) -> torch.Tensor:
    validate_start(filters_n, start)
    m = torch.zeros(filters_n, 2, dtype=torch.bool)
    m[start:, 1] = True
    return m.to(device)


def owned_mask(filters_n: int, start: int, device="cuda") -> torch.Tensor:
    """bool [N, 2] on ``device``: True where intensity owns the bin (the
    side channel at and above the crossover), the ``exclude`` mask of
    noise filling and bandwidth extension on both sides. Built once per
    (N, start, device)."""
    return _owned_mask(filters_n, start, torch.device(device))


def _check_stereo(spec: torch.Tensor) -> None:
    if spec.shape[-1] != 2:
        raise ValueError(
            "intensity stereo needs the mid/side layout (exactly 2 "
            f"channels), got {spec.shape[-1]}"
        )


def force_codes(codes: torch.Tensor, start: int,
                bs_flags: torch.Tensor | None = None) -> torch.Tensor:
    """Encoder-side: zero the side-channel codes at and above ``start``;
    short block-switch frames keep theirs."""
    _check_stereo(codes)
    validate_start(codes.shape[-2], start)
    keep = ~owned_mask(codes.shape[-2], start, codes.device)
    if bs_flags is not None:
        keep = keep | bs_flags[:, :, None, None]
    return torch.where(keep, codes, 0)


def mid_reference(codes: torch.Tensor, delta: torch.Tensor, dtype,
                  bwe_gains: torch.Tensor | None = None,
                  bwe_start: int = 0,
                  exclude: torch.Tensor | None = None) -> torch.Tensor:
    """The full-band mid both sides project onto and scale: the plain
    ``codes * delta``, with the bwe reconstruction when bandwidth extension
    is active (wire data only: no dead-zone offset, no fill noise).

    :return: [B, F, N] mid reconstruction.
    """
    _check_stereo(codes)
    plain = codes.to(dtype) * delta.to(dtype)
    if bwe_gains is not None:
        plain = _bwe.fill(plain, codes, delta, bwe_gains, bwe_start,
                          exclude=exclude)
    return plain[..., 0]


def gain_to_amp(gains: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 wire gains -> signed linear amplitude (0 stays 0); magnitude
    levels above LEVEL_MAX decode as GAIN_CEIL."""
    g = gains.to(torch.int32)
    lvl = torch.clamp_max(g & (_SIGN_BIT - 1), LEVEL_MAX)
    mag = torch.exp2((lvl.to(dtype) - LEVEL_BIAS) / LEVEL_K)
    signed = torch.where(g >= _SIGN_BIT, -mag, mag)
    return torch.where(g > 0, signed, 0.0)


def _group_sum(a: torch.Tensor) -> torch.Tensor:
    b, f, w = a.shape
    return torch.sum(a.reshape(b, f, w // GROUP, GROUP), dim=-1)


def analyze(spec: torch.Tensor, codes: torch.Tensor, delta: torch.Tensor,
            start: int, mid_ref: torch.Tensor | None = None) -> torch.Tensor:
    """Per-(frame, group) signed image gain of the dropped side band: the
    projection g = sum(side * mid) / sum(mid^2) over the group's zero-coded
    side bins. Groups below the grid's floor (silent mids among them)
    transmit 0.

    :param spec: the mid/side spectrum the quantizer saw [B, frames, N, 2].
    :param codes: the codes after :func:`force_codes`.
    :param mid_ref: the full-band mid the decoder will scale [B, frames, N];
        None = the plain ``codes * delta`` mid. With bandwidth extension
        both sides pass the bwe-reconstructed mid.
    :return: uint8 [B, frames, n_groups] wire gains.
    """
    _check_stereo(spec)
    validate_start(spec.shape[-2], start)
    wdt = _dtypes.sidecar_work_dtype(spec)
    if mid_ref is None:
        mid_hat = (codes.to(wdt) * delta.to(wdt))[..., start:, 0]
    else:
        mid_hat = mid_ref.to(wdt)[..., start:]
    side = spec[..., start:, 1].to(wdt)
    zero = (codes[..., start:, 1] == 0).to(wdt)
    num = _group_sum(side * mid_hat * zero)
    den = _group_sum(torch.square(mid_hat) * zero)
    g = num / torch.clamp_min(den, 1e-30)
    mag = torch.abs(g)
    level = torch.round(
        LEVEL_BIAS + LEVEL_K * torch.log2(torch.clamp_min(mag, 1e-30))
    )
    level = torch.clamp(level, 1, LEVEL_MAX)
    level = torch.where(mag >= 2.0 ** ((1 - LEVEL_BIAS) / LEVEL_K), level,
                        0.0)
    level = torch.where((g < 0) & (level > 0), level + _SIGN_BIT, level)
    return level.to(torch.uint8)


def fill(spec: torch.Tensor, codes: torch.Tensor, delta: torch.Tensor,
         gains: torch.Tensor, start: int,
         mid_ref: torch.Tensor | None = None) -> torch.Tensor:
    """Decoder: every zero-coded side bin at and above ``start`` becomes
    its group gain times the mid reconstruction at the same bin (no
    per-bin clamp: the dropped bins held real content; GAIN_CEIL bounds
    the fill).

    :param spec: dequantized mid/side spectrum [B, F, N, 2], coded domain.
    :param gains: uint8 [B, F, n_groups] from :func:`analyze`.
    :param mid_ref: must match what the encoder projected onto.
    """
    _check_stereo(spec)
    validate_start(spec.shape[-2], start)
    if mid_ref is None:
        mid_hat = (codes.to(spec.dtype)
                   * delta.to(spec.dtype))[..., start:, 0]
    else:
        mid_hat = mid_ref.to(spec.dtype)[..., start:]
    amp = torch.repeat_interleave(gain_to_amp(gains, spec.dtype), GROUP,
                                  dim=-1)
    hole = codes[..., start:, 1] == 0
    side = spec[..., start:, 1] + torch.where(hole, amp * mid_hat, 0.0)
    return torch.cat(
        [spec[..., :start, :],
         torch.stack([spec[..., start:, 0], side], dim=-1)],
        dim=-2,
    )
