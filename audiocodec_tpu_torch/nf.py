"""Noise filling in PyTorch (counterpart of ``audiocodec_tpu/nf.py``):
spectral-hole repair for low-rate bitstreams.

The encoder transmits one uint8 level per (frame, channel), log-coding the
half-width of uniform noise in units of each bin's own step size; the
decoder refills the zero-coded bins of the band with that noise. The noise
is drawn per (batch, global frame) from the threefry stream of the
container's seed (``ops/threefry.py``, bit for bit ``jax.random``), so a
chunked decode, a seek and a whole-file decode all reconstruct the same
waveform, and so does the JAX package.
"""

from __future__ import annotations

import torch

from audiocodec_tpu_torch.ops import threefry as _threefry
from audiocodec_tpu_torch.utils import dtypes as _dtypes

# level 0 = no fill, else the half-width in step units is
# a = 2^((level - LEVEL_BIAS) / LEVEL_K): 0.38 dB steps, a in
# [2^-14.9, 2^0.94] over levels 1..255
LEVEL_K = 16.0
LEVEL_BIAS = 240.0


def level_to_amp(levels: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 levels -> noise half-width in step units (0 stays 0)."""
    lv = levels.to(dtype)
    amp = torch.exp2((lv - LEVEL_BIAS) / LEVEL_K)
    return torch.where(lv > 0, amp, 0.0)


def default_band_start(filters_n: int) -> int:
    """First bin the fill covers (bin N/16, ~1.3 kHz at 44.1 kHz)."""
    return filters_n // 16


def _check_band(band_start: int, band_end: int) -> None:
    """Both sides refuse an empty fill band (a bwe crossover at or below the
    fill's start), so that an encode fails rather than writing a container
    its decoder cannot read."""
    if band_end <= band_start:
        raise ValueError(
            f"noise-fill band is empty: band_start={band_start} >= "
            f"band_end={band_end} (with bandwidth extension the bwe "
            "crossover caps the fill band — this configuration puts it "
            "at or below the fill's start; disable --nf or --bwe, or "
            "change filters_n/sample_rate)"
        )


def analyze(spec: torch.Tensor, codes: torch.Tensor, delta: torch.Tensor,
            band_start: int, *, deadzone: float = 0.5,
            band_end: int | None = None,
            exclude: torch.Tensor | None = None) -> torch.Tensor:
    """Per-(frame, channel) fill level: the half-width a (in step units)
    whose total power matches the energy the quantizer zeroed in the band,
    a = sqrt(3 * sum(x^2) / sum(delta^2)) over the zeroed bins, capped at
    sqrt(3) * deadzone.

    :param spec: the spectrum the quantizer saw [B, frames, N, C].
    :param codes: its integer codes; ``delta`` the step sizes used.
    :param band_end: one past the last bin the fill covers (None = N);
        bandwidth extension caps it at its crossover.
    :param exclude: bool [N, C] bins another mechanism owns
        (intensity.owned_mask), neither metered nor filled.
    :return: uint8 [B, frames, C] levels.
    """
    wdt = _dtypes.sidecar_work_dtype(spec)
    end = spec.shape[-2] if band_end is None else band_end
    _check_band(band_start, end)
    s = spec[..., band_start:end, :].to(wdt)
    d = delta[..., band_start:end, :].to(wdt)
    zero = (codes[..., band_start:end, :] == 0).to(wdt)
    if exclude is not None:
        zero = zero * (~exclude[band_start:end, :]).to(wdt)
    cnt = torch.sum(zero, dim=-2)  # [B, F, C]
    e_lost = torch.sum(torch.square(s) * zero, dim=-2)
    e_cap = torch.sum(torch.square(d) * zero, dim=-2)
    a = torch.sqrt(3.0 * e_lost / torch.clamp_min(e_cap, 1e-30))
    a = torch.clamp_max(a, 3.0**0.5 * deadzone)
    level = torch.round(
        LEVEL_BIAS + LEVEL_K * torch.log2(torch.clamp_min(a, 1e-30))
    )
    # everything the wire can represent is kept: at aggressive scales the
    # ratio collapses while the lost energy stays audible
    keep = (cnt > 0) & (a > 2.0 ** ((1 - LEVEL_BIAS) / LEVEL_K))
    level = torch.where(keep, level, 0.0)
    return torch.clamp(level, 0, 255).to(torch.uint8)


def noise(seed, batch: int, frames: int, shape, dtype: torch.dtype,
          frame_offset=0, device="cuda") -> torch.Tensor:
    """The fill noise of every (batch, frame): uniforms in [-1, 1) of
    ``shape`` under the keys ``fold_in(fold_in(key(seed), b),
    frame_offset + f)``, drawn in one call: [batch, frames, *shape]."""
    k = _threefry.key(seed)
    kb = _threefry.fold_in(k, torch.arange(batch, device=device))
    f = frame_offset + torch.arange(frames, device=device)
    kf = _threefry.fold_in((kb[0][:, None], kb[1][:, None]), f[None, :])
    return _threefry.uniform(kf, shape, dtype, -1.0, 1.0)


def fill(spec: torch.Tensor, codes: torch.Tensor, delta: torch.Tensor,
         levels: torch.Tensor, band_start: int, seed,
         frame_offset=0, band_end: int | None = None,
         exclude: torch.Tensor | None = None) -> torch.Tensor:
    """Decoder fill: add uniform noise of half-width
    ``level_to_amp(level) * delta`` to every zero-code bin of the band.

    :param spec: dequantized spectrum [B, F, N, C], in the coded domain
        (before the TNS inverse filter and the mid/side derotation).
    :param levels: uint8 [B, F, C] from :func:`analyze`.
    :param seed: the container's uint32 noise seed (an int; a negative
        int32 is taken modulo 2^32).
    :param frame_offset: global index of ``spec``'s first frame.
    :param band_end: must match the encoder's (the draw's shape depends
        on it); ``exclude`` must match too (it masks the write, not the
        draw).
    :return: the spectrum with its holes filled, ``spec``'s shape and
        dtype.
    """
    b_n, f_n, n_bins, c_n = spec.shape
    end = n_bins if band_end is None else band_end
    _check_band(band_start, end)
    band = spec[..., band_start:end, :]
    u = noise(seed, b_n, f_n, (end - band_start, c_n), band.dtype,
              frame_offset, spec.device)
    amp = level_to_amp(levels, band.dtype)[..., None, :] * delta[
        ..., band_start:end, :].to(band.dtype)
    hole = codes[..., band_start:end, :] == 0
    if exclude is not None:
        hole = hole & ~exclude[band_start:end, :]
    band = band + torch.where(hole, u * amp, 0.0)
    return torch.cat(
        [spec[..., :band_start, :], band, spec[..., end:, :]], dim=-2
    )
