"""Temporal noise shaping in PyTorch (counterpart of ``audiocodec_tpu/tns.py``).

Open-loop linear prediction along frequency (Herre & Johnston 1996): a frame
whose time envelope is peaky has correlated MDCT coefficients across bins,
so an order-p predictor A(z) run over the frequency axis whitens them before
quantization, and the decoder's inverse filter 1/A(z) puts the envelope back
on everything in the frame, the quantization noise included.

Every stage is batched over (batch, frame, channel) lanes with the filter
order unrolled: the autocorrelation is p+1 multiply-reduces over the band,
Levinson-Durbin p vectorized steps, the encoder filter p shifted
multiply-adds. The decoder filter is a recursion along frequency, run p
bins a step: a loop over blocks of p bins, each step one batched
multiply-add of every lane's previous block (:func:`filter_inverse`).

Wire format: int8 reflection-coefficient indices [B, frames, order, C]
(all zero = identity filter). Both sides rebuild the LPC taps from the
dequantized reflection coefficients, so the two filters are exact inverses.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from audiocodec_tpu_torch.utils import dtypes as _dtypes

ORDER = 8

# 4-bit signed indices in [-QMAX, QMAX], k = sin(idx * pi/2 / (QMAX + 1)):
# uniform in the arcsine domain
QMAX = 7
_QSTEP = (math.pi / 2.0) / (QMAX + 1)

# In-band step sizes scale by (1/sqrt(G))^STEP_SCALE_EXP, G = 1/prod(1 - k^2)
# the prediction gain; part of the wire format
STEP_SCALE_EXP = 0.75


@functools.lru_cache(maxsize=None)
def _k_table(device: torch.device) -> torch.Tensor:
    """k = sin(idx * QSTEP) of every int8 index, float32, correctly rounded
    from float64 (idx + 128 indexes it): the CPU's torch.sin is one ulp off
    at idx = +-6, where the card's sinf and XLA's CPU sin may differ too."""
    arg = np.arange(-128, 128, dtype=np.float32) * np.float32(_QSTEP)
    return torch.from_numpy(np.sin(arg.astype(np.float64)).astype(
        np.float32)).to(device)


def _reflection(idx: torch.Tensor) -> torch.Tensor:
    """Dequantized reflection coefficients (float32) of int8 indices."""
    return _k_table(idx.device)[idx.to(torch.int64) + 128]


def default_band_start(filters_n: int) -> int:
    """First bin the filter covers (bin N/16, ~1.3 kHz at 44.1 kHz)."""
    return max(ORDER + 1, filters_n // 16)


# The filters' work dtype is the sidecar analyses' (float32, float64 for a
# float64 pipeline): an 8-tap recursion in bf16 loses ~2 digits
_work_dtype = _dtypes.sidecar_work_dtype


def _lanes_last(spec: torch.Tensor, band_start: int) -> torch.Tensor:
    # [B, F, N, C] -> the band as [B, F, C, M], frequency last
    return spec[..., band_start:, :].transpose(-2, -1).to(_work_dtype(spec))


def analyze(spec: torch.Tensor, band_start: int, *, order: int = ORDER,
            gain_min: float = 1.25) -> torch.Tensor:
    """Per-frame TNS analysis -> quantized reflection-coefficient indices.

    :param spec: MDCT spectra [B, frames, N, C] (the domain that will be
        quantized, after any mid/side rotation).
    :param gain_min: prediction-gain gate: frames whose order-p gain
        r[0]/err is at most this transmit all-zero indices.
    :return: int8 [B, frames, order, C] indices in [-QMAX, QMAX].
    """
    if spec.shape[-2] - band_start <= order:
        raise ValueError(
            f"TNS band ({spec.shape[-2]} - {band_start}) must exceed the "
            f"filter order {order}"
        )
    s = _lanes_last(spec, band_start)  # [B, F, C, M]
    m = s.shape[-1]
    r = [torch.sum(s * s, dim=-1)]
    for i in range(1, order + 1):
        r.append(torch.sum(s[..., : m - i] * s[..., i:], dim=-1))
    # white-noise correction keeps Levinson regular on silent frames
    r0 = r[0] * (1.0 + 1e-6) + 1e-20
    err = r0
    a: list[torch.Tensor] = []  # a[j] holds a_{j+1}
    ks = []
    for i in range(1, order + 1):
        acc = r[i]
        for j in range(1, i):
            acc = acc + a[j - 1] * r[i - j]
        k = torch.clamp(-acc / err, -0.999, 0.999)
        a = [a[j] + k * a[i - 2 - j] for j in range(i - 1)] + [k]
        err = err * (1.0 - k * k)
        ks.append(k)
    gain = r0 / torch.clamp_min(err, 1e-30)
    enable = gain > gain_min  # [B, F, C]
    kq = torch.stack(ks, dim=-1)  # [B, F, C, p]
    q = torch.div(torch.asin(kq), _dtypes.divisor(_QSTEP, kq.dtype, kq.device))
    idx = torch.clamp(torch.round(q), -QMAX, QMAX).to(torch.int8)
    idx = torch.where(enable[..., None], idx, torch.zeros_like(idx))
    return idx.transpose(-2, -1)  # [B, F, p, C]


def lpc_from_indices(idx: torch.Tensor) -> torch.Tensor:
    """Dequantize reflection indices and step up to LPC taps.

    :param idx: int8 [B, frames, order, C].
    :return: float32 [B, frames, order, C] taps a_1..a_p of
        A(z) = 1 + sum_i a_i z^-i (all-zero indices: all-zero taps).
    """
    k = _reflection(idx)  # [B, F, p, C]
    a: list[torch.Tensor] = []
    for i in range(1, k.shape[-2] + 1):
        ki = k[..., i - 1, :]
        a = [a[j] + ki * a[i - 2 - j] for j in range(i - 1)] + [ki]
    return torch.stack(a, dim=-2)


def scaled_threshold(threshold: torch.Tensor, idx: torch.Tensor,
                     band_start: int) -> torch.Tensor:
    """Noise-gain-compensated thresholds for TNS frames; encoder and decoder
    both derive step sizes from this. All-zero indices scale by exactly 1.

    :param threshold: [B, F, N, C] masking threshold (rate scale included).
    """
    k = _reflection(idx)  # [B, F, p, C]
    gain = torch.prod(1.0 - k * k, dim=-2, keepdim=True).to(torch.float64)
    # the float32 sqrt and power, each correctly rounded (through float64):
    # the CPU's torch rounds either off by an ulp at times
    inv_gain = torch.sqrt(gain).to(torch.float32).to(torch.float64)
    c = (inv_gain ** STEP_SCALE_EXP).to(torch.float32)  # [B, F, 1, C]
    c = c.to(threshold.dtype)
    return torch.cat(
        [threshold[..., :band_start, :], threshold[..., band_start:, :] * c],
        dim=-2,
    )


def filter_forward(spec: torch.Tensor, idx: torch.Tensor,
                   band_start: int) -> torch.Tensor:
    """Encoder filter: e[k] = s[k] + sum_i a_i s[k-i] along frequency, zero
    history at the band edge; bins below ``band_start`` pass through."""
    wdt = _work_dtype(spec)
    a = lpc_from_indices(idx).to(wdt)  # [B, F, p, C]
    band = spec[..., band_start:, :].to(wdt)  # [B, F, M, C]
    m = band.shape[-2]
    out = band.clone()
    for i in range(1, a.shape[-2] + 1):
        out[..., i:, :] += a[..., i - 1 : i, :] * band[..., : m - i, :]
    return torch.cat([spec[..., :band_start, :], out.to(spec.dtype)], dim=-2)


@functools.lru_cache(maxsize=None)
def _block_index(p: int, device: torch.device):
    """[p, p] gathers of the block filter's matrices: t - m + p - 1 into a
    row of p - 1 zeros then p values (lower-triangular Toeplitz), and
    t + m into a row of p values then p - 1 zeros (upper-left Hankel)."""
    t = torch.arange(p)
    return ((t[:, None] - t[None, :] + p - 1).to(device),
            (t[:, None] + t[None, :]).to(device))


def filter_inverse(spec: torch.Tensor, idx: torch.Tensor,
                   band_start: int) -> torch.Tensor:
    """Decoder filter: s[k] = e[k] - sum_i a_i s[k-i], the exact inverse
    recursion of :func:`filter_forward` (stable: every representable
    |k| < 1).

    The recursion runs p bins a step. With the band cut into blocks of p
    bins, block j of the output is y_j = G e_j + H y_{j-1}: G (lower
    triangular, Toeplitz) holds the filter's impulse response h_0..h_{p-1}
    and H = -G U carries the last p outputs forward (U[t, m] =
    a_{t+1+m}, m counting back from the block's start). G e_j is one
    batched product for every block at once; then each block is one
    batched multiply-add of the previous one, so the band's M bins take
    M/p launches over every (batch, frame, channel) lane."""
    wdt = _work_dtype(spec)
    b, f, n, c = spec.shape
    p = idx.shape[-2]
    m = n - band_start
    blocks = -(-m // p)
    if spec.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    a = lpc_from_indices(idx).to(wdt).transpose(-2, -1).reshape(-1, p)
    lanes = a.shape[0]
    h = [torch.ones_like(a[:, 0])]  # impulse response of 1/A(z)
    for t in range(1, p):
        acc = a[:, 0] * h[t - 1]
        for i in range(2, t + 1):
            acc = acc + a[:, i - 1] * h[t - i]
        h.append(-acc)
    toeplitz, hankel = _block_index(p, spec.device)
    zeros = a.new_zeros(lanes, p - 1)
    g = torch.cat([zeros, torch.stack(h, dim=-1)], dim=-1)[:, toeplitz]
    u = torch.cat([a, zeros], dim=-1)[:, hankel]
    # y_j as a row: y_j += y_{j-1} @ H'^T, H' = H on the previous block in
    # bin order (its columns reversed)
    ht = (-torch.bmm(g, u)).flip(-1).transpose(-2, -1).contiguous()
    band = _lanes_last(spec, band_start).reshape(lanes, m)
    band = torch.nn.functional.pad(band, (0, blocks * p - m))
    y = torch.bmm(band.reshape(lanes, blocks, p), g.transpose(-2, -1))
    # block-major, so that each step reads and writes whole [L, 1, p] rows
    y = y.transpose(0, 1).contiguous().unsqueeze(2)
    for j in range(1, blocks):
        y[j].baddbmm_(y[j - 1], ht)
    out = y.reshape(blocks, lanes, p).transpose(0, 1).reshape(
        lanes, blocks * p)[:, :m].reshape(b, f, c, m)
    return torch.cat([spec[..., :band_start, :],
                      out.transpose(-2, -1).to(spec.dtype)], dim=-2)
