"""Objective quality metrics: waveform SNR, segmental SNR, NMR and BS.1770
loudness (counterpart of ``audiocodec_tpu/metrics.py``).

NMR turns the codec's own psychoacoustic model into a measurement
instrument: noise moved ABOVE the masking threshold at constant power is
audible but SNR-invariant, which is why quality gates pair an SNR floor
with an NMR ceiling. Every function runs on the device of its inputs; the
MDCT of :func:`nmr` goes through the codec's analysis kernel
(``fold_matmul``), once for each signal.

The loudness filter is a blocked linear recurrence (:func:`_biquad`): the
K-weighting biquads run as a few matrix products a block of samples and a
log-depth scan of the two-sample state across blocks, a few dozen
launches a biquad whatever the length.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audiocodec_tpu_torch import psycho as _psycho
from audiocodec_tpu_torch.codec import Codec
from audiocodec_tpu_torch.ops.dct import matmul

# samples a block of the loudness filter's recurrence
BIQUAD_BLOCK = 1024


def snr_db(ref: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Time-domain SNR in dB over the whole signal: both [B, samples, C]."""
    noise = torch.sum((ref - deg) ** 2)
    sig = torch.sum(ref**2)
    return 10.0 * torch.log10(sig / torch.clamp(noise, min=1e-30))


def segmental_snr_db(
    ref: torch.Tensor, deg: torch.Tensor, frame: int = 1024,
    floor_db: float = -10.0, ceil_db: float = 35.0,
) -> torch.Tensor:
    """Mean per-frame SNR in dB, frames clamped to [floor, ceil].

    The standard speech-quality variant: long silences and easy passages
    cannot buy back a badly coded segment (global SNR lets them)."""
    s = ref.shape[1] - ref.shape[1] % frame
    r = ref[:, :s].reshape(ref.shape[0], -1, frame, ref.shape[-1])
    d = deg[:, :s].reshape(deg.shape[0], -1, frame, deg.shape[-1])
    sig = torch.sum(r**2, dim=2)
    noise = torch.clamp(torch.sum((r - d) ** 2, dim=2), min=1e-30)
    per = 10.0 * torch.log10(torch.clamp(sig, min=1e-30) / noise)
    return torch.mean(torch.clamp(per, floor_db, ceil_db))


def nmr(codec: Codec, ref: torch.Tensor, deg: torch.Tensor,
        tmask: float = 0.0) -> torch.Tensor:
    """Mean squared noise-to-mask ratio of ``deg`` against ``ref``.

    The error spectrum (MDCT of both signals, differenced) is compared
    bin-by-bin to the masking threshold of the REFERENCE — the same
    quantity the codec's quantizer is calibrated against (step =
    threshold/√3, noise power threshold²/36), so the codec's own
    quantization lands at NMR ≈ 1/36 ≈ 0.03 and NMR << 1 generally means
    the degradation hides under the mask.

    Calibration note: the model's dB_MAX=120 convention maps full scale
    to 120 dB SPL, so even the −96 dBFS dither of a 16-bit PCM wav
    registers as NMR ≈ 1. Comparing wav files therefore floors around
    NMR ~1; in-memory float comparisons see the codec's true ≈ 0.03.

    :param tmask: forward-masking decay in dB/s (psycho.temporal_masking).
        0 (default) judges against the SIMULTANEOUS threshold only — the
        strictest lens. Pass the encoder's tmask value to evaluate a
        tmask'd encode against the model's own audibility claim."""
    spec_ref = codec.mdct.transform(ref)
    spec_deg = codec.mdct.transform(deg)
    tonality = codec.psycho.tonality(spec_ref)
    if tmask:
        bark = codec.psycho.global_masking_intensity_in_bark(
            spec_ref, tonality
        )
        bark = _psycho.temporal_masking(
            bark, codec._tmask_db_per_frame(tmask)
        )
        threshold = codec.psycho.bark_intensity_to_threshold(bark)
    else:
        threshold = codec.psycho.global_masking_threshold(
            spec_ref, tonality
        )
    r = ((spec_deg - spec_ref) / threshold).to(torch.float32)
    return torch.mean(r * r)


def nmr_db(codec: Codec, ref: torch.Tensor, deg: torch.Tensor,
           tmask: float = 0.0) -> torch.Tensor:
    """NMR in dB (negative = inaudible on average)."""
    return 10.0 * torch.log10(
        torch.clamp(nmr(codec, ref, deg, tmask=tmask), min=1e-30)
    )


def _k_weighting_coeffs(sample_rate: float):
    """BS.1770 K-weighting as two biquads at an arbitrary sample rate.

    The standard tabulates 48 kHz coefficients; any other rate needs the
    analog prototypes re-discretized (the pre-warped bilinear transform
    below — the same redesign pyloudnorm/ffmpeg use). Stage 1 is a
    +4 dB high shelf (head diffraction), stage 2 the RLB high-pass.
    Host-side float64 precompute, like every constant here."""
    def shelf(fc, gain_db, q, fs):
        k = np.tan(np.pi * fc / fs)
        vh = 10.0 ** (gain_db / 20.0)
        vb = vh ** 0.4996667741545416
        a0 = 1.0 + k / q + k * k
        b = np.array([
            (vh + vb * k / q + k * k) / a0,
            2.0 * (k * k - vh) / a0,
            (vh - vb * k / q + k * k) / a0,
        ])
        a = np.array([
            1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0
        ])
        return b, a

    def highpass(fc, q, fs):
        k = np.tan(np.pi * fc / fs)
        a0 = 1.0 + k / q + k * k
        b = np.array([1.0, -2.0, 1.0]) / a0
        a = np.array([
            1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0
        ])
        return b, a

    b1, a1 = shelf(1681.974450955533, 3.999843853973347,
                   0.7071752369554196, sample_rate)
    b2, a2 = highpass(38.13547087602444, 0.5003270373238773, sample_rate)
    return (b1, a1), (b2, a2)


# block-count doublings the state scan can take (2^48 blocks: never short)
_SCAN_STEPS = 48


@functools.lru_cache(maxsize=16)
def _biquad_operators(b: tuple, a: tuple, block: int, dtype: torch.dtype,
                      device: torch.device):
    """The blocked recurrence of a direct-form-II-transposed biquad, built
    in float64 on the host once and kept on ``device``: (T^T [L, L] in
    ``dtype``; Bm^T [L, 2], Cm^T [2, L] and the scan's (A^(L 2^i))^T
    [_SCAN_STEPS, 2, 2] in float64). Building them is ~20 ms of Python, more
    than a loudness pass's device work.

    With the state s = (z1, z2), a block of L inputs x starting in state s0
    gives y = T x + Cm s0 (T the lower-triangular Toeplitz matrix of the
    impulse response, Cm the zero-input response) and ends in state
    A^L s0 + Bm x."""
    a_mat = np.array([[-a[1], 1.0], [-a[2], 0.0]])
    b_vec = np.array([b[1] - a[1] * b[0], b[2] - a[2] * b[0]])
    powers = [np.eye(2)]
    for _ in range(block):
        powers.append(a_mat @ powers[-1])
    h = np.empty(block)
    h[0] = b[0]
    for k in range(1, block):
        h[k] = (powers[k - 1] @ b_vec)[0]
    idx = np.arange(block)
    lag = idx[:, None] - idx[None, :]
    toeplitz = np.where(lag >= 0, h[np.clip(lag, 0, None)], 0.0)
    cm = np.stack([powers[n][0] for n in range(block)])  # [L, 2]
    bm = np.stack([powers[block - 1 - n] @ b_vec for n in range(block)],
                  axis=1)  # [2, L]
    squares = [powers[block]]
    for _ in range(_SCAN_STEPS - 1):
        squares.append(squares[-1] @ squares[-1])

    def dev(arr, dt):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device, dt)

    f64 = torch.float64
    return (dev(toeplitz.T, dtype), dev(bm.T, f64), dev(cm.T, f64),
            dev(np.stack([q.T for q in squares]), f64))


def _biquad(x: torch.Tensor, b, a, block: int = BIQUAD_BLOCK
            ) -> torch.Tensor:
    """Direct-form-II-transposed biquad along axis 1 of [B, samples, C],
    zero initial state, with the coefficients rounded to x's dtype (as the
    JAX package's per-sample scan takes them).

    Each block of ``block`` samples is one product with the impulse
    response's Toeplitz matrix (its zero-state response, in x's dtype at
    the ``highest`` tier: TF32 off) plus the response to the state it
    starts in. The block-end states form a linear recurrence over blocks,
    solved by a log-depth (Hillis-Steele) scan with the transfer matrix's
    powers. The states run in float64: near a double pole (the RLB
    high-pass's, at ~0.995) the zero-input response amplifies a state's
    rounding ~100-fold, and these [rows, blocks, 2] products are tiny."""
    bsz, s, ch = x.shape
    dt = x.dtype
    coeff = np.float64 if dt == torch.float64 else np.float32
    toeplitz_t, bm_t, cm_t, squares_t = _biquad_operators(
        tuple(np.asarray(b).astype(coeff).astype(np.float64).tolist()),
        tuple(np.asarray(a).astype(coeff).astype(np.float64).tolist()),
        block, dt, x.device)
    nb = -(-s // block)
    rows = x.permute(0, 2, 1).reshape(bsz * ch, s)
    rows = torch.nn.functional.pad(rows, (0, nb * block - s))
    xb = rows.reshape(bsz * ch, nb, block)
    y = matmul(xb, toeplitz_t, "highest")
    e = matmul(xb.to(torch.float64), bm_t, "highest")  # block-end states
    d, i = 1, 0
    while d < nb:
        e = torch.cat([e[:, :d], e[:, d:] + matmul(e[:, :-d], squares_t[i],
                                                   "highest")], dim=1)
        d, i = 2 * d, i + 1
    s0 = torch.cat([torch.zeros_like(e[:, :1]), e[:, :-1]], dim=1)
    y = (y + matmul(s0, cm_t, "highest")).to(dt)
    y = y.reshape(bsz * ch, nb * block)[:, :s]
    return y.reshape(bsz, ch, s).permute(0, 2, 1)


def loudness_lufs(x: torch.Tensor, sample_rate: int) -> float:
    """Integrated loudness (LUFS) per ITU-R BS.1770-4 / EBU R128.

    K-weighting (shelf + RLB high-pass, re-discretized for the given
    rate), 400 ms blocks with 75 % overlap, −70 LUFS absolute gate, then
    a −10 LU relative gate. Channels are summed with unit weights
    (correct for mono/stereo; surround side-channel weighting is out of
    scope). Calibration: a full-scale 997 Hz sine reads −3.0 LUFS.

    :param x: [B, samples, C] float waveform in [−1, 1].
    :return: integrated loudness of the batch's first clip, as a float.
    """
    return float(loudness_lufs_batch(x, sample_rate)[0])


def loudness_lufs_batch(x: torch.Tensor, sample_rate: int) -> np.ndarray:
    """Per-clip integrated loudness for a batch: [B, samples, C] (a tensor
    or numpy) -> float64 [B]. Same algorithm as :func:`loudness_lufs`
    (which is this function's first element), with the block powers and
    both gates vectorized over the batch axis."""
    x = torch.as_tensor(x).to(torch.float32)
    (b1, a1), (b2, a2) = _k_weighting_coeffs(float(sample_rate))
    z = _biquad(_biquad(x, b1, a1), b2, a2)
    block = max(1, int(round(0.400 * sample_rate)))
    step = max(1, block // 4)  # 75% overlap
    s = z.shape[1]
    if s < block:
        block = s
        step = s
    # power per block, channels summed with unit weights: the windows are
    # a strided view of z^2, never a float32 prefix sum
    zb = (z * z).unfold(1, block, step)  # [B, n_blocks, C, block]
    # l_j = -0.691 + 10 log10( sum_ch mean_t z^2 ) — unit channel weights
    power = torch.clamp(torch.sum(torch.mean(zb, dim=-1), dim=-1),
                        min=1e-12)  # [B, n_blocks]
    l_blocks = -0.691 + 10.0 * torch.log10(power)
    abs_mask = l_blocks > -70.0
    p_abs = torch.sum(
        torch.where(abs_mask, power, 0.0), dim=1
    ) / torch.clamp(torch.sum(abs_mask, dim=1), min=1)
    rel_gate = (
        -0.691 + 10.0 * torch.log10(torch.clamp(p_abs, min=1e-12)) - 10.0
    )
    mask = abs_mask & (l_blocks > rel_gate[:, None])
    p_int = torch.sum(
        torch.where(mask, power, 0.0), dim=1
    ) / torch.clamp(torch.sum(mask, dim=1), min=1)
    lufs = -0.691 + 10.0 * torch.log10(torch.clamp(p_int, min=1e-12))
    return lufs.cpu().numpy().astype(np.float64)


def evaluate(codec: Codec, ref: torch.Tensor, deg: torch.Tensor) -> dict:
    """All metrics as python floats. ``ref``/``deg``: [B, samples, C] of
    the codec's compute dtype on its device, equal shapes, samples a
    multiple of N."""
    if ref.shape != deg.shape:
        raise ValueError(
            f"reference and degraded shapes differ: {tuple(ref.shape)} vs "
            f"{tuple(deg.shape)}; align them first (the CLI trims to the "
            "common length)"
        )
    n = codec.mdct.filters_n
    if ref.shape[1] % n:
        raise ValueError(
            f"samples ({ref.shape[1]}) must be a multiple of filters_n "
            f"({n}) for the MDCT-domain metrics"
        )
    ratio = nmr(codec, ref, deg)
    # the keys in the JAX package's order (its jitted dict comes back
    # sorted), so the CLI's JSON line reads the same
    out = {
        "nmr": ratio,
        "nmr_db": 10.0 * torch.log10(torch.clamp(ratio, min=1e-30)),
        "seg_snr_db": segmental_snr_db(ref, deg, frame=n),
        "snr_db": snr_db(ref, deg),
    }
    return {k: float(v) for k, v in out.items()}
