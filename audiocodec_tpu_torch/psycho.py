"""Psychoacoustic model (Bark-domain masking) in PyTorch: parity and
calibrated modes, and temporal (post-)masking.

The counterpart of ``audiocodec_tpu/psycho.py``. The numpy float64 builders
are copies of the JAX package's; the masking contraction is reassociated as
there, (I^alpha @ spreading) * offset_factor, so the 5-D masking tensor is
never built. Formulas follow Zolzer, "Digital Audio Signal Processing" ch. 9.

Bark contractions run at ``bark_precision``: ``highest``/``high`` in
float32 (float64 for a float64 model), ``default`` with operands rounded to
bfloat16 and float32 sums (float64 models stay float64).

Shapes: spectra [batches_n, blocks_n, filter_bands_n, channels_n];
tonality [batches_n, blocks_n, 1, channels_n].
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from audiocodec_tpu_torch.ops import cuda_noise as _noise
from audiocodec_tpu_torch.ops import dct as _dct
from audiocodec_tpu_torch.utils import dtypes as _dtypes
from audiocodec_tpu_torch.utils.profiling import span

DB_MAX = 120.0
INTENSITY_EPS = 1e-14


def freq2bark(frequencies):
    """Empirical Bark scale: bark = 6 * asinh(f / 600)."""
    return 6.0 * np.arcsinh(np.asarray(frequencies) / 600.0)


def bark2freq(bark_band):
    """Inverse empirical Bark scale: f = 600 * sinh(bark / 6)."""
    return 600.0 * np.sinh(np.asarray(bark_band) / 6.0)


def _bark_freq_mapping(
    sample_rate: float, filter_bands_n: int, bark_bands_n: int
):
    """Linear-frequency <-> Bark band overlap matrices (W [filter, bark],
    W_inv [bark, filter]), float64; rows of each sum to 1."""
    max_frequency = sample_rate / 2.0
    max_bark = freq2bark(max_frequency)
    bark_band_width = max_bark / bark_bands_n
    filter_band_width = max_frequency / filter_bands_n

    bark_idx = np.arange(bark_bands_n, dtype=np.float64)[None, :]
    freq_idx = np.arange(filter_bands_n, dtype=np.float64)[:, None]

    bark_low_hz = bark2freq(bark_band_width * bark_idx)
    bark_high_hz = bark2freq(bark_band_width * (bark_idx + 1.0))
    freq_low = filter_band_width * freq_idx
    freq_high = freq_low + filter_band_width

    lo = np.clip(bark_low_hz, freq_low, freq_high)
    hi = np.clip(bark_high_hz, freq_low, freq_high)
    overlap = hi - lo

    W = overlap / filter_band_width
    W_inv = (overlap / (bark_high_hz - bark_low_hz)).T
    return W, W_inv


def _bark_freq_mapping_calibrated(
    sample_rate: float, filter_bands_n: int, bark_bands_n: int
):
    """Centroid-preserving analysis matrix W [filter, bark] of calibrated
    mode, float64: each filter band's intensity is split between the two
    Bark bands whose centres bracket its centre (a triangular kernel), so a
    tonal masker sits at its true Bark position; rows sum to 1."""
    max_frequency = sample_rate / 2.0
    max_bark = freq2bark(max_frequency)
    step = max_bark / bark_bands_n
    fc = (np.arange(filter_bands_n) + 0.5) * max_frequency / filter_bands_n
    pos = (freq2bark(fc) - 0.5 * step) / step  # fractional centre index
    lo = np.clip(np.floor(pos).astype(int), 0, bark_bands_n - 1)
    hi = np.clip(lo + 1, 0, bark_bands_n - 1)
    wfrac = np.clip(pos - lo, 0.0, 1.0)
    W = np.zeros((filter_bands_n, bark_bands_n))
    np.add.at(W, (np.arange(filter_bands_n), lo), 1.0 - wfrac)
    np.add.at(W, (np.arange(filter_bands_n), hi), wfrac)
    return W


def _spreading_matrix_integrated(
    bark_bands_n: int, max_bark: float, alpha: float
):
    """Band-integrated spreading matrix of calibrated mode, float64: each
    entry is the prototype's mean intensity over the target band (a
    33-point trapezoid), with the 1024/64 configuration's half-step offset
    kept as a fixed Bark shift, so that every band count reproduces its
    masking pattern."""
    step = max_bark / bark_bands_n
    d = (
        np.arange(bark_bands_n)[None, :] - np.arange(bark_bands_n)[:, None]
    ).astype(np.float64)
    u = np.linspace(-0.5, 0.5, 33)
    anchor_shift = 0.5 * (max_bark / 64.0)
    z = (d[:, :, None] + u[None, None, :]) * step + anchor_shift
    f_spreading = 15.81 + 7.5 * (z + 0.474) - 17.5 * np.sqrt(
        1.0 + (z + 0.474) ** 2
    )
    vals = 10.0 ** (alpha * f_spreading / 10.0)
    # np.trapezoid is numpy >= 2.0; np.trapz its earlier name
    trap = getattr(np, "trapezoid", None) or np.trapz
    return trap(vals, u, axis=2)


def _quiet_threshold_freq_amp(
    sample_rate: float, filter_bands_n: int, db_min: float
):
    """Threshold in quiet per filter band, [1, 1, filter_bands_n, 1]
    amplitudes: calibrated mode's fine-grid quiet floor. Zolzer eq. 9.3 at
    the filter bands' centres, each band's intensity divided by the number
    of 1024-band filters a 64-band Bark band spans there (evaluated
    continuously), which keeps the 1024/64 configuration's levels."""
    fc = (
        (np.arange(filter_bands_n) + 0.5)
        * (sample_rate / 2.0)
        / filter_bands_n
    )
    f_khz = fc / 1000.0
    quiet_db = np.clip(
        3.64 * f_khz**-0.8
        - 6.5 * np.exp(-0.6 * (f_khz - 3.3) ** 2)
        + 1e-3 * f_khz**4,
        db_min,
        DB_MAX,
    )
    max_bark = freq2bark(sample_rate / 2.0)
    bark_width_hz = 100.0 * np.cosh(freq2bark(fc) / 6.0) * (max_bark / 64.0)
    filter_bw_default = (sample_rate / 2.0) / 1024.0
    n_default = np.maximum(bark_width_hz / filter_bw_default, 1e-6)
    intensity = 10.0 ** ((quiet_db - DB_MAX) / 10.0) / n_default
    amp = np.sqrt(intensity)
    return amp.reshape(1, 1, -1, 1)


def _spreading_matrix(bark_bands_n: int, max_bark: float, alpha: float):
    """Toeplitz-like matrix of shifted spreading prototypes (Zolzer eq.
    9.15, intensity with the alpha exponent baked in), float64."""
    z = np.linspace(-max_bark, max_bark, 2 * bark_bands_n)
    f_spreading = 15.81 + 7.5 * (z + 0.474) - 17.5 * np.sqrt(
        1.0 + (z + 0.474) ** 2
    )
    f_intensity = 10.0 ** (alpha * f_spreading / 10.0)
    starts = bark_bands_n - np.arange(bark_bands_n)
    idx = starts[:, None] + np.arange(bark_bands_n)[None, :]
    return f_intensity[idx]


def _quiet_threshold_intensity(
    bark_bands_n: int, max_bark: float, db_min: float
):
    """Threshold-in-quiet intensity per Bark band (Zolzer eq. 9.3 at the
    band midpoints), [1, 1, bark_bands_n, 1] float64."""
    bark_band_width = max_bark / bark_bands_n
    mid_bark = bark_band_width * np.arange(bark_bands_n, dtype=np.float64) + (
        bark_band_width / 2.0
    )
    mid_khz = bark2freq(mid_bark) / 1000.0
    quiet_db = np.clip(
        3.64 * mid_khz**-0.8
        - 6.5 * np.exp(-0.6 * (mid_khz - 3.3) ** 2)
        + 1e-3 * mid_khz**4,
        db_min,
        DB_MAX,
    )
    intensity = 10.0 ** ((quiet_db - DB_MAX) / 10.0)
    return intensity.reshape(1, 1, -1, 1)


def temporal_masking_window(decay_db_per_frame: float,
                            horizon_db: float = 30.0) -> int:
    """The number of past frames :func:`temporal_masking` spans: the
    log-doubling window 2^ceil(log2(w+1)) - 1 over the smallest w whose
    decayed contribution stays within ``horizon_db`` of a masker. A
    streaming encoder carries this many context frames."""
    if not decay_db_per_frame > 0:
        raise ValueError(
            f"decay must be positive, got {decay_db_per_frame}"
        )
    w = int(np.ceil(horizon_db / decay_db_per_frame))
    return 2 ** max(1, int(np.ceil(np.log2(w + 1)))) - 1


def _shifted(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """``x`` moved ``k`` frames later along ``axis``, zero-filled."""
    frames = x.shape[axis]
    pad = list(x.shape)
    pad[axis] = k
    return torch.cat([x.new_zeros(pad), x.narrow(axis, 0, frames - k)],
                     dim=axis)


def temporal_masking(bark_intensity: torch.Tensor, decay_db_per_frame: float,
                     frame_axis: int = 1, context=None,
                     horizon_db: float = 30.0) -> torch.Tensor:
    """Forward (post-)masking: I'_t = max_k lambda^k * I_{t-k}, lambda =
    10^(-decay/10), over the window of :func:`temporal_masking_window`.

    The max over the window is taken by log-doubling: ceil(log2(window+1))
    shifted, scaled elementwise maxes (zero-filled shifts: intensities are
    >= the 1e-14 floor, so a zero frame never wins), stopping once the shift
    reaches the frame count (a longer shift changes nothing). Each
    lambda^shift is a float64 host value rounded once to the input's dtype
    and kept on the host.

    :param bark_intensity: [..., frames, bark_bands_n, channels] masking
        intensities; ``frame_axis`` is the time axis.
    :param decay_db_per_frame: decay per frame hop in dB (> 0).
    :param context: optional trailing frames of the previous chunk's
        intensities, prepended along ``frame_axis`` and trimmed from the
        output, so chunk boundaries spread as a whole-file run does.
    :return: the spread intensities, ``bark_intensity``'s shape.
    """
    window = temporal_masking_window(decay_db_per_frame, horizon_db)
    x = bark_intensity
    n_ctx = 0
    if context is not None:
        if context.dim() != x.dim():
            raise ValueError(
                f"context rank {context.dim()} != input rank {x.dim()}"
            )
        n_ctx = context.shape[frame_axis]
        x = torch.cat([context.to(x.dtype), x], dim=frame_axis)
    frames = x.shape[frame_axis]
    shift = 1
    for _ in range(max(1, int(np.ceil(np.log2(window + 1))))):
        if shift >= frames:
            break
        lam = _dtypes.scalar(10.0 ** (-decay_db_per_frame * shift / 10.0),
                             x.dtype)
        x = torch.maximum(x, _shifted(x, shift, frame_axis) * lam)
        shift *= 2
    if n_ctx:
        x = x.narrow(frame_axis, n_ctx, frames - n_ctx)
    return x


class PsychoacousticModel(nn.Module):
    """Bark-scale masking model; its precomputes are registered buffers.

    :param sample_rate: input sample rate in Hz.
    :param filter_bands_n: number of MDCT filter bands.
    :param bark_bands_n: number of Bark bands.
    :param alpha: exponent of the non-linear masking superposition.
    :param compute_dtype: float64, float32 or bfloat16.
    :param bark_precision: tier of the Bark contractions: "highest",
        "high" or "default".
    :param calibrated: False (the default) keeps the reference's parity;
        True makes the thresholds invariant to (filter_bands_n,
        bark_bands_n), anchored to the 1024/64 configuration: a W_inv level
        scalar, the centroid-preserving W, the band-integrated spreading
        matrix and the fine-grid quiet floor ``quiet_threshold_freq_amp``
        (None in parity mode).
    :param device: where the buffers live: the card unless the caller asks
        for the CPU.
    """

    def __init__(
        self,
        sample_rate,
        filter_bands_n: int = 1024,
        bark_bands_n: int = 64,
        alpha: float = 0.6,
        compute_dtype=torch.float32,
        bark_precision: str = "highest",
        calibrated: bool = False,
        device="cuda",
    ):
        super().__init__()
        if bark_precision not in _dct.PRECISIONS:
            raise ValueError(
                f"bark_precision must be one of {sorted(_dct.PRECISIONS)}, "
                f"got {bark_precision!r}"
            )
        dtype = _dtypes.canonicalize_compute_dtype(compute_dtype)
        device = torch.device(device)
        max_bark = float(freq2bark(sample_rate / 2.0))
        db_min = 10.0 * math.log10(INTENSITY_EPS) + DB_MAX
        W, W_inv = _bark_freq_mapping(sample_rate, filter_bands_n, bark_bands_n)
        quiet_freq = None
        if calibrated:
            # the W_inv level scalar is exactly 1.0 at 1024/64
            W_inv = W_inv * (
                (filter_bands_n * 64.0) / (1024.0 * bark_bands_n)
            )
            W = _bark_freq_mapping_calibrated(
                sample_rate, filter_bands_n, bark_bands_n
            )
            spreading = _spreading_matrix_integrated(
                bark_bands_n, max_bark, alpha
            )
            quiet_freq = _quiet_threshold_freq_amp(
                sample_rate, filter_bands_n, db_min
            )
        else:
            spreading = _spreading_matrix(bark_bands_n, max_bark, alpha)
        self.sample_rate = float(sample_rate)
        self.filter_bands_n = filter_bands_n
        self.bark_bands_n = bark_bands_n
        self.alpha = float(alpha)
        self.compute_dtype = dtype
        self.max_bark = max_bark
        self.bark_precision = bark_precision
        self.calibrated = bool(calibrated)
        arrays = dict(
            W=W,
            W_inv=W_inv,
            quiet_threshold_intensity=_quiet_threshold_intensity(
                bark_bands_n, max_bark, db_min
            ),
            spreading_matrix=spreading,
            bark_grid=np.linspace(0.0, max_bark, bark_bands_n),
            quiet_threshold_freq_amp=quiet_freq,
        )
        for name, value in arrays.items():
            self.register_buffer(name, None if value is None else
                                 torch.as_tensor(value, dtype=dtype,
                                                 device=device))
        # 0-d constants in the compute dtype, made once on the device: made
        # in each call, each would be a host-to-device copy in each call.
        # Not kept on the host as the quantizer's are: a CUDA division by a
        # host scalar multiplies by its reciprocal, which rounds twice.
        consts = dict(eps=INTENSITY_EPS, ln10=math.log(10.0), db_max=DB_MAX,
                      db_min=self.dB_MIN, db_range=self.dB_MAX - self.dB_MIN,
                      one=1.0, ten=10.0, alpha=alpha,
                      sixth=_noise.SIGMA_SCALE)
        for name, value in consts.items():
            self.register_buffer(f"c_{name}",
                                 _dtypes.scalar(value, dtype, device),
                                 persistent=False)
        self.register_buffer("c_neg_alpha", -self.c_alpha, persistent=False)
        self.register_buffer("c_inv_alpha", 1.0 / self.c_alpha,
                             persistent=False)

    @classmethod
    def create(cls, *args, **kwargs) -> "PsychoacousticModel":
        """The JAX package's constructor name: the constructor's arguments,
        in its order."""
        return cls(*args, **kwargs)

    @property
    def dB_MAX(self) -> float:
        return DB_MAX

    @property
    def dB_MIN(self) -> float:
        """The dB of the intensity floor INTENSITY_EPS: -20 dB."""
        return 10.0 * math.log10(INTENSITY_EPS) + DB_MAX

    def amplitude_to_dB(self, mdct_amplitude: torch.Tensor) -> torch.Tensor:
        """Amplitude in [-1, 1] -> dB in [dB_MIN, dB_MAX]."""
        intensity = torch.maximum(self.c_eps, mdct_amplitude**2)
        return 10.0 * torch.log(intensity) / self.c_ln10 + self.c_db_max

    def amplitude_to_dB_norm(self, mdct_amplitude: torch.Tensor
                             ) -> torch.Tensor:
        """Amplitude in [-1, 1] -> normalized dB in [0, 1]."""
        db = self.amplitude_to_dB(mdct_amplitude)
        return (db - self.c_db_min) / self.c_db_range

    @span("psycho.tonality")
    def tonality(self, mdct_amplitudes: torch.Tensor) -> torch.Tensor:
        """Tonality in [0, 1] (0 = noise, 1 = tonal) from the spectral
        flatness measure, Zolzer eqs. 9.10-9.11."""
        _dtypes.check_input_dtype(
            mdct_amplitudes, self.compute_dtype, "tonality input"
        )
        eps = self.c_eps
        intensity = mdct_amplitudes**2
        geo_mean = torch.exp(
            torch.mean(torch.log(torch.maximum(eps, intensity)), dim=2,
                       keepdim=True)
        )
        arith_mean = torch.mean(intensity, dim=2, keepdim=True) + eps
        sfm = 10.0 * torch.log(geo_mean / arith_mean) / self.c_ln10
        return torch.minimum(sfm / -60.0, self.c_one)

    def _bark_matmul(self, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """einsum("nbic,ij->nbjc") at bark_precision, in the compute dtype."""
        out = _dct.matmul(a.transpose(2, 3), m, self.bark_precision)
        return out.transpose(2, 3).to(self.compute_dtype)

    def _masking_intensity_in_bark(
        self, mdct_amplitudes, tonality_per_block, drown=0.0
    ):
        """Masked intensity per Bark band [B, blocks, bark_bands_n, C]; the
        masking offset factors out of the spreading contraction."""
        eps = self.c_eps
        grid = self.bark_grid.reshape(1, 1, -1, 1)
        offset = (1.0 - drown) * (
            tonality_per_block * grid + 9.0 * tonality_per_block + 5.5
        )
        offset_factor = torch.pow(self.c_ten, self.c_neg_alpha * offset / 10.0)
        intensities_in_bark = self._bark_matmul(mdct_amplitudes**2, self.W)
        amp_alpha = torch.pow(torch.maximum(eps, intensities_in_bark),
                              self.c_alpha)
        spread = self._bark_matmul(amp_alpha, self.spreading_matrix)
        masked = spread * offset_factor
        return torch.pow(torch.maximum(eps, masked), self.c_inv_alpha)

    def global_masking_threshold(
        self, mdct_amplitudes, tonality_per_block, drown=0.0
    ) -> torch.Tensor:
        """Global masking threshold as per-filter-band amplitudes (>= 0):
        max(masking, threshold in quiet) in the Bark domain, mapped back;
        in calibrated mode also at least the fine-grid quiet floor."""
        _dtypes.check_input_dtype(
            mdct_amplitudes, self.compute_dtype,
            "global_masking_threshold input",
        )
        thr = self.bark_intensity_to_threshold(
            self.global_masking_intensity_in_bark(
                mdct_amplitudes, tonality_per_block, drown
            )
        )
        if self.calibrated:
            thr = torch.maximum(thr, self.quiet_threshold_freq_amp)
        return thr

    @span("psycho.masking")
    def global_masking_intensity_in_bark(
        self, mdct_amplitudes, tonality_per_block, drown=0.0
    ) -> torch.Tensor:
        """Bark-domain global masking intensity [B, blocks, bark_bands_n, C]."""
        masking = self._masking_intensity_in_bark(
            mdct_amplitudes, tonality_per_block, drown
        )
        return torch.maximum(masking, self.quiet_threshold_intensity)

    @span("psycho.threshold")
    def bark_intensity_to_threshold(self, bark_intensity) -> torch.Tensor:
        """Bark-band intensities -> filter-band threshold amplitudes: linear
        intensity split, then sqrt."""
        intensity = self._bark_matmul(bark_intensity, self.W_inv)
        return torch.sqrt(torch.maximum(self.c_eps, intensity))

    def add_noise(self, generator: torch.Generator, mdct_amplitudes,
                  masking_threshold) -> torch.Tensor:
        """Add inaudible Gaussian noise shaped by the masking threshold,
        sigma = threshold / 6 ("3 sigma both directions": ~0.27% of samples
        beyond the threshold). The normals come from ``torch.randn`` with
        ``generator``, which must be on the spectrum's device; the JAX
        package's ``add_noise`` takes a PRNG key in its place."""
        noise = masking_threshold * torch.randn(
            mdct_amplitudes.shape, generator=generator,
            dtype=self.compute_dtype, device=mdct_amplitudes.device,
        ) * self.c_sixth
        return mdct_amplitudes + noise

    def add_noise_fast(self, seed: int, mdct_amplitudes,
                       masking_threshold) -> torch.Tensor:
        """The same operation as :meth:`add_noise` in one pass of the noise
        kernel (ops/cuda_noise.py): normals from the Philox stream of
        ``seed``, indexed by the flat element index, so the same seed and
        shape give the same output. Not equal to :meth:`add_noise`'s
        stream. Mono spectra are contiguous already; others are copied to
        their logical order first."""
        return _noise.add_masked_noise(
            mdct_amplitudes.contiguous(), masking_threshold.contiguous(), seed
        )
