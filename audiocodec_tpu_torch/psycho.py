"""Psychoacoustic model (Bark-domain masking) in PyTorch, parity mode.

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


class PsychoacousticModel(nn.Module):
    """Bark-scale masking model; its precomputes are registered buffers.

    :param sample_rate: input sample rate in Hz.
    :param filter_bands_n: number of MDCT filter bands.
    :param bark_bands_n: number of Bark bands.
    :param alpha: exponent of the non-linear masking superposition.
    :param compute_dtype: float64, float32 or bfloat16.
    :param bark_precision: tier of the Bark contractions: "highest",
        "high" or "default".
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
        self.sample_rate = float(sample_rate)
        self.filter_bands_n = filter_bands_n
        self.bark_bands_n = bark_bands_n
        self.alpha = float(alpha)
        self.compute_dtype = dtype
        self.max_bark = max_bark
        self.bark_precision = bark_precision
        arrays = dict(
            W=W,
            W_inv=W_inv,
            quiet_threshold_intensity=_quiet_threshold_intensity(
                bark_bands_n, max_bark, db_min
            ),
            spreading_matrix=_spreading_matrix(bark_bands_n, max_bark, alpha),
            bark_grid=np.linspace(0.0, max_bark, bark_bands_n),
        )
        for name, value in arrays.items():
            self.register_buffer(
                name, torch.as_tensor(value, dtype=dtype, device=device)
            )
        # 0-d constants in the compute dtype, made once on the device: made
        # in each call, each would be a host-to-device copy in each call.
        # Not kept on the host as the quantizer's are: a CUDA division by a
        # host scalar multiplies by its reciprocal, which rounds twice.
        consts = dict(eps=INTENSITY_EPS, ln10=math.log(10.0), db_max=DB_MAX,
                      one=1.0, ten=10.0, alpha=alpha,
                      sixth=_noise.SIGMA_SCALE)
        for name, value in consts.items():
            self.register_buffer(f"c_{name}",
                                 _dtypes.scalar(value, dtype, device),
                                 persistent=False)
        self.register_buffer("c_neg_alpha", -self.c_alpha, persistent=False)
        self.register_buffer("c_inv_alpha", 1.0 / self.c_alpha,
                             persistent=False)

    def amplitude_to_dB(self, mdct_amplitude: torch.Tensor) -> torch.Tensor:
        """Amplitude in [-1, 1] -> dB in [-20, DB_MAX] (the intensity floor
        INTENSITY_EPS maps to -20 dB)."""
        intensity = torch.maximum(self.c_eps, mdct_amplitude**2)
        return 10.0 * torch.log(intensity) / self.c_ln10 + self.c_db_max

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
        max(masking, threshold in quiet) in the Bark domain, mapped back."""
        _dtypes.check_input_dtype(
            mdct_amplitudes, self.compute_dtype,
            "global_masking_threshold input",
        )
        return self.bark_intensity_to_threshold(
            self.global_masking_intensity_in_bark(
                mdct_amplitudes, tonality_per_block, drown
            )
        )

    def global_masking_intensity_in_bark(
        self, mdct_amplitudes, tonality_per_block, drown=0.0
    ) -> torch.Tensor:
        """Bark-domain global masking intensity [B, blocks, bark_bands_n, C]."""
        masking = self._masking_intensity_in_bark(
            mdct_amplitudes, tonality_per_block, drown
        )
        return torch.maximum(masking, self.quiet_threshold_intensity)

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
