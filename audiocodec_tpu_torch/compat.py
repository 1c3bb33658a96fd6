"""Drop-in API compatibility with the reference library.

The reference is used as::

    from audiocodec.mdctransformer import MDCTransformer
    from audiocodec import psychoacoustic
    mdct = MDCTransformer(filters_n, window_type)
    pa = psychoacoustic.PsychoacousticModel(sample_rate, ...)

This module lets that code run on an NVIDIA GPU by switching only the
import::

    from audiocodec_tpu_torch.compat import MDCTransformer, PsychoacousticModel

Constructor signatures match the reference's (audiocodec/mdctransformer.py:
13-14, psychoacoustic.py:13-15), with a trailing ``device`` (the card unless
the caller asks for the CPU). ``precompute_dtype`` is pinned: constants are
always precomputed in float64 on the host and downcast once; asking for a
lower-precision precompute emits a UserWarning instead of silently
changing numerics. Dtypes may be torch, numpy or tf dtypes, or strings.

One semantic difference: ``add_noise`` draws from a ``torch.Generator``
seeded per instance (deterministic per construction order, like TF's
global seed within one program), which each call without ``generator=``
advances. Pass ``generator=`` for reproducible pipelines, or use the
native API (``audiocodec_tpu_torch.PsychoacousticModel``).
"""

from __future__ import annotations

import functools
import itertools
import warnings

import numpy as np
import torch

from audiocodec_tpu_torch import mdct as _mdct
from audiocodec_tpu_torch import psycho as _psycho
from audiocodec_tpu_torch.ops import folding as _folding
from audiocodec_tpu_torch.utils import dtypes as _dtypes

_instance_counter = itertools.count()


def _check_precompute_dtype(precompute_dtype):
    """Constants are always precomputed in float64 on the host (the
    reference's *default*, mdctransformer.py:14). A lower-precision request
    is not reproduced: the reference's float32 numbers are the rounding
    trail of its own graph (a dense polyphase convolution and a float32
    ``tf.linalg.inv``, mdctransformer.py:176-190), and this package derives
    the same constants through a closed-form one (ops/folding.py), so a
    float32 precompute here would be less accurate than float64 and still
    not TF's. The shim keeps float64 and warns."""
    if precompute_dtype is None:
        return
    name = getattr(precompute_dtype, "name", None) or str(precompute_dtype)
    if "float64" in name or "f64" in name:
        return
    warnings.warn(
        f"precompute_dtype={name!r} requested, but audiocodec_tpu_torch "
        "always precomputes constants in float64 on the host and downcasts "
        "once to compute_dtype; a reduced-precision precompute is not "
        "reproduced bit-for-bit (it would only be less accurate).",
        stacklevel=3,
    )


def _canonical(dtype) -> torch.dtype:
    """A compute dtype from a torch, numpy or tf dtype, a numpy scalar
    type, a string ("float32", "torch.float32", "tf.float32") or any
    object with a ``.name``."""
    name = getattr(dtype, "name", None) or str(dtype)
    return _dtypes.canonicalize_compute_dtype(
        name.split(".")[-1].strip("'<>"))


def _stacked(pair, dtype, device) -> torch.Tensor:
    """[2, N, N] of two float64 matrices, rounded once to ``dtype``."""
    return torch.as_tensor(np.stack(pair), dtype=dtype, device=device)


class MDCTransformer:
    """Reference-signature wrapper over ``audiocodec_tpu_torch.mdct.MDCT``
    at the ``highest`` tier (reference: audiocodec/mdctransformer.py:12-59).

    On the card the transforms run the MDCT kernels wherever the MDCT's
    ``use_kernel="auto"`` turns them on (N a multiple of 256, float32 or
    bfloat16): the ``highest`` kernels meet the tier's error (~8e-9 of the
    forward at N=1024 against float64), so the shim needs no plain path
    there. On the CPU the plain torch path runs.
    """

    def __init__(self, filters_n=1024, window_type="vorbis",
                 compute_dtype=torch.float32, precompute_dtype=None,
                 device="cuda"):
        _check_precompute_dtype(precompute_dtype)
        self._device = torch.device(device)
        self._m = _mdct.MDCT.create(
            filters_n=filters_n,
            window_type=window_type,
            compute_dtype=_canonical(compute_dtype),
            dct_precision="highest",
            device=self._device,
        )
        self.filters_n = filters_n
        self.window_type = window_type

    @functools.cached_property
    def H(self) -> torch.Tensor:
        """[2, filters_n, filters_n] analysis polyphase tensor, the
        attribute the reference exposes (mdctransformer.py:58):
        y[n] = x[n] @ H[0] + x[n-1] @ H[1], unscaled. Built on first access
        (the transforms never use it), then cached."""
        return _stacked(
            _folding.dense_fold_matrices(self.filters_n, self.window_type),
            self._m.compute_dtype, self._device)

    @functools.cached_property
    def H_inv(self) -> torch.Tensor:
        """[2, filters_n, filters_n] synthesis polyphase tensor
        (mdctransformer.py:59): out[n] = z[n] @ H_inv[0] + z[n-1] @ H_inv[1].
        """
        return _stacked(
            _folding.dense_unfold_matrices(self.filters_n, self.window_type),
            self._m.compute_dtype, self._device)

    def transform(self, x):
        return self._m.transform(torch.as_tensor(x, device=self._device))

    def inverse_transform(self, mdct_amplitudes):
        return self._m.inverse_transform(
            torch.as_tensor(mdct_amplitudes, device=self._device))


class PsychoacousticModel:
    """Reference-signature wrapper over ``audiocodec_tpu_torch.psycho``
    (reference: audiocodec/psychoacoustic.py:13-69)."""

    def __init__(self, sample_rate, filter_bands_n=1024, bark_bands_n=64,
                 alpha=0.6, compute_dtype=torch.float32,
                 precompute_dtype=None, device="cuda"):
        _check_precompute_dtype(precompute_dtype)
        self._device = torch.device(device)
        self._p = _psycho.PsychoacousticModel.create(
            sample_rate,
            filter_bands_n=filter_bands_n,
            bark_bands_n=bark_bands_n,
            alpha=alpha,
            compute_dtype=_canonical(compute_dtype),
            device=self._device,
        )
        self.sample_rate = sample_rate
        self.filter_bands_n = filter_bands_n
        self.bark_bands_n = bark_bands_n
        self.alpha = alpha
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(next(_instance_counter))

    # attribute surface the reference exposes
    @property
    def compute_dtype(self):
        return self._p.compute_dtype

    @property
    def max_frequency(self):
        """Nyquist (reference: audiocodec/psychoacoustic.py:61)."""
        return self.sample_rate / 2.0

    @property
    def max_bark(self):
        """Bark value at Nyquist (reference: psychoacoustic.py:62)."""
        return self._p.max_bark

    @property
    def bark_band_width(self):
        """Bark width per Bark band (reference: psychoacoustic.py:63)."""
        return self._p.max_bark / self.bark_bands_n

    def _tensor(self, x):
        return torch.as_tensor(x, device=self._device)

    def freq2bark(self, frequencies):
        """bark = 6*asinh(f/600) (reference: psychoacoustic.py:333)."""
        return 6.0 * torch.asinh(self._tensor(frequencies) / 600.0)

    def bark2freq(self, bark_band):
        """f = 600*sinh(b/6) (reference: psychoacoustic.py:337)."""
        return 600.0 * torch.sinh(self._tensor(bark_band) / 6.0)

    @property
    def W(self):
        return self._p.W

    @property
    def W_inv(self):
        return self._p.W_inv

    @property
    def spreading_matrix(self):
        return self._p.spreading_matrix

    @property
    def quiet_threshold_intensity(self):
        return self._p.quiet_threshold_intensity

    def amplitude_to_dB(self, mdct_amplitude):
        return self._p.amplitude_to_dB(self._tensor(mdct_amplitude))

    def amplitude_to_dB_norm(self, mdct_amplitude):
        return self._p.amplitude_to_dB_norm(self._tensor(mdct_amplitude))

    def tonality(self, mdct_amplitudes):
        return self._p.tonality(self._tensor(mdct_amplitudes))

    def global_masking_threshold(self, mdct_amplitudes, tonality_per_block,
                                 drown=0.0):
        return self._p.global_masking_threshold(
            self._tensor(mdct_amplitudes),
            self._tensor(tonality_per_block),
            drown,
        )

    def add_noise(self, mdct_amplitudes, masking_threshold, generator=None):
        """Reference call shape (no generator). Without ``generator``, the
        instance's own generator draws and advances, as TF's global-seed
        RNG does; a given one must be on the shim's device."""
        return self._p.add_noise(
            self._generator if generator is None else generator,
            self._tensor(mdct_amplitudes), self._tensor(masking_threshold),
        )
