"""The codec pipelines in PyTorch (counterpart of ``audiocodec_tpu/codec.py``):

  wav -> MDCT.transform -> tonality -> global_masking_threshold
      -> add_noise (torch.Generator)                         [encode]
       | add_noise_fast (the noise kernel, an int seed)      [encode_fast]
       | quantize                                            [encode_quantized]
      -> (dequantize ->) MDCT.inverse_transform              [decode...]

and the bitstream path, what a container carries (``encode_frames`` ->
:class:`EncodedFrames` -> ``decode_frames``): integer codes, the
Bark sidecar on the scq grid, and the feature ladder's members: TNS
indices, noise-fill levels, block-switch flags, bandwidth-extension gains
and intensity-stereo gains. The order of operations on both sides is part
of the wire contract: the threshold is pooled last (after every scaling),
the fills run before the TNS inverse filter and before the mid/side
derotation.
"""

from __future__ import annotations

import math
import typing

import torch
from torch import nn

from audiocodec_tpu_torch import blockswitch as _blockswitch
from audiocodec_tpu_torch import bwe as _bwe
from audiocodec_tpu_torch import intensity as _intensity
from audiocodec_tpu_torch import nf as _nf
from audiocodec_tpu_torch import psycho as _psycho
from audiocodec_tpu_torch import quantize as _quantize
from audiocodec_tpu_torch import scq as _scq
from audiocodec_tpu_torch import tns as _tns
from audiocodec_tpu_torch.mdct import MDCT
from audiocodec_tpu_torch.ops import cuda_psycho as _cuda_psycho
from audiocodec_tpu_torch.psycho import PsychoacousticModel
from audiocodec_tpu_torch.utils import dtypes as _dtypes
from audiocodec_tpu_torch.utils.profiling import span


class EncodedFrames(typing.NamedTuple):
    """One encode's transmissible payload (:meth:`Codec.encode_frames`):
    each optional member is None exactly when its feature was off."""

    codes: torch.Tensor  # int32 [B, frames, N, C]
    bark16: torch.Tensor  # bfloat16 [B, frames, bark_n, C or 1 (ms)]
    tns_idx: torch.Tensor | None  # int8 [B, frames, order, C]
    nf_levels: torch.Tensor | None  # uint8 [B, frames, C]
    bs_flags: torch.Tensor | None = None  # bool [B, frames]
    bwe_gains: torch.Tensor | None = None  # uint8 [B, frames, groups, C]
    is_gains: torch.Tensor | None = None  # uint8 [B, frames, groups] (ms)


class Codec(nn.Module):
    """MDCT + psychoacoustic model."""

    def __init__(self, mdct: MDCT, psycho: PsychoacousticModel,
                 sidecar_grid: int = _scq.DEFAULT_K2):
        super().__init__()
        if sidecar_grid:
            _scq.validate_k2(sidecar_grid)
        self.mdct = mdct
        self.psycho = psycho
        # levels per octave of the sidecar's log grid (scq.py); 0 ships raw
        # bfloat16 sidecars. Encoder-side: containers record the grid.
        self.sidecar_grid = int(sidecar_grid)

    @classmethod
    def create(
        cls,
        sample_rate,
        filters_n: int = 1024,
        bark_bands_n: int = 64,
        alpha: float = 0.6,
        window_type="vorbis",
        compute_dtype=torch.float32,
        fast_bf16: bool = False,
        use_kernel="auto",
        dct_precision: str = "highest",
        bark_precision: str | None = None,
        kernel_design: str = "auto",
        sidecar_grid: int = _scq.DEFAULT_K2,
        calibrated: bool = False,
        device="cuda",
    ) -> "Codec":
        """Build the codec on ``device``: the card unless the caller asks
        for the CPU.

        :param bark_precision: tier of the Bark contractions; defaults to
            ``dct_precision``, except that an ``int8`` MDCT pairs with
            ``default`` Bark contractions (int8 is an MDCT-only tier).
        :param sidecar_grid: levels per octave of the Bark sidecar's log
            grid (scq.py), 1, 2, 4 or 8; 0 ships raw bfloat16 sidecars.
        :param calibrated: the psychoacoustic model's calibrated mode
            (``PsychoacousticModel``); False is reference parity.
        """
        if bark_precision is None:
            bark_precision = (
                "default" if dct_precision == "int8" else dct_precision
            )
        return cls(
            MDCT(
                filters_n=filters_n,
                window_type=window_type,
                compute_dtype=compute_dtype,
                fast_bf16=fast_bf16,
                use_kernel=use_kernel,
                dct_precision=dct_precision,
                kernel_design=kernel_design,
                device=device,
            ),
            PsychoacousticModel(
                sample_rate,
                filter_bands_n=filters_n,
                bark_bands_n=bark_bands_n,
                alpha=alpha,
                compute_dtype=compute_dtype,
                bark_precision=bark_precision,
                calibrated=calibrated,
                device=device,
            ),
            sidecar_grid=sidecar_grid,
        )

    def _analyze(self, x: torch.Tensor, drown=0.0):
        """The deterministic front of every encode: (spectrum, masking
        threshold), each [B, S/N+1, N, C], of a waveform [B, S, C]."""
        spectrum = self.mdct.transform(x)
        tonality = self.psycho.tonality(spectrum)
        threshold = self.psycho.global_masking_threshold(
            spectrum, tonality, drown
        )
        return spectrum, threshold

    def decode(self, spectrum: torch.Tensor) -> torch.Tensor:
        """Inverse MDCT: [B, blocks, N, C] -> [B, (blocks+1)*N, C]."""
        return self.mdct.inverse_transform(spectrum)

    def encode(self, x: torch.Tensor, generator: torch.Generator,
               drown=0.0) -> torch.Tensor:
        """Lossy encode, the reference's own: the spectrum with masked
        Gaussian noise (``torch.randn`` from ``generator``) injected.

        :return: noisy spectrum [B, S/N+1, N, C].
        """
        return self.psycho.add_noise(generator, *self._analyze(x, drown))

    def round_trip(self, x: torch.Tensor, generator: torch.Generator,
                   drown=0.0) -> torch.Tensor:
        """encode + decode; the output has filters_n padding samples at
        each end relative to the input."""
        return self.decode(self.encode(x, generator, drown))

    def encode_fast(self, x: torch.Tensor, seed: int,
                    drown=0.0) -> torch.Tensor:
        """Like :meth:`encode`, with the noise drawn and added by the noise
        kernel from the Philox stream of the int ``seed``."""
        return self.psycho.add_noise_fast(seed, *self._analyze(x, drown))

    def round_trip_fast(self, x: torch.Tensor, seed: int,
                        drown=0.0) -> torch.Tensor:
        return self.decode(self.encode_fast(x, seed, drown))

    def _fused(self, x: torch.Tensor) -> bool:
        """Whether the deterministic encode of ``x`` runs the psycho/quantize
        kernel (ops/cuda_psycho.py) between the transforms: ``x`` on the
        card, float32 with float32 Bark products, no autograd graph
        recorded, and rows of a multiple of 4 bins (16-byte aligned, as the
        kernel reads them). Every other input takes the stagewise path."""
        return (x.is_cuda and self.psycho.compute_dtype == torch.float32
                and self.psycho.bark_precision in _cuda_psycho.PRECISIONS
                and self.mdct.filters_n % 4 == 0
                and not (torch.is_grad_enabled() and x.requires_grad))

    def encode_quantized(self, x: torch.Tensor, drown=0.0):
        """Deterministic encode of a waveform [B, S, C].

        :return: (codes int32 [B, S/N+1, N, C], step sizes, threshold).
        """
        if self._fused(x):
            return _cuda_psycho.psycho_quantize(
                self.psycho, self.mdct.transform(x), drown, encode=True)
        spectrum, threshold = self._analyze(x, drown)
        codes, delta = _quantize.quantize(spectrum, threshold)
        return codes, delta, threshold

    def decode_quantized(self, codes: torch.Tensor,
                         delta: torch.Tensor) -> torch.Tensor:
        """Codes + step sizes -> waveform."""
        spectrum = _quantize.dequantize(
            codes, delta, dtype=self.mdct.compute_dtype
        )
        return self.decode(spectrum)

    def round_trip_quantized(self, x: torch.Tensor, drown=0.0) -> torch.Tensor:
        """encode_quantized + decode_quantized; the output has filters_n
        padding samples at each end relative to the input."""
        if self._fused(x):
            return self.decode(_cuda_psycho.psycho_quantize(
                self.psycho, self.mdct.transform(x), drown))
        codes, delta, _ = self.encode_quantized(x, drown)
        return self.decode_quantized(codes, delta)

    # -- bitstream path: what a container carries ----------------------------

    @staticmethod
    def to_mid_side(x: torch.Tensor) -> torch.Tensor:
        """Stereo (channels last, size 2) -> mid/side, orthonormal; works on
        waveforms and spectra alike (the MDCT is linear)."""
        scale = _dtypes.rounded(1.0 / math.sqrt(2.0), x.dtype)
        mid = (x[..., 0:1] + x[..., 1:2]) * scale
        side = (x[..., 0:1] - x[..., 1:2]) * scale
        return torch.cat([mid, side], dim=-1)

    @staticmethod
    def from_mid_side(ms: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`to_mid_side` (self-inverse up to roundoff)."""
        return Codec.to_mid_side(ms)

    def _scaled(self, threshold: torch.Tensor, scale) -> torch.Tensor:
        """``threshold`` times the rate-control scale rounded to the
        compute dtype: a number, or a tensor that broadcasts against the
        threshold (one scale a clip, [B, 1, 1, 1])."""
        dtype = self.mdct.compute_dtype
        if isinstance(scale, torch.Tensor):
            return threshold * scale.to(threshold.device, dtype)
        return threshold * _dtypes.rounded(scale, dtype)

    def _snap(self, bark: torch.Tensor) -> torch.Tensor:
        """The bfloat16 sidecar of Bark intensities: on the scq grid, or raw
        bfloat16 when ``sidecar_grid`` is 0."""
        if self.sidecar_grid:
            return _scq.snap(bark, self.sidecar_grid)
        return bark.to(torch.bfloat16)

    def _ms_threshold(self, bark16_min: torch.Tensor) -> torch.Tensor:
        thr = self.psycho.bark_intensity_to_threshold(
            bark16_min.to(self.mdct.compute_dtype)
        )
        return thr.expand(*thr.shape[:-1], 2)

    def encode_bitstream_ms(self, x: torch.Tensor, drown=0.0,
                            deadzone: float = 0.5, tmask: float = 0.0):
        """Joint-stereo encode of a stereo waveform [B, S, 2]: mid/side
        spectra quantized against the per-band min of the left/right
        masking thresholds, whose Bark intensity (the min over channels)
        is the one-channel sidecar.

        :return: (codes [B, blocks+1, N, 2], bark16 [B, blocks+1, bark, 1]).
        """
        return self.quantize_frames(self.mdct.transform(x), drown, ms=True,
                                    deadzone=deadzone, tmask=tmask)

    def encode_bitstream(self, x: torch.Tensor, drown=0.0,
                         deadzone: float = 0.5, tmask: float = 0.0):
        """Encode a waveform to integer codes plus the bfloat16 Bark masking
        intensity from which the decoder re-derives the step sizes (the
        encoder's own steps come from the same rounded sidecar).

        :return: (codes int32 [B, blocks+1, N, C],
                  bark16 bfloat16 [B, blocks+1, bark_bands_n, C]).
        """
        return self.quantize_frames(self.mdct.transform(x), drown,
                                    deadzone=deadzone, tmask=tmask)

    def analyze_for_quantization(self, frames: torch.Tensor, drown=0.0,
                                 ms: bool = False, tmask: float = 0.0,
                                 tmask_context: torch.Tensor | None = None,
                                 bs: bool = False):
        """The bitstream-critical analysis, in one place: tonality -> Bark
        masking intensity (temporally spread with ``tmask`` dB/s) -> the
        bfloat16 sidecar -> threshold; with ``ms`` the mid/side rotation and
        the min-channel sidecar. With ``bs`` the transient flags are
        detected on the long (pre-rotation) spectrum; the spectrum and
        threshold returned are still long-basis.

        :param tmask_context: the previous chunk's trailing pre-spread Bark
            intensities (:meth:`tmask_context_frames` of them).
        :return: (quantizable spectrum, bark16 sidecar, base threshold,
            bs_flags bool [B, frames] or None).
        """
        bs_flags = (
            _blockswitch.detect(frames, precision=self.mdct.dct_precision)
            if bs else None
        )
        tonality = self.psycho.tonality(frames)
        bark = self.psycho.global_masking_intensity_in_bark(
            frames, tonality, drown
        )
        if tmask:
            bark = self._tmask(bark, tmask, tmask_context)
        if ms:
            spec, bark = self._mid_side(frames, bark)
            bark16 = self._snap(bark)
            return spec, bark16, self._ms_threshold(bark16), bs_flags
        bark16 = self._snap(bark)
        threshold = self.psycho.bark_intensity_to_threshold(
            bark16.to(self.mdct.compute_dtype)
        )
        return frames, bark16, threshold, bs_flags

    # -- the feature ladder's encode stages: each is one span, entered only
    # when its feature is on; none runs inside another or inside a codec
    # stage span, so that their times add up ---------------------------------

    @span("ladder.tmask")
    def _tmask(self, bark, tmask_db_per_s, context):
        """Forward masking of the pre-snap Bark intensities, the previous
        chunk's ``context`` prepended."""
        return _psycho.temporal_masking(
            bark, self._tmask_db_per_frame(tmask_db_per_s), context=context,
        )

    @span("ladder.ms")
    def _mid_side(self, frames, bark):
        """Joint stereo: (the mid/side spectra, the per-band min of the two
        channels' Bark intensities: the one sidecar channel)."""
        if frames.shape[-1] != 2:
            raise ValueError("joint stereo needs exactly 2 channels")
        return self.to_mid_side(frames), torch.amin(bark, dim=-1,
                                                    keepdim=True)

    @span("ladder.bs")
    def _block_switch(self, frames, spec, threshold):
        """Block switching: transient flags from the long (pre-rotation)
        ``frames``, then the flagged frames' ``spec`` in the short basis and
        their ``threshold`` min-pooled. Pooling here, before the TNS scale,
        equals pooling after it: short frames never filter, and an all-zero
        TNS row scales by exactly 1.

        :return: (flags bool [B, frames], spectrum, threshold).
        """
        prec = self.mdct.dct_precision
        flags = _blockswitch.detect(frames, precision=prec)
        return (flags,
                _blockswitch.split_spectrum(spec, flags, precision=prec),
                _blockswitch.pool_threshold(threshold, flags))

    @span("ladder.tns")
    def _tns(self, spec, threshold, bs_flags):
        """Temporal noise shaping: the indices (zero on short frames), the
        filtered spectrum and the gain-compensated threshold."""
        tbs = self.tns_band_start
        idx = _tns.analyze(spec, tbs)
        if bs_flags is not None:
            idx = torch.where(bs_flags[:, :, None, None], 0, idx)
        return (idx, _tns.filter_forward(spec, idx, tbs),
                _tns.scaled_threshold(threshold, idx, tbs))

    @span("ladder.nf")
    def _nf_levels(self, spec, codes, delta, bs_flags, deadzone, bwe, excl):
        nfl = _nf.analyze(spec, codes, delta, self.nf_band_start,
                          deadzone=deadzone,
                          band_end=self.bwe_start if bwe else None,
                          exclude=excl)
        if bs_flags is not None:
            nfl = torch.where(bs_flags[:, :, None], 0, nfl)
        return nfl

    @span("ladder.bwe")
    def _bwe_gains(self, spec, codes, delta, bs_flags, excl):
        gains = _bwe.analyze(spec, codes, delta, self.bwe_start,
                             exclude=excl)
        if bs_flags is not None:
            gains = torch.where(bs_flags[:, :, None, None], 0, gains)
        return gains

    @span("ladder.intensity")
    def _intensity(self, spec, codes, delta, bs_flags, bwe_gains):
        """Intensity stereo: (the codes with the owned side band forced to
        zero, the image gains)."""
        codes, excl = self._intensity_force(codes, bs_flags)
        return codes, self._intensity_gains(spec, codes, delta, bs_flags,
                                            bwe_gains=bwe_gains, excl=excl)

    def _tmask_db_per_frame(self, tmask_db_per_s: float) -> float:
        """dB-per-second forward-masking decay -> dB per frame hop."""
        return (
            float(tmask_db_per_s) * self.mdct.filters_n
            / self.psycho.sample_rate
        )

    def tmask_context_frames(self, tmask_db_per_s: float) -> int:
        """Context frames a streaming encoder carries for chunk-boundary
        temporal masking equal to a whole-file encode's."""
        return _psycho.temporal_masking_window(
            self._tmask_db_per_frame(tmask_db_per_s)
        )

    def bark_intensity(self, frames: torch.Tensor, drown=0.0) -> torch.Tensor:
        """Pre-spread Bark masking intensity of ``frames``: what streaming
        encoders carry as temporal-masking context."""
        return self.psycho.global_masking_intensity_in_bark(
            frames, self.psycho.tonality(frames), drown
        )

    @property
    def tns_band_start(self) -> int:
        """First bin TNS filters cover (tns.default_band_start)."""
        return _tns.default_band_start(self.mdct.filters_n)

    @property
    def nf_band_start(self) -> int:
        """First bin noise filling covers (nf.default_band_start)."""
        return _nf.default_band_start(self.mdct.filters_n)

    @property
    def bwe_start(self) -> int:
        """First bin bandwidth extension replicates (bwe.default_start)."""
        return _bwe.default_start(
            self.mdct.filters_n, self.psycho.sample_rate
        )

    @property
    def is_start(self) -> int:
        """First bin intensity stereo owns (intensity.default_start)."""
        return _intensity.default_start(
            self.mdct.filters_n, self.psycho.sample_rate
        )

    def _intensity_force(self, codes, bs_flags):
        """The encoder-side intensity setup: force the owned side band's
        codes to zero and give the nf/bwe exclusion mask."""
        codes = _intensity.force_codes(codes, self.is_start, bs_flags)
        excl = _intensity.owned_mask(self.mdct.filters_n, self.is_start,
                                     codes.device)
        return codes, excl

    def _intensity_gains(self, spec, codes, delta, bs_flags,
                         bwe_gains=None, excl=None):
        """Encoder-side image gains; with bwe active the projection
        reference is the bwe-reconstructed mid (intensity.mid_reference)."""
        mid_ref = None
        if bwe_gains is not None:
            mid_ref = _intensity.mid_reference(
                codes, delta, self.mdct.compute_dtype,
                bwe_gains=bwe_gains, bwe_start=self.bwe_start,
                exclude=excl,
            )
        isg = _intensity.analyze(spec, codes, delta, self.is_start,
                                 mid_ref=mid_ref)
        if bs_flags is not None:
            # short frames kept their side codes: no gains
            isg = torch.where(bs_flags[:, :, None], 0, isg)
        return isg

    @staticmethod
    def _as_tuple(enc: EncodedFrames) -> tuple:
        """(codes, bark16, *the members that are on, bs_flags last)."""
        members = (enc.tns_idx, enc.nf_levels, enc.bwe_gains, enc.is_gains,
                   enc.bs_flags)
        return (enc.codes, enc.bark16) + tuple(m for m in members
                                               if m is not None)

    def quantize_frames(self, frames: torch.Tensor, drown=0.0,
                        threshold_scale=1.0, ms: bool = False,
                        deadzone: float = 0.5, nf: bool = False,
                        tmask: float = 0.0,
                        tmask_context: torch.Tensor | None = None,
                        bs: bool = False, bwe: bool = False,
                        intensity: bool = False):
        """Spectral frames -> (codes, bf16 Bark sidecar, *members): the
        frame-level half of ``encode_bitstream[_ms]``.

        :param threshold_scale: multiplies the thresholds (the rate-control
            knob); the decoder applies the same scale.
        :param ms: joint mid/side coding (stereo frames only).
        :param deadzone: zero-bin half-width in step units (0.5 = plain
            rounding); the decoder needs ``quantize.dz_recon_offset`` of it.
        :param nf: append uint8 noise-fill levels [B, frames, C].
        :param tmask: forward-masking decay in dB/s (0 = off).
        :param bs: block switching: transient frames quantize in the short
            basis against the min-pooled threshold; bool flags [B, frames]
            are appended last. nf levels and bwe gains are zeroed on them.
        :param bwe: append uint8 bandwidth-extension gains
            [B, frames, groups, C]; with ``nf`` the fill caps at the
            crossover.
        :param intensity: intensity stereo (requires ``ms``): the owned
            side codes are forced to zero and uint8 image gains
            [B, frames, groups] appended; nf/bwe exclude the owned region.
        """
        return self._as_tuple(self.encode_frames(
            frames, drown, threshold_scale=threshold_scale, ms=ms,
            deadzone=deadzone, nf=nf, tmask=tmask,
            tmask_context=tmask_context, bs=bs, bwe=bwe,
            intensity=intensity,
        ))

    def quantize_frames_tns(self, frames: torch.Tensor, drown=0.0,
                            threshold_scale=1.0, ms: bool = False,
                            deadzone: float = 0.5, nf: bool = False,
                            tmask: float = 0.0,
                            tmask_context: torch.Tensor | None = None,
                            bs: bool = False, bwe: bool = False,
                            intensity: bool = False):
        """:meth:`quantize_frames` with temporal noise shaping: frames
        predictable along frequency are whitened by an order-8 LPC filter
        before quantization, and their in-band steps shrink by the
        gain-compensation rule (tns.scaled_threshold). Short block-switch
        frames never filter. The side members are analyzed in the filtered
        domain, where the decoder fills before its inverse filter.

        :return: (codes, bark16, tns_idx int8 [B, frames, order, C],
            *members) as :meth:`quantize_frames` appends them.
        """
        return self._as_tuple(self.encode_frames(
            frames, drown, threshold_scale=threshold_scale, ms=ms,
            deadzone=deadzone, tns=True, nf=nf, tmask=tmask,
            tmask_context=tmask_context, bs=bs, bwe=bwe,
            intensity=intensity,
        ))

    def quantize_frames_fec(self, frames: torch.Tensor, drown=0.0,
                            threshold_scale=1.0, ms: bool = False,
                            deadzone: float = 0.5, tpool: int = 4):
        """Coarse redundant coding for stream FEC members: a plain quantize
        against a time-pooled sidecar, one row per ``tpool`` frames, the
        max masking intensity of the group, snapped on this codec's grid.

        :return: (codes [B, T, N, C], pooled bark16
            [B, ceil(T/tpool), bark_n, C or 1]); the quantizer used the
            repeat-expanded pooled sidecar, as a decoder expands it.
        """
        tonality = self.psycho.tonality(frames)
        bark = self.psycho.global_masking_intensity_in_bark(
            frames, tonality, drown
        )
        if ms:
            if frames.shape[-1] != 2:
                raise ValueError("joint stereo needs exactly 2 channels")
            bark = torch.amin(bark, dim=-1, keepdim=True)
        b, t, nb, cc = bark.shape
        tpool = max(1, int(tpool))
        g = -(-t // tpool)
        pad = g * tpool - t
        if pad:
            bark = torch.cat([bark, bark[:, -1:].expand(b, pad, nb, cc)],
                             dim=1)
        pooled = torch.amax(bark.reshape(b, g, tpool, nb, cc), dim=2)
        bark16 = self._snap(pooled)
        b16f = torch.repeat_interleave(bark16, tpool, dim=1)[:, :t]
        if ms:
            spec = self.to_mid_side(frames)
            threshold = self._ms_threshold(b16f)
        else:
            spec = frames
            threshold = self.psycho.bark_intensity_to_threshold(
                b16f.to(self.mdct.compute_dtype)
            )
        threshold = self._scaled(threshold, threshold_scale)
        codes, _ = _quantize.quantize(spec, threshold, deadzone=deadzone)
        return codes, bark16

    def encode_frames(self, frames: torch.Tensor, drown=0.0,
                      threshold_scale=1.0, ms: bool = False,
                      deadzone: float = 0.5, tns: bool = False,
                      nf: bool = False, tmask: float = 0.0,
                      tmask_context: torch.Tensor | None = None,
                      bs: bool = False, bwe: bool = False,
                      intensity: bool = False) -> EncodedFrames:
        """The one entry point of every coded-bitstream encode
        (:meth:`quantize_frames` and :meth:`quantize_frames_tns` are its
        tuple forms): the analysis, the threshold scale, then block
        switching, TNS, the quantizer, and the members analyzed in the
        domain the quantizer saw (nf, bwe, then intensity, which forces the
        owned side codes to zero; nf and bwe exclude that band, so they read
        the same either side of the forcing). Absent features are None.

        :param frames: MDCT spectra [B, frames, N, C] (``mdct.transform``).
        """
        if intensity and not ms:
            raise ValueError("intensity stereo requires ms=True (it "
                             "codes the mid/side layout)")
        spec, bark16, threshold, _ = self.analyze_for_quantization(
            frames, drown, ms=ms, tmask=tmask, tmask_context=tmask_context,
        )
        threshold = self._scaled(threshold, threshold_scale)
        bs_flags = tns_idx = nfl = gains = isg = None
        if bs:
            bs_flags, spec, threshold = self._block_switch(frames, spec,
                                                           threshold)
        if tns:
            tns_idx, spec, threshold = self._tns(spec, threshold, bs_flags)
        codes, delta = _quantize.quantize(spec, threshold, deadzone=deadzone)
        excl = (_intensity.owned_mask(self.mdct.filters_n, self.is_start,
                                      codes.device) if intensity else None)
        if nf:
            nfl = self._nf_levels(spec, codes, delta, bs_flags, deadzone,
                                  bwe, excl)
        if bwe:
            gains = self._bwe_gains(spec, codes, delta, bs_flags, excl)
        if intensity:
            codes, isg = self._intensity(spec, codes, delta, bs_flags, gains)
        return EncodedFrames(codes, bark16, tns_idx, nfl, bs_flags, gains,
                             isg)

    def _decode_threshold(self, threshold, tns_idx, tbs, bs_flags):
        """The decoder's thresholds, scaled and pooled in the encoder's
        order (TNS scale, then pooling last)."""
        if tns_idx is not None:
            threshold = _tns.scaled_threshold(threshold, tns_idx, tbs)
        if bs_flags is not None:
            threshold = _blockswitch.pool_threshold(threshold, bs_flags)
        return threshold

    def decode_frames(self, codes: torch.Tensor, bark16: torch.Tensor, *,
                      ms: bool = False, threshold_scale=1.0,
                      dz_recon: float = 0.0,
                      tns_idx: torch.Tensor | None = None,
                      tns_band_start: int | None = None,
                      nf_levels: torch.Tensor | None = None,
                      nf_band_start: int | None = None,
                      nf_seed=0, nf_frame_offset=0,
                      bs_flags: torch.Tensor | None = None,
                      bwe_gains: torch.Tensor | None = None,
                      bwe_start: int | None = None,
                      is_gains: torch.Tensor | None = None,
                      is_start: int | None = None) -> torch.Tensor:
        """The one decode body, the mirror of :meth:`encode_frames`: codes
        + sidecar (+ members) -> spectra [B, frames, N, C], derotated to
        left/right with ``ms``. The step sizes follow the encoder's order
        bit for bit: the sidecar's threshold (the one min channel with
        ``ms``), the scale, the TNS gain compensation, the block-switch
        pooling last; then the dequantization, the fills (bwe, noise,
        intensity), the block-switch merge and the TNS inverse filter, all
        in the coded domain before the derotation.

        :param dz_recon: dead-zone reconstruction offset (0 for plain
            rounding).
        :param tns_idx: TNS indices (None: unfiltered); ``tns_band_start``
            the encoder's band start (default this codec's), as each
            ``*_start`` below.
        :param nf_levels: noise-fill levels (None: unfilled); ``nf_seed``
            the container's seed, ``nf_frame_offset`` the global index of
            the first frame.
        :param bs_flags: block-switch flags (None: long only).
        :param bwe_gains: bandwidth-extension gains (None: off), applied
            before the noise fill, which they cap at ``bwe_start``.
        :param is_gains: intensity-stereo image gains (None: fully coded;
            only with ``ms``); nf and bwe then exclude the owned region as
            the encoder did, and with bwe the side is rebuilt from the
            bwe-reconstructed mid.
        """
        if is_gains is not None and not ms:
            raise ValueError("intensity stereo requires ms=True (it "
                             "codes the mid/side layout)")
        dtype = self.mdct.compute_dtype
        threshold = self._scaled(
            self._ms_threshold(bark16) if ms else
            self.psycho.bark_intensity_to_threshold(bark16.to(dtype)),
            threshold_scale,
        )
        tbs = self.tns_band_start if tns_band_start is None else tns_band_start
        delta = _quantize.step_size(
            self._decode_threshold(threshold, tns_idx, tbs, bs_flags)
        )
        spec = _quantize.dequantize(codes, delta, dtype=dtype,
                                    recon_offset=dz_recon)
        excl = ist = bst = None
        if is_gains is not None:
            ist = self.is_start if is_start is None else is_start
            excl = _intensity.owned_mask(self.mdct.filters_n, ist,
                                         codes.device)
        if bwe_gains is not None:
            bst = self.bwe_start if bwe_start is None else bwe_start
            spec = _bwe.fill(spec, codes, delta, bwe_gains, bst,
                             exclude=excl)
        if nf_levels is not None:
            bs_nf = (self.nf_band_start if nf_band_start is None
                     else nf_band_start)
            spec = _nf.fill(spec, codes, delta, nf_levels, bs_nf, nf_seed,
                            nf_frame_offset, band_end=bst, exclude=excl)
        if is_gains is not None:
            # with bwe the fill scales the bwe-reconstructed mid, the
            # reference the encoder projected onto
            mid_ref = None
            if bwe_gains is not None:
                mid_ref = _intensity.mid_reference(
                    codes, delta, dtype, bwe_gains=bwe_gains,
                    bwe_start=bst, exclude=excl,
                )
            spec = _intensity.fill(spec, codes, delta, is_gains, ist,
                                   mid_ref=mid_ref)
        if bs_flags is not None:
            spec = _blockswitch.merge_spectrum(
                spec, bs_flags, precision=self.mdct.dct_precision
            )
        if tns_idx is not None:
            spec = _tns.filter_inverse(spec, tns_idx, tbs)
        return self.from_mid_side(spec) if ms else spec

    def decode_bitstream(self, codes: torch.Tensor, bark16: torch.Tensor,
                         threshold_scale=1.0,
                         dz_recon: float = 0.0,
                         tns_idx: torch.Tensor | None = None,
                         tns_band_start: int | None = None,
                         nf_levels: torch.Tensor | None = None,
                         nf_band_start: int | None = None,
                         nf_seed=0, nf_frame_offset=0,
                         bs_flags: torch.Tensor | None = None,
                         bwe_gains: torch.Tensor | None = None,
                         bwe_start: int | None = None) -> torch.Tensor:
        """Inverse of :meth:`encode_bitstream` and of a mono
        :meth:`encode_frames`: codes + sidecar (+ members) -> waveform
        [B, (blocks+1)*N, C]; the arguments are :meth:`decode_frames`'."""
        return self.decode(self.decode_frames(
            codes, bark16, threshold_scale=threshold_scale,
            dz_recon=dz_recon, tns_idx=tns_idx,
            tns_band_start=tns_band_start, nf_levels=nf_levels,
            nf_band_start=nf_band_start, nf_seed=nf_seed,
            nf_frame_offset=nf_frame_offset, bs_flags=bs_flags,
            bwe_gains=bwe_gains, bwe_start=bwe_start))

    def decode_bitstream_ms(self, codes: torch.Tensor, bark16: torch.Tensor,
                            threshold_scale=1.0,
                            dz_recon: float = 0.0,
                            tns_idx: torch.Tensor | None = None,
                            tns_band_start: int | None = None,
                            nf_levels: torch.Tensor | None = None,
                            nf_band_start: int | None = None,
                            nf_seed=0, nf_frame_offset=0,
                            bs_flags: torch.Tensor | None = None,
                            bwe_gains: torch.Tensor | None = None,
                            bwe_start: int | None = None,
                            is_gains: torch.Tensor | None = None,
                            is_start: int | None = None
                            ) -> torch.Tensor:
        """Inverse of :meth:`encode_bitstream_ms` and of a mid/side
        :meth:`encode_frames` -> left/right waveform; the arguments are
        :meth:`decode_frames`'."""
        return self.decode(self.decode_frames(
            codes, bark16, ms=True, threshold_scale=threshold_scale,
            dz_recon=dz_recon, tns_idx=tns_idx,
            tns_band_start=tns_band_start, nf_levels=nf_levels,
            nf_band_start=nf_band_start, nf_seed=nf_seed,
            nf_frame_offset=nf_frame_offset, bs_flags=bs_flags,
            bwe_gains=bwe_gains, bwe_start=bwe_start, is_gains=is_gains,
            is_start=is_start))
