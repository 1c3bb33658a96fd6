"""The codec pipelines in PyTorch (counterpart of ``audiocodec_tpu/codec.py``):

  wav -> MDCT.transform -> tonality -> global_masking_threshold
      -> add_noise (torch.Generator)                         [encode]
       | add_noise_fast (the noise kernel, an int seed)      [encode_fast]
       | quantize                                            [encode_quantized]
      -> (dequantize ->) MDCT.inverse_transform              [decode...]
"""

from __future__ import annotations

import torch
from torch import nn

from audiocodec_tpu_torch import quantize as _quantize
from audiocodec_tpu_torch.mdct import MDCT
from audiocodec_tpu_torch.psycho import PsychoacousticModel


class Codec(nn.Module):
    """MDCT + psychoacoustic model."""

    def __init__(self, mdct: MDCT, psycho: PsychoacousticModel):
        super().__init__()
        self.mdct = mdct
        self.psycho = psycho

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
        device="cuda",
    ) -> "Codec":
        """Build the codec on ``device``: the card unless the caller asks
        for the CPU.

        :param bark_precision: tier of the Bark contractions; defaults to
            ``dct_precision``, except that an ``int8`` MDCT pairs with
            ``default`` Bark contractions (int8 is an MDCT-only tier).
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
                device=device,
            ),
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

    def encode_quantized(self, x: torch.Tensor, drown=0.0):
        """Deterministic encode of a waveform [B, S, C].

        :return: (codes int32 [B, S/N+1, N, C], step sizes, threshold).
        """
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
        codes, delta, _ = self.encode_quantized(x, drown)
        return self.decode_quantized(codes, delta)
