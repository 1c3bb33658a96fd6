"""Masking-driven quantization in PyTorch (counterpart of
``audiocodec_tpu/quantize.py``).

A uniform mid-tread quantizer whose step per band is threshold / sqrt(3),
so its noise power (delta^2 / 12) equals that of the reference's injected
noise (sigma = threshold / 6).
"""

from __future__ import annotations

import math

import torch

from audiocodec_tpu_torch.utils.profiling import span


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d constant in ``like``'s dtype, kept on the host: a CUDA kernel
    takes it as an argument, with no copy to the device in each call."""
    return torch.tensor(value, dtype=like.dtype)


def step_size(masking_threshold: torch.Tensor,
              floor: float = 1e-12) -> torch.Tensor:
    """Quantization step per band: threshold / sqrt(3), floored."""
    return torch.maximum(
        masking_threshold * _const(1.0 / math.sqrt(3.0), masking_threshold),
        _const(floor, masking_threshold),
    )


@span("quantize.quantize")
def quantize(mdct_amplitudes: torch.Tensor, masking_threshold: torch.Tensor,
             deadzone: float = 0.5):
    """Quantize spectra to integer codes.

    :param deadzone: zero-bin half-width in step units, in [0.5, 2.0]; 0.5
        is the plain mid-tread rounder (round half to even).
    :return: (codes int32, step sizes), both of the input's shape.
    """
    if not 0.5 <= deadzone <= 2.0:
        raise ValueError(f"deadzone must be in [0.5, 2.0], got {deadzone}")
    delta = step_size(masking_threshold)
    if deadzone == 0.5:
        codes = torch.round(mdct_amplitudes / delta).to(torch.int32)
    else:
        u = torch.abs(mdct_amplitudes) / delta
        mag = torch.clamp(
            torch.floor(u - _const(deadzone - 1.0, u)),
            min=0.0,
        )
        codes = (torch.sign(mdct_amplitudes) * mag).to(torch.int32)
    return codes, delta


def dz_recon_offset(deadzone: float, recon_point=None) -> float:
    """Decoder-side reconstruction offset rho of a dead-zone quantizer:
    rho = deadzone + m - 1, with m the point inside the bin (0.5 for mild
    dead zones, else 0.45)."""
    if recon_point is None:
        recon_point = 0.5 if deadzone <= 0.75 else 0.45
    return deadzone + recon_point - 1.0


@span("quantize.dequantize")
def dequantize(codes: torch.Tensor, delta: torch.Tensor, dtype=None,
               recon_offset: float = 0.0) -> torch.Tensor:
    """Reconstruct spectra from integer codes and step sizes."""
    mag = codes.to(delta.dtype)
    if recon_offset:
        mag = mag + torch.sign(mag) * _const(recon_offset, delta)
    out = mag * delta
    return out if dtype is None else out.to(dtype)


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mdct_amplitudes, masking_threshold):
        codes, delta = quantize(mdct_amplitudes, masking_threshold)
        return dequantize(codes, delta, dtype=mdct_amplitudes.dtype)

    @staticmethod
    def backward(ctx, g):
        zeros = torch.zeros_like(g) if ctx.needs_input_grad[1] else None
        return g, zeros


def quantize_ste(mdct_amplitudes: torch.Tensor,
                 masking_threshold: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize round trip with a straight-through gradient.

    Forward: dequantize(quantize(x)); backward: identity on the amplitudes,
    zeros on the threshold. Lets training optimize through the quantizer.
    """
    return _QuantizeSTE.apply(mdct_amplitudes, masking_threshold)
