"""Neural spectral autoencoder: a learned bottleneck over MDCT frames
(counterpart of ``audiocodec_tpu/models/spectral_ae.py``).

Frames -> encoder MLP -> latent in [-1, 1] -> decoder MLP -> frames,
trained end to end through the codec's real analysis and synthesis against
a waveform + noise-to-mask perceptual loss. Each layer contracts the
filter-band axis of [B, T, N, C] frames as one GEMM. During training
uniform noise of one latent step is added to the latent (from a
``torch.Generator``, where the JAX package takes a key); at inference the
latent is rounded to that grid, a code of ``latent_n * log2(2 /
latent_step)`` bits a frame and channel. Parameters are a dict of tensors
with the JAX package's names and ``[fan_in, fan_out]`` layout, in the
compute dtype.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from audiocodec_tpu_torch.codec import Codec
from audiocodec_tpu_torch.models import _layers
from audiocodec_tpu_torch.parallel.train import default_optimizer


@dataclasses.dataclass(frozen=True)
class SpectralAE:
    """Static architecture config.

    :param filters_n: MDCT filter bands N (the frame width).
    :param hidden_n: hidden layer width.
    :param latent_n: bottleneck width (the learned code per frame/channel).
    :param latent_step: quantization step of the latent grid; the latent
        lives in [-1, 1] (tanh), so bits/frame/channel =
        latent_n * log2(2 / latent_step).
    """

    filters_n: int = 1024
    hidden_n: int = 512
    latent_n: int = 64
    latent_step: float = 1.0 / 32.0

    def bits_per_frame(self) -> float:
        """Code size of one frame of one channel at the latent grid."""
        return self.latent_n * math.log2(2.0 / self.latent_step)


def init_params(generator: torch.Generator, cfg: SpectralAE,
                compute_dtype=torch.float32, device="cuda") -> dict:
    """He-initialized encoder/decoder parameters, zero biases, as leaf
    tensors that require grad.

    :param device: the card unless the caller asks for the CPU.
    """
    n, h, z = cfg.filters_n, cfg.hidden_n, cfg.latent_n
    w = lambda i, o: _layers.he_normal(  # noqa: E731
        generator, i, o, compute_dtype, device)
    params = {"enc_w1": w(n, h), "enc_w2": w(h, z), "dec_w1": w(z, h),
              "dec_w2": w(h, n)}
    dtype = params["enc_w1"].dtype
    for name, width in (("enc_b1", h), ("enc_b2", z), ("dec_b1", h),
                        ("dec_b2", n)):
        params[name] = torch.zeros(width, dtype=dtype, device=device)
    return {k: params[k].requires_grad_() for k in (
        "enc_w1", "enc_b1", "enc_w2", "enc_b2",
        "dec_w1", "dec_b1", "dec_w2", "dec_b2")}


def encode_frames(params: dict, frames: torch.Tensor) -> torch.Tensor:
    """[B, blocks, N, C] spectrum -> [B, blocks, latent_n, C] in [-1, 1]."""
    hidden = _layers.gelu(_layers.dense(frames, params["enc_w1"],
                                        params["enc_b1"]))
    return torch.tanh(_layers.dense(hidden, params["enc_w2"],
                                    params["enc_b2"]))


def decode_frames(params: dict, latents: torch.Tensor) -> torch.Tensor:
    """[B, blocks, latent_n, C] -> reconstructed [B, blocks, N, C]."""
    hidden = _layers.gelu(_layers.dense(latents, params["dec_w1"],
                                        params["dec_b1"]))
    return _layers.dense(hidden, params["dec_w2"], params["dec_b2"])


def quantize_latents(cfg: SpectralAE, latents: torch.Tensor) -> torch.Tensor:
    """Round to the latent grid (inference-time discrete code)."""
    step = torch.tensor(cfg.latent_step, dtype=latents.dtype)
    return torch.round(latents / step) * step


def apply(cfg: SpectralAE, params: dict, frames: torch.Tensor, *,
          generator: torch.Generator | None = None,
          quantized: bool = False) -> torch.Tensor:
    """Full bottleneck pass over spectrum frames.

    :param generator: when given, adds U(-step/2, step/2) noise to the
        latent, drawn from it on its device: the training-time relaxation
        of the quantizer.
    :param quantized: round the latent to the grid (deterministic
        inference; mutually exclusive with ``generator``).
    """
    if generator is not None and quantized:
        raise ValueError(
            "apply(generator=..., quantized=True) is ambiguous: pass a "
            "generator for the training-time noise relaxation OR "
            "quantized=True for rounded discrete-code inference, not both"
        )
    z = encode_frames(params, frames)
    if generator is not None:
        u = torch.rand(z.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
        z = z + ((u - 0.5) * cfg.latent_step).to(z.device, z.dtype)
    elif quantized:
        z = quantize_latents(cfg, z)
    return decode_frames(params, z)


def perceptual_loss(codec: Codec, cfg: SpectralAE, params: dict,
                    x: torch.Tensor, generator=None, nmr_weight: float = 0.1,
                    nmr_floor: float = 1e-3) -> torch.Tensor:
    """Waveform MSE + noise-to-mask ratio through the real codec chain.

    The masking threshold of the original spectrum weighs the
    reconstruction error as the codec's quantizer would be judged.

    :param generator: the latent noise's generator; None for none.
    :param nmr_floor: denominator floor on the threshold, in spectrum
        amplitude units (about -60 dB of a full-scale frame): without it a
        quiet bin outweighs a tonal one by ~1e8 and the decoder that
        outputs zeros is the optimum (the JAX package measured the
        collapse).
    """
    spec = codec.mdct.transform(x)
    tonality = codec.psycho.tonality(spec)
    threshold = codec.psycho.global_masking_threshold(spec, tonality)
    recon = apply(cfg, params, spec, generator=generator)
    decoded = codec.mdct.inverse_transform(recon)
    n = codec.mdct.filters_n
    wave_mse = torch.mean((decoded[:, n:-n] - x) ** 2)
    thr_f = torch.clamp(threshold, min=nmr_floor)
    nmr = torch.mean(((recon - spec) / thr_f) ** 2)
    return wave_mse + nmr_weight * nmr


def make_train_step(codec: Codec, cfg: SpectralAE, optimizer=None,
                    remat: bool = False, nmr_weight: float = 0.1,
                    nmr_floor: float = 1e-3):
    """Train step ``(params, opt, x, generator=None) -> loss``, with ``opt
    = optimizer(list(params.values()))``; returns (train_step, optimizer).
    The step updates the parameters and the optimizer's state in place.

    :param optimizer: a callable from a list of parameters to a
        ``torch.optim.Optimizer``; defaults to Adam at 1e-3.
    :param remat: recompute the forward in the backward
        (``torch.utils.checkpoint``).
    """
    def loss_fn(params, x, generator):
        return perceptual_loss(codec, cfg, params, x, generator, nmr_weight,
                               nmr_floor)

    return (_layers.make_step(loss_fn, remat),
            optimizer or default_optimizer)
