"""MDCT-domain neural post-filter: enhance decoded spectra (counterpart of
``audiocodec_tpu/models/post_filter.py``).

A small residual MLP runs on the dequantized spectrum, before the inverse
MDCT, conditioned on the per-bin step size ``delta`` the decoder knows,
with +-1 frame of temporal context. Its output head is zero at init, so
the untrained filter is exactly the identity. Parameters are a dict with
the JAX package's names and ``[fan_in, fan_out]`` layout.
"""

from __future__ import annotations

import dataclasses

import torch

from audiocodec_tpu_torch import quantize as _quantize
from audiocodec_tpu_torch.codec import Codec
from audiocodec_tpu_torch.models import _layers
from audiocodec_tpu_torch.parallel.train import default_optimizer


@dataclasses.dataclass(frozen=True)
class PostFilter:
    """Static architecture config.

    :param filters_n: MDCT filter bands N.
    :param hidden_n: hidden width of the residual MLP.
    """

    filters_n: int = 1024
    hidden_n: int = 512


def init_params(generator: torch.Generator, cfg: PostFilter,
                compute_dtype=torch.float32, device="cuda") -> dict:
    """He-initialized hidden layer, zero output head (identity start), as
    leaf tensors that require grad.

    :param device: the card unless the caller asks for the CPU.
    """
    n, h = cfg.filters_n, cfg.hidden_n
    w1 = _layers.he_normal(generator, 4 * n, h, compute_dtype, device)
    zeros = lambda *shape: torch.zeros(  # noqa: E731
        shape, dtype=w1.dtype, device=device)
    params = {"w1": w1, "b1": zeros(h), "w2": zeros(h, n), "b2": zeros(n)}
    return {k: v.requires_grad_() for k, v in params.items()}


def _delta_features(delta: torch.Tensor) -> torch.Tensor:
    """Per-bin noise-magnitude conditioning: log10(delta), squashed to
    O(1) (deltas span ~[1e-12, 1])."""
    return torch.log(torch.clamp(delta, min=1e-12)) * (1.0 / (12.0 * 2.302585))


def apply(cfg: PostFilter, params: dict, spec_q: torch.Tensor,
          delta: torch.Tensor) -> torch.Tensor:
    """Enhanced spectrum = spec_q + residual(spec_q, delta) * delta.

    :param spec_q: dequantized spectrum [B, blocks, N, C].
    :param delta: per-bin quantization step sizes, same shape.
    """
    # +-1 frame of temporal context: quantization noise is independent
    # across frames while tonal content is correlated
    prev = torch.cat([spec_q[:, :1], spec_q[:, :-1]], dim=1)
    nxt = torch.cat([spec_q[:, 1:], spec_q[:, -1:]], dim=1)
    feats = torch.cat(
        [prev, spec_q, nxt, _delta_features(delta).to(spec_q.dtype)], dim=2
    )
    hidden = _layers.gelu(_layers.dense(feats, params["w1"], params["b1"]))
    resid = _layers.dense(hidden, params["w2"], params["b2"])
    # the correction is in units of the step: every bin's true error lies
    # in [-delta/2, delta/2]
    return spec_q + resid * delta.to(spec_q.dtype)


def enhancement_loss(codec: Codec, cfg: PostFilter, params: dict,
                     x: torch.Tensor, nmr_weight: float = 0.1,
                     threshold_scale: float = 1.0) -> torch.Tensor:
    """Encode x with the real quantized codec, enhance the dequantized
    spectrum, and score the decoded waveform + the residual noise-to-mask
    ratio against the clean original.

    :param threshold_scale: quantize coarser than nominal (the low-bitrate
        regime where a post-filter has structure to restore).
    """
    spec = codec.mdct.transform(x)
    tonality = codec.psycho.tonality(spec)
    threshold = codec.psycho.global_masking_threshold(spec, tonality)
    threshold = threshold * torch.tensor(threshold_scale,
                                         dtype=threshold.dtype)
    codes, delta = _quantize.quantize(spec, threshold)
    spec_q = _quantize.dequantize(codes, delta, dtype=spec.dtype)
    enhanced = apply(cfg, params, spec_q, delta)
    decoded = codec.mdct.inverse_transform(enhanced)
    n = codec.mdct.filters_n
    wave_mse = torch.mean((decoded[:, n:-n] - x) ** 2)
    # a floored denominator: near-silent bins have thresholds at the quiet
    # floor, and dividing a learned residual by them explodes the gradients
    thr_f = torch.clamp(threshold, min=1e-5)
    nmr = torch.mean(((enhanced - spec) / thr_f) ** 2)
    return wave_mse + nmr_weight * nmr


def make_train_step(codec: Codec, cfg: PostFilter, optimizer=None,
                    remat: bool = False, nmr_weight: float = 0.1,
                    threshold_scale: float = 1.0):
    """Train step ``(params, opt, x) -> loss``, with ``opt =
    optimizer(list(params.values()))``; returns (train_step, optimizer).
    The step updates the parameters and the optimizer's state in place.
    Train at the ``threshold_scale`` the filter will serve at."""
    def loss_fn(params, x, generator):
        return enhancement_loss(codec, cfg, params, x, nmr_weight,
                                threshold_scale)

    return (_layers.make_step(loss_fn, remat),
            optimizer or default_optimizer)


def decode_enhanced(codec: Codec, cfg: PostFilter, params: dict,
                    codes: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Decoder-side integration: dequantize -> post-filter -> inverse MDCT
    (a drop-in for ``Codec.decode_quantized``)."""
    dtype = codec.mdct.compute_dtype
    spec_q = _quantize.dequantize(codes, delta, dtype=dtype)
    return codec.mdct.inverse_transform(
        apply(cfg, params, spec_q, delta.to(dtype))
    )
