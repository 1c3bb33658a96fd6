"""Differentiable perceptual training step on one device (counterpart of
``audiocodec_tpu/parallel/train.py``).

Learns per-band spectral gains through the whole encode (quantize with a
straight-through gradient) / decode chain against a waveform + noise-to-mask
perceptual loss. The gradient reaches the gains through the synthesis
kernel's VJP (``ops/cuda_mdct.py``) where the codec runs its kernels.
Sharding over ``torch.distributed`` is not ported.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils import checkpoint as _checkpoint

from audiocodec_tpu_torch import quantize as _quantize
from audiocodec_tpu_torch.codec import Codec

# optax.adam(1e-3): the same update rule (b1 0.9, b2 0.999, eps 1e-8)
default_optimizer = functools.partial(torch.optim.Adam, lr=1e-3)


@dataclasses.dataclass
class TrainState:
    """Learnable per-band gains [filters_n] and the optimizer that owns
    them (it holds their state)."""

    gains: torch.Tensor
    optimizer: torch.optim.Optimizer


def init_state(codec: Codec, optimizer=default_optimizer) -> TrainState:
    """Unit gains on the codec's device, in its compute dtype.

    :param optimizer: a callable from a list of parameters to a
        ``torch.optim.Optimizer``.
    """
    mdct = codec.mdct
    gains = torch.ones(mdct.filters_n, dtype=mdct.compute_dtype,
                       device=mdct.wa_r.device, requires_grad=True)
    return TrainState(gains=gains, optimizer=optimizer([gains]))


def perceptual_loss(codec: Codec, gains, x, nmr_weight=0.1):
    """Waveform MSE + noise-to-mask ratio through the quantize-STE chain.

    The gains scale the spectrum before quantization; the STE lets the
    gradient flow through the rounding (see quantize.quantize_ste).
    """
    spec = codec.mdct.transform(x)
    tonality = codec.psycho.tonality(spec)
    threshold = codec.psycho.global_masking_threshold(spec, tonality)
    shaped = spec * gains[None, None, :, None]
    coded = _quantize.quantize_ste(shaped, threshold)
    decoded = codec.mdct.inverse_transform(coded)
    n = codec.mdct.filters_n
    wave_mse = torch.mean((decoded[:, n:-n] - x) ** 2)
    # noise-to-mask ratio: quantization error relative to what is inaudible
    nmr = torch.mean(((coded - shaped) / threshold) ** 2)
    return wave_mse + nmr_weight * nmr


def make_train_step(codec: Codec, optimizer=None, remat: bool = False):
    """Build a train step ``(state, x) -> loss``; returns (train_step,
    optimizer). The step updates ``state.gains`` and the optimizer's state
    in place, where the JAX step returns new ones.

    :param optimizer: a callable from a list of parameters to a
        ``torch.optim.Optimizer``; defaults to Adam at 1e-3.
    :param remat: recompute the forward pass in the backward
        (``torch.utils.checkpoint``), so the spectrum and threshold are not
        kept alive.
    """
    if optimizer is None:
        optimizer = default_optimizer

    def loss_fn(gains, x):
        return perceptual_loss(codec, gains, x)

    if remat:
        plain = loss_fn

        def loss_fn(gains, x):
            return _checkpoint.checkpoint(plain, gains, x,
                                          use_reentrant=False)

    def train_step(state: TrainState, x):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.gains, x)
        loss.backward()
        state.optimizer.step()
        return loss.detach()

    return train_step, optimizer
