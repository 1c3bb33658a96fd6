"""Differentiable perceptual training step (counterpart of
``audiocodec_tpu/parallel/train.py``).

Learns per-band spectral gains through the whole encode (quantize with a
straight-through gradient) / decode chain against a waveform + noise-to-mask
perceptual loss. The gradient reaches the gains through the synthesis
kernel's VJP (``ops/cuda_mdct.py``) where the codec runs its kernels.
Under a mesh the batch splits dp over its rows and each row's blocks sp
over the row's devices (``parallel.sequence``); each row adds its share of
the batch's mean, so the step equals the single-device step, and across
processes the gradients and the loss are averaged over the mesh's group
before the optimizer steps (JAX's GSPMD-inserted psum).

Every trainer's step (this one, the models' ``_layers.make_step`` and the
RVQ codec's) is one :func:`optimizer_step`, whose three spans split it:
``train.forward`` (the loss), ``train.backward`` (its backward, and the
mesh's average) and ``train.optimizer`` (the optimizer's step).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils import checkpoint as _checkpoint

from audiocodec_tpu_torch import quantize as _quantize
from audiocodec_tpu_torch.codec import Codec
from audiocodec_tpu_torch.parallel import sequence as _seq
from audiocodec_tpu_torch.utils import profiling as _profiling

# optax.adam(1e-3): the same update rule (b1 0.9, b2 0.999, eps 1e-8)
default_optimizer = functools.partial(torch.optim.Adam, lr=1e-3)


def optimizer_step(params, optimizer, forward, mesh=None):
    """One step of ``optimizer`` on the loss of ``forward() -> (loss,
    aux)``: the gradients cleared, the loss (span ``train.forward``), its
    backward (``train.backward``; under a ``mesh`` the gradients of
    ``params`` and the loss then averaged over its group) and the
    optimizer's step (``train.optimizer``). Returns (the loss detached,
    aux)."""
    optimizer.zero_grad(set_to_none=True)
    with _profiling.span("train.forward"):
        loss, aux = forward()
    with _profiling.span("train.backward"):
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            mesh.all_mean([p.grad for p in params if p.grad is not None]
                          + [loss])
    with _profiling.span("train.optimizer"):
        optimizer.step()
    return loss, aux


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


def _loss(codecs, gains, x, nmr_weight=0.1):
    """:func:`perceptual_loss` of one dp row, its blocks split over the
    devices of ``codecs`` (one codec a shard)."""
    def frames(specs, thresholds):
        coded, nmr = [], []
        for spec, threshold in zip(specs, thresholds):
            shaped = spec * gains.to(spec.device)[None, None, :, None]
            c = _quantize.quantize_ste(shaped, threshold)
            coded.append(c)
            # noise-to-mask ratio: quantization error relative to what is
            # inaudible
            nmr.append(((c - shaped) / threshold) ** 2)
        return coded, [nmr]

    return _seq.codec_loss(codecs, x, frames, [nmr_weight])


def perceptual_loss(codec: Codec, gains, x, nmr_weight=0.1):
    """Waveform MSE + noise-to-mask ratio through the quantize-STE chain.

    The gains scale the spectrum before quantization; the STE lets the
    gradient flow through the rounding (see quantize.quantize_ste).
    """
    return _loss([codec], gains, x, nmr_weight)


def make_train_step(codec: Codec, optimizer=None, remat: bool = False,
                    mesh=None):
    """Build a train step ``(state, x) -> loss``; returns (train_step,
    optimizer). The step updates ``state.gains`` and the optimizer's state
    in place, where the JAX step returns new ones.

    :param optimizer: a callable from a list of parameters to a
        ``torch.optim.Optimizer``; defaults to Adam at 1e-3.
    :param remat: recompute the forward pass in the backward
        (``torch.utils.checkpoint``), so the spectrum and threshold are not
        kept alive.
    :param mesh: a ``parallel.mesh.Mesh``: ``x`` (this process's batch)
        splits dp x sp over it; None runs on the gains' device.
    """
    if optimizer is None:
        optimizer = default_optimizer

    if mesh is None:
        def loss_fn(gains, x):
            return perceptual_loss(codec, gains, x)
    else:
        rows = _seq.mesh_rows(codec, mesh)

        def loss_fn(gains, x):
            return _seq.mesh_loss(mesh, rows, x, lambda codecs, xr, r: _loss(
                codecs, gains, xr))

    if remat:
        plain = loss_fn

        def loss_fn(gains, x):
            return _checkpoint.checkpoint(plain, gains, x,
                                          use_reentrant=False)

    def train_step(state: TrainState, x):
        return optimizer_step([state.gains], state.optimizer,
                              lambda: (loss_fn(state.gains, x), None),
                              mesh)[0]

    return train_step, optimizer
