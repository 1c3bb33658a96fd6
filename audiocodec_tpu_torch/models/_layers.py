"""What the model families share: the per-frame dense layer, He
initialization and the train step's plumbing."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _checkpoint

from audiocodec_tpu_torch.ops import dct as _dct
from audiocodec_tpu_torch.parallel.train import optimizer_step
from audiocodec_tpu_torch.utils import dtypes as _dtypes


def he_normal(generator: torch.Generator, fan_in: int, fan_out: int,
              compute_dtype, device) -> torch.Tensor:
    """A [fan_in, fan_out] He-initialized weight: float32 normals from
    ``generator`` (drawn on its device) scaled by sqrt(2 / fan_in), then
    cast to the compute dtype, as the JAX package draws them."""
    dtype = _dtypes.canonicalize_compute_dtype(compute_dtype)
    w = torch.randn(fan_in, fan_out, generator=generator,
                    dtype=torch.float32, device=generator.device)
    return (w * (2.0 / fan_in) ** 0.5).to(device=device, dtype=dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """Contract the band axis of [B, T, K, C] frames with w [K, H] as one
    GEMM ('btkc,kh->bthc'), with float32 sums: bfloat16 operands at the
    ``default`` tier, float32 at ``highest`` (TF32 off on the card; float64
    stays float64); out in x's dtype, plus the bias."""
    tier = "default" if x.dtype == torch.bfloat16 else "highest"
    y = _dct.matmul(x.transpose(2, 3), w, tier).transpose(2, 3).to(x.dtype)
    return y if b is None else y + b[None, None, :, None]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def make_step(loss_fn, remat: bool, mesh=None):
    """A train step ``(params, optimizer, x, generator=None) -> loss`` over
    ``loss_fn(params, x, generator)``: one backward and one optimizer step,
    updating ``params`` and the optimizer's state in place where the JAX
    step returns new ones. With ``remat`` the forward is recomputed in the
    backward (``torch.utils.checkpoint``); the generator's state is set
    back before each of the two forwards, so both draw the same noise.
    Under a ``mesh`` of several processes the gradients and the loss are
    averaged over its group before the optimizer steps
    (``parallel.train.optimizer_step``)."""
    if remat:
        plain = loss_fn

        def loss_fn(params, x, generator):
            state = None if generator is None else generator.get_state()

            def run(params, x):
                if state is not None:
                    generator.set_state(state)
                return plain(params, x, generator)

            return _checkpoint.checkpoint(run, params, x, use_reentrant=False)

    def train_step(params: dict, optimizer, x, generator=None):
        return optimizer_step(
            params.values(), optimizer,
            lambda: (loss_fn(params, x, generator), None), mesh)[0]

    return train_step
