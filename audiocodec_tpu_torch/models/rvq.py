"""Residual vector quantization over the spectral autoencoder's latent
(counterpart of ``audiocodec_tpu/models/rvq.py``), on one device.

The whole latent vector of a frame and channel is matched against a learned
codebook, and the match repeats on the residual over a few stages: four
stages of 1024 codewords code a frame in 40 bits where the scalar latent grid
takes 384. Codebooks learn by exponential-moving-average k-means, not by
gradients; dead codewords (EMA count below a threshold) reseed from random
batch vectors drawn with a ``torch.Generator`` (where the JAX package draws
``jax.random.randint``). A straight-through estimator carries the decoder's
gradient through the quantizer, and a commitment term keeps the encoder near
its codewords.

The nearest-codeword search is ``argmin(|c|^2 - 2 r.c)`` over a float32
``torch.matmul`` of scores (TF32 off), then an index gather; the EMA counts
and sums are a ``bincount`` and an ``index_add_``. The JAX package's one-hot
matmuls are the TPU's way to gather and are not carried over: the gathered
codeword is the one-hot product's exact value. The state is a dict of
tensors (``codebooks`` [S, K, D] in the compute dtype, ``ema_count`` [S, K]
and ``ema_sum`` [S, K, D] in float32) that no gradient reaches; the train
step updates it in place.

Codes pack host-side at exactly S * log2(K) bits a frame and channel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint

from audiocodec_tpu_torch.codec import Codec
from audiocodec_tpu_torch.models import spectral_ae as _sae
from audiocodec_tpu_torch.ops import dct as _dct
from audiocodec_tpu_torch.parallel.train import default_optimizer
from audiocodec_tpu_torch.utils import dtypes as _dtypes


@dataclasses.dataclass(frozen=True)
class RVQ:
    """Static RVQ architecture config.

    :param stages: residual quantization stages S.
    :param codebook_size: codewords a stage K (a power of two, so codes pack
        at a fixed width).
    :param dim: latent vector dimension D (the autoencoder's ``latent_n``).
    :param ema_decay: EMA k-means decay of the counts and vector sums.
    :param reseed_threshold: EMA count below which a codeword is dead and
        reseeds from a random batch vector.
    :param commitment_weight: beta of the commitment loss
        beta * mean((z - sg(q))^2).
    """

    stages: int = 4
    codebook_size: int = 1024
    dim: int = 64
    ema_decay: float = 0.99
    reseed_threshold: float = 1.0
    commitment_weight: float = 0.25

    def __post_init__(self):
        if self.stages < 1:
            raise ValueError(f"stages must be >= 1, got {self.stages}")
        k = self.codebook_size
        if k < 2 or (k & (k - 1)) != 0:
            raise ValueError(
                f"codebook_size must be a power of two >= 2 (codes pack "
                f"at fixed bit width), got {k}"
            )

    @property
    def bits_per_index(self) -> int:
        return int(math.log2(self.codebook_size))

    def bits_per_frame(self) -> float:
        """Code size of one frame of one channel: S * log2(K)."""
        return self.stages * self.bits_per_index


def init_state(generator: torch.Generator, cfg: RVQ,
               compute_dtype=torch.float32, device="cuda") -> dict:
    """Codebooks at small random vectors (float32 normals from
    ``generator``, on its device, times 0.1, cast to the compute dtype),
    EMA counts at 1 (no codeword is born dead) and EMA sums consistent with
    them (count * codeword, float32).

    :param device: the card unless the caller asks for the CPU.
    """
    dtype = _dtypes.canonicalize_compute_dtype(compute_dtype)
    s, k, d = cfg.stages, cfg.codebook_size, cfg.dim
    codebooks = (torch.randn(s, k, d, generator=generator, dtype=torch.float32,
                             device=generator.device) * 0.1).to(device, dtype)
    count = torch.ones(s, k, dtype=torch.float32, device=device)
    return {"codebooks": codebooks, "ema_count": count,
            "ema_sum": count[..., None] * codebooks.float()}


def _flatten_latents(z: torch.Tensor, dim: int) -> torch.Tensor:
    """[B, T, Z, C] (channels last) -> [M, Z]."""
    if z.shape[-2] != dim:
        raise ValueError(
            f"latent axis {z.shape[-2]} != RVQ dim {dim}; RVQ.dim must "
            "equal the autoencoder's latent_n"
        )
    return z.movedim(-1, -2).reshape(-1, dim)


def _unflatten_latents(flat: torch.Tensor, shape) -> torch.Tensor:
    """[M, Z] -> [B, T, Z, C] of ``shape``."""
    b, t, zdim, c = shape
    return flat.reshape(b, t, c, zdim).movedim(-1, -2)


def _nearest(residual: torch.Tensor, codebook: torch.Tensor):
    """One stage: (indices int64 [M], the selected codewords in the
    residual's dtype). argmin over |r - c|^2 drops the |r|^2 constant:
    |c|^2 - 2 r.c with float32 scores (bf16 operands: float32 sums); ties
    go to the first index, as ``jnp.argmin``'s."""
    tier = "default" if residual.dtype == torch.bfloat16 else "highest"
    scores = _dct.matmul(residual, codebook.T, tier)
    sq = torch.sum(codebook.float() ** 2, dim=-1)
    idx = torch.argmin(sq[None, :] - 2.0 * scores, dim=-1)
    return idx, codebook[idx].to(residual.dtype)


def quantize(cfg: RVQ, state: dict, z: torch.Tensor):
    """RVQ the latent with a straight-through estimator.

    :param z: [B, blocks, latent_n, C] autoencoder latents.
    :returns: (z_q, codes, commitment): ``z_q`` has the quantized value and
        the identity gradient; ``codes`` is int32 [B, blocks, C, S];
        ``commitment`` is the scalar beta-weighted commitment loss.
    """
    flat = _flatten_latents(z, cfg.dim)
    residual = flat.detach()
    codes = []
    for codebook in state["codebooks"]:
        idx, q = _nearest(residual, codebook)
        residual = residual - q
        codes.append(idx)
    quant = flat.detach() - residual  # the sum of the stages
    z_q = _unflatten_latents(flat + (quant - flat).detach(), z.shape)
    b, t, _, c = z.shape
    codes = torch.stack(codes, dim=-1).reshape(b, t, c, cfg.stages)
    commitment = cfg.commitment_weight * torch.mean((flat - quant) ** 2)
    return z_q, codes.to(torch.int32), commitment


def ema_update(cfg: RVQ, state: dict, z: torch.Tensor,
               generator: torch.Generator | None = None) -> dict:
    """One EMA k-means step of every stage's codebook from the batch ``z``;
    returns the new state. Dead codewords (EMA count below
    ``reseed_threshold``) reseed from batch vectors picked by
    ``torch.randint`` from ``generator`` (on its device; the default
    generator of the latents' device when None)."""
    flat = _flatten_latents(z, cfg.dim).detach().float()
    m, k, decay = flat.shape[0], cfg.codebook_size, cfg.ema_decay
    residual, counts, sums = flat, [], []
    for codebook in state["codebooks"]:
        idx, q = _nearest(residual.to(codebook.dtype), codebook)
        counts.append(torch.bincount(idx, minlength=k).float())
        sums.append(torch.zeros(k, cfg.dim, device=flat.device)
                    .index_add_(0, idx, residual))
        residual = residual - q.float()
    new_count = decay * state["ema_count"] + (1 - decay) * torch.stack(counts)
    new_sum = decay * state["ema_sum"] + (1 - decay) * torch.stack(sums)
    # Laplace-smoothed means: a near-empty codeword does not blow up
    n_total = torch.sum(new_count, dim=-1, keepdim=True)
    smoothed = (new_count + 1e-5) / (n_total + k * 1e-5) * n_total
    means = new_sum / smoothed[..., None]
    device = flat.device if generator is None else generator.device
    pick = torch.randint(0, m, (cfg.stages, k), generator=generator,
                         device=device).to(flat.device)
    dead = (new_count < cfg.reseed_threshold)[..., None]
    reseeded = torch.where(dead, flat[pick], means)
    return {"codebooks": reseeded.to(state["codebooks"].dtype),
            "ema_count": new_count, "ema_sum": new_sum}


def decode_codes(cfg: RVQ, state: dict, codes: torch.Tensor) -> torch.Tensor:
    """int codes [B, blocks, C, S] -> latents [B, blocks, dim, C]: each
    stage's codeword gathered and the stages summed in float32, then cast to
    the codebooks' dtype."""
    codebooks = state["codebooks"]
    codes = torch.as_tensor(codes, device=codebooks.device).long()
    z = codebooks[0][codes[..., 0]].float()
    for s in range(1, cfg.stages):
        z = z + codebooks[s][codes[..., s]].float()
    return z.to(codebooks.dtype).movedim(-1, -2)


def pack_codes(cfg: RVQ, codes) -> bytes:
    """Fixed-width bit-pack int codes host-side: S * log2(K) bits a frame.

    Layout: little-endian bit order within the flattened [B, T, C, S]
    index sequence; trailing bits of the final byte are zero."""
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    bits = cfg.bits_per_index
    flat = np.asarray(codes, dtype=np.uint32).reshape(-1)
    if flat.size and (flat.min() < 0 or flat.max() >= cfg.codebook_size):
        raise ValueError("codes out of range for the codebook")
    bitmat = (flat[:, None] >> np.arange(bits, dtype=np.uint32)) & 1
    return np.packbits(bitmat.astype(np.uint8), bitorder="little").tobytes()


def unpack_codes(cfg: RVQ, data: bytes, shape) -> np.ndarray:
    """Inverse of :func:`pack_codes` for a known [B, T, C, S] shape; int32
    numpy codes."""
    bits = cfg.bits_per_index
    n = int(np.prod(shape))
    raw = np.frombuffer(data, dtype=np.uint8)
    bitmat = np.unpackbits(raw, bitorder="little")[: n * bits]
    if bitmat.size < n * bits:
        raise ValueError("truncated RVQ code payload")
    bitmat = bitmat.reshape(n, bits).astype(np.uint32)
    flat = (bitmat << np.arange(bits, dtype=np.uint32)[None, :]).sum(
        axis=1, dtype=np.uint32
    )
    return flat.reshape(shape).astype(np.int32)


def perceptual_loss(codec: Codec, ae_cfg: _sae.SpectralAE, rvq_cfg: RVQ,
                    params: dict, rvq_state: dict, x: torch.Tensor,
                    nmr_weight: float = 0.1, nmr_floor: float = 1e-3,
                    quantizer_gate=1.0):
    """Waveform MSE + noise-to-mask ratio through the codec chain, the RVQ
    in the bottleneck, plus the commitment term; returns (loss, z), the
    latents before quantization (for the EMA update).

    :param quantizer_gate: 0.0 bypasses the quantizer (the decoder sees the
        continuous latent, no commitment), 1.0 engages it. Engaging it at
        init collapses the bottleneck: the commitment term drags the encoder
        toward the near-zero random codebooks faster than the EMA follows
        the latents.
    """
    spec = codec.mdct.transform(x)
    tonality = codec.psycho.tonality(spec)
    threshold = codec.psycho.global_masking_threshold(spec, tonality)
    z = _sae.encode_frames(params, spec)
    z_q, _codes, commitment = quantize(rvq_cfg, rvq_state, z)
    gate = torch.tensor(quantizer_gate, dtype=z.dtype)  # on the host
    z_q = z + gate * (z_q - z)  # the STE already carries z's gradient
    commitment = gate * commitment
    recon = _sae.decode_frames(params, z_q)
    decoded = codec.mdct.inverse_transform(recon)
    n = codec.mdct.filters_n
    wave_mse = torch.mean((decoded[:, n:-n] - x) ** 2)
    thr_f = torch.clamp(threshold, min=nmr_floor)
    nmr = torch.mean(((recon - spec) / thr_f) ** 2)
    return wave_mse + nmr_weight * nmr + commitment, z


def make_train_step(codec: Codec, ae_cfg: _sae.SpectralAE, rvq_cfg: RVQ,
                    optimizer=None, remat: bool = False,
                    nmr_weight: float = 0.1, nmr_floor: float = 1e-3,
                    warmup_steps: int = 0):
    """Joint step ``(params, rvq_state, opt, x, generator, step) -> loss``,
    with ``opt = optimizer(list(params.values()))``; returns (train_step,
    optimizer). The autoencoder's parameters take one optimizer step on the
    perceptual loss; then the codebooks take one EMA step on that forward's
    latents (``generator`` draws the reseeds). Parameters, optimizer and
    RVQ state are updated in place.

    :param optimizer: a callable from a list of parameters to a
        ``torch.optim.Optimizer``; defaults to Adam at 1e-3.
    :param remat: recompute the forward in the backward
        (``torch.utils.checkpoint``).
    :param warmup_steps: for ``step < warmup_steps`` the decoder trains on
        the continuous latent while the EMA fits the codebooks to it; the
        quantizer then engages on codebooks already on the data.
    """
    def loss_fn(params, rvq_state, x, gate):
        return perceptual_loss(codec, ae_cfg, rvq_cfg, params, rvq_state, x,
                               nmr_weight, nmr_floor, quantizer_gate=gate)

    if remat:
        plain = loss_fn

        def loss_fn(params, rvq_state, x, gate):
            return _checkpoint.checkpoint(plain, params, rvq_state, x, gate,
                                          use_reentrant=False)

    def train_step(params: dict, rvq_state: dict, optimizer, x,
                   generator=None, step: int = 0):
        gate = 1.0 if step >= warmup_steps else 0.0
        optimizer.zero_grad(set_to_none=True)
        loss, z = loss_fn(params, rvq_state, x, gate)
        loss.backward()
        optimizer.step()
        rvq_state.update(ema_update(rvq_cfg, rvq_state, z, generator))
        return loss.detach()

    return train_step, optimizer or default_optimizer


@torch.no_grad()
def encode_discrete(codec: Codec, ae_cfg: _sae.SpectralAE, rvq_cfg: RVQ,
                    params: dict, rvq_state: dict,
                    x: torch.Tensor) -> torch.Tensor:
    """Waveform [B, S, C] -> int32 RVQ codes [B, S/N+1, C, stages]."""
    z = _sae.encode_frames(params, codec.mdct.transform(x))
    return quantize(rvq_cfg, rvq_state, z)[1]


@torch.no_grad()
def decode_discrete(codec: Codec, ae_cfg: _sae.SpectralAE, rvq_cfg: RVQ,
                    params: dict, rvq_state: dict, codes) -> torch.Tensor:
    """int RVQ codes (a tensor or :func:`unpack_codes`' array) -> waveform
    [B, samples, C]."""
    z = decode_codes(rvq_cfg, rvq_state, codes)
    return codec.mdct.inverse_transform(_sae.decode_frames(params, z))
