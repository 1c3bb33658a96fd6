"""Residual vector quantization over the spectral autoencoder's latent
(counterpart of ``audiocodec_tpu/models/rvq.py``).

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
and sums are each an ``index_add_`` (of ones for the counts: a ``bincount``
reads its input's largest value back on the card). The JAX package's one-hot
matmuls are the TPU's way to gather and are not carried over: the gathered
codeword is the one-hot product's exact value. The state is a dict of
tensors (``codebooks`` [S, K, D] in the compute dtype, ``ema_count`` [S, K]
and ``ema_sum`` [S, K, D] in float32) that no gradient reaches; the train
step updates it in place.

Under a mesh the train step runs each dp row's loss on its devices, the
blocks split sp (``parallel.sequence``), and the EMA statistics are summed
over every shard and every process; the reseed's picks are drawn on rank 0
and broadcast, and the picked vectors gathered from the ranks that hold
them, so every process applies the same update, the single-device one.

On the card, with no mesh, no remat, grad on and the parameters and
codebooks on the batch's device, the train step's loss and backward
replay as one CUDA graph (``parallel.train.LossGraph``, kept in a
``utils.graphs.Cache``), keyed on the batch's shape, dtype and device, the
codebooks' dtype, the quantizer's gate and the parameters, and captured
after the key's first step ran op by op; the optimizer's step and
:func:`ema_update` run op by op after the replay, and nothing in the step
reads the card back.

Codes pack host-side at exactly S * log2(K) bits a frame and channel.

Spans: ``rvq.search`` (the forward's stage searches in :func:`quantize`
and the train step's loss; on the card's graphed step only at the
capture) and ``rvq.ema`` (the whole of :func:`ema_update`, after the
step's ``train.optimizer``). :func:`counts` gives the train steps, stage
searches, graphed steps replayed, graphs captured and card steps run op
by op, counted on the host, and the codewords reseeded, a device sum read
only there.
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
from audiocodec_tpu_torch.parallel import sequence as _seq
from audiocodec_tpu_torch.parallel.train import (LossGraph,
                                                 default_optimizer,
                                                 optimizer_step)
from audiocodec_tpu_torch.utils import dtypes as _dtypes
from audiocodec_tpu_torch.utils import graphs as _cuda_graphs
from audiocodec_tpu_torch.utils import profiling as _profiling

_counts = dict.fromkeys(
    ("steps", "searches", "replayed", "captured", "direct"), 0)
_reseeded = {}  # device -> int64 0-d sum of the codewords reseeded there
# CUDA graphs kept for each train step, least recently used first out
_GRAPH_SLOTS = 4


def counts() -> dict:
    """Since the last reset: the train steps, the stage searches (one
    stage's nearest-codeword search over a batch: 2 * stages a train step,
    the forward's and the EMA's, whether the forward's ran op by op or
    replayed), the train steps replayed from a CUDA graph, the graphs
    captured, the train steps on the card run op by op, and the codewords
    reseeded, read from the devices' sums here (one sync a device), never
    inside a step."""
    return dict(_counts, reseeded=sum(int(t.item())
                                      for t in _reseeded.values()))


def reset_counts() -> None:
    _counts.update(dict.fromkeys(_counts, 0))
    _reseeded.clear()


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
    _counts["searches"] += 1
    tier = "default" if residual.dtype == torch.bfloat16 else "highest"
    scores = _dct.matmul(residual, codebook.T, tier)
    sq = torch.sum(codebook.float() ** 2, dim=-1)
    idx = torch.argmin(sq[None, :] - 2.0 * scores, dim=-1)
    return idx, codebook[idx].to(residual.dtype)


def _quantize(cfg: RVQ, codebooks: torch.Tensor, z: torch.Tensor):
    """:func:`quantize` with the commitment's squared errors (flat - q)^2
    [M, D] in place of their weighted mean."""
    flat = _flatten_latents(z, cfg.dim)
    residual = flat.detach()
    codes = []
    with _profiling.span("rvq.search"):
        for codebook in codebooks:
            idx, q = _nearest(residual, codebook)
            residual = residual - q
            codes.append(idx)
    quant = flat.detach() - residual  # the sum of the stages
    z_q = _unflatten_latents(flat + (quant - flat).detach(), z.shape)
    b, t, _, c = z.shape
    codes = torch.stack(codes, dim=-1).reshape(b, t, c, cfg.stages)
    return z_q, codes.to(torch.int32), (flat - quant) ** 2


def quantize(cfg: RVQ, state: dict, z: torch.Tensor):
    """RVQ the latent with a straight-through estimator.

    :param z: [B, blocks, latent_n, C] autoencoder latents.
    :returns: (z_q, codes, commitment): ``z_q`` has the quantized value and
        the identity gradient; ``codes`` is int32 [B, blocks, C, S];
        ``commitment`` is the scalar beta-weighted commitment loss.
    """
    z_q, codes, sq = _quantize(cfg, state["codebooks"], z)
    return z_q, codes, cfg.commitment_weight * torch.mean(sq)


def _ema_stats(cfg: RVQ, codebooks: torch.Tensor, flat: torch.Tensor):
    """Each stage's assignment counts [S, K] and residual sums [S, K, D]
    (float32) of the float32 latents ``flat`` [M, D]."""
    k = cfg.codebook_size
    residual, counts, sums = flat, [], []
    ones = flat.new_ones(flat.shape[0])
    for codebook in codebooks:
        idx, q = _nearest(residual.to(codebook.dtype), codebook)
        # whole numbers below 2^24: exact in any order of the adds
        counts.append(torch.zeros(k, device=flat.device)
                      .index_add_(0, idx, ones))
        sums.append(torch.zeros(k, cfg.dim, device=flat.device)
                    .index_add_(0, idx, residual))
        residual = residual - q.float()
    return torch.stack(counts), torch.stack(sums)


@_profiling.span("rvq.ema")
def ema_update(cfg: RVQ, state: dict, z, generator=None, mesh=None) -> dict:
    """One EMA k-means step of every stage's codebook from the batch ``z``;
    returns the new state. Dead codewords (EMA count below
    ``reseed_threshold``) reseed from batch vectors picked by
    ``torch.randint`` from ``generator`` (on its device; the default
    generator of the state's device when None).

    :param z: the latents [B, blocks, latent_n, C], or the list of a mesh's
        dp rows, each the list of its sp shards (blocks on axis 1).
    :param mesh: the ``parallel.mesh.Mesh`` of a step over several
        processes: the statistics are summed over its group, rank 0 draws
        the picks, and each pick's vector comes from the rank that holds it.
    """
    rows = [[z]] if isinstance(z, torch.Tensor) else z
    codebooks = state["codebooks"]
    home = codebooks.device
    counts = sums = None
    for shard in (s for row in rows for s in row):
        flat = _flatten_latents(shard, cfg.dim).detach().float()
        c, v = _ema_stats(cfg, codebooks.to(flat.device), flat)
        c, v = c.to(home), v.to(home)
        counts, sums = (c, v) if counts is None else (counts + c, sums + v)
    group = None if mesh is None else mesh.group
    if group is not None:
        mesh.all_sum([counts, sums])
    k, decay = cfg.codebook_size, cfg.ema_decay
    new_count = decay * state["ema_count"] + (1 - decay) * counts
    new_sum = decay * state["ema_sum"] + (1 - decay) * sums
    # Laplace-smoothed means: a near-empty codeword does not blow up
    n_total = torch.sum(new_count, dim=-1, keepdim=True)
    smoothed = (new_count + 1e-5) / (n_total + k * 1e-5) * n_total
    means = new_sum / smoothed[..., None]
    if len(rows) == 1 and len(rows[0]) == 1:
        local = rows[0][0]
    else:  # this process's batch, blocks and rows in order
        local = torch.cat([torch.cat([s.to(home) for s in row], dim=1)
                           for row in rows])
    flat = _flatten_latents(local, cfg.dim).detach().float()
    m = flat.shape[0]
    device = home if generator is None else generator.device
    if group is None:
        pick = torch.randint(0, m, (cfg.stages, k), generator=generator,
                             device=device).to(home)
        fresh = flat[pick]
    else:
        # rank r holds rows [r * m, (r + 1) * m) of the batch's latents
        pick = (torch.randint(0, m * mesh.world, (cfg.stages, k),
                              generator=generator, device=device).to(home)
                if mesh.rank == 0 else
                torch.empty(cfg.stages, k, dtype=torch.int64, device=home))
        mesh.broadcast(pick)
        owned = (pick // m == mesh.rank)[..., None]
        fresh = torch.where(owned, flat[pick % m], 0.0)
        mesh.all_sum([fresh])
    dead = (new_count < cfg.reseed_threshold)[..., None]
    reseeded = torch.where(dead, fresh, means)
    total = _reseeded.get(home)
    if total is None:
        total = _reseeded[home] = torch.zeros((), dtype=torch.int64,
                                              device=home)
    total += dead.sum()
    return {"codebooks": reseeded.to(codebooks.dtype),
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


def _loss(codecs, rvq_cfg, params, rvq_state, x, nmr_weight, nmr_floor,
          gate, zs):
    """:func:`perceptual_loss` of one dp row, its blocks split over the
    devices of ``codecs`` (one codec a shard); each shard's latents are
    appended to ``zs``."""
    def frames(specs, thresholds):
        recons, nmr, commitment = [], [], []
        for spec, threshold in zip(specs, thresholds):
            p = {k: v.to(spec.device) for k, v in params.items()}
            z = _sae.encode_frames(p, spec)
            z_q, _codes, sq = _quantize(
                rvq_cfg, rvq_state["codebooks"].to(spec.device), z)
            g = torch.tensor(gate, dtype=z.dtype)  # on the host
            z_q = z + g * (z_q - z)  # the STE already carries z's gradient
            recon = _sae.decode_frames(p, z_q)
            recons.append(recon)
            zs.append(z)
            thr_f = torch.clamp(threshold, min=nmr_floor)
            nmr.append(((recon - spec) / thr_f) ** 2)
            commitment.append(sq)
        return recons, [nmr, commitment]

    return _seq.codec_loss(codecs, x, frames,
                           [nmr_weight, gate * rvq_cfg.commitment_weight])


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
    zs = []
    loss = _loss([codec], rvq_cfg, params, rvq_state, x, nmr_weight,
                 nmr_floor, quantizer_gate, zs)
    return loss, zs[0]


def make_train_step(codec: Codec, ae_cfg: _sae.SpectralAE, rvq_cfg: RVQ,
                    optimizer=None, remat: bool = False,
                    nmr_weight: float = 0.1, nmr_floor: float = 1e-3,
                    warmup_steps: int = 0, mesh=None):
    """Joint step ``(params, rvq_state, opt, x, generator, step) -> loss``,
    with ``opt = optimizer(list(params.values()))``; returns (train_step,
    optimizer). The autoencoder's parameters take one optimizer step on the
    perceptual loss; then the codebooks take one EMA step on that forward's
    latents (``generator`` draws the reseeds). Parameters, optimizer and
    RVQ state are updated in place (``parallel.train.optimizer_step``,
    then :func:`ema_update`). On the card, with no ``mesh``, no ``remat``,
    grad on and every parameter and the codebooks on ``x``'s device, the
    loss and its backward replay as one CUDA graph
    (``parallel.train.LossGraph``), captured after its key's first step ran
    op by op and kept with the step (the last few keys): the graph owns the
    parameters' ``.grad``, and the returned loss is a copy of its own.

    :param optimizer: a callable from a list of parameters to a
        ``torch.optim.Optimizer``; defaults to Adam at 1e-3.
    :param remat: recompute the forward in the backward
        (``torch.utils.checkpoint``).
    :param warmup_steps: for ``step < warmup_steps`` the decoder trains on
        the continuous latent while the EMA fits the codebooks to it; the
        quantizer then engages on codebooks already on the data.
    :param mesh: a ``parallel.mesh.Mesh``: ``x`` (this process's batch)
        splits dp x sp over it; the EMA step sums its statistics over the
        shards and the mesh's processes (:func:`ema_update`).
    """
    if mesh is None:
        def loss_fn(params, rvq_state, x, gate):
            return perceptual_loss(codec, ae_cfg, rvq_cfg, params, rvq_state,
                                   x, nmr_weight, nmr_floor,
                                   quantizer_gate=gate)
    else:
        rows = _seq.mesh_rows(codec, mesh)

        def loss_fn(params, rvq_state, x, gate):
            zs = [[] for _ in rows]
            loss = _seq.mesh_loss(mesh, rows, x, lambda codecs, xr, r: _loss(
                codecs, rvq_cfg, params, rvq_state, xr, nmr_weight,
                nmr_floor, gate, zs[r]))
            return loss, zs

    if remat:
        plain = loss_fn

        def loss_fn(params, rvq_state, x, gate):
            return _checkpoint.checkpoint(plain, params, rvq_state, x, gate,
                                          use_reentrant=False)

    graphs = _cuda_graphs.Cache()  # key -> (LossGraph, its searches)

    def graph_key(params, x, codebooks, gate):
        """The key of the step's CUDA graph, or None where the step runs op
        by op: off the card or with the graphs off (``utils.graphs``),
        under a mesh, with remat, with grad off, or with a parameter or
        the codebooks on another device than ``x`` (the loss would copy
        them, which a capture refuses). A graph holds its parameters, so
        their ids stay theirs."""
        if (not _cuda_graphs.engaged(x) or mesh is not None or remat
                or not torch.is_grad_enabled()
                or codebooks.device != x.device
                or any(p.device != x.device for p in params.values())):
            return None
        return (tuple(x.shape), x.dtype, x.device, codebooks.dtype, gate,
                *map(id, params.values()))

    def capture(params, x, codebooks, gate):
        """The graph of the loss over (x, codebooks), and the stage
        searches its forward makes, which the capture itself runs none
        of."""
        searches = _counts["searches"]
        graph = LossGraph.capture(
            params.values(), lambda x, codebooks: loss_fn(
                params, {"codebooks": codebooks}, x, gate), (x, codebooks))
        made, _counts["searches"] = _counts["searches"] - searches, searches
        return graph, made

    def train_step(params: dict, rvq_state: dict, optimizer, x,
                   generator=None, step: int = 0):
        gate = 1.0 if step >= warmup_steps else 0.0
        codebooks = rvq_state["codebooks"]
        key = graph_key(params, x, codebooks, gate)
        held = graphs.get(key)
        if held is not None:
            graph, searches = held
            loss, z = graph.step(optimizer, (x, codebooks))
            _counts["replayed"] += 1
            _counts["searches"] += searches
        else:
            loss, z = optimizer_step(
                params.values(), optimizer,
                lambda: loss_fn(params, rvq_state, x, gate), mesh)
            _counts["direct"] += int(x.device.type == _cuda_graphs.DEVICE)
            if key is not None:
                z = z.detach()  # the capture wants no autograd graph alive
                graphs.put(key, capture(params, x, codebooks, gate),
                           _GRAPH_SLOTS)
                _counts["captured"] += 1
        rvq_state.update(ema_update(rvq_cfg, rvq_state, z, generator, mesh))
        _counts["steps"] += 1
        return loss

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
