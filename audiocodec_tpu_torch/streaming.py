"""Chunked streaming MDCT encode/decode with one-block carried state, in
PyTorch (counterpart of ``audiocodec_tpu/streaming.py``).

The polyphase fold couples only adjacent blocks, so a streaming encoder
needs one block of carried state per boundary. This module provides:

* a step/flush API (``mdct_stream_step`` / ``imdct_stream_step``) for a
  host loop over chunks, as a real-time stream runs it; and
* whole-signal drivers (``stream_transform``, ``stream_inverse_transform``,
  ``streaming_round_trip``) for long-form offline work (BASELINE config 5:
  one hour of stereo) at bounded memory: host loops over the steps.

Each step runs the MDCT's own ``transform`` / ``inverse_transform`` on the
chunk with its carry in front, and keeps the frames (or blocks) that the
batch transform would give at that offset:

* analysis: ``transform([carry; chunk])`` of K+1 blocks gives K+2 frames;
  frames 1..K are ``fold(block j-1, block j)``, the batch frames;
* synthesis: ``inverse_transform([carry frame; frames])`` gives K+2 blocks;
  blocks 1..K are the batch blocks. The carry is the previous raw frame;
* flush: frame 1 of ``transform([carry])``, block 1 of
  ``inverse_transform([carry frame])``.

So a step runs the same code as the batch transform, the card's kernels
where the MDCT has them, on the same operands, and the stream equals the
batch transform by construction, for two extra frames in K+2. Carries are
opaque (the synthesis carry is the raw frame here, on every tier), so they
are not exchanged with the JAX package's. The stream is resumable: (carry,
block offset) is the whole codec state at a chunk boundary.
"""

from __future__ import annotations

import torch

from audiocodec_tpu_torch import quantize as _quantize
from audiocodec_tpu_torch.mdct import MDCT
from audiocodec_tpu_torch.utils import dtypes as _dtypes


def _carry(mdct: MDCT, batches_n: int, channels_n: int) -> torch.Tensor:
    return torch.zeros(batches_n, channels_n, mdct.filters_n,
                       dtype=mdct.compute_dtype, device=mdct.wa_r.device)


# -- streaming analysis ------------------------------------------------------


def mdct_stream_init(mdct: MDCT, batches_n: int, channels_n: int):
    """Zero carry: one time-domain block [B, C, N], on the MDCT's device."""
    return _carry(mdct, batches_n, channels_n)


def mdct_stream_step(mdct: MDCT, carry, chunk):
    """Encode one chunk.

    :param carry: [B, C, N], the last block of the previous chunk.
    :param chunk: [B, K*N, C] waveform samples, K >= 1.
    :return: (new_carry, frames [B, K, N, C]), the K frames the batch
        transform gives at this offset.
    """
    _dtypes.check_input_dtype(chunk, mdct.compute_dtype, "stream chunk")
    n = mdct.filters_n
    samples = chunk.shape[1]
    if samples % n != 0 or samples == 0:
        raise ValueError(f"chunk samples {samples} not a multiple of N={n}")
    k = samples // n
    frames = mdct.transform(torch.cat([carry.transpose(1, 2), chunk], dim=1))
    return chunk[:, -n:].transpose(1, 2), frames[:, 1:k + 1]


def mdct_stream_flush(mdct: MDCT, carry):
    """Final frame after the last chunk, the carried block's tail-out:
    [B, 1, N, C], the batch transform's last (+1) frame."""
    return mdct.transform(carry.transpose(1, 2))[:, 1:]


# -- streaming synthesis -----------------------------------------------------


def imdct_stream_init(mdct: MDCT, batches_n: int, channels_n: int):
    """Zero carry: one spectral frame [B, C, N], on the MDCT's device."""
    return _carry(mdct, batches_n, channels_n)


def imdct_stream_step(mdct: MDCT, carry, frames):
    """Decode one chunk of spectral frames.

    :param carry: [B, C, N], the previous chunk's last frame.
    :param frames: [B, K, N, C] MDCT amplitudes.
    :return: (new_carry, samples [B, K*N, C]).
    """
    _dtypes.check_input_dtype(frames, mdct.compute_dtype, "stream frames")
    n = mdct.filters_n
    k = frames.shape[1]
    out = mdct.inverse_transform(
        torch.cat([carry.transpose(1, 2)[:, None], frames], dim=1))
    return frames[:, -1].transpose(1, 2), out[:, n:(k + 1) * n]


def imdct_stream_flush(mdct: MDCT, carry):
    """Final N output samples after the last chunk, the carry's tail-out:
    [B, N, C]."""
    n = mdct.filters_n
    return mdct.inverse_transform(carry.transpose(1, 2)[:, None])[:, n:]


# -- whole-signal drivers ----------------------------------------------------


def _check_chunks(samples: int, chunk: int) -> int:
    if samples % chunk != 0:
        raise ValueError(
            f"samples {samples} must be a multiple of chunk_blocks*N={chunk}"
        )
    return samples // chunk


def stream_transform(mdct: MDCT, x, chunk_blocks: int):
    """The batch transform, chunk by chunk.

    :param x: [B, S, C] with S a multiple of chunk_blocks * N.
    :return: [B, blocks+1, N, C], equal to ``mdct.transform(x)``.
    """
    chunk = chunk_blocks * mdct.filters_n
    b, s, c = x.shape
    carry = mdct_stream_init(mdct, b, c)
    frames = []
    for i in range(_check_chunks(s, chunk)):
        carry, f = mdct_stream_step(mdct, carry, x[:, i * chunk:(i + 1) * chunk])
        frames.append(f)
    frames.append(mdct_stream_flush(mdct, carry))
    return torch.cat(frames, dim=1)


def stream_inverse_transform(mdct: MDCT, y, chunk_blocks: int):
    """The batch inverse transform, chunk by chunk.

    :param y: [B, blocks, N, C] with blocks a multiple of chunk_blocks.
    :return: [B, (blocks+1)*N, C], equal to ``mdct.inverse_transform(y)``.
    """
    b, blocks, _, c = y.shape
    if blocks % chunk_blocks != 0:
        raise ValueError(
            f"blocks {blocks} must be a multiple of chunk_blocks="
            f"{chunk_blocks}"
        )
    carry = imdct_stream_init(mdct, b, c)
    out = []
    for i in range(0, blocks, chunk_blocks):
        carry, samples = imdct_stream_step(mdct, carry,
                                           y[:, i:i + chunk_blocks])
        out.append(samples)
    out.append(imdct_stream_flush(mdct, carry))
    return torch.cat(out, dim=1)


def streaming_round_trip(codec, x, chunk_blocks: int,
                         generator: torch.Generator | None = None,
                         drown=0.0):
    """Long-form chunked encode/decode: per-chunk masking and quantization
    (or, given a ``generator``, noise injection) with carried fold state.

    The noise of every chunk, then of the flush frame, is drawn from the
    one ``generator`` in that order (``psycho.add_noise``; the JAX package
    splits a key per chunk). Peak live state is one chunk and two carries,
    whatever the signal's length. [B, S, C] -> [B, S + 2N, C].
    """
    mdct = codec.mdct
    chunk = chunk_blocks * mdct.filters_n
    b, s, c = x.shape
    n_chunks = _check_chunks(s, chunk)

    def lossy(frames):
        tonality = codec.psycho.tonality(frames)
        threshold = codec.psycho.global_masking_threshold(
            frames, tonality, drown
        )
        if generator is not None:
            return codec.psycho.add_noise(generator, frames, threshold)
        codes, delta = _quantize.quantize(frames, threshold)
        return _quantize.dequantize(codes, delta, dtype=mdct.compute_dtype)

    enc = mdct_stream_init(mdct, b, c)
    dec = imdct_stream_init(mdct, b, c)
    out = []
    for i in range(n_chunks):
        enc, frames = mdct_stream_step(mdct, enc,
                                       x[:, i * chunk:(i + 1) * chunk])
        dec, samples = imdct_stream_step(mdct, dec, lossy(frames))
        out.append(samples)
    # flush: the encoder's last frame through the lossy stage and the
    # decoder, then the decoder's own tail
    dec, samples = imdct_stream_step(mdct, dec,
                                     lossy(mdct_stream_flush(mdct, enc)))
    out += [samples, imdct_stream_flush(mdct, dec)]
    return torch.cat(out, dim=1)
