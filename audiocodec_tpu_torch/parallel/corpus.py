"""Corpus-scale batched encode over a mesh of this process's devices
(counterpart of ``audiocodec_tpu/parallel/corpus.py``).

BASELINE.md's configuration 4: a corpus of equal-length clips encoded a
batch at a time, each batch split data-parallel over the mesh's dp rows and
each row's shard sequence-parallel over the row's devices
(``parallel.sequence``), with one codec replica a device. Each shard's
encode runs the MDCT kernels on its own device; the results come back to
the mesh's first device.
"""

from __future__ import annotations

import torch

from audiocodec_tpu_torch.codec import Codec
from audiocodec_tpu_torch.parallel import mesh as _mesh
from audiocodec_tpu_torch.parallel import sequence as _seq
from audiocodec_tpu_torch.utils.device import on_device


def replicas(codec: Codec, mesh: _mesh.Mesh) -> list:
    """One codec a dp row, on the row's first device: ``codec`` itself on
    its own device, a copy of its buffers on every other."""
    return [row[0] for row in _seq.mesh_rows(codec, mesh)]


def make_corpus_encoder(codec: Codec, mesh: _mesh.Mesh,
                        quantized: bool = True, per_shard=None):
    """Build the encoder of a batch split over the mesh's dp rows, each
    row's shard split over its sp devices.

    :param quantized: True -> ``run(batch)`` = (codes, step sizes) of
        ``Codec.encode_quantized``; False -> ``run(batch, generator)`` =
        (noisy spectrum,) of ``Codec.encode``, ``generator`` a
        ``torch.Generator`` on the mesh's device or one a dp row (under
        ``sp`` the row's noise is drawn at once on its first device, so a
        row's output does not depend on ``sp``).
    :param per_shard: ``fn(replica, shard)``, run on each dp row's first
        device with that device current in place of those encodes (no
        sequence split); ``run(batch)`` then returns the list of its
        results in row order, not gathered (the ``corpus`` command's encode
        of the int16 wire).
    :return: ``run``: ``batch`` is [B, S, C] in the codec's compute dtype,
        B divisible by dp (any device: each shard is copied to its row's),
        or the list of its shards already placed (``Mesh.split``); the
        outputs are gathered on the mesh's first device, codes equal to the
        unsharded encode's.
    """
    rows = _seq.mesh_rows(codec, mesh)
    devices = mesh.dp_devices

    @torch.no_grad()
    def each(fn, batch, *per_row):
        """``fn(row's codecs, shard, *row's extras)`` on every dp row."""
        shards = (list(batch) if isinstance(batch, (list, tuple))
                  else mesh.split(batch))
        outs = []
        for codecs, dev, x, *extra in zip(rows, devices, shards, *per_row):
            with on_device(dev):
                outs.append(fn(codecs, x, *extra))
        return outs

    def frames(codecs, x, fn):
        """``fn(codec, piece)``'s frame tensors of each shard, gathered on
        the row's first device."""
        shards = _seq.map_frames(codecs, x, fn)
        if len(shards) == 1:
            return list(shards[0])
        return [torch.cat([s[i].to(x.device) for s in shards], dim=1)
                for i in range(len(shards[0]))]

    if per_shard is not None:
        return lambda batch: each(
            lambda codecs, x: per_shard(codecs[0], x), batch)

    def run(batch):
        outs = each(lambda codecs, x: frames(
            codecs, x, lambda c, p: c.encode_quantized(p)[:2]), batch)
        return (mesh.gather([o[0] for o in outs]),
                mesh.gather([o[1] for o in outs]))

    def run_noise(batch, generator):
        gens = (list(generator) if isinstance(generator, (list, tuple))
                else [generator] * len(devices))

        def noisy(codecs, x, gen):
            spec, threshold = frames(codecs, x, lambda c, p: c._analyze(p))
            return codecs[0].psycho.add_noise(gen, spec, threshold)

        return mesh.gather(each(noisy, batch, gens))

    return run if quantized else run_noise


def encode_corpus(codec: Codec, clips, mesh: _mesh.Mesh | None = None,
                  batch_size: int = 64, generator=None,
                  quantized: bool = True):
    """Encode an array of equal-length clips in batches split over the
    mesh (default: every visible CUDA device).

    :param clips: [n_clips, samples, channels] in the codec's compute
        dtype, a tensor on any device or a numpy array.
    :param generator: the noise mode's ``torch.Generator`` (or one a dp
        row), drawn batch after batch; JAX splits a key instead.
    :return: list of per-batch outputs, (codes, step sizes) or (noisy
        spectrum,), on the mesh's first device; the rows that pad a short
        batch to a multiple of dp are stripped.
    """
    if mesh is None:
        mesh = _mesh.make_mesh()
    encoder = make_corpus_encoder(codec, mesh, quantized=quantized)
    dp = mesh.shape["dp"]
    if batch_size % dp != 0:
        batch_size = _mesh.pad_batch_to(batch_size, dp)
    clips = torch.as_tensor(clips)
    outputs = []
    for start in range(0, clips.shape[0], batch_size):
        batch = clips[start:start + batch_size]
        real = batch.shape[0]
        if real % dp != 0:
            pad = _mesh.pad_batch_to(real, dp) - real
            batch = torch.cat([batch, batch.new_zeros(
                (pad,) + tuple(batch.shape[1:]))])
        out = encoder(batch) if quantized else (encoder(batch, generator),)
        # strip the dp-padding rows so callers never see phantom clips
        outputs.append(tuple(o[:real] for o in out))
    return outputs
