"""Sequence parallelism: one batch's blocks split over a row of devices.

The JAX package shards the samples axis over the mesh's ``sp`` axis and
lets GSPMD insert the halo of the MDCT's fold. Here it is written out:

* the samples split at block boundaries into ``sp`` contiguous shards, as
  even as possible (the first ``blocks % sp`` one block longer), and each
  shard but the first also takes the previous shard's last block, the
  halo the fold's coupling of adjacent blocks needs;
* each shard's analysis gives one frame a block plus one: the halo's own
  frame (every shard but the first) and the trailing zero-padded frame
  (every shard but the last) are dropped, so the shards' frames are the
  unsharded ``transform``'s S/N + 1, in order;
* each shard's synthesis gives one block more than it has frames: that
  last block overlaps the next shard's first and is added to it there.

Psychoacoustics, quantization and the models' per-frame layers are
frame-local, so they run on each shard unchanged; the post-filter's
+-1-frame context takes a one-frame halo (:func:`frame_context`). Each
shard runs the MDCT kernels on its own device, once a direction; the
copies between devices are differentiable, so autograd carries a
gradient back across every halo.
"""

from __future__ import annotations

import copy

import torch


def block_bounds(blocks_n: int, sp: int) -> list:
    """[(start, stop)] block ranges of ``sp`` contiguous shards of
    ``blocks_n`` blocks, the first ``blocks_n % sp`` one block longer."""
    if blocks_n < sp:
        raise ValueError(f"{blocks_n} blocks do not split over sp={sp}")
    base, extra = divmod(blocks_n, sp)
    bounds, start = [], 0
    for k in range(sp):
        stop = start + base + (k < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


def replicas(codec, devices) -> list:
    """One codec a device of ``devices``: ``codec`` itself on its own
    device, one copy of its buffers on each other device (a device that
    repeats shares its copy)."""
    home = codec.mdct.wa_r.device
    made = {home: codec}
    for dev in devices:
        if dev not in made:
            made[dev] = copy.deepcopy(codec).to(dev)
    return [made[dev] for dev in devices]


def split(x: torch.Tensor, devices, n: int) -> list:
    """A waveform [B, S, C] -> one piece a device: the shard's blocks, led
    by the previous shard's last block on every shard but the first."""
    if x.shape[1] % n:
        raise ValueError(
            f"samples_n={x.shape[1]} must be a nonzero multiple of "
            f"filters_n={n}")
    bounds = block_bounds(x.shape[1] // n, len(devices))
    return [x[:, max(a - 1, 0) * n:b * n].to(dev)
            for (a, b), dev in zip(bounds, devices)]


def map_frames(codecs, x: torch.Tensor, fn) -> list:
    """``fn(codec, piece)`` on each shard of ``x`` [B, S, C], with its
    codec; ``fn`` returns a tuple of frame tensors (frames on axis 1, one
    more than the piece has blocks). The halo's frame and the trailing
    frame are dropped from every shard that has a neighbour there, so the
    shards' frames, concatenated on axis 1, are those of ``fn`` on the
    whole ``x`` where ``fn`` is frame-local."""
    return _frames(codecs, _pieces(codecs, x), fn)


def _pieces(codecs, x):
    return split(x, [c.mdct.wa_r.device for c in codecs],
                 codecs[0].mdct.filters_n)


def _frames(codecs, pieces, fn):
    last = len(pieces) - 1
    return [tuple(t[:, int(k > 0):(None if k == last else -1)]
                  for t in fn(codec, piece))
            for k, (codec, piece) in enumerate(zip(codecs, pieces))]


def transform(codecs, x: torch.Tensor) -> list:
    """The shards of ``mdct.transform(x)``: [B, frames_k, N, C] each, on
    its codec's device."""
    return [f for (f,) in map_frames(
        codecs, x, lambda codec, piece: (codec.mdct.transform(piece),))]


def inverse_transform(codecs, frames) -> list:
    """The shards of ``mdct.inverse_transform`` of the frames ``frames``
    (one tensor a shard, in order): each shard's synthesis, its last block
    added to the next shard's first. Shard k keeps the samples of its own
    blocks, the last shard one block more: concatenated on axis 1 they are
    the unsharded [B, (T + 1) * N, C]."""
    n = codecs[0].mdct.filters_n
    out, tail = [], None
    for k, (codec, f) in enumerate(zip(codecs, frames)):
        y = codec.mdct.inverse_transform(f)
        if tail is not None:
            y = torch.cat([y[:, :n] + tail.to(y.device), y[:, n:]], dim=1)
        if k < len(frames) - 1:
            y, tail = y[:, :-n], y[:, -n:]
        out.append(y)
    return out


def frame_context(frames) -> list:
    """(previous, next) frames of each frame of each shard [B, F, ...]: the
    neighbouring shards' edge frames across a boundary, the first and last
    frame of the whole sequence repeated at its ends."""
    last = len(frames) - 1
    out = []
    for k, f in enumerate(frames):
        left = frames[k - 1][:, -1:].to(f.device) if k else f[:, :1]
        right = frames[k + 1][:, :1].to(f.device) if k < last else f[:, -1:]
        out.append((torch.cat([left, f[:, :-1]], dim=1),
                    torch.cat([f[:, 1:], right], dim=1)))
    return out


def _sum(t: torch.Tensor) -> torch.Tensor:
    """A float32 (float64 for float64) sum of ``t``: a bfloat16 loss term
    is accumulated once, not rounded a shard at a time."""
    return torch.sum(t, dtype=torch.promote_types(t.dtype, torch.float32))


def codec_loss(codecs, x: torch.Tensor, frames_fn, weights=()):
    """The loss of the codec chain on one dp row's batch ``x`` [b, S, C],
    its blocks split over the codecs' devices (one codec a shard)::

        mean((synthesis(recon)[:, N:-N] - x)^2)
            + sum_i weights[i] * mean(term_i)

    ``frames_fn(specs, thresholds) -> (recons, terms)`` maps each shard's
    spectrum and masking threshold to its reconstructed spectrum, and
    gives, for each weight, one tensor a shard whose mean over all shards
    is that term. Sums are taken a shard at a time on its device and added
    on the first; the loss has ``x``'s dtype.
    """
    n = codecs[0].mdct.filters_n
    home = codecs[0].mdct.wa_r.device
    pieces = _pieces(codecs, x)
    analyzed = _frames(codecs, pieces, lambda codec, p: codec._analyze(p))
    recons, terms = frames_fn([a[0] for a in analyzed],
                              [a[1] for a in analyzed])
    decoded = inverse_transform(codecs, recons)
    last = len(decoded) - 1
    wave = 0.0
    for k, (y, piece) in enumerate(zip(decoded, pieces)):
        # shard k holds output blocks [a_k, b_k) (the last one more), which
        # face input blocks [a_k - 1, b_k - 1): its piece from the halo on
        y = y[:, (n if k == 0 else 0):(-n if k == last else None)]
        wave = wave + _sum((y - piece[:, :y.shape[1]]) ** 2).to(home)
    loss = wave / x.numel()
    for w, term in zip(weights, terms):
        total = sum(_sum(t).to(home) for t in term)
        loss = loss + w * (total / sum(t.numel() for t in term))
    return loss.to(x.dtype)


def mesh_loss(mesh, rows, x: torch.Tensor, row_loss):
    """The mean over the mesh's dp rows of ``row_loss(codecs, x_r, r)``,
    row r's loss on its shard ``x_r`` of the batch with ``rows[r]``, the
    codecs of its devices; on the mesh's first device. Each row adds its
    share of the batch's mean, so the sum equals the loss of the whole
    batch on one device."""
    shards = mesh.split(x)
    home = mesh.dp_devices[0]
    total = sum(row_loss(codecs, xr, r).to(home)
                for r, (codecs, xr) in enumerate(zip(rows, shards)))
    return total / len(shards)


def mesh_rows(codec, mesh) -> list:
    """The codecs of each dp row's devices (:func:`replicas`)."""
    made = replicas(codec, [d for row in mesh.devices for d in row])
    sp = mesh.shape["sp"]
    return [made[r * sp:(r + 1) * sp] for r in range(mesh.shape["dp"])]
