"""Plain reference of the constant-bitrate ``.acs`` stream with forward
error correction, and a reader of its files, in PyTorch and NumPy.

Written from docs/FORMATS.md (``cbr``, ``fec``, ``dzr``, ``scq`` and the
``.acs`` layout). It imports nothing of the program; :class:`codec.Reference`
supplies the filter bank, the psychoacoustic model, the sidecar grid and
the threshold, and :mod:`containers` the Rice and level decoders.

A chunk of such a stream is, in file order: its own float64 threshold
scale, u32 blocks, u32 codes length, the rrice codes, u32 sidecar length,
the sidecar's grid levels, u32 member length, the FEC member, and a CRC
chained over every field before it. The FEC member of chunk k + 1 is a
coarse copy of chunk k: ``u32 blocks | f64 absolute scale | u32 k2 | u32
tpool | u32 clen | codes | levels``, the levels on their own grid (k2 = 1,
3 dB steps), one row a ``tpool`` = 4 frames; chunk 0's member is empty and
the flush chunk carries the last body chunk's copy.

The encode of a chunk at its wire scale s (the compute dtype's float32
rounding of the float64 on the wire, as a decoder casts it):

1. the Bark masking intensity of each frame and channel, snapped to the
   sidecar grid;
2. step = threshold(levels) * s / sqrt(3);
3. the dead-zone quantizer, code = sign(x) max(floor(|x|/step -
   (deadzone - 1)), 0), dequantized as (code + sign(code) rho) step with
   rho the header's ``dzr``.

The coarse copy of a chunk at the member's scale s4 = s * 4: the masking
intensity pooled by max over each group of 4 frames (the last group padded
with its last frame), snapped on the k2 = 1 grid, repeated back to the
frames, and the same dead-zone quantizer at s4, with no feature ladder.

The dead zone is the command line's ``--deadzone auto``: from the target
rate per 44.1 kHz channel, 1.0 below 48 kbps, 0.9 below 80, 0.7 below 120,
0.5 (plain rounding) above; its reconstruction point is 0.45 of the bin
above a zone of 0.75, 0.5 below.
"""

from __future__ import annotations

import json
import math
import struct
import zlib

import numpy as np
import torch

from portbench.reference import containers
from portbench.reference.codec import Reference

FEC_K2 = 1
FEC_TPOOL = 4
SCALE_MAX = 2.0 ** 32


def resolve_deadzone(config: dict) -> float:
    z = config["deadzone"]
    if z != "auto":
        return float(z)
    kb = (float(config["target_kbps"]) / int(config["channels"])
          / (int(config["sample_rate"]) / 44100.0))
    for edge, zone in ((120.0, 0.5), (80.0, 0.7), (48.0, 0.9)):
        if kb >= edge:
            return zone
    return 1.0


def recon_offset(zone: float) -> float:
    return zone + (0.5 if zone <= 0.75 else 0.45) - 1.0


def header(config: dict) -> dict:
    """The ``.acs`` header a stream of the configuration declares, but
    ``nsamp``."""
    zone = resolve_deadzone(config)
    out = dict(
        sample_rate=int(config["sample_rate"]),
        filters_n=int(config["filters_n"]),
        bark_bands_n=int(config["bark_bands_n"]),
        alpha=float(config["alpha"]), window_type=config["window_type"],
        channels=int(config["channels"]), compute_dtype="float32",
        ms=False, threshold_scale=1.0,
        bark_precision=config["dct_precision"], coder="rrice", hcrc=1,
        scq=int(config["sidecar_grid"]), fec={"scale": float(config["fec"])},
        cbr=1)
    if zone != 0.5:
        out["dzr"] = recon_offset(zone)
    return out


def wire_bits(path) -> list:
    """Every chunk's bytes on the wire (framing included) times 8, from
    the trailer and the index alone."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        end = f.tell()
        if end < 16:
            raise ValueError("no trailer")
        f.seek(end - 16)
        count, index_off = struct.unpack("<QQ", f.read(16))
        if index_off + 8 * count + 16 != end:
            raise ValueError("index/trailer do not close the file")
        f.seek(index_off)
        offsets = list(struct.unpack(f"<{count}Q", f.read(8 * count)))
    edges = offsets + [index_off]
    sizes = [b - a for a, b in zip(edges, edges[1:])]
    if any(s <= 0 for s in sizes):
        raise ValueError("index not increasing")
    return [8 * s for s in sizes]


class Member:
    """A parsed FEC member: ``blocks``, ``scale``, ``k2``, ``tpool``,
    ``codes`` [blocks, N, C] and ``levels`` [groups, bands, C]."""

    def __init__(self, data: bytes, meta: dict):
        if len(data) < 24:
            raise ValueError("FEC member too short")
        self.blocks, self.scale, self.k2, self.tpool, clen = \
            struct.unpack_from("<IdIII", data, 0)
        if not (math.isfinite(self.scale) and 0 < self.scale < SCALE_MAX):
            raise ValueError(f"FEC scale {self.scale!r}")
        if self.k2 != FEC_K2 or self.tpool != FEC_TPOOL:
            raise ValueError(f"FEC grid {self.k2}, pool {self.tpool}")
        if clen > len(data) - 24:
            raise ValueError("FEC codes length")
        n, ch = meta["filters_n"], meta["channels"]
        groups = -(-self.blocks // self.tpool)
        self.codes = containers.rice_decode(
            data[24:24 + clen], self.blocks * n * ch, True).reshape(
                self.blocks, n, ch)
        self.levels = containers.int2d(
            data[24 + clen:], (groups, meta["bark_bands_n"], ch), 0)


class CbrStream:
    """A ``.acs`` stream of a CBR + FEC configuration: the header must
    declare the configuration, every chunk's CRC, the index and the
    trailer are checked on open, and every scale must lie in (0, 2^32)."""

    def __init__(self, path, config: dict):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"ACS2":
            raise ValueError(f"magic {data[:4]!r}")
        (hlen,) = struct.unpack_from("<I", data, 4)
        self.meta = meta = json.loads(data[8:8 + hlen])
        want = header(config)
        for key, value in want.items():
            if meta.get(key) != value:
                raise ValueError(f"header {key}={meta.get(key)!r}")
        extra = set(meta) - set(want) - {"nsamp"}
        if extra:
            raise ValueError(f"header declares {sorted(extra)}")
        count, index_off = struct.unpack_from("<QQ", data, len(data) - 16)
        if index_off + 8 * count + 16 != len(data):
            raise ValueError("index/trailer do not close the file")
        offsets = struct.unpack_from(f"<{count}Q", data, index_off)
        self.chunks = []  # (scale, blocks, codes, bark, member)
        pos = 8 + hlen
        for off in offsets:
            if off != pos:
                raise ValueError(f"index offset {off} != chunk at {pos}")
            scale, blocks = struct.unpack_from("<dI", data, off)
            if not (math.isfinite(scale) and 0 < scale < SCALE_MAX):
                raise ValueError(f"chunk at {off}: scale {scale!r}")
            crc = zlib.crc32(data[off:off + 12])
            pos, parts = off + 12, []
            # codes, sidecar, FEC member: each a u32 length and its bytes;
            # the CRC chains every field in file order
            for _ in range(3):
                (length,) = struct.unpack_from("<I", data, pos)
                body = data[pos + 4:pos + 4 + length]
                if len(body) != length:
                    raise ValueError(f"chunk at {off}: truncated")
                crc = zlib.crc32(body, zlib.crc32(data[pos:pos + 4], crc))
                parts.append(body)
                pos += 4 + length
            (got,) = struct.unpack_from("<I", data, pos)
            if got != crc:
                raise ValueError(f"chunk at {off}: CRC")
            pos += 4
            self.chunks.append((scale, blocks, *parts))
        if pos != index_off:
            raise ValueError("bytes between the last chunk and the index")

    def blocks(self) -> list:
        return [c[1] for c in self.chunks]

    def scales(self) -> list:
        return [c[0] for c in self.chunks]

    def chunk(self, i: int):
        """(codes [blocks, N, C] int32, levels [blocks, bands, C], the
        chunk's float64 scale)."""
        scale, blocks, codes, bark, _ = self.chunks[i]
        n, ch = self.meta["filters_n"], self.meta["channels"]
        bands = self.meta["bark_bands_n"]
        c = containers.rice_decode(codes, blocks * n * ch, True).reshape(
            blocks, n, ch)
        return c, containers.int2d(bark, (blocks, bands, ch), 0), scale

    def member(self, i: int):
        """Chunk i's FEC member (a copy of chunk i - 1), or None if it is
        empty."""
        data = self.chunks[i][4]
        return Member(data, self.meta) if data else None

    def check_chain(self, fec_scale: float) -> None:
        """The FEC chain as the format fixes it: chunk 0's member empty,
        every later member a copy of its predecessor's frames at its
        predecessor's scale times ``fec_scale`` (in float64, exactly)."""
        if self.chunks and self.chunks[0][4]:
            raise ValueError("chunk 0 carries a FEC member")
        for i in range(1, len(self.chunks)):
            m = self.member(i)
            prev_scale, prev_blocks = self.chunks[i - 1][:2]
            if m is None:
                raise ValueError(f"chunk {i}: no FEC member")
            if m.blocks != prev_blocks:
                raise ValueError(f"chunk {i}: FEC member of {m.blocks} "
                                 f"frames, its predecessor {prev_blocks}")
            if m.scale != prev_scale * fec_scale:
                raise ValueError(f"chunk {i}: FEC scale {m.scale!r}, its "
                                 f"predecessor's {prev_scale!r}")


class Cbr:
    """The configuration's chunk encode and coarse copy (a ``configs/*.json``
    dict) on ``device`` at ``dtype``; ``tf32`` lets float32 products run
    in TF32."""

    def __init__(self, config: dict, device, dtype=torch.float64,
                 tf32: bool = False):
        self.base = Reference(config, device, dtype, tf32)
        self.coarse_base = Reference(dict(config, sidecar_grid=FEC_K2),
                                     device, dtype, tf32)
        self.zone = resolve_deadzone(config)
        self.rho = recon_offset(self.zone) if self.zone != 0.5 else 0.0

    @staticmethod
    def wire(scale: float) -> float:
        """The scale a decoder applies: the wire's float64 in float32."""
        return float(np.float32(scale))

    def _quantize(self, spec, delta):
        u = spec.abs() / delta
        mag = torch.clamp_min(torch.floor(u - (self.zone - 1.0)), 0.0)
        return torch.sign(spec) * mag

    def _dequantize(self, codes, delta):
        return (codes + torch.sign(codes) * self.rho) * delta

    def _delta(self, ref, levels, scale):
        lv = torch.as_tensor(np.asarray(levels), dtype=torch.int64,
                             device=ref.device)
        if lv.min() < ref.lo or lv.max() > ref.table.numel() - 1 + ref.lo:
            raise ValueError("sidecar level outside the grid")
        return ref.step(ref.threshold(ref.table[lv - ref.lo][None])[0]
                        * self.wire(scale))

    def encode(self, x, first: int, count: int, scale: float):
        """Frames ``first .. first + count - 1`` of x [1, S, C] at the wire
        scale -> (codes, sidecar levels, dequantized frames) [count, ...]."""
        b = self.base
        frames = b.frames(x, first, count)[0]
        lv = b.levels(b.bark_intensity(frames[None]))[0]
        delta = self._delta(b, lv.cpu(), scale)
        codes = self._quantize(frames, delta)
        return codes.long(), lv, self._dequantize(codes, delta)

    def coarse(self, x, first: int, count: int, scale: float):
        """The FEC copy of those frames at the member's absolute scale ->
        (codes, pooled levels [groups, bands, C], dequantized frames)."""
        b, c = self.base, self.coarse_base
        frames = b.frames(x, first, count)[0]
        bark = b.bark_intensity(frames[None])[0]  # [count, bands, C]
        groups = -(-count // FEC_TPOOL)
        pad = groups * FEC_TPOOL - count
        bark = torch.cat([bark, bark[-1:].expand(pad, -1, -1)], 0)
        pooled = bark.reshape(groups, FEC_TPOOL, *bark.shape[1:]).amax(1)
        lv = c.levels(pooled)
        delta = self._delta(c, self.expand(lv.cpu(), count), scale)
        codes = self._quantize(frames, delta)
        return codes.long(), lv, self._dequantize(codes, delta)

    @staticmethod
    def expand(levels, count: int):
        """Pooled levels [groups, ...] -> one row a frame [count, ...]."""
        return np.repeat(np.asarray(levels), FEC_TPOOL, axis=0)[:count]

    def dequantize(self, codes, levels, scale: float) -> torch.Tensor:
        """A chunk's codes, sidecar levels and wire scale -> its frames, as
        a decoder derives them."""
        codes = torch.as_tensor(np.asarray(codes), device=self.base.device)
        return self._dequantize(codes.to(self.base.dtype),
                                self._delta(self.base, levels, scale))

    def dequantize_coarse(self, codes, levels, scale: float):
        """A coarse copy's codes [blocks, N, C], pooled levels and absolute
        scale -> the frames a decoder rebuilds from it."""
        codes = torch.as_tensor(np.asarray(codes), device=self.base.device)
        return self._dequantize(
            codes.to(self.base.dtype),
            self._delta(self.coarse_base,
                        self.expand(levels, codes.shape[0]), scale))

    def dequantize_member(self, m: Member) -> torch.Tensor:
        return self.dequantize_coarse(m.codes, m.levels, m.scale)
