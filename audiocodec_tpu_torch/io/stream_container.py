"""Seekable chunked stream container (.acs) for long-form encoded audio, in
PyTorch (counterpart of ``audiocodec_tpu/io/stream_container.py``): byte for
byte the JAX package's format, so that either package reads what the other
writes.

The ``.acz`` container holds one array of codes, which suits clips; an hour
of audio needs chunks that decode on their own. This container stores
independently readable CHUNKS of spectral frames with a byte index, so a
decoder streams with bounded memory or seeks to any chunk. Overlap-add needs
one spectral frame of context, so decoding from chunk k reads chunk k-1's
last frame and nothing else.

Layout (little-endian):

  magic b"ACS1"/b"ACS2"/b"ACS3" | u32 header_len | header JSON (meta incl.
  chunk settings; "ACS2" iff the header carries "scq", grid-quantized
  sidecars; "ACS3" iff it carries "dtx")
  per chunk: [u8 marker, DTX streams: 0 coded, 1 silent record]
             | [f64 scale, CBR streams]
             | u32 blocks | u32 codes_len | codes rice bytes
             | u32 bark_len | sidecar bytes
             | [u32 len | deflated int8 TNS indices, "tns"]
             | [u32 len | deflated uint8 noise-fill levels, "nf"]
             | [u32 len | deflated uint8 replication gains, "bwe"]
             | [u32 len | deflated uint8 intensity gains, "isf"]
             | [u32 len | packbits block-switch flags, "bs"]
             | [u32 len | FEC member: a coarse copy of the previous chunk]
             | u32 crc32 (over the payloads and, "hcrc", the length fields)
  a silent record: u8 1 | u32 blocks | f32 comfort-noise RMS per channel
             | u32 crc32
  trailer: u64 chunk byte offsets | u64 n_chunks | u64 index offset

The encoder runs each chunk's device work (the streaming MDCT on the card's
kernels, then ``Codec.encode_frames``) one chunk ahead of the host's Rice
coding: the payload comes back through pinned memory, and the host waits on
an event, never on the whole card. The decoder reads and Rice-decodes the
next chunk in a worker thread while the card synthesizes this one. Device
memory is bounded by the chunk: the signal may stay on the host.

The reader gives the codes and members as numpy arrays and the sidecar as a
CPU ``torch.bfloat16`` tensor, as ``io/bitstream.unpack`` does. The host
spans are labelled for ``torch.profiler``: ``stream.step`` (a chunk's
device work queued), ``stream.d2h`` (the wait for its payload) and
``stream.pack`` (Rice coding and the write) in the encoder,
``stream.read`` (the worker's read, CRC and Rice decode) and
``stream.step`` in the decoder.
"""

from __future__ import annotations

import json
import math
import os
import struct
import threading
import typing
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from audiocodec_tpu_torch import blockswitch as _blockswitch
from audiocodec_tpu_torch import bwe as _bwe
from audiocodec_tpu_torch import intensity as _intensity
from audiocodec_tpu_torch import native
from audiocodec_tpu_torch import nf as _nf
from audiocodec_tpu_torch import quantize as _quantize
from audiocodec_tpu_torch import rate as _rate
from audiocodec_tpu_torch import scq as _scq
from audiocodec_tpu_torch import streaming
from audiocodec_tpu_torch import tns as _tns
from audiocodec_tpu_torch.codec import Codec
from audiocodec_tpu_torch.io import bitstream as _bitstream
from audiocodec_tpu_torch.ops import threefry as _threefry
from audiocodec_tpu_torch.utils import dtypes as _dtypes

# Wire versions: "ACS2" marks grid-quantized sidecars (an ACS1 reader would
# play their levels as bfloat16 deltas), "ACS3" DTX streams (every chunk
# body starts with a marker byte); everything else stays ACS1.
_MAGIC_V1 = b"ACS1"
_MAGIC_V2 = b"ACS2"
_MAGIC_V3 = b"ACS3"

# Frame-count ceiling of a DTX silent record (writer-validated,
# reader-enforced): it caps the zero-codes allocation a tampered record
# could demand.
_SILENT_BLOCKS_CAP = 1 << 16

# The FEC copy's own sidecar grid (3 dB steps) and time pool (one sidecar
# row per 4 frames, the group's max intensity); both ride each member.
_FEC_K2 = 1
_FEC_TPOOL = 4

# Concealment's sign-scramble keys (jax.random.key of these, folded with
# the chunk index)
_CONCEAL_KEY = 0x9E3779B9
_INTERP_KEY = 0x7F4A7C15
# DTX comfort noise: numpy's default_rng(_COMFORT_SEED + chunk index)
_COMFORT_SEED = 0xD7C0FFEE

_span = torch.profiler.record_function


class Chunk(typing.NamedTuple):
    """One decoded chunk's payload (StreamReader.read_chunk)."""

    codes: np.ndarray  # int32 [blocks, N, C]
    bark: torch.Tensor  # CPU bfloat16 [blocks, bark_n, C or 1 (ms)]
    tns: np.ndarray | None  # int8 [blocks, order, C]; None = no TNS
    nfl: np.ndarray | None  # uint8 [blocks, C]; None = no noise filling
    tscale: float | None = None  # per-chunk rate scale (CBR streams)
    bsw: np.ndarray | None = None  # bool [blocks]; None = all-long
    bwe: np.ndarray | None = None  # uint8 [blocks, groups, C]; None = off
    isg: np.ndarray | None = None  # uint8 [blocks, groups]; None = off
    fec: bytes | None = None  # raw FEC member (a coarse coding of the
    #   PREVIOUS chunk, parse_fec_member); None = absent or empty
    silent: np.ndarray | None = None  # f32 [C] comfort-noise RMS levels of
    #   a DTX silent record; its codes and sidecar are then zeros and
    #   floors, so it decodes through the standard step


def _bark16(bark) -> torch.Tensor:
    """A sidecar as a CPU bfloat16 tensor: from a bfloat16 tensor on any
    device, a numpy bfloat16 array or its uint16 bits."""
    if isinstance(bark, torch.Tensor) and bark.dtype == torch.bfloat16:
        return bark.detach().cpu()
    return _bitstream.bf16_from_bits(_bitstream.bf16_bits(bark))


def _inflate(data: bytes, want_n: int, i: int, what: str) -> bytes:
    """Inflate a deflated member of ``want_n`` bytes, capped at the expected
    size (+1 to detect excess): a tampered field must not drive an unbounded
    allocation."""
    try:
        raw = zlib.decompressobj().decompress(data, want_n + 1)
    except zlib.error as e:
        raise ValueError(f"chunk {i} {what} payload corrupt: {e}") from None
    if len(raw) != want_n:
        raise ValueError(
            f"chunk {i} {what} payload is {len(raw)} bytes, expected "
            f"{want_n} — corrupt stream"
        )
    return raw


def pack_fec_member(codes, bark16, tscale: float, meta: dict,
                    k2: int = _FEC_K2, tpool: int = _FEC_TPOOL) -> bytes:
    """A chunk's FEC member: a self-contained COARSE coding of the previous
    chunk, its codes, its time-pooled sidecar and the absolute threshold
    scale they were quantized with (so a CBR stream, whose per-chunk scale
    is in the lost chunk, stays recoverable). Layout inside the
    (length-prefixed) member:

      u32 blocks | f64 scale | u32 k2 | u32 tpool | u32 clen
      | codes | levels...end

    ``bark16`` is the POOLED sidecar [ceil(blocks/tpool), bark, C'] that
    ``Codec.quantize_frames_fec`` quantized against on the grid ``k2``."""
    codes = _bitstream.host(codes)
    bark = _bark16(bark16)
    if codes.ndim == 4:
        codes = codes[0]
        bark = bark[0]
    blocks = codes.shape[0]
    if bark.shape[0] != -(-blocks // tpool):
        raise ValueError(
            f"pooled FEC sidecar has {bark.shape[0]} rows for {blocks} "
            f"frames at tpool={tpool}"
        )
    enc = (native.rrice_encode if meta["coder"] == "rrice"
           else native.rice_encode)
    code_bytes = enc(codes.astype(np.int32))
    bark_bytes = _scq.encode_levels(_scq.levels_from_bark16(bark, k2),
                                    block_axis=0)
    return (
        struct.pack("<IdII", blocks, float(tscale), int(k2), int(tpool))
        + struct.pack("<I", len(code_bytes))
        + code_bytes
        + bark_bytes
    )


def parse_fec_member(data: bytes, meta: dict):
    """FEC member bytes -> (codes int32 [blocks, N, C], bark bfloat16
    [blocks, bark_n, C or 1], the pooled sidecar repeat-expanded back to
    per-frame rows as the encoder quantized against, scale float).

    :raises ValueError: on any implausible field; the caller takes that as
        'no redundancy'. The member arrived CRC-verified, so these bounds
        guard logic errors and version skew, not bit flips.
    """
    if len(data) < 24:
        raise ValueError("FEC member too short")
    blocks, scale, k2, tpool = struct.unpack("<IdII", data[:20])
    (clen,) = struct.unpack("<I", data[20:24])
    if not (math.isfinite(scale) and 0 < scale < 2**32):
        raise ValueError(f"FEC scale {scale!r} out of bounds")
    if not k2:
        raise ValueError("FEC member sidecar grid must be nonzero")
    _scq.validate_k2(k2)
    if not 1 <= tpool <= 256:
        raise ValueError(f"FEC member time pool {tpool} out of bounds")
    if clen > len(data) - 24:
        raise ValueError("FEC member codes length out of bounds")
    code_bytes = data[24:24 + clen]
    bark_bytes = data[24 + clen:]
    n = meta["filters_n"]
    bark_n = meta["bark_bands_n"]
    ch = meta["channels"]
    bark_ch = 1 if meta.get("ms", False) else ch
    coder = meta.get("coder", "rice")
    per_byte = 96 if coder == "rrice" else 8
    if blocks * n * ch > per_byte * clen or blocks > len(data):
        raise ValueError("FEC member demands implausible code count")
    g = -(-blocks // tpool)
    if g * bark_n * bark_ch > 96 * len(bark_bytes):
        raise ValueError("FEC member demands implausible sidecar count")
    decode = native.rrice_decode if coder == "rrice" else native.rice_decode
    codes = decode(code_bytes, blocks * n * ch).reshape(blocks, n, ch)
    pooled = _scq.bark16_from_levels(
        _scq.decode_levels(bark_bytes, (g, bark_n, bark_ch), block_axis=0),
        k2, (g, bark_n, bark_ch), device="cpu",
    )
    bark = torch.repeat_interleave(pooled, tpool, dim=0)[:blocks]
    return codes, bark, scale


class StreamWriter:
    """Append encoded chunks to a seekable stream file (a path, or a
    file-like sink that stays the caller's)."""

    def __init__(self, path, *, sample_rate, filters_n, bark_bands_n,
                 alpha, window_type, channels, compute_dtype="float32",
                 ms: bool = False, threshold_scale: float = 1.0,
                 bark_precision: str = "highest", dz_recon: float = 0.0,
                 tns_order: int = 0, tns_band_start: int = 0,
                 nf: bool = False, nf_band_start: int = 0,
                 nf_seed: int = 0, cbr: bool = False,
                 bs: bool = False, bwe_start: int = 0,
                 is_start: int = 0,
                 sidecar_grid: int = 0,
                 fec_scale: float = 0.0,
                 dtx_level: float = 0.0,
                 orig_samples: int = 0, lufs=None):
        # quantization-affecting knobs ride the header so the decoder
        # derives bit-identical step sizes; "coder" is run-length Rice;
        # "hcrc" chains the per-chunk length fields into each chunk's CRC
        self.meta = {
            "sample_rate": int(sample_rate),
            "filters_n": int(filters_n),
            "bark_bands_n": int(bark_bands_n),
            "alpha": float(alpha),
            "window_type": window_type,
            "channels": int(channels),
            "compute_dtype": _bitstream.dtype_name(compute_dtype),
            "ms": bool(ms),
            "threshold_scale": float(threshold_scale),
            "bark_precision": str(bark_precision),
            "coder": "rrice",
            "hcrc": 1,
        }
        if orig_samples:
            # the exact pre-padding length, for a gapless decode
            if int(orig_samples) <= 0:
                raise ValueError(f"bad orig_samples: {orig_samples}")
            self.meta["nsamp"] = int(orig_samples)
        if lufs is not None:
            if not _bitstream.LUFS_MIN <= float(lufs) <= _bitstream.LUFS_MAX:
                raise ValueError(f"lufs out of range: {lufs}")
            self.meta["lufs"] = float(lufs)
        if dz_recon:
            # absent = 0 (plain rounding)
            self.meta["dzr"] = float(dz_recon)
        if tns_order:
            if not 0 < tns_order <= 32 or not (
                tns_order < tns_band_start < filters_n
            ):
                raise ValueError(
                    f"bad TNS config: order={tns_order}, "
                    f"band_start={tns_band_start}"
                )
            self.meta["tns"] = {
                "order": int(tns_order),
                "band_start": int(tns_band_start),
            }
        if nf:
            # the seed makes the fill noise reproducible; levels index
            # GLOBAL frame positions, so chunked and seeking decodes agree
            if not 0 <= nf_band_start < filters_n or not (
                0 <= nf_seed < 2**32
            ):
                raise ValueError(
                    f"bad noise-fill config: band_start={nf_band_start}, "
                    f"seed={nf_seed}"
                )
            self.meta["nf"] = {
                "band_start": int(nf_band_start),
                "seed": int(nf_seed),
            }
        if sidecar_grid:
            _scq.validate_k2(int(sidecar_grid))
            self.meta["scq"] = int(sidecar_grid)
        if bwe_start:
            # the crossover and group width are bitstream-critical
            _bwe.validate_start(filters_n, int(bwe_start))
            self.meta["bwe"] = {
                "start": int(bwe_start),
                "group": int(_bwe.GROUP),
            }
        if is_start:
            if not ms:
                raise ValueError(
                    "intensity streams require joint stereo (ms)"
                )
            _intensity.validate_start(filters_n, int(is_start))
            self.meta["isf"] = {
                "start": int(is_start),
                "group": int(_intensity.GROUP),
            }
        if bs:
            if filters_n % _blockswitch.FACTOR:
                raise ValueError(
                    f"block switching needs filters_n divisible by "
                    f"{_blockswitch.FACTOR}, got {filters_n}"
                )
            self.meta["bs"] = {"factor": int(_blockswitch.FACTOR)}
        if fec_scale:
            # every chunk carries a coarse redundant coding of the
            # PREVIOUS chunk (plain quantize at threshold scale x
            # fec_scale), from which a lost chunk is rebuilt
            if not 1.0 <= float(fec_scale) <= 256.0:
                raise ValueError(
                    f"fec_scale must be in [1, 256], got {fec_scale}"
                )
            self.meta["fec"] = {"scale": float(fec_scale)}
        if dtx_level:
            # gated chunks become silent records (append_silent); the
            # level (dBFS) is informational
            if not -200.0 < float(dtx_level) < 0.0:
                raise ValueError(
                    f"dtx_level must be a negative dBFS gate, got "
                    f"{dtx_level}"
                )
            if fec_scale or cbr:
                raise ValueError(
                    "dtx does not compose with fec or cbr streams (a "
                    "silent record carries no members for the FEC chain "
                    "or a per-chunk scale to ride)"
                )
            self.meta["dtx"] = {"level": float(dtx_level)}
        if cbr:
            # every chunk carries its OWN f64 threshold scale
            self.meta["cbr"] = 1
        if isinstance(path, (str, bytes, os.PathLike)):
            self._f = open(path, "wb")
            self._owns_file = True
        else:
            self._f = path
            self._owns_file = False
        header = json.dumps(self.meta).encode()
        if "dtx" in self.meta:
            magic = _MAGIC_V3
        elif "scq" in self.meta:
            magic = _MAGIC_V2
        else:
            magic = _MAGIC_V1
        self._f.write(magic + struct.pack("<I", len(header)) + header)
        self._index = []
        self._closed = False

    def append(self, codes, bark16, tns_idx=None, nf_levels=None,
               tscale=None, bs_flags=None, bwe_gains=None,
               is_gains=None, fec=None) -> None:
        """Write one chunk: codes int32 [1, blocks, N, C] (or [blocks, N,
        C]), bark16 bfloat16 [1, blocks, bark_n, C] (or unbatched), and the
        members the header declares: int8 TNS indices [1, blocks, order,
        C], uint8 noise-fill levels [1, blocks, C], this chunk's threshold
        scale (CBR), bool block-switch flags [1, blocks], uint8 replication
        gains [1, blocks, groups, C], uint8 intensity gains [1, blocks,
        groups], FEC member bytes (b"" for the first chunk). Arrays may be
        numpy or tensors on any device."""
        codes = _bitstream.host(codes)
        bark = _bark16(bark16)
        if codes.ndim == 4:
            if codes.shape[0] != 1:
                raise ValueError("stream chunks are single-clip")
            codes = codes[0]
            bark = bark[0]
        blocks = codes.shape[0]
        ch = codes.shape[-1]
        # each member is passed exactly when the header declares it
        for name, value, key, word in (
            ("TNS indices", tns_idx, "tns", "TNS"),
            ("noise-fill levels", nf_levels, "nf", "nf"),
            ("block-switch flags", bs_flags, "bs", "bs"),
            ("replication gains", bwe_gains, "bwe", "bwe"),
            ("intensity gains", is_gains, "isf", "isf"),
            ("FEC bytes", fec, "fec",
             "fec (pass b'' for the first chunk)"),
            ("threshold scale", tscale, "cbr", "cbr"),
        ):
            if (self.meta.get(key) is not None) != (value is not None):
                raise ValueError(
                    f"chunk {name} must be passed exactly when the stream "
                    f"header declares {word}"
                )
        tns = self.meta.get("tns")
        cbr = self.meta.get("cbr")
        if cbr is not None and not 0 < float(tscale) < 2**32:
            raise ValueError(f"chunk threshold scale out of range: {tscale}")
        enc = (native.rrice_encode if self.meta["coder"] == "rrice"
               else native.rice_encode)
        code_bytes = enc(codes.astype(np.int32))
        scq_k2 = self.meta.get("scq", 0)
        if scq_k2:
            bark_bytes = _scq.encode_levels(
                _scq.levels_from_bark16(bark, scq_k2), block_axis=0
            )
        else:
            bark_bytes = _bitstream.encode_bark_sidecar(
                bark, block_axis=0,
                coder=self.meta.get("scoder", self.meta["coder"]),
            )

        def unbatched(values, dtype, ndim, shape, what):
            a = np.ascontiguousarray(_bitstream.host(values), dtype=dtype)
            if a.ndim == ndim:
                a = a[0]
            if a.shape != shape:
                raise ValueError(f"chunk {what} shape {a.shape} != {shape}")
            return a

        # optional members in wire order: (header key, bytes)
        members = []
        if tns is not None:
            ti = unbatched(tns_idx, np.int8, 4, (blocks, tns["order"], ch),
                           "tns_idx")
            members.append(zlib.compress(ti.tobytes(), 6))
        if self.meta.get("nf") is not None:
            lv = unbatched(nf_levels, np.uint8, 3, (blocks, ch), "nf_levels")
            members.append(zlib.compress(lv.tobytes(), 6))
        if self.meta.get("bwe") is not None:
            groups = _bwe.n_groups(self.meta["filters_n"],
                                   self.meta["bwe"]["start"])
            gz = unbatched(bwe_gains, np.uint8, 4, (blocks, groups, ch),
                           "bwe_gains")
            members.append(zlib.compress(gz.tobytes(), 6))
        if self.meta.get("isf") is not None:
            groups = _intensity.n_groups(self.meta["filters_n"],
                                         self.meta["isf"]["start"])
            gz = unbatched(is_gains, np.uint8, 3, (blocks, groups),
                           "is_gains")
            members.append(zlib.compress(gz.tobytes(), 6))
        if self.meta.get("bs") is not None:
            fl = unbatched(bs_flags, bool, 2, (blocks,), "bs_flags")
            members.append(
                _blockswitch.pack_flags(torch.from_numpy(fl[None]))[0]
                .tobytes())
        if self.meta.get("fec") is not None:
            members.append(bytes(fec))
        # the CRC covers the header fields too, chained in file order
        hdr_codes = struct.pack("<II", blocks, len(code_bytes))
        hdr_bark = struct.pack("<I", len(bark_bytes))
        crc = 0
        self._index.append(self._f.tell())
        if "dtx" in self.meta:
            # DTX bodies start with a marker byte: 0 = this coded layout
            crc = zlib.crc32(b"\x00", crc)
            self._f.write(b"\x00")
        if cbr is not None:
            ts_bytes = struct.pack("<d", float(tscale))
            crc = zlib.crc32(ts_bytes, crc)
            self._f.write(ts_bytes)
        crc = zlib.crc32(code_bytes, zlib.crc32(hdr_codes, crc))
        crc = zlib.crc32(bark_bytes, zlib.crc32(hdr_bark, crc))
        self._f.write(hdr_codes)
        self._f.write(code_bytes)
        self._f.write(hdr_bark)
        self._f.write(bark_bytes)
        for data in members:
            hdr = struct.pack("<I", len(data))
            crc = zlib.crc32(data, zlib.crc32(hdr, crc))
            self._f.write(hdr)
            self._f.write(data)
        self._f.write(struct.pack("<I", crc))

    def append_silent(self, blocks: int, levels) -> None:
        """Write one DTX silent record: marker 1, the frame count, and one
        float32 comfort-noise RMS level per channel (0.0 decodes to digital
        silence), ~(9 + 4*C) bytes. Only on streams made with
        ``dtx_level``."""
        if "dtx" not in self.meta:
            raise ValueError(
                "append_silent requires a DTX stream (dtx_level set)"
            )
        lv = np.asarray(_bitstream.host(levels), dtype=np.float64).ravel()
        if lv.shape != (self.meta["channels"],):
            raise ValueError(
                f"need one level per channel ({self.meta['channels']}), "
                f"got shape {lv.shape}"
            )
        if not (np.isfinite(lv).all() and (lv >= 0).all()):
            raise ValueError(f"bad comfort-noise levels: {lv!r}")
        # snapped onto a 0.5 dB log grid: the wire bytes then do not depend
        # on the last ulp of how the RMS was computed
        nz = lv > 1e-12
        lv = np.where(
            nz,
            10.0 ** (np.round(
                40.0 * np.log10(np.maximum(lv, 1e-12))
            ) / 40.0),
            0.0,
        ).astype(np.float32)
        blocks = int(blocks)
        if not 0 < blocks <= _SILENT_BLOCKS_CAP:
            raise ValueError(
                f"silent record blocks out of range (1..{_SILENT_BLOCKS_CAP}): "
                f"{blocks}"
            )
        body = b"\x01" + struct.pack("<I", blocks) + lv.tobytes()
        self._index.append(self._f.tell())
        self._f.write(body)
        self._f.write(struct.pack("<I", zlib.crc32(body, 0)))

    def close(self) -> None:
        if self._closed:
            return
        index_off = self._f.tell()
        self._f.write(struct.pack(f"<{len(self._index)}Q", *self._index))
        self._f.write(struct.pack("<QQ", len(self._index), index_off))
        if self._owns_file:
            self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StreamReader:
    """Random or sequential access to an .acs stream (a path, or a seekable
    file-like source that stays the caller's)."""

    def __init__(self, path):
        if isinstance(path, (str, bytes, os.PathLike)):
            self._f = open(path, "rb")
            self._size = os.fstat(self._f.fileno()).st_size
            self._owns_file = True
        else:
            self._f = path
            self._f.seek(0, 2)
            self._size = self._f.tell()
            self._f.seek(0)
            self._owns_file = False
        try:
            magic = self._f.read(4)
            if magic not in (_MAGIC_V1, _MAGIC_V2, _MAGIC_V3):
                raise ValueError(f"not an ACS stream (magic {magic!r})")
            try:
                (hlen,) = struct.unpack("<I", self._f.read(4))
                if hlen > self._size:
                    raise ValueError("header length exceeds file size")
                self.meta = json.loads(self._f.read(hlen))
                self._f.seek(-16, 2)
                n_chunks, index_off = struct.unpack("<QQ", self._f.read(16))
                # every trailer field must point inside the file
                if (index_off + 8 * n_chunks + 16 > self._size
                        or index_off < 8 + hlen):
                    raise ValueError("stream trailer/index out of bounds")
                self._f.seek(index_off)
                self._index = list(struct.unpack(
                    f"<{n_chunks}Q", self._f.read(8 * n_chunks)))
                self._index_end = index_off
                if any(not 8 + hlen <= off < index_off
                       for off in self._index):
                    raise ValueError("chunk offsets out of bounds")
                self._validate_meta()
            except (struct.error, json.JSONDecodeError,
                    UnicodeDecodeError) as e:
                raise ValueError(f"corrupt ACS stream: {e}") from None
        except (ValueError, OSError):
            self.close()
            raise

    def _validate_meta(self) -> None:
        """Bound the untrusted JSON header before any field sizes a decode
        allocation."""
        m = self.meta
        if not isinstance(m, dict):
            raise ValueError("stream header is not an object")
        for key, lo, hi in (
            ("filters_n", 2, 1 << 16),
            ("bark_bands_n", 1, 1 << 16),
            ("channels", 1, 64),
            ("sample_rate", 1, 10_000_000),
        ):
            v = m.get(key)
            if not isinstance(v, int) or not lo <= v <= hi:
                raise ValueError(
                    f"stream header field {key}={v!r} out of bounds "
                    f"[{lo}, {hi}] — corrupt stream"
                )
        if m["filters_n"] % 2 != 0:
            raise ValueError("stream header filters_n must be even")
        ts = m.get("threshold_scale", 1.0)
        if not isinstance(ts, (int, float)) or not 0 < ts < 2**32:
            raise ValueError(
                f"stream header threshold_scale={ts!r} out of bounds — "
                "corrupt stream"
            )
        if m.get("ms", False) and m["channels"] != 2:
            raise ValueError("stream header: ms coding requires 2 channels")
        dzr = m.get("dzr", 0.0)
        if not isinstance(dzr, (int, float)) or not -1.0 <= dzr <= 2.0:
            raise ValueError(
                f"stream header dzr={dzr!r} out of bounds — corrupt stream"
            )
        if m.get("bark_precision", "highest") not in (
            "highest", "high", "default"
        ):
            raise ValueError(
                "stream header bark_precision must be one of "
                "highest/high/default — corrupt stream"
            )
        scq_k2 = m.get("scq", 0)
        if scq_k2:
            if not isinstance(scq_k2, int):
                raise ValueError(
                    f"stream header scq={scq_k2!r} must be an integer — "
                    "corrupt stream"
                )
            try:
                _scq.validate_k2(scq_k2)
            except ValueError as e:
                raise ValueError(
                    f"stream sidecar grid unsupported: {e} — written by "
                    "a newer framework version?"
                ) from None
        tns = m.get("tns")
        if tns is not None:
            order = tns.get("order") if isinstance(tns, dict) else None
            bs = tns.get("band_start") if isinstance(tns, dict) else None
            if (
                not isinstance(order, int) or not isinstance(bs, int)
                or not 0 < order <= 32 or not order < bs < m["filters_n"]
            ):
                raise ValueError(
                    f"stream header tns={tns!r} out of bounds — corrupt "
                    "stream"
                )
        nf = m.get("nf")
        if nf is not None:
            bs = nf.get("band_start") if isinstance(nf, dict) else None
            seed = nf.get("seed") if isinstance(nf, dict) else None
            if (
                not isinstance(bs, int) or not isinstance(seed, int)
                or not 0 <= bs < m["filters_n"] or not 0 <= seed < 2**32
            ):
                raise ValueError(
                    f"stream header nf={nf!r} out of bounds — corrupt "
                    "stream"
                )
        bsm = m.get("bs")
        if bsm is not None:
            factor = bsm.get("factor") if isinstance(bsm, dict) else None
            if (
                not isinstance(factor, int)
                or not 2 <= factor <= 64
                or m["filters_n"] % factor
            ):
                raise ValueError(
                    f"stream header bs={bsm!r} out of bounds — corrupt "
                    "stream"
                )
            if factor != _blockswitch.FACTOR:
                # pooling groups and the short basis derive from FACTOR
                raise ValueError(
                    f"stream uses block-switch factor {factor}; this "
                    f"decoder supports {_blockswitch.FACTOR} (newer "
                    "framework version?)"
                )
        for key, module, what in (("bwe", _bwe, "bwe group width"),
                                  ("isf", _intensity,
                                   "intensity group width")):
            sub = m.get(key)
            if sub is None:
                continue
            start = sub.get("start") if isinstance(sub, dict) else None
            group = sub.get("group") if isinstance(sub, dict) else None
            if not isinstance(start, int) or not isinstance(group, int):
                raise ValueError(
                    f"stream header {key}={sub!r} out of bounds — corrupt "
                    "stream"
                )
            if group != module.GROUP:
                # the fill derives its group slices from GROUP
                raise ValueError(
                    f"stream uses {what} {group}; this decoder supports "
                    f"{module.GROUP} (newer framework version?)"
                )
            try:
                module.validate_start(m["filters_n"], start)
            except ValueError as e:
                raise ValueError(f"corrupt stream: {e}") from None
            if key == "isf" and not m.get("ms"):
                raise ValueError(
                    "stream header declares intensity without joint "
                    "stereo — corrupt stream"
                )
        fecm = m.get("fec")
        if fecm is not None:
            sc = fecm.get("scale") if isinstance(fecm, dict) else None
            if not isinstance(sc, (int, float)) or not 1.0 <= sc <= 256.0:
                raise ValueError(
                    f"stream header fec={fecm!r} out of bounds — corrupt "
                    "stream"
                )
        if not isinstance(m.get("cbr", 0), (int, bool)):
            raise ValueError("stream header cbr must be a flag")
        ns = m.get("nsamp", 0)
        if not isinstance(ns, int) or ns < 0:
            raise ValueError(
                f"stream header nsamp={ns!r} out of bounds — corrupt "
                "stream"
            )
        lv = m.get("lufs")
        if lv is not None and (
            not isinstance(lv, (int, float))
            or not _bitstream.LUFS_MIN <= lv <= _bitstream.LUFS_MAX
        ):
            raise ValueError(
                f"stream header lufs={lv!r} out of bounds — corrupt "
                "stream"
            )

    @property
    def n_chunks(self) -> int:
        return len(self._index)

    def chunk_blocks(self, i: int) -> int:
        """Number of spectral frames in chunk i (its header only)."""
        self._check_index(i)
        self._f.seek(self._index[i])
        # wire order: DTX marker, then the f64 CBR scale, then the count
        silent = False
        if self.meta.get("dtx") is not None:
            marker = self._read_exact(1, i)
            if marker not in (b"\x00", b"\x01"):
                raise ValueError(
                    f"chunk {i} has an unknown DTX marker — corrupt "
                    "stream"
                )
            silent = marker == b"\x01"
        if self.meta.get("cbr") and not silent:
            self._f.seek(8, 1)
        (blocks,) = struct.unpack("<I", self._read_exact(4, i))
        return blocks

    def chunk_bytes(self, i: int) -> int:
        """On-wire byte size of chunk i, framing included (from the index
        alone): the stream's bit-demand profile, which the reservoir
        allocator feeds on (rate.reservoir_allocate)."""
        self._check_index(i)
        end = (self._index[i + 1] if i + 1 < len(self._index)
               else self._index_end)
        size = end - self._index[i]
        if size <= 0:
            raise ValueError(f"chunk {i} index not increasing — corrupt")
        return size

    def _check_index(self, i: int) -> None:
        if not 0 <= i < len(self._index):
            raise IndexError(f"chunk {i} of {len(self._index)}")

    def _read_exact(self, nbytes: int, i: int) -> bytes:
        data = self._f.read(nbytes)
        if len(data) != nbytes:
            raise ValueError(f"chunk {i} truncated — corrupt stream")
        return data

    def read_chunk(self, i: int) -> Chunk:
        """-> :class:`Chunk` of chunk i, CRC-checked.

        :raises ValueError: on any corruption; IndexError out of range.
        """
        self._check_index(i)
        self._f.seek(self._index[i])
        hcrc = bool(self.meta.get("hcrc"))
        want = 0
        tscale = None
        if self.meta.get("dtx") is not None:
            marker = self._read_exact(1, i)
            want = zlib.crc32(marker, want)
            if marker == b"\x01":
                return self._read_silent_record(i, want)
            if marker != b"\x00":
                raise ValueError(
                    f"chunk {i} has an unknown DTX marker — corrupt "
                    "stream"
                )
        if self.meta.get("cbr"):
            ts_bytes = self._read_exact(8, i)
            (tscale,) = struct.unpack("<d", ts_bytes)
            want = zlib.crc32(ts_bytes, want)
            if not (math.isfinite(tscale) and 0 < tscale < 2**32):
                raise ValueError(
                    f"chunk {i} threshold scale {tscale!r} out of bounds "
                    "— corrupt stream"
                )

        # hcrc streams chain the length fields into the CRC, so a flipped
        # blocks/length field fails the check instead of truncating the
        # decode; payload bytes chain either way
        def chain(data, hdr):
            nonlocal want
            if hcrc:
                want = zlib.crc32(hdr, want)
            want = zlib.crc32(data, want)

        def read_payload():
            """One length-prefixed member, its length bounded by the file
            before anything is allocated or read."""
            hdr = self._read_exact(4, i)
            (length,) = struct.unpack("<I", hdr)
            if length > self._size:
                raise ValueError(
                    f"chunk {i} has implausible sizes — corrupt stream"
                )
            data = self._read_exact(length, i)
            chain(data, hdr)
            return data

        hdr_codes = self._read_exact(8, i)
        blocks, clen = struct.unpack("<II", hdr_codes)
        if blocks > self._size or clen > self._size:
            raise ValueError(f"chunk {i} has implausible sizes — corrupt stream")
        code_bytes = self._read_exact(clen, i)
        chain(code_bytes, hdr_codes)
        bark_bytes = read_payload()
        raw = {key: read_payload() if self.meta.get(key) is not None
               else None for key in ("tns", "nf", "bwe", "isf", "bs", "fec")}
        (crc,) = struct.unpack("<I", self._read_exact(4, i))
        if want != crc:
            raise ValueError(f"chunk {i} failed CRC — corrupt stream")

        n = self.meta["filters_n"]
        bark_n = self.meta["bark_bands_n"]
        ch = self.meta["channels"]
        # joint stereo stores the one min-channel sidecar
        bark_ch = 1 if self.meta.get("ms", False) else ch
        # plausibility before allocating: plain Rice spends >= 1 bit a
        # value, run-length Rice ~93 values a byte at best
        coder = self.meta.get("coder", "rice")
        if coder not in ("rice", "rrice"):
            raise ValueError(
                f"stream uses unsupported coder {coder!r} — written by a "
                "newer framework version?"
            )
        scoder = self.meta.get("scoder", coder)
        if scoder not in ("rice", "rrice", "rrice2d"):
            raise ValueError(
                f"stream uses unsupported sidecar coder {scoder!r} — "
                "written by a newer framework version?"
            )
        per_byte = 96 if coder == "rrice" else 8
        if blocks * n * ch > per_byte * clen:
            raise ValueError(
                f"chunk {i} header demands {blocks * n * ch} values from a "
                f"{clen}-byte payload — corrupt stream"
            )
        decode = native.rrice_decode if coder == "rrice" else native.rice_decode
        codes = decode(code_bytes, blocks * n * ch).reshape(blocks, n, ch)
        sper_byte = 8 if scoder == "rice" else 96
        if blocks * bark_n * bark_ch > sper_byte * len(bark_bytes):
            raise ValueError(
                f"chunk {i} header demands {blocks * bark_n * bark_ch} "
                f"sidecar values from a {len(bark_bytes)}-byte payload "
                "— corrupt stream"
            )
        scq_k2 = self.meta.get("scq", 0)
        shape = (blocks, bark_n, bark_ch)
        if scq_k2:
            try:
                bark = _scq.bark16_from_levels(
                    _scq.decode_levels(bark_bytes, shape, block_axis=0),
                    scq_k2, shape, device="cpu",
                )
            except ValueError as e:
                raise ValueError(f"chunk {i}: {e}") from None
        else:
            bark = _bitstream.decode_bark_sidecar(bark_bytes, shape,
                                                  block_axis=0, coder=scoder)

        def inflated(key, what, dtype, *dims):
            if raw[key] is None:
                return None
            data = _inflate(raw[key], blocks * math.prod(dims), i, what)
            return np.frombuffer(data, dtype=dtype).reshape(blocks, *dims)

        tns = (inflated("tns", "TNS", np.int8, self.meta["tns"]["order"], ch)
               if raw["tns"] is not None else None)
        nfl = inflated("nf", "noise-fill", np.uint8, ch)
        bwe = (inflated("bwe", "bwe", np.uint8,
                        _bwe.n_groups(n, self.meta["bwe"]["start"]), ch)
               if raw["bwe"] is not None else None)
        isg = (inflated("isf", "intensity", np.uint8,
                        _intensity.n_groups(n, self.meta["isf"]["start"]))
               if raw["isf"] is not None else None)
        bsw = None
        if raw["bs"] is not None:
            want_n = (blocks + 7) // 8
            if len(raw["bs"]) != want_n:
                raise ValueError(
                    f"chunk {i} block-switch bitmap is {len(raw['bs'])} "
                    f"bytes, expected {want_n} — corrupt stream"
                )
            bsw = _blockswitch.unpack_flags(
                np.frombuffer(raw["bs"], dtype=np.uint8)[None], blocks,
                device="cpu")[0].numpy()
        return Chunk(codes, bark, tns, nfl, tscale, bsw, bwe, isg,
                     raw["fec"] or None)

    def _read_silent_record(self, i: int, want: int) -> Chunk:
        """A DTX silent record (marker consumed and chained) as a chunk
        that decodes through the STANDARD step: zero codes, a floor
        sidecar, and neutral members (identity TNS, no fills, all-long),
        so carries, seeks and every decode path stay the coded chunks'."""
        hdr = self._read_exact(4, i)
        (blocks,) = struct.unpack("<I", hdr)
        ch = self.meta["channels"]
        # no payload bounds a silent record's frame count: the cap does
        if not 0 < blocks <= _SILENT_BLOCKS_CAP:
            raise ValueError(
                f"chunk {i} has implausible sizes — corrupt stream"
            )
        lv_bytes = self._read_exact(4 * ch, i)
        want = zlib.crc32(lv_bytes, zlib.crc32(hdr, want))
        (crc,) = struct.unpack("<I", self._read_exact(4, i))
        if want != crc:
            raise ValueError(f"chunk {i} failed CRC — corrupt stream")
        levels = np.frombuffer(lv_bytes, dtype=np.float32).copy()
        if not np.isfinite(levels).all() or (levels < 0).any():
            raise ValueError(
                f"chunk {i} has bad comfort-noise levels — corrupt "
                "stream"
            )
        m = self.meta
        n = m["filters_n"]
        bark_ch = 1 if m.get("ms", False) else ch

        def zeros(key, *dims):
            if m.get(key) is None:
                return None
            return np.zeros((blocks, *dims), np.int8 if key == "tns"
                            else np.uint8)

        return Chunk(
            np.zeros((blocks, n, ch), np.int32),
            torch.full((blocks, m["bark_bands_n"], bark_ch), 1e-9,
                       dtype=torch.bfloat16),
            zeros("tns", m["tns"]["order"], ch) if m.get("tns") else None,
            zeros("nf", ch), None,
            np.zeros(blocks, bool) if m.get("bs") is not None else None,
            zeros("bwe", _bwe.n_groups(n, m["bwe"]["start"]), ch)
            if m.get("bwe") else None,
            zeros("isf", _intensity.n_groups(n, m["isf"]["start"]))
            if m.get("isf") else None,
            None, silent=levels,
        )

    def close(self) -> None:
        if self._owns_file:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def modal_body_blocks(reader: StreamReader) -> int:
    """The stream's MODAL body-chunk size over readable headers (the format
    writes uniform body chunks and a one-frame flush). Loss concealment
    uses it wherever a chunk's own header cannot be trusted: a corrupt u32
    must not size a huge synthesis or shift the noise fill's frames."""
    seen: dict[int, int] = {}
    for j in range(max(0, reader.n_chunks - 1)):
        try:
            b = reader.chunk_blocks(j)
        except ValueError:
            continue
        if 0 < b <= reader._size:
            seen[b] = seen.get(b, 0) + 1
    return max(seen, key=seen.get) if seen else 1


# -- codec integration ---------------------------------------------------------


def _device(codec) -> torch.device:
    return codec.mdct.wa_r.device


def _to_host(tensors):
    """Queue a copy of every CUDA tensor of ``tensors`` into pinned host
    memory without waiting for it -> (the host tensors, the event that
    marks the copies done, or None when nothing was on the card)."""
    out, queued = [], False
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t, queued = h, True
        out.append(t)
    if not queued:
        return out, None
    event = torch.cuda.Event()
    event.record()
    return out, event


def _encode_step(codec, carry, x_chunk, drown, threshold_scale, ms,
                 deadzone, tns=False, nf=False, tmask=0.0,
                 tmask_context=None, bs=False, bwe=False, intensity=False,
                 fec_mult=0.0, codec_fec=None):
    """One chunk's device work: the streaming MDCT step, the coded encode,
    the FEC copy (by ``codec_fec``, with ``fec_mult``) and the next chunk's
    temporal-masking context ->
    (carry, context, EncodedFrames, FEC (codes, pooled sidecar) or None)."""
    carry, frames = streaming.mdct_stream_step(codec.mdct, carry, x_chunk)
    enc = codec.encode_frames(
        frames, drown, threshold_scale=threshold_scale, ms=ms,
        deadzone=deadzone, tns=tns, nf=nf, tmask=tmask,
        tmask_context=tmask_context, bs=bs, bwe=bwe, intensity=intensity,
    )
    # the FEC copy: a PLAIN coarse quantize of the same frames (it must
    # decode standalone out of a successor chunk), on the member's own
    # sidecar grid (codec_fec) and time pool, so its codes are quantized
    # against exactly the sidecar the member carries
    fecq = None
    if fec_mult:
        fecq = codec_fec.quantize_frames_fec(
            frames, drown, threshold_scale=threshold_scale * fec_mult,
            ms=ms, deadzone=deadzone, tpool=_FEC_TPOOL,
        )
    new_ctx = None
    if tmask:
        # the next chunk's context: the trailing pre-spread Bark
        # intensities of these frames (per-frame, so equal to what the
        # encode above used)
        w = codec.tmask_context_frames(tmask)
        take = min(w, frames.shape[1])
        pre = codec.bark_intensity(frames[:, -take:], drown)
        if tmask_context is not None and take < w:
            pre = torch.cat([tmask_context, pre], dim=1)[:, -w:]
        new_ctx = pre
    return carry, new_ctx, enc, fecq


def _dtx_gate(x, chunk: int, dtx: float):
    """Per-(chunk, channel) RMS of ``x`` [1, S, C] in float32, one reduction
    where ``x`` lives -> (gate bool [chunks], levels [chunks, C]). The gate
    compares the loudest channel; a one-chunk hangover keeps coding the
    chunk right after active content, so decays are not clipped."""
    c = x.shape[-1]
    rms = torch.sqrt(torch.mean(
        x.to(torch.float32).reshape(-1, chunk, c) ** 2, dim=1)).cpu().numpy()
    below = rms.max(axis=1) < 10.0 ** (float(dtx) / 20.0)
    gate = below & np.roll(below, 1)
    gate[0] = below[0]
    return gate, rms


@torch.no_grad()
def encode_stream(codec, x, path, chunk_blocks: int = 256,
                  drown=0.0, ms: bool = False,
                  threshold_scale: float = 1.0,
                  deadzone: float = 0.5, tns: bool = False,
                  nf: bool = False, nf_seed: int = 0,
                  tmask: float = 0.0, bs: bool = False,
                  bwe: bool = False, intensity: bool = False,
                  fec: float = 0.0, dtx: float = 0.0,
                  orig_samples: int = 0, lufs=None) -> int:
    """Encode a long waveform to a seekable stream with bounded memory.

    The streaming MDCT (one carried block across chunks) and a per-chunk
    ``Codec.encode_frames``, on the codec's device; the header records
    what the decoder needs for the same step sizes.

    :param x: [1, samples, channels] in the codec's compute dtype, on the
        host or the codec's device; samples a multiple of chunk_blocks*N.
        Each chunk goes to the device on its own turn.
    :param threshold_scale: one float for the whole stream (the header
        records it); a SEQUENCE of floats, one per body chunk, writes a CBR
        stream whose chunks carry their own scales (the flush frame reuses
        the last). :func:`encode_stream_cbr` searches them.
    :param deadzone: zero-bin half-width (0.5 = plain rounding); its
        reconstruction offset rides the header as ``dzr``.
    :param tns, nf, bs, bwe, intensity: the feature ladder
        (``Codec.encode_frames``); its members ride each chunk. The noise
        fill is keyed by GLOBAL frame index (``nf_seed`` in the header), so
        a chunked decode and a seek reproduce a whole-file decode's noise.
    :param tmask: forward-masking decay in dB/s, 0 = off; a rolling context
        of pre-spread intensities crosses the chunk boundaries.
    :param fec: forward error correction, 0 = off; else a threshold-scale
        multiplier: every chunk also carries a coarse plain-quantized copy
        of the PREVIOUS chunk, from which ``decode_stream(conceal=True)``
        rebuilds a lost chunk. The flush chunk is unprotected.
    :param dtx: discontinuous transmission gate in dBFS (negative), 0 =
        off: chunks whose channels' RMS all sit below it (with a one-chunk
        hangover) become silent records carrying comfort-noise levels; the
        encoder zeroes its MDCT carry across them. Magic ACS3; does not
        compose with ``fec`` or CBR scales.
    :return: number of chunks written.
    """
    mdct = codec.mdct
    n = mdct.filters_n
    _dtypes.check_input_dtype(x, mdct.compute_dtype, "encode_stream input")
    dev = _device(codec)
    b, s, c = x.shape
    if b != 1:
        raise ValueError("encode_stream takes a single clip")
    if ms and c != 2:
        raise ValueError("joint mid/side coding needs a stereo input")
    chunk = chunk_blocks * n
    if s % chunk != 0:
        raise ValueError(f"samples {s} must be a multiple of {chunk}")
    deadzone = float(deadzone)
    dz_recon = (_quantize.dz_recon_offset(deadzone) if deadzone != 0.5
                else 0.0)
    cbr = np.ndim(threshold_scale) > 0 or isinstance(threshold_scale,
                                                     (list, tuple))
    if cbr:
        scales = [float(v) for v in np.asarray(threshold_scale).ravel()]
        if len(scales) != s // chunk:
            raise ValueError(
                f"per-chunk threshold_scale needs one value per body "
                f"chunk ({s // chunk}), got {len(scales)}"
            )
    tmask = float(tmask)
    fec = float(fec)
    features = dict(tns=tns, nf=nf, tmask=tmask, bs=bs, bwe=bwe,
                    intensity=intensity)
    with StreamWriter(
        path,
        sample_rate=codec.psycho.sample_rate,
        filters_n=n,
        bark_bands_n=codec.psycho.bark_bands_n,
        alpha=codec.psycho.alpha,
        window_type=mdct.window_type,
        channels=c,
        compute_dtype=mdct.compute_dtype,
        ms=ms,
        threshold_scale=1.0 if cbr else threshold_scale,
        bark_precision=codec.psycho.bark_precision,
        dz_recon=dz_recon,
        tns_order=_tns.ORDER if tns else 0,
        tns_band_start=codec.tns_band_start if tns else 0,
        nf=nf,
        nf_band_start=codec.nf_band_start if nf else 0,
        nf_seed=nf_seed if nf else 0,
        cbr=cbr,
        bs=bs,
        bwe_start=codec.bwe_start if bwe else 0,
        is_start=codec.is_start if intensity else 0,
        sidecar_grid=codec.sidecar_grid,
        fec_scale=fec,
        dtx_level=float(dtx),
        orig_samples=orig_samples,
        lufs=lufs,
    ) as w:
        gate = None
        if dtx:
            gate, levels = _dtx_gate(x, chunk, dtx)
        # the same codec on the FEC member's own coarse sidecar grid,
        # sharing the modules and their buffers
        codec_fec = (Codec(codec.mdct, codec.psycho, sidecar_grid=_FEC_K2)
                     if fec else None)
        carry = streaming.mdct_stream_init(mdct, 1, c)
        tctx = None
        # one-deep pipeline: chunk k+1's device work is queued before the
        # host waits for chunk k's payload and Rice-codes it
        pending = None  # (host payload, its event, FEC member of the
        #                 previous chunk's coarse copy or None)
        prev_coarse = None  # (codes, pooled sidecar) on the host, scale

        def flush_pending():
            payload, event, fec_prev = pending
            if event is not None:
                with _span("stream.d2h"):
                    event.synchronize()
            with _span("stream.pack"):
                fec_bytes = None
                if fec:
                    fec_bytes = (b"" if fec_prev is None
                                 else pack_fec_member(*fec_prev, w.meta))
                w.append(*payload[:8], fec=fec_bytes)

        for k, start in enumerate(range(0, s, chunk)):
            ts_k = scales[k] if cbr else threshold_scale
            if gate is not None and gate[k]:
                if pending is not None:
                    flush_pending()
                    pending = None
                # digital silence records level 0: decodes to silence
                w.append_silent(chunk_blocks, levels[k] * (levels[k] > 1e-12))
                # both ends take the gated span as zeros: reset the overlap
                # carry and drop the post-masking context
                carry = streaming.mdct_stream_init(mdct, 1, c)
                tctx = None
                continue
            with _span("stream.step"):
                x_k = x[:, start:start + chunk].to(dev, non_blocking=True)
                carry, tctx, enc, fecq = _encode_step(
                    codec, carry, x_k, drown, ts_k, ms, deadzone,
                    fec_mult=fec, codec_fec=codec_fec, tmask_context=tctx,
                    **features,
                )
                payload, event = _to_host(
                    (enc.codes, enc.bark16, enc.tns_idx, enc.nf_levels,
                     None, enc.bs_flags, enc.bwe_gains, enc.is_gains)
                    + (tuple(fecq) if fecq is not None else ()))
            payload[4] = ts_k if cbr else None
            if pending is not None:
                flush_pending()
            pending = (payload, event, prev_coarse)
            if fec:
                prev_coarse = (payload[8], payload[9], ts_k * fec)
        if pending is not None:
            flush_pending()
        ts_last = scales[-1] if cbr else threshold_scale
        # the flush frame: the carried block's tail-out
        last = codec.encode_frames(
            streaming.mdct_stream_flush(mdct, carry), drown,
            threshold_scale=ts_last, ms=ms, deadzone=deadzone,
            tmask_context=tctx, **features)
        fec_last = None
        if fec:
            # the flush chunk carries the LAST body chunk's redundancy
            fec_last = (b"" if prev_coarse is None
                        else pack_fec_member(*prev_coarse, w.meta))
        w.append(last.codes, last.bark16, last.tns_idx, last.nf_levels,
                 tscale=ts_last if cbr else None,
                 bs_flags=last.bs_flags, bwe_gains=last.bwe_gains,
                 is_gains=last.is_gains, fec=fec_last)
        n_chunks = len(w._index)
    return n_chunks


def encode_stream_with_target_bitrate(
    codec, x, path, chunk_blocks: int = 256, *,
    target_kbps: float, drown=0.0, ms: bool = False,
    sample_chunks: int = 8, tolerance: float = 0.08,
    log2_scale_range=(-4.0, 10.0), deadzone="auto", tns: bool = False,
    nf: bool = False, tmask: float = 0.0, bs: bool = False,
    bwe: bool = False, intensity: bool = False, fec: float = 0.0,
    orig_samples: int = 0, lufs=None,
):
    """Rate-controlled stream encode (ABR): ONE stream-global threshold
    scale, picked by rate.py's batched trial search on a strided sample of
    the chunks, then the whole stream encoded with it (the header records
    it). If the file's rate is still off by more than ``tolerance`` (the
    stream's framing subtracted), up to three corrective re-encodes follow
    the measured size/scale curve, plus one re-encode of the best attempt
    if the last was not it. The returned kbps is the file's.

    :return: (n_chunks, threshold_scale, measured_kbps).
    """
    n = codec.mdct.filters_n
    chunk = chunk_blocks * n
    s = x.shape[1]
    seconds = s / codec.psycho.sample_rate
    n_chunks_est = s // chunk + 1  # + the flush chunk
    # fixed framing: magic + header, 16 B a chunk, the 8 B index, trailer
    overhead_bytes = 300 + 24 * n_chunks_est + 16
    overhead_kbps = overhead_bytes * 8 / seconds / 1000
    payload_target = max(0.5, target_kbps - overhead_kbps)

    take = min(max(1, sample_chunks), max(1, s // chunk))
    starts = np.linspace(0, s // chunk - 1, take).astype(int) * chunk
    sample = torch.cat([x[:, st:st + chunk] for st in starts],
                       dim=1).to(_device(codec))

    # one dead zone for the sampled search, every full pass and the header
    z = _rate.resolve_deadzone(deadzone, target_kbps, x.shape[-1],
                               codec.psycho.sample_rate)

    def search(tgt):
        # trials skip the fill levels (~1 deflated byte a frame); bwe gains
        # ride every trial (rate.py)
        return _rate.encode_with_target_bitrate(
            codec, sample, tgt, drown=drown, ms=ms, deadzone=z, tns=tns,
            tmask=tmask, bs=bs, bwe=bwe, intensity=intensity,
        ).threshold_scale

    def full_encode(scale):
        # fec rides every full pass: the measured kbps includes it
        n_chunks = encode_stream(
            codec, x, path, chunk_blocks=chunk_blocks, drown=drown, ms=ms,
            threshold_scale=scale, deadzone=z, tns=tns, nf=nf,
            tmask=tmask, bs=bs, bwe=bwe, intensity=intensity, fec=fec,
            orig_samples=orig_samples, lufs=lufs,
        )
        return n_chunks, os.path.getsize(path) * 8 / seconds / 1000

    # the sampled curve's scale first, then (off target only) secant steps
    # on the file itself: payload bits are locally linear in log2(scale)
    scale = search(payload_target)
    n_chunks, kbps = full_encode(scale)
    attempts = [(scale, kbps, n_chunks)]
    while (abs(kbps - target_kbps) > tolerance * target_kbps
           and len(attempts) < 4):
        payload = max(kbps - overhead_kbps, 0.25)
        want = max(target_kbps - overhead_kbps, 0.25)
        if len(attempts) == 1:
            # one-point correction through the sampled curve's shape
            scale = search(max(0.5, payload_target * want / payload))
        else:
            (s1, k1, _), (s2, k2, _) = attempts[-2], attempts[-1]
            p1 = max(k1 - overhead_kbps, 0.25)
            p2 = max(k2 - overhead_kbps, 0.25)
            if abs(np.log(p2 / p1)) < 1e-6:
                break  # at the entropy floor; no scale can help
            slope = (np.log2(s2) - np.log2(s1)) / np.log(p2 / p1)
            scale = float(2.0 ** (np.log2(s2) + slope * np.log(want / p2)))
            scale = min(max(scale, 2.0 ** log2_scale_range[0]),
                        2.0 ** log2_scale_range[1])
        n_chunks, kbps = full_encode(scale)
        attempts.append((scale, kbps, n_chunks))

    best = min(attempts, key=lambda a: abs(a[1] - target_kbps))
    if best is not attempts[-1]:
        scale = best[0]
        n_chunks, kbps = full_encode(scale)
    else:
        scale, kbps, n_chunks = best
    return n_chunks, scale, kbps


def encode_stream_cbr(
    codec, x, path, chunk_blocks: int = 256, *,
    target_kbps: float, drown=0.0, ms: bool = False,
    tolerance: float = 0.05, trials_per_round: int = 8,
    deadzone="auto", tns: bool = False, nf: bool = False,
    tmask: float = 0.0, bs: bool = False, bwe: bool = False,
    intensity: bool = False, fec: float = 0.0,
    orig_samples: int = 0, lufs=None, reservoir_kbits: float = 0.0,
):
    """Constant-bitrate stream encode: EVERY chunk is rate-controlled to its
    share of the target in one batched search (each chunk a clip of
    ``rate.encode_with_target_bitrate_batch``), then the stream is written
    with per-chunk scales on the wire (the ``cbr`` format).

    ``reservoir_kbits > 0`` turns on the bit reservoir: one ABR pass
    measures each chunk's bit demand at uniform quality,
    ``rate.reservoir_allocate`` moves budget toward hard chunks under a
    hard ``±reservoir_kbits`` bound on the running deviation from the
    constant-rate schedule, and the per-chunk search converges each chunk
    to its own target. The wire format is unchanged.

    The search encodes each chunk as an independent clip, the stream with
    the streaming MDCT, so a chunk's size can differ from its searched
    size by about one frame's codes; up to four corrective re-searches
    close that bias on the measured wire sizes.

    :return: (n_chunks, per-chunk scales list, measured whole-file kbps).
    """
    n = codec.mdct.filters_n
    chunk = chunk_blocks * n
    b, s, c = x.shape
    if b != 1:
        raise ValueError("encode_stream_cbr takes a single clip")
    if s % chunk != 0 or s == 0:
        raise ValueError(f"samples {s} must be a multiple of {chunk}")
    n_body = s // chunk
    sr = codec.psycho.sample_rate
    chunk_seconds = chunk / sr
    # per-chunk framing: 8 B scale + 16 B headers/CRC + 8 B index (+4 B a
    # member length), plus the stream header amortized
    overhead_bytes = (32 + (4 if tns else 0) + (4 if nf else 0)
                      + (4 if bwe else 0) + (4 if intensity else 0))
    overhead_kbps = (overhead_bytes + 350 / max(n_body, 1)) * 8 / (
        chunk_seconds * 1000
    )
    payload_target = max(0.5, target_kbps - overhead_kbps)

    z = _rate.resolve_deadzone(deadzone, target_kbps, c, sr)
    chunks_x = x[0].reshape(n_body, chunk, c).to(_device(codec))
    # the searched clips carry a fixed .acz overhead (~350 B of members)
    # that the stream never ships: measure it on an all-zero pack of the
    # clips' shape and aim each search above its payload target by it
    blocks_per_clip = chunk_blocks + 1
    empty = _bitstream.pack(
        np.zeros((1, blocks_per_clip, n, c), np.int32),
        torch.zeros((1, blocks_per_clip, codec.psycho.bark_bands_n,
                     1 if ms else c), dtype=torch.bfloat16),
        sample_rate=sr, filters_n=n,
        bark_bands_n=codec.psycho.bark_bands_n,
        alpha=codec.psycho.alpha, window_type=codec.mdct.window_type,
        ms=ms,
    )
    acz_overhead_kbps = len(empty) * 8 / chunk_seconds / 1000

    def search_and_encode(clip_targets):
        # ``tolerance`` is payload-relative: shrink the clip-space one by
        # the payload's share of a clip's size
        tol_clip = max(2e-3, tolerance * payload_target
                       / (payload_target + acz_overhead_kbps))
        results = _rate.encode_with_target_bitrate_batch(
            codec, chunks_x, clip_targets,
            drown=drown, tolerance=tol_clip,
            trials_per_round=trials_per_round,
            ms=ms, deadzone=z, tns=tns, tmask=tmask, bs=bs, bwe=bwe,
            intensity=intensity,
        )
        sc_list = [r.threshold_scale for r in results]
        n_ch = encode_stream(
            codec, x, path, chunk_blocks=chunk_blocks, drown=drown, ms=ms,
            threshold_scale=sc_list, deadzone=z, tns=tns, nf=nf,
            tmask=tmask, bs=bs, bwe=bwe, intensity=intensity, fec=fec,
            orig_samples=orig_samples, lufs=lufs,
        )
        kbps_out = os.path.getsize(path) * 8 / (s / sr) / 1000
        chosen = np.array([r.kbps for r in results])
        return n_ch, sc_list, kbps_out, chosen

    demand_bits = None
    if reservoir_kbits < 0 or not np.isfinite(reservoir_kbits):
        raise ValueError(
            f"reservoir_kbits must be finite and >= 0: {reservoir_kbits}"
        )
    if reservoir_kbits > 0.0 and n_body > 1:
        # the demand profile: the per-chunk wire sizes of ONE ABR pass at
        # the same target, dead zone and ladder (framing, sidecar and fec
        # included), read back from the stream index
        encode_stream_with_target_bitrate(
            codec, x, path, chunk_blocks=chunk_blocks,
            target_kbps=target_kbps, drown=drown, ms=ms, deadzone=z,
            tns=tns, nf=nf, tmask=tmask, bs=bs, bwe=bwe,
            intensity=intensity, fec=fec,
        )
        with StreamReader(path) as r:
            demand_bits = np.array(
                [r.chunk_bytes(i) * 8.0 for i in range(n_body)]
            )

    budget_bits = payload_target * 1000.0 * chunk_seconds * n_body
    floor_bits = 0.5 * 1000.0 * chunk_seconds
    # the desired per-chunk payload bits: equal shares, or the reservoir's
    # demand-weighted split of the same budget (which also enforces the
    # floor)
    if demand_bits is None:
        desired_bits = np.full(n_body,
                               payload_target * chunk_seconds * 1000.0)
    else:
        desired_bits = _rate.reservoir_allocate(
            demand_bits, budget_bits, reservoir_kbits * 1000.0,
            floor=floor_bits,
        )
    want_wire = desired_bits + overhead_bytes * 8.0

    def read_wire():
        with StreamReader(path) as r:
            return np.array([r.chunk_bytes(i) * 8.0 for i in range(n_body)])

    # the first pass aims each clip search at its payload plus the empty
    # container's overhead; corrective passes then run, per chunk, a secant
    # on the two latest (achieved clip kbps -> wire bits) points (the wire
    # size is affine in the clip size), or a ratio step with one point
    clip0 = np.maximum(0.5, desired_bits / (chunk_seconds * 1000.0)) + (
        acz_overhead_kbps)
    n_chunks, scales, kbps, chosen = search_and_encode(clip0)
    best = (abs(kbps - target_kbps), n_chunks, scales, kbps)
    prev_pt = None
    for _ in range(4):
        if abs(kbps - target_kbps) <= tolerance * target_kbps:
            break
        actual = read_wire()
        nxt = np.empty(n_body)
        for i in range(n_body):
            if (
                prev_pt is not None
                and abs(actual[i] - prev_pt[1][i]) > 1e-6
                and abs(chosen[i] - prev_pt[0][i]) > 1e-9
            ):
                slope = (chosen[i] - prev_pt[0][i]) / (
                    actual[i] - prev_pt[1][i]
                )
                step = (want_wire[i] - actual[i]) * slope
                # a negative slope is measurement noise (size is monotone
                # in rate): take the ratio step
                if slope > 0:
                    nxt[i] = chosen[i] + np.clip(step, -0.75 * chosen[i],
                                                 4.0 * chosen[i])
                    continue
            nxt[i] = chosen[i] * np.clip(want_wire[i] / actual[i], 0.25, 8.0)
        prev_pt = (chosen.copy(), actual)
        n_chunks, scales, kbps, chosen = search_and_encode(
            np.maximum(0.5, nxt))
        if abs(kbps - target_kbps) < best[0]:
            best = (abs(kbps - target_kbps), n_chunks, scales, kbps)
    # never ship a worse stream than the best pass: re-encode its scales
    if best[0] < abs(kbps - target_kbps):
        _, n_chunks, scales, kbps = best
        encode_stream(
            codec, x, path, chunk_blocks=chunk_blocks, drown=drown,
            ms=ms, threshold_scale=scales, deadzone=z, tns=tns, nf=nf,
            tmask=tmask, bs=bs, bwe=bwe, intensity=intensity, fec=fec,
            orig_samples=orig_samples, lufs=lufs,
        )
    return n_chunks, scales, kbps


def _dequant_frames(codec, codes, bark, tscale, ms, dzr=0.0,
                    tns=None, tns_bs=0,
                    nfl=None, nf_bs=0, nf_seed=0, frame_offset=0,
                    bsw=None, bwe=None, bwe_start=0,
                    isg=None, is_start=0):
    """A chunk's spectral frames [1, blocks, N, C] from its payload (device
    tensors without the batch axis), mirroring the encoder's threshold
    derivation exactly (mid/side min-channel sidecar, the scale, the TNS
    gain compensation, the block-switch pooling last) so the step sizes are
    bit-identical; then the dead-zone offset ``dzr``, the fills (bwe, the
    noise fill keyed by ``frame_offset`` + frame, intensity), the
    block-switch merge and the TNS inverse filter, all in the coded domain
    before the mid/side derotation."""
    dtype = codec.mdct.compute_dtype
    bark = bark[None]
    if ms:
        threshold = codec._ms_threshold(bark)
    else:
        threshold = codec.psycho.bark_intensity_to_threshold(bark.to(dtype))
    threshold = codec._scaled(threshold, tscale)
    if tns is not None:
        tns = tns[None]
        threshold = _tns.scaled_threshold(threshold, tns, tns_bs)
    if bsw is not None:
        bsw = bsw[None]
        threshold = _blockswitch.pool_threshold(threshold, bsw)
    delta = _quantize.step_size(threshold)
    codes = codes[None]
    spec = _quantize.dequantize(codes, delta, dtype=dtype, recon_offset=dzr)
    excl = None
    if isg is not None:
        excl = _intensity.owned_mask(codec.mdct.filters_n, is_start,
                                     codes.device)
    if bwe is not None:
        # copy-up before the noise fill, which it caps at the crossover
        spec = _bwe.fill(spec, codes, delta, bwe[None], bwe_start,
                         exclude=excl)
    if nfl is not None:
        spec = _nf.fill(spec, codes, delta, nfl[None], nf_bs, nf_seed,
                        frame_offset,
                        band_end=bwe_start if bwe is not None else None,
                        exclude=excl)
    if isg is not None:
        # with bwe the fill scales the bwe-reconstructed mid, the
        # reference the encoder projected onto
        mid_ref = None
        if bwe is not None:
            mid_ref = _intensity.mid_reference(
                codes, delta, dtype, bwe_gains=bwe[None],
                bwe_start=bwe_start, exclude=excl,
            )
        spec = _intensity.fill(spec, codes, delta, isg[None], is_start,
                               mid_ref=mid_ref)
    if bsw is not None:
        spec = _blockswitch.merge_spectrum(
            spec, bsw, precision=codec.mdct.dct_precision
        )
    if tns is not None:
        spec = _tns.filter_inverse(spec, tns, tns_bs)
    return codec.from_mid_side(spec) if ms else spec


def _signs(seed: int, chunk_idx: int, like, blocks: int):
    """Concealment's sign scramble: ``jax.random.rademacher`` under
    ``fold_in(key(seed), chunk_idx)``, [1, blocks, N, C] of ``like``'s
    dtype, drawn as the JAX package draws it for a stream of that dtype
    (float64 uniforms for float64 streams, whose decoder runs with x64)."""
    k = _threefry.fold_in(_threefry.key(seed),
                          torch.tensor(chunk_idx, device=like.device))
    return _threefry.rademacher(k, (1, blocks, *like.shape[2:]), like.dtype,
                                x64=like.dtype == torch.float64)


def _conceal_step(codec, carry, prev_frame, decay_pows, chunk_idx):
    """Concealment of an unreadable chunk: the last good spectral frame
    repeated with an exponential energy fade (``decay_pows`` [blocks]) and
    per-frame sign scrambling keyed by the chunk index (the AAC-family
    recipe: the magnitudes keep the timbre, random signs turn a frozen
    frame's buzz into noise of the same envelope)."""
    signs = _signs(_CONCEAL_KEY, chunk_idx, prev_frame, decay_pows.shape[0])
    frames = prev_frame * decay_pows[None, :, None, None] * signs
    carry, samples = streaming.imdct_stream_step(codec.mdct, carry, frames)
    return carry, samples, frames[:, -1:]


def _conceal_interp_step(codec, carry, prev_frame, next_frame, weights,
                         chunk_idx):
    """Interpolative concealment, when the NEXT chunk is in hand: a per-bin
    energy crossfade sqrt((1-w) prev^2 + w next^2) between the good
    neighbours with scrambled signs, ``weights`` [blocks] ramping 0 -> 1."""
    signs = _signs(_INTERP_KEY, chunk_idx, prev_frame, weights.shape[0])
    w = weights[None, :, None, None]
    mag = torch.sqrt((1.0 - w) * torch.square(prev_frame)
                     + w * torch.square(next_frame))
    frames = mag * signs
    carry, samples = streaming.imdct_stream_step(codec.mdct, carry, frames)
    return carry, samples, frames[:, -1:]


def _staged(c: Chunk, pin: bool) -> dict:
    """A chunk's arrays as host tensors, in pinned memory when ``pin`` (so
    the copies to the card can run without blocking the host)."""
    out = {}
    for name in ("codes", "bark", "tns", "nfl", "bsw", "bwe", "isg"):
        a = getattr(c, name)
        if a is not None:
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(a if a.flags.writeable else a.copy())
            if pin:
                a = a.pin_memory()
        out[name] = a
    return out


@torch.no_grad()
def decode_stream(codec, path, start_chunk: int = 0,
                  conceal: bool = False, conceal_decay: float = 0.8):
    """Generator of waveform chunks [1, samples, C] on the codec's device,
    from an .acs stream (seekable).

    Starting mid-stream needs only the previous chunk's last frame for the
    overlap-add carry; the first yielded chunk is then sample-exact.

    :param conceal: packet-loss concealment: a chunk that fails its CRC (or
        is otherwise unreadable) is synthesized instead of raising. On fec
        streams the lost chunk is REBUILT from the coarse copy riding its
        successor; otherwise the last good spectral frame repeats with an
        exponential energy fade (``conceal_decay`` a frame), or crossfades
        into the next good chunk when it is already in hand. Decoding
        recovers exactly at the next good chunk. Without it, corruption
        raises ValueError.
    """
    mdct = codec.mdct
    dev = _device(codec)
    pin = dev.type == "cuda"
    with StreamReader(path) as r:
        ch = r.meta["channels"]
        ms = bool(r.meta.get("ms", False))
        tscale = float(r.meta.get("threshold_scale", 1.0))
        dzr = float(r.meta.get("dzr", 0.0))
        tns_meta = r.meta.get("tns")
        nf_meta = r.meta.get("nf")
        bwe_meta = r.meta.get("bwe")
        is_meta = r.meta.get("isf")
        fixed = dict(
            ms=ms, dzr=dzr,
            tns_bs=int(tns_meta["band_start"]) if tns_meta else 0,
            nf_bs=int(nf_meta["band_start"]) if nf_meta else 0,
            nf_seed=int(nf_meta["seed"]) if nf_meta else 0,
            bwe_start=int(bwe_meta["start"]) if bwe_meta else 0,
            is_start=int(is_meta["start"]) if is_meta else 0,
        )
        dtype = mdct.compute_dtype
        n = r.meta["filters_n"]
        prev_frame = torch.zeros((1, 1, n, ch), dtype=dtype, device=dev)

        def frames_of(c, staged, frame_offset):
            d = {k: None if v is None else v.to(dev, non_blocking=True)
                 for k, v in staged.items()}
            return _dequant_frames(
                codec, d["codes"], d["bark"],
                tscale if c.tscale is None else c.tscale,
                tns=d["tns"], nfl=d["nfl"], frame_offset=frame_offset,
                bsw=d["bsw"], bwe=d["bwe"], isg=d["isg"], **fixed,
            )

        modal = []

        def chunk_blocks_guess(i):
            """Frames to conceal for an unreadable chunk i: the modal body
            size, or 1 for the flush chunk."""
            if i == r.n_chunks - 1:
                return 1
            if not modal:
                modal.append(modal_body_blocks(r))
            return modal[0]

        # the global index of each chunk's first frame keys the noise fill;
        # under conceal the headers are untrusted, so the prefix sum uses
        # the modal body size
        frame_off = 0
        if nf_meta and start_chunk:
            if conceal:
                frame_off = start_chunk * chunk_blocks_guess(0)
            else:
                frame_off = sum(r.chunk_blocks(j)
                                for j in range(start_chunk))
        carry = streaming.imdct_stream_init(mdct, 1, ch)
        # one-deep read-ahead: chunk i+1's parse (CRC, Rice decode) and
        # staging in pinned memory run in a worker thread while the card
        # works on chunk i; the file handle is shared, so every file
        # access holds one lock
        io_lock = threading.Lock()

        def fetch(i):
            with _span("stream.read"):
                try:
                    with io_lock:
                        c = r.read_chunk(i)
                except ValueError as e:
                    return "err", e, None
                return "ok", c, _staged(c, pin)

        if start_chunk > 0:
            status, val, staged = fetch(start_chunk - 1)
            if status == "err" and not conceal:
                raise val
            if status == "ok":
                prev_frame = frames_of(val, staged, frame_off
                                       - val.codes.shape[0])[:, -1:]
                # the carry is the previous raw frame (streaming.py)
                carry = prev_frame[:, 0].transpose(1, 2)
            # else: prime with silence; recovery at start_chunk
        ex = ThreadPoolExecutor(max_workers=1)
        try:
            fut = (ex.submit(fetch, start_chunk)
                   if start_chunk < r.n_chunks else None)
            for i in range(start_chunk, r.n_chunks):
                status, val, staged = fut.result()
                if i + 1 < r.n_chunks:
                    fut = ex.submit(fetch, i + 1)
                if status == "err":
                    if not conceal:
                        raise val
                    with io_lock:
                        blocks = chunk_blocks_guess(i)
                    nxt = None
                    if i + 1 < r.n_chunks:
                        n_status, n_val, n_staged = fut.result()
                        if n_status == "ok":
                            nxt = n_val
                    # FEC first: the successor carries a coarse plain copy
                    # of THIS chunk, decoded with the features off
                    fdec = None
                    if nxt is not None and nxt.fec is not None:
                        try:
                            fdec = parse_fec_member(nxt.fec, r.meta)
                        except ValueError:
                            fdec = None  # version skew or garbage
                    if fdec is not None:
                        fcodes, fbark, fscale = fdec
                        frames = _dequant_frames(
                            codec, torch.from_numpy(fcodes).to(dev),
                            fbark.to(dev), fscale, ms, dzr,
                            nf_seed=fixed["nf_seed"], frame_offset=frame_off)
                        carry, samples = streaming.imdct_stream_step(
                            mdct, carry, frames)
                        prev_frame = frames[:, -1:]
                        frame_off += fcodes.shape[0]
                        yield samples
                        continue
                    if nxt is not None:
                        # both neighbours in hand: morph the envelope into
                        # what follows
                        nfr = frames_of(nxt, n_staged,
                                        frame_off + blocks)[:, :1]
                        weights = torch.from_numpy(
                            np.arange(1, blocks + 1) / (blocks + 1)
                        ).to(device=dev, dtype=dtype)
                        carry, samples, prev_frame = _conceal_interp_step(
                            codec, carry, prev_frame, nfr, weights, i)
                    else:
                        decay_pows = torch.from_numpy(
                            conceal_decay ** np.arange(1, blocks + 1)
                        ).to(device=dev, dtype=dtype)
                        carry, samples, prev_frame = _conceal_step(
                            codec, carry, prev_frame, decay_pows, i)
                    frame_off += blocks
                    yield samples
                    continue
                c = val
                with _span("stream.step"):
                    frames = frames_of(c, staged, frame_off)
                    carry, samples = streaming.imdct_stream_step(
                        mdct, carry, frames)
                prev_frame = frames[:, -1:]
                if c.silent is not None and float(np.max(c.silent)) > 0:
                    # DTX comfort noise: flat Gaussian at the recorded
                    # per-channel RMS, keyed by the chunk index so seeks
                    # reproduce it, added after the (zero-spectrum) step so
                    # the previous chunk's window tail still rings out
                    cn = np.random.default_rng(_COMFORT_SEED + i)
                    noise = (cn.standard_normal(
                        (1, samples.shape[1], ch)).astype(np.float32)
                        * c.silent[None, None, :])
                    samples = samples + torch.from_numpy(noise).to(
                        device=dev, dtype=dtype)
                frame_off += c.codes.shape[0]
                yield samples
            yield streaming.imdct_stream_flush(mdct, carry)
        finally:
            ex.shutdown(wait=False)
