"""Plain readers of the program's containers, from docs/FORMATS.md.

Rice and run-length Rice ("rrice") payloads are decoded here in Python:
MSB-first bits, groups of 256 values, a 4-bit parameter k a group (rrice:
then a mode bit), zigzag-mapped values, quotients of 48 escaping to 32 raw
bits; rrice's mode 1 alternates Elias-gamma zero runs (run + 1) with Rice
magnitudes (zigzag - 1). ``.acz`` is a numpy ``.npz``; ``.acs`` is a chunk
stream with CRCs, an index and a trailer. Every reader raises ValueError on
anything it cannot parse.
"""

from __future__ import annotations

import io
import json
import struct
import zlib

import numpy as np

GROUP = 256
ESCAPE = 48


def _bits(data: bytes) -> str:
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8)).tobytes() \
        .translate(bytes.maketrans(b"\x00\x01", b"01")).decode("ascii")


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def rice_decode(data: bytes, n: int, rle: bool) -> np.ndarray:
    """The first ``n`` int32 values of a rice (``rle`` False) or rrice
    payload."""
    s = _bits(data)
    end = len(s)
    out = np.zeros(n, dtype=np.int64)
    p = 0

    def take(p, k):
        if p + k > end:
            raise ValueError("rice payload truncated")
        return (int(s[p:p + k], 2) if k else 0), p + k

    def rice(p, k):
        z = s.find("0", p, min(p + ESCAPE + 1, end))
        if z < 0:
            if end - p > ESCAPE:  # 49 or more ones: not a codeword
                raise ValueError("rice quotient beyond the escape")
            raise ValueError("rice payload truncated")
        q = z - p
        if q == ESCAPE:
            return take(z + 1, 32)
        r, p = take(z + 1, k)
        return (q << k) | r, p

    i = 0
    while i < n:
        g_end = min(i + GROUP, n)
        k, p = take(p, 4)
        mode = 0
        if rle:
            mode, p = take(p, 1)
        if mode == 0:
            while i < g_end:
                u, p = rice(p, k)
                out[i] = _unzigzag(u)
                i += 1
            continue
        while i < g_end:
            z = s.find("1", p, end)
            if z < 0 or z - p > 31:
                raise ValueError("bad zero-run length")
            run, p = take(z, z - p + 1)
            run -= 1
            if run > g_end - i:
                raise ValueError("zero run past its group")
            i += run
            if i < g_end:
                um1, p = rice(p, k)
                out[i] = _unzigzag(um1 + 1)
                i += 1
    if (out > np.iinfo(np.int32).max).any() or (
            out < np.iinfo(np.int32).min).any():
        raise ValueError("value outside int32")
    return out.astype(np.int32)


def int2d(data: bytes, shape, block_axis: int) -> np.ndarray:
    """A 2-D delta + rrice coded integer field (the sidecar levels)."""
    d = rice_decode(data, int(np.prod(shape)), True).astype(np.int64)
    d = d.reshape(shape)
    return np.cumsum(np.cumsum(d, axis=block_axis + 1), axis=block_axis)


# -- .acz ---------------------------------------------------------------------


def read_acz(data: bytes, expect: dict, decode: bool = True) -> dict:
    """Parse one ``.acz`` of the plain configuration ``expect`` (a
    ``configs/*.json`` dict) -> {shape, codes [B, T, N, C] int32, levels
    [B, T, bands, C] int64, nsamp or None}; without ``decode`` the members
    are checked but the payloads not decoded (codes and levels None)."""
    try:
        z = np.load(io.BytesIO(data), allow_pickle=False)
        members = {k: z[k] for k in z.files}
    except Exception as e:  # zipfile/npy errors of a damaged container
        raise ValueError(f"not an npz container: {e}") from e
    n, bands = int(expect["filters_n"]), int(expect["bark_bands_n"])
    ch = int(expect["channels"])
    meta = [int(v) for v in members.get("meta", [])]
    if meta != [int(expect["sample_rate"]), n, bands, ch]:
        raise ValueError(f"meta {meta}")
    want = {"dtype": "float32", "barkprec": expect["dct_precision"],
            "window": expect["window_type"]}
    for key, value in want.items():
        if str(members[key][0]) != value:
            raise ValueError(f"{key} {members[key]!r}")
    if int(members["ms"][0]) != 0 or float(members["tscale"][0]) != 1.0:
        raise ValueError("ms or threshold scale set")
    if float(members["alphaw"][0]) != float(expect["alpha"]):
        raise ValueError("alpha")
    extra = {"tns", "nfl", "bsw", "bwe", "isg", "dzr"} & set(members)
    if extra:
        raise ValueError(f"feature members {sorted(extra)}")
    coders = {"rice", "rrice"} & set(members)
    if len(coders) != 1 or int(members["scq"][0]) != int(
            expect["sidecar_grid"]):
        raise ValueError("not a rice or rrice + scq container")
    coder = coders.pop()
    shape = tuple(int(v) for v in members["shape"])
    bshape = tuple(int(v) for v in members["bark_shape"])
    if len(shape) != 4 or shape[2:] != (n, ch) or bshape != (
            shape[0], shape[1], bands, ch):
        raise ValueError(f"shapes {shape} {bshape}")
    nsamp = int(members["nsamp"][0]) if "nsamp" in members else None
    if not decode:
        return {"shape": shape, "codes": None, "levels": None,
                "nsamp": nsamp}
    codes = rice_decode(members[coder].tobytes(), int(np.prod(shape)),
                        coder == "rrice").reshape(shape)
    levels = int2d(members["bark_lvl"].tobytes(), bshape, 1)
    return {"shape": shape, "codes": codes, "levels": levels,
            "nsamp": nsamp}


# -- .acs ---------------------------------------------------------------------


class Stream:
    """A ``.acs`` stream of the plain configuration: header, index and
    trailer checked, every chunk's CRC checked on open."""

    def __init__(self, path, expect: dict):
        with open(path, "rb") as f:
            self.data = data = f.read()
        if data[:4] != b"ACS2":
            raise ValueError(f"magic {data[:4]!r}")
        (hlen,) = struct.unpack_from("<I", data, 4)
        self.meta = meta = json.loads(data[8:8 + hlen])
        want = dict(sample_rate=int(expect["sample_rate"]),
                    filters_n=int(expect["filters_n"]),
                    bark_bands_n=int(expect["bark_bands_n"]),
                    alpha=float(expect["alpha"]),
                    window_type=expect["window_type"],
                    channels=int(expect["channels"]),
                    compute_dtype="float32", ms=False, threshold_scale=1.0,
                    bark_precision=expect["dct_precision"], coder="rrice",
                    hcrc=1, scq=int(expect["sidecar_grid"]))
        for key, value in want.items():
            if meta.get(key) != value:
                raise ValueError(f"header {key}={meta.get(key)!r}")
        extra = set(meta) - set(want) - {"nsamp"}
        if extra:
            raise ValueError(f"header declares {sorted(extra)}")
        count, index_off = struct.unpack_from("<QQ", data, len(data) - 16)
        if index_off + 8 * count + 16 != len(data):
            raise ValueError("index/trailer do not close the file")
        self.offsets = list(struct.unpack_from(f"<{count}Q", data,
                                               index_off))
        self.chunks = []  # (blocks, codes bytes, bark bytes)
        pos = 8 + hlen
        for off in self.offsets:
            if off != pos:
                raise ValueError(f"index offset {off} != chunk at {pos}")
            # u32 blocks | u32 codes_len | codes | u32 bark_len | bark | crc
            blocks, clen = struct.unpack_from("<II", data, off)
            bark_hdr = off + 8 + clen
            (blen,) = struct.unpack_from("<I", data, bark_hdr)
            codes = data[off + 8:bark_hdr]
            bark = data[bark_hdr + 4:bark_hdr + 4 + blen]
            pos = bark_hdr + 4 + blen
            (crc,) = struct.unpack_from("<I", data, pos)
            pos += 4
            # the CRC chains each length field and its payload, in order
            want_crc = zlib.crc32(data[off:off + 8])
            want_crc = zlib.crc32(codes, want_crc)
            want_crc = zlib.crc32(data[bark_hdr:bark_hdr + 4], want_crc)
            want_crc = zlib.crc32(bark, want_crc)
            if crc != want_crc or len(codes) != clen or len(bark) != blen:
                raise ValueError(f"chunk at {off}: CRC or length")
            self.chunks.append((blocks, codes, bark))
        if pos != index_off:
            raise ValueError("bytes between the last chunk and the index")

    def blocks(self) -> list:
        return [c[0] for c in self.chunks]

    def chunk(self, i: int):
        """(codes [blocks, N, C] int32, levels [blocks, bands, C])."""
        blocks, codes, bark = self.chunks[i]
        n, ch = self.meta["filters_n"], self.meta["channels"]
        bands = self.meta["bark_bands_n"]
        c = rice_decode(codes, blocks * n * ch, True).reshape(blocks, n, ch)
        return c, int2d(bark, (blocks, bands, ch), 0)
