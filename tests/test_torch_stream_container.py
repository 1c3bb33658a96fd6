"""The port's ``.acs`` stream container
(``audiocodec_tpu_torch.io.stream_container``) held against the JAX package
on the CPU, at N=256, 16 kHz, 16 Bark bands, chunks of 4 blocks.

- At float64 (exact payloads) ``encode_stream`` writes the JAX package's
  bytes: plain (with gapless length and loudness tags), the full feature
  ladder with temporal masking, FEC, DTX, and CBR with per-chunk scales;
  so do ABR (``encode_stream_with_target_bitrate``: the same scale) and
  CBR with the bit reservoir (``encode_stream_cbr``: the same scales,
  every chunk within the reservoir's excursion bound). Each package reads
  the other's files chunk for chunk.
- ``decode_stream`` of a JAX-written stream matches the JAX decode within
  1e-12 at float64 (1e-6 with TNS: jitted XLA fuses the TNS step-up into
  FMAs), for a full decode, seeks (and a seek equals the full decode's
  samples bit for bit), FEC rebuilds, both concealment modes (also at
  float32 within 1e-5, where the JAX side runs with x64 off as its CLI
  does, so the sign scramble draws float32 uniforms) and DTX comfort noise.
- The reader refuses the same tampered inputs as the JAX reader, with the
  same exception type.
- The ``cbr_stream.acs`` golden vector decodes to its codes' sha256 and
  within 4 LSB of its PCM.
"""

import hashlib
import io
import json
import os
import shutil
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu.io import stream_container as jsc
from audiocodec_tpu_torch import Codec
from audiocodec_tpu_torch.io import bitstream
from audiocodec_tpu_torch.io import stream_container as sc

torch.set_num_threads(1)

SR, N, BARK, CB = 16000, 256, 16, 4
VEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
# name -> (channels, encode_stream keywords)
CASES = {
    "plain": (1, dict(orig_samples=16 * N - 5, lufs=-23.0)),
    "ladder": (2, dict(ms=True, tns=True, nf=True, nf_seed=2**31 + 9,
                       tmask=130.0, bs=True, bwe=True, intensity=True,
                       deadzone=1.0)),
    "fec": (2, dict(ms=True, fec=4.0)),
    "dtx": (2, dict(dtx=-60.0)),
    "cbr": (1, dict(threshold_scale=[1.0, 4.0, 2.0, 8.0], bs=True)),
}
DECODE_ATOL = {"ladder": 1e-6}


def signal(ch, blocks=16, seed=0, dtype=np.float64):
    """Tones over noise with an impulse (TNS and block switching fire);
    built as float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * N) / SR
    x = (0.3 * np.sin(2 * np.pi * 440 * t)[:, None]
         + 0.02 * np.sin(2 * np.pi * 6000 * t)[:, None]
         + 0.03 * rng.normal(size=(blocks * N, ch)))
    x[9 * N + 40] += 0.9
    x[10 * N:10 * N + N // 2] *= 0.01
    if ch == 2:
        x[:, 1] = 0.8 * x[:, 0] + 0.01 * rng.normal(size=blocks * N)
    return np.clip(x, -1, 1).astype(np.float32).astype(dtype)[None]


def dtx_signal(dtype=np.float64):
    """Chunks 1-2 digital silence (chunk 1 coded: the gate's hangover;
    chunk 2 a silent record of level 0), chunk 3 a -100 dBFS noise floor
    (a silent record of comfort noise)."""
    x = signal(2, dtype=dtype)
    x[:, CB * N:] = 0.0
    x[:, 3 * CB * N:] += (1e-5 * np.random.default_rng(3).normal(
        size=(CB * N, 2))).astype(np.float32)
    return x


def inputs(case, dtype=np.float64):
    return dtx_signal(dtype) if case == "dtx" else signal(CASES[case][0],
                                                          dtype=dtype)


def make_codecs(dtype):
    return (JaxCodec.create(SR, filters_n=N, bark_bands_n=BARK,
                            compute_dtype=getattr(jnp, dtype),
                            use_pallas=False),
            Codec.create(SR, filters_n=N, bark_bands_n=BARK,
                         compute_dtype=dtype, device="cpu"))


@pytest.fixture(scope="module")
def codecs():
    return make_codecs("float64")


@pytest.fixture(scope="module")
def streams(codecs, tmp_path_factory):
    """case -> (JAX file, port file) at float64."""
    jc, tc = codecs
    d = tmp_path_factory.mktemp("acs")
    out = {}
    for case, (_, kw) in CASES.items():
        x = inputs(case)
        pj, pt = str(d / f"{case}.j.acs"), str(d / f"{case}.t.acs")
        nj = jsc.encode_stream(jc, jnp.asarray(x), pj, chunk_blocks=CB, **kw)
        nt = sc.encode_stream(tc, torch.from_numpy(x), pt, chunk_blocks=CB,
                              **kw)
        assert nj == nt == 5
        out[case] = (pj, pt)
    return out


def jax_decode(codec, path, **kw):
    return np.concatenate(
        [np.asarray(c) for c in jsc.decode_stream(codec, path, **kw)], axis=1)


def port_decode(codec, path, **kw):
    out = torch.cat(list(sc.decode_stream(codec, path, **kw)), dim=1)
    assert out.dtype == codec.mdct.compute_dtype
    return out.numpy()


def bits(bark):
    return bitstream.bf16_bits(bark)


@pytest.mark.parametrize("case", sorted(CASES))
def test_files_equal_jax_and_cross_read(streams, case):
    pj, pt = streams[case]
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file, chunk for chunk
    with jsc.StreamReader(pt) as rj, sc.StreamReader(pj) as rt:
        assert rt.meta == rj.meta
        assert rt.n_chunks == rj.n_chunks == 5
        assert sc.modal_body_blocks(rt) == jsc.modal_body_blocks(rj) == CB
        for i in range(rt.n_chunks):
            assert rt.chunk_blocks(i) == rj.chunk_blocks(i)
            assert rt.chunk_bytes(i) == rj.chunk_bytes(i)
            a, b = rt.read_chunk(i), rj.read_chunk(i)
            assert a.codes.dtype == np.int32
            np.testing.assert_array_equal(a.codes, b.codes)
            assert a.bark.dtype == torch.bfloat16
            np.testing.assert_array_equal(bits(a.bark), bits(b.bark))
            for name in ("tns", "nfl", "bsw", "bwe", "isg", "silent"):
                u, v = getattr(a, name), getattr(b, name)
                assert (u is None) == (v is None), name
                if u is not None:
                    assert u.dtype == np.asarray(v).dtype, name
                    np.testing.assert_array_equal(u, v, err_msg=name)
            assert a.tscale == b.tscale and a.fec == b.fec


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_jax(codecs, streams, case):
    jc, tc = codecs
    pj = streams[case][0]
    atol = DECODE_ATOL.get(case, 1e-12)
    want = jax_decode(jc, pj)
    got = port_decode(tc, pj)
    assert got.shape == want.shape == (1, 18 * N, CASES[case][0])
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if case == "dtx":
        # chunk 2 decodes to silence, chunk 3 to comfort noise
        assert np.abs(got[:, 2 * CB * N:3 * CB * N]).max() == 0.0
        assert 0 < np.abs(got[:, 3 * CB * N:4 * CB * N]).max() < 1e-3
    # a seek equals the full decode's samples from that chunk, bit for bit
    for k in (1, 3):
        seek = port_decode(tc, pj, start_chunk=k)
        np.testing.assert_array_equal(seek, got[:, k * CB * N:])
    np.testing.assert_allclose(seek, jax_decode(jc, pj, start_chunk=3),
                               rtol=0, atol=atol)


def corrupt(src, dst, *chunks):
    """A copy of ``src`` with one byte of each chunk's codes flipped."""
    shutil.copy(src, dst)
    with sc.StreamReader(dst) as r:
        offs = [r._index[i] for i in chunks]
    with open(dst, "r+b") as f:
        for off in offs:
            f.seek(off + 12)
            b = f.read(1)
            f.seek(off + 12)
            f.write(bytes([b[0] ^ 0xFF]))


# mode -> (fec multiplier, lost chunks): the FEC rebuild; interpolation
# (the next chunk in hand); extrapolation (two losses: the first has no
# good successor), then interpolation into chunk 3
CONCEAL = {"fec": (4.0, (2,)), "interpolate": (0.0, (1,)),
           "extrapolate": (0.0, (1, 2))}


@pytest.mark.parametrize("mode", sorted(CONCEAL))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_conceal_matches_jax(tmp_path, dtype, mode):
    jc, tc = make_codecs(dtype)
    fec, lost = CONCEAL[mode]
    x = signal(2, dtype=np.dtype(dtype))
    src, bad = str(tmp_path / "a.acs"), str(tmp_path / "b.acs")
    sc.encode_stream(tc, torch.from_numpy(x), src, chunk_blocks=CB, ms=True,
                     fec=fec)
    corrupt(src, bad, *lost)
    with pytest.raises(ValueError, match="CRC"):
        port_decode(tc, bad)
    with jax.enable_x64(dtype == "float64"):
        want = jax_decode(jc, bad, conceal=True)
        seek = jax_decode(jc, bad, conceal=True, start_chunk=2)
    got = port_decode(tc, bad, conceal=True)
    atol = 1e-12 if dtype == "float64" else 1e-5
    assert got.shape == want.shape == (1, 18 * N, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(port_decode(tc, bad, conceal=True,
                                           start_chunk=2), seek, rtol=0,
                               atol=atol)
    # the concealed span is not silence, and the good chunks are exact
    span = slice(lost[0] * CB * N + N, (lost[-1] + 1) * CB * N)
    assert np.abs(got[:, span]).max() > 1e-3
    clean = port_decode(tc, src)
    tail = (lost[-1] + 2) * CB * N
    np.testing.assert_array_equal(got[:, tail:], clean[:, tail:])


def verse_chorus(chunks=6):
    """Quiet tone chunks alternating with dense harmonic stacks."""
    seg = CB * N
    t = np.arange(chunks * seg) / SR
    x = 0.04 * np.sin(2 * np.pi * 330 * t)
    for i in range(1, chunks, 2):
        sl = slice(i * seg, (i + 1) * seg)
        for k, f in enumerate([220, 440, 660, 880, 1320, 1980, 2640, 3520]):
            x[sl] += (0.25 / (1 + 0.35 * k)) * np.sin(
                2 * np.pi * f * t[sl] + 0.7 * k)
    return np.clip(x, -1, 1).astype(np.float32).astype(np.float64)[
        None, :, None]


def test_abr_equals_jax(codecs, tmp_path):
    jc, tc = codecs
    x = verse_chorus()
    pj, pt = str(tmp_path / "j.acs"), str(tmp_path / "t.acs")
    want = jsc.encode_stream_with_target_bitrate(
        jc, jnp.asarray(x), pj, chunk_blocks=CB, target_kbps=40.0)
    got = sc.encode_stream_with_target_bitrate(
        tc, torch.from_numpy(x), pt, chunk_blocks=CB, target_kbps=40.0)
    assert got == want
    assert 0.25 < got[1] < 1024.0  # a scale inside the search range
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()


def test_cbr_reservoir_equals_jax(codecs, tmp_path):
    """The JAX test's excursion check (tests/test_stream_container.py):
    the running size stays within the reservoir plus 5% a chunk of the
    constant-rate schedule."""
    jc, tc = codecs
    x = verse_chorus()
    pj, pt = str(tmp_path / "j.acs"), str(tmp_path / "t.acs")
    kw = dict(chunk_blocks=CB, target_kbps=24.0, reservoir_kbits=1.5)
    want = jsc.encode_stream_cbr(jc, jnp.asarray(x), pj, **kw)
    got = sc.encode_stream_cbr(tc, torch.from_numpy(x), pt, **kw)
    assert got == want
    n_chunks, scales, kbps = got
    assert n_chunks == 7 and len(scales) == 6
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    with sc.StreamReader(pt) as r:
        assert r.meta["cbr"] == 1
        sizes = np.array([r.chunk_bytes(i) for i in range(6)])
    dev_kbit = (np.cumsum(sizes) - sizes.mean() * np.arange(1, 7)) * 8e-3
    assert np.abs(dev_kbit).max() <= 1.5 + 0.05 * sizes.mean() * 8e-3 * 6
    assert np.isfinite(port_decode(tc, pt)).all()


def _tamper(blob, off, data):
    return blob[:off] + data + blob[off + len(data):]


def _flip(blob, chunk):
    """Flip a byte of a chunk's codes."""
    with sc.StreamReader(io.BytesIO(blob)) as r:
        off = r._index[chunk] + 12
    return _tamper(blob, off, bytes([blob[off] ^ 1]))


def _silent_record(blob, edit):
    """Rewrite the first silent record of a DTX stream with ``edit``
    (blocks, levels) -> (blocks, levels) and a CRC that matches."""
    with sc.StreamReader(io.BytesIO(blob)) as r:
        off = next(r._index[i] for i in range(r.n_chunks)
                   if r.read_chunk(i).silent is not None)
        ch = r.meta["channels"]
    blocks, = struct.unpack("<I", blob[off + 1:off + 5])
    levels = np.frombuffer(blob[off + 5:off + 5 + 4 * ch], np.float32)
    blocks, levels = edit(blocks, levels.copy())
    body = b"\x01" + struct.pack("<I", blocks) + levels.tobytes()
    return _tamper(blob, off, body + struct.pack("<I", zlib.crc32(body)))


def _header(blob, edit):
    """Rewrite the JSON header (the index and offsets shift with it)."""
    hlen, = struct.unpack("<I", blob[4:8])
    meta = json.loads(blob[8:8 + hlen])
    edit(meta)
    head = json.dumps(meta).encode()
    shift = len(head) - hlen
    body = blob[8 + hlen:]
    n, index_off = struct.unpack("<QQ", body[-16:])
    idx = struct.unpack(f"<{n}Q", blob[index_off:index_off + 8 * n])
    body = body[:index_off - 8 - hlen] + struct.pack(
        f"<{n}Q", *(o + shift for o in idx)) + struct.pack(
        "<QQ", n, index_off + shift)
    return blob[:4] + struct.pack("<I", len(head)) + head + body


# name -> (stream case, edit of the file bytes, chunk read or None)
REFUSALS = {
    "bad magic": ("plain", lambda b: b"ACSX" + b[4:], None),
    "crc": ("plain", lambda b: _flip(b, 3), 3),
    "trailer": ("plain", lambda b: b[:-8] + struct.pack("<Q", len(b)),
                None),
    "truncated": ("plain", lambda b: b[:len(b) // 2], None),
    "chunk offsets": ("plain", lambda b: b[:-16] + struct.pack(
        "<QQ", 10**6, 8), None),
    "channels bound": ("plain", lambda b: _header(
        b, lambda m: m.update(channels=0)), None),
    "tns bound": ("ladder", lambda b: _header(
        b, lambda m: m["tns"].update(order=64)), None),
    "blocks field": ("plain", lambda b: _tamper(
        b, json_end(b), struct.pack("<I", 3)), 0),
    "silent blocks": ("dtx", lambda b: _silent_record(
        b, lambda k, lv: (1 << 20, lv)), 2),
    "silent levels": ("dtx", lambda b: _silent_record(
        b, lambda k, lv: (k, -lv - 1.0)), 2),
    "dtx marker": ("dtx", lambda b: _tamper(b, json_end(b), b"\x07"), 0),
}


def json_end(blob):
    """The offset of the first chunk."""
    hlen, = struct.unpack("<I", blob[4:8])
    return 8 + hlen


def _outcome(package, blob, chunk):
    """The exception type (and, for the JAX-equal messages, the text) of
    opening ``blob`` and reading chunk ``chunk``."""
    try:
        with package.StreamReader(io.BytesIO(blob)) as r:
            if chunk is not None:
                r.read_chunk(chunk)
    except (ValueError, IndexError) as e:
        return type(e), str(e)
    return None, None


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_reader_refuses_as_jax(streams, name):
    case, edit, chunk = REFUSALS[name]
    with open(streams[case][1], "rb") as f:
        blob = edit(f.read())
    got, want = _outcome(sc, blob, chunk), _outcome(jsc, blob, chunk)
    assert got[0] is not None and got == want


def test_reader_bounds_and_writer_refusals(streams, tmp_path):
    with sc.StreamReader(streams["plain"][1]) as r:
        for i in (-1, 5):
            with pytest.raises(IndexError):
                r.read_chunk(i)
        with pytest.raises(IndexError):
            r.chunk_bytes(5)
    meta = dict(sample_rate=SR, filters_n=N, bark_bands_n=BARK, alpha=0.6,
                window_type="vorbis", channels=1)
    with sc.StreamWriter(io.BytesIO(), **meta) as w:
        with pytest.raises(ValueError, match="DTX stream"):
            w.append_silent(4, [0.0])
        with pytest.raises(ValueError, match="declares TNS"):
            w.append(np.zeros((4, N, 1), np.int32),
                     torch.zeros(4, BARK, 1, dtype=torch.bfloat16),
                     tns_idx=np.zeros((4, 8, 1), np.int8))
    for kw in (dict(dtx_level=-60.0, fec_scale=4.0), dict(dtx_level=3.0),
               dict(fec_scale=0.5), dict(is_start=200)):
        with pytest.raises(ValueError):
            sc.StreamWriter(io.BytesIO(), **meta, **kw)
    with pytest.raises(ValueError):
        sc.StreamWriter(io.BytesIO(), **meta, lufs=99.0)
    tc = Codec.create(SR, filters_n=N, bark_bands_n=BARK, device="cpu")
    x = torch.from_numpy(signal(1, dtype=np.float32))
    path = str(tmp_path / "e.acs")
    with pytest.raises(ValueError, match="multiple"):
        sc.encode_stream(tc, x[:, :-1], path, chunk_blocks=CB)
    with pytest.raises(ValueError, match="stereo"):
        sc.encode_stream(tc, x, path, chunk_blocks=CB, ms=True)
    with pytest.raises(ValueError, match="one value per body chunk"):
        sc.encode_stream(tc, x, path, chunk_blocks=CB,
                         threshold_scale=[1.0, 2.0])
    with pytest.raises((TypeError, ValueError)):
        sc.encode_stream(tc, x.double(), path, chunk_blocks=CB)


def test_fec_member_round_trip(codecs):
    """A FEC member parses to what it packs, in both packages; garbage and
    implausible members raise ValueError in both."""
    _, tc = codecs
    x = torch.from_numpy(signal(2))
    frames = tc.mdct.transform(x)
    fc = Codec(tc.mdct, tc.psycho, sidecar_grid=1)
    codes, bark = fc.quantize_frames_fec(frames, ms=True, tpool=4,
                                         threshold_scale=4.0)
    meta = dict(filters_n=N, bark_bands_n=BARK, channels=2, ms=True,
                coder="rrice")
    blob = sc.pack_fec_member(codes, bark, 4.0, meta)
    assert blob == jsc.pack_fec_member(codes.numpy(),
                                       np.asarray(jnp.asarray(
                                           bark.float().numpy(),
                                           dtype=jnp.bfloat16)), 4.0, meta)
    c, b, s = sc.parse_fec_member(blob, meta)
    np.testing.assert_array_equal(c, codes[0].numpy())
    assert s == 4.0 and b.shape == (17, BARK, 1)
    np.testing.assert_array_equal(
        bits(b), bits(torch.repeat_interleave(bark[0], 4, dim=0)[:17]))
    for bad in (blob[:20], blob[:20] + struct.pack("<I", 10**6),
                struct.pack("<IdII", 17, float("nan"), 1, 4) + blob[20:]):
        for package in (sc, jsc):
            with pytest.raises(ValueError):
                package.parse_fec_member(bad, meta)


def test_cbr_stream_vector():
    """tests/vectors/cbr_stream.acs (tests/test_vectors.py's rule)."""
    with open(os.path.join(VEC_DIR, "manifest.json")) as f:
        want = json.load(f)["cbr_stream.acs"]
    path = os.path.join(VEC_DIR, "cbr_stream.acs")
    n = 64
    with sc.StreamReader(path) as r:
        assert r.meta.get("cbr") and r.meta.get("bs") == {"factor": 8}
        nsamp = r.meta["nsamp"]
        codes = np.concatenate([r.read_chunk(i).codes
                                for i in range(r.n_chunks)], axis=0)
    assert hashlib.sha256(np.ascontiguousarray(
        codes, np.int32).tobytes()).hexdigest() == want["codes_sha256"]
    codec = Codec.create(SR, filters_n=n, bark_bands_n=BARK, device="cpu")
    wave = port_decode(codec, path)[0][:nsamp]
    pcm = np.load(os.path.join(VEC_DIR, "cbr_stream.acs.pcm.npy"))
    assert list(pcm.shape) == want["pcm_shape"]
    got = np.round(np.clip(wave.astype(np.float64), -1, 1) * 32767.0)
    assert np.abs(got.astype(np.int64) - pcm.astype(np.int64)).max() <= 4
