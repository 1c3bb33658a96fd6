"""The port's WAV I/O (``audiocodec_tpu_torch.io.wav``) and its native host
library (``audiocodec_tpu_torch.native``: WAV decode and write, the Rice
coders) held against the JAX package's on the same seeded inputs: equal
bytes from both encoders and writers, each package decoding the other's
streams, equal decoded samples, the same errors; and the loader's build
cache (a hashed library on disk loads without any compiler call)."""

import struct

import numpy as np
import pytest
import torch

from audiocodec_tpu import native as jnative
from audiocodec_tpu.io import wav as jwav
from audiocodec_tpu_torch import native
from audiocodec_tpu_torch.io import wav

torch.set_num_threads(1)

GROUP = native.RICE_GROUP


def test_native_library_builds_here():
    """g++ exists on this machine: the port's library must build and load
    (the .acz path ships Rice-coded containers, never the zlib fallback)."""
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert jnative.available(), jnative.build_error()


# -- the Rice coders -----------------------------------------------------------


def _codes(kind, n=20000, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "geometric":  # zero-heavy, like the quantizer's codes
        return ((rng.geometric(0.4, size=n) - 1)
                * rng.choice([-1, 1], size=n)).astype(np.int32)
    if kind == "sparse":
        return np.where(rng.random(n) < 0.01,
                        rng.integers(-2000, 2000, n), 0).astype(np.int32)
    if kind == "dense":
        return rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32)
    if kind == "zeros":
        return np.zeros(n, np.int32)
    # extremes: escapes at both ends of int32, and group-boundary values
    out = np.zeros(3 * GROUP + 7, np.int32)
    out[:9] = [0, 1, -1, 2**30, -(2**30), 47, -48, 2**31 - 1, -(2**31)]
    out[GROUP - 1], out[GROUP], out[2 * GROUP - 1] = 5, -3, 1
    return out


KINDS = ("geometric", "sparse", "dense", "zeros", "extremes")


@pytest.mark.parametrize("coder", ["rice", "rrice"])
@pytest.mark.parametrize("kind", KINDS)
def test_coder_bytes_equal_jax(coder, kind):
    codes = _codes(kind)
    mine = getattr(native, f"{coder}_encode")(codes)
    theirs = getattr(jnative, f"{coder}_encode")(codes)
    assert mine == theirs
    # each package decodes the other's stream (equal bytes make these the
    # same call; the decoders are the packages' own)
    np.testing.assert_array_equal(
        getattr(native, f"{coder}_decode")(theirs, codes.size), codes)
    np.testing.assert_array_equal(
        getattr(jnative, f"{coder}_decode")(mine, codes.size), codes)


@pytest.mark.parametrize("coder", ["rice", "rrice"])
@pytest.mark.parametrize("kind", KINDS)
def test_python_decoders_equal_native(coder, kind):
    codes = _codes(kind, n=3000, seed=1)
    data = getattr(native, f"{coder}_encode")(codes)
    py = getattr(native, f"_{coder}_decode_py")
    got = py(np.frombuffer(data, np.uint8), codes.size, GROUP)
    np.testing.assert_array_equal(got, codes)
    np.testing.assert_array_equal(
        got, getattr(native, f"{coder}_decode")(data, codes.size))


@pytest.mark.parametrize("coder", ["rice", "rrice"])
def test_indexed_encoders_equal_jax_and_seek(coder):
    codes = _codes("geometric", n=10 * GROUP + 17, seed=2)
    stride = 2 * GROUP
    data, idx = getattr(native, f"{coder}_encode_indexed")(codes, stride)
    jdata, jidx = getattr(jnative, f"{coder}_encode_indexed")(codes, stride)
    assert data == jdata
    np.testing.assert_array_equal(idx, jidx)
    assert data == getattr(native, f"{coder}_encode")(codes)
    # a recorded offset decodes from that value on
    start = 3
    got = getattr(native, f"{coder}_decode")(
        data, codes.size - start * stride, start_bit=int(idx[start]))
    np.testing.assert_array_equal(got, codes[start * stride:])
    with pytest.raises(ValueError, match="multiple of group"):
        getattr(native, f"{coder}_encode_indexed")(codes, GROUP + 1)


@pytest.mark.parametrize("coder", ["rice", "rrice"])
def test_corrupt_streams_raise_as_jax(coder):
    codes = np.where(np.arange(5000) % 100 == 0, np.arange(5000),
                     0).astype(np.int32)
    data = getattr(native, f"{coder}_encode")(codes)
    cut = data[: len(data) // 4]
    for decode in (getattr(native, f"{coder}_decode"),
                   getattr(jnative, f"{coder}_decode")):
        with pytest.raises(ValueError, match="corrupt rice stream"):
            decode(cut, codes.size)
        with pytest.raises(ValueError, match="corrupt rice stream"):
            decode(data, codes.size, start_bit=8 * len(data) + 1)
    with pytest.raises(ValueError, match="corrupt rice stream"):
        getattr(native, f"_{coder}_decode_py")(
            np.frombuffer(cut, np.uint8), codes.size, GROUP)


def test_bit_flips_decode_alike_or_raise():
    """Flipped bits decode to the same values in both packages, or raise
    ValueError in both."""
    rng = np.random.default_rng(3)
    codes = np.where(rng.random(4096) < 0.05, rng.integers(-99, 99, 4096),
                     0).astype(np.int32)
    data = bytearray(native.rrice_encode(codes))
    for _ in range(60):
        mut = bytearray(data)
        mut[int(rng.integers(0, len(mut)))] ^= 1 << int(rng.integers(0, 8))
        outs = []
        for decode in (native.rrice_decode, jnative.rrice_decode):
            try:
                outs.append(decode(bytes(mut), codes.size))
            except ValueError:
                outs.append(None)
        assert (outs[0] is None) == (outs[1] is None)
        if outs[0] is not None:
            np.testing.assert_array_equal(outs[0], outs[1])


# -- WAV I/O -------------------------------------------------------------------


def _riff(x, code, bits, rate=16000):
    """A WAV file's bytes of samples ``x`` [frames, channels] already in
    the wire's integer or float representation."""
    channels = x.shape[1]
    if code == 3:
        pcm = x.astype("<f4").tobytes()
    elif bits == 24:
        u = (x.astype(np.int64).ravel() & 0xFFFFFF).astype(np.uint32)
        pcm = np.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF],
                       axis=1).astype(np.uint8).tobytes()
    else:
        pcm = x.astype(f"<i{bits // 8}").tobytes()
    block = channels * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
    hdr += struct.pack("<IHHIIHH", 16, code, channels, rate, rate * block,
                       block, bits)
    return hdr + b"data" + struct.pack("<I", len(pcm)) + pcm


def _samples(code, bits, channels, frames=1500, seed=0):
    rng = np.random.default_rng(seed)
    if code == 3:
        return rng.uniform(-0.99, 0.99, (frames, channels)).astype(np.float32)
    top = 1 << (bits - 1)
    x = rng.integers(-top, top, (frames, channels), dtype=np.int64)
    x[0, 0], x[1, 0] = -top, top - 1  # full scale both ways
    return x


FORMATS = [(1, 16), (1, 24), (1, 32), (3, 32)]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("code,bits", FORMATS)
def test_readers_equal_jax(tmp_path, code, bits, channels):
    path = tmp_path / "in.wav"
    path.write_bytes(_riff(_samples(code, bits, channels), code, bits))
    want, want_rate = jwav.read_wav(str(path))
    got, rate = wav.read_wav(str(path))
    assert rate == want_rate == 16000
    assert got.dtype == want.dtype and got.shape == (1, 1500, channels)
    np.testing.assert_array_equal(got, want)
    got_n, rate_n = native.decode_wav(str(path))
    want_n, _ = jnative.decode_wav(str(path))
    assert rate_n == 16000 and got_n.dtype == np.float32
    np.testing.assert_array_equal(got_n, want_n)


@pytest.mark.parametrize("bits", [16, 24])
def test_integer_readers_and_writer_equal_jax(tmp_path, bits):
    x = _samples(1, bits, 2, seed=4)
    path = tmp_path / "in.wav"
    path.write_bytes(_riff(x, 1, bits))
    got, rate, got_bits = wav.read_wav_int(str(path))
    want = jwav.read_wav_int(str(path))
    assert (rate, got_bits) == want[1:] == (16000, bits)
    np.testing.assert_array_equal(got, want[0])
    np.testing.assert_array_equal(got, x)
    mine, theirs = tmp_path / "m.wav", tmp_path / "t.wav"
    wav.write_wav_int(str(mine), got, 16000, bits)
    jwav.write_wav_int(str(theirs), got, 16000, bits)
    assert mine.read_bytes() == theirs.read_bytes()
    blob = path.read_bytes()
    if bits == 16:
        i16, r = wav.read_wav_i16_bytes(blob)
        np.testing.assert_array_equal(i16, jwav.read_wav_i16_bytes(blob)[0])
        assert i16.dtype == np.int16 and r == 16000
    else:
        assert wav.read_wav_i16_bytes(blob) is None


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_writers_bytes_equal_jax(tmp_path, width, channels):
    rng = np.random.default_rng(width + channels)
    x = rng.uniform(-1.2, 1.2, (1200, channels)).astype(np.float32)
    x[:4, 0] = [1.0, -1.0, 2.0, -2.0]  # full scale and clipped
    out = {}
    for name, fn in (("port native", native.write_wav),
                     ("jax native", jnative.write_wav),
                     ("port python", wav.write_wav),
                     ("jax python", jwav.write_wav)):
        path = tmp_path / f"{name}.wav"
        fn(str(path), x, 44100, width=width)
        out[name] = path.read_bytes()
    assert out["port native"] == out["jax native"]
    assert out["port python"] == out["jax python"]
    assert wav.write_wav_bytes(x, 44100, width) == out["port python"]
    # the port reads its native file back as the JAX package does
    got, _ = native.decode_wav(str(tmp_path / "port native.wav"))
    want, _ = jnative.decode_wav(str(tmp_path / "port native.wav"))
    np.testing.assert_array_equal(got, want)
    assert got[0, 2, 0] > 0.999 and got[0, 3, 0] < -0.999  # clipped, not wrapped


def test_write_errors_as_jax(tmp_path):
    batch = np.zeros((2, 10, 1), np.float32)
    for fn in (wav.write_wav, native.write_wav):
        with pytest.raises(ValueError, match="single clip"):
            fn(str(tmp_path / "x.wav"), batch, 8000)
    with pytest.raises(ValueError, match="unsupported sample width"):
        wav.write_wav(str(tmp_path / "x.wav"), batch[0], 8000, width=3)
    with pytest.raises(ValueError, match="16-bit range"):
        wav.write_wav_int(str(tmp_path / "x.wav"),
                          np.full((4, 1), 1 << 15, np.int32), 8000, 16)


def test_reader_errors_as_jax(tmp_path):
    junk = tmp_path / "junk.wav"
    junk.write_bytes(b"not a wav at all" * 10)
    for read in (wav.read_wav, native.decode_wav):
        with pytest.raises(ValueError, match="RIFF"):
            read(str(junk))
    alaw = tmp_path / "alaw.wav"
    alaw.write_bytes(_riff(np.zeros((4, 1), np.int64), 6, 8))
    with pytest.raises(ValueError, match="unsupported encoding"):
        wav.read_wav(str(alaw))
    with pytest.raises(ValueError, match="unsupported encoding"):
        native.decode_wav(str(alaw))
    f32 = tmp_path / "f32.wav"
    f32.write_bytes(_riff(_samples(3, 32, 1), 3, 32))
    with pytest.raises(ValueError, match="float32"):
        wav.read_wav_int(str(f32))


def test_parser_fuzz_alike(tmp_path):
    """Garbage and truncated files: the port's readers fail with
    ValueError exactly where the JAX package's do, and otherwise give the
    same samples."""
    rng = np.random.default_rng(0)
    full = _riff(_samples(1, 16, 2), 1, 16)
    blobs = [full[: int(len(full) * f)] for f in (0.3, 0.6, 0.95)]
    for i in range(30):
        blob = rng.integers(0, 256, int(rng.integers(0, 600)),
                            dtype=np.uint8).tobytes()
        if i % 3 == 0:
            blob = b"RIFF" + blob
        if i % 5 == 0:
            blob = b"RIFF\xff\xff\xff\xffWAVE" + blob
        blobs.append(blob)
    for i, blob in enumerate(blobs):
        path = tmp_path / f"f{i}.wav"
        path.write_bytes(blob)
        for mine, theirs in ((wav.read_wav, jwav.read_wav),
                             (native.decode_wav, jnative.decode_wav)):
            outs = []
            for fn in (mine, theirs):
                try:
                    outs.append(fn(str(path)))
                except ValueError:
                    outs.append(None)
            assert (outs[0] is None) == (outs[1] is None), (i, mine)
            if outs[0] is not None:
                np.testing.assert_array_equal(outs[0][0], outs[1][0])


# -- the loader: a hashed library needs no compiler ----------------------------


@pytest.fixture
def fresh_loader(monkeypatch):
    """The loader with its process-wide state cleared (restored after)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    return monkeypatch


def test_up_to_date_library_loads_without_compiler(fresh_loader):
    assert native.available()  # builds it, if no test has yet
    fresh_loader.setattr(native, "_lib", None)
    calls = []
    fresh_loader.setattr(native, "_compile",
                         lambda *a: calls.append(a) or "g++ failed: no")
    fresh_loader.setattr(native, "CXX", "/nonexistent/g++")
    assert native.available()
    assert native.build_error() is None
    assert calls == []
    codes = _codes("sparse", n=999)
    assert native.rrice_decode(native.rrice_encode(codes), 999).tolist() \
        == codes.tolist()


def test_no_library_and_no_compiler_reports_why(fresh_loader, tmp_path):
    fresh_loader.setattr(native, "BUILD_DIR", tmp_path)
    fresh_loader.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    assert not native.available()
    err = native.build_error()
    assert err is not None and "g++ unavailable" in err
    assert list(tmp_path.iterdir()) == []
    # the fallbacks keep the decoders and WAV I/O working
    codes = _codes("geometric", n=700)
    data = jnative.rice_encode(codes)
    np.testing.assert_array_equal(native.rice_decode(data, 700), codes)
    with pytest.raises(RuntimeError, match="needs the native library"):
        native.rice_encode(codes)
    path = tmp_path / "a.wav"
    path.write_bytes(_riff(_samples(1, 16, 1), 1, 16))
    np.testing.assert_array_equal(native.decode_wav(str(path))[0],
                                  jwav.read_wav(str(path))[0])


def test_library_name_hashes_sources_flags_and_host(monkeypatch):
    a, b = (native.library_path(f) for f in native.ARCH_FLAGS)
    assert a != b and a.parent == native.BUILD_DIR
    assert a.name.startswith("libacx_native-") and a.suffix == ".so"
    monkeypatch.setattr(native, "_host_fingerprint", lambda: "another host")
    assert native.library_path(native.ARCH_FLAGS[0]) != a
