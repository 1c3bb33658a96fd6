"""The port's codec server (``audiocodec_tpu_torch.serve``) on the CPU, held
against the JAX package's server and the port's own offline paths (N=256,
32 Bark bands, 16 kHz, clips under 1 s, one float32 server for the module).

Containers are compared member by member (``np.load``): the zip stamps the
time of the write. Streams have no time stamp and are compared as bytes.

- At float64 the port server's 'E' response to a PCM16 WAV equals the JAX
  server's response to the same bytes.
- At float32 a response equals the port's offline ``pack`` of
  ``quantize_frames(transform(x))`` on the same samples (PCM16 and 32-bit
  wires), and padding a batch group to its longest clip gives each clip
  the container it gets alone.
- 'D' equals the offline ``decode_container`` of the same container,
  through the same 16-bit egress, every recorded member honoured.
- 'B'/'C'/'A'/'F' sessions give the bytes of offline ``encode_stream``;
  'J'/'K'/'L' give the PCM of ``decode_stream``, DTX comfort noise included.
- The error paths answer with an error frame and the connection lives on.
"""

import io
import json
import struct
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu import serve as jserve
from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu_torch import Codec, native, quantize, serve
from audiocodec_tpu_torch.io import bitstream
from audiocodec_tpu_torch.io import stream_container as sc
from audiocodec_tpu_torch.io.wav import read_wav_bytes, write_wav_bytes

torch.set_num_threads(1)

N = 256
SR = 16000
BARK = 32


@pytest.fixture(scope="module")
def codec():
    return Codec.create(SR, filters_n=N, bark_bands_n=BARK, device="cpu")


@pytest.fixture(scope="module")
def server(codec):
    with serve.CodecServer(codec, SR, port=0, max_batch=8,
                           max_wait_ms=50.0) as s:
        yield s


def signal(samples, channels=1, freq=440.0, seed=0, amp=0.4):
    """Tones plus a little noise, float32 [samples, channels] in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / SR
    x = np.stack([amp * np.sin(2 * np.pi * freq * (1 + 0.5 * c) * t)
                  for c in range(channels)], axis=1)
    return (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)


def wav_blob(samples, channels=1, width=2, **kw):
    return write_wav_bytes(signal(samples, channels, **kw), SR, width=width)


def members(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def assert_same_members(a: bytes, b: bytes):
    ma, mb = members(a), members(b)
    assert sorted(ma) == sorted(mb)
    for k in ma:
        assert ma[k].dtype == mb[k].dtype, k
        np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


def offline_container(codec, blob):
    """The port's offline encode of a WAV blob's samples, as the server
    records it."""
    wave, _ = read_wav_bytes(blob)
    samples = wave.shape[1]
    x = torch.from_numpy(wave)
    x = torch.nn.functional.pad(x, (0, 0, 0, (-samples) % N))
    codes, bark = codec.quantize_frames(codec.mdct.transform(x))
    return bitstream.pack(
        codes, bark, sample_rate=SR, filters_n=N, bark_bands_n=BARK,
        alpha=codec.psycho.alpha, window_type=codec.mdct.window_type,
        compute_dtype="float32", ms=False,
        bark_precision=codec.psycho.bark_precision,
        entropy="rrice" if native.available() else "zlib",
        sidecar_grid=codec.sidecar_grid, orig_samples=samples,
    )


@pytest.mark.parametrize("channels", [1, 2])
def test_encode_equals_jax_server_f64(channels):
    """The JAX server dequantizes the int16 wire to float32, then to the
    codec's float64; so does the port's."""
    blob = wav_blob(5 * N + 37, channels, seed=channels)
    got = {}
    tcodec = Codec.create(SR, filters_n=N, bark_bands_n=BARK,
                          compute_dtype=torch.float64, device="cpu")
    with serve.CodecServer(tcodec, SR, port=0) as s:
        got["port"] = serve.request("E", blob, port=s.port)
    jcodec = JaxCodec.create(SR, filters_n=N, bark_bands_n=BARK,
                             compute_dtype=jnp.float64)
    with jserve.CodecServer(jcodec, SR, port=0, min_blocks=4) as s:
        got["jax"] = jserve.request("E", blob, port=s.port)
    assert_same_members(got["port"], got["jax"])
    codes, _, meta = bitstream.unpack(got["port"])
    assert codes.shape == (1, 7, N, channels)
    assert meta["compute_dtype"] == "float64" and meta["orig_samples"] == (
        5 * N + 37)


@pytest.mark.parametrize("width", [2, 4])
def test_container_equals_offline_pack(codec, server, width):
    blob = wav_blob(6 * N + 11, width=width, freq=330.0)
    with serve.Client(port=server.port) as c:
        got = c.encode(blob)
    assert_same_members(got, offline_container(codec, blob))


def test_group_padding_equals_solo(codec, server):
    """Concurrent requests of four lengths batch into fewer groups than
    requests; each clip's container is the one it gets alone."""
    lengths = (3 * N, 4 * N + 5, 5 * N + 37, 7 * N)
    blobs = [wav_blob(s, seed=i, freq=300.0 + 100 * i)
             for i, s in enumerate(lengths)]
    with serve.Client(port=server.port) as c:
        before = c.stats()
    results = [None] * len(blobs)
    barrier = threading.Barrier(len(blobs))

    def worker(i):
        with serve.Client(port=server.port) as c:
            barrier.wait(timeout=10)
            results[i] = c.encode(blobs[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(blobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    with serve.Client(port=server.port) as c:
        after = c.stats()
        for blob, got in zip(blobs, results):
            assert_same_members(got, c.encode(blob))
            assert_same_members(got, offline_container(codec, blob))
    assert after["encode_requests"] - before["encode_requests"] == 4
    assert after["encode_batches"] - before["encode_batches"] < 4


def feature_container(codec):
    """A stereo container with every quantization-affecting member: a
    threshold scale, mid/side, a dead zone, TNS, noise fill (seed 4)."""
    x = torch.from_numpy(signal(12 * N, 2, seed=3))[None]
    enc = codec.encode_frames(codec.mdct.transform(x), threshold_scale=8.0,
                              ms=True, deadzone=1.0, tns=True, nf=True)
    return bitstream.pack(
        enc.codes, enc.bark16, sample_rate=SR, filters_n=N,
        bark_bands_n=BARK, alpha=codec.psycho.alpha, window_type="vorbis",
        ms=True, threshold_scale=8.0, sidecar_grid=codec.sidecar_grid,
        dz_recon=quantize.dz_recon_offset(1.0), tns_idx=enc.tns_idx,
        tns_band_start=codec.tns_band_start, nf_levels=enc.nf_levels,
        nf_band_start=codec.nf_band_start, nf_seed=4,
    )


@pytest.mark.parametrize("case", ["gapless", "features"])
def test_decode_equals_offline(codec, server, case):
    with serve.Client(port=server.port) as c:
        if case == "gapless":
            acz = c.encode(wav_blob(5 * N + 37))
        else:
            acz = feature_container(codec)
        got = c.decode(acz)
    codes, bark, meta = bitstream.unpack(acz)
    with torch.no_grad():
        wave = bitstream.decode_container(codec, codes, bark, meta)
    frames = codes.shape[1]
    wave = wave[0, N:N + (frames - 1) * N].numpy()
    if meta["orig_samples"]:
        wave = wave[:meta["orig_samples"]]
        assert wave.shape[0] == 5 * N + 37
    assert got == write_wav_bytes(wave, SR)


def session_bytes(server, cfg, x, scales=None):
    """One 'B'/'C'|'A'/'F' session over x [samples, C] -> its bytes."""
    cs = cfg["chunk_blocks"] * N
    with serve.Client(port=server.port) as c:
        parts = [c.begin_stream(**cfg)]
        for k in range(x.shape[0] // cs):
            ts = None if scales is None else scales[k]
            parts.append(c.feed(x[k * cs:(k + 1) * cs], threshold_scale=ts))
        parts.append(c.finish_stream())
    return b"".join(parts)


def dtx_signal(chunks, cs, silent_first=False):
    rng = np.random.default_rng(44)
    t = np.arange(chunks * cs) / SR
    sig = np.zeros(chunks * cs, np.float32)
    if silent_first:
        sig[:2 * cs] = 5e-5 * rng.standard_normal(2 * cs)
        sig[2 * cs:] = 0.4 * np.sin(2 * np.pi * 440 * t[2 * cs:])
    else:
        sig[:2 * cs] = 0.4 * np.sin(2 * np.pi * 440 * t[:2 * cs])
        sig[2 * cs:5 * cs] = 5e-5 * rng.standard_normal(3 * cs)
        sig[5 * cs:] = 0.3 * np.sin(2 * np.pi * 660 * t[5 * cs:])
    return sig[:, None]


def tmask_signal():
    x = signal(3 * 4 * N, seed=21, amp=0.05)
    x[2 * N:3 * N] += 0.8  # an attack whose shadow spans chunks
    return x


SESSIONS = {
    # name: (cfg, signal, per-chunk scales or None)
    "nf": (dict(channels=1, chunk_blocks=4, nf=True, nf_seed=3),
           lambda: signal(4 * 4 * N, seed=9), None),
    "tmask": (dict(channels=1, chunk_blocks=4, tmask=400.0),
              tmask_signal, None),
    "dtx": (dict(channels=1, chunk_blocks=4, dtx=-70.0),
            lambda: dtx_signal(6, 4 * N), None),
    "dtx-first-silent": (dict(channels=1, chunk_blocks=4, dtx=-70.0),
                         lambda: dtx_signal(4, 4 * N, True), None),
    "intensity": (dict(channels=2, chunk_blocks=4, ms=True, intensity=True,
                       tns=True, bs=True, bwe=True),
                  lambda: signal(3 * 4 * N, 2, freq=3000.0, seed=33), None),
    "adaptive-cbr": (dict(channels=1, chunk_blocks=4, cbr=True,
                          threshold_scale=1.5),
                     lambda: signal(4 * 4 * N, seed=17),
                     [None, 4.0, 16.0, 2.0]),
}


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_session_bytes_equal_encode_stream(codec, server, tmp_path, name):
    cfg, make, scales = SESSIONS[name]
    x = make()
    streamed = session_bytes(server, cfg, x, scales)
    kw = {k: v for k, v in cfg.items() if k not in ("channels", "cbr")}
    if scales is not None:
        # a feed without a scale takes the session's; the header records 1
        kw["threshold_scale"] = [cfg["threshold_scale"] if s is None else s
                                 for s in scales]
    path = str(tmp_path / "off.acs")
    sc.encode_stream(codec, torch.from_numpy(x)[None], path, **kw)
    with open(path, "rb") as f:
        assert streamed == f.read()
    with sc.StreamReader(io.BytesIO(streamed)) as r:
        if name.startswith("dtx"):
            assert streamed[:4] == b"ACS3"
            silent = [r.read_chunk(i).silent is not None
                      for i in range(r.n_chunks)]
            assert silent[:2] == ([True, True] if "first" in name
                                  else [False, False])
            assert any(silent)
        if scales is not None:
            assert r.meta.get("cbr")


def chunk_ranges(path):
    with open(path, "rb") as f:
        raw = f.read()
    _, index_off = struct.unpack("<QQ", raw[-16:])
    with sc.StreamReader(path) as r:
        offs = list(r._index)
    return raw, offs, offs[1:] + [index_off]


@pytest.mark.parametrize("case", ["nf-scaled", "dtx"])
def test_decode_session_equals_decode_stream(codec, server, tmp_path, case):
    path = str(tmp_path / "d.acs")
    if case == "dtx":
        x = dtx_signal(6, 4 * N)
        kw = dict(dtx=-70.0)
    else:
        x = signal(4 * 4 * N, seed=13)
        kw = dict(nf=True, nf_seed=7, threshold_scale=2.0)
    sc.encode_stream(codec, torch.from_numpy(x)[None], path, chunk_blocks=4,
                     **kw)
    with torch.no_grad():
        offline = torch.cat(list(sc.decode_stream(codec, path)),
                            dim=1)[0].numpy()
    raw, offs, ends = chunk_ranges(path)
    with serve.Client(port=server.port) as c:
        meta = c.begin_decode_stream(raw[:offs[0]])
        assert meta["channels"] == 1
        live = [c.feed_chunk(raw[o:e]) for o, e in zip(offs, ends)]
        live.append(c.finish_decode_stream())
    np.testing.assert_array_equal(np.concatenate(live), offline)


def mismatched_header():
    hdr = json.dumps({
        "sample_rate": 8000, "filters_n": N, "bark_bands_n": BARK,
        "alpha": 0.6, "window_type": "vorbis", "channels": 1,
        "compute_dtype": "float32", "ms": False, "threshold_scale": 1.0,
        "bark_precision": "highest", "coder": "rrice", "hcrc": 1,
    }).encode()
    return b"ACS1" + struct.pack("<I", len(hdr)) + hdr


def float64_container(c):
    codes, bark, meta = bitstream.unpack(c.encode(wav_blob(4 * N)))
    return bitstream.pack(codes, bark, sample_rate=SR, filters_n=N,
                          bark_bands_n=BARK, alpha=meta["alpha"],
                          window_type="vorbis", compute_dtype="float64")


ERRORS = {
    # name: (call on a Client, the message's pattern)
    "not-a-wav": (lambda c: c.encode(b"this is not a wav"), "RIFF"),
    "rate-mismatch": (lambda c: c.encode(write_wav_bytes(
        signal(8 * N), 8000)), "resample"),
    "too-short": (lambda c: c.encode(write_wav_bytes(
        np.zeros((N // 2, 1), np.float32), SR)), "block"),
    "garbage-container": (lambda c: c.decode(b"not a container"),
                          "server error"),
    "mismatched-dtype": (lambda c: c.decode(float64_container(c)),
                         "different codec"),
    "mismatched-stream": (lambda c: c.begin_decode_stream(
        mismatched_header()), "different codec"),
    "dtx-with-cbr": (lambda c: c.begin_stream(
        channels=1, chunk_blocks=4, dtx=-70.0, cbr=True), "dtx"),
    "unknown-opcode": (lambda c: c._call("X", b""), "opcode"),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_error_keeps_connection_alive(codec, server, name):
    call, pattern = ERRORS[name]
    with serve.Client(port=server.port) as c:
        errors = c.stats()["errors"]
        with pytest.raises(RuntimeError, match=pattern):
            call(c)
        assert len(c.encode(wav_blob(4 * N))) > 0
        if name in ("not-a-wav", "rate-mismatch", "too-short",
                    "garbage-container", "mismatched-dtype"):
            assert c.stats()["errors"] == errors + 1


def test_session_protocol_errors(server):
    with serve.Client(port=server.port) as c:
        with pytest.raises(RuntimeError, match="no active"):
            c.feed(b"\x00" * 16)
        with pytest.raises(RuntimeError, match="no active"):
            c.finish_stream()
        with pytest.raises(RuntimeError, match="no active decode"):
            c._call("K", b"")
        c.begin_stream(channels=1, chunk_blocks=4)
        with pytest.raises(RuntimeError, match="already active"):
            c.begin_stream(channels=1, chunk_blocks=4)
        with pytest.raises(RuntimeError, match="float32 PCM"):
            c.feed(b"\x00" * 16)  # the wrong size
        with pytest.raises(RuntimeError, match="cbr session"):
            c.feed(np.zeros((4 * N, 1), np.float32), threshold_scale=4.0)
        # the session survives a bad chunk and still finishes
        c.feed(np.zeros((4 * N, 1), np.float32))
        assert len(c.finish_stream()) > 0
        assert len(c.encode(wav_blob(4 * N))) > 0
        stats = c.stats()
    for key in ("encode_ema_ms", "stream_chunk_ema_ms", "t_parse_s",
                "t_acquire_s", "t_dispatch_s", "t_readback_s", "t_pack_s",
                "stream_sessions", "stream_chunks"):
        assert key in stats, key
    assert stats["kernel_launches"]["fold_matmul"] == 0  # CPU tensors


def test_unix_socket_and_concurrent_sessions(codec, tmp_path):
    path = str(tmp_path / "acx.sock")
    pcm = [signal(4 * N, seed=i) for i in range(2)]
    with serve.CodecServer(codec, SR, unix_path=path):
        codes, _, _ = bitstream.unpack(
            serve.request("E", wav_blob(4 * N), unix_path=path))
        assert codes.shape[1] == 5
        # one session a connection, two connections at once
        with serve.Client(unix_path=path) as a, \
                serve.Client(unix_path=path) as b:
            parts = {a: [a.begin_stream(channels=1, chunk_blocks=4)],
                     b: [b.begin_stream(channels=1, chunk_blocks=4)]}
            parts[a].append(a.feed(pcm[0]))
            parts[b].append(b.feed(pcm[1]))
            parts[a].append(a.finish_stream())
            parts[b].append(b.finish_stream())
    for c, x in zip(parts, pcm):
        off = io.BytesIO()
        sc.encode_stream(codec, torch.from_numpy(x)[None], off,
                         chunk_blocks=4)
        assert b"".join(parts[c]) == off.getvalue()
