"""The port's ``.acz`` container (``audiocodec_tpu_torch.io.bitstream``), the
scq levels' byte coding and rate control (``audiocodec_tpu_torch.rate``)
held against the JAX package on the CPU.

Containers are compared member by member through ``np.load`` (names,
dtypes, values), never as raw bytes: ``np.savez_compressed`` stamps the
write time into the zip headers.

- The six lossy golden vectors (tests/vectors/) load through the port with
  codes equal to the manifest's sha256, the sidecar bits and every meta key
  equal to the JAX package's ``load``, and the port's CPU decode within 4
  LSB of the recorded PCM (tests/test_vectors.py's rule).
- Payloads cross both ways; at float64 (exact payloads) the port's
  container from its own ``encode_frames`` equals the JAX package's member
  for member, in the five feature combinations of
  tests/test_torch_ladder.py and every entropy mode.
- Corrupt containers raise ValueError in both, with the same message.
- Rate control at float64 (N=256, 16 kHz, 2 clips of 1 s) picks the same
  scales and writes the same containers as the JAX package.
"""

import hashlib
import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu import rate as jrate
from audiocodec_tpu import scq as jscq
from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu.io import bitstream as jbs
import chip_smoke
from audiocodec_tpu_torch import Codec, quantize, rate, scq
from audiocodec_tpu_torch.io import bitstream
from tests.test_torch_ladder import COMBOS, channels, codecs, inputs

torch.set_num_threads(1)

VEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
LOSSY_VECTORS = ("plain", "scq", "bwe", "intensity", "ladder", "stereo_ms")
SR, N = 44100, 1024


def members(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def assert_same_members(a: bytes, b: bytes):
    ma, mb = members(a), members(b)
    assert sorted(ma) == sorted(mb)
    for k in ma:
        assert ma[k].dtype == mb[k].dtype, k
        assert ma[k].shape == mb[k].shape, k
        np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


def bits(bark) -> np.ndarray:
    """The uint16 bits of a sidecar, from either package."""
    return bitstream.bf16_bits(bark)


def assert_same_load(port, jax_):
    """(codes, bark, meta) of the port's unpack equal to the JAX one's."""
    (c, b, m), (cj, bj, mj) = port, jax_
    assert c.dtype == np.int32 == cj.dtype
    np.testing.assert_array_equal(c, cj)
    assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
    assert b.device.type == "cpu"
    np.testing.assert_array_equal(bits(b), bits(bj))
    assert sorted(m) == sorted(mj)
    for k, want in mj.items():
        if isinstance(want, np.ndarray):
            assert m[k].dtype == want.dtype, k
            np.testing.assert_array_equal(m[k], want, err_msg=k)
        else:
            assert type(m[k]) is type(want) and m[k] == want, k


def decode_container(codec, codes, bark, meta):
    """chip_smoke.py's decode of a loaded container (the keywords the JAX
    CLI's cmd_decode takes from the meta dict), on the CPU."""
    return chip_smoke.container_decode(torch, codec, codes, bark, meta)


# -- the golden vectors --------------------------------------------------------


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(VEC_DIR, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", LOSSY_VECTORS)
def test_golden_vectors_load_and_decode(name, manifest):
    path = os.path.join(VEC_DIR, f"{name}.acz")
    codes, bark, meta = bitstream.load(path)
    assert_same_load((codes, bark, meta), jbs.load(path))
    want = manifest[f"{name}.acz"]
    assert hashlib.sha256(codes.tobytes()).hexdigest() == want["codes_sha256"]
    codec = Codec.create(meta["sample_rate"], filters_n=meta["filters_n"],
                         bark_bands_n=meta["bark_bands_n"],
                         compute_dtype=meta["compute_dtype"],
                         bark_precision=meta["bark_precision"], device="cpu")
    n = meta["filters_n"]
    with torch.no_grad():
        wave = decode_container(codec, codes, bark, meta)[0, n:-n]
    if meta["orig_samples"]:
        wave = wave[: meta["orig_samples"]]
    pcm16 = np.load(os.path.join(VEC_DIR, f"{name}.acz.pcm.npy"))
    assert list(pcm16.shape) == want["pcm_shape"]
    got = np.round(np.clip(wave.double().numpy(), -1, 1) * 32767.0)
    assert np.abs(got.astype(np.int64) - pcm16.astype(np.int64)).max() <= 4


# -- cross-packing: payloads from both encoders --------------------------------


@pytest.fixture(scope="module")
def payloads():
    """combo -> (JAX payload, port payload) at float64 (exact)."""
    out = {}
    jc, tc = codecs("float64")
    for combo, kw in COMBOS.items():
        xj, xt = inputs("float64", channels(combo))
        enc = jax.jit(lambda c, x, kw=kw: c.encode_frames(
            c.mdct.transform(x), **kw))
        out[combo] = (enc(jc, xj), tc.encode_frames(tc.mdct.transform(xt),
                                                    **kw), tc)
    return out


def pack_args(codec, enc, kw, compute_dtype):
    """pack's keywords for an encode of ``kw``, as the CLI's cmd_encode
    writes them (window, dtype and precision by name)."""
    dz = kw.get("deadzone", 0.5)
    return dict(
        sample_rate=SR, filters_n=N, bark_bands_n=64, alpha=0.6,
        window_type="vorbis", compute_dtype=compute_dtype,
        ms=bool(kw.get("ms")), bark_precision="highest",
        sidecar_grid=codec.sidecar_grid,
        dz_recon=0.0 if dz == 0.5 else quantize.dz_recon_offset(dz),
        tns_idx=enc.tns_idx, tns_band_start=codec.tns_band_start,
        nf_levels=enc.nf_levels, nf_band_start=codec.nf_band_start,
        nf_seed=7, bs_flags=enc.bs_flags, bwe_gains=enc.bwe_gains,
        bwe_start=codec.bwe_start if kw.get("bwe") else 0,
        is_gains=enc.is_gains,
        is_start=codec.is_start if kw.get("intensity") else 0,
        orig_samples=8 * N - 321,
    )


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_port_container_equals_jax(payloads, combo):
    ej, et, tc = payloads[combo]
    kw = COMBOS[combo]
    mine = bitstream.pack(et.codes, et.bark16,
                          **pack_args(tc, et, kw, torch.float64))
    theirs = jbs.pack(ej.codes, ej.bark16,
                      **pack_args(tc, ej, kw, "float64"))
    assert_same_members(mine, theirs)
    m = members(mine)
    assert str(m["dtype"][0]) == "float64"
    assert m["nsamp"].tolist() == [8 * N - 321]
    assert ("dzr" in m) == (kw.get("deadzone", 0.5) != 0.5)
    assert ("rice" in m) or ("rrice" in m)
    # each package reads the other's container alike
    assert_same_load(bitstream.unpack(theirs), jbs.unpack(theirs))
    assert_same_load(bitstream.unpack(mine), jbs.unpack(mine))


@pytest.mark.parametrize("grid", [0, 4])
@pytest.mark.parametrize("entropy", ["zlib", "rice", "rrice", "auto"])
def test_entropy_modes_equal_jax(payloads, entropy, grid):
    """Every coder, with the scq sidecar and with the raw bfloat16 one; the
    port also packs the JAX payload (numpy, the sidecar ml_dtypes
    bfloat16) alike."""
    ej, et, tc = payloads["low"]
    extra = dict(entropy=entropy, sidecar_grid=grid)
    mine = bitstream.pack(et.codes, et.bark16,
                          **pack_args(tc, et, COMBOS["low"], "float64")
                          | extra)
    jargs = pack_args(tc, ej, COMBOS["low"], "float64") | extra
    theirs = jbs.pack(ej.codes, ej.bark16, **jargs)
    assert_same_members(mine, theirs)
    host = {k: np.asarray(v) if isinstance(v, jax.Array) else v
            for k, v in jargs.items()}
    from_jax = bitstream.pack(np.asarray(ej.codes), np.asarray(ej.bark16),
                              **host)
    assert_same_members(from_jax, theirs)
    m = members(mine)
    coder = [c for c in ("codes", "rice", "rrice") if c in m]
    assert coder == (["codes"] if entropy == "zlib" else
                     [entropy] if entropy != "auto" else coder)
    assert len(coder) == 1 and coder != ["codes"] or entropy == "zlib"
    assert ("bark" in m) == (entropy == "zlib")
    assert ("bark_lvl" in m) == bool(grid and entropy != "zlib")
    assert_same_load(bitstream.unpack(mine), jbs.unpack(mine))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   "float64", "torch.float32"])
def test_compute_dtype_written_by_name(dtype):
    codes = np.zeros((1, 2, 64, 1), np.int32)
    bark = torch.ones(1, 2, 16, 1, dtype=torch.bfloat16)
    blob = bitstream.pack(codes, bark, sample_rate=16000, filters_n=64,
                          bark_bands_n=16, alpha=0.6, window_type=None,
                          compute_dtype=dtype)
    name = str(dtype).removeprefix("torch.")
    assert str(members(blob)["dtype"][0]) == name
    meta = jbs.unpack(blob)[2]
    assert meta["compute_dtype"] == name and meta["window_type"] is None


def test_pack_refuses_a_sidecar_that_is_not_bfloat16():
    with pytest.raises(ValueError, match="bfloat16"):
        bitstream.pack(np.zeros((1, 2, 64, 1), np.int32),
                       np.ones((1, 2, 16, 1), np.float32),
                       sample_rate=16000, filters_n=64, bark_bands_n=16,
                       alpha=0.6, window_type=None)


def _rewrite(blob, edit):
    """The container with each member's .npy bytes passed through
    ``edit(name, data)`` (None drops the member)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(blob)) as zin, zipfile.ZipFile(
            buf, "w", zipfile.ZIP_DEFLATED) as zout:
        for name in zin.namelist():
            data = edit(name, zin.read(name))
            if data is not None:
                zout.writestr(name, data)
    return buf.getvalue()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def corrupt_cases(blob):
    return {
        "truncated": blob[: len(blob) // 2],
        "garbage": b"PK\x03\x04" + b"\x00" * 64,
        "bare npy": _npy(np.zeros(3)),
        "no meta": _rewrite(blob, lambda n, d: None if n == "meta.npy"
                            else d),
        "dzr out of bounds": _rewrite(blob, lambda n, d: _npy(
            np.asarray([50.0])) if n == "dzr.npy" else d),
        "huge shape": _rewrite(blob, lambda n, d: _npy(np.asarray(
            [1, 1 << 20, 1 << 20, 2], np.int64)) if n == "shape.npy"
            else d),
        "bad tnsmeta": _rewrite(blob, lambda n, d: _npy(np.asarray(
            [8, 2000], np.int64)) if n == "tnsmeta.npy" else d),
        "bwe group": _rewrite(blob, lambda n, d: _npy(np.asarray(
            [512, 8], np.int64)) if n == "bwemeta.npy" else d),
        "nsamp too long": _rewrite(blob, lambda n, d: _npy(np.asarray(
            [10**9], np.int64)) if n == "nsamp.npy" else d),
        "channels": _rewrite(blob, lambda n, d: _npy(np.asarray(
            [SR, N, 64, 1], np.int64)) if n == "meta.npy" else d),
        "not ms": _rewrite(blob, lambda n, d: _npy(np.asarray(
            [0], np.int64)) if n == "ms.npy" else d),
        "flipped byte": blob[:200] + bytes([blob[200] ^ 0x55]) + blob[201:],
    }


@pytest.fixture(scope="module")
def low_container(payloads):
    _, et, tc = payloads["low"]
    return bitstream.pack(et.codes, et.bark16,
                          **pack_args(tc, et, COMBOS["low"], "float64"))


CORRUPT = ("truncated", "garbage", "bare npy", "no meta", "dzr out of bounds",
           "huge shape", "bad tnsmeta", "bwe group", "nsamp too long",
           "channels", "not ms", "flipped byte")


@pytest.mark.parametrize("case", CORRUPT)
def test_corrupt_containers_raise_as_jax(low_container, case):
    blob = corrupt_cases(low_container)[case]
    errors = []
    for unpack in (bitstream.unpack, jbs.unpack):
        try:
            unpack(blob)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] is not None and errors[0] == errors[1]


# -- scq byte coding -----------------------------------------------------------


@pytest.mark.parametrize("k2", scq.ALLOWED_K2)
def test_scq_levels_bytes_equal_jax(k2):
    lo, hi = scq.level_bounds(k2)
    rng = np.random.default_rng(k2)
    walk = np.cumsum(rng.integers(-2, 3, (2, 40, 16, 1)), axis=1)
    lv = np.clip(walk - 20 * k2, lo, hi).astype(np.int32)
    data = scq.encode_levels(lv, block_axis=1)
    assert data == jscq.encode_levels(lv, block_axis=1)
    np.testing.assert_array_equal(
        scq.decode_levels(data, lv.shape, block_axis=1), lv)
    np.testing.assert_array_equal(
        jscq.decode_levels(data, lv.shape, block_axis=1), lv)


# -- rate control --------------------------------------------------------------


@pytest.mark.parametrize("deadzone", ["auto", 0.5, 1.3])
@pytest.mark.parametrize("kbps", [24.0, 48.0, 64.0, 96.0, 128.0, 300.0])
@pytest.mark.parametrize("channels,sr", [(1, 44100), (2, 44100),
                                         (1, 16000)])
def test_resolve_deadzone_equals_jax(deadzone, kbps, channels, sr):
    assert rate.resolve_deadzone(deadzone, kbps, channels, sr) == \
        jrate.resolve_deadzone(deadzone, kbps, channels, sr)


def test_resolve_deadzone_refuses_as_jax():
    for bad in (0.2, 3.0):
        with pytest.raises(ValueError, match=r"\[0.5, 2.0\]"):
            rate.resolve_deadzone(bad, 64.0, 1, 44100)


RATE_SR, RATE_N = 16000, 256
RATE_CASES = {
    "plain": (40.0, {}),
    "per-clip": ([24.0, 72.0], {}),
    "low": (40.0, dict(ms=True, tns=True, bs=True, nf=True, bwe=True,
                       intensity=True, tmask=130.0)),
}


def rate_clips(ch):
    rng = np.random.default_rng(0)
    t = np.arange(RATE_SR) / RATE_SR
    loud = np.clip(0.4 * np.sin(2 * np.pi * 440 * t)
                   + 0.15 * rng.normal(size=t.size), -1, 1)
    quiet = np.clip(0.05 * rng.normal(size=t.size), -1, 1)
    x = np.stack([loud, quiet])[:, :, None]
    if ch == 2:
        x = np.concatenate([x, 0.9 * x + 0.01 * rng.normal(size=x.shape)],
                           axis=-1)
    return x[:, : x.shape[1] // RATE_N * RATE_N]


@pytest.fixture(scope="module")
def rate_codecs():
    return (JaxCodec.create(RATE_SR, filters_n=RATE_N, bark_bands_n=32,
                            compute_dtype=jnp.float64, use_pallas=False),
            Codec.create(RATE_SR, filters_n=RATE_N, bark_bands_n=32,
                         compute_dtype="float64", device="cpu"))


@pytest.mark.parametrize("case", sorted(RATE_CASES))
def test_rate_control_equals_jax(rate_codecs, case):
    jc, tc = rate_codecs
    target, kw = RATE_CASES[case]
    x = rate_clips(2 if kw.get("ms") else 1)
    orig = x.shape[1] - 7
    want = jrate.encode_with_target_bitrate_batch(
        jc, jnp.asarray(x), np.asarray(target), orig_samples=orig, **kw)
    got = rate.encode_with_target_bitrate_batch(
        tc, torch.from_numpy(x), target, orig_samples=orig, **kw)
    assert len(got) == len(want) == 2
    for g, w, tgt in zip(got, want, np.broadcast_to(target, (2,))):
        assert g.threshold_scale == w.threshold_scale
        assert g.kbps == w.kbps
        assert abs(g.kbps - tgt) <= 0.15 * tgt
        assert g.dz_recon == w.dz_recon
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(bits(g.bark16), bits(w.bark16))
        for name in ("tns_idx", "nf_levels", "bs_flags", "bwe_gains",
                     "is_gains"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b), name)
        assert_same_members(g.packed, w.packed)
        # the winning container decodes through the port
        codes, bark, meta = bitstream.unpack(g.packed)
        assert meta["threshold_scale"] == g.threshold_scale
        with torch.no_grad():
            out = decode_container(tc, codes, bark, meta)
        assert out.shape == (1, x.shape[1] + 2 * RATE_N, x.shape[2])
        assert bool(torch.isfinite(out).all())
    if case == "per-clip":  # the same content at 3x the budget: finer
        assert got[1].threshold_scale < got[0].threshold_scale


def test_rate_control_errors_as_jax(rate_codecs):
    _, tc = rate_codecs
    x = torch.from_numpy(rate_clips(1))
    with pytest.raises(ValueError, match="single clip"):
        rate.encode_with_target_bitrate(tc, x, 64.0)
    for bad in (0.0, -5.0, float("nan")):
        with pytest.raises(ValueError, match="positive"):
            rate.encode_with_target_bitrate(tc, x[:1], bad)
    with pytest.raises(ValueError, match="one value per clip"):
        rate.encode_with_target_bitrate_batch(
            tc, x, np.array([24.0, 48.0, 96.0]))
    with pytest.raises(ValueError, match="positive"):
        rate.encode_with_target_bitrate_batch(tc, x, np.array([24.0, -1.0]))
    with pytest.raises(ValueError, match="one value per clip"):
        rate.encode_with_target_bitrate_batch(tc, x, 40.0, lufs=[-20.0])
    with pytest.raises(ValueError, match="requires ms=True"):
        rate.encode_with_target_bitrate_batch(tc, x, 40.0, intensity=True)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("reservoir", [0.0, 500.0, 4000.0, 1e9])
def test_reservoir_allocate_equals_jax(seed, reservoir):
    rng = np.random.default_rng(seed)
    demand = rng.gamma(2.0, 1000.0, size=int(rng.integers(1, 40)))
    demand[rng.integers(0, demand.size)] *= 8.0  # a hard chunk
    budget = float(demand.sum() * rng.uniform(0.5, 1.5))
    floor = float(rng.choice([0.0, 200.0]))
    np.testing.assert_array_equal(
        rate.reservoir_allocate(demand, budget, reservoir, floor),
        jrate.reservoir_allocate(demand, budget, reservoir, floor))


def test_reservoir_allocate_refuses_as_jax():
    assert rate.reservoir_allocate(np.zeros(0), 10.0, 1.0).shape == (0,)
    with pytest.raises(ValueError, match="reservoir"):
        rate.reservoir_allocate(np.ones(3), 800.0, -1.0)
    with pytest.raises(ValueError, match="positive sum"):
        rate.reservoir_allocate(np.zeros(3), 800.0, 10.0)
