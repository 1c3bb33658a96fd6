"""The port's lossless mode (``audiocodec_tpu_torch.lossless``) held against
the JAX package's on the CPU.

- The device programs: ``_select``/``_select_stereo`` give the same orders,
  residuals and scores as the jitted JAX ones at 16 and 24 bits, mono,
  stereo and 3 channels, on frame counts that are not powers of two (the
  port runs each file's own frame count; the JAX package pads it to a
  power of two). ``_reconstruct_flat`` inverts them as JAX's does.
- Containers: levels 1 and 2 cross both ways bit for bit (a JAX blob
  through the port, a port blob through JAX), and on these signals the
  port's members equal the JAX package's (``np.savez`` stamps the time
  into the zip, so members are compared, not bytes). The port's scores are
  exact int64 sums rounded once to float32; the JAX package's float32
  sums are exact while every partial sum stays below 2^24, which holds for
  the 16-bit signals here, and at 24 bits their rounding moves a score by
  a few ulps, which flips an order only at a near-tie (none here).
  Level 2 is native host code in both packages.
- ``describe``, the golden v2/v3 vectors, range decodes and a subset of
  tests/test_lossless.py's tamper cases (ValueError in the port too).
"""

import io
import os

import jax
import numpy as np
import pytest
import torch

from audiocodec_tpu import lossless as jl
from audiocodec_tpu_torch import lossless
from tests.test_lossless import _tamper_lmeta

torch.set_num_threads(1)

VEC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vectors")
SR = 16000
FRAME = 1024


def pcm(samples, channels, bits, seed=0):
    """Tones with a per-channel phase and a little noise, as integer PCM
    at ``bits``: the second half of the stereo file swaps in an unrelated
    right channel, so the per-frame stereo modes differ along it."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / SR
    x = np.stack([0.4 * np.sin(2 * np.pi * (440 + 110 * c) * t + c)
                  + 0.03 * rng.standard_normal(samples)
                  for c in range(channels)], axis=1)
    if channels == 2:
        x[samples // 2:, 1] = 0.3 * rng.standard_normal(
            samples - samples // 2)
    amp = (1 << (bits - 1)) - 1
    return np.clip(np.round(x * amp), -amp - 1, amp).astype(np.int32)


def members(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def assert_same_members(a: bytes, b: bytes):
    ma, mb = members(a), members(b)
    assert sorted(ma) == sorted(mb)
    for k in ma:
        assert ma[k].dtype == mb[k].dtype, k
        np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


# -- the device programs --------------------------------------------------------


# 13 frames of 1024 (not a power of two) and a frame of 4096 (the sampled
# four-chunk scores)
@pytest.mark.parametrize("frame,frames", [(FRAME, 13), (4096, 3)])
@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_select_equals_jax(channels, bits, frame, frames):
    x = pcm(frame * frames, channels, bits).reshape(frames, frame, channels)
    if channels == 2:
        want = jax.jit(jl._select_stereo)(x)
        got = lossless._select_stereo(torch.from_numpy(x))
    else:
        want = jax.jit(jl._select)(x)
        got = lossless._select(torch.from_numpy(x))
    for name, g, w in zip(("orders", "residuals", "bits"), got, want):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype, name
        if name == "bits" and bits == 24:
            # the JAX float32 sums round above 2^24 (a few float32 ulps
            # over a frame's thousand terms); the port's are exact
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # the residuals integrate back to the candidates
    cand = x if channels != 2 else np.stack(
        [x[..., 0], x[..., 1], (x[..., 0] + x[..., 1]) >> 1,
         x[..., 0] - x[..., 1]], axis=-1)
    back = lossless._reconstruct(got[1], got[0])
    np.testing.assert_array_equal(back.numpy(), cand)


@pytest.mark.parametrize("channels", [1, 3])
def test_reconstruct_flat_equals_jax(channels):
    rng = np.random.default_rng(3)
    frames = 5
    flat = rng.integers(-3000, 3000, size=frames * channels * FRAME,
                        dtype=np.int32)
    orders = rng.integers(0, lossless.MAX_ORDER + 1,
                          size=(frames, channels)).astype(np.int32)
    want = np.asarray(jax.jit(jl._reconstruct_flat)(flat, orders))
    got = lossless._reconstruct_flat(torch.from_numpy(flat),
                                     torch.from_numpy(orders))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- containers ------------------------------------------------------------------


# 13 frames and a ragged last one: the port's frame count is the file's
SAMPLES = FRAME * 12 + 333


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_containers_cross_both_ways(channels, bits, level):
    x = pcm(SAMPLES, channels, bits, seed=level)
    with jax.enable_x64(False):
        blob_j = jl.encode_lossless(x, SR, bits=bits, frame=FRAME,
                                    level=level)
    blob_t = lossless.encode_lossless(x, SR, bits=bits, frame=FRAME,
                                      level=level, device="cpu")
    assert_same_members(blob_t, blob_j)
    y, rate, b = lossless.decode_lossless(blob_j, device="cpu")
    assert (rate, b) == (SR, bits) and y.dtype == np.int32
    np.testing.assert_array_equal(y, x)
    with jax.enable_x64(False):
        y, rate, b = jl.decode_lossless(blob_t)
    np.testing.assert_array_equal(y, x)
    assert lossless.describe(blob_t) == jl.describe(blob_j)


def test_per_frame_stereo_modes_and_deflate_families():
    """Mixed per-frame stereo modes (smodes), silence (run-length Rice) and
    a pure tone (a deflated payload) take the same branches as JAX."""
    rng = np.random.default_rng(5)
    n = FRAME * 9 + 17
    t = np.arange(n) / SR
    tone = np.round(20000 * np.sin(2 * np.pi * 441 * t)).astype(np.int32)
    cases = {
        "smodes": pcm(n, 2, 16, seed=9),
        "silence": np.zeros((n, 2), np.int32),
        "tone": tone[:, None],
        "noise": rng.integers(-30000, 30000, size=(n, 1)).astype(np.int32),
    }
    seen = set()
    for name, x in cases.items():
        blob_t = lossless.encode_lossless(x, SR, frame=FRAME, device="cpu")
        with jax.enable_x64(False):
            blob_j = jl.encode_lossless(x, SR, frame=FRAME)
        assert_same_members(blob_t, blob_j)
        d = lossless.describe(blob_t)
        seen.add((d["stereo_mode"], d["entropy"]))
        np.testing.assert_array_equal(
            lossless.decode_lossless(blob_t, device="cpu")[0], x)
    assert ("per-frame", "rice") in seen
    assert any("deflate" in e for _, e in seen)
    assert any(e == "verbatim" for _, e in seen)


@pytest.mark.parametrize("name", ["lossless_v2", "lossless_v3"])
def test_golden_vectors_decode(name):
    with open(os.path.join(VEC_DIR, f"{name}.bin"), "rb") as f:
        blob = f.read()
    ref = np.load(os.path.join(VEC_DIR, f"{name}.pcm.npy"))
    assert lossless.describe(blob) == jl.describe(blob)
    y, rate, bits = lossless.decode_lossless(blob, device="cpu")
    np.testing.assert_array_equal(y, ref)
    # a window from the middle of the clip is the same rows
    s0, cnt = ref.shape[0] // 3, ref.shape[0] // 4
    y, _, _ = lossless.decode_lossless(blob, start=s0, count=cnt,
                                       device="cpu")
    np.testing.assert_array_equal(y, ref[s0:s0 + cnt])


@pytest.mark.parametrize("level", [1, 2])
def test_range_decode_equals_slice(level):
    x = pcm(SAMPLES, 2, 24, seed=4)
    blob = lossless.encode_lossless(x, SR, bits=24, frame=FRAME,
                                    level=level, device="cpu")
    for start, count in ((0, 100), (FRAME - 1, 2), (5 * FRAME + 7, 3000),
                         (SAMPLES - 10, None)):
        y, _, _ = lossless.decode_lossless(blob, start=start, count=count,
                                           device="cpu")
        end = SAMPLES if count is None else start + count
        np.testing.assert_array_equal(y, x[start:end])
    with pytest.raises(ValueError):
        lossless.decode_lossless(blob, start=SAMPLES, device="cpu")
    with pytest.raises(ValueError):
        lossless.decode_lossless(blob, count=0, device="cpu")


# -- hardening ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def blob():
    rng = np.random.default_rng(7)
    x = rng.integers(-500, 500, size=(9000, 2), dtype=np.int16)
    return lossless.encode_lossless(x, 44100, device="cpu")


@pytest.mark.parametrize("field,value", [
    ("version", 99), ("channels", 0), ("channels", 1000),
    ("n_samples", 0), ("n_samples", 1 << 62), ("n_samples", 1 << 38),
    ("frame", 7), ("bits", 32), ("stereo_mode", 5), ("entropy", 5),
    ("entropy", 9), ("sample_rate", 0),
])
def test_tampered_header_raises_value_error(blob, field, value):
    bad = _tamper_lmeta(blob, **{field: value})
    with pytest.raises(ValueError):
        jl.decode_lossless(bad)
    with pytest.raises(ValueError):
        lossless.decode_lossless(bad, device="cpu")


@pytest.mark.parametrize("cut", [0.5, 0.9])
def test_garbage_and_truncation_raise_value_error(blob, cut):
    for bad in (b"not a container at all", blob[: int(len(blob) * cut)]):
        with pytest.raises(ValueError):
            lossless.decode_lossless(bad, device="cpu")
        with pytest.raises(ValueError):
            lossless.describe(bad)
    assert lossless.is_lossless_bytes(blob)
    assert not lossless.is_lossless_bytes(b"RIFF....WAVE")


def test_rejects_what_jax_rejects():
    x = np.zeros((100, 1), np.int32)
    for kw in (dict(bits=32), dict(frame=7), dict(level=3)):
        with pytest.raises(ValueError):
            jl.encode_lossless(x, SR, **kw)
        with pytest.raises(ValueError):
            lossless.encode_lossless(x, SR, device="cpu", **kw)
    for bad in (np.zeros((100, 1), np.float32),
                np.full((10, 1), 1 << 20, np.int32)):
        with pytest.raises(ValueError):
            lossless.encode_lossless(bad, SR, device="cpu")
