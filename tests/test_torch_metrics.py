"""The port's quality metrics (``audiocodec_tpu_torch.metrics``) held against
the JAX package's on the CPU (N=256, 16 kHz, 32 Bark bands; loudness at
44.1 and 48 kHz), with the tolerances:

- ``snr_db`` and ``segmental_snr_db`` within 1e-4 dB (float32 sums in
  another order);
- ``nmr`` within 1e-4 relative, at ``tmask`` 0 and 130 dB/s (the MDCT and
  the masking threshold in float32 ``highest``);
- ``loudness_lufs_batch`` within 0.01 LU, and ``round(lufs, 2)`` (the
  ``--tag-loudness`` tag) equal. The port's K-weighting is a blocked
  recurrence (float32 products of the impulse response's Toeplitz matrix,
  a log-depth scan of the state in float64) where JAX runs a per-sample
  float32 scan; both are held to a float64 per-sample loop, the port
  within 2e-6 of the peak and JAX's scan within 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu import metrics as jm
from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu_torch import Codec, metrics

torch.set_num_threads(1)

SR, N, BANDS = 16000, 256, 32


def signal(samples, channels, sr, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sr
    x = np.stack([0.4 * np.sin(2 * np.pi * (440 + 220 * c) * t)
                  + 0.05 * rng.standard_normal(samples)
                  for c in range(channels)], axis=1)
    return x[None].astype(np.float32)


@pytest.fixture(scope="module")
def codecs():
    jc = JaxCodec.create(SR, filters_n=N, bark_bands_n=BANDS,
                         compute_dtype=jnp.float32, use_pallas=False)
    tc = Codec.create(SR, filters_n=N, bark_bands_n=BANDS, use_kernel=False,
                      device="cpu")
    return jc, tc


@pytest.fixture(scope="module")
def pair():
    """A reference and a degraded copy (noise at ~20 dB), 2 s stereo."""
    ref = signal(N * 125, 2, SR)
    rng = np.random.default_rng(1)
    deg = (ref + 0.02 * rng.standard_normal(ref.shape)).astype(np.float32)
    return ref, deg


def test_snr_and_segmental_snr(pair):
    ref, deg = pair
    rt, dt = torch.from_numpy(ref), torch.from_numpy(deg)
    assert abs(float(metrics.snr_db(rt, dt))
               - float(jm.snr_db(jnp.asarray(ref), jnp.asarray(deg)))) < 1e-4
    for frame in (N, 1024):
        got = float(metrics.segmental_snr_db(rt, dt, frame=frame))
        want = float(jm.segmental_snr_db(jnp.asarray(ref), jnp.asarray(deg),
                                         frame=frame))
        assert abs(got - want) < 1e-4, frame


@pytest.mark.parametrize("tmask", [0.0, 130.0])
def test_nmr(codecs, pair, tmask):
    jc, tc = codecs
    ref, deg = pair
    want = float(jax.jit(lambda c, r, d: jm.nmr(c, r, d, tmask=tmask))(
        jc, jnp.asarray(ref), jnp.asarray(deg)))
    got = float(metrics.nmr(tc, torch.from_numpy(ref), torch.from_numpy(deg),
                            tmask=tmask))
    assert abs(got - want) <= 1e-4 * want
    got_db = float(metrics.nmr_db(tc, torch.from_numpy(ref),
                                  torch.from_numpy(deg), tmask=tmask))
    assert abs(got_db - 10 * np.log10(got)) < 1e-5


def test_evaluate(codecs, pair):
    jc, tc = codecs
    ref, deg = pair
    want = jm.evaluate(jc, jnp.asarray(ref), jnp.asarray(deg))
    got = metrics.evaluate(tc, torch.from_numpy(ref), torch.from_numpy(deg))
    assert list(got) == list(want)  # the CLI's JSON line, key for key
    assert all(type(v) is float for v in got.values())
    for k in ("snr_db", "seg_snr_db", "nmr_db"):
        assert abs(got[k] - want[k]) < 1e-4, k
    assert abs(got["nmr"] - want["nmr"]) <= 1e-4 * want["nmr"]
    with pytest.raises(ValueError):
        metrics.evaluate(tc, torch.from_numpy(ref),
                         torch.from_numpy(deg[:, :-N]))
    with pytest.raises(ValueError):
        metrics.evaluate(tc, torch.from_numpy(ref[:, :-1]),
                         torch.from_numpy(deg[:, :-1]))


def biquad_loop(x, b, a):
    """Direct form II transposed in float64, one sample at a time, with the
    coefficients rounded to float32 (as both packages take them)."""
    b = np.asarray(b, np.float32).astype(np.float64)
    a = np.asarray(a, np.float32).astype(np.float64)
    y = np.empty_like(x, dtype=np.float64)
    z1 = np.zeros(x.shape[0::2])
    z2 = np.zeros(x.shape[0::2])
    for n in range(x.shape[1]):
        xn = x[:, n].astype(np.float64)
        yn = b[0] * xn + z1
        z1, z2 = b[1] * xn - a[1] * yn + z2, b[2] * xn - a[2] * yn
        y[:, n] = yn
    return y


@pytest.mark.parametrize("sr", [44100, 48000])
def test_biquad_against_float64_loop(sr):
    # 3.3 blocks of the recurrence at the default block, and a block of 100
    # (the scan over 44 blocks)
    x = signal(4400, 2, sr, seed=2)[0:1]
    for (b, a) in metrics._k_weighting_coeffs(float(sr)):
        want = biquad_loop(x, b, a)
        peak = np.abs(want).max()
        for block in (metrics.BIQUAD_BLOCK, 100):
            got = metrics._biquad(torch.from_numpy(x), b, a, block=block)
            assert got.dtype == torch.float32
            assert np.abs(got.numpy() - want).max() <= 2e-6 * peak, block
        jax_scan = np.asarray(jm._biquad(jnp.asarray(x), b, a))
        assert np.abs(jax_scan - want).max() <= 5e-4 * peak


def test_k_weighting_coeffs_equal():
    for sr in (16000.0, 44100.0, 48000.0):
        for (bt, at), (bj, aj) in zip(metrics._k_weighting_coeffs(sr),
                                      jm._k_weighting_coeffs(sr)):
            np.testing.assert_array_equal(bt, bj)
            np.testing.assert_array_equal(at, aj)


@pytest.mark.parametrize("sr", [44100, 48000])
def test_loudness_batch(sr):
    """Stereo clips: tones with noise, a tone followed by silence (the
    gates must drop it), a full-scale 997 Hz sine (-3.0 LUFS), a quiet
    clip and a clip under the absolute gate."""
    s = 3 * sr
    t = np.arange(s) / sr
    sine = np.sin(2 * np.pi * 997 * t)
    gap = np.where(t < 1.0, 0.3 * np.sin(2 * np.pi * 440 * t), 0.0)
    clips = np.stack([
        signal(s, 2, sr)[0],
        np.stack([gap, 0.5 * gap], 1),
        np.stack([sine, np.zeros(s)], 1),
        0.01 * signal(s, 2, sr, seed=3)[0],
        1e-5 * signal(s, 2, sr, seed=4)[0],
    ]).astype(np.float32)
    want = jm.loudness_lufs_batch(jnp.asarray(clips), sr)
    got = metrics.loudness_lufs_batch(torch.from_numpy(clips), sr)
    assert got.dtype == np.float64 and got.shape == (5,)
    np.testing.assert_allclose(got, want, atol=0.01)
    np.testing.assert_array_equal(np.round(got, 2), np.round(want, 2))
    assert abs(got[2] - (-3.0)) < 0.1
    # the silence is gated away: ungated, the tone's 1 s of 3 would read
    # 4.8 LU lower than the tone alone
    alone = metrics.loudness_lufs(torch.from_numpy(clips[1:2, :sr]), sr)
    assert abs(got[1] - alone) < 1.5
    assert metrics.loudness_lufs(torch.from_numpy(clips[2:3]), sr) == got[2]
