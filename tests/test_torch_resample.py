"""The port's polyphase resampler (``audiocodec_tpu_torch.resample``) held
against the JAX package's on the CPU.

- The taps equal the JAX ``Resampler.kernel`` bit for bit in float32 (one
  float64 host recipe, rounded once).
- 44.1 -> 48 kHz, 48 -> 16 kHz, 16 -> 44.1 kHz and identity within 1e-6 of
  the peak at ``highest`` (float32 products, TF32 off on the card); at the
  bfloat16 ``default`` tier within two bfloat16 ulps of the peak (2^-7),
  the rounding of the output.
- ``StreamingResampler`` chunked equals the one-shot resample within 1e-6
  (tests/test_resample.py's bound: the products see other shapes), and
  ``out_length`` and the refusals match.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu import resample as jr
from audiocodec_tpu_torch import resample

torch.set_num_threads(1)

RATES = [(44100, 48000), (48000, 16000), (16000, 44100), (16000, 16000)]


def signal(samples, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 16000
    x = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                  0.3 * rng.standard_normal(samples)], axis=1)
    return np.stack([x, 0.5 * x[::-1]]).astype(np.float32)  # [2, S, 2]


@pytest.mark.parametrize("zeros", [16, 8])
@pytest.mark.parametrize("rates", RATES)
def test_taps_equal_jax(rates, zeros):
    j = jr.Resampler.create(*rates, zeros=zeros)
    t = resample.Resampler.create(*rates, zeros=zeros, device="cpu")
    assert (t.up, t.down, t.pad_left, t.window_n) == (
        j.up, j.down, j.pad_left, j.window_n)
    assert t.kernel.dtype == torch.float32
    np.testing.assert_array_equal(t.kernel.numpy(), np.asarray(j.kernel))


@pytest.mark.parametrize("rates", RATES)
def test_resample_equals_jax(rates):
    x = signal(3001)
    j = jr.Resampler.create(*rates)
    t = resample.Resampler.create(*rates, device="cpu")
    want = np.asarray(j.resample(jnp.asarray(x)))
    got = t.resample(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, t.out_length(3001), 2)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert resample.resample_waveform(
        torch.from_numpy(x), *rates).shape == got.shape


@pytest.mark.parametrize("rates", RATES[:3])
def test_bf16_default_tier(rates):
    x = signal(3001)
    j = jr.Resampler.create(*rates, compute_dtype=jnp.bfloat16,
                            precision="default")
    t = resample.Resampler.create(*rates, compute_dtype=torch.bfloat16,
                                  precision="default", device="cpu")
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(j.resample(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    ).astype(jnp.float32))
    got = t.resample(xb)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("chunk", [333, 1000, 7])
@pytest.mark.parametrize("rates", RATES[:3])
def test_streaming_equals_one_shot(rates, chunk):
    x = torch.from_numpy(signal(3001))
    r = resample.Resampler.create(*rates, device="cpu")
    want = r.resample(x)
    s = resample.StreamingResampler(r)
    outs = [s.step(x[:, i:i + chunk]) for i in range(0, 3001, chunk)]
    got = torch.cat(outs + [s.flush()], dim=1)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6
    # flush resets: a second pass gives the same samples
    outs = [s.step(x[:, i:i + chunk]) for i in range(0, 3001, chunk)]
    again = torch.cat(outs + [s.flush()], dim=1)
    assert torch.equal(again, got)


def test_identity_streams_through():
    r = resample.Resampler.create(16000, 16000, device="cpu")
    x = torch.from_numpy(signal(100))
    assert r.resample(x) is x
    s = resample.StreamingResampler(r)
    assert torch.equal(s.step(x), x)
    assert s.flush().numel() == 0


def test_out_length_and_refusals():
    for rates, n in (((44100, 16000), 44100), ((44100, 16000), 441),
                     ((16000, 48000), 16000), ((48000, 44100), 12345)):
        assert (resample.Resampler.create(*rates, device="cpu")
                .out_length(n)) == jr.Resampler.create(*rates).out_length(n)
    for args, kw in (((44100, 44101), {}), ((0, 16000), {}),
                     ((16000, -1), {}), ((16000, 8000),
                                         {"precision": "fastest"})):
        with pytest.raises(ValueError):
            jr.Resampler.create(*args, **kw)
        with pytest.raises(ValueError):
            resample.Resampler.create(*args, device="cpu", **kw)
    with pytest.raises(TypeError):
        resample.Resampler.create(16000, 8000, compute_dtype=torch.float16,
                                  device="cpu")
    r = resample.Resampler.create(16000, 8000, device="cpu")
    with pytest.raises(TypeError):
        r.resample(torch.zeros(1, 100, 1, dtype=torch.float64))
    with pytest.raises(ValueError):
        r.resample(torch.zeros(100, 1))
