"""The port's noise injection on the CPU: the Philox stream against the
Random123 known answers, the plain noise kernel's moments, seeding and
per-element sigma (the thresholds of tests/test_tpu_hw.py), and the
deterministic part of ``encode``/``encode_fast`` against the JAX package.

The JAX noise kernel draws nothing in interpret mode (its hardware PRNG
returns zeros there), so JAX's ``encode_fast`` is its spectrum exactly: the
noise itself is held by its statistics, not against JAX."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu_torch import Codec
from audiocodec_tpu_torch.ops import cuda_noise, philox

torch.set_num_threads(1)

SR = 44100
SIGMA = 1.0 / 6.0

# Random123's known-answer vectors of Philox4x32-10: counter, key, output
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KNOWN_ANSWERS)
def test_philox_known_answers(counter, key, want):
    words = philox.philox4x32(
        [torch.tensor([c], dtype=torch.int64) for c in counter], key
    )
    assert [int(w) for w in words] == list(want)


def _word_uniforms(seed, calls):
    """The TPU kernel's map u = 2 - float(0x3F800000 | bits >> 9) of the
    four words of Philox calls 0..calls-1, numpy float32 [calls, 4]."""
    index = torch.arange(calls, dtype=torch.int64)
    zero = torch.zeros_like(index)
    words = philox.philox4x32((index, zero, zero, zero), (seed, 0))
    bits = np.stack([w.numpy() for w in words], axis=-1).astype(np.uint32)
    return np.float32(2.0) - ((bits >> 9) | np.uint32(0x3F800000)).view(
        np.float32)


def test_uniforms_are_the_tpu_kernels_map_of_the_stream():
    """u = 2 - float(0x3F800000 | bits >> 9), in (0, 1]; element 4j + e
    takes call j's words (w0, w1) for e = 0, 1 and (w2, w3) for e = 2, 3,
    and its normal is that pair's cosine (e even) or sine (e odd): no word
    of a call is thrown away."""
    count = 4096
    u1, u2 = philox.uniforms(9, count)
    assert u1.dtype == u2.dtype == torch.float32
    for u in (u1, u2):
        assert bool((u > 0).all()) and bool((u <= 1).all())
    w = _word_uniforms(9, count // 4)
    for e in range(4):
        pair = 2 * (e // 2)
        np.testing.assert_array_equal(u1.numpy()[e::4], w[:, pair])
        np.testing.assert_array_equal(u2.numpy()[e::4], w[:, pair + 1])
    radius = torch.sqrt(-2.0 * torch.log(torch.from_numpy(w[:, 0::2])))
    angle = philox.TWO_PI * torch.from_numpy(w[:, 1::2])
    z = philox.normal(9, count).reshape(-1, 4)
    assert torch.equal(z[:, 0::2], radius * torch.cos(angle))
    assert torch.equal(z[:, 1::2], radius * torch.sin(angle))


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5, 6, 7, 8, 9, 100])
def test_an_element_does_not_depend_on_the_count(count):
    """Element i of the stream is the same whatever the count drawn,
    including counts that end inside a call."""
    u1, u2 = philox.uniforms(9, 4096)
    head = philox.uniforms(9, count)
    assert head[0].shape == (count,)
    assert torch.equal(head[0], u1[:count]) and torch.equal(head[1],
                                                            u2[:count])
    assert torch.equal(philox.normal(9, count), philox.normal(9, 4096)[:count])


def _noise(seed, thr=None, shape=(8, 64, 1024, 1)):
    """The plain kernel's noise on a zero spectrum: 524,288 samples."""
    zero = torch.zeros(shape)
    thr = torch.ones(shape) if thr is None else thr
    return cuda_noise.add_masked_noise(zero, thr, seed)


def test_plain_noise_moments_match_sigma_over_6():
    z = _noise(0).double().flatten()
    n = z.numel()
    assert abs(float(z.mean())) < 5 * SIGMA / math.sqrt(n)
    assert abs(float(z.std()) / SIGMA - 1.0) < 0.01
    frac = float((z.abs() > 3 * SIGMA).double().mean())
    assert 0.0020 < frac < 0.0035
    kurt = float(((z / z.std()) ** 4).mean())
    assert abs(kurt - 3.0) < 0.1


def test_plain_noise_seeding():
    a, b, c = _noise(7), _noise(7), _noise(8)
    assert torch.equal(a, b)
    assert float((a - c).abs().max()) > 1e-3
    assert torch.equal(_noise(-1, shape=(64,)), _noise(2**32 - 1, shape=(64,)))


def test_plain_noise_sigma_follows_the_threshold():
    shape = (8, 64, 1024, 1)
    thr = torch.zeros(shape)
    thr[:4] = 0.5
    thr[4:] = 2.0
    z = _noise(3, thr).double()
    assert abs(float(z[:4].std()) / (0.5 / 6) - 1.0) < 0.02
    assert abs(float(z[4:].std()) / (2.0 / 6) - 1.0) < 0.02


def test_bf16_noise_is_computed_in_f32_and_rounded_once():
    rng = np.random.default_rng(2)
    spec = torch.from_numpy(rng.normal(scale=0.1, size=(3, 40, 64, 1))
                            .astype(np.float32)).to(torch.bfloat16)
    thr = torch.from_numpy(rng.uniform(0, 0.05, size=spec.shape)
                           .astype(np.float32)).to(torch.bfloat16)
    got = cuda_noise.add_masked_noise(spec, thr, 4)
    assert got.dtype == torch.bfloat16
    want = cuda_noise.add_masked_noise(spec.float(), thr.float(), 4)
    assert torch.equal(got, want.to(torch.bfloat16))


def _signal(blocks=6, n=256, batch=2):
    rng = np.random.default_rng(0)
    t = np.arange(blocks * n) / SR
    base = (0.4 * np.sin(2 * np.pi * 440 * t)
            + 0.3 * np.sin(2 * np.pi * 1320 * t)
            + 0.05 * rng.normal(size=t.size))
    gains = rng.uniform(0.5, 1.0, (batch, 1))
    return ((base[None] * gains)[..., None]).astype(np.float32)


def test_encode_fast_with_zero_threshold_returns_the_spectrum(monkeypatch):
    c = Codec.create(SR, filters_n=256, bark_bands_n=32, device="cpu")
    x = torch.from_numpy(_signal())
    spectrum = c.mdct.transform(x)
    monkeypatch.setattr(c.psycho, "global_masking_threshold",
                        lambda s, t, drown=0.0: torch.zeros_like(s))
    assert torch.equal(c.encode_fast(x, 3), spectrum)


def test_encode_and_encode_fast_draw_their_own_streams():
    c = Codec.create(SR, filters_n=256, bark_bands_n=32, device="cpu")
    x = torch.from_numpy(_signal())
    spectrum, threshold = c._analyze(x)
    assert spectrum.is_contiguous() and threshold.is_contiguous()  # no copy
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a = c.encode(x, gen(5))
    assert torch.equal(a, c.encode(x, gen(5)))
    assert not torch.equal(a, c.encode(x, gen(6)))
    assert torch.equal(a, c.psycho.add_noise(gen(5), spectrum, threshold))
    fast = c.encode_fast(x, 5)
    assert torch.equal(fast, cuda_noise.add_masked_noise_reference(
        spectrum, threshold, 5))
    for noisy in (a, fast):
        ratio = ((noisy - spectrum) / threshold).double()
        assert abs(float(ratio.std()) / SIGMA - 1.0) < 0.05
    assert torch.equal(c.round_trip_fast(x, 5), c.decode(fast))
    assert torch.equal(c.round_trip(x, gen(5)), c.decode(a))


# (compute dtype, MDCT kwargs, spectrum tolerance, threshold rtol). The
# spectra are held as tests/test_torch_mdct.py holds the kernels' plain
# versions against the Pallas kernels; the thresholds as
# tests/test_torch_codec.py holds them at f32 highest. In bf16 the port
# rounds the Bark contractions' operands to bf16 at `default`, where the
# JAX package's CPU dot keeps float32, and bf16 keeps 8 bits: 2e-2.
DETERMINISTIC = {
    "f32-highest-mono": ("float32", dict(kernel_design="mono"), "1e-6",
                         2e-4),
    "f32-highest-radix": ("float32", dict(kernel_design="radix"), "2e-6",
                          2e-4),
    "bf16-default-mono": ("bfloat16", dict(fast_bf16=True,
                                           dct_precision="default"),
                          "2ulp", 2e-2),
}


@pytest.mark.parametrize("config", sorted(DETERMINISTIC))
def test_deterministic_part_matches_jax(config):
    dtype, kw, spec_tol, thr_rtol = DETERMINISTIC[config]
    n = 1024
    design = kw.pop("kernel_design", "mono")
    jc = JaxCodec.create(SR, filters_n=n, compute_dtype=getattr(jnp, dtype),
                         use_pallas=True, pallas_kernel=design, **kw)
    tc = Codec.create(SR, filters_n=n, compute_dtype=dtype, use_kernel=True,
                      kernel_design=design, device="cpu", **kw)
    x = _signal(n=n)
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    with pltpu.force_tpu_interpret_mode():
        noisy_j = np.asarray(jc.encode_fast(xj, 7), dtype=np.float64)
        spec_j = jc.mdct.transform(xj)
    np.testing.assert_array_equal(noisy_j,
                                  np.asarray(spec_j, dtype=np.float64))
    thr_j = np.asarray(jc.psycho.global_masking_threshold(
        spec_j, jc.psycho.tonality(spec_j)), dtype=np.float64)
    spec_t, thr_t = tc._analyze(xt)
    spec_t, thr_t = spec_t.double().numpy(), thr_t.double().numpy()
    peak = np.abs(noisy_j).max()
    atol = (2.0 * 2.0 ** (np.floor(np.log2(peak)) - 7) if spec_tol == "2ulp"
            else float(spec_tol))
    np.testing.assert_allclose(spec_t, noisy_j, rtol=0, atol=atol)
    np.testing.assert_allclose(thr_t, thr_j, rtol=thr_rtol)
