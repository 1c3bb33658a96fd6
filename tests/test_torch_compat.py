"""The port's compat shim (``audiocodec_tpu_torch.compat``) runs the
reference's own test code, as tests/test_compat.py runs it on the JAX
shim (the import, torch for jnp and ``device="cpu"`` changed), and holds
to the JAX shim on the same numpy inputs."""

import numpy as np
import pytest
import torch

from audiocodec_tpu import compat as jax_compat
from audiocodec_tpu_torch.compat import MDCTransformer, PsychoacousticModel

torch.set_num_threads(1)


def sine_wav(amplitude, frequency, sample_rate=44100, duration_sec=2.0):
    t = np.arange(0, sample_rate * duration_sec, dtype=np.float64)
    wave = amplitude * np.sin(2.0 * np.pi * frequency * t / sample_rate)
    return torch.as_tensor(wave, dtype=torch.float32).reshape(1, -1, 1)


class TestReferenceTestSuiteOnShim:
    """Each test mirrors one reference test
    (audiocodec/tests/test_mdctransformer.py, test_psychoacoustic.py)."""

    def test_inverse_identity(self):
        filters_n = 256
        mdct = MDCTransformer(filters_n, device="cpu")
        wave_data = sine_wav(0.8, 880, sample_rate=16000, duration_sec=1.0)
        wave_data = wave_data[:, : filters_n * (wave_data.shape[1] // filters_n)]
        spectrum = mdct.transform(wave_data)
        wave_reproduced = mdct.inverse_transform(spectrum)
        zero = torch.max(
            torch.abs(wave_data - wave_reproduced[:, filters_n:-filters_n])
        )
        assert float(zero) < 1e-5

    def test_mdct_calculation(self):
        filters_n = 64
        mdct = MDCTransformer(filters_n, device="cpu")
        wave_data = sine_wav(0.8, 4, sample_rate=64, duration_sec=4.0)
        wave_data = wave_data[:, : filters_n * (wave_data.shape[1] // filters_n)]
        spectrum = mdct.transform(wave_data)
        correct_spectrum = [
            -0.000412722176, 0.000430465181, 0.000789350364, -0.000867388735,
            -0.00275337417, 0.0132110268, 0.0193885863, 0.156005412,
            -0.233544752, -0.0129148215,
        ]
        for i, a in enumerate(correct_spectrum):
            assert abs(float(spectrum[0, 1, i, 0]) - a) < 2e-6

    def test_mdct_shape(self):
        filters_n = 64
        mdct = MDCTransformer(filters_n, device="cpu")
        rng = np.random.default_rng(0)
        wave_data = torch.as_tensor(
            rng.normal(size=(128, 10 * filters_n, 2)), dtype=torch.float32
        )
        spectrum = mdct.transform(wave_data)
        assert spectrum.shape == (128, 11, filters_n, 2)

    def test_energy_conservation_W(self):
        pa_model = PsychoacousticModel(sample_rate=32768, filter_bands_n=64,
                                       device="cpu")
        should_be_zeros = torch.sum(pa_model.W, dim=1) - 1.0
        assert float(torch.sum(torch.abs(should_be_zeros))) < 1e-6

    def test_energy_conservation_W_inv(self):
        pa_model = PsychoacousticModel(sample_rate=32768, filter_bands_n=64,
                                       device="cpu")
        should_be_zeros = torch.sum(pa_model.W_inv, dim=1) - 1.0
        assert float(torch.sum(torch.abs(should_be_zeros))) < 1e-6

    def test_tonality_tone(self):
        filters_n = 64
        mdct = MDCTransformer(filters_n, device="cpu")
        wave_data = sine_wav(0.8, 4, sample_rate=64, duration_sec=5.0)
        spectrum = mdct.transform(wave_data)
        pa_model = PsychoacousticModel(
            sample_rate=filters_n, filter_bands_n=filters_n, device="cpu"
        )
        tonality = pa_model.tonality(spectrum)
        assert float(tonality[0, 1, 0, 0]) == 1.0

    def test_tonality_noise(self):
        filters_n = 64
        blocks_n = 10
        mdct = MDCTransformer(filters_n, device="cpu")
        rng = np.random.default_rng(1)
        wave_data = torch.as_tensor(
            rng.uniform(-1.0, 1.0, size=(10, blocks_n * filters_n, 2)),
            dtype=torch.float32,
        )
        spectrum = mdct.transform(wave_data)
        pa_model = PsychoacousticModel(
            sample_rate=filters_n, filter_bands_n=filters_n, device="cpu"
        )
        tonality = pa_model.tonality(spectrum)
        assert tonality.shape == (10, blocks_n + 1, 1, 2)
        assert float(torch.mean(tonality[0, 1:-1])) < 0.1


class TestShimExtras:
    def test_reference_constructor_kwargs_accepted(self):
        # the reference passes tf dtypes / precompute_dtype; strings and
        # ignored args must work
        m = MDCTransformer(
            64, window_type="sine", compute_dtype="float32",
            precompute_dtype="float64", device="cpu",
        )
        assert m.filters_n == 64
        pa = PsychoacousticModel(
            44100, compute_dtype=np.float32, precompute_dtype=np.float64,
            device="cpu",
        )
        assert pa.alpha == 0.6

    def test_low_precision_precompute_warns(self):
        with pytest.warns(UserWarning, match="float64"):
            MDCTransformer(64, precompute_dtype="float32", device="cpu")
        with pytest.warns(UserWarning, match="float64"):
            PsychoacousticModel(44100, precompute_dtype=np.float32,
                                device="cpu")

    def test_polyphase_tensor_surface(self):
        """Reference users read mdct.H / mdct.H_inv (mdctransformer.py:58-59):
        [2, N, N], compute dtype, and mutually inverse two-tap operators."""
        n = 64
        m = MDCTransformer(n, window_type="sine", device="cpu")
        H, H_inv = np.asarray(m.H), np.asarray(m.H_inv)
        assert H.shape == (2, n, n) and H_inv.shape == (2, n, n)
        assert H.dtype == np.float32
        # two-tap convolution of H with H_inv is the identity delayed by
        # one block: sum_k H[k] @ H_inv[1-k] == I (perfect reconstruction)
        mid = H[0] @ H_inv[1] + H[1] @ H_inv[0]
        np.testing.assert_allclose(mid, np.eye(n), atol=1e-5)

    def test_add_noise_without_key(self):
        pa = PsychoacousticModel(44100, filter_bands_n=64, device="cpu")
        x = torch.zeros((1, 2, 64, 1), dtype=torch.float32)
        thr = torch.ones_like(x) * 0.1
        a = pa.add_noise(x, thr)
        b = pa.add_noise(x, thr)
        assert not bool(torch.all(a == b))  # stream advances, like global RNG

    def test_end_to_end_pipeline(self):
        """The reference's intended composition, through the shim only."""
        filters_n = 256
        mdct = MDCTransformer(filters_n, device="cpu")
        pa = PsychoacousticModel(16000, filter_bands_n=filters_n,
                                 device="cpu")
        wave = sine_wav(0.7, 700, sample_rate=16000, duration_sec=1.0)
        wave = wave[:, : filters_n * (wave.shape[1] // filters_n)]
        spectrum = mdct.transform(wave)
        tonality = pa.tonality(spectrum)
        thr = pa.global_masking_threshold(spectrum, tonality, drown=0.1)
        noisy = pa.add_noise(spectrum, thr)
        out = mdct.inverse_transform(noisy)
        assert out.shape == (1, wave.shape[1] + 2 * filters_n, 1)
        assert bool(torch.all(torch.isfinite(out)))

    def test_bark_scale_methods(self):
        pa = PsychoacousticModel(44100, device="cpu")
        f = torch.as_tensor([100.0, 1000.0, 10000.0])
        np.testing.assert_allclose(
            np.asarray(pa.bark2freq(pa.freq2bark(f))), np.asarray(f),
            rtol=1e-5,
        )


# -- parity with the JAX shim on the same numpy inputs -------------------------


def _public(obj):
    return {n for n in list(vars(obj)) + dir(type(obj))
            if not n.startswith("_")}


def _wave(n, batch=3, blocks=12, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.8, 0.8, (batch, blocks * n, channels)).astype(
        np.float32)


@pytest.mark.parametrize("window_type", ["vorbis", "sine"])
@pytest.mark.parametrize("n", [64, 256])
def test_polyphase_tensors_bit_equal_to_jax(n, window_type):
    mine = MDCTransformer(n, window_type, device="cpu")
    theirs = jax_compat.MDCTransformer(n, window_type)
    for name in ("H", "H_inv"):
        got = getattr(mine, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(theirs, name)))


@pytest.mark.parametrize("n", [64, 256])
def test_transforms_match_jax(n):
    x = _wave(n)
    mine = MDCTransformer(n, device="cpu")
    theirs = jax_compat.MDCTransformer(n)
    spec = np.array(theirs.transform(x))  # writable, as torch wants
    got = mine.transform(x).numpy()  # a numpy input goes through as_tensor
    np.testing.assert_allclose(got, spec, rtol=0,
                               atol=1e-6 * np.abs(spec).max())
    want = np.asarray(theirs.inverse_transform(spec))
    got = mine.inverse_transform(spec).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n,sr", [(64, 16000), (256, 44100)])
def test_psycho_matches_jax(n, sr):
    spec = np.array(jax_compat.MDCTransformer(n).transform(_wave(n, seed=1)))
    mine = PsychoacousticModel(sr, filter_bands_n=n, bark_bands_n=16,
                               device="cpu")
    theirs = jax_compat.PsychoacousticModel(sr, filter_bands_n=n,
                                            bark_bands_n=16)
    for name in ("max_frequency", "max_bark", "bark_band_width"):
        assert getattr(mine, name) == pytest.approx(getattr(theirs, name),
                                                    rel=1e-12)
    for name in ("W", "W_inv", "spreading_matrix",
                 "quiet_threshold_intensity"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(theirs, name)))
    ton = np.array(theirs.tonality(spec))
    np.testing.assert_allclose(mine.tonality(spec).numpy(), ton, rtol=1e-5,
                               atol=1e-5 * np.abs(ton).max())
    for drown in (0.0, 0.1):
        want = np.asarray(theirs.global_masking_threshold(spec, ton, drown))
        got = mine.global_masking_threshold(spec, ton, drown=drown).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    for name in ("amplitude_to_dB", "amplitude_to_dB_norm"):
        want = np.asarray(getattr(theirs, name)(spec))
        np.testing.assert_allclose(getattr(mine, name)(spec).numpy(), want,
                                   rtol=1e-5)
    f = np.asarray([50.0, 440.0, 8000.0], np.float32)
    np.testing.assert_allclose(mine.freq2bark(f).numpy(),
                               np.asarray(theirs.freq2bark(f)), rtol=1e-6)
    np.testing.assert_allclose(mine.bark2freq(f / 1000).numpy(),
                               np.asarray(theirs.bark2freq(f / 1000)),
                               rtol=1e-6)


def test_public_attributes_cover_jax_shim():
    pairs = (
        (MDCTransformer(64, device="cpu"), jax_compat.MDCTransformer(64)),
        (PsychoacousticModel(16000, filter_bands_n=64, device="cpu"),
         jax_compat.PsychoacousticModel(16000, filter_bands_n=64)),
    )
    for mine, theirs in pairs:
        assert _public(theirs) <= _public(mine), sorted(
            _public(theirs) - _public(mine))


def test_add_noise_generator_and_moments():
    """The by-design divergence from the JAX shim's key stream: a
    ``torch.Generator`` per instance, seeded from a process-wide counter.
    A given generator reproduces a draw; successive calls without one
    differ; the noise over threshold / 6 is N(0, 1)."""
    pa = PsychoacousticModel(16000, filter_bands_n=256, device="cpu")
    spec = torch.zeros((4, 64, 256, 1))
    thr = torch.full_like(spec, 0.3)  # 65,536 elements
    a = pa.add_noise(spec, thr, torch.Generator().manual_seed(7))
    b = pa.add_noise(spec, thr, torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c, d = pa.add_noise(spec, thr), pa.add_noise(spec, thr)
    assert not torch.equal(c, d)
    other = PsychoacousticModel(16000, filter_bands_n=256, device="cpu")
    assert not torch.equal(other.add_noise(spec, thr), c)
    for noise in (a, c, d):
        z = (noise - spec) / (thr / 6)
        assert abs(float(z.mean())) < 0.02
        assert abs(float(z.var()) - 1.0) < 0.05


def test_inputs_stay_uncast():
    """Like the JAX shim, inputs are not cast: a float64 waveform into a
    float32 transformer is refused, not silently rounded."""
    x = _wave(64).astype(np.float64)
    for shim in (MDCTransformer(64, device="cpu"),
                 jax_compat.MDCTransformer(64)):
        with pytest.raises(TypeError, match="never casts implicitly"):
            shim.transform(x)
