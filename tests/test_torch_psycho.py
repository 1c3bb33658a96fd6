"""The port's psychoacoustic model beyond parity mode, held against the JAX
package on the CPU: calibrated mode (and its passage through
``convert.codec_from_arrays``), temporal masking and the normalized dB
scale. Templates: tests/test_psycho.py, tests/test_tmask.py and
``TestPsychoProperties`` of tests/test_properties.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu import psycho as jax_psycho
from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu_torch import PsychoacousticModel, psycho
from audiocodec_tpu_torch.convert import codec_from_arrays
from tests.test_torch_codec import _leaves_and_meta, _np, _signal

torch.set_num_threads(1)

RTOL = 2e-4  # test_torch_codec.py::test_psycho_matches_jax_f32_highest
BUFFERS = ("W", "W_inv", "spreading_matrix", "quiet_threshold_intensity",
           "bark_grid", "quiet_threshold_freq_amp")


def _spectrum(filters_n, seed, blocks=5, batch=2):
    """An MDCT-like spectrum: a few tonal peaks over a quiet floor."""
    rng = np.random.default_rng(seed)
    spec = rng.normal(scale=1e-3, size=(batch, blocks, filters_n, 1))
    peaks = rng.integers(0, filters_n, size=6)
    spec[:, :, peaks] += rng.uniform(0.05, 0.5, size=(batch, blocks, 6, 1))
    return spec.astype(np.float32)


def _thresholds(pj, pt, spec):
    sj, st = jnp.asarray(spec), torch.from_numpy(spec)
    thr_j = pj.global_masking_threshold(sj, pj.tonality(sj))
    thr_t = pt.global_masking_threshold(st, pt.tonality(st))
    return _np(thr_j), _np(thr_t)


def test_calibrated_codec_converts_and_matches_jax():
    """The converted calibrated codec keeps its mode: thresholds within
    2e-4 of the JAX codec's on 2 clips of 8 blocks (seed 0). A parity
    conversion missed 11.7% of them, bin 0 of frame 0 by 0.986."""
    jc = JaxCodec.create(44100, filters_n=1024, use_pallas=False)
    jc = dataclasses.replace(jc, psycho=jax_psycho.PsychoacousticModel.create(
        44100, 1024, 64, calibrated=True))
    tc = codec_from_arrays(*_leaves_and_meta(jc), device="cpu")
    assert tc.psycho.calibrated
    np.testing.assert_array_equal(
        _np(tc.psycho.quiet_threshold_freq_amp),
        _np(jc.psycho.quiet_threshold_freq_amp))
    xj, xt = _signal("float32")
    sj, st = jc.mdct.transform(xj), tc.mdct.transform(xt)
    thr_j = jc.psycho.global_masking_threshold(sj, jc.psycho.tonality(sj))
    thr_t = tc.psycho.global_masking_threshold(st, tc.psycho.tonality(st))
    np.testing.assert_allclose(_np(thr_t), _np(thr_j), rtol=RTOL)
    # the floor is what a parity model would miss at the band edges
    assert float(thr_t[0, 0, 0, 0]) == pytest.approx(
        float(thr_j[0, 0, 0, 0]), rel=RTOL)


@pytest.mark.parametrize("filters_n,bark_n", [(1024, 64), (512, 48),
                                              (256, 24)])
def test_calibrated_matches_jax(filters_n, bark_n):
    """Every buffer equal to the JAX model's (the same float64 precomputes,
    one rounding), and the thresholds within 2e-4."""
    pj = jax_psycho.PsychoacousticModel.create(44100, filters_n, bark_n,
                                               calibrated=True)
    pt = PsychoacousticModel(44100, filters_n, bark_n, calibrated=True,
                             device="cpu")
    for name in BUFFERS:
        np.testing.assert_array_equal(_np(getattr(pt, name)),
                                      _np(getattr(pj, name)), err_msg=name)
    thr_j, thr_t = _thresholds(pj, pt, _spectrum(filters_n, filters_n))
    assert (thr_t > 0).all()
    np.testing.assert_allclose(thr_t, thr_j, rtol=RTOL)


def test_parity_mode_has_no_floor():
    pt = PsychoacousticModel(44100, 256, 24, device="cpu")
    assert not pt.calibrated and pt.quiet_threshold_freq_amp is None
    assert "quiet_threshold_freq_amp" not in dict(pt.named_buffers())
    pc = PsychoacousticModel(44100, 256, 24, calibrated=True, device="cpu")
    assert pc.quiet_threshold_freq_amp.shape == (1, 1, 256, 1)
    # the calibrated threshold is never below its fine-grid floor
    thr = pc.global_masking_threshold(*(lambda s: (s, pc.tonality(s)))(
        torch.from_numpy(_spectrum(256, 1))))
    assert bool((thr >= pc.quiet_threshold_freq_amp).all())


def test_calibrated_is_invariant_to_band_counts():
    """Calibrated mode's reason to exist: the same tone's threshold around
    its peak agrees across band configurations far closer than parity
    mode's (tests/test_psycho.py's calibrated checks, in the port)."""
    sr, tone_hz = 44100, 1000.0

    def peak_db(filters_n, bark_n, calibrated):
        pm = PsychoacousticModel(sr, filters_n, bark_n, calibrated=calibrated,
                                 device="cpu")
        spec = np.full((1, 1, filters_n, 1), 1e-6, np.float32)
        spec[0, 0, int(tone_hz / (sr / 2) * filters_n)] = 0.5
        s = torch.from_numpy(spec)
        thr = pm.global_masking_threshold(s, pm.tonality(s))[0, 0, :, 0]
        # as the dB of an intensity summed over 1/1024 of the band
        intensity = (thr.double() ** 2).sum() * 1024 / filters_n
        return float(10 * torch.log10(intensity))

    spread = {c: [peak_db(f, b, c) for f, b in ((1024, 64), (512, 48),
                                                (2048, 96))]
              for c in (False, True)}
    width = {c: max(v) - min(v) for c, v in spread.items()}
    assert width[True] < width[False], width


def test_convert_refuses_a_mismatched_floor():
    calibrated = JaxCodec.create(16000, filters_n=256, bark_bands_n=16,
                                 use_pallas=False)
    calibrated = dataclasses.replace(
        calibrated, psycho=jax_psycho.PsychoacousticModel.create(
            16000, 256, 16, calibrated=True))
    leaves, meta = _leaves_and_meta(calibrated)
    missing = {k: v for k, v in leaves.items()
               if k != "psycho.quiet_threshold_freq_amp"}
    with pytest.raises(ValueError, match="lack"):
        codec_from_arrays(missing, meta, device="cpu")
    with pytest.raises(ValueError, match="hold"):
        codec_from_arrays(leaves, dict(meta, calibrated=False), device="cpu")
    with pytest.raises(ValueError, match="hold"):  # no flag: parity
        codec_from_arrays(leaves, {k: v for k, v in meta.items()
                                   if k != "calibrated"}, device="cpu")
    assert codec_from_arrays(leaves, meta, device="cpu").psycho.calibrated


# ---- temporal masking -----------------------------------------------------


def _intensity(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (10.0 ** rng.uniform(-14, 2, shape)).astype(dtype)


@pytest.mark.parametrize("decay", [0.5, 2.7, 3.0, 31.0, 1e-12])
@pytest.mark.parametrize("frame_axis", [1, 0])
def test_temporal_masking_bit_equal(decay, frame_axis):
    """float32, bit for bit. At 0.5 dB/frame the window (63) exceeds the
    37 frames, at 1e-12 it is ~3e13: the doubling stops at the frame
    count."""
    x = _intensity((2, 37, 24, 3), int(decay * 10) + frame_axis)
    if frame_axis == 0:
        x = x[0]
    got = psycho.temporal_masking(torch.from_numpy(x), decay, frame_axis)
    want = jax_psycho.temporal_masking(jnp.asarray(x), decay, frame_axis)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("decay,split", [(2.0, 1), (2.0, 25), (0.5, 7),
                                         (7.5, 49)])
def test_temporal_masking_context_bit_equal(decay, split):
    """With a carried context: equal to JAX's and to the whole-signal
    spread."""
    x = _intensity((1, 50, 16, 2), split)
    w = psycho.temporal_masking_window(decay)
    a, b = x[:, :split], x[:, split:]
    ctx = a[:, max(0, split - w):]
    got = psycho.temporal_masking(torch.from_numpy(b), decay,
                                  context=torch.from_numpy(ctx))
    want = jax_psycho.temporal_masking(jnp.asarray(b), decay,
                                       context=jnp.asarray(ctx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    whole = psycho.temporal_masking(torch.from_numpy(x), decay).numpy()
    head = psycho.temporal_masking(torch.from_numpy(a), decay).numpy()
    np.testing.assert_array_equal(
        np.concatenate([head, got.numpy()], axis=1), whole)


def test_temporal_masking_bf16_matches_jax():
    x = _intensity((1, 20, 8, 1), 5)
    got = psycho.temporal_masking(torch.from_numpy(x).to(torch.bfloat16), 3.0)
    want = jax_psycho.temporal_masking(jnp.asarray(x, jnp.bfloat16), 3.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_temporal_masking_window_and_errors():
    for decay in (0.5, 1.0, 2.7, 3.0, 7.5, 31.0, 1e-12):
        w = psycho.temporal_masking_window(decay)
        assert w == jax_psycho.temporal_masking_window(decay)
        assert ((w + 1) & w) == 0
    assert psycho.temporal_masking_window(3.0, 60.0) == \
        jax_psycho.temporal_masking_window(3.0, 60.0)
    with pytest.raises(ValueError):
        psycho.temporal_masking_window(0.0)
    with pytest.raises(ValueError):
        psycho.temporal_masking(torch.ones(1, 4, 2, 1), -1.0)
    with pytest.raises(ValueError, match="rank"):
        psycho.temporal_masking(torch.ones(1, 4, 2, 1), 1.0,
                                context=torch.ones(4, 2, 1))


def test_isolated_impulse_decays_exponentially():
    x = np.full((1, 20, 8, 1), 1e-14)
    x[0, 3] = 1.0
    out = psycho.temporal_masking(torch.from_numpy(x), 3.0).numpy()
    lam, w = 10.0 ** -0.3, psycho.temporal_masking_window(3.0)
    for k in range(1, min(w, 16) + 1):
        np.testing.assert_allclose(out[0, 3 + k, :, 0], lam**k, rtol=1e-12)
    np.testing.assert_allclose(out[0, 3 + w + 1:, :, 0], 1e-14, rtol=1e-12)


# ---- the dB scale ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_amplitude_to_db_norm_within_one_ulp(dtype):
    pj = jax_psycho.PsychoacousticModel.create(
        44100, 64, 16, compute_dtype=getattr(jnp, dtype))
    pt = PsychoacousticModel(44100, 64, 16, compute_dtype=dtype,
                             device="cpu")
    assert (pt.dB_MAX, pt.dB_MIN) == (pj.dB_MAX, pj.dB_MIN) == (120.0, -20.0)
    amp = np.random.default_rng(6).uniform(-1, 1, (2, 3, 64, 1))
    amp[0, 0, :4, 0] = [0.0, 1e-9, 1.0, -1.0]
    amp = amp.astype(np.float32)
    got = _np(pt.amplitude_to_dB_norm(
        torch.from_numpy(amp).to(getattr(torch, dtype))))
    want = _np(pj.amplitude_to_dB_norm(jnp.asarray(amp, getattr(jnp, dtype))))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    if dtype == "bfloat16":
        ulp = ulp * 2.0 ** 16
    assert (np.abs(got - want) <= ulp).all()
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("sample_rate,filters_n,bark_n",
                         [(8000, 32, 8), (16000, 64, 24), (44100, 256, 64),
                          (96000, 64, 8)])
def test_bark_maps(sample_rate, filters_n, bark_n, calibrated):
    """Rows of W sum to 1 in both modes (energy conservation), and of W_inv
    to calibrated mode's level scalar (1 in parity mode)."""
    pt = PsychoacousticModel(sample_rate, filters_n, bark_n,
                             calibrated=calibrated, compute_dtype="float64",
                             device="cpu")
    np.testing.assert_allclose(pt.W.sum(1).numpy(), 1.0, atol=1e-12)
    level = filters_n * 64.0 / (1024.0 * bark_n) if calibrated else 1.0
    np.testing.assert_allclose(pt.W_inv.sum(1).numpy(), level, rtol=1e-12)
    spec = torch.from_numpy(np.random.default_rng(bark_n).uniform(
        -1, 1, (1, 3, filters_n, 1)))
    thr = pt.global_masking_threshold(spec, pt.tonality(spec))
    assert bool((thr > 0).all()) and bool(torch.isfinite(thr).all())
