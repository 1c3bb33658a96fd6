"""The port's psychoacoustic model, quantizer and quantized codec path held
against the JAX package on the CPU, and the state carried across by
``convert.codec_from_arrays``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from audiocodec_tpu import quantize as jax_quantize
from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu_torch import Codec, quantize
from audiocodec_tpu_torch.convert import codec_from_arrays

torch.set_num_threads(1)

SR, N, BLOCKS = 44100, 1024, 8

# The three configurations of bench.py (bark_precision None follows the DCT)
CONFIGS = {
    "a": dict(compute_dtype="bfloat16", fast_bf16=True, dct_precision="int8",
              bark_precision="default"),
    "b": dict(compute_dtype="bfloat16", fast_bf16=True,
              dct_precision="default", bark_precision="default"),
    "c": dict(compute_dtype="float32", fast_bf16=False,
              dct_precision="default", bark_precision=None),
}


def _signal(dtype_name, batch=2, blocks=BLOCKS):
    """Two tones plus noise, [batch, blocks*N, 1], the same values for
    both frameworks."""
    rng = np.random.default_rng(0)
    t = np.arange(blocks * N) / SR
    base = (0.4 * np.sin(2 * np.pi * 440 * t)
            + 0.3 * np.sin(2 * np.pi * 1320 * t)
            + 0.05 * rng.normal(size=t.size))
    gains = rng.uniform(0.5, 1.0, (batch, 1))
    x = (base[None] * gains)[..., None]
    x = x.astype(np.float64 if dtype_name == "float64" else np.float32)
    return (jnp.asarray(x, dtype=getattr(jnp, dtype_name)),
            torch.from_numpy(x).to(getattr(torch, dtype_name)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float64))


def _snr(x, out):
    x = _np(x)
    out = _np(out)[:, N:-N]
    return 10 * np.log10((x**2).sum() / ((x - out) ** 2).sum())


def _pair(dtype="float32", kernels=False, **kw):
    jc = JaxCodec.create(SR, filters_n=N, compute_dtype=getattr(jnp, dtype),
                         use_pallas=kernels, **kw)
    tc = Codec.create(SR, filters_n=N, compute_dtype=dtype,
                      use_kernel=kernels, device="cpu", **kw)
    return jc, tc


def test_psycho_matches_jax_f32_highest():
    jc, tc = _pair()
    xj, xt = _signal("float32")
    sj, st = jc.mdct.transform(xj), tc.mdct.transform(xt)
    tonj, tont = jc.psycho.tonality(sj), tc.psycho.tonality(st)
    assert tont.shape == (2, BLOCKS + 1, 1, 1)
    np.testing.assert_allclose(_np(tont), _np(tonj), rtol=2e-4)
    thr_j = jc.psycho.global_masking_threshold(sj, tonj)
    thr_t = tc.psycho.global_masking_threshold(st, tont)
    assert thr_t.shape == st.shape and bool((thr_t > 0).all())
    np.testing.assert_allclose(_np(thr_t), _np(thr_j), rtol=2e-4)
    # on one spectrum: near the intensity floor the two MDCTs' last-bit
    # differences are a large part of a tiny amplitude
    same = torch.from_numpy(np.array(sj))
    np.testing.assert_allclose(
        _np(tc.psycho.amplitude_to_dB(same)),
        _np(jc.psycho.amplitude_to_dB(sj)), rtol=2e-4,
    )


def test_round_trip_f64_codes_equal():
    jc, tc = _pair("float64")
    xj, xt = _signal("float64")
    cj, dj, _ = jc.encode_quantized(xj)
    ct, dt, _ = tc.encode_quantized(xt)
    assert ct.dtype == torch.int32 and ct.shape == (2, BLOCKS + 1, N, 1)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(_np(dt), _np(dj), rtol=1e-12)
    out = tc.round_trip_quantized(xt)
    np.testing.assert_allclose(_np(out), _np(jc.round_trip_quantized(xj)),
                               rtol=0, atol=1e-10)


def test_round_trip_f32_highest_codes():
    """At most 1e-4 of the codes may differ, each by at most one step."""
    jc, tc = _pair("float32")
    xj, xt = _signal("float32", batch=4)
    cj = np.asarray(jc.encode_quantized(xj)[0])
    ct = tc.encode_quantized(xt)[0].numpy()
    diff = np.abs(cj.astype(np.int64) - ct)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_slice_snr_matches_jax(config, kernels):
    """round_trip_quantized in bench.py's configurations: quantized SNR
    within 0.1 dB of JAX's. With ``kernels`` the port runs its kernels'
    plain versions and JAX its Pallas kernels in interpret mode."""
    cfg = dict(CONFIGS[config])
    dtype = cfg.pop("compute_dtype")
    jc, tc = _pair(dtype, kernels=kernels,
                   bark_bands_n=64, **cfg)
    xj, xt = _signal(dtype)
    with pltpu.force_tpu_interpret_mode():
        oj = jc.round_trip_quantized(xj)
    ot = tc.round_trip_quantized(xt)
    assert ot.shape == (2, (BLOCKS + 2) * N, 1)
    assert ot.dtype == getattr(torch, dtype)
    assert bool(torch.isfinite(ot).all())
    snr_j, snr_t = _snr(xj, oj), _snr(xt, ot)
    assert snr_t > 15.0
    assert abs(snr_t - snr_j) <= 0.1, (snr_t, snr_j)


@pytest.mark.parametrize("deadzone", [0.5, 0.8, 1.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax(deadzone, dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(scale=0.1, size=(2, 3, 64, 1)).astype(np.float32)
    thr = rng.uniform(1e-3, 0.1, size=x.shape).astype(np.float32)
    j = lambda a: jnp.asarray(a, dtype=getattr(jnp, dtype))  # noqa: E731
    t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    cj, dj = jax_quantize.quantize(j(x), j(thr), deadzone)
    ct, dt = quantize.quantize(t(x), t(thr), deadzone)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(_np(dt), _np(dj))
    rho = jax_quantize.dz_recon_offset(deadzone)
    assert quantize.dz_recon_offset(deadzone) == rho
    np.testing.assert_array_equal(
        _np(quantize.dequantize(ct, dt, recon_offset=rho)),
        _np(jax_quantize.dequantize(cj, dj, recon_offset=rho)),
    )


def test_deadzone_out_of_range_rejected():
    with pytest.raises(ValueError, match="deadzone"):
        quantize.quantize(torch.zeros(1), torch.ones(1), deadzone=3.0)


def _leaves_and_meta(jc):
    leaves = {}
    for part in ("mdct", "psycho"):
        obj = getattr(jc, part)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if hasattr(v, "shape"):
                leaves[f"{part}.{f.name}"] = np.asarray(v)
    m, p = jc.mdct, jc.psycho
    meta = dict(
        sample_rate=p.sample_rate, filters_n=m.filters_n,
        bark_bands_n=p.bark_bands_n, alpha=p.alpha,
        window_type=m.window_type, compute_dtype=str(m.compute_dtype),
        fast_bf16=m.fast_bf16, use_pallas=m.use_pallas,
        pallas_kernel=m.pallas_kernel,
        dct_precision=m.dct_precision, bark_precision=p.bark_precision,
        pallas_int8_scale=m.pallas_int8_scale,
    )
    return leaves, meta


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_convert_carries_every_buffer(config, kernels):
    cfg = dict(CONFIGS[config])
    dtype = cfg.pop("compute_dtype")
    jc, tc = _pair(dtype, kernels=kernels,
                   bark_bands_n=64, **cfg)
    leaves, meta = _leaves_and_meta(jc)
    got = codec_from_arrays(leaves, meta, device="cpu")
    want = dict(tc.named_buffers())
    have = dict(got.named_buffers())
    assert sorted(have) == sorted(want)
    for name, buf in want.items():
        assert have[name].dtype == buf.dtype, name
        assert torch.equal(have[name], buf), name
    if config == "a" and kernels:
        assert want["mdct.kernel_q_fwd"].dtype == torch.int8
    assert got.mdct.int8_scale == tc.mdct.int8_scale
    xj, xt = _signal(dtype, batch=1, blocks=3)
    assert torch.equal(got.round_trip_quantized(xt),
                       tc.round_trip_quantized(xt))
