"""The port's bitstream decode (``decode_bitstream[_ms]``) held against the
JAX package on the CPU, on the combinations and signal of
tests/test_torch_ladder.py: each package decodes the other's payload within
0.1 dB of the SNR of JAX's own encode and decode (float32 ``highest``), the
float64 decodes agree within 1e-10 of the peak, a bfloat16 (b) codec is
held by SNR, and ``convert.codec_from_arrays`` carries ``sidecar_grid``.
``Codec.decode_frames``, the body both decode through, refuses intensity
gains without ``ms``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu import quantize as jax_quantize
from audiocodec_tpu import scq as jscq
from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu.codec import EncodedFrames as JaxFrames
from audiocodec_tpu_torch import Codec, EncodedFrames, quantize, scq
from audiocodec_tpu_torch.convert import codec_from_arrays
from tests.test_torch_codec import _leaves_and_meta
from tests.test_torch_ladder import COMBOS, N, channels, codecs, inputs
from tests.test_torch_sidecar import assert_ints

torch.set_num_threads(1)

SNR_MARGIN_DB = 0.1  # tests/test_torch_codec.py::test_slice_snr_matches_jax
F64_TOL = 1e-10  # of the peak
# the bf16 (b) configuration of bench.py
CONFIG_B = dict(fast_bf16=True, dct_precision="default",
                bark_precision="default")
SEED = 5


def _decode_kwargs(combo, enc, offset=0):
    kw = COMBOS[combo]
    out = dict(dz_recon=quantize.dz_recon_offset(kw.get("deadzone", 0.5)),
               tns_idx=enc.tns_idx, nf_levels=enc.nf_levels,
               nf_seed=SEED, nf_frame_offset=offset, bs_flags=enc.bs_flags,
               bwe_gains=enc.bwe_gains)
    if kw.get("ms"):
        out["is_gains"] = enc.is_gains
    return out


def _decode(codec, combo, enc):
    name = "decode_bitstream_ms" if COMBOS[combo].get("ms") else (
        "decode_bitstream")
    return getattr(codec, name)(enc.codes, enc.bark16,
                                **_decode_kwargs(combo, enc))


def _jax_decode(jc, combo, enc):
    return jax.jit(lambda c, e: _decode(c, combo, e))(jc, enc)


def _to_port(enc):
    return EncodedFrames(*(None if a is None else torch.from_numpy(
        np.array(a).view(np.int16)).view(torch.bfloat16)
        if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a))
        for a in enc))


def _to_jax(enc):
    return JaxFrames(*(
        None if a is None else jnp.asarray(
            a.view(torch.int16).numpy().view(jnp.bfloat16))
        if a.dtype == torch.bfloat16 else jnp.asarray(a.numpy())
        for a in enc))


def snr_db(x, out):
    x = np.asarray(x, np.float64)
    out = np.asarray(out, np.float64)[:, N:-N]
    return 10 * np.log10((x**2).sum() / ((x - out) ** 2).sum())


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a, jnp.float64))


@pytest.fixture(scope="module")
def f32_payloads():
    """combo -> (x, JAX payload, port payload) at float32 ``highest``."""
    jc, tc = codecs("float32")
    out = {}
    for combo, kw in COMBOS.items():
        xj, xt = inputs("float32", channels(combo))
        ej = jax.jit(lambda c, x, kw=kw: c.encode_frames(
            c.mdct.transform(x), **kw))(jc, xj)
        out[combo] = (xt.numpy(), ej, tc.encode_frames(tc.mdct.transform(xt),
                                                       **kw))
    return jc, tc, out


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_decodes_cross_packages_within_snr_margin(f32_payloads, combo):
    jc, tc, payloads = f32_payloads
    x, ej, et = payloads[combo]
    want = snr_db(x, _jax_decode(jc, combo, ej))  # JAX's own
    port_of_jax = _decode(tc, combo, _to_port(ej))
    jax_of_port = _jax_decode(jc, combo, _to_jax(et))
    port_of_port = _decode(tc, combo, et)
    assert port_of_jax.shape == (2, (9 + 1) * N, channels(combo))
    assert port_of_jax.dtype == torch.float32
    for out in (port_of_jax, jax_of_port, port_of_port):
        assert np.isfinite(_np(out)).all()
        got = snr_db(x, _np(out))
        assert abs(got - want) <= SNR_MARGIN_DB, (got, want)
    assert want > 5.0


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_f64_decode_matches_jax(combo):
    """Against JAX's eager decode: jitted, XLA contracts the float32 TNS
    taps' step-up into fused multiply-adds, which moves a float64 decode
    by up to ~4e-7 of its peak; eager, each operation rounds as the
    port's does."""
    jc, tc = codecs("float64")
    xj, _ = inputs("float64", channels(combo))
    kw = COMBOS[combo]
    ej = jax.jit(lambda c, x: c.encode_frames(c.mdct.transform(x), **kw))(
        jc, xj)
    want = _np(_decode(jc, combo, ej))
    got = _np(_decode(tc, combo, _to_port(ej)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F64_TOL * np.abs(want).max())


def test_decode_frames_refuses_intensity_gains_without_ms(f32_payloads):
    """Intensity gains code the mid/side layout: a decode that is not
    mid/side refuses them, as the encode refuses intensity without ms."""
    _, tc, payloads = f32_payloads
    et = payloads["ms-intensity"][2]
    assert et.is_gains is not None
    with pytest.raises(ValueError, match="ms=True"):
        tc.decode_frames(et.codes, et.bark16, is_gains=et.is_gains)


def test_nf_frame_offset_changes_only_the_fill(f32_payloads):
    """A decoder entering at another frame index draws another fill."""
    jc, tc, payloads = f32_payloads
    _, _, et = payloads["ms-tns-nf-tmask"]
    base = tc.decode_bitstream_ms(et.codes, et.bark16,
                                  **_decode_kwargs("ms-tns-nf-tmask", et))
    moved = tc.decode_bitstream_ms(et.codes, et.bark16, **_decode_kwargs(
        "ms-tns-nf-tmask", et, offset=1))
    assert bool(torch.isfinite(moved).all())
    assert not torch.equal(base, moved)
    assert torch.equal(base, tc.decode_bitstream_ms(
        et.codes, et.bark16, **_decode_kwargs("ms-tns-nf-tmask", et)))


@pytest.mark.parametrize("combo", ["music", "low"])
def test_bf16_config_b_snr_matches_jax(combo):
    """bf16 ``fast_bf16`` ``default``: the port's encode + decode within
    0.1 dB of JAX's (JAX's CPU runs a ``default`` float32 product at full
    float32, the port at the tier's bfloat16 operands)."""
    jc = JaxCodec.create(44100, filters_n=N, compute_dtype=jnp.bfloat16,
                         use_pallas=False, **CONFIG_B)
    tc = Codec.create(44100, filters_n=N, compute_dtype="bfloat16",
                      use_kernel=False, device="cpu", **CONFIG_B)
    kw = COMBOS[combo]
    x = inputs("float32", channels(combo))[1].numpy()
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)
    ej = jax.jit(lambda c, v: c.encode_frames(c.mdct.transform(v), **kw))(
        jc, xj)
    et = tc.encode_frames(tc.mdct.transform(xt), **kw)
    want = snr_db(x, _np(_jax_decode(jc, combo, ej)))
    out = _decode(tc, combo, et)
    assert out.dtype == torch.bfloat16
    got = snr_db(x, _np(out))
    assert abs(got - want) <= SNR_MARGIN_DB, (got, want)


def test_dz_recon_offset_matches_jax():
    for dz in (0.5, 0.7, 1.0, 1.5):
        assert quantize.dz_recon_offset(dz) == jax_quantize.dz_recon_offset(
            dz)


@pytest.mark.parametrize("grid", [0, 4])
def test_convert_carries_sidecar_grid(grid):
    """A JAX codec built with sidecar_grid=0 converts to a port codec that
    ships raw bfloat16 sidecars, not grid-snapped ones."""
    jc, _ = codecs("float32", sidecar_grid=grid)
    leaves, meta = _leaves_and_meta(jc)
    tc = codec_from_arrays(leaves, dict(meta, sidecar_grid=jc.sidecar_grid),
                           device="cpu")
    assert tc.sidecar_grid == grid
    xj, xt = inputs("float32", 1)
    bj = jc.encode_bitstream(xj)[1]
    bt = tc.encode_bitstream(xt)[1]
    # positive bf16 values: their bit patterns count the levels
    assert_ints(bt.view(torch.int16), np.asarray(bj).view(np.int16),
                "float32")
    if grid:
        assert_ints(scq.levels_from_bark16(bt, grid),
                    jscq.levels_from_bark16(np.asarray(bj), grid), "float32")
    else:
        with pytest.raises(ValueError, match="not on the declared grid"):
            scq.levels_from_bark16(bt, scq.DEFAULT_K2)


def test_convert_without_sidecar_grid_takes_jax_default():
    jc, _ = codecs("float32")
    leaves, meta = _leaves_and_meta(jc)
    assert "sidecar_grid" not in meta
    tc = codec_from_arrays(leaves, meta, device="cpu")
    default = {f.name: f.default for f in dataclasses.fields(JaxCodec)}
    assert tc.sidecar_grid == default["sidecar_grid"] == 4
