"""The port's bitstream encode (``Codec.encode_frames`` and
``quantize_frames_fec``) held against the JAX package on the CPU, at N=1024
and 44.1 kHz with 64 Bark bands, 2 clips of 8 blocks, on the signal of
tests/test_torch_sidecar.py (an attack after a gap fires block switching,
an impulse TNS).

Five feature combinations, taken from tests/test_feature_matrix.py's
COMBOS (the fifth is COMBOS[9] with bandwidth extension added and the CLI's
"low" preset's tmask of 130 dB/s; the first is the "music" preset). Each
JAX payload is computed once, jitted, in a module-scoped fixture.

Rules: at float64 the codes and every member are equal; at float32
``highest`` at most 1e-4 of the codes differ, each by one step, and each
member (sidecar levels, TNS indices, nf levels, bwe and intensity gains,
block-switch flags) is at least 99.9% equal, each within one level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu import scq as jscq
from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu_torch import Codec, EncodedFrames, scq
from tests.test_torch_sidecar import (_np, assert_ints, ladder_signal,
                                      signed_levels)

torch.set_num_threads(1)

SR, N, BLOCKS = 44100, 1024, 8
CODES_DIFFER_F32 = 1e-4  # tests/test_torch_codec.py::test_round_trip_f32_highest_codes
# name -> encode_frames keywords
COMBOS = {
    "music": dict(tns=True, bs=True, deadzone=0.7),
    "bs-nf": dict(bs=True, nf=True),
    "ms-tns-nf-tmask": dict(ms=True, tns=True, nf=True, tmask=400.0),
    "ms-intensity": dict(ms=True, intensity=True),
    "low": dict(ms=True, deadzone=1.0, tns=True, bs=True, nf=True,
                tmask=130.0, bwe=True, intensity=True),
}
DTYPES = ("float64", "float32")
MEMBERS = ("tns_idx", "nf_levels", "bs_flags", "bwe_gains", "is_gains")


def codecs(dtype, **kw):
    jc = JaxCodec.create(SR, filters_n=N, compute_dtype=getattr(jnp, dtype),
                         use_pallas=False, **kw)
    tc = Codec.create(SR, filters_n=N, compute_dtype=dtype, use_kernel=False,
                      device="cpu", **kw)
    return jc, tc


def channels(combo):
    return 2 if COMBOS[combo].get("ms") else 1


def inputs(dtype, ch):
    x = ladder_signal(ch).astype(dtype)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.fixture(scope="module")
def payloads():
    """(dtype, combo) -> (JAX payload, port payload, JAX fec, port fec)."""
    out = {}
    for dtype in DTYPES:
        jc, tc = codecs(dtype)
        for combo, kw in COMBOS.items():
            xj, xt = inputs(dtype, channels(combo))
            ms = bool(kw.get("ms"))
            enc = jax.jit(lambda c, x, kw=kw: c.encode_frames(
                c.mdct.transform(x), **kw))
            fec = jax.jit(lambda c, x, ms=ms: c.quantize_frames_fec(
                c.mdct.transform(x), ms=ms, threshold_scale=4.0))
            st = tc.mdct.transform(xt)
            out[dtype, combo] = (
                enc(jc, xj), tc.encode_frames(st, **kw), fec(jc, xj),
                tc.quantize_frames_fec(st, ms=ms, threshold_scale=4.0),
            )
    return out


def assert_codes(got, want, dtype):
    got, want = _np(got).astype(np.int64), np.asarray(want, np.int64)
    assert got.shape == want.shape
    if dtype == "float64":
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= CODES_DIFFER_F32


def assert_sidecar(got, want, dtype, k2=scq.DEFAULT_K2):
    """The bf16 sidecars' grid levels, by the integer rule."""
    assert got.dtype == torch.bfloat16
    assert_ints(scq.levels_from_bark16(got, k2),
                jscq.levels_from_bark16(np.asarray(want), k2), dtype)


@pytest.mark.parametrize("combo", sorted(COMBOS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_frames_matches_jax(payloads, dtype, combo):
    ej, et = payloads[dtype, combo][:2]
    assert isinstance(et, EncodedFrames)
    kw = COMBOS[combo]
    ch = channels(combo)
    assert et.codes.dtype == torch.int32
    assert et.codes.shape == (2, BLOCKS + 1, N, ch)
    assert_codes(et.codes, ej.codes, dtype)
    assert et.bark16.shape == (2, BLOCKS + 1, 64, 1)
    assert_sidecar(et.bark16, ej.bark16, dtype)
    on = {"tns_idx": kw.get("tns"), "nf_levels": kw.get("nf"),
          "bs_flags": kw.get("bs"), "bwe_gains": kw.get("bwe"),
          "is_gains": kw.get("intensity")}
    for name in MEMBERS:
        got, want = getattr(et, name), getattr(ej, name)
        # an absent feature gives a None member
        assert (got is None) == (want is None) == (not on[name]), name
        if got is not None:
            assert got.shape == want.shape, name
            if name == "is_gains":
                got, want = signed_levels(got), signed_levels(want)
            assert_ints(got, want, dtype)
    # the features that are on fire on this signal
    if kw.get("bs"):
        assert bool(et.bs_flags[:, 1:-1].any())
    if kw.get("tns"):
        assert bool((et.tns_idx != 0).any())
    if kw.get("nf"):
        assert bool((et.nf_levels > 0).any())


@pytest.mark.parametrize("combo", sorted(COMBOS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_frames_fec_matches_jax(payloads, dtype, combo):
    cj, bj = payloads[dtype, combo][2]
    ct, bt = payloads[dtype, combo][3]
    assert bt.shape == (2, 3, 64, 1)  # ceil(9 / 4) pooled rows
    assert_codes(ct, cj, dtype)
    assert_sidecar(bt, bj, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_bitstream_entry_points_match_jax(dtype):
    jc, tc = codecs(dtype)
    for ms in (False, True):
        xj, xt = inputs(dtype, 2 if ms else 1)
        name = "encode_bitstream_ms" if ms else "encode_bitstream"
        cj, bj = getattr(jc, name)(xj, deadzone=0.7, tmask=130.0)
        ct, bt = getattr(tc, name)(xt, deadzone=0.7, tmask=130.0)
        assert_codes(ct, cj, dtype)
        assert_sidecar(bt, bj, dtype)


def test_raw_bfloat16_sidecar_matches_jax():
    """sidecar_grid=0 ships the raw bfloat16 intensities."""
    jc, tc = codecs("float64", sidecar_grid=0)
    assert tc.sidecar_grid == 0
    xj, xt = inputs("float64", 1)
    cj, bj = jc.encode_bitstream(xj)
    ct, bt = tc.encode_bitstream(xt)
    assert bt.dtype == torch.bfloat16
    np.testing.assert_array_equal(bt.view(torch.int16).numpy(),
                                  np.asarray(bj).view(np.int16))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    with pytest.raises(ValueError, match="not on the declared grid"):
        scq.levels_from_bark16(bt, scq.DEFAULT_K2)


def test_ladder_raises_as_jax():
    jc, tc = codecs("float32")
    mono = inputs("float32", 1)
    stereo = inputs("float32", 2)
    cases = (
        (mono, dict(ms=True), "exactly 2 channels"),
        (stereo, dict(intensity=True), "requires ms=True"),
    )
    for (xj, xt), kw, match in cases:
        with pytest.raises(ValueError, match=match):
            jc.encode_frames(jc.mdct.transform(xj), **kw)
        with pytest.raises(ValueError, match=match):
            tc.encode_frames(tc.mdct.transform(xt), **kw)
    with pytest.raises(ValueError, match="exactly 2 channels"):
        tc.quantize_frames_fec(tc.mdct.transform(mono[1]), ms=True)


def test_codec_properties_match_jax():
    jc, tc = codecs("float32")
    for name in ("tns_band_start", "nf_band_start", "bwe_start", "is_start"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert (tc.bwe_start, tc.is_start) == (480, 272)
    for tmask in (130.0, 400.0):
        assert (tc.tmask_context_frames(tmask)
                == jc.tmask_context_frames(tmask))
