"""The port's streaming MDCT (``audiocodec_tpu_torch.streaming``) and its
``threefry.rademacher`` held against the JAX package on the CPU, at N=256.

- ``rademacher`` equals ``jax.random.rademacher`` bit for bit with x64 off
  (float32 uniforms) and on (float64 uniforms), which draw other signs.
- Each streaming step runs the MDCT's own transform, so the port's stream
  equals its batch transform bit for bit, at ``highest`` (the fold) and
  ``default`` (the dense two-matmul form), for any chunking; against the
  JAX package's steps and drivers it agrees to the tier's tolerance
  (tests/test_torch_mdct.py: float32 ``highest`` 1e-6 forward, 1e-4
  inverse; float64 1e-12 / 1e-10; ``default`` 2e-2 of the peak, since JAX's
  CPU matmul keeps float32 operands where the tier rounds them to bf16).
- ``streaming_round_trip``'s quantize mode matches JAX's (float64: within
  1e-12); its noise mode is deterministic per generator and adds noise of
  the masking threshold's energy / 36.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu import streaming as jstreaming
from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu.mdct import MDCT as JaxMDCT
from audiocodec_tpu_torch import MDCT, Codec, streaming
from audiocodec_tpu_torch.ops import threefry

torch.set_num_threads(1)

N, SR = 256, 16000
# (dtype, precision) -> (forward atol, inverse atol), relative to the peak
# at ``default``
TIERS = {
    ("float32", "highest"): (1e-6, 1e-4),
    ("float64", "highest"): (1e-12, 1e-10),
    ("float32", "default"): (2e-2, 2e-2),
}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float64))


def _wave(shape, dtype, seed):
    """Seeded uniform values built as float32, then the compute dtype."""
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return x.astype(dtype)


@pytest.fixture(scope="module")
def mdcts():
    return {(dt, p): (JaxMDCT.create(N, compute_dtype=getattr(jnp, dt),
                                     dct_precision=p, use_pallas=False),
                      MDCT(N, compute_dtype=dt, dct_precision=p,
                           device="cpu"))
            for dt, p in TIERS}


@pytest.mark.parametrize("x64,dtype", [(False, "float32"), (True, "float32"),
                                       (True, "float64")])
@pytest.mark.parametrize("seed,data,shape", [
    (0x9E3779B9, 3, (1, 4, 8, 1)),
    (0x9E3779B9, 0, (1, 7, 256, 2)),
    (0x7F4A7C15, 12, (1, 1, 256, 2)),
    (5, 2**31 + 7, (3, 5)),
])
def test_rademacher_equals_jax(x64, seed, data, shape, dtype):
    with jax.enable_x64(x64):
        want = np.asarray(jax.random.rademacher(
            jax.random.fold_in(jax.random.key(seed), data), shape,
            getattr(jnp, dtype)))
    k = threefry.fold_in(threefry.key(seed), torch.tensor(data))
    got = threefry.rademacher(k, shape, getattr(torch, dtype), x64=x64)
    assert got.shape == shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rademacher_x64_draws_other_signs():
    """The trap: the same key gives other signs with float64 uniforms."""
    k = threefry.fold_in(threefry.key(0x9E3779B9), torch.tensor(3))
    a, b = (threefry.rademacher(k, (1, 4, 8, 1), torch.float32, x64=x)
            for x in (False, True))
    assert not torch.equal(a, b)
    assert set(a.unique().tolist()) == {-1.0, 1.0}


@pytest.mark.parametrize("chunk_blocks", [1, 2, 3, 4, 12])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_stream_equals_batch(mdcts, tier, chunk_blocks):
    """The port's drivers equal its batch transforms bit for bit."""
    tm = mdcts[tier][1]
    dt = tier[0]
    x = torch.from_numpy(_wave((2, 12 * N, 2), dt, 0))
    y = torch.from_numpy(_wave((2, 12, N, 2), dt, 1) * 0.5)
    assert torch.equal(streaming.stream_transform(tm, x, chunk_blocks),
                       tm.transform(x))
    assert torch.equal(
        streaming.stream_inverse_transform(tm, y, chunk_blocks),
        tm.inverse_transform(y))


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_stream_matches_jax(mdcts, tier):
    """Step by step (uneven chunks 3 + 2 + 1 and the flush, then 2 + 2 +
    2 + 1 frames) and through the drivers, against the JAX package's."""
    jm, tm = mdcts[tier]
    dt = tier[0]
    fwd, inv = TIERS[tier]
    x = _wave((1, 6 * N, 2), dt, 2)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    cj = jstreaming.mdct_stream_init(jm, 1, 2)
    ct = streaming.mdct_stream_init(tm, 1, 2)
    assert ct.shape == (1, 2, N) and ct.dtype == getattr(torch, dt)
    frames = []
    start = 0
    for k in (3, 2, 1):
        sl = slice(start * N, (start + k) * N)
        cj, fj = jstreaming.mdct_stream_step(jm, cj, xj[:, sl])
        ct, ft = streaming.mdct_stream_step(tm, ct, xt[:, sl])
        assert ft.shape == (1, k, N, 2)
        peak = 1.0 if dt != "float32" or tier[1] == "highest" else (
            np.abs(_np(fj)).max())
        np.testing.assert_allclose(_np(ft), _np(fj), rtol=0,
                                   atol=fwd * peak)
        # the analysis carry is the raw last block in both packages
        np.testing.assert_array_equal(_np(ct), _np(cj))
        frames.append(ft)
        start += k
    last = streaming.mdct_stream_flush(tm, ct)
    np.testing.assert_allclose(
        _np(last), _np(jstreaming.mdct_stream_flush(jm, cj)), rtol=0,
        atol=fwd * max(1.0, np.abs(_np(last)).max()))
    y = torch.cat(frames + [last], dim=1)
    assert torch.equal(y, tm.transform(xt))

    # synthesis: carries are opaque, so compare the samples only
    dj = jstreaming.imdct_stream_init(jm, 1, 2)
    dtc = streaming.imdct_stream_init(tm, 1, 2)
    yj = jnp.asarray(y.numpy())
    out = []
    for i in range(0, 7, 2):
        dj, sj = jstreaming.imdct_stream_step(jm, dj, yj[:, i:i + 2])
        dtc, st = streaming.imdct_stream_step(tm, dtc, y[:, i:i + 2])
        np.testing.assert_allclose(_np(st), _np(sj), rtol=0,
                                   atol=inv * np.abs(_np(sj)).max())
        out.append(st)
    tail = streaming.imdct_stream_flush(tm, dtc)
    np.testing.assert_allclose(
        _np(tail), _np(jstreaming.imdct_stream_flush(jm, dj)), rtol=0,
        atol=inv * np.abs(x).max())
    rt = torch.cat(out + [tail], dim=1)
    assert torch.equal(rt, tm.inverse_transform(y))
    # the round trip reconstructs the waveform
    err = np.abs(_np(rt)[:, N:-N] - x.astype(np.float64)).max()
    assert err < (1e-2 if tier[1] == "default" else 1e-5)

    # the whole-signal drivers
    np.testing.assert_allclose(
        _np(streaming.stream_transform(tm, xt, 2)),
        _np(jstreaming.stream_transform(jm, xj, 2)), rtol=0,
        atol=fwd * (1.0 if tier[1] == "highest" else np.abs(x).max() * 8))


def test_stream_is_resumable(mdcts):
    """(carry, offset) is the whole state: a carry copied to numpy and back
    continues the stream bit for bit."""
    tm = mdcts["float32", "highest"][1]
    x = torch.from_numpy(_wave((1, 8 * N, 1), "float32", 4))
    carry = streaming.mdct_stream_init(tm, 1, 1)
    carry, f1 = streaming.mdct_stream_step(tm, carry, x[:, :4 * N])
    restored = torch.from_numpy(carry.numpy().copy())
    _, f2 = streaming.mdct_stream_step(tm, restored, x[:, 4 * N:])
    assert torch.equal(torch.cat([f1, f2], dim=1), tm.transform(x)[:, :-1])


def test_stream_errors(mdcts):
    tm = mdcts["float32", "highest"][1]
    x = torch.from_numpy(_wave((1, 5 * N, 1), "float32", 5))
    with pytest.raises(ValueError, match="multiple of"):
        streaming.stream_transform(tm, x, chunk_blocks=2)
    with pytest.raises(ValueError, match="multiple of"):
        streaming.stream_inverse_transform(tm, torch.zeros(1, 5, N, 1), 2)
    carry = streaming.mdct_stream_init(tm, 1, 1)
    with pytest.raises(ValueError, match="multiple of N"):
        streaming.mdct_stream_step(tm, carry, x[:, :N + 1])
    with pytest.raises((TypeError, ValueError)):
        streaming.mdct_stream_step(tm, carry, x[:, :N].double())


@pytest.fixture(scope="module")
def codecs():
    return {dt: (JaxCodec.create(SR, filters_n=N, bark_bands_n=16,
                                 compute_dtype=getattr(jnp, dt),
                                 use_pallas=False),
                 Codec.create(SR, filters_n=N, bark_bands_n=16,
                              compute_dtype=dt, device="cpu"))
            for dt in ("float64", "float32")}


@pytest.mark.parametrize("dtype,atol", [("float64", 1e-12),
                                        ("float32", 1e-4)])
def test_streaming_round_trip_quantize_matches_jax(codecs, dtype, atol):
    jc, tc = codecs[dtype]
    x = _wave((1, 12 * N, 2), dtype, 3) * 0.5
    want = jstreaming.streaming_round_trip(jc, jnp.asarray(x), 4)
    got = streaming.streaming_round_trip(tc, torch.from_numpy(x), 4)
    assert got.shape == (1, 14 * N, 2) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)
    # and it is the batch quantized round trip
    np.testing.assert_allclose(
        _np(got), _np(tc.round_trip_quantized(torch.from_numpy(x))),
        rtol=0, atol=atol)


def test_streaming_round_trip_noise(codecs):
    """Noise mode: one generator's draws in chunk order. The same seed
    gives the same output, another seed another; the added noise (out minus
    the clean MDCT round trip) has the energy of sigma = threshold / 6
    summed over the frames, through the synthesis, within 10%."""
    tc = codecs["float64"][1]
    x = torch.from_numpy(_wave((1, 12 * N, 1), "float64", 6) * 0.5)

    def run(seed):
        return streaming.streaming_round_trip(
            tc, x, 4, generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    spec = tc.mdct.transform(x)
    clean = tc.mdct.inverse_transform(spec)
    thr = tc.psycho.global_masking_threshold(spec, tc.psycho.tonality(spec))
    # the synthesis scales by sqrt(4N) (its DCT-IV matrix times sqrt(4N)),
    # so the lapped transform's energy gain is 4N
    want = float(((thr / 6.0) ** 2).sum()) * 4 * N
    for out in (a, c):
        got = float(((out - clean) ** 2).sum())
        assert 0.9 < got / want < 1.1, got / want
