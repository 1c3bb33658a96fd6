"""The bitstream ladder's modules of the port held against the JAX package
on the CPU, on the same inputs: ``ops/threefry`` against ``jax.random``,
``scq``, ``tns``, ``blockswitch``, ``nf``, ``bwe`` and ``intensity``, at
N=1024 and 44.1 kHz with 64 Bark bands (``bwe_start`` 480, ``is_start``
272). Templates: tests/test_scq.py, test_tns.py, test_blockswitch.py,
test_nf.py, test_bwe.py and test_intensity.py.

Rules: at float64 every integer output (indices, flags, uint8 levels and
gains) is equal; at float32 at least 99.9% of each, each within one level;
each fill and filter within 1e-5 of the peak (float32) or 1e-10 (float64).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from audiocodec_tpu import blockswitch as jbs
from audiocodec_tpu import bwe as jbwe
from audiocodec_tpu import intensity as jis
from audiocodec_tpu import nf as jnf
from audiocodec_tpu import scq as jscq
from audiocodec_tpu import tns as jtns
from audiocodec_tpu_torch import (Codec, blockswitch, bwe, intensity, nf,
                                  quantize, scq, tns)
from audiocodec_tpu_torch.ops import threefry
from audiocodec_tpu_torch.utils import dtypes

torch.set_num_threads(1)

SR, N, BLOCKS = 44100, 1024, 8
DTYPES = ("float64", "float32")
# share of each integer output that must be equal at float32, and the
# float tolerances (share of the peak) of fills and filters
INT_EQUAL_F32 = 0.999
FILL_TOL = {"float64": 1e-10, "float32": 1e-5}
BWE_START, IS_START = 480, 272


def ladder_signal(channels, batch=2, blocks=BLOCKS, n=N, sr=SR, seed=0):
    """Tones over a noise floor with an attack after a gap at block 4
    (fires block switching) and an impulse in block 5 (fires TNS):
    [batch, blocks*n, channels] float64. The second channel is the first
    scaled plus a little noise (a panned image); clip b is scaled by
    0.7**b."""
    rng = np.random.default_rng(seed)
    count = blocks * n
    t = np.arange(count) / sr
    x = (0.3 * np.sin(2 * np.pi * 440 * t)
         + 0.02 * np.sin(2 * np.pi * 7000 * t)
         + 0.03 * rng.standard_normal(count))
    start = 4 * n - n // 4
    x[start:start + n // 2] *= 0.01
    x[start + n // 2:start + 3 * n // 4] += 0.6 * rng.standard_normal(n // 4)
    x[5 * n + 300] += 0.9
    x = np.clip(x, -1, 1)
    x = np.stack([x, 0.8 * x + 0.01 * rng.standard_normal(count)], -1)
    x = x[:, :channels]
    return np.stack([x * 0.7**b for b in range(batch)])


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.to(torch.float32)
        return a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def signed_levels(gains):
    """Intensity wire gains (bit 7 the sign) as signed magnitude levels."""
    g = _np(gains).astype(np.int64)
    return np.where(g >= 128, -(g & 127), g)


def assert_ints(got, want, dtype):
    """Equal at float64; at float32 at least INT_EQUAL_F32 equal, each
    within one level."""
    got, want = _np(got).astype(np.int64), _np(want).astype(np.int64)
    assert got.shape == want.shape
    if dtype == "float64":
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1
    assert (diff == 0).mean() >= INT_EQUAL_F32


def assert_close(got, want, dtype):
    got, want = _np(got), _np(want)
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FILL_TOL[dtype] * max(peak, 1e-30))


@pytest.fixture(scope="module")
def coded():
    """Per dtype and channel count: the spectrum (mid/side for stereo), its
    codes and step sizes (deadzone 1.0), from the port on the CPU, as
    numpy."""
    out = {}
    for dtype in DTYPES:
        codec = Codec.create(SR, filters_n=N, compute_dtype=dtype,
                             device="cpu")
        for ch in (1, 2):
            x = torch.from_numpy(ladder_signal(ch)).to(getattr(torch, dtype))
            spec = codec.mdct.transform(x)
            thr = codec.psycho.global_masking_threshold(
                spec, codec.psycho.tonality(spec))
            if ch == 2:
                spec = Codec.to_mid_side(spec)
                thr = torch.minimum(thr[..., :1], thr[..., 1:]).expand_as(
                    spec)
            codes, delta = quantize.quantize(spec, thr, deadzone=1.0)
            out[dtype, ch] = tuple(a.numpy() for a in (spec, codes, delta))
    return out


def assert_amp_map(port, jax_fn, bias=None, k=None, exact=None):
    """A uint8 -> amplitude map at float32: within one ulp of the exact
    value, and within 2e-6 of JAX's (XLA's CPU exp2 is up to ~1e-6, about
    8 float32 ulps, from the exact value)."""
    lv = np.arange(256, dtype=np.uint8)
    if exact is None:
        exact = np.where(lv > 0, np.exp2((lv - bias) / k), 0.0)
    got = port(torch.from_numpy(lv), torch.float32).numpy()
    want = np.asarray(jax_fn(jnp.asarray(lv), jnp.dtype(jnp.float32)))
    ulp = np.spacing(np.abs(exact).astype(np.float32))
    assert (np.abs(got - exact) <= ulp).all()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


# -- threefry -----------------------------------------------------------------

SEEDS = (0, 5, 2**31 - 1, 2**32 - 1)
SHAPES = ((937, 2), (1, 1), (3, 5, 4))
FLOATS = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float64": (jnp.float64, torch.float64)}
INT_VIEWS = {"float32": (np.int32, torch.int32),
             "bfloat16": (np.int16, torch.int16),
             "float64": (np.int64, torch.int64)}


def _key_words(k):
    return [int(w) for w in np.asarray(jax.random.key_data(k))]


def _words(k):
    """The port's key words (int32 bit patterns) as uint32 values."""
    return [int(w) & threefry.M32 for w in k]


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_key_and_fold_in_chain(seed):
    kj = jax.random.key(jnp.asarray(seed, jnp.uint32))
    kt = threefry.key(seed)
    assert _key_words(kj) == _words(kt)
    for data in (0, 1, 430, 2**32 - 1):
        kj2 = jax.random.fold_in(kj, jnp.asarray(data, jnp.uint32))
        kt2 = threefry.fold_in(kt, torch.tensor(data))
        assert _key_words(kj2) == _words(kt2)
        kj3 = jax.random.fold_in(kj2, 7)
        kt3 = threefry.fold_in(kt2, torch.tensor(7))
        assert _key_words(kj3) == _words(kt3)


@pytest.mark.parametrize("dtype", sorted(FLOATS))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_uniform_bits_equal_jax(seed, shape, dtype):
    """uniform(-1, 1) of a fold_in chain, bit for bit, one key at a time
    and for a [2, 3] grid of keys drawn at once."""
    jdt, tdt = FLOATS[dtype]
    k = threefry.fold_in(threefry.key(seed), torch.arange(2)[:, None])
    k = threefry.fold_in(k, 10 + torch.arange(3)[None, :])
    grid = threefry.uniform(k, shape, tdt, -1.0, 1.0)
    assert grid.shape == (2, 3, *shape) and grid.dtype == tdt
    for b in range(2):
        kb = jax.random.fold_in(jax.random.key(jnp.asarray(seed, jnp.uint32)),
                                b)
        for f in range(3):
            want = jax.random.uniform(jax.random.fold_in(kb, 10 + f), shape,
                                      jdt, -1.0, 1.0)
            one = threefry.uniform(
                (k[0][b, f], k[1][b, f]), shape, tdt, -1.0, 1.0)
            for got in (grid[b, f], one):
                np.testing.assert_array_equal(
                    got.view(INT_VIEWS[dtype][1]).numpy(),
                    np.asarray(want).view(INT_VIEWS[dtype][0]))


@pytest.mark.parametrize("seed", [3, torch.tensor(3), 2**32 - 1,
                                  torch.tensor(-1)])
def test_threefry_uniform_of_a_seed_key(seed):
    """A key straight from a seed (an int or a tensor; -1 is 2^32 - 1)."""
    u = threefry.uniform(threefry.key(seed), (4096,), torch.float32, -1.0,
                         1.0)
    want = jax.random.uniform(
        jax.random.key(jnp.asarray(int(seed) & threefry.M32, jnp.uint32)),
        (4096,), jnp.float32, -1.0, 1.0)
    np.testing.assert_array_equal(u.numpy(), np.asarray(want))
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0


# -- scq ----------------------------------------------------------------------

@pytest.mark.parametrize("k2", jscq.ALLOWED_K2)
def test_scq_table_bits_equal_jax(k2):
    t = scq.table(k2, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  jscq.table(k2).view(np.int16))
    assert scq.level_bounds(k2) == jscq.level_bounds(k2)
    assert scq.table(k2, "cpu") is t  # built once per (k2, device)


@pytest.mark.parametrize("k2", jscq.ALLOWED_K2)
def test_scq_snap_and_levels_round_trip(k2):
    rng = np.random.default_rng(k2)
    x = np.exp(rng.uniform(np.log(1e-40), np.log(1e5), 20000))
    x = x.astype(np.float32)
    lo, hi = jscq.level_bounds(k2)
    x[:4] = [0.0, 2.0**lo, 2.0**hi, 1e30]
    xj, xt = _pair(x)
    want = np.asarray(jscq.snap(xj, k2))
    got = scq.snap(xt, k2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    levels = scq.levels_from_bark16(got, k2)
    np.testing.assert_array_equal(levels, jscq.levels_from_bark16(want, k2))
    back = scq.bark16_from_levels(levels, k2, got.shape, device="cpu")
    assert torch.equal(back.view(torch.int16), got.view(torch.int16))


def test_scq_raises_as_jax():
    with pytest.raises(ValueError, match="not supported"):
        scq.validate_k2(3)
    with pytest.raises(ValueError, match="not supported"):
        Codec.create(SR, filters_n=256, bark_bands_n=16, sidecar_grid=3,
                     device="cpu")
    off = torch.tensor([0.3], dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not on the declared grid"):
        scq.levels_from_bark16(off, 4)
    with pytest.raises(ValueError, match="bfloat16"):
        scq.levels_from_bark16(torch.tensor([1.0]), 4)
    lo, hi = scq.level_bounds(4)
    for bad in (lo - 1, hi + 1):
        with pytest.raises(ValueError, match="outside the grid"):
            scq.bark16_from_levels(np.array([bad]), 4, (1,), device="cpu")
        with pytest.raises(ValueError, match="outside the grid"):
            jscq.bark16_from_levels(np.array([bad]), 4, (1,))


def test_sidecar_work_dtype():
    for dt, want in ((torch.float64, torch.float64),
                     (torch.float32, torch.float32),
                     (torch.bfloat16, torch.float32)):
        assert dtypes.sidecar_work_dtype(torch.zeros(1, dtype=dt)) == want


# -- tns ----------------------------------------------------------------------

@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tns_matches_jax(coded, dtype, ch):
    spec = coded[dtype, ch][0]
    bs_ = tns.default_band_start(N)
    assert bs_ == jtns.default_band_start(N)
    sj, st = _pair(spec)
    idx_j = jtns.analyze(sj, bs_)
    idx = tns.analyze(st, bs_)
    assert idx.dtype == torch.int8 and idx.shape == (2, BLOCKS + 1, 8, ch)
    assert_ints(idx, idx_j, dtype)
    assert bool((idx != 0).any())  # the impulse's frame fires
    # the rest on the same indices
    ij, it = _pair(_np(idx_j))
    assert_close(tns.lpc_from_indices(it), jtns.lpc_from_indices(ij),
                 "float32")
    fwd = tns.filter_forward(st, it, bs_)
    assert_close(fwd, jtns.filter_forward(sj, ij, bs_), dtype)
    ej, et = _pair(_np(fwd))
    inv = tns.filter_inverse(et, it, bs_)
    assert_close(inv, jtns.filter_inverse(ej, ij, bs_), dtype)
    assert_close(inv, spec, dtype)  # the inverse filter returns s
    thr = np.abs(spec) + 1e-3
    tj, tt = _pair(thr)
    assert_close(tns.scaled_threshold(tt, it, bs_),
                 jtns.scaled_threshold(tj, ij, bs_), dtype)


def test_tns_band_too_narrow_raises():
    with pytest.raises(ValueError, match="must exceed the filter order"):
        tns.analyze(torch.zeros(1, 1, 16, 1), 10)


# -- blockswitch ----------------------------------------------------------------

@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_blockswitch_matches_jax(coded, dtype, ch):
    codec = Codec.create(SR, filters_n=N, compute_dtype=dtype, device="cpu")
    x = torch.from_numpy(ladder_signal(ch)).to(getattr(torch, dtype))
    spec = codec.mdct.transform(x).numpy()  # the long (pre-rotation) one
    sj, st = _pair(spec)
    flags = blockswitch.detect(st)
    assert flags.dtype == torch.bool and flags.shape == (2, BLOCKS + 1)
    assert_ints(flags, jbs.detect(sj), dtype)
    assert bool(flags[:, 1:-1].any())  # the attack after the gap fires
    fj, ft = _pair(_np(flags))
    split = blockswitch.split_spectrum(st, ft)
    assert_close(split, jbs.split_spectrum(sj, fj), dtype)
    wj, wt = _pair(_np(split))
    merged = blockswitch.merge_spectrum(wt, ft)
    assert_close(merged, jbs.merge_spectrum(wj, fj), dtype)
    assert_close(merged, spec, dtype)
    thr = np.abs(spec) + 1e-3
    tj, tt = _pair(thr)
    np.testing.assert_array_equal(_np(blockswitch.pool_threshold(tt, ft)),
                                  _np(jbs.pool_threshold(tj, fj)))


def test_blockswitch_matrices_built_once_and_flags_packed():
    fwd, inv = blockswitch.transition_matrices(256, device="cpu")
    again = blockswitch.transition_matrices(256, device="cpu")
    assert again[0] is fwd and again[1] is inv
    jf, ji = jbs.transition_matrices(256)
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ji))
    flags = np.random.default_rng(0).random((3, 13)) > 0.5
    bits = blockswitch.pack_flags(torch.from_numpy(flags))
    np.testing.assert_array_equal(bits, jbs.pack_flags(flags))
    back = blockswitch.unpack_flags(bits, 13, device="cpu")
    assert back.dtype == torch.bool
    np.testing.assert_array_equal(back.numpy(), flags)
    with pytest.raises(ValueError, match="flag bitmap"):
        blockswitch.unpack_flags(bits, 17, device="cpu")


# -- nf -------------------------------------------------------------------------

@pytest.mark.parametrize("band_end", [None, BWE_START])
@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_nf_matches_jax(coded, dtype, ch, band_end, monkeypatch):
    spec, codes, delta = coded[dtype, ch]
    start = nf.default_band_start(N)
    assert start == jnf.default_band_start(N)
    excl = (intensity.owned_mask(N, IS_START, "cpu") if ch == 2 else None)
    ex_j = None if excl is None else excl.numpy()
    (sj, st), (cj, ct), (dj, dt) = _pair(spec), _pair(codes), _pair(delta)
    lv = nf.analyze(st, ct, dt, start, deadzone=1.0, band_end=band_end,
                    exclude=excl)
    lv_j = jnf.analyze(sj, cj, dj, start, deadzone=1.0, band_end=band_end,
                       exclude=ex_j)
    assert lv.dtype == torch.uint8 and lv.shape == (2, BLOCKS + 1, ch)
    assert_ints(lv, lv_j, dtype)
    assert bool((lv > 0).any())
    lj, lt = _pair(_np(lv_j).astype(np.uint8))
    qj, qt = _pair((codes * delta).astype(delta.dtype))

    def fill(offset):
        return nf.fill(qt, ct, dt, lt, start, 5, offset, band_end=band_end,
                       exclude=excl)

    want = jnf.fill(qj, cj, dj, lj, start, 5, 3, band_end=band_end,
                    exclude=ex_j)
    got = fill(3)
    assert got.dtype == qt.dtype
    assert_close(got, want, dtype)
    assert torch.equal(fill(3), got)
    assert not torch.equal(fill(4), got)  # another frame: another draw
    # with JAX's amplitudes (XLA's CPU exp2 is several float32 ulps from
    # the exact value, torch's within one: assert_amp_map), the same draw
    # gives the same fill within one ulp
    amp_j = np.array(jnf.level_to_amp(lj, jnp.dtype(qj.dtype)))
    monkeypatch.setattr(nf, "level_to_amp",
                        lambda levels, dt_: torch.from_numpy(amp_j))
    ulp = np.spacing(np.abs(_np(want)))
    assert (np.abs(_np(fill(3)) - _np(want)) <= ulp).all()


def test_nf_noise_is_jax_draw():
    """The fill's noise of every (batch, frame) at once equals
    jax.random.uniform under fold_in(fold_in(key(seed), b), offset + f),
    bit for bit, at the fill band of the codec's "low" preset."""
    b_n, f_n, m, c = 2, 5, BWE_START - nf.default_band_start(N), 2
    for seed, offset in ((5, 0), (2**32 - 1, 430)):
        got = nf.noise(seed, b_n, f_n, (m, c), torch.float32, offset,
                       device="cpu")
        key = jax.random.key(jnp.asarray(seed, jnp.uint32))
        for b in range(b_n):
            kb = jax.random.fold_in(key, b)
            for f in range(f_n):
                want = jax.random.uniform(jax.random.fold_in(kb, offset + f),
                                          (m, c), jnp.float32, -1.0, 1.0)
                np.testing.assert_array_equal(got[b, f].numpy(),
                                              np.asarray(want))


def test_nf_level_to_amp_and_empty_band():
    assert_amp_map(nf.level_to_amp, jnf.level_to_amp, nf.LEVEL_BIAS,
                   nf.LEVEL_K)
    z = torch.zeros(1, 1, 64, 1)
    with pytest.raises(ValueError, match="noise-fill band is empty"):
        nf.analyze(z, z.int(), z + 1, 32, band_end=32)
    with pytest.raises(ValueError, match="noise-fill band is empty"):
        nf.fill(z, z.int(), z + 1, torch.zeros(1, 1, 1, dtype=torch.uint8),
                32, 0, band_end=16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nf_fill_in_the_band_dtype_equals_jax(dtype, monkeypatch):
    """The fill draws in the band's dtype (8 random bits for bfloat16):
    with JAX's amplitudes, bit for bit."""
    rng = np.random.default_rng(1)
    jdt, tdt = FLOATS[dtype]
    spec = rng.normal(scale=0.1, size=(2, 3, 256, 2)).astype(np.float32)
    delta = rng.uniform(0.01, 0.1, size=spec.shape).astype(np.float32)
    codes = np.round(spec / delta / 2).astype(np.int32)
    levels = rng.integers(0, 256, size=(2, 3, 2)).astype(np.uint8)
    want = jnf.fill(jnp.asarray(spec, jdt), jnp.asarray(codes),
                    jnp.asarray(delta, jdt), jnp.asarray(levels), 16, 7, 2)
    amp_j = jnf.level_to_amp(jnp.asarray(levels), jnp.dtype(jdt))
    monkeypatch.setattr(nf, "level_to_amp", lambda lv, dt_: torch.from_numpy(
        np.array(amp_j, np.float32)).to(tdt))
    got = nf.fill(torch.from_numpy(spec).to(tdt), torch.from_numpy(codes),
                  torch.from_numpy(delta).to(tdt), torch.from_numpy(levels),
                  16, 7, 2)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), _np(want))


# -- bwe ------------------------------------------------------------------------

def test_bwe_layout_matches_jax():
    assert bwe.default_start(N, SR) == jbwe.default_start(N, SR) == BWE_START
    for n, start in ((N, BWE_START), (256, 96), (64, 16)):
        np.testing.assert_array_equal(bwe.source_index(n, start),
                                      jbwe.source_index(n, start))
        assert bwe.n_groups(n, start) == jbwe.n_groups(n, start)
    for bad in (8, 100, N):
        with pytest.raises(ValueError, match="bwe start"):
            bwe.validate_start(N, bad)
    assert_amp_map(bwe.gain_to_amp, jbwe.gain_to_amp, bwe.LEVEL_BIAS,
                   bwe.LEVEL_K)


@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bwe_matches_jax(coded, dtype, ch):
    spec, codes, delta = coded[dtype, ch]
    excl = (intensity.owned_mask(N, IS_START, "cpu") if ch == 2 else None)
    ex_j = None if excl is None else excl.numpy()
    (sj, st), (cj, ct), (dj, dt) = _pair(spec), _pair(codes), _pair(delta)
    g = bwe.analyze(st, ct, dt, BWE_START, exclude=excl)
    g_j = jbwe.analyze(sj, cj, dj, BWE_START, exclude=ex_j)
    assert g.dtype == torch.uint8 and g.shape == (2, BLOCKS + 1, 34, ch)
    assert_ints(g, g_j, dtype)
    assert bool((g > 0).any())
    gj, gt = _pair(_np(g_j).astype(np.uint8))
    qj, qt = _pair((codes * delta).astype(delta.dtype))
    assert_close(bwe.fill(qt, ct, dt, gt, BWE_START, exclude=excl),
                 jbwe.fill(qj, cj, dj, gj, BWE_START, exclude=ex_j), dtype)


# -- intensity --------------------------------------------------------------------

def test_intensity_layout_matches_jax():
    assert (intensity.default_start(N, SR) == jis.default_start(N, SR)
            == IS_START)
    assert intensity.LEVEL_MAX == jis.LEVEL_MAX
    np.testing.assert_array_equal(
        intensity.owned_mask(N, IS_START, "cpu").numpy(),
        jis.owned_mask(N, IS_START))
    assert intensity.owned_mask(N, IS_START, "cpu") is intensity.owned_mask(
        N, IS_START, "cpu")
    assert intensity.n_groups(N, IS_START) == jis.n_groups(N, IS_START)
    g = np.arange(256)
    lvl = np.minimum(g & 127, intensity.LEVEL_MAX)
    exact = np.where(g >= 128, -1.0, 1.0) * np.exp2(
        (lvl - intensity.LEVEL_BIAS) / intensity.LEVEL_K) * (g > 0)
    assert_amp_map(intensity.gain_to_amp, jis.gain_to_amp, exact=exact)
    with pytest.raises(ValueError, match="exactly 2"):
        intensity.force_codes(torch.zeros(1, 1, N, 1, dtype=torch.int32),
                              IS_START)
    with pytest.raises(ValueError, match="intensity start"):
        intensity.validate_start(N, 100)


@pytest.mark.parametrize("with_bwe", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_intensity_matches_jax(coded, dtype, with_bwe):
    spec, codes, delta = coded[dtype, 2]
    rng = np.random.default_rng(2)
    flags = rng.random((2, BLOCKS + 1)) > 0.7
    (sj, st), (dj, dt), (fj, ft) = _pair(spec), _pair(delta), _pair(flags)
    forced = intensity.force_codes(torch.from_numpy(codes), IS_START, ft)
    forced_j = jis.force_codes(jnp.asarray(codes), IS_START, fj)
    np.testing.assert_array_equal(forced.numpy(), np.asarray(forced_j))
    cj, ct = _pair(forced.numpy())
    excl = intensity.owned_mask(N, IS_START, "cpu")
    mid_t = mid_j = None
    if with_bwe:
        gains = bwe.analyze(st, ct, dt, BWE_START, exclude=excl)
        gj, gt = _pair(gains.numpy())
        mid_t = intensity.mid_reference(ct, dt, st.dtype, gt, BWE_START,
                                        excl)
        mid_j = jis.mid_reference(cj, dj, sj.dtype, gj, BWE_START,
                                  excl.numpy())
        assert_close(mid_t, mid_j, dtype)
    g = intensity.analyze(st, ct, dt, IS_START, mid_ref=mid_t)
    g_j = jis.analyze(sj, cj, dj, IS_START, mid_ref=mid_j)
    assert g.dtype == torch.uint8 and g.shape == (2, BLOCKS + 1, 47)
    assert_ints(signed_levels(g), signed_levels(g_j), dtype)
    assert bool((g > 0).any())
    gj2, gt2 = _pair(_np(g_j).astype(np.uint8))
    qj, qt = _pair((forced.numpy() * delta).astype(delta.dtype))
    mid_j2 = None if mid_t is None else jnp.asarray(_np(mid_t))
    assert_close(intensity.fill(qt, ct, dt, gt2, IS_START, mid_ref=mid_t),
                 jis.fill(qj, cj, dj, gj2, IS_START, mid_ref=mid_j2), dtype)
